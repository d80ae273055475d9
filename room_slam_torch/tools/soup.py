"""Checkpoint souping (counterpart of the JAX package's ``tools/soup.py``):
average the parameters of several checkpoints of ONE training run into a
new checkpoint (a uniform "model soup").

Late checkpoints of one run sit in one basin, so their average denoises
the final point much as a parameter EMA does, after the fact. Only
checkpoints of the SAME run may be souped: independently seeded runs live
in different basins (pool those as an ensemble, ``--checkpoint a,b,c``).

    python -m room_slam_torch.tools.soup --out DIR/soup \\
        DIR/checkpoint_epoch_259 ... DIR/checkpoint_epoch_299

The stems are read without flax (``train/checkpoint.read_msgpack_tree``),
averaged in float64 and cast to float32; the output is written by the
port's ``save_checkpoint`` in the JAX layout, a stem that both packages'
loaders and every CLI read. Host only: no device is involved.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from room_slam_torch.config import ExperimentConfig
from room_slam_torch.models.factory import build_model
from room_slam_torch.train.checkpoint import read_msgpack_tree, save_checkpoint
from room_slam_torch.weights import params_to_state_dict


def soup_params(stems: list) -> Tuple[Dict, Dict]:
    """Uniformly average the ``params`` trees (the model's ``{"params":
    ...}`` variables) of checkpoint stems. Returns (the averaged tree, the
    sidecar of the last stem)."""
    if len(stems) < 2:
        raise SystemExit("soup needs at least 2 checkpoints")
    acc = None
    side = None
    for stem in stems:
        p = Path(stem)
        state = read_msgpack_tree(p.with_suffix(".msgpack").read_bytes())
        side = json.loads(p.with_suffix(".json").read_text())
        flat = {}

        def _flatten(tree, prefix=()):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    _flatten(v, prefix + (k,))
            else:
                flat[prefix] = np.asarray(tree, np.float64)

        _flatten(state["params"])
        if acc is None:
            acc = {k: v.copy() for k, v in flat.items()}
            shapes = {k: v.shape for k, v in flat.items()}
        else:
            if {k: v.shape for k, v in flat.items()} != shapes:
                raise SystemExit(
                    f"{stem}: params tree differs from the first "
                    "checkpoint — soup only checkpoints of one run")
            for k, v in flat.items():
                acc[k] += v

    n = len(stems)
    tree: dict = {}
    for k, v in acc.items():
        node = tree
        for part in k[:-1]:
            node = node.setdefault(part, {})
        node[k[-1]] = (v / n).astype(np.float32)
    return tree, side


def main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stems", nargs="+",
                    help="checkpoint stems (msgpack+json pairs) of ONE run")
    ap.add_argument("--out", required=True, help="output checkpoint stem")
    args = ap.parse_args(argv)

    params, side = soup_params(args.stems)
    cfg = ExperimentConfig.from_dict(side.get("config", {}))
    model = build_model(cfg.model)
    save_checkpoint(args.out, params_to_state_dict(params, model),
                    epoch=side.get("epoch", 0), config=cfg,
                    extra={"soup_of": [str(s) for s in args.stems]},
                    model=model)
    print(f"souped {len(args.stems)} checkpoints -> {args.out}")


if __name__ == "__main__":
    main()
