#!/usr/bin/env python3
"""Time chip_smoke.py's legacy train step and fused BiGRU layer from two
checkouts of this repository on one CUDA card, in turns.

    python3 chip_ab.py --parent DIR [--output FILE]

``--parent`` is the root of another checkout; it and this one run in the
order parent, change, change, parent, so a drift of the card over the
call shows as a parent-parent spread. Each run is a fresh process in its
checkout's root that imports that checkout's ``chip_smoke.py`` and
``room_slam_torch`` (its kernels built there at first use) and measures:

- phase 23: ``time_legacy_steps``, the legacy train step (B=32, N=500)
  p50 over ``LEGACY_STEPS`` after ``LEGACY_WARMUP`` on the rooms that
  ``chip_smoke.py`` makes from its default seed (0), then its per-stage
  split; the ``gru_fwd_train`` and ``gru_bwd`` kernel times beside it
  from CUDA events;
- phase 27: ``fused_ab``, one scale-up BiGRU layer's forward + backward
  fused (#9) and unfused, and #9 alone.

It prints one line per run and, last, a JSON object of all runs (also
written to ``--output``). Exits non-zero without a CUDA card; every
number comes from the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, subprocess, sys, tempfile
from pathlib import Path
import torch
import chip_smoke as cs
from room_slam_torch.data.rooms import write_legacy_rooms
from room_slam_torch.ops import build, gru_cuda

seed = 0   # chip_smoke.py's default --seed
dev = cs.resolve_device("cuda")
build.build_all()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], check=True,
                     capture_output=True, text=True,
                     timeout=60).stdout.strip().splitlines()[0]
B, N, H = cs.LEGACY
xg, _, w, b, _, _ = cs.gru_inputs(B, N, H, torch.float32, dev, seed)
ys, gs, hn = gru_cuda.gru_fwd_train_plain(xg, w, b)
dy = torch.randn(B, N, H, device=dev,
                 generator=torch.Generator(dev).manual_seed(seed))
rows = {"gru_fwd_train": {"kernel_ms": cs.cuda_ms(
            lambda: gru_cuda.gru_fwd_train_cuda(xg, w, b), 20)},
        "gru_bwd": {"kernel_ms": cs.cuda_ms(
            lambda: gru_cuda.gru_bwd_cuda(w, gs, hn, ys, dy), 20)}}
with tempfile.TemporaryDirectory() as tmp:
    data = Path(tmp) / "legacy"
    write_legacy_rooms(data, cs.LEGACY_ROOMS, seed + 20,
                       points=cs.LEGACY_POINTS)
    legacy = cs.time_legacy_steps(data, dev, seed, smi, rows)
fused, _ = cs.fused_ab(dev, seed, smi, None)
print("AB_RESULT " + json.dumps({"card": smi, "legacy": legacy,
                                 "fused": fused}), flush=True)
'''


ORDER = "pccp"   # parent, change, change, parent


def run_one(root: Path) -> dict:
    """One run in checkout ``root``: its own process, imports and build."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                          env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {root} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("AB_RESULT "))
    return json.loads(line[len("AB_RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--output", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA card", file=sys.stderr)
        return 1
    roots = {"p": args.parent.resolve(),
             "c": Path(__file__).resolve().parent}
    runs = []
    for i, key in enumerate(ORDER):
        res = run_one(roots[key])
        leg, fus = res["legacy"], res["fused"]
        runs.append({"run": i + 1, "tree": "parent" if key == "p"
                     else "change", **res})
        stage = leg["stage_ms"]
        print(f"[{i + 1} {runs[-1]['tree']}] legacy step p50 "
              f"{leg['p50_ms']:.3f} ms (forward {stage['forward']:.3f}, "
              f"backward {stage['backward']:.3f}; gru_bwd kernel "
              f"{leg['bwd_kernels_ms'] / 4:.3f} ms); fused layer "
              f"{fus['fused_layer_fwd_bwd_ms']:.3f} ms, unfused "
              f"{fus['unfused_layer_fwd_bwd_ms']:.3f} ms, #9 "
              f"{fus['kernel_ms']:.3f} ms on {res['card']}", flush=True)
    out = json.dumps({"order": ORDER, "runs": runs})
    if args.output:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(out)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
