"""Export the serving program to a ``torch.export`` artifact (counterpart of
the JAX package's ``tools/export.py``).

``predictor.build_predictor``'s ``run`` is the whole inference program on
the device: featurized views in, post-processed boxes out (forward, view
pooling, refine, extent mask, NMS, fusion). This tool exports exactly that
function with ``torch.export`` at one fixed shape, ``[R, L, F]`` float32
traces and an ``[R, L]`` bool mask (the same fixed-shape serving contract
the live UDP mode uses, ``data/ingest.py``), and saves it with
``torch.export.save``. The model's weights travel inside the artifact: the
exported module owns the model.

What serving the artifact needs. The JAX artifact is StableHLO that jax
alone runs; this one is not self-contained. It needs torch and this
package's ops: each bidirectional layer's recurrence is one node of the
custom op ``room_slam::bilstm_fwd`` (the ``lstm``, ``ops/rnn_cuda.py``) or
``room_slam::bigru_fwd`` (the ``bigru``, ``ops/gru_cuda.py``), whose
implementations live there: the plain version for CPU tensors, kernel #1 /
#5 for CUDA tensors,
built from ``room_slam_torch/csrc`` at their first launch (``nvcc`` on the
serving host). ``load_exported`` imports those ops before it loads. One
artifact serves both devices: ``load_exported`` moves the program to the
device asked for, and the ops pick their implementation there.

The operating point is the JAX tool's (threshold 0.05, NMS 0.1, extent
1.0, top-K 12, fusion; no soft-NMS, ttopt, synthesis or quality model).

Usage:
    python -m room_slam_torch.tools.export --checkpoint CKPT \\
        --output model.pt2 [--max_trace_len 3000] [--threshold 0.05 ...] \\
        [--platforms cpu,cuda] [--device cuda|cpu]
    python -m room_slam_torch.tools.export --run model.pt2 \\
        --input trace.json [--device cuda|cpu]   # smoke-test an artifact
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from room_slam_torch import resolve_device

PLATFORMS = ("cpu", "cuda")


class ServingProgram(nn.Module):
    """``predict.run`` as a module that owns the model, so that
    ``torch.export`` saves the weights with the program."""

    def __init__(self, model: nn.Module, run: Callable):
        super().__init__()
        self.model = model
        self.run = run

    def forward(self, traces: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        return self.run(traces, mask)


def export_checkpoint(checkpoint: str, output: str,
                      max_trace_len: int = 3000,
                      threshold: float = 0.05, nms: float = 0.1,
                      refine: float | None = None,
                      refine_furniture: bool = True,
                      extent: float | None = 1.0,
                      top_k: int | None = 12,
                      tta: bool = False, fuse: bool = True,
                      platforms: tuple = (),
                      device: str | torch.device = "cuda") -> dict:
    """Export the full inference program for ``checkpoint`` to ``output``
    (``torch.export.save``) and write a JSON sidecar describing the
    contract. The export runs on ``device``; ``platforms`` ("cpu",
    "cuda") only names the devices the artifact is for (default: that
    one), since every one of its ops runs on both."""
    from room_slam_torch.predictor import build_predictor, model_input_dim
    from room_slam_torch.train.driver import load_model_for_inference

    dev = resolve_device(device)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms {unknown}: the port's artifacts serve "
                         f"{list(PLATFORMS)}")
    model, cfg = load_model_for_inference(checkpoint, device=dev)
    predict = build_predictor(
        model, max_trace_len=max_trace_len,
        confidence_threshold=threshold, nms_threshold=nms,
        refine_clearance=refine, refine_furniture=refine_furniture,
        extent_slack=extent, top_k=top_k, tta_rotations=tta, fuse=fuse,
        device=dev, verbose=False)
    views = predict.views
    R = len(views)
    F = model_input_dim(model, default=cfg.model.input_dim)
    args = (torch.zeros(R, max_trace_len, F, device=dev),
            torch.zeros(R, max_trace_len, dtype=torch.bool, device=dev))
    with torch.no_grad():
        exported = torch.export.export(ServingProgram(model, predict.run),
                                       args, strict=False)
    torch.export.save(exported, output)
    meta = {
        "input": {"traces": [R, max_trace_len, F],
                  "mask": [R, max_trace_len]},
        "output": "[RQ', 9] rows: box(6), keep, label, confidence",
        "views": [list(v) for v in views],
        "operating_point": {
            "threshold": threshold, "nms": nms, "refine": refine,
            "refine_furniture": refine_furniture, "extent": extent,
            "top_k": top_k, "tta": tta, "fuse": fuse},
        "platforms": list(platforms) or [dev.type],
        "model_type": cfg.model.model_type,
        "bytes": Path(output).stat().st_size,
    }
    Path(output).with_suffix(".json").write_text(json.dumps(meta, indent=1))
    return meta


def load_exported(path: str, device: str | torch.device = "cuda"
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Load an artifact and move its program to ``device`` (raises for
    ``cuda`` without a card); returns ``fn(traces, mask) -> [RQ', 9]``.
    Arrays are taken as they are; tensors go to ``device``."""
    from torch.export.passes import move_to_device_pass

    # importing the recurrences' modules registers their ops
    from room_slam_torch.ops import gru_cuda, rnn_cuda  # noqa: F401

    dev = resolve_device(device)
    program = move_to_device_pass(torch.export.load(path), dev).module()

    def fn(traces, mask) -> torch.Tensor:
        with torch.no_grad():
            return program(torch.as_tensor(traces, device=dev),
                           torch.as_tensor(mask, device=dev))

    return fn


def run_exported(path: str, trace_file: str,
                 device: str | torch.device = "cuda") -> list:
    """Smoke-test: featurize a trace file on the host and run the loaded
    program (mirrors ``build_predictor``'s host side)."""
    from room_slam_torch.data import formats
    from room_slam_torch.data.features import process_traces_np
    from room_slam_torch.predictor import adapt_features

    meta = json.loads(Path(path).with_suffix(".json").read_text())
    R, L, F = meta["input"]["traces"]
    arr = formats.load_trace_json(trace_file)
    feats = process_traces_np(np.asarray(arr, np.float32), max_len=L)
    if feats.shape[-1] != F:
        feats = adapt_features(feats, F)
    if R != 1:
        raise SystemExit("--run supports artifacts exported without --tta "
                         f"(R=1); this one has R={R}")
    n = feats.shape[0]
    padded = np.zeros((R, L, F), np.float32)
    mask = np.zeros((R, L), bool)
    padded[0, :n], mask[0, :n] = feats, True
    stacked = load_exported(path, device)(padded, mask).cpu().numpy()
    keep = stacked[:, 6] > 0.5
    out = [formats.collider_to_dict(stacked[i, :6],
                                    int(stacked[i, 7]), stacked[i, 8])
           for i in np.argsort(-stacked[:, 8] * keep) if keep[i]]
    print(f"{len(out)} colliders from {path}")
    for c in out[:8]:
        print(" ", c["label"], [round(float(x), 2) for x in
                               (c["center"]["x"], c["center"]["y"],
                                c["center"]["z"])], round(c["confidence"], 3))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", help="checkpoint to export")
    p.add_argument("--output", default="model.pt2")
    p.add_argument("--max_trace_len", type=int, default=3000)
    # defaults = the calibration-selected detection cell (refine snapping
    # off: it destroys memorized walls)
    p.add_argument("--threshold", type=float, default=0.05)
    p.add_argument("--nms", type=float, default=0.1)
    p.add_argument("--refine", type=float, default=None)
    p.add_argument("--no_refine", action="store_true")
    p.add_argument("--extent", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=12)
    p.add_argument("--tta", action="store_true")
    p.add_argument("--fuse", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--platforms", default="",
                   help="comma list of cpu,cuda (default: --device's)")
    p.add_argument("--device", default="cuda",
                   help="device to export on, or to run --run on")
    p.add_argument("--run", help="smoke-test an existing artifact instead")
    p.add_argument("--input", help="trace JSON for --run")
    args = p.parse_args()

    if args.run:
        if not args.input:
            raise SystemExit("--run needs --input TRACE_JSON")
        run_exported(args.run, args.input, args.device)
        return
    if not args.checkpoint:
        raise SystemExit("--checkpoint required")
    meta = export_checkpoint(
        args.checkpoint, args.output, max_trace_len=args.max_trace_len,
        threshold=args.threshold, nms=args.nms,
        refine=None if args.no_refine else args.refine,
        extent=args.extent, top_k=args.top_k, tta=args.tta, fuse=args.fuse,
        platforms=tuple(s for s in args.platforms.split(",") if s),
        device=args.device)
    print(json.dumps(meta, indent=1))


if __name__ == "__main__":
    main()
