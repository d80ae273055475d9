"""Evaluation CLI of the port (the JAX package's ``evaluate.py``), the
legacy surface:

    python -m room_slam_torch.evaluate --checkpoint DIR/best_model_legacy \\
        --data_dir DIR [--compare_baseline] [--threshold 0.5] \\
        [--iou_thresh 0.5] [--hidden_size 128] [--max_objects 10] \\
        [--output metrics.json] [--device cuda|cpu]

Scores a legacy GRU checkpoint per trace: every window of a CSV trace goes
through the model in one batch, the slots whose confidence (sigmoid
validity times the top class probability) exceeds ``--threshold`` pool
into the trace's predictions, and the trace's ground truth counts once;
rotated-box mAP at ``--iou_thresh``. ``--compare_baseline`` scores the
rule-based occupancy baseline on each whole trace beside it. Prints the
metrics as JSON.

Not ported yet: the benchmark surface (``--surface bench``, ROADMAP queue 1
item 9) and ``--visualize`` (item 16); both raise ``NotImplementedError``.
``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from room_slam_torch import resolve_device
from room_slam_torch.data.legacy import LegacyArrays
from room_slam_torch.models.baseline import OccupancyBaseline
from room_slam_torch.models.legacy_gru import RoomSlamGRU
from room_slam_torch.train import checkpoint as ckpt_lib
from room_slam_torch.train.metrics import average_precision_rotated_2d
from room_slam_torch.weights import load_params


def load_legacy_model(checkpoint: str, hidden_size: int = 128,
                      max_objects: int = 10,
                      device: str | torch.device = "cuda"
                      ) -> Tuple[nn.Module, Dict]:
    """The legacy model of checkpoint stem ``checkpoint`` (the JAX layout,
    as ``train_legacy`` and the JAX package write it) on ``device`` in eval
    mode, and the checkpoint's sidecar."""
    dev = resolve_device(device)
    params, side = ckpt_lib.load_checkpoint(checkpoint)
    model = load_params(RoomSlamGRU(hidden_size=hidden_size,
                                    max_objects=max_objects), params)
    return model.to(dev).eval(), side


@torch.no_grad()
def model_rows(model: nn.Module, ds: LegacyArrays,
               threshold: float) -> List[Tuple]:
    """``(box, label, confidence, trace id)`` of every slot of every window
    whose confidence exceeds ``threshold``: one forward over all windows."""
    dev = next(model.parameters()).device
    out = model(torch.from_numpy(np.ascontiguousarray(
        ds.traces[:, :, 1:3])).to(dev))
    val = torch.sigmoid(out["validity"][..., 0])
    prob = torch.softmax(out["classes"], dim=-1)
    conf = (val * prob.max(-1).values).cpu().numpy()
    labels = prob.argmax(-1).cpu().numpy()
    boxes = out["pred_boxes"].cpu().numpy()
    rows = []
    for i in range(len(ds)):
        tid = int(ds.trace_id[i])
        for s in np.where(conf[i] > threshold)[0]:
            rows.append((boxes[i, s], int(labels[i, s]), float(conf[i, s]),
                         tid))
    return rows


def gt_rows(ds: LegacyArrays) -> List[Tuple]:
    """``(box, label, trace id)`` of each trace's ground truth, once."""
    rows = []
    for tid in sorted(set(ds.trace_id.tolist())):
        i = int(np.where(ds.trace_id == tid)[0][0])
        for m in np.where(ds.valid[i])[0]:
            rows.append((ds.boxes[i, m], int(ds.labels[i, m]), tid))
    return rows


def baseline_rows(ds: LegacyArrays, max_objects: int,
                  device: str | torch.device) -> List[Tuple]:
    """The occupancy baseline's objects of each whole trace as rows."""
    baseline = OccupancyBaseline(max_objects=max_objects, device=device)
    rows = []
    for tid in sorted(set(ds.trace_id.tolist())):
        full = np.concatenate([ds.traces[i]
                               for i in np.where(ds.trace_id == tid)[0]])
        for o in baseline.predict(full):
            box = np.asarray(o["position"] + o["size"] + [o["orientation"]],
                             np.float32)
            rows.append((box, o["class_id"], o["confidence"], tid))
    return rows


def score(pred: List[Tuple], gt: List[Tuple], iou_thresh: float):
    """``(mAP, AP per class)`` of prediction rows against GT rows."""
    if not pred or not gt:
        return 0.0, {}
    return average_precision_rotated_2d(
        np.stack([r[0] for r in pred]), np.asarray([r[1] for r in pred]),
        np.asarray([r[2] for r in pred]), np.asarray([r[3] for r in pred]),
        np.stack([r[0] for r in gt]), np.asarray([r[1] for r in gt]),
        np.asarray([r[2] for r in gt]), iou_thresh=iou_thresh)


def evaluate_legacy(checkpoint: str, data_dir: str, hidden_size: int = 128,
                    max_objects: int = 10, threshold: float = 0.5,
                    iou_thresh: float = 0.5, compare_baseline: bool = False,
                    device: str | torch.device = "cuda") -> Dict:
    """The metrics of the JAX package's ``evaluate_legacy``: ``mAP``,
    ``AP_per_class``, ``checkpoint_epoch`` and, with ``compare_baseline``,
    ``baseline_mAP`` and ``baseline_AP_per_class``."""
    ds = LegacyArrays(data_dir)
    model, side = load_legacy_model(checkpoint, hidden_size, max_objects,
                                    device)
    gt = gt_rows(ds)
    mAP, aps = score(model_rows(model, ds, threshold), gt, iou_thresh)
    result = {"mAP": mAP, "AP_per_class": aps,
              "checkpoint_epoch": side.get("epoch")}
    if compare_baseline:
        result["baseline_mAP"], result["baseline_AP_per_class"] = score(
            baseline_rows(ds, max_objects, device), gt, iou_thresh)
    return result


def main(argv: List[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="dataset/val")
    p.add_argument("--surface", choices=["auto", "bench", "legacy"],
                   default="auto")
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--threshold", type=float, default=0.5,
                   help="confidence threshold for detection metrics")
    p.add_argument("--hidden_size", type=int, default=128)
    p.add_argument("--max_objects", type=int, default=10)
    p.add_argument("--compare_baseline", action="store_true")
    p.add_argument("--visualize", type=str, default=None, metavar="OUT_DIR")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    surface = args.surface
    if surface == "auto":
        surface = "legacy" if "legacy" in args.checkpoint else "bench"
        print(f"[evaluate] auto-detected surface: {surface}")
    if surface == "bench":
        raise NotImplementedError(
            "the benchmark surface's evaluation is not ported yet (ROADMAP "
            "queue 1 item 9); the port evaluates the legacy surface")
    if args.visualize:
        raise NotImplementedError(
            "--visualize is not ported yet (ROADMAP queue 1 item 16)")
    metrics = evaluate_legacy(
        args.checkpoint, args.data_dir, args.hidden_size, args.max_objects,
        args.threshold, args.iou_thresh, args.compare_baseline, args.device)
    print(json.dumps(metrics, indent=2, default=float))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(metrics, f, indent=2, default=float)


if __name__ == "__main__":
    main()
