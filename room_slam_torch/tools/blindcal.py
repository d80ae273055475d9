"""Simulated-blindness calibration of furniture synthesis (counterpart of
the JAX package's ``tools/blindcal.py``).

On an unseen real room the model draws no candidate at all for much of
the furniture, so synthesized candidates must fill the gap; an in-domain
sweep cannot see that regime because the model already emits candidates
at real furniture there. This harness simulates the failure on rooms
where labels are free: every furniture-class candidate row (LOW / MID,
and non-thin BLOCK solids) is BLINDED, its XZ center moved out of the
room, so that the post-process sees good walls and no furniture. The
synthesis options are then scored on how much furniture the injections
recover (``furn_AP@0.25``: the mean AP of classes 1 and 2).

    python -m room_slam_torch.tools.blindcal --checkpoint a/best_model \\
        --data_dir DIR --tta --output blindcal.json [--device cuda|cpu]

The forward and the sweep run on ``--device`` (``cuda`` by default,
raising without a card; the JAX tool runs on its CPU).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np

from room_slam_torch.tools.calibrate import _floats, _forward_val_set, sweep


def blind_furniture(cached: Dict, thin: float = 0.25,
                    shift: float = 1000.0) -> Dict:
    """A copy of the cached forwards with the furniture rows disabled.

    A row is furniture when its argmax class is LOW / MID, or BLOCK with a
    non-thin footprint (min(sx, sz) > ``thin``; thin BLOCK rows are walls
    and stay). Blinding shifts the XZ center by ``shift`` only: dup gates
    and IoU see nothing nearby and the extent mask removes the rows, while
    confidence and objectness stay as they were (in the real failure the
    model's furniture rows carry low but real confidence that synthesis
    reads)."""
    out = dict(cached)
    boxes = np.array(cached["pred_boxes"])            # [N, Q, 6]
    labels = np.argmax(cached["pred_logits"], -1)
    furn = ((labels == 1) | (labels == 2)
            | ((labels == 0)
               & (np.minimum(boxes[..., 3], boxes[..., 5]) > thin)))
    boxes[..., 0] = np.where(furn, boxes[..., 0] + shift, boxes[..., 0])
    boxes[..., 2] = np.where(furn, boxes[..., 2] + shift, boxes[..., 2])
    out["pred_boxes"] = boxes
    n = int(furn.sum())
    print(f"blinded {n} furniture rows "
          f"({100 * n / furn.size:.1f}% of candidates)")
    return out


def main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--thresholds", default="0,0.05")
    ap.add_argument("--nms", default="0.1,0.5")
    ap.add_argument("--soft", default="none,0.25")
    ap.add_argument("--top_k", default="none,12")
    ap.add_argument("--synthf", default="off,v1,v2")
    ap.add_argument("--qscore", default="none",
                    help="comma list of qscore weight JSONs to sweep")
    ap.add_argument("--no_blind", action="store_true",
                    help="control run: same grid without blinding")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cached = _forward_val_set(args.checkpoint, args.data_dir,
                              args.batch_size, tta=args.tta,
                              device=args.device)
    if not args.no_blind:
        cached = blind_furniture(cached)

    _sf = {"off": False, "on": "v1", "v1": "v1", "v2": "v2"}
    cells = sweep(
        cached,
        thresholds=[float(x) for x in args.thresholds.split(",")],
        nms_vals=[float(x) for x in args.nms.split(",")],
        refine_vals=[None],
        extent_vals=[1.0],
        top_k_vals=_floats(args.top_k, int),
        fuse_vals=[True],
        soft_vals=_floats(args.soft),
        synthf_vals=[_sf[x] for x in args.synthf.split(",")],
        qscore_vals=_floats(args.qscore, str),
        iou_thresholds=(0.25, 0.5),
        device=args.device,
    )
    # furniture recovery = class 1/2 AP + overall TP; with furniture rows
    # blinded, any furniture AP must come from synthesis
    for c in cells:
        aps = c.get("AP_per_class@0.25", {})
        c["furn_AP@0.25"] = round(
            (aps.get(1, 0.0) + aps.get(2, 0.0)) / 2, 4)
    cells.sort(key=lambda c: (-c["furn_AP@0.25"], -c["tp@0.25"]))
    print(f"\n{'synthf':7s} {'thr':5s} {'nms':4s} {'soft':5s} {'topk':5s} "
          f"{'qs':3s} | {'furnAP':7s} {'mAP':6s} {'tp':4s} {'f1':6s} "
          f"{'tp@.5':5s} {'npred':6s}")
    for c in cells:
        print(f"{str(c['synthf'] or 'off'):7s} {c['threshold']:<5g} "
              f"{c['nms']:<4g} {str(c['soft']):5s} {str(c['top_k']):5s} "
              f"{'y' if c['qscore'] else 'n':3s} | "
              f"{c['furn_AP@0.25']:<7.4f} {c['mAP@0.25']:<6.4f} "
              f"{c['tp@0.25']:<4d} {c['det_f1@0.25']:<6.4f} "
              f"{c['tp@0.5']:<5d} {c['num_predictions']:<6d}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"checkpoint": args.checkpoint,
                       "data_dir": args.data_dir,
                       "blinded": not args.no_blind,
                       "tta": args.tta,
                       "cells": cells}, f, indent=1)
        print(f"\nwrote {args.output}")


if __name__ == "__main__":
    main()
