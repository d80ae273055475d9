"""Quality-parity harness (the JAX package's ``tools/parity.py``): score
checkpoints, the port's or the JAX package's (msgpack stems) and the
reference's (``.pth``, imported through ``train/torch_import.py``), with
one evaluator on the same data.

    python -m room_slam_torch.tools.parity \\
        --checkpoints ours=DIR/best_model reference=DIR/best_model.pth \\
        --data_dir DIR [--batch_size 8] [--iou_thresh 0.5] \\
        [--threshold 0.5] [--nms 0.3] [--refine CLEARANCE] \\
        [--extent_slack METERS] [--consensus] [--output results.json] \\
        [--device cuda|cpu]

Prints the results as JSON and, for two checkpoints, the mAP delta line.
``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from room_slam_torch.evaluate import benchmark_rows
from room_slam_torch.train.metrics import (average_precision_3d,
                                           summarize_metrics)


def score_checkpoint(checkpoint: str, data_dir: str, batch_size: int = 8,
                     iou_thresh: float = 0.5, threshold: float = 0.5,
                     nms: float = 0.3,
                     refine_clearance: float | None = None,
                     extent_slack: float | None = None,
                     consensus: bool = False,
                     device: str | torch.device = "cuda") -> Dict:
    """Hungarian-aligned metrics and 3D mAP for one checkpoint.

    ``refine_clearance`` applies the trace-informed wall refinement and
    ``extent_slack`` the outside-extent suppression (``ops/refine.py``),
    each the same for every checkpoint scored."""
    acc, pred_rows, gt_rows = benchmark_rows(
        checkpoint, data_dir, batch_size, iou_thresh, threshold, nms,
        consensus, device, refine=refine_clearance,
        extent_slack=extent_slack)
    metrics = summarize_metrics(acc)
    if pred_rows and gt_rows:
        mAP, aps = average_precision_3d(
            np.stack([r[0] for r in pred_rows]),
            np.asarray([r[1] for r in pred_rows]),
            np.asarray([r[2] for r in pred_rows]),
            np.asarray([r[3] for r in pred_rows]),
            np.stack([r[0] for r in gt_rows]),
            np.asarray([r[1] for r in gt_rows]),
            np.asarray([r[2] for r in gt_rows]),
            iou_thresh=iou_thresh)
        metrics["mAP"] = mAP
        metrics["AP_per_class"] = {int(k): round(v, 4)
                                   for k, v in aps.items()}
    else:
        metrics["mAP"] = 0.0
    metrics["num_predictions"] = len(pred_rows)
    return metrics


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoints", nargs="+", required=True,
                   help="name=path pairs; .pth paths are torch-imported")
    p.add_argument("--data_dir", type=str, default="dataset/val")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--nms", type=float, default=0.3)
    p.add_argument("--refine", type=float, default=None, metavar="CLEARANCE",
                   help="apply trace-informed wall refinement "
                        "(ops/refine.py) to EVERY checkpoint scored")
    p.add_argument("--extent_slack", type=float, default=None,
                   metavar="METERS",
                   help="suppress predictions entirely outside trace extent"
                        " + margin, for EVERY checkpoint scored")
    p.add_argument("--consensus", action="store_true",
                   help="cluster-size consensus rescoring (rank-only), for "
                        "EVERY checkpoint scored")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    results = {}
    for spec in args.checkpoints:
        name, _, path = spec.partition("=")
        print(f"scoring {name}: {path}")
        results[name] = score_checkpoint(
            path, args.data_dir, args.batch_size, args.iou_thresh,
            args.threshold, args.nms, refine_clearance=args.refine,
            extent_slack=args.extent_slack, consensus=args.consensus,
            device=args.device)

    print(json.dumps(results, indent=2, default=float))
    names = list(results)
    if len(names) == 2:
        a, b = names
        delta = results[a]["mAP"] - results[b]["mAP"]
        print(f"\nmAP delta ({a} - {b}): {delta:+.4f} "
              f"({'within' if abs(delta) <= 0.005 or delta > 0 else 'OUTSIDE'}"
              " the 0.5-point parity gate when negative)")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2, default=float)


if __name__ == "__main__":
    main()
