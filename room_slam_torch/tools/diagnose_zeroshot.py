"""Per-GT zero-shot failure decomposition (counterpart of the JAX
package's ``tools/diagnose_zeroshot.py``): WHICH boxes fail, and WHY.

Reruns an already-scored operating point's deterministic forward and
post-process (``tools/realbench.py``) on a zero-shot directory and, for
every GT box of every capture, reports its ceiling class (contacted /
plane_inferable / unrecoverable, ``tools/ceiling.py``), the best IoU of
any same-class prediction and of any prediction (the gap is class
confusion), the best same-class candidate's XZ center error and size
ratios, and hits at IoU 0.25 / 0.5. The aggregates split the misses into
near misses (best IoU in [0.10, 0.25)) and missing candidates (< 0.10)
by ceiling class, walls / furniture and label.

    python -m room_slam_torch.tools.diagnose_zeroshot \\
        --checkpoint DIR/best_model --zero_shot_dir ROOM \\
        --threshold 0 --nms 0.1 --extent 1.0 --fuse --tta \\
        [--output diagnosis.json] [--device cuda|cpu]

Diagnostic only: no selection, no headline metric. The forward and the
post-passes run on ``--device`` (``cuda`` by default, raising without a
card).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from room_slam_torch.data import formats
from room_slam_torch.ops.iou import pairwise_iou_3d
from room_slam_torch.tools.ceiling import analyze_capture
from room_slam_torch.tools.realbench import (apply_operating_point,
                                             forward_captures)


def _center_size_errors(pred: np.ndarray, gt: np.ndarray) -> dict:
    """XZ translation and per-axis size ratio of one candidate box."""
    return {
        "center_err_xz_m": round(float(np.hypot(pred[0] - gt[0],
                                                pred[2] - gt[2])), 3),
        "center_err_y_m": round(float(abs(pred[1] - gt[1])), 3),
        "size_ratio": [round(float(pred[3 + a] / max(gt[3 + a], 1e-6)), 3)
                       for a in range(3)],
    }


def _bucket(rows: list) -> dict:
    n = len(rows)
    if not n:
        return {"n": 0}
    hits = sum(r["hit@0.25"] for r in rows)
    near = sum(0.10 <= r["best_iou"] < 0.25 for r in rows)
    blind = sum(r["best_iou"] < 0.10 for r in rows)
    confused = sum(r["best_iou"] < 0.10 <= r["best_iou_anyclass"]
                   for r in rows)
    return {"n": n, "hit@0.25": hits, "near_miss": near,
            "no_candidate": blind, "class_confusion": confused,
            "hit_rate": round(hits / n, 3)}


def diagnose(checkpoint: str, zero_shot_dir: str, cell: Dict,
             tta: bool = False, tta_reflect: bool = False,
             contact_r: float = 0.5, wall_r: float = 1.0,
             batch_size: int = 8,
             device: str | torch.device = "cuda") -> Dict:
    """The per-GT rows and the miss decomposition of ``checkpoint`` on
    ``zero_shot_dir`` at ``cell``."""
    cached = forward_captures(checkpoint, [zero_shot_dir], batch_size,
                              tta=tta, tta_reflect=tta_reflect,
                              device=device)
    dets = apply_operating_point(cached, cell, device=device)

    pairs = formats.find_data_pairs(Path(zero_shot_dir))
    report = {"checkpoint": checkpoint, "zero_shot_dir": zero_shot_dir,
              "operating_point": cell, "tta": tta, "captures": []}
    for i, (trace_file, collider_file) in enumerate(pairs):
        trace = formats.sort_by_time(formats.load_trace_json(trace_file))
        gt_boxes, gt_labels = formats.load_colliders_json(collider_file)
        ceil_rows = analyze_capture(trace, gt_boxes, gt_labels,
                                    contact_r, wall_r)
        sel = dets["img"] == i
        pb, pl = dets["boxes"][sel], dets["labels"][sel]
        rows = []
        for g, (gb, gl, cr) in enumerate(zip(gt_boxes, gt_labels,
                                             ceil_rows)):
            row = {"gt_index": g, "label": int(gl),
                   "is_wall": cr["is_wall"], "size": cr["size"],
                   "ceiling": cr["status"]}
            if len(pb):
                iou_all = pairwise_iou_3d(
                    torch.from_numpy(np.asarray(pb, np.float32)),
                    torch.from_numpy(np.asarray(gb[None, :], np.float32))
                ).numpy()[:, 0]
                row["best_iou_anyclass"] = round(float(iou_all.max()), 3)
                same = pl == gl
                if same.any():
                    j = int(np.argmax(np.where(same, iou_all, -1.0)))
                    row["best_iou"] = round(float(iou_all[j]), 3)
                    row.update(_center_size_errors(pb[j], gb))
                else:
                    row["best_iou"] = 0.0
            else:
                row["best_iou"] = 0.0
                row["best_iou_anyclass"] = 0.0
            row["hit@0.25"] = row["best_iou"] >= 0.25
            row["hit@0.5"] = row["best_iou"] >= 0.5
            rows.append(row)
        report["captures"].append({
            "name": f"{Path(zero_shot_dir).name}/{trace_file.name}",
            "num_predictions": int(sel.sum()), "boxes": rows})

    allr = [r for c in report["captures"] for r in c["boxes"]]
    agg = {"all": _bucket(allr)}
    for status in ("contacted", "plane_inferable", "unrecoverable"):
        agg[status] = _bucket([r for r in allr if r["ceiling"] == status])
    agg["walls"] = _bucket([r for r in allr if r["is_wall"]])
    agg["furniture"] = _bucket([r for r in allr if not r["is_wall"]])
    for lab in sorted({r["label"] for r in allr}):
        agg[f"label_{lab}"] = _bucket([r for r in allr
                                       if r["label"] == lab])
    report["aggregate"] = agg
    return report


def main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint prefix, or comma-list for an ensemble")
    ap.add_argument("--zero_shot_dir", default="dataset/train")
    ap.add_argument("--threshold", type=float, default=0.0)
    ap.add_argument("--nms", type=float, default=0.1)
    ap.add_argument("--extent", type=float, default=1.0)
    ap.add_argument("--top_k", type=int, default=None)
    ap.add_argument("--trust", type=float, default=0.4)
    ap.add_argument("--fuse", action="store_true")
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--ttopt", action="store_true")
    ap.add_argument("--support", type=float, default=None)
    ap.add_argument("--pen_beta", type=float, default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cell = {"threshold": args.threshold, "nms": args.nms,
            "refine": None, "trust": args.trust, "synth": False,
            "extent": args.extent, "consensus": False,
            "top_k": args.top_k, "fuse": args.fuse,
            "ttopt": args.ttopt, "support": args.support,
            "pen_beta": args.pen_beta}
    rep = diagnose(args.checkpoint, args.zero_shot_dir, cell, tta=args.tta,
                   device=args.device)
    print(f"{'capture':48s} hits  near  blind")
    for c in rep["captures"]:
        b = c["boxes"]
        print(f"{c['name']:48s} "
              f"{sum(r['hit@0.25'] for r in b):4d}  "
              f"{sum(0.10 <= r['best_iou'] < 0.25 for r in b):4d}  "
              f"{sum(r['best_iou'] < 0.10 for r in b):4d}")
    print(json.dumps(rep["aggregate"], indent=1))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rep, f, indent=2, default=float)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
