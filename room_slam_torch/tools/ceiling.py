"""Structural-ceiling decomposition (counterpart of the JAX package's
``tools/ceiling.py``): which GT boxes CAN a walking trace see?

A trace carries evidence only about objects it contacted or bounded. Each
GT box of each capture is classified, model-free and on the host:

- ``contacted``: some trace point passes within ``contact_r`` (0.5 m) of
  the box footprint;
- ``plane_inferable`` (walls only): the wall's inner face lies within
  ``wall_r`` (1.0 m) of the visited envelope's matching edge;
- ``unrecoverable``: neither; no trace-only model can localize it, so
  these bound the achievable recall.

    python -m room_slam_torch.tools.ceiling --dirs ROOM_A,ROOM_B \\
        [--output ceiling.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List

import numpy as np

from room_slam_torch.data import formats

WALL_LABEL = 0  # BLOCK


def _footprint_distance(trace_xz: np.ndarray, box: np.ndarray) -> float:
    """Min distance from any trace point to the box's XZ footprint
    rectangle (0 if a point lies inside it)."""
    cx, cz = box[0], box[2]
    hx, hz = box[3] / 2.0, box[5] / 2.0
    dx = np.maximum(np.abs(trace_xz[:, 0] - cx) - hx, 0.0)
    dz = np.maximum(np.abs(trace_xz[:, 1] - cz) - hz, 0.0)
    return float(np.sqrt(dx * dx + dz * dz).min())


def _is_wall(box: np.ndarray, label: int) -> bool:
    """Wall-like: BLOCK class, thin in one footprint axis (< 0.6 m), long
    in the other (> 1.5 m)."""
    sx, sz = box[3], box[5]
    return (label == WALL_LABEL and min(sx, sz) < 0.6
            and max(sx, sz) > 1.5)


def _wall_plane_gap(env_min, env_max, box) -> float:
    """Distance from the wall's inner face to the matching envelope edge
    (how far beyond where walking stopped the wall sits): of the two
    sides, the face closest to its envelope edge."""
    cx, cz = box[0], box[2]
    hx, hz = box[3] / 2.0, box[5] / 2.0
    if box[3] <= box[5]:  # thin in x: faces at cx +- hx, normal = x
        faces = [(cx - hx, env_max[0]), (cx + hx, env_min[0])]
    else:
        faces = [(cz - hz, env_max[1]), (cz + hz, env_min[1])]
    return min(abs(f - e) for f, e in faces)


def analyze_capture(trace: np.ndarray, boxes: np.ndarray,
                    labels: np.ndarray, contact_r: float = 0.5,
                    wall_r: float = 1.0) -> list:
    """Per-GT-box recoverability rows of one capture: ``trace [N, 4]``
    (x, y, z, t), ``boxes [M, 6]``, ``labels [M]``."""
    xz = trace[:, [0, 2]]
    env_min, env_max = xz.min(0), xz.max(0)
    rows = []
    for i, (box, lab) in enumerate(zip(boxes, labels)):
        d = _footprint_distance(xz, box)
        wall = _is_wall(box, int(lab))
        plane_gap = _wall_plane_gap(env_min, env_max, box) if wall else None
        if d <= contact_r:
            status = "contacted"
        elif wall and plane_gap <= wall_r:
            status = "plane_inferable"
        else:
            status = "unrecoverable"
        rows.append({
            "gt_index": i,
            "label": int(lab),
            "is_wall": bool(wall),
            "size": [round(float(s), 3) for s in box[3:]],
            "footprint_dist_m": round(d, 3),
            "wall_plane_gap_m": (round(plane_gap, 3)
                                 if plane_gap is not None else None),
            "status": status,
        })
    return rows


def run(dirs, contact_r: float = 0.5, wall_r: float = 1.0) -> dict:
    """Every capture's rows of ``dirs`` (trace / collider pairs), with its
    counts and recall ceiling, and the totals."""
    report = {"contact_r": contact_r, "wall_r": wall_r, "captures": []}
    totals = {"contacted": 0, "plane_inferable": 0, "unrecoverable": 0,
              "n_gt": 0}
    for d in dirs:
        for trace_file, collider_file in formats.find_data_pairs(Path(d)):
            trace = formats.sort_by_time(formats.load_trace_json(trace_file))
            boxes, labels = formats.load_colliders_json(collider_file)
            rows = analyze_capture(trace, boxes, labels, contact_r, wall_r)
            counts = {s: sum(r["status"] == s for r in rows)
                      for s in ("contacted", "plane_inferable",
                                "unrecoverable")}
            n = len(rows)
            report["captures"].append({
                "name": f"{Path(d).name}/{trace_file.name}",
                "n_gt": n,
                **counts,
                "recall_ceiling": round((n - counts["unrecoverable"])
                                        / max(n, 1), 3),
                "boxes": rows,
            })
            for s in counts:
                totals[s] += counts[s]
            totals["n_gt"] += n
    totals["recall_ceiling"] = round(
        (totals["n_gt"] - totals["unrecoverable"])
        / max(totals["n_gt"], 1), 3)
    report["totals"] = totals
    return report


def main(argv: List[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dirs", default="dataset/train,dataset/val")
    p.add_argument("--contact_r", type=float, default=0.5)
    p.add_argument("--wall_r", type=float, default=1.0)
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    dirs = [d for d in args.dirs.split(",") if Path(d).is_dir()]
    report = run(dirs, args.contact_r, args.wall_r)
    for cap in report["captures"]:
        print(f"{cap['name']:48s} gt={cap['n_gt']:2d} "
              f"contact={cap['contacted']:2d} "
              f"plane={cap['plane_inferable']:2d} "
              f"unrec={cap['unrecoverable']:2d} "
              f"ceiling={cap['recall_ceiling']:.2f}")
        for r in cap["boxes"]:
            if r["status"] == "unrecoverable":
                gap = (f"wall gap={r['wall_plane_gap_m']}m"
                       if r["is_wall"] else "")
                print(f"    gt{r['gt_index']:2d} label={r['label']} "
                      f"size={r['size']} dist={r['footprint_dist_m']}m "
                      f"{gap}")
    t = report["totals"]
    print(f"\nTOTAL: {t['n_gt']} GT | contacted {t['contacted']} | "
          f"plane-inferable {t['plane_inferable']} | "
          f"unrecoverable {t['unrecoverable']} | "
          f"recall ceiling {t['recall_ceiling']:.2f}")
    if args.output:
        Path(args.output).write_text(
            json.dumps(report, indent=2, default=float))


if __name__ == "__main__":
    main()
