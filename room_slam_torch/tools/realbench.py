"""Aggregate capture benchmark (counterpart of the JAX package's
``tools/realbench.py``): score a checkpoint on every capture of several
directories at ONE operating point, with per-capture rows, per-directory
aggregates and a bootstrap confidence interval over captures.

    python -m room_slam_torch.tools.realbench --checkpoint DIR/best_model \\
        --dirs ROOM_A,ROOM_B [--calib_dir HELD_OUT] [--threshold 0.5 ...] \\
        [--bootstrap 2000] [--output realbench.json] [--device cuda|cpu]

The operating point is given by the flags or chosen by a calibration sweep
on a separate directory (``--calib_dir``, never the scored captures). Each
capture is one "image": VOC greedy assignment makes every prediction's
TP/FP flag depend only on its own capture, so the pooled AP of any
bootstrap resample is a merge of precomputed per-capture (score, tp)
lists. The forward and the post-passes run on ``--device`` (``cuda`` by
default, raising without a card; the JAX tool defaults to its CPU); the
per-capture scoring is host numpy.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from room_slam_torch import resolve_device
from room_slam_torch.ops import qscore as qscore_ops
from room_slam_torch.ops import refine
from room_slam_torch.ops.iou import pairwise_iou_3d
from room_slam_torch.ops.nms import post_process
from room_slam_torch.ops.ttopt import (TTOptParams, adapt_boxes,
                                       penetration_depth)
from room_slam_torch.tools.calibrate import (_floats, _forward_val_set,
                                             device_cache, per_room, sweep)

# the reference dataset's capture directories, relative to the working
# directory (the evaluation CLI's default is dataset/val too)
REF_DIRS = ("dataset/train", "dataset/val")
IOU_THRESHOLDS = (0.25, 0.5)


def forward_captures(checkpoint: str, dirs, batch_size: int = 8,
                     tta: bool = False, tta_reflect: bool = False,
                     tta_scales: tuple = (), tta_windows: int = 0,
                     device: str | torch.device = "cuda") -> Dict:
    """Cached forwards over every capture of every directory,
    concatenated; capture names are prefixed by their directory's name."""
    parts = [_forward_val_set(checkpoint, d, batch_size, tta=tta,
                              tta_reflect=tta_reflect,
                              tta_scales=tta_scales,
                              tta_windows=tta_windows, device=device)
             for d in dirs]
    out = {}
    for k in parts[0]:
        if k == "names":
            out[k] = [f"{Path(d).name}/{n}"
                      for d, p in zip(dirs, parts) for n in p["names"]]
        elif all(k in p for p in parts):
            out[k] = np.concatenate([p[k] for p in parts])
    return out


def capture_confidence(cached: Dict) -> np.ndarray:
    """Per-capture auto-gate signal ``[N]``: the largest pooled candidate
    confidence, softmax(class logits) x sigmoid(objectness), read from the
    raw model outputs (before synthesis appends rows)."""
    probs = torch.softmax(torch.from_numpy(
        np.asarray(cached["pred_logits"], np.float32)), dim=-1).numpy()
    conf = probs.max(-1)
    if cached.get("pred_objectness") is not None:
        conf = conf / (1.0 + np.exp(
            -np.asarray(cached["pred_objectness"])))
    return conf.max(-1)


def apply_operating_point(cached: Dict, cell: Dict,
                          refine_furniture: bool = False,
                          device: str | torch.device = "cuda") -> Dict:
    """Post-process cached forwards at ONE operating point on ``device``,
    room by room, in the calibration sweep's order: refine, the ``ycal``
    floor / ceiling snap, wall synthesis, furniture synthesis, ttopt (its
    ``"auto"`` tau gates it per capture on ``capture_confidence``), the
    extent mask, physics and learned rescoring (``qscore_auto`` gates the
    latter), ``post_process``.

    Returns ``{boxes [P, 6], labels [P], conf [P], img [P]}`` of the kept
    detections."""
    dev = resolve_device(device)
    c = device_cache(cached, dev)
    raw, length = c["raw"], c["length"]
    boxes, logits = c["pred_boxes"], c["pred_logits"]
    obj = c.get("pred_objectness")
    rf = cell.get("refine")
    if rf is not None:
        tr = cell.get("trust", 0.4)
        boxes = per_room(
            lambda b, lab, r, n: refine.refine_walls(
                b, lab, r, n, clearance=rf, trust=tr,
                furniture_aware=refine_furniture),
            boxes, logits.argmax(-1), raw, length)

    yc = cell.get("ycal")
    if yc is not None:
        # before synthesis, so that synthesized walls take the snapped
        # heights
        fl, ce = float(yc[0]), float(yc[1])
        boxes = per_room(lambda b, lab: refine.snap_y_planes(b, lab, fl, ce),
                         boxes, logits.argmax(-1))

    base_valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
    if cell.get("synth"):
        obj_in = torch.zeros(boxes.shape[:2], device=dev) if obj is None \
            else obj
        boxes, logits, so, base_valid = per_room(
            lambda b, lg, o, r, n: refine.synthesize_walls(
                b, lg, o, r, n, clearance=rf if rf is not None else 0.3,
                furniture_aware=refine_furniture),
            boxes, logits, obj_in, raw, length)
        if obj is not None:
            obj = so

    if cell.get("synthf"):
        # True or "v1": interior holes; "v2" adds boundary-notch and
        # tall-BLOCK hypotheses
        fn = (refine.synthesize_furniture_v2 if cell["synthf"] == "v2"
              else refine.synthesize_furniture)
        Qb = boxes.shape[1]
        boxes, logits, obj, nv = per_room(fn, boxes, logits, obj, raw,
                                          length)
        base_valid = torch.cat([base_valid, nv[:, Qb:]], dim=1)

    if cell.get("ttopt"):
        # after refine / synthesis, before the extent mask; an "auto" key
        # adapts only the captures whose largest raw candidate confidence
        # is below it
        tcfg = dict(cell["ttopt"]) if isinstance(cell["ttopt"], dict) \
            else {}
        tau = tcfg.pop("auto", None)
        tp = TTOptParams(**tcfg)
        adapted = per_room(lambda b, r, n: adapt_boxes(b, r, n, tp),
                           boxes, raw, length)
        if tau is None:
            boxes = adapted
        else:
            use = torch.from_numpy(capture_confidence(cached)
                                   < float(tau)).to(dev)
            boxes = torch.where(use[:, None, None], adapted, boxes)

    ext = cell.get("extent")
    cand = base_valid
    if ext is not None:
        # BEFORE NMS / top_k (post_process's candidate_mask)
        cand = cand & ~per_room(
            lambda b, r, n: refine.outside_extent_mask(b, r, n, slack=ext),
            boxes, raw, length)

    pen_beta = cell.get("pen_beta")
    if pen_beta is not None:
        conf_scale = torch.exp(-pen_beta * per_room(penetration_depth, boxes,
                                                    raw, length))
    else:
        conf_scale = torch.ones(boxes.shape[:2], device=dev)

    if cell.get("qscore"):
        qp = qscore_ops.load_params(cell["qscore"], dev)
        qsc = per_room(
            lambda b, lg, o, r, n: qscore_ops.quality_scale(qp, b, lg, o, r,
                                                            n),
            boxes, logits, obj, raw, length)
        qtau = cell.get("qscore_auto")
        if qtau is not None:
            # the ttopt gate's signal: rerank only the captures the model
            # is unsure about
            use = torch.from_numpy(capture_confidence(cached)
                                   < float(qtau)).to(dev)
            qsc = torch.where(use[:, None], qsc, torch.ones_like(qsc))
        conf_scale = conf_scale * qsc

    kept = per_room(
        lambda b, lg, o, cm, s: torch.cat([
            t.to(torch.float32).reshape(b.shape[0], -1)
            for t in post_process(
                b, lg, confidence_threshold=cell["threshold"],
                nms_threshold=cell["nms"],
                consensus=cell.get("consensus", False),
                top_k=cell.get("top_k"), objectness=o, candidate_mask=cm,
                fuse=cell.get("fuse", False), return_boxes=True,
                support=cell.get("support"), conf_scale=s,
                soft_sigma=cell.get("soft"))], -1),
        boxes, logits, obj, cand, conf_scale).cpu().numpy()
    keep = kept[..., 0] > 0.5
    img, flat = np.nonzero(keep)
    return {"boxes": kept[img, flat, 3:], "labels":
            kept[img, flat, 1].astype(np.int32),
            "conf": kept[img, flat, 2], "img": img}


def _capture_flags(dets: Dict, gts: Dict, n_img: int) -> list:
    """Per-capture VOC TP/FP flags: per capture ``{(iou_t, cls):
    (scores_desc, tp_flags)}`` plus ``npos`` per class and ``npred``.
    Greedy assignment inside one capture in descending-score order
    reproduces the pooled evaluator exactly. Host numpy (the IoU on CPU
    tensors)."""
    per_cap = []
    for i in range(n_img):
        p_sel = dets["img"] == i
        g_sel = gts["img"] == i
        pb, pl = dets["boxes"][p_sel], dets["labels"][p_sel]
        ps = dets["conf"][p_sel]
        gb, gl = gts["boxes"][g_sel], gts["labels"][g_sel]
        entry = {"npred": int(p_sel.sum()),
                 "npos": {int(c): int((gl == c).sum()) for c in np.unique(gl)},
                 "flags": {}}
        # classes with predictions but no same-class GT in this capture
        # still contribute FPs to the class's pooled precision curve
        for c in np.union1d(np.unique(gl), np.unique(pl)):
            pc = pl == c
            if pc.sum() == 0:
                continue
            order = np.argsort(-ps[pc], kind="stable")
            pbox = pb[pc][order]
            score = ps[pc][order]
            n_gt = int((gl == c).sum())
            if n_gt == 0:
                for t in IOU_THRESHOLDS:
                    entry["flags"][(t, int(c))] = (
                        score, np.zeros(len(pbox)))
                continue
            iou = pairwise_iou_3d(
                torch.from_numpy(np.asarray(pbox, np.float32)),
                torch.from_numpy(np.asarray(gb[gl == c], np.float32))
            ).numpy()
            for t in IOU_THRESHOLDS:
                taken = np.zeros(iou.shape[1], dtype=bool)
                tp = np.zeros(len(pbox))
                for r in range(len(pbox)):
                    j = int(np.argmax(iou[r])) if iou.shape[1] else 0
                    if iou.shape[1] and iou[r, j] >= t and not taken[j]:
                        taken[j] = True
                        tp[r] = 1.0
                entry["flags"][(t, int(c))] = (score, tp)
        per_cap.append(entry)
    return per_cap


def _pool_metrics(per_cap: list, caps: np.ndarray) -> Dict:
    """Pooled mAP / det-P/R/F1 over a multiset of capture indices (a numpy
    merge of the precomputed per-capture flags)."""
    out = {}
    for t in IOU_THRESHOLDS:
        npos = {}
        merged = {}
        npred = 0
        tp_total = 0.0
        for i in caps:
            e = per_cap[i]
            npred += e["npred"]
            for c, n in e["npos"].items():
                npos[c] = npos.get(c, 0) + n
            for (tt, c), (score, tp) in e["flags"].items():
                if tt != t:
                    continue
                merged.setdefault(c, []).append((score, tp))
                tp_total += tp.sum()
        aps = {}
        for c, n in npos.items():
            if n == 0:
                continue
            if c not in merged:
                aps[c] = 0.0
                continue
            score = np.concatenate([s for s, _ in merged[c]])
            tp = np.concatenate([f for _, f in merged[c]])
            order = np.argsort(-score, kind="stable")
            tp_c = np.cumsum(tp[order])
            fp_c = np.cumsum(1.0 - tp[order])
            recall = tp_c / n
            precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
            ap = 0.0
            for r in np.linspace(0, 1, 101):
                m = recall >= r
                ap += precision[m].max() if m.any() else 0.0
            aps[c] = ap / 101
        npos_total = sum(npos.values())
        prec = tp_total / max(npred, 1)
        rec = tp_total / max(npos_total, 1)
        out[f"mAP@{t}"] = float(np.mean(list(aps.values()))) if aps else 0.0
        out[f"AP_per_class@{t}"] = {c: round(float(v), 4)
                                    for c, v in aps.items()}
        out[f"det_precision@{t}"] = prec
        out[f"det_recall@{t}"] = rec
        out[f"det_f1@{t}"] = (2 * prec * rec / (prec + rec)
                              if prec + rec > 0 else 0.0)
        out[f"tp@{t}"] = int(tp_total)
    out["num_predictions"] = int(sum(per_cap[i]["npred"] for i in caps))
    out["num_gt"] = int(sum(sum(per_cap[i]["npos"].values()) for i in caps))
    return out


def run(checkpoint: str, dirs, cell: Dict, bootstrap: int = 2000,
        refine_furniture: bool = False, batch_size: int = 8,
        seed: int = 0, tta: bool = False, tta_reflect: bool = False,
        tta_scales: tuple = (), tta_windows: int = 0,
        device: str | torch.device = "cuda") -> Dict:
    """The report of ``checkpoint`` on the captures of ``dirs`` at ``cell``:
    the aggregate, per-directory aggregates (with mixed-in training
    captures only the other directories are zero-shot), per-capture rows
    and, with ``bootstrap`` resamples of the captures drawn from
    ``numpy.random.default_rng(seed)``, the 95% intervals."""
    cached = forward_captures(checkpoint, dirs, batch_size, tta=tta,
                              tta_reflect=tta_reflect,
                              tta_scales=tta_scales,
                              tta_windows=tta_windows, device=device)
    dets = apply_operating_point(cached, cell, refine_furniture, device)
    n_img = cached["pred_boxes"].shape[0]
    g_img, g_flat = np.nonzero(cached["gt_valid"])
    gts = {"boxes": cached["gt_boxes"][g_img, g_flat],
           "labels": cached["gt_labels"][g_img, g_flat], "img": g_img}
    per_cap = _capture_flags(dets, gts, n_img)

    all_caps = np.arange(n_img)
    report = {
        "operating_point": cell,
        "captures": [],
        "aggregate": _pool_metrics(per_cap, all_caps),
    }
    dirs_of = [n.split("/")[0] for n in cached["names"]]
    report["per_dir"] = {}
    for d in dict.fromkeys(dirs_of):
        caps = np.array([i for i, dd in enumerate(dirs_of) if dd == d])
        report["per_dir"][d] = _pool_metrics(per_cap, caps)
    for i in range(n_img):
        row = {"name": cached["names"][i]}
        row.update({k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in _pool_metrics(per_cap, np.array([i])).items()
                    if not k.startswith("AP_per_class")})
        report["captures"].append(row)
    if bootstrap:
        rng = np.random.default_rng(seed)
        stats = {f"mAP@{t}": [] for t in IOU_THRESHOLDS}
        stats.update({f"det_f1@{t}": [] for t in IOU_THRESHOLDS})
        for _ in range(bootstrap):
            caps = rng.integers(0, n_img, size=n_img)
            m = _pool_metrics(per_cap, caps)
            for k in stats:
                stats[k].append(m[k])
        report["bootstrap"] = {
            k: {"lo": round(float(np.percentile(v, 2.5)), 4),
                "hi": round(float(np.percentile(v, 97.5)), 4),
                "median": round(float(np.percentile(v, 50)), 4)}
            for k, v in stats.items()}
        report["bootstrap"]["resamples"] = bootstrap
    return report


def choose_cell(checkpoint: str, calib_dir: str, select: str = "mAP@0.25",
                batch_size: int = 8, refine_furniture: bool = False,
                tta: bool = False, tta_reflect: bool = False,
                tta_scales: tuple = (),
                device: str | torch.device = "cuda") -> Dict:
    """Sweep the calibration grid on a held-out directory and return the
    best cell by ``select`` (calibrate on A, score on B). ``tta`` /
    ``tta_reflect`` must match the scoring run."""
    cached = _forward_val_set(checkpoint, calib_dir, batch_size, tta=tta,
                              tta_reflect=tta_reflect,
                              tta_scales=tta_scales, device=device)
    cells = sweep(cached, thresholds=(0.0, 0.3, 0.5, 0.7),
                  nms_vals=(0.1, 0.3),
                  refine_vals=(None, 0.55), extent_vals=(None, 0.75),
                  consensus_vals=(False, True),
                  top_k_vals=(None, 10, 15),
                  refine_furniture=refine_furniture,
                  trust_vals=(0.4, 0.8), synth_vals=(False, True),
                  device=device)
    cells.sort(key=lambda c: (-c[select], -c["mAP@0.5"]))
    best = cells[0]
    return {k: best.get(k) for k in
            ("threshold", "nms", "refine", "trust", "synth", "ttopt",
             "extent", "consensus", "top_k", "support", "pen_beta")}


def main(argv: List[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint stem, or comma-separated stems to "
                        "pool as a seed ensemble")
    p.add_argument("--dirs", default=",".join(REF_DIRS),
                   help="comma list of capture directories to score")
    p.add_argument("--calib_dir", default=None,
                   help="held-out directory to choose the operating point on"
                        " (otherwise --threshold/--nms/... are used as-is)")
    p.add_argument("--select", default="mAP@0.25",
                   help="metric the calibration sweep optimizes")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--nms", type=float, default=0.3)
    p.add_argument("--refine", default="none")
    p.add_argument("--trust", type=float, default=0.4,
                   help="wall-refine max snap distance (m)")
    p.add_argument("--synth", action="store_true",
                   help="inject the 4 extent-implied wall candidates")
    p.add_argument("--extent", default="none")
    p.add_argument("--consensus", action="store_true")
    p.add_argument("--top_k", type=int, default=None,
                   help="keep only the K best detections after NMS")
    p.add_argument("--fuse", action="store_true",
                   help="weighted box fusion of the NMS clusters")
    p.add_argument("--ttopt", action="store_true",
                   help="test-time trace-consistency adaptation of the "
                        "candidate boxes")
    p.add_argument("--ttopt_params", default=None,
                   help="JSON dict of TTOptParams overrides applied when "
                        "--ttopt is set (e.g. '{\"deadband\": 0.15}'; "
                        "'auto': tau gates it per capture)")
    p.add_argument("--support", default="none",
                   help="support-ordered NMS: vote IoU threshold (e.g. "
                        "0.25)")
    p.add_argument("--pen_beta", default="none",
                   help="physics rescoring strength: confidence scaled by "
                        "exp(-beta * mean penetration depth)")
    p.add_argument("--soft", default="none",
                   help="soft-NMS Gaussian sigma; --nms becomes the "
                        "tight-duplicate fusion threshold")
    p.add_argument("--qscore_auto", default="none",
                   help="per-capture confidence gate for --qscore")
    p.add_argument("--qscore", default="none",
                   help="learned-quality weight JSON (tools/qscore.py) "
                        "applied as conf_scale rescoring")
    p.add_argument("--synthf", nargs="?", const="v1", default=None,
                   choices=["v1", "v2"],
                   help="inject hole-implied furniture candidates (bare "
                        "flag / 'v1'; 'v2' adds notch and tall-BLOCK "
                        "hypotheses)")
    p.add_argument("--ycal", default="none",
                   help="seen-room Y-plane calibration: a colliders.json "
                        "path or 'floor,ceil' in metres; snaps tall BLOCK "
                        "predictions to those planes")
    p.add_argument("--refine_furniture", action="store_true")
    p.add_argument("--bootstrap", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tta", action="store_true",
                   help="pool the un-rotated candidates of the four "
                        "90-degree forwards")
    p.add_argument("--tta_reflect", action="store_true",
                   help="also pool the x-mirrored copy of every view")
    p.add_argument("--tta_scales", default="",
                   help="comma list of extra uniform scales to forward "
                        "every view at")
    p.add_argument("--tta_windows", type=int, default=0,
                   help=">= 2: pool that many overlapping full-resolution "
                        "temporal windows of each capture")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)

    dirs = [d for d in args.dirs.split(",") if d]
    missing = [d for d in dirs if not Path(d).is_dir()]
    if missing:
        raise SystemExit(f"capture directories not found: {missing}")

    tta_scales = tuple(float(x) for x in args.tta_scales.split(",") if x)
    ttopt = ((json.loads(args.ttopt_params) if args.ttopt_params else True)
             if args.ttopt else False)
    if args.calib_dir:
        cell = choose_cell(args.checkpoint, args.calib_dir, args.select,
                           args.batch_size, args.refine_furniture,
                           tta=args.tta, tta_reflect=args.tta_reflect,
                           tta_scales=tta_scales, device=args.device)
        cell["calibrated_on"] = args.calib_dir
        cell.setdefault("fuse", args.fuse)
        if args.ttopt:
            cell["ttopt"] = ttopt
        # dimensions outside choose_cell's grid merge into the calibrated
        # cell: a requested flag is never dropped
        if args.soft != "none":
            cell["soft"] = float(args.soft)
        if args.support != "none":
            cell["support"] = float(args.support)
        if args.pen_beta != "none":
            cell["pen_beta"] = float(args.pen_beta)
        if args.synthf:
            cell["synthf"] = args.synthf
        if args.qscore != "none":
            cell["qscore"] = args.qscore
        if args.qscore_auto != "none":
            cell["qscore_auto"] = float(args.qscore_auto)
        print(f"operating point from {args.calib_dir}: {cell}")
    else:
        cell = {"threshold": args.threshold, "nms": args.nms,
                "refine": _floats(args.refine)[0], "trust": args.trust,
                "synth": args.synth, "extent": _floats(args.extent)[0],
                "consensus": args.consensus, "top_k": args.top_k,
                "fuse": args.fuse, "ttopt": ttopt,
                "support": _floats(args.support)[0],
                "pen_beta": _floats(args.pen_beta)[0],
                "soft": _floats(args.soft)[0],
                "synthf": args.synthf or False,
                "qscore": None if args.qscore == "none" else args.qscore,
                "qscore_auto": _floats(args.qscore_auto)[0]}
    if args.ycal != "none":
        if "," in args.ycal and not Path(args.ycal).exists():
            cell["ycal"] = [float(x) for x in args.ycal.split(",")]
        else:
            cell["ycal"] = list(refine.y_planes_from_colliders(args.ycal))
    cell["tta"] = args.tta
    cell["tta_reflect"] = args.tta_reflect
    if tta_scales:
        cell["tta_scales"] = list(tta_scales)
    if args.tta_windows:
        cell["tta_windows"] = args.tta_windows

    report = run(args.checkpoint, dirs, cell, args.bootstrap,
                 args.refine_furniture, args.batch_size, tta=args.tta,
                 tta_reflect=args.tta_reflect, tta_scales=tta_scales,
                 tta_windows=args.tta_windows, device=args.device)
    agg = report["aggregate"]
    print(f"\n=== {len(report['captures'])} captures, "
          f"{agg['num_gt']} GT boxes, {agg['num_predictions']} predictions")
    for row in report["captures"]:
        print(f"  {row['name']:48s} tp@0.25={row['tp@0.25']:2d}"
              f"/{row['num_gt']:2d}  det_f1@0.25={row['det_f1@0.25']:.3f}"
              f"  mAP@0.25={row['mAP@0.25']:.3f}")
    for t in IOU_THRESHOLDS:
        print(f"aggregate @IoU{t}: mAP={agg[f'mAP@{t}']:.4f} "
              f"det_f1={agg[f'det_f1@{t}']:.4f} "
              f"P={agg[f'det_precision@{t}']:.3f} "
              f"R={agg[f'det_recall@{t}']:.3f} tp={agg[f'tp@{t}']}")
    for d, m in report["per_dir"].items():
        print(f"room[{d}] @IoU0.25: mAP={m['mAP@0.25']:.4f} "
              f"det_f1={m['det_f1@0.25']:.4f} tp={m['tp@0.25']}"
              f"/{m['num_gt']}")
    if "bootstrap" in report:
        for k in ("mAP@0.25", "det_f1@0.25"):
            b = report["bootstrap"][k]
            print(f"bootstrap {k}: median={b['median']:.4f} "
                  f"95% CI [{b['lo']:.4f}, {b['hi']:.4f}]")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2, default=float)
        print(f"\nwrote {args.output}")


if __name__ == "__main__":
    main()
