"""Detection-calibration sweep (counterpart of the JAX package's
``tools/calibrate.py``): forward the validation set once, cache the
outputs, and score every cell of a grid of post-processing operating
points (confidence threshold, NMS IoU, wall refine, synthesis, ttopt,
extent mask, consensus, top-K, fusion, support, physics and learned
rescoring, soft-NMS) from the cache, so an N-cell sweep costs one model
pass.

    python -m room_slam_torch.tools.calibrate --checkpoint DIR/best_model \\
        --data_dir DIR --thresholds 0.3,0.5,0.7 --nms 0.1,0.3,0.5 \\
        --refine none,0.3,0.55 [--tta --tta_reflect --tta_windows 2] \\
        [--eval_dir HELD_OUT] [--output sweep.json] [--device cuda|cpu]

The flags, the cells' keys and the JSON are the JAX tool's. The forward
runs on the card through the model's recurrence kernels (the flagship's
``bilstm_fwd``, a ``bigru``'s ``bigru_fwd``), and so does the sweep: every
post-pass runs per room in a loop on the device (the JAX tool ``vmap``s
them; the greedy NMS's data-dependent loops do not vectorize over rooms).
``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given (the JAX tool defaults to its CPU).
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from room_slam_torch import resolve_device
from room_slam_torch.data import formats
from room_slam_torch.data.augment import (reflect_raw, rotate_raw, scale_raw,
                                          unreflect_boxes, unrotate_boxes,
                                          unscale_boxes)
from room_slam_torch.data.dataset import TraceColliderArrays
from room_slam_torch.data.features import featurize
from room_slam_torch.ops import qscore as qscore_ops
from room_slam_torch.ops import refine
from room_slam_torch.ops.nms import post_process
from room_slam_torch.ops.ttopt import (TTOptParams, adapt_boxes,
                                       penetration_depth)
from room_slam_torch.train.driver import load_model_for_inference
from room_slam_torch.train.metrics import average_precision_3d, detection_prf


def window_fractions(n_windows: int, overlap: float = 0.1) -> list:
    """``n_windows`` overlapping (start, end) fractions covering [0, 1]."""
    if n_windows < 2:
        return []
    width = (1.0 + overlap * (n_windows - 1)) / n_windows
    step = (1.0 - width) / (n_windows - 1)
    return [(i * step, i * step + width) for i in range(n_windows)]


def _window_variants(ds: TraceColliderArrays, data_dir: str, L: int,
                     n_windows: int) -> List[TraceColliderArrays]:
    """Copies of ``ds`` whose traces are ``n_windows`` overlapping temporal
    windows of each full-resolution trace file, each downsampled to
    ``L`` points."""
    pairs = formats.find_data_pairs(Path(data_dir))
    fulls = [formats.sort_by_time(formats.load_trace_json(t))
             for t, _ in pairs]
    out = []
    for f0, f1 in window_fractions(n_windows):
        ds_w = copy.copy(ds)
        ds_w.raw = np.zeros_like(ds.raw)
        ds_w.length = np.zeros_like(ds.length)
        for i, arr in enumerate(fulls):
            lo = int(f0 * arr.shape[0])
            hi = max(int(f1 * arr.shape[0]), lo + 1)
            win = formats.linspace_downsample(arr[lo:hi], L)
            ds_w.raw[i, :win.shape[0]] = win
            ds_w.length[i] = max(win.shape[0], 1)
        out.append(ds_w)
    return out


def _forward_val_set(checkpoint: str, data_dir: str, batch_size: int,
                     tta: bool = False, tta_reflect: bool = False,
                     tta_scales: tuple = (), tta_windows: int = 0,
                     device: str | torch.device = "cuda") -> Dict:
    """The model's deterministic outputs over every sample of ``data_dir``
    as host arrays: ``pred_boxes [N, V·Q, 6]``, ``pred_logits``,
    ``pred_objectness`` (where the model has the head), the full-trace
    ``raw`` / ``length``, ``gt_boxes`` / ``gt_labels`` / ``gt_valid`` and
    ``names``.

    Each batch of ``batch_size`` rows (the last padded, its padding rows
    dropped) is forwarded in every view: ``tta`` the four 90-degree Y
    rotations, ``tta_reflect`` the x-mirrored copy of each, ``tta_scales``
    every view again at those scales (scales outer, then reflection, then
    rotations), and with ``tta_windows`` >= 2 all of them again on that
    many overlapping temporal windows re-downsampled from the
    full-resolution trace files. Boxes return to the capture frame and
    the V views' candidates pool along the query axis; one host copy a
    batch. ``checkpoint`` may be a comma list: every checkpoint's
    candidates pool the same way (``pred_objectness`` is dropped unless
    every checkpoint has it)."""
    ckpts = [c for c in str(checkpoint).split(",") if c]
    if len(ckpts) > 1:
        parts = [_forward_val_set(c, data_dir, batch_size, tta, tta_reflect,
                                  tta_scales, tta_windows, device)
                 for c in ckpts]
        out = dict(parts[0])
        for k in ("pred_boxes", "pred_logits", "pred_objectness"):
            if all(k in p for p in parts):
                out[k] = np.concatenate([p[k] for p in parts], axis=1)
            else:
                out.pop(k, None)
        return out

    model, cfg = load_model_for_inference(checkpoint, device)
    dev = next(model.parameters()).device
    ds = TraceColliderArrays(data_dir, cfg.data, augment=False, verbose=False)
    variants = [ds]
    if tta_windows >= 2:
        variants += _window_variants(ds, data_dir, cfg.data.max_trace_len,
                                     tta_windows)
    geom_views = [(k, m, s) for s in (1.0, *tta_scales)
                  for m in ((0, 1) if tta_reflect else (0,))
                  for k in (range(4) if tta else (0,))]

    rows: Dict[str, list] = {k: [] for k in (
        "pred_boxes", "pred_logits", "raw", "length", "gt_boxes",
        "gt_labels", "gt_valid")}
    batch_iters = [v.epoch_batches(batch_size, shuffle=False)
                   for v in variants]
    for batches in zip(*batch_iters):
        pooled = []
        with torch.inference_mode():
            for batch_v in batches:
                raw = torch.from_numpy(batch_v["raw"]).to(dev)
                length = torch.from_numpy(batch_v["length"]).to(dev)
                for k, m, s in geom_views:
                    ks = torch.full((raw.shape[0],), k, device=dev)
                    raw_k = scale_raw(raw, s) if s != 1.0 else raw
                    raw_k = reflect_raw(raw_k) if m else raw_k
                    raw_k = rotate_raw(raw_k, ks) if k else raw_k
                    fwd = model(*featurize(raw_k, length))
                    b = fwd["pred_boxes"]
                    if k:
                        b = unrotate_boxes(b, ks)
                    if m:
                        b = unreflect_boxes(b)
                    if s != 1.0:
                        b = unscale_boxes(b, s)
                    obj = fwd.get("pred_objectness")
                    pooled.append(torch.cat(
                        [b, fwd["pred_classes"]]
                        + ([] if obj is None else [obj[..., None]]), -1))
            # one host copy a batch: [B, V·Q, 6 + C (+ 1)]
            host = torch.cat(pooled, 1).float().cpu().numpy()
        batch = batches[0]      # the full-trace variant: raw, GT, weights
        keep = np.where(batch["weight"] != 0)[0]
        C = fwd["pred_classes"].shape[-1]
        rows["pred_boxes"].append(host[keep, :, :6])
        rows["pred_logits"].append(host[keep, :, 6:6 + C])
        if obj is not None:
            rows.setdefault("pred_objectness", []).append(
                host[keep, :, 6 + C])
        for k in ("raw", "length"):
            rows[k].append(batch[k][keep])
        rows["gt_boxes"].append(batch["boxes"][keep])
        rows["gt_labels"].append(batch["labels"][keep])
        rows["gt_valid"].append(batch["valid"][keep])
    out = {k: np.concatenate(v) for k, v in rows.items()}
    # shuffle=False and augment=False: the batches' order is the base order
    out["names"] = list(ds.names)[:out["pred_boxes"].shape[0]]
    return out


def per_room(fn: Callable, *arrays):
    """``fn`` on each room's slices of ``arrays`` (tensors with a leading
    room axis, or None, passed through as None), its outputs stacked on a
    new leading axis: the per-room loop in place of JAX's ``vmap``. A
    tuple output gives a tuple, a None element stays None."""
    n = next(a for a in arrays if a is not None).shape[0]
    outs = [fn(*(None if a is None else a[i] for a in arrays))
            for i in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else torch.stack(o)
                     for o in zip(*outs))
    return torch.stack(outs)


def device_cache(cached: Dict, dev: torch.device) -> Dict:
    """The cached forwards' arrays as tensors on ``dev`` (``names`` left
    out)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in cached.items() if k != "names"}


def sweep(cached: Dict, thresholds, nms_vals, refine_vals,
          extent_vals=(None,), consensus_vals=(False,), top_k_vals=(None,),
          iou_thresholds=(0.5, 0.25), refine_furniture: bool = False,
          trust_vals=(0.4,), synth_vals=(False,),
          fuse_vals=(False,), ttopt_vals=(False,),
          ttopt_params=None, support_vals=(None,),
          pen_vals=(None,), soft_vals=(None,),
          synthf_vals=(False,), qscore_vals=(None,),
          device: str | torch.device = "cuda") -> List[Dict]:
    """Score every (threshold, nms, refine, trust, synth, synthf, ttopt,
    extent, consensus, top_k, fuse, support, pen_beta, soft, qscore) cell
    of the grid from cached forwards (``_forward_val_set``), on
    ``device``.

    Per variant (refine clearance and trust, wall synthesis, furniture
    synthesis v1 / v2, ttopt) the candidate set is built once, in that
    order; per cell the extent mask (before NMS), the physics rescoring
    ``exp(-pen_beta · penetration_depth)`` and the learned quality scale
    (a weight JSON) multiply into ``post_process``'s ``conf_scale``, and
    the kept detections are scored at each IoU threshold: ``mAP@t``,
    ``AP_per_class@t``, ``det_f1@t``, ``tp@t``. Returns the cells in grid
    order."""
    dev = resolve_device(device)
    if ttopt_params is None:
        ttopt_params = TTOptParams()
    c = device_cache(cached, dev)
    raw, length = c["raw"], c["length"]
    pred_labels = c["pred_logits"].argmax(-1)
    obj_all = c.get("pred_objectness")

    # (refine, trust, synth, synthf, ttopt) -> (boxes, logits, objectness,
    # base_valid)
    variants = {}
    for rf in refine_vals:
        for tr in (trust_vals if rf is not None else (trust_vals[0],)):
            if rf is None:
                boxes = c["pred_boxes"]
            else:
                boxes = per_room(
                    lambda b, lab, r, n: refine.refine_walls(
                        b, lab, r, n, clearance=rf, trust=tr,
                        furniture_aware=refine_furniture),
                    c["pred_boxes"], pred_labels, raw, length)
            for sy in synth_vals:
                if not sy:
                    sb, sl, so = boxes, c["pred_logits"], obj_all
                    sv = torch.ones(boxes.shape[:2], dtype=torch.bool,
                                    device=dev)
                else:
                    obj_in = (torch.zeros(boxes.shape[:2], device=dev)
                              if obj_all is None else obj_all)
                    sb, sl, so, sv = per_room(
                        lambda b, lg, o, r, n: refine.synthesize_walls(
                            b, lg, o, r, n,
                            clearance=rf if rf is not None else 0.3,
                            furniture_aware=refine_furniture),
                        boxes, c["pred_logits"], obj_in, raw, length)
                    if obj_all is None:
                        so = None
                for sf in synthf_vals:
                    if not sf:
                        fb, fl, fo, fv = sb, sl, so, sv
                    else:
                        fn = (refine.synthesize_furniture_v2 if sf == "v2"
                              else refine.synthesize_furniture)
                        Qb = sb.shape[1]
                        fb, fl, fo, nv = per_room(fn, sb, sl, so, raw,
                                                  length)
                        fv = torch.cat([sv, nv[:, Qb:]], dim=1)
                    for tt in ttopt_vals:
                        tb = fb
                        if tt:
                            tb = per_room(
                                lambda b, r, n: adapt_boxes(b, r, n,
                                                            ttopt_params),
                                fb, raw, length)
                        variants[rf, tr, sy, sf, tt] = (tb, fl, fo, fv)

    n_img = cached["pred_boxes"].shape[0]
    gt_rows = [(cached["gt_boxes"][i][cached["gt_valid"][i]],
                cached["gt_labels"][i][cached["gt_valid"][i]], i)
               for i in range(n_img)]
    gt_boxes = np.concatenate([r[0] for r in gt_rows])
    gt_labels = np.concatenate([r[1] for r in gt_rows])
    gt_imgs = np.concatenate([np.full(len(r[0]), r[2]) for r in gt_rows])

    # penetration depths and quality scales depend only on the variant
    pen_cache = {}
    qs_params = {}
    qs_cache = {}

    def _qscale_all(path, vkey, boxes, logits, obj):
        if (path, vkey) not in qs_cache:
            if path not in qs_params:
                qs_params[path] = qscore_ops.load_params(path, dev)
            qp = qs_params[path]
            qs_cache[path, vkey] = per_room(
                lambda b, lg, o, r, n: qscore_ops.quality_scale(
                    qp, b, lg, o, r, n),
                boxes, logits, obj, raw, length)
        return qs_cache[path, vkey]

    results = []
    for (rf, tr, sy, sf, tt), thr, nm, ext, cns, tk, fu, sp, pb, so, qs \
            in itertools.product(
                variants, thresholds, nms_vals, extent_vals,
                consensus_vals, top_k_vals, fuse_vals, support_vals,
                pen_vals, soft_vals, qscore_vals):
        vkey = (rf, tr, sy, sf, tt)
        boxes, logits, obj, base_valid = variants[vkey]
        if ext is None:
            cand = base_valid
        else:
            # extent suppression runs BEFORE NMS/top_k: an implausible box
            # must not suppress a real one or consume a top-K slot
            cand = base_valid & ~per_room(
                lambda b, r, n: refine.outside_extent_mask(b, r, n,
                                                           slack=ext),
                boxes, raw, length)
        if pb is None:
            cs = torch.ones(boxes.shape[:2], device=dev)
        else:
            if vkey not in pen_cache:
                pen_cache[vkey] = per_room(penetration_depth, boxes, raw,
                                           length)
            cs = torch.exp(-pb * pen_cache[vkey])
        if qs is not None:
            cs = cs * _qscale_all(qs, vkey, boxes, logits, obj)
        kept = per_room(
            lambda b, lg, o, cm, s: torch.cat([
                t.to(torch.float32).reshape(b.shape[0], -1)
                for t in post_process(
                    b, lg, confidence_threshold=thr, nms_threshold=nm,
                    consensus=cns, top_k=tk, objectness=o,
                    candidate_mask=cm, fuse=fu, return_boxes=True,
                    support=sp, conf_scale=s, soft_sigma=so)], -1),
            boxes, logits, obj, cand, cs).cpu().numpy()   # one host copy
        keep, labels = kept[..., 0] > 0.5, kept[..., 1].astype(np.int32)
        conf, out_boxes = kept[..., 2], kept[..., 3:]
        img_ids, flat = np.nonzero(keep)
        cell = {"threshold": thr, "nms": nm, "refine": rf, "trust": tr,
                "synth": sy, "synthf": sf, "ttopt": tt, "extent": ext,
                "consensus": cns, "top_k": tk, "fuse": fu, "support": sp,
                "pen_beta": pb, "soft": so, "qscore": qs,
                "num_predictions": int(keep.sum())}
        rows = (out_boxes[img_ids, flat], labels[img_ids, flat],
                conf[img_ids, flat], img_ids, gt_boxes, gt_labels, gt_imgs)
        for it in iou_thresholds:
            if keep.any():
                mAP, aps = average_precision_3d(*rows, iou_thresh=it)
                _, _, df1, dtp = detection_prf(*rows, iou_thresh=it)
            else:
                mAP, aps, df1, dtp = 0.0, {}, 0.0, 0
            cell[f"mAP@{it}"] = round(float(mAP), 4)
            cell[f"AP_per_class@{it}"] = {int(k): round(float(v), 3)
                                          for k, v in aps.items()}
            cell[f"det_f1@{it}"] = round(float(df1), 4)
            cell[f"tp@{it}"] = int(dtp)
        results.append(cell)
    return results


def _flags(s: str) -> list:
    """'off' / 'on' comma lists, 'both' = [False, True]."""
    if s == "both":
        return [False, True]
    return [x == "on" for x in s.split(",")]


def _floats(s: str, cast=float) -> list:
    """A comma list with 'none' entries as None."""
    return [None if x == "none" else cast(x) for x in s.split(",")]


def main(argv: List[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint stem, or comma-separated stems to "
                        "pool as a seed ensemble")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--thresholds", default="0.3,0.5,0.7")
    p.add_argument("--nms", default="0.1,0.3,0.5")
    p.add_argument("--refine", default="none,0.3,0.55",
                   help="comma list of wall-refine clearances; 'none' = off")
    p.add_argument("--trust", default="0.4",
                   help="comma list of wall-refine max snap distances (m); "
                        "only meaningful with --refine")
    p.add_argument("--synth", default="off",
                   help="'off', 'on', or 'off,on' (alias 'both'): sweep "
                        "extent-implied wall candidate injection")
    p.add_argument("--extent", default="none",
                   help="comma list of extent-suppression slacks (m); "
                        "'none' = off")
    p.add_argument("--consensus", default="off",
                   help="'off', 'on', 'off,on' (alias 'both') to sweep "
                        "cluster-size consensus rescoring")
    p.add_argument("--top_k", default="none",
                   help="comma list of rank cutoffs (keep K best after "
                        "NMS); 'none' = absolute threshold only")
    p.add_argument("--fuse", default="off",
                   help="'off', 'on', or 'off,on' (alias 'both'): sweep "
                        "weighted box fusion")
    p.add_argument("--ttopt", default="off",
                   help="'off', 'on', or 'off,on' (alias 'both'): sweep "
                        "test-time trace-consistency adaptation")
    p.add_argument("--ttopt_params", default=None,
                   help="JSON dict of TTOptParams overrides for the "
                        "ttopt=on cells (e.g. '{\"steps\": 300}')")
    p.add_argument("--support", default="none",
                   help="comma list of support-ordered-NMS vote IoU "
                        "thresholds (e.g. 'none,0.25')")
    p.add_argument("--pen_beta", default="none",
                   help="comma list of physics-rescoring strengths (e.g. "
                        "'none,3')")
    p.add_argument("--soft", default="none",
                   help="comma list of soft-NMS Gaussian sigmas (e.g. "
                        "'none,0.25,0.5'); the cell's nms value becomes "
                        "the tight-duplicate fusion threshold")
    p.add_argument("--qscore", default="none",
                   help="comma list of learned-quality weight JSONs "
                        "(tools/qscore.py) to sweep ('none' = off)")
    p.add_argument("--synthf", default="off",
                   help="comma list of 'off'/'on'(='v1')/'v2', or 'both' "
                        "(off+v1): sweep hole-implied furniture candidate "
                        "injection")
    p.add_argument("--refine_furniture", action="store_true",
                   help="refine cells place wall planes beyond predicted "
                        "furniture lining the envelope")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tta", action="store_true",
                   help="pool the un-rotated candidates of the four "
                        "90-degree forwards")
    p.add_argument("--tta_reflect", action="store_true",
                   help="also pool the x-mirrored copy of every view")
    p.add_argument("--tta_scales", default="",
                   help="comma list of extra uniform scales (e.g. "
                        "'0.9,1.1') to forward every view at")
    p.add_argument("--tta_windows", type=int, default=0,
                   help=">= 2: also forward that many overlapping "
                        "temporal windows re-downsampled from the "
                        "full-resolution trace files")
    p.add_argument("--output", default=None)
    p.add_argument("--eval_dir", default=None,
                   help="honest protocol: choose the best cell on "
                        "--data_dir, then re-score THAT cell on this "
                        "untouched directory")
    p.add_argument("--select", default="mAP@0.5",
                   help="metric the sweep ranks cells by")
    args = p.parse_args(argv)

    thresholds = [float(x) for x in args.thresholds.split(",")]
    nms_vals = [float(x) for x in args.nms.split(",")]
    refine_vals = _floats(args.refine)
    trust_vals = [float(x) for x in args.trust.split(",")]
    ttopt_params = None
    if args.ttopt_params:
        ttopt_params = TTOptParams(**json.loads(args.ttopt_params))
    if args.synthf == "both":
        synthf_vals = [False, "v1"]
    else:
        _sf_map = {"off": False, "on": "v1", "v1": "v1", "v2": "v2"}
        synthf_vals = [_sf_map[x] for x in args.synthf.split(",")]
    grid = dict(refine_furniture=args.refine_furniture,
                trust_vals=trust_vals, synth_vals=_flags(args.synth),
                fuse_vals=_flags(args.fuse), ttopt_vals=_flags(args.ttopt),
                ttopt_params=ttopt_params,
                support_vals=_floats(args.support),
                pen_vals=_floats(args.pen_beta),
                soft_vals=_floats(args.soft), synthf_vals=synthf_vals,
                qscore_vals=_floats(args.qscore, str), device=args.device)
    tta = dict(tta=args.tta, tta_reflect=args.tta_reflect,
               tta_scales=tuple(float(x) for x in args.tta_scales.split(",")
                                if x),
               tta_windows=args.tta_windows, device=args.device)

    cached = _forward_val_set(args.checkpoint, args.data_dir,
                              args.batch_size, **tta)
    results = sweep(cached, thresholds, nms_vals, refine_vals,
                    _floats(args.extent), _flags(args.consensus),
                    _floats(args.top_k, int), **grid)
    results.sort(key=lambda c: (-c[args.select], -c["mAP@0.25"]))
    for c in results:
        print(f"thr={c['threshold']:.2f} nms={c['nms']:.2f} "
              f"refine={c['refine']} trust={c['trust']} "
              f"synth={int(c['synth'])} sf={c['synthf'] or 0} "
              f"tt={int(c['ttopt'])} "
              f"extent={c['extent']} "
              f"cns={int(c['consensus'])} k={c['top_k']} "
              f"fuse={int(c['fuse'])} "
              f"sup={c['support']} pen={c['pen_beta']} "
              f"soft={c['soft']} q={int(c['qscore'] is not None)} "
              f"preds={c['num_predictions']:4d} "
              f"mAP@0.5={c['mAP@0.5']:.4f} mAP@0.25={c['mAP@0.25']:.4f}")
    best = results[0]
    print("\nbest:", json.dumps(best, default=float))
    if args.eval_dir:
        # honest protocol: the chosen cell's numbers come from a directory
        # the sweep never saw (max-over-cells on the reported set is
        # selection bias)
        eval_cached = _forward_val_set(args.checkpoint, args.eval_dir,
                                       args.batch_size, **tta)
        grid.update(trust_vals=[best.get("trust", 0.4)],
                    synth_vals=[best.get("synth", False)],
                    fuse_vals=[best.get("fuse", False)],
                    ttopt_vals=[best.get("ttopt", False)],
                    support_vals=[best.get("support")],
                    pen_vals=[best.get("pen_beta")],
                    soft_vals=[best.get("soft")],
                    synthf_vals=[best.get("synthf", False)],
                    qscore_vals=[best.get("qscore")])
        held_out = sweep(eval_cached, [best["threshold"]], [best["nms"]],
                         [best["refine"]], [best["extent"]],
                         [best["consensus"]], [best.get("top_k")],
                         **grid)[0]
        held_out["calibrated_on"] = args.data_dir
        held_out["scored_on"] = args.eval_dir
        if args.ttopt_params:
            held_out["ttopt_params"] = json.loads(args.ttopt_params)
        print("held-out:", json.dumps(held_out, default=float))
        best = held_out
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"best": best, "sweep": results} if args.eval_dir
                      else results, f, indent=2, default=float)


if __name__ == "__main__":
    main()
