"""Evaluation CLI of the port (the JAX package's ``evaluate.py``), both
surfaces:

    python -m room_slam_torch.evaluate --checkpoint DIR/best_model \\
        --data_dir DIR [--batch_size 8] [--iou_thresh 0.5] \\
        [--threshold 0.5] [--nms 0.3] [--consensus] \\
        [--output metrics.json] [--device cuda|cpu]
    python -m room_slam_torch.evaluate --checkpoint DIR/best_model_legacy \\
        --data_dir DIR [--compare_baseline] [--threshold 0.5] \\
        [--iou_thresh 0.5] [--hidden_size 128] [--max_objects 10] \\
        [--output metrics.json] [--device cuda|cpu]

The benchmark surface (``evaluate_benchmark``): the Hungarian-aligned
metric sums of every batch (``summarize_metrics``: mIoU, precision,
recall, F1, class accuracy), then each sample's post-processed detections
(confidence threshold, per-class NMS, optional consensus rescoring)
against its ground truth: ``mAP`` and ``AP_per_class`` by label name, and
the operating point's ``det_precision``, ``det_recall``, ``det_f1`` and
``det_tp``. ``--refine CLEARANCE`` (with ``--refine_furniture``) snaps each
sample's wall boxes to its trace-extent planes before post-processing;
``--extent_slack M`` drops kept detections entirely outside the trace
extent + M after NMS (the predictor applies it before NMS).

The legacy surface scores a legacy GRU checkpoint per trace: every window of a CSV trace goes
through the model in one batch, the slots whose confidence (sigmoid
validity times the top class probability) exceeds ``--threshold`` pool
into the trace's predictions, and the trace's ground truth counts once;
rotated-box mAP at ``--iou_thresh``. ``--compare_baseline`` scores the
rule-based occupancy baseline on each whole trace beside it.
``--visualize OUT_DIR`` writes ``eval_trace_<id>.png`` for the first 12
traces: the trace, the ground truth (red) and the model's predictions
(blue, dashed), as the root script does; like it, the benchmark surface
ignores the flag. The plots need matplotlib (an ``ImportError`` naming it
without). Prints the metrics as JSON.
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
from room_slam_torch.config import BENCH_ID_TO_LABEL, LEGACY_ID_TO_LABEL
from room_slam_torch.data.dataset import TraceColliderArrays
from room_slam_torch.data.features import featurize
from room_slam_torch.data.legacy import LegacyArrays
from room_slam_torch.models.baseline import OccupancyBaseline
from room_slam_torch.models.legacy_gru import RoomSlamGRU
from room_slam_torch.ops.nms import post_process
from room_slam_torch.ops.refine import outside_extent_mask, refine_walls
from room_slam_torch.train import checkpoint as ckpt_lib
from room_slam_torch.train.driver import load_model_for_inference
from room_slam_torch.train.loop import gather_batch
from room_slam_torch.train.metrics import (average_precision_3d,
                                           average_precision_rotated_2d,
                                           detection_prf, make_metrics_step,
                                           summarize_metrics)
from room_slam_torch.weights import load_params


@torch.no_grad()
def benchmark_rows(checkpoint: str, data_dir: str, batch_size: int = 8,
                   iou_thresh: float = 0.5, threshold: float = 0.5,
                   nms: float = 0.3, consensus: bool = False,
                   device: str | torch.device = "cuda",
                   refine: float | None = None,
                   refine_furniture: bool = False,
                   extent_slack: float | None = None
                   ) -> Tuple[Dict[str, float], List[Tuple], List[Tuple]]:
    """What ``evaluate_benchmark`` scores: the metric sums of the batches of
    an unshuffled epoch plan, and per sample of weight 1 (in the
    reference's order) its post-processed detections ``(box, label,
    confidence, sample)`` and its GT ``(box, label, sample)``; ``refine``
    and ``extent_slack`` as in the module docstring."""
    model, cfg = load_model_for_inference(checkpoint, device)
    dev = next(model.parameters()).device
    ds = TraceColliderArrays(data_dir, cfg.data, augment=False,
                             verbose=False)
    mstep = make_metrics_step(model, iou_thresh)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in ds.device_arrays().items()}
    plan = ds.epoch_plan(batch_size, shuffle=False)
    acc: Dict[str, float] = {}
    pred_rows: List[Tuple] = []
    gt: List[Tuple] = []
    img = 0
    for i in range(plan["base_idx"].shape[0]):
        batch = gather_batch(data, plan, i)
        for k, v in mstep(batch).items():
            acc[k] = acc.get(k, 0.0) + float(v)
        out = model(*featurize(batch["raw"], batch["length"]))
        obj = out.get("pred_objectness")
        for b in range(batch["raw"].shape[0]):
            if plan["weight"][i, b] == 0:
                continue
            pred_b = out["pred_boxes"][b]
            raw_b, len_b = batch["raw"][b], batch["length"][b]
            if refine is not None:
                pred_b = refine_walls(
                    pred_b, out["pred_classes"][b].argmax(-1), raw_b, len_b,
                    clearance=refine, furniture_aware=refine_furniture)
            keep, labels, conf = post_process(
                pred_b, out["pred_classes"][b],
                confidence_threshold=threshold, nms_threshold=nms,
                consensus=consensus,
                objectness=None if obj is None else obj[b])
            if extent_slack is not None:
                keep = keep & ~outside_extent_mask(pred_b, raw_b, len_b,
                                                   slack=extent_slack)
            keep, labels, conf = (keep.cpu().numpy(), labels.cpu().numpy(),
                                  conf.cpu().numpy())
            boxes = pred_b.cpu().numpy()
            for q in np.where(keep)[0]:
                pred_rows.append((boxes[q], int(labels[q]),
                                  float(conf[q]), img))
            j = int(plan["base_idx"][i, b])
            for m in np.where(ds.valid[j])[0]:
                gt.append((ds.boxes[j, m], int(ds.labels[j, m]), img))
            img += 1
    return acc, pred_rows, gt


def evaluate_benchmark(checkpoint: str, data_dir: str, batch_size: int = 8,
                       iou_thresh: float = 0.5, threshold: float = 0.5,
                       nms: float = 0.3, consensus: bool = False,
                       device: str | torch.device = "cuda",
                       refine: float | None = None,
                       refine_furniture: bool = False,
                       extent_slack: float | None = None) -> Dict:
    """The metrics of the JAX package's ``evaluate_benchmark`` for the
    benchmark checkpoint stem ``checkpoint`` on the trace/collider pairs of
    ``data_dir`` (``benchmark_rows``), scored as described in the module
    docstring."""
    acc, pred_rows, gt = benchmark_rows(
        checkpoint, data_dir, batch_size, iou_thresh, threshold, nms,
        consensus, device, refine, refine_furniture, extent_slack)
    metrics = summarize_metrics(acc)
    if pred_rows and gt:
        rows = (np.stack([r[0] for r in pred_rows]),
                np.asarray([r[1] for r in pred_rows]),
                np.asarray([r[2] for r in pred_rows]),
                np.asarray([r[3] for r in pred_rows]),
                np.stack([r[0] for r in gt]), np.asarray([r[1] for r in gt]),
                np.asarray([r[2] for r in gt]))
        mAP, aps = average_precision_3d(*rows, iou_thresh=iou_thresh)
        metrics["mAP"] = mAP
        metrics["AP_per_class"] = {BENCH_ID_TO_LABEL[c]: round(v, 4)
                                   for c, v in aps.items()}
        dp, dr, df1, dtp = detection_prf(*rows, iou_thresh=iou_thresh)
        metrics["det_precision"] = round(dp, 4)
        metrics["det_recall"] = round(dr, 4)
        metrics["det_f1"] = round(df1, 4)
        metrics["det_tp"] = dtp
    return metrics


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
                    device: str | torch.device = "cuda",
                    visualize: str | None = None) -> Dict:
    """The metrics of the JAX package's ``evaluate_legacy``: ``mAP``,
    ``AP_per_class``, ``checkpoint_epoch`` and, with ``compare_baseline``,
    ``baseline_mAP`` and ``baseline_AP_per_class``; with ``visualize``, the
    per-trace plots in that directory (``visualize_legacy``)."""
    ds = LegacyArrays(data_dir)
    model, side = load_legacy_model(checkpoint, hidden_size, max_objects,
                                    device)
    gt = gt_rows(ds)
    pred = model_rows(model, ds, threshold)
    mAP, aps = score(pred, gt, iou_thresh)
    result = {"mAP": mAP, "AP_per_class": aps,
              "checkpoint_epoch": side.get("epoch")}
    if compare_baseline:
        result["baseline_mAP"], result["baseline_AP_per_class"] = score(
            baseline_rows(ds, max_objects, device), gt, iou_thresh)
    if visualize:
        visualize_legacy(visualize, ds, pred, gt)
    return result


def visualize_legacy(out_dir: str, ds: LegacyArrays, pred: List[Tuple],
                     gt: List[Tuple]) -> None:
    """``eval_trace_<id>.png`` in ``out_dir`` for the first 12 traces: the
    whole trace, its GT rows (red) and prediction rows (blue, dashed), as
    the root ``evaluate.py``'s ``_visualize_legacy`` draws them."""
    from pathlib import Path

    from room_slam_torch.viz import pyplot, rectangle

    plt = pyplot()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for tid in sorted(set(ds.trace_id.tolist()))[:12]:
        full = np.concatenate([ds.traces[i]
                               for i in np.where(ds.trace_id == tid)[0]])
        fig, ax = plt.subplots(figsize=(9, 9))
        ax.plot(full[:, 1], full[:, 2], "b-", lw=0.4, alpha=0.6,
                label="trace")
        for b, l, t in gt:
            if t != tid:
                continue
            ax.add_patch(rectangle(
                (b[0] - b[2] / 2, b[1] - b[3] / 2), b[2], b[3],
                ec="red", fc="red", alpha=0.2))
            ax.text(b[0], b[1], LEGACY_ID_TO_LABEL.get(int(l), "?"),
                    color="red", fontsize=7, ha="center")
        for b, l, c, t in pred:
            if t != tid:
                continue
            ax.add_patch(rectangle(
                (b[0] - b[2] / 2, b[1] - b[3] / 2), b[2], b[3],
                ec="blue", fc="none", ls="--"))
            ax.text(b[0], b[1],
                    f"{LEGACY_ID_TO_LABEL.get(int(l), '?')}\n{c:.2f}",
                    color="blue", fontsize=6, ha="center")
        ax.set_aspect("equal")
        ax.set_title(f"trace {tid}: GT (red) vs prediction (blue)")
        ax.legend()
        fig.savefig(out / f"eval_trace_{tid}.png", dpi=110,
                    bbox_inches="tight")
        plt.close(fig)
    print(f"saved visualizations to {out}")


def main(argv: List[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--data_dir", type=str, default="dataset/val")
    p.add_argument("--surface", choices=["auto", "bench", "legacy"],
                   default="auto")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--iou_thresh", type=float, default=0.5)
    p.add_argument("--threshold", type=float, default=0.5,
                   help="confidence threshold for detection metrics")
    p.add_argument("--nms", type=float, default=0.3)
    p.add_argument("--consensus", action="store_true",
                   help="rescore detections by NMS cluster-size consensus")
    p.add_argument("--extent_slack", type=float, default=None,
                   metavar="METERS")
    p.add_argument("--refine", type=float, default=None, metavar="CLEARANCE")
    p.add_argument("--refine_furniture", action="store_true")
    p.add_argument("--hidden_size", type=int, default=128)
    p.add_argument("--max_objects", type=int, default=10)
    p.add_argument("--compare_baseline", action="store_true")
    p.add_argument("--visualize", type=str, default=None, metavar="OUT_DIR",
                   help="write per-trace GT-vs-prediction PNGs (legacy "
                        "surface; needs matplotlib)")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    surface = args.surface
    if surface == "auto":
        surface = "legacy" if "legacy" in args.checkpoint else "bench"
        print(f"[evaluate] auto-detected surface: {surface}")
    if surface == "bench":
        metrics = evaluate_benchmark(
            args.checkpoint, args.data_dir, args.batch_size, args.iou_thresh,
            args.threshold, args.nms, args.consensus, args.device,
            args.refine, args.refine_furniture, args.extent_slack)
    else:
        metrics = evaluate_legacy(
            args.checkpoint, args.data_dir, args.hidden_size,
            args.max_objects, args.threshold, args.iou_thresh,
            args.compare_baseline, args.device, args.visualize)
    print(json.dumps(metrics, indent=2, default=float))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(metrics, f, indent=2, default=float)


if __name__ == "__main__":
    main()
