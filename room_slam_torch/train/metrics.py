"""Hungarian-aligned evaluation metrics (counterpart of the JAX package's
``train/metrics.py::metrics_sums`` and ``summarize_metrics``): mean IoU of
matched pairs, TP / FP at an IoU threshold over matched pairs, FN for valid
GT left unmatched, matched-pair class accuracy."""

from __future__ import annotations

from typing import Dict

import torch

from room_slam_torch.ops import losses as loss_ops
from room_slam_torch.ops.iou import eval_pair_iou_3d


def metrics_sums(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                 iou_thresh: float = 0.5) -> Dict[str, torch.Tensor]:
    """Metric sums of one batch of model outputs (device scalars)."""
    pred_boxes = out["pred_boxes"]
    pred_logits = out["pred_classes"]
    gt_valid = batch["valid"].bool()
    w = batch["weight"]
    rows, matched = loss_ops.match(pred_boxes, pred_logits, batch["boxes"],
                                   batch["labels"], gt_valid)
    pair_w = matched & (w[:, None] > 0)
    mp_boxes = torch.gather(pred_boxes, 1, rows[..., None].expand(-1, -1, 6))
    mp_labels = torch.gather(
        pred_logits, 1, rows[..., None].expand(-1, -1, pred_logits.shape[-1])
    ).argmax(-1)
    ious = eval_pair_iou_3d(mp_boxes, batch["boxes"])
    num_valid = (gt_valid & (w[:, None] > 0)).sum(1)
    return {
        "iou_sum": torch.where(pair_w, ious, torch.zeros_like(ious)).sum(),
        "iou_cnt": pair_w.sum(),
        "tp": (pair_w & (ious >= iou_thresh)).sum(),
        "fp": (pair_w & (ious < iou_thresh)).sum(),
        "fn": (num_valid - pair_w.sum(1)).clamp(min=0).sum(),
        "cls_correct": (pair_w & (mp_labels == batch["labels"])).sum(),
        "cls_total": pair_w.sum(),
    }


def summarize_metrics(acc: Dict[str, float]) -> Dict[str, float]:
    """Fold accumulated sums into the reference's metric dict."""
    miou = acc["iou_sum"] / acc["iou_cnt"] if acc["iou_cnt"] > 0 else 0.0
    precision = acc["tp"] / (acc["tp"] + acc["fp"] + 1e-8)
    recall = acc["tp"] / (acc["tp"] + acc["fn"] + 1e-8)
    f1 = 2 * precision * recall / (precision + recall + 1e-8)
    cls_acc = (acc["cls_correct"] / acc["cls_total"]
               if acc["cls_total"] > 0 else 0.0)
    return {"mIoU": float(miou), "precision": float(precision),
            "recall": float(recall), "f1": float(f1),
            "cls_acc": float(cls_acc), "tp": int(acc["tp"]),
            "fp": int(acc["fp"]), "fn": int(acc["fn"])}
