"""Evaluation metrics (counterpart of the JAX package's ``train/metrics.py``):
Hungarian-aligned ``metrics_sums`` and ``summarize_metrics`` (mean IoU of
matched pairs, TP / FP at an IoU threshold over matched pairs, FN for valid
GT left unmatched, matched-pair class accuracy), and the legacy surface's
rotated-box ``average_precision_rotated_2d``."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from room_slam_torch.ops import losses as loss_ops
from room_slam_torch.ops.iou import eval_pair_iou_3d, rotated_iou_2d


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


def average_precision_rotated_2d(
        pred_boxes: np.ndarray, pred_labels: np.ndarray,
        pred_scores: np.ndarray, pred_image: np.ndarray,
        gt_boxes: np.ndarray, gt_labels: np.ndarray, gt_image: np.ndarray,
        num_classes: int = 4, iou_thresh: float = 0.5
) -> Tuple[float, Dict[int, float]]:
    """Rotated-box 2D mAP of the legacy surface: per class, predictions in
    descending score order take the GT of their own image with the highest
    IoU if it reaches ``iou_thresh`` and is not taken (the VOC assignment),
    and AP is the 101-point interpolated precision. Boxes are ``[*, 5]``
    (cx, cy, w, h, theta); a class without GT is left out of the mean, a
    class with GT and no prediction scores 0. The IoU matrix of a class is
    one batched ``rotated_iou_2d`` on the host."""
    aps: Dict[int, float] = {}
    for c in range(num_classes):
        p_sel, g_sel = pred_labels == c, gt_labels == c
        npos = int(g_sel.sum())
        if npos == 0:
            continue
        if p_sel.sum() == 0:
            aps[c] = 0.0
            continue
        order = np.argsort(-pred_scores[p_sel])
        pb, pim = pred_boxes[p_sel][order], pred_image[p_sel][order]
        gb, gim = gt_boxes[g_sel], gt_image[g_sel]
        iou = rotated_iou_2d(torch.from_numpy(np.ascontiguousarray(
            pb, np.float32))[:, None], torch.from_numpy(np.ascontiguousarray(
                gb, np.float32))[None]).numpy()
        iou = np.where(pim[:, None] == gim[None, :], iou, 0.0)
        taken = np.zeros(gb.shape[0], dtype=bool)
        tp = np.zeros(pb.shape[0])
        for i in range(pb.shape[0]):
            j = int(np.argmax(iou[i]))
            if iou[i, j] >= iou_thresh and not taken[j]:
                taken[j] = True
                tp[i] = 1
        tp_c, fp_c = np.cumsum(tp), np.cumsum(1 - tp)
        recall = tp_c / npos
        precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            mask = recall >= r
            ap += precision[mask].max() if mask.any() else 0.0
        aps[c] = ap / 101
    return (float(np.mean(list(aps.values()))) if aps else 0.0), aps
