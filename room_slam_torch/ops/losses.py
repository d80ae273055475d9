"""Set-prediction criterion: Hungarian matching and the weighted loss terms
(counterpart of the JAX package's ``ops/losses.py``).

- match cost = 1.0 * (-softmax prob of the GT class) + 5.0 * L1 distance;
- class cross-entropy, L1 and (1 - GIoU) over matched pairs;
- optional terms, each on when its weight is non-zero: footprint (XZ)
  GIoU, |log size ratio|, auxiliary L1 + GIoU of the refine stages under
  the final assignment, coverage (nearest unmatched query per GT), and the
  objectness BCE over all query slots (IoU-aware soft target with
  ``objectness_iou``).

All means are weighted by pair and sample weights, so batch-padding
samples (weight 0) contribute nothing. Matching runs on the host
(``ops/hungarian.py``): one device-to-host copy of the cost per call.

``legacy_criterion`` is the legacy surface's 2D loss (class, position,
size, orientation, validity) with the same matcher.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from room_slam_torch.ops import iou as iou_ops
from room_slam_torch.ops.hungarian import hungarian_match_batch

DEFAULT_COST_CLASS = 1.0
DEFAULT_COST_BOX = 5.0
DEFAULT_WEIGHTS = {"class_loss": 2.0, "l1_loss": 5.0, "giou_loss": 2.0}


def match_cost(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
               gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
               cost_class: float = DEFAULT_COST_CLASS,
               cost_box: float = DEFAULT_COST_BOX) -> torch.Tensor:
    """Batched match cost ``[B, Q, M]``."""
    prob = torch.softmax(pred_logits, dim=-1)                 # [B, Q, C]
    safe = gt_labels.long().clamp(0, prob.shape[-1] - 1)      # [B, M]
    c_class = -torch.gather(
        prob, 2, safe[:, None, :].expand(-1, prob.shape[1], -1))
    c_box = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs() \
        .sum(-1)
    return cost_class * c_class + cost_box * c_box


def match(pred_boxes, pred_logits, gt_boxes, gt_labels, gt_valid
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hungarian matching per batch item: ``(row_for_col [B, M] int64,
    matched [B, M] bool)`` on the inputs' device."""
    cost = match_cost(pred_boxes, pred_logits, gt_boxes, gt_labels)
    return hungarian_match_batch(cost, gt_valid)


def _weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    denom = w.sum()
    return torch.where(denom > 0, (x * w).sum() / denom.clamp(min=1e-12),
                       torch.zeros_like(denom))


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x [B, Q, D]`` at ``rows [B, M]`` -> ``[B, M, D]``."""
    return torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))


def optax_sigmoid_bce(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy (optax's formula)."""
    return torch.clamp(logits, min=0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))


def set_criterion(outputs: Dict[str, torch.Tensor],
                  targets: Dict[str, torch.Tensor],
                  sample_weight: torch.Tensor | None = None,
                  loss_weights: Dict[str, float] = DEFAULT_WEIGHTS
                  ) -> Dict[str, torch.Tensor]:
    """Full set loss.

    outputs: ``pred_boxes [B, Q, 6]``, ``pred_classes [B, Q, C]``, and
    optionally ``pred_objectness [B, Q]``, ``pred_aux_boxes [S, B, Q, 6]``;
    targets: ``boxes [B, M, 6]``, ``labels [B, M]``, ``valid_mask [B, M]``;
    sample_weight: ``[B]`` (1 = real sample, 0 = batch padding).
    """
    pred_boxes = outputs["pred_boxes"]
    pred_logits = outputs["pred_classes"]
    gt_boxes = targets["boxes"]
    gt_labels = targets["labels"]
    gt_valid = targets["valid_mask"]
    B, Q, C = pred_logits.shape
    dt = pred_boxes.dtype
    if sample_weight is None:
        sample_weight = torch.ones(B, dtype=dt, device=pred_boxes.device)

    rows, matched = match(pred_boxes, pred_logits, gt_boxes, gt_labels,
                          gt_valid)
    pair_w = matched.to(dt) * sample_weight[:, None]

    mp_boxes = _take_rows(pred_boxes, rows)
    mp_logits = _take_rows(pred_logits, rows)

    safe_labels = gt_labels.long().clamp(0, C - 1)
    logp = F.log_softmax(mp_logits, dim=-1)
    ce = -torch.gather(logp, 2, safe_labels[..., None])[..., 0]
    class_loss = _weighted_mean(ce, pair_w)
    l1_loss = _weighted_mean((mp_boxes - gt_boxes).abs().mean(-1), pair_w)
    _, giou = iou_ops.iou_giou_3d(mp_boxes, gt_boxes)
    giou_loss = _weighted_mean(1.0 - giou, pair_w)

    total = (loss_weights["class_loss"] * class_loss
             + loss_weights["l1_loss"] * l1_loss
             + loss_weights["giou_loss"] * giou_loss)
    out = {"class_loss": class_loss, "l1_loss": l1_loss,
           "giou_loss": giou_loss}

    fw = loss_weights.get("footprint_loss", 0.0)
    if fw:
        _, giou2d = iou_ops.iou_giou_2d_xz(mp_boxes, gt_boxes)
        out["footprint_loss"] = _weighted_mean(1.0 - giou2d, pair_w)
        total = total + fw * out["footprint_loss"]

    sw = loss_weights.get("size_log_loss", 0.0)
    if sw:
        eps = 1e-3
        log_ratio = torch.log((mp_boxes[..., 3:].abs() + eps)
                              / (gt_boxes[..., 3:].abs() + eps))
        out["size_log_loss"] = _weighted_mean(log_ratio.abs().mean(-1),
                                              pair_w)
        total = total + sw * out["size_log_loss"]

    aw = loss_weights.get("aux_loss", 0.0)
    if aw and "pred_aux_boxes" in outputs:
        aux = outputs["pred_aux_boxes"]                       # [S, B, Q, 6]
        S = aux.shape[0]
        ma_boxes = _take_rows(aux.flatten(0, 1), rows.repeat(S, 1)) \
            .view(S, B, -1, 6)
        aux_l1 = (ma_boxes - gt_boxes[None]).abs().mean(-1)   # [S, B, M]
        _, aux_giou = iou_ops.iou_giou_3d(ma_boxes, gt_boxes[None])
        pw = pair_w[None].expand_as(aux_l1)
        out["aux_loss"] = (_weighted_mean(aux_l1, pw)
                           * loss_weights["l1_loss"]
                           + _weighted_mean(1.0 - aux_giou, pw)
                           * loss_weights["giou_loss"])
        total = total + aw * out["aux_loss"]

    cw = loss_weights.get("coverage_loss", 0.0)
    if cw:
        # [B, Q]: query slot matched to any valid GT
        matched_slot = torch.zeros(B, Q, dtype=dt,
                                   device=rows.device).scatter_reduce(
            1, rows, matched.to(dt), reduce="amax") > 0
        d = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs() \
            .mean(-1)                                         # [B, Q, M]
        d = torch.where(matched_slot[:, :, None],
                        torch.full_like(d, float("inf")), d)
        runner = d.amin(dim=1)                                # [B, M]
        # a batch row with every query matched would leave inf
        runner = torch.where(torch.isfinite(runner), runner,
                             torch.zeros_like(runner))
        cov_w = pair_w
        if loss_weights.get("coverage_furniture_only", 0.0):
            cov_w = cov_w * (gt_labels != 0).to(dt)
        out["coverage_loss"] = _weighted_mean(runner, cov_w)
        total = total + cw * out["coverage_loss"]

    if "pred_objectness" in outputs:
        obj_logits = outputs["pred_objectness"]               # [B, Q]
        if loss_weights.get("objectness_iou", 0.0):
            pair_iou, _ = iou_ops.iou_giou_3d(mp_boxes, gt_boxes)
            pair_val = pair_iou.detach().clamp(0.0, 1.0) * matched
        else:
            pair_val = matched.to(dt)
        slot_target = torch.zeros(B, Q, dtype=dt, device=obj_logits.device) \
            .scatter_reduce(1, rows, pair_val.to(dt), reduce="amax")
        bce = optax_sigmoid_bce(obj_logits, slot_target)
        out["objectness_loss"] = _weighted_mean(
            bce, sample_weight[:, None].expand_as(bce))
        total = total + loss_weights.get("objectness_loss", 1.0) \
            * out["objectness_loss"]
    out["total_loss"] = total
    return out


LEGACY_WEIGHTS = {
    "class_loss": 1.0,
    "position_loss": 1.0,
    "size_loss": 1.0,
    "orientation_loss": 0.5,
    "validity_loss": 1.0,
}


def legacy_match(outputs: Dict[str, torch.Tensor],
                 targets: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The legacy surface's Hungarian matching: ``(row_for_col [B, M],
    matched [B, M])`` for the cost -softmax prob of the GT class + 5 *
    position L1."""
    logits, pos = outputs["classes"], outputs["positions"]
    N, C = logits.shape[1:]
    prob = torch.softmax(logits, dim=-1)
    safe = targets["labels"].long().clamp(0, C - 1)               # [B, M]
    c_class = -torch.gather(prob, 2, safe[:, None, :].expand(-1, N, -1))
    c_pos = (pos[:, :, None, :] - targets["boxes"][:, None, :, :2]).abs() \
        .sum(-1)
    return hungarian_match_batch(c_class + 5.0 * c_pos,
                                 targets["valid_mask"])


def legacy_criterion(outputs: Dict[str, torch.Tensor],
                     targets: Dict[str, torch.Tensor],
                     sample_weight: torch.Tensor | None = None,
                     loss_weights: Dict[str, float] = LEGACY_WEIGHTS
                     ) -> Dict[str, torch.Tensor]:
    """Multi-task loss of the legacy surface: cross-entropy (classes), L1
    (position, size, orientation) over Hungarian-matched pairs, and the
    validity BCE over every slot (target 1 where the slot got a match).

    outputs: ``classes [B, N, C]``, ``positions [B, N, 2]``, ``sizes
    [B, N, 2]``, ``orientations [B, N, 1]``, ``validity [B, N, 1]``
    (logits); targets: ``boxes [B, M, 5]`` (x, y, w, h, theta), ``labels
    [B, M]``, ``valid_mask [B, M]``.

    The match cost is -softmax prob of the GT class + 5 * position L1. The
    JAX package solves it with its exact square solver; the host matcher
    here gives the same assignment to every valid column and row 0 to the
    invalid ones, which carry weight 0 in every term."""
    logits = outputs["classes"]
    pos = outputs["positions"]
    size = outputs["sizes"]
    orient = outputs["orientations"][..., 0]
    validity = outputs["validity"][..., 0]
    gt = targets["boxes"]
    B, N, C = logits.shape
    dt = pos.dtype
    if sample_weight is None:
        sample_weight = torch.ones(B, dtype=dt, device=pos.device)
    safe = targets["labels"].long().clamp(0, C - 1)               # [B, M]
    rows, matched = legacy_match(outputs, targets)
    pair_w = matched.to(dt) * sample_weight[:, None]

    logp = F.log_softmax(_take_rows(logits, rows), dim=-1)
    ce = -torch.gather(logp, 2, safe[..., None])[..., 0]
    m_orient = torch.gather(orient, 1, rows)
    slot_target = torch.zeros(B, N, dtype=dt, device=pos.device) \
        .scatter_reduce(1, rows, matched.to(dt), reduce="amax")
    bce = optax_sigmoid_bce(validity, slot_target)
    losses = {
        "class_loss": _weighted_mean(ce, pair_w),
        "position_loss": _weighted_mean(
            (_take_rows(pos, rows) - gt[..., :2]).abs().mean(-1), pair_w),
        "size_loss": _weighted_mean(
            (_take_rows(size, rows) - gt[..., 2:4]).abs().mean(-1), pair_w),
        "orientation_loss": _weighted_mean((m_orient - gt[..., 4]).abs(),
                                           pair_w),
        "validity_loss": _weighted_mean(
            bce, sample_weight[:, None].expand_as(bce)),
    }
    losses["total_loss"] = sum(loss_weights.get(k, 1.0) * v
                               for k, v in losses.items())
    return losses
