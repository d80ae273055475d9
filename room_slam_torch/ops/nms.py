"""Greedy 3D NMS, soft-NMS and confidence post-processing (counterpart of
the JAX package's ``ops/nms.py``).

The greedy sweep runs on the boxes' device as a loop of Q steps over all
classes at once, with no host synchronization. Score order matches the JAX
package exactly: a stable ascending sort, reversed, so among tied scores
the higher index goes first.

The soft-NMS sweep picks the argmax of the current (decayed) scores each
pass, all classes at once. The reference's ``while_loop`` stops once no
candidate is left; a pass with none left changes nothing, so this loop
reads that condition on the host every ``SOFT_CHECK_EVERY`` passes and
stops there, with the reference's result.
"""

from __future__ import annotations

from typing import Tuple

import torch

from room_slam_torch.ops.iou import pairwise_iou_3d


def _nms_fused_batched(boxes: torch.Tensor, scores: torch.Tensor,
                       masks: torch.Tensor, iou_threshold: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS of the same ``boxes [Q, 6]`` / ``scores [Q]`` under each
    of ``masks [C, Q]``. Returns keep ``[C, Q]``, cluster counts ``[C, Q]``
    (int32) and fused boxes ``[C, Q, 6]``."""
    C, Q = masks.shape
    iou = pairwise_iou_3d(boxes, boxes)
    ranked = torch.where(masks, scores[None],
                         torch.finfo(scores.dtype).min)
    order = torch.argsort(ranked, dim=-1, stable=True).flip(-1)
    rows = torch.arange(C, device=boxes.device)
    keep = torch.zeros(C, Q, dtype=torch.bool, device=boxes.device)
    suppressed = ~masks
    counts = torch.zeros(C, Q, dtype=torch.int32, device=boxes.device)
    fused = boxes.expand(C, Q, 6).clone()
    for i in range(Q):
        idx = order[:, i]
        alive = ~suppressed[rows, idx] & masks[rows, idx]
        keep[rows, idx] = alive
        sup = (iou[idx] >= iou_threshold) & alive[:, None] & ~suppressed
        counts[rows, idx] = torch.where(alive, sup.sum(-1), 0).to(torch.int32)
        w = torch.where(sup, scores[None], 0.0)
        mean = (w @ boxes) / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
        fused[rows, idx] = torch.where(alive[:, None], mean, fused[rows, idx])
        suppressed = suppressed | sup
    return keep, counts, fused


SOFT_CHECK_EVERY = 8


def _soft_nms_fused_batched(boxes: torch.Tensor, scores: torch.Tensor,
                            masks: torch.Tensor, dup_threshold: float,
                            sigma: float):
    """Soft-NMS of the same ``boxes [Q, 6]`` / ``scores [Q]`` under each of
    ``masks [C, Q]``. Returns keep ``[C, Q]``, cluster counts ``[C, Q]``
    (int32), fused boxes ``[C, Q, 6]`` and rescored confidences
    ``[C, Q]``."""
    C, Q = masks.shape
    dev = boxes.device
    iou = pairwise_iou_3d(boxes, boxes)
    cur = scores.float().expand(C, Q).clone()
    neg_inf = torch.finfo(cur.dtype).min
    rows = torch.arange(C, device=dev)
    keep = torch.zeros(C, Q, dtype=torch.bool, device=dev)
    absorbed = torch.zeros_like(keep)
    counts = torch.zeros(C, Q, dtype=torch.int32, device=dev)
    fused = boxes.expand(C, Q, 6).clone()
    for i in range(Q):
        avail = masks & ~keep & ~absorbed
        if i % SOFT_CHECK_EVERY == 0 and not bool(avail.any()):
            break
        s = torch.where(avail, cur, neg_inf)
        idx = s.argmax(dim=-1)
        alive = s[rows, idx] > neg_inf
        chosen = torch.zeros_like(keep)
        chosen[rows, idx] = alive
        keep = keep | chosen
        dup = ((iou[idx] >= dup_threshold) & avail & alive[:, None]
               & ~chosen)
        wsel = chosen | dup
        w = torch.where(wsel, torch.clamp(cur, min=1e-12), 0.0)
        mean = (w @ boxes) / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
        fused[rows, idx] = torch.where(alive[:, None], mean, fused[rows, idx])
        counts[rows, idx] = torch.where(alive, wsel.sum(-1).to(torch.int32),
                                        counts[rows, idx])
        absorbed = absorbed | dup
        decay = torch.exp(-(iou[idx] ** 2) / sigma)
        cur = torch.where(avail & ~wsel & alive[:, None], cur * decay, cur)
    return keep, counts, fused, cur


def soft_nms_3d_fused(boxes: torch.Tensor, scores: torch.Tensor,
                      mask: torch.Tensor, dup_threshold: float = 0.5,
                      sigma: float = 0.25):
    """Soft-NMS (Gaussian rescoring) with tight-cluster fusion: the
    candidate of highest current score is kept, candidates with IoU >=
    ``dup_threshold`` are absorbed into its fused box, and every other one
    decays by ``exp(-iou^2 / sigma)``. Returns (keep ``[Q]``, cluster
    counts ``[Q]``, fused boxes ``[Q, 6]``, rescored confidences ``[Q]``);
    a kept box's confidence is its score when it was kept."""
    out = _soft_nms_fused_batched(boxes, scores, mask[None], dup_threshold,
                                  sigma)
    return tuple(t[0] for t in out)


def nms_3d_fused(boxes: torch.Tensor, scores: torch.Tensor,
                 mask: torch.Tensor, iou_threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS returning (keep ``[Q]``, cluster counts ``[Q]``, fused
    boxes ``[Q, 6]``). A kept box's fused box is the score-weighted mean of
    the boxes it suppressed, itself included; other rows keep their box."""
    keep, counts, fused = _nms_fused_batched(boxes, scores, mask[None],
                                             iou_threshold)
    return keep[0], counts[0], fused[0]


def nms_3d_with_counts(boxes, scores, mask, iou_threshold: float = 0.5):
    """Greedy NMS returning (keep, cluster counts)."""
    return nms_3d_fused(boxes, scores, mask, iou_threshold)[:2]


def nms_3d_mask(boxes, scores, mask, iou_threshold: float = 0.5):
    """Greedy NMS keep mask: highest score kept, IoU >= threshold
    suppressed."""
    return nms_3d_fused(boxes, scores, mask, iou_threshold)[0]


def post_process(
    pred_boxes: torch.Tensor,
    pred_logits: torch.Tensor,
    confidence_threshold: float = 0.7,
    nms_threshold: float = 0.3,
    num_classes: int = 4,
    consensus: bool = False,
    objectness: torch.Tensor | None = None,
    top_k: int | None = None,
    candidate_mask: torch.Tensor | None = None,
    fuse: bool = False,
    return_boxes: bool = False,
    support: float | None = None,
    conf_scale: torch.Tensor | None = None,
    soft_sigma: float | None = None,
):
    """Confidence filter and per-class NMS of ``pred_boxes [Q, 6]`` /
    ``pred_logits [Q, C]``.

    Confidence is the max softmax probability, times ``sigmoid(objectness)``
    when given; ``candidate_mask`` gates candidates before NMS;
    ``conf_scale`` rescales the ranking confidence after thresholding;
    ``support`` (support-ordered NMS) then multiplies it by the share of
    same-class passed confidence mass at IoU >= ``support``;
    ``soft_sigma`` makes the per-class sweep soft-NMS (``nms_threshold``
    is then the absorb threshold) and the kept boxes carry their decayed
    confidences; ``fuse`` returns each kept box's fused cluster box (needs
    ``return_boxes``); ``consensus`` multiplies confidence by the NMS
    cluster's share of queries; ``top_k`` keeps the K best survivors.

    Returns (keep ``[Q]`` bool, labels ``[Q]`` int32, confidences ``[Q]``)
    and the output boxes ``[Q, 6]`` when ``return_boxes``.
    """
    if fuse and not return_boxes:
        raise ValueError("fuse=True changes boxes; pass return_boxes=True")
    probs = torch.softmax(pred_logits, dim=-1)
    conf, _ = probs.max(dim=-1)
    if objectness is not None:
        conf = conf * torch.sigmoid(objectness)
    labels = probs.argmax(dim=-1).to(torch.int32)
    passed = conf > confidence_threshold
    if candidate_mask is not None:
        passed = passed & candidate_mask
    if conf_scale is not None:
        conf = conf * conf_scale
    if support is not None:
        iou = pairwise_iou_3d(pred_boxes, pred_boxes)
        same = labels[None, :] == labels[:, None]
        votes = ((iou >= support) & same & passed[None, :]).to(conf.dtype)
        mass = torch.where(passed, conf, 0.0)
        total = same.to(conf.dtype) @ mass
        conf = conf * (votes @ mass) / torch.clamp(total, min=1e-12)

    classes = torch.arange(num_classes, device=labels.device)
    masks = passed[None] & (labels[None] == classes[:, None])
    qi = torch.arange(labels.shape[0], device=labels.device)
    if soft_sigma is None:
        keep_pc, counts_pc, fused_pc = _nms_fused_batched(
            pred_boxes, conf, masks, nms_threshold)
        keep = keep_pc.any(dim=0)
    else:
        keep_pc, counts_pc, fused_pc, conf_pc = _soft_nms_fused_batched(
            pred_boxes, conf, masks, nms_threshold, soft_sigma)
        keep = keep_pc.any(dim=0)
        # a box is kept only by its own class's pass: adopt its decayed
        # confidence as the ranking signal
        conf = torch.where(keep, conf_pc[labels.long(), qi], conf)
    out_boxes = pred_boxes
    if fuse:
        out_boxes = torch.where(keep[:, None], fused_pc[labels.long(), qi],
                                pred_boxes)
    if consensus:
        conf = conf * counts_pc.sum(dim=0) / pred_boxes.shape[0]
    if top_k is not None:
        kept_conf = torch.where(keep, conf, -torch.inf)
        order = torch.argsort(-kept_conf, stable=True)
        rank = torch.empty_like(order)
        rank[order] = qi
        keep = keep & (rank < top_k)
    if return_boxes:
        return keep, labels, conf, out_boxes
    return keep, labels, conf
