"""Axis-aligned 3D IoU and GIoU of ``(cx, cy, cz, sx, sy, sz)`` boxes
(counterpart of the JAX package's ``ops/iou.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-6


def iou_giou_3d(boxes1: torch.Tensor,
                boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paired IoU and GIoU of ``[..., 6]`` boxes, each ``[...]``; +1e-6 in
    both denominators."""
    b1_min = boxes1[..., :3] - boxes1[..., 3:] / 2
    b1_max = boxes1[..., :3] + boxes1[..., 3:] / 2
    b2_min = boxes2[..., :3] - boxes2[..., 3:] / 2
    b2_max = boxes2[..., :3] + boxes2[..., 3:] / 2

    inter = torch.clamp(torch.minimum(b1_max, b2_max)
                        - torch.maximum(b1_min, b2_min), min=0.0).prod(-1)
    union = boxes1[..., 3:].prod(-1) + boxes2[..., 3:].prod(-1) - inter
    iou = inter / (union + _EPS)

    enc = torch.clamp(torch.maximum(b1_max, b2_max)
                      - torch.minimum(b1_min, b2_min), min=0.0).prod(-1)
    return iou, iou - (enc - union) / (enc + _EPS)


def iou_giou_2d_xz(boxes1: torch.Tensor,
                   boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paired IoU and GIoU of the XZ footprints of ``[..., 6]`` boxes (the
    footprint loss term)."""
    idx = [0, 2, 3, 5]                       # (cx, cz, sx, sz)
    f1, f2 = boxes1[..., idx], boxes2[..., idx]
    b1_min = f1[..., :2] - f1[..., 2:] / 2
    b1_max = f1[..., :2] + f1[..., 2:] / 2
    b2_min = f2[..., :2] - f2[..., 2:] / 2
    b2_max = f2[..., :2] + f2[..., 2:] / 2
    inter = torch.clamp(torch.minimum(b1_max, b2_max)
                        - torch.maximum(b1_min, b2_min), min=0.0).prod(-1)
    union = f1[..., 2:].prod(-1) + f2[..., 2:].prod(-1) - inter
    iou = inter / (union + _EPS)
    enc = torch.clamp(torch.maximum(b1_max, b2_max)
                      - torch.minimum(b1_min, b2_min), min=0.0).prod(-1)
    return iou, iou - (enc - union) / (enc + _EPS)


def eval_pair_iou_3d(pb: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """Paired IoU with the evaluator's denominator convention (1e-6 added
    to the union before the divide)."""
    p_min, p_max = pb[..., :3] - pb[..., 3:] / 2, pb[..., :3] + pb[..., 3:] / 2
    g_min, g_max = gb[..., :3] - gb[..., 3:] / 2, gb[..., :3] + gb[..., 3:] / 2
    inter = torch.clamp(torch.minimum(p_max, g_max)
                        - torch.maximum(p_min, g_min), min=0.0).prod(-1)
    union = pb[..., 3:].prod(-1) + gb[..., 3:].prod(-1) - inter + _EPS
    return inter / union


def pairwise_iou_3d(boxes1: torch.Tensor,
                    boxes2: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: ``[N, 6] x [M, 6] -> [N, M]``."""
    return iou_giou_3d(boxes1[:, None, :], boxes2[None, :, :])[0]
