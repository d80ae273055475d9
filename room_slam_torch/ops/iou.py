"""Axis-aligned 3D IoU and GIoU of ``(cx, cy, cz, sx, sy, sz)`` boxes, and
the rotated 2D IoU of the legacy surface (counterpart of the JAX package's
``ops/iou.py``)."""

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


# ---------------------------------------------------------------------------
# Rotated-rectangle IoU (legacy surface: 2D boxes with a yaw)
# ---------------------------------------------------------------------------

_RING = 16   # slots of a padded polygon ring: clipping adds at most one a cut


def _box_corners_2d(boxes: torch.Tensor) -> torch.Tensor:
    """Corners of rotated rectangles: ``[..., 5] (cx, cy, w, h, theta)`` ->
    ``[..., 4, 2]`` counter-clockwise."""
    cx, cy, w, h, th = boxes.unbind(-1)
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    dx = torch.stack([w, w, -w, -w], dim=-1) / 2
    dy = torch.stack([-h, h, h, -h], dim=-1) / 2
    x = cx[..., None] + c * dx - s * dy
    y = cy[..., None] + s * dx + c * dy
    return torch.stack([x, y], dim=-1)


def _ring_next(n: torch.Tensor) -> torch.Tensor:
    """Index of each slot's successor on rings of ``n [...]`` points:
    ``[..., K]``, wrapping to 0 after the last point."""
    idx = torch.arange(_RING, device=n.device)
    return torch.where(idx + 1 >= n[..., None], torch.zeros_like(idx),
                       idx + 1)


def _polygon_area(pts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the first ``n [...]`` points of padded rings
    ``pts [..., K, 2]``."""
    nxt = torch.gather(pts, -2, _ring_next(n)[..., None].expand_as(pts))
    cross = pts[..., 0] * nxt[..., 1] - nxt[..., 0] * pts[..., 1]
    valid = torch.arange(_RING, device=n.device) < n[..., None]
    return 0.5 * torch.where(valid, cross, torch.zeros_like(cross)) \
        .sum(-1).abs()


def _clip_polygon(pts: torch.Tensor, n: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor):
    """Sutherland-Hodgman: clip padded convex rings ``pts [..., K, 2]`` of
    ``n [...]`` points by the half-plane left of the directed edges
    ``a -> b`` (``[..., 2]``). Each input edge emits its start point if it
    is inside, then the crossing point if the edge crosses; the emitted
    points are compacted by prefix sums. Returns ``(ring, count)``."""
    idx = torch.arange(_RING, device=n.device)
    nxt_pts = torch.gather(pts, -2, _ring_next(n)[..., None].expand_as(pts))
    edge = b - a

    def side(p):
        return edge[..., None, 0] * (p[..., 1] - a[..., None, 1]) \
            - edge[..., None, 1] * (p[..., 0] - a[..., None, 0])

    s_cur, s_nxt = side(pts), side(nxt_pts)
    in_cur, in_nxt = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
    inter = pts + t[..., None] * (nxt_pts - pts)
    live = idx < n[..., None]
    emit_cur = in_cur & live
    emit_int = (in_cur != in_nxt) & live
    counts = emit_cur.long() + emit_int.long()
    offsets = torch.cumsum(counts, -1) - counts
    # slot K collects what is not emitted and is cut off afterwards
    out = pts.new_zeros(*pts.shape[:-2], _RING + 1, 2)
    dump = torch.full_like(offsets, _RING)
    pos_cur = torch.where(emit_cur, offsets, dump)
    pos_int = torch.where(emit_int, offsets + emit_cur.long(), dump)
    out.scatter_(-2, pos_cur[..., None].expand_as(pts), pts)
    out.scatter_(-2, pos_int[..., None].expand_as(pts), inter)
    return out[..., :_RING, :], counts.sum(-1)


def rotated_iou_2d(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """IoU of rotated rectangles ``(cx, cy, w, h, theta)``, ``[..., 5]``
    each, broadcast against each other (``[P, 1, 5]`` and ``[1, G, 5]``
    give all ``[P, G]`` pairs): the first quad clipped by the four edges of
    the second (at most 8 vertices), shoelace area, +1e-6 in the
    denominator."""
    box1, box2 = torch.broadcast_tensors(box1, box2)
    c1, c2 = _box_corners_2d(box1), _box_corners_2d(box2)
    pts = box1.new_zeros(*box1.shape[:-1], _RING, 2)
    pts[..., :4, :] = c1
    n = torch.full(box1.shape[:-1], 4, dtype=torch.long, device=box1.device)
    for e in range(4):
        pts, n = _clip_polygon(pts, n, c2[..., e, :], c2[..., (e + 1) % 4, :])
    area = _polygon_area(pts, n)
    inter = torch.where(n >= 3, area, torch.zeros_like(area))
    a1 = box1[..., 2] * box1[..., 3]
    a2 = box2[..., 2] * box2[..., 3]
    return inter / (a1 + a2 - inter + _EPS)
