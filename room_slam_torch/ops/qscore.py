"""Learned per-candidate quality scoring (counterpart of the JAX package's
``ops/qscore.py``): a small MLP over physics, geometry and agreement
features of each candidate, applied at post-process time as
``post_process``'s ``conf_scale`` multiplier. ``tools/qscore.py`` fits
the scorer from ``mlp_init``'s draw; ``load_params`` reads its weight
JSON (the JAX package's tool writes the same file)."""

from __future__ import annotations

import json
from typing import Dict

import torch
import torch.nn.functional as F

from room_slam_torch.data import prng
from room_slam_torch.ops.iou import pairwise_iou_3d
from room_slam_torch.ops.refine import trace_extent
from room_slam_torch.ops.ttopt import penetration_depth

N_FEATURES = 18


def candidate_features(boxes: torch.Tensor, logits: torch.Tensor,
                       objectness, raw: torch.Tensor, length,
                       support_iou: float = 0.25,
                       contact_margin: float = 0.3) -> torch.Tensor:
    """``[Q, N_FEATURES]`` evidence features of each candidate: confidence
    and class one-hot; log sizes, log footprint, absolute y placement;
    mean penetration depth and XZ overshoot beyond the visited envelope
    (over its larger span); the share of trace points within
    ``contact_margin`` of the footprint and the nearest approach; the
    same-class support mass at IoU >= ``support_iou`` and the vote
    share."""
    if logits.shape[-1] != 4:
        raise ValueError("qscore features are fitted for 4 classes, got "
                         f"C={logits.shape[-1]}")
    Q, L = boxes.shape[0], raw.shape[0]
    conf = torch.softmax(logits, dim=-1).amax(dim=-1)
    if objectness is not None:
        conf = conf * torch.sigmoid(objectness)
    labels = logits.argmax(-1)
    onehot = F.one_hot(labels, 4).to(boxes.dtype)

    cx, cy, cz = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    sx, sy, sz = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    logs = torch.log(torch.clamp(torch.stack([sx, sy, sz], -1), 1e-3, 50.0))
    foot = torch.log(torch.clamp(sx * sz, 1e-4, 100.0))

    pen = penetration_depth(boxes, raw, length)

    x_min, x_max, z_min, z_max = trace_extent(raw, length)
    span = torch.clamp(torch.maximum(x_max - x_min, z_max - z_min), min=1e-3)
    over_x = torch.clamp(torch.maximum((cx + sx / 2) - x_max,
                                       x_min - (cx - sx / 2)), min=0.0)
    over_z = torch.clamp(torch.maximum((cz + sz / 2) - z_max,
                                       z_min - (cz - sz / 2)), min=0.0)

    valid = torch.arange(L, device=raw.device) < length
    px, pz = raw[:, 0], raw[:, 2]
    ax = torch.clamp(torch.abs(px[None, :] - cx[:, None]) - sx[:, None] / 2,
                     min=0.0)
    az = torch.clamp(torch.abs(pz[None, :] - cz[:, None]) - sz[:, None] / 2,
                     min=0.0)
    d = torch.sqrt(ax ** 2 + az ** 2 + 1e-12)                   # [Q, L]
    n_valid = torch.clamp(valid.sum(), min=1)
    near = (valid[None, :] & (d < contact_margin)).sum(dim=1) / n_valid
    min_d = torch.where(valid[None, :], d, torch.inf).amin(dim=1)
    min_d = torch.clamp(min_d, max=10.0)

    iou = pairwise_iou_3d(boxes, boxes)
    same = labels[None, :] == labels[:, None]
    votes = (iou >= support_iou) & same
    mass = votes.to(conf.dtype) @ conf
    total = same.to(conf.dtype) @ conf
    support = mass / torch.clamp(total, min=1e-9)
    n_votes = votes.sum(-1).to(torch.float32) / Q

    return torch.cat([
        conf[:, None], onehot, logs, foot[:, None],
        cy[:, None], (cy - sy / 2)[:, None],
        pen[:, None],
        (over_x / span)[:, None], (over_z / span)[:, None],
        torch.stack([near.to(boxes.dtype), min_d], -1),
        support[:, None], n_votes[:, None],
    ], dim=-1)


def mlp_init(key: torch.Tensor, hidden: int = 16,
             n_features: int = N_FEATURES) -> Dict[str, torch.Tensor]:
    """The scorer's initial weights from the threefry ``key`` (``prng.key``),
    as the JAX package's ``mlp_init`` draws them: normal layers scaled by
    0.3, zero biases, identity standardization. On the key's device."""
    k1, k2 = prng.split(key)
    dev = key.device
    return {
        "w1": prng.normal(k1, (n_features, hidden)) * 0.3,
        "b1": torch.zeros(hidden, device=dev),
        "w2": prng.normal(k2, (hidden, 1)) * 0.3,
        "b2": torch.zeros(1, device=dev),
        "mu": torch.zeros(n_features, device=dev),
        "sigma": torch.ones(n_features, device=dev),
    }


def mlp_apply(params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """``[..., F]`` features to ``[...]`` quality logits."""
    z = (x - params["mu"]) / params["sigma"]
    h = torch.tanh(z @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[..., 0]


def load_params(path: str, device: str | torch.device = "cpu"
                ) -> Dict[str, torch.Tensor]:
    """The scorer's weight JSON as float32 tensors on ``device``; keys
    starting with ``_`` (metadata) are skipped."""
    with open(path) as f:
        raw = json.load(f)
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in raw.items() if not k.startswith("_")}


def quality_scale(params: Dict[str, torch.Tensor], boxes, logits,
                  objectness, raw, length) -> torch.Tensor:
    """``[Q]`` rescoring factor ``sigmoid(q)`` for ``post_process``'s
    ``conf_scale``."""
    x = candidate_features(boxes, logits, objectness, raw, length)
    return torch.sigmoid(mlp_apply(params, x))
