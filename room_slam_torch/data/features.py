"""Kinematic features: ``[x, y, z, t, vx, vy, vz, ax, ay, az, speed]``.

``process_traces_np`` is a numpy copy of the JAX package's host featurizer
(single-trace serving path); ``featurize`` and ``trace_stats`` are the
batched tensor versions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

FEAT_DIM = 11


def _diff_prepend_first(x: torch.Tensor) -> torch.Tensor:
    """``diff`` along dim -2 with the first row prepended (first row 0)."""
    return torch.cat([torch.zeros_like(x[..., :1, :]),
                      x[..., 1:, :] - x[..., :-1, :]], dim=-2)


def featurize(raw: torch.Tensor,
              length: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Featurize padded, time-sorted raw traces.

    Args:
        raw: ``[..., L, 4]`` float32 (x, y, z, t); rows ``>= length`` are
            padding.
        length: ``[...]`` integer count of valid rows (>= 1).

    Returns:
        feats ``[..., L, 11]`` (zeros in padded rows), mask ``[..., L]``.
        Velocity is ``diff(pos) / clip(diff(t), 1e-3)``; acceleration is
        ``diff(velocity)`` (not divided by dt); first rows are 0.
    """
    L = raw.shape[-2]
    mask = torch.arange(L, device=raw.device) < length[..., None]
    feats = kinematics(raw, raw[..., :1, 3:4])
    return feats * mask[..., None].to(raw.dtype), mask


def kinematics(raw: torch.Tensor, t0: torch.Tensor) -> torch.Tensor:
    """The 11 features of ``raw [..., L, 4]`` before masking, time counted
    from ``t0 [..., 1, 1]``; the first row's diffs are 0."""
    pos = raw[..., :3]
    t = raw[..., 3:4] - t0
    vel = _diff_prepend_first(pos) / torch.clamp(_diff_prepend_first(t),
                                                 min=1e-3)
    acc = _diff_prepend_first(vel)
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    return torch.cat([pos, t, vel, acc, speed], dim=-1)


def trace_stats(coords: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean ``[.., 1, 3]`` and RMS x-z scale ``[.., 1, 1]`` of raw
    coordinates, used for relative box decoding."""
    m = mask[..., None].to(coords.dtype)
    denom = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
    mean = (coords * m).sum(dim=-2, keepdim=True) / denom
    centered = (coords - mean) * m
    xz_sq = centered[..., 0] ** 2 + centered[..., 2] ** 2
    rms = torch.sqrt(xz_sq.sum(dim=-1, keepdim=True)[..., None] / denom)
    return mean, torch.clamp(rms, min=1e-3)


def process_traces_np(arr: np.ndarray, max_len: int = 3000) -> np.ndarray:
    """Host featurizer for one trace.

    Args:
        arr: ``[N, 4]`` float32 (x, y, z, t), any order.
        max_len: uniform-index downsampling target.

    Returns:
        ``[min(N, max_len), 11]`` float32; ``[1, 11]`` zeros when empty.
    """
    arr = np.asarray(arr, dtype=np.float32)
    if arr.shape[0] == 0:
        return np.zeros((1, FEAT_DIM), dtype=np.float32)

    arr = arr[np.argsort(arr[:, 3], kind="stable")].copy()
    arr[:, 3] -= arr[0, 3]

    diffs = np.diff(arr, axis=0, prepend=arr[[0], :])
    dt = np.clip(diffs[:, 3], 1e-3, None)
    vel = diffs[:, :3] / dt[:, None]
    acc = np.diff(vel, axis=0, prepend=vel[[0], :])
    speed = np.linalg.norm(vel, axis=1, keepdims=True)
    feats = np.concatenate([arr, vel, acc, speed], axis=1).astype(np.float32)

    if feats.shape[0] > max_len:
        feats = feats[np.linspace(0, feats.shape[0] - 1, max_len, dtype=int)]
    return feats
