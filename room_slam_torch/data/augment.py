"""Training augmentation on the device (counterpart of the JAX package's
``data/augment.py``).

All random draws for a batch happen at once from one ``torch.Generator``
(``draw_rands``); ``apply_augment`` is then a deterministic function of the
batch and those draws, written over a leading batch dimension. Order as in
the reference: rotate (k * 90 degrees about Y, x/z sizes swap for odd k) ->
translate (X-Z) -> scale (isotropic, coordinates and boxes) -> position
noise -> crop -> 2-piece monotone time warp -> collider dropout (walls
never dropped, never everything).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from room_slam_torch.config import DataConfig

# exact rotation table for k * 90 degrees: cos, sin
_ROT_COS = (1.0, 0.0, -1.0, 0.0)
_ROT_SIN = (0.0, 1.0, 0.0, -1.0)


class Sample(NamedTuple):
    """A batch of fixed-shape training samples (pre-featurization)."""

    raw: torch.Tensor      # [B, L, 4] (x, y, z, t), time-sorted, zero-padded
    length: torch.Tensor   # [B]       int, number of valid rows
    boxes: torch.Tensor    # [B, M, 6] (cx, cy, cz, sx, sy, sz)
    labels: torch.Tensor   # [B, M]    int, -1 for padding
    valid: torch.Tensor    # [B, M]    bool


class AugRand(NamedTuple):
    """Per-sample random draws, each with a leading batch dim."""

    t_xz: torch.Tensor       # [B, 2]
    scale: torch.Tensor      # [B]
    noise_gate: torch.Tensor  # [B]
    noise: torch.Tensor      # [B, L, 3]
    crop_gate: torch.Tensor  # [B]
    crop_u1: torch.Tensor    # [B]
    crop_u2: torch.Tensor    # [B]
    warp_gate: torch.Tensor  # [B]
    warp_k: torch.Tensor     # [B]
    warp_s1: torch.Tensor    # [B]
    warp_s2: torch.Tensor    # [B]
    drop_gate: torch.Tensor  # [B]
    drop_u: torch.Tensor     # [B, M]


def draw_rands(generator: torch.Generator, batch: int, L: int, M: int,
               cfg: DataConfig, device: torch.device | str = "cpu"
               ) -> AugRand:
    """All stochastic draws for a whole batch, from ``generator`` (which
    must live on ``device``)."""
    def u(*shape, lo=0.0, hi=1.0):
        x = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * x

    sigma = torch.tensor(cfg.noise_sigma, dtype=torch.float32, device=device)
    tr = cfg.translation_range
    return AugRand(
        t_xz=u(batch, 2, lo=-tr, hi=tr),
        scale=u(batch, lo=cfg.scale_range[0], hi=cfg.scale_range[1]),
        noise_gate=u(batch),
        noise=torch.randn((batch, L, 3), generator=generator,
                          device=device) * sigma,
        crop_gate=u(batch),
        crop_u1=u(batch),
        crop_u2=u(batch),
        warp_gate=u(batch),
        warp_k=u(batch, lo=0.4, hi=0.6),
        warp_s1=u(batch, lo=0.5, hi=1.5),
        warp_s2=u(batch, lo=0.5, hi=1.5),
        drop_gate=u(batch),
        drop_u=u(batch, M),
    )


def _rot_table(k: torch.Tensor, dtype: torch.dtype):
    c = torch.tensor(_ROT_COS, dtype=dtype, device=k.device)[k.long() % 4]
    s = torch.tensor(_ROT_SIN, dtype=dtype, device=k.device)[k.long() % 4]
    return c, s


def rotate_raw(raw: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Y-rotate ``[B, ..., 4]`` (x, y, z, t) points by ``k [B]`` * 90
    degrees: x' = c*x + s*z ; z' = -s*x + c*z."""
    c, s = _rot_table(k, raw.dtype)
    c = c.view(-1, *([1] * (raw.dim() - 2)))
    s = s.view_as(c)
    x, y, z, t = raw.unbind(-1)
    return torch.stack([c * x + s * z, y, -s * x + c * z, t], dim=-1)


def unrotate_boxes(boxes_r: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Map boxes ``[R, Q, 6]`` predicted in a ``ks [R]``-rotated frame back
    to the capture frame (test-time augmentation): centers get the
    (4 - k) % 4 rotation, x/z sizes swap for odd k."""
    c, s = _rot_table((4 - ks % 4) % 4, boxes_r.dtype)
    c, s = c[:, None], s[:, None]
    cx, cz = boxes_r[..., 0], boxes_r[..., 2]
    odd = ((ks % 2) == 1)[:, None]
    return torch.stack([
        c * cx + s * cz,
        boxes_r[..., 1],
        -s * cx + c * cz,
        torch.where(odd, boxes_r[..., 5], boxes_r[..., 3]),
        boxes_r[..., 4],
        torch.where(odd, boxes_r[..., 3], boxes_r[..., 5]),
    ], dim=-1)


def reflect_raw(raw: torch.Tensor) -> torch.Tensor:
    """Mirror ``[..., 4]`` (x, y, z, t) points across x = 0."""
    return raw * raw.new_tensor([-1.0, 1.0, 1.0, 1.0])


def unreflect_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Inverse box transform of ``reflect_raw`` (its own inverse)."""
    return boxes * boxes.new_tensor([-1.0, 1.0, 1.0, 1.0, 1.0, 1.0])


def scale_raw(raw: torch.Tensor, s) -> torch.Tensor:
    """Scale ``[..., 4]`` trace positions by ``s``; timestamps untouched."""
    return raw * raw.new_tensor([1.0, 1.0, 1.0, 0.0]) * s \
        + raw * raw.new_tensor([0.0, 0.0, 0.0, 1.0])


def unscale_boxes(boxes: torch.Tensor, s) -> torch.Tensor:
    """Inverse box transform of ``scale_raw``."""
    return boxes / s


def rotate_sample(sample: Sample, k: torch.Tensor) -> Sample:
    """Rotate traces and boxes of a batch about Y by ``k [B]`` * 90
    degrees; box x/z sizes swap for odd k."""
    c, s = _rot_table(k, sample.boxes.dtype)
    c, s = c[:, None], s[:, None]
    b = sample.boxes
    cx, cy, cz, sx, sy, sz = b.unbind(-1)
    odd = ((k % 2) == 1)[:, None]
    boxes = torch.stack([c * cx + s * cz, cy, -s * cx + c * cz,
                         torch.where(odd, sz, sx), sy,
                         torch.where(odd, sx, sz)], dim=-1)
    return sample._replace(raw=rotate_raw(sample.raw, k), boxes=boxes)


def _is_wall(boxes: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """BLOCK colliders larger than 5 m in x or z are walls, never
    dropped."""
    return (labels == 0) & ((boxes[..., 3] > 5.0) | (boxes[..., 5] > 5.0))


def apply_augment(sample: Sample, rotation_k: torch.Tensor, r: AugRand,
                  cfg: DataConfig) -> Sample:
    """Deterministic augmentation of a batch given pre-drawn randoms."""
    B, L = sample.raw.shape[:2]
    if cfg.augment_rotation:
        sample = rotate_sample(sample, rotation_k)

    raw, boxes = sample.raw, sample.boxes
    length, labels, valid = sample.length, sample.labels, sample.valid

    if cfg.augment_translation:
        zero = torch.zeros_like(r.t_xz[:, 0])
        shift = torch.stack([r.t_xz[:, 0], zero, r.t_xz[:, 1], zero], -1)
        raw = raw + shift[:, None, :]
        boxes = boxes + torch.stack(
            [r.t_xz[:, 0], zero, r.t_xz[:, 1], zero, zero, zero],
            -1)[:, None, :]

    if cfg.augment_scale:
        xyz_only = raw.new_tensor([1.0, 1.0, 1.0, 0.0])
        raw = raw * (xyz_only * r.scale[:, None, None] + (1.0 - xyz_only))
        boxes = boxes * r.scale[:, None, None]

    if cfg.noise_prob > 0:
        do_noise = (r.noise_gate < cfg.noise_prob)[:, None, None]
        noisy = torch.cat([raw[..., :3] + r.noise, raw[..., 3:]], dim=-1)
        raw = torch.where(do_noise, noisy, raw)

    if cfg.crop_prob > 0:
        do_crop = (r.crop_gate < cfg.crop_prob) & (length > 100)
        lf = length.to(torch.float32)
        lo = (0.2 * lf).to(torch.int32)
        hi = (0.8 * lf).to(torch.int32)
        start = (r.crop_u1 * lo.clamp(min=1).to(torch.float32)
                 ).to(torch.int32)
        end = hi + (r.crop_u2 * (length - hi).clamp(min=1).to(torch.float32)
                    ).to(torch.int32)
        start = torch.where(do_crop, start, torch.zeros_like(start))
        end = torch.where(do_crop, end, length.to(torch.int32))
        idx = torch.clamp(torch.arange(L, device=raw.device)[None, :]
                          + start[:, None].long(), max=L - 1)
        raw = torch.gather(raw, 1, idx[..., None].expand(-1, -1, 4))
        length = (end - start).to(length.dtype)

    if cfg.time_warp_prob > 0:
        do_warp = (r.warp_gate < cfg.time_warp_prob)[:, None]
        t = raw[..., 3]
        t_rel = t - t[:, :1]
        last = (length.long() - 1).clamp(min=0)[:, None]
        t_max = torch.gather(t_rel, 1, last) + 1e-6              # [B, 1]
        k, s1, s2 = r.warp_k[:, None], r.warp_s1[:, None], r.warp_s2[:, None]
        first = t_rel / t_max < k
        warped = torch.where(first, t_rel * s1,
                             k * t_max * s1 + (t_rel - k * t_max) * s2)
        raw = torch.cat([raw[..., :3],
                         torch.where(do_warp, warped, t_rel)[..., None]], -1)

    if cfg.augment_collider_dropout:
        gate = (r.drop_gate < cfg.dropout_gate_prob)[:, None]
        keep = _is_wall(boxes, labels) | (r.drop_u > cfg.collider_dropout_prob)
        new_valid = valid & keep
        # never drop everything
        new_valid = torch.where(new_valid.any(dim=1, keepdim=True),
                                new_valid, valid)
        valid = torch.where(gate, new_valid, valid)

    return Sample(raw=raw, length=length, boxes=boxes, labels=labels,
                  valid=valid)
