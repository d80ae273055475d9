"""The port's batched augmentation against the JAX package's vmapped
``apply_augment``, both fed the same draws (JAX's own ``draw_rands``), per
operation and all together, at rtol 1e-6 / atol 1e-5 (positions in metres,
times in seconds); integer and mask outputs exactly. Plus the port's own
``draw_rands`` shapes and ranges, and the TTA helpers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import DataConfig as TorchDataConfig
from room_slam_torch.data import augment as aug_t
from room_slam_tpu.config import DataConfig
from room_slam_tpu.data import augment as aug_j

B, L, M = 6, 160, 8
OFF = dict(augment_rotation=False, augment_translation=False,
           augment_scale=False, augment_collider_dropout=False,
           noise_prob=0.0, crop_prob=0.0, time_warp_prob=0.0)
CASES = {
    "rotate": dict(augment_rotation=True),
    "translate": dict(augment_translation=True),
    "scale": dict(augment_scale=True),
    "noise": dict(noise_prob=0.8),
    "crop": dict(crop_prob=0.5),
    "time_warp": dict(time_warp_prob=0.5),
    "collider_dropout": dict(augment_collider_dropout=True),
    "all": {},
}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    length = rng.integers(60, L + 1, size=B).astype(np.int32)
    length[0] = L
    raw = np.zeros((B, L, 4), np.float32)
    for b in range(B):
        n = length[b]
        raw[b, :n, :3] = np.cumsum(rng.normal(size=(n, 3)) * 0.1, 0)
        raw[b, :n, 3] = np.sort(rng.uniform(0, 40, n))
    boxes = np.concatenate([rng.normal(size=(B, M, 3)) * 2,
                            rng.uniform(0.3, 7.0, size=(B, M, 3))], -1)
    labels = rng.integers(0, 4, size=(B, M)).astype(np.int32)
    valid = rng.uniform(size=(B, M)) < 0.8
    return dict(raw=raw, length=length, boxes=boxes.astype(np.float32),
                labels=labels, valid=valid,
                rotation_k=rng.integers(0, 4, size=B).astype(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_apply_augment_matches_jax(case):
    kw = {**OFF, **CASES[case]} if case != "all" else {}
    cfg = DataConfig(**kw)
    tcfg = TorchDataConfig(**dataclasses.asdict(cfg))
    data = _batch()
    rands = jax.device_get(aug_j.draw_rands(jax.random.key(3), B, L, M, cfg))
    names = ("raw", "length", "boxes", "labels", "valid")
    ref = jax.vmap(lambda s, k, r: aug_j.apply_augment(s, k, r, cfg))(
        aug_j.Sample(*(jnp.asarray(data[n]) for n in names)),
        jnp.asarray(data["rotation_k"]), rands)
    got = aug_t.apply_augment(
        aug_t.Sample(*(torch.from_numpy(data[n]) for n in names)),
        torch.from_numpy(data["rotation_k"]),
        aug_t.AugRand(*(torch.from_numpy(np.array(x)) for x in rands)),
        tcfg)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(ref.length))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for g, r in ((got.raw, ref.raw), (got.boxes, ref.boxes)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-5)


def test_draw_rands_shapes_and_ranges():
    cfg = TorchDataConfig()
    g = torch.Generator().manual_seed(0)
    r = aug_t.draw_rands(g, 64, L, M, cfg)
    shapes = dict(t_xz=(64, 2), noise=(64, L, 3), drop_u=(64, M))
    for name, x in r._asdict().items():
        assert x.shape == shapes.get(name, (64,)), name
        assert x.dtype == torch.float32
    tr = cfg.translation_range
    assert -tr <= r.t_xz.min() and r.t_xz.max() <= tr
    assert cfg.scale_range[0] <= r.scale.min() <= r.scale.max() \
        <= cfg.scale_range[1]
    assert 0.4 <= r.warp_k.min() and r.warp_k.max() <= 0.6
    for x in (r.warp_s1, r.warp_s2):
        assert 0.5 <= x.min() and x.max() <= 1.5
    for x in (r.noise_gate, r.crop_gate, r.warp_gate, r.drop_gate, r.drop_u):
        assert 0.0 <= x.min() and x.max() < 1.0
    # per-axis noise scale follows noise_sigma
    np.testing.assert_allclose(r.noise.std(dim=(0, 1)).numpy(),
                               cfg.noise_sigma, rtol=0.1)
    g2 = torch.Generator().manual_seed(0)
    again = aug_t.draw_rands(g2, 64, L, M, cfg)
    assert all(torch.equal(a, b) for a, b in zip(r, again))


def test_tta_helpers_match_jax():
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(4, 9, 4)).astype(np.float32)
    boxes = rng.normal(size=(4, 5, 6)).astype(np.float32)
    ks = np.arange(4, dtype=np.int32)
    tr, tb, tk = map(torch.from_numpy, (raw, boxes, ks))
    pairs = [
        (aug_t.rotate_raw(tr, tk),
         jax.vmap(aug_j.rotate_raw)(jnp.asarray(raw), jnp.asarray(ks))),
        (aug_t.unrotate_boxes(tb, tk), aug_j.unrotate_boxes(boxes, ks)),
        (aug_t.reflect_raw(tr), aug_j.reflect_raw(jnp.asarray(raw))),
        (aug_t.unreflect_boxes(tb), aug_j.unreflect_boxes(jnp.asarray(boxes))),
        (aug_t.scale_raw(tr, 1.1), aug_j.scale_raw(jnp.asarray(raw), 1.1)),
        (aug_t.unscale_boxes(tb, 1.1), aug_j.unscale_boxes(boxes, 1.1)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
