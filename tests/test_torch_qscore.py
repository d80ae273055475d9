"""The port's learned quality scorer (``room_slam_torch/ops/qscore.py``)
against the JAX package's: ``candidate_features`` within rtol 1e-5 /
atol 1e-5 and ``quality_scale`` within 1e-5 with
``results/r5_qscore_multi.json``'s weights."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import qscore as tq
from room_slam_tpu.ops import qscore as jq

WEIGHTS = Path(__file__).resolve().parents[1] / "results" / \
    "r5_qscore_multi.json"


def _setup(seed, Q=24, L=300, n_valid=211):
    """Pooled candidates around a seeded walk (clusters of near-duplicate
    boxes, so the support features vote), padding rows past ``n_valid``."""
    rng = np.random.default_rng(seed)
    xz = np.clip(np.cumsum(rng.normal(size=(L, 2)) * 0.25, 0), -2.5, 2.5)
    raw = np.stack([xz[:, 0], 1.4 + rng.normal(size=L) * 0.05, xz[:, 1],
                    np.arange(L) * 0.05], 1)
    raw[n_valid:] = rng.uniform(20, 30, (L - n_valid, 4))
    centers = np.concatenate([rng.uniform(-3, 3, (6, 1)),
                              rng.uniform(0.2, 1.5, (6, 1)),
                              rng.uniform(-3, 3, (6, 1))], 1)
    sizes = rng.uniform(0.1, 2.0, (6, 3))
    k = rng.integers(0, 6, Q)
    boxes = np.concatenate([centers[k] + rng.normal(size=(Q, 3)) * 0.05,
                            sizes[k] * rng.uniform(0.9, 1.1, (Q, 3))], 1)
    logits = rng.normal(size=(Q, 4)) * 2.0
    obj = rng.normal(size=Q)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(boxes), f32(logits), f32(obj), f32(raw), n_valid


@pytest.mark.parametrize("seed,objectness", [(0, True), (1, False),
                                             (2, True)])
def test_candidate_features_match_jax(seed, objectness):
    boxes, logits, obj, raw, n = _setup(seed)
    obj = obj if objectness else None
    got = tq.candidate_features(
        torch.from_numpy(boxes), torch.from_numpy(logits),
        None if obj is None else torch.from_numpy(obj),
        torch.from_numpy(raw), n)
    ref = jq.candidate_features(
        jnp.asarray(boxes), jnp.asarray(logits),
        None if obj is None else jnp.asarray(obj), jnp.asarray(raw),
        jnp.asarray(n))
    assert got.shape == ref.shape == (len(boxes), tq.N_FEATURES)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert np.asarray(ref)[:, 17].max() > 1.0 / len(boxes)   # votes cast


def test_quality_scale_matches_jax_with_published_weights():
    tparams = tq.load_params(str(WEIGHTS))
    jparams = jq.load_params(str(WEIGHTS))
    assert set(tparams) == set(jparams) == {"w1", "b1", "w2", "b2", "mu",
                                            "sigma"}
    for seed in (0, 3):
        boxes, logits, obj, raw, n = _setup(seed)
        got = tq.quality_scale(tparams, torch.from_numpy(boxes),
                               torch.from_numpy(logits),
                               torch.from_numpy(obj), torch.from_numpy(raw),
                               n)
        ref = jq.quality_scale(jparams, jnp.asarray(boxes),
                               jnp.asarray(logits), jnp.asarray(obj),
                               jnp.asarray(raw), jnp.asarray(n))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
        assert float(np.ptp(np.asarray(ref))) > 0.05        # it rescores


def test_load_params_skips_metadata_and_mlp_apply_matches(tmp_path):
    rng = np.random.default_rng(4)
    w = {"w1": rng.normal(size=(18, 5)).tolist(),
         "b1": rng.normal(size=5).tolist(),
         "w2": rng.normal(size=(5, 1)).tolist(), "b2": [0.3],
         "mu": rng.normal(size=18).tolist(),
         "sigma": rng.uniform(0.5, 2, 18).tolist(), "_meta": {"hidden": 5}}
    path = tmp_path / "w.json"
    path.write_text(json.dumps(w))
    tparams = tq.load_params(str(path))
    assert "_meta" not in tparams
    assert all(v.dtype == torch.float32 for v in tparams.values())
    x = rng.normal(size=(7, 18)).astype(np.float32)
    np.testing.assert_allclose(
        tq.mlp_apply(tparams, torch.from_numpy(x)).numpy(),
        np.asarray(jq.mlp_apply(jq.load_params(str(path)), jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_candidate_features_need_four_classes():
    boxes, logits, obj, raw, n = _setup(0)
    with pytest.raises(ValueError, match="4 classes"):
        tq.candidate_features(torch.from_numpy(boxes),
                              torch.from_numpy(logits[:, :3]), None,
                              torch.from_numpy(raw), n)
