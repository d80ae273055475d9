"""The port's TraceToColliderLSTM against the JAX model on the same weights
and inputs, at small width.

JAX's init leaves the refinement deltas at zero (every refine stage is the
identity), which would hide bugs in the stages, so seeded noise is added to
every leaf before both models get the tree. Tolerance rtol 1e-4 / atol 1e-5:
both sides compute in f32 with different summation orders through two
recurrent layers, attention and two refine stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ModelConfig as TorchModelConfig
from room_slam_torch.models.factory import build_model as build_torch
from room_slam_torch.models.common import center_traces_xz
from room_slam_torch.ops.refine import hole_components
from room_slam_torch.train.driver import load_model_for_inference
from room_slam_torch.weights import load_params, state_dict_to_params
from room_slam_tpu.config import ExperimentConfig, ModelConfig
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.train.checkpoint import save_checkpoint

RTOL, ATOL = 1e-4, 1e-5
B, N, SHORT = 2, 40, 17


def noisy_params(params, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)


def model_inputs(seed=0):
    rng = np.random.default_rng(seed)
    traces = rng.normal(size=(B, N, 11)).astype(np.float32)
    traces[..., :3] += np.cumsum(rng.normal(size=(B, N, 3)) * 0.3, axis=1
                                 ).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, SHORT:] = False
    traces[~mask] = 0.0
    return traces, mask


def small_cfg(**kw):
    base = dict(model_type="lstm", d_model=32, num_queries=6, lstm_layers=2,
                dropout=0.0, objectness=True, center_xz=True,
                refine_stages=2, use_pallas_rnn=False)
    base.update(kw)
    return ModelConfig(**base), TorchModelConfig(**base)


@pytest.mark.parametrize("extent_features", [False, True])
def test_model_output_dict_matches_jax(extent_features):
    jcfg, tcfg = small_cfg(extent_features=extent_features)
    jmodel = build_model(jcfg)
    params = noisy_params(init_params(jmodel, jcfg, seq_len=N))
    traces, mask = model_inputs()
    ref = jmodel.apply(params, jnp.asarray(traces), jnp.asarray(mask),
                      deterministic=True)

    model = load_params(build_torch(tcfg), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(traces), torch.from_numpy(mask))
    assert set(got) == set(ref) == {"pred_boxes", "pred_classes",
                                    "pred_objectness", "pred_aux_boxes"}
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_model_without_mask_or_extras_matches_jax():
    """Reference decoder (no objectness, no centering, no refine) and a
    mask-less call."""
    jcfg, tcfg = small_cfg(objectness=False, center_xz=False,
                           refine_stages=0, lstm_layers=1)
    jmodel = build_model(jcfg)
    params = noisy_params(init_params(jmodel, jcfg, seq_len=N), seed=3)
    traces, _ = model_inputs(seed=3)
    ref = jmodel.apply(params, jnp.asarray(traces), deterministic=True)
    model = load_params(build_torch(tcfg), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(traces))
    assert set(got) == set(ref) == {"pred_boxes", "pred_classes"}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kw,match", [
    (dict(model_type="rnn"), "Unknown model_type: rnn"),
])
def test_unported_options_raise(kw, match):
    """Every model type of the JAX package is ported; a type neither
    package knows raises, naming the four."""
    _, tcfg = small_cfg(**kw)
    with pytest.raises(ValueError, match=match):
        build_torch(tcfg)


def _ring_inputs(seed=0, N=300):
    """Walks around a room whose middle is never visited (interior holes
    for the hole tokens); row 1 is ragged."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 20 * np.pi, N)
    r = 2.0 + 0.5 * np.sin(3 * t)
    traces = rng.normal(size=(B, N, 11)).astype(np.float32) * 0.1
    traces[..., 0] = r * np.cos(t) + rng.normal(size=(B, 1)) * 0.3
    traces[..., 1] = 1.5
    traces[..., 2] = r * np.sin(t)
    mask = np.ones((B, N), bool)
    mask[1, 2 * N // 3:] = False
    traces[~mask] = 0.0
    return traces, mask


def test_hole_tokens_model_matches_jax(tmp_path):
    """``hole_tokens=4`` through the weight bridge (``hole_embed`` and the
    ``hole_proj`` MLP) and through a msgpack checkpoint: the outputs, and
    the hole slots are live."""
    jcfg, tcfg = small_cfg(hole_tokens=4)
    jmodel = build_model(jcfg)
    traces, mask = _ring_inputs()
    params = noisy_params(init_params(jmodel, jcfg, seq_len=traces.shape[1]),
                          seed=5)
    assert {"hole_embed", "hole_proj"} <= set(params["params"])
    ref = jmodel.apply(params, jnp.asarray(traces), jnp.asarray(mask),
                      deterministic=True)
    model = load_params(build_torch(tcfg), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(traces), torch.from_numpy(mask))
        coords = center_traces_xz(torch.from_numpy(traces),
                                  torch.from_numpy(mask))[0]
        holes = hole_components(coords[..., 0], coords[..., 2],
                                torch.from_numpy(mask), 4)
    assert (holes["area_m2"] > 0.02).any(dim=1).all()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # a JAX checkpoint of the model loads with its hole parameters
    jax_cfg = ExperimentConfig()
    jax_cfg.model = jcfg
    save_checkpoint(tmp_path / "holes", params, config=jax_cfg)
    loaded, cfg = load_model_for_inference(str(tmp_path / "holes"),
                                           device="cpu")
    assert cfg.model.hole_tokens == 4
    with torch.no_grad():
        again = loaded(torch.from_numpy(traces), torch.from_numpy(mask))
    for k in got:
        torch.testing.assert_close(again[k], got[k], rtol=0, atol=0)
    # the weight bridge round-trips the hole parameters
    back = state_dict_to_params(model.state_dict())["params"]
    np.testing.assert_array_equal(back["hole_embed"],
                                  params["params"]["hole_embed"])
    np.testing.assert_array_equal(
        back["hole_proj"]["layer_1"]["kernel"],
        params["params"]["hole_proj"]["layer_1"]["kernel"])


def test_seeded_init_follows_jax_init_rules():
    """A fresh port model draws from the JAX package's init distributions:
    the same generator seed gives the same weights; the deterministic
    leaves (zero refinement deltas, inv_temp 1, radius slack log 0.3)
    equal JAX init_params'; dense and LSTM leaves stay inside
    U(+-1/sqrt(fan_in))."""
    jcfg, tcfg = small_cfg()
    ref = jax.tree_util.tree_map(
        np.asarray, init_params(build_model(jcfg), jcfg, seq_len=8))
    a, b = (build_torch(tcfg, torch.Generator().manual_seed(5))
            for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    got = state_dict_to_params(a.state_dict())

    def walk(g, r, path=""):
        for k in r:
            if isinstance(r[k], dict):
                walk(g[k], r[k], f"{path}{k}.")
                continue
            name = f"{path}{k}"
            assert g[k].shape == r[k].shape, name
            if np.ptp(r[k]) == 0 and (r[k].size > 1 or k in (
                    "inv_temp", "log_radius_slack")):   # constant init
                np.testing.assert_allclose(g[k], r[k], rtol=1e-7,
                                           err_msg=name)
            elif k != "query_embed":
                fan_in = (r["kernel"] if "kernel" in r
                          else r["w_hh_fwd"]).shape[0]
                bound = 1.0 / np.sqrt(fan_in)
                assert 0 < np.abs(g[k]).max() <= bound, name
                if g[k].size >= 32:
                    assert np.abs(g[k]).max() > 0.5 * bound, name

    walk(got["params"], ref["params"])
