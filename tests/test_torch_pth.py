"""Reference ``.pth`` checkpoints, the weight bridge on the transformer
family, and the parity tool, on the CPU against the JAX package.

``tests/torch_pth_cases.py`` writes a reference-named ``state_dict`` from a
JAX-layout tree (inverting the documented layouts); both packages'
importers must return the same tree from it, and both packages'
``load_model_for_inference`` the same model. Tolerances: trees equal;
forwards rtol 1e-5 / atol 1e-6 (transformer) and 1e-4 / 1e-5 (lstm, a
recurrence summed in another order: tests/test_torch_model.py's); the
parity tool's metric sums within 1e-4 and mAP within 1e-6
(tests/test_torch_eval.py's).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ExperimentConfig as TorchConfig
from room_slam_torch.config import ModelConfig as TorchModelConfig
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch.models.factory import build_model as build_torch
from room_slam_torch.tools import parity as tparity
from room_slam_torch.train import checkpoint as tckpt
from room_slam_torch.train import torch_import as timport
from room_slam_torch.train.driver import load_model_for_inference
from room_slam_torch.weights import (_flatten, load_params,
                                     params_to_state_dict, random_params,
                                     state_dict_to_params)
from room_slam_tpu.config import ModelConfig
from room_slam_tpu.models.factory import build_model
from room_slam_tpu.tools import parity as jparity
from room_slam_tpu.train import torch_import as jimport
from room_slam_tpu.train.driver import \
    load_model_for_inference as jax_load_model
from torch_pth_cases import reference_state_dict, write_reference_pth

D, Q = 32, 6
TOL = {"transformer": (1e-5, 1e-6), "lstm": (1e-4, 1e-5)}


def reference_tree(model_type, seed, **kw):
    """Seeded weights of the reference architecture at the loader's
    defaults (the default config's layers, heads and FFN) in the JAX
    layout."""
    cfg = TorchModelConfig(model_type=model_type, d_model=D, num_queries=Q,
                           **kw)
    return random_params(build_torch(cfg), seed)


@pytest.fixture(scope="module", params=["lstm", "transformer"])
def pth(request, tmp_path_factory):
    """A reference ``.pth`` of each model type at d_model 32, 6 queries."""
    path = tmp_path_factory.mktemp("pth") / f"{request.param}.pth"
    params = reference_tree(request.param, 1)
    write_reference_pth(path, params, {"model_type": request.param,
                                       "d_model": D, "num_queries": Q})
    return request.param, str(path), params


def flat(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree["params"]).items()}


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb)
    for k, v in fb.items():
        np.testing.assert_array_equal(fa[k], v, err_msg=k)


def test_port_importer_returns_the_jax_importers_tree(pth):
    model_type, path, params = pth
    got, cfg = timport.load_pth_checkpoint(path)
    ref, ref_cfg = jimport.load_pth_checkpoint(path)
    assert cfg == ref_cfg == {"model_type": model_type, "d_model": D,
                              "num_queries": Q}
    assert_trees_equal(got, jax.device_get(ref))
    # the documented layouts invert exactly: the tree written is read back
    assert_trees_equal(got, params)


def test_load_model_for_inference_matches_jax(pth):
    """Both packages' loaders on the same ``.pth``: the same config and
    the same forward on a ragged batch."""
    model_type, path, _ = pth
    model, cfg = load_model_for_inference(path, device="cpu")
    jmodel, jparams, jcfg = jax_load_model(path)
    # every field but the JAX package's Pallas switch (off for a .pth)
    got_m, ref_m = cfg.to_dict()["model"], jcfg.to_dict()["model"]
    assert ref_m.pop("use_pallas_rnn") is False
    got_m.pop("use_pallas_rnn")
    assert got_m == ref_m
    assert (cfg.model.model_type, cfg.model.d_model,
            cfg.model.num_queries) == (model_type, D, Q)
    assert not model.training
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 40, 11)).astype(np.float32)
    x[..., :3] += np.cumsum(rng.normal(size=(3, 40, 3)) * 0.3, axis=1)
    m = np.ones((3, 40), bool)
    m[1, 17:] = False
    x[~m] = 0.0
    ref = jax.jit(lambda p: jmodel.apply(p, jnp.asarray(x), jnp.asarray(m),
                                         deterministic=True))(jparams)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(m))
    rtol, atol = TOL[model_type]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_pth_defaults_and_extra_layers(tmp_path):
    """A ``.pth`` whose config names nothing is a transformer at d_model
    256 with 50 queries; layers past the default counts (here a fourth
    encoder layer) are ignored by both packages' importers, as the JAX
    package's loader does."""
    params = random_params(build_torch(TorchModelConfig(
        model_type="transformer", d_model=256, num_queries=50,
        enc_layers=4)), 3)
    path = tmp_path / "bare.pth"
    torch.save({"model_state_dict": reference_state_dict(
        params, "transformer")}, path)
    assert "encoder.transformer.layers.3.norm2.weight" in torch.load(
        path, weights_only=False)["model_state_dict"]
    model, cfg = load_model_for_inference(str(path), device="cpu")
    assert (cfg.model.model_type, cfg.model.d_model, cfg.model.num_queries,
            cfg.model.enc_layers) == ("transformer", 256, 50, 3)
    got, _ = timport.load_pth_checkpoint(str(path))
    ref, _ = jimport.load_pth_checkpoint(str(path))
    assert_trees_equal(got, jax.device_get(ref))
    assert set(got["params"]["encoder"]) == {"input_proj", "layer_0",
                                             "layer_1", "layer_2"}
    np.testing.assert_array_equal(
        model.state_dict()["encoder.layer_2.norm1.weight"].numpy(),
        params["params"]["encoder"]["layer_2"]["norm1"]["scale"])


def test_unknown_model_type_raises(tmp_path):
    path = tmp_path / "gru.pth"
    torch.save({"model_state_dict": {}, "config": {"model_type": "bigru"}},
               path)
    with pytest.raises(ValueError, match="unsupported model_type"):
        load_model_for_inference(str(path), device="cpu")


def test_lstm_biases_merge(tmp_path):
    """The reference LSTM's two biases are summed into the one bias."""
    params = reference_tree("lstm", 4)
    sd = {k: v.numpy() for k, v in reference_state_dict(params,
                                                        "lstm").items()}
    rng = np.random.default_rng(4)
    extra = rng.normal(size=sd["encoder.lstm.bias_hh_l1_reverse"].shape)
    sd["encoder.lstm.bias_ih_l1_reverse"] = (
        sd["encoder.lstm.bias_ih_l1_reverse"] - extra).astype(np.float32)
    sd["encoder.lstm.bias_hh_l1_reverse"] = extra.astype(np.float32)
    got = timport.import_state_dict(sd, "lstm")
    ref = jimport.import_state_dict(sd, "lstm")
    assert_trees_equal(got, ref)
    np.testing.assert_allclose(got["params"]["encoder"]["lstm_1"]["b_bwd"],
                               params["params"]["encoder"]["lstm_1"]["b_bwd"],
                               atol=1e-6)


MODELS = {
    "transformer": dict(model_type="transformer", d_model=D, nhead=2,
                        enc_layers=2, dec_layers=1, dim_feedforward=64,
                        num_queries=Q, objectness=True, refine_stages=1),
    "moe": dict(model_type="transformer", d_model=D, nhead=2, enc_layers=2,
                dec_layers=1, dim_feedforward=64, num_queries=Q,
                moe_experts=3),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_round_trip_of_jax_trees(name):
    """The JAX package's own init of the transformer and the MoE model
    goes through ``params_to_state_dict`` / ``state_dict_to_params``
    unchanged; layer norms' ``scale`` is their ``weight``, not
    transposed."""
    jmodel = build_model(ModelConfig(**MODELS[name], use_pallas_rnn=False))
    x = jnp.zeros((2, 16, 11), jnp.float32)
    params = jax.device_get(jax.jit(lambda k: {"params": jmodel.init(
        k, x, jnp.ones((2, 16), bool))["params"]})(jax.random.key(5)))
    model = build_torch(TorchModelConfig(**MODELS[name]))
    sd = params_to_state_dict(params, model)
    assert_trees_equal(state_dict_to_params(sd, model), params)
    np.testing.assert_array_equal(
        sd["encoder.layer_1.norm2.weight"].numpy(),
        params["params"]["encoder"]["layer_1"]["norm2"]["scale"])


@pytest.mark.parametrize("edit", ["unknown", "scale_on_dense",
                                  "kernel_on_norm", "no_model"])
def test_bridge_stays_strict(edit):
    model = build_torch(TorchModelConfig(**MODELS["moe"]))
    params = random_params(model, 6)
    layer = params["params"]["encoder"]["layer_0"]
    if edit == "no_model":
        with pytest.raises(ValueError, match="dense weight must be 2-D"):
            state_dict_to_params(model.state_dict())
        return
    if edit == "unknown":
        layer["norm1"]["offset"] = np.zeros(D, np.float32)
    elif edit == "scale_on_dense":
        layer["moe"]["gate"]["scale"] = layer["moe"]["gate"].pop("kernel")
    else:
        layer["norm2"]["kernel"] = layer["norm2"].pop("scale")
    with pytest.raises(KeyError, match="no counterpart"):
        params_to_state_dict(params, model)


def test_random_params_rules():
    """Layer norms away from the identity (scale 1 +- 0.1, bias +- 0.1),
    the experts within U(+-1/sqrt(D)) and U(+-1/sqrt(F)); seeded."""
    model = build_torch(TorchModelConfig(**MODELS["moe"]))
    a, b = random_params(model, 7), random_params(model, 7)
    assert_trees_equal(a, b)
    layer = a["params"]["encoder"]["layer_1"]
    scale, bias = layer["norm1"]["scale"], layer["norm1"]["bias"]
    assert np.all(np.abs(scale - 1.0) <= 0.1) and np.any(scale != 1.0)
    assert np.all(np.abs(bias) <= 0.1) and np.any(bias != 0.0)
    for name, fan in (("w1", D), ("b1", D), ("w2", 64), ("b2", 64)):
        w = layer["moe"][name]
        assert np.abs(w).max() <= 1 / np.sqrt(fan), name
        assert np.abs(w).max() > 0.5 / np.sqrt(fan), name


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Four seeded rooms, a reference lstm ``.pth`` and a port transformer
    checkpoint at max_trace_len 96."""
    d = tmp_path_factory.mktemp("parity")
    write_rooms(d / "rooms", 4, seed=8, points=(150, 250))
    pth = d / "ref_lstm.pth"
    write_reference_pth(pth, reference_tree("lstm", 9),
                        {"model_type": "lstm", "d_model": D,
                         "num_queries": Q})
    cfg = TorchConfig()
    cfg.model = TorchModelConfig(**MODELS["transformer"])
    cfg.data.max_trace_len = 96
    model = build_torch(cfg.model)
    load_params(model, random_params(model, 10))
    tckpt.save_checkpoint(d / "ours", model.state_dict(), config=cfg,
                          model=model)
    return d, {"ours": str(d / "ours"), "reference": str(pth)}


@pytest.mark.parametrize("name", ["ours", "reference"])
@pytest.mark.parametrize("passes", [
    {}, dict(refine_clearance=0.3, extent_slack=1.0, consensus=True)])
def test_parity_score_matches_jax(scored, name, passes):
    d, ckpts = scored
    kw = dict(batch_size=3, threshold=0.0, nms=0.3, **passes)
    got = tparity.score_checkpoint(ckpts[name], str(d / "rooms"),
                                   device="cpu", **kw)
    ref = jparity.score_checkpoint(ckpts[name], str(d / "rooms"), **kw)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k == "AP_per_class":
            assert set(got[k]) == set(v)
            for c, ap in v.items():
                assert abs(got[k][c] - ap) <= 1e-4, (k, c)
        elif k == "mAP":
            assert abs(got[k] - v) <= 1e-6, k
        else:
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
    assert got["num_predictions"] > 0


def test_parity_cli(scored, tmp_path, capsys):
    d, ckpts = scored
    out = tmp_path / "parity.json"
    tparity.main(["--checkpoints", f"ours={ckpts['ours']}",
                  f"again={ckpts['ours']}", "--data_dir", str(d / "rooms"),
                  "--threshold", "0.0", "--output", str(out),
                  "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "mAP delta (ours - again): +0.0000 (within" in printed
    res = json.loads(out.read_text())
    assert res["ours"] == res["again"]
    assert set(res["ours"]) >= {"mIoU", "precision", "recall", "f1", "mAP",
                                "num_predictions"}
