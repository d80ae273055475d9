"""The port's switch-MoE FFN and its load-balance term against the JAX
package's ``MoEFFN`` and train step (d_model 32, FFN 64, 4 experts); the
training CLI on a MoE transformer, and in-run validation at the run's
``train.matmul_precision``.

Values rtol 1e-5 / atol 1e-6 (float32); the train step's ``moe_aux`` rel
1e-5, its other losses rel 1e-4 (test_torch_train.py's bound), dropout
off. ``total_loss`` at two ``moe_aux_weight``s differs by ``dw * moe_aux``
up to the float32 rounding of the sums (four ulps of the total).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ExperimentConfig as TorchConfig
from room_slam_torch.models.common import MoEFFN
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch.models.factory import build_model as build_torch
from room_slam_torch.models.transformer import TraceToColliderTransformer
from room_slam_torch.train import driver as driver_mod
from room_slam_torch.train import loop as tloop
from room_slam_torch.train.__main__ import main as train_cli
from room_slam_torch.train.driver import (load_model_for_inference,
                                          train_benchmark)
from room_slam_torch.weights import (_flatten, load_params, random_params,
                                     state_dict_to_params)
from room_slam_tpu.config import (DataConfig, ExperimentConfig, ModelConfig,
                                  TrainConfig)
from room_slam_tpu.data import synthetic
from room_slam_tpu.models import common as jcommon
from room_slam_tpu.models.factory import build_model
from room_slam_tpu.train import loop as jloop
from room_slam_tpu.train.driver import \
    load_model_for_inference as jax_load_model

RTOL, ATOL = 1e-5, 1e-6
D, FF, E = 32, 64, 4
L, B = 64, 4


def tokens(seed=0, N=16):
    """``[2, N, D]`` tokens and a ragged mask (9 and 13 valid)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, N, D)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.array([[9], [13]])
    return x, mask


def pair(num_experts, seed=0):
    """The port's MoEFFN with seeded weights and the same JAX tree."""
    m = MoEFFN(D, FF, num_experts)
    params = random_params(m, seed)
    load_params(m, params)
    return m.eval(), params


def jax_moe(params, x, mask=None, num_experts=E):
    """JAX MoEFFN output and its sowed load-balance term."""
    out, sown = jax.jit(lambda p, x, k: jcommon.MoEFFN(D, FF, num_experts)
                        .apply(p, x, mask=k, mutable=["losses"]))(
        params, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    return np.asarray(out), float(sown["losses"]["moe_aux"][0])


def test_one_expert_equals_the_plain_ffn():
    """One expert: the router's softmax over one logit is 1, so the output
    is the expert's plain ReLU FFN (the JAX suite's test_moe_ffn)."""
    x, _ = tokens(1)
    m, params = pair(1, seed=1)
    w = params["params"]
    plain = (np.maximum(x @ w["w1"][0] + w["b1"][0], 0.0) @ w["w2"][0]
             + w["b2"][0])
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5)
    np.testing.assert_allclose(got, jax_moe(params, x, num_experts=1)[0],
                               rtol=RTOL, atol=ATOL)
    assert float(m.aux) == 1.0


@pytest.mark.parametrize("masked", [True, False])
def test_output_and_aux_match_jax(masked):
    x, mask = tokens(2)
    m, params = pair(E, seed=2)
    ref, ref_aux = jax_moe(params, x, mask if masked else None)
    with torch.no_grad():
        got = m(torch.from_numpy(x),
                torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m.aux), ref_aux, rtol=RTOL)


def test_masked_stats_ignore_padding():
    """The JAX suite's test_moe_ffn_masked_stats on the port: the content
    of padded rows does not move the masked aux term, which differs from
    the unmasked one when the padding is extreme."""
    x, mask = tokens(3)
    m, params = pair(E, seed=3)
    tm = torch.from_numpy(mask)

    def aux(fill, k=tm):
        xf = np.where(mask[..., None], x, np.float32(fill))
        with torch.no_grad():
            m(torch.from_numpy(xf), k)
        return float(m.aux)

    a1, a2 = aux(0.0), aux(37.0)
    np.testing.assert_allclose(a1, a2, rtol=1e-6)
    assert a1 > 0.0
    assert abs(aux(37.0, None) - a1) > 1e-6
    xf = np.where(mask[..., None], x, np.float32(37.0))
    np.testing.assert_allclose(a1, jax_moe(params, xf, mask)[1], rtol=RTOL)


def test_router_tie_goes_to_the_first_expert():
    """A zero gate gives every expert the same probability: argmax picks
    expert 0 for every token, the output is its FFN scaled by 1/E and the
    load-balance term is E * (1 * 1/E) = 1, as in JAX."""
    x, mask = tokens(4)
    m, params = pair(E, seed=4)
    gate = params["params"]["gate"]
    gate["kernel"][...] = 0.0
    gate["bias"][...] = 0.0
    load_params(m, params)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    w = params["params"]
    first = (np.maximum(x @ w["w1"][0] + w["b1"][0], 0.0) @ w["w2"][0]
             + w["b2"][0]) / E
    np.testing.assert_allclose(got, first, rtol=RTOL, atol=ATOL)
    assert float(m.aux) == 1.0
    ref, ref_aux = jax_moe(params, x, mask)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert ref_aux == 1.0


def test_gradients_reach_the_router_as_in_jax():
    """Gradients of ``<out, W> + aux`` over every leaf (the gate through
    the winning probability and the aux term): max-rel 1e-4."""
    x, mask = tokens(5)
    m, params = pair(E, seed=5)
    W = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def loss(p):
        out, sown = jcommon.MoEFFN(D, FF, E).apply(
            p, jnp.asarray(x), mask=jnp.asarray(mask), mutable=["losses"])
        return jnp.sum(out * W) + sown["losses"]["moe_aux"][0]

    ref = _flatten(jax.device_get(jax.jit(jax.grad(loss))(params))["params"])
    out = m.train()(torch.from_numpy(x), torch.from_numpy(mask))
    ((out * torch.from_numpy(W)).sum() + m.aux).backward()
    got = _flatten(state_dict_to_params(
        {n: p.grad for n, p in m.named_parameters()}, m)["params"])
    assert set(got) == set(ref)
    for k, v in ref.items():
        err = np.abs(got[k] - v).max()
        assert err <= 1e-4 * np.abs(v).max(), (k, err)


def _config(**train):
    return ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=16, noise_prob=0.0,
                        crop_prob=0.0, time_warp_prob=0.0,
                        augment_collider_dropout=False,
                        augment_translation=False, augment_scale=False),
        model=ModelConfig(model_type="transformer", d_model=D, nhead=2,
                          enc_layers=2, dec_layers=1, num_queries=12,
                          dim_feedforward=FF, dropout=0.0,
                          use_pallas_rnn=False, moe_experts=E),
        train=TrainConfig(batch_size=B, lr=3e-3, **train))


@pytest.fixture(scope="module")
def step_case():
    """Seeded weights and one batch of the JAX generator's rooms."""
    cfg = _config()
    params = random_params(build_torch(TorchConfig.from_dict(
        cfg.to_dict()).model), 6)
    data = synthetic.generate_rooms_and_traces(
        jax.random.key(0), n_rooms=B, num_steps=L, max_colliders=16)
    batch = {k: np.array(data[k])
             for k in ("raw", "length", "boxes", "labels", "valid")}
    batch["rotation_k"] = np.zeros(B, np.int32)
    batch["weight"] = np.ones(B, np.float32)
    return params, batch


def _jax_losses(cfg, params, batch):
    model = build_model(cfg.model)
    tx = jloop.make_optimizer(cfg)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = jloop.TrainState(p, tx.init(p), jnp.asarray(0))
    step = jloop.make_train_step(model, tx, cfg, augment=False)
    _, losses = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.key(0))
    return {k: float(v) for k, v in losses.items()}


def _torch_losses(cfg, params, batch):
    tcfg = TorchConfig.from_dict(cfg.to_dict())
    model = load_params(build_torch(tcfg.model), params)
    opt = tloop.make_optimizer(model, tcfg)
    step = tloop.make_train_step(model, opt, tcfg, augment=False)
    losses = step({k: torch.from_numpy(v) for k, v in batch.items()},
                  torch.Generator().manual_seed(0))
    return {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_moe_aux_matches_jax(step_case, accum):
    """The step's ``moe_aux`` (the mean over layers; under grad_accum the
    mean over microbatches) and every other loss, as JAX's step."""
    params, batch = step_case
    cfg = _config(moe_aux_weight=0.5, grad_accum=accum)
    ref = _jax_losses(cfg, params, batch)
    got = _torch_losses(cfg, params, batch)
    assert set(got) == set(ref) and "moe_aux" in got
    np.testing.assert_allclose(got["moe_aux"], ref["moe_aux"], rtol=1e-5)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


def test_moe_aux_weight_reaches_total_loss(step_case):
    """The JAX suite's test_moe_aux_loss_reaches_total_loss on the port:
    from the same state and batch, two weights differ in total_loss by
    dw * moe_aux; weight 0 surfaces no moe_aux and leaves the rest."""
    params, batch = step_case
    runs = {w: _torch_losses(_config(moe_aux_weight=w), params, batch)
            for w in (0.0, 0.5, 1.0)}
    assert "moe_aux" not in runs[0.0]
    aux = runs[1.0]["moe_aux"]
    assert runs[0.5]["moe_aux"] == aux > 0.0
    ulp = float(np.spacing(np.float32(runs[1.0]["total_loss"])))
    np.testing.assert_allclose(
        runs[1.0]["total_loss"] - runs[0.5]["total_loss"], 0.5 * aux,
        rtol=0, atol=4 * ulp)
    np.testing.assert_allclose(
        runs[1.0]["total_loss"] - runs[0.0]["total_loss"], aux, rtol=0,
        atol=4 * ulp)
    for k, v in runs[0.0].items():
        if k != "total_loss":
            assert runs[1.0][k] == v, k


def test_eval_adds_no_moe_term(step_case):
    """Validation (``make_eval_step``, as JAX's) reports no moe_aux and
    keeps it out of the total."""
    params, batch = step_case
    tcfg = TorchConfig.from_dict(_config(moe_aux_weight=1.0).to_dict())
    model = load_params(build_torch(tcfg.model), params)
    losses, _ = tloop.make_eval_step(model, tcfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert "moe_aux" not in losses


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    d = tmp_path_factory.mktemp("rooms")
    write_rooms(d / "train", 4, seed=0, points=(150, 250))
    write_rooms(d / "val", 2, seed=1, points=(150, 250))
    return d


def test_cli_trains_a_moe_transformer(rooms, tmp_path, capsys):
    """``--model transformer`` with the transformer's fields through
    ``--set`` trains one epoch on the CPU; the best model loads in both
    packages and their forwards agree."""
    save = tmp_path / "ckpt"
    train_cli(["--data_dir", str(rooms / "train"), "--val_dir",
               str(rooms / "val"), "--epochs", "1", "--batch_size", "4",
               "--max_trace_len", "64", "--model", "transformer",
               "--d_model", "32", "--num_queries", "12",
               "--set", "model.moe_experts=2", "--set", "model.nhead=2",
               "--set", "model.enc_layers=1", "--set", "model.dec_layers=1",
               "--set", "model.dim_feedforward=64",
               "--set", "train.moe_aux_weight=0.1",
               "--save_dir", str(save), "--device", "cpu"])
    assert '"best_val_loss"' in capsys.readouterr().out
    model, cfg = load_model_for_inference(str(save / "best_model"), "cpu")
    assert isinstance(model, TraceToColliderTransformer)
    assert (cfg.model.moe_experts, cfg.train.moe_aux_weight) == (2, 0.1)
    assert isinstance(model.encoder.layer_0.moe, MoEFFN)
    jmodel, jparams, _ = jax_load_model(str(save / "best_model"))
    x, mask = tokens(7, N=16)
    x = x[..., :11] + 0.0
    ref = jax.jit(lambda p: jmodel.apply(p, jnp.asarray(x), jnp.asarray(mask),
                                         deterministic=True))(jparams)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_validation_runs_at_the_run_matmul_precision(rooms, tmp_path,
                                                     monkeypatch):
    """Every in-run validation epoch runs inside ``matmul_precision`` at
    ``train.matmul_precision``, as the reference's run-wide setting covers
    it; on the CPU the flags do not change."""
    levels, inside, seen = [], [], []
    real = driver_mod.matmul_precision

    @contextlib.contextmanager
    def recording(level, device):
        levels.append((level, torch.device(device).type))
        inside.append(True)
        try:
            with real(level, device):
                yield
        finally:
            inside.pop()

    real_epoch = driver_mod.make_eval_epoch

    def make_eval_epoch(cfg, iou_thresh=0.5):
        epoch = real_epoch(cfg, iou_thresh)

        def run(*args):
            seen.append(bool(inside))
            return epoch(*args)

        return run

    monkeypatch.setattr(driver_mod, "matmul_precision", recording)
    monkeypatch.setattr(driver_mod, "make_eval_epoch", make_eval_epoch)
    tcfg = TorchConfig.from_dict(_config(matmul_precision="bfloat16",
                                         num_epochs=2).to_dict())
    tcfg.data.data_dir = str(rooms / "train")
    tcfg.data.val_dir = str(rooms / "val")
    tcfg.train.save_dir = str(tmp_path / "ckpt")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    res = train_benchmark(tcfg, device="cpu", verbose=False)
    assert len(res["history"]) == 2
    assert seen == [True, True]
    assert levels == [("bfloat16", "cpu")] * 2
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags


def test_ema_model_after_a_moe_step(step_case):
    """With ``train.ema_decay`` the validation model is a copy of the
    trained one: a step leaves no load-balance term with autograd history
    on the experts (a tensor that cannot be copied), and the copy holds
    the average."""
    params, batch = step_case
    tcfg = TorchConfig.from_dict(_config(moe_aux_weight=0.5,
                                         ema_decay=0.9).to_dict())
    model = load_params(build_torch(tcfg.model), params)
    opt = tloop.make_optimizer(model, tcfg)
    step = tloop.make_train_step(model, opt, tcfg, augment=False)
    losses = step({k: torch.from_numpy(v) for k, v in batch.items()},
                  torch.Generator().manual_seed(0))
    assert float(losses["moe_aux"]) > 0.0
    assert all(m.aux is None for m in model.modules()
               if isinstance(m, MoEFFN))
    ema = tloop.eval_model(model, opt)
    assert ema is not model
    for n, p in ema.named_parameters():
        assert torch.equal(p, opt.ema[n]), n
