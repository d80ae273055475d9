"""Resuming a run on the CPU: checkpoints with the optimizer state in
optax's layout go both ways between the JAX package and the port, one
AdamW update after loading equals optax's, a resumed ``train_benchmark``
starts at the saved epoch + 1 with the scheduler restored, a CUDA runtime
error is recovered from (and raised again after ``max_recoveries``), and
the training CLI's model flags and ``--resume``.

Tolerance: updated parameters rtol 1e-6 plus ``2e-5 * lr``. optax and
``torch.optim.AdamW`` take the same float32 steps in another order of
operations, and optax forms Adam's bias correction ``1 - 0.999**t`` in
float32, where the subtraction cancels three digits at a small count (t=3:
a relative error near 1e-5 of the step, against torch's float64).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import serialization
import torch

from room_slam_torch.config import ExperimentConfig as TorchConfig
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch.models.factory import build_model as torch_build
from room_slam_torch.train import checkpoint as tckpt
from room_slam_torch.train import driver as tdriver
from room_slam_torch.train import loop as tloop
from room_slam_torch.train.__main__ import main as train_cli
from room_slam_torch.weights import (_flatten, load_params,
                                     params_to_state_dict)
from room_slam_tpu.config import (DataConfig, ExperimentConfig, ModelConfig,
                                  TrainConfig)
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.train import checkpoint as jckpt
from room_slam_tpu.train import loop as jloop

L = 32


def _config(ema: float):
    return ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=16),
        model=ModelConfig(model_type="lstm", d_model=16, num_queries=8,
                          lstm_layers=1, dropout=0.0, use_pallas_rnn=False,
                          refine_stages=1),
        train=TrainConfig(batch_size=4, lr=3e-3, ema_decay=ema))


def _params(cfg):
    return jax.device_get(init_params(build_model(cfg.model), cfg.model,
                                      seed=0, seq_len=L))


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(0.3 * rng.standard_normal(np.shape(a)),
                             np.float32), params)


def _jax_updates(cfg, params, n):
    """optax's state after ``n`` updates on seeded gradients, with the
    parameters they reach."""
    tx = jloop.make_optimizer(cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    for i in range(n):
        upd, state = tx.update(_grads(params, i), state, p)
        p = optax.apply_updates(p, upd)
    return tx, jax.device_get(p), state


def _leaves(tree):
    """The leaves of an optimizer state by their path in the layout flax
    serializes (``to_state_dict``: tuple slots "0", "1", ...)."""
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                serialization.to_state_dict(tree))[0]}


def _port(cfg, params):
    tcfg = TorchConfig.from_dict(cfg.to_dict())
    model = load_params(torch_build(tcfg.model), params)
    return model, tloop.make_optimizer(model, tcfg)


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_jax_checkpoint_with_optimizer_state_loads_into_port(tmp_path, ema):
    cfg = _config(ema)
    tx, p, state = _jax_updates(cfg, _params(cfg), 2)
    jckpt.save_checkpoint(tmp_path / "ck", p, state, epoch=4)
    params, opt_state, side = tckpt.load_checkpoint(tmp_path / "ck",
                                                    with_opt_state=True)
    assert side["has_opt_state"] and side["epoch"] == 4
    model, opt = _port(cfg, params)
    opt.load_state_dict(opt_state)
    assert opt.count == 2 and opt.lr == pytest.approx(3e-3)
    # the port writes back exactly what it read
    got, want = _leaves(opt.state_dict()), _leaves(state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_port_checkpoint_restores_into_jax_templates(tmp_path, ema):
    cfg = _config(ema)
    tx, p, state = _jax_updates(cfg, _params(cfg), 3)
    model, opt = _port(cfg, p)
    opt.load_state_dict(serialization.to_state_dict(jax.device_get(state)))
    opt.set_learning_rate(1e-3)
    tckpt.save_checkpoint(tmp_path / "port", model.state_dict(),
                          opt.state_dict(), epoch=7, val_loss=0.5,
                          extra={"sched": {"lr": 1e-3}})
    params0 = _params(cfg)
    rp, rs, side = jckpt.load_checkpoint(tmp_path / "port", params0,
                                         tx.init(params0))
    assert side["has_opt_state"] and side["epoch"] == 7
    assert jloop.get_learning_rate(rs) == pytest.approx(1e-3)
    want = _leaves(state)
    want["hyperparams/learning_rate"] = np.float32(1e-3)
    got = _leaves(rs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0,
                                   err_msg=k)
    for k, v in _flatten(p["params"]).items():
        np.testing.assert_array_equal(
            np.asarray(_flatten(rp["params"])[k]), v, err_msg=k)


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_update_after_loading_matches_optax(tmp_path, ema):
    cfg = _config(ema)
    tx, p, state = _jax_updates(cfg, _params(cfg), 2)
    jckpt.save_checkpoint(tmp_path / "ck", p, state, epoch=1)
    params, opt_state, _ = tckpt.load_checkpoint(tmp_path / "ck",
                                                 with_opt_state=True)
    model, opt = _port(cfg, params)
    opt.load_state_dict(opt_state)
    g = _grads(p, 7)
    upd, new_state = tx.update(g, state, jax.tree_util.tree_map(
        jnp.asarray, p))
    new_p = jax.device_get(optax.apply_updates(p, upd))
    tg = params_to_state_dict(g, model)
    for n, prm in model.named_parameters():
        prm.grad = tg[n].clone()
    opt.step()
    want = params_to_state_dict(new_p, model)
    atol = 2e-5 * cfg.train.lr
    for n, prm in model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=atol, err_msg=n)
    assert opt.count == 3
    if ema:
        want_ema = params_to_state_dict(
            jax.device_get(jloop.eval_params(jloop.TrainState(
                new_p, new_state, 0))), model)
        for n, v in opt.ema.items():
            np.testing.assert_allclose(v.numpy(), want_ema[n].numpy(),
                                       rtol=1e-6, atol=atol, err_msg=n)


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    d = tmp_path_factory.mktemp("rooms")
    write_rooms(d / "train", 4, seed=0, points=(100, 160))
    write_rooms(d / "val", 2, seed=1, points=(100, 160))
    return d


def _bench(rooms, tmp_path, epochs):
    cfg = TorchConfig.from_dict(_config(0.0).to_dict())
    cfg.data.data_dir = str(rooms / "train")
    cfg.data.val_dir = str(rooms / "val")
    cfg.train.num_epochs = epochs
    cfg.train.save_dir = str(tmp_path)
    cfg.train.plateau_patience = 0
    return cfg


def test_resumed_run_starts_after_saved_epoch(rooms, tmp_path):
    cfg = _bench(rooms, tmp_path, 2)
    first = tdriver.train_benchmark(cfg, device="cpu", verbose=False,
                                    checkpoint_every=2)
    ck = tmp_path / "checkpoint_epoch_1"
    side = json.loads(ck.with_suffix(".json").read_text())
    assert side["has_opt_state"] and side["epoch"] == 1
    cfg.train.num_epochs = 3
    res = tdriver.train_benchmark(cfg, device="cpu", verbose=False,
                                  resume=str(ck))
    assert res["start_epoch"] == 2 and res["recoveries"] == 0
    assert [h["epoch"] for h in res["history"]] == [2]
    # the plateau scheduler continued from the saved state: one more step
    sched = tloop.PlateauScheduler(
        lr=cfg.train.lr, factor=cfg.train.plateau_factor,
        patience=cfg.train.plateau_patience,
        cooldown=cfg.train.plateau_cooldown,
        min_lr=cfg.train.lr * cfg.train.plateau_min_scale)
    sched.load_state_dict(side["sched"])
    assert res["lr"] == pytest.approx(
        sched.step(res["history"][0]["val_loss"]))
    assert res["count"] == first["count"] + first["count"] // 2
    # a periodic checkpoint's NaN val_loss is not taken as best_val
    assert np.isfinite(res["best_val_loss"])


def test_recovers_from_accelerator_error(rooms, tmp_path, monkeypatch,
                                         capsys):
    cfg = _bench(rooms, tmp_path, 2)
    make = tdriver.make_train_step
    calls = {"n": 0}

    def flaky(*a, **k):
        step = make(*a, **k)

        def run(batch, gen):
            calls["n"] += 1
            if calls["n"] == 2:
                raise torch.AcceleratorError("CUDA error: device lost")
            return step(batch, gen)
        return run

    monkeypatch.setattr(tdriver, "make_train_step", flaky)
    res = tdriver.train_benchmark(cfg, device="cpu", verbose=False)
    assert res["recoveries"] == 1
    assert [h["epoch"] for h in res["history"]] == [0, 1]
    assert "recovery 1/3 from initial state" in capsys.readouterr().out

    def broken(*a, **k):
        def run(batch, gen):
            raise torch.AcceleratorError("CUDA error: device lost")
        return run

    monkeypatch.setattr(tdriver, "make_train_step", broken)
    with pytest.raises(torch.AcceleratorError):
        tdriver.train_benchmark(cfg, device="cpu", verbose=False,
                                max_recoveries=2)
    assert "recovery 2/2" in capsys.readouterr().out

    def other(*a, **k):
        def run(batch, gen):
            raise RuntimeError("not a device error")
        return run

    monkeypatch.setattr(tdriver, "make_train_step", other)
    with pytest.raises(RuntimeError, match="not a device"):
        tdriver.train_benchmark(cfg, device="cpu", verbose=False)


def test_cli_model_flags_and_resume(rooms, tmp_path, capsys):
    args = ["--data_dir", str(rooms / "train"), "--val_dir",
            str(rooms / "val"), "--model", "bigru", "--d_model", "32",
            "--num_queries", "6", "--schedule", "cosine",
            "--max_trace_len", "24", "--batch_size", "4",
            "--save_dir", str(tmp_path), "--device", "cpu"]
    # the per-epoch driver (the CLI's default is the fused run, whose best
    # model carries no optimizer state to resume from)
    train_cli(args + ["--epochs", "1", "--no_fused"])
    saved = json.loads((tmp_path / "config.json").read_text())
    assert saved["model"]["model_type"] == "bigru"
    assert saved["model"]["d_model"] == 32
    assert saved["model"]["num_queries"] == 6
    assert saved["train"]["lr_schedule"] == "cosine"
    capsys.readouterr()
    train_cli(args + ["--epochs", "2", "--resume",
                      str(tmp_path / "best_model")])
    out = capsys.readouterr().out
    assert "Resumed from" in out and "at epoch 1" in out
    summary = json.loads(out[out.rindex("\n{") + 1:])
    assert summary["start_epoch"] == 1 and summary["recoveries"] == 0
    assert summary["count"] == 2 * summary["samples_seen"] // 4
