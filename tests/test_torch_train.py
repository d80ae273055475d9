"""The port's training slice on the CPU against the JAX package: the
dataset, one and three train steps (losses, gradients, updated
parameters and their EMA) from identical parameters and batch, gradient
accumulation, the learning-rate schedules, the validation step and epoch
(losses and metric sums), a checkpoint both packages read, overfitting,
``train_benchmark`` and the CLI.

The parameters are the JAX package's init with the attention temperature
``inv_temp`` set to 10. At the init value 1 the attention over a random
encoder is nearly uniform, and the softmax backward then cancels almost
all of its input: float32 gradients of the attention and encoder leaves
sit about 2% from a float64 evaluation in both packages alike. At 10 they
sit within 1e-6 of it.

Tolerances. Losses rtol 1e-4 (float32 through a 64-step recurrence,
summed in another order). Gradients: max abs error within 1e-5 of the
largest gradient (a leaf whose gradient is analytically zero, such as
``k_proj``'s bias under softmax, holds only rounding noise). Updated
parameters atol 1e-6 after one step, 1e-5 after three, on every element
whose gradient exceeds 1e-5 of the largest; on the rest AdamW's steps turn
rounding noise into steps of up to ``lr`` in either direction, so there
they agree within ``2 * lr * steps``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ExperimentConfig as TorchConfig
from room_slam_torch.data.dataset import TraceColliderArrays as TorchArrays
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch.models.factory import build_model as torch_build
from room_slam_torch.ops.losses import set_criterion as torch_criterion
from room_slam_torch.train import checkpoint as torch_ckpt
from room_slam_torch.train import loop as tloop
from room_slam_torch.train.__main__ import main as train_cli
from room_slam_torch.train.driver import (load_model_for_inference,
                                          train_benchmark)
from room_slam_torch.train.metrics import summarize_metrics as \
    torch_summarize
from room_slam_torch.weights import _flatten, load_params, \
    state_dict_to_params
from room_slam_tpu.config import (DataConfig, ExperimentConfig, ModelConfig,
                                  TrainConfig)
from room_slam_tpu.data.dataset import TraceColliderArrays
from room_slam_tpu.data.features import featurize as jax_featurize
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.ops.losses import set_criterion
from room_slam_tpu.train import loop as jloop
from room_slam_tpu.train.metrics import summarize_metrics
from room_slam_tpu.train.driver import \
    load_model_for_inference as jax_load_model

L, M, B = 64, 16, 4
LOSS_RTOL = 1e-4


def _config(**train):
    train.setdefault("ema_decay", 0.9)
    return ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=M),
        model=ModelConfig(model_type="lstm", d_model=32, num_queries=12,
                          lstm_layers=2, dropout=0.0, use_pallas_rnn=False,
                          objectness=True, center_xz=True, refine_stages=1),
        train=TrainConfig(batch_size=B, lr=3e-3, footprint_weight=1.0,
                          objectness_iou=True, size_log_weight=0.5,
                          **train))


def _torch_config(cfg):
    return TorchConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    d = tmp_path_factory.mktemp("rooms")
    write_rooms(d / "train", 6, seed=0, points=(150, 250))
    write_rooms(d / "val", 2, seed=1, points=(150, 250))
    return d


@pytest.fixture(scope="module")
def batch(rooms):
    """One batch of the seeded rooms through both packages' datasets."""
    cfg = _config()
    ds = TraceColliderArrays(rooms / "train", cfg.data, augment=False,
                             verbose=False)
    tds = TorchArrays(rooms / "train", _torch_config(cfg).data,
                      augment=False, verbose=False)
    for k, v in ds.device_arrays().items():
        np.testing.assert_array_equal(tds.device_arrays()[k], v)
    assert tds.max_valid == ds.max_valid <= cfg.model.num_queries
    for k, v in ds.epoch_plan(B, seed=3).items():
        np.testing.assert_array_equal(tds.epoch_plan(B, seed=3)[k], v)
    return ds.gather(np.arange(B))


def _params(cfg, seed=0):
    params = jax.device_get(init_params(build_model(cfg.model), cfg.model,
                                        seed=seed, seq_len=L))
    params["params"]["decoder"]["inv_temp"] = np.float32(10.0)
    return params


def _flat_params(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree["params"]).items()}


def _jax_steps(cfg, params, batch, n):
    model = build_model(cfg.model)
    tx = jloop.make_optimizer(cfg)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = jloop.TrainState(p, tx.init(p), jnp.asarray(0))
    step = jloop.make_train_step(model, tx, cfg, augment=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    states, losses = [], []
    for i in range(n):
        state, ls = step(state, jb, jax.random.key(i))
        states.append(jax.device_get(state.params))
        losses.append({k: float(v) for k, v in ls.items()})
    return states, losses, jax.device_get(jloop.eval_params(state))


def _torch_steps(cfg, params, batch, n):
    tcfg = _torch_config(cfg)
    model = load_params(torch_build(tcfg.model), params)
    opt = tloop.make_optimizer(model, tcfg)
    step = tloop.make_train_step(model, opt, tcfg, augment=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    losses = [{k: float(v) for k, v in step(tb, gen).items()}
              for _ in range(n)]
    return model, opt, losses


def _assert_params_close(got, ref_params, grad_ref, steps, lr, atol):
    got = _flat_params(got)
    ref = _flat_params(ref_params)
    scale = max(np.abs(g).max() for g in grad_ref.values())
    assert set(got) == set(ref)
    for k in ref:
        live = np.abs(grad_ref[k]) > 1e-5 * scale
        diff = np.abs(got[k] - ref[k])
        assert diff[live].max(initial=0.0) <= atol, (k, diff[live].max())
        assert diff.max(initial=0.0) <= 2 * lr * steps + atol, k


def _jax_grads(cfg, params, batch):
    model = build_model(cfg.model)
    lw = jloop._loss_weight_dict(cfg)
    feats, mask = jax_featurize(jnp.asarray(batch["raw"]),
                                jnp.asarray(batch["length"]))
    targets = {"boxes": jnp.asarray(batch["boxes"]),
               "labels": jnp.asarray(batch["labels"]),
               "valid_mask": jnp.asarray(batch["valid"])}

    def loss(p):
        out = model.apply(p, feats, mask, deterministic=True)
        return set_criterion(out, targets, jnp.asarray(batch["weight"]),
                             lw)["total_loss"]

    return _flat_params(jax.device_get(jax.jit(jax.grad(loss))(params)))


@pytest.fixture(scope="module")
def jax_run(batch):
    """Three JAX train steps from ``_params``: per-step params and losses,
    the first step's gradient and the EMA after the third step."""
    cfg = _config()
    params = _params(cfg)
    states, losses, ema = _jax_steps(cfg, params, batch, 3)
    return params, _jax_grads(cfg, params, batch), states, losses, ema


def test_one_step_matches_jax(batch, jax_run):
    cfg = _config()
    params, grad_ref, ref_states, ref_losses, _ = jax_run

    # gradients of one forward/backward, before any update
    tcfg = _torch_config(cfg)
    model = load_params(torch_build(tcfg.model), params)
    feats, mask, targets = tloop.prepare_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg.data)
    torch_criterion(model(feats, mask), targets,
                    torch.from_numpy(batch["weight"]),
                    tloop._loss_weight_dict(tcfg))["total_loss"].backward()
    grads = _flat_params(state_dict_to_params(
        {n: p.grad for n, p in model.named_parameters()}))
    scale = max(np.abs(g).max() for g in grad_ref.values())
    for k, g in grad_ref.items():
        assert np.abs(grads[k] - g).max() <= 1e-5 * scale, k

    model, _, losses = _torch_steps(cfg, params, batch, 1)
    assert set(losses[0]) == set(ref_losses[0])
    for k, v in ref_losses[0].items():
        np.testing.assert_allclose(losses[0][k], v, rtol=LOSS_RTOL, err_msg=k)
    _assert_params_close(state_dict_to_params(model.state_dict()),
                         ref_states[0], grad_ref, 1, cfg.train.lr, 1e-6)


def test_three_steps_match_jax(batch, jax_run):
    """Three steps in a row; the parameter EMA (``train.ema_decay``), which
    validation and the best model use, matches JAX ``eval_params``."""
    cfg = _config()
    params, grad_ref, ref_states, ref_losses, ref_ema = jax_run
    model, opt, losses = _torch_steps(cfg, params, batch, 3)
    for got, ref in zip(losses, ref_losses):
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    _assert_params_close(state_dict_to_params(model.state_dict()),
                         ref_states[2], grad_ref, 3, cfg.train.lr, 1e-5)
    ema = tloop.eval_model(model, opt)
    assert ema is not model
    _assert_params_close(state_dict_to_params(ema.state_dict()), ref_ema,
                         grad_ref, 3, cfg.train.lr, 1e-5)


def test_grad_accum_matches_single_step(batch):
    """grad_accum=2 on a batch of two identical halves gives the full
    batch's losses and accumulated (clipped) gradient."""
    half = {k: v[:2] for k, v in batch.items()}
    dup = {k: np.concatenate([v, v]) for k, v in half.items()}
    params = _params(_config())
    runs = {}
    for accum in (1, 2):
        model, opt, losses = _torch_steps(_config(grad_accum=accum), params,
                                          dup, 1)
        runs[accum] = ({n: p.grad.clone() for n, p in opt.named}, losses[0])
    for k, v in runs[1][1].items():
        np.testing.assert_allclose(runs[2][1][k], v, rtol=1e-5, err_msg=k)
    scale = max(g.abs().max().item() for g in runs[1][0].values())
    for n, g in runs[1][0].items():
        assert (runs[2][0][n] - g).abs().max().item() <= 1e-5 * scale, n


def test_schedules_match_jax():
    cfg = _config()
    cfg.train.num_epochs, cfg.train.warmup_epochs = 30, 4
    tcfg = _torch_config(cfg)
    for e in range(cfg.train.num_epochs):
        assert tloop.warmup_cosine_lr(tcfg, e) == \
            jloop.warmup_cosine_lr(cfg, e)
    kw = dict(lr=1.0, factor=0.5, patience=2, threshold=1e-3, cooldown=1,
              min_lr=0.01)
    ours, ref = tloop.PlateauScheduler(**kw), jloop.PlateauScheduler(**kw)
    values = [10.0, 9.0, 9.0, 9.0, 9.0, 8.5, 9.0, 9.0, 9.0, 9.0, 9.0,
              9.0, 9.0, 7.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0]
    for v in values:
        assert ours.step(v) == ref.step(v), v
    assert ours.state_dict() == ref.state_dict()


def test_loss_decreases_overfit(rooms):
    """As the JAX suite's overfit test: 60 steps on one batch bring the
    loss below 0.7x the first."""
    cfg = ExperimentConfig(
        data=DataConfig(max_trace_len=128, max_colliders=16),
        model=ModelConfig(model_type="lstm", d_model=32, num_queries=12,
                          lstm_layers=1, dropout=0.0),
        train=TrainConfig(batch_size=4, lr=3e-3))
    tcfg = _torch_config(cfg)
    ds = TorchArrays(rooms / "train", tcfg.data, augment=False,
                     verbose=False)
    tb = {k: torch.from_numpy(v) for k, v in ds.gather(np.arange(4)).items()}
    model = torch_build(tcfg.model, generator=torch.Generator().manual_seed(0))
    opt = tloop.make_optimizer(model, tcfg)
    step = tloop.make_train_step(model, opt, tcfg, augment=False)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(tb, gen)["total_loss"]) for _ in range(60)]
    assert np.isfinite(losses[-1])
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])


def test_from_arrays_matches_jax(rooms):
    """A dataset built from in-memory arrays gives the same batches and
    plans as the JAX package's."""
    cfg = _config()
    ref = TraceColliderArrays(rooms / "val", cfg.data, augment=True,
                              verbose=False)
    arrays = ref.device_arrays()
    a = TraceColliderArrays.from_arrays(arrays, cfg.data, augment=True)
    b = TorchArrays.from_arrays(arrays, _torch_config(cfg).data,
                                augment=True)
    assert (b.num_samples, b.n_base, b.names) == \
        (a.num_samples, a.n_base, a.names)
    idx = np.arange(a.num_samples)[::-1]
    for k, v in a.gather(idx).items():
        np.testing.assert_array_equal(b.gather(idx)[k], v, err_msg=k)
    for k, v in a.epoch_plan(3, seed=1).items():
        np.testing.assert_array_equal(b.epoch_plan(3, seed=1)[k], v)


def test_eval_step_and_epoch_match_jax(rooms):
    """Validation: the eval step's losses and outputs, and the whole-split
    eval epoch's mean losses, metric sums and summarized metrics."""
    cfg = _config()
    tcfg = _torch_config(cfg)
    ds = TraceColliderArrays(rooms / "train", cfg.data, augment=False,
                             verbose=False)
    params = _params(cfg)
    jmodel = build_model(cfg.model)
    model = load_params(torch_build(tcfg.model), params)

    host = ds.gather(np.arange(B))
    ref_losses, ref_out = jloop.make_eval_step(jmodel, cfg)(
        params, {k: jnp.asarray(v) for k, v in host.items()})
    losses, out = tloop.make_eval_step(model, tcfg)(
        {k: torch.from_numpy(v) for k, v in host.items()})
    assert set(losses) == set(ref_losses) and set(out) == set(ref_out)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k, v in ref_out.items():
        np.testing.assert_allclose(out[k].numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)

    plan = ds.epoch_plan(B, shuffle=False)      # last batch padded
    data = ds.device_arrays()
    ref_losses, ref_sums = jloop.make_eval_epoch(jmodel, cfg)(
        params, {k: jnp.asarray(v) for k, v in data.items()},
        {k: jnp.asarray(v) for k, v in plan.items()})
    losses, sums = tloop.make_eval_epoch(tcfg)(
        model, {k: torch.from_numpy(v) for k, v in data.items()}, plan)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert set(sums) == set(ref_sums)
    for k, v in ref_sums.items():
        np.testing.assert_allclose(float(sums[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    ref_m = summarize_metrics({k: float(v) for k, v in ref_sums.items()})
    got_m = torch_summarize({k: float(v) for k, v in sums.items()})
    assert set(got_m) == set(ref_m)
    for k, v in ref_m.items():
        np.testing.assert_allclose(got_m[k], v, rtol=1e-5, err_msg=k)


def test_checkpoint_loads_in_both_packages(batch, tmp_path):
    cfg = _config()
    tcfg = _torch_config(cfg)
    model = torch_build(tcfg.model, generator=torch.Generator().manual_seed(5))
    torch_ckpt.save_checkpoint(tmp_path / "best_model", model.state_dict(),
                               epoch=2, val_loss=1.5, config=tcfg)
    side = json.loads((tmp_path / "best_model.json").read_text())
    assert side["has_opt_state"] is False and side["epoch"] == 2

    jmodel, jparams, jcfg = jax_load_model(str(tmp_path / "best_model"))
    assert jcfg.model == cfg.model
    tmodel, _ = load_model_for_inference(str(tmp_path / "best_model"),
                                         device="cpu")
    feats, mask = jax_featurize(jnp.asarray(batch["raw"]),
                                jnp.asarray(batch["length"]))
    ref = jax.jit(jmodel.apply)(jparams, feats, mask)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(np.array(feats)),
                     torch.from_numpy(np.array(mask)))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _bench_config(rooms, tmp_path):
    cfg = _torch_config(_config())
    cfg.model.dropout = 0.1
    cfg.data.data_dir = str(rooms / "train")
    cfg.data.val_dir = str(rooms / "val")
    cfg.train.num_epochs = 2
    cfg.train.save_dir = str(tmp_path)
    return cfg


def test_train_benchmark_two_epochs(rooms, tmp_path):
    cfg = _bench_config(rooms, tmp_path)
    res = train_benchmark(cfg, device="cpu", verbose=False)
    assert len(res["history"]) == 2
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in res["history"])
    assert res["samples_seen"] == 2 * 6 * 4     # rotation-expanded
    assert (tmp_path / "best_model.msgpack").exists()
    assert (tmp_path / "config.json").exists()
    logged = (tmp_path / "history.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in logged] == [0, 1]
    model, _ = load_model_for_inference(str(tmp_path / "best_model"),
                                        device="cpu")
    assert not model.training


def test_cli_trains_on_cpu_and_refuses_without_card(rooms, tmp_path,
                                                    monkeypatch, capsys):
    cfg = _bench_config(rooms, tmp_path)
    cfg.to_json(tmp_path / "cfg.json")
    args = ["--config", str(tmp_path / "cfg.json"),
            "--data_dir", str(rooms / "train"),
            "--val_dir", str(rooms / "val"), "--epochs", "1",
            "--batch_size", "4", "--max_trace_len", "32",
            "--save_dir", str(tmp_path / "out")]
    train_cli(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.rindex("\n{") + 1:])
    assert summary["samples_seen"] == 24
    assert (tmp_path / "out" / "best_model.json").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli(args)
