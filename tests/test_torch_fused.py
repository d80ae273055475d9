"""The port's fused training run on the CPU: the device plateau scheduler
against the JAX package's over a seeded loss sequence (equal state each
step), the fused run (``make_fused_run`` + ``fused_run_init``) against
the JAX package's on a deterministic tiny config, ``train_benchmark_fused``
against the port's per-epoch ``train_benchmark`` on one seed, the
multi-step and epoch runners, and the CLI's fused / unfused rule.

The tiny config turns every augmentation off (every ``augment_*`` flag,
every ``*_prob`` 0, one rotation) and dropout to 0, so the JAX keys and
the port's generator draw nothing that changes a value. Against JAX:
losses rtol 1e-4 (float32 through the recurrences, summed in another
order), the IoU sum rtol 1e-3 (the matched pairs' IoUs of small boxes
move a few 1e-4 of the sum after three epochs of such rounding),
learning rates and the count sums equal, best epochs equal. The two port
drivers agree to the bit but for the order of the train-loss mean.
"""

import argparse
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
from room_slam_torch.train import __main__ as cli
from room_slam_torch.train import checkpoint as torch_ckpt
from room_slam_torch.train import loop as tloop
from room_slam_torch.train.driver import (fused_segment, train_benchmark,
                                          train_benchmark_fused)
from room_slam_torch.weights import load_params
from room_slam_tpu.config import (DataConfig, ExperimentConfig, ModelConfig,
                                  TrainConfig)
from room_slam_tpu.data.dataset import TraceColliderArrays
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.train import loop as jloop

L, M, B, E = 48, 12, 4, 3
LOSS_RTOL = 1e-4
IOU_RTOL = 1e-3
SUMS = tloop.METRIC_KEYS


def _config(ema_decay=0.9, patience=0):
    return ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=M,
                        augment_rotation=False, augment_translation=False,
                        augment_scale=False, augment_collider_dropout=False,
                        rotation_angles=(0,), collider_dropout_prob=0.0,
                        reverse_prob=0.0, noise_prob=0.0, crop_prob=0.0,
                        time_warp_prob=0.0, dropout_gate_prob=0.0),
        model=ModelConfig(model_type="lstm", d_model=16, num_queries=12,
                          lstm_layers=1, dropout=0.0, use_pallas_rnn=False,
                          objectness=True),
        train=TrainConfig(batch_size=B, lr=3e-3, num_epochs=E,
                          ema_decay=ema_decay, plateau_patience=patience,
                          plateau_cooldown=1, objectness_iou=True))


def _torch_config(cfg, rooms=None, save_dir=None):
    tc = TorchConfig.from_dict(cfg.to_dict())
    if rooms is not None:
        tc.data.data_dir = str(rooms / "train")
        tc.data.val_dir = str(rooms / "val")
    if save_dir is not None:
        tc.train.save_dir = str(save_dir)
    return tc


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    """8 train rooms (2 batches of 4) and 4 val rooms (1 batch)."""
    d = tmp_path_factory.mktemp("rooms")
    write_rooms(d / "train", 8, seed=0, points=(80, 120))
    write_rooms(d / "val", 4, seed=1, points=(80, 120))
    return d


def _sched_tuple(s):
    return tuple(np.asarray(x).item() for x in s)


def test_sched_update_matches_jax():
    """Every state of the plateau rule (lr, best, num_bad, cooldown) over a
    seeded loss sequence with plateaus, decays, cooldowns and the floor."""
    cfg = _config(patience=1)
    cfg.train.plateau_min_scale = 0.2
    rng = np.random.default_rng(0)
    losses = np.concatenate([np.linspace(2.0, 1.0, 6),
                             1.0 + 0.01 * rng.uniform(size=14),
                             np.linspace(0.9, 0.5, 5),
                             0.5 + 0.3 * rng.uniform(size=15)]
                            ).astype(np.float32)
    js = jloop.sched_init(cfg)
    ts = tloop.sched_init(_torch_config(cfg))
    lrs = set()
    for v in losses:
        js = jloop.sched_update(js, jnp.float32(v), cfg)
        ts = tloop.sched_update(ts, torch.tensor(v), _torch_config(cfg))
        assert _sched_tuple(ts) == _sched_tuple(js), (v, ts, js)
        assert ts.lr.dtype == torch.float32 and ts.num_bad.dtype == \
            torch.int32
        lrs.add(float(ts.lr))
    assert len(lrs) >= 3            # decayed at least twice, to the floor
    assert min(lrs) == pytest.approx(cfg.train.lr * 0.2)


def _plans(ds, cfg):
    plans = [ds.epoch_plan(B, seed=cfg.train.seed + e) for e in range(E)]
    return {k: np.stack([p[k] for p in plans]) for k in plans[0]}


def _jax_fused(cfg, rooms, params):
    tr = TraceColliderArrays(rooms / "train", cfg.data, augment=True,
                             verbose=False)
    va = TraceColliderArrays(rooms / "val", cfg.data, augment=False,
                             verbose=False)
    model = build_model(cfg.model)
    tx = jloop.make_optimizer(cfg)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = jloop.TrainState(p, tx.init(p), jnp.asarray(0))
    run = jloop.make_fused_run(model, tx, cfg)
    sched, best = jloop.fused_run_init(cfg, state)
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    state, sched, best, hist = run(
        state, sched, best, J(tr.device_arrays()), J(va.device_arrays()),
        J(_plans(tr, cfg)), J(va.epoch_plan(B, shuffle=False)),
        jnp.arange(E, dtype=jnp.int32), jax.random.key(0))
    return ({k: np.asarray(v) for k, v in hist.items()},
            int(best["epoch"]), float(best["val_loss"]))


def test_fused_run_matches_jax(rooms):
    """The port's fused run from the JAX init against the JAX fused run:
    the history's losses, learning rates and metric sums, the best epoch
    and its validation loss, with the EMA as the evaluation parameters."""
    cfg = _config()
    params = jax.device_get(init_params(build_model(cfg.model), cfg.model,
                                        seed=0, seq_len=L))
    params["params"]["decoder"]["inv_temp"] = np.float32(10.0)
    ref, ref_epoch, ref_val = _jax_fused(cfg, rooms, params)

    tc = _torch_config(cfg)
    model = load_params(torch_build(tc.model), params)
    opt = tloop.make_optimizer(model, tc)
    run = tloop.make_fused_run(model, opt, tc)
    sched, best = tloop.fused_run_init(tc, model, opt)
    live = dict(model.state_dict())
    assert all(best["params"][k].data_ptr() != v.data_ptr()
               for k, v in live.items())
    tr = TorchArrays(rooms / "train", tc.data, augment=True, verbose=False)
    va = TorchArrays(rooms / "val", tc.data, augment=False, verbose=False)
    T = lambda d: tloop.device_plan(d, torch.device("cpu"))
    sched, best, hist = run(
        sched, best, T(tr.device_arrays()), T(va.device_arrays()),
        T(_plans(tr, tc)), T(va.epoch_plan(B, shuffle=False)),
        torch.arange(E, dtype=torch.int32),
        torch.Generator().manual_seed(0))
    got = {k: v.numpy() for k, v in hist.items()}
    assert set(got) == set(ref)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_array_equal(got["lr"], ref["lr"])
    for k in SUMS:
        if k == "iou_sum":     # a float sum of the outputs' IoUs
            np.testing.assert_allclose(got[k], ref[k], rtol=IOU_RTOL)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert int(best["epoch"]) == ref_epoch
    assert float(best["val_loss"]) == pytest.approx(ref_val, rel=LOSS_RTOL)
    assert float(opt.lr) == float(ref["lr"][-1])


def test_fused_driver_matches_per_epoch_driver(rooms, tmp_path):
    """``train_benchmark_fused`` and ``train_benchmark`` on one seed take
    the same steps: equal histories and the same best model."""
    cfg = _config(patience=0)
    fused = train_benchmark_fused(
        _torch_config(cfg, rooms, tmp_path / "fused"), device="cpu",
        verbose=False)
    plain = train_benchmark(
        _torch_config(cfg, rooms, tmp_path / "plain"), device="cpu",
        verbose=False)
    assert len(fused["history"]) == len(plain["history"]) == E
    for f, p in zip(fused["history"], plain["history"]):
        for k in ("train_loss", "val_loss"):
            assert f[k] == pytest.approx(p[k], rel=LOSS_RTOL), k
        for k in ("tp", "fp", "fn", "mIoU", "precision", "recall", "cls_acc"):
            assert f[k] == p[k], k
    logged = [json.loads(x) for x in (tmp_path / "plain" / "history.jsonl")
              .read_text().splitlines()]
    # the per-epoch driver logs its host scheduler's float64; both
    # optimizers take it as float32
    assert [np.float32(r["lr"]) for r in fused["history"]] == \
        [np.float32(r["lr"]) for r in logged]
    vals = [r["val_loss"] for r in plain["history"]]
    assert fused["best_epoch"] == int(np.argmin(vals))
    assert fused["best_val_loss"] == pytest.approx(plain["best_val_loss"],
                                                   rel=LOSS_RTOL)
    assert fused["n_params"] == plain["n_params"]
    assert fused["samples_seen"] == plain["samples_seen"] == E * 8
    got, side = torch_ckpt.load_checkpoint(str(tmp_path / "fused" /
                                               "best_model"))
    ref, ref_side = torch_ckpt.load_checkpoint(str(tmp_path / "plain" /
                                                   "best_model"))
    assert side["epoch"] == ref_side["epoch"] == fused["best_epoch"]
    flat = jax.tree_util.tree_leaves_with_path
    for (kp, a), (_, b) in zip(flat(got), flat(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=str(kp))
    final, fside = torch_ckpt.load_checkpoint(
        str(tmp_path / "fused" / "final_model"), with_opt_state=True)[1:]
    assert fside["has_opt_state"] and fside["epoch"] == E - 1
    assert [json.loads(x)["epoch"] for x in (tmp_path / "fused" /
            "history.jsonl").read_text().splitlines()] == list(range(E))


def test_train_steps_and_epoch_runners(rooms):
    """``make_train_steps`` returns the N losses of N steps on one batch,
    ``make_train_epoch`` the mean of a plan's steps; both as
    ``make_train_step`` from the same start."""
    tc = _torch_config(_config(ema_decay=0.0))
    tr = TorchArrays(rooms / "train", tc.data, augment=True, verbose=False)
    data = tloop.device_plan(tr.device_arrays(), torch.device("cpu"))
    plan = tr.epoch_plan(B, seed=0)

    def fresh():
        model = torch_build(tc.model,
                            generator=torch.Generator().manual_seed(0))
        return model, tloop.make_optimizer(model, tc)

    model, opt = fresh()
    batch = tloop.gather_batch(data, plan, 0)
    gen = torch.Generator().manual_seed(1)
    many = tloop.make_train_steps(model, opt, tc)(batch, gen, 3)
    model, opt = fresh()
    step = tloop.make_train_step(model, opt, tc)
    one = [step(batch, torch.Generator().manual_seed(1))["total_loss"]]
    assert many.shape == (3,) and float(many[0]) == float(one[0])
    assert float(many[2]) < float(many[0])
    model, opt = fresh()
    mean = tloop.make_train_epoch(model, opt, tc)(
        data, tloop.device_plan(plan, torch.device("cpu")), gen)
    model, opt = fresh()
    step = tloop.make_train_step(model, opt, tc)
    ref = [float(step(tloop.gather_batch(data, plan, i), gen)["total_loss"])
           for i in range(2)]
    assert float(mean["total_loss"]) == pytest.approx(np.mean(ref),
                                                      rel=1e-6)


@pytest.mark.parametrize("flags, fused", [
    ([], True), (["--no_fused"], False), (["--synthetic", "8"], False),
    (["--resume", "ckpt/best_model"], False)])
def test_cli_fused_rule(flags, fused, monkeypatch, tmp_path):
    """``train.py``'s rule: the fused run unless ``--no_fused``,
    ``--synthetic`` or ``--resume``; the chosen driver gets the run."""
    called = []
    monkeypatch.setattr(cli, "train_benchmark_fused",
                        lambda cfg, **kw: called.append("fused") or {})
    monkeypatch.setattr(cli, "train_benchmark",
                        lambda cfg, **kw: called.append("plain") or {})
    monkeypatch.setattr(cli, "make_synthetic_datasets",
                        lambda *a, **kw: (None, None))
    args = ["--data_dir", str(tmp_path), "--device", "cpu", *flags]
    assert cli.use_fused(argparse.Namespace(
        no_fused="--no_fused" in flags, synthetic="--synthetic" in flags,
        resume="--resume" in flags)) is fused
    cli.main(args)
    assert called == ["fused" if fused else "plain"]


def test_fused_segment_rule():
    """At most 20 epochs a segment, about 200 steps, at least one."""
    assert fused_segment(100, 1) == 20
    assert fused_segment(3, 2) == 3
    assert fused_segment(50, 40) == 5
    assert fused_segment(50, 500) == 1
