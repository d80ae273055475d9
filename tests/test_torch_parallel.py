"""The port's data, tensor and expert parallelism
(``room_slam_torch/parallel/mesh.py`` through ``train/loop.py``) on 4
gloo CPU ranks, from the same bridged parameters and batch, dropout off,
against the JAX package's sharded steps on the virtual 8-CPU mesh and
against the port's one-device step:

- a data-parallel step of the flagship-shaped lstm on a (4, 1) mesh with
  ``grad_accum=2`` and EMA on: losses, updated parameters and EMA against
  the JAX (4, 1) step; the gradients against the port's one-device step;
- the same step with augmentation against the port's one-device step on
  the same generator (the ranks draw the global batch's augmentation);
- transformer steps on a (2, 2) mesh with ``tensor_parallel=True``, with
  dense FFNs (tensor parallelism) and with switch-MoE FFNs (expert
  parallelism): losses and updated parameters against the JAX (2, 2)
  step, the gradients against the port's one-device step, and the
  parameters each side splits over 'model', name for name through the
  weight bridge;
- the validation epoch on a (4, 1) mesh against the one-device one.

Tolerances (``tests/test_torch_train.py``'s): losses rtol 1e-4 against
JAX, 1e-5 within the port; gradients max abs error within 1e-5 of the
largest gradient; updated parameters and EMA atol 1e-6 where the
gradient exceeds 1e-5 of the largest, elsewhere within AdamW's
``2 * lr``. The gradients are held within the port (sharded against
one device). The batch is ``tests/test_torch_train.py``'s: on the 8 rooms
of seed 0 the Hungarian optimum of one item is tied, the two packages'
float32 matchers pick different optimal assignments, and their gradients
part by percents on some encoder leaves (``tests/test_torch_tied_match.py``
pins that cause). One spawn of 4 ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ExperimentConfig as TorchConfig
from room_slam_torch.models.factory import build_model as torch_build
from room_slam_torch.train import loop as tloop
from room_slam_torch.weights import _flatten, _to_jax_key, load_params
from room_slam_tpu.config import (DataConfig, ExperimentConfig, ModelConfig,
                                  TrainConfig)
from room_slam_tpu.data.dataset import TraceColliderArrays
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.parallel import mesh as jmesh
from room_slam_tpu.train import loop as jloop
from room_slam_torch.data.rooms import write_rooms
from torch_parallel_cases import eval_epoch, spawn, train_step

L, M = 64, 16
LOSS_RTOL = 1e-4


def _lstm_config():
    return ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=M),
        model=ModelConfig(model_type="lstm", d_model=32, num_queries=12,
                          lstm_layers=2, dropout=0.0, use_pallas_rnn=False,
                          objectness=True, center_xz=True, refine_stages=1),
        train=TrainConfig(batch_size=8, lr=3e-3, footprint_weight=1.0,
                          objectness_iou=True, size_log_weight=0.5,
                          ema_decay=0.9, grad_accum=2))


def _transformer_config(moe):
    return ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=M),
        model=ModelConfig(model_type="transformer", d_model=32, nhead=2,
                          enc_layers=1, dec_layers=1, num_queries=10,
                          dim_feedforward=64, dropout=0.0,
                          use_pallas_rnn=False, moe_experts=4 if moe else 0),
        train=TrainConfig(batch_size=4, lr=3e-3))


def _params(cfg):
    params = jax.device_get(init_params(build_model(cfg.model), cfg.model,
                                        seq_len=L))
    if cfg.model.model_type == "lstm":
        # a sharp attention (as tests/test_torch_train.py sets it): at the
        # init value the softmax backward cancels most of its input
        params["params"]["decoder"]["inv_temp"] = np.float32(10.0)
    return params


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """``tests/test_torch_train.py``'s batch (its rooms, the first four)
    twice over, the last row padding: each microbatch of ``grad_accum=2``
    puts one row on each of 4 ranks."""
    d = tmp_path_factory.mktemp("par_rooms")
    write_rooms(d, 6, seed=0, points=(150, 250))
    ds = TraceColliderArrays(d, DataConfig(max_trace_len=L, max_colliders=M),
                             augment=False, verbose=False)
    out = ds.gather(np.arange(8) % 4)
    out["weight"][-1] = 0.0
    return out


def _jax_step(cfg, params, batch, mesh_shape, tp, tx):
    """One JAX step on a mesh: (losses, new flat params, flat EMA)."""
    model = build_model(cfg.model)
    mesh = jmesh.make_mesh(mesh_shape)
    p = jmesh.shard_params(jax.tree_util.tree_map(jnp.array, params), mesh,
                           tensor_parallel=tp)
    state = jloop.TrainState(p, tx.init(p), jnp.asarray(0))
    step = jloop.make_train_step(model, tx, cfg, augment=False)
    state, losses = step(state, jmesh.shard_batch(batch, mesh),
                         jax.random.key(0))
    ema = None
    if cfg.train.ema_decay > 0:
        ema = _flat(jax.device_get(jloop.eval_params(state)))
    return ({k: float(v) for k, v in losses.items()},
            _flat(jax.device_get(state.params)), ema, mesh, p)


def _flat(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree["params"]).items()}


def _torch_named(model, flat):
    """Port-named arrays (``weights`` layout) of flat JAX-layout ones."""
    sd = dict(model.named_parameters())
    out = {}
    for k, v in flat.items():
        key = k
        for name in sd:
            jk, tr = _to_jax_key(name, _norms(model))
            if jk == k:
                key, v = name, (v.T if tr else v)
        out[key] = v
    return out


def _norms(model):
    return {n for n, m in model.named_modules()
            if isinstance(m, torch.nn.LayerNorm)}


def _assert_grads(got, ref, rel):
    top = max(np.abs(v).max() for v in ref.values())
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert np.abs(got[k] - v).max() <= rel * top, k


def _assert_params(got, ref, grads, lr, atol=1e-6):
    top = max(np.abs(g).max() for g in grads.values())
    for k, v in ref.items():
        live = np.abs(grads[k]) > 1e-5 * top
        diff = np.abs(got[k] - v)
        assert diff[live].max(initial=0.0) <= atol, (k, diff[live].max())
        assert diff.max(initial=0.0) <= 2 * lr + atol, k


def _payload(cfg, params, batch, mesh, **kw):
    return {"cfg": TorchConfig.from_dict(cfg.to_dict()).to_dict(),
            "params": params, "batch": batch, "mesh": mesh, **kw}


@pytest.fixture(scope="module")
def ranks(batch, tmp_path_factory):
    lcfg = _lstm_config()
    lp = _params(lcfg)
    tcfgs = {moe: _transformer_config(moe) for moe in (False, True)}
    tps = {moe: _params(c) for moe, c in tcfgs.items()}
    half = {k: v[:4] for k, v in batch.items()}
    eval_cfg = _lstm_config()
    eval_cfg.train.batch_size = 4
    ds = TraceColliderArrays.from_arrays(
        {k: batch[k] for k in ("raw", "length", "boxes", "labels", "valid")},
        eval_cfg.data, augment=False)
    cases = {
        "dp": (train_step, _payload(lcfg, lp, batch, (4, 1))),
        "dp_aug": (train_step, _payload(lcfg, lp, batch, (4, 1),
                                        augment=True, seed=5)),
        "tp": (train_step, _payload(tcfgs[False], tps[False], half, (2, 2),
                                    tensor_parallel=True)),
        "ep": (train_step, _payload(tcfgs[True], tps[True], half, (2, 2),
                                    tensor_parallel=True)),
        "eval": (eval_epoch, {
            "cfg": TorchConfig.from_dict(eval_cfg.to_dict()).to_dict(),
            "params": lp, "mesh": (4, 1), "data": ds.device_arrays(),
            "plan": ds.epoch_plan(4, shuffle=False)}),
    }
    out = spawn(4, tmp_path_factory.mktemp("par_ranks"), cases)
    out["inputs"] = (lcfg, lp, tcfgs, tps, half, eval_cfg, ds)
    return out


def _one_device(cfg, params, batch, augment, seed):
    tcfg = TorchConfig.from_dict(cfg.to_dict())
    model = load_params(torch_build(tcfg.model), params)
    opt = tloop.make_optimizer(model, tcfg)
    step = tloop.make_train_step(model, opt, tcfg, augment)
    losses = step({k: torch.from_numpy(v) for k, v in batch.items()},
                  torch.Generator().manual_seed(seed))
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.numpy() for n, p in model.named_parameters()},
            {n: p.detach().numpy() for n, p in model.named_parameters()})


def _assert_vs_jax(got, cfg, params, batch, mesh_shape, tp, grads):
    losses, new, ema, mesh, p = _jax_step(cfg, params, batch, mesh_shape,
                                          tp, jloop.make_optimizer(cfg))
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][0][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    model = torch_build(TorchConfig.from_dict(cfg.to_dict()).model)
    _assert_params(got["params"], _torch_named(model, new), grads,
                   cfg.train.lr)
    if ema is not None:
        _assert_params(got["ema"], _torch_named(model, ema), grads,
                       cfg.train.lr)
    return model, mesh, p


def _assert_vs_one_device(got, cfg, params, batch, augment=False, seed=0):
    losses, grads, new = _one_device(cfg, params, batch, augment, seed)
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][0][k], v, rtol=1e-5,
                                   err_msg=k)
    _assert_grads(got["grads"], grads, 1e-5)
    _assert_params(got["params"], new, grads, cfg.train.lr)
    return grads


def test_data_parallel_step_matches_jax(ranks, batch):
    lcfg, lp, *_ = ranks["inputs"]
    got = ranks["dp"]
    grads = _assert_vs_one_device(got, lcfg, lp, batch)
    _assert_vs_jax(got, lcfg, lp, batch, (4, 1), False, grads)
    assert got["sharded"] == []


def test_data_parallel_augmentation_is_the_global_batchs(ranks, batch):
    lcfg, lp, *_ = ranks["inputs"]
    _assert_vs_one_device(ranks["dp_aug"], lcfg, lp, batch, True, 5)


@pytest.mark.parametrize("kind", ["tp", "ep"])
def test_tensor_and_expert_parallel_steps_match_jax(ranks, kind):
    _, _, tcfgs, tps, half, *_ = ranks["inputs"]
    moe = kind == "ep"
    cfg, params, got = tcfgs[moe], tps[moe], ranks[kind]
    grads = _assert_vs_one_device(got, cfg, params, half)
    # the clip acted: the global norm counted each split parameter once
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in got["grads"].values()))
    np.testing.assert_allclose(norm, cfg.train.grad_clip, rtol=1e-5)
    model, mesh, p = _assert_vs_jax(got, cfg, params, half, (2, 2), True,
                                    grads)
    # the same parameters split over 'model', name for name
    specs = jmesh.param_shardings(p, mesh, tensor_parallel=True)
    jax_sharded = {k for k, s in _flatten(jax.tree_util.tree_map(
        lambda x: "model" in x.spec, specs)["params"]).items() if s}
    port = {_to_jax_key(n, _norms(model))[0] for n in got["sharded"]}
    assert port == jax_sharded and port
    if moe:
        assert "encoder.layer_0.moe.w1" in port
        assert "encoder.layer_0.moe.gate.kernel" not in port
    else:
        assert "encoder.layer_0.linear1.kernel" in port


def test_eval_epoch_on_the_mesh(ranks):
    *_, eval_cfg, ds = ranks["inputs"]
    lp = ranks["inputs"][1]
    tcfg = TorchConfig.from_dict(eval_cfg.to_dict())
    model = load_params(torch_build(tcfg.model), lp)
    data = {k: torch.from_numpy(v) for k, v in ds.device_arrays().items()}
    losses, sums = tloop.make_eval_epoch(tcfg, 0.5)(
        model, data, ds.epoch_plan(4, shuffle=False))
    got_l, got_s = ranks["eval"]
    for k, v in losses.items():
        np.testing.assert_allclose(got_l[k], float(v), rtol=1e-5, err_msg=k)
    for k, v in sums.items():
        np.testing.assert_allclose(got_s[k], float(v), rtol=1e-5, err_msg=k)
