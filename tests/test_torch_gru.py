"""The port's scale-up BiGRU slice on the CPU against the JAX package.

The plain GRU recurrence against ``gru_recurrence_scan``; the BiGRU
kernels' plain versions (light forward, training forward, BPTT through
``BiGRUFunction``) against ``bigru_recurrence_pallas`` / ``_bigru_fwd_pallas``
in interpret mode, in float32 and bfloat16 streams; a float64 gradcheck of
the Function; the ``bigru`` model (``TraceToColliderGRU`` built with
``use_pallas=True``, as the JAX suite runs it) in float32 and bfloat16; one
train step against JAX ``make_train_step``; the weight bridge, serving a JAX
checkpoint, ``--set``, the launch planner and the refusal to fall back.

Tolerances. float32: the JAX suite's rtol 1e-5 / atol 1e-6 on recurrences,
max-rel 1e-4 on gradients (max abs error over the reference's max abs
value), rtol 1e-4 / atol 1e-5 on the model outputs. bfloat16 streams: rtol
0.05 / atol 0.03 on values and max-rel 0.1 on gradients, the suite's bf16
bounds: both sides round to bf16 at the same points, and a rounding that
flips on one side moves a value by one bf16 ulp (2^-8 relative), which the
next steps carry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ExperimentConfig as TorchConfig
from room_slam_torch.models.factory import build_model as torch_build
from room_slam_torch.ops import gru_cuda
from room_slam_torch.ops.gru_cuda import (BiGRUFunction, bigru_fwd_train,
                                          bigru_plan, bigru_recurrence)
from room_slam_torch.ops.rnn import gru_recurrence
from room_slam_torch.train import loop as tloop
from room_slam_torch.train.__main__ import main as train_cli
from room_slam_torch.train.driver import load_model_for_inference
from room_slam_torch.weights import (_flatten, load_params, random_params,
                                     state_dict_to_params)
from room_slam_tpu.config import (DataConfig, ExperimentConfig, ModelConfig,
                                  TrainConfig)
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.models.gru import TraceToColliderGRU
from room_slam_tpu.ops.gru_pallas import (_bigru_fwd_pallas,
                                          bigru_recurrence_pallas)
from room_slam_tpu.ops.rnn import gru_recurrence_scan
from room_slam_tpu.train import loop as jloop
from room_slam_tpu.train.checkpoint import save_checkpoint

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=0.05, atol=0.03)
GRAD_REL = {"float32": 1e-4, "bfloat16": 0.1}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(B, N, H, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, N, 3 * H)) * 0.5).astype(np.float32),
            (rng.normal(size=(B, N, 3 * H)) * 0.5).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) * 0.2).astype(np.float32),
            (rng.normal(size=(3 * H,)) * 0.2).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) * 0.2).astype(np.float32),
            (rng.normal(size=(3 * H,)) * 0.2).astype(np.float32)]


def _cast(arrs, dtype):
    """torch and jax copies; the gate streams (first two) in ``dtype``."""
    td, jd = DTYPES[dtype]
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    return ([x.to(td) for x in t[:2]] + t[2:],
            [x.astype(jd) for x in j[:2]] + j[2:])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _max_rel(got, ref):
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("N", [17, 43])
def test_gru_recurrence_matches_scan(N):
    xg, _, w, b, _, _ = _inputs(3, N, 16)
    for reverse in (False, True):
        got = gru_recurrence(torch.from_numpy(xg), torch.from_numpy(w),
                             torch.from_numpy(b), reverse=reverse)
        ref = gru_recurrence_scan(jnp.asarray(xg), jnp.asarray(w),
                                  jnp.asarray(b), reverse=reverse)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forwards_match_pallas(dtype):
    """Light forward (outputs) and training forward (outputs and the
    residuals r, z, n and hn) against the interpret-mode Pallas kernel's
    training call, whose outputs are the light call's (one kernel body)."""
    tins, jins = _cast(_inputs(3, 17, 16), dtype)
    tol = F32 if dtype == "float32" else BF16
    before = gru_cuda.bigru_fwd_cuda.launches
    light = bigru_recurrence(*tins)
    assert gru_cuda.bigru_fwd_cuda.launches == before    # CPU: no kernel
    ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = bigru_fwd_train(*tins)
    assert ys_f.dtype == gs_f.dtype == hn_b.dtype == DTYPES[dtype][0]
    # JAX: the backward direction on the flipped stream, time-major
    # residuals in its walk order
    xgf, xgb, wf, bf, wb, bb = jins
    jyf, jyb, jgf, jhnf, jgb, jhnb = _bigru_fwd_pallas(
        xgf, jnp.flip(xgb, 1), wf, bf, wb, bb, interpret=True,
        save_residuals=True)
    ref_f, ref_b = _np(jyf), _np(jyb)[:, ::-1]

    def tm(x, flip):
        x = np.swapaxes(_np(x), 0, 1)
        return x[:, ::-1] if flip else x

    pairs = [(light[0], ref_f), (light[1], ref_b),
             (ys_f, ref_f), (ys_b, ref_b),
             (gs_f, tm(jgf, False)), (gs_b, tm(jgb, True)),
             (hn_f, tm(jhnf, False)), (hn_b, tm(jhnb, True))]
    for got, ref in pairs:
        np.testing.assert_allclose(_np(got), ref, **tol)


@pytest.mark.parametrize("dtype,shape", [("float32", (3, 23, 16)),
                                         ("bfloat16", (3, 23, 16))])
def test_gradients_match_jax(dtype, shape):
    """All six gradients of ``BiGRUFunction`` (plain BPTT on the CPU)
    against ``jax.grad`` through the interpret-mode Pallas kernel."""
    B, N, H = shape
    tins, jins = _cast(_inputs(B, N, H, seed=2), dtype)
    rng = np.random.default_rng(3)
    dyf, dyb = (rng.normal(size=(B, N, H)).astype(np.float32)
                for _ in range(2))
    ins = [t.requires_grad_(True) for t in tins]
    ys = bigru_recurrence(*ins)
    assert type(ys[0].grad_fn).__name__ == "BiGRUFunctionBackward"
    td = DTYPES[dtype][0]
    got = torch.autograd.grad(ys, ins, [torch.from_numpy(dyf).to(td),
                                        torch.from_numpy(dyb).to(td)])
    jd = DTYPES[dtype][1]

    def loss(*a):
        f, b = bigru_recurrence_pallas(*a, interpret=True)
        return (jnp.sum(f.astype(jnp.float32) * dyf.astype(jd))
                + jnp.sum(b.astype(jnp.float32) * dyb.astype(jd)))

    ref = jax.grad(loss, argnums=tuple(range(6)))(*jins)
    for name, g, r, t in zip(("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b",
                              "db_b"), got, ref, tins):
        assert g.dtype == t.dtype, name
        rel = _max_rel(g, r)
        assert rel < GRAD_REL[dtype], (name, rel)


def test_function_gradcheck():
    """The hand-written backward (plain BPTT and the dW_hh / db_hh
    products, not autograd through the loop) against finite differences in
    float64."""
    g = torch.Generator().manual_seed(0)
    B, N, H = 2, 7, 4
    ins = [torch.randn(B, N, 3 * H, generator=g, dtype=torch.float64) * 0.5,
           torch.randn(B, N, 3 * H, generator=g, dtype=torch.float64) * 0.5,
           torch.randn(H, 3 * H, generator=g, dtype=torch.float64) * 0.3,
           torch.randn(3 * H, generator=g, dtype=torch.float64) * 0.3,
           torch.randn(H, 3 * H, generator=g, dtype=torch.float64) * 0.3,
           torch.randn(3 * H, generator=g, dtype=torch.float64) * 0.3]
    assert torch.autograd.gradcheck(
        BiGRUFunction.apply, [t.requires_grad_(True) for t in ins])


# ---------------------------------------------------------------------------
# The model, a train step, the bridge and serving
# ---------------------------------------------------------------------------

L, M, B = 48, 12, 3


def _model_cfg(dtype="float32", **kw):
    base = dict(model_type="bigru", d_model=32, num_queries=8,
                lstm_layers=2, dropout=0.0, compute_dtype=dtype,
                objectness=True, center_xz=True, refine_stages=1,
                extent_features=True, use_pallas_rnn=False)
    base.update(kw)
    return ModelConfig(**base)


def _traces(seed=0):
    rng = np.random.default_rng(seed)
    traces = rng.normal(size=(2, L, 11)).astype(np.float32)
    traces[..., :3] += np.cumsum(rng.normal(size=(2, L, 3)) * 0.3, axis=1
                                 ).astype(np.float32)
    mask = np.ones((2, L), bool)
    mask[1, 29:] = False
    traces[~mask] = 0.0
    return traces, mask


def _torch_model(cfg, params):
    tcfg = TorchConfig.from_dict({"model": cfg.__dict__}).model
    return load_params(torch_build(tcfg), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_output_dict_matches_jax(dtype):
    cfg = _model_cfg(dtype)
    jmodel = TraceToColliderGRU(
        d_model=cfg.d_model, num_queries=cfg.num_queries,
        gru_layers=cfg.lstm_layers, dropout=0.0, use_pallas=True,
        compute_dtype=dtype, objectness=True, center_xz=True,
        refine_stages=1, extent_features=True)
    model = torch_build(TorchConfig.from_dict({"model": cfg.__dict__}).model)
    params = random_params(model, seed=4)
    params["params"]["decoder"]["inv_temp"] = np.float32(5.0)
    load_params(model, params)
    traces, mask = _traces()
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(traces),
                                jnp.asarray(mask))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(traces), torch.from_numpy(mask))
    assert set(got) == set(ref) == {"pred_boxes", "pred_classes",
                                    "pred_objectness", "pred_aux_boxes"}
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else BF16
    for k in ref:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), _np(ref[k]), **tol,
                                   err_msg=k)


def _batch(seed=0):
    """A featurizable batch: walks with a random box set."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((B, L, 4), np.float32)
    raw[..., [0, 2]] = np.cumsum(rng.normal(size=(B, L, 2)) * 0.1, axis=1)
    raw[..., 1] = 1.6 + 0.02 * rng.standard_normal((B, L))
    raw[..., 3] = np.arange(L) / 30.0
    boxes = np.zeros((B, M, 6), np.float32)
    boxes[..., :3] = rng.normal(size=(B, M, 3))
    boxes[..., 3:] = rng.uniform(0.3, 2.0, size=(B, M, 3))
    valid = np.arange(M)[None] < np.array([[5], [7], [3]])
    return {"raw": raw, "length": np.array([L, L - 9, L - 20], np.int32),
            "boxes": boxes, "labels": rng.integers(0, 4, (B, M)).astype(
                np.int32), "valid": valid,
            "rotation_k": np.zeros(B, np.int32),
            "weight": np.ones(B, np.float32)}


def test_train_step_matches_jax():
    """One ``bigru`` step (one GRU layer: the model tests above stack two,
    and a second layer only lengthens JAX's compile) from identical
    parameters (``random_params``) and batch (augmentation off, dropout 0,
    ``inv_temp`` 10), as
    ``tests/test_torch_train.py`` holds
    the ``lstm`` step: losses rtol 1e-4, equal Hungarian assignments, and
    updated parameters within 1e-6 where the gradient is live (more than
    1e-5 of the largest); elsewhere AdamW's first step turns rounding noise
    into +-lr, so there within 2 lr."""
    from room_slam_torch.data.features import featurize
    from room_slam_torch.ops.losses import match
    from room_slam_tpu.data.features import featurize as jax_featurize
    from room_slam_tpu.ops.losses import match as jax_match

    cfg = ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=M),
        model=_model_cfg(extent_features=False, lstm_layers=1),
        train=TrainConfig(batch_size=B, lr=3e-3, footprint_weight=1.0,
                          objectness_iou=True))
    jmodel = build_model(cfg.model)
    tcfg = TorchConfig.from_dict(cfg.to_dict())
    model = torch_build(tcfg.model)
    params = random_params(model, seed=1)
    params["params"]["decoder"]["inv_temp"] = np.float32(10.0)
    load_params(model, params)
    batch = _batch()
    feats, mask = jax_featurize(jnp.asarray(batch["raw"]),
                                jnp.asarray(batch["length"]))
    # targets near a shuffled subset of the predicted boxes: with random
    # weights the predictions cluster, and far targets tie exactly in the
    # L1 match cost
    pred = np.asarray(jmodel.apply(params, feats, mask)["pred_boxes"])
    rng = np.random.default_rng(7)
    for i in range(B):
        q = rng.permutation(cfg.model.num_queries)[:M]
        n = min(M, len(q))
        batch["boxes"][i, :n] = pred[i, q] + rng.normal(
            scale=0.05, size=(n, 6)).astype(np.float32)
    batch["boxes"][..., 3:] = np.abs(batch["boxes"][..., 3:]) + 0.05
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = jmodel.apply(params, feats, mask)
    ref_rows, ref_matched = jax_match(out["pred_boxes"], out["pred_classes"],
                                      jb["boxes"], jb["labels"], jb["valid"])
    with torch.no_grad():
        tout = model(*featurize(tb["raw"], tb["length"]))
        rows, matched = match(tout["pred_boxes"], tout["pred_classes"],
                              tb["boxes"], tb["labels"], tb["valid"])
    np.testing.assert_array_equal(matched.numpy(), np.asarray(ref_matched))
    np.testing.assert_array_equal(np.where(matched, rows, -1),
                                  np.where(ref_matched, ref_rows, -1))

    tx = jloop.make_optimizer(cfg)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = jloop.TrainState(p, tx.init(p), jnp.asarray(0))
    step = jloop.make_train_step(jmodel, tx, cfg, augment=False)
    state, ref_losses = step(state, jb, jax.random.key(0))
    opt = tloop.make_optimizer(model, tcfg)
    losses = tloop.make_train_step(model, opt, tcfg, augment=False)(
        tb, torch.Generator().manual_seed(0))
    assert set(losses) == set(ref_losses)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4,
                                   err_msg=k)

    def flat(tree):
        return {k: np.asarray(v) for k, v in _flatten(tree["params"]).items()}

    got = flat(state_dict_to_params(model.state_dict()))
    ref = flat(jax.device_get(state.params))
    grads = flat(state_dict_to_params({n: q.grad for n, q in opt.named}))
    scale = max(np.abs(g).max() for g in grads.values())
    lr = cfg.train.lr
    assert set(got) == set(ref)
    for k in ref:
        live = np.abs(grads[k]) > 1e-5 * scale
        diff = np.abs(got[k] - ref[k])
        assert diff[live].max(initial=0.0) <= 1e-6, (k, diff[live].max())
        assert diff.max() <= 2 * lr + 1e-6, k


def test_weight_bridge_round_trip():
    """The ``bigru`` tree maps both ways, strictly, with every GRU leaf
    (w_ih, b_ih, w_hh, b_hh of both directions) in the JAX layout."""
    cfg = _model_cfg()
    jparams = jax.device_get(init_params(build_model(cfg), cfg, seq_len=L))
    model = _torch_model(cfg, jparams)
    back = state_dict_to_params(model.state_dict())
    ref = _flatten(jparams["params"])
    got = _flatten(back["params"])
    assert set(got) == set(ref)
    assert {"encoder.gru_1.b_ih_bwd", "encoder.gru_0.w_hh_fwd",
            "encoder.gru_0.b_hh_fwd"} <= set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["params"]["encoder"]["gru_0"]["b_hh_fwd"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="b_hh_fwd"):
        load_params(torch_build(TorchConfig.from_dict(
            {"model": cfg.__dict__}).model), bad)
    del bad["params"]["encoder"]["gru_0"]["b_hh_fwd"]
    with pytest.raises(KeyError, match="b_hh_fwd"):
        load_params(torch_build(TorchConfig.from_dict(
            {"model": cfg.__dict__}).model), bad)
    rnd = _flatten(random_params(model, seed=0)["params"])
    bound = 1.0 / np.sqrt(cfg.d_model // 2)
    for k in ("encoder.gru_0.b_ih_fwd", "encoder.gru_1.b_hh_bwd"):
        assert 0.5 * bound < np.abs(rnd[k]).max() <= bound, k


def test_serves_jax_bigru_checkpoint(tmp_path):
    """A JAX ``bigru`` checkpoint through ``load_model_for_inference`` on
    the CPU gives the JAX model's outputs."""
    cfg = ExperimentConfig(data=DataConfig(max_trace_len=L),
                           model=_model_cfg(refine_stages=0))
    jmodel = build_model(cfg.model)
    params = init_params(jmodel, cfg.model, seed=2, seq_len=L)
    save_checkpoint(tmp_path / "best_model", params, config=cfg)
    model, tcfg = load_model_for_inference(str(tmp_path / "best_model"),
                                           device="cpu")
    assert tcfg.model.model_type == "bigru" and not model.training
    traces, mask = _traces(seed=5)
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(traces),
                                jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(traces), torch.from_numpy(mask))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), _np(ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_set_overrides_match_jax_and_train_bigru(tmp_path, capsys):
    """``apply_overrides`` parses as the JAX package's does, and the CLI's
    ``--set`` trains a small bf16 ``bigru`` on the CPU."""
    sets = ["model.model_type=bigru", "model.d_model=32",
            "model.num_queries=8", "model.compute_dtype=bfloat16",
            "data.max_colliders=12", "model.objectness=true",
            "data.scale_range=[0.9, 1.1]", "train.lr=0.001"]
    ref = ExperimentConfig().apply_overrides(sets)
    got = TorchConfig().apply_overrides(sets)
    assert got.to_dict() == TorchConfig.from_dict(ref.to_dict()).to_dict()
    with pytest.raises(AttributeError):
        TorchConfig().apply_overrides(["model.no_such_key=1"])

    from room_slam_torch.data.rooms import write_rooms
    write_rooms(tmp_path / "train", 2, seed=0, points=(60, 80))
    write_rooms(tmp_path / "val", 1, seed=1, points=(60, 80))
    train_cli(["--data_dir", str(tmp_path / "train"),
               "--val_dir", str(tmp_path / "val"), "--epochs", "1",
               "--batch_size", "4", "--max_trace_len", "32",
               "--save_dir", str(tmp_path / "out"), "--device", "cpu",
               *(a for s in sets for a in ("--set", s))])
    out = capsys.readouterr().out
    summary = json.loads(out[out.rindex("\n{") + 1:])
    assert np.isfinite(summary["best_val_loss"])
    saved = json.loads((tmp_path / "out" / "config.json").read_text())
    assert saved["model"]["model_type"] == "bigru"
    assert saved["model"]["compute_dtype"] == "bfloat16"


# ---------------------------------------------------------------------------
# Planning and dispatch
# ---------------------------------------------------------------------------


def test_cluster_plan():
    """W_hh of H=256 needs a cluster. On a card that holds 132 clusters of
    1 block, 66 of 2, 30 of 4 and 15 of 8 at once (an H100's counts at
    these shared-memory sizes), both kernels take 8 blocks of 32 units at
    B=128 with 20-row tiles: 7 tiles x 2 directions = 14 clusters, one
    wave, where smaller tiles would need a second. Smaller batches take 4
    blocks and 4-row tiles; the test width H=16 takes one block. On a card
    that holds only 8 clusters of 8, the forward moves to 4 blocks of
    12-row tiles (22 clusters, one wave); the BPTT, whose exchange tile
    leaves room for at most 20 rows in 8 blocks and 4 in 4, runs 16
    clusters of 8 blocks with 16-row tiles in two waves. A shape no
    cluster size takes raises."""
    counts = {1: 132, 2: 66, 4: 30, 8: 15}

    def resident(c, rows):
        return counts[c]

    for kind in ("fwd", "bwd"):
        assert bigru_plan(kind, 128, 256, resident) == (8, 20)
        assert bigru_plan(kind, 16, 256, resident) == (4, 4)
        assert bigru_plan(kind, 1, 256, resident) == (4, 4)
        assert bigru_plan(kind, 3, 16, resident) == (1, 4)
        assert gru_cuda.bigru_smem_bytes(kind, 256, 8, 20) \
            <= gru_cuda.MAX_SMEM_BYTES
        assert gru_cuda.bigru_smem_bytes(kind, 256, 4, 20) \
            > gru_cuda.MAX_SMEM_BYTES
    counts[8] = 8
    assert bigru_plan("fwd", 128, 256, resident) == (4, 12)
    assert bigru_plan("bwd", 128, 256, resident) == (8, 16)
    with pytest.raises(ValueError, match="cluster"):
        bigru_plan("fwd", 8, 526, resident)   # 526 = 2 x 263: none fits


def test_cuda_path_never_falls_back(monkeypatch):
    """When the tensors' device says CUDA, every BiGRU entry launches the
    kernel's wrapper, which refuses tensors that are not on a card: no
    path sends them to a plain version."""
    ins = [torch.from_numpy(a) for a in _inputs(2, 5, 8)]
    monkeypatch.setattr(gru_cuda, "_device_type", lambda name, *t: "cuda")
    plain = []
    for name in ("bigru_fwd_plain", "bigru_fwd_train_plain",
                 "bigru_bwd_plain"):
        monkeypatch.setattr(gru_cuda, name,
                            lambda *a, n=name: plain.append(n))
    with pytest.raises(ValueError, match="CUDA"):
        bigru_recurrence(*ins)
    with pytest.raises(ValueError, match="CUDA"):
        bigru_recurrence(*[t.clone().requires_grad_(True) for t in ins])
    ys = [torch.zeros(2, 5, 8)] * 2
    with pytest.raises(ValueError, match="CUDA"):
        gru_cuda.bigru_bwd(ins[2], ins[4], ins[0], ys[0], ys[0], ys[0],
                           ins[1], ys[1], ys[1], ys[1])
    assert plain == []
