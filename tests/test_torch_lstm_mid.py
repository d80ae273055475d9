"""The widths H 65-118, which the card takes on the LSTM register cluster
kernels (the wide kernels, the first design there, by a forced plan), on
the port's CPU path against the JAX package.

Both directions of a BiLSTM layer (``bilstm_recurrence``) against
``lstm_recurrence_scan``, and the one-direction ``lstm_recurrence(...,
use_kernel=True)`` forward and reverse against ``lstm_recurrence_pallas``
through its CPU path (interpret mode), at H=96 and 116 (the lstm at d_model
192 and 232); values at the JAX suite's float32 bound (rtol 1e-5, atol
1e-6) and all gradients at its BPTT bound (max relative error 1e-4). Then
the ``lstm`` model at d_model 192 against the JAX model on the same
weights: its forward at rtol 1e-4 / atol 1e-5 (two recurrent layers,
attention and a refine stage summed in other orders), and the gradients of
one train step's loss, dropout off, each leaf within 1e-4 of the largest
gradient (a leaf whose gradient is analytically zero holds only rounding
noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ExperimentConfig as TorchConfig
from room_slam_torch.models.factory import build_model as torch_build
from room_slam_torch.ops.losses import set_criterion as torch_criterion
from room_slam_torch.ops.rnn import lstm_recurrence
from room_slam_torch.ops.rnn_cuda import bilstm_recurrence
from room_slam_torch.train import loop as tloop
from room_slam_torch.weights import _flatten, load_params, \
    state_dict_to_params
from room_slam_tpu.config import (DataConfig, ExperimentConfig, ModelConfig,
                                  TrainConfig)
from room_slam_tpu.data.features import featurize as jax_featurize
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.ops.losses import set_criterion
from room_slam_tpu.ops.rnn import lstm_recurrence_scan
from room_slam_tpu.ops.rnn_pallas import lstm_recurrence_pallas
from room_slam_tpu.train import loop as jloop

RTOL, ATOL = 1e-5, 1e-6
GRAD_REL = 1e-4
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
B, N = 2, 9
D_MODEL, L, Q, M = 192, 48, 8, 6   # the model test's width and batch


def _max_rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()
                 / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("hidden", [96, 116])
@pytest.mark.parametrize("family", ["lstm", "lstm_one"])
def test_mid_recurrence_matches_jax(family, hidden):
    rng = np.random.default_rng(hidden)
    arrs = [(rng.normal(size=(B, N, 4 * hidden)) * 0.5).astype(np.float32)
            for _ in range(2)]
    arrs += [(rng.uniform(-1, 1, size=(hidden, 4 * hidden))
              / np.sqrt(hidden)).astype(np.float32) for _ in range(2)]
    dys = [rng.normal(size=(B, N, hidden)).astype(np.float32)
           for _ in range(2)]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    if family == "lstm":
        ys = bilstm_recurrence(*ins)

        def jax_pair(xf, xb, wf, wb):
            return (lstm_recurrence_scan(xf, wf),
                    lstm_recurrence_scan(xb, wb, reverse=True))
    else:
        # two one-direction LSTMs, the second walking in reverse
        ys = (lstm_recurrence(ins[0], ins[2], False, use_kernel=True),
              lstm_recurrence(ins[1], ins[3], True, use_kernel=True))

        def jax_pair(xf, xb, wf, wb):
            return (lstm_recurrence_pallas(xf, wf),
                    lstm_recurrence_pallas(xb, wb, reverse=True))
    jins = [jnp.asarray(a) for a in arrs]
    for got, ref in zip(ys, jax_pair(*jins)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(ys, ins, [torch.from_numpy(d) for d in dys])

    def loss(*a):
        f, b = jax_pair(*a)
        return jnp.sum(f * dys[0]) + jnp.sum(b * dys[1])

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*jins)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert _max_rel(g.numpy(), r) < GRAD_REL, (family, hidden, i)


def _configs():
    """The JAX package's experiment config with the lstm at d_model 192,
    and the port's from its dict."""
    cfg = ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=M),
        model=ModelConfig(model_type="lstm", d_model=D_MODEL, num_queries=Q,
                          lstm_layers=2, dropout=0.0, use_pallas_rnn=False,
                          objectness=True, center_xz=True, refine_stages=1),
        train=TrainConfig(batch_size=B))
    return cfg, TorchConfig.from_dict(cfg.to_dict())


def _batch(seed=0):
    """A seeded batch as the datasets gather it: raw walks (x, y, z, t) of
    two lengths and their colliders."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((B, L, 4), np.float32)
    raw[..., :3] = np.cumsum(rng.normal(scale=0.05, size=(B, L, 3)), axis=1)
    raw[..., 1] += 1.6
    raw[..., 3] = np.arange(L) / 30.0
    boxes = np.concatenate([rng.uniform(-2, 2, size=(B, M, 3)),
                            rng.uniform(0.3, 1.5, size=(B, M, 3))], -1)
    valid = np.zeros((B, M), bool)
    valid[0, :4] = valid[1, :3] = True
    return {"raw": raw, "length": np.array([L, L - 11], np.int32),
            "boxes": boxes.astype(np.float32),
            "labels": rng.integers(0, 3, size=(B, M)).astype(np.int32),
            "valid": valid, "weight": np.ones((B,), np.float32)}


def _flat(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree["params"]).items()}


def test_mid_lstm_model_matches_jax():
    """The lstm at d_model 192 (H=96): the forward's outputs, and the
    gradients of one train step's loss with respect to every leaf."""
    cfg, tcfg = _configs()
    jmodel = build_model(cfg.model)
    params = jax.device_get(init_params(jmodel, cfg.model, seed=0,
                                        seq_len=L))
    # a sharp attention, as chip_smoke.py's steps set it: at the init value
    # the attention over a random encoder is nearly uniform and the float32
    # softmax backward cancels most of its input in both packages (at 10,
    # the train suite's value at d_model 32, one leaf here sits 1.3e-4 of
    # the largest gradient apart)
    params["params"]["decoder"]["inv_temp"] = np.float32(100.0)
    batch = _batch()
    jfeats, jmask = jax_featurize(jnp.asarray(batch["raw"]),
                                  jnp.asarray(batch["length"]))
    ref = jmodel.apply(params, jfeats, jmask, deterministic=True)
    model = load_params(torch_build(tcfg.model), params)
    feats, mask, targets = tloop.prepare_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg.data)
    out = model(feats, mask)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL, err_msg=k)

    jtargets = {"boxes": jnp.asarray(batch["boxes"]),
                "labels": jnp.asarray(batch["labels"]),
                "valid_mask": jnp.asarray(batch["valid"])}

    def loss(p):
        o = jmodel.apply(p, jfeats, jmask, deterministic=True)
        return set_criterion(o, jtargets, jnp.asarray(batch["weight"]),
                             jloop._loss_weight_dict(cfg))["total_loss"]

    grad_ref = _flat(jax.device_get(jax.jit(jax.grad(loss))(params)))
    torch_criterion(out, targets, torch.from_numpy(batch["weight"]),
                    tloop._loss_weight_dict(tcfg))["total_loss"].backward()
    grads = _flat(state_dict_to_params(
        {n: p.grad for n, p in model.named_parameters()}))
    assert set(grads) == set(grad_ref)
    scale = max(np.abs(g).max() for g in grad_ref.values())
    for k, g in grad_ref.items():
        assert np.abs(grads[k] - g).max() <= GRAD_REL * scale, k
