"""bfloat16 streams of the port's LSTM recurrences on the CPU against the
JAX package's Pallas kernels in interpret mode.

The plain versions of the six LSTM kernels round where the kernels (and the
Pallas kernels) round: W_hh and h before each dot product, the outputs and
the c and gate residuals, the BPTT coefficients and the gate cotangent;
the carries stay float32. ``lstm_recurrence`` / ``bilstm_recurrence`` without
grad are the light forwards' plain versions; with grad they go through
``LSTMFunction`` / ``BiLSTMFunction``, i.e. the training forward's and the
BPTT's plain versions. The ``lstm`` model with ``compute_dtype="bfloat16"``
against the JAX model (``use_pallas=True``, as the JAX suite runs it).

Tolerances: the JAX suite's bf16 bounds, rtol 0.05 / atol 0.03 on values
and max-rel 0.1 on gradients (max abs error over the reference's max abs
value): both sides round to bf16 at the same points, and a rounding that
flips on one side moves a value by one bf16 ulp (2^-8 relative), which the
next steps carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ModelConfig as TorchModelConfig
from room_slam_torch.models.factory import build_model as build_torch
from room_slam_torch.ops import rnn_cuda
from room_slam_torch.ops.rnn import lstm_recurrence
from room_slam_torch.weights import load_params, random_params
from room_slam_tpu.config import ModelConfig
from room_slam_tpu.models.factory import build_model
from room_slam_tpu.ops.rnn_pallas import (bilstm_recurrence_pallas,
                                         lstm_recurrence_pallas)

BF16 = dict(rtol=0.05, atol=0.03)
GRAD_REL = 0.1


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _max_rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _arrays(B, N, H, seed):
    rng = np.random.default_rng(seed)
    xs = [(rng.normal(size=(B, N, 4 * H)) * 0.5).astype(np.float32)
          for _ in range(2)]
    ws = [(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H)).astype(
        np.float32) for _ in range(2)]
    dys = [rng.normal(size=(B, N, H)).astype(np.float32) for _ in range(2)]
    return xs, ws, dys


@pytest.mark.parametrize("shape", [(5, 17, 8), (5, 43, 16)])
def test_single_direction_bf16_matches_pallas(shape):
    """``lstm_recurrence`` (light forward's plain version) and
    ``lstm_recurrence(use_kernel=True)`` under grad (``LSTMFunction`` with
    the training forward's and the BPTT's plain versions) against
    ``lstm_recurrence_pallas``, both walk orders: values and ``jax.grad``
    of xg (bf16) and W_hh (float32)."""
    xs, ws, dys = _arrays(*shape, seed=sum(shape))
    for reverse in (False, True):
        xg = torch.from_numpy(xs[0]).bfloat16()
        w = torch.from_numpy(ws[0])
        ys = lstm_recurrence(xg, w, reverse)
        assert ys.dtype == torch.bfloat16
        jx = jnp.asarray(xs[0]).astype(jnp.bfloat16)
        jw = jnp.asarray(ws[0])
        ref = lstm_recurrence_pallas(jx, jw, reverse, interpret=True)
        np.testing.assert_allclose(_np(ys), _np(ref), **BF16)

        x = [xg.clone().requires_grad_(True), w.clone().requires_grad_(True)]
        yk = lstm_recurrence(*x, reverse, use_kernel=True)
        assert type(yk.grad_fn).__name__ == "LSTMFunctionBackward"
        np.testing.assert_allclose(_np(yk), _np(ref), **BF16)
        got = torch.autograd.grad(yk, x, torch.from_numpy(dys[0]).bfloat16())

        def loss(a, b):
            y = lstm_recurrence_pallas(a, b, reverse, interpret=True)
            return jnp.sum(y.astype(jnp.float32)
                           * jnp.asarray(dys[0]).astype(jnp.bfloat16))

        jg = jax.grad(loss, (0, 1))(jx, jw)
        for name, g, r, t in zip(("dxg", "dW_hh"), got, jg, x):
            assert g.dtype == t.dtype, name
            assert _max_rel(g, r) < GRAD_REL, (name, reverse,
                                                _max_rel(g, r))


@pytest.mark.parametrize("shape", [(5, 17, 8), (5, 43, 16)])
def test_bidirectional_bf16_matches_pallas(shape):
    """``bilstm_recurrence`` without grad (plain light forward) and with it
    (``BiLSTMFunction``: plain training forward and BPTT) against
    ``bilstm_recurrence_pallas``: both outputs and the four gradients."""
    xs, ws, dys = _arrays(*shape, seed=7 + sum(shape))
    tins = [torch.from_numpy(a).bfloat16() for a in xs] \
        + [torch.from_numpy(a) for a in ws]
    jins = [jnp.asarray(a).astype(jnp.bfloat16) for a in xs] \
        + [jnp.asarray(a) for a in ws]
    ref = bilstm_recurrence_pallas(*jins, interpret=True)
    with torch.no_grad():
        light = rnn_cuda.bilstm_recurrence(*tins)
    x = [t.clone().requires_grad_(True) for t in tins]
    ys = rnn_cuda.bilstm_recurrence(*x)
    assert type(ys[0].grad_fn).__name__ == "BiLSTMFunctionBackward"
    for a, b, r in zip(light, ys, ref):
        assert a.dtype == b.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), _np(r), **BF16)
        np.testing.assert_allclose(_np(b), _np(r), **BF16)
    dy = [torch.from_numpy(d).bfloat16() for d in dys]
    got = torch.autograd.grad(ys, x, dy)

    def loss(*a):
        f, b = bilstm_recurrence_pallas(*a, interpret=True)
        return sum(jnp.sum(y.astype(jnp.float32)
                           * jnp.asarray(d).astype(jnp.bfloat16))
                   for y, d in zip((f, b), dys))

    jg = jax.grad(loss, tuple(range(4)))(*jins)
    for name, g, r, t in zip(("dxg_f", "dxg_b", "dW_f", "dW_b"), got, jg,
                             tins):
        assert g.dtype == t.dtype, name
        assert _max_rel(g, r) < GRAD_REL, (name, _max_rel(g, r))


def test_bf16_lstm_model_matches_jax():
    """The ``lstm`` model with ``compute_dtype="bfloat16"`` (bf16
    projections, gate streams, recurrences and q/k/v) against the JAX model
    on the same seeded weights, through the weight bridge."""
    base = dict(model_type="lstm", d_model=32, num_queries=6, lstm_layers=2,
                dropout=0.0, objectness=True, center_xz=True,
                refine_stages=1, compute_dtype="bfloat16")
    jmodel = build_model(ModelConfig(**base, use_pallas_rnn=True))
    model = build_torch(TorchModelConfig(**base, use_pallas_rnn=False))
    params = random_params(model, seed=11)
    params["params"]["decoder"]["inv_temp"] = np.float32(5.0)
    load_params(model, params)
    rng = np.random.default_rng(12)
    B, N = 2, 40
    traces = rng.normal(size=(B, N, 11)).astype(np.float32)
    traces[..., :3] += np.cumsum(rng.normal(size=(B, N, 3)) * 0.3, axis=1
                                 ).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 29:] = False
    traces[~mask] = 0.0
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(traces),
                                jnp.asarray(mask))
    enc = model.encoder
    assert enc.lstm_0.compute_dtype == torch.bfloat16
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(traces), torch.from_numpy(mask))
        memory = enc(torch.from_numpy(traces), torch.from_numpy(mask))[0]
    assert memory.dtype == torch.bfloat16
    assert set(got) == set(ref) == {"pred_boxes", "pred_classes",
                                    "pred_objectness", "pred_aux_boxes"}
    for k in ref:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), _np(ref[k]), **BF16,
                                   err_msg=k)
