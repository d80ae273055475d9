"""The port's BiLSTM training path (plain versions, CPU) against the JAX
package: the training variant's residuals against ``_bilstm_fwd_pallas``
with ``save_residuals`` (interpret mode), and all four gradients of
``bilstm_recurrence`` against ``jax.grad`` through
``bilstm_recurrence_pallas`` (interpret mode) and through two
``lstm_recurrence_scan`` calls, at the JAX suite's BPTT bound: max relative
error (max abs error over the reference's max abs value) 1e-4. Plus a
float64 ``gradcheck`` of the ``Function``'s hand-written backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import rnn_cuda
from room_slam_torch.ops.rnn_cuda import (BiLSTMFunction, bilstm_fwd_train,
                                          bilstm_recurrence)
from room_slam_tpu.ops.rnn import lstm_recurrence_scan
from room_slam_tpu.ops.rnn_pallas import (_bilstm_fwd_pallas,
                                          bilstm_recurrence_pallas)

GRAD_REL = 1e-4
RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(3, 53, 16), (5, 43, 16), (2, 1, 8)]


def _inputs(B, N, H, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, N, 4 * H)) * 0.5).astype(np.float32),
            (rng.normal(size=(B, N, 4 * H)) * 0.5).astype(np.float32),
            (rng.normal(size=(H, 4 * H)) * 0.2).astype(np.float32),
            (rng.normal(size=(H, 4 * H)) * 0.2).astype(np.float32)]


def _max_rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()
                 / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("shape", SHAPES)
def test_training_residuals_match_jax(shape):
    xgf, xgb, wf, wb = _inputs(*shape)
    ys_f, ys_b, cs_f, cs_b, gs_f, gs_b = bilstm_fwd_train(
        *map(torch.from_numpy, (xgf, xgb, wf, wb)))
    # JAX: backward direction on the flipped stream, time-major residuals
    jys_f, jys_b, jcs_f, jgs_f, jcs_b, jgs_b = _bilstm_fwd_pallas(
        jnp.asarray(xgf), jnp.flip(jnp.asarray(xgb), 1), jnp.asarray(wf),
        jnp.asarray(wb), interpret=True, save_residuals=True)

    def tm(x, flip):      # time-major (flipped) -> [B, N, *] original order
        x = np.swapaxes(np.asarray(x), 0, 1)
        return x[:, ::-1] if flip else x

    pairs = [(ys_f, np.asarray(jys_f)), (ys_b, np.asarray(jys_b)[:, ::-1]),
             (cs_f, tm(jcs_f, False)), (cs_b, tm(jcs_b, True)),
             (gs_f, tm(jgs_f, False)), (gs_b, tm(jgs_b, True))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax(shape):
    xgf, xgb, wf, wb = _inputs(*shape)
    rng = np.random.default_rng(1)
    B, N, H = shape
    dyf = rng.normal(size=(B, N, H)).astype(np.float32)
    dyb = rng.normal(size=(B, N, H)).astype(np.float32)

    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (xgf, xgb, wf, wb)]
    ys = bilstm_recurrence(*ins)
    assert type(ys[0].grad_fn).__name__ == "BiLSTMFunctionBackward"
    got = torch.autograd.grad(ys, ins, [torch.from_numpy(dyf),
                                        torch.from_numpy(dyb)])

    def loss_pallas(*a):
        f, b = bilstm_recurrence_pallas(*a, interpret=True)
        return jnp.sum(f * dyf) + jnp.sum(b * dyb)

    def loss_scan(xf, xb, w_f, w_b):
        f = lstm_recurrence_scan(xf, w_f)
        b = lstm_recurrence_scan(xb, w_b, reverse=True)
        return jnp.sum(f * dyf) + jnp.sum(b * dyb)

    jins = [jnp.asarray(a) for a in (xgf, xgb, wf, wb)]
    for loss in (loss_pallas, loss_scan):
        ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*jins)
        for name, g, r in zip(("dxg_f", "dxg_b", "dW_f", "dW_b"), got, ref):
            rel = _max_rel(g.numpy(), r)
            assert rel < GRAD_REL, (loss.__name__, name, rel)


def test_plain_function_gradcheck():
    """The hand-written backward (plain BPTT, not autograd through the
    loop) against finite differences in float64."""
    g = torch.Generator().manual_seed(0)
    B, N, H = 2, 7, 4
    ins = [torch.randn(B, N, 4 * H, generator=g, dtype=torch.float64) * 0.5,
           torch.randn(B, N, 4 * H, generator=g, dtype=torch.float64) * 0.5,
           torch.randn(H, 4 * H, generator=g, dtype=torch.float64) * 0.3,
           torch.randn(H, 4 * H, generator=g, dtype=torch.float64) * 0.3]
    ins = [t.requires_grad_(True) for t in ins]
    assert torch.autograd.gradcheck(BiLSTMFunction.apply, ins)


def test_backward_runs_the_plain_bptt(monkeypatch):
    """On the CPU the Function's backward goes through ``bilstm_bwd_plain``
    (the kernel's arithmetic), not autograd through the forward loop."""
    calls = []
    plain = rnn_cuda.bilstm_bwd_plain
    monkeypatch.setattr(rnn_cuda, "bilstm_bwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in _inputs(2, 5, 8)]
    ys_f, ys_b = bilstm_recurrence(*ins)
    (ys_f.sum() + ys_b.sum()).backward()
    assert calls == [1]
    assert all(t.grad is not None for t in ins)
