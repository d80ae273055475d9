"""The widths above H=256, which the card takes on the stream kernels, on
the port's CPU path against the JAX package: both directions of a BiLSTM
and a BiGRU layer at H=260 (the plain recurrences that those kernels are
held to on the card) against ``lstm_recurrence_scan`` /
``gru_recurrence_scan``, values at the JAX suite's float32 bound (rtol
1e-5, atol 1e-6) and all gradients at its BPTT bound (max relative error
1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops.gru_cuda import bigru_recurrence
from room_slam_torch.ops.rnn_cuda import bilstm_recurrence
from room_slam_tpu.ops.rnn import gru_recurrence_scan, lstm_recurrence_scan

RTOL, ATOL = 1e-5, 1e-6
GRAD_REL = 1e-4
B, N, H = 2, 7, 260


def _max_rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()
                 / (np.abs(ref).max() + 1e-9))


def _inputs(gates, seed=0):
    """xg and W_hh of both directions (and b_hh of each for the GRU)."""
    rng = np.random.default_rng(seed)
    G = gates * H
    x = [(rng.normal(size=(B, N, G)) * 0.5).astype(np.float32)
         for _ in range(2)]
    w = [(rng.uniform(-1, 1, size=(H, G)) / np.sqrt(H)).astype(np.float32)
         for _ in range(2)]
    if gates == 4:
        return [x[0], x[1], w[0], w[1]]
    b = [(rng.uniform(-1, 1, size=(G,)) / np.sqrt(H)).astype(np.float32)
         for _ in range(2)]
    return [x[0], x[1], w[0], b[0], w[1], b[1]]


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_wide_recurrence_matches_jax(family):
    arrs = _inputs(4 if family == "lstm" else 3)
    rng = np.random.default_rng(1)
    dys = [rng.normal(size=(B, N, H)).astype(np.float32) for _ in range(2)]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    if family == "lstm":
        ys = bilstm_recurrence(*ins)

        def jax_pair(xf, xb, wf, wb):
            return (lstm_recurrence_scan(xf, wf),
                    lstm_recurrence_scan(xb, wb, reverse=True))
    else:
        ys = bigru_recurrence(*ins)

        def jax_pair(xf, xb, wf, bf, wb, bb):
            return (gru_recurrence_scan(xf, wf, bf),
                    gru_recurrence_scan(xb, wb, bb, reverse=True))
    jins = [jnp.asarray(a) for a in arrs]
    for got, ref in zip(ys, jax_pair(*jins)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(ys, ins, [torch.from_numpy(d) for d in dys])

    def loss(*a):
        f, b = jax_pair(*a)
        return jnp.sum(f * dys[0]) + jnp.sum(b * dys[1])

    ref = jax.grad(loss, argnums=tuple(range(len(jins))))(*jins)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert _max_rel(g.numpy(), r) < GRAD_REL, (family, i)
