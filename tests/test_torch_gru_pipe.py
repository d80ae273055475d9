"""The order of the sums of the GRU BPTT's pipe kernel (``csrc/bigru_pipe.cu``,
the card's route of #6 and #8 above H=256) against the JAX package, on the
CPU: each block of a cluster of C multiplies its own units' T([dx_r, dx_z,
dhn]) by its own slice of W_hh as ``rnn_cuda.pipe_weights`` packs it, the
owner sums the C float32 partials of a cell in rank order, then adds
dh_t * z. That walk, emulated in torch from the packed slices at the
cluster size the planner takes, with dW_hh and db_hh from
``gru_cuda.hidden_grads``, is held to the VJP of
``room_slam_tpu.ops.gru_pallas.gru_recurrence_pallas`` in interpret mode
(as ``tests/test_rnn_pallas.py`` runs it), both walk orders, at H=257 and
320, float32: the JAX suite's bound (rtol 1e-5, atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from room_slam_torch.ops import gru_cuda, rnn_cuda
from room_slam_tpu.ops.gru_pallas import gru_recurrence_pallas

RTOL, ATOL = 1e-5, 1e-6
B, N = 3, 6


def _resident(c, rows):
    """An H100's resident clusters of the pipe kernel: 7 of 9 to 16."""
    return 120 // c if c <= 8 else 7


def _pipe_bptt(w, gs, hns, ys, dy, reverse, cluster):
    """The pipe kernel's walk in float32 (T() is the identity): kLinear's
    coefficients, dx and dhn per cell, then dh_carry as the C blocks'
    partials over their packed slices, summed in rank order, plus dh_t z.
    Returns ``(dx, dhn)``."""
    H = w.shape[0]
    r, z, n = gs.split(H, dim=-1)
    hp = rnn_cuda.prev_steps(ys, reverse)
    packed = rnn_cuda.pipe_weights(w, cluster)     # [C, 3, U, HP]
    U = packed.shape[2]
    slices = packed.reshape(cluster, 3 * U, -1)
    a = (1.0 - z) * (1.0 - n * n)
    c_r, c_z = a * hns * r * (1.0 - r), (hp - n) * z * (1.0 - z)
    dh = gs.new_zeros(B, H)
    dhz = gs.new_zeros(B, H)
    dx, dhn = torch.empty_like(gs), torch.empty_like(ys)
    for t in (range(N) if reverse else range(N - 1, -1, -1)):
        dh_t = dy[:, t] + (dhz + dh)
        dx[:, t] = torch.cat([dh_t * c_r[:, t], dh_t * c_z[:, t],
                              dh_t * a[:, t]], dim=-1)
        dhn[:, t] = dx[:, t, 2 * H:] * r[:, t]
        dhz = dh_t * z[:, t]
        dg = torch.cat([dx[:, t, :2 * H], dhn[:, t]], dim=-1)
        # block q's gate columns g * H + q * U + u, zero past H
        dgq = F.pad(dg.view(B, 3, H), (0, cluster * U - H)).view(
            B, 3, cluster, U)
        dh = None
        for q in range(cluster):
            part = dgq[:, :, q].reshape(B, 3 * U) @ slices[q]
            dh = part if dh is None else dh + part
        dh = dh[:, :H]
    return dx, dhn


@pytest.mark.parametrize("hidden", [257, 320])
@pytest.mark.parametrize("reverse", [False, True])
def test_pipe_sum_order_matches_jax(hidden, reverse):
    assert gru_cuda.gru_bwd_kernel_route(hidden, 1) == "pipe"
    cluster, _ = rnn_cuda.pipe_plans(B, hidden, _resident, 1, 4, 3)[0]
    assert cluster > 1, cluster
    g = np.random.default_rng(hidden + reverse)
    xg = (g.normal(size=(B, N, 3 * hidden)) * 0.5).astype(np.float32)
    w = (g.uniform(-1, 1, size=(hidden, 3 * hidden))
         / np.sqrt(hidden)).astype(np.float32)
    b = (g.uniform(-1, 1, size=(3 * hidden,))
         / np.sqrt(hidden)).astype(np.float32)
    dy = g.normal(size=(B, N, hidden)).astype(np.float32)

    ys_j, vjp = jax.vjp(
        lambda a, ww, bb: gru_recurrence_pallas(a, ww, bb, reverse,
                                                interpret=True),
        jnp.asarray(xg), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))

    tw, tdy = torch.from_numpy(w), torch.from_numpy(dy)
    ys, gs, hns = gru_cuda.gru_fwd_train_plain(
        torch.from_numpy(xg), tw, torch.from_numpy(b), reverse)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=RTOL,
                               atol=ATOL)
    dx, dhn = _pipe_bptt(tw, gs, hns, ys, tdy, reverse, cluster)
    dw, db = gru_cuda.hidden_grads(ys, dx, dhn, reverse, torch.float32)
    for name, got, ref in (("dxg", dx, want[0]), ("dW_hh", dw, want[1]),
                           ("db_hh", db, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
