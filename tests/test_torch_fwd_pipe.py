"""The order of the sums of the forward pipe kernels (``csrc/bilstm_fwd_pipe.cu``
and ``csrc/bigru_fwd_pipe.cu``, the card's route of #1/#1t, #3/#3t, #5/#5t
and #7/#7t above H=256) against the JAX package, on the CPU: block q of a
cluster of C multiplies the whole h_{t-1} tile by its own units' slice of
W_hh as ``rnn_cuda.fwd_pipe_weights`` packs it ([C, HP, U, 4], k-major),
each of a warp's four quarters summing the rows k = p (mod 4) in rising k
with a fused multiply-add each, the quarters' partials then added pairwise,
(0 + 1) + (2 + 3), and xg (the LSTM) or b_hh (the GRU) added to the sums.
That walk, emulated in torch from the packed slices at the cluster size the
planner takes, is held to ``room_slam_tpu.ops.rnn_pallas.
lstm_recurrence_pallas`` and ``room_slam_tpu.ops.gru_pallas.
gru_recurrence_pallas`` in interpret mode (as ``tests/test_rnn_pallas.py``
runs them), both walk orders, at H=257 and 320, float32: the JAX suite's
bound (rtol 1e-5, atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import gru_cuda, rnn_cuda
from room_slam_tpu.ops.gru_pallas import gru_recurrence_pallas
from room_slam_tpu.ops.rnn_pallas import lstm_recurrence_pallas

RTOL, ATOL = 1e-5, 1e-6
B, N = 3, 6


def _resident(c, rows):
    """An H100's resident clusters of the pipe kernels: 7 of 9 to 16."""
    return 120 // c if c <= 8 else 7


def _gate_sums(h, slices):
    """The kernel's product of h [B, H] by the packed slices [C, HP, U, 4]:
    [B, C, U, 4], each quarter p's partial over k = p (mod 4) by fused
    multiply-adds in rising k (float64 products of float32 values, rounded
    once), then (p0 + p1) + (p2 + p3) in float32."""
    hp = slices.shape[1]
    hk = torch.nn.functional.pad(h, (0, hp - h.shape[1])).double()
    acc = [torch.zeros(h.shape[0], *slices.shape[0:1], *slices.shape[2:],
                       dtype=torch.float32) for _ in range(4)]
    wk = slices.double()
    for k in range(hp):
        p = k % 4
        acc[p] = (acc[p].double()
                  + hk[:, k, None, None, None] * wk[None, :, k]).float()
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _unit_sums(sums, hidden, gate):
    """Gate ``gate`` of every unit of the layer, [B, H], from the blocks'
    sums [B, C, U, 4]."""
    return sums[..., gate].reshape(sums.shape[0], -1)[:, :hidden]


def _lstm_pipe(xg, w, reverse, cluster):
    """The LSTM forward pipe kernel's walk in float32: ys [B, N, H]."""
    H = w.shape[0]
    slices = rnn_cuda.fwd_pipe_weights(w, cluster)
    h = xg.new_zeros(B, H)
    c = xg.new_zeros(B, H)
    ys = torch.empty(B, N, H)
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        sums = _gate_sums(h, slices)
        g = [xg[:, t, q * H:(q + 1) * H] + _unit_sums(sums, H, q)
             for q in range(4)]
        i, f, o = (torch.sigmoid(g[q]) for q in (0, 1, 3))
        c = f * c + i * torch.tanh(g[2])
        h = o * torch.tanh(c)
        ys[:, t] = h
    return ys


def _gru_pipe(xg, w, b, reverse, cluster):
    """The GRU forward pipe kernel's walk in float32: ys [B, N, H]."""
    H = w.shape[0]
    slices = rnn_cuda.fwd_pipe_weights(w, cluster)
    assert not slices[..., 3].any()
    h = xg.new_zeros(B, H)
    ys = torch.empty(B, N, H)
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        sums = _gate_sums(h, slices)
        hg = [_unit_sums(sums, H, q) + b[q * H:(q + 1) * H] for q in range(3)]
        r = torch.sigmoid(xg[:, t, :H] + hg[0])
        z = torch.sigmoid(xg[:, t, H:2 * H] + hg[1])
        n = torch.tanh(xg[:, t, 2 * H:] + r * hg[2])
        h = (1.0 - z) * n + z * h
        ys[:, t] = h
    return ys


def _inputs(hidden, gates, seed):
    g = np.random.default_rng(seed)
    xg = (g.normal(size=(B, N, gates * hidden)) * 0.5).astype(np.float32)
    w = (g.uniform(-1, 1, size=(hidden, gates * hidden))
         / np.sqrt(hidden)).astype(np.float32)
    b = (g.uniform(-1, 1, size=(gates * hidden,))
         / np.sqrt(hidden)).astype(np.float32)
    return xg, w, b


@pytest.mark.parametrize("hidden", [257, 320])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_fwd_pipe_sum_order_matches_jax(hidden, reverse):
    assert rnn_cuda.lstm_fwd_kernel_route(hidden) == "pipe"
    cluster, _ = rnn_cuda.fwd_pipe_plans(B, hidden, _resident, 1, 4, 4)[0]
    assert cluster > 1, cluster
    xg, w, _ = _inputs(hidden, 4, hidden + reverse)
    want = lstm_recurrence_pallas(jnp.asarray(xg), jnp.asarray(w), reverse,
                                  interpret=True)
    got = _lstm_pipe(torch.from_numpy(xg), torch.from_numpy(w), reverse,
                     cluster)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("hidden", [257, 320])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_fwd_pipe_sum_order_matches_jax(hidden, reverse):
    assert gru_cuda.gru_fwd_kernel_route(hidden, 1) == "pipe"
    cluster, _ = rnn_cuda.fwd_pipe_plans(B, hidden, _resident, 1, 4, 3)[0]
    assert cluster > 1, cluster
    xg, w, b = _inputs(hidden, 3, 7 * hidden + reverse)
    want = gru_recurrence_pallas(jnp.asarray(xg), jnp.asarray(w),
                                 jnp.asarray(b), reverse, interpret=True)
    got = _gru_pipe(torch.from_numpy(xg), torch.from_numpy(w),
                    torch.from_numpy(b), reverse, cluster)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
