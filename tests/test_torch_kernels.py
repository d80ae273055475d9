"""Port's BiLSTM recurrence (plain path, CPU) against the JAX package:
``bilstm_recurrence_pallas`` in interpret mode and two ``lstm_recurrence_scan``
calls, at the JAX suite's own f32 tolerance (rtol 1e-5, atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import rnn_cuda
from room_slam_torch.ops.rnn import lstm_recurrence
from room_slam_torch.ops.rnn_cuda import (bilstm_recurrence,
                                          bilstm_smem_bytes)
from room_slam_tpu.ops.rnn import lstm_recurrence_scan
from room_slam_tpu.ops.rnn_pallas import bilstm_recurrence_pallas

RTOL, ATOL = 1e-5, 1e-6


def _inputs(B, N, H, seed=0):
    rng = np.random.default_rng(seed)
    xgf = (rng.normal(size=(B, N, 4 * H)) * 0.5).astype(np.float32)
    xgb = (rng.normal(size=(B, N, 4 * H)) * 0.5).astype(np.float32)
    wf = (rng.normal(size=(H, 4 * H)) * 0.1).astype(np.float32)
    wb = (rng.normal(size=(H, 4 * H)) * 0.1).astype(np.float32)
    return xgf, xgb, wf, wb


@pytest.mark.parametrize("shape", [(3, 53, 16), (5, 43, 16), (2, 1, 8),
                                   (2, 33, 8)])
def test_bilstm_plain_matches_jax(shape):
    B, N, H = shape
    xgf, xgb, wf, wb = _inputs(B, N, H)
    before = rnn_cuda.bilstm_fwd_cuda.launches
    got_f, got_b = bilstm_recurrence(*map(torch.from_numpy,
                                          (xgf, xgb, wf, wb)))
    assert rnn_cuda.bilstm_fwd_cuda.launches == before  # CPU: no kernel
    assert got_f.shape == got_b.shape == (B, N, H)

    pal_f, pal_b = bilstm_recurrence_pallas(
        jnp.asarray(xgf), jnp.asarray(xgb), jnp.asarray(wf), jnp.asarray(wb),
        interpret=True)
    scan_f = lstm_recurrence_scan(jnp.asarray(xgf), jnp.asarray(wf))
    scan_b = lstm_recurrence_scan(jnp.asarray(xgb), jnp.asarray(wb),
                                  reverse=True)
    for got, ref in ((got_f, pal_f), (got_b, pal_b), (got_f, scan_f),
                     (got_b, scan_b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_recurrence_bf16_stream_keeps_f32_carry(reverse):
    """bf16 gate stream: outputs come back in bf16, the carry stays f32 —
    the scan reference's contract (bf16 tolerance of the JAX suite)."""
    xg, _, w, _ = _inputs(2, 17, 8, seed=1)
    got = lstm_recurrence(torch.from_numpy(xg).to(torch.bfloat16),
                          torch.from_numpy(w), reverse=reverse)
    assert got.dtype == torch.bfloat16
    ref = lstm_recurrence_scan(jnp.asarray(xg, jnp.bfloat16),
                               jnp.asarray(w), reverse=reverse)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=0.05, atol=0.03)


def test_bilstm_wrapper_checks_shapes():
    xgf, xgb, wf, wb = map(torch.from_numpy, _inputs(2, 5, 8))
    with pytest.raises(ValueError):
        bilstm_recurrence(xgf, xgb[:, :4], wf, wb)
    with pytest.raises(ValueError):
        bilstm_recurrence(xgf, xgb, wf[:4], wb)
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_fwd_cuda(xgf, xgb, wf, wb)   # CPU tensors


def test_bilstm_kernel_refuses_grad():
    """The light kernel never sees an input that needs a gradient: with
    grad on, ``bilstm_recurrence`` routes it to ``BiLSTMFunction`` (on the
    CPU its plain training forward, no kernel launch), whose outputs stay
    in the graph. The light wrapper itself takes CUDA tensors only."""
    xgf, xgb, wf, wb = map(torch.from_numpy, _inputs(2, 5, 8))
    wf.requires_grad_(True)
    counts = (rnn_cuda.bilstm_fwd_cuda.launches,
              rnn_cuda.bilstm_fwd_train_cuda.launches)
    ys_f, ys_b = bilstm_recurrence(xgf, xgb, wf, wb)
    assert type(ys_f.grad_fn).__name__ == "BiLSTMFunctionBackward"
    assert (rnn_cuda.bilstm_fwd_cuda.launches,
            rnn_cuda.bilstm_fwd_train_cuda.launches) == counts
    with torch.no_grad():
        assert bilstm_recurrence(xgf, xgb, wf, wb)[0].grad_fn is None
    with pytest.raises(ValueError, match="CUDA"):
        rnn_cuda.bilstm_fwd_cuda(xgf, xgb, wf, wb)


def test_bilstm_smem_budget():
    """At the flagship H=64 W_hh (64 KiB) plus the carries fit one block's
    227 KB; H=128 does not (it needs a cluster split)."""
    assert bilstm_smem_bytes(64) == (64 * 256 + 4 * 256 + 4 * 64) * 4
    assert bilstm_smem_bytes(64) <= rnn_cuda.MAX_SMEM_BYTES
    assert bilstm_smem_bytes(128) > rnn_cuda.MAX_SMEM_BYTES
