"""The order of the sums of the GRU BPTT's register cluster kernel
(``csrc/bigru_bwd_reg.cu``, the card's route of #6 and #8 at H 65-256)
against the JAX package, on the CPU: each block of a cluster of C forms the
partial dh of every k from its own units' T([dx_r, dx_z, dhn]) and its own
gate columns of W_hh (a K-split), the owner sums the C float32 partials of
a cell in rank order, then adds dh_t * z. That walk, emulated in torch at
the cluster size the planner takes (a masked last slice at H=255), with
dW_hh and db_hh from ``gru_cuda.hidden_grads``, is held to the VJP of
``room_slam_tpu.ops.gru_pallas.gru_recurrence_pallas`` (one direction,
both walk orders, H=128 and 255) and ``bigru_recurrence_pallas`` (both
directions at once, H=255) in interpret mode, float32: the JAX suite's
bound (rtol 1e-5, atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import gru_cuda, rnn_cuda
from room_slam_tpu.ops.gru_pallas import (bigru_recurrence_pallas,
                                          gru_recurrence_pallas)

RTOL, ATOL = 1e-5, 1e-6
B, N = 3, 6


def _resident(c, rows):
    """An H100's resident clusters of the register kernels: 7 of 9 to
    16."""
    return 120 // c if c <= 8 else 7


def _reg_bptt(w, gs, hns, ys, dy, reverse, cluster):
    """The register kernel's walk in float32 (T() is the identity):
    kLinear's coefficients, dx and dhn per cell, then dh_carry as the C
    blocks' partials over their own gate columns (block q's units q * U ..
    q * U + U - 1, masked past H), summed in rank order, plus dh_t z.
    Returns ``(dx, dhn)``."""
    H = w.shape[0]
    U = rnn_cuda.reg_units("bwd", H, cluster)
    assert (cluster - 1) * U < H <= cluster * U
    cols = [torch.tensor([g * H + u for g in range(3)
                          for u in range(q * U, min(q * U + U, H))])
            for q in range(cluster)]
    r, z, n = gs.split(H, dim=-1)
    hp = rnn_cuda.prev_steps(ys, reverse)
    a = (1.0 - z) * (1.0 - n * n)
    c_r, c_z = a * hns * r * (1.0 - r), (hp - n) * z * (1.0 - z)
    dh = gs.new_zeros(B, H)
    dhz = gs.new_zeros(B, H)
    dx, dhn = torch.empty_like(gs), torch.empty_like(ys)
    for t in (range(N) if reverse else range(N - 1, -1, -1)):
        dh_t = dy[:, t] + (dh + dhz)
        dx[:, t] = torch.cat([dh_t * c_r[:, t], dh_t * c_z[:, t],
                              dh_t * a[:, t]], dim=-1)
        dhn[:, t] = dx[:, t, 2 * H:] * r[:, t]
        dhz = dh_t * z[:, t]
        dg = torch.cat([dx[:, t, :2 * H], dhn[:, t]], dim=-1)
        dh = None
        for c in cols:
            part = dg[:, c] @ w[:, c].t()
            dh = part if dh is None else dh + part
    return dx, dhn


def _inputs(hidden, seed):
    g = np.random.default_rng(seed)
    xg = (g.normal(size=(B, N, 3 * hidden)) * 0.5).astype(np.float32)
    w = (g.uniform(-1, 1, size=(hidden, 3 * hidden))
         / np.sqrt(hidden)).astype(np.float32)
    b = (g.uniform(-1, 1, size=(3 * hidden,))
         / np.sqrt(hidden)).astype(np.float32)
    dy = g.normal(size=(B, N, hidden)).astype(np.float32)
    return xg, w, b, dy


def _grads(xg, w, b, dy, reverse, cluster):
    """The training forward's plain version, then the emulated walk and
    the hidden-side gradients: ``(ys, dxg, dW_hh, db_hh)``."""
    tw = torch.from_numpy(w)
    ys, gs, hns = gru_cuda.gru_fwd_train_plain(
        torch.from_numpy(xg), tw, torch.from_numpy(b), reverse)
    dx, dhn = _reg_bptt(tw, gs, hns, ys, torch.from_numpy(dy), reverse,
                        cluster)
    dw, db = gru_cuda.hidden_grads(ys, dx, dhn, reverse, torch.float32)
    return ys, dx, dw, db


def _close(got, want, names):
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("hidden,grid", [
    (128, "one"), (128, "one_reverse"), (255, "one"), (255, "one_reverse"),
    (255, "two")])
def test_reg_sum_order_matches_jax(hidden, grid):
    dirs = 2 if grid == "two" else 1
    assert gru_cuda.gru_bwd_kernel_route(hidden, dirs) == "reg"
    cluster, _ = gru_cuda.bigru_reg_plan("bwd", B, hidden, _resident, dirs)
    assert cluster > 1, cluster
    xg, w, b, dy = _inputs(hidden, hidden + len(grid))
    names = ("ys", "dxg", "dW_hh", "db_hh")
    if grid != "two":
        reverse = grid == "one_reverse"
        ys_j, vjp = jax.vjp(
            lambda a, ww, bb: gru_recurrence_pallas(a, ww, bb, reverse,
                                                    interpret=True),
            jnp.asarray(xg), jnp.asarray(w), jnp.asarray(b))
        _close(_grads(xg, w, b, dy, reverse, cluster),
               (ys_j, *vjp(jnp.asarray(dy))), names)
        return
    xg_b, w_b, b_b, dy_b = _inputs(hidden, hidden + 7)
    (ys_f, ys_b), vjp = jax.vjp(
        lambda a, c, wf, bf, wb, bb: bigru_recurrence_pallas(
            a, c, wf, bf, wb, bb, interpret=True),
        *(jnp.asarray(v) for v in (xg, xg_b, w, b, w_b, b_b)))
    dxf, dxb, dwf, dbf, dwb, dbb = vjp((jnp.asarray(dy), jnp.asarray(dy_b)))
    _close(_grads(xg, w, b, dy, False, cluster), (ys_f, dxf, dwf, dbf),
           [f"{n}_f" for n in names])
    _close(_grads(xg_b, w_b, b_b, dy_b, True, cluster),
           (ys_b, dxb, dwb, dbb), [f"{n}_b" for n in names])
