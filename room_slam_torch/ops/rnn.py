"""LSTM and GRU recurrences, plain PyTorch.

The input matmul ``x @ W_ih + b`` is hoisted out of the time loop by the
caller; only ``h @ W_hh`` stays sequential. LSTM gate order is torch's
``nn.LSTM`` (i, f, g, o) with one merged bias; GRU gate order is torch's
``nn.GRU`` (r, z, n) with ``b_hh`` kept apart, since the reset gate
multiplies ``W_hn h + b_hn``. The carry is float32 for any stream dtype;
outputs take the stream dtype.

These are the CPU path and what the plain versions of the recurrence
kernels (``ops/rnn_cuda.py``, ``ops/gru_cuda.py``) are built on. With
``use_kernel=True`` ``lstm_recurrence`` and ``gru_recurrence`` dispatch to
the single-direction kernels instead (``lstm_recurrence_kernel``,
``gru_recurrence_kernel``: the kernel for CUDA tensors, a hand-written
backward under grad, this plain loop for CPU tensors), as the JAX
package's ``use_pallas`` does.
"""

from __future__ import annotations

import torch


def input_gates(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """One direction's gate stream ``x @ W_ih + b`` for the whole sequence,
    ``[B, N, G]``, in the dtype of ``x``: the weights are cast to it, not
    the product, as the reference does under a compute dtype."""
    T = x.dtype
    xg = torch.addmm(b.to(T), x.flatten(0, 1), w_ih.to(T))
    return xg.view(*x.shape[:2], w_ih.shape[-1])


def lstm_cell_step(gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                   w_hh: torch.Tensor):
    """One LSTM step; ``gates`` = x_t @ W_ih + b, ``[B, 4H]``."""
    H = h.shape[-1]
    g = gates + h @ w_hh
    i = torch.sigmoid(g[..., :H])
    f = torch.sigmoid(g[..., H:2 * H])
    gg = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:])
    c_new = f * c + i * gg
    return o * torch.tanh(c_new), c_new


def lstm_recurrence(xg: torch.Tensor, w_hh: torch.Tensor,
                    reverse: bool = False,
                    use_kernel: bool = False) -> torch.Tensor:
    """Run the recurrence over ``xg [B, N, 4H]`` with ``w_hh [H, 4H]``.

    ``reverse`` walks back to front; outputs stay aligned with input
    positions (the backward half of a BiLSTM). Returns ``[B, N, H]`` in the
    stream dtype. The carries and the sums are float32 (float64 for float64
    streams); W_hh and h are rounded to the stream dtype before the dot
    product, as the Pallas kernels do (the identity for float32 streams).
    ``use_kernel`` goes through ``rnn_cuda.lstm_recurrence_kernel``.
    """
    if use_kernel:
        from room_slam_torch.ops import rnn_cuda

        return rnn_cuda.lstm_recurrence_kernel(xg, w_hh, reverse)
    B, N, _ = xg.shape
    H = w_hh.shape[0]
    T = xg.dtype
    dt = torch.promote_types(T, torch.float32)
    w = w_hh.to(T).to(dt)
    h = torch.zeros(B, H, dtype=dt, device=xg.device)
    c = torch.zeros_like(h)
    ys = [None] * N
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        h, c = lstm_cell_step(xg[:, t].to(dt), h.to(T).to(dt), c, w)
        ys[t] = h.to(T)
    if N == 0:
        return xg.new_zeros(B, 0, H)
    return torch.stack(ys, dim=1)


def gru_cell(x: torch.Tensor, h: torch.Tensor, hg: torch.Tensor):
    """One GRU step from the input gates ``x [B, 3H]``, the carry ``h``
    and the hidden gates ``hg = h @ W_hh + b_hh [B, 3H]``, all float32.
    Returns ``(h_new, r, z, n, hn)`` with ``hn = hg[:, 2H:]``."""
    H = h.shape[-1]
    r = torch.sigmoid(x[..., :H] + hg[..., :H])
    z = torch.sigmoid(x[..., H:2 * H] + hg[..., H:2 * H])
    hn = hg[..., 2 * H:]
    n = torch.tanh(x[..., 2 * H:] + r * hn)
    return (1.0 - z) * n + z * h, r, z, n, hn


def gru_recurrence(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   reverse: bool = False, residuals: bool = False,
                   use_kernel: bool = False):
    """Run the GRU recurrence over ``xg [B, N, 3H]`` (= x @ W_ih + b_ih)
    with ``w_hh [H, 3H]`` and ``b_hh [3H]``; ``reverse`` walks back to
    front with outputs aligned to input positions. Returns ``ys [B, N, H]``
    in the stream dtype; with ``residuals``, ``(ys, gates, hn)`` with the
    activated gates ``r, z, n [B, N, 3H]`` and ``hn = W_hn h + b_hn
    [B, N, H]`` in it too.

    The carry and the sums are float32 (float64 for float64 streams). W_hh
    and h are rounded to the stream dtype before the dot product, as the
    Pallas kernels do; for float32 streams that is no rounding at all.
    ``use_kernel`` goes through ``gru_cuda.gru_recurrence_kernel`` (no
    ``residuals``)."""
    if use_kernel:
        if residuals:
            raise ValueError("gru_recurrence: use_kernel returns ys only; "
                             "gru_cuda.gru_fwd_train returns the residuals")
        from room_slam_torch.ops import gru_cuda

        return gru_cuda.gru_recurrence_kernel(xg, w_hh, b_hh, reverse)
    B, N, G = xg.shape
    H = G // 3
    T = xg.dtype
    dt = torch.promote_types(T, torch.float32)
    if N == 0:
        ys = xg.new_zeros(B, 0, H)
        return (ys, xg.new_zeros(B, 0, G), xg.new_zeros(B, 0, H)) \
            if residuals else ys
    w, b = w_hh.to(T).to(dt), b_hh.to(dt)
    h = xg.new_zeros(B, H, dtype=dt)
    ys, gs, hns = [None] * N, [None] * N, [None] * N
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        h, r, z, n, hn = gru_cell(xg[:, t].to(dt), h, h.to(T).to(dt) @ w + b)
        ys[t] = h.to(T)
        if residuals:
            gs[t] = torch.cat([r, z, n], dim=-1).to(T)
            hns[t] = hn.to(T)
    if not residuals:
        return torch.stack(ys, dim=1)
    return (torch.stack(ys, dim=1), torch.stack(gs, dim=1),
            torch.stack(hns, dim=1))
