"""LSTM and GRU recurrences, plain PyTorch.

The input matmul ``x @ W_ih + b`` is hoisted out of the time loop by the
caller; only ``h @ W_hh`` stays sequential. LSTM gate order is torch's
``nn.LSTM`` (i, f, g, o) with one merged bias; GRU gate order is torch's
``nn.GRU`` (r, z, n) with ``b_hh`` kept apart, since the reset gate
multiplies ``W_hn h + b_hn``. The carry is float32 for any stream dtype;
outputs take the stream dtype.

These are the CPU path and what the plain versions of the recurrence
kernels (``ops/rnn_cuda.py``, ``ops/gru_cuda.py``) are built on.
"""

from __future__ import annotations

import torch


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
                    reverse: bool = False) -> torch.Tensor:
    """Run the recurrence over ``xg [B, N, 4H]`` with ``w_hh [H, 4H]``.

    ``reverse`` walks back to front; outputs stay aligned with input
    positions (the backward half of a BiLSTM). Returns ``[B, N, H]``.
    """
    B, N, _ = xg.shape
    H = w_hh.shape[0]
    w = w_hh.float()
    h = torch.zeros(B, H, dtype=torch.float32, device=xg.device)
    c = torch.zeros_like(h)
    ys = [None] * N
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        h, c = lstm_cell_step(xg[:, t].float(), h, c, w)
        ys[t] = h.to(xg.dtype)
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
                   reverse: bool = False, residuals: bool = False):
    """Run the GRU recurrence over ``xg [B, N, 3H]`` (= x @ W_ih + b_ih)
    with ``w_hh [H, 3H]`` and ``b_hh [3H]``; ``reverse`` walks back to
    front with outputs aligned to input positions. Returns ``ys [B, N, H]``
    in the stream dtype; with ``residuals``, ``(ys, gates, hn)`` with the
    activated gates ``r, z, n [B, N, 3H]`` and ``hn = W_hn h + b_hn
    [B, N, H]`` in it too.

    The carry and the sums are float32 (float64 for float64 streams). W_hh
    and h are rounded to the stream dtype before the dot product, as the
    Pallas kernels do; for float32 streams that is no rounding at all."""
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
