"""Fused BiGRU layer recurrence: CUDA kernels, wrappers, plain versions and
the autograd ``Function`` that joins them.

``bigru_recurrence(xg_f, xg_b, w_f, b_f, w_b, b_b)`` runs both directions
of one BiGRU layer: the forward direction over ``xg_f`` and the
backward-in-time direction over ``xg_b``, both ``[B, N, 3H]`` in original
time order (gate order r, z, n), with ``w_* [H, 3H]`` and ``b_* [3H]``
(``b_hh``, kept apart from the input bias because the reset gate multiplies
``W_hn h + b_hn``, as torch's ``nn.GRU`` does). It returns ``(ys_f, ys_b)``,
each ``[B, N, H]`` in original time order and in the stream dtype. It is
the counterpart of the JAX package's ``ops/gru_pallas.py::
bigru_recurrence_pallas`` and its ``custom_vjp``.

Streams are float32 or bfloat16. Whatever the stream dtype, the carry and
every sum are float32, and values are rounded to the stream dtype where the
Pallas kernels round them: W_hh (and W_hh^T in the BPTT) and h before each
dot product, the outputs and residuals, the linearized BPTT coefficients
and the gate cotangent before the W_hh^T dot product. b_hh stays float32.

Three kernels, each with a wrapper that counts its launches and a plain
PyTorch version beside it that repeats its arithmetic:

- ``bigru_fwd`` (``csrc/bigru_fwd.cu``, light): no gradient needed;
- ``bigru_fwd_train`` (same source, residual variant): also returns the
  activated gates ``r, z, n [B, N, 3H]`` and ``hn = W_hn h + b_hn
  [B, N, H]`` per direction;
- ``bigru_bwd`` (``csrc/bigru_bwd.cu``): reverse-time BPTT from those
  residuals to ``dx [B, N, 3H]`` (the cotangent of xg) and ``dhn [B, N, H]``
  per direction.

With grad enabled and an input that requires it, ``bigru_recurrence`` goes
through ``BiGRUFunction`` (training forward, then BPTT, then ``dW_hh`` and
``db_hh`` as matmuls and sums outside the kernel); otherwise it runs the
light forward. The tensor's device picks the implementation: a CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.

At H=256 one direction's W_hh does not fit one block's shared memory, so
each kernel splits it across the blocks of a thread-block cluster
(``bigru_plan``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch
from torch.autograd.function import once_differentiable

from room_slam_torch.ops.rnn import gru_recurrence
from room_slam_torch.ops.rnn_cuda import (MAX_SMEM_BYTES, _device_type,
                                          _work_dtype, launch, prev_steps,
                                          set_error_string)

CLUSTER_SIZES = (1, 2, 4, 8)
ROWS_PER_THREAD = 4       # kRowsPerThread in csrc/bigru_*.cu
MAX_ROWS = 32             # largest batch tile one cluster takes
MAX_THREADS = 512         # __launch_bounds__ of the kernels
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


# ---------------------------------------------------------------------------
# Launch planning (mirrors smem_bytes and the grid of csrc/bigru_*.cu)
# ---------------------------------------------------------------------------


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def bigru_smem_bytes(kind: str, hidden: int, cluster: int, rows: int) -> int:
    """Dynamic shared memory one block of ``kind`` ("fwd" or "bwd") needs:
    its W_hh slice and a double-buffered exchange tile, both float32 (a
    bf16 value is exact in float32)."""
    U = hidden // cluster
    if kind == "fwd":    # W_hh[:, r|z|n of its U units] and h_{t-1} [H, R]
        return (_pad4(hidden * 3 * U) + 2 * hidden * rows) * 4
    # W_hh[its U units, :]^T and the gate cotangent dg [3H, R]
    return (_pad4(3 * hidden * U) + 2 * 3 * hidden * rows) * 4


def bigru_plan(kind: str, batch: int, hidden: int,
               resident: Callable[[int, int], int]) -> Tuple[int, int]:
    """``(cluster, rows)`` for kernel ``kind`` ("fwd" or "bwd") at this
    batch and H: the cluster size (dividing H) and batch tile (a multiple
    of ``ROWS_PER_THREAD`` up to ``MAX_ROWS``) whose W_hh slice and
    exchange tile fit one block and whose step takes least time.

    A step's time is taken as the block's thread count, at least 128 (four
    warps, one per scheduler: fewer do not finish a step sooner), times
    the waves the grid needs: ``resident(cluster, rows)`` clusters run at
    once (the card's own count, ``cudaOccupancyMaxActiveClusters``). Ties
    go to the smaller cluster, then the smaller tile. Raises for a shape no
    cluster size takes."""
    best = None
    for c in CLUSTER_SIZES:
        if hidden % c:
            continue
        for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1, ROWS_PER_THREAD):
            threads = hidden // c * (rows // ROWS_PER_THREAD)
            if (bigru_smem_bytes(kind, hidden, c, rows) > MAX_SMEM_BYTES
                    or threads > MAX_THREADS):
                continue
            at_once = resident(c, rows)
            if at_once <= 0:
                continue
            waves = -(-2 * -(-batch // rows) // at_once)
            key = (max(threads, 128) * waves, c, rows)
            best = min(best or key, key)
    if best is None:
        raise ValueError(
            f"bigru_{kind}: no cluster of {CLUSTER_SIZES} blocks takes H="
            f"{hidden} (it must divide H, and the W_hh slice plus the "
            f"exchange tile must fit {MAX_SMEM_BYTES} bytes of shared memory "
            "per block)")
    return best[1], best[2]


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and what the kernels are held against)
# ---------------------------------------------------------------------------


def bigru_fwd_plain(xg_f, xg_b, w_f, b_f, w_b, b_b
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bigru_fwd``: ``(ys_f, ys_b)``, each direction
    step for step as the kernel (``ops/rnn.py`` ``gru_recurrence``)."""
    return (gru_recurrence(xg_f, w_f, b_f),
            gru_recurrence(xg_b, w_b, b_b, reverse=True))


def bigru_fwd_train_plain(xg_f, xg_b, w_f, b_f, w_b, b_b):
    """Plain version of ``bigru_fwd_train``: ``(ys_f, ys_b, gs_f, gs_b,
    hn_f, hn_b)`` in original time order, gates activated (sigmoid r,
    sigmoid z, tanh n)."""
    ys_f, gs_f, hn_f = gru_recurrence(xg_f, w_f, b_f, residuals=True)
    ys_b, gs_b, hn_b = gru_recurrence(xg_b, w_b, b_b, reverse=True,
                                      residuals=True)
    return ys_f, ys_b, gs_f, gs_b, hn_f, hn_b


def _gru_bwd_plain(w, gs, hns, ys, dy, reverse: bool):
    """One direction of the BPTT kernel, step for step: the linearized
    coefficients of the reference (``gru_pallas.py:374-384``), rounded to
    the stream dtype, then the serial walk against the forward order."""
    B, N, G = gs.shape
    H = G // 3
    T, dt = gs.dtype, _work_dtype(gs)
    r, z, n = gs.to(dt).split(H, dim=-1)
    hp = prev_steps(ys, reverse).to(dt)
    a = (1.0 - z) * (1.0 - n * n)
    coef = torch.cat([a * hns.to(dt) * r * (1.0 - r),
                      (hp - n) * z * (1.0 - z), a], dim=-1).to(T).to(dt)
    wt = w.to(T).to(dt).t()
    dh = gs.new_zeros(B, H, dtype=dt)
    dx = torch.empty_like(gs)
    dhn = torch.empty_like(hns)
    for t in (range(N) if reverse else range(N - 1, -1, -1)):
        dh_t = dy[:, t].to(dt) + dh
        d = torch.cat([dh_t, dh_t, dh_t], dim=-1) * coef[:, t]
        dhn_t = d[:, 2 * H:] * r[:, t]
        dx[:, t] = d
        dhn[:, t] = dhn_t
        dg = torch.cat([d[:, :2 * H], dhn_t], dim=-1).to(T).to(dt)
        dh = dh_t * z[:, t] + dg @ wt
    return dx, dhn


def bigru_bwd_plain(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b):
    """Plain version of ``bigru_bwd``: ``(dx_f, dhn_f, dx_b, dhn_b)`` from
    the training forward's gates, hn and ys and the upstream ``dy``."""
    return (*_gru_bwd_plain(w_f, gs_f, hn_f, ys_f, dy_f, reverse=False),
            *_gru_bwd_plain(w_b, gs_b, hn_b, ys_b, dy_b, reverse=True))


# ---------------------------------------------------------------------------
# Device dispatch and the autograd Function
# ---------------------------------------------------------------------------


def _check_shapes(xg_f, xg_b, w_f, b_f, w_b, b_b) -> None:
    if xg_f.dim() != 3 or xg_f.shape != xg_b.shape:
        raise ValueError(f"xg_f {tuple(xg_f.shape)} and xg_b "
                         f"{tuple(xg_b.shape)} must both be [B, N, 3H]")
    H = w_f.shape[0]
    if w_f.shape != (H, 3 * H) or w_b.shape != w_f.shape \
            or xg_f.shape[-1] != 3 * H:
        raise ValueError(f"w_f {tuple(w_f.shape)} / w_b {tuple(w_b.shape)} "
                         f"must be [H, 3H] with 3H == {xg_f.shape[-1]}")
    if b_f.shape != (3 * H,) or b_b.shape != (3 * H,):
        raise ValueError(f"b_f {tuple(b_f.shape)} / b_b {tuple(b_b.shape)} "
                         f"must be [3H] = [{3 * H}]")


def bigru_fwd_train(xg_f, xg_b, w_f, b_f, w_b, b_b):
    """Training forward: ``(ys_f, ys_b, gs_f, gs_b, hn_f, hn_b)``; CUDA
    tensors launch ``bigru_fwd_train``, CPU tensors take the plain
    version."""
    ins = (xg_f, xg_b, w_f, b_f, w_b, b_b)
    if _device_type("bigru_fwd_train", *ins) == "cpu":
        return bigru_fwd_train_plain(*ins)
    return bigru_fwd_train_cuda(*ins)


def bigru_bwd(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b):
    """BPTT of both directions: ``(dx_f, dhn_f, dx_b, dhn_b)``; CUDA
    tensors launch ``bigru_bwd``, CPU tensors take the plain version."""
    ins = (w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)
    if _device_type("bigru_bwd", *ins) == "cpu":
        return bigru_bwd_plain(*ins)
    return bigru_bwd_cuda(*ins)


def hidden_grads(ys, dx, dhn, reverse: bool, dtype: torch.dtype):
    """``dW_hh = h_prev^T [dx_r, dx_z, dhn]`` and ``db_hh = sum [dx_r,
    dx_z, dhn]`` of one direction, accumulated in float32 (float64 for
    float64 streams) and returned in ``dtype``. Two products instead of a
    ``[B, N, 3H]`` concatenation, as the reference does (``:582-594``)."""
    H = ys.shape[-1]
    acc = _work_dtype(ys)
    hp = prev_steps(ys, reverse).reshape(-1, H).to(acc)
    d2 = dx[..., :2 * H].reshape(-1, 2 * H).to(acc)
    dn = dhn.reshape(-1, H).to(acc)
    dw = torch.cat([hp.t() @ d2, hp.t() @ dn], dim=-1)
    db = torch.cat([d2.sum(0), dn.sum(0)])
    return dw.to(dtype), db.to(dtype)


class BiGRUFunction(torch.autograd.Function):
    """One BiGRU layer's recurrence with its hand-written backward
    (counterpart of ``_bigru_core`` with ``_bigru_core_fwd`` and
    ``_bigru_core_bwd``). Inputs and outputs as ``bigru_recurrence``;
    gradients: dxg in the stream dtype, dW_hh and db_hh in W_hh's dtype."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, w_f, b_f, w_b, b_b):
        ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = bigru_fwd_train(
            xg_f, xg_b, w_f, b_f, w_b, b_b)
        ctx.save_for_backward(w_f, w_b, ys_f, ys_b, gs_f, gs_b, hn_f, hn_b)
        return ys_f, ys_b

    @staticmethod
    @once_differentiable
    def backward(ctx, dy_f, dy_b):
        # autograd hands zeros for an output that got no gradient; the
        # halves of a concatenation arrive as strided views
        w_f, w_b, ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = ctx.saved_tensors
        T = ys_f.dtype
        dx_f, dhn_f, dx_b, dhn_b = bigru_bwd(
            w_f, w_b, gs_f, hn_f, ys_f, dy_f.to(T).contiguous(),
            gs_b, hn_b, ys_b, dy_b.to(T).contiguous())
        dw_f, db_f = hidden_grads(ys_f, dx_f, dhn_f, False, w_f.dtype)
        dw_b, db_b = hidden_grads(ys_b, dx_b, dhn_b, True, w_b.dtype)
        return dx_f, dx_b, dw_f, db_f, dw_b, db_b


def bigru_recurrence(xg_f: torch.Tensor, xg_b: torch.Tensor,
                     w_f: torch.Tensor, b_f: torch.Tensor,
                     w_b: torch.Tensor, b_b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of one BiGRU layer (see module docstring)."""
    tensors = (xg_f, xg_b, w_f, b_f, w_b, b_b)
    _check_shapes(*tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return BiGRUFunction.apply(*tensors)
    if _device_type("bigru_recurrence", *tensors) == "cpu":
        return bigru_fwd_plain(*tensors)
    return bigru_fwd_cuda(*tensors)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _library(name: str):
    from room_slam_torch.ops.build import load_library

    lib = load_library(name)
    if getattr(lib, "_argtypes_set", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd = name == "bigru_fwd"
    for sfx in _SUFFIX.values():
        if fwd:
            fns = {f"bigru_fwd_{sfx}": 8, f"bigru_fwd_train_{sfx}": 12}
        else:
            fns = {f"bigru_bwd_{sfx}": 14}
        for fn_name, n_ptr in fns.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = [p] * n_ptr + [i] * 5 + [p]
            fn.restype = ctypes.c_int
    clusters = getattr(lib, f"{name}_max_active_clusters")
    clusters.argtypes = [i] * (5 if fwd else 4)   # fwd: also the kSave flag
    clusters.restype = ctypes.c_int
    set_error_string(lib, name)
    return lib


def _check_cuda(name, streams, weights, biases) -> torch.device:
    tensors = (*streams, *weights, *biases)
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    T = streams[0].dtype
    if T not in _SUFFIX or any(t.dtype != T for t in streams):
        raise TypeError(f"{name} takes float32 or bfloat16 streams of one "
                        f"dtype, got {[t.dtype for t in streams]}")
    if any(t.dtype not in (torch.float32, T) for t in weights) \
            or any(t.dtype != torch.float32 for t in biases):
        raise TypeError(f"{name}: W_hh must be float32 or the stream dtype "
                        "and b_hh float32, got "
                        f"{[t.dtype for t in (*weights, *biases)]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return dev


def _plan_launch(kind: str, fn, B: int, H: int, dev: torch.device, T):
    """The launch's ``(cluster, rows)`` from ``bigru_plan`` with the card's
    own count of clusters it runs at once, recorded with the number of the
    grid's clusters in ``fn.last_launch``."""
    lib = _library(f"bigru_{kind}")
    query = getattr(lib, f"bigru_{kind}_max_active_clusters")
    save = int(fn is bigru_fwd_train_cuda)
    flags = (int(T == torch.bfloat16),) + ((save,) if kind == "fwd" else ())

    def resident(c, rows):
        with torch.cuda.device(dev):
            return query(*flags, H, c, rows)

    key = (kind, B, H, str(dev), T, save)
    if key not in _PLANS:
        cluster, rows = bigru_plan(kind, B, H, resident)
        _PLANS[key] = {"cluster": cluster, "rows": rows,
                       "clusters": 2 * -(-B // rows),
                       "resident": resident(cluster, rows)}
    fn.last_launch = _PLANS[key]
    return lib, fn.last_launch["cluster"], fn.last_launch["rows"]


_PLANS: dict = {}     # launch plans by kernel, shape, device and dtype


def _fwd_launch(fn, save: bool, xg_f, xg_b, w_f, b_f, w_b, b_b):
    ins = (xg_f, xg_b, w_f, b_f, w_b, b_b)
    _check_shapes(*ins)
    name = "bigru_fwd_train" if save else "bigru_fwd"
    dev = _check_cuda(name, (xg_f, xg_b), (w_f, w_b), (b_f, b_b))
    B, N, G = xg_f.shape
    H = G // 3
    T = xg_f.dtype
    outs = [torch.empty(B, N, d, dtype=T, device=dev)
            for d in ((H, H, G, G, H, H) if save else (H, H))]
    if B == 0 or N == 0:
        return tuple(outs)
    lib, cluster, rows = _plan_launch("fwd", fn, B, H, dev, T)
    w_f, w_b = w_f.to(T).contiguous(), w_b.to(T).contiguous()
    launch(lib, f"{name}_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (xg_f, xg_b, w_f, b_f, w_b, b_b)),
           *(o.data_ptr() for o in outs), B, N, H, cluster, rows)
    fn.launches += 1
    return tuple(outs)


def bigru_fwd_cuda(xg_f, xg_b, w_f, b_f, w_b, b_b
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the light kernel of ``csrc/bigru_fwd.cu`` on the current
    stream: ``(ys_f, ys_b)``. Counts each launch in
    ``bigru_fwd_cuda.launches``. Its outputs carry no autograd history:
    ``bigru_recurrence`` sends inputs that need a gradient to
    ``BiGRUFunction`` instead."""
    return _fwd_launch(bigru_fwd_cuda, False, xg_f, xg_b, w_f, b_f, w_b, b_b)


bigru_fwd_cuda.launches = 0


def bigru_fwd_train_cuda(xg_f, xg_b, w_f, b_f, w_b, b_b):
    """Launch the residual variant of ``csrc/bigru_fwd.cu``: ``(ys_f, ys_b,
    gs_f, gs_b, hn_f, hn_b)``. Counts each launch in
    ``bigru_fwd_train_cuda.launches``."""
    return _fwd_launch(bigru_fwd_train_cuda, True, xg_f, xg_b, w_f, b_f, w_b,
                       b_b)


bigru_fwd_train_cuda.launches = 0


def bigru_bwd_cuda(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b):
    """Launch ``csrc/bigru_bwd.cu``: ``(dx_f, dhn_f, dx_b, dhn_b)``. Counts
    each launch in ``bigru_bwd_cuda.launches``."""
    H = w_f.shape[0]
    B, N, G = gs_f.shape
    shapes = [tuple(t.shape) for t in (w_f, w_b, gs_f, gs_b, hn_f, ys_f,
                                        dy_f, hn_b, ys_b, dy_b)]
    if shapes != [(H, 3 * H)] * 2 + [(B, N, 3 * H)] * 2 + [(B, N, H)] * 6:
        raise ValueError("bigru_bwd: w_* must be [H, 3H], gs_* [B, N, 3H] "
                         f"and hn_*, ys_*, dy_* [B, N, H]; got {shapes}")
    streams = (gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)
    dev = _check_cuda("bigru_bwd", streams, (w_f, w_b), ())
    T = gs_f.dtype
    outs = [torch.empty(B, N, d, dtype=T, device=dev) for d in (G, H, G, H)]
    if B == 0 or N == 0:
        return tuple(outs)
    lib, cluster, rows = _plan_launch("bwd", bigru_bwd_cuda, B, H, dev, T)
    w_f, w_b = w_f.to(T).contiguous(), w_b.to(T).contiguous()
    launch(lib, f"bigru_bwd_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (w_f, w_b, *streams)),
           *(o.data_ptr() for o in outs), B, N, H, cluster, rows)
    bigru_bwd_cuda.launches += 1
    return tuple(outs)


bigru_bwd_cuda.launches = 0
