"""Fused BiLSTM layer recurrence: CUDA kernels, wrappers, plain versions and
the autograd ``Function`` that joins them.

``bilstm_recurrence(xg_f, xg_b, w_f, w_b)`` runs both directions of one
BiLSTM layer: the forward direction over ``xg_f`` and the backward-in-time
direction over ``xg_b``, both ``[B, N, 4H]`` in original time order, with
``w_* [H, 4H]``; it returns ``(ys_f, ys_b)``, each ``[B, N, H]`` in
original time order. It is the counterpart of the JAX package's
``ops/rnn_pallas.py::bilstm_recurrence_pallas`` and its ``custom_vjp``.

Three kernels, each with a wrapper that counts its launches and a plain
PyTorch version beside it:

- ``bilstm_fwd`` (``csrc/bilstm_fwd.cu``, light): no gradient needed;
- ``bilstm_fwd_train`` (same source, residual variant): also returns
  ``c_t [B, N, H]`` and the activated gates ``[B, N, 4H]`` per direction;
- ``bilstm_bwd`` (``csrc/bilstm_bwd.cu``): reverse-time BPTT from those
  residuals to the gate cotangent ``dg [B, N, 4H]`` per direction.

With grad enabled and an input that requires it, ``bilstm_recurrence``
goes through ``BiLSTMFunction`` (training forward, then BPTT and
``dW_hh = sum_t h_{t-1}^T dg_t`` as one matmul); otherwise it runs the
light forward. The tensor's device picks the implementation: a CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.
Nothing routes a CUDA tensor to a plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from room_slam_torch.ops.rnn import lstm_recurrence

# Largest dynamic shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232448
_ROWS_PER_BLOCK = 4   # kRows in csrc/bilstm_fwd.cu and csrc/bilstm_bwd.cu


def bilstm_smem_bytes(hidden: int) -> int:
    """Shared memory one block of the forward kernels needs (mirrors
    ``smem_bytes`` in ``csrc/bilstm_fwd.cu``)."""
    G = 4 * hidden
    return (hidden * G + _ROWS_PER_BLOCK * G + _ROWS_PER_BLOCK * hidden) * 4


def bilstm_bwd_smem_bytes(hidden: int) -> int:
    """Shared memory one block of the backward kernel needs (mirrors
    ``smem_bytes`` in ``csrc/bilstm_bwd.cu``): W_hh^T and a double-buffered
    dg tile."""
    G = 4 * hidden
    return (G * hidden + 2 * _ROWS_PER_BLOCK * G) * 4


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and what the kernels are held against)
# ---------------------------------------------------------------------------


def bilstm_recurrence_plain(xg_f: torch.Tensor, xg_b: torch.Tensor,
                            w_f: torch.Tensor, w_b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bilstm_fwd``: two single-direction recurrences."""
    return (lstm_recurrence(xg_f, w_f, reverse=False),
            lstm_recurrence(xg_b, w_b, reverse=True))


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 for float32 and narrower streams, float64 for float64 (the
    gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _lstm_fwd_train_plain(xg: torch.Tensor, w: torch.Tensor, reverse: bool):
    B, N, G = xg.shape
    H = G // 4
    dt = _work_dtype(xg)
    w = w.to(dt)
    h = xg.new_zeros(B, H, dtype=dt)
    c = torch.zeros_like(h)
    ys = xg.new_empty(B, N, H, dtype=dt)
    cs = torch.empty_like(ys)
    gs = xg.new_empty(B, N, G, dtype=dt)
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        g = xg[:, t].to(dt) + h @ w
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        gg = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        ys[:, t] = h
        cs[:, t] = c
        gs[:, t] = torch.cat([i, f, gg, o], dim=-1)
    return ys, cs, gs


def bilstm_fwd_train_plain(xg_f: torch.Tensor, xg_b: torch.Tensor,
                           w_f: torch.Tensor, w_b: torch.Tensor):
    """Plain version of ``bilstm_fwd_train``: returns
    ``(ys_f, ys_b, cs_f, cs_b, gs_f, gs_b)`` in original time order, gates
    activated (sigmoid i, sigmoid f, tanh g, sigmoid o)."""
    ys_f, cs_f, gs_f = _lstm_fwd_train_plain(xg_f, w_f, reverse=False)
    ys_b, cs_b, gs_b = _lstm_fwd_train_plain(xg_b, w_b, reverse=True)
    return ys_f, ys_b, cs_f, cs_b, gs_f, gs_b


def _lstm_bwd_plain(w, gs, cs, dy, reverse: bool) -> torch.Tensor:
    """One direction of the kernel's BPTT, step for step: the linearized
    coefficients of the reference, then the serial walk against the
    direction's forward order."""
    B, N, G = gs.shape
    H = G // 4
    i, f, gg, o = gs.split(H, dim=-1)
    cp = prev_steps(cs, reverse)
    tanh_c = torch.tanh(cs)
    c_c = o * (1.0 - tanh_c * tanh_c)
    c4 = torch.cat([gg * i * (1.0 - i), cp * f * (1.0 - f),
                    i * (1.0 - gg * gg), tanh_c * o * (1.0 - o)], dim=-1)
    wt = w.to(gs.dtype).t()
    dh = gs.new_zeros(B, H)
    dc = torch.zeros_like(dh)
    dg = torch.empty_like(gs)
    for t in (range(N) if reverse else range(N - 1, -1, -1)):
        dh_t = dy[:, t] + dh
        dc_t = dc + dh_t * c_c[:, t]
        d = torch.cat([dc_t, dc_t, dc_t, dh_t], dim=-1) * c4[:, t]
        dg[:, t] = d
        dh = d @ wt
        dc = dc_t * f[:, t]
    return dg


def bilstm_bwd_plain(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bilstm_bwd``: ``(dg_f, dg_b)``, each
    ``[B, N, 4H]``, from the training forward's gates and c and the
    upstream ``dy``."""
    return (_lstm_bwd_plain(w_f, gs_f, cs_f, dy_f, reverse=False),
            _lstm_bwd_plain(w_b, gs_b, cs_b, dy_b, reverse=True))


# ---------------------------------------------------------------------------
# Device dispatch and the autograd Function
# ---------------------------------------------------------------------------


def _check_shapes(xg_f, xg_b, w_f, w_b) -> None:
    if xg_f.dim() != 3 or xg_f.shape != xg_b.shape:
        raise ValueError(f"xg_f {tuple(xg_f.shape)} and xg_b "
                         f"{tuple(xg_b.shape)} must both be [B, N, 4H]")
    H = w_f.shape[0]
    if w_f.shape != (H, 4 * H) or w_b.shape != w_f.shape \
            or xg_f.shape[-1] != 4 * H:
        raise ValueError(f"w_f {tuple(w_f.shape)} / w_b {tuple(w_b.shape)} "
                         f"must be [H, 4H] with 4H == {xg_f.shape[-1]}")


def _device_type(name: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or dev.type not in ("cpu",
                                                                  "cuda"):
        raise ValueError(f"{name}: all inputs must be on one CPU or CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    return dev.type


def prev_steps(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """``x`` at each direction's previous step, zero at its first: t-1 for
    the forward direction, t+1 for the backward-in-time one."""
    if reverse:
        return F.pad(x[:, 1:], (0, 0, 0, 1))
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def bilstm_fwd_train(xg_f, xg_b, w_f, w_b):
    """Training forward: ``(ys_f, ys_b, cs_f, cs_b, gs_f, gs_b)``; CUDA
    tensors launch ``bilstm_fwd_train``, CPU tensors take the plain
    version."""
    if _device_type("bilstm_fwd_train", xg_f, xg_b, w_f, w_b) == "cpu":
        return bilstm_fwd_train_plain(xg_f, xg_b, w_f, w_b)
    return bilstm_fwd_train_cuda(xg_f, xg_b, w_f, w_b)


def bilstm_bwd(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b):
    """BPTT of both directions: ``(dg_f, dg_b)``; CUDA tensors launch
    ``bilstm_bwd``, CPU tensors take the plain version."""
    ins = (w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b)
    if _device_type("bilstm_bwd", *ins) == "cpu":
        return bilstm_bwd_plain(*ins)
    return bilstm_bwd_cuda(*ins)


class BiLSTMFunction(torch.autograd.Function):
    """One BiLSTM layer's recurrence with its hand-written backward
    (counterpart of ``_bilstm_core`` with ``_bilstm_core_fwd`` and
    ``_bilstm_core_bwd``). Inputs and outputs as ``bilstm_recurrence``."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, w_f, w_b):
        ys_f, ys_b, cs_f, cs_b, gs_f, gs_b = bilstm_fwd_train(
            xg_f, xg_b, w_f, w_b)
        ctx.save_for_backward(w_f, w_b, ys_f, ys_b, cs_f, cs_b, gs_f, gs_b)
        return ys_f, ys_b

    @staticmethod
    @once_differentiable
    def backward(ctx, dy_f, dy_b):
        # autograd hands zeros for an output that got no gradient; the
        # halves of a concatenation arrive as strided views
        w_f, w_b, ys_f, ys_b, cs_f, cs_b, gs_f, gs_b = ctx.saved_tensors
        dg_f, dg_b = bilstm_bwd(w_f, w_b, gs_f, cs_f, dy_f.contiguous(),
                                gs_b, cs_b, dy_b.contiguous())
        H = w_f.shape[0]

        def dw(ys, dg, reverse):
            hp = prev_steps(ys, reverse)
            return torch.matmul(hp.reshape(-1, H).t(), dg.reshape(-1, 4 * H))

        return dg_f, dg_b, dw(ys_f, dg_f, False), dw(ys_b, dg_b, True)


def bilstm_recurrence(xg_f: torch.Tensor, xg_b: torch.Tensor,
                      w_f: torch.Tensor, w_b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of one BiLSTM layer (see module docstring)."""
    _check_shapes(xg_f, xg_b, w_f, w_b)
    tensors = (xg_f, xg_b, w_f, w_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return BiLSTMFunction.apply(*tensors)
    if _device_type("bilstm_recurrence", *tensors) == "cpu":
        return bilstm_recurrence_plain(*tensors)
    return bilstm_fwd_cuda(*tensors)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _library(name: str):
    from room_slam_torch.ops.build import load_library

    lib = load_library(name)
    if getattr(lib, "_argtypes_set", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "bilstm_fwd":
        lib.bilstm_fwd_f32.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.bilstm_fwd_train_f32.argtypes = [p] * 10 + [i] * 3 + [p]
        fns = (lib.bilstm_fwd_f32, lib.bilstm_fwd_train_f32)
    else:
        lib.bilstm_bwd_f32.argtypes = [p] * 10 + [i] * 3 + [p]
        fns = (lib.bilstm_bwd_f32,)
    for fn in fns:
        fn.restype = ctypes.c_int
    set_error_string(lib, name)
    return lib


def set_error_string(lib, name: str) -> None:
    """Bind ``<name>_error_string`` of a kernel library as
    ``lib.error_string`` and mark its argument types as set."""
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    lib._argtypes_set = True


def _check_cuda(name: str, tensors, smem: int) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32 only, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: needs {smem} bytes of shared memory per block, over "
            f"the {MAX_SMEM_BYTES} a block can have (larger H needs W_hh "
            "split across a thread-block cluster)")
    return dev


def launch(lib, fn_name: str, dev: torch.device, *args) -> None:
    """Call ``fn_name`` of the kernel library ``lib`` on the current stream
    of ``dev``; raise if the launch was refused."""
    with torch.cuda.device(dev):
        rc = getattr(lib, fn_name)(*args,
                                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.error_string(rc).decode()}")


def bilstm_fwd_cuda(xg_f: torch.Tensor, xg_b: torch.Tensor,
                    w_f: torch.Tensor, w_b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the light kernel of ``csrc/bilstm_fwd.cu`` on the current
    stream. Counts each launch in ``bilstm_fwd_cuda.launches``. Its outputs
    carry no autograd history: ``bilstm_recurrence`` sends inputs that need
    a gradient to ``BiLSTMFunction`` instead."""
    _check_shapes(xg_f, xg_b, w_f, w_b)
    B, N, G = xg_f.shape
    H = G // 4
    dev = _check_cuda("bilstm_fwd", (xg_f, xg_b, w_f, w_b),
                      bilstm_smem_bytes(H))
    ys_f = torch.empty(B, N, H, dtype=torch.float32, device=dev)
    ys_b = torch.empty_like(ys_f)
    if B == 0 or N == 0:
        return ys_f, ys_b
    launch(_library("bilstm_fwd"), "bilstm_fwd_f32", dev,
           xg_f.data_ptr(), xg_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
           ys_f.data_ptr(), ys_b.data_ptr(), B, N, H)
    bilstm_fwd_cuda.launches += 1
    return ys_f, ys_b


bilstm_fwd_cuda.launches = 0


def bilstm_fwd_train_cuda(xg_f: torch.Tensor, xg_b: torch.Tensor,
                          w_f: torch.Tensor, w_b: torch.Tensor):
    """Launch the residual variant of ``csrc/bilstm_fwd.cu``: returns
    ``(ys_f, ys_b, cs_f, cs_b, gs_f, gs_b)``. Counts each launch in
    ``bilstm_fwd_train_cuda.launches``."""
    _check_shapes(xg_f, xg_b, w_f, w_b)
    B, N, G = xg_f.shape
    H = G // 4
    dev = _check_cuda("bilstm_fwd_train", (xg_f, xg_b, w_f, w_b),
                      bilstm_smem_bytes(H))
    outs = [torch.empty(B, N, d, dtype=torch.float32, device=dev)
            for d in (H, H, H, H, G, G)]
    if B == 0 or N == 0:
        return tuple(outs)
    launch(_library("bilstm_fwd"), "bilstm_fwd_train_f32", dev,
           xg_f.data_ptr(), xg_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
           *(o.data_ptr() for o in outs), B, N, H)
    bilstm_fwd_train_cuda.launches += 1
    return tuple(outs)


bilstm_fwd_train_cuda.launches = 0


def bilstm_bwd_cuda(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bilstm_bwd.cu``: returns ``(dg_f, dg_b)``. Counts each
    launch in ``bilstm_bwd_cuda.launches``."""
    _check_shapes(gs_f, gs_b, w_f, w_b)
    B, N, G = gs_f.shape
    H = G // 4
    if any(t.shape != (B, N, H) for t in (cs_f, dy_f, cs_b, dy_b)):
        raise ValueError(
            "bilstm_bwd: cs_* and dy_* must be [B, N, H] with gs_* "
            f"[B, N, 4H] = {tuple(gs_f.shape)}; got "
            f"{[tuple(t.shape) for t in (cs_f, dy_f, cs_b, dy_b)]}")
    ins = (w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b)
    dev = _check_cuda("bilstm_bwd", ins, bilstm_bwd_smem_bytes(H))
    dg_f = torch.empty(B, N, G, dtype=torch.float32, device=dev)
    dg_b = torch.empty_like(dg_f)
    if B == 0 or N == 0:
        return dg_f, dg_b
    launch(_library("bilstm_bwd"), "bilstm_bwd_f32", dev,
           *(t.data_ptr() for t in ins), dg_f.data_ptr(), dg_b.data_ptr(),
           B, N, H)
    bilstm_bwd_cuda.launches += 1
    return dg_f, dg_b


bilstm_bwd_cuda.launches = 0
