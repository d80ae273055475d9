"""LSTM recurrences, both directions of a BiLSTM layer or one direction of
an LSTM: CUDA kernels, wrappers, plain versions and the autograd
``Function``s that join them.

``bilstm_recurrence(xg_f, xg_b, w_f, w_b)`` runs both directions of one
BiLSTM layer: the forward direction over ``xg_f`` and the backward-in-time
direction over ``xg_b``, both ``[B, N, 4H]`` in original time order, with
``w_* [H, 4H]``; it returns ``(ys_f, ys_b)``, each ``[B, N, H]`` in
original time order. It is the counterpart of the JAX package's
``ops/rnn_pallas.py::bilstm_recurrence_pallas`` and its ``custom_vjp``.

Streams are float32 or bfloat16. Whatever the stream dtype, the carries
and every sum are float32, and values are rounded to the stream dtype where
the Pallas kernels round them: W_hh (W_hh^T in the BPTT) and h before each
dot product, the outputs and the c and gate residuals, the linearized BPTT
coefficients and the gate cotangent. ``dW_hh`` is summed in float32 and
returned in W_hh's dtype.

Three kernels, each with a wrapper that counts its launches and a plain
PyTorch version beside it:

- ``bilstm_fwd`` (``csrc/bilstm_fwd.cu``, light): no gradient needed;
- ``bilstm_fwd_train`` (same source, residual variant): also returns
  ``c_t [B, N, H]`` and the activated gates ``[B, N, 4H]`` per direction;
- ``bilstm_bwd`` (``csrc/bilstm_bwd.cu``): reverse-time BPTT from those
  residuals to the gate cotangent ``dg [B, N, 4H]`` per direction.

The forward source holds two kernels. At H <= ``UNIT_MAX_H`` (64, the
flagship's and the legacy LSTM's width) the unit kernel runs: four lanes
of a warp own one hidden unit of a tile of 1, 2 or 4 batch rows, W_hh in
their registers, one block barrier a step; ``unit_plan`` sizes the tile to
the batch and the card. Above it the wide kernel (the first design, W_hh in
shared memory, one block of 4H threads per 4-row tile) runs, up to H=118
in float32. ``lstm_fwd_kernel_route`` chooses, and each launch records its
kernel and tile in the wrapper's ``last_launch``.

With grad enabled and an input that requires it, ``bilstm_recurrence``
goes through ``BiLSTMFunction`` (training forward, then BPTT and
``dW_hh = sum_t h_{t-1}^T dg_t`` as one matmul); otherwise it runs the
light forward. The tensor's device picks the implementation: a CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.
Nothing routes a CUDA tensor to a plain version.

``lstm_recurrence_kernel(xg, w_hh, reverse)`` is one direction (the
counterpart of ``rnn_pallas.py::lstm_recurrence_pallas`` and its
``custom_vjp``; ``ops/rnn.py`` ``lstm_recurrence(use_kernel=True)`` reaches
it). The same two sources launch it with a grid of one direction:
``lstm_fwd``, ``lstm_fwd_train`` and ``lstm_bwd``, with ``LSTMFunction``
joining them. Their plain versions are ``ops/rnn.py``
``lstm_recurrence``, ``lstm_fwd_train_plain`` and ``lstm_bwd_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from room_slam_torch.ops.rnn import lstm_recurrence

# Largest dynamic shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232448
_ROWS_PER_BLOCK = 4   # kRows in csrc/bilstm_bwd.cu (and the wide forward)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# The unit kernels of csrc/bilstm_fwd.cu and csrc/bigru_fwd.cu: kLanes,
# kMaxRegH / kMaxUnitH and the templated batch tiles
UNIT_LANES = 4
UNIT_MAX_H = 64
UNIT_ROWS = (1, 2, 4)
# A step's fixed part (block barrier, lane reduction, gate math) in rows'
# worth of a block's FMA issue, for unit_plans' cost model
UNIT_STEP_FIXED = 2


def bilstm_smem_bytes(hidden: int) -> int:
    """Shared memory one block of the wide forward kernel needs (mirrors
    ``smem_bytes`` in ``csrc/bilstm_fwd.cu``)."""
    G = 4 * hidden
    return (hidden * G + _ROWS_PER_BLOCK * G + _ROWS_PER_BLOCK * hidden) * 4


def unit_smem_bytes(rows: int, tiles: int = 1) -> int:
    """Static shared memory of a unit kernel's block: ``tiles`` tiles of
    [64][rows] float32, double buffered (``unit_smem_bytes`` of the
    sources): the forward kernels' h tile (one), the GRU BPTT's dg tile
    (three, one per gate block of W_hh's row)."""
    return 2 * tiles * UNIT_MAX_H * rows * 4


def unit_threads(hidden: int) -> int:
    """Threads of a unit kernel's block: ``UNIT_LANES`` for each hidden
    unit, the units padded to whole warps."""
    return UNIT_LANES * (-(-hidden // 8) * 8)


def unit_weight_regs(gates: int) -> int:
    """W_hh values one lane of a unit kernel holds in registers: its
    quarter of the 64-deep k sum for each of ``gates`` gate columns."""
    return gates * UNIT_MAX_H // UNIT_LANES


def check_unit_mirror(layout, gates: int, name: str, tiles: int = 1) -> None:
    """Hold ``unit_smem_bytes`` (of ``tiles`` tiles), ``unit_threads`` and
    ``unit_weight_regs`` to a built source's ``<name>_unit_layout(what, H,
    R)`` over every H and tile it takes (and -1 for one it does not);
    raises on the first difference."""
    for hidden in range(1, UNIT_MAX_H + 2):
        for rows in (*UNIT_ROWS, 3):
            fits = hidden <= UNIT_MAX_H and rows in UNIT_ROWS
            want = ((unit_smem_bytes(rows, tiles), unit_threads(hidden),
                     unit_weight_regs(gates)) if fits else (-1, -1, -1))
            got = tuple(layout(what, hidden, rows) for what in range(3))
            if got != want:
                raise RuntimeError(
                    f"{name}: the wrapper's unit-kernel mirror gives {want} "
                    f"(shared bytes, threads, W_hh registers) at H={hidden}, "
                    f"R={rows}, the built source {got}: update UNIT_* to "
                    "match the source")


def unit_plans(batch: int, dirs: int, sms: int,
               per_sm: Callable[[int], int]) -> List[int]:
    """Every batch tile of ``UNIT_ROWS`` a unit kernel takes at this batch
    over ``dirs`` directions, fastest first.

    A block's step costs its rows' FMA issue (``rows``) plus a fixed part
    (``UNIT_STEP_FIXED``: the barrier, the lane reduction and the gate
    math). ``load = ceil(blocks / sms)`` blocks share an SM and their FMA
    issue adds up; ``per_sm(rows)`` of them (the card's own count,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) run at once and
    overlap their fixed parts. Ties go to the smaller tile."""
    keys = []
    for rows in UNIT_ROWS:
        at_once = per_sm(rows)
        if at_once <= 0:
            continue
        load = -(-dirs * -(-batch // rows) // sms)
        keys.append((load * rows + UNIT_STEP_FIXED * -(-load // at_once),
                     rows))
    return [rows for _, rows in sorted(keys)]


def unit_plan(batch: int, dirs: int, sms: int,
              per_sm: Callable[[int], int]) -> int:
    """The batch tile a unit kernel launch takes: the first of
    ``unit_plans``. Raises if the card runs no block of any tile."""
    plans = unit_plans(batch, dirs, sms, per_sm)
    if not plans:
        raise ValueError("unit kernel: the card runs no block of any tile "
                         f"of {UNIT_ROWS} rows")
    return plans[0]


def lstm_fwd_kernel_route(hidden: int) -> str:
    """The forward kernel of ``csrc/bilstm_fwd.cu`` that takes hidden size
    ``hidden`` (whatever the batch, stream dtype or direction count):
    "unit" up to ``UNIT_MAX_H``, else "wide" where its W_hh fits one
    block's shared memory. Raises for an H neither takes."""
    if hidden <= 0:
        raise ValueError(f"bilstm_fwd: H must be positive, got {hidden}")
    if hidden <= UNIT_MAX_H:
        return "unit"
    if 4 * hidden <= 512 and bilstm_smem_bytes(hidden) <= MAX_SMEM_BYTES:
        return "wide"
    raise ValueError(
        f"bilstm_fwd: no kernel takes H={hidden}: the unit kernel holds "
        f"H <= {UNIT_MAX_H}, and the wide kernel needs "
        f"{bilstm_smem_bytes(hidden)} bytes of shared memory per block, over "
        f"the {MAX_SMEM_BYTES} a block can have (larger H needs W_hh split "
        "across a thread-block cluster)")


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


def lstm_fwd_train_plain(xg: torch.Tensor, w: torch.Tensor,
                         reverse: bool = False):
    """Plain version of ``lstm_fwd_train``: ``(ys, cs, gates)`` in original
    time order and in the stream dtype, gates activated (sigmoid i, sigmoid
    f, tanh g, sigmoid o); W_hh and h rounded to the stream dtype before
    the dot product, the carries float32."""
    B, N, G = xg.shape
    H = G // 4
    T, dt = xg.dtype, _work_dtype(xg)
    w = w.to(T).to(dt)
    h = xg.new_zeros(B, H, dtype=dt)
    c = torch.zeros_like(h)
    ys = xg.new_empty(B, N, H)
    cs = torch.empty_like(ys)
    gs = xg.new_empty(B, N, G)
    for t in (range(N - 1, -1, -1) if reverse else range(N)):
        g = xg[:, t].to(dt) + h.to(T).to(dt) @ w
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
    ys_f, cs_f, gs_f = lstm_fwd_train_plain(xg_f, w_f, reverse=False)
    ys_b, cs_b, gs_b = lstm_fwd_train_plain(xg_b, w_b, reverse=True)
    return ys_f, ys_b, cs_f, cs_b, gs_f, gs_b


def lstm_bwd_plain(w, gs, cs, dy, reverse: bool = False) -> torch.Tensor:
    """Plain version of ``lstm_bwd`` (one direction of the kernel's BPTT),
    step for step: the linearized coefficients of the reference, rounded to
    the stream dtype, then the serial walk against the direction's forward
    order. Returns ``dg`` in the stream dtype."""
    B, N, G = gs.shape
    H = G // 4
    T, dt = gs.dtype, _work_dtype(gs)
    i, f, gg, o = gs.to(dt).split(H, dim=-1)
    cp = prev_steps(cs, reverse).to(dt)
    tanh_c = torch.tanh(cs.to(dt))
    c_c = (o * (1.0 - tanh_c * tanh_c)).to(T).to(dt)
    c4 = torch.cat([gg * i * (1.0 - i), cp * f * (1.0 - f),
                    i * (1.0 - gg * gg), tanh_c * o * (1.0 - o)],
                   dim=-1).to(T).to(dt)
    wt = w.to(T).to(dt).t()
    dh = gs.new_zeros(B, H, dtype=dt)
    dc = torch.zeros_like(dh)
    dg = torch.empty_like(gs)
    for t in (range(N) if reverse else range(N - 1, -1, -1)):
        dh_t = dy[:, t].to(dt) + dh
        dc_t = dc + dh_t * c_c[:, t]
        d = torch.cat([dc_t, dc_t, dc_t, dh_t], dim=-1) * c4[:, t]
        dg[:, t] = d
        dh = d.to(T).to(dt) @ wt
        dc = dc_t * f[:, t]
    return dg


def bilstm_bwd_plain(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bilstm_bwd``: ``(dg_f, dg_b)``, each
    ``[B, N, 4H]``, from the training forward's gates and c and the
    upstream ``dy``."""
    return (lstm_bwd_plain(w_f, gs_f, cs_f, dy_f, reverse=False),
            lstm_bwd_plain(w_b, gs_b, cs_b, dy_b, reverse=True))


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
        T = ys_f.dtype
        dg_f, dg_b = bilstm_bwd(w_f, w_b, gs_f, cs_f,
                                dy_f.to(T).contiguous(), gs_b, cs_b,
                                dy_b.to(T).contiguous())
        return (dg_f, dg_b, _hidden_grad(ys_f, dg_f, False, w_f.dtype),
                _hidden_grad(ys_b, dg_b, True, w_b.dtype))


def _hidden_grad(ys, dg, reverse: bool, dtype: torch.dtype) -> torch.Tensor:
    """``dW_hh = sum_t h_{t-1}^T dg_t`` of one direction, one matmul
    accumulated in float32 (float64 for float64 streams) and returned in
    ``dtype`` (the reference's einsum, ``rnn_pallas.py:352``)."""
    H = ys.shape[-1]
    acc = _work_dtype(ys)
    hp = prev_steps(ys, reverse).reshape(-1, H).to(acc)
    return torch.matmul(hp.t(), dg.reshape(-1, 4 * H).to(acc)).to(dtype)


def lstm_fwd_train(xg, w, reverse: bool = False):
    """One direction's training forward: ``(ys, cs, gates)``; CUDA tensors
    launch ``lstm_fwd_train``, CPU tensors take the plain version."""
    if _device_type("lstm_fwd_train", xg, w) == "cpu":
        return lstm_fwd_train_plain(xg, w, reverse)
    return lstm_fwd_train_cuda(xg, w, reverse)


def lstm_bwd(w, gs, cs, dy, reverse: bool = False) -> torch.Tensor:
    """One direction's BPTT: ``dg``; CUDA tensors launch ``lstm_bwd``, CPU
    tensors take the plain version."""
    if _device_type("lstm_bwd", w, gs, cs, dy) == "cpu":
        return lstm_bwd_plain(w, gs, cs, dy, reverse)
    return lstm_bwd_cuda(w, gs, cs, dy, reverse)


class LSTMFunction(torch.autograd.Function):
    """One direction of an LSTM with its hand-written backward (counterpart
    of ``_lstm_core`` with ``_lstm_core_fwd`` and ``_lstm_core_bwd``): the
    training forward, then BPTT, then ``dW_hh`` as one matmul outside the
    kernel. No gradient for ``reverse``."""

    @staticmethod
    def forward(ctx, xg, w, reverse: bool):
        ys, cs, gs = lstm_fwd_train(xg, w, reverse)
        ctx.save_for_backward(w, ys, cs, gs)
        ctx.reverse = reverse
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        w, ys, cs, gs = ctx.saved_tensors
        dg = lstm_bwd(w, gs, cs, dy.to(ys.dtype).contiguous(), ctx.reverse)
        return dg, _hidden_grad(ys, dg, ctx.reverse, w.dtype), None


def lstm_recurrence_kernel(xg: torch.Tensor, w_hh: torch.Tensor,
                           reverse: bool = False) -> torch.Tensor:
    """One direction of an LSTM over ``xg [B, N, 4H]`` with ``w_hh
    [H, 4H]``: ``ys [B, N, H]`` in original time order. With grad enabled
    and an input that requires it, ``LSTMFunction``; otherwise the light
    kernel for CUDA tensors, the plain loop for CPU tensors."""
    _check_shapes(xg, xg, w_hh, w_hh)
    if torch.is_grad_enabled() and (xg.requires_grad or w_hh.requires_grad):
        return LSTMFunction.apply(xg, w_hh, reverse)
    if _device_type("lstm_recurrence_kernel", xg, w_hh) == "cpu":
        return lstm_recurrence(xg, w_hh, reverse)
    return lstm_fwd_cuda(xg, w_hh, reverse)


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
    # pointers, then B, N, H (the forward: and the tile R and the wide
    # flag), and the reverse flag of one direction
    if name == "bilstm_fwd":
        fns = {"bilstm_fwd": (6, 5), "bilstm_fwd_train": (10, 5),
               "lstm_fwd": (3, 6), "lstm_fwd_train": (5, 6)}
    else:
        fns = {"bilstm_bwd": (10, 3), "lstm_bwd": (5, 4)}
    for fn_name, (n_ptr, n_int) in fns.items():
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"{fn_name}_{sfx}")
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = ctypes.c_int
    if name == "bilstm_fwd":
        bind_unit_queries(lib, name, gates=4)
    set_error_string(lib, name)
    return lib


def bind_unit_queries(lib, name: str, gates: int, tiles: int = 1) -> None:
    """Bind ``<name>_unit_blocks_per_sm`` (the bf16 flag, the kSave flag,
    H, R) and ``<name>_unit_layout`` (what, H, R) of a unit kernel
    (``tiles`` as ``unit_smem_bytes``) and hold the wrapper's unit-kernel
    mirror to the latter."""
    i = ctypes.c_int
    per_sm = getattr(lib, f"{name}_unit_blocks_per_sm")
    per_sm.argtypes = [i] * 4
    per_sm.restype = i
    layout = getattr(lib, f"{name}_unit_layout")
    layout.argtypes = [i] * 3
    layout.restype = i
    check_unit_mirror(layout, gates, name, tiles)


_UNIT_PLANS: dict = {}   # unit-kernel launch plans by source, shape, dtype


def _unit_counts(lib, name: str, H: int, dev: torch.device, T, save: bool):
    """The card's SM count and ``per_sm(rows)``: how many blocks of the
    unit kernel of source ``name`` at this H and tile one SM runs at
    once."""
    query = getattr(lib, f"{name}_unit_blocks_per_sm")

    def per_sm(rows):
        with torch.cuda.device(dev):
            return query(int(T == torch.bfloat16), int(save), H, rows)

    return torch.cuda.get_device_properties(dev).multi_processor_count, per_sm


def card_unit_plans(lib, name: str, B: int, H: int, dev: torch.device,
                    T: torch.dtype, save: bool, dirs: int) -> List[int]:
    """``unit_plans`` of the unit kernel of source ``name`` on the card
    ``dev`` (its own counts), fastest first; the first is the tile a launch
    takes."""
    return unit_plans(B, dirs, *_unit_counts(lib, name, H, dev, T, save))


def card_lstm_unit_plans(B: int, H: int, dev: torch.device,
                         dtype: torch.dtype, save: bool,
                         dirs: int) -> List[int]:
    """``card_unit_plans`` of the LSTM unit kernel (``dirs`` directions):
    the tiles the card runs, fastest first."""
    return card_unit_plans(_library("bilstm_fwd"), "bilstm_fwd", B, H, dev,
                           dtype, save, dirs)


def unit_launch_rows(fn, lib, name: str, B: int, H: int, dev: torch.device,
                     T, save: bool, dirs: int,
                     rows: Optional[int] = None) -> int:
    """The batch tile of a unit-kernel launch: ``unit_plan``'s pick with
    the card's own counts, or the caller's ``rows``, refused unless it is a
    tile of ``UNIT_ROWS`` the card runs. Recorded with the grid's block
    count and the card's resident count in ``fn.last_launch``."""
    key = (name, B, H, str(dev), T, save, dirs, rows)
    if key not in _UNIT_PLANS:
        sms, per_sm = _unit_counts(lib, name, H, dev, T, save)
        if rows is None:
            rows = unit_plan(B, dirs, sms, per_sm)
        elif rows not in UNIT_ROWS or per_sm(rows) <= 0:
            raise ValueError(f"{name}: the unit kernel takes tiles of "
                             f"{UNIT_ROWS} rows that the card runs, not "
                             f"{rows}")
        _UNIT_PLANS[key] = {"kernel": "unit", "cluster": 1, "rows": rows,
                            "clusters": dirs * -(-B // rows),
                            "resident": sms * per_sm(rows)}
    fn.last_launch = _UNIT_PLANS[key]
    return fn.last_launch["rows"]


def set_error_string(lib, name: str) -> None:
    """Bind ``<name>_error_string`` of a kernel library as
    ``lib.error_string`` and mark its argument types as set."""
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    lib._argtypes_set = True


def _check_cuda(name: str, streams, weights, smem: int):
    """The inputs' device and stream dtype; raises unless they lie on one
    CUDA device, the streams are float32 or bfloat16 of one dtype, W_hh is
    float32 or the stream dtype, all are contiguous and a block's shared
    memory fits."""
    tensors = (*streams, *weights)
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    T = streams[0].dtype
    if T not in _SUFFIX or any(t.dtype != T for t in streams):
        raise TypeError(f"{name} takes float32 or bfloat16 streams of one "
                        f"dtype, got {[t.dtype for t in streams]}")
    if any(t.dtype not in (torch.float32, T) for t in weights):
        raise TypeError(f"{name}: W_hh must be float32 or the stream dtype, "
                        f"got {[t.dtype for t in weights]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: needs {smem} bytes of shared memory per block, over "
            f"the {MAX_SMEM_BYTES} a block can have (larger H needs W_hh "
            "split across a thread-block cluster)")
    return dev, T


def launch(lib, fn_name: str, dev: torch.device, *args) -> None:
    """Call ``fn_name`` of the kernel library ``lib`` on the current stream
    of ``dev``; raise if the launch was refused."""
    with torch.cuda.device(dev):
        rc = getattr(lib, fn_name)(*args,
                                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.error_string(rc).decode()}")


def _fwd_plan(fn, name: str, B: int, H: int, dev, T, save: bool,
              dirs: int, plan):
    """The kernel library and ``(rows, wide)`` of a forward launch of
    ``csrc/bilstm_fwd.cu``: ``lstm_fwd_kernel_route``'s kernel and, for the
    unit kernel, ``unit_plan``'s tile; or the caller's ``plan`` ("unit",
    rows) or ("wide", 4). Recorded in ``fn.last_launch``."""
    kernel = lstm_fwd_kernel_route(H) if plan is None else plan[0]
    lib = _library("bilstm_fwd")
    if kernel == "unit":
        if H > UNIT_MAX_H:
            raise ValueError(f"{name}: the unit kernel takes H <= "
                             f"{UNIT_MAX_H}, not {H}")
        return lib, unit_launch_rows(fn, lib, "bilstm_fwd", B, H, dev, T,
                                     save, dirs,
                                     None if plan is None else plan[1]), 0
    if kernel != "wide" or (plan is not None
                            and plan[1] != _ROWS_PER_BLOCK):
        raise ValueError(f"{name}: plan must be ('unit', rows) or ('wide', "
                         f"{_ROWS_PER_BLOCK}), got {plan}")
    fn.last_launch = {"kernel": "wide", "cluster": 1,
                      "rows": _ROWS_PER_BLOCK,
                      "clusters": dirs * -(-B // _ROWS_PER_BLOCK),
                      "resident": None}
    return lib, _ROWS_PER_BLOCK, 1


def _fwd_smem(H: int, plan) -> int:
    """Shared memory of the forward kernel ``plan`` (or the route's) picks
    at H, for ``_check_cuda``; the unit kernel's largest tile."""
    kernel = lstm_fwd_kernel_route(H) if plan is None else plan[0]
    return (unit_smem_bytes(max(UNIT_ROWS)) if kernel == "unit"
            else bilstm_smem_bytes(H))


def _bilstm_fwd_launch(fn, save: bool, xg_f, xg_b, w_f, w_b, plan):
    _check_shapes(xg_f, xg_b, w_f, w_b)
    name = "bilstm_fwd_train" if save else "bilstm_fwd"
    B, N, G = xg_f.shape
    H = G // 4
    dev, T = _check_cuda(name, (xg_f, xg_b), (w_f, w_b), _fwd_smem(H, plan))
    outs = [torch.empty(B, N, d, dtype=T, device=dev)
            for d in ((H, H, H, H, G, G) if save else (H, H))]
    if B == 0 or N == 0:
        return tuple(outs)
    lib, rows, wide = _fwd_plan(fn, name, B, H, dev, T, save, 2, plan)
    w_f, w_b = w_f.to(T), w_b.to(T)
    launch(lib, f"{name}_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (xg_f, xg_b, w_f, w_b, *outs)), B, N, H,
           rows, wide)
    fn.launches += 1
    return tuple(outs)


def bilstm_fwd_cuda(xg_f: torch.Tensor, xg_b: torch.Tensor,
                    w_f: torch.Tensor, w_b: torch.Tensor,
                    plan: Optional[Tuple[str, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the light kernel of ``csrc/bilstm_fwd.cu`` on the current
    stream. ``plan=("unit", rows)`` or ``("wide", 4)`` overrides the route
    and the planner (raises if it does not fit). Counts each launch in
    ``bilstm_fwd_cuda.launches``. Its outputs carry no autograd history:
    ``bilstm_recurrence`` sends inputs that need a gradient to
    ``BiLSTMFunction`` instead."""
    return _bilstm_fwd_launch(bilstm_fwd_cuda, False, xg_f, xg_b, w_f, w_b,
                              plan)


bilstm_fwd_cuda.launches = 0


def bilstm_fwd_train_cuda(xg_f: torch.Tensor, xg_b: torch.Tensor,
                          w_f: torch.Tensor, w_b: torch.Tensor,
                          plan: Optional[Tuple[str, int]] = None):
    """Launch the residual variant of ``csrc/bilstm_fwd.cu``: returns
    ``(ys_f, ys_b, cs_f, cs_b, gs_f, gs_b)``; ``plan`` as
    ``bilstm_fwd_cuda``. Counts each launch in
    ``bilstm_fwd_train_cuda.launches``."""
    return _bilstm_fwd_launch(bilstm_fwd_train_cuda, True, xg_f, xg_b, w_f,
                              w_b, plan)


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
    streams = (gs_f, cs_f, dy_f, gs_b, cs_b, dy_b)
    dev, T = _check_cuda("bilstm_bwd", streams, (w_f, w_b),
                         bilstm_bwd_smem_bytes(H))
    dg_f = torch.empty(B, N, G, dtype=T, device=dev)
    dg_b = torch.empty_like(dg_f)
    if B == 0 or N == 0:
        return dg_f, dg_b
    w_f, w_b = w_f.to(T), w_b.to(T)
    launch(_library("bilstm_bwd"), f"bilstm_bwd_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (w_f, w_b, *streams)), dg_f.data_ptr(),
           dg_b.data_ptr(), B, N, H)
    bilstm_bwd_cuda.launches += 1
    return dg_f, dg_b


bilstm_bwd_cuda.launches = 0


def _lstm_fwd_launch(fn, save: bool, xg, w, reverse: bool, plan):
    _check_shapes(xg, xg, w, w)
    name = "lstm_fwd_train" if save else "lstm_fwd"
    B, N, G = xg.shape
    H = G // 4
    dev, T = _check_cuda(name, (xg,), (w,), _fwd_smem(H, plan))
    outs = [torch.empty(B, N, d, dtype=T, device=dev)
            for d in ((H, H, G) if save else (H,))]
    if B == 0 or N == 0:
        return tuple(outs)
    lib, rows, wide = _fwd_plan(fn, name, B, H, dev, T, save, 1, plan)
    w = w.to(T)
    launch(lib, f"{name}_{_SUFFIX[T]}", dev,
           xg.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in outs),
           B, N, H, rows, wide, int(reverse))
    fn.launches += 1
    return tuple(outs)


def lstm_fwd_cuda(xg: torch.Tensor, w: torch.Tensor, reverse: bool = False,
                  plan: Optional[Tuple[str, int]] = None) -> torch.Tensor:
    """Launch the light kernel of ``csrc/bilstm_fwd.cu`` with a grid of one
    direction on the current stream: ``ys``; ``plan`` as
    ``bilstm_fwd_cuda``. Counts each launch in ``lstm_fwd_cuda.launches``.
    Its output carries no autograd history: ``lstm_recurrence_kernel``
    sends inputs that need a gradient to ``LSTMFunction`` instead."""
    return _lstm_fwd_launch(lstm_fwd_cuda, False, xg, w, reverse, plan)[0]


lstm_fwd_cuda.launches = 0


def lstm_fwd_train_cuda(xg: torch.Tensor, w: torch.Tensor,
                        reverse: bool = False,
                        plan: Optional[Tuple[str, int]] = None):
    """Launch the residual variant of ``csrc/bilstm_fwd.cu`` with a grid of
    one direction: ``(ys, cs, gates)``; ``plan`` as ``bilstm_fwd_cuda``.
    Counts each launch in ``lstm_fwd_train_cuda.launches``."""
    return _lstm_fwd_launch(lstm_fwd_train_cuda, True, xg, w, reverse, plan)


lstm_fwd_train_cuda.launches = 0


def lstm_bwd_cuda(w, gs, cs, dy, reverse: bool = False) -> torch.Tensor:
    """Launch ``csrc/bilstm_bwd.cu`` with a grid of one direction: ``dg``.
    Counts each launch in ``lstm_bwd_cuda.launches``."""
    _check_shapes(gs, gs, w, w)
    B, N, G = gs.shape
    H = G // 4
    if cs.shape != (B, N, H) or dy.shape != (B, N, H):
        raise ValueError(
            "lstm_bwd: cs and dy must be [B, N, H] with gs [B, N, 4H] = "
            f"{tuple(gs.shape)}; got {tuple(cs.shape)}, {tuple(dy.shape)}")
    dev, T = _check_cuda("lstm_bwd", (gs, cs, dy), (w,),
                         bilstm_bwd_smem_bytes(H))
    dg = torch.empty(B, N, G, dtype=T, device=dev)
    if B == 0 or N == 0:
        return dg
    w = w.to(T)
    launch(_library("bilstm_bwd"), f"lstm_bwd_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (w, gs, cs, dy, dg)), B, N, H,
           int(reverse))
    lstm_bwd_cuda.launches += 1
    return dg


lstm_bwd_cuda.launches = 0
