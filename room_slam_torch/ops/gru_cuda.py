"""GRU recurrences, both directions of a BiGRU layer or one direction of a
GRU: CUDA kernels, wrappers, plain versions and the autograd ``Function``s
that join them.

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

Two more kinds of the BPTT source, which no model calls (as in the JAX
package):

- ``bigru_bwd_split`` (#10): the BPTT with the carry's product as three
  H-deep sums and the coefficients unrounded, the counterpart of the JAX
  micro-benchmark's ``_bwd_kernel_split``; ``tools/bench_bigru_bwd.py``
  times it against ``bigru_bwd`` under a sweep of launch plans (``plan=``);
- ``bigru_bwd_fused`` (#9): a whole BiGRU layer's VJP, the counterpart of
  ``gru_pallas.py::_bigru_bwd_fused_kernel``: ``bigru_bwd``'s walk and, in
  the same launch, dX, dW_ih, dW_hh and both biases; ``bigru_layer`` (a
  layer's gate products and recurrence, ``BiGRULayerFunction`` under grad)
  reaches it.

With grad enabled and an input that requires it, ``bigru_recurrence`` goes
through ``BiGRUFunction`` (training forward, then BPTT, then ``dW_hh`` and
``db_hh`` as matmuls and sums outside the kernel); otherwise it runs the
light forward. The tensor's device picks the implementation: a CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.

At H=256 one direction's W_hh does not fit one block's shared memory, so
each kernel splits it across the blocks of a thread-block cluster
(``bigru_plan``).

``gru_recurrence_kernel(xg, w_hh, b_hh, reverse)`` is one direction (the
counterpart of ``gru_pallas.py::gru_recurrence_pallas`` and its
``custom_vjp``; ``ops/rnn.py`` ``gru_recurrence(use_kernel=True)`` reaches
it). The same two sources launch it with a grid of one direction:
``gru_fwd``, ``gru_fwd_train`` and ``gru_bwd``, with ``GRUFunction`` joining
them. Their plain versions are ``ops/rnn.py`` ``gru_recurrence``,
``gru_fwd_train_plain`` (the same loop with ``residuals``) and
``gru_bwd_plain``. At H <= ``UNIT_MAX_H`` (the legacy model's H=64) the
one-direction forward and BPTT run the unit kernels of
``csrc/bigru_fwd.cu`` and ``csrc/bigru_bwd.cu`` instead of the cluster
kernels: four lanes of a warp own one hidden unit of a tile of 1, 2 or 4
rows, W_hh in their registers, one block barrier a step;
``gru_fwd_kernel_route`` / ``gru_bwd_kernel_route`` choose,
``rnn_cuda.unit_plan`` sizes the tile, and ``last_launch`` records both.

With bf16 streams the fused kind (#9) runs its three input-side products on
tensor cores (``mma.sync``); with float32 streams on CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from room_slam_torch.ops.rnn import gru_recurrence, input_gates
from room_slam_torch.ops.rnn_cuda import (MAX_SMEM_BYTES, UNIT_MAX_H,
                                          _device_type, _work_dtype,
                                          bind_unit_queries, card_unit_plans,
                                          launch, prev_steps,
                                          set_error_string, unit_launch_rows)

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


# The BPTT kinds' plan rule and shared memory mirror valid_plan and
# smem_bytes of csrc/bigru_bwd.cu; _library checks them against the built
# source (bigru_bwd_smem_bytes) before the first launch.
KIND_THREADS = {"fwd": MAX_THREADS, "bwd": MAX_THREADS, "split": MAX_THREADS,
                "fused": 256}   # __launch_bounds__ of each kernel kind
# kFusedStageFloats (a ring of four staged bf16 buffers of two 128 x 32
# tiles, rows padded by 8) and kChunk
_FUSED_STAGE, _FUSED_CHUNK = 4 * (128 + 128) * (32 + 8) // 2, 96


def bigru_smem_bytes(kind: str, hidden: int, cluster: int, rows: int) -> int:
    """Dynamic shared memory one block of ``kind`` needs: its W_hh slice and
    a double-buffered exchange tile, both float32 (a bf16 value is exact in
    float32). ``kind`` is "fwd" (both forward kernels), "bwd" (the BPTT,
    #6), "split" (#10, as "bwd") or "fused" (#9: the exchange tile doubles
    as the products' staging region, grown to ``_FUSED_STAGE`` floats where
    smaller, then a chunk's sample indices)."""
    U = hidden // cluster
    if kind == "fwd":    # W_hh[:, r|z|n of its U units] and h_{t-1} [H, R]
        return (_pad4(hidden * 3 * U) + 2 * hidden * rows) * 4
    # W_hh[its U units, :]^T and the gate cotangent dg [3H, R]
    tile = 2 * 3 * hidden * rows
    if kind == "fused":
        tile = max(tile, _FUSED_STAGE) + _FUSED_CHUNK * rows
    return (_pad4(3 * hidden * U) + tile) * 4


def _plan_rule(kind: str, hidden: int, cluster: int, rows: int) -> bool:
    """The cluster divides H, the tile is a multiple of ``ROWS_PER_THREAD``
    and the threads are within the kind's launch bound (the fused kind: a
    multiple of 16 units per block)."""
    if cluster not in CLUSTER_SIZES or hidden % cluster or rows <= 0 \
            or rows % ROWS_PER_THREAD:
        return False
    U = hidden // cluster
    return (U * (rows // ROWS_PER_THREAD) <= KIND_THREADS[kind]
            and (kind != "fused" or U % 16 == 0))


def plan_fits(kind: str, hidden: int, cluster: int, rows: int) -> bool:
    """Whether a block of ``kind`` at this cluster size and batch tile fits
    the kernel: ``_plan_rule`` holds and shared memory is within one
    block's."""
    return (_plan_rule(kind, hidden, cluster, rows)
            and bigru_smem_bytes(kind, hidden, cluster, rows)
            <= MAX_SMEM_BYTES)


def _check_mirror(lib) -> None:
    """Hold ``_plan_rule`` and ``bigru_smem_bytes`` of the BPTT kinds to the
    built ``csrc/bigru_bwd.cu`` (``bigru_bwd_smem_bytes``: bytes, or -1 for
    a plan the kind does not take) over H in 16..512 and every cluster
    size and tile; raises on the first plan where they differ."""
    for kind, code in _BWD_KINDS.items():
        for hidden in (16, 48, 64, 128, 256, 512):
            for c in CLUSTER_SIZES:
                for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1,
                                  ROWS_PER_THREAD):
                    want = (bigru_smem_bytes(kind, hidden, c, rows)
                            if _plan_rule(kind, hidden, c, rows) else -1)
                    got = lib.bigru_bwd_smem_bytes(code, hidden, c, rows)
                    if got != want:
                        raise RuntimeError(
                            f"bigru_{kind}: the wrapper's plan mirror gives "
                            f"{want} bytes at H={hidden}, plan {c}x{rows}, "
                            f"csrc/bigru_bwd.cu {got}: update KIND_THREADS, "
                            "_FUSED_* or bigru_smem_bytes to match the "
                            "source")


def bigru_plans(kind: str, batch: int, hidden: int,
                resident: Callable[[int, int], int],
                dirs: int = 2) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` that fits kernel ``kind`` at this batch and
    H over ``dirs`` directions (2 for a BiGRU layer, 1 for a GRU), the
    cluster size dividing H and the batch tile a multiple of
    ``ROWS_PER_THREAD`` up to ``MAX_ROWS``, fastest first.

    A step's time is taken as the block's thread count, at least 128 (four
    warps, one per scheduler: fewer do not finish a step sooner), times
    the waves the grid needs: ``resident(cluster, rows)`` clusters run at
    once (the card's own count, ``cudaOccupancyMaxActiveClusters``). Ties
    go to the smaller cluster, then the smaller tile."""
    keys = []
    for c in CLUSTER_SIZES:
        for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1, ROWS_PER_THREAD):
            if not plan_fits(kind, hidden, c, rows):
                continue
            at_once = resident(c, rows)
            if at_once <= 0:
                continue
            threads = hidden // c * (rows // ROWS_PER_THREAD)
            waves = -(-dirs * -(-batch // rows) // at_once)
            keys.append((max(threads, 128) * waves, c, rows))
    return [(c, rows) for _, c, rows in sorted(keys)]


def bigru_plan(kind: str, batch: int, hidden: int,
               resident: Callable[[int, int], int],
               dirs: int = 2) -> Tuple[int, int]:
    """``(cluster, rows)`` for kernel ``kind``: the first of
    ``bigru_plans``, the plan whose step takes least time. Raises for a
    shape no cluster size takes."""
    plans = bigru_plans(kind, batch, hidden, resident, dirs)
    if not plans:
        raise ValueError(
            f"bigru_{kind}: no cluster of {CLUSTER_SIZES} blocks takes H="
            f"{hidden} (it must divide H, and the W_hh slice plus the "
            f"exchange tile must fit {MAX_SMEM_BYTES} bytes of shared memory "
            "per block)")
    return plans[0]


def gru_fwd_kernel_route(hidden: int, dirs: int) -> str:
    """The forward kernel of ``csrc/bigru_fwd.cu`` that takes a launch of
    ``dirs`` directions at hidden size ``hidden`` (whatever the batch or
    stream dtype): "unit" for one direction at H <= ``UNIT_MAX_H``, else
    "cluster" (``bigru_plan`` then picks its cluster and tile, or raises
    for an H no cluster size takes)."""
    return "unit" if dirs == 1 and 0 < hidden <= UNIT_MAX_H else "cluster"


def gru_bwd_kernel_route(hidden: int, dirs: int) -> str:
    """The BPTT kernel of ``csrc/bigru_bwd.cu`` that takes a launch of
    ``dirs`` directions at hidden size ``hidden``: the forward's route,
    "unit" (``gru_bwd_unit_kernel``) for one direction at H <=
    ``UNIT_MAX_H``, else "cluster" (kLinear)."""
    return gru_fwd_kernel_route(hidden, dirs)


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


def gru_fwd_train_plain(xg, w, b, reverse: bool = False):
    """Plain version of ``gru_fwd_train``: ``(ys, gates, hn)``."""
    return gru_recurrence(xg, w, b, reverse, residuals=True)


def _gru_bptt(w, gs, hns, ys, dy, reverse: bool, split: bool):
    """The BPTT walk of one direction, step for step as the kernel, in the
    work dtype and unrounded: ``(dx, dhn)``.

    ``split=False`` (#6, #8, #9): the linearized coefficients of the
    reference (``gru_pallas.py:97-105``), rounded to the stream dtype, and
    one dot product of the rounded gate cotangent with W_hh^T.
    ``split=True`` (#10): the coefficients from the gates unrounded
    (``bench_bigru_bwd.py:140-159``) and three H-deep products added in
    order."""
    B, N, G = gs.shape
    H = G // 3
    T, dt = gs.dtype, _work_dtype(gs)
    r, z, n = gs.to(dt).split(H, dim=-1)
    hp = prev_steps(ys, reverse).to(dt)
    hn = hns.to(dt)
    if not split:
        a = (1.0 - z) * (1.0 - n * n)
        coef = torch.cat([a * hn * r * (1.0 - r),
                          (hp - n) * z * (1.0 - z), a], dim=-1).to(T).to(dt)
    wt = w.to(T).to(dt).t()
    dh = gs.new_zeros(B, H, dtype=dt)
    dx = gs.new_empty(B, N, G, dtype=dt)
    dhn = gs.new_empty(B, N, H, dtype=dt)
    for t in (range(N) if reverse else range(N - 1, -1, -1)):
        dh_t = dy[:, t].to(dt) + dh
        zt = z[:, t]
        if split:
            nt, rt = n[:, t], r[:, t]
            dn = dh_t * (1.0 - zt) * (1.0 - nt * nt)
            dz = dh_t * (hp[:, t] - nt) * zt * (1.0 - zt)
            dr = dn * hn[:, t] * rt * (1.0 - rt)
            d = torch.cat([dr, dz, dn], dim=-1)
            dhn_t = dn * rt
            dg = torch.cat([dr, dz, dhn_t], dim=-1).to(T).to(dt)
            dh = ((dh_t * zt + dg[:, :H] @ wt[:H])
                  + dg[:, H:2 * H] @ wt[H:2 * H]) + dg[:, 2 * H:] @ wt[2 * H:]
        else:
            d = torch.cat([dh_t, dh_t, dh_t], dim=-1) * coef[:, t]
            dhn_t = d[:, 2 * H:] * r[:, t]
            dg = torch.cat([d[:, :2 * H], dhn_t], dim=-1).to(T).to(dt)
            dh = dh_t * zt + dg @ wt
        dx[:, t] = d
        dhn[:, t] = dhn_t
    return dx, dhn


def gru_bwd_plain(w, gs, hns, ys, dy, reverse: bool = False):
    """Plain version of ``gru_bwd`` (one direction of the BPTT kernel),
    step for step: the linearized coefficients of the reference, rounded to
    the stream dtype, then the serial walk against the forward order.
    Returns ``(dx, dhn)`` in the stream dtype."""
    dx, dhn = _gru_bptt(w, gs, hns, ys, dy, reverse, split=False)
    return dx.to(gs.dtype), dhn.to(gs.dtype)


def bigru_bwd_plain(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b):
    """Plain version of ``bigru_bwd``: ``(dx_f, dhn_f, dx_b, dhn_b)`` from
    the training forward's gates, hn and ys and the upstream ``dy``."""
    return (*gru_bwd_plain(w_f, gs_f, hn_f, ys_f, dy_f, reverse=False),
            *gru_bwd_plain(w_b, gs_b, hn_b, ys_b, dy_b, reverse=True))


def bigru_bwd_split_plain(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b,
                          ys_b, dy_b):
    """Plain version of ``bigru_bwd_split`` (#10), step for step:
    ``(dx_f, dhn_f, dx_b, dhn_b)`` in the stream dtype, from the arguments
    of ``bigru_bwd``."""
    outs = []
    for w, gs, hn, ys, dy, rev in ((w_f, gs_f, hn_f, ys_f, dy_f, False),
                                   (w_b, gs_b, hn_b, ys_b, dy_b, True)):
        dx, dhn = _gru_bptt(w, gs, hn, ys, dy, rev, split=True)
        outs += [dx.to(gs.dtype), dhn.to(gs.dtype)]
    return tuple(outs)


def bigru_bwd_fused_plain(x, wih_f, whh_f, wih_b, whh_b, gs_f, hn_f, ys_f,
                          dy_f, gs_b, hn_b, ys_b, dy_b):
    """Plain version of ``bigru_bwd_fused`` (#9): #6's walk per direction,
    then the layer's input-side gradients from it, rounded where the kernel
    rounds: ``dX = T(T(dx) @ T(W_ih)^T)`` in the stream dtype T; ``dW_ih =
    T(x)^T T(dx)``, ``dW_hh = T(h_prev)^T T([dx_r, dx_z, dhn])``, and the
    bias sums of the unrounded ``dx`` and ``[dx_r, dx_z, dhn]``, float32.
    Returns ``(dX_f, dX_b, dW_ih_f, db_ih_f, dW_hh_f, db_hh_f, dW_ih_b,
    db_ih_b, dW_hh_b, db_hh_b)``."""
    T, dt = gs_f.dtype, _work_dtype(gs_f)
    H = ys_f.shape[-1]
    D = x.shape[-1]
    xs = x.to(dt).reshape(-1, D)
    dxs, grads = [], []
    for wih, whh, gs, hn, ys, dy, rev in (
            (wih_f, whh_f, gs_f, hn_f, ys_f, dy_f, False),
            (wih_b, whh_b, gs_b, hn_b, ys_b, dy_b, True)):
        dx, dhn = _gru_bptt(whh, gs, hn, ys, dy, rev, split=False)
        dx, dhn = dx.reshape(-1, 3 * H), dhn.reshape(-1, H)
        dg = torch.cat([dx[:, :2 * H], dhn], dim=-1)
        dx_s, dg_s = dx.to(T).to(dt), dg.to(T).to(dt)
        dxs.append((dx_s @ wih.to(T).to(dt).t()).to(T).view(*x.shape[:2], D))
        hp = prev_steps(ys, rev).to(dt).reshape(-1, H)
        grads += [xs.t() @ dx_s, dx.sum(0), hp.t() @ dg_s, dg.sum(0)]
    return (*dxs, *grads)


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


def bigru_bwd_fused(x, wih_f, whh_f, wih_b, whh_b, gs_f, hn_f, ys_f, dy_f,
                    gs_b, hn_b, ys_b, dy_b):
    """#9, the layer VJP of both directions (see
    ``bigru_bwd_fused_plain``); CUDA tensors launch ``bigru_bwd_fused``,
    CPU tensors take the plain version."""
    ins = (x, wih_f, whh_f, wih_b, whh_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b,
           ys_b, dy_b)
    if _device_type("bigru_bwd_fused", *ins) == "cpu":
        return bigru_bwd_fused_plain(*ins)
    return bigru_bwd_fused_cuda(*ins)


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


def gru_fwd_train(xg, w, b, reverse: bool = False):
    """One direction's training forward: ``(ys, gates, hn)``; CUDA tensors
    launch ``gru_fwd_train``, CPU tensors take the plain version."""
    if _device_type("gru_fwd_train", xg, w, b) == "cpu":
        return gru_fwd_train_plain(xg, w, b, reverse)
    return gru_fwd_train_cuda(xg, w, b, reverse)


def gru_bwd(w, gs, hn, ys, dy, reverse: bool = False):
    """One direction's BPTT: ``(dx, dhn)``; CUDA tensors launch
    ``gru_bwd``, CPU tensors take the plain version."""
    if _device_type("gru_bwd", w, gs, hn, ys, dy) == "cpu":
        return gru_bwd_plain(w, gs, hn, ys, dy, reverse)
    return gru_bwd_cuda(w, gs, hn, ys, dy, reverse)


class GRUFunction(torch.autograd.Function):
    """One direction of a GRU with its hand-written backward (counterpart
    of ``_gru_core`` with ``_gru_core_fwd`` and ``_gru_core_bwd``): the
    training forward, then BPTT, then ``dW_hh`` and ``db_hh`` as matmuls
    and sums outside the kernel. Gradients: dxg in the stream dtype, dW_hh
    and db_hh in W_hh's dtype; none for ``reverse``."""

    @staticmethod
    def forward(ctx, xg, w, b, reverse: bool):
        ys, gs, hn = gru_fwd_train(xg, w, b, reverse)
        ctx.save_for_backward(w, ys, gs, hn)
        ctx.reverse = reverse
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        w, ys, gs, hn = ctx.saved_tensors
        dx, dhn = gru_bwd(w, gs, hn, ys, dy.to(ys.dtype).contiguous(),
                          ctx.reverse)
        dw, db = hidden_grads(ys, dx, dhn, ctx.reverse, w.dtype)
        return dx, dw, db, None


def gru_recurrence_kernel(xg: torch.Tensor, w_hh: torch.Tensor,
                          b_hh: torch.Tensor, reverse: bool = False
                          ) -> torch.Tensor:
    """One direction of a GRU over ``xg [B, N, 3H]`` with ``w_hh [H, 3H]``
    and ``b_hh [3H]``: ``ys [B, N, H]`` in original time order. With grad
    enabled and an input that requires it, ``GRUFunction``; otherwise the
    light kernel for CUDA tensors, the plain loop for CPU tensors."""
    _check_shapes(xg, xg, w_hh, b_hh, w_hh, b_hh)
    tensors = (xg, w_hh, b_hh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return GRUFunction.apply(xg, w_hh, b_hh, reverse)
    if _device_type("gru_recurrence_kernel", *tensors) == "cpu":
        return gru_recurrence(xg, w_hh, b_hh, reverse)
    return gru_fwd_cuda(xg, w_hh, b_hh, reverse)


class BiGRULayerFunction(torch.autograd.Function):
    """One whole BiGRU layer, gate products and both recurrences, with the
    fused layer VJP as its backward (counterpart of ``_bigru_layer_core``
    with ``_bigru_layer_core_fwd`` and ``_bigru_layer_core_bwd``). The
    forward is the gate products (``torch.matmul`` in the stream dtype, as
    the reference leaves them to XLA) and the training kernel #5t; the
    backward is #9 and the stream-dtype sum of the two directions' dX.
    Inputs and output as ``bigru_layer``; gradients: dx in x's dtype, the
    eight weight gradients in ``wih_f``'s dtype."""

    @staticmethod
    def forward(ctx, x, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b,
                bhh_b):
        ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = bigru_fwd_train(
            input_gates(x, wih_f, bih_f), input_gates(x, wih_b, bih_b),
            whh_f, bhh_f, whh_b, bhh_b)
        ctx.save_for_backward(x, wih_f, whh_f, wih_b, whh_b, ys_f, ys_b,
                              gs_f, gs_b, hn_f, hn_b)
        return torch.cat([ys_f, ys_b], dim=-1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (x, wih_f, whh_f, wih_b, whh_b, ys_f, ys_b, gs_f, gs_b, hn_f,
         hn_b) = ctx.saved_tensors
        H = ys_f.shape[-1]
        dy = dy.to(ys_f.dtype)
        dx_f, dx_b, *grads = bigru_bwd_fused(
            x, wih_f, whh_f, wih_b, whh_b, gs_f, hn_f, ys_f,
            dy[..., :H].contiguous(), gs_b, hn_b, ys_b,
            dy[..., H:].contiguous())
        return ((dx_f + dx_b).to(x.dtype),
                *(g.to(wih_f.dtype) for g in grads))


def bigru_layer(x: torch.Tensor, wih_f: torch.Tensor, bih_f: torch.Tensor,
                whh_f: torch.Tensor, bhh_f: torch.Tensor,
                wih_b: torch.Tensor, bih_b: torch.Tensor,
                whh_b: torch.Tensor, bhh_b: torch.Tensor) -> torch.Tensor:
    """A whole BiGRU layer, the counterpart of ``gru_pallas.py::
    bigru_layer_pallas``: ``x [B, N, D]`` in the stream dtype, ``w_ih_*
    [D, 3H]``, ``b_ih_* [3H]``, ``w_hh_* [H, 3H]``, ``b_hh_* [3H]`` (float32
    parameters); returns ``concat([ys_f, ys_b], -1)``, ``[B, N, 2H]`` in the
    stream dtype. With grad enabled and an input that requires it,
    ``BiGRULayerFunction`` (its backward is the fused kernel #9); otherwise
    the gate products and the light forward. No model calls it, as in the
    JAX package, which measured it slower than the unfused layer on a TPU
    and did not adopt it."""
    tensors = (x, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b, bhh_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return BiGRULayerFunction.apply(*tensors)
    ys_f, ys_b = bigru_recurrence(
        input_gates(x, wih_f, bih_f), input_gates(x, wih_b, bih_b),
        whh_f.contiguous(), bhh_f, whh_b.contiguous(), bhh_b)
    return torch.cat([ys_f, ys_b], dim=-1)


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
        # pointers, then B, N, H (and D), C, R, and the reverse flag of one
        # direction
        if fwd:
            fns = {f"bigru_fwd_{sfx}": (8, 5), f"gru_fwd_{sfx}": (4, 6),
                   f"bigru_fwd_train_{sfx}": (12, 5),
                   f"gru_fwd_train_{sfx}": (6, 6),
                   f"gru_fwd_unit_{sfx}": (4, 5),
                   f"gru_fwd_unit_train_{sfx}": (6, 5)}
        else:
            fns = {f"bigru_bwd_{sfx}": (14, 5),
                   f"bigru_bwd_split_{sfx}": (14, 5),
                   f"bigru_bwd_fused_{sfx}": (28, 6),
                   f"gru_bwd_{sfx}": (7, 6),
                   f"gru_bwd_unit_{sfx}": (7, 5)}
        for fn_name, (n_ptr, n_int) in fns.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = ctypes.c_int
    clusters = getattr(lib, f"{name}_max_active_clusters")
    # the bf16 flag, the kSave flag (fwd) or kind (bwd), then H, C, R
    clusters.argtypes = [i] * 5
    clusters.restype = ctypes.c_int
    if fwd:
        bind_unit_queries(lib, "gru_fwd", gates=3)
    else:
        lib.bigru_bwd_smem_bytes.argtypes = [i] * 4
        lib.bigru_bwd_smem_bytes.restype = ctypes.c_int
        _check_mirror(lib)
        bind_unit_queries(lib, "gru_bwd", gates=3, tiles=3)
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


_BWD_KINDS = {"bwd": 0, "split": 1, "fused": 2}   # Kind in bigru_bwd.cu


def _resident(kind: str, H: int, dev: torch.device, T, save: bool):
    """The kernel library of ``kind`` and ``resident(cluster, rows)``: how
    many clusters of that plan the card ``dev`` runs at once."""
    lib = _library("bigru_fwd" if kind == "fwd" else "bigru_bwd")
    query = getattr(lib, "bigru_fwd_max_active_clusters" if kind == "fwd"
                    else "bigru_bwd_max_active_clusters")
    flag = int(save) if kind == "fwd" else _BWD_KINDS[kind]

    def resident(c, rows):
        with torch.cuda.device(dev):
            return query(int(T == torch.bfloat16), flag, H, c, rows)

    return lib, resident


def card_plans(kind: str, B: int, H: int, dev: torch.device,
               dtype: torch.dtype, dirs: int = 2) -> List[Tuple[int, int]]:
    """``bigru_plans`` of kernel ``kind`` on the card ``dev`` (its own
    resident-cluster counts), fastest first; the first is the plan a launch
    takes."""
    return bigru_plans(kind, B, H, _resident(kind, H, dev, dtype, False)[1],
                       dirs)


def _plan_launch(kind: str, fn, B: int, H: int, dev: torch.device, T,
                 save: bool, dirs: int,
                 plan: Optional[Tuple[int, int]] = None):
    """The launch's ``(cluster, rows)`` for kernel ``kind`` ("fwd", "bwd",
    "split" or "fused"): ``bigru_plan``'s pick with the card's own count of
    clusters it runs at once (one count for a grid of one direction or
    two), or the caller's ``plan``, refused unless it fits the kernel
    (``plan_fits``) and the card runs at least one such cluster. Recorded
    with the number of the grid's clusters in ``fn.last_launch``."""
    lib, resident = _resident(kind, H, dev, T, save)
    key = (kind, B, H, str(dev), T, save, dirs, plan)
    if key not in _PLANS:
        if plan is None:
            cluster, rows = bigru_plan(kind, B, H, resident, dirs)
        else:
            cluster, rows = plan
            if not plan_fits(kind, H, cluster, rows):
                raise ValueError(
                    f"bigru_{kind}: plan {cluster}x{rows} does not fit H={H}:"
                    f" the cluster must divide H, the tile be a multiple of "
                    f"{ROWS_PER_THREAD}, at most {KIND_THREADS[kind]} "
                    "threads a block, and bigru_smem_bytes (here "
                    f"{bigru_smem_bytes(kind, H, cluster, max(rows, 0))}) at"
                    f" most {MAX_SMEM_BYTES}")
            if resident(cluster, rows) <= 0:
                raise ValueError(f"bigru_{kind}: the card runs no cluster "
                                 f"of plan {cluster}x{rows} at once")
        _PLANS[key] = {"kernel": "cluster", "cluster": cluster, "rows": rows,
                       "clusters": dirs * -(-B // rows),
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
    lib, cluster, rows = _plan_launch("fwd", fn, B, H, dev, T, save, 2)
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


def _bwd_launch(fn, kind: str, plan, w_f, w_b, gs_f, hn_f, ys_f, dy_f,
                gs_b, hn_b, ys_b, dy_b):
    name = {"bwd": "bigru_bwd", "split": "bigru_bwd_split"}[kind]
    H = w_f.shape[0]
    B, N, G = gs_f.shape
    shapes = [tuple(t.shape) for t in (w_f, w_b, gs_f, gs_b, hn_f, ys_f,
                                        dy_f, hn_b, ys_b, dy_b)]
    if shapes != [(H, 3 * H)] * 2 + [(B, N, 3 * H)] * 2 + [(B, N, H)] * 6:
        raise ValueError(f"{name}: w_* must be [H, 3H], gs_* [B, N, 3H] "
                         f"and hn_*, ys_*, dy_* [B, N, H]; got {shapes}")
    streams = (gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)
    dev = _check_cuda(name, streams, (w_f, w_b), ())
    T = gs_f.dtype
    outs = [torch.empty(B, N, d, dtype=T, device=dev) for d in (G, H, G, H)]
    if B == 0 or N == 0:
        return tuple(outs)
    lib, cluster, rows = _plan_launch(kind, fn, B, H, dev, T, False, 2, plan)
    w_f, w_b = w_f.to(T).contiguous(), w_b.to(T).contiguous()
    launch(lib, f"{name}_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (w_f, w_b, *streams)),
           *(o.data_ptr() for o in outs), B, N, H, cluster, rows)
    fn.launches += 1
    return tuple(outs)


def bigru_bwd_cuda(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b,
                   plan: Optional[Tuple[int, int]] = None):
    """Launch ``csrc/bigru_bwd.cu`` (#6): ``(dx_f, dhn_f, dx_b, dhn_b)``.
    ``plan=(cluster, rows)`` overrides the planner (raises if it does not
    fit). Counts each launch in ``bigru_bwd_cuda.launches``."""
    return _bwd_launch(bigru_bwd_cuda, "bwd", plan, w_f, w_b, gs_f, hn_f,
                       ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)


bigru_bwd_cuda.launches = 0


def bigru_bwd_split_cuda(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b,
                         dy_b, plan: Optional[Tuple[int, int]] = None):
    """Launch the split kind of ``csrc/bigru_bwd.cu`` (#10): arguments,
    outputs and ``plan`` as ``bigru_bwd_cuda``. Counts each launch in
    ``bigru_bwd_split_cuda.launches``."""
    return _bwd_launch(bigru_bwd_split_cuda, "split", plan, w_f, w_b, gs_f,
                       hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)


bigru_bwd_split_cuda.launches = 0


def bigru_bwd_fused_cuda(x, wih_f, whh_f, wih_b, whh_b, gs_f, hn_f, ys_f,
                         dy_f, gs_b, hn_b, ys_b, dy_b):
    """Launch the fused kind of ``csrc/bigru_bwd.cu`` (#9) and the
    reduction of its per-cluster partials: the ten outputs of
    ``bigru_bwd_fused_plain``. ``x [B, N, D]`` and the gate residuals in the
    stream dtype; ``wih_* [D, 3H]`` and ``whh_* [H, 3H]`` float32 or the
    stream dtype. Counts one per call in ``bigru_bwd_fused_cuda.launches``:
    the walk, with its reduction on the same stream."""
    H = whh_f.shape[0]
    B, N, G = gs_f.shape
    D = x.shape[-1]
    shapes = [tuple(t.shape) for t in (x, wih_f, wih_b, whh_f, whh_b, gs_f,
                                        gs_b, hn_f, ys_f, dy_f, hn_b, ys_b,
                                        dy_b)]
    if shapes != [(B, N, D)] + [(D, 3 * H)] * 2 + [(H, 3 * H)] * 2 \
            + [(B, N, 3 * H)] * 2 + [(B, N, H)] * 6:
        raise ValueError("bigru_bwd_fused: x must be [B, N, D], wih_* "
                         "[D, 3H], whh_* [H, 3H], gs_* [B, N, 3H] and hn_*, "
                         f"ys_*, dy_* [B, N, H]; got {shapes}")
    streams = (gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)
    dev = _check_cuda("bigru_bwd_fused", (*streams, x),
                      (wih_f, wih_b, whh_f, whh_b), ())
    T = gs_f.dtype
    f32 = torch.float32
    dxin = [torch.empty(B, N, D, dtype=T, device=dev) for _ in range(2)]
    grads = [torch.zeros(*shape, dtype=f32, device=dev) for shape in
             ((D, G), (G,), (H, G), (G,)) * 2]
    if B == 0 or N == 0:
        dxin[0].zero_()
        dxin[1].zero_()
        return (*dxin, *grads)
    lib, cluster, rows = _plan_launch("fused", bigru_bwd_fused_cuda, B, H,
                                      dev, T, False, 2)
    scratch = [torch.empty(B, N, d, dtype=T, device=dev)
               for d in (G, H, G, H)]
    part = torch.zeros(2 * -(-B // rows),
                       (D + H) * G + rows // ROWS_PER_THREAD * 4 * H,
                       dtype=f32, device=dev)
    ws = [t.to(T).contiguous() for t in (whh_f, whh_b, wih_f, wih_b)]
    launch(lib, f"bigru_bwd_fused_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (*ws[:2], *streams, *scratch, x, *ws[2:],
                                    *dxin, part)),
           *(g.data_ptr() for g in grads), B, N, H, D, cluster, rows)
    bigru_bwd_fused_cuda.launches += 1
    return (*dxin, *grads)


bigru_bwd_fused_cuda.launches = 0


def card_gru_unit_plans(B: int, H: int, dev: torch.device,
                        dtype: torch.dtype, save: bool) -> List[int]:
    """``rnn_cuda.unit_plans`` of the one-direction GRU unit kernel on the
    card ``dev`` (its own counts), fastest first; the first is the tile a
    launch takes."""
    return card_unit_plans(_library("bigru_fwd"), "gru_fwd", B, H, dev,
                           dtype, save, 1)


def _gru_launch(fn, name: str, route, save: bool, ptrs, B, N, H, dev, T,
                reverse: bool, plan):
    """Launch one direction of a GRU: ``name`` "gru_fwd" or
    "gru_fwd_train" (``csrc/bigru_fwd.cu``) or "gru_bwd"
    (``csrc/bigru_bwd.cu``) on the pointers ``ptrs``, on the unit kernel
    (``rnn_cuda.unit_plan``'s tile) or the cluster kernel (``bigru_plan``'s
    plan) as ``route(H, 1)`` says, or as the caller's ``plan`` ("unit",
    rows) or ("cluster", cluster, rows) forces; counted and recorded on
    ``fn``."""
    src = name[:len("gru_fwd")]          # the unit queries' name
    kernel = route(H, 1) if plan is None else plan[0]
    if kernel == "unit":
        if H > UNIT_MAX_H:
            raise ValueError(f"{name}: the unit kernel takes H <= "
                             f"{UNIT_MAX_H}, not {H}")
        lib = _library(f"bi{src}")
        rows = unit_launch_rows(fn, lib, src, B, H, dev, T, save, 1,
                                None if plan is None else plan[1])
        launch(lib, f"{src}_unit{name[len(src):]}_{_SUFFIX[T]}", dev, *ptrs,
               B, N, H, rows, int(reverse))
    elif kernel == "cluster":
        lib, cluster, rows = _plan_launch(src[len("gru_"):], fn, B, H, dev,
                                          T, save, 1,
                                          None if plan is None else plan[1:])
        launch(lib, f"{name}_{_SUFFIX[T]}", dev, *ptrs, B, N, H, cluster,
               rows, int(reverse))
    else:
        raise ValueError(f"{name}: plan must be ('unit', rows) or "
                         f"('cluster', cluster, rows), got {plan}")
    fn.launches += 1


def _gru_fwd_launch(fn, save: bool, xg, w, b, reverse: bool, plan):
    _check_shapes(xg, xg, w, b, w, b)
    name = "gru_fwd_train" if save else "gru_fwd"
    dev = _check_cuda(name, (xg,), (w,), (b,))
    B, N, G = xg.shape
    H = G // 3
    T = xg.dtype
    outs = [torch.empty(B, N, d, dtype=T, device=dev)
            for d in ((H, G, H) if save else (H,))]
    if B == 0 or N == 0:
        return tuple(outs)
    w = w.to(T).contiguous()
    _gru_launch(fn, name, gru_fwd_kernel_route, save,
                [t.data_ptr() for t in (xg, w, b, *outs)], B, N, H, dev, T,
                reverse, plan)
    return tuple(outs)


def gru_fwd_cuda(xg, w, b, reverse: bool = False,
                 plan: Optional[tuple] = None) -> torch.Tensor:
    """Launch the light kernel of ``csrc/bigru_fwd.cu`` with a grid of one
    direction on the current stream: ``ys``. ``plan=("unit", rows)`` or
    ``("cluster", cluster, rows)`` overrides the route and the planner
    (raises if it does not fit). Counts each launch in
    ``gru_fwd_cuda.launches``. Its output carries no autograd history:
    ``gru_recurrence_kernel`` sends inputs that need a gradient to
    ``GRUFunction`` instead."""
    return _gru_fwd_launch(gru_fwd_cuda, False, xg, w, b, reverse, plan)[0]


gru_fwd_cuda.launches = 0


def gru_fwd_train_cuda(xg, w, b, reverse: bool = False,
                       plan: Optional[tuple] = None):
    """Launch the residual variant of ``csrc/bigru_fwd.cu`` with a grid of
    one direction: ``(ys, gates, hn)``; ``plan`` as ``gru_fwd_cuda``.
    Counts each launch in ``gru_fwd_train_cuda.launches``."""
    return _gru_fwd_launch(gru_fwd_train_cuda, True, xg, w, b, reverse, plan)


gru_fwd_train_cuda.launches = 0


def card_gru_bwd_unit_plans(B: int, H: int, dev: torch.device,
                            dtype: torch.dtype) -> List[int]:
    """``rnn_cuda.unit_plans`` of the one-direction GRU BPTT unit kernel on
    the card ``dev``, fastest first; the first is the tile a launch
    takes."""
    return card_unit_plans(_library("bigru_bwd"), "gru_bwd", B, H, dev,
                           dtype, False, 1)


def gru_bwd_cuda(w, gs, hn, ys, dy, reverse: bool = False,
                 plan: Optional[tuple] = None):
    """Launch ``csrc/bigru_bwd.cu`` with a grid of one direction:
    ``(dx, dhn)``. ``gru_bwd_kernel_route`` picks the unit kernel or the
    cluster kernel (kLinear); ``plan=("unit", rows)`` or ``("cluster",
    cluster, rows)`` overrides the route and the planner (raises if it does
    not fit). Records the plan in ``gru_bwd_cuda.last_launch`` and counts
    each launch in ``gru_bwd_cuda.launches``."""
    H = w.shape[0]
    B, N, G = gs.shape
    shapes = [tuple(t.shape) for t in (w, gs, hn, ys, dy)]
    if shapes != [(H, 3 * H), (B, N, 3 * H)] + [(B, N, H)] * 3:
        raise ValueError("gru_bwd: w must be [H, 3H], gs [B, N, 3H] and hn, "
                         f"ys, dy [B, N, H]; got {shapes}")
    streams = (gs, hn, ys, dy)
    dev = _check_cuda("gru_bwd", streams, (w,), ())
    T = gs.dtype
    outs = [torch.empty(B, N, d, dtype=T, device=dev) for d in (G, H)]
    if B == 0 or N == 0:
        return tuple(outs)
    w = w.to(T).contiguous()
    _gru_launch(gru_bwd_cuda, "gru_bwd", gru_bwd_kernel_route, False,
                [t.data_ptr() for t in (w, *streams, *outs)], B, N, H, dev, T,
                reverse, plan)
    return tuple(outs)


gru_bwd_cuda.launches = 0
