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

- ``bigru_bwd_split`` (#10): the BPTT with the coefficients unrounded and
  (where the kernel sums the carry per gate block) the carry's product as
  three H-deep sums, the counterpart of the JAX micro-benchmark's
  ``_bwd_kernel_split``. It takes ``bigru_bwd``'s route and plans, each
  kernel's kSplitCoef instance (``bigru_bwd_split_{unit,tc,reg,pipe}_*``);
  its first design, the split kind of the first cluster kernel, stays
  reachable by a forced ``("cluster", C, R)`` plan;
  ``tools/bench_bigru_bwd.py`` times it against ``bigru_bwd`` under the
  plans of the route's kernel (``plan=``);
- ``bigru_bwd_fused`` (#9): a whole BiGRU layer's VJP, the counterpart of
  ``gru_pallas.py::_bigru_bwd_fused_kernel``: ``bigru_bwd``'s walk and, in
  the same launch, dX, dW_ih, dW_hh and both biases; ``bigru_layer`` (a
  layer's gate products and recurrence, ``BiGRULayerFunction`` under grad)
  reaches it.

With grad enabled and an input that requires it, ``bigru_recurrence`` goes
through ``BiGRUFunction`` (training forward, then BPTT, then ``dW_hh`` and
``db_hh`` as matmuls and sums outside the kernel); otherwise it runs the
light forward through the custom op ``room_slam::bigru_fwd``
(``bigru_fwd_op``), which ``torch.export`` records as one node. The
tensor's device picks the implementation: a CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.

From H=65 to 256 one direction's W_hh does not fit the registers of one
block, so the kernels split it across the blocks of a thread-block
cluster. The register cluster kernels (``csrc/bigru_fwd_reg.cu``,
``csrc/bigru_bwd_reg.cu``; ``gru_fwd_kernel_route`` /
``gru_bwd_kernel_route`` say "reg") take these widths for float32 streams
in both grids, for bf16 with one direction and for bf16 with two where no
tensor-core plan fits: the LSTM's register scheme (``rnn_cuda.py``) with
three gates, each block's slice of W_hh in registers over a cluster of up
to 16 blocks, h (the BPTT: float32 partial sums of dh_carry, a K-split
summed in rank order at their owners) exchanged by ``st.async`` on
mbarriers; ``bigru_reg_plan`` picks the cluster and the tile of 1, 2, 4
or 8 rows from the card's own counts, and ``reg_route`` sends a forward
whose register grid needs more than ``REG_FWD_MAX_WAVES`` waves (the
scale-up batch of 128 rows in float32) to the forward pipe kernel. The
first cluster design (W_hh in shared memory, a cluster barrier a step;
``bigru_plan``) stays for the A/B, reached by a forced ``("cluster", C,
R)`` plan (or, for the two-direction wrappers, ``(C, R)``). With bf16
streams and both directions (the scale-up model's launches) ``bigru_fwd``,
``bigru_fwd_train`` and ``bigru_bwd`` run tensor-core kernels of the first
design's sources instead (the routes say "tc"): each warp holds its 8
units' slice of W_hh as ``mma.sync`` fragments in registers, a cluster of
4 or 8 blocks walks a batch tile of 16 or 32 rows, and ``bigru_tc_plan``
picks the plan from the card's own counts.

``gru_recurrence_kernel(xg, w_hh, b_hh, reverse)`` is one direction (the
counterpart of ``gru_pallas.py::gru_recurrence_pallas`` and its
``custom_vjp``; ``ops/rnn.py`` ``gru_recurrence(use_kernel=True)`` reaches
it). The same two sources launch it with a grid of one direction:
``gru_fwd``, ``gru_fwd_train`` and ``gru_bwd``, with ``GRUFunction`` joining
them. Their plain versions are ``ops/rnn.py`` ``gru_recurrence``,
``gru_fwd_train_plain`` (the same loop with ``residuals``) and
``gru_bwd_plain``. At H <= ``UNIT_MAX_H`` (the legacy model's H=64, the
``bigru`` model's at its default d_model) the one-direction forward and
BPTT, and the BiGRU's, run the unit kernels of
``csrc/bigru_fwd.cu`` and ``csrc/bigru_bwd.cu`` (with a grid of two
directions for a BiGRU layer) instead of the cluster kernels: four lanes
of a warp own one hidden unit of a tile of 1, 2 or 4 rows, W_hh in their
registers, one block barrier a step; ``gru_fwd_kernel_route`` /
``gru_bwd_kernel_route`` choose, ``rnn_cuda.unit_plan`` sizes the tile,
and ``last_launch`` records both. From H=65 to 256 the one-direction
launches take the register cluster kernels (as above). Above H=256 (to
``GRU_FWD_PIPE_MAX_H``, 1024) the forwards take the forward pipe kernel
(``csrc/bigru_fwd_pipe.cu``: the LSTM's design with three gates, W_hh
packed by ``rnn_cuda.fwd_pipe_weights``, planned by
``rnn_cuda.fwd_pipe_plans``), at the cluster kernel's widths too (faster
at H=320); above it
the stream kernels (the cluster kernels reading their slice of W_hh from
global memory every step, clusters of up to 16 blocks, planned by
``rnn_cuda.stream_plans``; the first design for these widths, reached
below by a forced ``("stream", C, R)`` plan). The BPTT above H=256 (to
H=1024) takes the pipe kernel (``csrc/bigru_pipe.cu``, both grids): each block of
a cluster of up to 16 forms dg for its own units and multiplies it by its
own slice of W_hh (packed by ``rnn_cuda.pipe_weights``, streamed through
shared memory by a producer warp), the float32 partial sums of dh_carry
summed in rank order at their owners; ``rnn_cuda.pipe_plans`` (three
gates) plans it. The stream BPTT stays for the widths above 1024 and, by a
forced ``("stream", C, R)`` plan, for the A/B.

With bf16 streams the fused kind (#9) runs its three input-side products on
tensor cores (``mma.sync``); with float32 streams on CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from room_slam_torch.ops.rnn import gru_recurrence, input_gates
from room_slam_torch.ops.rnn_cuda import (CLUSTER_MAX_H, CLUSTER_SIZES,
                                          MAX_ROWS, MAX_SMEM_BYTES,
                                          MAX_THREADS, FPIPE_MAX_CLUSTER,
                                          FPIPE_ROWS, GRU_REG_ROWS,
                                          PIPE_CELLS,
                                          PIPE_MAX_CLUSTER, PIPE_ROWS,
                                          REG_MAX_CLUSTER, REG_MAX_THREADS,
                                          ROWS_PER_THREAD,
                                          STREAM_MAX_CLUSTER,
                                          UNIT_MAX_H, UNIT_ROWS, _bind_pipe,
                                          _device_type, _fwd_pipe_rule,
                                          _pad4, _pipe_rule, _reg_rule,
                                          _stream_rule, _work_dtype,
                                          bind_fwd_pipe, bind_unit_queries,
                                          bwd_weights, fwd_pipe_plans,
                                          fwd_pipe_takes, fwd_weights,
                                          card_name, card_unit_plans,
                                          check_reg_mirror,
                                          check_stream_mirror, grad_product,
                                          grad_sum, launch, pipe_plans,
                                          pipe_takes, prev_steps,
                                          rank_cluster_plans, reg_plans,
                                          reg_takes,
                                          set_error_string, slice_units,
                                          stream_plans, stream_refusal,
                                          stream_takes, unit_launch_rows)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


# ---------------------------------------------------------------------------
# Launch planning (mirrors smem_bytes and the grid of csrc/bigru_*.cu)
# ---------------------------------------------------------------------------


# The plan rule and shared memory mirror valid_plan and smem_bytes of
# csrc/bigru_fwd.cu and csrc/bigru_bwd.cu; _library checks them against the
# built source (bigru_*_smem_bytes) before the first launch.
KIND_THREADS = {"fwd": MAX_THREADS, "bwd": MAX_THREADS, "split": MAX_THREADS,
                "fused": 256}   # __launch_bounds__ of each kernel kind
# kFusedStageFloats (a ring of four staged bf16 buffers of two 128 x 32
# tiles, rows padded by 8) and kChunk
_FUSED_STAGE, _FUSED_CHUNK = 4 * (128 + 128) * (32 + 8) // 2, 96


def bigru_smem_bytes(kind: str, hidden: int, cluster: int, rows: int) -> int:
    """Dynamic shared memory one block of ``kind`` needs: its W_hh slice
    (of ``slice_units`` units) and a double-buffered exchange tile, both
    float32 (a bf16 value is exact in float32). ``kind`` is "fwd" (both
    forward kernels), "bwd" (the BPTT, #6), "split" (#10, as "bwd") or
    "fused" (#9: the exchange tile doubles as the products' staging region,
    grown to ``_FUSED_STAGE`` floats where smaller, then a chunk's sample
    indices)."""
    U = slice_units(hidden, cluster)
    if kind == "fwd":    # W_hh[:, r|z|n of its U units] and h_{t-1} [H, R]
        return (_pad4(hidden * 3 * U) + 2 * hidden * rows) * 4
    # W_hh[its U units, :]^T and the gate cotangent dg [3H, R]
    tile = 2 * 3 * hidden * rows
    if kind == "fused":
        tile = max(tile, _FUSED_STAGE) + _FUSED_CHUNK * rows
    return (_pad4(3 * hidden * U) + tile) * 4


def _plan_rule(kind: str, hidden: int, cluster: int, rows: int) -> bool:
    """Every block of the cluster owns a unit at least (a slice of
    ``slice_units`` units, the last one masked past H where the cluster
    does not divide H; the fused kind: the cluster divides H into multiples
    of 16 units per block), the tile is a multiple of ``ROWS_PER_THREAD``
    and the threads are within the kind's launch bound."""
    if cluster not in CLUSTER_SIZES or hidden <= 0 or rows <= 0 \
            or rows % ROWS_PER_THREAD:
        return False
    U = slice_units(hidden, cluster)
    if kind == "fused" and (hidden % cluster or U % 16):
        return False
    return ((cluster - 1) * U < hidden
            and U * (rows // ROWS_PER_THREAD) <= KIND_THREADS[kind])


def plan_fits(kind: str, hidden: int, cluster: int, rows: int) -> bool:
    """Whether a block of ``kind`` at this cluster size and batch tile fits
    the kernel: ``_plan_rule`` holds and shared memory is within one
    block's."""
    return (_plan_rule(kind, hidden, cluster, rows)
            and bigru_smem_bytes(kind, hidden, cluster, rows)
            <= MAX_SMEM_BYTES)


def _check_mirror(lib, name: str = "bigru_bwd") -> None:
    """Hold ``_plan_rule`` and ``bigru_smem_bytes`` of the kinds of
    ``name`` ("bigru_fwd": "fwd"; "bigru_bwd": the BPTT kinds) to the built
    source (``bigru_fwd_smem_bytes`` / ``bigru_bwd_smem_bytes``: bytes, or
    -1 for a plan the kind does not take) over H in 9..512, dividing and
    masked slices, and every cluster size and tile; raises on the first
    plan where they differ."""
    if name == "bigru_fwd":
        kinds = {"fwd": lambda h, c, r: lib.bigru_fwd_smem_bytes(h, c, r)}
    else:
        kinds = {k: (lambda h, c, r, code=code:
                     lib.bigru_bwd_smem_bytes(code, h, c, r))
                 for k, code in _BWD_KINDS.items()}
    for kind, query in kinds.items():
        for hidden in (9, 16, 48, 64, 128, 139, 201, 250, 255, 256, 512):
            for c in CLUSTER_SIZES:
                for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1,
                                  ROWS_PER_THREAD):
                    want = (bigru_smem_bytes(kind, hidden, c, rows)
                            if _plan_rule(kind, hidden, c, rows) else -1)
                    got = query(hidden, c, rows)
                    if got != want:
                        raise RuntimeError(
                            f"bigru_{kind}: the wrapper's plan mirror gives "
                            f"{want} bytes at H={hidden}, plan {c}x{rows}, "
                            f"csrc/{name}.cu {got}: update KIND_THREADS, "
                            "_FUSED_* or bigru_smem_bytes to match the "
                            "source")


def bigru_plans(kind: str, batch: int, hidden: int,
                resident: Callable[[int, int], int],
                dirs: int = 2) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` that fits kernel ``kind`` at this batch and
    H over ``dirs`` directions (2 for a BiGRU layer, 1 for a GRU), the
    batch tile a multiple of ``ROWS_PER_THREAD`` up to ``MAX_ROWS``,
    fastest first (``rank_cluster_plans``: the block's threads, at least
    128, times the waves of the grid by the card's own resident count).

    Plans whose cluster size divides H come first and alone: masked plans
    (a last slice short of ``slice_units``) are considered only where no
    dividing plan fits, and only up to ``CLUSTER_MAX_H``, so every H a
    dividing plan takes keeps its pick."""
    def plans(masked: bool):
        return rank_cluster_plans(
            [(c, rows) for c in CLUSTER_SIZES
             for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1,
                               ROWS_PER_THREAD)
             if (masked or hidden % c == 0)
             and plan_fits(kind, hidden, c, rows)],
            batch, hidden, resident, dirs)

    found = plans(False)
    if not found and hidden <= CLUSTER_MAX_H:
        found = plans(True)
    return found


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
            f"{hidden} (above H={CLUSTER_MAX_H} it must divide H, and the "
            "W_hh slice plus the exchange tile must fit "
            f"{MAX_SMEM_BYTES} bytes of shared memory per block)")
    return plans[0]


# ---------------------------------------------------------------------------
# The tensor-core kernels (bigru_fwd_tc_kernel, bigru_bwd_tc_kernel): bf16
# streams, both directions; the plan rule and layout mirror valid_tc_plan,
# tc_smem_bytes and tc_threads of csrc/bigru_*.cu, held to the built
# sources by bigru_*_tc_layout when a library loads
# ---------------------------------------------------------------------------

TC_CLUSTER_SIZES = (4, 8)   # the planner's cluster sizes
TC_ROWS = (16, 32)          # batch tiles: one or two m16 tiles
TC_MAX_H = 256              # kTcMaxH: W_hh fragments a warp holds
TC_MAX_THREADS = 256        # 8 warps of up to 255 registers fill an SM's file
TC_PAD = 8                  # bf16 padding of a tile row (conflict-free ldmatrix)
# W_hh fragment registers a lane holds: three n8 tiles (r, z, n) over H/16
# k-steps in the forward, three gate blocks of H/16 k-steps in the BPTT
TC_WEIGHT_REGS = 3 * (TC_MAX_H // 16) * 2
TC_RING = {16: 4, 32: 3}     # steps of staged inputs by tile (tc_ring)
# staged input and output streams: the forward's xg (r, z, n) in, ys, r,
# z, n and hn out; the BPTT's r, z, n, hn, h_prev and dy in, dx (r, z, n)
# and dhn out
TC_STREAMS = {"fwd": (3, 5), "bwd": (6, 4)}


def tc_smem_bytes(kind: str, hidden: int, cluster: int, rows: int) -> int:
    """Dynamic shared memory one block of the tensor-core kernel ``kind``
    ("fwd": both forward variants; "bwd": the BPTT) needs, in bf16 values
    times two: the double-buffered tile of h_{t-1} [R, H] or dg [R, 3H],
    whatever H as wide as at ``TC_MAX_H`` (the product runs every k-step,
    past H on zeros), rows padded by ``TC_PAD``; then the block's streams
    staged as rows of its U units (padded by ``TC_PAD``): a ring of
    ``TC_RING`` steps of inputs and two steps of outputs."""
    tile = (TC_MAX_H if kind == "fwd" else 3 * TC_MAX_H) + TC_PAD
    ldq = hidden // cluster + TC_PAD
    n_in, n_out = TC_STREAMS[kind]
    return (2 * rows * tile
            + (TC_RING[rows] * n_in + 2 * n_out) * rows * ldq) * 2


def tc_threads(hidden: int, cluster: int) -> int:
    """Threads of a tensor-core block: a warp for each 8 of its units."""
    return 4 * (hidden // cluster)


def _tc_rule(hidden: int, cluster: int, rows: int) -> bool:
    """H a multiple of 16 up to ``TC_MAX_H``, the cluster dividing H into a
    whole number of 8-unit warps (U / 8 warps of up to 255 registers, at
    most ``TC_MAX_THREADS`` threads: C = 2 at H=256 would need 16), and one
    or two m16 tiles of rows."""
    if cluster not in CLUSTER_SIZES or rows not in TC_ROWS or hidden <= 0 \
            or hidden % 16 or hidden > TC_MAX_H or hidden % cluster:
        return False
    units = hidden // cluster
    return units % 8 == 0 and tc_threads(hidden, cluster) <= TC_MAX_THREADS


def tc_plan_fits(kind: str, hidden: int, cluster: int, rows: int) -> bool:
    """Whether the tensor-core kernel ``kind`` takes this cluster size and
    batch tile at H: ``_tc_rule`` holds and the tile fits a block's shared
    memory."""
    return (_tc_rule(hidden, cluster, rows)
            and tc_smem_bytes(kind, hidden, cluster, rows) <= MAX_SMEM_BYTES)


def check_tc_mirror(layout, kind: str) -> None:
    """Hold ``_tc_rule``, ``tc_smem_bytes``, ``tc_threads`` and
    ``TC_WEIGHT_REGS`` to a built source's ``bigru_<kind>_tc_layout(what,
    H, C, R)`` over H, every cluster size and a few tiles (-1 for a plan
    the kernel does not take); raises naming the first plan where they
    differ."""
    for hidden in (16, 24, 32, 48, 64, 96, 128, 256, 272, 512):
        for c in CLUSTER_SIZES:
            for rows in (8, *TC_ROWS, 24, 48):
                want = ((tc_smem_bytes(kind, hidden, c, rows),
                         tc_threads(hidden, c), TC_WEIGHT_REGS)
                        if _tc_rule(hidden, c, rows) else (-1, -1, -1))
                got = tuple(layout(what, hidden, c, rows) for what in range(3))
                if got != want:
                    raise RuntimeError(
                        f"bigru_{kind}_tc: the wrapper's tensor-core mirror "
                        f"gives {want} (shared bytes, threads, W_hh "
                        f"registers) at H={hidden}, plan {c}x{rows}, the "
                        f"built source {got}: update TC_* or tc_smem_bytes "
                        "to match the source")


def _tc_cost(batch: int, hidden: int, cluster: int, rows: int,
             sms: int) -> tuple:
    """A step's cost between plans that run in one wave, the order an
    H100 sweep of every plan gave at the scale-up width (B=128 and B=1,
    all three kernels): one m16 tile before two (twice the ``mma.sync``
    chain and the bytes a block exchanges); then plans whose grid leaves
    half the card's ``sms`` free (clusters of 8 that spread over more share
    the card's GPCs and lost to clusters of 4 at B=128, while they won at
    B=1); then the ``mma.sync`` work of one SM scheduler (U / 8 warps a
    block over four schedulers, times the m16 tiles); then the smaller
    cluster."""
    blocks = 2 * -(-batch // rows) * cluster
    warps = hidden // cluster // 8
    return (rows // 16, blocks > sms // 2, max(1, warps // 4) * (rows // 16),
            cluster)


def bigru_tc_plans(kind: str, batch: int, hidden: int,
                   resident: Callable[[int, int], int],
                   sms: int) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` of ``TC_CLUSTER_SIZES`` x ``TC_ROWS`` that
    the tensor-core kernel ``kind`` ("fwd" or "bwd") takes at this batch
    and H over two directions, fastest first: plans whose grid needs a
    second wave (``resident(cluster, rows)`` clusters run at once, the
    card's own count) last, then by ``_tc_cost`` on a card of ``sms``
    SMs."""
    keys = []
    for c in TC_CLUSTER_SIZES:
        for rows in TC_ROWS:
            if not tc_plan_fits(kind, hidden, c, rows):
                continue
            at_once = resident(c, rows)
            if at_once <= 0:
                continue
            waves = -(-2 * -(-batch // rows) // at_once)
            keys.append((waves, _tc_cost(batch, hidden, c, rows, sms), c,
                         rows))
    return [(c, rows) for *_, c, rows in sorted(keys)]


def bigru_tc_plan(kind: str, batch: int, hidden: int,
                  resident: Callable[[int, int], int],
                  sms: int) -> Tuple[int, int]:
    """``(cluster, rows)`` of the tensor-core kernel ``kind``: the first of
    ``bigru_tc_plans``. Raises where the card runs no plan."""
    plans = bigru_tc_plans(kind, batch, hidden, resident, sms)
    if not plans:
        raise ValueError(
            f"bigru_{kind}_tc: no plan of {TC_CLUSTER_SIZES} x {TC_ROWS} "
            f"takes H={hidden} on this card")
    return plans[0]


def cluster_takes(kind: str, hidden: int) -> bool:
    """Whether a plan of the cluster kernel ``kind`` that ``bigru_plans``
    considers fits at H: a dividing plan, or a masked one up to
    ``CLUSTER_MAX_H`` (whether the card runs it is the planner's
    question)."""
    return any(plan_fits(kind, hidden, c, rows)
               and (hidden % c == 0 or hidden <= CLUSTER_MAX_H)
               for c in CLUSTER_SIZES
               for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1,
                                 ROWS_PER_THREAD))


# ---------------------------------------------------------------------------
# The register cluster kernels (csrc/bigru_fwd_reg.cu, csrc/bigru_bwd_reg.cu):
# the LSTM's register scheme with three gates, so that rnn_cuda's register
# plan rule, layout mirror and planner take gates=3
# ---------------------------------------------------------------------------

REG_GATES = 3


def bigru_reg_plans(kind: str, batch: int, hidden: int,
                    resident: Callable[[int, int], int],
                    dirs: int = 2) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` the GRU register cluster kernel ``kind``
    ("fwd": both forward variants; "bwd": the BPTT) takes at this batch and
    H over ``dirs`` directions, fastest first (``rnn_cuda.rank_reg_plans``
    with three gates: ``resident(cluster, rows)`` is the card's own count
    of such clusters at once)."""
    return reg_plans(kind, batch, hidden, resident, dirs, REG_GATES)


def bigru_reg_plan(kind: str, batch: int, hidden: int,
                   resident: Callable[[int, int], int],
                   dirs: int = 2) -> Tuple[int, int]:
    """``(cluster, rows)`` of the GRU register cluster kernel ``kind``: the
    first of ``bigru_reg_plans``. Raises where the card runs no plan."""
    plans = bigru_reg_plans(kind, batch, hidden, resident, dirs)
    if not plans:
        raise ValueError(f"bigru_{kind}_reg: no plan of 1 to "
                         f"{REG_MAX_CLUSTER} blocks takes H={hidden} on this "
                         "card")
    return plans[0]


# A forward launch whose register grid needs more waves than this (the
# card's resident clusters of its plan) takes the forward pipe kernel: at
# the scale-up batch (128, 5000, 256) f32 the register grid's three waves
# lost to the pipe kernel's one on an H100 (chip_smoke.py phase 41 times
# both in turns; the BPTT's register grid won there and keeps the route)
REG_FWD_MAX_WAVES = 2


def reg_waves(kind: str, batch: int, hidden: int,
              resident: Callable[[int, int], int], dirs: int = 2) -> int:
    """The waves of the register kernel ``kind``'s grid at its planner's
    pick: ``dirs`` x ceil(B / R) clusters, ``resident(C, R)`` at once."""
    c, rows = bigru_reg_plan(kind, batch, hidden, resident, dirs)
    return -(-dirs * -(-batch // rows) // resident(c, rows))


def reg_route(kind: str, batch: int, hidden: int,
              resident: Callable[[int, int], int], dirs: int = 2) -> str:
    """Where a launch the route sends to the register kernel ``kind`` goes
    at this batch: "pipe" for a forward whose register grid needs more
    than ``REG_FWD_MAX_WAVES`` waves (where the forward pipe kernel takes
    H), else "reg"."""
    if kind == "fwd" and fwd_pipe_takes(hidden) and reg_waves(
            kind, batch, hidden, resident, dirs) > REG_FWD_MAX_WAVES:
        return "pipe"
    return "reg"


# The BPTT's pipe kernel (csrc/bigru_pipe.cu): three gates, so that
# rnn_cuda's pipe planner, layout mirror and W_hh packing take gates=3
PIPE_GATES = 3
# The forward's pipe kernel (csrc/bigru_fwd_pipe.cu) is routed above
# CLUSTER_MAX_H up to GRU_FWD_PIPE_MAX_H (the widest width its A/B times,
# chip_smoke.py phase 40)
GRU_FWD_PIPE_MAX_H = 1024


def _route(kind: str, hidden: int, dirs: int, dtype: torch.dtype) -> str:
    name = f"bigru_{kind}"
    if hidden <= 0:
        raise ValueError(f"{name}: H must be positive, got {hidden}")
    if hidden <= UNIT_MAX_H:
        return "unit"
    if dirs == 2 and dtype == torch.bfloat16 and any(
            tc_plan_fits(kind, hidden, c, r)
            for c in TC_CLUSTER_SIZES for r in TC_ROWS):
        return "tc"
    if hidden <= CLUSTER_MAX_H and reg_takes(kind, hidden, REG_GATES):
        return "reg"
    # above CLUSTER_MAX_H the BPTT takes the pipe kernel also where a
    # kLinear plan fits (the multiples of 8 up to 360): faster at H=320,
    # where chip_smoke.py phase 40 times the two in turns
    if kind == "bwd" and hidden > CLUSTER_MAX_H and \
            pipe_takes(hidden, PIPE_GATES):
        return "pipe"
    # above CLUSTER_MAX_H the pipe kernels take the launch also where a
    # cluster plan fits (the multiples of 8 up to 360): faster at H=320,
    # where chip_smoke.py phase 40 times the two in turns
    if kind == "fwd" and CLUSTER_MAX_H < hidden <= GRU_FWD_PIPE_MAX_H \
            and fwd_pipe_takes(hidden):
        return "pipe"
    if cluster_takes(kind, hidden):
        return "cluster"
    if stream_takes(name, hidden):
        return "stream"
    raise ValueError(
        f"{name}: no kernel takes H={hidden} on this card: no cluster of "
        f"{CLUSTER_SIZES} blocks holds W_hh's slice and the exchange tile in "
        f"{MAX_SMEM_BYTES} bytes a block, and {stream_refusal(name, hidden)}")


def gru_fwd_kernel_route(hidden: int, dirs: int,
                         dtype: torch.dtype = torch.float32) -> str:
    """The forward kernel of ``csrc/bigru_fwd.cu`` that takes a launch of
    ``dirs`` directions at hidden size ``hidden`` with ``dtype`` streams
    (whatever the batch): "unit" at H <= ``UNIT_MAX_H`` (one or two
    directions, float32 or bf16: at H=64 it beat the tensor-core kernels
    2-2.5x with bf16 streams on an H100); "tc" (the tensor-core kernel)
    above it for two directions with bf16 streams where ``tc_plan_fits``
    holds for a plan of the planner's; else "reg" (the register cluster
    kernel, ``csrc/bigru_fwd_reg.cu``) up to ``CLUSTER_MAX_H``
    (``bigru_reg_plan`` picks its cluster and tile; ``reg_route`` may send
    a batch whose register grid needs more waves to the pipe kernel);
    above it up to ``GRU_FWD_PIPE_MAX_H`` "pipe" (the forward pipe kernel,
    ``csrc/bigru_fwd_pipe.cu``; also where a cluster plan fits); else
    "cluster" where a plan of ``bigru_plans`` fits (the first design,
    ``bigru_plan`` picks its cluster and tile; also reached by a forced
    ``("cluster", C, R)`` plan), else "stream" (the first stream design,
    ``bigru_stream_plans``; also reached by a forced plan). Raises, naming
    the width and the card's limit, for an H none takes."""
    return _route("fwd", hidden, dirs, dtype)


def gru_bwd_kernel_route(hidden: int, dirs: int,
                         dtype: torch.dtype = torch.float32) -> str:
    """The BPTT kernel of ``csrc/bigru_bwd.cu`` (or, "pipe",
    ``csrc/bigru_pipe.cu``) that takes a launch of ``dirs`` directions at
    hidden size ``hidden`` with ``dtype`` streams: "unit"
    (``gru_bwd_unit_kernel``) at H <= ``UNIT_MAX_H``; "tc"
    (``bigru_bwd_tc_kernel``) above it for two directions with bf16 streams
    where ``tc_plan_fits`` holds; else "reg" (the register cluster kernel,
    ``csrc/bigru_bwd_reg.cu``) up to ``CLUSTER_MAX_H`` (``reg_route`` as
    the forward's); above it "pipe" (the pipe kernel) where a plan of it
    takes H (to H=1024), else "stream" (the first stream design, also
    reached below by a forced plan). kLinear's cluster kernel, the first
    design up to H=256, is reached by a forced ``("cluster", C, R)`` plan.
    Raises, naming the width and the card's limit, for an H none takes."""
    return _route("bwd", hidden, dirs, dtype)


def bigru_stream_plans(kind: str, batch: int, hidden: int,
                       resident: Callable[[int, int], int], dirs: int = 2,
                       wbytes: int = 4) -> List[Tuple[int, int]]:
    """``rnn_cuda.stream_plans`` of the BiGRU stream kernel ``kind`` ("fwd"
    or "bwd"): every ``(cluster, rows)`` it takes, fastest first."""
    return stream_plans(f"bigru_{kind}", batch, hidden, resident, dirs,
                        wbytes)


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
    dx_z, dhn]`` of one direction, summed in float32 (float64 for float64
    streams) and returned in ``dtype``. Two products instead of a
    ``[B, N, 3H]`` concatenation, as the reference does (``:582-594``);
    with bf16 streams on the card the products take the bf16 streams as
    they are (``rnn_cuda.grad_product``: float32 sums and result)."""
    H = ys.shape[-1]
    hp = prev_steps(ys, reverse).reshape(-1, H)
    d2 = dx[..., :2 * H].reshape(-1, 2 * H)
    dn = dhn.reshape(-1, H)
    dw = torch.cat([grad_product(hp.t(), d2), grad_product(hp.t(), dn)],
                   dim=-1)
    db = torch.cat([grad_sum(d2), grad_sum(dn)])
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


@torch.library.custom_op("room_slam::bigru_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def bigru_fwd_op(xg_f: torch.Tensor, xg_b: torch.Tensor, w_f: torch.Tensor,
                 b_f: torch.Tensor, w_b: torch.Tensor, b_b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The light forward of one BiGRU layer as the custom op
    ``room_slam::bigru_fwd``: kernel #5 (``bigru_fwd_cuda``, launch or
    raise) for CUDA tensors, the plain version for CPU tensors. One body
    for both dispatch keys, picking by ``_device_type`` as the recurrences
    always did; ``torch.export`` records it as one node."""
    tensors = (xg_f, xg_b, w_f, b_f, w_b, b_b)
    if _device_type("bigru_fwd", *tensors) == "cpu":
        return bigru_fwd_plain(*tensors)
    return bigru_fwd_cuda(*tensors)


@bigru_fwd_op.register_fake
def _(xg_f, xg_b, w_f, b_f, w_b, b_b):
    B, N, H = xg_f.shape[0], xg_f.shape[1], w_f.shape[0]
    return xg_f.new_empty(B, N, H), xg_f.new_empty(B, N, H)


def bigru_recurrence(xg_f: torch.Tensor, xg_b: torch.Tensor,
                     w_f: torch.Tensor, b_f: torch.Tensor,
                     w_b: torch.Tensor, b_b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of one BiGRU layer (see module docstring)."""
    tensors = (xg_f, xg_b, w_f, b_f, w_b, b_b)
    _check_shapes(*tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return BiGRUFunction.apply(*tensors)
    return torch.ops.room_slam.bigru_fwd(*tensors)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _library(name: str):
    from room_slam_torch.ops.build import load_library

    lib = load_library(name)
    if getattr(lib, "_argtypes_set", False):
        return lib
    if name == "bigru_pipe":
        for sfx in _SUFFIX.values():   # #10's entries: bigru_bwd_pipe_*'s
            fn = getattr(lib, f"bigru_bwd_split_pipe_{sfx}")
            fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        return _bind_pipe(lib, name, "bigru_bwd", "gru_bwd", 14, 7,
                          PIPE_GATES)
    if name == "bigru_fwd_pipe":
        return bind_fwd_pipe(lib, {"bigru_fwd": 8, "bigru_fwd_train": 12},
                             {"gru_fwd": 4, "gru_fwd_train": 6}, PIPE_GATES)
    if name in ("bigru_fwd_reg", "bigru_bwd_reg"):
        return _bind_reg(lib, name)
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
                   f"gru_fwd_unit_train_{sfx}": (6, 5),
                   f"bigru_fwd_unit_{sfx}": (8, 4),
                   f"bigru_fwd_unit_train_{sfx}": (12, 4),
                   f"bigru_fwd_stream_{sfx}": (8, 5),
                   f"bigru_fwd_train_stream_{sfx}": (12, 5),
                   f"gru_fwd_stream_{sfx}": (4, 6),
                   f"gru_fwd_train_stream_{sfx}": (6, 6)}
        else:
            fns = {f"bigru_bwd_{sfx}": (14, 5),
                   f"bigru_bwd_split_{sfx}": (14, 5),
                   f"bigru_bwd_fused_{sfx}": (28, 6),
                   f"gru_bwd_{sfx}": (7, 6),
                   f"gru_bwd_unit_{sfx}": (7, 5),
                   f"bigru_bwd_unit_{sfx}": (14, 4),
                   f"bigru_bwd_split_unit_{sfx}": (14, 4),
                   f"bigru_bwd_stream_{sfx}": (14, 5),
                   f"gru_bwd_stream_{sfx}": (7, 6)}
        for fn_name, (n_ptr, n_int) in fns.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = ctypes.c_int
    # the tensor-core kernels: bf16 only, the pointers of the cluster
    # entries, then B, N, H, C, R
    tc = ({"bigru_fwd_tc_bf16": 8, "bigru_fwd_train_tc_bf16": 12} if fwd
          else {"bigru_bwd_tc_bf16": 14, "bigru_bwd_split_tc_bf16": 14})
    for fn_name, n_ptr in tc.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = [p] * n_ptr + [i] * 5 + [p]
        fn.restype = ctypes.c_int
    clusters = getattr(lib, f"{name}_max_active_clusters")
    # the bf16 flag, the kSave flag (fwd) or kind (bwd), then H, C, R
    clusters.argtypes = [i] * 5
    clusters.restype = ctypes.c_int
    # the kSave flag (ignored by the BPTT), then H, C, R; what, H, C, R
    for query in ("max_active_clusters", "layout"):
        fn = getattr(lib, f"{name}_tc_{query}")
        fn.argtypes = [i] * 4
        fn.restype = ctypes.c_int
    check_tc_mirror(getattr(lib, f"{name}_tc_layout"), name[len("bigru_"):])
    # the stream kernel: the bf16 and kSave flags, H, C, R; H, C, R
    for query, n_int in (("stream_max_active_clusters", 5),
                         ("stream_smem_bytes", 3)):
        fn = getattr(lib, f"{name}_{query}")
        fn.argtypes = [i] * n_int
        fn.restype = ctypes.c_int
    check_stream_mirror(getattr(lib, f"{name}_stream_smem_bytes"), name)
    # (kind,) H, C, R
    smem_query = getattr(lib, f"{name}_smem_bytes")
    smem_query.argtypes = [i] * (3 if fwd else 4)
    smem_query.restype = ctypes.c_int
    _check_mirror(lib, name)
    if fwd:
        bind_unit_queries(lib, "gru_fwd", gates=3)
    else:
        bind_unit_queries(lib, "gru_bwd", gates=3, tiles=3)
    set_error_string(lib, name)
    return lib


def _bind_reg(lib, name: str):
    """Bind a register cluster kernel's library ``name``
    (``csrc/bigru_fwd_reg.cu``, ``csrc/bigru_bwd_reg.cu``): the entries of
    both grids (the cluster entries' pointers, then B, N, H, C, R, and a
    grid of one direction's reverse flag) and the queries
    ``<name>_max_active_clusters`` (the bf16 and kSave flags, H, C, R) and
    ``<name>_layout`` (what, H, C, R), held to ``rnn_cuda.reg_smem_bytes``
    / ``_reg_rule`` with three gates (``check_reg_mirror``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    kind = name[len("bigru_"):-len("_reg")]
    entries = ({"bigru_fwd_reg": (8, 5), "bigru_fwd_train_reg": (12, 5),
                "gru_fwd_reg": (4, 6), "gru_fwd_train_reg": (6, 6)}
               if kind == "fwd" else
               {"bigru_bwd_reg": (14, 5), "bigru_bwd_split_reg": (14, 5),
                "gru_bwd_reg": (7, 6)})
    for sfx in _SUFFIX.values():
        for fn_name, (n_ptr, n_int) in entries.items():
            fn = getattr(lib, f"{fn_name}_{sfx}")
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = ctypes.c_int
    for query, n_int in (("max_active_clusters", 5), ("layout", 4)):
        fn = getattr(lib, f"{name}_{query}")
        fn.argtypes = [i] * n_int
        fn.restype = i
    check_reg_mirror(getattr(lib, f"{name}_layout"), kind, REG_GATES)
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


def _tc_resident(kind: str, H: int, dev: torch.device, save: bool):
    """The kernel library of the tensor-core kernel ``kind`` ("fwd" or
    "bwd"), ``resident(cluster, rows)``: how many clusters of that plan the
    card ``dev`` runs at once, and the card's SM count."""
    lib = _library(f"bigru_{kind}")
    query = getattr(lib, f"bigru_{kind}_tc_max_active_clusters")

    def resident(c, rows):
        with torch.cuda.device(dev):
            return query(int(save), H, c, rows)

    return (lib, resident,
            torch.cuda.get_device_properties(dev).multi_processor_count)


def _stream_resident(kind: str, H: int, dev: torch.device, T, save: bool):
    """The kernel library of the stream kernel ``kind`` ("fwd" or "bwd")
    and ``resident(cluster, rows)``: how many clusters of that plan the
    card ``dev`` runs at once."""
    lib = _library(f"bigru_{kind}")
    query = getattr(lib, f"bigru_{kind}_stream_max_active_clusters")

    def resident(c, rows):
        with torch.cuda.device(dev):
            return query(int(T == torch.bfloat16), int(save), H, c, rows)

    return lib, resident


def card_stream_plans(kind: str, B: int, H: int, dev: torch.device,
                      dtype: torch.dtype, save: bool = False,
                      dirs: int = 2) -> List[Tuple[int, int]]:
    """``bigru_stream_plans`` of the stream kernel ``kind`` ("fwd" or
    "bwd") on the card ``dev`` (its own counts), fastest first; the first
    is the plan a launch takes."""
    return bigru_stream_plans(
        kind, B, H, _stream_resident(kind, H, dev, dtype, save)[1], dirs,
        dtype.itemsize)


def _pipe_resident(H: int, dev: torch.device, T):
    """The pipe kernel's library (``csrc/bigru_pipe.cu``) and
    ``resident(cluster, rows)``: how many clusters of that plan the card
    ``dev`` runs at once."""
    lib = _library("bigru_pipe")
    query = lib.bigru_bwd_pipe_max_active_clusters

    def resident(c, rows):
        with torch.cuda.device(dev):
            return query(int(T == torch.bfloat16), 0, H, c, rows)

    return lib, resident


def _fwd_pipe_resident(H: int, dev: torch.device, T, save: bool):
    """The forward pipe kernel's library (``csrc/bigru_fwd_pipe.cu``) and
    ``resident(cluster, rows)``: how many clusters of that plan the card
    ``dev`` runs at once."""
    lib = _library("bigru_fwd_pipe")
    query = lib.bigru_fwd_pipe_max_active_clusters

    def resident(c, rows):
        with torch.cuda.device(dev):
            return query(int(T == torch.bfloat16), int(save), H, c, rows)

    return lib, resident


def _reg_resident(kind: str, H: int, dev: torch.device, T, save: bool):
    """The register cluster kernel ``kind``'s library
    (``csrc/bigru_fwd_reg.cu`` or ``csrc/bigru_bwd_reg.cu``) and
    ``resident(cluster, rows)``: how many clusters of that plan the card
    ``dev`` runs at once."""
    lib = _library(f"bigru_{kind}_reg")
    query = getattr(lib, f"bigru_{kind}_reg_max_active_clusters")

    def resident(c, rows):
        with torch.cuda.device(dev):
            return query(int(T == torch.bfloat16), int(save), H, c, rows)

    return lib, resident


def card_gru_reg_plans(kind: str, B: int, H: int, dev: torch.device,
                       dtype: torch.dtype, save: bool = False,
                       dirs: int = 2) -> List[Tuple[int, int]]:
    """``bigru_reg_plans`` of the register cluster kernel ``kind`` ("fwd"
    or "bwd") over ``dirs`` directions on the card ``dev`` (its own
    counts), fastest first; the first is the plan a launch takes."""
    return bigru_reg_plans(kind, B, H,
                           _reg_resident(kind, H, dev, dtype, save)[1], dirs)


def card_gru_fwd_pipe_plans(B: int, H: int, dev: torch.device,
                            dtype: torch.dtype, save: bool = False,
                            dirs: int = 2) -> List[Tuple[int, int]]:
    """``rnn_cuda.fwd_pipe_plans`` of the GRU forward's pipe kernel (three
    gates) over ``dirs`` directions on the card ``dev`` (its own counts),
    fastest first; the first is the plan a launch takes."""
    return fwd_pipe_plans(B, H, _fwd_pipe_resident(H, dev, dtype, save)[1],
                          dirs, dtype.itemsize, PIPE_GATES)


def card_gru_pipe_plans(B: int, H: int, dev: torch.device,
                        dtype: torch.dtype,
                        dirs: int = 2) -> List[Tuple[int, int]]:
    """``rnn_cuda.pipe_plans`` of the GRU BPTT's pipe kernel (three gates)
    over ``dirs`` directions on the card ``dev`` (its own counts), fastest
    first; the first is the plan a launch takes."""
    return pipe_plans(B, H, _pipe_resident(H, dev, dtype)[1], dirs,
                      dtype.itemsize, PIPE_GATES)


def card_tc_plans(kind: str, B: int, H: int, dev: torch.device
                  ) -> List[Tuple[int, int]]:
    """``bigru_tc_plans`` of the tensor-core kernel behind wrapper ``kind``
    ("fwd", "fwd_train" or "bwd") on the card ``dev`` (its own
    resident-cluster counts), fastest first; the first is the plan a launch
    takes."""
    src = "bwd" if kind == "bwd" else "fwd"
    _, resident, sms = _tc_resident(src, H, dev, kind == "fwd_train")
    return bigru_tc_plans(src, B, H, resident, sms)


def card_plans(kind: str, B: int, H: int, dev: torch.device,
               dtype: torch.dtype, dirs: int = 2) -> List[Tuple[int, int]]:
    """``bigru_plans`` of kernel ``kind`` on the card ``dev`` (its own
    resident-cluster counts), fastest first; the first is the plan a launch
    takes."""
    return bigru_plans(kind, B, H, _resident(kind, H, dev, dtype, False)[1],
                       dirs)


def bwd_plan_fits(plan: tuple, hidden: int, dtype: torch.dtype) -> bool:
    """Whether a forced plan of the two-direction BPTT (#6's or #10's:
    ``("tc" | "reg" | "pipe" | "stream" | "cluster", C, R)`` or ``("unit",
    R)``) fits its kernel's rule at H with ``dtype`` streams, whatever the
    card (which may still run no such cluster)."""
    kernel, *ints = plan
    if kernel == "unit":
        return hidden <= UNIT_MAX_H and ints[0] in UNIT_ROWS
    cluster, rows = ints
    return {"tc": lambda: dtype == torch.bfloat16
            and tc_plan_fits("bwd", hidden, cluster, rows),
            "reg": lambda: _reg_rule("bwd", hidden, cluster, rows, REG_GATES),
            "pipe": lambda: _pipe_rule(hidden, cluster, rows, dtype.itemsize,
                                       PIPE_GATES),
            "stream": lambda: _stream_rule("bigru_bwd", hidden, cluster,
                                           rows),
            "cluster": lambda: plan_fits("bwd", hidden, cluster, rows)
            }[kernel]()


def card_bwd_plans(B: int, H: int, dev: torch.device, dtype: torch.dtype
                   ) -> Tuple[str, List[tuple]]:
    """The kernel of #6's two-direction route at (B, H) with ``dtype``
    streams (#10 takes the same) and that kernel's plans on the card
    ``dev`` as forced plans, ``("tc", C, R)`` ... or ``("unit", R)``,
    fastest first: the first is the plan a launch takes."""
    kernel = gru_bwd_kernel_route(H, 2, dtype)
    if kernel == "unit":
        return kernel, [("unit", r) for r in card_unit_plans(
            _library("bigru_bwd"), "gru_bwd", B, H, dev, dtype, False, 2)]
    plans = {"tc": lambda: card_tc_plans("bwd", B, H, dev),
             "reg": lambda: card_gru_reg_plans("bwd", B, H, dev, dtype),
             "pipe": lambda: card_gru_pipe_plans(B, H, dev, dtype),
             "stream": lambda: card_stream_plans("bwd", B, H, dev, dtype),
             "cluster": lambda: card_plans("bwd", B, H, dev, dtype)}[kernel]()
    return kernel, [(kernel, c, r) for c, r in plans]


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
                    f" every block of the cluster must own a unit (#9: the "
                    f"cluster divide H), the tile be a multiple of "
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


def _tc_plan_launch(kind: str, fn, B: int, H: int, dev: torch.device,
                    save: bool, plan: Optional[Tuple[int, int]] = None):
    """The launch's ``(cluster, rows)`` for the tensor-core kernel ``kind``
    ("fwd" or "bwd"): ``bigru_tc_plan``'s pick with the card's own counts,
    or the caller's ``plan``, refused unless ``tc_plan_fits`` holds and the
    card runs at least one such cluster. Recorded with the number of the
    grid's clusters in ``fn.last_launch``."""
    lib, resident, sms = _tc_resident(kind, H, dev, save)
    key = ("tc", kind, B, H, str(dev), save, plan)
    if key not in _PLANS:
        if plan is None:
            cluster, rows = bigru_tc_plan(kind, B, H, resident, sms)
        else:
            cluster, rows = plan
            if not tc_plan_fits(kind, H, cluster, rows):
                raise ValueError(
                    f"bigru_{kind}_tc: plan {cluster}x{rows} does not fit "
                    f"H={H}: H must be a multiple of 16 up to {TC_MAX_H}, "
                    "the cluster divide it into 8-unit warps, at most "
                    f"{TC_MAX_THREADS} threads a block, and the tile "
                    f"{TC_ROWS} rows")
            if resident(cluster, rows) <= 0:
                raise ValueError(f"bigru_{kind}_tc: the card runs no "
                                 f"cluster of plan {cluster}x{rows} at once")
        _PLANS[key] = {"kernel": "tc", "cluster": cluster, "rows": rows,
                       "clusters": 2 * -(-B // rows),
                       "resident": resident(cluster, rows)}
    fn.last_launch = _PLANS[key]
    return lib, fn.last_launch["cluster"], fn.last_launch["rows"]


def _stream_plan_launch(kind: str, fn, B: int, H: int, dev: torch.device,
                        T, save: bool, dirs: int,
                        plan: Optional[Tuple[int, int]] = None):
    """The launch's ``(cluster, rows)`` for the stream kernel ``kind``
    ("fwd" or "bwd") over ``dirs`` directions: ``bigru_stream_plans``' pick
    with the card's own counts, or the caller's ``plan``, refused unless
    ``_stream_rule`` holds and the card runs at least one such cluster.
    Recorded with the number of the grid's clusters in
    ``fn.last_launch``."""
    lib, resident = _stream_resident(kind, H, dev, T, save)
    key = ("stream", kind, B, H, str(dev), T, save, dirs, plan)
    if key not in _PLANS:
        if plan is None:
            plans = bigru_stream_plans(kind, B, H, resident, dirs,
                                       T.itemsize)
            if not plans:
                raise ValueError(f"bigru_{kind}_stream: no plan of 1 to "
                                 f"{STREAM_MAX_CLUSTER} blocks takes H={H} "
                                 f"on {card_name(dev)}")
            cluster, rows = plans[0]
        else:
            cluster, rows = plan
            if not _stream_rule(f"bigru_{kind}", H, cluster, rows):
                raise ValueError(
                    f"bigru_{kind}_stream: plan {cluster}x{rows} does not fit"
                    f" H={H}: 1 to {STREAM_MAX_CLUSTER} blocks each owning a"
                    f" unit, the tile a multiple of {ROWS_PER_THREAD}, at "
                    f"most {MAX_THREADS} threads and {MAX_SMEM_BYTES} bytes"
                    " a block")
            if resident(cluster, rows) <= 0:
                raise ValueError(f"bigru_{kind}_stream: the card runs no "
                                 f"cluster of plan {cluster}x{rows} at once")
        _PLANS[key] = {"kernel": "stream", "cluster": cluster, "rows": rows,
                       "clusters": dirs * -(-B // rows),
                       "resident": resident(cluster, rows)}
    fn.last_launch = _PLANS[key]
    return lib, fn.last_launch["cluster"], fn.last_launch["rows"]


def _batch_route(kind: str, B: int, H: int, dev: torch.device, T,
                 save: bool, dirs: int) -> str:
    """``reg_route`` of a launch the route sends to the register kernel
    ``kind``, with the card's own counts (cached by shape)."""
    key = ("route", kind, B, H, str(dev), T, save, dirs)
    if key not in _PLANS:
        _PLANS[key] = reg_route(kind, B, H,
                                _reg_resident(kind, H, dev, T, save)[1],
                                dirs)
    return _PLANS[key]


def _reg_plan_launch(kind: str, fn, B: int, H: int, dev: torch.device, T,
                     save: bool, dirs: int,
                     plan: Optional[Tuple[int, int]] = None):
    """The launch's ``(cluster, rows)`` for the register cluster kernel
    ``kind`` ("fwd" or "bwd") over ``dirs`` directions:
    ``bigru_reg_plan``'s pick with the card's own counts, or the caller's
    ``plan``, refused unless the register rule holds (``_reg_rule`` with
    three gates) and the card runs at least one such cluster. Recorded
    with the number of the grid's clusters in ``fn.last_launch``."""
    lib, resident = _reg_resident(kind, H, dev, T, save)
    key = ("reg", kind, B, H, str(dev), T, save, dirs, plan)
    if key not in _PLANS:
        if plan is None:
            plans = bigru_reg_plans(kind, B, H, resident, dirs)
            if not plans:
                raise ValueError(f"bigru_{kind}_reg: no plan of 1 to "
                                 f"{REG_MAX_CLUSTER} blocks takes H={H} on "
                                 f"{card_name(dev)}")
            cluster, rows = plans[0]
        else:
            cluster, rows = plan
            if not _reg_rule(kind, H, cluster, rows, REG_GATES):
                raise ValueError(
                    f"bigru_{kind}_reg: plan {cluster}x{rows} does not fit "
                    f"H={H}: H at most {CLUSTER_MAX_H}, 1 to "
                    f"{REG_MAX_CLUSTER} blocks each owning a unit, a tile of "
                    f"{GRU_REG_ROWS} rows, at most {REG_MAX_THREADS} threads"
                    f" and {MAX_SMEM_BYTES} bytes of shared memory a block")
            if resident(cluster, rows) <= 0:
                raise ValueError(f"bigru_{kind}_reg: the card runs no "
                                 f"cluster of plan {cluster}x{rows} at once")
        _PLANS[key] = {"kernel": "reg", "cluster": cluster, "rows": rows,
                       "clusters": dirs * -(-B // rows),
                       "resident": resident(cluster, rows)}
    fn.last_launch = _PLANS[key]
    return lib, fn.last_launch["cluster"], fn.last_launch["rows"]


def _pipe_plan_launch(fn, B: int, H: int, dev: torch.device, T, dirs: int,
                      plan: Optional[Tuple[int, int]] = None):
    """The launch's ``(cluster, rows)`` for the BPTT's pipe kernel over
    ``dirs`` directions: ``rnn_cuda.pipe_plans``' pick (three gates) with
    the card's own counts, or the caller's ``plan``, refused unless its
    rule holds and the card runs at least one such cluster. Recorded with
    the number of the grid's clusters in ``fn.last_launch``."""
    lib, resident = _pipe_resident(H, dev, T)
    key = ("pipe", B, H, str(dev), T, dirs, plan)
    if key not in _PLANS:
        if plan is None:
            plans = pipe_plans(B, H, resident, dirs, T.itemsize, PIPE_GATES)
            if not plans:
                raise ValueError(f"bigru_bwd_pipe: no plan of 1 to "
                                 f"{PIPE_MAX_CLUSTER} blocks takes H={H} on "
                                 f"{card_name(dev)}")
            cluster, rows = plans[0]
        else:
            cluster, rows = plan
            if not _pipe_rule(H, cluster, rows, T.itemsize, PIPE_GATES):
                raise ValueError(
                    f"bigru_bwd_pipe: plan {cluster}x{rows} does not fit "
                    f"H={H}: 1 to {PIPE_MAX_CLUSTER} blocks each owning a "
                    f"unit, H at most 1024, a tile of {PIPE_ROWS[1]} rows, "
                    f"at most {PIPE_CELLS} cells a thread and two chunks of "
                    f"W_hh's slice in {MAX_SMEM_BYTES} bytes of shared "
                    "memory a block")
            if resident(cluster, rows) <= 0:
                raise ValueError(f"bigru_bwd_pipe: the card runs no cluster "
                                 f"of plan {cluster}x{rows} at once")
        _PLANS[key] = {"kernel": "pipe", "cluster": cluster, "rows": rows,
                       "clusters": dirs * -(-B // rows),
                       "resident": resident(cluster, rows)}
    fn.last_launch = _PLANS[key]
    return lib, fn.last_launch["cluster"], fn.last_launch["rows"]


def _fwd_pipe_plan_launch(fn, B: int, H: int, dev: torch.device, T,
                          save: bool, dirs: int,
                          plan: Optional[Tuple[int, int]] = None):
    """The launch's ``(cluster, rows)`` for the forward's pipe kernel over
    ``dirs`` directions: ``rnn_cuda.fwd_pipe_plans``' pick (three gates)
    with the card's own counts, or the caller's ``plan``, refused unless
    its rule holds and the card runs at least one such cluster. Recorded
    with the number of the grid's clusters in ``fn.last_launch``."""
    lib, resident = _fwd_pipe_resident(H, dev, T, save)
    key = ("fwd_pipe", B, H, str(dev), T, save, dirs, plan)
    if key not in _PLANS:
        if plan is None:
            plans = fwd_pipe_plans(B, H, resident, dirs, T.itemsize,
                                   PIPE_GATES)
            if not plans:
                raise ValueError(f"bigru_fwd_pipe: no plan of 1 to "
                                 f"{FPIPE_MAX_CLUSTER} blocks takes H={H} "
                                 f"on {card_name(dev)}")
            cluster, rows = plans[0]
        else:
            cluster, rows = plan
            if not _fwd_pipe_rule(H, cluster, rows, T.itemsize):
                raise ValueError(
                    f"bigru_fwd_pipe: plan {cluster}x{rows} does not fit "
                    f"H={H}: 1 to {FPIPE_MAX_CLUSTER} blocks each owning a "
                    f"unit, at most 15 consumer warps of 8 units, a tile of "
                    f"{FPIPE_ROWS} rows (16 in two row groups, 12 in at most "
                    "8 warps) and two chunks of W_hh's slice in "
                    f"{MAX_SMEM_BYTES} bytes of shared memory a block")
            if resident(cluster, rows) <= 0:
                raise ValueError(f"bigru_fwd_pipe: the card runs no cluster "
                                 f"of plan {cluster}x{rows} at once")
        _PLANS[key] = {"kernel": "pipe", "cluster": cluster, "rows": rows,
                       "clusters": dirs * -(-B // rows),
                       "resident": resident(cluster, rows)}
    fn.last_launch = _PLANS[key]
    return lib, fn.last_launch["cluster"], fn.last_launch["rows"]


def _bigru_kernel(kind: str, H: int, T: torch.dtype, plan):
    """The kernel a two-direction launch of ``kind`` ("fwd" or "bwd")
    takes, "unit", "tc", "reg", "cluster", "pipe" or "stream", and the plan
    the caller forces (None: the planner's): ``plan=None`` follows the
    route, ``("cluster", cluster, rows)`` or ``(cluster, rows)`` forces the
    first cluster kernel, ``("reg", cluster, rows)`` the register cluster
    kernel, ``("unit", rows)`` the unit kernel, ``("stream", cluster,
    rows)`` the stream kernel, ``("pipe", cluster, rows)`` the pipe kernel
    (the BPTT's or the forward's), ``("tc", cluster, rows)`` the
    tensor-core kernel, refused for float32 streams."""
    if plan is None:
        route = gru_fwd_kernel_route if kind == "fwd" else gru_bwd_kernel_route
        return route(H, 2, T), None
    if plan[0] not in ("tc", "unit", "stream", "pipe", "reg", "cluster"):
        return "cluster", tuple(plan)
    if plan[0] == "tc" and T != torch.bfloat16:
        raise ValueError(f"bigru_{kind}: the tensor-core kernel takes "
                         f"bfloat16 streams, not {T}")
    if plan[0] == "unit" and H > UNIT_MAX_H:
        raise ValueError(f"bigru_{kind}: the unit kernel takes H <= "
                         f"{UNIT_MAX_H}, not {H}")
    return plan[0], tuple(plan[1:])


def _unit_rows(fn, src: str, B: int, H: int, dev, T, save: bool,
               dirs: int, forced):
    """The kernel library and batch tile of a unit-kernel launch of
    ``src`` ("gru_fwd" or "gru_bwd", the unit queries' name) over ``dirs``
    directions: ``rnn_cuda.unit_launch_rows``, the caller's ``forced``
    tile or the planner's."""
    lib = _library(f"bi{src}")
    return lib, unit_launch_rows(fn, lib, src, B, H, dev, T, save, dirs,
                                 None if forced is None else forced[0])


def _fwd_launch(fn, save: bool, plan, xg_f, xg_b, w_f, b_f, w_b, b_b):
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
    kernel, forced = _bigru_kernel("fwd", H, T, plan)
    if kernel == "reg" and plan is None:
        kernel = _batch_route("fwd", B, H, dev, T, save, 2)
    if kernel == "unit":
        lib, rows = _unit_rows(fn, "gru_fwd", B, H, dev, T, save, 2, forced)
        name = "bigru_fwd_unit_train" if save else "bigru_fwd_unit"
        plan_ints = (rows,)
    elif kernel == "tc":
        lib, cluster, rows = _tc_plan_launch("fwd", fn, B, H, dev, save,
                                             forced)
        name, plan_ints = f"{name}_tc", (cluster, rows)
    elif kernel == "stream":
        lib, cluster, rows = _stream_plan_launch("fwd", fn, B, H, dev, T,
                                                 save, 2, forced)
        name, plan_ints = f"{name}_stream", (cluster, rows)
    elif kernel == "pipe":
        lib, cluster, rows = _fwd_pipe_plan_launch(fn, B, H, dev, T, save, 2,
                                                   forced)
        name, plan_ints = f"{name}_pipe", (cluster, rows)
    elif kernel == "reg":
        lib, cluster, rows = _reg_plan_launch("fwd", fn, B, H, dev, T, save,
                                              2, forced)
        name, plan_ints = f"{name}_reg", (cluster, rows)
    else:
        lib, cluster, rows = _plan_launch("fwd", fn, B, H, dev, T, save, 2,
                                          forced)
        plan_ints = (cluster, rows)
    w_f, w_b = fwd_weights(kernel, (w_f.to(T).contiguous(),
                                    w_b.to(T).contiguous()), plan_ints[0])
    launch(lib, f"{name}_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (xg_f, xg_b, w_f, b_f, w_b, b_b)),
           *(o.data_ptr() for o in outs), B, N, H, *plan_ints)
    fn.launches += 1
    return tuple(outs)


def bigru_fwd_cuda(xg_f, xg_b, w_f, b_f, w_b, b_b,
                   plan: Optional[tuple] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the light kernel of ``csrc/bigru_fwd.cu`` (the register
    kernel: ``csrc/bigru_fwd_reg.cu``; the pipe kernel:
    ``csrc/bigru_fwd_pipe.cu``) on the current stream: ``(ys_f, ys_b)``.
    ``gru_fwd_kernel_route`` (and, for the register kernel, ``reg_route``)
    picks the unit, tensor-core, register, cluster, pipe or stream kernel;
    ``plan=("cluster", cluster, rows)`` or ``(cluster, rows)`` forces the
    first cluster kernel's plan, ``plan=("unit", rows)``, ``("reg",
    cluster, rows)``, ``("pipe", cluster, rows)``, ``("stream", cluster,
    rows)`` or ``("tc", cluster, rows)`` the unit, register, pipe, stream
    or tensor-core kernel's (raises if it does not fit).
    Records the plan in
    ``bigru_fwd_cuda.last_launch`` and counts each launch in
    ``bigru_fwd_cuda.launches``. Its outputs carry no autograd history:
    ``bigru_recurrence`` sends inputs that need a gradient to
    ``BiGRUFunction`` instead."""
    return _fwd_launch(bigru_fwd_cuda, False, plan, xg_f, xg_b, w_f, b_f,
                       w_b, b_b)


bigru_fwd_cuda.launches = 0


def bigru_fwd_train_cuda(xg_f, xg_b, w_f, b_f, w_b, b_b,
                         plan: Optional[tuple] = None):
    """Launch the residual variant of ``csrc/bigru_fwd.cu``: ``(ys_f, ys_b,
    gs_f, gs_b, hn_f, hn_b)``; route and ``plan`` as ``bigru_fwd_cuda``.
    Counts each launch in ``bigru_fwd_train_cuda.launches``."""
    return _fwd_launch(bigru_fwd_train_cuda, True, plan, xg_f, xg_b, w_f, b_f,
                       w_b, b_b)


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
    # #10 takes #6's route, kernels and plans (each kernel's kSplitCoef
    # instance); above H=1024, where #6 takes the stream kernel, #10 has no
    # kernel of its own and stays on its first design, which takes no such
    # width: the cluster planner raises, naming it
    kernel, forced = _bigru_kernel("bwd", H, T, plan)
    if kind == "split" and kernel == "stream":
        if plan is not None:
            raise ValueError(f"{name}: #10 has no stream kernel; plans are "
                             "('tc' | 'reg' | 'pipe' | 'cluster', C, R) or "
                             "('unit', R)")
        kernel = "cluster"
    if kernel == "reg" and plan is None:
        kernel = _batch_route("bwd", B, H, dev, T, False, 2)
    if kernel == "unit":
        lib, rows = _unit_rows(fn, "gru_bwd", B, H, dev, T, False, 2, forced)
        name, plan_ints = f"{name}_unit", (rows,)
    elif kernel == "tc":
        lib, cluster, rows = _tc_plan_launch("bwd", fn, B, H, dev, False,
                                             forced)
        name, plan_ints = f"{name}_tc", (cluster, rows)
    elif kernel == "stream":
        lib, cluster, rows = _stream_plan_launch("bwd", fn, B, H, dev, T,
                                                 False, 2, forced)
        name, plan_ints = f"{name}_stream", (cluster, rows)
    elif kernel == "pipe":
        lib, cluster, rows = _pipe_plan_launch(fn, B, H, dev, T, 2, forced)
        name, plan_ints = f"{name}_pipe", (cluster, rows)
    elif kernel == "reg":
        lib, cluster, rows = _reg_plan_launch("bwd", fn, B, H, dev, T, False,
                                              2, forced)
        name, plan_ints = f"{name}_reg", (cluster, rows)
    else:
        lib, cluster, rows = _plan_launch(kind, fn, B, H, dev, T, False, 2,
                                          forced)
        plan_ints = (cluster, rows)
    w_f, w_b = bwd_weights(kernel, (w_f.to(T).contiguous(),
                                    w_b.to(T).contiguous()), plan_ints[0])
    launch(lib, f"{name}_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (w_f, w_b, *streams)),
           *(o.data_ptr() for o in outs), B, N, H, *plan_ints)
    fn.launches += 1
    return tuple(outs)


def bigru_bwd_cuda(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b,
                   plan: Optional[tuple] = None):
    """Launch ``csrc/bigru_bwd.cu`` (#6; the register kernel
    ``csrc/bigru_bwd_reg.cu``, the pipe kernel ``csrc/bigru_pipe.cu``):
    ``(dx_f, dhn_f, dx_b, dhn_b)``. ``gru_bwd_kernel_route`` picks the unit
    kernel (both directions in one launch), the tensor-core kernel, the
    register kernel, the pipe kernel or the stream kernel;
    ``plan=("cluster", cluster, rows)`` or ``(cluster, rows)`` forces
    kLinear's cluster kernel (the first design), ``plan=("unit", rows)``,
    ``("reg", cluster, rows)``, ``("pipe", cluster, rows)``, ``("stream",
    cluster, rows)`` or ``("tc", cluster, rows)`` the unit, register,
    pipe, stream or tensor-core kernel's (raises if it does not fit). Records the plan in ``bigru_bwd_cuda.last_launch`` and
    counts each launch in ``bigru_bwd_cuda.launches``."""
    return _bwd_launch(bigru_bwd_cuda, "bwd", plan, w_f, w_b, gs_f, hn_f,
                       ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)


bigru_bwd_cuda.launches = 0


def bigru_bwd_split_cuda(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b,
                         dy_b, plan: Optional[tuple] = None):
    """Launch #10, the split BPTT: on #6's route and plans
    (``gru_bwd_kernel_route``), the kSplitCoef instance of the kernel #6
    takes there (``bigru_bwd_split_{unit,tc,reg,pipe}_*`` of
    ``csrc/bigru_bwd.cu``, ``csrc/bigru_bwd_reg.cu`` and
    ``csrc/bigru_pipe.cu``). Arguments, outputs and ``plan`` as
    ``bigru_bwd_cuda``: ``("cluster", cluster, rows)`` or ``(cluster,
    rows)`` forces the first design (the split kind of the first cluster
    kernel); there is no stream kernel of #10, so above H=1024 (#6's stream
    widths) it stays on the first design, which raises for want of a plan.
    Records the kernel and plan in ``bigru_bwd_split_cuda.last_launch`` and
    counts each launch in ``bigru_bwd_split_cuda.launches``."""
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
    (``csrc/bigru_bwd.cu``, the pipe kernel ``csrc/bigru_pipe.cu``) on the
    tensors ``ptrs`` (the BPTT's: W_hh first), on the unit kernel
    (``rnn_cuda.unit_plan``'s tile), the register kernel
    (``bigru_reg_plan``'s plan; ``reg_route`` may send a forward to the
    pipe kernel), the cluster kernel (``bigru_plan``'s plan), the pipe
    kernel (the BPTT's: ``rnn_cuda.pipe_plans``' plan, W_hh
    packed by ``rnn_cuda.pipe_weights``; the forward's:
    ``rnn_cuda.fwd_pipe_plans``', ``rnn_cuda.fwd_pipe_weights``) or the
    stream kernel
    (``bigru_stream_plans``' plan; the BPTT's reads W_hh^T) as ``route(H,
    1)`` says, or as the caller's ``plan`` ("unit", rows), ("reg",
    cluster, rows), ("cluster", cluster, rows), ("pipe", cluster, rows) or
    ("stream", cluster, rows) forces; counted and recorded on ``fn``."""
    src = name[:len("gru_fwd")]          # the unit queries' name
    kernel = route(H, 1) if plan is None else plan[0]
    if kernel == "reg" and plan is None:
        kernel = _batch_route(src[len("gru_"):], B, H, dev, T, save, 1)
    forced = None if plan is None else tuple(plan[1:])
    sfx = _SUFFIX[T]
    if kernel == "unit":
        if H > UNIT_MAX_H:
            raise ValueError(f"{name}: the unit kernel takes H <= "
                             f"{UNIT_MAX_H}, not {H}")
        lib, rows = _unit_rows(fn, src, B, H, dev, T, save, 1, forced)
        entry, plan_ints = f"{src}_unit{name[len(src):]}", (rows,)
    elif kernel in ("cluster", "stream"):
        plan_of = _plan_launch if kernel == "cluster" else _stream_plan_launch
        lib, cluster, rows = plan_of(src[len("gru_"):], fn, B, H, dev, T,
                                     save, 1, forced)
        entry = name if kernel == "cluster" else f"{name}_stream"
        plan_ints = (cluster, rows)
    elif kernel == "reg":
        lib, cluster, rows = _reg_plan_launch(src[len("gru_"):], fn, B, H,
                                              dev, T, save, 1, forced)
        entry, plan_ints = f"{name}_reg", (cluster, rows)
    elif kernel == "pipe" and src == "gru_bwd":
        lib, cluster, rows = _pipe_plan_launch(fn, B, H, dev, T, 1, forced)
        entry, plan_ints = f"{name}_pipe", (cluster, rows)
    elif kernel == "pipe":
        lib, cluster, rows = _fwd_pipe_plan_launch(fn, B, H, dev, T, save, 1,
                                                   forced)
        entry, plan_ints = f"{name}_pipe", (cluster, rows)
    else:
        raise ValueError(f"{name}: plan must be ('unit', rows), ('reg', "
                         "cluster, rows), ('cluster', cluster, rows), "
                         "('pipe', cluster, rows) or ('stream', cluster, "
                         f"rows), got {plan}")
    if src == "gru_bwd":
        ptrs = [*bwd_weights(kernel, ptrs[:1], plan_ints[0]), *ptrs[1:]]
    else:
        ptrs = [ptrs[0], *fwd_weights(kernel, ptrs[1:2], plan_ints[0]),
                *ptrs[2:]]
    launch(lib, f"{entry}_{sfx}", dev, *(t.data_ptr() for t in ptrs), B, N,
           H, *plan_ints, int(reverse))
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
    _gru_launch(fn, name, gru_fwd_kernel_route, save, [xg, w, b, *outs], B,
                N, H, dev, T, reverse, plan)
    return tuple(outs)


def gru_fwd_cuda(xg, w, b, reverse: bool = False,
                 plan: Optional[tuple] = None) -> torch.Tensor:
    """Launch the light kernel of ``csrc/bigru_fwd.cu`` with a grid of one
    direction on the current stream (the register kernel:
    ``csrc/bigru_fwd_reg.cu``; the pipe kernel: ``csrc/bigru_fwd_pipe.cu``):
    ``ys``. ``plan=("unit", rows)``, ``("reg", cluster, rows)``,
    ``("cluster", cluster, rows)``, ``("pipe", cluster, rows)`` or
    ``("stream", cluster, rows)`` overrides the route and the planner
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
    """Launch ``csrc/bigru_bwd.cu`` (the register kernel
    ``csrc/bigru_bwd_reg.cu``, the pipe kernel ``csrc/bigru_pipe.cu``) with
    a grid of one direction: ``(dx, dhn)``. ``gru_bwd_kernel_route`` picks
    the unit kernel, the register kernel, the pipe kernel or the stream
    kernel; ``plan=("unit", rows)``, ``("reg", cluster, rows)``,
    ``("cluster", cluster, rows)`` (kLinear, the first design), ``("pipe",
    cluster, rows)`` or ``("stream", cluster, rows)`` overrides the route
    and the planner (raises if it does not fit). Records the plan in ``gru_bwd_cuda.last_launch`` and counts
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
                [w, *streams, *outs], B, N, H, dev, T, reverse, plan)
    return tuple(outs)


gru_bwd_cuda.launches = 0
