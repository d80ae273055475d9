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

Each source holds five kernels. At H <= ``UNIT_MAX_H`` (64, the flagship's
and the legacy LSTM's width) the unit kernel runs: four lanes of a warp own
one hidden unit of a tile of 1, 2 or 4 batch rows, W_hh (the forward's
columns, the BPTT's row) in their registers, one block barrier a step;
``unit_plan`` sizes the tile to the batch and the card. Above it, up to
``CLUSTER_MAX_H`` (256), the register cluster kernel ("reg") splits W_hh by
hidden units across a thread-block cluster of up to 16 blocks, each block's
slice held in registers (a forward lane's k count fitted to H:
``reg_k_per_lane``), h (the BPTT: partial sums of dh) exchanged by
``st.async`` on mbarriers; ``lstm_reg_plan`` picks the cluster and the
batch tile from the card's own counts. The wide kernel (the first design
above H=64: W_hh in shared memory, one block of 4H threads per 4-row tile,
up to H=118 in the forward and H=116 in the BPTT) stays for the A/B,
reached by a forced ``("wide", 4)`` plan. The first cluster kernel
("cluster": the slice in shared memory, a cluster barrier a step) stays for
the A/B, reached by a forced plan. Above ``CLUSTER_MAX_H``, where no block
holds its share of W_hh, the forward takes its pipe kernel
(``csrc/bilstm_fwd_pipe.cu``, a source of its own: "pipe", each block's
slice of W_hh packed k-major by ``fwd_pipe_weights`` and streamed through
shared memory by a producer warp's bulk copies, the part that fits held, h
exchanged by ``st.async`` on mbarriers; ``fwd_pipe_plans`` picks the
cluster and the batch tile) up to ``LSTM_FWD_PIPE_MAX_H``; the stream
kernel ("stream": the first cluster kernel reading its slice of W_hh from
global memory every step, clusters of up to 16 blocks; ``stream_plans``)
keeps the forward's wider widths whose exchange tile fits a block and is
reached below by a forced plan. The BPTT there takes the pipe kernel
(``csrc/bilstm_pipe.cu``, a source of its own: "pipe", the register
kernel's K-split, each block's slice of W_hh streamed through shared memory
by a producer warp's bulk copies, the part that fits held for the whole
walk; ``pipe_plans`` picks the cluster and the batch tile), routed as far
as the first stream design takes H (1816) and by a forced plan to H=2048;
the stream BPTT, the first design for those widths, is reached by a forced
``("stream", C, R)`` plan. ``lstm_fwd_kernel_route`` and
``lstm_bwd_kernel_route`` choose, and each launch records its kernel and
plan in the wrapper's ``last_launch``.

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

# The cluster kernels (csrc/bilstm_*.cu bilstm_*_cluster_kernel and the
# BiGRU ones of csrc/bigru_*.cu): cluster sizes, rows of a thread
# (kRowsPerThread), the largest batch tile the planners take, the launch
# bound, and the largest H of the LSTM cluster kernels (kMaxClusterH; the
# BiGRU planner's masked slices stop there too)
CLUSTER_SIZES = (1, 2, 4, 8)
ROWS_PER_THREAD = 4
MAX_ROWS = 32
MAX_THREADS = 512
CLUSTER_MAX_H = 256

# The register cluster kernels (bilstm_*_reg_kernel; with three gates
# csrc/bigru_fwd_reg.cu and csrc/bigru_bwd_reg.cu): clusters of 1 to
# REG_MAX_CLUSTER blocks (above 8 a non-portable size), batch tiles of
# REG_ROWS[kind] rows (the GRU's: GRU_REG_ROWS), the k values a forward lane
# holds (kRegKPerLane, or the LSTM's kRegKFit to H=96; a BPTT lane holds 8
# columns of each gate, kRegJPerLane / kJPerLane), the inputs the BPTT
# stages a cell (kRegIn) and the outputs the forward stages (kRegStreams),
# by gate count
REG_MAX_CLUSTER = 16
REG_ROWS = {"fwd": (1, 2, 4), "bwd": (1, 2, 4, 8)}
GRU_REG_ROWS = (1, 2, 4, 8)
REG_MAX_THREADS = 256   # the launch bound: 255 registers a thread
REG_K_PER_LANE = 16
REG_K_FIT = 12
REG_IN = {4: 7, 3: 6}        # i, f, g, o, c, c_prev, dy; r, z, n, hn, h_prev, dy
REG_LOADS = 4     # input values a BPTT thread loads a step (kRegLoads)
REG_STREAMS = {4: 6, 3: 5}   # ys, c, i, f, g, o; ys, r, z, n, hn
REG_BWD_OUT = 4   # staged BPTT outputs: dg of four gates; dx of three and dhn
REG_STAGES = 3    # output staging slots (kRegStages)
REG_SOURCE = {4: "bilstm", 3: "bigru"}   # the layout queries' prefix
# A step's fixed part (the exchange, the lane reduction, the gate math) in
# thread-rows of a block's FMA issue, for rank_reg_plans' cost model; and
# the LSTM kernels' own terms (lstm_reg_terms): each cluster of a forward
# grid, each block of a BPTT grid, and each shuffle round of the BPTT's
# K-split (log2 of U / 8 lanes a pair of k)
REG_STEP_FIXED = 2400
REG_FWD_CLUSTER = 10
REG_BWD_BLOCK = 1
REG_BWD_SHUFFLE = 60

# The stream kernels (the first cluster kernels of the four sources with
# kStream: W_hh read from global memory every step): clusters of 1 to
# STREAM_MAX_CLUSTER blocks (kStreamMaxC), the exchange tile's rows padded
# to whole chunks of STREAM_K (kStreamK: the values of k, or of j in the
# BPTT, whose W_hh a thread has in flight); the tile's rows in units of H
# by source (h: H; the BPTT's dg: 4H and 3H)
STREAM_MAX_CLUSTER = 16
STREAM_K = 8
STREAM_GATES = {"bilstm_fwd": 1, "bilstm_bwd": 4, "bigru_fwd": 1,
                "bigru_bwd": 3}
# stream_plans' cost model, an H100's rates a cycle: FMAs one SM issues, L2
# bytes one SM and the whole card read
STREAM_SM_FMA = 128
STREAM_SM_L2 = 32
STREAM_CARD_L2 = 3072

# The pipe kernels (the BPTT above CLUSTER_MAX_H: csrc/bilstm_pipe.cu
# bilstm_bwd_pipe_kernel, the LSTM's, four gates; csrc/bigru_pipe.cu
# bigru_bwd_pipe_kernel, the GRU's, three): clusters of 1 to
# PIPE_MAX_CLUSTER blocks (kPipeMaxC), batch tiles of PIPE_ROWS[k] rows where
# a thread sums k groups of 4 k values (1 pass of PIPE_GROUPS groups to
# H=1024, 2 to H=2048), chunks of PIPE_JC[gates][k] gate columns of the
# block's slice of W_hh (the GRU's kernel takes one pass only), at least
# PIPE_MIN_WARPS consumer warps, at most PIPE_CELLS (unit, row) cells a
# consumer thread, a ring of PIPE_RING stages where the slice does not fit,
# at most PIPE_MAX_STAGES chunks in shared memory (kPipe* in the sources)
PIPE_MAX_CLUSTER = 16
PIPE_ROWS = {1: (1, 2, 4, 8, 12, 16), 2: (1, 2, 4, 8)}
PIPE_JC = {4: {1: 16, 2: 8}, 3: {1: 12}}
PIPE_SOURCE = {4: "bilstm_bwd", 3: "bigru_bwd"}   # the queries' prefix
PIPE_GROUPS = 256
PIPE_MIN_WARPS = 4
PIPE_CELLS = 4
PIPE_RING = 4
PIPE_MAX_STAGES = 32
# pipe_plans' cost model, in cycles: a step's fixed part (the exchange's
# latency, the waits and the block barrier) and one partial summed a cell
PIPE_STEP_FIXED = 2000
PIPE_CELL_PARTIAL = 8

# The forward pipe kernels (the forwards above CLUSTER_MAX_H:
# csrc/bilstm_fwd_pipe.cu bilstm_fwd_pipe_kernel, the LSTM's, and
# csrc/bigru_fwd_pipe.cu bigru_fwd_pipe_kernel, the GRU's; one layout, the
# GRU's fourth gate slot zero): clusters of 1 to FPIPE_MAX_CLUSTER blocks,
# the block's slice of W_hh k-major in chunks of FPIPE_JK rows of k,
# FPIPE_UNITS_WARP units a consumer warp (its four quarters summing
# interleaved rows of k), at most FPIPE_MAX_WARPS consumer warps (above
# FPIPE_NARROW_WARPS a wide block), tiles of FPIPE_ROWS rows (those of
# FPIPE_GROUP_ROWS split into two row groups where the block has the warps
# for them), a ring of FPIPE_RING stages where the slice does not fit, at
# most FPIPE_MAX_STAGES chunks in shared memory (kFp* in the sources)
FPIPE_JK = 16
FPIPE_UNITS_WARP = 8
FPIPE_MAX_CLUSTER = 16
FPIPE_MAX_WARPS = 15
FPIPE_NARROW_WARPS = 8
FPIPE_ROWS = (1, 2, 4, 8, 12, 16)
FPIPE_GROUP_ROWS = (8, 16)
FPIPE_RING = 4
FPIPE_MAX_STAGES = 64
FPIPE_SOURCE = {4: "bilstm_fwd", 3: "bigru_fwd"}   # the queries' prefix
# fwd_pipe_plans' cost model, in cycles: a lane's FMA (the card's rate
# with one or two warps a scheduler: the product's loads and their latency
# included), a step's fixed part (the wait, the shuffles, the exchange) and
# a row of a warp's cells (their activations, stores and pieces sent); the
# bytes of the streamed chunks one SM's ring brings in a cycle (the ring's
# depth against the bulk copies' latency: 72 KiB a step took 7.6 K cycles)
FPIPE_FMA_CYCLES = 2.5
FPIPE_SM_L2 = 10
# the SMs the blocks of a wave share (an H100 SXM's): blocks beyond them
# run two to an SM and share its issue and its ring's L2 rate
FPIPE_SMS = 132
FPIPE_STEP_FIXED = 1500
FPIPE_ROW_CELLS = 250
# The LSTM forward's pipe route stops at the widest width its A/B times
# (chip_smoke.py phase 40, PIPE_TIME): the first stream design keeps the
# widths above
LSTM_FWD_PIPE_MAX_H = 1816


def bilstm_smem_bytes(hidden: int) -> int:
    """Shared memory one block of the wide forward kernel needs (mirrors
    ``smem_bytes`` in ``csrc/bilstm_fwd.cu``)."""
    G = 4 * hidden
    return (hidden * G + _ROWS_PER_BLOCK * G + _ROWS_PER_BLOCK * hidden) * 4


def unit_smem_bytes(rows: int, tiles: int = 1) -> int:
    """Static shared memory of a unit kernel's block: ``tiles`` tiles of
    [64][rows] float32, double buffered (``unit_smem_bytes`` of the
    sources): the forward kernels' h tile (one), the GRU BPTT's and the
    LSTM BPTT's dg tile (three and four, one per gate block of W_hh's
    row)."""
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


def slice_units(hidden: int, cluster: int) -> int:
    """Hidden units one block of a cluster kernel owns: ceil(H / C); the
    last block's slice is masked past H where C does not divide H."""
    return -(-hidden // cluster)


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def rank_cluster_plans(plans, batch: int, hidden: int,
                       resident: Callable[[int, int], int],
                       dirs: int) -> List[Tuple[int, int]]:
    """The ``(cluster, rows)`` plans of a cluster kernel, fastest first.

    A step's time is taken as the block's thread count (``slice_units``
    times the rows over ``ROWS_PER_THREAD``), at least 128 (four warps, one
    per scheduler: fewer do not finish a step sooner), times the waves the
    grid of ``dirs`` directions needs: ``resident(cluster, rows)`` clusters
    run at once (the card's own count, ``cudaOccupancyMaxActiveClusters``);
    a plan the card runs none of is dropped. Ties go to the smaller
    cluster, then the smaller tile."""
    keys = []
    for c, rows in plans:
        at_once = resident(c, rows)
        if at_once <= 0:
            continue
        threads = slice_units(hidden, c) * (rows // ROWS_PER_THREAD)
        waves = -(-dirs * -(-batch // rows) // at_once)
        keys.append((max(threads, 128) * waves, c, rows))
    return [(c, rows) for _, c, rows in sorted(keys)]


def lstm_cluster_smem_bytes(kind: str, hidden: int, cluster: int,
                            rows: int) -> int:
    """Dynamic shared memory one block of the LSTM cluster kernel ``kind``
    ("fwd": both forward variants; "bwd": the BPTT) needs, float32 (a bf16
    value is exact there): its W_hh slice (the forward's [H, 4U] gate
    columns, the BPTT's [4H, U] rows) and the double-buffered exchange tile
    (h [H, R], dg [4H, R]); mirrors ``cluster_smem_bytes`` of the
    sources."""
    U = slice_units(hidden, cluster)
    tile = hidden if kind == "fwd" else 4 * hidden
    return (_pad4(4 * hidden * U) + 2 * tile * rows) * 4


def _lstm_cluster_rule(hidden: int, cluster: int, rows: int) -> bool:
    """The LSTM cluster kernels' plan rule (``valid_cluster_plan``): H up
    to ``CLUSTER_MAX_H``, a cluster of ``CLUSTER_SIZES`` in which every
    block owns one unit at least, a tile a multiple of
    ``ROWS_PER_THREAD``, at most ``MAX_THREADS`` threads a block."""
    if cluster not in CLUSTER_SIZES or not 0 < hidden <= CLUSTER_MAX_H \
            or rows <= 0 or rows % ROWS_PER_THREAD:
        return False
    U = slice_units(hidden, cluster)
    return ((cluster - 1) * U < hidden
            and U * (rows // ROWS_PER_THREAD) <= MAX_THREADS)


def lstm_cluster_fits(kind: str, hidden: int, cluster: int,
                      rows: int) -> bool:
    """Whether the LSTM cluster kernel ``kind`` takes this plan at H: the
    rule holds and a block's shared memory fits."""
    return (_lstm_cluster_rule(hidden, cluster, rows)
            and lstm_cluster_smem_bytes(kind, hidden, cluster, rows)
            <= MAX_SMEM_BYTES)


def check_lstm_cluster_mirror(smem_query, kind: str) -> None:
    """Hold ``_lstm_cluster_rule`` and ``lstm_cluster_smem_bytes`` to a
    built source's ``bilstm_<kind>_cluster_smem_bytes(H, C, R)`` (bytes, or
    -1 for a plan it does not take) over H, every cluster size and tile;
    raises naming the first plan where they differ."""
    for hidden in (1, 7, 64, 119, 128, 130, 201, 255, 256, 257):
        for c in CLUSTER_SIZES:
            for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1,
                              ROWS_PER_THREAD):
                want = (lstm_cluster_smem_bytes(kind, hidden, c, rows)
                        if _lstm_cluster_rule(hidden, c, rows) else -1)
                got = smem_query(hidden, c, rows)
                if got != want:
                    raise RuntimeError(
                        f"bilstm_{kind}_cluster: the wrapper's plan mirror "
                        f"gives {want} bytes at H={hidden}, plan {c}x{rows}, "
                        f"the built source {got}: update CLUSTER_* or "
                        "lstm_cluster_smem_bytes to match the source")


def lstm_cluster_plans(kind: str, batch: int, hidden: int,
                       resident: Callable[[int, int], int],
                       dirs: int = 2) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` the LSTM cluster kernel ``kind`` takes at
    this batch and H over ``dirs`` directions, tiles up to ``MAX_ROWS``,
    fastest first (``rank_cluster_plans``)."""
    return rank_cluster_plans(
        [(c, rows) for c in CLUSTER_SIZES
         for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1, ROWS_PER_THREAD)
         if lstm_cluster_fits(kind, hidden, c, rows)],
        batch, hidden, resident, dirs)


def lstm_cluster_plan(kind: str, batch: int, hidden: int,
                      resident: Callable[[int, int], int],
                      dirs: int = 2) -> Tuple[int, int]:
    """``(cluster, rows)`` of the LSTM cluster kernel ``kind``: the first
    of ``lstm_cluster_plans``. Raises where the card runs no plan."""
    plans = lstm_cluster_plans(kind, batch, hidden, resident, dirs)
    if not plans:
        raise ValueError(f"bilstm_{kind}_cluster: no plan of "
                         f"{CLUSTER_SIZES} blocks takes H={hidden} on this "
                         "card")
    return plans[0]


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def reg_lanes(hidden: int) -> int:
    """Lanes of a hidden unit in the forward register cluster kernels: 8 up
    to H=128 (16 k values a lane), 16 above."""
    return 8 if hidden <= 8 * REG_K_PER_LANE else 16


def reg_k_per_lane(hidden: int, gates: int = 4) -> int:
    """k values of the sum a lane of the forward register cluster kernel
    holds: the LSTM's 12 where a unit's 8 lanes' 12 cover H (H <= 96),
    else 16; the GRU's always 16."""
    fit = gates == 4 and hidden <= REG_K_FIT * 8
    return REG_K_FIT if fit else REG_K_PER_LANE


def reg_rows(kind: str, gates: int = 4) -> Tuple[int, ...]:
    """The batch tiles of the register cluster kernel ``kind`` with
    ``gates`` gates: the LSTM forward's 1, 2 or 4 rows (8 spilled), the
    LSTM BPTT's and both GRU kernels' also 8."""
    return REG_ROWS[kind] if gates == 4 else GRU_REG_ROWS


def reg_units(kind: str, hidden: int, cluster: int) -> int:
    """Hidden units one block of the register cluster kernel ``kind``
    owns: ceil(H / C) up to a power of two, at least a warp's worth of
    units in the forward (32 / lanes) and 8 in the BPTT (a lane's 8
    columns of each gate); the last block's slice is masked past H."""
    u = _pow2_at_least(-(-hidden // cluster))
    return max(u, 32 // reg_lanes(hidden) if kind == "fwd" else 8)


def reg_threads(kind: str, hidden: int, cluster: int) -> int:
    """Threads of a block: the forward's lanes for each unit; the BPTT's
    U / 8 lanes for each pair of k, whole warps."""
    U = reg_units(kind, hidden, cluster)
    if kind == "fwd":
        return U * reg_lanes(hidden)
    return -(-(-(-hidden // 2) * (U // 8)) // 32) * 32


def reg_smem_bytes(kind: str, hidden: int, cluster: int, rows: int,
                   gates: int = 4) -> int:
    """Dynamic shared memory of a block of the register cluster kernel
    ``kind`` with ``gates`` gates (``reg_smem_floats`` of the sources): the
    forward's h tile [2][rows][TK] (TK covers the cluster's units and every
    k a lane reads), xg ring [2][rows][gates][U + 1] and output staging
    [3][REG_STREAMS][rows][U + 1]; the BPTT's dg tile (groups of 8 columns
    a gate, padded by 4 floats), partials [2][C][U][rows], input ring
    [2][rows][REG_IN][U + 1] and output staging [3][4][rows][U + 1]."""
    U = reg_units(kind, hidden, cluster)
    if kind == "fwd":
        tk = _pad4(max(cluster * U,
                       reg_k_per_lane(hidden, gates) * reg_lanes(hidden)))
        floats = (2 * rows * tk + (2 * gates + REG_STAGES
                                   * REG_STREAMS[gates]) * rows * (U + 1))
    else:
        rq = min(rows, 4)
        floats = ((rows // rq) * (U // 8) * (8 * gates * rq + 4)
                  + 2 * cluster * U * rows
                  + (2 * REG_IN[gates] + REG_STAGES * REG_BWD_OUT)
                  * rows * (U + 1))
    return floats * 4


def _reg_rule(kind: str, hidden: int, cluster: int, rows: int,
              gates: int = 4) -> bool:
    """The register cluster kernels' plan rule (``valid_reg_plan``): H up
    to ``CLUSTER_MAX_H``, 1 to ``REG_MAX_CLUSTER`` blocks each owning a
    unit at least, a tile of ``reg_rows(kind, gates)``, at most
    ``REG_MAX_THREADS`` threads and ``MAX_SMEM_BYTES`` bytes a block; the
    BPTT also at most ``REG_LOADS`` of its ``REG_IN`` input values a cell
    a thread a step."""
    if not (0 < hidden <= CLUSTER_MAX_H and 1 <= cluster <= REG_MAX_CLUSTER
            and rows in reg_rows(kind, gates)):
        return False
    U = reg_units(kind, hidden, cluster)
    threads = reg_threads(kind, hidden, cluster)
    return ((cluster - 1) * U < hidden and threads <= REG_MAX_THREADS
            and (kind == "fwd"
                 or REG_IN[gates] * U * rows <= REG_LOADS * threads)
            and reg_smem_bytes(kind, hidden, cluster, rows, gates)
            <= MAX_SMEM_BYTES)


def check_reg_mirror(layout, kind: str, gates: int = 4) -> None:
    """Hold ``_reg_rule``, ``reg_smem_bytes``, ``reg_threads`` and
    ``reg_units`` of ``gates`` gates to a built source's
    ``<bilstm|bigru>_<kind>_reg_layout(what, H, C, R)`` (bytes, threads,
    units, or -1 for a plan it does not take) over H, every cluster size
    and tile; raises naming the first plan where they differ."""
    for hidden in (1, 7, 64, 65, 80, 96, 97, 116, 117, 118, 119, 128, 130,
                   139, 192, 193, 201, 255, 256, 257):
        for c in range(1, REG_MAX_CLUSTER + 2):
            for rows in (1, 2, 3, 4, 8, 16):
                want = ((reg_smem_bytes(kind, hidden, c, rows, gates),
                         reg_threads(kind, hidden, c),
                         reg_units(kind, hidden, c))
                        if _reg_rule(kind, hidden, c, rows, gates)
                        else (-1,) * 3)
                got = tuple(layout(what, hidden, c, rows)
                            for what in range(3))
                if got != want:
                    raise RuntimeError(
                        f"{REG_SOURCE[gates]}_{kind}_reg: the wrapper's plan "
                        f"mirror gives {want} (shared bytes, threads, units) "
                        f"at H={hidden}, plan {c}x{rows}, the built source "
                        f"{got}: update REG_* or reg_* to match the source")


def rank_reg_plans(kind: str, plans, batch: int, hidden: int,
                   resident: Callable[[int, int], int],
                   dirs: int, gates: int = 4,
                   terms: Optional[Callable[[int, int, int],
                                            Tuple[int, int]]] = None
                   ) -> List[Tuple[int, int]]:
    """The ``(cluster, rows)`` plans of the register cluster kernel
    ``kind``, fastest first.

    A lane runs the same FMAs a gate a row a step whatever the plan at one
    H, so a block's step costs its threads (at least 128: four warps, one
    per scheduler) times its rows times gates / 4, plus
    ``REG_STEP_FIXED`` for the exchange, the lane reduction and the gate
    math; the grid of ``dirs`` directions takes ``waves`` such steps, with
    ``resident(cluster, rows)`` clusters at once (the card's own count,
    ``cudaOccupancyMaxActiveClusters``); a plan the card runs none of is
    dropped. ``terms(cluster, rows, clusters)``, where given, is a
    kernel's own (cost a step, cost once) for a grid of ``clusters``
    clusters (``lstm_reg_terms``). Ties go to the smaller cluster, then the
    smaller tile."""
    keys = []
    for c, rows in plans:
        at_once = resident(c, rows)
        if at_once <= 0:
            continue
        clusters = dirs * -(-batch // rows)
        waves = -(-clusters // at_once)
        step = (max(reg_threads(kind, hidden, c), 128) * rows * gates // 4
                + REG_STEP_FIXED)
        per_step, once = terms(c, rows, clusters) if terms else (0, 0)
        keys.append((waves * (step + per_step) + once, c, rows))
    return [(c, rows) for _, c, rows in sorted(keys)]


def reg_plans(kind: str, batch: int, hidden: int,
              resident: Callable[[int, int], int], dirs: int = 2,
              gates: int = 4, terms=None) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` the register cluster kernel ``kind`` of
    ``gates`` gates takes at this batch and H over ``dirs`` directions,
    fastest first (``rank_reg_plans``, with the kernel's own ``terms``)."""
    return rank_reg_plans(
        kind, [(c, rows) for c in range(1, REG_MAX_CLUSTER + 1)
               for rows in reg_rows(kind, gates)
               if _reg_rule(kind, hidden, c, rows, gates)],
        batch, hidden, resident, dirs, gates, terms)


def reg_takes(kind: str, hidden: int, gates: int = 4) -> bool:
    """Whether a plan of the register cluster kernel ``kind`` fits at H
    (whether the card runs it is the planner's question)."""
    return any(_reg_rule(kind, hidden, c, rows, gates)
               for c in range(1, REG_MAX_CLUSTER + 1)
               for rows in reg_rows(kind, gates))


def lstm_reg_terms(kind: str, hidden: int):
    """The LSTM register kernels' own cost terms for ``rank_reg_plans``,
    fitted to an H100's plan sweeps at H 96-256 (chip_smoke.py phase 42):
    ``REG_FWD_CLUSTER`` once for each cluster of a forward grid (at B=32
    tiles of 2 rows beat tiles of 1 where both make one wave);
    ``REG_BWD_SHUFFLE`` a step for each shuffle round of the BPTT's K-split
    (log2 of U / 8 lanes a pair of k: at B=1 eight units a block, no
    shuffle, beat 16 or 32) and ``REG_BWD_BLOCK`` once for each block of
    its grid (few blocks at B=32)."""
    def terms(c, rows, clusters):
        if kind == "fwd":
            return 0, REG_FWD_CLUSTER * clusters
        rounds = (reg_units(kind, hidden, c) // 8).bit_length() - 1
        return REG_BWD_SHUFFLE * rounds, REG_BWD_BLOCK * clusters * c
    return terms


def lstm_reg_plans(kind: str, batch: int, hidden: int,
                   resident: Callable[[int, int], int],
                   dirs: int = 2) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` the LSTM register cluster kernel ``kind``
    takes at this batch and H over ``dirs`` directions, fastest first
    (``rank_reg_plans`` with ``lstm_reg_terms``)."""
    return reg_plans(kind, batch, hidden, resident, dirs,
                     terms=lstm_reg_terms(kind, hidden))


def lstm_reg_plan(kind: str, batch: int, hidden: int,
                  resident: Callable[[int, int], int],
                  dirs: int = 2) -> Tuple[int, int]:
    """``(cluster, rows)`` of the register cluster kernel ``kind``: the
    first of ``lstm_reg_plans``. Raises where the card runs no plan."""
    plans = lstm_reg_plans(kind, batch, hidden, resident, dirs)
    if not plans:
        raise ValueError(f"bilstm_{kind}_reg: no plan of 1 to "
                         f"{REG_MAX_CLUSTER} blocks takes H={hidden} on this "
                         "card")
    return plans[0]


def stream_smem_bytes(source: str, hidden: int, rows: int) -> int:
    """Dynamic shared memory of a block of the stream kernel of ``source``
    (``stream_smem_bytes`` of the sources): the double-buffered exchange
    tile of ``STREAM_GATES[source]`` x H rows (h: H; the BPTT's dg: 4H or
    3H) padded to whole chunks of ``STREAM_K``, ``rows`` float32 columns;
    no W_hh slice."""
    tile = STREAM_GATES[source] * hidden
    return 2 * (-(-tile // STREAM_K) * STREAM_K) * rows * 4


def _stream_rule(source: str, hidden: int, cluster: int, rows: int) -> bool:
    """The plan rule of the stream kernel of ``source``
    (``valid_stream_plan``): any H, a cluster of 1 to
    ``STREAM_MAX_CLUSTER`` blocks each owning a unit at least, a tile a
    multiple of ``ROWS_PER_THREAD``, at most ``MAX_THREADS`` threads and
    ``MAX_SMEM_BYTES`` bytes a block."""
    if not (hidden > 0 and 1 <= cluster <= STREAM_MAX_CLUSTER and rows > 0
            and rows % ROWS_PER_THREAD == 0):
        return False
    U = slice_units(hidden, cluster)
    return ((cluster - 1) * U < hidden
            and U * (rows // ROWS_PER_THREAD) <= MAX_THREADS
            and stream_smem_bytes(source, hidden, rows) <= MAX_SMEM_BYTES)


def stream_takes(source: str, hidden: int) -> bool:
    """Whether any plan of the stream kernel of ``source`` takes H."""
    return any(_stream_rule(source, hidden, c, rows)
               for c in range(1, STREAM_MAX_CLUSTER + 1)
               for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1,
                                 ROWS_PER_THREAD))


def stream_refusal(source: str, hidden: int) -> str:
    """Why no stream plan of ``source`` takes H: its exchange tile at the
    smallest batch tile (or a block's threads) against the card's limits."""
    need = stream_smem_bytes(source, hidden, ROWS_PER_THREAD)
    return (f"the stream kernel's exchange tile of {STREAM_GATES[source]} x "
            f"H rows needs "
            f"{need} bytes a block at {ROWS_PER_THREAD} rows, over the "
            f"{MAX_SMEM_BYTES} an H100 block can have")


def check_stream_mirror(smem_query, source: str) -> None:
    """Hold ``_stream_rule`` and ``stream_smem_bytes`` to a built source's
    ``<source>_stream_smem_bytes(H, C, R)`` (bytes, or -1 for a plan it
    does not take) over H, every cluster size to one past the largest and a
    few tiles; raises naming the first plan where they differ."""
    for hidden in (1, 7, 64, 139, 256, 257, 260, 320, 511, 512, 1024, 1816,
                   1817, 2422, 7265):
        for c in range(1, STREAM_MAX_CLUSTER + 2):
            for rows in (3, 4, 8, 12, 32, 64):
                want = (stream_smem_bytes(source, hidden, rows)
                        if _stream_rule(source, hidden, c, rows) else -1)
                got = smem_query(hidden, c, rows)
                if got != want:
                    raise RuntimeError(
                        f"{source}_stream: the wrapper's plan mirror gives "
                        f"{want} bytes at H={hidden}, plan {c}x{rows}, the "
                        f"built source {got}: update STREAM_* or "
                        "stream_smem_bytes to match the source")


def rank_stream_plans(plans, batch: int, hidden: int,
                      resident: Callable[[int, int], int], dirs: int,
                      wbytes: int) -> List[Tuple[int, int]]:
    """The ``(cluster, rows)`` plans of a stream kernel, fastest first.

    A block of U = ``slice_units`` units a step issues U x rows FMAs for
    each of the gates x H (gate, k) pairs and reads U values of W_hh of
    ``wbytes`` bytes for each through L2; the blocks of a wave together
    read that many times more through the card's L2. So a step costs, per
    (gate, k), the largest of U x rows / ``STREAM_SM_FMA``, U x wbytes /
    ``STREAM_SM_L2`` and the wave's blocks x U x wbytes /
    ``STREAM_CARD_L2`` cycles, times the waves of the grid of ``dirs``
    directions (``resident(cluster, rows)`` clusters at once, the card's
    own count; a plan the card runs none of is dropped). Ties go to the
    plan that walks fewer rows past the batch, then the smaller tile, then
    the larger cluster."""
    keys = []
    for c, rows in plans:
        at_once = resident(c, rows)
        if at_once <= 0:
            continue
        tiles = dirs * -(-batch // rows)
        U = slice_units(hidden, c)
        blocks = min(tiles, at_once) * c
        step = max(U * rows / STREAM_SM_FMA, U * wbytes / STREAM_SM_L2,
                   blocks * U * wbytes / STREAM_CARD_L2)
        keys.append((-(-tiles // at_once) * step, tiles * rows, rows, -c,
                     c))
    return [(c, rows) for *_, rows, _, c in sorted(keys)]


def stream_plans(source: str, batch: int, hidden: int,
                 resident: Callable[[int, int], int], dirs: int = 2,
                 wbytes: int = 4) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` the stream kernel of ``source`` takes at
    this batch and H over ``dirs`` directions, tiles up to ``MAX_ROWS``,
    fastest first (``rank_stream_plans``; ``wbytes``: bytes of a W_hh
    value, the stream dtype's)."""
    return rank_stream_plans(
        [(c, rows) for c in range(1, STREAM_MAX_CLUSTER + 1)
         for rows in range(ROWS_PER_THREAD, MAX_ROWS + 1, ROWS_PER_THREAD)
         if _stream_rule(source, hidden, c, rows)],
        batch, hidden, resident, dirs, wbytes)


def pipe_hp(hidden: int) -> int:
    """H padded to a multiple of 8: the k values of a chunk row of the
    pipe kernel's packed W_hh (whole 16-byte rows in bf16)."""
    return -(-hidden // 8) * 8


def pipe_units(hidden: int, cluster: int) -> int:
    """Hidden units one block of the pipe kernel owns: ceil(H / C) up to a
    multiple of 4, so that a k group of 4 lies in one block's units; the
    last block's slice is masked past H."""
    return -(-slice_units(hidden, cluster) // 4) * 4


def pipe_kpt(hidden: int) -> int:
    """k groups of 4 a consumer thread of a pipe kernel sums: 1 up to
    H=1024, 2 up to 2048 (more the LSTM's kernel does not take; the GRU's
    takes one)."""
    return -(-(pipe_hp(hidden) // 4) // PIPE_GROUPS)


def pipe_jc(hidden: int, gates: int = 4) -> int:
    """Gate columns of a chunk of the W_hh slice of the pipe kernel of
    ``gates`` gates: the LSTM's 16 where a thread sums one k group (H <=
    1024), 8 above (two chunks of 16 columns of f32 there would not fit a
    block); the GRU's 12 (3U is a multiple of 12)."""
    jc = PIPE_JC[gates]
    return jc[min(pipe_kpt(hidden), max(jc))]


def _pipe_busy(hidden: int) -> int:
    """Consumer threads of the pipe kernel with a k group to sum."""
    return -(-(pipe_hp(hidden) // 4) // pipe_kpt(hidden))


def pipe_warps(hidden: int) -> int:
    """Consumer warps of a pipe-kernel block: a thread for each k group of
    a pass, ``PIPE_MIN_WARPS`` at least; the block adds a producer warp."""
    return max(PIPE_MIN_WARPS, -(-_pipe_busy(hidden) // 32))


def pipe_layout(hidden: int, cluster: int, rows: int, wbytes: int,
                gates: int = 4) -> Tuple[int, int, int, int, int, int]:
    """A block of the pipe kernel of ``gates`` gates at H, C and R with
    W_hh of ``wbytes`` bytes a value (``<PIPE_SOURCE>_pipe_layout`` of its
    source, by ``what``): dynamic shared memory in bytes, threads, units,
    chunks of the slice in shared memory, of those the ones held for the
    whole walk, and the slice's chunks. Shared memory: as many chunks of
    ``pipe_jc(H, gates)`` x ``pipe_hp(H)`` values as fit (at most the
    slice's and ``PIPE_MAX_STAGES``) beside the partials [2][C][R][U] and
    the dg tile [gates x U][R] in float32 and the mbarriers; where the
    slice does not fit, ``PIPE_RING`` of them are the ring the other chunks
    stream through."""
    U = pipe_units(hidden, cluster)
    jc = pipe_jc(hidden, gates)
    chunk = jc * pipe_hp(hidden) * wbytes
    chunks = gates * U // jc
    fixed = (2 * cluster * rows * U + gates * U * rows) * 4 \
        + (2 * PIPE_MAX_STAGES + 2) * 8
    stages = (0 if fixed >= MAX_SMEM_BYTES else
              min(chunks, PIPE_MAX_STAGES, (MAX_SMEM_BYTES - fixed) // chunk))
    ring = 0 if stages >= chunks else min(stages, PIPE_RING)
    return (stages * chunk + fixed, 32 * (pipe_warps(hidden) + 1), U, stages,
            stages - ring, chunks)


def _pipe_rule(hidden: int, cluster: int, rows: int, wbytes: int,
               gates: int = 4) -> bool:
    """The plan rule of the pipe kernel of ``gates`` gates
    (``valid_pipe_plan``): 1 to ``PIPE_MAX_CLUSTER`` blocks each owning a
    unit, at most as many k groups a thread as ``PIPE_JC[gates]`` has (the
    LSTM's H <= 2048, the GRU's H <= 1024), a tile of ``PIPE_ROWS``, at
    most ``PIPE_CELLS`` cells a consumer thread, and two chunks of the
    slice in shared memory at least (one where the slice is one chunk)."""
    if not (hidden > 0 and 1 <= cluster <= PIPE_MAX_CLUSTER):
        return False
    kpt = pipe_kpt(hidden)
    if kpt > max(PIPE_JC[gates]) or rows not in PIPE_ROWS[kpt]:
        return False
    U = pipe_units(hidden, cluster)
    if (cluster - 1) * U >= hidden or \
            U * rows > PIPE_CELLS * 32 * pipe_warps(hidden):
        return False
    _, _, _, stages, _, chunks = pipe_layout(hidden, cluster, rows, wbytes,
                                             gates)
    return stages >= min(chunks, 2)


def _pipe_plan_grid(hidden: int, wbytes: int,
                    gates: int = 4) -> List[Tuple[int, int]]:
    return [(c, rows) for c in range(1, PIPE_MAX_CLUSTER + 1)
            for rows in PIPE_ROWS[min(pipe_kpt(hidden), 2)]
            if _pipe_rule(hidden, c, rows, wbytes, gates)]


def pipe_takes(hidden: int, gates: int = 4) -> bool:
    """Whether any plan of the pipe kernel of ``gates`` gates takes H in
    float32 (then also in bf16, whose chunks are half the bytes)."""
    return bool(_pipe_plan_grid(hidden, 4, gates))


def check_pipe_mirror(layout, gates: int = 4) -> None:
    """Hold ``_pipe_rule`` and ``pipe_layout`` of the pipe kernel of
    ``gates`` gates to its built source's ``<PIPE_SOURCE>_pipe_layout(what,
    bf16, H, C, R)`` (or -1 for a plan it does not take) over H, every
    cluster size to one past the largest, a few tiles and both W_hh types;
    raises naming the first plan where they differ."""
    for hidden in (1, 7, 64, 139, 256, 257, 260, 320, 511, 512, 1024, 1025,
                   1816, 1817, 2048, 2049):
        for c in range(1, PIPE_MAX_CLUSTER + 2):
            for rows in (1, 2, 3, 4, 8, 12, 16, 32):
                for bf16 in (0, 1):
                    wbytes = 2 if bf16 else 4
                    want = (pipe_layout(hidden, c, rows, wbytes, gates)
                            if _pipe_rule(hidden, c, rows, wbytes, gates)
                            else (-1,) * 6)
                    got = tuple(layout(what, bf16, hidden, c, rows)
                                for what in range(6))
                    if got != want:
                        raise RuntimeError(
                            f"{PIPE_SOURCE[gates]}_pipe: the wrapper's plan "
                            f"mirror gives {want} (shared bytes, threads, "
                            "units, chunks there, held, of the slice) at "
                            f"H={hidden}"
                            f", plan {c}x{rows}, {'bf16' if bf16 else 'f32'}"
                            f" W_hh, the built source {got}: update PIPE_* "
                            "or pipe_layout to match the source")


def rank_pipe_plans(plans, batch: int, hidden: int,
                    resident: Callable[[int, int], int], dirs: int,
                    wbytes: int, gates: int = 4) -> List[Tuple[int, int]]:
    """The ``(cluster, rows)`` plans of the pipe kernel of ``gates``
    gates, fastest first.

    A block's step costs the larger of its FMA issue (gates x U x
    ``pipe_hp(H)``
    x rows FMAs over its busy warps, four at most issuing at once, 32 a
    warp instruction), its streamed chunks' L2 bytes at ``STREAM_SM_L2``
    and the wave's at ``STREAM_CARD_L2``, plus ``PIPE_STEP_FIXED`` and
    ``PIPE_CELL_PARTIAL`` for each of the C partials of each cell a
    consumer thread sums; times the waves of the grid of ``dirs``
    directions (``resident(cluster, rows)`` clusters at once, the card's
    own count; a plan the card runs none of is dropped). Ties go to the
    plan that walks fewer rows past the batch, then the smaller tile, then
    the larger cluster."""
    hp = pipe_hp(hidden)
    busy = min(4, -(-_pipe_busy(hidden) // 32))
    keys = []
    for c, rows in plans:
        at_once = resident(c, rows)
        if at_once <= 0:
            continue
        _, threads, U, _, held, chunks = pipe_layout(hidden, c, rows, wbytes,
                                                     gates)
        tiles = dirs * -(-batch // rows)
        blocks = min(tiles, at_once) * c
        streamed = (chunks - held) * pipe_jc(hidden, gates) * hp * wbytes
        cells = -(-U * rows // (threads - 32))
        step = (max(gates * U * hp * rows / (32 * busy),
                    streamed / STREAM_SM_L2,
                    blocks * streamed / STREAM_CARD_L2)
                + PIPE_STEP_FIXED + cells * c * PIPE_CELL_PARTIAL)
        keys.append((-(-tiles // at_once) * step, tiles * rows, rows, -c,
                     c))
    return [(c, rows) for *_, rows, _, c in sorted(keys)]


def pipe_plans(batch: int, hidden: int, resident: Callable[[int, int], int],
               dirs: int = 2, wbytes: int = 4,
               gates: int = 4) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` the pipe kernel of ``gates`` gates takes
    at this batch and H over ``dirs`` directions with W_hh of ``wbytes``
    bytes (the stream dtype's), fastest first (``rank_pipe_plans``)."""
    return rank_pipe_plans(_pipe_plan_grid(hidden, wbytes, gates), batch,
                           hidden, resident, dirs, wbytes, gates)


def pipe_weights(w: torch.Tensor, cluster: int) -> torch.Tensor:
    """W_hh [H, gates x H] (the LSTM's four gates, the GRU's three) as a
    pipe kernel reads it at cluster size C: [C, gates, U, HP]
    (``pipe_units``, ``pipe_hp``), contiguous, so that block q's slice is
    one run of gates x U rows, row g * U + u holding column g * H + q * U +
    u of W_hh over k; zero past H in both."""
    H = w.shape[0]
    gates = w.shape[1] // H
    U, HP = pipe_units(H, cluster), pipe_hp(H)
    wt = F.pad(w.t().reshape(gates, H, H), (0, HP - H, 0, cluster * U - H))
    return wt.reshape(gates, cluster, U, HP).transpose(0, 1).contiguous()


def fwd_pipe_hp(hidden: int) -> int:
    """H padded to whole chunks of ``FPIPE_JK`` rows of k: the rows of the
    forward pipe kernels' packed W_hh."""
    return -(-hidden // FPIPE_JK) * FPIPE_JK


def fwd_pipe_units(hidden: int, cluster: int) -> int:
    """Hidden units one block of a forward pipe kernel owns: ceil(H / C) up
    to a multiple of 4 (the exchange's 16-byte pieces at any tile); the
    last block's slice is masked past H."""
    return -(-slice_units(hidden, cluster) // 4) * 4


def fwd_pipe_unit_warps(hidden: int, cluster: int) -> int:
    """Warps that cover a forward pipe block's units once,
    ``FPIPE_UNITS_WARP`` units each."""
    return -(-fwd_pipe_units(hidden, cluster) // FPIPE_UNITS_WARP)


def fwd_pipe_groups(hidden: int, cluster: int, rows: int) -> int:
    """Row groups of a forward pipe block: tiles of ``FPIPE_GROUP_ROWS``
    split into two halves, each walked by its own warps, where the block
    stays within ``FPIPE_MAX_WARPS``; else one."""
    return (2 if rows in FPIPE_GROUP_ROWS and 2 * fwd_pipe_unit_warps(
        hidden, cluster) <= FPIPE_MAX_WARPS else 1)


def fwd_pipe_warps(hidden: int, cluster: int, rows: int) -> int:
    """Consumer warps of a forward pipe block: its unit warps in each row
    group; the block adds a producer warp."""
    return (fwd_pipe_unit_warps(hidden, cluster)
            * fwd_pipe_groups(hidden, cluster, rows))


def fwd_pipe_row_stride(rows: int) -> int:
    """Floats of a row of the forward pipe kernels' h tile: the tile's
    rows, 20 at 16 (so that a warp's four quarters read four rows of k
    without a bank conflict)."""
    return 20 if rows == 16 else rows


def fwd_pipe_layout(hidden: int, cluster: int, rows: int, wbytes: int
                    ) -> Tuple[int, int, int, int, int, int]:
    """A block of a forward pipe kernel (either family's) at H, C and R with
    W_hh of ``wbytes`` bytes a value (``<FPIPE_SOURCE>_pipe_layout`` of its
    source, by ``what``): dynamic shared memory in bytes, threads, units,
    chunks of the slice in shared memory, of those the ones held for the
    whole walk, and the slice's chunks. Shared memory: as many chunks of
    ``FPIPE_JK`` x U x 4 values as fit (at most the slice's and
    ``FPIPE_MAX_STAGES``) beside the double-buffered h tile [2][TK][RS]
    (TK: the cluster's units or ``fwd_pipe_hp(H)``, the larger; RS:
    ``fwd_pipe_row_stride``) in float32 and the mbarriers; where the slice
    does not fit, ``FPIPE_RING`` of them are the ring the other chunks
    stream through."""
    U = fwd_pipe_units(hidden, cluster)
    hp = fwd_pipe_hp(hidden)
    chunk = FPIPE_JK * U * 4 * wbytes
    chunks = hp // FPIPE_JK
    tk = max(cluster * U, hp)
    fixed = 2 * tk * fwd_pipe_row_stride(rows) * 4 \
        + (2 * FPIPE_MAX_STAGES + 2) * 8
    stages = (0 if fixed >= MAX_SMEM_BYTES else
              min(chunks, FPIPE_MAX_STAGES, (MAX_SMEM_BYTES - fixed) // chunk))
    ring = 0 if stages >= chunks else min(stages, FPIPE_RING)
    return (stages * chunk + fixed,
            32 * (fwd_pipe_warps(hidden, cluster, rows) + 1), U, stages,
            stages - ring, chunks)


def _fwd_pipe_rule(hidden: int, cluster: int, rows: int,
                   wbytes: int) -> bool:
    """The forward pipe kernels' plan rule (``valid_fp_plan``): 1 to
    ``FPIPE_MAX_CLUSTER`` blocks each owning a unit, at most
    ``FPIPE_MAX_WARPS`` consumer warps, a tile of ``FPIPE_ROWS`` (16 rows
    in two row groups only, 12 in a narrow block only: at most 8 rows a
    warp in a wide one), and two chunks of the slice in shared memory at
    least (one where the slice is one chunk)."""
    if not (hidden > 0 and 1 <= cluster <= FPIPE_MAX_CLUSTER
            and rows in FPIPE_ROWS):
        return False
    warps = fwd_pipe_warps(hidden, cluster, rows)
    if (cluster - 1) * fwd_pipe_units(hidden, cluster) >= hidden \
            or warps > FPIPE_MAX_WARPS \
            or (rows == 16 and fwd_pipe_groups(hidden, cluster, rows) != 2) \
            or (rows == 12 and warps > FPIPE_NARROW_WARPS):
        return False
    _, _, _, stages, _, chunks = fwd_pipe_layout(hidden, cluster, rows,
                                                 wbytes)
    return stages >= min(chunks, 2)


def _fwd_pipe_plan_grid(hidden: int, wbytes: int) -> List[Tuple[int, int]]:
    return [(c, rows) for c in range(1, FPIPE_MAX_CLUSTER + 1)
            for rows in FPIPE_ROWS
            if _fwd_pipe_rule(hidden, c, rows, wbytes)]


def fwd_pipe_takes(hidden: int) -> bool:
    """Whether any plan of the forward pipe kernels takes H in float32
    (then also in bf16, whose chunks are half the bytes): H <= 1920."""
    return bool(_fwd_pipe_plan_grid(hidden, 4))


def check_fwd_pipe_mirror(layout, gates: int = 4) -> None:
    """Hold ``_fwd_pipe_rule`` and ``fwd_pipe_layout`` to the built
    forward pipe source of ``gates`` gates (``<FPIPE_SOURCE>_pipe_layout(
    what, bf16, H, C, R)``, or -1 for a plan it does not take) over H,
    every cluster size to one past the largest, every tile and a few
    others, and both W_hh types; raises naming the first plan where they
    differ."""
    for hidden in (1, 7, 64, 139, 256, 257, 260, 320, 511, 512, 1000, 1024,
                   1025, 1816, 2048, 2049):
        for c in range(1, FPIPE_MAX_CLUSTER + 2):
            for rows in (*FPIPE_ROWS, 3, 32):
                for bf16 in (0, 1):
                    wbytes = 2 if bf16 else 4
                    want = (fwd_pipe_layout(hidden, c, rows, wbytes)
                            if _fwd_pipe_rule(hidden, c, rows, wbytes)
                            else (-1,) * 6)
                    got = tuple(layout(what, bf16, hidden, c, rows)
                                for what in range(6))
                    if got != want:
                        raise RuntimeError(
                            f"{FPIPE_SOURCE[gates]}_pipe: the wrapper's plan "
                            f"mirror gives {want} (shared bytes, threads, "
                            "units, chunks there, held, of the slice) at "
                            f"H={hidden}, plan {c}x{rows}, "
                            f"{'bf16' if bf16 else 'f32'} W_hh, the built "
                            f"source {got}: update FPIPE_* or "
                            "fwd_pipe_layout to match the source")


def rank_fwd_pipe_plans(plans, batch: int, hidden: int,
                        resident: Callable[[int, int], int], dirs: int,
                        wbytes: int, gates: int = 4) -> List[Tuple[int, int]]:
    """The ``(cluster, rows)`` plans of the forward pipe kernel of
    ``gates`` gates, fastest first.

    A lane sums ``fwd_pipe_hp(H)`` / 4 rows of k, each ``gates`` x R2
    FMAs (R2: its row group's rows) at ``FPIPE_FMA_CYCLES`` each, and the
    block's warps share four schedulers; a wave's blocks beyond
    ``FPIPE_SMS`` share SMs. So a block's step costs the largest of its FMA
    time (the warps a scheduler runs x the lane's FMAs) and its streamed
    chunks' L2 bytes at ``FPIPE_SM_L2``, both times the blocks an SM runs,
    and the wave's at ``STREAM_CARD_L2``, plus ``FPIPE_STEP_FIXED`` and
    ``FPIPE_ROW_CELLS`` for each of a warp's R2 rows; times the waves of
    the grid of ``dirs`` directions (``resident(cluster, rows)`` clusters
    at once, the card's own count; a plan the card runs none of is
    dropped). Fitted to phase
    40's sweeps on an H100 (PERF.md section 6). Ties go to the plan that
    walks fewer rows past the batch, then the smaller tile, then the
    larger cluster."""
    quads = fwd_pipe_hp(hidden) // 4
    keys = []
    for c, rows in plans:
        at_once = resident(c, rows)
        if at_once <= 0:
            continue
        _, _, U, _, held, chunks = fwd_pipe_layout(hidden, c, rows, wbytes)
        warps = fwd_pipe_warps(hidden, c, rows)
        r2 = rows // fwd_pipe_groups(hidden, c, rows)
        tiles = dirs * -(-batch // rows)
        blocks = min(tiles, at_once) * c
        streamed = (chunks - held) * FPIPE_JK * U * 4 * wbytes
        share = -(-blocks // FPIPE_SMS)
        step = (max(share * -(-warps // 4) * quads * gates * r2
                    * FPIPE_FMA_CYCLES, share * streamed / FPIPE_SM_L2,
                    blocks * streamed / STREAM_CARD_L2)
                + FPIPE_STEP_FIXED + FPIPE_ROW_CELLS * r2)
        keys.append((-(-tiles // at_once) * step, tiles * rows, rows, -c,
                     c))
    return [(c, rows) for *_, rows, _, c in sorted(keys)]


def fwd_pipe_plans(batch: int, hidden: int,
                   resident: Callable[[int, int], int], dirs: int = 2,
                   wbytes: int = 4, gates: int = 4) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` the forward pipe kernel of ``gates`` gates
    takes at this batch and H over ``dirs`` directions with W_hh of
    ``wbytes`` bytes (the stream dtype's), fastest first
    (``rank_fwd_pipe_plans``)."""
    return rank_fwd_pipe_plans(_fwd_pipe_plan_grid(hidden, wbytes), batch,
                               hidden, resident, dirs, wbytes, gates)


def fwd_pipe_weights(w: torch.Tensor, cluster: int) -> torch.Tensor:
    """W_hh [H, gates x H] (the LSTM's four gates, the GRU's three) as a
    forward pipe kernel reads it at cluster size C: [C, HP, U, 4]
    (``fwd_pipe_units``, ``fwd_pipe_hp``), contiguous, so that block q's
    slice is one run of HP x U x 4 values, value (k, u, g) holding W_hh[k,
    g * H + q * U + u]; zero past H in both and, for the GRU, at g = 3."""
    H = w.shape[0]
    gates = w.shape[1] // H
    U, HP = fwd_pipe_units(H, cluster), fwd_pipe_hp(H)
    wk = F.pad(w.reshape(H, gates, H), (0, cluster * U - H, 0, 4 - gates,
                                        0, HP - H))
    return wk.reshape(HP, 4, cluster, U).permute(2, 0, 3, 1).contiguous()


def _lstm_route(kind: str, hidden: int) -> str:
    name = f"bilstm_{kind}"
    if hidden <= 0:
        raise ValueError(f"{name}: H must be positive, got {hidden}")
    if hidden <= UNIT_MAX_H:
        return "unit"
    if reg_takes(kind, hidden):
        return "reg"
    # the forward's pipe kernel is routed as far as its A/B against the
    # first stream design (chip_smoke.py phase 40) reaches, the BPTT's as
    # far as the first stream design takes H
    if kind == "fwd" and hidden <= LSTM_FWD_PIPE_MAX_H \
            and fwd_pipe_takes(hidden):
        return "pipe"
    if stream_takes(name, hidden) and (kind == "fwd" or pipe_takes(hidden)):
        return "stream" if kind == "fwd" else "pipe"
    pipe = ("the pipe kernel is routed where the first stream design takes "
            "H, and " if kind == "bwd" else "and ")
    raise ValueError(
        f"{name}: no kernel takes H={hidden} on this card: the unit kernel "
        f"holds H <= {UNIT_MAX_H}, the register cluster kernel takes "
        f"H <= {CLUSTER_MAX_H}, {pipe}{stream_refusal(name, hidden)}")


def lstm_fwd_kernel_route(hidden: int) -> str:
    """The forward kernel of ``csrc/bilstm_fwd.cu`` that takes hidden size
    ``hidden`` (whatever the batch, stream dtype or direction count):
    "unit" up to ``UNIT_MAX_H``, else "reg" (the register cluster kernel)
    up to ``CLUSTER_MAX_H``, else "pipe" (the forward pipe kernel,
    ``csrc/bilstm_fwd_pipe.cu``) up to ``LSTM_FWD_PIPE_MAX_H`` (the widest
    width its A/B times), else "stream" (the first stream design) where its
    h tile fits a block. The wide kernel (the first design above H=64,
    where its W_hh fits one block's shared memory: H <= 118), the first
    cluster kernel ("cluster") and the stream kernel at the pipe kernel's
    widths are reached only by a forced plan. Raises, naming the width and
    the card's limit, for an H none takes."""
    return _lstm_route("fwd", hidden)


def bilstm_bwd_smem_bytes(hidden: int) -> int:
    """Shared memory one block of the backward kernel needs (mirrors
    ``smem_bytes`` in ``csrc/bilstm_bwd.cu``): W_hh^T and a double-buffered
    dg tile."""
    G = 4 * hidden
    return (G * hidden + 2 * _ROWS_PER_BLOCK * G) * 4


def lstm_bwd_kernel_route(hidden: int) -> str:
    """The BPTT kernel of ``csrc/bilstm_bwd.cu`` (or, "pipe",
    ``csrc/bilstm_pipe.cu``) that takes hidden size ``hidden`` (whatever
    the batch, stream dtype or direction count): "unit"
    (``bilstm_bwd_unit_kernel``) up to ``UNIT_MAX_H``, else "reg" (the
    register cluster kernel) up to ``CLUSTER_MAX_H``, else "pipe" (the pipe
    kernel) where the first stream design's dg tile fits a block (H <=
    1816: the widths its A/B covers); the wide kernel (the first design
    above H=64, where its W_hh^T and dg tile fit one block's shared memory:
    H <= 116), the first cluster kernel, the stream kernel and the pipe
    kernel's plans above 1816 (to H=2048) are reached only by a forced
    plan. Raises, naming the width and the card's limit, for an H none
    takes."""
    return _lstm_route("bwd", hidden)


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


def grad_product(at: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``at @ b`` summed and returned in float32 (float64 for float64
    operands), for the weight gradients outside the kernels. bf16 operands
    on the card multiply as they are, with float32 sums and a float32
    result (``torch.mm(..., out_dtype=torch.float32)``, the reference's
    ``preferred_element_type=f32``): a bf16 x bf16 product is exact in
    float32, so the values are the upcast product's up to summation order,
    with no float32 copy of a stream and no process-wide precision flag.
    float32 operands (TF32 off, as every float32 matmul of the port) and
    CPU tensors multiply upcast to the work dtype."""
    if at.is_cuda and at.dtype == torch.bfloat16 == b.dtype:
        return torch.mm(at, b, out_dtype=torch.float32)
    acc = _work_dtype(at)
    return torch.matmul(at.to(acc), b.to(acc))


def grad_sum(x: torch.Tensor) -> torch.Tensor:
    """The column sums of ``x [M, K]`` in float32 (float64 for float64):
    on the card a bf16 stream is summed in float32 as it is; CPU tensors
    sum upcast."""
    acc = _work_dtype(x)
    if x.is_cuda:
        return x.sum(0, dtype=acc)
    return x.to(acc).sum(0)


def _hidden_grad(ys, dg, reverse: bool, dtype: torch.dtype) -> torch.Tensor:
    """``dW_hh = sum_t h_{t-1}^T dg_t`` of one direction, one product
    summed in float32 (float64 for float64 streams, ``grad_product``) and
    returned in ``dtype`` (the reference's einsum, ``rnn_pallas.py:352``).
    """
    H = ys.shape[-1]
    hp = prev_steps(ys, reverse).reshape(-1, H)
    return grad_product(hp.t(), dg.reshape(-1, 4 * H)).to(dtype)


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
    if name == "bilstm_pipe":
        return _bind_pipe(lib, name, "bilstm_bwd", "lstm_bwd", 10, 5, 4)
    if name == "bilstm_fwd_pipe":
        return bind_fwd_pipe(lib, {"bilstm_fwd": 6, "bilstm_fwd_train": 10},
                             {"lstm_fwd": 3, "lstm_fwd_train": 5}, 4)
    # pointers, then B, N, H (the forward: and the tile R and the wide
    # flag; the BPTT's unit kernel: and R), and the reverse flag of one
    # direction
    if name == "bilstm_fwd":
        fns = {"bilstm_fwd": (6, 5), "bilstm_fwd_train": (10, 5),
               "lstm_fwd": (3, 6), "lstm_fwd_train": (5, 6)}
    else:
        fns = {"bilstm_bwd": (10, 3), "lstm_bwd": (5, 4),
               "bilstm_bwd_unit": (10, 4), "lstm_bwd_unit": (5, 5)}
    # the cluster kernels: the pointers, then B, N, H, C, R (and reverse)
    for fn_name in [f for f in fns if not f.endswith("_unit")]:
        n_ptr, n_int = fns[fn_name]
        for kernel in ("cluster", "reg", "stream"):
            fns[f"{fn_name}_{kernel}"] = (
                n_ptr, 5 + int(fn_name.startswith("lstm")))
    for fn_name, (n_ptr, n_int) in fns.items():
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"{fn_name}_{sfx}")
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = ctypes.c_int
    if name == "bilstm_fwd":
        bind_unit_queries(lib, name, gates=4)
    else:
        bind_unit_queries(lib, name, gates=4, tiles=4)
    # the bf16 and kSave flags, then H, C, R; H, C, R; what, H, C, R
    queries = (("cluster_max_active_clusters", 5), ("cluster_smem_bytes", 3),
               ("reg_max_active_clusters", 5), ("reg_layout", 4),
               ("stream_max_active_clusters", 5), ("stream_smem_bytes", 3))
    for query, n_int in queries:
        fn = getattr(lib, f"{name}_{query}")
        fn.argtypes = [i] * n_int
        fn.restype = i
    check_lstm_cluster_mirror(getattr(lib, f"{name}_cluster_smem_bytes"),
                              name[len("bilstm_"):])
    check_reg_mirror(getattr(lib, f"{name}_reg_layout"),
                     name[len("bilstm_"):])
    check_stream_mirror(getattr(lib, f"{name}_stream_smem_bytes"), name)
    set_error_string(lib, name)
    return lib


def _bind_pipe(lib, name: str, two: str, one: str, n_ptr: int,
               n_one: int, gates: int):
    """Bind a pipe kernel's library ``name`` (``csrc/bilstm_pipe.cu``,
    ``csrc/bigru_pipe.cu``): the entries ``<two>_pipe_<dtype>`` (``n_ptr``
    pointers of both directions, then B, N, H, C, R) and
    ``<one>_pipe_<dtype>`` (``n_one`` pointers of one direction, then B, N,
    H, C, R and the reverse flag), and the queries
    ``<two>_pipe_max_active_clusters`` (the bf16 and kSave flags, H, C, R)
    and ``<two>_pipe_layout`` (what, the bf16 flag, H, C, R), held to
    ``pipe_layout`` of ``gates`` gates (``check_pipe_mirror``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        for fn_name, ptrs, ints in ((f"{two}_pipe_{sfx}", n_ptr, 5),
                                    (f"{one}_pipe_{sfx}", n_one, 6)):
            fn = getattr(lib, fn_name)
            fn.argtypes = [p] * ptrs + [i] * ints + [p]
            fn.restype = ctypes.c_int
    for query in ("pipe_max_active_clusters", "pipe_layout"):
        fn = getattr(lib, f"{two}_{query}")
        fn.argtypes = [i] * 5
        fn.restype = i
    check_pipe_mirror(getattr(lib, f"{two}_pipe_layout"), gates)
    set_error_string(lib, name)
    return lib


def bind_fwd_pipe(lib, two: dict, one: dict, gates: int):
    """Bind a forward pipe kernel's library (``csrc/bilstm_fwd_pipe.cu``,
    ``csrc/bigru_fwd_pipe.cu``): the entries ``<name>_pipe_<dtype>`` of
    ``two`` (pointers of both directions by name, then B, N, H, C, R) and
    of ``one`` (pointers of one direction, then B, N, H, C, R and the
    reverse flag), and the queries ``<source>_pipe_max_active_clusters``
    (the bf16 and kSave flags, H, C, R) and ``<source>_pipe_layout`` (what,
    the bf16 flag, H, C, R), held to ``fwd_pipe_layout``
    (``check_fwd_pipe_mirror``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    source = FPIPE_SOURCE[gates]
    for sfx in _SUFFIX.values():
        for entries, ints in ((two, 5), (one, 6)):
            for name, ptrs in entries.items():
                fn = getattr(lib, f"{name}_pipe_{sfx}")
                fn.argtypes = [p] * ptrs + [i] * ints + [p]
                fn.restype = ctypes.c_int
    for query in ("pipe_max_active_clusters", "pipe_layout"):
        fn = getattr(lib, f"{source}_{query}")
        fn.argtypes = [i] * 5
        fn.restype = i
    check_fwd_pipe_mirror(getattr(lib, f"{source}_pipe_layout"), gates)
    set_error_string(lib, f"{source}_pipe")
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
_CLUSTER_PLANS: dict = {}   # cluster-kernel launch plans, likewise


def _cluster_resident(source: str, H: int, dev: torch.device, T,
                      save: bool, kernel: str = "cluster"
                      ) -> Callable[[int, int], int]:
    """``resident(cluster, rows)``: how many clusters of that plan of the
    LSTM cluster kernel ``kernel`` ("cluster", "reg", "stream" or "pipe",
    whose library is ``csrc/bilstm_pipe.cu``'s for the BPTT and
    ``csrc/bilstm_fwd_pipe.cu``'s for the forward) of ``source``
    ("bilstm_fwd" or "bilstm_bwd") the card ``dev`` runs at once."""
    query = getattr(_library(_lstm_library(source, kernel)),
                    f"{source}_{kernel}_max_active_clusters")

    def resident(c, rows):
        with torch.cuda.device(dev):
            return query(int(T == torch.bfloat16), int(save), H, c, rows)

    return resident


def card_lstm_cluster_plans(kind: str, B: int, H: int, dev: torch.device,
                            dtype: torch.dtype, save: bool,
                            dirs: int) -> List[Tuple[int, int]]:
    """``lstm_cluster_plans`` of the LSTM cluster kernel ``kind`` ("fwd"
    or "bwd") on the card ``dev`` (its own counts), fastest first; the
    first is the plan a launch takes."""
    return lstm_cluster_plans(
        kind, B, H, _cluster_resident(f"bilstm_{kind}", H, dev, dtype, save),
        dirs)


def card_lstm_reg_plans(kind: str, B: int, H: int, dev: torch.device,
                        dtype: torch.dtype, save: bool,
                        dirs: int) -> List[Tuple[int, int]]:
    """``lstm_reg_plans`` of the register cluster kernel ``kind`` ("fwd"
    or "bwd") on the card ``dev`` (its own counts), fastest first; the
    first is the plan a launch takes."""
    return lstm_reg_plans(
        kind, B, H,
        _cluster_resident(f"bilstm_{kind}", H, dev, dtype, save, "reg"),
        dirs)


def card_lstm_stream_plans(kind: str, B: int, H: int, dev: torch.device,
                           dtype: torch.dtype, save: bool,
                           dirs: int) -> List[Tuple[int, int]]:
    """``stream_plans`` of the LSTM stream kernel ``kind`` ("fwd" or "bwd")
    on the card ``dev`` (its own counts), fastest first; the first is the
    plan a launch takes."""
    source = f"bilstm_{kind}"
    return stream_plans(
        source, B, H,
        _cluster_resident(source, H, dev, dtype, save, "stream"), dirs,
        dtype.itemsize)


def card_lstm_pipe_plans(B: int, H: int, dev: torch.device,
                         dtype: torch.dtype,
                         dirs: int) -> List[Tuple[int, int]]:
    """``pipe_plans`` of the LSTM BPTT's pipe kernel on the card ``dev``
    (its own counts), fastest first; the first is the plan a launch
    takes."""
    return pipe_plans(
        B, H, _cluster_resident("bilstm_bwd", H, dev, dtype, False, "pipe"),
        dirs, dtype.itemsize)


def card_lstm_fwd_pipe_plans(B: int, H: int, dev: torch.device,
                             dtype: torch.dtype, save: bool,
                             dirs: int) -> List[Tuple[int, int]]:
    """``fwd_pipe_plans`` of the LSTM forward's pipe kernel on the card
    ``dev`` (its own counts), fastest first; the first is the plan a launch
    takes."""
    return fwd_pipe_plans(
        B, H, _cluster_resident("bilstm_fwd", H, dev, dtype, save, "pipe"),
        dirs, dtype.itemsize)


def card_name(dev: torch.device) -> str:
    """The card's name, for an error that names where a plan failed."""
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def _plan_rules(kind: str, H: int, T: torch.dtype):
    """The register (``"reg"``), first (``"cluster"``), stream
    (``"stream"``) and pipe (``"pipe"``: the BPTT's or the forward's)
    cluster kernels' plan test, planners (every plan, fastest first) and
    plan rule as text, for ``cluster_launch_plan``."""
    source = f"bilstm_{kind}"
    pipe = {"pipe": (
        lambda c, r: _pipe_rule(H, c, r, T.itemsize),
        lambda kind_, B, H_, res, dirs: pipe_plans(B, H_, res, dirs,
                                                   T.itemsize),
        f"1 to {PIPE_MAX_CLUSTER} blocks each owning a unit, a tile of "
        f"{PIPE_ROWS[min(pipe_kpt(H), 2)]} rows, at most {PIPE_CELLS} cells "
        "a thread, two chunks of W_hh's slice in shared memory")
    } if kind == "bwd" else {"pipe": (
        lambda c, r: _fwd_pipe_rule(H, c, r, T.itemsize),
        lambda kind_, B, H_, res, dirs: fwd_pipe_plans(B, H_, res, dirs,
                                                       T.itemsize),
        f"1 to {FPIPE_MAX_CLUSTER} blocks each owning a unit, at most "
        f"{FPIPE_MAX_WARPS} consumer warps of {FPIPE_UNITS_WARP} units, a "
        f"tile of {FPIPE_ROWS} rows (16 in two row groups, 12 in at most "
        f"{FPIPE_NARROW_WARPS} warps), two chunks of W_hh's slice in shared "
        "memory")}
    return {**pipe,
        "reg": (lambda c, r: _reg_rule(kind, H, c, r), lstm_reg_plans,
                f"H at most {CLUSTER_MAX_H}, 1 to {REG_MAX_CLUSTER} blocks "
                f"each owning a unit, a tile of {REG_ROWS[kind]} rows, at "
                f"most {REG_MAX_THREADS} threads"),
        "cluster": (lambda c, r: lstm_cluster_fits(kind, H, c, r),
                    lstm_cluster_plans,
                    f"H at most {CLUSTER_MAX_H}, a cluster of "
                    f"{CLUSTER_SIZES} blocks each owning a unit, the tile a "
                    f"multiple of {ROWS_PER_THREAD}, at most {MAX_THREADS} "
                    "threads"),
        "stream": (lambda c, r: _stream_rule(source, H, c, r),
                   lambda kind_, B, H_, res, dirs: stream_plans(
                       source, B, H_, res, dirs, T.itemsize),
                   f"1 to {STREAM_MAX_CLUSTER} blocks each owning a unit, "
                   f"the tile a multiple of {ROWS_PER_THREAD}, at most "
                   f"{MAX_THREADS} threads")}


def cluster_launch_plan(fn, source: str, B: int, H: int, dev: torch.device,
                        T, save: bool, dirs: int,
                        plan: Optional[Tuple[int, int]] = None,
                        kernel: str = "reg") -> Tuple[int, int]:
    """``(cluster, rows)`` of a launch of the LSTM cluster kernel
    ``kernel`` ("reg": the register cluster kernel, "cluster": the first
    design, "stream": the stream kernel, "pipe": the BPTT's pipe kernel) of
    ``source``: its planner's pick with the card's own counts, or the
    caller's ``plan``, refused unless it fits and the card runs such a
    cluster. Recorded with the grid's cluster count in ``fn.last_launch``.
    """
    kind = source[len("bilstm_"):]
    key = (source, kernel, B, H, str(dev), T, save, dirs, plan)
    if key not in _CLUSTER_PLANS:
        rules = _plan_rules(kind, H, T)
        if kernel not in rules:
            raise ValueError(f"{source}: no {kernel} kernel; plans of "
                             f"{sorted(rules)} are taken")
        fits, planner, rule = rules[kernel]
        resident = _cluster_resident(source, H, dev, T, save, kernel)
        if plan is None:
            plans = planner(kind, B, H, resident, dirs)
            if not plans:
                raise ValueError(f"{source}: no {kernel} plan ({rule}) takes "
                                 f"H={H} on {card_name(dev)}")
            cluster, rows = plans[0]
        else:
            cluster, rows = plan
            if not fits(cluster, rows):
                raise ValueError(
                    f"{source}: {kernel} plan {cluster}x{rows} does not fit "
                    f"H={H}: {rule} and {MAX_SMEM_BYTES} bytes of shared "
                    "memory a block")
            if resident(cluster, rows) <= 0:
                raise ValueError(f"{source}: the card runs no cluster of "
                                 f"{kernel} plan {cluster}x{rows} at once")
        _CLUSTER_PLANS[key] = {"kernel": kernel, "cluster": cluster,
                               "rows": rows, "clusters": dirs * -(-B // rows),
                               "resident": resident(cluster, rows)}
    fn.last_launch = _CLUSTER_PLANS[key]
    return fn.last_launch["cluster"], fn.last_launch["rows"]


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


def card_lstm_bwd_unit_plans(B: int, H: int, dev: torch.device,
                             dtype: torch.dtype, dirs: int) -> List[int]:
    """``card_unit_plans`` of the LSTM BPTT unit kernel (``dirs``
    directions): the tiles the card runs, fastest first."""
    return card_unit_plans(_library("bilstm_bwd"), "bilstm_bwd", B, H, dev,
                           dtype, False, dirs)


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


def _kernel(source: str, H: int, plan) -> str:
    """The kernel of ``source`` ("bilstm_fwd" or "bilstm_bwd") that a
    launch at H takes: the caller's ``plan`` or the source's route."""
    if plan is not None:
        return plan[0]
    route = (lstm_fwd_kernel_route if source == "bilstm_fwd"
             else lstm_bwd_kernel_route)
    return route(H)


def _smem(source: str, H: int, plan) -> int:
    """Shared memory of the kernel of ``source`` that ``plan`` (or the
    route) picks at H, for ``_check_cuda``; the unit kernel's largest
    tile (the forward's h tile, the BPTT's four dg tiles); 0 for the
    cluster kernels, whose planners keep each plan within a block's."""
    kernel = _kernel(source, H, plan)
    if kernel == "unit":
        return unit_smem_bytes(max(UNIT_ROWS),
                               tiles=1 if source == "bilstm_fwd" else 4)
    if kernel in ("cluster", "reg", "stream", "pipe"):
        return 0
    return (bilstm_smem_bytes if source == "bilstm_fwd"
            else bilstm_bwd_smem_bytes)(H)


def _plan(fn, source: str, name: str, B: int, H: int, dev, T, save: bool,
          dirs: int, plan):
    """The kernel library, the kernel ("unit", "wide", "reg", "pipe",
    "stream" or "cluster") and the plan's integers of a launch of
    ``source`` ("bilstm_fwd" or "bilstm_bwd"): the route's kernel with
    ``unit_plan``'s tile ``(rows,)``, the wide kernel's ``(4,)``,
    ``lstm_reg_plan``'s, ``pipe_plans``' (the BPTT), ``fwd_pipe_plans``'
    (the forward) or ``stream_plans``' ``(cluster, rows)``; or the caller's
    ``plan`` ("unit", rows), ("wide", 4), ("reg", cluster, rows), ("pipe",
    cluster, rows), ("stream", cluster, rows) or ("cluster", cluster,
    rows), the first cluster kernel's.
    Recorded in ``fn.last_launch``."""
    kernel = _kernel(source, H, plan)
    lib = _library(_lstm_library(source, kernel))
    forced = None if plan is None else tuple(plan[1:])
    if kernel == "unit":
        if H > UNIT_MAX_H:
            raise ValueError(f"{name}: the unit kernel takes H <= "
                             f"{UNIT_MAX_H}, not {H}")
        return lib, kernel, (unit_launch_rows(
            fn, lib, source, B, H, dev, T, save, dirs,
            None if forced is None else forced[0]),)
    if kernel in ("cluster", "reg", "stream", "pipe"):
        return lib, kernel, cluster_launch_plan(fn, source, B, H, dev, T,
                                                save, dirs, forced, kernel)
    if kernel != "wide" or forced not in (None, (_ROWS_PER_BLOCK,)):
        raise ValueError(f"{name}: plan must be ('unit', rows), ('wide', "
                         f"{_ROWS_PER_BLOCK}), ('reg', cluster, rows), "
                         "('pipe', cluster, rows), ('stream', cluster, rows) "
                         f"or ('cluster', cluster, rows), got {plan}")
    fn.last_launch = {"kernel": "wide", "cluster": 1,
                      "rows": _ROWS_PER_BLOCK,
                      "clusters": dirs * -(-B // _ROWS_PER_BLOCK),
                      "resident": None}
    return lib, kernel, (_ROWS_PER_BLOCK,)


def _lstm_library(source: str, kernel: str) -> str:
    """The kernel library of ``kernel`` of ``source``: the pipe kernels'
    sources of their own (``csrc/bilstm_pipe.cu`` for the BPTT,
    ``csrc/bilstm_fwd_pipe.cu`` for the forward), else ``source``'s."""
    if kernel != "pipe":
        return source
    return "bilstm_pipe" if source == "bilstm_bwd" else "bilstm_fwd_pipe"


def _fwd_plan_args(lib_name: str, kernel: str, ints) -> Tuple[str, tuple]:
    """The entry point of ``csrc/bilstm_fwd.cu`` (the pipe kernel's:
    ``csrc/bilstm_fwd_pipe.cu``) and the plan's integers it takes: the
    cluster entries (``<name>_reg_*``, ``<name>_pipe_*``,
    ``<name>_stream_*``, ``<name>_cluster_*``) take (C, R), the others the
    unit tile or 4 and the wide flag."""
    if kernel in ("cluster", "reg", "stream", "pipe"):
        return f"{lib_name}_{kernel}", tuple(ints)
    return lib_name, (ints[0], int(kernel == "wide"))


def _bilstm_fwd_launch(fn, save: bool, xg_f, xg_b, w_f, w_b, plan):
    _check_shapes(xg_f, xg_b, w_f, w_b)
    name = "bilstm_fwd_train" if save else "bilstm_fwd"
    B, N, G = xg_f.shape
    H = G // 4
    dev, T = _check_cuda(name, (xg_f, xg_b), (w_f, w_b),
                         _smem("bilstm_fwd", H, plan))
    outs = [torch.empty(B, N, d, dtype=T, device=dev)
            for d in ((H, H, H, H, G, G) if save else (H, H))]
    if B == 0 or N == 0:
        return tuple(outs)
    lib, kernel, ints = _plan(fn, "bilstm_fwd", name, B, H, dev, T, save, 2,
                              plan)
    entry, ints = _fwd_plan_args(name, kernel, ints)
    w_f, w_b = fwd_weights(kernel, (w_f.to(T), w_b.to(T)), ints[0])
    launch(lib, f"{entry}_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (xg_f, xg_b, w_f, w_b, *outs)), B, N, H,
           *ints)
    fn.launches += 1
    return tuple(outs)


def bilstm_fwd_cuda(xg_f: torch.Tensor, xg_b: torch.Tensor,
                    w_f: torch.Tensor, w_b: torch.Tensor,
                    plan: Optional[Tuple[str, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the light kernel of ``csrc/bilstm_fwd.cu`` (the pipe kernel:
    ``csrc/bilstm_fwd_pipe.cu``) on the current stream. ``plan=("unit",
    rows)``, ``("wide", 4)``, ``("reg", cluster, rows)``, ``("pipe",
    cluster, rows)``, ``("stream", cluster, rows)`` or ``("cluster",
    cluster, rows)`` overrides the route and the planner (raises if it
    does not fit). Records the plan in
    ``bilstm_fwd_cuda.last_launch``. Counts each launch in
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


def fwd_weights(kernel: str, weights, cluster: int = 1) -> list:
    """The forward's W_hh as a launch of ``kernel`` reads it: the pipe
    kernels packed for their cluster size (``fwd_pipe_weights``), every
    other kernel W_hh itself."""
    if kernel == "pipe":
        return [fwd_pipe_weights(w, cluster) for w in weights]
    return list(weights)


def bwd_weights(kernel: str, weights, cluster: int = 1) -> list:
    """The BPTT's W_hh as a launch of ``kernel`` reads it: the stream
    kernels read W_hh^T (a contiguous transposed copy, so that consecutive
    threads read consecutive units), the pipe kernel W_hh packed for its
    cluster size (``pipe_weights``), every other kernel W_hh itself."""
    if kernel == "stream":
        return [w.t().contiguous() for w in weights]
    if kernel == "pipe":
        return [pipe_weights(w, cluster) for w in weights]
    return list(weights)


def _bwd_launch(fn, name: str, ptrs, B: int, N: int, H: int, dev, T,
                dirs: int, plan, *tail) -> None:
    """Launch ``name`` ("bilstm_bwd" or "lstm_bwd", ``csrc/bilstm_bwd.cu``;
    the pipe kernel ``csrc/bilstm_pipe.cu``) on the tensors ``ptrs``, then B, N, H, the plan's integers and
    ``tail`` (the reverse flag of one direction), as ``_plan`` picks: the
    wide kernel's entries take no tile, the unit kernel's
    (``<name>_unit_*``) its tile, the cluster kernels'
    (``<name>_reg_*``, ``<name>_pipe_*``, ``<name>_stream_*``,
    ``<name>_cluster_*``) C and R. The stream and pipe kernels read W_hh in
    their own layouts (``bwd_weights``): ``ptrs`` start with the weights,
    which are passed so there. Counted on ``fn``."""
    lib, kernel, ints = _plan(fn, "bilstm_bwd", name, B, H, dev, T, False,
                              dirs, plan)
    tensors = [*bwd_weights(kernel, ptrs[:dirs], ints[0]), *ptrs[dirs:]]
    ptrs = [t.data_ptr() for t in tensors]   # tensors held to the launch
    sfx = _SUFFIX[T]
    if kernel == "wide":
        launch(lib, f"{name}_{sfx}", dev, *ptrs, B, N, H, *tail)
    else:
        launch(lib, f"{name}_{kernel}_{sfx}", dev, *ptrs, B, N, H, *ints,
               *tail)
    fn.launches += 1


def bilstm_bwd_cuda(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b,
                    plan: Optional[Tuple[str, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/bilstm_bwd.cu`` (the pipe kernel:
    ``csrc/bilstm_pipe.cu``): returns ``(dg_f, dg_b)``.
    ``lstm_bwd_kernel_route`` picks the unit, wide, register cluster or
    pipe kernel; ``plan=("unit", rows)``, ``("wide", 4)``, ``("reg",
    cluster, rows)``, ``("pipe", cluster, rows)``, ``("stream", cluster,
    rows)`` or ``("cluster", cluster, rows)`` overrides the route and the
    planner (raises if it does not fit). Records the plan in
    ``bilstm_bwd_cuda.last_launch`` and counts each launch in
    ``bilstm_bwd_cuda.launches``."""
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
                         _smem("bilstm_bwd", H, plan))
    dg_f = torch.empty(B, N, G, dtype=T, device=dev)
    dg_b = torch.empty_like(dg_f)
    if B == 0 or N == 0:
        return dg_f, dg_b
    w_f, w_b = w_f.to(T), w_b.to(T)
    _bwd_launch(bilstm_bwd_cuda, "bilstm_bwd",
                [w_f, w_b, *streams, dg_f, dg_b], B, N, H, dev, T, 2, plan)
    return dg_f, dg_b


bilstm_bwd_cuda.launches = 0


def _lstm_fwd_launch(fn, save: bool, xg, w, reverse: bool, plan):
    _check_shapes(xg, xg, w, w)
    name = "lstm_fwd_train" if save else "lstm_fwd"
    B, N, G = xg.shape
    H = G // 4
    dev, T = _check_cuda(name, (xg,), (w,), _smem("bilstm_fwd", H, plan))
    outs = [torch.empty(B, N, d, dtype=T, device=dev)
            for d in ((H, H, G) if save else (H,))]
    if B == 0 or N == 0:
        return tuple(outs)
    lib, kernel, ints = _plan(fn, "bilstm_fwd", name, B, H, dev, T, save, 1,
                              plan)
    entry, ints = _fwd_plan_args(name, kernel, ints)
    (w,) = fwd_weights(kernel, (w.to(T),), ints[0])
    launch(lib, f"{entry}_{_SUFFIX[T]}", dev,
           xg.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in outs),
           B, N, H, *ints, int(reverse))
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


def lstm_bwd_cuda(w, gs, cs, dy, reverse: bool = False,
                  plan: Optional[Tuple[str, int]] = None) -> torch.Tensor:
    """Launch ``csrc/bilstm_bwd.cu`` with a grid of one direction: ``dg``;
    ``plan`` as ``bilstm_bwd_cuda``. Records the plan in
    ``lstm_bwd_cuda.last_launch`` and counts each launch in
    ``lstm_bwd_cuda.launches``."""
    _check_shapes(gs, gs, w, w)
    B, N, G = gs.shape
    H = G // 4
    if cs.shape != (B, N, H) or dy.shape != (B, N, H):
        raise ValueError(
            "lstm_bwd: cs and dy must be [B, N, H] with gs [B, N, 4H] = "
            f"{tuple(gs.shape)}; got {tuple(cs.shape)}, {tuple(dy.shape)}")
    dev, T = _check_cuda("lstm_bwd", (gs, cs, dy), (w,),
                         _smem("bilstm_bwd", H, plan))
    dg = torch.empty(B, N, G, dtype=T, device=dev)
    if B == 0 or N == 0:
        return dg
    w = w.to(T)
    _bwd_launch(lstm_bwd_cuda, "lstm_bwd", [w, gs, cs, dy, dg], B, N, H,
                dev, T, 1, plan, int(reverse))
    return dg


lstm_bwd_cuda.launches = 0
