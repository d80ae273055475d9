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

Each source holds five kernels. At H <= ``UNIT_MAX_H`` (64, the
flagship's and the legacy LSTM's width) the unit kernel runs: four lanes of
a warp own one hidden unit of a tile of 1, 2 or 4 batch rows, W_hh (the
forward's columns, the BPTT's row) in their registers, one block barrier a
step; ``unit_plan`` sizes the tile to the batch and the card. Above it the
wide kernel (the first design, W_hh in shared memory, one block of 4H
threads per 4-row tile) runs, up to H=118 in the forward and H=116 in the
BPTT. Above that, up to ``CLUSTER_MAX_H`` (256), the register cluster
kernel ("reg") splits W_hh by hidden units across a thread-block cluster
of up to 16 blocks, each block's slice held in registers, h (the BPTT:
partial sums of dh) exchanged by ``st.async`` on mbarriers;
``lstm_reg_plan`` picks the cluster and the batch tile from the card's own
counts. The first cluster kernel ("cluster": the slice in shared memory, a
cluster barrier a step) stays for the A/B, reached by a forced plan. Above
``CLUSTER_MAX_H``, where no block holds its share of W_hh, the stream
kernel ("stream": the first cluster kernel reading its slice of W_hh from
global memory every step, clusters of up to 16 blocks) takes every width
whose exchange tile fits a block; ``lstm_stream_plan`` picks its plan.
``lstm_fwd_kernel_route`` and ``lstm_bwd_kernel_route`` choose, and each
launch records its kernel and plan in the wrapper's ``last_launch``.

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

# The register cluster kernels (bilstm_*_reg_kernel): clusters of 1 to
# REG_MAX_CLUSTER blocks (above 8 a non-portable size), batch tiles of
# REG_ROWS[kind] rows, the k values a forward lane holds (kRegKPerLane) and the
# gate columns a BPTT lane holds (kRegJPerLane), the inputs the BPTT stages
# a cell (kRegIn) and the outputs the forward stages (kRegStreams)
REG_MAX_CLUSTER = 16
REG_ROWS = {"fwd": (1, 2, 4), "bwd": (1, 2, 4, 8)}
REG_MAX_THREADS = 256   # the launch bound: 255 registers a thread
REG_K_PER_LANE = 16
REG_J_PER_LANE = 32
REG_IN = 7
REG_LOADS = 4     # input values a BPTT thread loads a step (kRegLoads)
REG_STREAMS = 6
REG_STAGES = 3    # output staging slots (kRegStages)
# A step's fixed part (the exchange, the lane reduction, the gate math) in
# thread-rows of a block's FMA issue, for rank_reg_plans' cost model
REG_STEP_FIXED = 2400

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
    """Lanes of a hidden unit in the forward register cluster kernel: 8 up
    to H=128 (16 k values a lane), 16 above."""
    return 8 if hidden <= 8 * REG_K_PER_LANE else 16


def reg_units(kind: str, hidden: int, cluster: int) -> int:
    """Hidden units one block of the register cluster kernel ``kind``
    owns: ceil(H / C) up to a power of two, at least a warp's worth of
    units in the forward (32 / lanes) and 8 in the BPTT (a lane's 32 gate
    columns); the last block's slice is masked past H."""
    u = _pow2_at_least(-(-hidden // cluster))
    return max(u, 32 // reg_lanes(hidden) if kind == "fwd" else 8)


def reg_threads(kind: str, hidden: int, cluster: int) -> int:
    """Threads of a block: the forward's lanes for each unit; the BPTT's
    U / 8 lanes for each pair of k, whole warps."""
    U = reg_units(kind, hidden, cluster)
    if kind == "fwd":
        return U * reg_lanes(hidden)
    return -(-(-(-hidden // 2) * (U // 8)) // 32) * 32


def reg_smem_bytes(kind: str, hidden: int, cluster: int, rows: int) -> int:
    """Dynamic shared memory of a block of the register cluster kernel
    ``kind`` (``reg_smem_floats`` of the sources): the forward's h tile
    [2][rows][TK] (TK covers the cluster's units and every k a lane reads),
    xg ring [2][rows][4][U + 1] and output staging [3][6][rows][U + 1]; the
    BPTT's dg tile (32-column groups padded by 4 floats), partials
    [2][C][U][rows], input ring [2][rows][7][U + 1] and output staging
    [3][4][rows][U + 1]."""
    U = reg_units(kind, hidden, cluster)
    if kind == "fwd":
        tk = _pad4(max(cluster * U, REG_K_PER_LANE * reg_lanes(hidden)))
        floats = (2 * rows * tk
                  + (2 * 4 + REG_STAGES * REG_STREAMS) * rows * (U + 1))
    else:
        rq = min(rows, 4)
        floats = ((rows // rq) * (U // 8) * (REG_J_PER_LANE * rq + 4)
                  + 2 * cluster * U * rows + (2 * REG_IN + REG_STAGES * 4)
                  * rows * (U + 1))
    return floats * 4


def _reg_rule(kind: str, hidden: int, cluster: int, rows: int) -> bool:
    """The register cluster kernels' plan rule (``valid_reg_plan``): H up
    to ``CLUSTER_MAX_H``, 1 to ``REG_MAX_CLUSTER`` blocks each owning a
    unit at least, a tile of ``REG_ROWS[kind]``, at most ``REG_MAX_THREADS``
    threads and ``MAX_SMEM_BYTES`` bytes a block; the BPTT also at most
    ``REG_LOADS`` of its ``REG_IN`` input values a cell a thread a step."""
    if not (0 < hidden <= CLUSTER_MAX_H and 1 <= cluster <= REG_MAX_CLUSTER
            and rows in REG_ROWS[kind]):
        return False
    U = reg_units(kind, hidden, cluster)
    threads = reg_threads(kind, hidden, cluster)
    return ((cluster - 1) * U < hidden and threads <= REG_MAX_THREADS
            and (kind == "fwd" or REG_IN * U * rows <= REG_LOADS * threads)
            and reg_smem_bytes(kind, hidden, cluster, rows)
            <= MAX_SMEM_BYTES)


def check_reg_mirror(layout, kind: str) -> None:
    """Hold ``_reg_rule``, ``reg_smem_bytes``, ``reg_threads`` and
    ``reg_units`` to a built source's ``bilstm_<kind>_reg_layout(what, H,
    C, R)`` (bytes, threads, units, or -1 for a plan it does not take) over
    H, every cluster size and tile; raises naming the first plan where
    they differ."""
    for hidden in (1, 7, 64, 96, 117, 118, 119, 128, 130, 201, 255, 256,
                   257):
        for c in range(1, REG_MAX_CLUSTER + 2):
            for rows in (1, 2, 3, 4, 8, 16):
                want = ((reg_smem_bytes(kind, hidden, c, rows),
                         reg_threads(kind, hidden, c),
                         reg_units(kind, hidden, c))
                        if _reg_rule(kind, hidden, c, rows) else (-1,) * 3)
                got = tuple(layout(what, hidden, c, rows)
                            for what in range(3))
                if got != want:
                    raise RuntimeError(
                        f"bilstm_{kind}_reg: the wrapper's plan mirror gives "
                        f"{want} (shared bytes, threads, units) at H={hidden}"
                        f", plan {c}x{rows}, the built source {got}: update "
                        "REG_* or reg_* to match the source")


def rank_reg_plans(kind: str, plans, batch: int, hidden: int,
                   resident: Callable[[int, int], int],
                   dirs: int) -> List[Tuple[int, int]]:
    """The ``(cluster, rows)`` plans of the register cluster kernel
    ``kind``, fastest first.

    A lane runs 64 FMAs a row a step whatever the plan, so a block's step
    costs its threads (at least 128: four warps, one per scheduler) times
    its rows, plus ``REG_STEP_FIXED`` for the exchange, the lane reduction
    and the gate math; the grid of ``dirs`` directions takes ``waves`` such
    steps, with ``resident(cluster, rows)`` clusters at once (the card's
    own count, ``cudaOccupancyMaxActiveClusters``); a plan the card runs
    none of is dropped. Ties go to the smaller cluster, then the smaller
    tile."""
    keys = []
    for c, rows in plans:
        at_once = resident(c, rows)
        if at_once <= 0:
            continue
        waves = -(-dirs * -(-batch // rows) // at_once)
        step = max(reg_threads(kind, hidden, c), 128) * rows + REG_STEP_FIXED
        keys.append((waves * step, c, rows))
    return [(c, rows) for _, c, rows in sorted(keys)]


def lstm_reg_plans(kind: str, batch: int, hidden: int,
                   resident: Callable[[int, int], int],
                   dirs: int = 2) -> List[Tuple[int, int]]:
    """Every ``(cluster, rows)`` the register cluster kernel ``kind``
    takes at this batch and H over ``dirs`` directions, fastest first
    (``rank_reg_plans``)."""
    return rank_reg_plans(
        kind, [(c, rows) for c in range(1, REG_MAX_CLUSTER + 1)
               for rows in REG_ROWS[kind]
               if _reg_rule(kind, hidden, c, rows)],
        batch, hidden, resident, dirs)


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


def _lstm_route(kind: str, hidden: int, wide: bool, wide_smem: int) -> str:
    name = f"bilstm_{kind}"
    if hidden <= 0:
        raise ValueError(f"{name}: H must be positive, got {hidden}")
    if hidden <= UNIT_MAX_H:
        return "unit"
    if wide:
        return "wide"
    if any(_reg_rule(kind, hidden, c, rows)
           for c in range(1, REG_MAX_CLUSTER + 1) for rows in REG_ROWS[kind]):
        return "reg"
    if stream_takes(name, hidden):
        return "stream"
    raise ValueError(
        f"{name}: no kernel takes H={hidden} on this card: the unit kernel "
        f"holds H <= {UNIT_MAX_H}, the wide kernel needs {wide_smem} bytes "
        f"of shared memory per block, the register cluster kernel takes "
        f"H <= {CLUSTER_MAX_H}, and {stream_refusal(name, hidden)}")


def lstm_fwd_kernel_route(hidden: int) -> str:
    """The forward kernel of ``csrc/bilstm_fwd.cu`` that takes hidden size
    ``hidden`` (whatever the batch, stream dtype or direction count):
    "unit" up to ``UNIT_MAX_H``, else "wide" where its W_hh fits one
    block's shared memory (H <= 118), else "reg" (the register cluster
    kernel) up to ``CLUSTER_MAX_H``, else "stream" (the stream kernel)
    where its h tile fits a block. The first cluster kernel ("cluster") is
    reached only by a forced plan. Raises, naming the width and the card's
    limit, for an H none takes."""
    return _lstm_route("fwd", hidden,
                       4 * hidden <= 512
                       and bilstm_smem_bytes(hidden) <= MAX_SMEM_BYTES,
                       bilstm_smem_bytes(hidden))


def bilstm_bwd_smem_bytes(hidden: int) -> int:
    """Shared memory one block of the backward kernel needs (mirrors
    ``smem_bytes`` in ``csrc/bilstm_bwd.cu``): W_hh^T and a double-buffered
    dg tile."""
    G = 4 * hidden
    return (G * hidden + 2 * _ROWS_PER_BLOCK * G) * 4


def lstm_bwd_kernel_route(hidden: int) -> str:
    """The BPTT kernel of ``csrc/bilstm_bwd.cu`` that takes hidden size
    ``hidden`` (whatever the batch, stream dtype or direction count):
    "unit" (``bilstm_bwd_unit_kernel``) up to ``UNIT_MAX_H``, else "wide"
    where its W_hh^T and dg tile fit one block's shared memory (H <= 116),
    else "reg" (the register cluster kernel) up to ``CLUSTER_MAX_H``, else
    "stream" where its dg tile fits a block (H <= 1816); the first cluster
    kernel is reached only by a forced plan. Raises, naming the width and
    the card's limit, for an H none takes."""
    return _lstm_route("bwd", hidden,
                       bilstm_bwd_smem_bytes(hidden) <= MAX_SMEM_BYTES,
                       bilstm_bwd_smem_bytes(hidden))


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
    for query, n_int in (("cluster_max_active_clusters", 5),
                         ("cluster_smem_bytes", 3),
                         ("reg_max_active_clusters", 5), ("reg_layout", 4),
                         ("stream_max_active_clusters", 5),
                         ("stream_smem_bytes", 3)):
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
    LSTM cluster kernel ``kernel`` ("cluster", "reg" or "stream") of
    ``source``
    ("bilstm_fwd" or "bilstm_bwd") the card ``dev`` runs at once."""
    query = getattr(_library(source),
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


def card_name(dev: torch.device) -> str:
    """The card's name, for an error that names where a plan failed."""
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def _plan_rules(kind: str, H: int, T: torch.dtype):
    """The register (``"reg"``), first (``"cluster"``) and stream
    (``"stream"``) cluster kernels' plan test, planners (every plan,
    fastest first) and plan rule as text, for ``cluster_launch_plan``."""
    source = f"bilstm_{kind}"
    return {
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
    design, "stream": the stream kernel) of ``source``: its planner's pick
    with the card's own counts, or the caller's ``plan``, refused unless it
    fits and the card runs such a cluster. Recorded with the grid's cluster
    count in ``fn.last_launch``."""
    kind = source[len("bilstm_"):]
    key = (source, kernel, B, H, str(dev), T, save, dirs, plan)
    if key not in _CLUSTER_PLANS:
        fits, planner, rule = _plan_rules(kind, H, T)[kernel]
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
    if kernel in ("cluster", "reg", "stream"):
        return 0
    return (bilstm_smem_bytes if source == "bilstm_fwd"
            else bilstm_bwd_smem_bytes)(H)


def _plan(fn, source: str, name: str, B: int, H: int, dev, T, save: bool,
          dirs: int, plan):
    """The kernel library, the kernel ("unit", "wide", "reg", "stream" or
    "cluster") and the plan's integers of a launch of ``source``
    ("bilstm_fwd" or "bilstm_bwd"): the route's kernel with ``unit_plan``'s
    tile ``(rows,)``, the wide kernel's ``(4,)``, ``lstm_reg_plan``'s or
    ``stream_plans``' ``(cluster, rows)``; or the caller's ``plan``
    ("unit", rows), ("wide", 4), ("reg", cluster, rows), ("stream",
    cluster, rows) or ("cluster", cluster, rows), the first cluster
    kernel's. Recorded in ``fn.last_launch``."""
    kernel = _kernel(source, H, plan)
    lib = _library(source)
    forced = None if plan is None else tuple(plan[1:])
    if kernel == "unit":
        if H > UNIT_MAX_H:
            raise ValueError(f"{name}: the unit kernel takes H <= "
                             f"{UNIT_MAX_H}, not {H}")
        return lib, kernel, (unit_launch_rows(
            fn, lib, source, B, H, dev, T, save, dirs,
            None if forced is None else forced[0]),)
    if kernel in ("cluster", "reg", "stream"):
        return lib, kernel, cluster_launch_plan(fn, source, B, H, dev, T,
                                                save, dirs, forced, kernel)
    if kernel != "wide" or forced not in (None, (_ROWS_PER_BLOCK,)):
        raise ValueError(f"{name}: plan must be ('unit', rows), ('wide', "
                         f"{_ROWS_PER_BLOCK}), ('reg', cluster, rows), "
                         "('stream', cluster, rows) or ('cluster', cluster, "
                         f"rows), got {plan}")
    fn.last_launch = {"kernel": "wide", "cluster": 1,
                      "rows": _ROWS_PER_BLOCK,
                      "clusters": dirs * -(-B // _ROWS_PER_BLOCK),
                      "resident": None}
    return lib, kernel, (_ROWS_PER_BLOCK,)


def _fwd_plan_args(lib_name: str, kernel: str, ints) -> Tuple[str, tuple]:
    """The entry point of ``csrc/bilstm_fwd.cu`` and the plan's integers
    it takes: the cluster entries (``<name>_reg_*``, ``<name>_stream_*``,
    ``<name>_cluster_*``) take (C, R), the others the unit tile or 4 and
    the wide flag."""
    if kernel in ("cluster", "reg", "stream"):
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
    w_f, w_b = w_f.to(T), w_b.to(T)
    launch(lib, f"{entry}_{_SUFFIX[T]}", dev,
           *(t.data_ptr() for t in (xg_f, xg_b, w_f, w_b, *outs)), B, N, H,
           *ints)
    fn.launches += 1
    return tuple(outs)


def bilstm_fwd_cuda(xg_f: torch.Tensor, xg_b: torch.Tensor,
                    w_f: torch.Tensor, w_b: torch.Tensor,
                    plan: Optional[Tuple[str, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the light kernel of ``csrc/bilstm_fwd.cu`` on the current
    stream. ``plan=("unit", rows)``, ``("wide", 4)``, ``("reg", cluster,
    rows)`` or ``("cluster", cluster, rows)`` overrides the route and the
    planner (raises if it does not fit). Records the plan in
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


def bwd_weights(kernel: str, weights) -> list:
    """The BPTT's W_hh as a launch of ``kernel`` reads it: the stream
    kernels read W_hh^T (a contiguous transposed copy, so that consecutive
    threads read consecutive units), every other kernel W_hh itself."""
    if kernel == "stream":
        return [w.t().contiguous() for w in weights]
    return list(weights)


def _bwd_launch(fn, name: str, ptrs, B: int, N: int, H: int, dev, T,
                dirs: int, plan, *tail) -> None:
    """Launch ``name`` ("bilstm_bwd" or "lstm_bwd", ``csrc/bilstm_bwd.cu``)
    on the tensors ``ptrs``, then B, N, H, the plan's integers and
    ``tail`` (the reverse flag of one direction), as ``_plan`` picks: the
    wide kernel's entries take no tile, the unit kernel's
    (``<name>_unit_*``) its tile, the cluster kernels'
    (``<name>_reg_*``, ``<name>_stream_*``, ``<name>_cluster_*``) C and R.
    The stream kernel reads W_hh^T: ``ptrs`` start with the weights, which
    are passed transposed there. Counted on ``fn``."""
    lib, kernel, ints = _plan(fn, "bilstm_bwd", name, B, H, dev, T, False,
                              dirs, plan)
    tensors = [*bwd_weights(kernel, ptrs[:dirs]), *ptrs[dirs:]]
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
    """Launch ``csrc/bilstm_bwd.cu``: returns ``(dg_f, dg_b)``.
    ``lstm_bwd_kernel_route`` picks the unit, wide or register cluster
    kernel; ``plan=("unit", rows)``, ``("wide", 4)``, ``("reg", cluster,
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
    w = w.to(T)
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
