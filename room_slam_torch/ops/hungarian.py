"""Exact linear-sum assignment (Hungarian) matching on the device
(counterpart of the JAX package's ``ops/hungarian.py``).

The JAX package solves the assignment with ``lax`` loops vmapped over the
batch, so matching stays on the device and fuses into the train step. Here
the same algorithm runs as one CUDA kernel (``csrc/hungarian.cu``) a batch:
one block a problem, one thread a column. The set criterion, the validation
metrics and the legacy loss call it on every step and batch; nothing of the
cost returns to the host.

The algorithm is the textbook shortest augmenting path with row and column
potentials (u, v), 1-indexed with a virtual column 0. Counterparts:

- ``solve_square(cost)``: the exact ``n x n`` assignment, ``row_for_col``;
- ``solve_rect(cost, n_rows)``: ``n <= m`` rows against ``m`` columns,
  inserting only the first ``n_rows`` rows; ``col_for_row``;
- ``hungarian_match(cost, valid)``: the ``[Q, M]`` match of the legacy loss
  (invalid columns cost 0; dummy rows at ``_BIG`` when ``M > Q``);
- ``hungarian_match_batch``: the same over a batch, one launch;
- ``hungarian_match_fast(cost, valid)``: the training loss's matcher (the
  valid columns compacted stably, ``K = min(M, Q)`` kept, the transposed
  ``K x Q`` problem solved for the valid rows only).

Each takes one problem (``cost [n, m]``) or a batch (``[B, n, m]``). The
tensor's device picks the implementation: a CUDA tensor launches the kernel
(or raises); a CPU tensor takes the plain version (``assign_plain``), which
repeats the kernel's arithmetic in torch for all items of the batch in
lockstep, as ``vmap`` runs the JAX loops, masking the items that have
finished. Its float32 expressions keep the JAX order, so assignments, ties
included, equal the JAX module's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_INF = 1e30
# Cost placed on (dummy row, valid column) entries when the problem is
# padded to square: a power of two well above any real cost, so that it
# never wins against a real row (hungarian_match).
_BIG = 32768.0
MAX_COLUMNS = 1023   # one thread a column, the virtual one too: 1024


def assign_plain(cost: torch.Tensor, n_rows: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: ``cost [B, n, m]`` float32 (n <= m),
    ``n_rows [B]`` (None: every row) -> ``(row_for_col [B, m],
    col_for_row [B, n])`` int32, -1 where a column got no row or a row was
    not inserted. It reads each loop's end condition on the host."""
    B, n, m = cost.shape
    dev = cost.device
    cost = cost.float()
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    k = (torch.full((B,), n, dtype=torch.long, device=dev) if n_rows is None
         else n_rows.to(dev).long().clamp(0, n))
    cols = torch.arange(m + 1, device=dev)
    bidx = torch.arange(B, device=dev)
    # a_full[b, i - 1] = concat([INF], cost[b, i - 1]): the relaxation row
    a_full = torch.cat([inf.expand(B, n, 1), cost], dim=2)
    u = torch.zeros(B, n + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(B, m + 1, dtype=torch.float32, device=dev)
    p = torch.zeros(B, m + 1, dtype=torch.long, device=dev)
    way = torch.zeros(B, m + 1, dtype=torch.long, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(1, int(k.max()) + 1 if B else 1):
        act = i <= k
        minv = inf.expand(B, m + 1).clone()
        used = torch.zeros(B, m + 1, dtype=torch.bool, device=dev)
        p[:, 0] = torch.where(act, i, p[:, 0])
        j0 = torch.zeros(B, dtype=torch.long, device=dev)
        run = act.clone()
        while bool(run.any()):
            r = run[:, None]
            used_n = used | ((cols[None] == j0[:, None]) & r)
            i0 = p[bidx, j0]
            a_row = a_full[bidx, (i0 - 1).clamp(min=0)]
            cur = a_row - u[bidx, i0][:, None] - v
            scan = ~used_n & (cols >= 1)[None]
            better = scan & (cur < minv)
            minv_n = torch.where(better, cur, minv)
            way_n = torch.where(better, j0[:, None], way)
            masked = torch.where(scan, minv_n, inf)
            j1 = masked.argmin(dim=1)
            delta = masked[bidx, j1][:, None]
            u_n = u.scatter_add(1, p, torch.where(used_n, delta, zero))
            v_n = v - torch.where(used_n, delta, zero)
            minv_n = minv_n - torch.where(used_n, zero, delta)
            u = torch.where(r, u_n, u)
            v = torch.where(r, v_n, v)
            minv = torch.where(r, minv_n, minv)
            way = torch.where(r, way_n, way)
            used = used_n
            j0 = torch.where(run, j1, j0)
            run = run & (p[bidx, j0] != 0)
        walk = act & (j0 != 0)
        while bool(walk.any()):
            j1 = way[bidx, j0]
            p[bidx, j0] = torch.where(walk, p[bidx, j1], p[bidx, j0])
            j0 = torch.where(walk, j1, j0)
            walk = walk & (j0 != 0)
    row_for_col = (p[:, 1:] - 1).int()
    col_for_row = torch.full((B, n + 1), -1, dtype=torch.int32, device=dev)
    assigned = p[:, 1:] >= 1
    col_for_row[bidx[:, None].expand(-1, m)[assigned], p[:, 1:][assigned]] = \
        (cols[1:] - 1).int().expand(B, -1)[assigned]
    return row_for_col, col_for_row[:, 1:]


def _library():
    from room_slam_torch.ops.build import load_library

    lib = load_library("hungarian")
    if getattr(lib, "_argtypes_set", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hungarian_solve.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.hungarian_solve.restype = i
    lib.hungarian_smem_bytes.argtypes = [i, i]
    lib.hungarian_smem_bytes.restype = i
    lib.hungarian_threads.argtypes = [i]
    lib.hungarian_threads.restype = i
    lib.hungarian_error_string.argtypes = [i]
    lib.hungarian_error_string.restype = ctypes.c_char_p
    lib._argtypes_set = True
    return lib


def hungarian_cuda(cost: torch.Tensor, n_rows: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/hungarian.cu`` on the current stream: ``cost [B, n,
    m]`` float32 on a CUDA device (n <= m <= 1023), ``n_rows [B]`` on the
    same device or None -> ``(row_for_col [B, m], col_for_row [B, n])``
    int32, as ``assign_plain``. Counts each launch in
    ``hungarian_cuda.launches``."""
    B, n, m = cost.shape
    if n > m or m > MAX_COLUMNS:
        raise ValueError(f"hungarian_cuda: needs rows <= columns <= "
                         f"{MAX_COLUMNS} (one thread a column and the "
                         f"virtual one, 1024 a block), got {n} x {m}")
    if cost.dtype != torch.float32:
        raise TypeError(f"hungarian_cuda takes a float32 cost, got "
                        f"{cost.dtype}")
    dev = cost.device
    if dev.type != "cuda" or (n_rows is not None and n_rows.device != dev):
        raise ValueError("hungarian_cuda: inputs must be on one CUDA "
                         f"device, got {cost.device} and "
                         f"{None if n_rows is None else n_rows.device}")
    cost = cost.contiguous()
    rows = None if n_rows is None else n_rows.to(torch.int32).contiguous()
    row_for_col = torch.empty(B, m, dtype=torch.int32, device=dev)
    col_for_row = torch.empty(B, n, dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.hungarian_solve(
            cost.data_ptr(), None if rows is None else rows.data_ptr(),
            row_for_col.data_ptr(), col_for_row.data_ptr(), B, n, m,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("hungarian_solve launch failed: "
                           f"{lib.hungarian_error_string(rc).decode()}")
    hungarian_cuda.launches += 1
    return row_for_col, col_for_row


hungarian_cuda.launches = 0


def assign(cost: torch.Tensor, n_rows: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cost [B, n, m]`` -> ``(row_for_col [B, m], col_for_row [B, n])``:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    if cost.device.type == "cuda":
        return hungarian_cuda(cost.float(), n_rows)
    if cost.device.type != "cpu":
        raise ValueError(f"hungarian: a CPU or CUDA tensor, got "
                         f"{cost.device}")
    if cost.shape[1] > cost.shape[2]:
        raise ValueError(f"hungarian: needs rows <= columns, got "
                         f"{tuple(cost.shape[1:])}")
    return assign_plain(cost, n_rows)


def _batched(cost, *rest):
    """``(cost [B, ...], rest..., single)`` as tensors (numpy arrays taken
    too), the cost detached, a leading batch axis added to a single
    problem."""
    cost = torch.as_tensor(cost).detach()
    rest = [None if r is None else torch.as_tensor(r) for r in rest]
    single = cost.dim() == 2
    if single:
        cost = cost[None]
        rest = [None if r is None else r[None] for r in rest]
    return (cost, *rest, single)


def solve_square(cost) -> torch.Tensor:
    """``row_for_col [n]`` (or ``[B, n]``), int64: the row assigned to each
    column of the exact assignment of ``cost [n, n]`` (``[B, n, n]``)."""
    c, single = _batched(cost)
    row_for_col, _ = assign(c)
    out = row_for_col.long()
    return out[0] if single else out


def solve_rect(cost, n_rows=None) -> torch.Tensor:
    """Rectangular assignment of ``cost [n, m]`` (``[B, n, m]``), n <= m:
    every inserted row gets a distinct column; ``col_for_row [n]`` (``[B,
    n]``) int64. ``n_rows`` (a 0-d / ``[B]`` tensor or an int) limits the
    insertion to the first ``n_rows`` rows; ``col_for_row`` beyond them is
    -1, which the caller masks."""
    c, k, single = _batched(cost, n_rows)
    if k is not None:
        k = k.reshape(-1).expand(c.shape[0]).to(c.device)
    _, col_for_row = assign(c, k)
    out = col_for_row.long()
    return out[0] if single else out


def square_problem(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``hungarian_match``'s square problem ``[B, n, n]``, ``n = max(Q,
    M)``, of ``cost [B, Q, M]`` and ``valid [B, M]`` (bool)."""
    B, Q, M = cost.shape
    n = max(Q, M)
    vb = valid[:, None, :]
    sq = torch.zeros(B, n, n, dtype=torch.float32, device=cost.device)
    sq[:, :Q, :M] = torch.where(vb, cost.float(), 0.0)
    if n > Q:
        sq[:, Q:, :M] = torch.where(vb, _BIG, 0.0).expand(-1, n - Q, -1)
    return sq


def fast_problem(cost: torch.Tensor, valid: torch.Tensor):
    """``hungarian_match_fast``'s problem of ``cost [B, Q, M]`` and ``valid
    [B, M]`` (bool): ``(sel [B, K], sub_valid [B, K], sub [B, K, Q],
    n_valid [B] int32)``, the kept columns, their validity, the transposed
    costs (0 on invalid rows) and the rows to insert."""
    B, Q, M = cost.shape
    K = min(M, Q)
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    sel = order[:, :K]
    sub_valid = torch.gather(valid, 1, sel)
    sub = torch.gather(cost.float(), 2, sel[:, None, :].expand(-1, Q, -1))
    sub = torch.where(sub_valid[:, :, None], sub.transpose(1, 2), 0.0)
    return sel, sub_valid, sub.contiguous(), sub_valid.sum(
        1, dtype=torch.int32)


def hungarian_match(cost, valid_cols) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match predictions (rows of ``cost [Q, M]`` or ``[B, Q, M]``) to the
    valid ground-truth columns, as scipy's ``linear_sum_assignment`` on the
    ``[Q, num_valid]`` submatrix: invalid columns cost 0, and with ``M >
    Q`` dummy rows cost ``_BIG`` on the valid columns, so that a valid
    column given a dummy row is unmatched. Returns ``(row_for_col [M]
    int64, clipped to [0, Q), matched [M] bool)``."""
    c, valid, single = _batched(cost, valid_cols)
    valid = valid.bool()
    Q, M = c.shape[1:]
    row_for_col, _ = assign(square_problem(c, valid))
    rows = row_for_col[:, :M].long()
    matched = valid & (rows < Q)
    rows = rows.clamp(max=Q - 1)
    return (rows[0], matched[0]) if single else (rows, matched)


def hungarian_match_batch(cost, valid_cols
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hungarian_match`` over a batch: ``cost [B, Q, M]``, ``valid [B,
    M]``; one kernel launch on the card."""
    return hungarian_match(cost, valid_cols)


def hungarian_match_fast(cost, valid_cols
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training loss's matcher: ``hungarian_match``'s contract with a
    shorter chain. The valid columns are compacted to the front (stable),
    ``K = min(M, Q)`` of them kept, and the transposed problem (K GT rows
    against Q prediction columns) solved for the valid rows only; an
    invalid kept row costs 0. With more than Q valid columns the first Q
    by position are kept (``hungarian_match`` keeps the exact semantics).
    Returns ``(row_for_col [M] int64, clipped to [0, Q) and 0 where no row
    was assigned, matched [M] bool)``; ``[B, M]`` each for a batch."""
    c, valid, single = _batched(cost, valid_cols)
    valid = valid.bool()
    B, Q, M = c.shape
    sel, sub_valid, sub, n_valid = fast_problem(c, valid)
    _, col_for_row = assign(sub, n_valid)                    # [B, K]
    row_for_col = torch.zeros(B, M, dtype=torch.long, device=c.device)
    row_for_col.scatter_(1, sel, col_for_row.long())
    kept = torch.zeros(B, M, dtype=torch.bool, device=c.device)
    kept.scatter_(1, sel, sub_valid)
    matched = valid & kept
    rows = row_for_col.clamp(0, Q - 1)
    return (rows[0], matched[0]) if single else (rows, matched)
