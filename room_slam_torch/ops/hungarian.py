"""Hungarian matching of predictions to ground truth (counterpart of the
JAX package's ``ops/hungarian.py::hungarian_match_fast``).

The JAX package solves the assignment on the device with ``lax`` control
flow. This port's first step solves it on the host with scipy's
``linear_sum_assignment``: the batch's ``[B, Q, M]`` cost goes to the host
in one copy per step and the assignment comes back in one copy. An on-GPU
matcher is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def hungarian_match_fast(cost: np.ndarray, valid_cols: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Match predictions (rows of ``cost [Q, M]``) to the valid ground-truth
    columns (``valid_cols [M]`` bool), as the JAX package's
    ``hungarian_match_fast`` does:

    - the valid columns are compacted to the front (stable) and the first
      ``K = min(M, Q)`` kept, so with more than Q valid columns the first Q
      by position are matched;
    - the transposed ``[K, Q]`` problem of the kept valid columns is solved
      exactly (each GT row gets a distinct prediction);
    - ``matched = valid & kept``; ``row_for_col`` is clipped to
      ``[0, Q)`` and is 0 for every column that is not matched.

    Returns ``(row_for_col [M] int32, matched [M] bool)``.
    """
    Q, M = cost.shape
    K = min(M, Q)
    order = np.argsort(~valid_cols, kind="stable")
    sel = order[:K]
    sub_valid = valid_cols[sel]
    n_valid = int(sub_valid.sum())
    row_for_col = np.zeros(M, np.int32)
    if n_valid:
        # the valid rows are the first n_valid of the compacted order
        gt_rows, preds = linear_sum_assignment(cost[:, sel[:n_valid]].T)
        row_for_col[sel[gt_rows]] = preds
    kept = np.zeros(M, bool)
    kept[sel] = sub_valid
    return np.clip(row_for_col, 0, Q - 1), valid_cols & kept


def hungarian_match_batch(cost: torch.Tensor, valid_cols: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hungarian_match_fast`` over a batch: ``cost [B, Q, M]``,
    ``valid_cols [B, M]`` on any device. One copy to the host, one back;
    returns ``(row_for_col [B, M] int64, matched [B, M] bool)`` on the
    cost's device."""
    c = cost.detach().float().cpu().numpy()
    v = valid_cols.cpu().numpy().astype(bool)
    rows = np.zeros(v.shape, np.int64)
    matched = np.zeros(v.shape, bool)
    for b in range(c.shape[0]):
        rows[b], matched[b] = hungarian_match_fast(c[b], v[b])
    out = torch.from_numpy(np.stack([rows, matched.astype(np.int64)]))
    out = out.to(cost.device)
    return out[0], out[1].bool()
