"""The port's exact matcher (``ops/hungarian.py``, the plain versions that a
CPU tensor takes) against the JAX package's ``solve_square``,
``hungarian_match``, ``solve_rect`` and ``hungarian_match_fast`` on seeded
float costs and integer costs full of ties: assignments equal to the bit.
The optimal totals equal scipy's ``linear_sum_assignment`` (float64 sums,
rtol 1e-6); the batched calls equal a loop of single calls. Cases: an item
with no valid column, ``M > Q`` (dummy rows at ``_BIG`` on the square form,
the first Q valid kept by the fast one) and ``n_rows < K``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from room_slam_torch.ops import hungarian as th
from room_slam_tpu.ops import hungarian as jh

# one compile a shape (the eager lax loops would trace every call)
J_SQUARE = jax.jit(jh.solve_square)
J_RECT = jax.jit(jh.solve_rect)
J_FAST = jax.jit(jh.hungarian_match_fast)


def _cost(rng, shape, ints):
    if ints:
        return rng.integers(0, 3, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _total(cost, rows, cols):
    return float(np.asarray(cost, np.float64)[rows, cols].sum())


@pytest.mark.parametrize("ints", [False, True], ids=["float", "ties"])
@pytest.mark.parametrize("n", [1, 5, 9])
def test_solve_square_matches_jax(n, ints):
    rng = np.random.default_rng(n + 10 * ints)
    for _ in range(3):
        c = _cost(rng, (n, n), ints)
        got = th.solve_square(torch.from_numpy(c))
        ref = np.asarray(J_SQUARE(jnp.asarray(c)))
        np.testing.assert_array_equal(got.numpy(), ref)
        r, col = linear_sum_assignment(c)
        assert _total(c, got.numpy(), np.arange(n)) == pytest.approx(
            _total(c, r, col), rel=1e-6)


@pytest.mark.parametrize("ints", [False, True], ids=["float", "ties"])
@pytest.mark.parametrize("n, m", [(3, 8), (6, 6), (4, 30)])
def test_solve_rect_matches_jax(n, m, ints):
    """Every row, and the first ``n_rows`` rows (0 included): the inserted
    rows' columns equal JAX's; the rest are -1, which JAX leaves as the
    caller's garbage."""
    rng = np.random.default_rng(n * m + ints)
    c = _cost(rng, (n, m), ints)
    full = th.solve_rect(torch.from_numpy(c))
    np.testing.assert_array_equal(full.numpy(),
                                  np.asarray(J_RECT(jnp.asarray(c))))
    r, col = linear_sum_assignment(c)
    assert _total(c, np.arange(n), full.numpy()) == pytest.approx(
        _total(c, r, col), rel=1e-6)
    for k in range(n + 1):
        got = th.solve_rect(torch.from_numpy(c), k).numpy()
        ref = np.asarray(J_RECT(jnp.asarray(c), jnp.int32(k)))
        np.testing.assert_array_equal(got[:k], ref[:k])
        assert (got[k:] == -1).all()


MATCH_CASES = {           # Q, M, valid
    "interleaved": (12, 9, [1, 0, 1, 1, 0, 0, 1, 0, 1]),
    "empty": (6, 5, [0] * 5),
    "m_over_q": (4, 7, [1, 1, 0, 1, 1, 1, 1]),
    "all_valid": (7, 7, [1] * 7),
    "q_over_m": (30, 12, [1] * 8 + [0] * 4),
}


@pytest.mark.parametrize("ints", [False, True], ids=["float", "ties"])
@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_match_forms_match_jax(case, ints):
    """``hungarian_match`` (square form) and ``hungarian_match_fast`` on one
    problem against JAX's; with M > Q the square form's matched columns
    are scipy's optimum over the valid ones."""
    Q, M, valid = MATCH_CASES[case]
    valid = np.asarray(valid, bool)
    rng = np.random.default_rng(len(case) + 7 * ints)
    for _ in range(3):
        c = _cost(rng, (Q, M), ints)
        for ours, theirs in ((th.hungarian_match, jh.hungarian_match),
                             (th.hungarian_match_fast, J_FAST)):
            rows, matched = ours(torch.from_numpy(c), torch.from_numpy(valid))
            jr, jm = theirs(jnp.asarray(c), jnp.asarray(valid))
            np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
            assert rows.dtype == torch.int64 and matched.dtype == torch.bool
        vc = np.flatnonzero(valid)
        if len(vc):
            rows, matched = th.hungarian_match(torch.from_numpy(c),
                                               torch.from_numpy(valid))
            r, col = linear_sum_assignment(c[:, vc])
            mc = np.flatnonzero(matched.numpy())
            assert _total(c, rows.numpy()[mc], mc) == pytest.approx(
                _total(c[:, vc], r, col), rel=1e-6)


@pytest.mark.parametrize("ints", [False, True], ids=["float", "ties"])
def test_batched_equals_single_calls(ints):
    """A batch (one empty item, the rest random) through each batched entry
    equals the single calls item by item, and JAX's vmapped forms."""
    rng = np.random.default_rng(3 + ints)
    B, Q, M = 6, 10, 8
    c = _cost(rng, (B, Q, M), ints)
    valid = rng.uniform(size=(B, M)) < 0.6
    valid[2] = False
    ct, vt = torch.from_numpy(c), torch.from_numpy(valid)
    for batch_fn, one_fn, jax_fn in (
            (th.hungarian_match_batch, th.hungarian_match,
             jh.hungarian_match_batch),
            (th.hungarian_match_fast, th.hungarian_match_fast,
             jax.jit(jax.vmap(jh.hungarian_match_fast)))):
        rows, matched = batch_fn(ct, vt)
        jr, jm = jax_fn(jnp.asarray(c), jnp.asarray(valid))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
        for b in range(B):
            r1, m1 = one_fn(ct[b], vt[b])
            assert torch.equal(rows[b], r1) and torch.equal(matched[b], m1)
    assert not matched[2].any()
    sq = c[:, :M, :]
    got = th.solve_square(torch.from_numpy(sq))
    for b in range(B):
        assert torch.equal(got[b], th.solve_square(torch.from_numpy(sq[b])))
    k = torch.tensor([0, 3, 8, 1, 8, 5])
    got = th.solve_rect(torch.from_numpy(sq), k)
    for b in range(B):
        one = th.solve_rect(torch.from_numpy(sq[b]), int(k[b]))
        assert torch.equal(got[b], one)


def test_plain_outputs_and_refusals():
    """``assign_plain``'s two outputs agree with each other; a CUDA call
    refuses a problem of more rows than columns, more than 1023 columns or
    a non-float32 cost before anything runs."""
    rng = np.random.default_rng(0)
    c = torch.from_numpy(_cost(rng, (3, 4, 9), False))
    row_for_col, col_for_row = th.assign_plain(c, torch.tensor([4, 2, 0]))
    assert row_for_col.dtype == col_for_row.dtype == torch.int32
    for b, k in enumerate((4, 2, 0)):
        rows = col_for_row[b]
        assert (rows[k:] == -1).all()
        for i in range(k):
            assert row_for_col[b, rows[i]] == i
        assert int((row_for_col[b] >= 0).sum()) == k
    with pytest.raises(ValueError, match="rows <= columns"):
        th.solve_rect(torch.zeros(5, 3))
    with pytest.raises(ValueError, match="1023"):
        th.hungarian_cuda(torch.zeros(1, 2, 1100))
    with pytest.raises(ValueError, match="rows <= columns"):
        th.hungarian_cuda(torch.zeros(1, 5, 3))
    with pytest.raises(TypeError, match="float32"):
        th.hungarian_cuda(torch.zeros(1, 2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        th.hungarian_cuda(torch.zeros(1, 2, 3))
