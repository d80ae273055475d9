"""The port's trace-informed post-passes (``room_slam_torch/ops/refine.py``)
against the JAX package's on the same seeded inputs: ragged lengths
(L=17, 43) with padding points outside the envelope, boxes within rtol
1e-5 / atol 1e-6, masks and ``valid`` equal; the hole raster's areas and
the order of tied components equal; the even-count median and the
scatter-max of padding points into visited cells."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import refine as tref
from room_slam_tpu.ops import refine as jref

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def _pad(raw, extra=9, seed=0):
    """``raw`` plus ``extra`` padding rows far outside its envelope."""
    rng = np.random.default_rng(seed)
    pad = np.concatenate([rng.uniform(20.0, 40.0, (extra, 3)) *
                          rng.choice([-1.0, 1.0], (extra, 3)),
                          np.zeros((extra, 1))], 1)
    return np.concatenate([raw, pad]).astype(np.float32)


def _walk(L, seed):
    """A seeded walk in a ~4 x 5 m room, (x, y, z, t)."""
    rng = np.random.default_rng(seed)
    xz = np.cumsum(rng.normal(size=(L, 2)) * 0.35, axis=0)
    xz = np.clip(xz, [-2.0, -2.5], [2.0, 2.5])
    y = 1.5 + rng.normal(size=L) * 0.02
    t = np.arange(L) * 0.05
    return np.stack([xz[:, 0], y, xz[:, 1], t], 1).astype(np.float32)


def _boxes(seed, Q=12):
    """Predictions around a 4 x 5 m room: thin walls near each side (some
    inside the snap window), furniture lining two sides, free boxes."""
    rng = np.random.default_rng(seed)
    walls = np.array([[-2.3, 1.3, 0.1, 0.15, 2.6, 4.0],
                      [2.25, 1.2, -0.2, 0.2, 2.4, 3.5],
                      [0.1, 1.25, 2.8, 3.5, 2.5, 0.12],
                      [-0.2, 1.25, -2.9, 3.0, 2.5, 0.18]])
    furn = np.array([[1.7, 0.4, 0.5, 0.6, 0.8, 1.2],
                     [-0.3, 0.5, -2.3, 1.5, 1.0, 0.6],
                     [0.0, 0.3, 0.0, 0.8, 0.6, 0.7]])
    free = np.concatenate([rng.uniform(-3, 3, (Q - 7, 3)),
                           rng.uniform(0.1, 2.0, (Q - 7, 3))], 1)
    boxes = np.concatenate([walls, furn, free])
    boxes[:, [0, 2]] += rng.normal(size=(Q, 2)) * 0.05
    logits = rng.normal(size=(Q, 4)) * 2.0
    logits[:4, 0] += 6.0                      # walls are BLOCK
    logits[4:6, 2] += 6.0                     # two MID, one LOW
    logits[6, 1] += 6.0
    obj = rng.normal(size=Q)
    return (boxes.astype(np.float32), logits.astype(np.float32),
            obj.astype(np.float32))


def _both(fn_t, fn_j, *args, **kw):
    """Call the port's function on tensors and the JAX one on jnp arrays."""
    t_args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args]
    j_args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args]
    return fn_t(*t_args, **kw), fn_j(*j_args, **kw)


@pytest.mark.parametrize("L", [17, 43])
def test_trace_extent_and_outside_mask(L):
    raw = _pad(_walk(L, L))
    boxes, _, _ = _boxes(L)
    got, ref = _both(tref.trace_extent, jref.trace_extent, raw, L)
    for g, r in zip(got, ref):
        _close(g, r)
    for slack in (0.0, 1.0):
        got, ref = _both(tref.outside_extent_mask, jref.outside_extent_mask,
                         boxes, raw, L, slack=slack)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("L,furniture", [(17, False), (43, False),
                                         (17, True), (43, True)])
def test_refine_walls_matches_jax(L, furniture):
    raw = _pad(_walk(L, L + 1))
    boxes, logits, _ = _boxes(L + 1)
    labels = logits.argmax(-1).astype(np.int32)
    for trust in (0.4, 1.5):
        got, ref = _both(tref.refine_walls, jref.refine_walls, boxes, labels,
                         raw, L, clearance=0.3, trust=trust,
                         furniture_aware=furniture)
        _close(got, ref)
        if trust == 1.5:
            assert not np.allclose(np.asarray(ref), boxes)   # something snaps


@pytest.mark.parametrize("L,objectness,furniture", [
    (17, True, False), (43, False, True), (43, True, True)])
def test_synthesize_walls_matches_jax(L, objectness, furniture):
    raw = _pad(_walk(L, L + 2))
    boxes, logits, obj = _boxes(L + 2)
    got, ref = _both(tref.synthesize_walls, jref.synthesize_walls, boxes,
                     logits, obj if objectness else None, raw, L,
                     clearance=0.3, furniture_aware=furniture)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    assert (got[2] is None) == (ref[2] is None) == (not objectness)
    if objectness:
        _close(got[2], ref[2])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_synthesize_walls_degenerate_and_no_thin_walls():
    """A trace spanning under min_span opens no side; with no thin-wall
    prediction every source falls back to the best BLOCK, then any row."""
    raw = _pad(_walk(43, 5) * np.array([0.2, 1, 0.2, 1], np.float32))
    boxes, logits, obj = _boxes(5)
    boxes[:, 3:] = 1.0                          # nothing is thin
    for lg in (logits, logits - np.array([9, 0, 0, 0], np.float32)):
        got, ref = _both(tref.synthesize_walls, jref.synthesize_walls, boxes,
                         lg, obj, raw, 43)
        for g, r in zip(got[:3], ref[:3]):
            _close(g, r)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_snap_y_planes_matches_jax():
    boxes, logits, _ = _boxes(7, Q=20)
    boxes[::3, 4] = 2.5                         # tall rows
    labels = logits.argmax(-1).astype(np.int32)
    got, ref = _both(tref.snap_y_planes, jref.snap_y_planes, boxes, labels,
                     np.float32(-0.1), np.float32(3.6))
    _close(got, ref)
    assert not np.allclose(np.asarray(ref), boxes)


def test_y_planes_from_colliders_matches_jax(tmp_path):
    cols = [{"center": {"x": 0, "y": 1.7, "z": 0},
             "size": {"x": 4, "y": 3.8, "z": 0.1}},
            {"center": {"x": 1, "y": 1.85, "z": 0},
             "size": {"x": 0.1, "y": 3.9, "z": 2}},
            {"center": {"x": 1, "y": 0.5, "z": 1},
             "size": {"x": 1, "y": 1.0, "z": 1}}]
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"colliders": cols}))
    assert tref.y_planes_from_colliders(str(path)) == \
        jref.y_planes_from_colliders(str(path))
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(cols[2:]))
    for fn in (tref.y_planes_from_colliders, jref.y_planes_from_colliders):
        with pytest.raises(ValueError, match="no tall boxes"):
            fn(str(bare))


def _ring_trace(holes, span=4.0, step=0.06):
    """Serpentine walk over a [0, span]^2 room except the ``(cx, cz, r)``
    discs of ``holes``."""
    pts, t, z, direction = [], 0.0, 0.0, 1
    while z <= span:
        for x in np.arange(0.0, span + 1e-6, step)[::direction]:
            if all(np.hypot(x - h[0], z - h[1]) > h[2] for h in holes):
                pts.append([x, 1.5, z, t])
                t += 0.05
        z += step
        direction *= -1
    return np.asarray(pts, np.float32)


def _holes(raw, L, k, grid=40):
    x, z = raw[:, 0], raw[:, 2]
    pmask = np.arange(len(raw)) < L
    return _both(tref.hole_components, jref.hole_components, x, z, pmask, k,
                 grid=grid)


def test_hole_components_matches_jax():
    raw = _pad(_ring_trace([(1.0, 1.0, 0.55), (2.9, 2.7, 0.4),
                            (3.0, 1.0, 0.25)]))
    L = len(raw) - 9
    got, ref = _holes(raw, L, k=6)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["area_m2"].numpy() > 0,
                                  np.asarray(ref["area_m2"]) > 0)
    assert int((np.asarray(ref["area_m2"]) > 0).sum()) >= 2
    for key in ref:
        _close(got[key], ref[key], err_msg=key)


def _cell_trace(holes, G=40, span=4.0):
    """One point at the center of every cell of a ``G x G`` raster over
    [0, span]^2 but those inside the ``(i0, j0, i1, j1)`` cell squares,
    plus the two corners that pin the envelope."""
    d = span / G
    pts = [[0.0, 1.5, 0.0], [span, 1.5, span]]
    for i in range(G):
        for j in range(G):
            if not any(h[0] <= i <= h[2] and h[1] <= j <= h[3]
                       for h in holes):
                pts.append([(i + 0.5) * d, 1.5, (j + 0.5) * d])
    pts = np.asarray(pts, np.float32)
    t = np.arange(len(pts), dtype=np.float32)[:, None] * 0.05
    return np.concatenate([pts, t], 1)


def test_hole_components_tied_areas_keep_index_order():
    """Two holes of equal cell count: ``lax.top_k`` puts the lower
    segment id first, and so must the port."""
    raw = _pad(_cell_trace([(10, 10, 15, 15), (25, 24, 30, 29),
                            (5, 30, 9, 33)]))
    L = len(raw) - 9
    got, ref = _holes(raw, L, k=4)
    area = np.asarray(ref["area_m2"])
    assert area[0] == area[1] > area[2] > 0 == area[3]   # the tie is real
    for key in ("area_m2", "c_x", "c_z", "s_x", "s_z"):
        _close(got[key], ref[key], err_msg=key)
    assert np.asarray(ref["c_x"])[0] != np.asarray(ref["c_x"])[1]


def test_hole_components_batched_rows_match_single():
    """The port's batched call (``hole_tokens``) equals one call a row."""
    a = _pad(_ring_trace([(1.0, 1.0, 0.55)]), extra=200)
    b = _pad(_ring_trace([(2.5, 2.0, 0.7)]), extra=3)
    n = min(len(a), len(b))
    x = torch.from_numpy(np.stack([a[:n, 0], b[:n, 0]]))
    z = torch.from_numpy(np.stack([a[:n, 2], b[:n, 2]]))
    pmask = torch.from_numpy(np.stack([np.arange(n) < n - 200,
                                       np.arange(n) < n - 3]))
    batched = tref.hole_components(x, z, pmask, 3)
    for r in range(2):
        single = tref.hole_components(x[r], z[r], pmask[r], 3)
        for key in single:
            torch.testing.assert_close(batched[key][r], single[key],
                                       rtol=0, atol=0)


def test_scatter_max_keeps_cells_padding_points_also_hit():
    """Padding points that land in visited cells must not clear them
    (``.at[].max`` semantics, not last-write-wins)."""
    raw = _ring_trace([(2.0, 2.0, 0.6)])
    L = len(raw)
    raw = np.concatenate([raw, raw[::7]])           # padding inside cells
    got, ref = _holes(raw, L, k=3)
    for key in ref:
        _close(got[key], ref[key], err_msg=key)
    assert float(ref["area_m2"][0]) > 0


@pytest.mark.parametrize("case", ["ring_obj", "ring_no_obj", "walk43"])
def test_synthesize_furniture_matches_jax(case):
    if case == "walk43":
        raw, L = _pad(_walk(43, 3)), 43
    else:
        raw = _pad(_ring_trace([(1.0, 1.0, 0.55), (3.0, 2.8, 0.3)]))
        L = len(raw) - 9
    boxes, logits, obj = _boxes(11)
    boxes[:, [0, 2]] += 2.0                       # into the ring's room
    obj = None if case == "ring_no_obj" else obj
    got, ref = _both(tref.synthesize_furniture, jref.synthesize_furniture,
                     boxes, logits, obj, raw, L)
    for g, r in zip(got[:2], ref[:2]):
        _close(g, r)
    if obj is not None:
        _close(got[2], ref[2])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    if case != "walk43":
        assert np.asarray(ref[3])[len(boxes):].any()


def _notched_trace(seed=0, n=2600):
    """Dense room walk with a 1.2 m-deep x 2 m-long notch at the x-max
    wall."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        x, z = rng.uniform(-3, 3), rng.uniform(-3, 3)
        if x > 1.8 and -1.0 < z < 1.0:
            continue
        pts.append([x, -0.46, z, len(pts) * 0.03])
    return np.asarray(pts, np.float32)


@pytest.mark.parametrize("seed,objectness", [(0, True), (1, True),
                                             (2, False)])
def test_synthesize_furniture_v2_matches_jax(seed, objectness):
    raw = _pad(_notched_trace(seed))
    L = len(raw) - 9
    boxes, logits, obj = _boxes(seed + 20)
    boxes[0, 4] = 3.6                              # a tall wall datum
    got, ref = _both(tref.synthesize_furniture_v2,
                     jref.synthesize_furniture_v2, boxes, logits,
                     obj if objectness else None, raw, L)
    assert got[0].shape == ref[0].shape
    for g, r in zip(got[:2], ref[:2]):
        _close(g, r)
    if objectness:
        _close(got[2], ref[2])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert np.asarray(ref[3])[len(boxes):].any()


def test_median_of_even_count_averages_the_middles():
    """``side_runs``' standoff median over G=40 columns: ``jnp.median``
    averages the two middle values, where ``torch.median`` would take the
    lower."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        v = rng.uniform(0.0, 2.0, 40).astype(np.float32)
        s = np.sort(v)
        assert s[19] != s[20]
        got = tref._median(torch.from_numpy(v)).item()
        assert got == float(jnp.median(jnp.asarray(v)))
        assert got != torch.from_numpy(v).median().item()
    v = rng.uniform(size=41).astype(np.float32)
    assert tref._median(torch.from_numpy(v)).item() == \
        float(jnp.median(jnp.asarray(v)))
