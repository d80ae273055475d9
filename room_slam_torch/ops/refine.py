"""Trace-informed box post-passes (counterpart of the JAX package's
``ops/refine.py``).

The walker's trace pins what the model regresses loosely: its free-space
extent implies the boundary wall planes (``refine_walls`` snaps thin BLOCK
boxes to them, ``synthesize_walls`` appends them as candidates), its
unvisited interior holes and boundary notches imply furniture
(``hole_components``, ``synthesize_furniture`` / ``_v2``), a seen room's
colliders give the building's floor and ceiling (``snap_y_planes``,
``y_planes_from_colliders``), and ``outside_extent_mask`` flags boxes
entirely outside the plausible room. Everything runs at fixed shapes on
the boxes' device.

Where the JAX functions rank (``lax.top_k``), the port sorts stably in
descending order, so tied values keep the lower index first as
``top_k`` does; ``jnp.median`` averages the two middle values; segment
minima and maxima of empty segments read +inf / -inf.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

DEFAULT_WALL_THICKNESS = 0.125  # synthetic walls; real walls are 0.10-0.24
_BIG = 1e9


def trace_extent(raw: torch.Tensor, length):
    """Free-space bounding box ``(x_min, x_max, z_min, z_max)`` of the first
    ``length`` points of ``raw [L, 4]`` (x, y, z, t)."""
    m = torch.arange(raw.shape[0], device=raw.device) < length
    x, z = raw[:, 0], raw[:, 2]
    return (torch.where(m, x, _BIG).amin(), torch.where(m, x, -_BIG).amax(),
            torch.where(m, z, _BIG).amin(), torch.where(m, z, -_BIG).amax())


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _side_offsets(boxes, labels, extent, clearance, wall_thickness,
                  furniture_aware):
    """Per-side wall-plane offsets beyond the trace extent
    ``(lo_x, hi_x, lo_z, hi_z)``: clearance + thickness / 2, or, with
    ``furniture_aware``, just beyond predicted furniture lining that
    side."""
    x_min, x_max, z_min, z_max = extent
    off = _scalar(clearance + wall_thickness / 2, boxes)
    if not furniture_aware:
        return off, off, off, off
    cx, cz = boxes[:, 0], boxes[:, 2]
    sx, sz = boxes[:, 3], boxes[:, 5]
    furn = labels != 0
    gap = 0.05 + wall_thickness / 2
    near = 1.2

    def side_off(centers, sizes, lo_edge, hi_edge, hi_side):
        if hi_side:
            outer, edge = centers + sizes / 2, hi_edge
        else:
            outer, edge = -(centers - sizes / 2), -lo_edge
        lining = furn & (outer > edge - 0.2) & (outer < edge + near)
        best = torch.where(lining, outer - edge, -torch.inf).amax()
        return torch.maximum(off, torch.where(torch.isfinite(best),
                                              best + gap, off))

    return (side_off(cx, sx, x_min, x_max, False),
            side_off(cx, sx, x_min, x_max, True),
            side_off(cz, sz, z_min, z_max, False),
            side_off(cz, sz, z_min, z_max, True))


def refine_walls(boxes: torch.Tensor, labels: torch.Tensor,
                 raw: torch.Tensor, length, clearance: float = 0.3,
                 wall_thickness: float = DEFAULT_WALL_THICKNESS,
                 trust: float = 0.4, max_aspect_thin: float = 0.45,
                 furniture_aware: bool = False) -> torch.Tensor:
    """Snap wall-like BLOCK boxes ``[Q, 6]`` (thin in x or z, elongated in
    the other) to the trace-extent-implied wall planes, at the trace's room
    span, when the predicted center lies within ``trust`` of the plane
    (widened by how far ``furniture_aware`` moved that side's plane)."""
    x_min, x_max, z_min, z_max = trace_extent(raw, length)
    off = clearance + wall_thickness / 2
    span_x = (x_max - x_min) + 2 * clearance + wall_thickness
    span_z = (z_max - z_min) + 2 * clearance + wall_thickness
    mid_x = (x_min + x_max) / 2
    mid_z = (z_min + z_max) / 2

    cx, cy, cz = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    sx, sy, sz = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    is_block = labels == 0
    lo_x_off, hi_x_off, lo_z_off, hi_z_off = _side_offsets(
        boxes, labels, (x_min, x_max, z_min, z_max), clearance,
        wall_thickness, furniture_aware)

    thin_x = is_block & (sx < max_aspect_thin) & (sz > 2 * sx)
    right = cx > mid_x
    snap_x = torch.where(right, x_max + hi_x_off, x_min - lo_x_off)
    do_x = thin_x & (torch.abs(cx - snap_x) < trust + torch.where(
        right, torch.abs(hi_x_off - off), torch.abs(lo_x_off - off)))
    cx = torch.where(do_x, snap_x, cx)
    sx = torch.where(do_x, wall_thickness, sx)
    sz = torch.where(do_x, span_z, sz)
    cz = torch.where(do_x, mid_z, cz)

    thin_z = is_block & (boxes[:, 5] < max_aspect_thin) & (
        boxes[:, 3] > 2 * boxes[:, 5]) & ~do_x
    front = boxes[:, 2] > mid_z
    snap_z = torch.where(front, z_max + hi_z_off, z_min - lo_z_off)
    do_z = thin_z & (torch.abs(boxes[:, 2] - snap_z) < trust + torch.where(
        front, torch.abs(hi_z_off - off), torch.abs(lo_z_off - off)))
    cz = torch.where(do_z, snap_z, cz)
    sz = torch.where(do_z, wall_thickness, sz)
    sx = torch.where(do_z, span_x, sx)
    cx = torch.where(do_z, mid_x, cx)
    return torch.stack([cx, cy, cz, sx, sy, sz], dim=-1)


def _confidence(logits: torch.Tensor, objectness) -> torch.Tensor:
    conf = torch.softmax(logits, dim=-1).amax(dim=-1)
    if objectness is not None:
        conf = conf * torch.sigmoid(objectness)
    return conf


def _best(m: torch.Tensor, conf: torch.Tensor):
    """Index of the highest confidence under ``m`` (the first on ties, 0
    when ``m`` is empty) and whether ``m`` holds any row."""
    return torch.where(m, conf, -torch.inf).argmax(), m.any()


def synthesize_walls(boxes: torch.Tensor, logits: torch.Tensor,
                     objectness, raw: torch.Tensor, length,
                     clearance: float = 0.3,
                     wall_thickness: float = DEFAULT_WALL_THICKNESS,
                     furniture_aware: bool = False, min_span: float = 1.5,
                     dup_dist: float = 0.4):
    """Append the 4 extent-implied wall candidates to the predictions.

    Each side's row takes the class logits (and objectness) of the best
    thin-wall prediction on that side, else the best BLOCK, else the best
    row, decayed by 0.99 with the BLOCK logit raised to the row max + 0.01;
    the height comes from the best thin wall anywhere (default cy 1.25, sy
    2.5). A side is open only if no thin wall lies within ``dup_dist`` of
    its plane, and the trace must span ``min_span`` in both axes.

    Returns (boxes ``[Q+4, 6]``, logits ``[Q+4, C]``, objectness ``[Q+4]``
    or None, valid ``[Q+4]`` bool).
    """
    Q = boxes.shape[0]
    x_min, x_max, z_min, z_max = trace_extent(raw, length)
    extent_ok = ((x_max - x_min) > min_span) & ((z_max - z_min) > min_span)
    labels = logits.argmax(-1)
    lo_x, hi_x, lo_z, hi_z = _side_offsets(
        boxes, labels, (x_min, x_max, z_min, z_max), clearance,
        wall_thickness, furniture_aware)
    span_x = (x_max - x_min) + 2 * clearance + wall_thickness
    span_z = (z_max - z_min) + 2 * clearance + wall_thickness
    mid_x = (x_min + x_max) / 2
    mid_z = (z_min + z_max) / 2

    conf = _confidence(logits, objectness)
    cx, cz = boxes[:, 0], boxes[:, 2]
    sx, sz = boxes[:, 3], boxes[:, 5]
    is_block = labels == 0
    thin_x = is_block & (sx < 0.45) & (sz > 2 * sx)
    thin_z = is_block & (sz < 0.45) & (sx > 2 * sz)

    def pick(side_mask):
        i_thin, has_thin = _best(side_mask, conf)
        i_block, has_block = _best(is_block, conf)
        return torch.where(has_thin, i_thin,
                           torch.where(has_block, i_block, conf.argmax()))

    srcs = torch.stack([pick(thin_x & (cx <= mid_x)),
                        pick(thin_x & (cx > mid_x)),
                        pick(thin_z & (cz <= mid_z)),
                        pick(thin_z & (cz > mid_z))])

    any_thin = thin_x | thin_z
    i_h, has_h = _best(any_thin, conf)
    wall_cy = torch.where(has_h, boxes[i_h, 1], 1.25)
    wall_sy = torch.where(has_h, boxes[i_h, 4], 2.5)

    wt = _scalar(wall_thickness, boxes)
    planes = (x_min - lo_x, x_max + hi_x, z_min - lo_z, z_max + hi_z)
    new_boxes = torch.stack([
        torch.stack([planes[0], wall_cy, mid_z, wt, wall_sy, span_z]),
        torch.stack([planes[1], wall_cy, mid_z, wt, wall_sy, span_z]),
        torch.stack([mid_x, wall_cy, planes[2], span_x, wall_sy, wt]),
        torch.stack([mid_x, wall_cy, planes[3], span_x, wall_sy, wt]),
    ])

    def covered(thin_mask, centers, plane):
        d = torch.where(thin_mask, torch.abs(centers - plane), torch.inf)
        return d.amin() < dup_dist

    side_open = ~torch.stack([covered(thin_x, cx, planes[0]),
                              covered(thin_x, cx, planes[1]),
                              covered(thin_z, cz, planes[2]),
                              covered(thin_z, cz, planes[3])])
    src_logits = logits[srcs] * 0.99
    src_logits[:, 0] = src_logits.amax(dim=-1) + 0.01
    out_obj = (None if objectness is None
               else torch.cat([objectness, objectness[srcs]]))
    valid = torch.cat([torch.ones(Q, dtype=torch.bool, device=boxes.device),
                       side_open & extent_ok])
    return (torch.cat([boxes, new_boxes]), torch.cat([logits, src_logits]),
            out_obj, valid)


def snap_y_planes(boxes: torch.Tensor, labels: torch.Tensor, floor_y,
                  ceil_y, min_h: float = 1.8) -> torch.Tensor:
    """Snap BLOCK boxes taller than ``min_h`` to the calibrated floor and
    ceiling planes (center y at their middle, height their distance)."""
    cy, sy = boxes[:, 1], boxes[:, 4]
    floor_y, ceil_y = _scalar(floor_y, boxes), _scalar(ceil_y, boxes)
    tall_block = (labels == 0) & (sy > min_h)
    out = boxes.clone()
    out[:, 1] = torch.where(tall_block, (floor_y + ceil_y) / 2.0, cy)
    out[:, 4] = torch.where(tall_block, ceil_y - floor_y, sy)
    return out


def y_planes_from_colliders(path: str, min_h: float = 1.8):
    """``(floor_y, ceil_y)`` of a seen room's collider JSON: the lowest
    bottom and highest top face over its boxes taller than ``min_h``."""
    with open(path) as f:
        data = json.load(f)
    cols = data["colliders"] if isinstance(data, dict) else data
    bottoms, tops = [], []
    for c in cols:
        size = c.get("size", {})
        center = c.get("center", {})
        sy = float(size.get("y", 0.0))
        if sy > min_h:
            cy = float(center.get("y", 0.0))
            bottoms.append(cy - sy / 2.0)
            tops.append(cy + sy / 2.0)
    if not bottoms:
        raise ValueError(f"no tall boxes (size.y > {min_h}) in {path}")
    return min(bottoms), max(tops)


def _dilate(a: torch.Tensor) -> torch.Tensor:
    """3x3 max filter of ``[B, G, G]`` with -inf padding (``reduce_window``
    max, ``SAME``)."""
    return F.max_pool2d(a[:, None], 3, stride=1, padding=1)[:, 0]


def _cell(v: torch.Tensor, lo: torch.Tensor, d: torch.Tensor,
          G: int) -> torch.Tensor:
    """Raster cell of coordinates ``v [B, L]``: ``(v - lo) / max(d, 1e-6)``
    truncated toward zero and clipped to ``[0, G - 1]``. The quotient is
    clipped to ``[-1, G]`` before the integer conversion, which gives the
    same cells for every finite input without an out-of-range cast."""
    q = (v - lo[:, None]) / torch.clamp(d, min=1e-6)[:, None]
    return torch.clamp(torch.clamp(q, -1.0, float(G)).to(torch.int64),
                       0, G - 1)


def _raster(x, z, pmask, G):
    """The walk's visited cells on the ``G x G`` envelope raster of each
    row of ``x, z, pmask [B, L]``, dilated one cell (the walker's body):
    ``(visited [B, G, G] float, x_min, x_max, z_min, z_max, dx, dz)``, the
    rest ``[B]``."""
    B = x.shape[0]
    x_min = torch.where(pmask, x, _BIG).amin(-1)
    x_max = torch.where(pmask, x, -_BIG).amax(-1)
    z_min = torch.where(pmask, z, _BIG).amin(-1)
    z_max = torch.where(pmask, z, -_BIG).amax(-1)
    # divided by a tensor: CUDA turns a division by a Python number into a
    # multiply by its reciprocal, an ulp off, and an ulp moves a point to
    # the next cell
    g = torch.full_like(x_min, G)
    dx = (x_max - x_min) / g
    dz = (z_max - z_min) / g
    flat = _cell(x, x_min, dx, G) * G + _cell(z, z_min, dz, G)
    # scatter-max: a padding point writes 0 into a cell a valid point may
    # also hit, and must not clear it
    visited = torch.zeros(B, G * G, dtype=x.dtype, device=x.device)
    visited.scatter_reduce_(1, flat, pmask.to(x.dtype), "amax")
    return (_dilate(visited.view(B, G, G)), x_min, x_max, z_min, z_max,
            dx, dz)


def _segment(values: torch.Tensor, seg: torch.Tensor, n: int,
             reduce: str) -> torch.Tensor:
    """Segment reduction of ``values [B, M]`` by ids ``seg [B, M]`` into
    ``[B, n]``; empty segments read 0 (sum), +inf (amin) or -inf (amax)."""
    init = {"sum": 0.0, "amin": torch.inf, "amax": -torch.inf}[reduce]
    out = torch.full((values.shape[0], n), init, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(1, seg, values, reduce)


def _top_k(values: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties in index
    order."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def hole_components(x: torch.Tensor, z: torch.Tensor, pmask: torch.Tensor,
                    k: int, grid: int = 40):
    """Largest-``k`` interior holes of the visited XZ raster of ``x, z,
    pmask [L]`` (or ``[B, L]``, each row its own walk).

    Rasterize the visited cells on a ``grid`` x ``grid`` envelope raster,
    dilate one cell, flood-fill outside-connected unvisited space by 2G
    iterated 3x3 dilations, label the remaining components by 2G
    max-propagations of cell ids, and read per-component stats by segment
    reductions.

    Returns a dict of ``[k]`` (``[B, k]``) tensors sorted by descending
    area: ``c_x``, ``c_z``, ``s_x``, ``s_z``, ``area_m2``; plus ``span_x``,
    ``span_z`` (``[]`` or ``[B]``). Slots beyond the real components read
    ``area_m2`` 0.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x, z, pmask = x[None], z[None], pmask[None]
    B = x.shape[0]
    G = grid
    visited, x_min, x_max, z_min, z_max, dx, dz = _raster(x, z, pmask, G)
    unvisited = visited < 0.5

    border = torch.zeros(G, G, dtype=torch.bool, device=x.device)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    o = (border & unvisited).to(x.dtype)
    for _ in range(2 * G):
        o = torch.where(unvisited, _dilate(o), 0.0)
    hole = unvisited & ~(o > 0.5)

    ids = torch.arange(1, G * G + 1, dtype=x.dtype,
                       device=x.device).view(G, G)
    lab = torch.where(hole, ids, 0.0)
    for _ in range(2 * G):
        lab = torch.where(hole, _dilate(lab), 0.0)

    flat = lab.view(B, G * G).to(torch.int64)
    ones = hole.view(B, G * G).to(x.dtype)
    n_seg = G * G + 1
    area = _segment(ones, flat, n_seg, "sum")
    steps = torch.arange(G, dtype=x.dtype, device=x.device) + 0.5
    cxs = x_min[:, None] + steps * dx[:, None]                  # [B, G]
    czs = z_min[:, None] + steps * dz[:, None]
    cell_x = cxs[:, :, None].expand(B, G, G).reshape(B, G * G)
    cell_z = czs[:, None, :].expand(B, G, G).reshape(B, G * G)
    sum_x = _segment(ones * cell_x, flat, n_seg, "sum")
    sum_z = _segment(ones * cell_z, flat, n_seg, "sum")
    inside = ones > 0
    min_x = _segment(torch.where(inside, cell_x, torch.inf), flat, n_seg,
                     "amin")
    max_x = _segment(torch.where(inside, cell_x, -torch.inf), flat, n_seg,
                     "amax")
    min_z = _segment(torch.where(inside, cell_z, torch.inf), flat, n_seg,
                     "amin")
    max_z = _segment(torch.where(inside, cell_z, -torch.inf), flat, n_seg,
                     "amax")
    area[:, 0] = 0.0                                  # the background

    top_area, top = _top_k(area, k)
    n_cells = torch.clamp(top_area, min=1.0)

    def at(v):
        return v.gather(1, top)

    out = {
        "c_x": at(sum_x) / n_cells,
        "c_z": at(sum_z) / n_cells,
        "s_x": at(max_x) - at(min_x) + dx[:, None],
        "s_z": at(max_z) - at(min_z) + dz[:, None],
        "area_m2": top_area * (dx * dz)[:, None],
        "span_x": x_max - x_min,
        "span_z": z_max - z_min,
    }
    if squeeze:
        out = {key: v[0] for key, v in out.items()}
    return out


def _class_logits(logits: torch.Tensor, srcs: torch.Tensor,
                  cls: torch.Tensor) -> torch.Tensor:
    """The source rows' logits decayed by 0.99, with class ``cls``'s logit
    raised to the row max + 0.01."""
    src = logits[srcs] * 0.99
    hot = F.one_hot(cls, logits.shape[-1]).bool()
    return torch.where(hot, src.amax(dim=-1, keepdim=True) + 0.01, src)


def synthesize_furniture(boxes: torch.Tensor, logits: torch.Tensor,
                         objectness, raw: torch.Tensor, length,
                         k_new: int = 6, grid: int = 40,
                         min_area: float = 0.05, max_area: float = 2.5,
                         dup_dist: float = 0.35, min_span: float = 1.5,
                         low_mid_split: float = 0.55,
                         max_side: float = 1.8):
    """Append up to ``k_new`` hole-implied furniture candidates: the
    largest interior holes of the walk raster with an area in [min_area,
    max_area], no furniture prediction within ``dup_dist``, on a trace
    spanning ``min_span``. Footprint = the hole's extent clipped to [0.2,
    max_side]; LOW below ``low_mid_split`` else MID; y and height from the
    model's best same-class row, then its best furniture row, then fixed
    priors; logits from that row (``_class_logits``).

    Returns (boxes ``[Q+k, 6]``, logits ``[Q+k, C]``, objectness
    ``[Q+k]`` or None, valid ``[Q+k]`` bool).
    """
    Q = boxes.shape[0]
    pmask = torch.arange(raw.shape[0], device=raw.device) < length
    h = hole_components(raw[:, 0], raw[:, 2], pmask, k_new, grid)
    extent_ok = (h["span_x"] > min_span) & (h["span_z"] > min_span)
    area_m2 = h["area_m2"]
    c_x, c_z = h["c_x"], h["c_z"]
    s_x = torch.clamp(h["s_x"], 0.2, max_side)
    s_z = torch.clamp(h["s_z"], 0.2, max_side)
    is_low = torch.maximum(s_x, s_z) < low_mid_split

    labels = logits.argmax(-1)
    conf = _confidence(logits, objectness)
    furn_rows = (labels == 1) | (labels == 2)

    def pick(cls):
        i_cls, has_cls = _best(labels == cls, conf)
        i_furn, has_furn = _best(furn_rows, conf)
        return (torch.where(has_cls, i_cls,
                            torch.where(has_furn, i_furn, conf.argmax())),
                has_cls | has_furn)

    i_low, has_low = pick(1)
    i_mid, has_mid = pick(2)
    cy_low = torch.where(has_low, boxes[i_low, 1], 0.2)
    sy_low = torch.where(has_low, boxes[i_low, 4], 0.4)
    cy_mid = torch.where(has_mid, boxes[i_mid, 1], 0.5)
    sy_mid = torch.where(has_mid, boxes[i_mid, 4], 1.0)
    c_y = torch.where(is_low, cy_low, cy_mid)
    s_y = torch.where(is_low, sy_low, sy_mid)

    new_boxes = torch.stack([c_x, c_y, c_z, s_x, s_y, s_z], dim=-1)
    srcs = torch.where(is_low, i_low, i_mid)
    cls = torch.where(is_low, 1, 2)
    src_logits = _class_logits(logits, srcs, cls)

    d2 = ((boxes[None, :, 0] - c_x[:, None]) ** 2
          + (boxes[None, :, 2] - c_z[:, None]) ** 2)            # [k, Q]
    dup = ((d2 < dup_dist ** 2) & furn_rows[None, :]).any(dim=1)
    ok = (area_m2 >= min_area) & (area_m2 <= max_area) & ~dup & extent_ok

    out_obj = (None if objectness is None
               else torch.cat([objectness, objectness[srcs]]))
    valid = torch.cat([torch.ones(Q, dtype=torch.bool, device=boxes.device),
                       ok])
    return (torch.cat([boxes, new_boxes]), torch.cat([logits, src_logits]),
            out_obj, valid)


def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the mean of the two middle values
    of an even count (``(lo + hi) * 0.5``)."""
    s = torch.sort(v).values
    n = v.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def synthesize_furniture_v2(boxes: torch.Tensor, logits: torch.Tensor,
                            objectness, raw: torch.Tensor, length,
                            k_new: int = 6, grid: int = 40,
                            notch_min: float = 0.55,
                            notch_max: float = 2.6,
                            notch_run_min: float = 0.6,
                            side_clear: float = 0.35,
                            runs_per_side: int = 2, face_tol: float = 0.22,
                            shoulder_drop: float = 0.35,
                            side_max_standoff: float = 0.6,
                            notch_conf: float = 0.7,
                            tall_min_area: float = 0.6,
                            tall_max_area: float = 4.5,
                            max_area: float = 3.5, dup_dist: float = 0.35,
                            min_span: float = 1.5):
    """Interior-hole rows (``synthesize_furniture`` with a relaxed area
    band and a 3 m footprint clip), wall-height and chest-height BLOCK
    copies of the big hole rows, and boundary-notch rows: per envelope
    side, runs of columns whose indentation beyond the side's median
    standoff is deep, flat and shouldered each give a wall-height BLOCK
    and a MID hypothesis. The added rows rank at the model's best MID
    row's confidence, discounted by ``notch_conf``.

    Returns (boxes ``[Q', 6]``, logits ``[Q', C]``, objectness ``[Q']`` or
    None, valid ``[Q']`` bool), Q' = Q + 3 k_new + 8 runs_per_side.
    """
    Q = boxes.shape[0]
    G = grid
    b1, lg1, ob1, v1 = synthesize_furniture(
        boxes, logits, objectness, raw, length, k_new=k_new, grid=grid,
        max_area=max_area, dup_dist=dup_dist, min_span=min_span,
        max_side=3.0)

    labels = logits.argmax(-1)
    conf = _confidence(logits, objectness)

    i_tall, has_tall = _best((labels == 0) & (boxes[:, 4] > 1.8), conf)
    cy_tall = torch.where(has_tall, boxes[i_tall, 1], 1.45)
    sy_tall = torch.where(has_tall, boxes[i_tall, 4], 3.8)
    i_mid, has_mid = _best(labels == 2, conf)
    cy_mid = torch.where(has_mid, boxes[i_mid, 1], 0.5)
    sy_mid = torch.where(has_mid, boxes[i_mid, 4], 1.0)

    def with_y(rows, cy, sy):
        out = rows.clone()
        out[:, 1] = cy
        out[:, 4] = sy
        return out

    # wall-height BLOCK copies of the v1 hole rows: geometry from the tall
    # datum, confidence from the furniture datum with the discount
    hole_rows = b1[Q:Q + k_new]
    hole_valid = v1[Q:Q + k_new]
    hole_area = hole_rows[:, 3] * hole_rows[:, 5]
    tall_ok = (hole_valid & (hole_area >= tall_min_area)
               & (hole_area <= tall_max_area))
    tall_boxes = with_y(hole_rows, cy_tall, sy_tall)
    src_mid = torch.where(has_mid, i_mid, conf.argmax())
    disc = torch.log(_scalar(notch_conf, boxes))
    zeros_k = torch.zeros(k_new, dtype=torch.int64, device=boxes.device)
    mid_k = src_mid.expand(k_new)
    tall_logits = _class_logits(logits, mid_k, zeros_k)

    # chest-height BLOCK copies of the big hole rows (beds)
    i_lblk, has_lblk = _best((labels == 0) & (boxes[:, 4] > 0.6)
                             & (boxes[:, 4] <= 1.8), conf)
    cy_lblk = torch.where(has_lblk, boxes[i_lblk, 1], 0.06)
    sy_lblk = torch.where(has_lblk, boxes[i_lblk, 4], 1.12)
    lblk_ok = hole_valid & (hole_area >= 1.2) & (hole_area <= tall_max_area)
    lblk_boxes = with_y(hole_rows, cy_lblk, sy_lblk)
    lblk_logits = _class_logits(logits, mid_k, zeros_k)
    disc_obj = (None if objectness is None
                else (objectness[src_mid] + disc).expand(k_new))

    # boundary notches
    pmask = torch.arange(raw.shape[0], device=raw.device) < length
    vis, x_min, x_max, z_min, z_max, dx, dz = _raster(
        raw[None, :, 0], raw[None, :, 2], pmask[None], G)
    vis = vis[0] > 0.5
    x_min, x_max, z_min, z_max, dx, dz = (
        v[0] for v in (x_min, x_max, z_min, z_max, dx, dz))
    extent_ok = ((x_max - x_min) > min_span) & ((z_max - z_min) > min_span)
    iidx = torch.arange(G, dtype=raw.dtype, device=raw.device)

    def side_runs(v, d_i, d_j):
        """``v [G_i, G_j]`` with the wall at high i: per run of the top
        ``runs_per_side`` (ok, depth, j_lo, j_hi) in metres, and the side's
        median standoff."""
        last = torch.where(v, iidx[:, None], -1.0).amax(dim=0)   # [G_j]
        has_col = last >= 0.0
        indent = torch.where(has_col, (G - 1 - last) * d_i, G * d_i)
        side_med = _median(torch.where(has_col, indent, G * d_i))
        mark = (has_col & (indent >= notch_min) & (indent <= notch_max)
                & (indent >= side_med + side_clear))
        run_id = torch.cumsum((~mark).to(torch.int64), dim=0)
        seg = torch.where(mark, run_id, G)[None]                 # G: trash
        ones = mark.to(raw.dtype)[None]
        cnt = _segment(ones, seg, G + 1, "sum")[0]
        cnt[G] = 0.0
        dsum = _segment(ones * indent, seg, G + 1, "sum")[0]
        d2sum = _segment(ones * indent * indent, seg, G + 1, "sum")[0]
        jmin = _segment(torch.where(mark, iidx, torch.inf)[None], seg, G + 1,
                        "amin")[0]
        jmax = _segment(torch.where(mark, iidx, -torch.inf)[None], seg,
                        G + 1, "amax")[0]
        top_cnt, top = _top_k(cnt, runs_per_side)
        n = torch.clamp(top_cnt, min=1.0)
        has_run = top_cnt > 0
        run_len = top_cnt * d_j
        mean_d = dsum[top] / n
        var_d = torch.clamp(d2sum[top] / n - mean_d * mean_d, min=0.0)
        flat = torch.sqrt(var_d) <= face_tol

        def col(j):   # an empty run's +-inf bound is clipped before the cast
            return torch.clamp(torch.clamp(j, -1.0, float(G)).to(torch.int64),
                               0, G - 1)

        sh = torch.minimum(indent[col(jmin[top] - 1)],
                           indent[col(jmax[top] + 1)])
        shoulder_ok = sh <= mean_d - shoulder_drop
        hugs = side_med <= side_max_standoff
        ok = (has_run & (run_len >= notch_run_min) & flat & shoulder_ok
              & hugs & extent_ok)
        depth = torch.where(has_run, mean_d, 0.5)
        j_lo = torch.where(has_run, jmin[top] * d_j, 0.0)
        j_hi = torch.where(has_run, (jmax[top] + 1.0) * d_j, 0.3)
        return ok, depth, j_lo, j_hi, side_med

    notch_parts = []
    for side in range(4):
        if side == 0:    # wall at x_max; j axis = z
            ok, dep, j_lo, j_hi, med = side_runs(vis, dx, dz)
            c_i, c_j = x_max + (med - dep) / 2.0, z_min + (j_lo + j_hi) / 2.0
        elif side == 1:  # wall at x_min
            ok, dep, j_lo, j_hi, med = side_runs(vis.flip(0), dx, dz)
            c_i, c_j = x_min - (med - dep) / 2.0, z_min + (j_lo + j_hi) / 2.0
        elif side == 2:  # wall at z_max; j axis = x
            ok, dep, j_lo, j_hi, med = side_runs(vis.t(), dz, dx)
            c_i, c_j = z_max + (med - dep) / 2.0, x_min + (j_lo + j_hi) / 2.0
        else:            # wall at z_min
            ok, dep, j_lo, j_hi, med = side_runs(vis.t().flip(0), dz, dx)
            c_i, c_j = z_min - (med - dep) / 2.0, x_min + (j_lo + j_hi) / 2.0
        s_i, s_j = dep + med, j_hi - j_lo
        zero = torch.zeros_like(c_i)
        if side < 2:
            bx = torch.stack([c_i, zero, c_j, s_i, zero, s_j], -1)
        else:
            bx = torch.stack([c_j, zero, c_i, s_j, zero, s_i], -1)
        notch_parts.append((bx, ok))
    notch_fp = torch.cat([p[0] for p in notch_parts])            # [4R, 6]
    notch_ok = torch.cat([p[1] for p in notch_parts])
    notch_fp[:, 3] = torch.clamp(notch_fp[:, 3], 0.3, 3.0)
    notch_fp[:, 5] = torch.clamp(notch_fp[:, 5], 0.3, 4.0)
    R = notch_fp.shape[0]

    # dup gate against existing non-thin predictions
    nonthin = torch.minimum(boxes[:, 3], boxes[:, 5]) > 0.25
    d2 = ((boxes[None, :, 0] - notch_fp[:, 0:1]) ** 2
          + (boxes[None, :, 2] - notch_fp[:, 2:3]) ** 2)          # [R, Q]
    ndup = ((d2 < dup_dist ** 2) & nonthin[None, :]).any(dim=1)
    notch_ok = notch_ok & ~ndup

    nb_tall = with_y(notch_fp, cy_tall, sy_tall)
    nb_mid = with_y(notch_fp, cy_mid, sy_mid)
    mid_r = src_mid.expand(R)
    nlog_tall = _class_logits(logits, mid_r, torch.zeros_like(mid_r))
    nlog_mid = _class_logits(logits, mid_r, torch.full_like(mid_r, 2))

    out_boxes = torch.cat([b1, tall_boxes, lblk_boxes, nb_tall, nb_mid])
    out_logits = torch.cat([lg1, tall_logits, lblk_logits, nlog_tall,
                            nlog_mid])
    out_obj = None
    if objectness is not None:
        nobj = (objectness[src_mid] + disc).expand(2 * R)
        out_obj = torch.cat([ob1, disc_obj, disc_obj, nobj])
    valid = torch.cat([v1, tall_ok, lblk_ok, notch_ok, notch_ok])
    return out_boxes, out_logits, out_obj, valid


def outside_extent_mask(boxes: torch.Tensor, raw: torch.Tensor, length,
                        slack: float = 1.0) -> torch.Tensor:
    """True for boxes ``[Q, 6]`` whose XZ footprint lies entirely outside
    the trace's free-space extent expanded by ``slack``."""
    x_min, x_max, z_min, z_max = trace_extent(raw, length)
    bx_min = boxes[:, 0] - boxes[:, 3] / 2
    bx_max = boxes[:, 0] + boxes[:, 3] / 2
    bz_min = boxes[:, 2] - boxes[:, 5] / 2
    bz_max = boxes[:, 2] + boxes[:, 5] / 2
    overlaps = ((bx_max >= x_min - slack) & (bx_min <= x_max + slack)
                & (bz_max >= z_min - slack) & (bz_min <= z_max + slack))
    return ~overlaps
