"""Seeded box rooms written as trace/collider JSON pairs, for smoke runs and
tests of the training path where no captured dataset is at hand.

Each room is an axis-aligned box of 5-9 m by 5-9 m with its four walls
(BLOCK colliders, thin and longer than 5 m, so augmentation never drops
them) and 3-8 furniture boxes (LOW, MID or HIGH by height), walked by a
smooth random walk of 2000-3000 points at 30 Hz inside it. All draws come
from ``numpy.random.default_rng(seed)``. This is not the JAX package's
synthetic generator (``data/synthetic.py``, still to be ported).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from room_slam_torch.data import formats

_HEIGHTS = {1: (0.3, 0.6), 2: (0.7, 1.2), 3: (1.5, 2.2)}   # LOW, MID, HIGH


def seeded_room(rng: np.random.Generator,
                points: Tuple[int, int] = (2000, 3000)
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One room: ``(trace [n, 4] (x, y, z, t), boxes [m, 6], labels [m])``
    with ``n`` drawn from ``points`` (both ends included)."""
    W, D = rng.uniform(5.0, 9.0, size=2)
    H = rng.uniform(2.4, 3.0)
    boxes = [[0.0, H / 2, -D / 2, W, H, 0.2], [0.0, H / 2, D / 2, W, H, 0.2],
             [-W / 2, H / 2, 0.0, 0.2, H, D], [W / 2, H / 2, 0.0, 0.2, H, D]]
    labels = [0, 0, 0, 0]
    for _ in range(rng.integers(3, 9)):
        lab = int(rng.integers(1, 4))
        sx, sz = rng.uniform(0.4, 1.5, size=2)
        sy = rng.uniform(*_HEIGHTS[lab])
        cx = rng.uniform(-W / 2 + sx / 2 + 0.2, W / 2 - sx / 2 - 0.2)
        cz = rng.uniform(-D / 2 + sz / 2 + 0.2, D / 2 - sz / 2 - 0.2)
        boxes.append([cx, sy / 2, cz, sx, sy, sz])
        labels.append(lab)

    n = int(rng.integers(points[0], points[1] + 1))
    heading = np.cumsum(rng.normal(scale=0.15, size=n))
    step = 0.04 * np.stack([np.cos(heading), np.sin(heading)], -1)
    lim = np.array([W / 2 - 0.3, D / 2 - 0.3])
    xz = np.zeros((n, 2))
    for i in range(1, n):          # walk, reflected at the walls
        p = xz[i - 1] + step[i]
        xz[i] = np.where(np.abs(p) > lim, np.sign(p) * lim, p)
    y = 1.6 + 0.02 * rng.standard_normal(n)
    trace = np.stack([xz[:, 0], y, xz[:, 1], np.arange(n) / 30.0], -1)
    return (trace.astype(np.float32), np.asarray(boxes, np.float32),
            np.asarray(labels, np.int32))


def write_rooms(data_dir: str | Path, n_rooms: int, seed: int,
                points: Tuple[int, int] = (2000, 3000)) -> List[Path]:
    """Write ``n_rooms`` seeded rooms to ``data_dir`` as
    ``room_<i>_trace.json`` + ``room_<i>_collider.json`` pairs; returns the
    trace files."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n_rooms):
        trace, boxes, labels = seeded_room(rng, points)
        files.append(data_dir / f"room_{i:03d}_trace.json")
        formats.save_trace_json(files[-1], trace)
        formats.save_colliders_json(data_dir / f"room_{i:03d}_collider.json",
                                    boxes, labels)
    return files
