"""Seeded box rooms written as trace/collider JSON pairs (``write_rooms``) or
as legacy CSV/objects pairs (``write_legacy_rooms``), for smoke runs and
tests of the training paths where no captured dataset is at hand.

Each room is an axis-aligned box of 5-9 m by 5-9 m with its four walls
(BLOCK colliders, thin and longer than 5 m, so augmentation never drops
them) and 3-8 furniture boxes (LOW, MID or HIGH by height), walked by a
smooth random walk of 2000-3000 points at 30 Hz inside it. All draws come
from ``numpy.random.default_rng(seed)``. This is not the JAX package's
synthetic generator (the port's ``data/synthetic.py`` reproduces that).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from room_slam_torch.config import LEGACY_LABELS
from room_slam_torch.data import formats

_HEIGHTS = {1: (0.3, 0.6), 2: (0.7, 1.2), 3: (1.5, 2.2)}   # LOW, MID, HIGH
# benchmark label -> legacy class name, as the JAX package's
# create_sample_data folds them: walls stay BLOCK, HIGH furniture is MID
_LEGACY_NAME = {0: "BLOCK", 1: "LOW", 2: "MID", 3: "MID"}


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


def write_legacy_rooms(data_dir: str | Path, n_rooms: int, seed: int,
                       points: Tuple[int, int] = (1500, 3000)) -> List[Path]:
    """Write ``n_rooms`` seeded rooms to ``data_dir`` as legacy pairs
    ``room_<i>.csv`` (``t, x, z`` rows: the walk on the floor plane) and
    ``room_<i>_objects.json`` (each box at position ``[x, z]``, size
    ``[w, d]``, orientation 0), projected as the JAX package's
    ``create_sample_data`` projects its rooms; returns the CSV files."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n_rooms):
        trace, boxes, labels = seeded_room(rng, points)
        files.append(data_dir / f"room_{i:03d}.csv")
        formats.save_trace_csv(files[-1], trace[:, [3, 0, 2]])
        objs = []
        for b, lab in zip(boxes, labels):
            name = _LEGACY_NAME[int(lab)]
            objs.append({"class_id": LEGACY_LABELS[name], "class_name": name,
                         "position": [float(b[0]), float(b[2])],
                         "size": [float(b[3]), float(b[5])],
                         "orientation": 0.0, "confidence": 1.0})
        formats.save_objects_json(data_dir / f"room_{i:03d}_objects.json",
                                  objs)
    return files
