"""The legacy (CSV, 2D) dataset surface (own copy of the JAX package's
``data/legacy.py``): CSV movement traces ``timestamp, x, y`` cut into
fixed windows of ``SEQ_LEN`` points, each paired with up to
``MAX_OBJECTS`` ground-truth objects of its ``<stem>_objects.json``
(class, 2D position and size, orientation).

``create_sample_data`` (the synthetic generator's CSV export) is not
ported; ``data/rooms.py`` ``write_legacy_rooms`` writes seeded smoke and
test data in the same layout.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np

from room_slam_torch.config import LEGACY_LABELS
from room_slam_torch.data import formats

SEQ_LEN = 500
MAX_OBJECTS = 10


def window_trace(arr: np.ndarray, seq_len: int = SEQ_LEN,
                 stride: int | None = None) -> np.ndarray:
    """Slice a ``[N, 3]`` (t, x, y) trace into ``[W, seq_len, 3]`` windows,
    each with its time shifted to start at 0. A trace shorter than
    ``seq_len`` is linearly resampled up to ``seq_len``."""
    if arr.shape[0] == 0:
        return np.zeros((0, seq_len, 3), np.float32)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    if arr.shape[0] < seq_len:
        idx = np.linspace(0, arr.shape[0] - 1, seq_len)
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, arr.shape[0] - 1)
        frac = (idx - lo)[:, None].astype(np.float32)
        arr = arr[lo] * (1 - frac) + arr[hi] * frac
    stride = stride or seq_len
    windows = []
    for start in range(0, arr.shape[0] - seq_len + 1, stride):
        w = arr[start: start + seq_len].copy()
        w[:, 0] -= w[0, 0]
        windows.append(w)
    return np.stack(windows).astype(np.float32)


def load_objects_json(path: str | Path) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, np.ndarray]:
    """Parse a legacy objects JSON -> ``(positions [M, 2], sizes [M, 2],
    orientations [M], class_ids [M])``; a missing ``class_id`` comes from
    ``class_name`` (default MID)."""
    data = json.loads(Path(path).read_text())
    objs = data.get("objects", []) if isinstance(data, dict) else data
    m = len(objs)
    pos = np.zeros((m, 2), np.float32)
    size = np.zeros((m, 2), np.float32)
    orient = np.zeros((m,), np.float32)
    cls = np.zeros((m,), np.int32)
    for i, o in enumerate(objs):
        pos[i] = o.get("position", [0, 0])[:2]
        size[i] = o.get("size", [0, 0])[:2]
        orient[i] = o.get("orientation", 0.0)
        cls[i] = o.get(
            "class_id", LEGACY_LABELS.get(o.get("class_name", "MID"), 2))
    return pos, size, orient, cls


def find_legacy_pairs(data_dir: str | Path) -> List[Tuple[Path, Path]]:
    """Pair ``<stem>.csv`` with ``<stem>_objects.json``."""
    data_dir = Path(data_dir)
    pairs = []
    for csv in sorted(data_dir.glob("*.csv")):
        side = data_dir / f"{csv.stem}_objects.json"
        if side.exists():
            pairs.append((csv, side))
    return pairs


class LegacyArrays:
    """All legacy samples as fixed-shape arrays, one window per sample:
    ``traces [S, seq_len, 3]`` (t, x, y), ``boxes [S, M, 5]`` (x, y, w, h,
    theta), ``labels [S, M]`` (-1 where empty), ``valid [S, M]`` and
    ``trace_id [S]`` (the pair each window came from)."""

    def __init__(self, data_dir: str | Path, seq_len: int = SEQ_LEN,
                 max_objects: int = MAX_OBJECTS, stride: int | None = None):
        pairs = find_legacy_pairs(data_dir)
        if not pairs:
            raise ValueError(f"No CSV/objects pairs found in {data_dir}")
        traces, boxes, labels, valid, trace_id = [], [], [], [], []
        for tid, (csv, side) in enumerate(pairs):
            wins = window_trace(formats.load_trace_csv(csv), seq_len, stride)
            pos, size, orient, cls = load_objects_json(side)
            m = min(len(cls), max_objects)
            b = np.zeros((max_objects, 5), np.float32)
            lab = np.full((max_objects,), -1, np.int32)
            v = np.zeros((max_objects,), bool)
            b[:m, :2] = pos[:m]
            b[:m, 2:4] = size[:m]
            b[:m, 4] = orient[:m]
            lab[:m] = cls[:m]
            v[:m] = True
            for w in wins:
                traces.append(w)
                boxes.append(b)
                labels.append(lab)
                valid.append(v)
                trace_id.append(tid)
        self.traces = np.stack(traces)
        self.boxes = np.stack(boxes)
        self.labels = np.stack(labels)
        self.valid = np.stack(valid)
        self.trace_id = np.asarray(trace_id, np.int32)
        self.num_samples = len(traces)

    def __len__(self) -> int:
        return self.num_samples
