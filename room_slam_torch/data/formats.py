"""Host-side trace and collider JSON I/O and the legacy CSV surface (own
copy of the JAX package's ``data/formats.py``). Trace JSON loads through
the native parser (``native/trace_parser.py``); a file it declines is
parsed in Python.

- trace JSON: a list of ``{"timestamp","x","y","z"}`` rows, or a dict with a
  ``traces`` / ``trajectory`` key.
- collider JSON: ``{"colliders": [{"type","label","center","size",
  "radius","height"}, ...], "metadata": {...}}``, or a bare list.
- a data directory pairs ``*_trace.json`` with ``*_collider.json``, or
  ``agent_data_*.json`` / ``human_data_*.json`` with a shared
  ``colliders.json``.
- legacy CSV trace: ``timestamp, x, y`` rows; legacy objects JSON:
  ``{"objects": [...]}``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from room_slam_torch.config import BENCH_ID_TO_LABEL, BENCH_LABELS
from room_slam_torch.native import trace_parser


def parse_trace_records(data) -> np.ndarray:
    """Convert a parsed trace JSON object to ``[N, 4]`` float32 of
    ``(x, y, z, t)``; an empty or unrecognized container gives ``[0, 4]``."""
    if isinstance(data, dict):
        data = data.get("traces", data.get("trajectory", []))
    if not isinstance(data, list) or len(data) == 0:
        return np.zeros((0, 4), dtype=np.float32)
    arr = np.empty((len(data), 4), dtype=np.float32)
    for i, p in enumerate(data):
        arr[i, 0] = p.get("x", 0.0)
        arr[i, 1] = p.get("y", 0.0)
        arr[i, 2] = p.get("z", 0.0)
        arr[i, 3] = p.get("timestamp", 0.0)
    return arr


def load_trace_json(path: str | Path) -> np.ndarray:
    """Load a trace JSON file to ``[N, 4]`` (x, y, z, t) float32 with the
    native parser; a file the parser declines goes to
    ``parse_trace_records``."""
    arr = trace_parser.parse_trace_file(path)
    if arr is not None:
        return arr
    with open(path, "r") as f:
        return parse_trace_records(json.load(f))


def save_trace_json(path: str | Path, arr: np.ndarray) -> None:
    """Write ``[N, 4]`` (x, y, z, t) as trace JSON rows."""
    rows = [{"timestamp": float(t), "x": float(x), "y": float(y),
             "z": float(z)} for x, y, z, t in arr]
    with open(path, "w") as f:
        json.dump(rows, f)


def parse_collider_records(colliders: Sequence[Dict],
                           label_to_id: Dict[str, int] = BENCH_LABELS
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Collider dicts to ``boxes [M, 6]`` (cx, cy, cz, sx, sy, sz) float32
    and ``labels [M]`` int32 (an unknown label counts as BLOCK)."""
    m = len(colliders)
    boxes = np.zeros((m, 6), dtype=np.float32)
    labels = np.zeros((m,), dtype=np.int32)
    for i, col in enumerate(colliders):
        c = col.get("center", {})
        s = col.get("size", {})
        boxes[i] = [c.get("x", 0.0), c.get("y", 0.0), c.get("z", 0.0),
                    s.get("x", 0.0), s.get("y", 0.0), s.get("z", 0.0)]
        labels[i] = label_to_id.get(col.get("label", "BLOCK"), 0)
    return boxes, labels


def load_colliders_json(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """Load a collider JSON file (``{"colliders": [...]}`` or a bare
    list) to ``(boxes [M, 6], labels [M])``."""
    with open(path, "r") as f:
        data = json.load(f)
    cols = data.get("colliders", []) if isinstance(data, dict) else data
    return parse_collider_records(cols)


def save_colliders_json(path: str | Path, boxes: np.ndarray,
                        labels: np.ndarray) -> None:
    """Write ground truth as ``{"colliders": [...]}``."""
    cols = [collider_to_dict(b, lab) for b, lab in zip(boxes, labels)]
    with open(path, "w") as f:
        json.dump({"colliders": cols}, f, indent=2)


def find_data_pairs(data_dir: str | Path) -> List[Tuple[Path, Path]]:
    """``(trace_file, collider_file)`` pairs of a data directory:
    ``*_trace.json`` + ``*_collider.json``, else ``agent_data_*.json`` /
    ``human_data_*.json`` + a shared ``colliders.json``."""
    data_dir = Path(data_dir)
    pairs: List[Tuple[Path, Path]] = []
    for trace_file in sorted(data_dir.glob("*_trace.json")):
        base = trace_file.stem.replace("_trace", "")
        collider_file = data_dir / f"{base}_collider.json"
        if collider_file.exists():
            pairs.append((trace_file, collider_file))
    if not pairs:
        shared = data_dir / "colliders.json"
        if shared.exists():
            traces = sorted(data_dir.glob("agent_data_*.json")) + sorted(
                data_dir.glob("human_data_*.json"))
            pairs = [(t, shared) for t in traces]
    return pairs


def sort_by_time(arr: np.ndarray, time_col: int = 3) -> np.ndarray:
    """Stable sort of rows by timestamp."""
    if arr.shape[0] == 0:
        return arr
    return arr[np.argsort(arr[:, time_col], kind="stable")]


def linspace_downsample(arr: np.ndarray, max_len: int) -> np.ndarray:
    """Uniform index downsampling to at most ``max_len`` rows."""
    if arr.shape[0] <= max_len:
        return arr
    return arr[np.linspace(0, arr.shape[0] - 1, max_len, dtype=int)]


def collider_to_dict(box: np.ndarray, label_id: int,
                     confidence: Optional[float] = None) -> Dict:
    """Format one ``(cx, cy, cz, sx, sy, sz)`` box as a collider dict."""
    d: Dict = {"type": "BoxCollider",
               "label": BENCH_ID_TO_LABEL[int(label_id)]}
    if confidence is not None:
        d["confidence"] = float(confidence)
    d["center"] = {"x": float(box[0]), "y": float(box[1]), "z": float(box[2])}
    d["size"] = {"x": float(box[3]), "y": float(box[4]), "z": float(box[5])}
    d["radius"] = 0.0
    d["height"] = 0.0
    return d


def save_predictions_json(path: str | Path, predictions: List[Dict],
                          confidence_threshold: float,
                          nms_threshold: float) -> None:
    """Write the inference output JSON."""
    out = {
        "colliders": predictions,
        "metadata": {
            "num_colliders": len(predictions),
            "confidence_threshold": confidence_threshold,
            "nms_threshold": nms_threshold,
        },
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


def load_trace_csv(path: str | Path) -> np.ndarray:
    """Load a legacy CSV trace (``timestamp, x, y`` rows, no header
    required; a line that does not parse is skipped) to ``[N, 3]`` float32
    of (t, x, y)."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append([float(p) for p in line.split(",")[:3]])
            except ValueError:
                continue
    if not rows:
        return np.zeros((0, 3), dtype=np.float32)
    return np.asarray(rows, dtype=np.float32)


def save_trace_csv(path: str | Path, arr: np.ndarray) -> None:
    """Write ``[N, 3]`` (t, x, y) as the legacy CSV format."""
    with open(path, "w") as f:
        for t, x, y in arr:
            f.write(f"{t}, {x}, {y}\n")


def save_objects_json(path: str | Path, objects: List[Dict]) -> None:
    """Write the legacy objects JSON ``{"objects": [...]}``."""
    with open(path, "w") as f:
        json.dump({"objects": objects}, f, indent=2)
