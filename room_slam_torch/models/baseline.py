"""Rule-based occupancy-heatmap baseline of the legacy surface (counterpart
of the JAX package's ``models/baseline.py``).

1. histogram the 2D trace onto a grid, each point weighted by its dwell
   time (one ``index_add_`` on the device);
2. GROUND = visited cells; candidate objects = unvisited cells inside the
   bounding box of the visited ones;
3. 4-connected components of candidate cells -> axis-aligned boxes
   (``scipy.ndimage.label`` on the host);
4. class: a component touching that bounding box's border -> BLOCK (a
   wall); an interior one next to a high-dwell cell (above the 75th
   percentile of the visited cells) -> LOW (people sit there); other
   interior ones -> MID.

On the card ``index_add_`` sums with atomics in no fixed order, so a
cell's dwell may differ from the CPU's in its last bits. The boxes depend
only on which cells are visited and are exact; a LOW / MID label can flip
only for a cell whose dwell ties the 75th percentile.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from scipy import ndimage

from room_slam_torch import resolve_device
from room_slam_torch.config import LEGACY_ID_TO_LABEL, LEGACY_LABELS


def occupancy_histogram(xy: torch.Tensor, dwell: torch.Tensor,
                        origin: torch.Tensor, cell: float,
                        grid: int) -> torch.Tensor:
    """Dwell-weighted occupancy grid ``[grid, grid]`` of ``xy [N, 2]`` with
    weights ``dwell [N]``, cells of ``cell`` metres from ``origin [2]``:
    one ``index_add_``."""
    ij = ((xy - origin) / cell).to(torch.int32).clamp(0, grid - 1)
    flat = (ij[:, 0] * grid + ij[:, 1]).long()
    hist = torch.zeros(grid * grid, dtype=torch.float32, device=xy.device)
    return hist.index_add_(0, flat, dwell).view(grid, grid)


class OccupancyBaseline:
    """Rule-based predictor: trace ``[N, 3]`` of (t, x, y) -> legacy object
    dicts (at most ``max_objects``, by descending confidence). The
    histogram runs on ``device`` (default the card)."""

    def __init__(self, cell: float = 0.25, grid: int = 64,
                 min_cells: int = 2, max_objects: int = 10,
                 device: str | torch.device = "cuda"):
        self.cell = cell
        self.grid = grid
        self.min_cells = min_cells
        self.max_objects = max_objects
        self.device = resolve_device(device)

    def predict(self, trace_txy: np.ndarray) -> List[Dict]:
        t = trace_txy[:, 0]
        xy = trace_txy[:, 1:3].astype(np.float32)
        dt = np.clip(np.diff(t, prepend=t[0]).astype(np.float32), 0.0, 1.0)
        lo = xy.min(axis=0) - self.cell
        span = (xy.max(axis=0) - lo) + self.cell
        cell = max(float(span.max()) / self.grid, self.cell)
        dev = self.device
        hist = occupancy_histogram(
            torch.from_numpy(xy).to(dev), torch.from_numpy(dt).to(dev),
            torch.from_numpy(lo).to(dev), cell, self.grid).cpu().numpy()

        visited = hist > 0
        vi, vj = np.where(visited)
        if len(vi) == 0:
            return []
        i0, i1, j0, j1 = vi.min(), vi.max(), vj.min(), vj.max()
        interior = np.zeros_like(visited)
        interior[i0:i1 + 1, j0:j1 + 1] = True
        candidates = interior & ~visited
        labels, _ = ndimage.label(candidates)
        high_dwell = hist > np.percentile(hist[visited], 75)

        objects: List[Dict] = []
        for comp in range(1, labels.max() + 1):
            ci, cj = np.where(labels == comp)
            if len(ci) < self.min_cells:
                continue
            x_min = lo[0] + ci.min() * cell
            x_max = lo[0] + (ci.max() + 1) * cell
            y_min = lo[1] + cj.min() * cell
            y_max = lo[1] + (cj.max() + 1) * cell
            if (ci.min() <= i0 or ci.max() >= i1 or cj.min() <= j0
                    or cj.max() >= j1):
                cls = LEGACY_LABELS["BLOCK"]
            else:
                g = self.grid - 1
                dil = np.zeros_like(candidates)
                dil[np.clip(ci + 1, 0, g), cj] = True
                dil[np.clip(ci - 1, 0, g), cj] = True
                dil[ci, np.clip(cj + 1, 0, g)] = True
                dil[ci, np.clip(cj - 1, 0, g)] = True
                cls = LEGACY_LABELS["LOW" if (dil & high_dwell).any()
                                    else "MID"]
            objects.append({
                "class_id": int(cls),
                "class_name": LEGACY_ID_TO_LABEL[cls],
                "position": [float((x_min + x_max) / 2),
                             float((y_min + y_max) / 2)],
                "size": [float(x_max - x_min), float(y_max - y_min)],
                "orientation": 0.0,
                "confidence": float(min(1.0, len(ci) / 20.0)),
            })
        objects.sort(key=lambda o: -o["confidence"])
        return objects[: self.max_objects]
