"""Host dataset: every trace/collider pair parsed once into fixed-shape
numpy arrays (own copy of the JAX package's ``data/dataset.py``).

Batch contract (every step has the same shapes):
    raw        [B, L, 4] float32  (x, y, z, t) time-sorted, zero-padded
    length     [B]       int32
    boxes      [B, M, 6] float32
    labels     [B, M]    int32    (-1 padding)
    valid      [B, M]    bool
    rotation_k [B]       int32    rotation index 0..3 (epoch expansion)
    weight     [B]       float32  1.0 for real samples, 0.0 for batch padding
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from room_slam_torch.config import BENCH_ID_TO_LABEL, DataConfig
from room_slam_torch.data import formats


class TraceColliderArrays:
    """All samples of a directory as padded numpy arrays.

    The 4x rotation expansion is an index-space expansion: expanded sample
    ``i`` is base pair ``i // n_rot`` at angle ``rotation_angles[i % n_rot]``;
    the rotation itself happens on the device in ``augment.rotate_sample``.
    """

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], cfg: DataConfig,
                    augment: bool = True) -> "TraceColliderArrays":
        """Build a dataset from in-memory arrays (no file round trip)."""
        self = cls.__new__(cls)
        self.cfg = cfg
        self.augment = augment
        self.data_dir = None
        self.raw = np.asarray(arrays["raw"], np.float32)
        self.length = np.asarray(arrays["length"], np.int32)
        self.boxes = np.asarray(arrays["boxes"], np.float32)
        self.labels = np.asarray(arrays["labels"], np.int32)
        self.valid = np.asarray(arrays["valid"], bool)
        self.names = [f"synthetic_{i:05d}" for i in range(self.raw.shape[0])]
        self._set_rotations()
        return self

    def __init__(self, data_dir: str | Path, cfg: DataConfig,
                 augment: bool = True, verbose: bool = True):
        self.cfg = cfg
        self.augment = augment
        self.data_dir = Path(data_dir)
        pairs = formats.find_data_pairs(self.data_dir)
        if not pairs:
            raise ValueError(f"No valid data files found in {data_dir}")
        if verbose:
            print(f"Found {len(pairs)} base samples in {data_dir}")

        L, M = cfg.max_trace_len, cfg.max_colliders
        n = len(pairs)
        self.raw = np.zeros((n, L, 4), dtype=np.float32)
        self.length = np.zeros((n,), dtype=np.int32)
        self.boxes = np.zeros((n, M, 6), dtype=np.float32)
        self.labels = np.full((n, M), -1, dtype=np.int32)
        self.valid = np.zeros((n, M), dtype=bool)
        self.names: List[str] = []
        colliders: Dict[Path, tuple] = {}
        for i, (trace_file, collider_file) in enumerate(pairs):
            arr = formats.linspace_downsample(
                formats.sort_by_time(formats.load_trace_json(trace_file)), L)
            self.raw[i, :arr.shape[0]] = arr
            self.length[i] = max(arr.shape[0], 1)
            if collider_file not in colliders:
                colliders[collider_file] = formats.load_colliders_json(
                    collider_file)
            b, lab = colliders[collider_file]
            m = min(b.shape[0], M)
            self.boxes[i, :m] = b[:m]
            self.labels[i, :m] = lab[:m]
            self.valid[i, :m] = True
            self.names.append(trace_file.name)
        self._set_rotations()
        if verbose and len(self.rotation_angles) > 1:
            print(f"Augmented to {self.num_samples} samples with rotations: "
                  f"{self.rotation_angles}°")

    @classmethod
    def concat(cls, parts: List["TraceColliderArrays"],
               copies: List[int] | None = None) -> "TraceColliderArrays":
        """Concatenate datasets base sample by base sample, part ``i``
        tiled ``copies[i]`` times (folding a few real captures into a
        large synthetic set). The parts must share their fixed shapes and
        rotation set; the first part's config and augmentation carry
        over."""
        if copies is None:
            copies = [1] * len(parts)
        first = parts[0]
        for p in parts[1:]:
            if p.raw.shape[1:] != first.raw.shape[1:] or \
                    p.boxes.shape[1:] != first.boxes.shape[1:]:
                raise ValueError("concat: mismatched fixed shapes "
                                 f"{p.raw.shape} vs {first.raw.shape}")
            if p.rotation_angles != first.rotation_angles:
                raise ValueError("concat: mismatched rotation sets")

        def tile(name):
            return np.concatenate([np.concatenate([getattr(p, name)] * c)
                                   for p, c in zip(parts, copies)])

        self = cls.__new__(cls)
        self.cfg = first.cfg
        self.augment = first.augment
        self.data_dir = None
        for name in ("raw", "length", "boxes", "labels", "valid"):
            setattr(self, name, tile(name))
        self.names = [n for p, c in zip(parts, copies)
                      for _ in range(c) for n in p.names]
        self.rotation_angles = first.rotation_angles
        self.n_base = self.raw.shape[0]
        self.num_samples = self.n_base * len(self.rotation_angles)
        return self

    def _set_rotations(self) -> None:
        self.rotation_angles = (list(self.cfg.rotation_angles)
                                if self.augment and self.cfg.augment_rotation
                                else [0])
        self.n_base = self.raw.shape[0]
        self.num_samples = self.n_base * len(self.rotation_angles)

    def __len__(self) -> int:
        return self.num_samples

    @property
    def max_valid(self) -> int:
        """Largest number of valid GT colliders in any sample (the matcher
        keeps only the first ``num_queries`` beyond that)."""
        return int(self.valid.sum(axis=1).max()) if len(self.valid) else 0

    def _rotation_k(self, indices: np.ndarray) -> np.ndarray:
        n_rot = len(self.rotation_angles)
        return np.asarray([self.rotation_angles[j % n_rot] // 90
                           for j in indices], dtype=np.int32)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """A batch dict for the given expanded indices (host numpy)."""
        base = np.asarray(indices) // len(self.rotation_angles)
        return {
            "raw": self.raw[base],
            "length": self.length[base],
            "boxes": self.boxes[base],
            "labels": self.labels[base],
            "valid": self.valid[base],
            "rotation_k": self._rotation_k(indices),
            "weight": np.ones((len(indices),), dtype=np.float32),
        }

    def epoch_batches(self, batch_size: int, seed: int = 0,
                      shuffle: bool = True
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield host batches covering the epoch once, in ``epoch_plan``'s
        order. The last partial batch is padded by repeating index 0 at
        weight 0, so every batch has ``batch_size`` rows."""
        rng = np.random.default_rng(seed)
        order = (rng.permutation(self.num_samples) if shuffle
                 else np.arange(self.num_samples))
        for lo in range(0, self.num_samples, batch_size):
            chunk = order[lo:lo + batch_size]
            pad = batch_size - len(chunk)
            batch = self.gather(np.concatenate(
                [chunk, np.zeros(pad, dtype=chunk.dtype)]))
            if pad:
                batch["weight"][-pad:] = 0.0
            yield batch

    def num_batches(self, batch_size: int) -> int:
        return -(-self.num_samples // batch_size)

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The whole base dataset as one dict (the trainer copies it to the
        device once; epochs then only ship index plans)."""
        return {"raw": self.raw, "length": self.length, "boxes": self.boxes,
                "labels": self.labels, "valid": self.valid}

    def epoch_plan(self, batch_size: int, seed: int = 0,
                   shuffle: bool = True) -> Dict[str, np.ndarray]:
        """Index plan of one epoch: ``base_idx``, ``rotation_k`` and
        ``weight``, each ``[n_batches, batch_size]``. The last batch is
        padded with index 0 at weight 0."""
        rng = np.random.default_rng(seed)
        order = (rng.permutation(self.num_samples) if shuffle
                 else np.arange(self.num_samples))
        nb = self.num_batches(batch_size)
        pad = nb * batch_size - len(order)
        idx = np.concatenate([order, np.zeros(pad, dtype=order.dtype)])
        weight = np.ones(len(idx), np.float32)
        if pad:
            weight[-pad:] = 0.0
        base = (idx // len(self.rotation_angles)).astype(np.int32)
        return {"base_idx": base.reshape(nb, batch_size),
                "rotation_k": self._rotation_k(idx).reshape(nb, batch_size),
                "weight": weight.reshape(nb, batch_size)}


def print_dataset_statistics(data_dir: str, cfg: DataConfig | None = None,
                             augment_rotation: bool = True) -> None:
    """Print the dataset report of the JAX package's
    ``print_dataset_statistics``: sample counts, rotations, trace lengths,
    colliders per sample and the label distribution."""
    cfg = cfg or DataConfig()
    ds = TraceColliderArrays(data_dir, cfg, augment=augment_rotation)
    print("=" * 50)
    print("Dataset Statistics")
    print("=" * 50)
    print(f"Base samples: {ds.n_base}")
    print(f"Total samples (with rotation expansion): {len(ds)}")
    print(f"Rotations: {ds.rotation_angles}°")
    lengths = ds.length
    print(f"\nTrace lengths (after window cap {cfg.max_trace_len}):")
    print(f"  Min: {lengths.min()}  Max: {lengths.max()}  "
          f"Avg: {lengths.mean():.1f}")
    counts = ds.valid.sum(axis=1)
    print(f"\nColliders per sample: min {counts.min()} max {counts.max()} "
          f"avg {counts.mean():.1f}")
    flat = ds.labels[ds.valid]
    print("\nLabel distribution (base samples):")
    for lid, name in BENCH_ID_TO_LABEL.items():
        print(f"  {name}: {(flat == lid).sum()}")
    print("=" * 50)


if __name__ == "__main__":
    # python -m room_slam_torch.data.dataset [DATA_DIR]: the report with
    # and without the rotation expansion
    import sys

    data_dir = sys.argv[1] if len(sys.argv) > 1 else "dataset/train"
    print("=== WITH rotation expansion ===")
    print_dataset_statistics(data_dir, augment_rotation=True)
    print("=== WITHOUT rotation expansion ===")
    print_dataset_statistics(data_dir, augment_rotation=False)
