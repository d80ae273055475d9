"""Augmentation check (the JAX package's ``viz/augmentation.py``).

Draws the four rotations of one sample in a 2x2 grid (trace and
colliders), through ``data/augment.rotate_sample``, and runs the numeric
rotation check: at 90 degrees, (x, z) -> (z, -x) within 0.01 (exact, since
the rotation table is exact). ``--stochastic_out`` adds a figure of the
random augmentations (translation, scale, noise, crop, warp, collider
dropout) over five draws from a ``torch.Generator`` seeded by ``--seed``.

    python -m room_slam_torch.viz.augmentation --data_dir DIR \\
        [--index 0] [--out augmentation_test.png] \\
        [--stochastic_out FILE] [--seed 0] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from room_slam_torch import resolve_device
from room_slam_torch.config import DataConfig
from room_slam_torch.data.augment import (Sample, apply_augment, draw_rands,
                                          rotate_sample)
from room_slam_torch.data.dataset import TraceColliderArrays
from room_slam_torch.viz import pyplot, rectangle

Panel = Tuple[np.ndarray, int, np.ndarray, np.ndarray, str]


def _panel(ax, raw, n, boxes, valid, title):
    ax.plot(raw[:n, 0], raw[:n, 2], "b-", lw=0.4, alpha=0.7)
    for b in boxes[valid]:
        ax.add_patch(rectangle(
            (b[0] - b[3] / 2, b[2] - b[5] / 2), b[3], b[5],
            ec="red", fc="red", alpha=0.2))
    ax.set_title(title, fontsize=9)
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)


def sample_of(ds: TraceColliderArrays, i: int,
              device: torch.device) -> Sample:
    """Base sample ``i`` of ``ds`` as a batch of one on ``device``."""
    return Sample(*(torch.from_numpy(getattr(ds, k)[i: i + 1]).to(device)
                    for k in Sample._fields))


def _numpy(s: Sample) -> Tuple[np.ndarray, ...]:
    return tuple(t[0].cpu().numpy() for t in s)


def rotation_panels(sample: Sample) -> List[Panel]:
    """``(raw, n, boxes, valid, title)`` of the four rotations."""
    n = int(sample.length[0])
    out = []
    for k in range(4):
        raw, _, boxes, _, valid = _numpy(rotate_sample(
            sample, torch.full((1,), k, device=sample.raw.device)))
        out.append((raw, n, boxes, valid, f"rotation {k * 90}°"))
    return out


def rotation_error(sample: Sample) -> float:
    """Largest deviation of the 90° rotation from (x, z) -> (z, -x)."""
    n = int(sample.length[0])
    r90 = rotate_sample(sample, torch.ones(1, dtype=torch.long,
                                           device=sample.raw.device))
    x, z = sample.raw[0, :n, 0], sample.raw[0, :n, 2]
    return float(max((r90.raw[0, :n, 0] - z).abs().max(),
                     (r90.raw[0, :n, 2] + x).abs().max()))


def stochastic_panels(sample: Sample, cfg: DataConfig,
                      generator: torch.Generator) -> List[Panel]:
    """The original and five augmented draws (rotation 0) from
    ``generator``, which lives on the sample's device."""
    raw, n, boxes, _, valid = _numpy(sample)
    out = [(raw, int(n), boxes, valid, "original")]
    L, M = sample.raw.shape[1], sample.boxes.shape[1]
    zero = torch.zeros(1, dtype=torch.long, device=sample.raw.device)
    for j in range(1, 6):
        r = draw_rands(generator, 1, L, M, cfg, device=sample.raw.device)
        raw, n, boxes, _, valid = _numpy(apply_augment(sample, zero, r, cfg))
        out.append((raw, int(n), boxes, valid,
                    f"random draw {j} (len {int(n)})"))
    return out


def plot_panels(panels: List[Panel], rows: int, cols: int, figsize,
                title: str):
    """A ``rows x cols`` grid of ``_panel``s."""
    fig, axes = pyplot().subplots(rows, cols, figsize=figsize)
    for ax, p in zip(axes.flat, panels):
        _panel(ax, *p)
    fig.suptitle(title)
    return fig


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", type=str, default="dataset/train")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", type=str, default="augmentation_test.png")
    p.add_argument("--stochastic_out", type=str, default=None,
                   help="optional second figure with random augmentations")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the stochastic figure's generator")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = DataConfig()
    ds = TraceColliderArrays(args.data_dir, cfg, augment=False)
    i = args.index
    sample = sample_of(ds, i, dev)

    fig = plot_panels(rotation_panels(sample), 2, 2, (14, 14),
                      f"Rotation augmentation — {ds.names[i]}")
    fig.savefig(args.out, dpi=110, bbox_inches="tight")
    print(f"saved {args.out}")

    err = rotation_error(sample)
    status = "✓" if err < 0.01 else "✗"
    print(f"{status} 90° rotation maps (x, z) -> (z, -x): "
          f"max error {err:.2e} (threshold 0.01)")

    if args.stochastic_out:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        fig = plot_panels(
            stochastic_panels(sample, cfg, gen), 2, 3, (20, 13),
            "Stochastic augmentations "
            "(translate / scale / noise / crop / warp / dropout)")
        fig.savefig(args.stochastic_out, dpi=110, bbox_inches="tight")
        print(f"saved {args.stochastic_out}")


if __name__ == "__main__":
    main()
