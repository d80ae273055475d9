"""Visualisation CLI (the root ``visualize.py``).

    python -m room_slam_torch.visualize --input TRACE.json \
        [--colliders COLLIDERS.json] [--predictions PREDICTIONS.json] \
        [--output out.png] [--side_view]

Draws a top view (X-Z) and with ``--side_view`` also a side view (X-Y):
the trace in blue, the ground truth filled red, the predictions dashed
blue with their confidence. numpy and matplotlib only: no tensor work, so
no ``--device``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from room_slam_torch.data import formats
from room_slam_torch.viz import pyplot, rectangle


def _plot_view(ax, traces, colliders, predictions, axes=(0, 2),
               axis_names=("X Position", "Z Position")):
    a, b = axes
    if traces is not None and traces.shape[0]:
        ax.plot(traces[:, a], traces[:, b], "b-", alpha=0.5, linewidth=0.5,
                label="Trace")
        ax.plot(traces[0, a], traces[0, b], "go", markersize=10,
                label="Start")
        ax.plot(traces[-1, a], traces[-1, b], "ro", markersize=10,
                label="End")

    for idx, col in enumerate(colliders or []):
        c, s = col["center"], col["size"]
        ca = c[("x", "y", "z")[a]]
        cb = c[("x", "y", "z")[b]]
        sa = s[("x", "y", "z")[a]]
        sb = s[("x", "y", "z")[b]]
        ax.add_patch(rectangle(
            (ca - sa / 2, cb - sb / 2), sa, sb, linewidth=2,
            edgecolor="red", facecolor="red", alpha=0.3,
            label="GT" if idx == 0 else ""))
        ax.text(ca, cb, col.get("label", "BLOCK"), ha="center", va="center",
                fontsize=8, color="red")

    for idx, pred in enumerate(predictions or []):
        c, s = pred["center"], pred["size"]
        ca = c[("x", "y", "z")[a]]
        cb = c[("x", "y", "z")[b]]
        sa = s[("x", "y", "z")[a]]
        sb = s[("x", "y", "z")[b]]
        ax.add_patch(rectangle(
            (ca - sa / 2, cb - sb / 2), sa, sb, linewidth=2,
            edgecolor="blue", facecolor="none", linestyle="--", alpha=0.8,
            label="Pred" if idx == 0 else ""))
        conf = pred.get("confidence", 1.0)
        ax.text(ca, cb, f"{pred.get('label', 'PRED')}\n{conf:.2f}",
                ha="center", va="center", fontsize=7, color="blue")

    ax.set_xlabel(axis_names[0])
    ax.set_ylabel(axis_names[1])
    ax.legend()
    ax.grid(True, alpha=0.3)
    ax.set_aspect("equal")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input", type=str, required=True,
                        help="Input trace file (JSON)")
    parser.add_argument("--colliders", type=str, default=None,
                        help="Separate colliders file (optional)")
    parser.add_argument("--predictions", type=str, default=None,
                        help="Prediction file (optional)")
    parser.add_argument("--output", type=str, default=None,
                        help="Output image file")
    parser.add_argument("--side_view", action="store_true",
                        help="also render the X-Y side view")
    args = parser.parse_args(argv)

    traces = formats.load_trace_json(args.input)

    colliders = []
    with open(args.input) as f:
        data = json.load(f)
    if isinstance(data, dict):
        colliders = data.get("colliders", [])
    if args.colliders:
        with open(args.colliders) as f:
            cd = json.load(f)
        colliders = cd.get("colliders", cd) if isinstance(cd, dict) else cd

    predictions = None
    if args.predictions:
        with open(args.predictions) as f:
            predictions = json.load(f).get("colliders", [])

    plt = pyplot()
    n_axes = 2 if args.side_view else 1
    fig, axes = plt.subplots(1, n_axes, figsize=(12 * n_axes, 10))
    axes = np.atleast_1d(axes)
    _plot_view(axes[0], traces, colliders, predictions, axes=(0, 2))
    axes[0].set_title(f"Top View - {Path(args.input).name}")
    if args.side_view:
        _plot_view(axes[1], traces, colliders, predictions, axes=(0, 1),
                   axis_names=("X Position", "Y Position (Height)"))
        axes[1].set_title(f"Side View - {Path(args.input).name}")

    if args.output:
        fig.savefig(args.output, dpi=150, bbox_inches="tight")
        print(f"Saved visualization to {args.output}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
