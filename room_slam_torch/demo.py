"""Demo: the rule-based occupancy-heatmap baseline on generated rooms, no
training needed (the JAX package's ``demo.py``).

    python -m room_slam_torch.demo [--n_rooms 3] [--num_steps 3000]
        [--seed 0] [--save_viz DIR] [--output preds.json]
        [--device cuda|cpu]

The rooms and walks are the JAX package's for the same seed, generated on
``--device`` (the card by default; raises without one unless ``--device
cpu``). ``--save_viz DIR`` writes ``demo_room_<i>.png`` for each room: the
walk, the ground truth (red) and the baseline's objects (blue, dashed), as
the root ``demo.py`` does; the plots need matplotlib (an ``ImportError``
naming it without).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np

from room_slam_torch.data import prng, synthetic
from room_slam_torch.models.baseline import OccupancyBaseline


def run_demo(n_rooms: int = 3, num_steps: int = 3000, seed: int = 0,
             device: str = "cuda", verbose: bool = True,
             save_viz: str | None = None) -> List[Dict]:
    """Generate ``n_rooms`` rooms and walks and run the baseline on each
    (with ``save_viz``, each room's plot in that directory); returns
    ``[{"room": i, "objects": [...]}, ...]``."""
    if verbose:
        print(f"Generating {n_rooms} synthetic rooms + traces on "
              f"{device}...")
    data = synthetic.to_numpy(synthetic.generate_rooms_and_traces(
        prng.key(seed), n_rooms, num_steps, device=device))
    baseline = OccupancyBaseline(device=device)
    results = []
    for i in range(n_rooms):
        raw = data["raw"][i]                         # [T, 4] (x, y, z, t)
        trace_txy = np.stack([raw[:, 3], raw[:, 0], raw[:, 2]], axis=1)
        objects = baseline.predict(trace_txy)
        if verbose:
            print(f"\nRoom {i}: {int(data['valid'][i].sum())} ground-truth "
                  f"colliders, baseline predicted {len(objects)} objects:")
            for o in objects:
                print(f"  {o['class_name']:6s} at "
                      f"({o['position'][0]:+.2f}, {o['position'][1]:+.2f}) "
                      f"size {o['size'][0]:.2f}x{o['size'][1]:.2f} "
                      f"conf {o['confidence']:.2f}")
        results.append({"room": i, "objects": objects})
        if save_viz:
            v = data["valid"][i]
            plot_room(save_viz, i, raw, data["boxes"][i][v], objects)
    return results


def plot_room(out_dir: str, i: int, raw: np.ndarray, gt_boxes: np.ndarray,
              objects: List[Dict]) -> None:
    """``<out_dir>/demo_room_<i>.png``: the walk, the GT boxes and the
    baseline's objects, as the root ``demo.py``'s ``_plot``."""
    from pathlib import Path

    from room_slam_torch.viz import pyplot, rectangle

    plt = pyplot()
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.plot(raw[:, 0], raw[:, 2], "b-", alpha=0.4, lw=0.5, label="Trace")
    for b in gt_boxes:
        ax.add_patch(rectangle(
            (b[0] - b[3] / 2, b[2] - b[5] / 2), b[3], b[5],
            ec="red", fc="red", alpha=0.25))
    for o in objects:
        x, y = o["position"]
        w, h = o["size"]
        ax.add_patch(rectangle(
            (x - w / 2, y - h / 2), w, h, ec="blue", fc="none", ls="--"))
        ax.text(x, y, o["class_name"], color="blue", ha="center",
                fontsize=7)
    ax.set_aspect("equal")
    ax.set_title(f"Room {i}: GT (red) vs occupancy baseline (blue)")
    ax.legend()
    fig.savefig(f"{out_dir}/demo_room_{i}.png", dpi=120,
                bbox_inches="tight")
    plt.close(fig)
    print(f"  saved {out_dir}/demo_room_{i}.png")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_rooms", type=int, default=3)
    p.add_argument("--num_steps", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_viz", type=str, default=None,
                   help="directory for PNG visualizations (needs "
                        "matplotlib)")
    p.add_argument("--output", type=str, default=None,
                   help="JSON file for predictions")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    results = run_demo(args.n_rooms, args.num_steps, args.seed, args.device,
                       save_viz=args.save_viz)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"results": results}, f, indent=2)
        print(f"\nSaved predictions to {args.output}")


if __name__ == "__main__":
    main()
