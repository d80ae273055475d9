"""Demo: the rule-based occupancy-heatmap baseline on generated rooms, no
training needed (the JAX package's ``demo.py``).

    python -m room_slam_torch.demo [--n_rooms 3] [--num_steps 3000]
        [--seed 0] [--output preds.json] [--device cuda|cpu]

The rooms and walks are the JAX package's for the same seed, generated on
``--device`` (the card by default; raises without one unless ``--device
cpu``). ``--save_viz`` is not ported: the plots need matplotlib and the
visualisation tools (ROADMAP.md queue 1, Item 16), so it raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np

from room_slam_torch.data import prng, synthetic
from room_slam_torch.models.baseline import OccupancyBaseline


def run_demo(n_rooms: int = 3, num_steps: int = 3000, seed: int = 0,
             device: str = "cuda", verbose: bool = True) -> List[Dict]:
    """Generate ``n_rooms`` rooms and walks and run the baseline on each;
    returns ``[{"room": i, "objects": [...]}, ...]``."""
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
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_rooms", type=int, default=3)
    p.add_argument("--num_steps", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_viz", type=str, default=None,
                   help="not ported (raises)")
    p.add_argument("--output", type=str, default=None,
                   help="JSON file for predictions")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.save_viz:
        raise NotImplementedError(
            "--save_viz is not ported: the plots need matplotlib and the "
            "visualisation tools (ROADMAP.md queue 1, Item 16)")
    results = run_demo(args.n_rooms, args.num_steps, args.seed, args.device)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"results": results}, f, indent=2)
        print(f"\nSaved predictions to {args.output}")


if __name__ == "__main__":
    main()
