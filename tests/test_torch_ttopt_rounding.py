"""The port's ttopt gradient rounding: the loss and gradient run in
float64, so two summation orders of one trace give the same boxes (split
from ``test_torch_ttopt.py``)."""

import numpy as np
import torch

from room_slam_torch.ops import ttopt as tt


def _heading_walk(n, seed):
    """A seeded 30 Hz room walk with a drifting heading (chip_smoke's)."""
    g = np.random.default_rng(seed)
    heading = np.cumsum(g.normal(scale=0.15, size=n))
    step = 0.04 * np.stack([np.cos(heading), np.sin(heading)], -1)
    xz = np.clip(np.cumsum(step, 0), -3.0, 3.0)
    y = 1.6 + 0.02 * g.standard_normal(n)
    return np.stack([xz[:, 0], y, xz[:, 1], np.arange(n) / 30.0],
                    -1).astype(np.float32)


def test_adapt_boxes_gradient_rounding_is_device_independent():
    """The loss and gradient run in float64. On this walk a float32
    gradient summed in another order (as the card sums it) moves boxes by
    up to an Adam step (lr); in float64 two orders of the same trace give
    the same boxes."""
    raw = _heading_walk(1500, 1)
    rng = np.random.default_rng(1)
    Q = 60
    boxes = np.concatenate([rng.uniform(-3, 3, (Q, 1)),
                            rng.uniform(0.3, 1.5, (Q, 1)),
                            rng.uniform(-3, 3, (Q, 1)),
                            rng.uniform(0.1, 2.5, (Q, 3))], 1
                           ).astype(np.float32)
    perm = rng.permutation(1500)
    a = tt.adapt_boxes(torch.from_numpy(boxes), torch.from_numpy(raw), 1500)
    b = tt.adapt_boxes(torch.from_numpy(boxes), torch.from_numpy(raw[perm]),
                       1500)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
