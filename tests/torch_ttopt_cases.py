"""Shared inputs of the port's ttopt tests (``test_torch_ttopt*.py``):
the JAX suite's traces and crafted boxes, seeded walks and boxes, the
parameter sets, and ``_adapt`` (the port's ``adapt_boxes`` beside the JAX
package's on the same inputs)."""

import jax.numpy as jnp
import numpy as np
import torch

from room_slam_torch.ops import ttopt as tt
from room_slam_tpu.ops import ttopt as jt


def _grid_trace(span=2.0, n=60, y=1.0):
    """A serpentine trace covering [-span, span]^2 in XZ at sensor height
    ``y`` (``tests/test_ttopt.py``'s)."""
    xs = np.linspace(-span, span, n)
    zs = np.linspace(-span, span, n)
    pts = np.array([(x, y, z) for z in zs for x in xs], np.float32)
    t = np.arange(len(pts), dtype=np.float32)[:, None] * 0.033
    return np.concatenate([pts, t], axis=1)


def _walk(L, seed):
    rng = np.random.default_rng(seed)
    xz = np.clip(np.cumsum(rng.normal(size=(L, 2)) * 0.2, 0), -2.2, 2.2)
    return np.stack([xz[:, 0], 1.4 + rng.normal(size=L) * 0.05, xz[:, 1],
                     np.arange(L) * 0.05], 1).astype(np.float32)


# the JAX suite's crafted boxes (an edge wall inward of the envelope, a
# consistent wall outside it, a deep wall inside, a phantom box far
# outside, an overhead box) and a furniture box, set off the grid trace's
# z = 0 symmetry plane: on it a center's gradient is 0 in exact arithmetic
# and Adam turns each package's float32 rounding noise into steps of up to
# lr (test_adapt_boxes_suite_checks_on_the_symmetric_trace covers it)
CRAFTED = np.array([[1.9, 1.25, 0.17, 0.15, 2.5, 4.0],
                    [2.3, 1.25, -0.23, 0.15, 2.5, 4.0],
                    [1.2, 1.25, 0.31, 0.15, 2.5, 4.0],
                    [8.0, 0.5, 8.0, 1.0, 1.0, 1.0],
                    [0.1, 2.0, -0.2, 1.0, 0.4, 1.0],
                    [-1.0, 0.6, 1.0, 0.8, 1.2, 0.6]], np.float32)


def _walk_boxes(seed, Q=10):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-2.5, 2.5, (Q, 1)),
                           rng.uniform(0.3, 1.5, (Q, 1)),
                           rng.uniform(-2.5, 2.5, (Q, 1)),
                           rng.uniform(0.1, 1.5, (Q, 3))], 1
                          ).astype(np.float32)


PARAMS = {
    "defaults": {},
    "deadband": dict(deadband=0.25),
    "att_faces": dict(w_att_faces=0.5, att_mass=1.0),
    "att_min": dict(w_att_min=0.5, att_mass=1.0),
    "att_all": dict(w_att=0.3, w_att_faces=0.2, w_att_min=0.2, deadband=0.1,
                    att_mass=1.0),
}


def _adapt(boxes, raw, L, **kw):
    got = tt.adapt_boxes(torch.from_numpy(boxes), torch.from_numpy(raw), L,
                         tt.TTOptParams(**kw))
    ref = jt.adapt_boxes(jnp.asarray(boxes), jnp.asarray(raw),
                         jnp.asarray(L, jnp.int32), jt.TTOptParams(**kw))
    return got.numpy(), np.asarray(ref)
