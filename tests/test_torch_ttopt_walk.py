"""The port's ``adapt_boxes`` against the JAX package's on a seeded walk
(atol 1e-4 m), the JAX suite's own checks of the port on its symmetric
trace, and the adaptation under serving's ``inference_mode`` and on an
empty trace (split from ``test_torch_ttopt.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import ttopt as tt
from room_slam_tpu.ops import ttopt as jt
from torch_ttopt_cases import (CRAFTED, PARAMS, _adapt, _grid_trace, _walk,
                               _walk_boxes)


@pytest.mark.parametrize("name", ["defaults", "deadband", "att_all"])
def test_adapt_boxes_seeded_walk_matches_jax(name):
    raw = np.concatenate([_walk(400, 2), np.full((37, 4), 30.0, np.float32)])
    boxes = _walk_boxes(2, Q=16)
    got, ref = _adapt(boxes, raw, 400, **PARAMS[name])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[:, [1, 4]], boxes[:, [1, 4]])


def test_adapt_boxes_suite_checks_on_the_symmetric_trace():
    """``tests/test_ttopt.py``'s checks, on its exact trace and boxes, for
    the port: the edge wall plowed out to the envelope, the consistent wall
    kept, the deep wall near its estimate, y untouched; the phantom box
    pulled in; the overhead box left alone."""
    raw = torch.from_numpy(_grid_trace(span=2.0))
    L = raw.shape[0]
    boxes = torch.tensor([[1.9, 1.25, 0.0, 0.15, 2.5, 4.0],
                          [2.3, 1.25, 0.0, 0.15, 2.5, 4.0],
                          [1.2, 1.25, 0.0, 0.15, 2.5, 4.0]])
    p = tt.TTOptParams(steps=300)
    out = tt.adapt_boxes(boxes, raw, L, p).numpy()
    assert out[0, 0] > 2.1, out[0]
    face = out[0, 0] - out[0, 3] / 2 - p.body_radius
    assert 1.93 < face < 2.15, out[0]
    np.testing.assert_allclose(out[1], boxes[1].numpy(), atol=0.05)
    assert abs(out[2, 0] - 1.2) < 0.25, out[2]
    np.testing.assert_allclose(out[:, [1, 4]], boxes[:, [1, 4]].numpy(),
                               atol=1e-6)
    phantom = torch.tensor([[8.0, 0.5, 8.0, 1.0, 1.0, 1.0]])
    out = tt.adapt_boxes(phantom, raw, L,
                         tt.TTOptParams(steps=300, w_env=1.0)).numpy()
    d1 = np.hypot(max(out[0, 0] - out[0, 3] / 2 - 2.0, 0),
                  max(out[0, 2] - out[0, 5] / 2 - 2.0, 0))
    assert d1 < 0.75 * np.hypot(6.0, 6.0), out
    overhead = torch.tensor([[0.0, 2.0, 0.0, 1.0, 0.4, 1.0]])
    np.testing.assert_allclose(tt.adapt_boxes(overhead, raw, L).numpy(),
                               overhead.numpy(), atol=0.02)


def test_adapt_boxes_under_inference_mode_and_empty_trace():
    """The adaptation runs inside a serving call's ``inference_mode``; a
    length-0 trace stays finite with y untouched, as in the reference (its
    boxes are not compared: the reference's float32 absorbs the 1e9 extent
    sentinel into exact ties that the port's float64 loss does not have,
    see ``ops/ttopt.py``)."""
    raw = _grid_trace(n=20)
    boxes = torch.from_numpy(CRAFTED)
    with torch.inference_mode():
        got = tt.adapt_boxes(boxes, torch.from_numpy(raw), len(raw),
                             tt.TTOptParams(steps=20))
    ref = jt.adapt_boxes(jnp.asarray(CRAFTED), jnp.asarray(raw),
                         jnp.asarray(len(raw)), jt.TTOptParams(steps=20))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    got0, ref0 = _adapt(CRAFTED, raw, 0, steps=20)
    assert np.isfinite(got0).all() and np.isfinite(ref0).all()
    np.testing.assert_array_equal(got0[:, [1, 4]], CRAFTED[:, [1, 4]])
