"""The port's test-time adaptation (``room_slam_torch/ops/ttopt.py``)
against the JAX package's: ``penetration_depth`` within 1e-6; the physics
loss's gradient at ties of ``minimum``, ``abs``, ``relu`` and ``amin``
against ``jax.grad``; ``adapt_boxes`` (150 Adam steps) within atol 1e-4 m
at its defaults and with ``deadband``, ``w_att_faces`` and ``w_att_min``
on, on the JAX suite's crafted trace and boxes and a seeded walk; and the
JAX suite's own checks of the port on its symmetric trace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def test_penetration_depth_matches_jax():
    for raw, boxes, L in ((_grid_trace(n=30), CRAFTED, 900),
                          (_walk(300, 1), _walk_boxes(1), 211)):
        got = tt.penetration_depth(torch.from_numpy(boxes),
                                   torch.from_numpy(raw), L)
        ref = jt.penetration_depth(jnp.asarray(boxes), jnp.asarray(raw),
                                   jnp.asarray(L))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
        assert (np.asarray(ref) > 0).any()


PARAMS = {
    "defaults": {},
    "deadband": dict(deadband=0.25),
    "att_faces": dict(w_att_faces=0.5, att_mass=1.0),
    "att_min": dict(w_att_min=0.5, att_mass=1.0),
    "att_all": dict(w_att=0.3, w_att_faces=0.2, w_att_min=0.2, deadband=0.1,
                    att_mass=1.0),
}


@pytest.mark.parametrize("name", list(PARAMS))
def test_physics_loss_gradient_at_ties_matches_jax(name):
    """Points placed on the ties: ``minimum(dx_in, dz_in)`` equal, ``abs``
    of an exact 0, ``relu`` of an exact 0, two faces at the same nearest
    approach. JAX splits ``minimum`` / ``amin`` ties evenly, gives 0 for
    ``relu`` at 0 and +1 for ``abs`` at 0 (``torch.abs`` gives 0: the port
    takes ``ttopt._abs``)."""
    p = jt.TTOptParams(body_radius=0.25, **PARAMS[name])
    boxes = np.array([[0.0, 1.0, 0.0, 1.0, 2.0, 1.0],
                      [2.0, 1.0, 2.0, 0.5, 2.0, 0.5]], np.float32)
    pts = np.array([[0.25, 0.25], [0.0, 0.5], [0.75, 0.0], [-0.5, -0.5],
                    [0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [2.0, 2.5],
                    [2.5, 2.0], [1.5, 2.0], [3.0, 3.0]], np.float32)
    px, pz = pts[:, 0], pts[:, 1]
    valid = np.ones(len(pts), np.float32)
    ygate = np.ones((2, len(pts)), np.float32)
    extent = (np.float32(-0.5), np.float32(1.0), np.float32(-0.5),
              np.float32(1.0))
    for dc, dls in ((np.zeros((2, 2), np.float32),
                     np.zeros((2, 2), np.float32)),
                    (np.array([[0.0, 0.0], [0.5, -0.5]], np.float32),
                     np.array([[0.0, 0.0], [0.25, 0.0]], np.float32))):
        ref = jax.grad(lambda a, b: jt._physics_loss(
            a, b, jnp.asarray(boxes), jnp.asarray(px), jnp.asarray(pz),
            jnp.asarray(valid), jnp.asarray(ygate),
            tuple(jnp.asarray(e) for e in extent), p), argnums=(0, 1))(
            jnp.asarray(dc), jnp.asarray(dls))
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (dc, dls)]
        loss = tt._physics_loss(
            *leaves, torch.from_numpy(boxes), torch.from_numpy(px),
            torch.from_numpy(pz), torch.from_numpy(valid),
            torch.from_numpy(ygate),
            tuple(torch.tensor(e) for e in extent), tt.TTOptParams(*p))
        got = torch.autograd.grad(loss, leaves)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-6)


def _adapt(boxes, raw, L, **kw):
    got = tt.adapt_boxes(torch.from_numpy(boxes), torch.from_numpy(raw), L,
                         tt.TTOptParams(**kw))
    ref = jt.adapt_boxes(jnp.asarray(boxes), jnp.asarray(raw),
                         jnp.asarray(L, jnp.int32), jt.TTOptParams(**kw))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name", list(PARAMS))
def test_adapt_boxes_crafted_matches_jax(name):
    raw = _grid_trace(n=40)
    got, ref = _adapt(CRAFTED, raw, len(raw), **PARAMS[name])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert np.abs(ref - CRAFTED).max() > 0.05       # the boxes moved


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
