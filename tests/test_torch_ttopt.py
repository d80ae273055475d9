"""The port's test-time adaptation (``room_slam_torch/ops/ttopt.py``)
against the JAX package's: ``penetration_depth`` within 1e-6; the physics
loss's gradient at ties of ``minimum``, ``abs``, ``relu`` and ``amin``
against ``jax.grad``; ``adapt_boxes`` (150 Adam steps) within atol 1e-4 m
at its defaults and with ``deadband``, ``w_att_faces`` and ``w_att_min``
on, on the JAX suite's crafted trace and boxes. The seeded walk, the JAX
suite's own checks on its symmetric trace and serving's
``inference_mode`` are in ``test_torch_ttopt_walk.py``, the gradient's
rounding in ``test_torch_ttopt_rounding.py`` (split so that the test
runner spreads them over workers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import ttopt as tt
from room_slam_tpu.ops import ttopt as jt
from torch_ttopt_cases import (CRAFTED, PARAMS, _adapt, _grid_trace, _walk,
                               _walk_boxes)


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


@pytest.mark.parametrize("name", list(PARAMS))
def test_adapt_boxes_crafted_matches_jax(name):
    raw = _grid_trace(n=40)
    got, ref = _adapt(CRAFTED, raw, len(raw), **PARAMS[name])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert np.abs(ref - CRAFTED).max() > 0.05       # the boxes moved
