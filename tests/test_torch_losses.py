"""The port's IoU, matcher and set criterion against the JAX package on
numpy-seeded inputs: IoU values at rtol 1e-6, the Hungarian assignment
exactly, and every loss term with the gradient of ``total_loss`` with
respect to the model outputs at rtol 1e-5 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import iou as iou_t
from room_slam_torch.ops.hungarian import hungarian_match_fast
from room_slam_torch.ops.losses import match_cost, set_criterion
from room_slam_tpu.ops import iou as iou_j
from room_slam_tpu.ops import losses as losses_j
from room_slam_tpu.ops.hungarian import \
    hungarian_match_fast as jax_match_fast

RTOL, ATOL = 1e-5, 1e-6
FLAGSHIP_WEIGHTS = {      # train/loop.py _loss_weight_dict, flagship_v15
    "class_loss": 2.0, "l1_loss": 5.0, "giou_loss": 2.0,
    "footprint_loss": 1.0, "objectness_loss": 1.0, "objectness_iou": 1.0,
    "size_log_loss": 0.5, "aux_loss": 0.5, "coverage_loss": 0.0,
    "coverage_furniture_only": 0.0,
}


def _boxes(rng, *shape):
    c = rng.normal(size=(*shape, 3)) * 2.0
    s = rng.uniform(0.2, 3.0, size=(*shape, 3))
    return np.concatenate([c, s], -1).astype(np.float32)


def test_iou_giou_2d_xz_and_eval_iou_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 7, 5), _boxes(rng, 7, 5)
    b[0] = a[0]                                     # identical pair
    got = iou_t.iou_giou_2d_xz(torch.from_numpy(a), torch.from_numpy(b))
    ref = iou_j.iou_giou_2d_xz(jnp.asarray(a), jnp.asarray(b))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(
        iou_t.eval_pair_iou_3d(torch.from_numpy(a), torch.from_numpy(b))
        .numpy(), np.asarray(iou_j.eval_pair_iou_3d(a, b)), rtol=1e-6,
        atol=1e-7)


MATCH_CASES = {
    "interleaved_invalid": (30, 12, [1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1]),
    "zero_valid": (10, 6, [0] * 6),
    "m_over_q": (5, 9, [1, 1, 0, 1, 1, 1, 0, 1, 1]),
    "all_valid": (8, 8, [1] * 8),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_hungarian_match_fast_matches_jax_exactly(case):
    Q, M, valid = MATCH_CASES[case]
    valid = np.asarray(valid, bool)
    rng = np.random.default_rng(len(case))
    for trial in range(5):
        cost = rng.normal(size=(Q, M)).astype(np.float32)
        rows, matched = hungarian_match_fast(cost, valid)
        jr, jm = jax_match_fast(jnp.asarray(cost), jnp.asarray(valid))
        np.testing.assert_array_equal(rows, np.asarray(jr))
        np.testing.assert_array_equal(matched, np.asarray(jm))
    # the batched form gives the same per item, on tensors
    costs = rng.normal(size=(3, Q, M)).astype(np.float32)
    vb = np.stack([valid, np.roll(valid, 1), valid])
    rows_b, matched_b = hungarian_match_fast(torch.from_numpy(costs),
                                             torch.from_numpy(vb))
    for i in range(3):
        jr, jm = jax_match_fast(jnp.asarray(costs[i]), jnp.asarray(vb[i]))
        np.testing.assert_array_equal(rows_b[i].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(matched_b[i].numpy(), np.asarray(jm))


def _criterion_inputs(seed=0, B=3, Q=10, M=7, C=4, S=2):
    rng = np.random.default_rng(seed)
    outputs = {
        "pred_boxes": _boxes(rng, B, Q),
        "pred_classes": rng.normal(size=(B, Q, C)).astype(np.float32),
        "pred_objectness": rng.normal(size=(B, Q)).astype(np.float32),
        "pred_aux_boxes": _boxes(rng, S, B, Q),
    }
    valid = rng.uniform(size=(B, M)) < 0.7
    valid[0, 0] = True
    labels = rng.integers(0, C, size=(B, M)).astype(np.int32)
    labels[~valid] = -1
    targets = {"boxes": _boxes(rng, B, M), "labels": labels,
               "valid_mask": valid}
    weight = np.ones(B, np.float32)
    weight[-1] = 0.0                                  # batch padding
    return outputs, targets, weight


CRITERION_CASES = {
    "flagship": FLAGSHIP_WEIGHTS,
    "coverage_furniture_only": {**FLAGSHIP_WEIGHTS, "coverage_loss": 0.5,
                                "coverage_furniture_only": 1.0,
                                "objectness_iou": 0.0},
    "reference_terms": losses_j.DEFAULT_WEIGHTS,
}


@pytest.mark.parametrize("case", list(CRITERION_CASES))
def test_set_criterion_and_grad_match_jax(case):
    lw = CRITERION_CASES[case]
    outputs, targets, weight = _criterion_inputs()
    if case == "reference_terms":
        outputs = {k: outputs[k] for k in ("pred_boxes", "pred_classes")}

    t_out = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in outputs.items()}
    t_tgt = {k: torch.from_numpy(v) for k, v in targets.items()}
    got = set_criterion(t_out, t_tgt, torch.from_numpy(weight), lw)
    got["total_loss"].backward()

    j_tgt = {k: jnp.asarray(v) for k, v in targets.items()}

    def total(out):
        res = losses_j.set_criterion(out, j_tgt, jnp.asarray(weight), lw)
        return res["total_loss"], res

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for k in outputs:
        np.testing.assert_allclose(t_out[k].grad.numpy(),
                                   np.asarray(grads[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_match_cost_matches_jax():
    outputs, targets, _ = _criterion_inputs(seed=3)
    got = match_cost(*(torch.from_numpy(x) for x in (
        outputs["pred_boxes"], outputs["pred_classes"], targets["boxes"],
        targets["labels"])))
    ref = losses_j.match_cost(outputs["pred_boxes"], outputs["pred_classes"],
                              targets["boxes"], targets["labels"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
