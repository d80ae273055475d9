"""Port's featurization, IoU and post-processing against the JAX package on
the same seeded inputs. Features: exact or 1e-6. post_process (hard, soft
and support-ordered NMS): keep masks and labels equal, confidences and
boxes at 1e-6; soft_nms_3d_fused: keep and counts equal, fused boxes and
rescored confidences at rtol 1e-5 / atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.data import features as tfeat
from room_slam_torch.ops import iou as tiou
from room_slam_torch.ops import nms as tnms
from room_slam_tpu.data import features as jfeat
from room_slam_tpu.ops import iou as jiou
from room_slam_tpu.ops import nms as jnms


def _raw(seed=0, B=3, L=50):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(size=(B, L, 3)) * 0.2, axis=1)
    t = np.cumsum(rng.uniform(0.0, 0.1, size=(B, L, 1)), axis=1) + 5.0
    t[:, 7] = t[:, 6]      # a zero dt row exercises the 1e-3 clip
    return np.concatenate([pos, t], -1).astype(np.float32)


def test_featurize_and_trace_stats_match_jax():
    raw = _raw()
    length = np.array([50, 31, 1], np.int32)
    f_t, m_t = tfeat.featurize(torch.from_numpy(raw), torch.from_numpy(length))
    f_j, m_j = jfeat.featurize(jnp.asarray(raw), jnp.asarray(length))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6,
                               atol=1e-6)
    mean_t, scale_t = tfeat.trace_stats(f_t[..., :3], m_t)
    mean_j, scale_j = jfeat.trace_stats(f_j[..., :3], m_j)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scale_t.numpy(), np.asarray(scale_j),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,max_len", [(0, 10), (40, 64), (200, 64)])
def test_process_traces_np_is_exact(n, max_len):
    arr = _raw(seed=n, B=1, L=max(n, 8))[0][:n]
    np.random.default_rng(1).shuffle(arr)           # any input order
    np.testing.assert_array_equal(tfeat.process_traces_np(arr, max_len),
                                  jfeat.process_traces_np(arr, max_len))


def test_iou_giou_matches_jax():
    rng = np.random.default_rng(0)
    b1 = np.concatenate([rng.normal(size=(20, 3)),
                         rng.uniform(0.1, 2.0, size=(20, 3))], -1)
    b2 = b1 + rng.normal(size=(20, 6)) * 0.3
    b2[:, 3:] = np.abs(b2[:, 3:])
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    for got, ref in zip(tiou.iou_giou_3d(torch.from_numpy(b1),
                                         torch.from_numpy(b2)),
                        jiou.iou_giou_3d(jnp.asarray(b1), jnp.asarray(b2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tiou.pairwise_iou_3d(torch.from_numpy(b1), torch.from_numpy(b2)),
        np.asarray(jiou.pairwise_iou_3d(jnp.asarray(b1), jnp.asarray(b2))),
        rtol=1e-6, atol=1e-6)


def _detections(seed, Q=30, C=4, ties=False):
    """Clustered boxes (so NMS suppresses and fuses) and logits."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, 3)) * 2.0
    sizes = rng.uniform(0.3, 1.5, size=(6, 3))
    k = rng.integers(0, 6, size=Q)
    boxes = np.concatenate([centers[k] + rng.normal(size=(Q, 3)) * 0.1,
                            sizes[k] * rng.uniform(0.8, 1.2, (Q, 3))], -1)
    logits = rng.normal(size=(Q, C)) * 2.0
    obj = rng.normal(size=Q)
    if ties:
        # identical rows -> identical confidences; order decides who wins
        logits[5] = logits[9] = logits[17] = logits[2]
        obj[5] = obj[9] = obj[17] = obj[2]
        boxes[[5, 9, 17]] = boxes[2] + 0.01 * np.arange(1, 4)[:, None]
    return (boxes.astype(np.float32), logits.astype(np.float32),
            obj.astype(np.float32))


CASES = {
    "plain": dict(confidence_threshold=0.3, nms_threshold=0.3),
    "objectness": dict(confidence_threshold=0.1, nms_threshold=0.3,
                       objectness=True),
    "consensus": dict(confidence_threshold=0.2, nms_threshold=0.2,
                      consensus=True, objectness=True),
    "top_k": dict(confidence_threshold=0.0, nms_threshold=0.3, top_k=5,
                  objectness=True),
    "fuse": dict(confidence_threshold=0.0, nms_threshold=0.1, fuse=True,
                 return_boxes=True),
    "candidates_scaled": dict(confidence_threshold=0.1, nms_threshold=0.3,
                              candidates=True, conf_scale=True,
                              consensus=True, top_k=7, return_boxes=True),
    "ties": dict(confidence_threshold=0.0, nms_threshold=0.3, ties=True,
                 objectness=True, top_k=8, fuse=True, return_boxes=True),
    "support": dict(confidence_threshold=0.1, nms_threshold=0.3,
                    support=0.25, objectness=True),
    "support_consensus_topk": dict(confidence_threshold=0.0,
                                   nms_threshold=0.2, support=0.5,
                                   consensus=True, top_k=6,
                                   candidates=True),
    "soft": dict(confidence_threshold=0.0, nms_threshold=0.5,
                 soft_sigma=0.25, objectness=True),
    "soft_fuse_topk": dict(confidence_threshold=0.05, nms_threshold=0.5,
                           soft_sigma=0.5, fuse=True, return_boxes=True,
                           top_k=7, objectness=True),
    "soft_consensus_scaled": dict(confidence_threshold=0.0,
                                  nms_threshold=0.4, soft_sigma=0.1,
                                  consensus=True, conf_scale=True,
                                  candidates=True, return_boxes=True),
    "soft_support_ties": dict(confidence_threshold=0.0, nms_threshold=0.5,
                              soft_sigma=0.25, support=0.25, ties=True,
                              objectness=True, fuse=True, return_boxes=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_post_process_matches_jax(case):
    kw = dict(CASES[case])
    boxes, logits, obj = _detections(seed=len(case), ties=kw.pop("ties", 0))
    rng = np.random.default_rng(7)
    extra_t, extra_j = {}, {}
    if kw.pop("objectness", False):
        extra_t["objectness"], extra_j["objectness"] = (
            torch.from_numpy(obj), jnp.asarray(obj))
    if kw.pop("candidates", False):
        cand = rng.uniform(size=len(boxes)) > 0.2
        extra_t["candidate_mask"], extra_j["candidate_mask"] = (
            torch.from_numpy(cand), jnp.asarray(cand))
    if kw.pop("conf_scale", False):
        sc = rng.uniform(0.5, 1.0, size=len(boxes)).astype(np.float32)
        extra_t["conf_scale"], extra_j["conf_scale"] = (
            torch.from_numpy(sc), jnp.asarray(sc))
    got = tnms.post_process(torch.from_numpy(boxes), torch.from_numpy(logits),
                            **kw, **extra_t)
    ref = jnms.post_process(jnp.asarray(boxes), jnp.asarray(logits),
                            **kw, **extra_j)
    assert len(got) == len(ref)
    assert 0 < int(got[0].sum()) < len(boxes)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_nms_tie_order_higher_index_first():
    """Equal scores: the JAX sweep (stable ascending sort, reversed) takes
    the higher index first; the port must keep the same box."""
    boxes = np.tile(np.array([[0, 0, 0, 1, 1, 1]], np.float32), (4, 1))
    scores = np.array([0.5, 0.9, 0.9, 0.1], np.float32)
    mask = np.ones(4, bool)
    keep_t, counts_t, _ = tnms.nms_3d_fused(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(mask), 0.5)
    keep_j, counts_j, _ = jnms.nms_3d_fused(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask), 0.5)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    assert keep_t.tolist() == [False, False, True, False]


@pytest.mark.parametrize("seed,dup,sigma", [(0, 0.5, 0.25), (1, 0.3, 0.5),
                                             (2, 0.7, 0.1)])
def test_soft_nms_matches_jax(seed, dup, sigma):
    boxes, logits, obj = _detections(seed, Q=40)
    scores = (np.exp(logits).max(-1) / np.exp(logits).sum(-1)
              ).astype(np.float32)
    mask = np.random.default_rng(seed).uniform(size=40) > 0.15
    got = tnms.soft_nms_3d_fused(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(mask), dup, sigma)
    ref = jnms.soft_nms_3d_fused(jnp.asarray(boxes), jnp.asarray(scores),
                                 jnp.asarray(mask), dup, sigma)
    keep, counts = np.asarray(ref[0]), np.asarray(ref[1])
    np.testing.assert_array_equal(got[0].numpy(), keep)
    np.testing.assert_array_equal(got[1].numpy(), counts)
    # every masked candidate is kept or absorbed, and some are absorbed
    assert counts.sum() == mask.sum() > keep.sum() > 0
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_soft_nms_stops_early_with_the_reference_result():
    """The sweep reads its stop condition every SOFT_CHECK_EVERY passes;
    a pass with nothing left changes nothing, so every cut gives the same
    result."""
    boxes, logits, _ = _detections(5, Q=33)
    scores = torch.softmax(torch.from_numpy(logits), -1).amax(-1)
    mask = torch.ones(33, dtype=torch.bool)
    args = (torch.from_numpy(boxes), scores, mask, 0.5, 0.25)
    ref = tnms.soft_nms_3d_fused(*args)
    for every in (1, 3, 100):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tnms, "SOFT_CHECK_EVERY", every)
            got = tnms.soft_nms_3d_fused(*args)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
