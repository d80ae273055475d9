"""The capture benchmark on the CPU against the JAX package's:
``forward_captures`` and ``capture_confidence``, ``apply_operating_point``
with every pass (refine, ycal, both syntheses, the ttopt auto gate,
extent, physics and gated learned rescoring, support), the per-capture
flags and their pooling, and ``choose_cell`` by a patched sweep. The
scoring runs (``run``, ``diagnose``) are in ``test_torch_realbench_run.py``.

The post-pass tests hand both packages one cached forward (the JAX
tool's, doctored with noisy GT copies so that they see true positives).
Tolerances: the forward within 1e-4 (the evaluation tests' float32
bound), the confidence gate's signal within 1e-6, the kept detections'
boxes and confidences within 1e-5 with the same labels and captures, the
flags and pooled metrics exact on the same detections.
"""

from unittest import mock

import numpy as np
import pytest

from room_slam_torch.tools import realbench as trb
from room_slam_tpu.tools import calibrate as jcal
from room_slam_tpu.tools import realbench as jrb
from torch_tools_cases import REPO, doctor, rooms, small_checkpoint

QSCORE = str(REPO / "results" / "r5_qscore_multi.json")
HEAVY = {"threshold": 0.0, "nms": 0.3, "refine": 0.3, "trust": 0.6,
         "ycal": [0.0, 2.7], "synth": True, "synthf": "v2",
         "ttopt": {"steps": 5, "deadband": 0.1},
         "extent": 1.0, "consensus": True, "top_k": 10, "fuse": True,
         "support": 0.25, "pen_beta": 1.0, "soft": None,
         "qscore": QSCORE}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("realbench")
    ck = small_checkpoint(d / "a")
    dirs = [rooms(d / "room_a", 3, seed=5), rooms(d / "room_b", 2, seed=6)]
    cached = jrb.forward_captures(ck, dirs, 2, tta=True)
    return {"ckpt": ck, "dirs": dirs, "cached": cached,
            "doctored": doctor(cached, seed=3)}


def test_forward_captures_match_jax(case):
    want = case["cached"]
    got = trb.forward_captures(case["ckpt"], case["dirs"], 2, tta=True,
                               device="cpu")
    assert got["names"] == want["names"]
    assert want["names"][0].startswith("room_a/")
    assert want["names"][-1].startswith("room_b/")
    assert set(got) == set(want)
    for k in set(want) - {"names"}:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("which", ["cached", "doctored"])
def test_capture_confidence_matches_jax(case, which):
    c = case[which]
    np.testing.assert_allclose(trb.capture_confidence(c),
                               jrb.capture_confidence(c), rtol=0, atol=1e-6)
    noobj = {k: v for k, v in c.items() if k != "pred_objectness"}
    np.testing.assert_allclose(trb.capture_confidence(noobj),
                               jrb.capture_confidence(noobj), rtol=0,
                               atol=1e-6)


def _assert_dets(got, want):
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["conf"], want["conf"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("cell", ["heavy", "gates_off"])
def test_apply_operating_point_matches_jax(case, cell):
    """Every pass at once, the auto gates' tau between two captures'
    signals; ``gates_off`` puts both auto gates' tau above
    every capture's signal, so that the gates take the other branch
    (ttopt and qscore on every capture) without the ycal snap."""
    c = case["doctored"]
    sig = np.sort(jrb.capture_confidence(c))
    # between two captures' signals: the gate splits the captures
    tau = float(sig[1] + sig[2]) / 2
    kw = dict(HEAVY, ttopt=dict(HEAVY["ttopt"], auto=tau), qscore_auto=tau)
    if cell == "gates_off":
        kw.update(ttopt={"steps": 5, "auto": float(sig[-1]) + 0.1},
                  qscore_auto=float(sig[-1]) + 0.1, ycal=None,
                  synthf=True, soft=0.25, support=None)
    want = jrb.apply_operating_point(c, kw, refine_furniture=True)
    got = trb.apply_operating_point(c, kw, refine_furniture=True,
                                    device="cpu")
    assert len(want["img"]) > 0
    _assert_dets(got, want)


def test_capture_flags_and_pooling_match_jax(case):
    c = case["doctored"]
    cell = {"threshold": 0.0, "nms": 0.3, "extent": 1.0, "fuse": True}
    dets = trb.apply_operating_point(c, cell, device="cpu")
    n_img = c["pred_boxes"].shape[0]
    g_img, g_flat = np.nonzero(c["gt_valid"])
    gts = {"boxes": c["gt_boxes"][g_img, g_flat],
           "labels": c["gt_labels"][g_img, g_flat], "img": g_img}
    want = jrb._capture_flags(dets, gts, n_img)
    got = trb._capture_flags(dets, gts, n_img)
    assert len(got) == len(want) == n_img
    for g, w in zip(got, want):
        assert g["npred"] == w["npred"] and g["npos"] == w["npos"]
        assert g["flags"].keys() == w["flags"].keys()
        for k in w["flags"]:
            for a, b in zip(g["flags"][k], w["flags"][k]):
                np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for caps in (np.arange(n_img), np.array([1]),
                 rng.integers(0, n_img, n_img)):
        assert trb._pool_metrics(got, caps) == jrb._pool_metrics(want, caps)
    assert jrb._pool_metrics(want, np.arange(n_img))["tp@0.25"] > 0


def test_choose_cell_matches_jax(case):
    """The calibration grid and the pick, with the sweep patched in both
    packages to record its arguments and return a fixed list of cells
    (the real grid is 768 cells)."""
    keys = ("threshold", "nms", "refine", "trust", "synth", "ttopt",
            "extent", "consensus", "top_k", "support", "pen_beta")
    cells = [dict({k: None for k in keys}, threshold=t, **{
        "mAP@0.25": m25, "mAP@0.5": m5}) for t, m25, m5 in
        ((0.0, 0.4, 0.1), (0.3, 0.5, 0.2), (0.5, 0.5, 0.3), (0.7, 0.2, 0.9))]
    calls = {}

    def fake(tag):
        def sweep(cached, **kw):
            calls[tag] = (cached["pred_boxes"].shape, kw)
            return [dict(c) for c in cells]
        return sweep

    ck, d = case["ckpt"], case["dirs"][0]
    with mock.patch.object(jcal, "sweep", fake("jax")):
        want = jrb.choose_cell(ck, d, batch_size=2, tta=True)
    with mock.patch.object(trb, "sweep", fake("torch")):
        got = trb.choose_cell(ck, d, batch_size=2, tta=True, device="cpu")
    assert got == want and want["threshold"] == 0.5
    shape, kw = calls["torch"]
    assert kw.pop("device") == "cpu"
    assert (shape, kw) == calls["jax"]
    assert shape == (3, 48, 6)
