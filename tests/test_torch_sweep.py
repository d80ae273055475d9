"""The calibration sweep on the CPU against the JAX package's, on one
cached forward (the JAX tool's, doctored with noisy GT copies so that AP
and the NMS see true positives, duplicates and ties) handed to both: only
the post-passes differ. One small grid per axis (the JAX sweep compiles
each combination of static arguments): the threshold, NMS and rescoring
axes here; the ranking axes and the candidate-building passes in
``test_torch_sweep_passes.py``.

Tolerances: the cells in the same order, ``num_predictions`` and ``tp``
equal, mAP and det_f1 within 1e-6, AP per class within its rounding.
"""

import pytest

from room_slam_torch.tools import calibrate as tcal
from room_slam_tpu.tools import calibrate as jcal
from torch_tools_cases import (REPO, assert_cells, doctor, rooms,
                               small_checkpoint)

QSCORE = str(REPO / "results" / "r5_qscore_multi.json")

GRIDS = {
    "threshold_nms": dict(thresholds=[0.0, 0.3, 0.5], nms_vals=[0.1, 0.5],
                          refine_vals=[None]),
    "rescore": dict(thresholds=[0.0], nms_vals=[0.5], refine_vals=[None],
                    support_vals=[None, 0.25], pen_vals=[None, 3.0],
                    soft_vals=[None, 0.25]),
    "qscore": dict(thresholds=[0.0], nms_vals=[0.3], refine_vals=[None],
                   qscore_vals=[None, QSCORE], pen_vals=[None, 1.0],
                   iou_thresholds=(0.25,)),
}


@pytest.fixture(scope="module")
def cached(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    out = jcal._forward_val_set(small_checkpoint(d / "a"),
                                rooms(d / "val", 5, seed=4), 2, tta=True)
    return doctor(out, seed=1)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_sweep_matches_jax(cached, grid):
    kw = GRIDS[grid]
    want = jcal.sweep(cached, **kw)
    got = tcal.sweep(cached, device="cpu", **kw)
    assert_cells(got, want)
    assert max(c["mAP@0.25"] for c in want) > 0.1
