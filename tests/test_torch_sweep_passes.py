"""The calibration sweep's ranking axes and candidate-building passes
(wall refine and its trust window, wall and furniture synthesis, ttopt,
the extent mask) on the CPU against the JAX package's, on one doctored
cached forward handed to both (as ``test_torch_sweep.py``).

Tolerances: the cells in the same order, ``num_predictions`` and ``tp``
equal, mAP and det_f1 within 1e-6, AP per class within its rounding.
"""

import pytest

from room_slam_torch.ops.ttopt import TTOptParams as TParams
from room_slam_torch.tools import calibrate as tcal
from room_slam_tpu.ops.ttopt import TTOptParams as JParams
from room_slam_tpu.tools import calibrate as jcal
from torch_tools_cases import assert_cells, doctor, rooms, small_checkpoint

GRIDS = {
    "rank": dict(thresholds=[0.0], nms_vals=[0.3], refine_vals=[None],
                 consensus_vals=[False, True], top_k_vals=[None, 5],
                 fuse_vals=[True]),
    "synth": dict(thresholds=[0.0], nms_vals=[0.3], refine_vals=[None, 0.3],
                  synth_vals=[False, True], synthf_vals=[False, "v1", "v2"],
                  refine_furniture=True),
    "refine_ttopt": dict(thresholds=[0.0], nms_vals=[0.3],
                         refine_vals=[0.55], trust_vals=[0.4, 0.8],
                         ttopt_vals=[False, True], extent_vals=[None, 0.5],
                         ttopt_params=dict(steps=5, deadband=0.1)),
}


@pytest.fixture(scope="module")
def cached(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep_passes")
    out = jcal._forward_val_set(small_checkpoint(d / "a"),
                                rooms(d / "val", 5, seed=4), 2, tta=True)
    return doctor(out, seed=2)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_sweep_passes_match_jax(cached, grid):
    kw = dict(GRIDS[grid])
    tt = kw.pop("ttopt_params", None)
    want = jcal.sweep(cached, ttopt_params=tt and JParams(**tt), **kw)
    got = tcal.sweep(cached, ttopt_params=tt and TParams(**tt),
                     device="cpu", **kw)
    assert_cells(got, want)
    assert max(c["mAP@0.25"] for c in want) > 0.1
