"""The calibration tool's cached forward on the CPU against the JAX
package's: ``window_fractions``, ``TraceColliderArrays.epoch_batches`` and
``_forward_val_set`` (views, temporal windows, checkpoint lists, a
``bigru`` checkpoint), and the CLI against the JAX CLI.

Tolerances: window fractions and batches exact; the cached model outputs
within 1e-4 (the evaluation tests' float32 bound: one float32 model, sums
in another order), names and ground truth exact.
"""

import json
import sys
from unittest import mock

import numpy as np
import pytest

from room_slam_torch.config import DataConfig as TDataConfig
from room_slam_torch.data.dataset import TraceColliderArrays as TArrays
from room_slam_torch.tools import calibrate as tcal
from room_slam_tpu.config import DataConfig as JDataConfig
from room_slam_tpu.data.dataset import TraceColliderArrays as JArrays
from room_slam_tpu.tools import calibrate as jcal
from torch_tools_cases import MAX_LEN, rooms, small_checkpoint

ATOL = 1e-4
EXACT = ("raw", "length", "gt_boxes", "gt_labels", "gt_valid")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("calibrate")
    return {"a": small_checkpoint(d / "a", seed=0),
            "b": small_checkpoint(d / "b", seed=1),
            "noobj": small_checkpoint(d / "noobj", seed=2, objectness=False),
            "bigru": small_checkpoint(d / "bigru", seed=3,
                                      model_type="bigru", d_model=16),
            "val": rooms(d / "val", 5, seed=4),
            "eval": rooms(d / "eval", 3, seed=5)}


def _assert_cached(got, want):
    assert set(got) == set(want)
    assert got["names"] == want["names"]
    for k in EXACT:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in set(want) - set(EXACT) - {"names"}:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("overlap", [0.1, 0.25])
def test_window_fractions_match_jax(n, overlap):
    assert tcal.window_fractions(n, overlap) == \
        jcal.window_fractions(n, overlap)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 0), (True, 3)])
def test_epoch_batches_match_jax(case, augment, shuffle, seed):
    """The same batches in the same order, the ragged last one padded by
    index 0 at weight 0 (5 rooms, x4 rotations when augmenting)."""
    tcfg, jcfg = TDataConfig(), JDataConfig()
    tcfg.max_trace_len = jcfg.max_trace_len = MAX_LEN
    t = TArrays(case["val"], tcfg, augment=augment, verbose=False)
    j = JArrays(case["val"], jcfg, augment=augment, verbose=False)
    got = list(t.epoch_batches(3, seed=seed, shuffle=shuffle))
    want = list(j.epoch_batches(3, seed=seed, shuffle=shuffle))
    assert len(got) == len(want) == -(-j.num_samples // 3)
    assert want[-1]["weight"][-1] == 0.0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


VIEWS = {"plain": {},
         "tta": dict(tta=True, tta_reflect=True, tta_scales=(0.9,),
                     tta_windows=2)}


@pytest.mark.parametrize("views", list(VIEWS))
def test_forward_val_set_matches_jax(case, views):
    """Every view of every (padded) batch, pooled along the query axis:
    16 geometric views x 3 temporal variants x 12 queries with ``tta``."""
    kw = VIEWS[views]
    want = jcal._forward_val_set(case["a"], case["val"], 2, **kw)
    got = tcal._forward_val_set(case["a"], case["val"], 2, device="cpu",
                                **kw)
    _assert_cached(got, want)
    assert want["pred_boxes"].shape == (5, 12 * (48 if kw else 1), 6)


@pytest.mark.parametrize("pair", [("a", "b"), ("a", "noobj")])
def test_forward_checkpoint_list_matches_jax(case, pair):
    """A comma list pools along the query axis; mixed heads drop
    ``pred_objectness``."""
    stems = ",".join(case[p] for p in pair)
    want = jcal._forward_val_set(stems, case["val"], 2)
    got = tcal._forward_val_set(stems, case["val"], 2, device="cpu")
    _assert_cached(got, want)
    assert ("pred_objectness" in got) == (pair[1] != "noobj")
    assert got["pred_boxes"].shape[1] == 2 * 12


def test_forward_bigru_matches_jax(case):
    kw = dict(tta=True, tta_windows=2)
    want = jcal._forward_val_set(case["bigru"], case["val"], 4, **kw)
    got = tcal._forward_val_set(case["bigru"], case["val"], 4, device="cpu",
                                **kw)
    _assert_cached(got, want)


def _cli_json(main, argv, out):
    with mock.patch.object(sys, "argv", ["calibrate", *argv]):
        main()
    return json.loads(out.read_text())


def test_cli_matches_jax(case, tmp_path):
    """The honest protocol: the best cell of a small grid on one
    directory, re-scored on another; the same JSON (every metric of these
    random weights is 0, so the cells are equal)."""
    args = ["--checkpoint", case["a"], "--data_dir", case["val"],
            "--eval_dir", case["eval"], "--batch_size", "2",
            "--thresholds", "0,0.5", "--nms", "0.3", "--refine", "none,0.3"]
    want = _cli_json(jcal.main, [*args, "--output",
                                 str(tmp_path / "j.json")],
                     tmp_path / "j.json")
    tcal.main([*args, "--device", "cpu", "--output",
               str(tmp_path / "t.json")])
    got = json.loads((tmp_path / "t.json").read_text())
    assert got.keys() == want.keys() == {"best", "sweep"}
    assert got == want
