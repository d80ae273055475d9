"""The smaller pieces of the model-selection tools on the CPU against the
JAX package's: ``prng.normal`` and ``ops/qscore.mlp_init``, the quality
fit (``iou_labels``, ``qscore.fit`` against the JAX CLI), ``blindcal``'s
``blind_furniture``, ``ceiling.run`` and ``soup``.

Tolerances: ``prng.normal`` draws the uniform bit for bit, then
``torch.erfinv`` where XLA has a polynomial: relative error 1e-5 (5.7e-6
seen over 100k draws, largest in the tails). The fit: 20 epochs of Adam
in float32 from features that agree to float32 rounding, weights within
1e-5 and AUCs within 1e-3 (one pair of close scores swapping rank moves
an AUC by 1 / (positives x negatives)). Everything else exact.
"""

import json
import shutil
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from room_slam_torch.data import prng
from room_slam_torch.ops import qscore as tqs_ops
from room_slam_torch.tools import blindcal as tblind
from room_slam_torch.tools import calibrate as tcal
from room_slam_torch.tools import ceiling as tceil
from room_slam_torch.tools import qscore as tqs
from room_slam_torch.tools import soup as tsoup
from room_slam_torch.train.checkpoint import (read_msgpack_tree,
                                              write_msgpack_tree)
from room_slam_torch.train.driver import load_model_for_inference
from room_slam_tpu.ops import qscore as jqs_ops
from room_slam_tpu.tools import blindcal as jblind
from room_slam_tpu.tools import calibrate as jcal
from room_slam_tpu.tools import ceiling as jceil
from room_slam_tpu.tools import qscore as jqs
from room_slam_tpu.tools import soup as jsoup
from room_slam_tpu.train.checkpoint import load_checkpoint as jload
from torch_tools_cases import doctor, rooms, small_checkpoint

NORMAL_RTOL = 1e-5


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_small")
    ck = small_checkpoint(d / "a")
    val = rooms(d / "val", 6, seed=9)
    cached = doctor(jcal._forward_val_set(ck, val, 4, tta=True), seed=5)
    return {"dir": d, "ckpt": ck, "val": val, "cached": cached}


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("shape", [(), (7,), (300, 37)])
def test_normal_matches_jax(seed, shape):
    key = jax.random.split(jax.random.key(seed))[1]
    tkey = prng.split(prng.key(seed))[1]
    lo = np.nextafter(np.float32(-1), np.float32(0))
    np.testing.assert_array_equal(
        prng.uniform(tkey, shape, float(lo), 1.0).numpy(),
        np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=1.0)))
    want = np.asarray(jax.random.normal(key, shape))
    got = prng.normal(tkey, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=NORMAL_RTOL, atol=0)


@pytest.mark.parametrize("seed,hidden,n_features", [(0, 16, 18), (3, 8, 5)])
def test_mlp_init_matches_jax(seed, hidden, n_features):
    want = jqs_ops.mlp_init(jax.random.key(seed), hidden, n_features)
    got = tqs_ops.mlp_init(prng.key(seed), hidden, n_features)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=NORMAL_RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("iou", [0.25, 0.5])
def test_iou_labels_match_jax(case, iou):
    want = jqs.iou_labels(case["cached"], iou)
    got = tqs.iou_labels(case["cached"], iou, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("synthf", ["v2"])
def test_qscore_fit_matches_jax_cli(case, tmp_path, synthf):
    """20 epochs on the candidates with the synthesized furniture rows
    appended; the same per-room split, standardization and report."""
    out = tmp_path / "qs.json"
    args = ["--checkpoint", case["ckpt"], "--data_dir", case["val"],
            "--epochs", "20", "--batch_size", "4", "--tta", "--holdout",
            "0.34", "--seed", "2", "--output", str(out)]
    if synthf:
        args += ["--synthf", synthf]
    fake = lambda *a, **k: dict(case["cached"])   # noqa: E731
    with mock.patch.object(jcal, "_forward_val_set", fake), \
            mock.patch.object(sys, "argv", ["qscore", *args]):
        jqs.main()
    want = json.loads(out.read_text())
    with mock.patch.object(tqs, "_forward_val_set", fake):
        got, report = tqs.fit(
            [{"checkpoint": case["ckpt"], "data_dir": case["val"]}],
            synthf=synthf, tta=True, batch_size=4, epochs=20, holdout=0.34,
            seed=2, device="cpu", log=lambda *_: None)
    assert list(got) == list(want)
    for k in ("w1", "b1", "w2", "b2", "mu", "sigma"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    meta_w, meta_g = want.pop("_meta"), got.pop("_meta")
    rep_w, rep_g = meta_w.pop("report"), meta_g.pop("report")
    assert meta_g == meta_w and report == rep_g
    for k, v in rep_w.items():
        assert abs(rep_g[k] - v) <= (1e-3 if "auc" in k else 0), (k, rep_g)
    assert 0 < rep_w["pos_rate"] < 1 and rep_w["holdout_auc"] == \
        rep_w["holdout_auc"]


def test_qscore_cli_writes_fit(case, tmp_path):
    out = tmp_path / "qs.json"
    fake = lambda *a, **k: dict(case["cached"])   # noqa: E731
    with mock.patch.object(tqs, "_forward_val_set", fake):
        tqs.main(["--checkpoint", case["ckpt"], "--data_dir", case["val"],
                  "--epochs", "3", "--device", "cpu", "--output", str(out)])
    params = tqs_ops.load_params(str(out))
    assert params.keys() == {"w1", "b1", "w2", "b2", "mu", "sigma"}
    assert json.loads(out.read_text())["_meta"]["hidden"] == 16


def test_blind_furniture_matches_jax(case):
    want = jblind.blind_furniture(case["cached"])
    got = tblind.blind_furniture(case["cached"])
    assert got.keys() == want.keys()
    for k in want:
        if k == "names":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (want["pred_boxes"] != case["cached"]["pred_boxes"]).any()


def test_ceiling_matches_jax(case, tmp_path):
    dirs = [case["val"], rooms(tmp_path / "b", 2, seed=10)]
    want = jceil.run(dirs, contact_r=0.4, wall_r=0.8)
    assert tceil.run(dirs, contact_r=0.4, wall_r=0.8) == want
    statuses = {b["status"] for c in want["captures"] for b in c["boxes"]}
    assert len(statuses) >= 2
    tceil.main(["--dirs", ",".join(dirs), "--output",
                str(tmp_path / "c.json")])
    assert json.loads((tmp_path / "c.json").read_text()) == \
        json.loads(json.dumps(jceil.run(dirs), default=float))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_soup_matches_jax(case, tmp_path):
    """The same average to 0 as the JAX soup of the same stems; the
    written stem loads in both packages to the same values."""
    d = case["dir"]
    stems = [case["ckpt"]] + [small_checkpoint(d / f"s{i}", seed=10 + i)
                              for i in range(2)]
    want, want_side = jsoup.soup_params(stems)
    got, got_side = tsoup.soup_params(stems)
    assert got_side == want_side
    fw, fg = _flat(want), _flat(got)
    assert fg.keys() == fw.keys()
    for k in fw:
        assert fg[k].dtype == np.float32
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)

    out = tmp_path / "soup"
    tsoup.main([*stems, "--out", str(out)])
    side = json.loads(out.with_suffix(".json").read_text())
    assert side["soup_of"] == stems and side["has_opt_state"] is False
    model, _ = load_model_for_inference(str(out), device="cpu")
    ref, _ = load_model_for_inference(stems[0], device="cpu")
    assert model.state_dict().keys() == ref.state_dict().keys()
    template = {"params": jax.tree_util.tree_map(np.zeros_like,
                                                 want["params"])}
    back, _, _ = jload(out, template)
    fb = _flat(back)
    for k in fw:
        np.testing.assert_array_equal(fb[k], fw[k], err_msg=k)


def test_soup_refusals_match_jax(case, tmp_path):
    stems = [case["ckpt"]]
    for mod in (jsoup, tsoup):
        with pytest.raises(SystemExit, match="at least 2"):
            mod.soup_params(stems)
    # a tree of another shape: one leaf cut
    tree = read_msgpack_tree(Path(case["ckpt"] + ".msgpack").read_bytes())
    node = tree["params"]
    while isinstance(node[next(iter(node))], dict):
        node = node[next(iter(node))]
    name = next(iter(node))
    node[name] = node[name][:-1]
    other = str(tmp_path / "cut")
    Path(other + ".msgpack").write_bytes(write_msgpack_tree(tree))
    shutil.copy(case["ckpt"] + ".json", other + ".json")
    for mod in (jsoup, tsoup):
        with pytest.raises(SystemExit, match="differs from the first"):
            mod.soup_params([case["ckpt"], other])


def test_tool_modules_run_as_scripts():
    """Every ported tool's CLI parses ``--help`` (the module runs as
    ``python -m``)."""
    for mod in (tcal, tblind, tceil, tqs, tsoup):
        with pytest.raises(SystemExit) as e:
            mod.main(["--help"])
        assert e.value.code == 0
