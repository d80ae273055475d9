"""The benchmark surface's evaluation on the CPU against the JAX package:
``average_precision_3d`` and ``detection_prf`` on seeded detection rows
(empty classes, equal scores, a GT that two predictions want), and the
port's ``evaluate_benchmark`` and CLI against the root ``evaluate.py`` on
one small checkpoint the JAX package writes.

Tolerances: the host-side AP and PRF equal to 1e-9 (the same assignment
on IoU matrices of one float32 formula); the evaluation's metric sums
within 1e-4 (float32 model outputs summed in another order), mAP within
1e-6.
"""

import argparse
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import evaluate as jax_evaluate
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch import evaluate as tevaluate
from room_slam_torch.evaluate import benchmark_rows, evaluate_benchmark
from room_slam_torch.evaluate import main as eval_cli
from room_slam_torch.train import metrics as tmetrics
from room_slam_tpu.config import ExperimentConfig
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.train import metrics as jmetrics
from room_slam_tpu.train.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
MAX_LEN = 48


def _rows(seed, n_pred=40, n_gt=12, n_img=3, classes=(0, 1, 3)):
    """Detection rows: GT boxes of ``classes`` (class 2 has none), noisy
    copies of some as predictions plus strays; scores from few levels so
    that many are equal; the first two predictions copy GT 0."""
    rng = np.random.default_rng(seed)
    gt = np.concatenate([rng.uniform(-3, 3, (n_gt, 3)),
                         rng.uniform(0.3, 2.0, (n_gt, 3))], 1)
    gl = rng.choice(classes, n_gt)
    gi = rng.integers(0, n_img, n_gt)
    src = rng.integers(0, n_gt, n_pred)
    src[:2] = 0
    pb = gt[src] + rng.normal(0, 0.15, (n_pred, 6)) * [1, 1, 1, .3, .3, .3]
    stray = rng.random(n_pred) < 0.3
    pb[stray, :3] += rng.uniform(-2, 2, (stray.sum(), 3))
    pb[:, 3:] = np.abs(pb[:, 3:]) + 0.05
    pl = np.where(rng.random(n_pred) < 0.8, gl[src], rng.integers(0, 4,
                                                                 n_pred))
    pi = np.where(rng.random(n_pred) < 0.9, gi[src],
                  rng.integers(0, n_img, n_pred))
    ps = rng.choice([0.2, 0.5, 0.5, 0.9], n_pred)
    return (pb.astype(np.float32), pl, ps, pi, gt.astype(np.float32), gl, gi)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou", [0.25, 0.5])
def test_average_precision_matches_jax(seed, iou):
    rows = _rows(seed)
    got, got_c = tmetrics.average_precision_3d(*rows, iou_thresh=iou)
    want, want_c = jmetrics.average_precision_3d(*rows, iou_thresh=iou)
    assert set(got_c) == set(want_c) and 2 not in got_c
    assert abs(got - want) <= 1e-9
    for c in want_c:
        assert abs(got_c[c] - want_c[c]) <= 1e-9, c
    assert want > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_prf_matches_jax(seed):
    rows = _rows(seed)
    got = tmetrics.detection_prf(*rows, iou_thresh=0.25)
    want = jmetrics.detection_prf(*rows, iou_thresh=0.25)
    assert got[3] == want[3] > 0
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-9)


def test_average_precision_edge_cases():
    """No predictions of a class with GT scores 0; no GT of a class leaves
    it out; no rows at all gives 0."""
    pb, pl, ps, pi, gb, gl, gi = _rows(3)
    keep = pl != 1
    rows = (pb[keep], pl[keep], ps[keep], pi[keep], gb, gl, gi)
    for fn in (tmetrics, jmetrics):
        m, aps = fn.average_precision_3d(*rows)
        assert aps[1] == 0.0 and 2 not in aps
    empty = (pb[:0], pl[:0], ps[:0], pi[:0], gb[:0], gl[:0], gi[:0])
    assert tmetrics.average_precision_3d(*empty) == (0.0, {})
    assert tmetrics.detection_prf(*empty) == (0.0, 0.0, 0.0, 0)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A small flagship-shaped JAX checkpoint with noise on every leaf and
    seeded rooms to evaluate on."""
    d = tmp_path_factory.mktemp("evalbench")
    cfg = ExperimentConfig.from_json(REPO / "configs/flagship_v15.json")
    cfg.model.d_model, cfg.model.num_queries = 32, 12
    cfg.model.use_pallas_rnn = False
    cfg.data.max_trace_len = MAX_LEN
    params = init_params(build_model(cfg.model), cfg.model, seq_len=MAX_LEN)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)
    save_checkpoint(d / "best_model", params, config=cfg)
    write_rooms(d / "val", 5, seed=4, points=(120, 200))
    return d


SETTINGS = {"default": dict(iou_thresh=0.5, threshold=0.5, nms=0.3,
                            consensus=False),
            "loose": dict(iou_thresh=0.01, threshold=0.0, nms=0.5,
                          consensus=True)}
PASSES = {"refine": dict(refine=0.3, refine_furniture=False,
                         extent_slack=None),
          "refine_furniture_slack": dict(refine=0.5, refine_furniture=True,
                                         extent_slack=0.3),
          "slack": dict(refine=None, refine_furniture=False,
                        extent_slack=0.0)}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_evaluate_benchmark_matches_jax(bench, name):
    kw = SETTINGS[name]
    args = argparse.Namespace(
        checkpoint=str(bench / "best_model"), data_dir=str(bench / "val"),
        batch_size=2, refine=None, refine_furniture=False, extent_slack=None,
        **kw)
    want = jax_evaluate.evaluate_benchmark(args)
    got = evaluate_benchmark(str(bench / "best_model"), str(bench / "val"),
                             batch_size=2, device="cpu", **kw)
    assert set(got) == set(want)
    for k in ("mIoU", "precision", "recall", "f1", "cls_acc"):
        assert abs(got[k] - want[k]) <= 1e-4, k
    for k in ("tp", "fp", "fn"):
        assert got[k] == want[k], k
    if "mAP" in want:
        assert abs(got["mAP"] - want["mAP"]) <= 1e-6
        assert got["AP_per_class"] == want["AP_per_class"]
        for k in ("det_precision", "det_recall", "det_f1", "det_tp"):
            assert got[k] == want[k], k
    if name == "loose":    # every query kept: the AP and PRF rows exist
        assert "mAP" in want and want["fp"] > 0


def test_evaluate_cli_bench_surface(bench, tmp_path, capsys):
    out = tmp_path / "m.json"
    base = ["--checkpoint", str(bench / "best_model"), "--data_dir",
            str(bench / "val"), "--device", "cpu"]
    eval_cli(base + ["--threshold", "0.05", "--iou_thresh", "0.1",
                     "--batch_size", "3", "--output", str(out)])
    assert "auto-detected surface: bench" in capsys.readouterr().out
    metrics = json.loads(out.read_text())
    assert {"mIoU", "f1", "mAP", "AP_per_class", "det_f1"} <= set(metrics)
    loose = base + ["--threshold", "0.0", "--iou_thresh", "0.01",
                    "--surface", "bench"]
    for flag in (["--extent_slack", "0.3"], ["--refine", "0.5"],
                 ["--refine", "0.5", "--refine_furniture"]):
        out = tmp_path / f"m{len(flag)}{flag[0]}.json"
        eval_cli(loose + [*flag, "--output", str(out)])
        name = {"--extent_slack": "slack"}.get(flag[0], "refine")
        kw = dict(PASSES[name], refine_furniture="--refine_furniture" in flag)
        if flag[0] == "--extent_slack":
            kw["extent_slack"] = 0.3
        if flag[0] == "--refine":
            kw["refine"] = 0.5
        want = evaluate_benchmark(str(bench / "best_model"),
                                  str(bench / "val"), iou_thresh=0.01,
                                  threshold=0.0, device="cpu", **kw)
        assert json.loads(out.read_text()) == json.loads(
            json.dumps(want, default=float))


@pytest.mark.parametrize("name", list(PASSES))
def test_evaluate_benchmark_passes_match_jax(bench, name, monkeypatch):
    """``--refine`` (wall snap before post-processing) and
    ``--extent_slack`` (after NMS) against the root ``evaluate.py``; each
    pass runs once a sample."""
    calls = {"refine_walls": 0, "outside_extent_mask": 0}
    for fn in calls:
        def spy(*a, _fn=getattr(tevaluate, fn), _name=fn, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tevaluate, fn, spy)
    kw = dict(iou_thresh=0.01, threshold=0.0, nms=0.5, consensus=False)
    args = argparse.Namespace(
        checkpoint=str(bench / "best_model"), data_dir=str(bench / "val"),
        batch_size=2, **kw, **PASSES[name])
    want = jax_evaluate.evaluate_benchmark(args)
    got = evaluate_benchmark(str(bench / "best_model"), str(bench / "val"),
                             batch_size=2, device="cpu", **kw,
                             **PASSES[name])
    assert set(got) == set(want)
    for k in ("mIoU", "precision", "recall", "f1", "cls_acc"):
        assert abs(got[k] - want[k]) <= 1e-4, k
    if "mAP" in want:
        assert abs(got["mAP"] - want["mAP"]) <= 1e-6
        assert got["AP_per_class"] == want["AP_per_class"]
        for k in ("det_precision", "det_recall", "det_f1", "det_tp"):
            assert got[k] == want[k], k
    n = len({r[2] for r in benchmark_rows(
        str(bench / "best_model"), str(bench / "val"), batch_size=2,
        device="cpu", **kw)[2]})
    assert calls == {
        "refine_walls": n if PASSES[name]["refine"] is not None else 0,
        "outside_extent_mask": (n if PASSES[name]["extent_slack"]
                                is not None else 0)}
    if name == "slack":     # at slack 0 kept detections are dropped
        kept = [len(benchmark_rows(str(bench / "best_model"),
                                   str(bench / "val"), batch_size=2,
                                   device="cpu", **kw, **extra)[1])
                for extra in ({}, PASSES[name])]
        assert kept[0] > kept[1]
