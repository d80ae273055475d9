"""The serving slice end to end: one JAX checkpoint and one trace JSON
through the JAX package's ``inference.predict`` and through the port's
``predict`` on the CPU, plain and with each serving option (TTA views,
soft-NMS, ycal, refine, synthesis, ttopt with and without its gate,
extent slack, qscore with and without its gate); the port's CLI with every
flag; no silent CPU fallback; and the port's import hygiene."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import inference as jax_inference
from room_slam_torch import resolve_device
from room_slam_torch.data import formats
from room_slam_torch.inference import predict
from room_slam_torch.predictor import build_predictor
from room_slam_torch.tools import calibrate as tcalibrate
from room_slam_torch.tools import qscore as tqscore
from room_slam_torch.tools import realbench as trealbench
from room_slam_torch.train.driver import load_model_for_inference
from room_slam_tpu.config import ExperimentConfig
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.train.checkpoint import save_checkpoint
from room_slam_tpu.train.driver import \
    load_model_for_inference as jax_load_model

REPO = Path(__file__).resolve().parents[1]
MAX_LEN = 64


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A small flagship-shaped checkpoint with noise on every leaf (so the
    refine stages are not the identity) and a seeded walk trace."""
    d = tmp_path_factory.mktemp("serve")
    cfg = ExperimentConfig.from_json(REPO / "configs/flagship_v15.json")
    cfg.model.d_model, cfg.model.num_queries = 32, 8
    cfg.model.use_pallas_rnn = False
    cfg.data.max_trace_len = MAX_LEN
    params = init_params(build_model(cfg.model), cfg.model, seq_len=MAX_LEN)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)
    save_checkpoint(d / "best_model", params, config=cfg)

    n = 100   # downsampled to MAX_LEN
    pos = np.cumsum(rng.normal(size=(n, 3)) * [0.3, 0.02, 0.3], axis=0)
    rows = [{"timestamp": 0.05 * i, "x": float(p[0]), "y": float(p[1]),
             "z": float(p[2])} for i, p in enumerate(pos)]
    trace = d / "trace.json"
    trace.write_text(json.dumps(rows))
    return d / "best_model", trace


QSCORE = str(REPO / "results" / "r5_qscore_multi.json")
CASES = {
    "threshold": dict(confidence_threshold=0.1, nms_threshold=0.3),
    "consensus_topk_fuse": dict(confidence_threshold=0.0, nms_threshold=0.2,
                                consensus=True, top_k=5, fuse=True),
    "tta_rotations": dict(confidence_threshold=0.1, tta_rotations=True),
    "tta_reflect": dict(confidence_threshold=0.1, tta_rotations=True,
                        tta_reflect=True, fuse=True),
    "tta_scales": dict(confidence_threshold=0.05, tta_rotations=True,
                       tta_reflect=True, tta_scales=(0.9, 1.1), fuse=True,
                       consensus=True, top_k=15),
    "soft": dict(confidence_threshold=0.05, nms_threshold=0.5,
                 soft_sigma=0.25),
    "ycal": dict(confidence_threshold=0.1, y_planes=(0.0, 3.6)),
    "refine_furniture": dict(confidence_threshold=0.1, refine_clearance=0.3,
                             refine_trust=1.5, refine_furniture=True),
    "synth_walls": dict(confidence_threshold=0.05, synth_walls=True),
    "synth_furniture_v1": dict(confidence_threshold=0.05,
                               synth_furniture=True),
    "synth_furniture_v2": dict(confidence_threshold=0.05,
                               synth_furniture="v2", y_planes=(0.0, 3.6)),
    "ttopt": dict(confidence_threshold=0.1, ttopt=True),
    "ttopt_auto_fires": dict(confidence_threshold=0.1, ttopt=True,
                             ttopt_params={"deadband": 0.25,
                                           "auto": "above"}),
    "ttopt_auto_skips": dict(confidence_threshold=0.1, ttopt=True,
                             ttopt_params={"deadband": 0.25,
                                           "auto": "below"}),
    "extent_slack": dict(confidence_threshold=0.0, nms_threshold=0.5,
                         tta_rotations=True, tta_reflect=True,
                         extent_slack=0.3),
    "qscore": dict(confidence_threshold=0.0, nms_threshold=0.5,
                   tta_rotations=True, qscore=QSCORE),
    "qscore_auto_fires": dict(confidence_threshold=0.0, nms_threshold=0.5,
                              tta_rotations=True, qscore=QSCORE,
                              qscore_auto="above"),
    "qscore_auto_skips": dict(confidence_threshold=0.0, nms_threshold=0.5,
                              tta_rotations=True, qscore=QSCORE,
                              qscore_auto="below"),
}


def _max_conf(ckpt, trace, kw):
    """The auto gates' signal on the served trace: the largest raw
    candidate confidence over the case's views (port model)."""
    model, _ = load_model_for_inference(str(ckpt), device="cpu")
    views = {k: kw[k] for k in ("tta_rotations", "tta_reflect", "tta_scales")
             if k in kw}
    pa = build_predictor(model, max_trace_len=MAX_LEN, device="cpu",
                         verbose=False, **views)
    with torch.no_grad():
        out = model(*pa.prepare(formats.load_trace_json(trace)))
    conf = torch.softmax(out["pred_classes"], -1).amax(-1) * torch.sigmoid(
        out["pred_objectness"])
    return float(conf.max())


def _resolve_taus(kw, tau):
    """'above' / 'below' stand for a tau just above or below the served
    trace's max confidence, so the gate fires or does not."""
    kw = dict(kw)
    pick = {"above": tau + 0.01, "below": tau - 0.01}
    if "ttopt_params" in kw:
        tp = dict(kw["ttopt_params"])
        tp["auto"] = pick[tp["auto"]]
        kw["ttopt_params"] = tp
    if isinstance(kw.get("qscore_auto"), str):
        kw["qscore_auto"] = pick[kw["qscore_auto"]]
    return kw


def _values(c):
    return [c["confidence"], *c["center"].values(), *c["size"].values()]


def _assert_same(got, ref):
    assert [c["label"] for c in got] == [c["label"] for c in ref]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        np.testing.assert_allclose(_values(g), _values(r), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_predict_matches_jax(served, case):
    ckpt, trace = served
    kw = _resolve_taus(CASES[case], _max_conf(ckpt, trace, CASES[case]))
    jmodel, jparams, _ = jax_load_model(str(ckpt))
    ref = jax_inference.predict(jmodel, jparams, str(trace),
                                max_trace_len=MAX_LEN, **kw)
    model, cfg = load_model_for_inference(str(ckpt), device="cpu")
    assert cfg.data.max_trace_len == MAX_LEN
    got = predict(model, str(trace), max_trace_len=MAX_LEN, device="cpu",
                  **kw)
    assert len(ref) > 1
    _assert_same(got, ref)
    if case.endswith(("_fires", "_skips")):
        # the gate went the way its tau says: the same answer as the pass
        # always on (fires) or off (skips)
        plain = {k: v for k, v in kw.items() if k != "qscore_auto"}
        if "ttopt_params" in plain:
            plain["ttopt_params"] = {"deadband": 0.25}
        if case.endswith("_skips"):
            plain.pop("ttopt", None)
            plain.pop("ttopt_params", None)
            plain.pop("qscore", None)
        same = predict(model, str(trace), max_trace_len=MAX_LEN,
                       device="cpu", **plain)
        _assert_same(got, same)


def test_cli_writes_collider_json(served, tmp_path):
    ckpt, trace = served
    out = tmp_path / "preds.json"
    proc = subprocess.run(
        [sys.executable, "-m", "room_slam_torch.inference",
         "--checkpoint", str(ckpt), "--input", str(trace),
         "--output", str(out), "--threshold", "0.1", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    data = json.loads(out.read_text())
    model, _ = load_model_for_inference(str(ckpt), device="cpu")
    direct = predict(model, str(trace), max_trace_len=MAX_LEN,
                     confidence_threshold=0.1, device="cpu")
    assert data["metadata"]["num_colliders"] == len(direct) > 0
    assert [c["label"] for c in data["colliders"]] == \
        [c["label"] for c in direct]


def test_cli_takes_every_serving_flag(served, tmp_path):
    """One run with every flag of the root ``inference.py``, against the
    same options through ``predict``."""
    ckpt, trace = served
    out = tmp_path / "preds.json"
    flags = ["--threshold", "0.05", "--nms", "0.5", "--tta", "--tta_reflect",
             "--tta_scales", "0.9,1.1", "--soft", "0.25", "--ycal",
             "0.0,3.6", "--refine", "0.3", "--refine_trust", "0.5",
             "--refine_furniture", "--synth_walls", "--synth_furniture",
             "v2", "--ttopt", "--ttopt_params",
             '{"deadband": 0.25, "auto": 0.9}', "--extent_slack", "1.0",
             "--qscore", QSCORE, "--qscore_auto", "0.9", "--fuse",
             "--consensus", "--top_k", "12"]
    proc = subprocess.run(
        [sys.executable, "-m", "room_slam_torch.inference",
         "--checkpoint", str(ckpt), "--input", str(trace),
         "--output", str(out), "--device", "cpu", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(out.read_text())["colliders"]
    model, _ = load_model_for_inference(str(ckpt), device="cpu")
    direct = predict(
        model, str(trace), max_trace_len=MAX_LEN, confidence_threshold=0.05,
        nms_threshold=0.5, tta_rotations=True, tta_reflect=True,
        tta_scales=(0.9, 1.1), soft_sigma=0.25, y_planes=(0.0, 3.6),
        refine_clearance=0.3, refine_trust=0.5, refine_furniture=True,
        synth_walls=True, synth_furniture="v2", ttopt=True,
        ttopt_params={"deadband": 0.25, "auto": 0.9}, extent_slack=1.0,
        qscore=QSCORE, qscore_auto=0.9, fuse=True, consensus=True, top_k=12,
        device="cpu")
    assert 0 < len(got) <= 12
    _assert_same(got, direct)


def test_ycal_spec_matches_jax(tmp_path):
    from room_slam_torch.inference import _ycal

    cols = tmp_path / "colliders.json"
    cols.write_text(json.dumps({"colliders": [
        {"center": {"x": 0, "y": 1.8, "z": 0},
         "size": {"x": 4, "y": 3.7, "z": 0.1}}]}))
    for spec in (None, "", "0.0,3.6", "-0.25,3.5", str(cols)):
        assert _ycal(spec) == jax_inference._ycal(spec), spec


def test_entry_points_raise_without_card(served, monkeypatch):
    """Without a card, every entry point called without device= raises
    instead of running on the CPU."""
    ckpt, trace = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, _ = load_model_for_inference(str(ckpt), device="cpu")
    calls = [
        lambda: resolve_device(),
        lambda: load_model_for_inference(str(ckpt)),
        lambda: build_predictor(model, max_trace_len=MAX_LEN),
        lambda: predict(model, str(trace), max_trace_len=MAX_LEN),
        lambda: tcalibrate._forward_val_set(str(ckpt), str(trace.parent),
                                            2),
        lambda: tcalibrate.sweep({}, [0.5], [0.3], [None]),
        lambda: trealbench.run(str(ckpt), [str(trace.parent)],
                               {"threshold": 0.5, "nms": 0.3}),
        lambda: tqscore.fit([{"checkpoint": str(ckpt),
                              "data_dir": str(trace.parent)}]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "room_slam_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    # the training, scale-up and legacy slices' modules and the tools are
    # among those checked
    training = {"ops/hungarian.py", "ops/losses.py", "data/augment.py",
                "data/dataset.py", "data/rooms.py", "train/loop.py",
                "train/metrics.py", "train/__main__.py",
                "utils/logging.py", "models/gru.py", "ops/gru_cuda.py",
                "models/legacy_gru.py", "models/baseline.py",
                "data/legacy.py", "evaluate.py", "ops/iou.py",
                "ops/rnn.py", "ops/rnn_cuda.py", "tools/__init__.py",
                "tools/bench_bigru_bwd.py", "ops/refine.py", "ops/ttopt.py",
                "ops/qscore.py", "native/__init__.py",
                "native/trace_parser.py", "predictor.py", "inference.py",
                "data/prng.py", "data/synthetic.py", "demo.py",
                "models/transformer.py", "train/torch_import.py",
                "tools/parity.py", "train/driver.py", "models/factory.py",
                "utils/profiling.py", "tools/profile_scaleup.py",
                "tools/profile_scaleup2.py", "tools/calibrate.py",
                "tools/realbench.py", "tools/qscore.py", "tools/blindcal.py",
                "tools/ceiling.py", "tools/diagnose_zeroshot.py",
                "tools/soup.py", "tools/export.py", "data/ingest.py"}
    rel = {str(f.relative_to(REPO / "room_slam_torch")) for f in files[:-1]}
    assert training <= rel, training - rel
    assert len(files) > 30
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in {"jax", "jaxlib", "flax", "optax",
                               "room_slam_tpu"}, f"{f}: imports {mod}"


def test_adapt_features_matches_jax():
    from room_slam_torch.predictor import adapt_features
    from room_slam_tpu.predictor import adapt_features as jax_adapt

    f = np.arange(24, dtype=np.float32).reshape(2, 12)
    for width in (12, 4, 15):
        np.testing.assert_array_equal(adapt_features(f, width),
                                      jax_adapt(f, width))
