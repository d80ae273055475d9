"""The serving slice end to end: one JAX checkpoint and one trace JSON
through the JAX package's ``inference.predict`` and through the port's
``predict`` on the CPU; the port's CLI; no silent CPU fallback; and the
port's import hygiene."""

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
from room_slam_torch.inference import predict
from room_slam_torch.predictor import build_predictor
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


CASES = {
    "threshold": dict(confidence_threshold=0.1, nms_threshold=0.3),
    "consensus_topk_fuse": dict(confidence_threshold=0.0, nms_threshold=0.2,
                                consensus=True, top_k=5, fuse=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_predict_matches_jax(served, case):
    ckpt, trace = served
    kw = CASES[case]
    jmodel, jparams, _ = jax_load_model(str(ckpt))
    ref = jax_inference.predict(jmodel, jparams, str(trace),
                                max_trace_len=MAX_LEN, **kw)
    model, cfg = load_model_for_inference(str(ckpt), device="cpu")
    assert cfg.data.max_trace_len == MAX_LEN
    got = predict(model, str(trace), max_trace_len=MAX_LEN, device="cpu",
                  **kw)
    assert len(ref) > 1
    assert [c["label"] for c in got] == [c["label"] for c in ref]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        vals = lambda c: [c["confidence"], *c["center"].values(),  # noqa
                          *c["size"].values()]
        np.testing.assert_allclose(vals(g), vals(r), rtol=1e-4, atol=1e-4)


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
                "tools/bench_bigru_bwd.py"}
    rel = {str(f.relative_to(REPO / "room_slam_torch")) for f in files[:-1]}
    assert training <= rel, training - rel
    assert len(files) > 25
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
