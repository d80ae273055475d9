"""The port's serving export (``room_slam_torch/tools/export.py``) against
its live predictor and the JAX package's StableHLO export, on one JAX-saved
checkpoint (the JAX suite's ``test_export.py`` model: an lstm, d_model 32,
8 queries, 1 layer, exported at max_trace_len 64 with refine 0.3, extent
1.0, top-K 5 and fusion).

The port's artifact reproduces ``predict.run`` (atol 1e-6) and agrees with
the JAX artifact on the same inputs: the same keep and label columns, the
rows within the predictor tolerance of ``test_torch_inference.py`` (rtol
and atol 1e-4). Its graph holds one ``room_slam::bilstm_fwd`` node per
bidirectional layer, so no recurrence was unrolled; a fresh process
without jax serves it through ``run_exported``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from room_slam_torch.tools import export as torch_export

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
POINT = dict(max_trace_len=64, threshold=0.0, nms=0.1, refine=0.3,
             extent=1.0, top_k=5, fuse=True)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One JAX checkpoint through both packages' ``export_checkpoint``."""
    from room_slam_tpu.config import ExperimentConfig, ModelConfig
    from room_slam_tpu.models.factory import build_model, init_params
    from room_slam_tpu.tools import export as jax_export
    from room_slam_tpu.train import checkpoint as ckpt_lib

    tmp = tmp_path_factory.mktemp("export")
    cfg = ExperimentConfig()
    cfg.model = ModelConfig(model_type="lstm", d_model=32, num_queries=8,
                            lstm_layers=1, dropout=0.0, objectness=True,
                            center_xz=True, refine_stages=1,
                            use_pallas_rnn=False)
    params = init_params(build_model(cfg.model), cfg.model, seq_len=64)
    ck = tmp / "ckpt" / "best_model"
    ckpt_lib.save_checkpoint(ck, params, config=cfg)
    meta = torch_export.export_checkpoint(str(ck), str(tmp / "port.pt2"),
                                          device="cpu", **POINT)
    jax_meta = jax_export.export_checkpoint(str(ck), str(tmp / "jax.shlo"),
                                            **POINT)
    rng = np.random.default_rng(0)
    feats = np.asarray(rng.normal(size=(1, 64, 11)), np.float32)
    feats[..., 3] = np.cumsum(np.abs(feats[..., 3]) * 0.03, axis=-1)
    mask = np.ones((1, 64), bool)
    mask[0, 50:] = False
    return dict(tmp=tmp, ck=ck, cfg=cfg, meta=meta, jax_meta=jax_meta,
                feats=feats, mask=mask, jax_export=jax_export)


def test_export_matches_live_run(exported):
    from room_slam_torch.predictor import build_predictor
    from room_slam_torch.train.driver import load_model_for_inference

    model, _ = load_model_for_inference(str(exported["ck"]), device="cpu")
    predict = build_predictor(
        model, max_trace_len=64, confidence_threshold=0.0,
        nms_threshold=0.1, refine_clearance=0.3, refine_furniture=True,
        extent_slack=1.0, top_k=5, fuse=True, device="cpu", verbose=False)
    feats, mask = exported["feats"], exported["mask"]
    live = predict.run(torch.from_numpy(feats), torch.from_numpy(mask))
    served = torch_export.load_exported(str(exported["tmp"] / "port.pt2"),
                                        device="cpu")(feats, mask)
    assert served.shape == live.shape == (8, 9)
    np.testing.assert_allclose(served.numpy(), live.numpy(), atol=1e-6)


def test_export_matches_jax_artifact(exported):
    feats, mask = exported["feats"], exported["mask"]
    got = torch_export.load_exported(str(exported["tmp"] / "port.pt2"),
                                     device="cpu")(feats, mask).numpy()
    ref = np.asarray(exported["jax_export"].load_exported(
        str(exported["tmp"] / "jax.shlo"))(feats, mask))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, 6:8], ref[:, 6:8])
    assert got[:, 6].sum() > 0
    np.testing.assert_allclose(got, ref, **TOL)


def test_sidecar_matches_jax(exported):
    meta, jax_meta = exported["meta"], exported["jax_meta"]
    assert meta.keys() == jax_meta.keys()
    for key in meta.keys() - {"platforms", "bytes"}:
        assert meta[key] == jax_meta[key], key
    assert meta["platforms"] == ["cpu"] and meta["bytes"] > 0
    side = json.loads((exported["tmp"] / "port.json").read_text())
    assert side == meta


def test_graph_holds_one_op_per_layer(exported):
    program = torch.export.load(str(exported["tmp"] / "port.pt2"))
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    ops = [t for t in targets if "room_slam" in str(t)]
    assert ops == [torch.ops.room_slam.bilstm_fwd.default] \
        * exported["cfg"].model.lstm_layers


def test_run_exported_in_fresh_process(exported):
    """``run_exported`` in a new interpreter that never imports jax gives
    the JAX ``run_exported``'s colliders on the same trace file."""
    from room_slam_torch.data import formats

    tmp = exported["tmp"]
    rng = np.random.default_rng(1)
    walk = np.column_stack([
        np.cumsum(rng.normal(size=(90, 3)) * 0.05, axis=0),
        np.cumsum(rng.uniform(0.02, 0.05, size=90))]).astype(np.float32)
    trace = tmp / "trace.json"
    formats.save_trace_json(trace, walk)
    out = tmp / "fresh.json"
    code = ("import json, sys\n"
            "preloaded = 'jax' in sys.modules\n"
            "from room_slam_torch.tools.export import run_exported\n"
            "cols = run_exported(sys.argv[1], sys.argv[2], 'cpu')\n"
            "assert ('jax' in sys.modules) == preloaded\n"
            "assert 'room_slam_tpu' not in sys.modules\n"
            "json.dump(cols, open(sys.argv[3], 'w'))\n")
    subprocess.run([sys.executable, "-c", code, str(tmp / "port.pt2"),
                    str(trace), str(out)], cwd=REPO, check=True,
                   capture_output=True, timeout=120)
    got = json.loads(out.read_text())
    ref = exported["jax_export"].run_exported(str(tmp / "jax.shlo"),
                                              str(trace))
    assert [c["label"] for c in got] == [c["label"] for c in ref]
    assert len(got) > 0

    def values(cols):
        return np.array([[c["confidence"], *c["center"].values(),
                          *c["size"].values()] for c in cols])

    np.testing.assert_allclose(values(got), values(ref), **TOL)


def test_load_exported_refuses_cuda_without_card(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_export.load_exported(str(exported["tmp"] / "port.pt2"))
    with pytest.raises(ValueError, match="platforms"):
        torch_export.export_checkpoint(str(exported["ck"]),
                                       str(exported["tmp"] / "x.pt2"),
                                       platforms=("tpu",), device="cpu")


def test_model_input_dim_matches_jax(exported):
    """``predictor.model_input_dim`` reads the encoder's input width as the
    JAX function reads the checkpoint's ``input_proj`` kernel; a model
    without one takes the default."""
    from room_slam_torch.predictor import model_input_dim
    from room_slam_torch.train.driver import load_model_for_inference
    from room_slam_tpu.predictor import model_input_dim as jax_input_dim
    from room_slam_tpu.train.driver import \
        load_model_for_inference as jax_load

    model, _ = load_model_for_inference(str(exported["ck"]), device="cpu")
    _, params, _ = jax_load(str(exported["ck"]))
    assert model_input_dim(model) == jax_input_dim(params) == 11
    assert model_input_dim(torch.nn.Linear(3, 4), default=7) == \
        jax_input_dim({}, default=7) == 7
