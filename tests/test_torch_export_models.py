"""The port's serving export on the other model families and options: a
two-layer ``bigru`` with bfloat16 streams and a ``transformer`` round-trip
against their live ``predict.run`` (atol 1e-6), the bigru's graph holding
one ``room_slam::bigru_fwd`` node per layer; a ``--tta`` artifact (R = 4
views) exports, and its ``--run`` refuses as the JAX tool's does."""

import numpy as np
import pytest
import torch

from room_slam_torch.config import ExperimentConfig, ModelConfig
from room_slam_torch.models.factory import build_model
from room_slam_torch.predictor import build_predictor
from room_slam_torch.tools import export as torch_export
from room_slam_torch.train import checkpoint as ckpt_lib
from room_slam_torch.weights import load_params, random_params

POINT = dict(max_trace_len=48, threshold=0.0, nms=0.1, extent=1.0, top_k=5,
             fuse=True)


def _checkpoint(tmp_path, **model_kw):
    cfg = ExperimentConfig()
    cfg.model = ModelConfig(d_model=16, num_queries=6, dropout=0.0,
                            objectness=True, refine_stages=1, **model_kw)
    model = build_model(cfg.model)
    load_params(model, random_params(model, 0))
    ck = tmp_path / "ckpt" / "best_model"
    ckpt_lib.save_checkpoint(ck, model.state_dict(), config=cfg, model=model)
    return ck, model, cfg


def _inputs(R, seed=0):
    rng = np.random.default_rng(seed)
    feats = np.asarray(rng.normal(size=(R, 48, 11)), np.float32)
    feats[..., 3] = np.cumsum(np.abs(feats[..., 3]) * 0.03, axis=-1)
    mask = np.ones((R, 48), bool)
    mask[:, 40:] = False
    return feats, mask


@pytest.mark.parametrize("model_kw,op", [
    (dict(model_type="bigru", lstm_layers=2, compute_dtype="bfloat16"),
     "bigru_fwd"),
    (dict(model_type="transformer", enc_layers=1, dec_layers=1), None)])
def test_export_round_trip(tmp_path, model_kw, op):
    ck, model, cfg = _checkpoint(tmp_path, **model_kw)
    out = tmp_path / "model.pt2"
    meta = torch_export.export_checkpoint(str(ck), str(out), device="cpu",
                                          **POINT)
    assert meta["model_type"] == cfg.model.model_type
    assert meta["input"] == {"traces": [1, 48, 11], "mask": [1, 48]}
    predict = build_predictor(model, max_trace_len=48,
                              confidence_threshold=0.0, nms_threshold=0.1,
                              refine_furniture=True, extent_slack=1.0,
                              top_k=5, fuse=True, device="cpu",
                              verbose=False)
    feats, mask = _inputs(1)
    live = predict.run(torch.from_numpy(feats), torch.from_numpy(mask))
    served = torch_export.load_exported(str(out), device="cpu")(feats, mask)
    np.testing.assert_allclose(served.numpy(), live.numpy(), atol=1e-6)
    ops = [n.target for n in torch.export.load(str(out)).graph.nodes
           if "room_slam" in str(n.target)]
    want = getattr(torch.ops.room_slam, op).default if op else None
    assert ops == [want] * cfg.model.lstm_layers if op else ops == []


def test_tta_artifact_run_refuses_as_jax(tmp_path):
    """R = 4 views: the program pools the four rotations and matches the
    live run; ``--run`` (one capture-frame row) refuses it with the JAX
    tool's message, which the JAX ``run_exported`` raises from the same
    sidecar before it loads any artifact."""
    from room_slam_torch.data import formats
    from room_slam_tpu.tools.export import run_exported as jax_run

    ck, model, _ = _checkpoint(tmp_path, model_type="lstm", lstm_layers=1)
    out = tmp_path / "tta.pt2"
    meta = torch_export.export_checkpoint(str(ck), str(out), tta=True,
                                          device="cpu", **POINT)
    assert meta["input"]["traces"][0] == 4 and len(meta["views"]) == 4
    predict = build_predictor(model, max_trace_len=48,
                              confidence_threshold=0.0, nms_threshold=0.1,
                              refine_furniture=True, extent_slack=1.0,
                              top_k=5, tta_rotations=True, fuse=True,
                              device="cpu", verbose=False)
    feats, mask = _inputs(4, seed=2)
    live = predict.run(torch.from_numpy(feats), torch.from_numpy(mask))
    served = torch_export.load_exported(str(out), device="cpu")(feats, mask)
    np.testing.assert_allclose(served.numpy(), live.numpy(), atol=1e-6)

    trace = tmp_path / "trace.json"
    formats.save_trace_json(trace, np.column_stack([
        feats[0, :40, :3], np.arange(40) / 30.0]).astype(np.float32))
    with pytest.raises(SystemExit) as got:
        torch_export.run_exported(str(out), str(trace), "cpu")
    with pytest.raises(SystemExit) as ref:
        jax_run(str(out), str(trace))
    assert str(got.value) == str(ref.value)
    assert "R=4" in str(got.value)
