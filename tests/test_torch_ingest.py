"""The port's UDP ingest (``room_slam_torch/data/ingest.py``) against the
JAX package's, and the serving ops' CPU and fake implementations
(``room_slam::bilstm_fwd`` in ``ops/rnn_cuda.py``, ``room_slam::bigru_fwd``
in ``ops/gru_cuda.py``) against the JAX scans.

The wire format is shared: each package's ``replay`` talks to the other's
``record`` on 127.0.0.1, and ``live(device="cpu")`` on a JAX-saved
checkpoint ends on the estimate of the JAX ``build_predictor`` over the
rows it received. The ops at N=17, B=5 hold the JAX scans
(``use_pallas_rnn=False``) at the JAX suite's tolerances: float32 rtol
1e-5 / atol 1e-6, bfloat16 streams rtol 0.05 / atol 0.03."""

import json
import socket
import threading
import time
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch import predictor as torch_predictor
from room_slam_torch.data import formats, ingest
from room_slam_tpu.data import ingest as jax_ingest
from room_slam_tpu.ops.rnn import gru_recurrence_scan, lstm_recurrence_scan

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=0.05, atol=0.03)}
PRED_TOL = dict(rtol=1e-4, atol=1e-4)


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _trace(n, seed):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.normal(size=(n, 3)).astype(np.float32),
        np.cumsum(rng.uniform(0.02, 0.05, size=n)).astype(np.float32)])


@pytest.mark.parametrize("sender,receiver", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_replay_record_between_packages(tmp_path, sender, receiver):
    """replay -> record across the packages: the handedness flip undone by
    the sender and redone by the receiver, the sender's clock kept, so both
    directions give the same rows: the source's positions, its times from
    the first."""
    mods = {"torch": ingest, "jax": jax_ingest}
    src = _trace(25, 0)
    trace_file = tmp_path / "trace.json"
    formats.save_trace_json(trace_file, src)
    port = _free_port()
    result = {}
    th = threading.Thread(target=lambda: result.setdefault(
        "path", mods[receiver].record(out_dir=tmp_path / receiver,
                                      host="127.0.0.1", port=port,
                                      duration=5.0, max_points=len(src))))
    th.start()
    time.sleep(0.3)   # let the socket bind
    n = mods[sender].replay(str(trace_file), host="127.0.0.1", port=port,
                            hz=0)
    th.join(timeout=10)
    assert n == len(src) and not th.is_alive()
    rec = formats.load_trace_json(result["path"])
    np.testing.assert_allclose(rec[:, :3], src[:, :3], atol=1e-6)
    t = src[:, 3].astype(np.float64)
    np.testing.assert_allclose(rec[:, 3], t - t[0], atol=1e-6)


def test_listen_counts():
    port = _free_port()
    result = {}
    th = threading.Thread(target=lambda: result.setdefault(
        "n", ingest.listen("127.0.0.1", port, max_packets=3)))
    th.start()
    time.sleep(0.3)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for i in range(3):
        s.sendto(b'{"x": %d}' % i, ("127.0.0.1", port))
    s.close()
    th.join(timeout=5)
    assert result["n"] == 3


def test_udp_tools_run_without_torch(tmp_path):
    """``listen``, ``record`` and ``replay`` import no torch (the package
    imports it only where a device is resolved): the replay CLI, run as a
    fresh process, sends a trace with ``torch`` never imported."""
    import subprocess
    import sys
    from pathlib import Path

    src = np.column_stack([np.arange(5.0)] * 3 + [np.arange(5.0) * 0.1])
    trace_file = tmp_path / "trace.json"
    formats.save_trace_json(trace_file, src.astype(np.float32))
    code = ("import runpy, sys\n"
            "sys.argv = ['ingest', 'replay', sys.argv[1], '--hz', '0',\n"
            "            '--port', str(int(sys.argv[2]))]\n"
            "runpy.run_module('room_slam_torch.data.ingest',\n"
            "                 run_name='__main__')\n"
            "assert 'torch' not in sys.modules\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(trace_file), str(_free_port())],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "Sent 5 pose packets" in out.stdout


def test_live_matches_jax_predictor(tmp_path):
    """``live(device="cpu")`` fed by ``replay`` over UDP: each refresh runs
    the port's predictor on the rows so far, and the final estimate equals
    the JAX ``build_predictor``'s on the same rows (the sender's times from
    the first, z flipped back)."""
    from room_slam_tpu.config import (DataConfig, ExperimentConfig,
                                      ModelConfig)
    from room_slam_tpu.models.factory import build_model, init_params
    from room_slam_tpu.predictor import build_predictor
    from room_slam_tpu.train.checkpoint import save_checkpoint

    cfg = ExperimentConfig(
        data=DataConfig(max_trace_len=64, max_colliders=8),
        model=ModelConfig(model_type="lstm", d_model=16, num_queries=4,
                          lstm_layers=1, use_pallas_rnn=False,
                          objectness=True))
    model = build_model(cfg.model)
    params = init_params(model, cfg.model, seq_len=64)
    ckpt = tmp_path / "ck" / "best_model"
    save_checkpoint(ckpt, params, config=cfg)
    src = _trace(40, 3)
    trace_file = tmp_path / "trace.json"
    formats.save_trace_json(trace_file, src)

    seen, ready = [], threading.Event()
    build = torch_predictor.build_predictor

    def recording_build(*a, **k):
        predict = build(*a, **k)

        def predict_array(arr):
            seen.append(arr.copy())
            return predict(arr)

        ready.set()
        return predict_array

    port = _free_port()
    out_json = tmp_path / "live.json"
    result = {}
    with mock.patch.object(torch_predictor, "build_predictor",
                           recording_build):
        th = threading.Thread(target=lambda: result.setdefault(
            "preds", ingest.live(str(ckpt), host="127.0.0.1", port=port,
                                 interval=0.2, min_points=10, duration=30.0,
                                 max_points=len(src), output=str(out_json),
                                 threshold=0.0, device="cpu")))
        th.start()
        assert ready.wait(60)
        ingest.replay(str(trace_file), host="127.0.0.1", port=port, hz=0)
        th.join(timeout=60)
    assert not th.is_alive() and seen
    rows = seen[-1]
    t = src[:, 3].astype(np.float64)
    np.testing.assert_array_equal(
        rows, np.column_stack([src[:, :3], t - t[0]]).astype(np.float32))
    ref = build_predictor(model, params, max_trace_len=64,
                          confidence_threshold=0.0, nms_threshold=0.3,
                          verbose=False)(rows)
    got = result["preds"]
    assert [c["label"] for c in got] == [c["label"] for c in ref]
    assert len(got) > 0

    def values(cols):
        return np.array([[c["confidence"], *c["center"].values(),
                          *c["size"].values()] for c in cols])

    np.testing.assert_allclose(values(got), values(ref), **PRED_TOL)
    saved = json.loads(out_json.read_text())
    assert saved["metadata"]["num_colliders"] == len(got)


def _lstm_inputs(B, N, H, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * k).astype(np.float32)
            for s, k in (((B, N, 4 * H), 0.5), ((B, N, 4 * H), 0.5),
                         ((H, 4 * H), 0.1), ((H, 4 * H), 0.1))]


def _gru_inputs(B, N, H, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * k).astype(np.float32)
            for s, k in (((B, N, 3 * H), 0.5), ((B, N, 3 * H), 0.5),
                         ((H, 3 * H), 0.1), ((3 * H,), 0.1),
                         ((H, 3 * H), 0.1), ((3 * H,), 0.1))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_op_matches_jax_scan(dtype):
    xgf, xgb, wf, wb = _lstm_inputs(5, 17, 8, 0)
    T = getattr(torch, dtype)
    ys_f, ys_b = torch.ops.room_slam.bilstm_fwd(
        torch.from_numpy(xgf).to(T), torch.from_numpy(xgb).to(T),
        torch.from_numpy(wf), torch.from_numpy(wb))
    assert ys_f.dtype == ys_b.dtype == T and ys_f.shape == (5, 17, 8)
    jt = getattr(jnp, dtype)
    ref_f = lstm_recurrence_scan(jnp.asarray(xgf, jt), jnp.asarray(wf))
    ref_b = lstm_recurrence_scan(jnp.asarray(xgb, jt), jnp.asarray(wb),
                                 reverse=True)
    for got, ref in ((ys_f, ref_f), (ys_b, ref_b)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bigru_op_matches_jax_scan(dtype):
    xgf, xgb, wf, bf, wb, bb = _gru_inputs(5, 17, 8, 1)
    T = getattr(torch, dtype)
    ys_f, ys_b = torch.ops.room_slam.bigru_fwd(
        torch.from_numpy(xgf).to(T), torch.from_numpy(xgb).to(T),
        *map(torch.from_numpy, (wf, bf, wb, bb)))
    assert ys_f.dtype == ys_b.dtype == T and ys_f.shape == (5, 17, 8)
    jt = getattr(jnp, dtype)
    ref_f = gru_recurrence_scan(jnp.asarray(xgf, jt), jnp.asarray(wf),
                                jnp.asarray(bf))
    ref_b = gru_recurrence_scan(jnp.asarray(xgb, jt), jnp.asarray(wb),
                                jnp.asarray(bb), reverse=True)
    for got, ref in ((ys_f, ref_f), (ys_b, ref_b)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_ops_opcheck(dtype):
    """``torch.library.opcheck``: the schema, the fake implementation's
    shapes and dtypes against the CPU implementation's, and the
    dispatcher's view of both ops."""
    opcheck = getattr(torch.library, "opcheck", None)
    if opcheck is None:
        pytest.skip("this torch has no torch.library.opcheck")
    T = getattr(torch, dtype)
    lstm = [torch.from_numpy(a) for a in _lstm_inputs(2, 5, 8, 2)]
    gru = [torch.from_numpy(a) for a in _gru_inputs(2, 5, 8, 3)]
    lstm[:2] = [t.to(T) for t in lstm[:2]]
    gru[:2] = [t.to(T) for t in gru[:2]]
    tests = ("test_schema", "test_faketensor")
    opcheck(torch.ops.room_slam.bilstm_fwd.default, lstm, test_utils=tests)
    opcheck(torch.ops.room_slam.bigru_fwd.default, gru, test_utils=tests)


def test_recurrences_dispatch_through_the_ops():
    """Without a gradient the model recurrences call the ops (the served
    and the exported program are one path); under grad they keep their
    autograd ``Function``s."""
    from room_slam_torch.ops import gru_cuda, rnn_cuda

    lstm = [torch.from_numpy(a) for a in _lstm_inputs(2, 5, 8, 4)]
    gru = [torch.from_numpy(a) for a in _gru_inputs(2, 5, 8, 5)]
    calls = []
    real_lstm = rnn_cuda.bilstm_recurrence_plain
    real_gru = gru_cuda.bigru_fwd_plain
    with mock.patch.object(rnn_cuda, "bilstm_recurrence_plain",
                           lambda *t: calls.append("lstm") or real_lstm(*t)), \
            mock.patch.object(gru_cuda, "bigru_fwd_plain",
                              lambda *t: calls.append("gru") or real_gru(*t)):
        with torch.no_grad():
            rnn_cuda.bilstm_recurrence(*lstm)
            gru_cuda.bigru_recurrence(*gru)
        assert calls == ["lstm", "gru"]
        ys, _ = rnn_cuda.bilstm_recurrence(
            *[t.requires_grad_(True) for t in lstm])
        assert ys.grad_fn is not None
    from torch.fx.experimental.proxy_tensor import make_fx

    graph = make_fx(lambda *t: rnn_cuda.bilstm_recurrence(*t))(
        *[t.detach() for t in lstm])
    targets = [n.target for n in graph.graph.nodes if n.op == "call_function"]
    assert torch.ops.room_slam.bilstm_fwd.default in targets
