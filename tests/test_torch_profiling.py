"""The port's profilers on the CPU: ``StepTimer`` against the JAX
package's under one patched clock, ``device_trace``, ``count_parameters``
against the JAX package's on the bridged weights, and both scale-up
profilers (``tools/profile_scaleup.py``, ``tools/profile_scaleup2.py``) at
``--device cpu`` and a tiny ``--seq``: every row of the JAX tools in their
JSON, and the derived rows the stated differences of the measured ones.
"""

import json
from unittest import mock

import jax
import numpy as np
import pytest

from room_slam_torch.config import ModelConfig as TorchModelConfig
from room_slam_torch.models.factory import build_model as torch_build
from room_slam_torch.models.factory import count_parameters
from room_slam_torch.tools import profile_scaleup, profile_scaleup2
from room_slam_torch.utils import profiling
from room_slam_torch.weights import load_params
from room_slam_tpu.config import ModelConfig
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.models.factory import \
    count_parameters as jax_count_parameters
from room_slam_tpu.utils import profiling as jax_profiling


def _clock(ticks):
    it = iter(ticks)
    return lambda: next(it)


@pytest.mark.parametrize("steps, skip", [(5, 2), (2, 3), (4, 0)])
def test_step_timer_matches_jax(steps, skip):
    """The same step lengths give the same summary (the zero case when no
    step is timed)."""
    rng = np.random.default_rng(steps)
    ticks = np.cumsum(rng.uniform(0.01, 0.2, 2 * steps)).tolist()
    summaries = []
    for mod in (profiling, jax_profiling):
        timer = mod.StepTimer(batch_size=8, skip=skip)
        with mock.patch.object(mod.time, "perf_counter", _clock(ticks)):
            for _ in range(steps):
                with timer.step():
                    pass
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert set(summaries[0]) == {"steps", "traces_per_sec", "ms_per_step"}
    assert (summaries[0]["ms_per_step"] == 0.0) == (steps <= skip)


def test_step_timer_syncs_on_a_card(monkeypatch):
    """On a CUDA device the timer synchronises before each clock reading;
    on the CPU it never calls the card."""
    calls = []
    monkeypatch.setattr(profiling.torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    timer = profiling.StepTimer(4, skip=0, device="cuda")
    with timer.step():
        pass
    assert len(calls) == 2
    with profiling.StepTimer(4, device="cpu").step():
        pass
    assert len(calls) == 2


def test_device_trace(tmp_path):
    with profiling.device_trace(None) as prof:
        assert prof is None
    with profiling.device_trace("") as prof:
        assert prof is None
    with profiling.device_trace(tmp_path / "t") as prof:
        import torch
        torch.ones(3).sum()
    assert prof is not None and len(prof.key_averages()) > 0
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("model", [
    dict(model_type="lstm", d_model=32, num_queries=6, lstm_layers=2,
         objectness=True, refine_stages=1),
    dict(model_type="bigru", d_model=32, num_queries=6),
    dict(model_type="transformer", d_model=32, num_queries=6, nhead=2,
         enc_layers=1, dec_layers=1, dim_feedforward=64, moe_experts=2),
])
def test_count_parameters_matches_jax(model):
    cfg = ModelConfig(use_pallas_rnn=False, **model)
    params = jax.device_get(init_params(build_model(cfg), cfg, seq_len=16))
    ported = load_params(torch_build(TorchModelConfig(**model)), params)
    assert count_parameters(ported) == jax_count_parameters(params)


TINY = ["--device", "cpu", "--batch", "1", "--seq", "8"]


def test_profile_scaleup_rows(tmp_path, capsys):
    out = tmp_path / "p1.json"
    profile_scaleup.main(TINY + ["--reps", "1", "--output", str(out)])
    res = json.loads(out.read_text())
    m, d = res["measured_ms"], res["derived"]
    assert set(m) == {f"{k}_ms" for k in (
        "full_step", "fwd_loss", "aug_featurize", "criterion",
        "elementwise_pass", "bigru_fwd_res", "bigru_fwd_nores",
        "bigru_fwdbwd", "gate_matmul")}
    ew = m["elementwise_pass_ms"]
    fwd_res = m["bigru_fwd_res_ms"] - ew
    fwdbwd = m["bigru_fwdbwd_ms"] - ew
    assert d["recurrence_fwd_walk_ms"] == pytest.approx(fwd_res, abs=2e-3)
    assert d["recurrence_bwd_walk_ms"] == pytest.approx(fwdbwd - fwd_res,
                                                        abs=3e-3)
    assert d["residual_store_cost_ms"] == pytest.approx(
        m["bigru_fwd_res_ms"] - m["bigru_fwd_nores_ms"], abs=2e-3)
    assert d["recurrence_total_2layers_ms"] == pytest.approx(2 * fwdbwd,
                                                             abs=4e-3)
    assert d["backward_etc_ms"] == pytest.approx(
        m["full_step_ms"] - m["fwd_loss_ms"], abs=2e-3)
    assert set(d["per_kernel_timestep_us"]) == {"fwd", "fwd_nores", "bwd"}
    assert res["config"]["platform"] == "cpu"


def test_profile_scaleup2_rows(tmp_path, capsys):
    out = tmp_path / "p2.json"
    profile_scaleup2.main(TINY + ["--k", "1", "--kernels", "--output",
                                  str(out)])
    res = json.loads(out.read_text())
    m, d = res["measured_ms"], res["derived"]
    assert set(m) == {"full_step", "grads_only", "fwd_loss", "model_fwd",
                      "model_fwd_bwd", "frontend", "bigru_core_fwd_res",
                      "bigru_core_fwd_nores", "bigru_core_fwdbwd",
                      "dw_einsum_2x", "hprev_build"}
    assert d == profile_scaleup2.derive(m)
    pairs = {"optimizer_ms": ("full_step", "grads_only"),
             "criterion_total_ms": ("grads_only", "model_fwd_bwd"),
             "criterion_fwd_ms": ("fwd_loss", "model_fwd"),
             "model_bwd_ms": ("model_fwd_bwd", "model_fwd"),
             "model_fwd_net_ms": ("model_fwd", "frontend"),
             "core_bwd_walk_ms": ("bigru_core_fwdbwd", "bigru_core_fwd_res"),
             "residual_store_ms": ("bigru_core_fwd_res",
                                   "bigru_core_fwd_nores")}
    for k, (a, b) in pairs.items():
        assert d[k] == pytest.approx(m[a] - m[b], abs=2e-3), k
    assert d["frontend_ms"] == m["frontend"]
    assert res["config"]["k_scan"] == 1
