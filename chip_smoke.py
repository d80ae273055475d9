#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (room_slam_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--requests 5] [--warmup 20]
                          [--window 200]

Phases, one line each or more (a failed check raises; nothing is caught):

1. device: card name, count, and ``nvidia-smi`` name and power limit;
2. build: every kernel source in ``room_slam_torch/csrc``, one ``nvcc`` each,
   all started together (registers and spills from ``-Xptxas -v``);
3. kernel check on the card: ``bilstm_fwd`` against its plain version at
   the bench, serving and a ragged shape; ``bilstm_fwd_train`` (ys, c,
   gates) and ``bilstm_bwd`` (dg) against theirs, and ``BiLSTMFunction``'s
   four gradients against torch autograd through the plain loop, at the
   bench, flagship training and a ragged shape;
4. kernel timing: each kernel, its plain version, the cuDNN yardstick
   (never called by the port) and the roofline bound, at the bench and
   serving shapes (``bilstm_fwd``) or bench and training shapes (the
   training kernels);
5. model: the flagship model (``configs/flagship_v15.json``) at full width
   with seeded random weights, forward at B=32, N=500 through the kernel,
   against the same model through the plain recurrence;
6. serving (a main path): a predictor answers requests on seeded walk
   traces of up to 3000 points (1500 after downsampling), writes collider
   JSON, and one answer is held against the same predictor on the CPU;
7. serving latency: ``--window`` full-length requests after ``--warmup``,
   p50 and p99 over all of them, each request split into its stages on the
   host clock, and the forward and post-process on CUDA events;
8. training (a main path): ``ROOMS`` seeded rooms written as
   trace/collider JSON, ``train_benchmark`` on the flagship config at full
   width for ``EPOCHS`` epochs; finite losses, a checkpoint, and the
   launch counts (two training forwards and two BPTT launches per step,
   light launches only in validation);
9. the checkpoint served: the port's predictor loads the best model and
   answers one request on the card;
10. one-step parity: one train step on the card and the same step on the
    CPU from the same parameters and batch (augmentation off, dropout 0):
    losses, Hungarian assignments and updated parameters agree; and, not
    asserted, how many assignments differ at the unmodified random init;
11. train-step timing at the flagship training shape (B=20, N=1500) and the
    bench shape (B=32, N=500): p50 step ms and traces/s over ``STEPS``
    steps after ``STEP_WARMUP``, then a per-stage mean with a
    synchronise between stages;
12. BiGRU kernel check on the card: ``bigru_fwd`` (ys), ``bigru_fwd_train``
    (ys, gates, hn) and ``bigru_bwd`` (dx, dhn) against their plain
    versions, and ``BiGRUFunction``'s six gradients against torch autograd
    through the plain loop, at the scale-up shape (128, 5000, 256) in bf16,
    (16, 5000, 256) in f32 and (5, 43, 16) in both, with each launch's
    cluster size and batch tile;
13. BiGRU kernel timing at the scale-up shape: each kernel, its plain
    version, torch ``nn.GRU`` (never called by the port), the bound and the
    time per step; then the dW_hh / db_hh products outside the kernels,
    with TF32 off (as the port runs them) and on;
14. scale-up training (a main path): seeded rooms of 5000-7500 points,
    ``train_benchmark`` on the scale-up bigru config (d_model 512, 32
    queries, bf16 streams, B=128, N=5000) for 3 steps; finite losses, a
    checkpoint, launch counts, peak device memory;
15. scale-up serving (a main path): the checkpoint answers one request of
    7500 points with two ``bigru_fwd`` launches; outputs and colliders
    against the same model through the plain recurrence on the card;
16. one scale-up step at B=8 with the kernels and with their plain
    versions patched in, on the card: equal assignments, losses within the
    bf16 tolerance;
17. scale-up train-step timing (B=128, N=5000): p50 over
    ``SCALEUP_STEPS`` after ``SCALEUP_WARMUP``, then the per-stage split.

Then a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from room_slam_torch import resolve_device
from room_slam_torch.config import ExperimentConfig
from room_slam_torch.data import formats
from room_slam_torch.data.dataset import TraceColliderArrays
from room_slam_torch.data.features import featurize
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch.models import gru as gru_mod
from room_slam_torch.models import lstm as lstm_mod
from room_slam_torch.models.factory import build_model
from room_slam_torch.ops import build, gru_cuda, rnn_cuda
from room_slam_torch.ops import losses as losses_mod
from room_slam_torch.predictor import build_predictor
from room_slam_torch.train import loop
from room_slam_torch.train.driver import (load_model_for_inference,
                                          train_benchmark)
from room_slam_torch.weights import load_params, random_params

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "flagship_v15.json"
# H100 SXM published peaks at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
KERNEL_ATOL = 1e-4   # on h, c and gates: f32 sum order over <= 1500 steps
GRAD_REL = 1e-4      # max abs error / max abs reference, the JAX suite's
MODEL_TOL = 1e-3     # rtol and atol on the model outputs (boxes in metres)
LOSS_RTOL = 1e-4     # card vs CPU train step: losses
PARAM_ATOL = 1e-5    # card vs CPU train step: updated parameters
BENCH, SERVE, RAGGED = (32, 500, 64), (1, 1500, 64), (5, 43, 64)
TRAIN = (20, 1500, 64)   # flagship batch_size, max_trace_len, d_model / 2
STEP_SHAPES = ((20, 1500), (32, 500))
ROOMS, EPOCHS = 40, 2        # seeded rooms (1 in 5 for validation), epochs
STEPS, STEP_WARMUP = 50, 5   # train steps timed per shape, after warm-up
# the scale-up bigru config (bench.py bench_scaleup): B, N, d_model / 2
SCALEUP = (128, 5000, 256)
SCALEUP_SETS = ("model.model_type=bigru", "model.d_model=512",
                "model.num_queries=32", "model.compute_dtype=bfloat16",
                "data.max_colliders=32")
GRU_SHAPES = ((SCALEUP, torch.bfloat16), ((16, 5000, 256), torch.float32),
              ((5, 43, 16), torch.float32), ((5, 43, 16), torch.bfloat16))
BF16_RTOL, BF16_ATOL = 0.05, 0.03   # bf16 streams: values (the JAX suite's)
BF16_GRAD_REL = 0.1                 # bf16 streams: gradients, max-rel
SCALEUP_TRAIN_ROOMS, SCALEUP_VAL_ROOMS = 96, 8   # x 4 rotations: 3 steps
SCALEUP_POINTS = (5000, 7500)       # walk length per room, before the cut
SCALEUP_REQUEST = 7500              # points of the served request
SCALEUP_PARITY_B = 8                # batch of the kernel-vs-plain step
SCALEUP_STEPS, SCALEUP_WARMUP = 10, 3   # bench_scaleup's own counts
GRU_PLAIN = {"bigru_fwd_cuda": gru_cuda.bigru_fwd_plain,
             "bigru_fwd_train_cuda": gru_cuda.bigru_fwd_train_plain,
             "bigru_bwd_cuda": gru_cuda.bigru_bwd_plain}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOP_PER_S):
    """Least time in ms for ``nbytes`` moved and ``flops`` operations at
    ``peak`` (f32 by default) on the card, and which of the two sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bilstm_bound(B: int, N: int, H: int):
    """Light forward, both directions: xg read once, W_hh read once, ys
    written once; h @ W_hh, the xg add and the cell update."""
    return bound(4 * 2 * (B * N * 4 * H + H * 4 * H + B * N * H),
                 2 * B * N * (2 * H * 4 * H + 4 * H + 5 * H))


def fwd_train_bound(B: int, N: int, H: int):
    """Training forward: as the light one, and c (H) and the activated
    gates (4H) written once per step."""
    return bound(4 * 2 * (B * N * (4 * H + H + H + 4 * H) + 4 * H * H),
                 2 * B * N * (2 * H * 4 * H + 4 * H + 5 * H))


def bwd_bound(B: int, N: int, H: int):
    """BPTT, both directions: gates (4H), c and dy (2H) read once, dg (4H)
    written once, W_hh read once; per (row, step) the 4H-deep dot product
    for each of H units and 25 operations per unit (coefficients, carries,
    tanh counted as one)."""
    return bound(4 * 2 * (B * N * (4 * H + 2 * H + 4 * H) + 4 * H * H),
                 2 * B * N * (2 * 4 * H * H + 25 * H))


GRU_COLS = {"bigru_fwd": 4, "bigru_fwd_train": 8, "bigru_bwd": 10}


def gru_bound(name: str, B: int, N: int, H: int, dtype: torch.dtype):
    """Both directions: per (row, step) the stream values each kernel must
    read and write (``bigru_fwd`` 3H in + H out; ``bigru_fwd_train`` also
    3H + H of residuals out; ``bigru_bwd`` 3H + H + H + H in, 3H + H out),
    W_hh read once; operations: the h @ W_hh (dg @ W_hh^T) products,
    2 * 3H * H per (row, step), at the peak of the operand type."""
    item = torch.finfo(dtype).bits // 8
    nbytes = 2 * (B * N * GRU_COLS[name] * H + 3 * H * H) * item
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
        else PEAK_F32_FLOP_PER_S
    return bound(nbytes, 2 * B * N * 2 * 3 * H * H, peak)


def gru_inputs(B, N, H, dtype, dev, seed):
    """Seeded BiGRU kernel inputs: gate streams in ``dtype``, W_hh and b_hh
    float32 U(+-1/sqrt(H))."""
    g = np.random.default_rng(seed)
    xs = [torch.tensor(g.normal(size=(B, N, 3 * H)) * 0.5,
                       dtype=torch.float32, device=dev).to(dtype)
          for _ in range(2)]
    ws = [torch.tensor(g.uniform(-1, 1, size=sz) / np.sqrt(H),
                       dtype=torch.float32, device=dev)
          for sz in ((H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    return [*xs, *ws]


def gru_bwd_inputs(ins, seed):
    """``bigru_bwd``'s arguments on the plain training forward's residuals
    of ``ins``, with a seeded upstream gradient in the stream dtype."""
    ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = gru_cuda.bigru_fwd_train_plain(*ins)
    g = torch.Generator(ins[0].device).manual_seed(seed)
    dy_f, dy_b = (torch.randn(ys_f.shape, device=ys_f.device, generator=g
                              ).to(ys_f.dtype) for _ in range(2))
    return ins[2], ins[4], gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b


def value_err(got, ref, dtype) -> float:
    """Max abs error over output pairs; asserts the tolerance of ``dtype``
    (f32: ``KERNEL_ATOL``; bf16: rtol ``BF16_RTOL`` / atol ``BF16_ATOL``)."""
    err = 0.0
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a).all()
        a, b = a.float(), b.float()
        err = max(err, (a - b).abs().max().item())
        if dtype == torch.bfloat16:
            assert torch.allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL), \
                (a - b).abs().max().item()
    if dtype == torch.float32:
        assert err <= KERNEL_ATOL, err
    return err


def plan_text(fn) -> str:
    p = fn.last_launch
    return (f"cluster {p['cluster']} x rows {p['rows']}, {p['clusters']} "
            f"clusters, {p['resident']} resident")


def check_gru_kernels(dev, seed):
    """Phase 12: the three BiGRU kernels against their plain versions and
    ``BiGRUFunction``'s six gradients against torch autograd through the
    plain loop; returns errors by (shape, dtype)."""
    errs = {}
    for shape, dtype in GRU_SHAPES:
        ins = gru_inputs(*shape, dtype, dev, seed)
        light_err = value_err(gru_cuda.bigru_fwd_cuda(*ins),
                              gru_cuda.bigru_fwd_plain(*ins), dtype)
        plans = {"bigru_fwd": plan_text(gru_cuda.bigru_fwd_cuda)}
        train_err = value_err(gru_cuda.bigru_fwd_train_cuda(*ins),
                              gru_cuda.bigru_fwd_train_plain(*ins), dtype)
        plans["bigru_fwd_train"] = plan_text(gru_cuda.bigru_fwd_train_cuda)
        args = gru_bwd_inputs(ins, seed + 1)
        got = gru_cuda.bigru_bwd_cuda(*args)
        plans["bigru_bwd"] = plan_text(gru_cuda.bigru_bwd_cuda)
        ref = gru_cuda.bigru_bwd_plain(*args)
        torch.cuda.synchronize()
        assert all(torch.isfinite(a).all() for a in got), shape
        bwd_abs = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, ref))
        bwd_rel = max(max_rel(a.float(), b.float()) for a, b in zip(got, ref))
        del got, ref
        x = [t.clone().requires_grad_(True) for t in ins]
        dys = [args[5], args[9]]
        grads = torch.autograd.grad(gru_cuda.bigru_recurrence(*x), x, dys)
        ref_grads = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*x), x, dys)
        fn_rel = {name: max_rel(a.float(), b.float()) for name, a, b in zip(
            ("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b", "db_b"), grads,
            ref_grads)}
        del x, grads, ref_grads, args
        key = (shape, dtype)
        errs[key] = {"fwd": light_err, "fwd_train": train_err,
                     "bwd_abs": bwd_abs, "bwd_rel": bwd_rel,
                     "function_rel": fn_rel}
        rel_tol = GRAD_REL if dtype == torch.float32 else BF16_GRAD_REL
        tol = (f"tol {KERNEL_ATOL:.0e}" if dtype == torch.float32 else
               f"tol rtol {BF16_RTOL} atol {BF16_ATOL}")
        log("kernel_check",
            f"B,N,H={shape} {str(dtype)[6:]}: bigru_fwd ys max_abs_err="
            f"{light_err:.3e}, bigru_fwd_train (ys, gates, hn) max_abs_err="
            f"{train_err:.3e} ({tol}); bigru_bwd (dx, dhn) max_abs_err="
            f"{bwd_abs:.3e} max_rel_err={bwd_rel:.3e} tol {rel_tol:g}; "
            "BiGRUFunction vs autograd through the plain loop max_rel_err "
            + " ".join(f"{k}={v:.3e}" for k, v in fn_rel.items())
            + "; launches: " + "; ".join(f"{k} {v}" for k, v in plans.items()))
        assert bwd_rel <= rel_tol, (shape, bwd_rel)
        assert max(fn_rel.values()) <= rel_tol, (shape, fn_rel)
    return errs


def time_gru_kernels(dev, seed, errs):
    """Phase 13: each BiGRU kernel at the scale-up shape in bf16, its plain
    version, torch ``nn.GRU`` (bidirectional, bf16, its input projection
    included; never called by the port) and the bound."""
    B, N, H = SCALEUP
    dtype = torch.bfloat16
    ins = gru_inputs(B, N, H, dtype, dev, seed)
    args = gru_bwd_inputs(ins, seed + 1)
    lib = torch.nn.GRU(2 * H, H, batch_first=True, bidirectional=True).to(
        dev, dtype)
    x = torch.randn(B, N, 2 * H, device=dev, dtype=dtype, requires_grad=True,
                    generator=torch.Generator(dev).manual_seed(seed))
    dy = torch.randn(B, N, 2 * H, device=dev, dtype=dtype,
                     generator=torch.Generator(dev).manual_seed(seed))
    cudnn = torch.backends.cudnn.is_acceptable(x)
    lib_ms = {}
    # cuDNN takes no bf16 RNN (is_acceptable), so nn.GRU in bf16 runs
    # PyTorch's own step loop; cuDNN in fp16 (same bytes per value) is timed
    # beside it
    for key, dt in (("bf16", dtype), ("cudnn_fp16", torch.float16)):
        m = lib.to(dt)
        m.flatten_parameters()
        xi = x.detach().to(dt).requires_grad_(True)
        dyi = dy.to(dt)
        with torch.no_grad():
            light = cuda_ms(lambda: m(xi), 3, warmup=1)
        fwd = cuda_ms(lambda: m(xi), 3, warmup=1)
        fb = cuda_ms(lambda: m(xi)[0].backward(dyi), 3, warmup=1)
        lib_ms[key] = {"bigru_fwd": light, "bigru_fwd_train": fwd,
                       "bigru_bwd": fb - fwd}
    err = errs[(SCALEUP, dtype)]
    rows = {}
    for name, fn, plain, a, e in (
            ("bigru_fwd", gru_cuda.bigru_fwd_cuda, gru_cuda.bigru_fwd_plain,
             ins, err["fwd"]),
            ("bigru_fwd_train", gru_cuda.bigru_fwd_train_cuda,
             gru_cuda.bigru_fwd_train_plain, ins, err["fwd_train"]),
            ("bigru_bwd", gru_cuda.bigru_bwd_cuda, gru_cuda.bigru_bwd_plain,
             args, err["bwd_abs"])):
        ms = cuda_ms(lambda: fn(*a), 3, warmup=1)
        plain_ms = cuda_ms(lambda: plain(*a), 1, warmup=0)
        b = gru_bound(name, B, N, H, dtype)
        rows[name] = {"shape": [B, N, H], "dtype": "bfloat16",
                      "kernel_ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms["bf16"][name],
                      "cudnn_fp16_ms": lib_ms["cudnn_fp16"][name],
                      "bound_us": b[0] * 1e3,
                      "bound_by": b[1], "us_per_step": ms / N * 1e3,
                      "err": e, "launch": dict(fn.last_launch)}
        log("kernel_time", f"{name} " + json.dumps(rows[name]) + (
            "  (library_ms: nn.GRU bidirectional bf16, "
            f"cudnn.is_acceptable={cudnn}; cudnn_fp16_ms: the same in fp16 "
            "through cuDNN; both "
            + {"bigru_fwd": "forward without grad",
               "bigru_fwd_train": "forward with grad on",
               "bigru_bwd": "forward + backward minus forward"}[name]
            + ", includes the input projection)"))
    return rows


def time_hidden_grads(dev, seed):
    """Phase 13, last: dW_hh and db_hh of one direction and layer
    (``gru_cuda.hidden_grads``, four per scale-up step) at the scale-up
    shape from bf16 residuals, with float32 matmuls as the port runs them
    (TF32 off) and, beside it, with TF32 allowed; the flag is restored."""
    B, N, H = SCALEUP
    g = torch.Generator(dev).manual_seed(seed)
    ys, dhn = (torch.randn(B, N, H, device=dev, generator=g).bfloat16()
               for _ in range(2))
    dx = torch.randn(B, N, 3 * H, device=dev, generator=g).bfloat16()
    prev = torch.backends.cuda.matmul.allow_tf32
    row = {"shape": [B, N, H]}
    try:
        for key, tf32 in (("ms", False), ("tf32_ms", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            row[key] = cuda_ms(lambda: gru_cuda.hidden_grads(
                ys, dx, dhn, False, torch.float32), 10, warmup=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    log("kernel_time", "hidden_grads (dW_hh, db_hh of one direction and "
        "layer, outside the kernels) " + json.dumps(row))
    return row


def kernel_inputs(B, N, H, dev, seed):
    g = np.random.default_rng(seed)
    arrs = [g.normal(size=(B, N, 4 * H)) * 0.5,
            g.normal(size=(B, N, 4 * H)) * 0.5,
            g.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H),
            g.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H)]
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def bwd_inputs(ins, seed):
    """The BPTT kernel's arguments on the plain training forward's
    residuals of ``ins``, with a seeded upstream gradient."""
    ys_f, ys_b, cs_f, cs_b, gs_f, gs_b = rnn_cuda.bilstm_fwd_train_plain(*ins)
    g = torch.Generator(ins[0].device).manual_seed(seed)
    dy_f = torch.randn(ys_f.shape, device=ys_f.device, generator=g)
    dy_b = torch.randn(ys_b.shape, device=ys_b.device, generator=g)
    return ins[2], ins[3], gs_f, cs_f, dy_f, gs_b, cs_b, dy_b


def max_rel(a, b) -> float:
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def walk(n: int, seed: int) -> np.ndarray:
    """Seeded room walk: ``[n, 4]`` (x, y, z, t) at 30 Hz."""
    g = np.random.default_rng(seed)
    heading = np.cumsum(g.normal(scale=0.15, size=n))
    step = 0.04 * np.stack([np.cos(heading), np.sin(heading)], -1)
    xz = np.clip(np.cumsum(step, 0), -3.0, 3.0)
    y = 1.6 + 0.02 * g.standard_normal(n)
    t = np.arange(n) / 30.0
    return np.stack([xz[:, 0], y, xz[:, 1], t], -1).astype(np.float32)


def collider_values(c):
    return [c["confidence"], *c["center"].values(), *c["size"].values()]


WRAPPERS = {"bilstm_fwd": (rnn_cuda, "bilstm_fwd_cuda"),
            "bilstm_fwd_train": (rnn_cuda, "bilstm_fwd_train_cuda"),
            "bilstm_bwd": (rnn_cuda, "bilstm_bwd_cuda"),
            "bigru_fwd": (gru_cuda, "bigru_fwd_cuda"),
            "bigru_fwd_train": (gru_cuda, "bigru_fwd_train_cuda"),
            "bigru_bwd": (gru_cuda, "bigru_bwd_cuda")}


def counts():
    return {k: getattr(mod, fn).launches for k, (mod, fn) in WRAPPERS.items()}


def reset_counts() -> None:
    for mod, fn in WRAPPERS.values():
        getattr(mod, fn).launches = 0


def expected_counts(**launched):
    """Every wrapper's count: the given ones, zero for the rest."""
    return {k: launched.get(k, 0) for k in WRAPPERS}


def check_training_kernels(dev, seed):
    """Phase 3 for the training kernels; returns per-shape errors."""
    errs = {}
    for shape in (BENCH, TRAIN, RAGGED):
        ins = kernel_inputs(*shape, dev, seed)
        got = rnn_cuda.bilstm_fwd_train_cuda(*ins)
        ref = rnn_cuda.bilstm_fwd_train_plain(*ins)
        torch.cuda.synchronize()
        assert all(torch.isfinite(a).all() for a in got), shape
        fwd_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        args = bwd_inputs(ins, seed + 1)
        dg = rnn_cuda.bilstm_bwd_cuda(*args)
        dg_ref = rnn_cuda.bilstm_bwd_plain(*args)
        torch.cuda.synchronize()
        assert all(torch.isfinite(a).all() for a in dg), shape
        bwd_abs = max((a - b).abs().max().item() for a, b in zip(dg, dg_ref))
        bwd_rel = max(max_rel(a, b) for a, b in zip(dg, dg_ref))
        x = [t.clone().requires_grad_(True) for t in ins]
        ys = rnn_cuda.bilstm_recurrence(*x)
        dys = [args[4], args[7]]
        grads = torch.autograd.grad(ys, x, dys)
        ref_grads = torch.autograd.grad(
            rnn_cuda.bilstm_recurrence_plain(*x), x, dys)
        fn_rel = {name: max_rel(a, b) for name, a, b in zip(
            ("dxg_f", "dxg_b", "dW_f", "dW_b"), grads, ref_grads)}
        errs[shape] = {"fwd_train": fwd_err, "bwd_abs": bwd_abs,
                       "bwd_rel": bwd_rel, "function_rel": fn_rel}
        log("kernel_check",
            f"bilstm_fwd_train B,N,H={shape} max_abs_err(ys,c,gates)="
            f"{fwd_err:.3e} tol={KERNEL_ATOL:.0e}; bilstm_bwd dg max_abs_err="
            f"{bwd_abs:.3e} max_rel_err={bwd_rel:.3e} tol={GRAD_REL:.0e}; "
            "BiLSTMFunction vs autograd through the plain loop max_rel_err "
            + " ".join(f"{k}={v:.3e}" for k, v in fn_rel.items()))
        assert fwd_err <= KERNEL_ATOL, (shape, fwd_err)
        assert bwd_rel <= GRAD_REL, (shape, bwd_rel)
        assert max(fn_rel.values()) <= GRAD_REL, (shape, fn_rel)
    return errs


def time_training_kernels(dev, seed, errs):
    """Phase 4 for the training kernels; returns one row per kernel and
    shape."""
    rows = {"bilstm_fwd_train": [], "bilstm_bwd": []}
    for shape, iters in ((BENCH, 20), (TRAIN, 10)):
        B, N, H = shape
        ins = kernel_inputs(*shape, dev, seed)
        args = bwd_inputs(ins, seed + 1)
        fwd_ms = cuda_ms(lambda: rnn_cuda.bilstm_fwd_train_cuda(*ins), iters)
        fwd_plain = cuda_ms(lambda: rnn_cuda.bilstm_fwd_train_plain(*ins),
                            2, warmup=1)
        bwd_ms = cuda_ms(lambda: rnn_cuda.bilstm_bwd_cuda(*args), iters)
        bwd_plain = cuda_ms(lambda: rnn_cuda.bilstm_bwd_plain(*args), 2,
                            warmup=1)
        lib = torch.nn.LSTM(2 * H, H, batch_first=True,
                            bidirectional=True).to(dev)
        x = torch.randn(B, N, 2 * H, device=dev, requires_grad=True,
                        generator=torch.Generator(dev).manual_seed(seed))
        dy = torch.randn(B, N, 2 * H, device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
        lib_fwd = cuda_ms(lambda: lib(x), iters)
        lib_fb = cuda_ms(lambda: lib(x)[0].backward(dy), iters)
        for name, ms, plain, b, lib_ms in (
                ("bilstm_fwd_train", fwd_ms, fwd_plain,
                 fwd_train_bound(*shape), lib_fwd),
                ("bilstm_bwd", bwd_ms, bwd_plain, bwd_bound(*shape),
                 lib_fb - lib_fwd)):
            row = {"shape": list(shape), "kernel_ms": ms, "plain_ms": plain,
                   "library_ms": lib_ms, "bound_us": b[0] * 1e3,
                   "bound_by": b[1],
                   "err": (errs[shape]["fwd_train"]
                           if name == "bilstm_fwd_train"
                           else errs[shape]["bwd_abs"])}
            rows[name].append(row)
            log("kernel_time", f"{name} " + json.dumps(row) + (
                "  (library_ms: cuDNN bidirectional nn.LSTM forward with "
                "grad on" if name == "bilstm_fwd_train" else
                "  (library_ms: cuDNN bidirectional nn.LSTM forward + "
                "backward minus forward") + ", includes the input projection)")
    return rows


def make_rooms(root: Path, n_rooms: int, seed: int):
    """``n_rooms`` seeded rooms, one in five for validation."""
    n_val = max(n_rooms // 5, 1)
    write_rooms(root / "train", n_rooms - n_val, seed)
    write_rooms(root / "val", n_val, seed + 1)
    return root / "train", root / "val"


def train_main_path(cfg, train_dir, val_dir, save_dir, epochs, dev, smi,
                    prefix="bilstm"):
    """Phases 8 and 14: the trainer on the card, launch counts read around
    it: two training forwards and two BPTT launches of the ``prefix``
    kernels per step, light launches only in validation, nothing else."""
    cfg = copy.deepcopy(cfg)
    cfg.data.data_dir, cfg.data.val_dir = str(train_dir), str(val_dir)
    cfg.train.num_epochs = epochs
    cfg.train.save_dir = str(save_dir)
    train_ds = TraceColliderArrays(train_dir, cfg.data, augment=True,
                                   verbose=False)
    val_ds = TraceColliderArrays(val_dir, cfg.data, augment=False,
                                 verbose=False)
    steps = epochs * train_ds.num_batches(cfg.train.batch_size)
    val_batches = epochs * val_ds.num_batches(cfg.train.batch_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train_benchmark(cfg, device=dev, verbose=True, train_ds=train_ds,
                          val_ds=val_ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = cfg.model.lstm_layers
    assert launched == expected_counts(**{
        f"{prefix}_fwd": layers * val_batches,
        f"{prefix}_fwd_train": layers * steps,
        f"{prefix}_bwd": layers * steps}), launched
    assert len(res["history"]) == epochs
    for row in res["history"]:
        assert np.isfinite(row["train_loss"]) and \
            np.isfinite(row["val_loss"]), row
    best = Path(save_dir) / "best_model"
    assert best.with_suffix(".msgpack").exists()
    assert json.loads(best.with_suffix(".json").read_text())[
        "has_opt_state"] is False
    log("train", f"{cfg.model.model_type} d_model={cfg.model.d_model} "
                 f"{cfg.model.compute_dtype}: train_benchmark {epochs} epochs of "
                 f"{train_ds.num_samples} samples ({train_ds.n_base} rooms x "
                 f"{len(train_ds.rotation_angles)} rotations), B="
                 f"{cfg.train.batch_size}, N={cfg.data.max_trace_len}: "
                 f"{steps} steps, {val_batches} validation batches in "
                 f"{wall:.1f} s on {smi}; losses "
                 + json.dumps([{k: r[k] for k in ("epoch", "train_loss",
                                                  "val_loss", "mIoU")}
                               for r in res["history"]])
                 + f"; launches {launched}; peak device memory "
                 f"{peak_gb:.2f} GB")
    return launched, best


def serve_checkpoint(best, trace_file, dev):
    """Phase 9: the written checkpoint through the port's predictor."""
    model, cfg = load_model_for_inference(str(best), device=dev)
    predict = build_predictor(model, max_trace_len=cfg.data.max_trace_len,
                              confidence_threshold=0.0, nms_threshold=0.3,
                              device=dev, verbose=False)
    reset_counts()
    cols = predict(formats.load_trace_json(trace_file))
    torch.cuda.synchronize()
    assert counts() == expected_counts(bilstm_fwd=cfg.model.lstm_layers)
    assert len(cols) > 0
    for c in cols:
        assert np.isfinite(collider_values(c)).all()
    log("serve_checkpoint", f"{best.name} served {trace_file.name}: "
                            f"{len(cols)} colliders, labels "
                            f"{sorted(set(c['label'] for c in cols))}")


def assignments(model, host, data_cfg, d):
    """A copy of ``model`` on device ``d``, its Hungarian rows and matched
    mask on the batch ``host`` (on the CPU), and the batch on ``d``."""
    m = copy.deepcopy(model).to(d)
    batch = {k: torch.from_numpy(v).to(d) for k, v in host.items()}
    feats, mask, targets = loop.prepare_batch(batch, data_cfg)
    with torch.no_grad():
        out = m.train()(feats, mask)
        rows, matched = losses_mod.match(
            out["pred_boxes"], out["pred_classes"], targets["boxes"],
            targets["labels"], targets["valid_mask"])
    return m, rows.cpu(), matched.cpu(), batch


def n_moved(rows_a, matched_a, rows_b, matched_b) -> int:
    """Targets whose assignment differs between two matchings."""
    both = matched_a & matched_b
    return int(((matched_a != matched_b) | (both & (rows_a != rows_b))).sum())


def step_parity(cfg, train_dir, dev, seed):
    """Phase 10: one step on the card and on the CPU from the same
    parameters and batch, augmentation off, dropout 0."""
    cfg = copy.deepcopy(cfg)
    cfg.model.dropout = 0.0
    ds = TraceColliderArrays(train_dir, cfg.data, augment=False,
                             verbose=False)
    host = ds.gather(np.arange(cfg.train.batch_size) % ds.num_samples)
    model = build_model(cfg.model)
    params = random_params(model, seed)
    load_params(model, params)
    # At the unmodified init the random queries sit so close together in
    # the match cost that card vs CPU rounding can move an assignment:
    # count how many move, without asserting.
    init_temp = float(params["params"]["decoder"]["inv_temp"])
    init_moved = n_moved(*assignments(model, host, cfg.data, dev)[1:3],
                         *assignments(model, host, cfg.data, "cpu")[1:3])
    # As in phase 5, a sharp attention spreads the queries over the walk,
    # so no two of them tie in the match cost. It also keeps the float32
    # softmax backward well conditioned.
    params["params"]["decoder"]["inv_temp"] = np.float32(100.0)
    load_params(model, params)
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m, rows, matched, batch = assignments(model, host, cfg.data, d)
        opt = loop.make_optimizer(m, cfg)
        step = loop.make_train_step(m, opt, cfg, augment=False)
        losses = step(batch, torch.Generator(d).manual_seed(seed))
        res[name] = ({k: float(v) for k, v in losses.items()},
                     rows, matched,
                     {n: p.detach().cpu() for n, p in m.named_parameters()},
                     {n: p.grad.cpu() for n, p in opt.named})
    (l_gpu, r_gpu, m_gpu, p_gpu, _), (l_cpu, r_cpu, m_cpu, p_cpu, g_cpu) = \
        res["card"], res["cpu"]
    assert torch.equal(r_gpu, r_cpu) and torch.equal(m_gpu, m_cpu)
    loss_rel = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12)
                   for k, v in l_cpu.items())
    scale = max(g.abs().max().item() for g in g_cpu.values())
    live_err, other_err = 0.0, 0.0
    for n, p in p_cpu.items():
        diff = (p_gpu[n] - p).abs()
        live = g_cpu[n].abs() > 1e-5 * scale
        live_err = max(live_err, diff[live].max().item() if live.any()
                       else 0.0)
        other_err = max(other_err, diff.max().item())
    log("step_parity",
        f"card vs CPU at the unmodified init (inv_temp={init_temp:g}), not "
        f"asserted: {init_moved} matched targets assigned differently")
    log("step_parity",
        f"card vs CPU, one step B={cfg.train.batch_size} N="
        f"{cfg.data.max_trace_len}, inv_temp=100: assignments equal "
        f"({int(m_cpu.sum())} matched pairs); losses max_rel_diff="
        f"{loss_rel:.3e} tol={LOSS_RTOL:.0e}; updated params max_abs_diff="
        f"{live_err:.3e} tol={PARAM_ATOL:.0e} where |grad| > 1e-5 of the "
        f"largest, {other_err:.3e} elsewhere (tol 2*lr="
        f"{2 * cfg.train.lr:.0e}: AdamW's first step maps rounding noise "
        "to +-lr)")
    assert loss_rel <= LOSS_RTOL, l_gpu
    assert live_err <= PARAM_ATOL, live_err
    assert other_err <= 2 * cfg.train.lr + PARAM_ATOL, other_err


def scaleup_config():
    """The scale-up config from the default one, as the training CLI's
    ``--set`` builds it, at bench_scaleup's batch and sequence length."""
    cfg = ExperimentConfig().apply_overrides(list(SCALEUP_SETS))
    cfg.train.batch_size, cfg.data.max_trace_len = SCALEUP[0], SCALEUP[1]
    return cfg


def bf16_close(a, b) -> float:
    """Max abs difference; asserts the bf16 tolerance."""
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    assert torch.allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL), \
        (a - b).abs().max().item()
    return (a - b).abs().max().item() if a.numel() else 0.0


def serve_scaleup(best, dev, seed):
    """Phase 15: the scale-up checkpoint served; the answer and the model's
    outputs against the same model through the plain recurrence on the
    card."""
    model, cfg = load_model_for_inference(str(best), device=dev)
    predict = build_predictor(model, max_trace_len=cfg.data.max_trace_len,
                              confidence_threshold=0.0, nms_threshold=0.3,
                              device=dev, verbose=False)
    arr = walk(SCALEUP_REQUEST, seed + 300)
    reset_counts()
    cols = predict(arr)
    torch.cuda.synchronize()
    launched = counts()
    assert launched == expected_counts(bigru_fwd=cfg.model.lstm_layers), \
        launched
    assert len(cols) > 0
    x, m = predict.prepare(arr)
    with torch.inference_mode():
        out = model(x, m)
        with mock.patch.object(gru_mod, "bigru_recurrence",
                               gru_cuda.bigru_fwd_plain):
            ref_out = model(x, m)
            ref = predict(arr)
    out_err = max(bf16_close(out[k], ref_out[k]) for k in out)
    assert [c["label"] for c in cols] == [c["label"] for c in ref]
    col_err = max(bf16_close(collider_values(a), collider_values(b))
                  for a, b in zip(cols, ref))
    log("serve_scaleup",
        f"{best.name} ({cfg.model.model_type} d_model={cfg.model.d_model} "
        f"{cfg.model.compute_dtype}) answered {len(arr)} points "
        f"({min(len(arr), cfg.data.max_trace_len)} after downsampling): "
        f"{len(cols)} colliders; launches {launched} "
        f"({plan_text(gru_cuda.bigru_fwd_cuda)}); vs the plain recurrence "
        f"on the card: outputs max abs diff {out_err:.3e}, colliders "
        f"{col_err:.3e} (rtol {BF16_RTOL} atol {BF16_ATOL}), labels equal")
    return launched


def step_parity_scaleup(cfg, train_dir, dev, seed):
    """Phase 16: one scale-up train step (B=SCALEUP_PARITY_B, bf16) with
    the kernels and with their plain versions patched in, on the card, from
    the same parameters and batch (augmentation off, dropout 0,
    inv_temp 100)."""
    cfg = copy.deepcopy(cfg)
    cfg.model.dropout = 0.0
    cfg.train.batch_size = SCALEUP_PARITY_B
    ds = TraceColliderArrays(train_dir, cfg.data, augment=False,
                             verbose=False)
    host = ds.gather(np.arange(SCALEUP_PARITY_B) % ds.num_samples)
    model = build_model(cfg.model)
    params = random_params(model, seed)
    params["params"]["decoder"]["inv_temp"] = np.float32(100.0)
    load_params(model, params)
    res = {}
    for name, patch in (("kernels", None), ("plain", GRU_PLAIN)):
        reset_counts()
        with (mock.patch.multiple(gru_cuda, **patch) if patch
              else contextlib.nullcontext()):
            m, rows, matched, batch = assignments(model, host, cfg.data, dev)
            opt = loop.make_optimizer(m, cfg)
            step = loop.make_train_step(m, opt, cfg, augment=False)
            losses = step(batch, torch.Generator(dev).manual_seed(seed))
            torch.cuda.synchronize()
        res[name] = ({k: float(v) for k, v in losses.items()}, rows, matched,
                     counts())
    (l_k, r_k, m_k, c_k), (l_p, r_p, m_p, c_p) = res["kernels"], res["plain"]
    layers = cfg.model.lstm_layers
    assert c_k == expected_counts(bigru_fwd=layers, bigru_fwd_train=layers,
                                  bigru_bwd=layers), c_k
    assert c_p == expected_counts(), c_p
    assert torch.equal(r_k, r_p) and torch.equal(m_k, m_p)
    loss_err = max(bf16_close(l_k[k], v) for k, v in l_p.items())
    log("step_parity_scaleup",
        f"one step B={SCALEUP_PARITY_B} N={cfg.data.max_trace_len} "
        f"{cfg.model.compute_dtype}, inv_temp=100, kernels vs plain versions "
        f"on the card: assignments equal ({int(m_p.sum())} matched pairs); "
        f"losses max abs diff {loss_err:.3e} (rtol {BF16_RTOL} atol "
        f"{BF16_ATOL}); " + json.dumps({"kernels": l_k, "plain": l_p}))


def time_steps(cfg, train_dir, dev, seed, smi, kernel_rows, shapes,
               n_steps, n_warmup, prefix):
    """Phases 11 and 17: p50 step time of the trainer's step at each (B, N)
    of ``shapes`` over ``n_steps`` after ``n_warmup``, then a per-stage
    mean with a synchronise between stages; ``kernel_rows`` (phase 4 or
    13) give the ``prefix`` kernels' share."""
    out = []
    for B, N in shapes:
        c = copy.deepcopy(cfg)
        c.train.batch_size, c.data.max_trace_len = B, N
        ds = TraceColliderArrays(train_dir, c.data, augment=True,
                                 verbose=False)
        data = {k: torch.from_numpy(v).to(dev)
                for k, v in ds.device_arrays().items()}
        plan = ds.epoch_plan(B, seed=seed)
        nb = plan["base_idx"].shape[0]
        model = build_model(c.model, generator=torch.Generator()
                            .manual_seed(seed)).to(dev)
        opt = loop.make_optimizer(model, c)
        step = loop.make_train_step(model, opt, c, augment=True)
        gen = torch.Generator(dev).manual_seed(seed)
        batches = [loop.gather_batch(data, plan, i % nb)
                   for i in range(n_steps + n_warmup)]
        ms = []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            losses = step(batch, gen)
            torch.cuda.synchronize()
            if i >= n_warmup:
                ms.append((time.perf_counter() - t0) * 1e3)
            assert np.isfinite(float(losses["total_loss"]))
        p50 = float(np.percentile(ms, 50))

        # per stage, with a synchronise between stages
        lw = loop._loss_weight_dict(c)
        match_ms = []
        match = losses_mod.match

        def timed_match(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = match(*a)
            torch.cuda.synchronize()
            match_ms.append((time.perf_counter() - t) * 1e3)
            return r

        stages = np.zeros((n_steps, 5))
        with mock.patch.object(losses_mod, "match", timed_match):
            for i, batch in enumerate(batches[n_warmup:]):
                t = [time.perf_counter()]
                feats, mask, targets = loop.prepare_batch(batch, c.data, gen)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                model.train()
                opt.zero_grad()
                o = model(feats, mask, generator=gen)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                ls = losses_mod.set_criterion(o, targets, batch["weight"], lw)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                ls["total_loss"].backward()
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                opt.step()
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                stages[i] = np.diff(t) * 1e3
        mean = stages.mean(0)
        m_ms = float(np.mean(match_ms))
        layers = c.model.lstm_layers
        k_ms = {name: next((r["kernel_ms"] for r in rows
                            if r["shape"] == [B, N, c.model.d_model // 2]),
                           None) for name, rows in kernel_rows.items()}
        row = {"B": B, "N": N, "steps": n_steps, "p50_ms": p50,
               "p99_ms": float(np.percentile(ms, 99)),
               "traces_per_s": B / p50 * 1e3,
               "stage_ms": {"augment_featurize": mean[0],
                            "forward": mean[1],
                            "criterion_host_matching": m_ms,
                            "criterion_rest": mean[2] - m_ms,
                            "backward": mean[3], "optimizer": mean[4]},
               "staged_step_ms": float(mean.sum()),
               "fwd_train_kernels_ms": (
                   layers * k_ms[f"{prefix}_fwd_train"]
                   if k_ms.get(f"{prefix}_fwd_train") else None),
               "bwd_kernels_ms": (layers * k_ms[f"{prefix}_bwd"]
                                  if k_ms.get(f"{prefix}_bwd") else None)}
        out.append(row)
        log("train_step", json.dumps(row) + f" on {smi}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=5,
                    help="mixed-size requests of the correctness check")
    ap.add_argument("--warmup", type=int, default=20,
                    help="full-length requests before the latency window")
    ap.add_argument("--window", type=int, default=200,
                    help="full-length requests timed for p50 / p99")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = resolve_device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    log("device", f"{kind} count={count} torch={torch.__version__} "
                  f"cuda={torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    for res in build.build_all():
        ptxas = [ln.strip() for ln in res.log.splitlines()
                 if "registers" in ln or "bytes stack" in ln]
        log("build", f"{res.name}: {res.seconds:.1f} s {res.path.name} | "
                     + (" | ".join(ptxas) if res.log else "reused"))
    log("build", f"all kernels in {time.perf_counter() - t0:.1f} s")

    # 3. kernel check against the plain versions on the card
    errs = {}
    for shape in (BENCH, SERVE, RAGGED):
        ins = kernel_inputs(*shape, dev, args.seed)
        got = rnn_cuda.bilstm_fwd_cuda(*ins)
        ref = rnn_cuda.bilstm_recurrence_plain(*ins)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        rel = err / max(b.abs().max().item() for b in ref)
        errs[shape] = err
        assert all(torch.isfinite(a).all() for a in got), shape
        log("kernel_check", f"bilstm_fwd B,N,H={shape} max_abs_err={err:.3e} "
                            f"max_rel_err={rel:.3e} tol={KERNEL_ATOL:.0e}")
        assert err <= KERNEL_ATOL, (shape, err)
    train_errs = check_training_kernels(dev, args.seed)

    # 4. kernel timing
    shapes = []
    for shape, iters in ((BENCH, 20), (SERVE, 10)):
        B, N, H = shape
        ins = kernel_inputs(*shape, dev, args.seed)
        kernel_ms = cuda_ms(lambda: rnn_cuda.bilstm_fwd_cuda(*ins), iters)
        plain_ms = cuda_ms(lambda: rnn_cuda.bilstm_recurrence_plain(*ins),
                           2, warmup=1)
        lib = torch.nn.LSTM(2 * H, H, batch_first=True,
                            bidirectional=True).to(dev)
        x = torch.randn(B, N, 2 * H, device=dev,
                        generator=torch.Generator(dev).manual_seed(args.seed))
        with torch.no_grad():
            library_ms = cuda_ms(lambda: lib(x), iters)
        bound_ms, bound_by = bilstm_bound(B, N, H)
        row = {"shape": list(shape), "err": errs[shape],
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_us": bound_ms * 1e3,
               "bound_by": bound_by}
        shapes.append(row)
        log("kernel_time", json.dumps(row) + "  (library_ms: cuDNN "
            "bidirectional nn.LSTM, includes the input projection)")
    train_rows = time_training_kernels(dev, args.seed, train_errs)

    # 5. the flagship model at full width
    cfg = ExperimentConfig.from_json(CONFIG)
    mcfg = cfg.model
    model = build_model(mcfg)
    params = random_params(model, args.seed)
    # Random weights give near-uniform attention, so every query would
    # decode the same box; a sharp attention temperature spreads the
    # queries over the walk and the answers hold several colliders.
    params["params"]["decoder"]["inv_temp"] = np.float32(100.0)
    load_params(model, params)
    model = model.to(dev).eval()
    g = np.random.default_rng(args.seed)
    B, N = 32, 500
    raw = np.stack([walk(N, args.seed + 1 + b) for b in range(B)])
    lengths = g.integers(N // 2, N + 1, size=B)
    lengths[0] = N
    feats, mask = featurize(torch.from_numpy(raw).to(dev),
                            torch.from_numpy(lengths).to(dev))
    with torch.inference_mode():
        before = rnn_cuda.bilstm_fwd_cuda.launches
        out = model(feats, mask)
        torch.cuda.synchronize()
        per_fwd = rnn_cuda.bilstm_fwd_cuda.launches - before
        assert per_fwd == mcfg.lstm_layers, per_fwd
        with mock.patch.object(lstm_mod, "bilstm_recurrence",
                               rnn_cuda.bilstm_recurrence_plain):
            ref = model(feats, mask)
        for k, v in out.items():
            assert torch.isfinite(v).all(), k
            err = (v - ref[k]).abs().max().item()
            ok = torch.allclose(v, ref[k], rtol=MODEL_TOL, atol=MODEL_TOL)
            log("model", f"{k} {tuple(v.shape)} max_abs_err_vs_plain="
                         f"{err:.3e} tol={MODEL_TOL:.0e}")
            assert ok, (k, err)
        fwd_ms = cuda_ms(lambda: model(feats, mask), 10)
    log("model", f"flagship lstm d_model={mcfg.d_model} Q={mcfg.num_queries} "
                 f"layers={mcfg.lstm_layers} refine={mcfg.refine_stages}: "
                 f"forward B={B} N={N} {fwd_ms:.3f} ms = "
                 f"{B / fwd_ms * 1e3:.1f} traces/s on {smi}; "
                 f"kernel launches per forward={per_fwd}")

    # 6. serving: a main path
    max_len = cfg.data.max_trace_len
    full = walk(2 * max_len, args.seed + 100)
    sizes = np.linspace(len(full) / args.requests, len(full),
                        args.requests).astype(int)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, n in enumerate(sizes):
            files.append(Path(tmp) / f"trace_{i}.json")
            formats.save_trace_json(files[-1], full[:n])
        predict = build_predictor(model, max_trace_len=max_len,
                                  confidence_threshold=0.0,
                                  nms_threshold=0.3, device=dev,
                                  verbose=False)
        predict(formats.load_trace_json(files[0]))        # warm-up
        reset_counts()
        answers, lat, load_ms = [], [], []
        for f in files:
            t0 = time.perf_counter()
            arr = formats.load_trace_json(f)
            t1 = time.perf_counter()
            answers.append(predict(arr))
            lat.append((time.perf_counter() - t0) * 1e3)
            load_ms.append((t1 - t0) * 1e3)
        launches = rnn_cuda.bilstm_fwd_cuda.launches
        assert launches == args.requests * mcfg.lstm_layers, launches
        assert counts()["bilstm_fwd_train"] == counts()["bilstm_bwd"] == 0
        out_json = Path(tmp) / "colliders.json"
        formats.save_predictions_json(out_json, answers[-1], 0.0, 0.3)
        back = json.loads(out_json.read_text())
        cols = back["colliders"]
        assert back["metadata"]["num_colliders"] == len(cols) > 0
        for c in cols:
            assert c["label"] in ("BLOCK", "LOW", "MID", "HIGH")
            assert np.isfinite(collider_values(c)).all()
            assert min(c["size"].values()) > 0

        cpu_predict = build_predictor(copy.deepcopy(model).cpu(),
                                      max_trace_len=max_len,
                                      confidence_threshold=0.0,
                                      nms_threshold=0.3, device="cpu",
                                      verbose=False)
        ref = cpu_predict(formats.load_trace_json(files[-1]))
    assert [c["label"] for c in ref] == [c["label"] for c in cols]
    err = max(np.abs(np.subtract(collider_values(a), collider_values(b))
                     ).max() for a, b in zip(cols, ref))
    assert err <= MODEL_TOL, err
    log("serve", f"{args.requests} requests, trace points {sizes.tolist()} "
                 f"-> {min(len(full), max_len)} max; colliders per answer "
                 f"{[len(a) for a in answers]}; kernel launches {launches}; "
                 f"card vs CPU max abs diff {err:.3e}")

    # 7. serving latency: full-length requests after warm-up, each stage
    # of predict_array (= finish(run(*prepare(arr)))) on the host clock
    stages = ("load", "prepare", "run", "finish")
    with tempfile.TemporaryDirectory() as tmp:
        f_full = Path(tmp) / "trace_full.json"
        formats.save_trace_json(f_full, full)
        for _ in range(args.warmup):
            predict(formats.load_trace_json(f_full))
        rnn_cuda.bilstm_fwd_cuda.launches = 0
        ms = np.zeros((args.window, len(stages)))
        for i in range(args.window):
            t = [time.perf_counter()]
            arr = formats.load_trace_json(f_full)
            t.append(time.perf_counter())
            x, m = predict.prepare(arr)
            t.append(time.perf_counter())
            stacked = predict.run(x, m)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            cols_i = predict.finish(stacked)
            t.append(time.perf_counter())
            ms[i] = np.diff(t) * 1e3
            assert len(cols_i) == len(answers[-1]), (i, len(cols_i))
    window_launches = rnn_cuda.bilstm_fwd_cuda.launches
    assert window_launches == args.window * mcfg.lstm_layers, window_launches
    req = ms.sum(1)
    mean = dict(zip(stages, ms.mean(0)))
    with torch.inference_mode():
        fwd1_ms = cuda_ms(lambda: model(x, m), 50)
    run_ms = cuda_ms(lambda: predict.run(x, m), 50)
    bench_row, serve_row = shapes
    bench_row["launches"] = per_fwd       # one bench-shape forward
    serve_row["launches"] = launches      # the serving path's requests
    log("serve_latency",
        f"{args.window} requests of {len(full)} points "
        f"({min(len(full), max_len)} after downsampling), after "
        f"{args.warmup} warm-up: p50 "
        f"{np.percentile(req, 50):.3f} ms, p99 {np.percentile(req, 99):.3f} "
        f"ms, mean {req.mean():.3f}, min {req.min():.3f}, max "
        f"{req.max():.3f} ms on {smi}")
    log("serve_latency",
        "mean per request (host clock): JSON load {load:.3f} ms; prepare "
        "(featurize, pad, H2D) {prepare:.3f} ms; run (forward + "
        "post_process, launch and wait) {run:.3f} ms; finish (D2H, collider "
        "dicts) {finish:.3f} ms".format(**mean))
    log("serve_latency",
        f"device (CUDA events, 50 calls back to back): forward "
        f"{fwd1_ms:.3f} ms, of which bilstm_fwd {mcfg.lstm_layers} x "
        f"{serve_row['kernel_ms']:.3f} ms; run {run_ms:.3f} ms, so "
        f"post_process {run_ms - fwd1_ms:.3f} ms")

    # 8-11. training: the main path, its checkpoint served, card vs CPU
    # parity of one step, step timing
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, val_dir = make_rooms(Path(tmp) / "rooms", ROOMS,
                                        args.seed)
        trained, best = train_main_path(cfg, train_dir, val_dir,
                                        Path(tmp) / "ckpt", EPOCHS, dev, smi)
        serve_checkpoint(best, sorted(val_dir.glob("*_trace.json"))[0], dev)
        step_parity(cfg, train_dir, dev, args.seed)
        time_steps(cfg, train_dir, dev, args.seed, smi, train_rows,
                   STEP_SHAPES, STEPS, STEP_WARMUP, "bilstm")

    # 12-17. the scale-up bigru: kernel checks and timing, training (a
    # main path), its checkpoint served (a main path), kernels vs plain
    # versions in one step, step timing
    gru_errs = check_gru_kernels(dev, args.seed)
    gru_rows = time_gru_kernels(dev, args.seed, gru_errs)
    time_hidden_grads(dev, args.seed)
    up = scaleup_config()
    with tempfile.TemporaryDirectory() as tmp:
        rooms = Path(tmp) / "rooms"
        t0 = time.perf_counter()
        write_rooms(rooms / "train", SCALEUP_TRAIN_ROOMS, args.seed + 10,
                    points=SCALEUP_POINTS)
        write_rooms(rooms / "val", SCALEUP_VAL_ROOMS, args.seed + 11,
                    points=SCALEUP_POINTS)
        log("train_scaleup", f"wrote {SCALEUP_TRAIN_ROOMS} + "
                             f"{SCALEUP_VAL_ROOMS} rooms of {SCALEUP_POINTS} "
                             f"points in {time.perf_counter() - t0:.1f} s")
        gru_trained, gru_best = train_main_path(
            up, rooms / "train", rooms / "val", Path(tmp) / "ckpt", 1, dev,
            smi, prefix="bigru")
        log("train_scaleup", "last launches: bigru_fwd_train "
            f"{plan_text(gru_cuda.bigru_fwd_train_cuda)}; bigru_bwd "
            f"{plan_text(gru_cuda.bigru_bwd_cuda)}")
        gru_served = serve_scaleup(gru_best, dev, args.seed)
        step_parity_scaleup(up, rooms / "train", dev, args.seed)
        time_steps(up, rooms / "train", dev, args.seed, smi,
                   {k: [v] for k, v in gru_rows.items()}, [SCALEUP[:2]],
                   SCALEUP_STEPS, SCALEUP_WARMUP, "bigru")

    def entry(name, source, replaces, launched, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": row["err"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_us"] / 1e3,
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    train_row = {name: next(r for r in rows if r["shape"] == list(TRAIN))
                 for name, rows in train_rows.items()}
    kernels = [
        {**entry("bilstm_fwd", "room_slam_torch/csrc/bilstm_fwd.cu",
                 "room_slam_tpu/ops/rnn_pallas.py:390", launches, serve_row),
         "shapes": shapes},
        {**entry("bilstm_fwd_train", "room_slam_torch/csrc/bilstm_fwd.cu",
                 "room_slam_tpu/ops/rnn_pallas.py:531",
                 trained["bilstm_fwd_train"], train_row["bilstm_fwd_train"]),
         "shapes": train_rows["bilstm_fwd_train"]},
        {**entry("bilstm_bwd", "room_slam_torch/csrc/bilstm_bwd.cu",
                 "room_slam_tpu/ops/rnn_pallas.py:438",
                 trained["bilstm_bwd"], train_row["bilstm_bwd"]),
         "max_rel_err": train_errs[TRAIN]["bwd_rel"],
         "shapes": train_rows["bilstm_bwd"]},
        {**entry("bigru_fwd", "room_slam_torch/csrc/bigru_fwd.cu",
                 "room_slam_tpu/ops/gru_pallas.py:314",
                 gru_served["bigru_fwd"], gru_rows["bigru_fwd"]),
         "shapes": [gru_rows["bigru_fwd"]]},
        {**entry("bigru_fwd_train", "room_slam_torch/csrc/bigru_fwd.cu",
                 "room_slam_tpu/ops/gru_pallas.py:454",
                 gru_trained["bigru_fwd_train"], gru_rows["bigru_fwd_train"]),
         "shapes": [gru_rows["bigru_fwd_train"]]},
        {**entry("bigru_bwd", "room_slam_torch/csrc/bigru_bwd.cu",
                 "room_slam_tpu/ops/gru_pallas.py:357",
                 gru_trained["bigru_bwd"], gru_rows["bigru_bwd"]),
         "max_rel_err": gru_errs[(SCALEUP, torch.bfloat16)]["bwd_rel"],
         "shapes": [gru_rows["bigru_bwd"]]},
    ]
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
