"""Measured decomposition of the scale-up train step, one component a row.

The port's counterpart of the JAX package's ``tools/profile_scaleup.py``,
with its flags, rows and derived rows. Each component of the scale-up step
(the bigru at d_model 512, bf16 streams, 32 queries and colliders, batch
128, 5000 points) is timed on its own at the production shape:

- ``full_step``          the train step (augment, forward, matcher and
                         criterion, backward, clip, AdamW)
- ``fwd_loss``           forward + criterion only (no backward, no update)
- ``aug_featurize``      augmentation + featurization front end
- ``criterion``          Hungarian matcher + CE / L1 / GIoU on frozen
                         model outputs
- ``bigru_fwd_res``      one BiGRU layer's recurrence at the layer shape,
                         residuals saved (#5t, the training forward)
- ``bigru_fwd_nores``    the same walk without residuals (#5, inference)
- ``bigru_fwdbwd``       #5t and the BPTT #6 through ``BiGRUFunction``
- ``gate_matmul``        one input-side gate projection [B*N, 512] @
                         [512, 768], bf16 operands, float32 result
- ``elementwise_pass``   one [B, N, 3H] read-and-write pass: each kernel
                         row scales its input by a fresh factor first, as
                         the JAX tool does, and the derived rows subtract
                         it, so the two tools' derived rows mean the same

Each row is the mean over ``--reps`` calls after warm-up, CUDA events
around the calls on the card (the host clock with ``--device cpu``, a run
check at a small ``--seq``, not a measurement of any device). Writes one
JSON (``--output``); ``--trace DIR`` also writes a ``torch.profiler``
trace of three steps (``utils/profiling.device_trace``).

    python -m room_slam_torch.tools.profile_scaleup \\
        [--output build/profile_scaleup.json] [--trace DIR] \\
        [--batch 128 --seq 5000 --reps 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from room_slam_torch import resolve_device
from room_slam_torch.config import (DataConfig, ExperimentConfig,
                                    ModelConfig, TrainConfig)


def _timeit(fn: Callable[[int], object], dev: torch.device, n: int = 10,
            warmup: int = 3, label: str = "") -> float:
    """Mean ms of ``fn(i)`` over ``n`` calls after ``warmup`` calls, each
    call with its own ``i`` (fresh inputs); CUDA events around the ``n``
    calls on the card, the host clock elsewhere."""
    for i in range(warmup):
        fn(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(warmup, warmup + n):
            fn(i)
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / n
    else:
        t0 = time.perf_counter()
        for i in range(warmup, warmup + n):
            fn(i)
        ms = (time.perf_counter() - t0) / n * 1e3
    if label:
        print(f"  {label}: {ms:.2f} ms", flush=True)
    return ms


def scaleup_config(B: int, L: int) -> ExperimentConfig:
    """The JAX tools' scale-up configuration: bigru, d_model 512, 32
    queries and colliders, bf16 streams, TF32 products (the default
    ``train.matmul_precision``, 'bfloat16')."""
    M = 32
    return ExperimentConfig(
        data=DataConfig(max_trace_len=L, max_colliders=M),
        model=ModelConfig(model_type="bigru", d_model=512, num_queries=M,
                          compute_dtype="bfloat16"),
        train=TrainConfig(batch_size=B))


def scaleup_batch(B: int, L: int, M: int, dev: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """The JAX tools' seeded batch (numpy seed 0), on ``dev``."""
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(B, L, 4)).astype(np.float32)
    raw[..., 3] = np.cumsum(np.abs(raw[..., 3]) * 0.03 + 1e-3, axis=-1)
    batch = {
        "raw": raw,
        "length": np.full((B,), L, np.int32),
        "boxes": np.abs(rng.normal(size=(B, M, 6))).astype(np.float32),
        "labels": rng.integers(0, 4, (B, M)).astype(np.int32),
        "valid": (np.arange(M)[None] < 12).repeat(B, 0),
        "rotation_k": np.zeros((B,), np.int32),
        "weight": np.ones((B,), np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def measure(args: argparse.Namespace, cfg: ExperimentConfig,
            dev: torch.device) -> Dict[str, object]:
    """Every row, then the derived rows: the tool's JSON."""
    from room_slam_torch.data.features import featurize
    from room_slam_torch.models.factory import build_model
    from room_slam_torch.ops import gru_cuda
    from room_slam_torch.ops.losses import set_criterion
    from room_slam_torch.ops.rnn_cuda import grad_product
    from room_slam_torch.tools.bench_bigru_bwd import _card
    from room_slam_torch.train.loop import (_loss_weight_dict, make_optimizer,
                                            make_train_step, prepare_batch)
    from room_slam_torch.utils.profiling import device_trace

    B, L, M, D = args.batch, args.seq, 32, 512
    H, H3 = D // 2, 3 * D // 2
    model = build_model(cfg.model,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model, cfg)
    train_step = make_train_step(model, opt, cfg, augment=True)
    batch = scaleup_batch(B, L, M, dev)
    gen = torch.Generator(dev).manual_seed(0)
    lw = _loss_weight_dict(cfg)
    n = args.reps
    rows: Dict[str, float] = {}

    rows["full_step_ms"] = _timeit(lambda i: train_step(batch, gen), dev, n,
                                   label="full_step")

    @torch.no_grad()
    def fwd_loss(i):
        feats, mask, targets = prepare_batch(batch, cfg.data, gen)
        model.train()
        out = model(feats, mask, generator=gen)
        return set_criterion(out, targets, batch["weight"], lw)["total_loss"]

    rows["fwd_loss_ms"] = _timeit(fwd_loss, dev, n, label="fwd_loss")
    rows["aug_featurize_ms"] = _timeit(
        lambda i: prepare_batch(batch, cfg.data, gen)[0], dev, n,
        label="aug_featurize")

    with torch.no_grad():
        feats0, mask0 = featurize(batch["raw"], batch["length"])
        out0 = {k: v for k, v in model.eval()(feats0, mask0).items()
                if v is not None}
    targets0 = {"boxes": batch["boxes"], "labels": batch["labels"],
                "valid_mask": batch["valid"]}
    salts = torch.linspace(0.999, 1.001, 4 * (n + 3) + 16, device=dev)

    @torch.no_grad()
    def crit(i):
        out = dict(out0, pred_boxes=out0["pred_boxes"] * salts[i])
        return set_criterion(out, targets0, batch["weight"], lw)["total_loss"]

    rows["criterion_ms"] = _timeit(crit, dev, n, label="criterion")

    # one BiGRU layer's recurrence at the layer shape; each call scales its
    # input by a fresh factor (elementwise_pass is that pass alone)
    rng = np.random.default_rng(0)
    xg0 = (0.1 * torch.randn(B, L, H3, device=dev,
                             generator=torch.Generator(dev).manual_seed(7))
           ).to(torch.bfloat16)
    w_hh = torch.tensor(rng.normal(size=(H, H3)) * 0.05, dtype=torch.float32,
                        device=dev)
    b_hh = torch.zeros(H3, device=dev)
    cs = torch.linspace(0.99, 1.01, 4 * (n + 3) + 16, device=dev).to(
        torch.bfloat16)

    rows["elementwise_pass_ms"] = _timeit(lambda i: xg0 * cs[i], dev, n,
                                          label="elementwise_pass")

    def k_fwd_res(i):
        x = xg0 * cs[i]
        return gru_cuda.bigru_fwd_train(x, x, w_hh, b_hh, w_hh, b_hh)[0]

    rows["bigru_fwd_res_ms"] = _timeit(k_fwd_res, dev, n,
                                       label="bigru_fwd_res")

    @torch.no_grad()
    def k_fwd_nores(i):
        x = xg0 * cs[i]
        return gru_cuda.bigru_recurrence(x, x, w_hh, b_hh, w_hh, b_hh)[0]

    rows["bigru_fwd_nores_ms"] = _timeit(k_fwd_nores, dev, n,
                                         label="bigru_fwd_nores")

    def k_fwdbwd(i):
        x = (xg0 * cs[i]).requires_grad_(True)
        w = w_hh.clone().requires_grad_(True)
        ysf, ysb = gru_cuda.bigru_recurrence(x, x, w, b_hh, w, b_hh)
        loss = ysf.float().sum() + ysb.float().sum()
        return torch.autograd.grad(loss, (x, w))[0]

    rows["bigru_fwdbwd_ms"] = _timeit(k_fwdbwd, dev, n, label="bigru_fwdbwd")

    xin = (0.1 * torch.randn(B * L, D, device=dev,
                             generator=torch.Generator(dev).manual_seed(8))
           ).to(torch.bfloat16)
    w_in = torch.tensor(rng.normal(size=(D, H3)) * 0.05,
                        dtype=torch.bfloat16, device=dev)
    rows["gate_matmul_ms"] = _timeit(
        lambda i: grad_product(xin * cs[i], w_in), dev, n,
        label="gate_matmul")

    ew = rows["elementwise_pass_ms"]
    fwd_res = rows["bigru_fwd_res_ms"] - ew
    fwd_nores = rows["bigru_fwd_nores_ms"] - ew
    fwdbwd = rows["bigru_fwdbwd_ms"] - ew
    mm = rows["gate_matmul_ms"] - ew
    gate_flops = 2.0 * B * L * D * H3
    derived = {
        "recurrence_fwd_walk_ms": round(fwd_res, 3),
        "recurrence_fwd_walk_inference_ms": round(fwd_nores, 3),
        "recurrence_bwd_walk_ms": round(fwdbwd - fwd_res, 3),
        "residual_store_cost_ms": round(fwd_res - fwd_nores, 3),
        "recurrence_total_2layers_ms": round(2 * fwdbwd, 3),
        "backward_etc_ms": round(
            rows["full_step_ms"] - rows["fwd_loss_ms"], 3),
        "gate_matmul_tflops": (round(gate_flops / (mm / 1e3) / 1e12, 1)
                               if mm > 0.5 else None),
        "per_kernel_timestep_us": {
            "fwd": round(fwd_res / L * 1e3, 3),
            "fwd_nores": round(fwd_nores / L * 1e3, 3),
            "bwd": round((fwdbwd - fwd_res) / L * 1e3, 3),
        },
    }
    result = {
        "config": {"batch": B, "seq": L, "d_model": D,
                   "stream_dtype": "bfloat16",
                   "matmul_precision": cfg.train.matmul_precision,
                   "reps": n, **_card(dev)},
        "measured_ms": {k: round(v, 3) for k, v in rows.items()},
        "derived": derived,
        "note": ("kernel rows are net of elementwise_pass_ms (each call's "
                 "fresh-input scaling pass); recurrence_total assumes the "
                 "step's 2 BiGRU layers each run one forward and one BPTT "
                 "walk at this shape"),
    }
    if args.trace:
        with device_trace(args.trace):
            for _ in range(3):
                train_step(batch, gen)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        result["trace_dir"] = args.trace
    return result



def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output", default="build/profile_scaleup.json")
    ap.add_argument("--trace", default=None,
                    help="also write a torch.profiler trace here")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=5000,
                    help="production 5000; small values allow a CPU run "
                         "(--device cpu: the plain recurrences)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from room_slam_torch.train.loop import matmul_precision

    dev = resolve_device(args.device)
    cfg = scaleup_config(args.batch, args.seq)
    # the JAX tool sets its precision process-wide: every row runs at it
    with matmul_precision(cfg.train.matmul_precision, dev):
        result = measure(args, cfg, dev)
    print(json.dumps(result, indent=1))
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
