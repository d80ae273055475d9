"""Decomposition of the scale-up train step by ablation pairs, each row a
run of K iterations.

The port's counterpart of the JAX package's ``tools/profile_scaleup2.py``,
with its flags (plus ``--device``), rows and derived rows. Every row runs
its body ``--k`` times, each with a fresh generator draw (the augmentation
and the dropout masks) and the iteration's input perturbation, after one
warm-up iteration, and is timed as one span: CUDA events around the K
iterations with a single synchronise on the card (the JAX tool's one
``lax.scan`` with one readback), the host clock with ``--device cpu`` (a
run check at a small ``--seq``). The pairs then split the step:

    optimizer        = full_step      - grads_only
    criterion total  = grads_only     - model_fwd_bwd
    criterion fwd    = fwd_loss       - model_fwd
    model backward   = model_fwd_bwd  - model_fwd
    model forward    = model_fwd      - frontend
    front end        = frontend (augment + featurize)

``--kernels`` adds one BiGRU layer's recurrence at the layer shape: #5t
(``bigru_core_fwd_res``), #5 (``bigru_core_fwd_nores``), #5t + #6 through
``BiGRUFunction`` (``bigru_core_fwdbwd``), the two ``dW_hh`` products the
backward adds outside the kernel (``dw_einsum_2x``) and the shifted h
(``hprev_build``).

    python -m room_slam_torch.tools.profile_scaleup2 [--kernels] \\
        [--batch 128 --seq 5000 --k 8] [--output FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from room_slam_torch import resolve_device
from room_slam_torch.tools.profile_scaleup import (scaleup_batch,
                                                   scaleup_config)


def span_ms(body: Callable[[int, torch.Generator], object], K: int,
            dev: torch.device, seed: int) -> float:
    """Mean ms an iteration of ``body(i, generator)`` over K iterations
    after one warm-up, the generator seeded by ``seed``: CUDA events around
    the K and one synchronise on the card, the host clock elsewhere."""
    gen = torch.Generator(dev).manual_seed(seed)
    body(0, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(K):
            body(i, gen)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / K
    t0 = time.perf_counter()
    for i in range(K):
        body(i, gen)
    return (time.perf_counter() - t0) / K * 1e3


def _abs_sum(tensors) -> torch.Tensor:
    """Consume every gradient (a reduction over a subset would leave the
    others' products out of the row)."""
    return sum(t.float().abs().sum() for t in tensors if t is not None)


def measure(args: argparse.Namespace, dev: torch.device
            ) -> Dict[str, float]:
    from room_slam_torch.models.factory import build_model
    from room_slam_torch.ops import gru_cuda
    from room_slam_torch.ops.losses import set_criterion
    from room_slam_torch.ops.rnn_cuda import grad_product, prev_steps
    from room_slam_torch.train.loop import (_loss_weight_dict, make_optimizer,
                                            make_train_steps, prepare_batch)

    B, L, M, K = args.batch, args.seq, 32, args.k
    cfg = scaleup_config(B, L)
    model = build_model(cfg.model,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    params = list(model.parameters())
    batch = scaleup_batch(B, L, M, dev)
    lw = _loss_weight_dict(cfg)
    rows: Dict[str, float] = {}

    def row(name, body, seed):
        ms = span_ms(body, K, dev, seed)
        rows[name] = round(ms, 3)
        print(f"{name:24s} {ms:8.2f} ms", flush=True)

    # the full step on a copy of the model, so that the ablation rows
    # below start from the same parameters
    step_model = copy.deepcopy(model)
    run_steps = make_train_steps(step_model, make_optimizer(step_model, cfg),
                                 cfg, augment=True)
    row("full_step", lambda i, g: run_steps(batch, g, 1), 7)

    def front(i, gen):
        b = dict(batch, raw=batch["raw"] + float(i) * 1e-6)
        return prepare_batch(b, cfg.data, gen)

    def forward(feats, mask, gen):
        model.train()
        return model(feats, mask, generator=gen)

    def body_grads(i, gen):
        feats, mask, targets = front(i, gen)
        loss = set_criterion(forward(feats, mask, gen), targets,
                             batch["weight"], lw)["total_loss"]
        return _abs_sum(torch.autograd.grad(loss, params, allow_unused=True))

    @torch.no_grad()
    def body_fwd_loss(i, gen):
        feats, mask, targets = front(i, gen)
        return set_criterion(forward(feats, mask, gen), targets,
                             batch["weight"], lw)["total_loss"]

    def out_sum(feats, mask, gen):
        return sum(v.float().sum() for v in forward(feats, mask, gen).values()
                   if v is not None)

    @torch.no_grad()
    def body_model_fwd(i, gen):
        feats, mask, _ = front(i, gen)
        return out_sum(feats, mask, gen)

    def body_model_fwd_bwd(i, gen):
        feats, mask, _ = front(i, gen)
        return _abs_sum(torch.autograd.grad(out_sum(feats, mask, gen),
                                            params, allow_unused=True))

    def body_front(i, gen):
        return front(i, gen)[0][:, 0, 0].sum()

    row("grads_only", body_grads, 1)
    row("fwd_loss", body_fwd_loss, 2)
    row("model_fwd", body_model_fwd, 3)
    row("model_fwd_bwd", body_model_fwd_bwd, 4)
    row("frontend", body_front, 5)
    if not args.kernels:
        return rows

    H = cfg.model.d_model // 2
    rng = np.random.default_rng(0)
    # the layer-shape streams drawn on the device (numpy takes seconds a
    # tensor at the scale-up shape)
    draw = torch.Generator(dev).manual_seed(11)
    bf = torch.bfloat16
    xg0 = torch.randn(B, L, 3 * H, device=dev, generator=draw).to(bf)
    wf = torch.tensor(rng.normal(size=(H, 3 * H)), dtype=torch.float32,
                      device=dev) * 0.05
    bias = torch.zeros(3 * H, device=dev)

    def xg(i):
        return xg0 + bf_scalar(i)

    def bf_scalar(i):
        return torch.tensor(i * 1e-3, dtype=bf, device=dev)

    def body_core_res(i, gen):
        ys = gru_cuda.bigru_fwd_train(xg(i), xg(i), wf, bias, wf, bias)[0]
        return ys[0, 0].float().sum()

    @torch.no_grad()
    def body_core_nores(i, gen):
        ys = gru_cuda.bigru_recurrence(xg(i), xg(i), wf, bias, wf, bias)[0]
        return ys[0, 0].float().sum()

    def body_core_fwdbwd(i, gen):
        x = xg(i).requires_grad_(True)
        ysf, ysb = gru_cuda.bigru_recurrence(x, x, wf, bias, wf, bias)
        g = torch.autograd.grad(ysf.float().sum() + ysb.float().sum(), x)[0]
        return g[0, 0].float().sum()

    # the products and the shift BiGRUFunction's backward adds around the
    # BPTT kernel: dW_hh's two gate blocks, h_prev from ys
    ys0 = torch.randn(B, L, H, device=dev, generator=draw).to(bf)
    dxg0 = torch.randn(B, L, 3 * H, device=dev, generator=draw).to(bf)

    def body_dw(i, gen):
        hp = (ys0 + bf_scalar(i)).reshape(B * L, H).t()
        dx = dxg0.reshape(B * L, 3 * H)
        dw2 = grad_product(hp, dx[:, :2 * H])
        dwn = grad_product(hp, dx[:, 2 * H:])
        return dw2[0].sum() + dwn[0].sum()

    def body_hprev(i, gen):
        return prev_steps(ys0 + bf_scalar(i), False)[0, 0].float().sum()

    row("bigru_core_fwd_res", body_core_res, 6)
    row("bigru_core_fwd_nores", body_core_nores, 7)
    row("bigru_core_fwdbwd", body_core_fwdbwd, 8)
    row("dw_einsum_2x", body_dw, 9)
    row("hprev_build", body_hprev, 10)
    return rows


def derive(rows: Dict[str, float]) -> Dict[str, float]:
    """The JAX tool's derived rows from the measured ones."""
    derived = {
        "optimizer_ms": round(rows["full_step"] - rows["grads_only"], 3),
        "criterion_total_ms": round(
            rows["grads_only"] - rows["model_fwd_bwd"], 3),
        "criterion_fwd_ms": round(rows["fwd_loss"] - rows["model_fwd"], 3),
        "model_bwd_ms": round(rows["model_fwd_bwd"] - rows["model_fwd"], 3),
        "model_fwd_net_ms": round(rows["model_fwd"] - rows["frontend"], 3),
        "frontend_ms": rows["frontend"],
    }
    if "bigru_core_fwdbwd" in rows:
        derived["core_bwd_walk_ms"] = round(
            rows["bigru_core_fwdbwd"] - rows["bigru_core_fwd_res"], 3)
        derived["residual_store_ms"] = round(
            rows["bigru_core_fwd_res"] - rows["bigru_core_fwd_nores"], 3)
    return derived


def emit(rows: Dict[str, float], args: argparse.Namespace,
         dev: torch.device) -> Dict[str, object]:
    from room_slam_torch.tools.bench_bigru_bwd import _card

    derived = derive(rows)
    print("\nderived:")
    for k, v in derived.items():
        print(f"  {k:28s} {v}")
    out = {"config": {"batch": args.batch, "seq": args.seq, "d_model": 512,
                      "stream_dtype": "bfloat16", "k_scan": args.k,
                      **_card(dev)},
           "measured_ms": rows, "derived": derived,
           "note": "every row is k_scan iterations of its body, each with "
                   "a fresh generator draw and input perturbation, timed "
                   "as one span after one warm-up iteration"}
    if args.output:
        path = Path(args.output)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        print(f"wrote {args.output}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=5000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--kernels", action="store_true",
                    help="also time one BiGRU layer's recurrence rows")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from room_slam_torch.train.loop import matmul_precision

    dev = resolve_device(args.device)
    # the JAX tool sets its precision process-wide: every row runs at it
    with matmul_precision(scaleup_config(1, 1).train.matmul_precision, dev):
        rows = measure(args, dev)
    return emit(rows, args, dev)


if __name__ == "__main__":
    main()
