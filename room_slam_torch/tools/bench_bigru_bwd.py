"""Micro-benchmark of the BiGRU BPTT kernels at the scale-up shape.

The port's counterpart of the JAX package's ``tools/bench_bigru_bwd.py``,
with its rows and JSON keys:

- ``elementwise_pass_ms``    one read-and-write pass over a ``[B, N, 3H]``
                             stream, the memory yardstick
- ``bwd_kernel@CxR_ms``      ``bigru_bwd`` (#6) under launch plan CxR of the
                             kernel #6's route takes at the shape (a plan of
                             another kernel: ``bwd_kernel@<kernel>CxR_ms``)
- ``bwd_split@CxR_ms``       ``bigru_bwd_split`` (#10) under the same plan
- ``dw_einsum_ms``           one direction's ``h_prev^T dx`` product, float32
- ``hprev_build_ms``         one direction's shifted ys (``prev_steps``)
- ``core_bwd_ms``            ``BiGRUFunction.backward``'s work: #6 and both
                             directions' ``hidden_grads``
- ``full_vjp_ms``            forward and backward through ``BiGRUFunction``

On the card every row is the mean over ``--reps`` calls after two warm-up
calls, timed with CUDA events; ``--device cpu`` runs the plain versions at
a small shape on the host clock (a check that the tool runs, not a
measurement of any device). Streams are bfloat16, as in the scale-up model.
``config`` records the route's kernel ("plain" on the CPU) and the plans.

    python -m room_slam_torch.tools.bench_bigru_bwd [--tiles auto]
        [--batch 128 --seq 5000 --hidden 256 --reps 8]
        [--output bench_bigru_bwd.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from room_slam_torch import resolve_device
from room_slam_torch.ops import gru_cuda
from room_slam_torch.ops.rnn_cuda import prev_steps

TILES_HELP = (
    "comma list of launch plans (cluster size x batch-tile rows) to sweep "
    "for bwd_kernel (#6) and bwd_split (#10) on the card: CxR, a plan of "
    "the kernel #6's route takes at the shape, or <kernel>CxR naming the "
    "kernel (tc, reg, pipe, stream, cluster: the first design, unit with "
    "C = 1), e.g. tc4x16,cluster8x20; 'auto' (the default) is the route "
    "kernel's pick plus up to five other plans the card runs, in its "
    "planner's order. The CPU's plain versions take no plan: with --device "
    "cpu only 'auto' is accepted and gives one row each, named @plain")
KERNELS = ("tc", "reg", "pipe", "stream", "cluster", "unit")
_SPEC = re.compile(r"([a-z]*)(\d+)x(\d+)")


def parse_tiles(spec: str, B: int, H: int) -> List[tuple]:
    """The forced plans (``gru_cuda.bwd_plan_fits``' form) an explicit
    ``--tiles`` list names at batch B and H with bf16 streams: ``CxR`` a
    plan of the route's kernel, ``<kernel>CxR`` of the kernel named (the
    unit kernel's with C = 1). Raises ``ValueError`` for an unknown kernel
    or a plan that does not fit its kernel's rule."""
    route = gru_cuda.gru_bwd_kernel_route(H, 2, torch.bfloat16)
    plans = []
    for item in spec.split(","):
        m = _SPEC.fullmatch(item.strip())
        kernel = (m.group(1) or route) if m else None
        if kernel not in KERNELS:
            raise ValueError(f"--tiles: {item!r} is not [kernel]CxR with a "
                             f"kernel of {KERNELS}")
        c, r = int(m.group(2)), int(m.group(3))
        plan = ("unit", r) if kernel == "unit" else (kernel, c, r)
        if (kernel == "unit" and c != 1) or not gru_cuda.bwd_plan_fits(
                plan, H, torch.bfloat16):
            raise ValueError(f"--tiles: plan {item!r} does not fit the "
                             f"{kernel} kernel at B={B}, H={H} (bf16)")
        plans.append(plan)
    return plans


def plan_tile(plan: tuple) -> str:
    """A forced plan's CxR: the unit kernel's cluster is one block."""
    return f"1x{plan[1]}" if plan[0] == "unit" else f"{plan[1]}x{plan[2]}"


def _timer(dev: torch.device, reps: int, warmup: int = 2
           ) -> Callable[[Callable[[], object]], float]:
    def cuda_ms(fn):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    def host_ms(fn):
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    return cuda_ms if dev.type == "cuda" else host_ms


def _inputs(B: int, N: int, H: int, dev: torch.device):
    """The JAX tool's inputs in the port's layout (batch-major, ys instead
    of a built h_prev), drawn from seed 0: gates sigmoid(0.1 z), hn, ys and
    dy 0.1 z, bf16; W_hh 0.05 z and zero b_hh, float32."""
    g = torch.Generator(dev).manual_seed(0)

    def mk(*shape):
        return 0.1 * torch.randn(*shape, device=dev, generator=g)

    bf = torch.bfloat16
    t = {}
    for d in ("f", "b"):
        t[f"gs_{d}"] = torch.sigmoid(mk(B, N, 3 * H)).to(bf)
        for k in ("hn", "ys", "dy"):
            t[f"{k}_{d}"] = mk(B, N, H).to(bf)
    rng = np.random.default_rng(0)
    for d in ("f", "b"):
        t[f"w_{d}"] = torch.tensor(rng.normal(size=(H, 3 * H)) * 0.05,
                                   dtype=torch.float32, device=dev)
        t[f"b_{d}"] = torch.zeros(3 * H, device=dev)
    return t


def _tiles(spec: str, dev: torch.device, B: int, H: int
           ) -> Tuple[str, List[Optional[tuple]]]:
    """The route's kernel and the launch plans to sweep; ``("plain",
    [None])`` (the plain versions) on the CPU."""
    if dev.type != "cuda":
        if spec != "auto":
            raise ValueError("--tiles: the CPU's plain versions take no "
                             "launch plan; use --tiles auto")
        return "plain", [None]
    if spec != "auto":
        return (gru_cuda.gru_bwd_kernel_route(H, 2, torch.bfloat16),
                parse_tiles(spec, B, H))
    kernel, plans = gru_cuda.card_bwd_plans(B, H, dev, torch.bfloat16)
    return kernel, plans[:6]


def _card(dev: torch.device) -> Dict[str, object]:
    if dev.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "device": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output", default="bench_bigru_bwd.json")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=5000)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--tiles", default="auto", help=TILES_HELP)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, N, H = args.batch, args.seq, args.hidden
    t = _inputs(B, N, H, dev)
    timeit = _timer(dev, args.reps)
    on_card = dev.type == "cuda"
    bwd_args = (t["w_f"], t["w_b"], t["gs_f"], t["hn_f"], t["ys_f"],
                t["dy_f"], t["gs_b"], t["hn_b"], t["ys_b"], t["dy_b"])
    rows: Dict[str, float] = {}

    def row(key, fn):
        rows[key] = timeit(fn)
        print(f"  {key}: {rows[key]:.3f} ms", flush=True)

    row("elementwise_pass_ms", lambda: t["gs_f"] * 1.01)
    kernel, tiles = _tiles(args.tiles, dev, B, H)
    for name, cuda_fn, plain in (
            ("bwd_kernel", gru_cuda.bigru_bwd_cuda, gru_cuda.bigru_bwd_plain),
            ("bwd_split", gru_cuda.bigru_bwd_split_cuda,
             gru_cuda.bigru_bwd_split_plain)):
        for plan in tiles:
            if plan is None:
                row(f"{name}@plain_ms", lambda: plain(*bwd_args))
            else:
                other = "" if plan[0] == kernel else plan[0]
                row(f"{name}@{other}{plan_tile(plan)}_ms",
                    lambda p=plan, f=cuda_fn: f(*bwd_args, plan=p))
    hp = prev_steps(t["ys_f"], False)
    dx, dhn = gru_cuda.bigru_bwd(*bwd_args)[:2]
    row("dw_einsum_ms", lambda: torch.matmul(
        hp.reshape(-1, H).float().t(), dx.reshape(-1, 3 * H).float()))
    row("hprev_build_ms", lambda: prev_steps(t["ys_f"], False))

    def core_bwd():
        dx_f, dhn_f, dx_b, dhn_b = gru_cuda.bigru_bwd(*bwd_args)
        gru_cuda.hidden_grads(t["ys_f"], dx_f, dhn_f, False, torch.float32)
        gru_cuda.hidden_grads(t["ys_b"], dx_b, dhn_b, True, torch.float32)

    row("core_bwd_ms", core_bwd)
    xg = t["gs_f"].detach().requires_grad_(True)
    w_f = t["w_f"].detach().requires_grad_(True)

    def full_vjp():
        ys_f, ys_b = gru_cuda.BiGRUFunction.apply(xg, xg, w_f, t["b_f"],
                                                  t["w_b"], t["b_b"])
        loss = ys_f.float().sum() + ys_b.float().sum()
        return torch.autograd.grad(loss, (xg, w_f))

    row("full_vjp_ms", full_vjp)
    result = {
        "config": {"batch": B, "seq": N, "hidden": H,
                   "stream_dtype": "bfloat16", "reps": args.reps,
                   "kernel": kernel,
                   "tiles": [None if p is None else plan_tile(p)
                             for p in tiles],
                   "plans": [None if p is None else list(p) for p in tiles],
                   **_card(dev)},
        "measured_ms": rows,
        "note": ("CUDA events over --reps calls after 2 warm-up calls; "
                 "tiles are cluster x batch-tile rows of the plans' kernels"
                 if on_card else
                 "plain versions on the host clock: a check that the tool "
                 "runs, no device measurement"),
    }
    print(json.dumps(result, indent=1))
    with open(args.output, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
