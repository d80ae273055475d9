#!/usr/bin/env python3
"""Time chip_smoke.py's flagship, legacy and scale-up train steps, the LSTM
and BiGRU kernels on them and the fused BiGRU layer from two checkouts of
this repository on one CUDA card, in turns.

    python3 chip_ab.py --parent DIR [--output FILE]

``--parent`` is the root of another checkout; it and this one run in the
order parent, change, change, parent, so a drift of the card over the
call shows as a parent-parent spread. Each run is a fresh process in its
checkout's root that imports that checkout's ``chip_smoke.py`` and
``room_slam_torch`` (its kernels built there at first use) and measures:

- phase 23: ``time_legacy_steps``, the legacy train step (B=32, N=500)
  p50 over ``LEGACY_STEPS`` after ``LEGACY_WARMUP`` on the rooms that
  ``chip_smoke.py`` makes from its default seed (0), then its per-stage
  split; the ``gru_fwd_train`` and ``gru_bwd`` kernel times beside it
  from CUDA events;
- phase 27: ``fused_ab``, one scale-up BiGRU layer's forward + backward
  fused (#9) and unfused, and #9 alone;
- phase 11: ``time_steps``, the flagship train step at ``TRAIN`` (B=20,
  N=1500) p50 over ``STEPS`` after ``STEP_WARMUP`` on phase 8's rooms,
  then its per-stage split; the ``bilstm_fwd_train`` and ``bilstm_bwd``
  kernel times at that shape beside it, and ``lstm_bwd`` at the legacy
  shape (B=32, N=500, one direction), from CUDA events;
- phase 17: ``time_steps``, the scale-up train step (the bigru config at
  ``SCALEUP``: B=128, N=5000, d_model 512, bf16) p50 over
  ``SCALEUP_STEPS`` after ``SCALEUP_WARMUP`` on phase 14's rooms, then its
  per-stage split; the ``bigru_fwd_train`` and ``bigru_bwd`` kernel times
  at that shape beside it, from CUDA events; and before it phase 13's
  ``time_hidden_grads``, the dW_hh / db_hh products of one direction and
  layer as the checkout runs them;
- phase 34's config: the flagship ``lstm`` at d_model ``WIDE_LSTM_D``
  (512: H=256, the LSTM cluster routes), dropout 0, the train step at
  (32, 500) p50 over ``STEPS`` after ``STEP_WARMUP`` on phase 8's rooms,
  with the ``bilstm_fwd_train`` and ``bilstm_bwd`` kernel times at (32,
  500, 256) f32 and the kernel each launch took.

``--parts`` picks some of them (legacy, fused, flagship, scaleup,
lstm512; all by default). It prints one line per run and, last, a JSON
object of all runs (also written to ``--output``). Exits non-zero without
a CUDA card; every number comes from the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

RUN = r'''
import copy, json, os, subprocess, sys, tempfile, time
from pathlib import Path
import numpy as np
import torch
import chip_smoke as cs
from room_slam_torch.data.rooms import write_legacy_rooms, write_rooms
from room_slam_torch.ops import build, gru_cuda, rnn_cuda

seed = 0   # chip_smoke.py's default --seed
dev = cs.resolve_device("cuda")
build.build_all()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], check=True,
                     capture_output=True, text=True,
                     timeout=60).stdout.strip().splitlines()[0]
parts = os.environ["AB_PARTS"].split(",")
result = {"card": smi}


def lstm512_step():
    """The step of phase 34's lstm at (32, 500) and its two kernels."""
    cfg = cs.ExperimentConfig.from_json(cs.CONFIG)
    cfg.model.d_model, cfg.model.dropout = cs.WIDE_LSTM_D, 0.0
    B, N = cs.WIDE_TIME[:2]
    cfg.train.batch_size, cfg.data.max_trace_len = B, N
    H = cfg.model.d_model // 2
    ins = cs.kernel_inputs(B, N, H, dev, seed)
    args = cs.bwd_inputs(ins, seed + 1)
    out = {}
    for name, fn, a in (("bilstm_fwd_train", rnn_cuda.bilstm_fwd_train_cuda,
                         ins), ("bilstm_bwd", rnn_cuda.bilstm_bwd_cuda,
                                args)):
        out[f"{name}_ms"] = cs.cuda_ms(lambda: fn(*a), 5)
        out[f"{name}_launch"] = dict(fn.last_launch)
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, _ = cs.make_rooms(Path(tmp) / "rooms", cs.ROOMS, seed)
        ds = cs.TraceColliderArrays(train_dir, cfg.data, augment=True,
                                    verbose=False)
        data = {k: torch.from_numpy(v).to(dev)
                for k, v in ds.device_arrays().items()}
        plan = ds.epoch_plan(B, seed=seed)
    nb = plan["base_idx"].shape[0]
    model = cs.build_model(cfg.model, generator=torch.Generator()
                           .manual_seed(seed)).to(dev)
    opt = cs.loop.make_optimizer(model, cfg)
    step = cs.loop.make_train_step(model, opt, cfg, augment=True)
    gen = torch.Generator(dev).manual_seed(seed)
    ms = []
    for i in range(cs.STEPS + cs.STEP_WARMUP):
        batch = cs.loop.gather_batch(data, plan, i % nb)
        t0 = time.perf_counter()
        losses = step(batch, gen)
        torch.cuda.synchronize()
        if i >= cs.STEP_WARMUP:
            ms.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(float(losses["total_loss"]))
    out.update(p50_ms=float(np.percentile(ms, 50)), steps=len(ms),
               traces_per_s=B / float(np.percentile(ms, 50)) * 1e3)
    return out


if "lstm512" in parts:
    result["lstm512"] = lstm512_step()
B, N, H = cs.LEGACY
xg, _, w, b, _, _ = cs.gru_inputs(B, N, H, torch.float32, dev, seed)
ys, gs, hn = gru_cuda.gru_fwd_train_plain(xg, w, b)
dy = torch.randn(B, N, H, device=dev,
                 generator=torch.Generator(dev).manual_seed(seed))
rows = {"gru_fwd_train": {"kernel_ms": cs.cuda_ms(
            lambda: gru_cuda.gru_fwd_train_cuda(xg, w, b), 20)},
        "gru_bwd": {"kernel_ms": cs.cuda_ms(
            lambda: gru_cuda.gru_bwd_cuda(w, gs, hn, ys, dy), 20)}}
if "legacy" in parts:
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "legacy"
        write_legacy_rooms(data, cs.LEGACY_ROOMS, seed + 20,
                           points=cs.LEGACY_POINTS)
        result["legacy"] = cs.time_legacy_steps(data, dev, seed, smi, rows)
if "fused" in parts:
    result["fused"] = cs.fused_ab(dev, seed, smi, None)[0]
ins = cs.kernel_inputs(*cs.TRAIN, dev, seed)
args = cs.bwd_inputs(ins, seed + 1)
flag_rows = {"bilstm_fwd_train": [{"shape": list(cs.TRAIN), "kernel_ms":
                 cs.cuda_ms(lambda: rnn_cuda.bilstm_fwd_train_cuda(*ins),
                            10)}],
             "bilstm_bwd": [{"shape": list(cs.TRAIN), "kernel_ms":
                 cs.cuda_ms(lambda: rnn_cuda.bilstm_bwd_cuda(*args), 10)}]}
lx, _, lw, _ = cs.kernel_inputs(*cs.LEGACY, dev, seed)
_, lc, lg = rnn_cuda.lstm_fwd_train_plain(lx, lw)
lstm_bwd_ms = cs.cuda_ms(lambda: rnn_cuda.lstm_bwd_cuda(lw, lg, lc, dy), 20)
result.update(bilstm_bwd_ms=flag_rows["bilstm_bwd"][0]["kernel_ms"],
              lstm_bwd_ms=lstm_bwd_ms)
if "flagship" in parts:
    cfg = cs.ExperimentConfig.from_json(cs.CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, _ = cs.make_rooms(Path(tmp) / "rooms", cs.ROOMS, seed)
        result["flagship"] = cs.time_steps(
            cfg, train_dir, dev, seed, smi, flag_rows, [cs.TRAIN[:2]],
            cs.STEPS, cs.STEP_WARMUP, "bilstm")[0]
if "scaleup" in parts:
    result["hidden_grads_ms"] = cs.time_hidden_grads(dev, seed)["ms"]
    B, N, H = cs.SCALEUP
    ins = cs.gru_inputs(B, N, H, torch.bfloat16, dev, seed)
    args = cs.gru_bwd_inputs(ins, seed + 1)
    up_rows = {"bigru_fwd_train": [{"shape": [B, N, H], "kernel_ms":
                   cs.cuda_ms(lambda: gru_cuda.bigru_fwd_train_cuda(*ins),
                              3)}],
               "bigru_bwd": [{"shape": [B, N, H], "kernel_ms": cs.cuda_ms(
                   lambda: gru_cuda.bigru_bwd_cuda(*args), 3)}]}
    result["bigru_launches"] = {
        k: dict(getattr(gru_cuda, k + "_cuda").last_launch) for k in up_rows}
    del ins, args
    with tempfile.TemporaryDirectory() as tmp:
        rooms = Path(tmp) / "rooms"
        write_rooms(rooms, cs.SCALEUP_TRAIN_ROOMS, seed + 10,
                    points=cs.SCALEUP_POINTS)
        result["scaleup"] = cs.time_steps(
            cs.scaleup_config(), rooms, dev, seed, smi, up_rows,
            [cs.SCALEUP[:2]], cs.SCALEUP_STEPS, cs.SCALEUP_WARMUP,
            "bigru")[0]
    result["bigru_fwd_train_ms"] = up_rows["bigru_fwd_train"][0]["kernel_ms"]
    result["bigru_bwd_ms"] = up_rows["bigru_bwd"][0]["kernel_ms"]
print("AB_RESULT " + json.dumps(result), flush=True)
'''


ORDER = "pccp"   # parent, change, change, parent
PARTS = ("legacy", "fused", "flagship", "scaleup", "lstm512")


def run_one(root: Path, parts) -> dict:
    """One run in checkout ``root``: its own process, imports and build."""
    env = dict(os.environ, PYTHONPATH=str(root), AB_PARTS=",".join(parts))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                          env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {root} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("AB_RESULT "))
    return json.loads(line[len("AB_RESULT "):])


def _summary(part: str, res: dict) -> str:
    """One part's numbers of a run, as text."""
    if part == "flagship":
        flag = res["flagship"]
        return (f"flagship step p50 {flag['p50_ms']:.3f} ms (backward "
                f"{flag['stage_ms']['backward']:.3f}; bilstm_bwd kernel "
                f"{res['bilstm_bwd_ms']:.3f} ms); lstm_bwd kernel "
                f"{res['lstm_bwd_ms']:.3f} ms")
    if part == "legacy":
        leg = res["legacy"]
        stage = leg["stage_ms"]
        return (f"legacy step p50 {leg['p50_ms']:.3f} ms (forward "
                f"{stage['forward']:.3f}, backward {stage['backward']:.3f}; "
                f"gru_bwd kernel {leg['bwd_kernels_ms'] / 4:.3f} ms)")
    if part == "fused":
        fus = res["fused"]
        return (f"fused layer {fus['fused_layer_fwd_bwd_ms']:.3f} ms, "
                f"unfused {fus['unfused_layer_fwd_bwd_ms']:.3f} ms, #9 "
                f"{fus['kernel_ms']:.3f} ms")
    if part == "scaleup":
        up = res["scaleup"]
        return (f"scale-up step p50 {up['p50_ms']:.3f} ms (forward "
                f"{up['stage_ms']['forward']:.3f}, backward "
                f"{up['stage_ms']['backward']:.3f}; bigru_fwd_train kernel "
                f"{res['bigru_fwd_train_ms']:.3f} ms, bigru_bwd kernel "
                f"{res['bigru_bwd_ms']:.3f} ms, "
                f"{res['bigru_launches']['bigru_bwd']['kernel']} kernel; "
                f"hidden_grads {res['hidden_grads_ms']:.3f} ms)")
    big = res["lstm512"]
    return (f"lstm d_model 512 step p50 {big['p50_ms']:.3f} ms "
            f"({big['traces_per_s']:.1f} traces/s; bilstm_fwd_train "
            f"{big['bilstm_fwd_train_ms']:.3f} ms on the "
            f"{big['bilstm_fwd_train_launch']['kernel']} kernel, bilstm_bwd "
            f"{big['bilstm_bwd_ms']:.3f} ms on the "
            f"{big['bilstm_bwd_launch']['kernel']} kernel)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--output", type=Path)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated parts to time, of "
                         + ", ".join(PARTS))
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {', '.join(PARTS)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA card", file=sys.stderr)
        return 1
    roots = {"p": args.parent.resolve(),
             "c": Path(__file__).resolve().parent}
    runs = []
    for i, key in enumerate(ORDER):
        res = run_one(roots[key], parts)
        runs.append({"run": i + 1, "tree": "parent" if key == "p"
                     else "change", **res})
        print(f"[{i + 1} {runs[-1]['tree']}] " + "; ".join(
            _summary(part, res) for part in parts) + f" on {res['card']}",
            flush=True)
    out = json.dumps({"order": ORDER, "runs": runs})
    if args.output:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(out)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
