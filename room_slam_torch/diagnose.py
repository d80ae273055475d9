"""Behaviour probes against a trained checkpoint (the root ``diagnose.py``).

Three probes that find a model ignoring its input:
1. trace sensitivity: different random traces must give different outputs;
2. order sensitivity: shuffling the trace must change the outputs;
3. scale proportionality: scaling the coordinates by 2 must scale the
   boxes.

    python -m room_slam_torch.diagnose CHECKPOINT [TRACE.json] \\
        [--device cuda|cpu]

Each forward pads the features to 1000 rows and runs the checkpoint's
model in eval mode without gradients (on the card an ``lstm`` goes through
the light forward #1, ``room_slam::bilstm_fwd``, and a ``bigru`` through
#5). The printed report and the pass / fail rule are the root script's;
each probe also returns the numbers it compares. No matplotlib.
``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from room_slam_torch.data import formats
from room_slam_torch.data.features import process_traces_np
from room_slam_torch.train.driver import load_model_for_inference

PAD_TO = 1000


class Probe(NamedTuple):
    """A probe's verdict, the numbers it compared and the ``pred_boxes``
    of each of its forwards (``[Q, 6]`` each)."""

    ok: bool
    values: dict
    boxes: List[np.ndarray]


@torch.no_grad()
def _forward(model: nn.Module, feats_np: np.ndarray,
             pad_to: int = PAD_TO) -> np.ndarray:
    """``pred_boxes [Q, 6]`` of one trace's features, padded (and masked)
    to ``pad_to`` rows."""
    dev = next(model.parameters()).device
    n = feats_np.shape[0]
    padded = np.zeros((1, pad_to, feats_np.shape[1]), np.float32)
    padded[0, :n] = feats_np[:pad_to]
    mask = np.zeros((1, pad_to), bool)
    mask[0, :n] = True
    out = model(torch.from_numpy(padded).to(dev),
                torch.from_numpy(mask).to(dev))
    return out["pred_boxes"][0].cpu().numpy()


def _feats_from_raw(raw_xyzt: np.ndarray) -> np.ndarray:
    return process_traces_np(raw_xyzt, max_len=PAD_TO)


def _header(title: str) -> None:
    print("\n" + "=" * 60)
    print(title)
    print("=" * 60)


def _load_walk(trace_file: str) -> np.ndarray:
    raw = formats.load_trace_json(trace_file)
    return formats.linspace_downsample(formats.sort_by_time(raw), PAD_TO)


def trace_sensitivity(model: nn.Module, rng: np.random.Generator) -> Probe:
    _header("Test 1: Trace Sensitivity")
    outs = []
    for i in range(3):
        if i < 2:
            raw = rng.normal(size=(1000, 4)).astype(np.float32) * 2.0
            raw[:, 3] = np.sort(rng.uniform(0, 30, 1000))
        else:
            raw = np.zeros((1000, 4), np.float32)
        outs.append(_forward(model, _feats_from_raw(raw)))
    d12 = np.abs(outs[0] - outs[1]).mean()
    d13 = np.abs(outs[0] - outs[2]).mean()
    print(f"  Random1 vs Random2: {d12:.6f}")
    print(f"  Random1 vs Zeros:   {d13:.6f}")
    ok = not (d12 < 0.1 and d13 < 0.1)
    print("  ✅ OK" if ok else "  ❌ PROBLEM: model ignores the trace")
    return Probe(ok, {"d12": float(d12), "d13": float(d13)}, outs)


def order_sensitivity(model: nn.Module, trace_file: str,
                      rng: np.random.Generator) -> Probe:
    _header("Test 2: Trace Order Sensitivity")
    raw = _load_walk(trace_file)
    out1 = _forward(model, _feats_from_raw(raw))
    # shuffle positions while keeping timestamps ascending: this scrambles
    # the path (and its kinematics), which an order-sensitive model must see
    perm = rng.permutation(raw.shape[0])
    shuffled = raw.copy()
    shuffled[:, :3] = raw[perm, :3]
    out2 = _forward(model, _feats_from_raw(shuffled))
    d = np.abs(out1 - out2).mean()
    print(f"  original vs shuffled: {d:.6f}")
    ok = d >= 0.1
    print("  ✅ OK" if ok else "  ❌ PROBLEM: order-insensitive")
    return Probe(bool(ok), {"d": float(d)}, [out1, out2])


def scale_sensitivity(model: nn.Module, trace_file: str) -> Probe:
    _header("Test 3: Trace Scaling Sensitivity")
    raw = _load_walk(trace_file)
    outs = []

    def centers(scale):
        r = raw.copy()
        r[:, :3] *= scale
        outs.append(_forward(model, _feats_from_raw(r)))
        return outs[-1].mean(axis=0)[:3]

    c1, c2, c05 = centers(1.0), centers(2.0), centers(0.5)
    ratio2 = c2 / (c1 + 1e-6)
    print(f"  1x centers: {c1}")
    print(f"  2x ratio:   {ratio2}")
    ok = np.abs(ratio2 - 2.0).mean() < 0.5
    print("  ✅ OK: boxes scale with trace" if ok
          else "  ❌ PROBLEM: boxes don't scale")
    return Probe(bool(ok), {"c1": c1, "c2": c2, "c05": c05,
                            "ratio2": ratio2}, outs)


def run_probes(model: nn.Module, trace_file: str) -> List[tuple]:
    """``(name, Probe)`` of the three probes in the root script's order,
    on one ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [("Trace Sensitivity", trace_sensitivity(model, rng)),
            ("Trace Order", order_sensitivity(model, trace_file, rng)),
            ("Trace Scaling", scale_sensitivity(model, trace_file))]


def summarize(results: List[tuple]) -> int:
    """Print the diagnosis summary; returns the number of probes passed."""
    _header("DIAGNOSIS SUMMARY")
    for name, probe in results:
        print(f"{'✅ PASS' if probe.ok else '❌ FAIL'}: {name}")
    passed = sum(probe.ok for _, probe in results)
    print(f"\nPassed: {passed}/{len(results)}")
    if passed == 0:
        print("\n⚠️  SEVERE OVERFITTING: model is not using the traces. "
              "Increase augmentation / regularization, or collect more "
              "varied rooms.")
    elif passed < len(results):
        print("\n⚠️  PARTIAL OVERFITTING: model uses traces but may "
              "memorize patterns.")
    else:
        print("\n✅ Model appears to be learning from traces!")
    return passed


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint")
    p.add_argument("trace_file", nargs="?",
                   default="dataset/val/human_data_20251016_204024.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    print(f"Loading model from {args.checkpoint}")
    model, _ = load_model_for_inference(args.checkpoint, args.device)
    summarize(run_probes(model, args.trace_file))


if __name__ == "__main__":
    main()
