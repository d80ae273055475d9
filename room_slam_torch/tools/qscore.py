"""Fit the learned per-candidate quality scorer (counterpart of the JAX
package's ``tools/qscore.py``; the model is ``ops/qscore.py``).

Trains the small rerank MLP on rooms where per-candidate IoU-vs-GT labels
are free, on exactly the pooled candidate sets the serving path produces
(the same ``_forward_val_set`` and view pooling as calibrate / realbench,
optionally checkpoint ensembles). ``--spec specs.json`` pools candidates
from several (checkpoint, data_dir) pairs; ``--synthf v1|v2`` appends the
synthesized furniture candidates to every pool so that the scorer learns
to rank them too.

    python -m room_slam_torch.tools.qscore --checkpoint a/best_model \\
        --data_dir DIR --tta --output qscore_weights.json \\
        [--device cuda|cpu]

The weight JSON (the JAX tool's layout, ``_meta`` included) is read by
``calibrate --qscore``, ``realbench --qscore`` and the serving path. The
fit: a per-room hold-out split from ``numpy.random.default_rng(seed)``,
feature standardization from the fit rows (frozen), full-batch Adam
(``torch.optim.Adam`` with optax's defaults: betas 0.9 / 0.999, eps 1e-8
outside the square root) on the positive-weighted mean sigmoid binary
cross-entropy. Runs on ``--device`` (``cuda`` by default, raising without
a card; the JAX tool runs on its CPU).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from room_slam_torch import resolve_device
from room_slam_torch.data import prng
from room_slam_torch.ops import refine
from room_slam_torch.ops.iou import pairwise_iou_3d
from room_slam_torch.ops.qscore import candidate_features, mlp_apply, mlp_init
from room_slam_torch.tools.calibrate import (_forward_val_set, device_cache,
                                             per_room)


def iou_labels(cached: Dict, iou_thresh: float = 0.25,
               device: str | torch.device = "cuda") -> np.ndarray:
    """``[B, Q]`` bool: the candidate has a same-class valid GT at IoU >=
    ``iou_thresh``."""
    c = device_cache(cached, resolve_device(device))

    def one(boxes, logits, gt_boxes, gt_labels, gt_valid):
        iou = pairwise_iou_3d(boxes, gt_boxes)
        same = logits.argmax(-1)[:, None] == gt_labels[None, :]
        return ((iou >= iou_thresh) & same & gt_valid[None, :]).any(dim=1)

    return per_room(one, c["pred_boxes"], c["pred_logits"], c["gt_boxes"],
                    c["gt_labels"], c["gt_valid"]).cpu().numpy()


def synth_augment(cached: Dict, synthf: str,
                  dev: torch.device) -> Tuple[Dict, np.ndarray]:
    """Append ``synthf`` ("v1" / "v2") synthesized furniture candidates
    (realbench's step) so that the scorer sees injected rows at fit time;
    returns the augmented arrays and a validity mask (invalid synthesized
    slots never reach serving)."""
    fn = (refine.synthesize_furniture_v2 if synthf == "v2"
          else refine.synthesize_furniture)
    c = device_cache(cached, dev)
    b, lg, ob, nv = per_room(fn, c["pred_boxes"], c["pred_logits"],
                             c.get("pred_objectness"), c["raw"], c["length"])
    out = dict(cached)
    if ob is not None:
        out["pred_objectness"] = ob.cpu().numpy()
    out["pred_boxes"], out["pred_logits"] = b.cpu().numpy(), lg.cpu().numpy()
    return out, nv.cpu().numpy()


def _rank_auc(score: np.ndarray, yv: np.ndarray) -> float:
    order = np.argsort(score)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(order))
    n_pos, n_neg = yv.sum(), (1 - yv).sum()
    return float((ranks[yv > 0.5].sum()
                  - n_pos * (n_pos - 1) / 2) / (n_pos * n_neg))


def fit(specs: List[Dict], *, synthf: str | None = None, tta: bool = False,
        batch_size: int = 8, hidden: int = 16, epochs: int = 800,
        lr: float = 3e-3, seed: int = 0, iou: float = 0.25,
        holdout: float = 0.2, device: str | torch.device = "cuda",
        log: Callable = print) -> Tuple[Dict, Dict]:
    """Fit the scorer on the pooled candidates of ``specs`` (a list of
    ``{checkpoint, data_dir[, tta]}``). Returns (the weight JSON's dict:
    the six tensors as lists and ``_meta``, the fit report: train and
    hold-out AUC of the scorer and of the raw confidence, the candidate
    count, the positive rate)."""
    dev = resolve_device(device)
    Xr, yr = [], []                      # per-room flattened arrays
    for sp in specs:
        cached = _forward_val_set(sp["checkpoint"], sp["data_dir"],
                                  batch_size, tta=sp.get("tta", tta),
                                  device=dev)
        if synthf:
            cached, valid = synth_augment(cached, synthf, dev)
        else:
            valid = np.ones(cached["pred_boxes"].shape[:2], bool)
        c = device_cache(cached, dev)
        feats = per_room(candidate_features, c["pred_boxes"],
                         c["pred_logits"], c.get("pred_objectness"),
                         c["raw"], c["length"]).cpu().numpy()
        y = iou_labels(cached, iou, dev)
        for i in range(feats.shape[0]):
            m = valid[i]
            Xr.append(feats[i][m])
            yr.append(y[i][m].astype(np.float32))
        log(f"  spec {sp['data_dir']}: rooms {feats.shape[0]}, "
            f"Q' {feats.shape[1]}")

    B = len(Xr)
    perm = np.random.default_rng(seed).permutation(B)
    n_hold = max(int(B * holdout), 1)
    hold, tr = perm[:n_hold], perm[n_hold:]
    Xtr = np.concatenate([Xr[i] for i in tr])
    ytr = np.concatenate([yr[i] for i in tr])
    Xho = np.concatenate([Xr[i] for i in hold])
    yho = np.concatenate([yr[i] for i in hold])
    log(f"rooms {B} (fit {len(tr)} / report {len(hold)}), "
        f"candidates {len(ytr)}, positives {ytr.mean():.3f}")

    params = mlp_init(prng.key(seed, dev), hidden, Xtr.shape[-1])
    params["mu"] = torch.from_numpy(Xtr.mean(0)).to(dev)
    params["sigma"] = torch.from_numpy(Xtr.std(0) + 1e-6).to(dev)
    pos_w = float((1.0 - ytr.mean()) / max(ytr.mean(), 1e-6))
    trained = [params[k].requires_grad_(True)
               for k in ("w1", "b1", "w2", "b2")]
    opt = torch.optim.Adam(trained, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    X, yv = torch.from_numpy(Xtr).to(dev), torch.from_numpy(ytr).to(dev)
    w = torch.where(yv > 0.5, pos_w, 1.0)
    for e in range(epochs):
        q = mlp_apply(params, X)
        # optax.sigmoid_binary_cross_entropy
        ls = -(yv * F.logsigmoid(q) + (1.0 - yv) * F.logsigmoid(-q))
        loss = torch.sum(ls * w) / torch.sum(w)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if e % 200 == 0:
            log(f"  epoch {e}: loss {loss.item():.4f}")
    params = {k: v.detach() for k, v in params.items()}

    def auc(Xa, ya):
        if ya.sum() == 0 or (1 - ya).sum() == 0:
            return float("nan")
        with torch.no_grad():
            q = mlp_apply(params, torch.from_numpy(Xa).to(dev)).cpu().numpy()
        return _rank_auc(q, ya)

    report = {
        "train_auc": auc(Xtr, ytr), "holdout_auc": auc(Xho, yho),
        "train_conf_auc": _rank_auc(Xtr[:, 0], ytr),
        "holdout_conf_auc": _rank_auc(Xho[:, 0], yho),
        "n_candidates": int(len(ytr)), "pos_rate": float(ytr.mean()),
    }
    out = {k: params[k].cpu().numpy().tolist() for k in sorted(params)}
    out["_meta"] = {"hidden": hidden, "iou": iou, "specs": specs,
                    "tta": bool(tta), "synthf": synthf, "report": report}
    return out, report


def main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None,
                    help="stem or comma-separated stems (candidate pool "
                         "matches the ensemble recipe)")
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--spec", default=None,
                    help="JSON file: list of {checkpoint, data_dir} pairs "
                         "pooled into one training set; overrides "
                         "--checkpoint/--data_dir")
    ap.add_argument("--synthf", default=None, choices=["v1", "v2"],
                    help="append hole/notch-synthesized candidates to "
                         "every pool")
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=800)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iou", type=float, default=0.25)
    ap.add_argument("--holdout", type=float, default=0.2,
                    help="fraction of ROOMS held out for the fit report")
    ap.add_argument("--output", default="results/r4_qscore_weights.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.spec:
        with open(args.spec) as f:
            specs = json.load(f)
    else:
        if not (args.checkpoint and args.data_dir):
            raise SystemExit("--checkpoint/--data_dir or --spec required")
        specs = [{"checkpoint": args.checkpoint, "data_dir": d}
                 for d in args.data_dir.split(",")]
    out, report = fit(specs, synthf=args.synthf, tta=args.tta,
                      batch_size=args.batch_size, hidden=args.hidden,
                      epochs=args.epochs, lr=args.lr, seed=args.seed,
                      iou=args.iou, holdout=args.holdout,
                      device=args.device)
    print(json.dumps(report, indent=1))
    with open(args.output, "w") as f:
        json.dump(out, f)
    print("wrote", args.output)


if __name__ == "__main__":
    main()
