"""Training driver and model loading (counterpart of the JAX package's
``train/driver.py``: ``train_benchmark`` with its per-epoch host loop,
``_check_query_capacity`` and ``load_model_for_inference``).

Not ported: the fused whole-run dispatch (``train_benchmark_fused``),
resuming from a checkpoint, and recovery from a lost device.
"""

from __future__ import annotations

import time
import warnings
from pathlib import Path
from typing import Dict, Tuple

import torch
from torch import nn

from room_slam_torch import resolve_device
from room_slam_torch.config import ExperimentConfig
from room_slam_torch.data.dataset import TraceColliderArrays
from room_slam_torch.models.factory import build_model
from room_slam_torch.train import checkpoint as ckpt_lib
from room_slam_torch.train.loop import (PlateauScheduler, eval_model,
                                        gather_batch, make_eval_epoch,
                                        make_optimizer, make_train_step,
                                        warmup_cosine_lr)
from room_slam_torch.train.metrics import summarize_metrics
from room_slam_torch.utils.logging import MetricsLogger
from room_slam_torch.weights import load_params


def _check_query_capacity(cfg: ExperimentConfig, *datasets) -> None:
    """Warn when a sample has more valid colliders than query slots: the
    matcher then keeps only the first ``num_queries`` valid GT boxes."""
    mv = max((ds.max_valid for ds in datasets if ds is not None), default=0)
    if mv > cfg.model.num_queries:
        warnings.warn(
            f"dataset has samples with {mv} valid colliders but the model "
            f"only has num_queries={cfg.model.num_queries}; the matcher "
            f"will truncate to the first {cfg.model.num_queries} valid GT "
            "boxes per sample (excess GT count as FN). Raise "
            "model.num_queries to cover max_valid.", stacklevel=3)


def train_benchmark(cfg: ExperimentConfig,
                    device: str | torch.device = "cuda",
                    verbose: bool = True,
                    train_ds: TraceColliderArrays | None = None,
                    val_ds: TraceColliderArrays | None = None) -> Dict:
    """Train a benchmark-surface model end to end on ``device``; returns a
    summary dict.

    Per epoch: the learning rate (cosine schedule, or plateau on the
    validation loss), one pass over a shuffled, rotation-expanded index
    plan with augmentation, then every ``val_every`` epochs the validation
    loss and metrics, the best model (``best_model``) and every 10 epochs a
    periodic checkpoint (``checkpoint_epoch_<e>``), all in the JAX
    package's checkpoint layout under ``train.save_dir``."""
    dev = resolve_device(device)
    t = cfg.train
    if verbose and t.matmul_precision != "float32":
        print(f"[train] train.matmul_precision={t.matmul_precision!r} is not "
              "honoured: the port's float32 matmuls run with TF32 off "
              "(model.compute_dtype sets the bf16 streams)")
    if train_ds is None:
        train_ds = TraceColliderArrays(cfg.data.data_dir, cfg.data,
                                       augment=True, verbose=verbose)
    if val_ds is None:
        val_ds = TraceColliderArrays(cfg.data.val_dir, cfg.data,
                                     augment=False, verbose=verbose)

    model = build_model(cfg.model,
                        generator=torch.Generator().manual_seed(t.seed))
    model = model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    if verbose:
        print(f"Model parameters: {n_params:,}")
    _check_query_capacity(cfg, train_ds, val_ds)

    opt = make_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg, augment=True)
    eval_epoch = make_eval_epoch(cfg, t.iou_thresh)
    sched = PlateauScheduler(lr=t.lr, factor=t.plateau_factor,
                             patience=t.plateau_patience,
                             cooldown=t.plateau_cooldown,
                             min_lr=t.lr * t.plateau_min_scale)
    save_dir = Path(t.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    cfg.to_json(save_dir / "config.json")
    mlog = MetricsLogger(save_dir / "history.jsonl")

    # the datasets live on the device for the whole run; epochs only
    # ship index plans
    def to_dev(arrays):
        return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

    train_data = to_dev(train_ds.device_arrays())
    val_data = to_dev(val_ds.device_arrays())
    val_plan = val_ds.epoch_plan(t.batch_size, shuffle=False)
    gen = torch.Generator(device=dev).manual_seed(t.seed)

    best_val = float("inf")
    history = []
    samples_seen = 0
    t0 = time.time()
    for epoch in range(t.num_epochs):
        if t.lr_schedule == "cosine":
            opt.set_learning_rate(warmup_cosine_lr(cfg, epoch))
        plan = train_ds.epoch_plan(t.batch_size, seed=t.seed + epoch)
        nb = plan["base_idx"].shape[0]
        total = torch.zeros((), device=dev)
        for i in range(nb):
            total += step(gather_batch(train_data, plan, i),
                          gen)["total_loss"]
        train_loss = float(total) / nb
        samples_seen += train_ds.num_samples

        if (epoch + 1) % t.val_every == 0:
            em = eval_model(model, opt)
            losses, sums = eval_epoch(em, val_data, val_plan)
            val_loss = float(losses["total_loss"])
            metrics = summarize_metrics({k: float(v)
                                         for k, v in sums.items()})
            if t.lr_schedule == "cosine":
                lr = opt.lr
            else:
                lr = sched.step(val_loss)
                opt.set_learning_rate(lr)
            if verbose:
                print(f"Epoch {epoch}: Train {train_loss:.4f} | "
                      f"Val {val_loss:.4f} | mIoU={metrics['mIoU']:.3f} "
                      f"P={metrics['precision']:.3f} "
                      f"R={metrics['recall']:.3f} F1={metrics['f1']:.3f} "
                      f"ClsAcc={metrics['cls_acc']:.3f} | LR={lr:.6f}")
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "val_loss": val_loss, **metrics})
            mlog.log(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                     lr=lr, **metrics)
            if val_loss < best_val:
                best_val = val_loss
                ckpt_lib.save_checkpoint(
                    save_dir / "best_model", em.state_dict(), epoch=epoch,
                    val_loss=val_loss, metrics=metrics, config=cfg,
                    extra={"sched": sched.state_dict()})
                if verbose:
                    print(f"✓ Saved BEST model (val_loss={best_val:.4f})")
        elif verbose:
            print(f"Epoch {epoch}: Train {train_loss:.4f}")

        if (epoch + 1) % 10 == 0:
            ckpt_lib.save_checkpoint(
                save_dir / f"checkpoint_epoch_{epoch}", model.state_dict(),
                epoch=epoch, config=cfg,
                extra={"sched": sched.state_dict()})

    wall = time.time() - t0
    return {
        "best_val_loss": best_val,
        "history": history,
        "wall_time_s": wall,
        "samples_seen": samples_seen,
        "samples_per_sec": samples_seen / max(wall, 1e-9),
        "n_params": n_params,
        "save_dir": str(save_dir),
    }


def load_model_for_inference(checkpoint: str,
                             device: str | torch.device = "cuda"
                             ) -> Tuple[nn.Module, ExperimentConfig]:
    """Rebuild the model of checkpoint stem ``checkpoint`` (``<stem>.json``
    + ``<stem>.msgpack``, as the JAX package and ``train_benchmark`` write
    them), load its weights and move it to ``device`` in eval mode."""
    if checkpoint.endswith(".pth"):
        raise NotImplementedError(
            "reference .pth checkpoints are not ported yet (ROADMAP queue 1 "
            "item 13)")
    dev = resolve_device(device)
    cfg = ckpt_lib.load_config_from_checkpoint(checkpoint)
    params, _ = ckpt_lib.load_checkpoint(checkpoint)
    model = load_params(build_model(cfg.model), params)
    return model.to(dev).eval(), cfg
