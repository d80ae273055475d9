"""Training driver and model loading (counterpart of the JAX package's
``train/driver.py``: ``make_synthetic_datasets``, ``train_benchmark_fused``
(the whole run on the device, read back once a segment),
``train_benchmark`` with its per-epoch host loop, ``_check_query_capacity``,
``train_legacy`` and ``load_model_for_inference``).

``train_benchmark`` resumes from a checkpoint (``resume=``) and recovers
from a CUDA runtime error (``max_recoveries``), as the JAX package's does;
its validation runs at ``train.matmul_precision``, as its steps.
``train_benchmark_fused`` does neither, as the JAX package's fused run.

Both benchmark drivers train on a mesh when ``torch.distributed`` is
initialised with more than one rank (a ``torchrun`` launch of the CLI,
``parallel/mesh.init_from_env``), as the JAX drivers do with more than one
device: the mesh of ``cfg.mesh.mesh_shape``, the parameters replicated
(``shard_params`` without tensor parallelism), every rank holding the
whole dataset and plans and training on its part of each batch; only rank
0 prints, logs and writes checkpoints.
"""

from __future__ import annotations

import math
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from room_slam_torch import resolve_device
from room_slam_torch.config import ExperimentConfig, TrainConfig
from room_slam_torch.data import prng, synthetic
from room_slam_torch.data.dataset import TraceColliderArrays
from room_slam_torch.data.legacy import LegacyArrays
from room_slam_torch.models.factory import build_model, count_parameters
from room_slam_torch.models.legacy_gru import RoomSlamGRU
from room_slam_torch.ops.losses import legacy_criterion
from room_slam_torch.parallel import mesh as mesh_lib
from room_slam_torch.train import checkpoint as ckpt_lib
from room_slam_torch.train.loop import (METRIC_KEYS, Batch, Optimizer,
                                        PlateauScheduler, device_plan,
                                        eval_model, fused_run_init,
                                        gather_batch, make_eval_epoch,
                                        make_fused_run, make_optimizer,
                                        make_train_step, matmul_precision,
                                        warmup_cosine_lr)
from room_slam_torch.train.metrics import summarize_metrics
from room_slam_torch.train.torch_import import load_pth_checkpoint
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


# sampling rates of the real captures (the ARKit human stream ~37 Hz; the
# agent's per-frame records downsampled to 30 Hz) and each mode's walk
# duration as a multiple of max_trace_len ticks (human 3587 points -> 1500;
# the agent's minutes-long runs)
HUMAN_HZ, AGENT_HZ = 37.0, 30.0
HUMAN_SIM, AGENT_SIM = 2.4, 4.0


def make_synthetic_datasets(cfg: ExperimentConfig, n_rooms: int,
                            seed: int = 0, mode: str = "agent",
                            multi_room_prob: float = 0.0,
                            sim_factor: float | None = None,
                            wall_adjacent_prob: float = 0.0,
                            captures_per_room: int = 1,
                            evidence_mask: bool = False,
                            device: str | torch.device = "cuda"
                            ) -> Tuple[TraceColliderArrays,
                                       TraceColliderArrays]:
    """Synthetic train and val datasets generated on ``device``, the JAX
    package's rooms for the same seed: train ``n_rooms`` samples from
    ``key(seed)``, val ``max(n_rooms // 8, 4)`` rooms from ``key(seed +
    10_000)`` with one full-GT walk each.

    ``mode``: 'agent' (constant sensor height, 30 Hz), 'human' (waypoint
    walk, phone-height wander, 37 Hz) or 'mixed' (``n // 2`` agent rooms
    from the first half of ``split(key)``, ``n - n // 2`` human rooms from
    the second). Each walk runs ``round(max_trace_len * f)`` ticks (``f``
    = ``sim_factor``, default human 2.4 / agent 4.0) and is downsampled to
    ``max_trace_len``. ``captures_per_room`` and ``evidence_mask`` apply
    to the train split only (``synthetic.generate_rooms_and_traces``)."""
    dev = resolve_device(device)
    L = cfg.data.max_trace_len

    def steps(human: bool) -> int:
        f = sim_factor if sim_factor is not None else (
            HUMAN_SIM if human else AGENT_SIM)
        return int(round(L * f))

    def one(key, n, human, cpr, emask):
        return synthetic.to_numpy(synthetic.generate_rooms_and_traces(
            key, n, L, max_colliders=cfg.data.max_colliders,
            hz=HUMAN_HZ if human else AGENT_HZ, human=human,
            multi_room_prob=multi_room_prob, sim_steps=steps(human),
            wall_adjacent_prob=wall_adjacent_prob, captures_per_room=cpr,
            evidence_mask=emask, device=dev))

    def gen(key, n, cpr, emask):
        if mode == "mixed":
            k1, k2 = prng.split(key).unbind(0)
            a = one(k1, n // 2, False, cpr, emask)
            b = one(k2, n - n // 2, True, cpr, emask)
            return {k: np.concatenate([a[k], b[k]]) for k in a}
        if mode not in ("agent", "human"):
            raise ValueError(f"synthetic mode {mode!r}: expected agent, "
                             "human or mixed")
        return one(key, n, mode == "human", cpr, emask)

    n_val = max(n_rooms // 8, 4)
    train = gen(prng.key(seed), n_rooms, captures_per_room, evidence_mask)
    val = gen(prng.key(seed + 10_000), n_val, 1, False)
    return (TraceColliderArrays.from_arrays(train, cfg.data, augment=True),
            TraceColliderArrays.from_arrays(val, cfg.data, augment=False))


def run_mesh(cfg: ExperimentConfig):
    """``(mesh, rank 0?)``: the mesh of ``cfg.mesh.mesh_shape`` when
    ``torch.distributed`` runs more than one rank, else ``(None, True)``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None, True
    return (mesh_lib.make_mesh_from_config(cfg.mesh.mesh_shape),
            dist.get_rank() == 0)


def fused_segment(num_epochs: int, num_batches: int) -> int:
    """Epochs a fused segment runs between host reads: about 200 optimizer
    steps, at most 20 epochs (the JAX package's rule)."""
    return max(1, min(20, num_epochs, max(1, 200 // num_batches)))


def train_benchmark_fused(cfg: ExperimentConfig,
                          device: str | torch.device = "cuda",
                          verbose: bool = True,
                          train_ds: TraceColliderArrays | None = None,
                          val_ds: TraceColliderArrays | None = None
                          ) -> Dict:
    """Train a benchmark-surface model with the whole run on the device
    (``loop.make_fused_run``): epochs, validation, the plateau scheduler
    and the best parameters, with one host read of the history a segment
    of ``fused_segment`` epochs. Every epoch's index plan is built up front
    and, with both datasets, copied to the device once. The steps and the
    validation run at ``train.matmul_precision``.

    As the JAX package's fused run: the plateau rule applies whatever
    ``train.lr_schedule`` says, no periodic checkpoint is kept and nothing
    resumes; ``best_model`` (the best epoch's evaluation parameters) and
    ``final_model`` (with the optimizer state) are written under
    ``train.save_dir`` with ``history.jsonl``. The augmentation and dropout
    come from one device generator in ``train_benchmark``'s order, so on
    one seed both drivers take the same steps. On several ranks see the
    module docstring."""
    dev = resolve_device(device)
    mesh, rank0 = run_mesh(cfg)
    verbose = verbose and rank0
    t = cfg.train
    if train_ds is None:
        train_ds = TraceColliderArrays(cfg.data.data_dir, cfg.data,
                                       augment=True, verbose=verbose)
    if val_ds is None:
        val_ds = TraceColliderArrays(cfg.data.val_dir, cfg.data,
                                     augment=False, verbose=verbose)
    model = build_model(cfg.model,
                        generator=torch.Generator().manual_seed(t.seed))
    model = model.to(dev)
    if mesh is not None:
        mesh_lib.shard_params(model, mesh)
    n_params = count_parameters(model)
    if verbose:
        print(f"Model parameters: {n_params:,}")
    _check_query_capacity(cfg, train_ds, val_ds)

    # the scheduler's device learning rate goes into AdamW with no host read
    opt = make_optimizer(model, cfg, capturable=dev.type == "cuda")
    run = make_fused_run(model, opt, cfg, mesh)
    sched, best = fused_run_init(cfg, model, opt)

    E = t.num_epochs
    seg = fused_segment(E, train_ds.num_batches(t.batch_size))
    plans_np = [train_ds.epoch_plan(t.batch_size, seed=t.seed + e)
                for e in range(E)]
    val_plan = device_plan(val_ds.epoch_plan(t.batch_size, shuffle=False),
                           dev)
    train_data = device_plan(train_ds.device_arrays(), dev)
    val_data = device_plan(val_ds.device_arrays(), dev)
    gen = torch.Generator(device=dev).manual_seed(t.seed)

    t0 = time.time()
    chunks = []
    for lo in range(0, E, seg):
        idxs = list(range(lo, min(lo + seg, E)))
        plans = device_plan({k: np.stack([plans_np[i][k] for i in idxs])
                             for k in plans_np[0]}, dev)
        epoch_ids = torch.tensor(idxs, dtype=torch.int32, device=dev)
        sched, best, hist = run(sched, best, train_data, val_data, plans,
                                val_plan, epoch_ids, gen)
        chunks.append({k: v.cpu().numpy() for k, v in hist.items()})
    history = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    best_val = float(best["val_loss"])
    wall = time.time() - t0

    save_dir = Path(t.save_dir)
    if rank0:
        save_dir.mkdir(parents=True, exist_ok=True)
        cfg.to_json(save_dir / "config.json")
    mlog = MetricsLogger(save_dir / "history.jsonl") if rank0 else None
    hist_rows = []
    for e in range(E):
        m = summarize_metrics({k: float(history[k][e]) for k in METRIC_KEYS})
        row = {"epoch": e, "train_loss": float(history["train_loss"][e]),
               "val_loss": float(history["val_loss"][e]),
               "lr": float(history["lr"][e]), **m}
        hist_rows.append(row)
        if mlog is not None:
            mlog.log(**{k: v for k, v in row.items()
                        if isinstance(v, (int, float))})
        if verbose and (e % 10 == 0 or e == E - 1):
            print(f"Epoch {e}: Train {row['train_loss']:.4f} | "
                  f"Val {row['val_loss']:.4f} | mIoU={row['mIoU']:.3f} "
                  f"F1={row['f1']:.3f} ClsAcc={row['cls_acc']:.3f} | "
                  f"LR={row['lr']:.6f}")

    best_epoch = int(best["epoch"])
    best_metrics = hist_rows[best_epoch] if 0 <= best_epoch < E else {}
    if rank0:
        ckpt_lib.save_checkpoint(
            save_dir / "best_model", best["params"], epoch=best_epoch,
            val_loss=best_val, metrics=best_metrics, config=cfg,
            model=model)
        ckpt_lib.save_checkpoint(
            save_dir / "final_model", model.state_dict(), opt.state_dict(),
            epoch=E - 1, val_loss=hist_rows[-1]["val_loss"],
            metrics=hist_rows[-1], config=cfg, model=model)
    if verbose:
        print(f"✓ Saved BEST model from epoch {best_epoch} "
              f"(val_loss={best_val:.4f}) and final model")

    samples_seen = train_ds.num_samples * E
    return {
        "best_val_loss": best_val,
        "best_epoch": best_epoch,
        "history": hist_rows,
        "wall_time_s": wall,
        "samples_seen": samples_seen,
        "samples_per_sec": samples_seen / max(wall, 1e-9),
        "n_params": n_params,
        "save_dir": str(save_dir),
    }


def train_benchmark(cfg: ExperimentConfig,
                    device: str | torch.device = "cuda",
                    verbose: bool = True,
                    train_ds: TraceColliderArrays | None = None,
                    val_ds: TraceColliderArrays | None = None,
                    resume: Optional[str] = None,
                    max_recoveries: int = 3,
                    checkpoint_every: int = 10) -> Dict:
    """Train a benchmark-surface model end to end on ``device``; returns a
    summary dict.

    Per epoch: the learning rate (cosine schedule, or plateau on the
    validation loss), one pass over a shuffled, rotation-expanded index
    plan with augmentation, then every ``val_every`` epochs the validation
    loss and metrics, the best model (``best_model``) and every
    ``checkpoint_every`` epochs (10, the JAX package's) a periodic
    checkpoint (``checkpoint_epoch_<e>``), all in the JAX package's
    checkpoint layout under ``train.save_dir``, with the optimizer state.

    ``resume``: continue from a checkpoint stem (parameters, optimizer
    state, epoch + 1, a finite ``best_val``, the plateau scheduler; the
    learning rate follows the scheduler unless the schedule is cosine).
    Recovery: a ``torch.AcceleratorError`` (the CUDA runtime's error)
    during an epoch's training reloads the last periodic checkpoint, or the
    initial state, moves the data to the device again and redoes the
    epoch; each recovery is printed, and the error is raised again after
    ``max_recoveries``. Nothing else is caught. On several ranks see the
    module docstring."""
    dev = resolve_device(device)
    mesh, rank0 = run_mesh(cfg)
    verbose = verbose and rank0
    t = cfg.train
    if train_ds is None:
        train_ds = TraceColliderArrays(cfg.data.data_dir, cfg.data,
                                       augment=True, verbose=verbose)
    if val_ds is None:
        val_ds = TraceColliderArrays(cfg.data.val_dir, cfg.data,
                                     augment=False, verbose=verbose)

    def fresh(ckpt: Optional[str | Path] = None):
        """Model, optimizer and step from the seed, or from ``ckpt``'s
        parameters and optimizer state; and the checkpoint's sidecar."""
        model = build_model(cfg.model,
                            generator=torch.Generator().manual_seed(t.seed))
        side: Dict = {}
        opt_state = None
        if ckpt is not None:
            params, opt_state, side = ckpt_lib.load_checkpoint(
                ckpt, with_opt_state=True)
            load_params(model, params)
        model = model.to(dev)
        if mesh is not None:
            mesh_lib.shard_params(model, mesh)
        opt = make_optimizer(model, cfg)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        return model, opt, make_train_step(model, opt, cfg, True, mesh), \
            side, opt_state is not None

    model, opt, step, side, has_opt = fresh(resume)
    n_params = count_parameters(model)
    if verbose:
        print(f"Model parameters: {n_params:,}")
    _check_query_capacity(cfg, train_ds, val_ds)

    eval_epoch = make_eval_epoch(cfg, t.iou_thresh, mesh)
    sched = PlateauScheduler(lr=t.lr, factor=t.plateau_factor,
                             patience=t.plateau_patience,
                             cooldown=t.plateau_cooldown,
                             min_lr=t.lr * t.plateau_min_scale)
    save_dir = Path(t.save_dir)
    if rank0:
        save_dir.mkdir(parents=True, exist_ok=True)
        cfg.to_json(save_dir / "config.json")
    mlog = MetricsLogger(save_dir / "history.jsonl") if rank0 else None

    best_val = float("inf")
    start_epoch = 0
    if resume:
        start_epoch = int(side.get("epoch", -1)) + 1
        # a periodic checkpoint's sidecar has val_loss NaN; a NaN best_val
        # would keep every later epoch from saving a best model
        bv = side.get("val_loss")
        if isinstance(bv, (int, float)) and math.isfinite(bv):
            best_val = float(bv)
        if isinstance(side.get("sched"), dict):
            sched.load_state_dict(side["sched"])
        elif has_opt:
            sched.lr = opt.lr
        if t.lr_schedule != "cosine":
            opt.set_learning_rate(sched.lr)
        if verbose:
            print(f"Resumed from {resume} at epoch {start_epoch} "
                  f"(best_val={best_val:.4f}, lr={sched.lr:.6f})")

    # the datasets live on the device for the whole run; epochs only
    # ship index plans
    def put_data():
        return ({k: torch.from_numpy(v).to(dev)
                 for k, v in train_ds.device_arrays().items()},
                {k: torch.from_numpy(v).to(dev)
                 for k, v in val_ds.device_arrays().items()})

    train_data, val_data = put_data()
    val_plan = val_ds.epoch_plan(t.batch_size, shuffle=False)
    gen = torch.Generator(device=dev).manual_seed(t.seed)

    history = []
    samples_seen = 0
    recoveries = 0
    last_ckpt: Optional[Path] = None
    t0 = time.time()
    epoch = start_epoch
    while epoch < t.num_epochs:
        if t.lr_schedule == "cosine":
            opt.set_learning_rate(warmup_cosine_lr(cfg, epoch))
        try:
            plan = train_ds.epoch_plan(t.batch_size, seed=t.seed + epoch)
            nb = plan["base_idx"].shape[0]
            total = torch.zeros((), device=dev)
            for i in range(nb):
                total += step(gather_batch(train_data, plan, i),
                              gen)["total_loss"]
            train_loss = float(total) / nb
        except torch.AcceleratorError as e:
            recoveries += 1
            if recoveries > max_recoveries:
                raise
            print(f"⚠ device failure in epoch {epoch} ({type(e).__name__}); "
                  f"recovery {recoveries}/{max_recoveries} from "
                  f"{last_ckpt or 'initial state'}")
            model, opt, step, side, _ = fresh(last_ckpt)
            epoch = (int(side.get("epoch", epoch - 1)) + 1
                     if last_ckpt is not None else start_epoch)
            train_data, val_data = put_data()
            continue
        samples_seen += train_ds.num_samples

        if (epoch + 1) % t.val_every == 0:
            em = eval_model(model, opt)
            # the reference sets the run's matmul precision process-wide,
            # so its validation (the plateau and best-model decisions)
            # runs at that level too
            with matmul_precision(t.matmul_precision, dev):
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
            if mlog is not None:
                mlog.log(epoch=epoch, train_loss=train_loss,
                         val_loss=val_loss, lr=lr, **metrics)
            if val_loss < best_val:
                best_val = val_loss
                if rank0:
                    ckpt_lib.save_checkpoint(
                        save_dir / "best_model", em.state_dict(),
                        opt.state_dict(), epoch=epoch, val_loss=val_loss,
                        metrics=metrics, config=cfg,
                        extra={"sched": sched.state_dict()}, model=em)
                if verbose:
                    print(f"✓ Saved BEST model (val_loss={best_val:.4f})")
        elif verbose:
            print(f"Epoch {epoch}: Train {train_loss:.4f}")

        if (epoch + 1) % checkpoint_every == 0:
            last_ckpt = save_dir / f"checkpoint_epoch_{epoch}"
            if rank0:
                ckpt_lib.save_checkpoint(
                    last_ckpt, model.state_dict(), opt.state_dict(),
                    epoch=epoch, config=cfg,
                    extra={"sched": sched.state_dict()}, model=model)
        epoch += 1

    wall = time.time() - t0
    return {
        "best_val_loss": best_val,
        "history": history,
        "wall_time_s": wall,
        "samples_seen": samples_seen,
        "samples_per_sec": samples_seen / max(wall, 1e-9),
        "n_params": n_params,
        "save_dir": str(save_dir),
        "start_epoch": start_epoch,
        "recoveries": recoveries,
        "lr": opt.lr,
        "count": opt.count,
    }


def legacy_data(ds: LegacyArrays, device: torch.device) -> Batch:
    """A legacy dataset's windows on ``device``: ``traces [S, seq, 2]``
    (x, y), ``boxes``, ``labels``, ``valid``."""
    arrays = {"traces": ds.traces[:, :, 1:3], "boxes": ds.boxes,
              "labels": ds.labels, "valid": ds.valid}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def legacy_batches(data: Batch, idx: Sequence[int], batch_size: int,
                   seed: int, shuffle: bool) -> Iterator[Batch]:
    """Batches of the windows ``idx`` of device-resident ``data``, shuffled
    by ``numpy.random.default_rng(seed)``; the last one is padded with
    window 0 at ``weight`` 0, as the JAX package's ``train_legacy``
    gathers them."""
    order = (np.random.default_rng(seed).permutation(idx) if shuffle
             else np.asarray(idx))
    dev = data["traces"].device
    for lo in range(0, len(order), batch_size):
        chunk = order[lo: lo + batch_size]
        pad = batch_size - len(chunk)
        sel = np.concatenate([chunk, np.zeros((pad,), chunk.dtype)])
        w = np.ones((batch_size,), np.float32)
        if pad:
            w[-pad:] = 0.0
        batch = {k: v[torch.from_numpy(sel).to(dev).long()]
                 for k, v in data.items()}
        batch["weight"] = torch.from_numpy(w).to(dev)
        yield batch


def legacy_targets(batch: Batch) -> Batch:
    return {"boxes": batch["boxes"], "labels": batch["labels"],
            "valid_mask": batch["valid"]}


def legacy_optimizer(model: nn.Module, lr: float) -> Optimizer:
    """optax's ``chain(clip_by_global_norm(1.0), adamw(lr))``: the trainer's
    optimizer with its defaults (weight decay 1e-4 as optax's adamw, no
    EMA)."""
    return Optimizer(model, ExperimentConfig(train=TrainConfig(lr=lr)))


def make_legacy_step(model: nn.Module, opt: Optimizer
                     ) -> Callable[[Batch, torch.Generator], Batch]:
    """``step(batch, generator) -> losses``: one update of the legacy
    model (train mode, dropout masks from ``generator``); the losses come
    back as detached device tensors."""

    def step(batch: Batch, generator: torch.Generator) -> Batch:
        model.train()
        opt.zero_grad()
        out = model(batch["traces"], generator=generator)
        losses = legacy_criterion(out, legacy_targets(batch), batch["weight"])
        losses["total_loss"].backward()
        opt.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def train_legacy(data_dir: str, epochs: int = 100, batch_size: int = 32,
                 lr: float = 1e-3, hidden_size: int = 128, seq_len: int = 500,
                 max_objects: int = 10, save_dir: str = "./checkpoints",
                 seed: int = 0, val_fraction: float = 0.2,
                 verbose: bool = True,
                 device: str | torch.device = "cuda") -> Dict:
    """Train the legacy GRU surface on ``device`` with the documented
    defaults (batch 32, lr 1e-3, hidden 128, seq 500, max_objects 10, 100
    epochs), as the JAX package's ``train_legacy``: a seeded split of the
    windows (``val_fraction`` for validation), a shuffled pass per epoch,
    the validation loss after each, and the best model saved as
    ``<save_dir>/best_model_legacy`` in the JAX checkpoint layout."""
    dev = resolve_device(device)
    ds = LegacyArrays(data_dir, seq_len=seq_len, max_objects=max_objects)
    n = len(ds)
    n_val = max(1, int(n * val_fraction))
    perm = np.random.default_rng(seed).permutation(n)
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    if verbose:
        print(f"Legacy dataset: {n} windows ({len(train_idx)} train / "
              f"{n_val} val)")

    model = RoomSlamGRU(hidden_size=hidden_size, max_objects=max_objects,
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = legacy_optimizer(model, lr)
    step = make_legacy_step(model, opt)
    data = legacy_data(ds, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    save_path = Path(save_dir)
    save_path.mkdir(parents=True, exist_ok=True)
    best_val = float("inf")
    history = []
    t0 = time.time()
    for epoch in range(epochs):
        total, nb = torch.zeros((), device=dev), 0
        for batch in legacy_batches(data, train_idx, batch_size, seed + epoch,
                                    True):
            total += step(batch, gen)["total_loss"]
            nb += 1
        model.eval()
        vl, nv = torch.zeros((), device=dev), 0
        with torch.no_grad():
            for batch in legacy_batches(data, val_idx, batch_size, 0, False):
                vl += legacy_criterion(model(batch["traces"]),
                                       legacy_targets(batch),
                                       batch["weight"])["total_loss"]
                nv += 1
        train_loss = float(total) / max(nb, 1)
        val_loss = float(vl) / max(nv, 1)
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss})
        if verbose:
            print(f"Epoch {epoch}: Train {train_loss:.4f} | "
                  f"Val {val_loss:.4f}")
        if val_loss < best_val:
            best_val = val_loss
            ckpt_lib.save_checkpoint(save_path / "best_model_legacy",
                                     model.state_dict(), epoch=epoch,
                                     val_loss=val_loss)
    wall = time.time() - t0
    return {
        "best_val_loss": best_val,
        "history": history,
        "wall_time_s": wall,
        "samples_per_sec": epochs * len(train_idx) / max(wall, 1e-9),
        "save_dir": str(save_path),
        "model": model,
        "dataset": ds,
        "val_idx": val_idx,
    }


def load_model_for_inference(checkpoint: str,
                             device: str | torch.device = "cuda"
                             ) -> Tuple[nn.Module, ExperimentConfig]:
    """Rebuild the model of checkpoint stem ``checkpoint`` (``<stem>.json``
    + ``<stem>.msgpack``, as the JAX package and ``train_benchmark`` write
    them), or import a reference ``.pth`` (``train/torch_import.py``:
    ``model_type`` from its ``config``, default ``transformer``, ``d_model``
    256 and ``num_queries`` 50 by default, every other field the default
    config's), load its weights and move it to ``device`` in eval mode."""
    dev = resolve_device(device)
    if checkpoint.endswith(".pth"):
        params, ref_cfg = load_pth_checkpoint(checkpoint)
        cfg = ExperimentConfig()
        cfg.model.model_type = ref_cfg.get("model_type", "transformer")
        cfg.model.d_model = ref_cfg.get("d_model", 256)
        cfg.model.num_queries = ref_cfg.get("num_queries", 50)
    else:
        cfg = ckpt_lib.load_config_from_checkpoint(checkpoint)
        params, _ = ckpt_lib.load_checkpoint(checkpoint)
    model = load_params(build_model(cfg.model), params)
    return model.to(dev).eval(), cfg
