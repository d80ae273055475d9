"""Training CLI of the port (the JAX package's ``train.py``), both surfaces.

    python -m room_slam_torch.train --config configs/flagship_v15.json \\
        --data_dir DIR [--val_dir DIR] [--epochs N] [--batch_size B] \\
        [--lr LR] [--model lstm|bigru|transformer] [--d_model D] \\
        [--num_queries Q] [--max_trace_len L] [--schedule plateau|cosine] \\
        [--resume STEM] [--save_dir DIR] [--seed S] [--no_fused] \\
        [--set section.key=value ...] [--device cuda|cpu]
    python -m room_slam_torch.train --surface legacy --data_dir DIR \\
        [--epochs N] [--batch_size B] [--lr LR] [--hidden_size 128] \\
        [--seq_len 500] [--max_objects 10] [--save_dir DIR] [--device cuda]

The benchmark surface trains with the fused run (``train_benchmark_fused``:
epochs, validation, the plateau scheduler and the best model on the
device, one host read a segment of epochs), as the JAX package's
``train.py``, unless ``--no_fused``, ``--synthetic`` or ``--resume`` is
given: those take the per-epoch driver (``train_benchmark``: cosine
schedule, periodic checkpoints, resume, recovery).

``--surface auto`` (the default) trains the legacy GRU surface when
``--data_dir`` holds ``*.csv`` traces, else the benchmark surface. The
legacy surface writes ``<save_dir>/best_model_legacy``; its defaults are
the JAX package's (100 epochs, batch 32, lr 1e-3).

The scale-up BiGRU trains from the default config with ``--model bigru
--d_model 512 --num_queries 32 --set model.compute_dtype=bfloat16 --set
data.max_colliders=32 --max_trace_len 5000 --batch_size 128``.
The transformer's fields (``nhead``, ``enc_layers``, ``dec_layers``,
``dim_feedforward``, ``moe_experts``) and ``train.moe_aux_weight`` are set
through ``--set``, as in the JAX CLI: ``--model transformer --set
model.moe_experts=4`` trains the switch-MoE encoder.
``--resume <save_dir>/checkpoint_epoch_N`` (or ``best_model``) continues a
run from the checkpoint's parameters, optimizer state, epoch and plateau
scheduler, as the JAX package's ``--resume`` does.

The flagship's recipe trains on generated rooms (the JAX package's rooms
for the same seed, generated on ``--device``) with a few real captures
tiled in; ``--data_dir`` is then not needed:

    python -m room_slam_torch.train --config configs/flagship_v15.json \
        --synthetic 2048 --synthetic_mode mixed --mix_real DIR \
        --mix_copies C --seed S [--multi_room_prob P] \
        [--wall_adjacent_prob P] [--sim_factor F] [--captures_per_room K] \
        [--evidence_mask]

``--create_sample_data`` writes ``--num_sample_traces`` generated legacy
CSV rooms into ``--data_dir`` (and stops there unless ``--epochs`` is
given).

``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given. Prints the summary dict as JSON.

Several ranks: launch the benchmark surface with ``torchrun``; each rank
joins the process group (NCCL on ``cuda:$LOCAL_RANK``, gloo with
``--device cpu``: ``parallel/mesh.init_from_env``), and both drivers train
on the mesh of ``mesh.mesh_shape`` (default ``[0, 1]``: every rank on
'data'; ``--set mesh.mesh_shape=[2,2,2]`` adds sequence parallelism),
rank 0 printing and writing the checkpoints:

    torchrun --standalone --nproc_per_node 4 -m room_slam_torch.train \
        --config configs/flagship_v15.json --data_dir DIR --device cpu

NCCL takes one card per rank: on a machine with one card only a one-rank
group runs there.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch.distributed as dist

from room_slam_torch.config import ExperimentConfig
from room_slam_torch.data.dataset import TraceColliderArrays
from room_slam_torch.data.legacy import create_sample_data
from room_slam_torch.parallel import mesh as mesh_lib
from room_slam_torch.train.driver import (make_synthetic_datasets,
                                          train_benchmark,
                                          train_benchmark_fused, train_legacy)


def use_fused(args: argparse.Namespace) -> bool:
    """The JAX package's ``train.py`` rule: the fused run unless
    ``--no_fused``, ``--synthetic`` or ``--resume``."""
    return not (args.no_fused or args.synthetic or args.resume)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--surface", choices=["auto", "bench", "legacy"],
                   default="auto")
    p.add_argument("--config", type=str, default=None,
                   help="JSON ExperimentConfig to start from (bench)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="training data (required unless --synthetic)")
    p.add_argument("--val_dir", type=str, default=None,
                   help="default: --data_dir with 'train' replaced by 'val'")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--model", type=str, default=None,
                   help="model.model_type: lstm | bigru | transformer | gru")
    p.add_argument("--d_model", type=int, default=None)
    p.add_argument("--num_queries", type=int, default=None)
    p.add_argument("--max_trace_len", type=int, default=None)
    p.add_argument("--hidden_size", type=int, default=128,
                   help="legacy GRU hidden size")
    p.add_argument("--seq_len", type=int, default=500,
                   help="legacy window length")
    p.add_argument("--max_objects", type=int, default=10,
                   help="legacy object slots")
    p.add_argument("--save_dir", type=str, default="./checkpoints")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--schedule", choices=["plateau", "cosine"], default=None,
                   help="LR schedule: ReduceLROnPlateau (the default) or "
                        "warmup + cosine")
    p.add_argument("--resume", type=str, default=None,
                   help="continue from a checkpoint stem (params + "
                        "optimizer state + epoch + scheduler)")
    p.add_argument("--no_fused", action="store_true",
                   help="train with the per-epoch host loop instead of the "
                        "fused run")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override section.key=value (repeatable)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--create_sample_data", action="store_true",
                   help="write generated legacy CSV rooms into --data_dir")
    p.add_argument("--num_sample_traces", type=int, default=10)
    p.add_argument("--synthetic", type=int, default=None, metavar="N_ROOMS",
                   help="train on N generated rooms instead of --data_dir "
                        "(val: max(N // 8, 4) rooms of another seed)")
    p.add_argument("--synthetic_mode", choices=["agent", "human", "mixed"],
                   default="agent",
                   help="walker of --synthetic: the agent, the human, or "
                        "half each")
    p.add_argument("--multi_room_prob", type=float, default=0.0,
                   help="share of generated layouts that are two rooms "
                        "joined by a doorway")
    p.add_argument("--wall_adjacent_prob", type=float, default=0.0,
                   help="share of generated furniture placed against a "
                        "wall")
    p.add_argument("--sim_factor", type=float, default=None,
                   help="walk duration as a multiple of max_trace_len "
                        "ticks (default: human 2.4, agent 4.0)")
    p.add_argument("--captures_per_room", type=int, default=1,
                   help="independent walks of each generated layout")
    p.add_argument("--evidence_mask", action="store_true",
                   help="drop GT boxes the walk carries no evidence for")
    p.add_argument("--mix_real", type=str, default=None, metavar="DIR",
                   help="with --synthetic: fold the trace/collider pairs "
                        "of DIR into the training set")
    p.add_argument("--mix_copies", type=int, default=16,
                   help="times the --mix_real samples are tiled")
    args = p.parse_args(argv)
    if args.data_dir is None and not args.synthetic:
        p.error("--data_dir is required unless --synthetic is given")
    joined = not dist.is_initialized()
    args.device = mesh_lib.init_from_env(args.device)
    joined = joined and dist.is_initialized()
    try:
        _run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args: argparse.Namespace) -> None:
    if args.create_sample_data:
        create_sample_data(args.data_dir, n_traces=args.num_sample_traces,
                           seed=args.seed, device=args.device)
        if args.epochs is None:
            return

    surface = args.surface
    if surface == "auto":
        d = Path(args.data_dir) if args.data_dir else None
        surface = ("legacy" if d is not None and d.is_dir()
                   and any(d.glob("*.csv")) else "bench")
        print(f"[train] auto-detected surface: {surface}")
    if surface == "legacy":
        result = train_legacy(
            data_dir=args.data_dir,
            epochs=args.epochs if args.epochs is not None else 100,
            batch_size=args.batch_size or 32, lr=args.lr or 1e-3,
            hidden_size=args.hidden_size, seq_len=args.seq_len,
            max_objects=args.max_objects, save_dir=args.save_dir,
            seed=args.seed, device=args.device)
    else:
        cfg = (ExperimentConfig.from_json(args.config) if args.config
               else ExperimentConfig())
        if args.data_dir is not None:
            cfg.data.data_dir = args.data_dir
            cfg.data.val_dir = args.val_dir or args.data_dir.replace(
                "train", "val")
        if args.epochs is not None:
            cfg.train.num_epochs = args.epochs
        if args.batch_size is not None:
            cfg.train.batch_size = args.batch_size
        if args.lr is not None:
            cfg.train.lr = args.lr
        if args.model is not None:
            cfg.model.model_type = args.model
        if args.d_model is not None:
            cfg.model.d_model = args.d_model
        if args.num_queries is not None:
            cfg.model.num_queries = args.num_queries
        if args.max_trace_len is not None:
            cfg.data.max_trace_len = args.max_trace_len
        cfg.train.save_dir = args.save_dir
        cfg.train.seed = args.seed
        if args.schedule is not None:
            cfg.train.lr_schedule = args.schedule
        cfg.apply_overrides(args.overrides)     # last, as in the JAX CLI
        kwargs = {}
        if args.synthetic:
            print(f"[train] generating {args.synthetic} synthetic rooms on "
                  f"{args.device} (mode={args.synthetic_mode})")
            tr, va = make_synthetic_datasets(
                cfg, args.synthetic, cfg.train.seed,
                mode=args.synthetic_mode,
                multi_room_prob=args.multi_room_prob,
                sim_factor=args.sim_factor,
                wall_adjacent_prob=args.wall_adjacent_prob,
                captures_per_room=args.captures_per_room,
                evidence_mask=args.evidence_mask, device=args.device)
            if args.mix_real:
                real = TraceColliderArrays(args.mix_real, cfg.data,
                                           augment=True)
                print(f"[train] mixing {real.n_base} real samples x "
                      f"{args.mix_copies} copies into {tr.n_base} "
                      "synthetic rooms")
                tr = TraceColliderArrays.concat([tr, real],
                                                [1, args.mix_copies])
            kwargs = {"train_ds": tr, "val_ds": va}
        if use_fused(args):
            result = train_benchmark_fused(cfg, device=args.device, **kwargs)
        else:
            result = train_benchmark(cfg, device=args.device,
                                     resume=args.resume, **kwargs)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps({k: v for k, v in result.items()
                          if isinstance(v, (int, float, str))}, indent=2))


if __name__ == "__main__":
    main()
