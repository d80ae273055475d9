"""Training CLI of the port (the JAX package's ``train.py``), both surfaces.

    python -m room_slam_torch.train --config configs/flagship_v15.json \\
        --data_dir DIR [--val_dir DIR] [--epochs N] [--batch_size B] \\
        [--lr LR] [--model lstm|bigru] [--d_model D] [--num_queries Q] \\
        [--max_trace_len L] [--schedule plateau|cosine] [--resume STEM] \\
        [--save_dir DIR] [--seed S] [--set section.key=value ...] \\
        [--device cuda|cpu]
    python -m room_slam_torch.train --surface legacy --data_dir DIR \\
        [--epochs N] [--batch_size B] [--lr LR] [--hidden_size 128] \\
        [--seq_len 500] [--max_objects 10] [--save_dir DIR] [--device cuda]

``--surface auto`` (the default) trains the legacy GRU surface when
``--data_dir`` holds ``*.csv`` traces, else the benchmark surface. The
legacy surface writes ``<save_dir>/best_model_legacy``; its defaults are
the JAX package's (100 epochs, batch 32, lr 1e-3).

The scale-up BiGRU trains from the default config with ``--model bigru
--d_model 512 --num_queries 32 --set model.compute_dtype=bfloat16 --set
data.max_colliders=32 --max_trace_len 5000 --batch_size 128``.
``--resume <save_dir>/checkpoint_epoch_N`` (or ``best_model``) continues a
run from the checkpoint's parameters, optimizer state, epoch and plateau
scheduler, as the JAX package's ``--resume`` does.

``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given. Prints the summary dict as JSON.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from room_slam_torch.config import ExperimentConfig
from room_slam_torch.train.driver import train_benchmark, train_legacy


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--surface", choices=["auto", "bench", "legacy"],
                   default="auto")
    p.add_argument("--config", type=str, default=None,
                   help="JSON ExperimentConfig to start from (bench)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--val_dir", type=str, default=None,
                   help="default: --data_dir with 'train' replaced by 'val'")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--model", type=str, default=None,
                   help="model.model_type: lstm | bigru")
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
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override section.key=value (repeatable)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    surface = args.surface
    if surface == "auto":
        d = Path(args.data_dir)
        surface = "legacy" if d.is_dir() and any(d.glob("*.csv")) else "bench"
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
        cfg.data.data_dir = args.data_dir
        cfg.data.val_dir = args.val_dir or args.data_dir.replace("train",
                                                                 "val")
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
        result = train_benchmark(cfg, device=args.device,
                                 resume=args.resume)
    print(json.dumps({k: v for k, v in result.items()
                      if isinstance(v, (int, float, str))}, indent=2))


if __name__ == "__main__":
    main()
