"""Training CLI of the port (the JAX package's ``train.py --surface bench``).

    python -m room_slam_torch.train --config configs/flagship_v15.json \\
        --data_dir DIR [--val_dir DIR] [--epochs N] [--batch_size B] \\
        [--lr LR] [--max_trace_len L] [--save_dir DIR] [--seed S] \\
        [--set section.key=value ...] [--device cuda|cpu]

The scale-up BiGRU trains from the default config with
``--set model.model_type=bigru --set model.d_model=512 --set
model.num_queries=32 --set model.compute_dtype=bfloat16 --set
data.max_colliders=32 --max_trace_len 5000 --batch_size 128``.

``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given. Prints the summary dict as JSON.
"""

from __future__ import annotations

import argparse
import json

from room_slam_torch.config import ExperimentConfig
from room_slam_torch.train.driver import train_benchmark


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=str, default=None,
                   help="JSON ExperimentConfig to start from")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--val_dir", type=str, default=None,
                   help="default: --data_dir with 'train' replaced by 'val'")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--max_trace_len", type=int, default=None)
    p.add_argument("--save_dir", type=str, default="./checkpoints")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override section.key=value (repeatable)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    cfg = (ExperimentConfig.from_json(args.config) if args.config
           else ExperimentConfig())
    cfg.data.data_dir = args.data_dir
    cfg.data.val_dir = args.val_dir or args.data_dir.replace("train", "val")
    if args.epochs is not None:
        cfg.train.num_epochs = args.epochs
    if args.batch_size is not None:
        cfg.train.batch_size = args.batch_size
    if args.lr is not None:
        cfg.train.lr = args.lr
    if args.max_trace_len is not None:
        cfg.data.max_trace_len = args.max_trace_len
    cfg.train.save_dir = args.save_dir
    cfg.train.seed = args.seed
    cfg.apply_overrides(args.overrides)     # last, as in the JAX CLI
    result = train_benchmark(cfg, device=args.device)
    print(json.dumps({k: v for k, v in result.items()
                      if isinstance(v, (int, float, str))}, indent=2))


if __name__ == "__main__":
    main()
