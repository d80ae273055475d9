"""Rank programs of the parallelism tests: gloo CPU ranks spawned from a
test, torch only (the ranks import no JAX), each case's result written by
rank 0 to ``<out>/<case>.pt``.

``spawn(world, tmp, cases)`` runs ``cases`` (name -> (function, payload))
in ``world`` fresh processes over a ``FileStore`` rendezvous in ``tmp``
(no TCP port, so parallel test workers do not collide) and returns each
case's result."""

import os
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from room_slam_torch.config import ExperimentConfig
from room_slam_torch.models.factory import build_model
from room_slam_torch.parallel import collectives as coll
from room_slam_torch.parallel import mesh as mesh_lib
from room_slam_torch.parallel import pipeline as pipe
from room_slam_torch.train import loop as tloop
from room_slam_torch.weights import load_params


def _rank_main(rank, world, tmp, cases):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world)
    try:
        for name, (fn, payload) in cases.items():
            out = fn(payload)
            if rank == 0:
                torch.save(out, f"{tmp}/{name}.pt")
    finally:
        dist.destroy_process_group()


def spawn(world, tmp, cases):
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.start_processes(_rank_main, args=(world, str(tmp), cases),
                       nprocs=world, start_method="spawn", join=True)
    return {name: torch.load(tmp / f"{name}.pt", weights_only=False)
            for name in cases}


def model_of(cfg_dict, params):
    cfg = ExperimentConfig.from_dict(cfg_dict)
    return cfg, load_params(build_model(cfg.model), params)


def train_step(p):
    """One step of ``make_train_step`` on the mesh ``p["mesh"]`` from the
    bridged parameters ``p["params"]`` and the global batch ``p["batch"]``;
    returns the losses, the whole updated parameters, their EMA and the
    clipped gradients the update took, and the parameters split over
    'model'."""
    cfg, model = model_of(p["cfg"], p["params"])
    mesh = mesh_lib.make_mesh_from_config(p["mesh"])
    mesh_lib.shard_params(model, mesh, p.get("tensor_parallel", False))
    opt = tloop.make_optimizer(model, cfg)
    step = tloop.make_train_step(model, opt, cfg, p.get("augment", False),
                                 mesh)
    batch = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    gen = torch.Generator().manual_seed(p.get("seed", 0))
    losses = [{k: float(v) for k, v in step(batch, gen).items()}
              for _ in range(p.get("steps", 1))]
    return {"losses": losses,
            "params": mesh_lib.gather_params(model),
            "ema": (mesh_lib.gather_params(model, opt.ema)
                    if opt.ema is not None else None),
            "grads": mesh_lib.gather_params(
                model, {n: q.grad for n, q in model.named_parameters()}),
            "sharded": sorted(n for n in model.placement.shardings
                              if model.placement.sharded(n))}


def eval_epoch(p):
    """``make_eval_epoch`` on the mesh over a plan of device arrays."""
    cfg, model = model_of(p["cfg"], p["params"])
    mesh = mesh_lib.make_mesh_from_config(p["mesh"])
    mesh_lib.shard_params(model, mesh)
    data = {k: torch.from_numpy(v) for k, v in p["data"].items()}
    losses, sums = tloop.make_eval_epoch(cfg, 0.5, mesh)(model, data,
                                                         p["plan"])
    return ({k: float(v) for k, v in losses.items()},
            {k: float(v) for k, v in sums.items()})


def pipeline_run(p):
    """``pipeline_apply`` of ``bilstm_stage_fn`` on a ('data', 'stage')
    mesh: the output and the gradients of ``mean(out ** 2)`` over the
    global batch, all gathered whole (stage parameters over 'stage', rows
    over 'data')."""
    mesh = pipe.make_pipeline_mesh(p["mesh"])
    stacked = {k: torch.from_numpy(v) for k, v in p["params"].items()}
    local = pipe.shard_pipeline_params(stacked, mesh)
    for v in local.values():
        v.requires_grad_(True)
    d, s = coll.axis(mesh, "data"), coll.axis(mesh, "stage")
    x = torch.from_numpy(p["x"])
    rows = mesh_lib.data_rows(x.shape[0], mesh)
    xl = x[rows].clone().requires_grad_(True)
    out = pipe.pipeline_apply(pipe.bilstm_stage_fn, local, xl, mesh,
                              p["microbatches"])
    (out.pow(2).sum() / out[:1].numel() / x.shape[0]).backward()
    with torch.no_grad():
        grads = {k: coll.all_gather(
            coll.all_reduce(v.grad, d), s, 0).numpy()
            for k, v in local.items()}
    return {"out": coll.all_gather(out.detach(), d, 0).numpy(),
            "grads": grads,
            "gx": coll.all_gather(xl.grad, d, 0).numpy()}


def pipeline_mismatch(p):
    """The stage-count error message (or None if nothing raised)."""
    mesh = pipe.make_pipeline_mesh(p["mesh"])
    stacked = {k: torch.from_numpy(v) for k, v in p["params"].items()}
    try:
        pipe.pipeline_apply(pipe.bilstm_stage_fn, stacked,
                            torch.zeros(8, 4, 8), mesh, 4)
    except ValueError as e:
        return str(e)
    return None


def featurize_slices(p):
    """``featurize_seq`` of every rank's slice of ``p["raw"]``, gathered
    whole over 'seq' (rows over 'data')."""
    mesh = mesh_lib.make_mesh_from_config(p["mesh"])
    raw = torch.from_numpy(p["raw"])
    length = torch.from_numpy(p["length"])
    local = mesh_lib.shard_batch({"raw": raw, "length": length}, mesh)
    seq, data = coll.axis(mesh, "seq"), coll.axis(mesh, "data")
    feats, mask = mesh_lib.featurize_seq(local["raw"], local["length"], seq)
    return tuple(coll.all_gather(coll.all_gather(t, seq, 1), data,
                                 0).numpy() for t in (feats, mask))


def drivers(p):
    """One epoch of ``train_benchmark_fused``, ``train_benchmark`` and the
    CLI on the ranks' mesh, each rank saving under ``<dir>/<name>_r<rank>``;
    the histories and what each rank's save directory holds."""
    from room_slam_torch.train.__main__ import main
    from room_slam_torch.train.driver import (train_benchmark,
                                              train_benchmark_fused)

    cfg = ExperimentConfig.from_dict(p["cfg"])
    rank = dist.get_rank()
    out = {}
    for name, fn in (("fused", train_benchmark_fused),
                     ("epoch", train_benchmark)):
        cfg.train.save_dir = f"{p['dir']}/{name}_r{rank}"
        res = fn(cfg, device="cpu", verbose=False)
        out[name] = [{k: v for k, v in row.items()
                      if k in ("train_loss", "val_loss")}
                     for row in res["history"]]
    main(["--data_dir", cfg.data.data_dir, "--val_dir", cfg.data.val_dir,
          "--epochs", "1", "--batch_size", str(cfg.train.batch_size),
          "--max_trace_len", str(cfg.data.max_trace_len), "--model",
          "lstm", "--d_model", "16", "--num_queries", "12", "--save_dir",
          f"{p['dir']}/cli_r{rank}", "--device", "cpu"])
    saved = Path(p["dir"]).rglob(f"*_r{rank}/*")
    out["files"] = {rank: sorted(str(f.relative_to(p["dir"]))
                                 for f in saved)}
    files = [None] * dist.get_world_size()
    dist.all_gather_object(files, out["files"])
    out["files"] = {k: v for f in files for k, v in f.items()}
    return out
