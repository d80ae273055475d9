"""Device mesh and the data, tensor / expert and sequence parallelism of
the port over ``torch.distributed`` (the JAX package's
``parallel/mesh.py``).

A ('data', 'model') mesh (``make_mesh``), or ('data', 'seq', 'model')
(``make_mesh3``), is a ``torch.distributed.device_mesh.DeviceMesh`` over
every rank of the default process group. On it:

- data parallelism: each rank takes its rows of the global batch
  (``data_rows`` / ``shard_batch``); the loss's weighted means divide
  numerators summed over 'data' by denominators summed over 'data'
  (``ops/losses.set_criterion(..., data=)``), so every rank computes the
  one-device loss of the global batch;
- tensor parallelism for the transformer (``shard_params(...,
  tensor_parallel=True)``, the rules ``_TP_RULES`` of the JAX package on
  the JAX names of the port's parameters): q/k/v projections and
  ``linear1`` column-parallel (their outputs stay local), ``out_proj`` and
  ``linear2`` row-parallel (partial products summed over 'model', the bias
  added once after), the MoE's stacked experts split over 'model' (each
  rank runs its own experts, their outputs summed over 'model'), the
  router replicated; a dimension that 'model' does not divide stays
  replicated;
- sequence parallelism on a 'seq' axis: each rank takes a slice of the
  raw trace's L axis; ``featurize_seq`` takes the two rows before the
  slice from the previous rank (the neighbour diffs: velocity, then
  acceleration); the transformer gathers attention K/V and the decoder's
  memory over 'seq' and offsets the positions by the slice's start; a
  recurrence model gathers its whole input first (the recurrence kernels
  take the whole sequence).

The collectives are written by hand (``collectives.py``: autograd
functions on ``torch.distributed.all_reduce`` / ``all_gather``); each
one's backward is its exact adjoint, so the backward of every rank's copy
of the loss is the backward of one global program whose output the ranks
hold in ``world`` copies.
``reduce_gradients`` then sums each parameter's gradient over the ranks
that hold the same values of it and divides by ``world``: the one-device
gradient, on every rank. The optimizer (``train/loop.Optimizer``) clips by
the global norm with each model-sharded parameter counted once over
'model' and each replicated one once.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from room_slam_torch.data.features import featurize, kinematics
from room_slam_torch.models.common import Dense, MoEFFN
from room_slam_torch.parallel.collectives import Axis, all_gather, axis


# --------------------------------------------------------------- meshes


def init_from_env(device: str) -> str:
    """Join the process group a ``torchrun`` launch describes (its
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``): NCCL with this rank on ``cuda:{LOCAL_RANK}`` for a
    CUDA ``device``, gloo for the CPU. Returns this rank's device; without
    ``WORLD_SIZE`` in the environment (or with a group already joined)
    nothing changes."""
    import os

    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl")
        return f"cuda:{local}"
    dist.init_process_group("gloo")
    return device


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(names: Tuple[str, ...], shape: Sequence[int], fill: int):
    """A DeviceMesh of ``names`` over every rank of the default group;
    entry ``fill`` of ``shape``, when 0, takes the ranks the others
    leave."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = [int(s) for s in shape]
    if shape[fill] <= 0:
        rest = math.prod(s for i, s in enumerate(shape) if i != fill)
        shape[fill] = world // max(rest, 1)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=names)


def make_mesh(mesh_shape: Tuple[int, int] = (0, 1)):
    """A 2-D ('data', 'model') mesh. ``(0, 1)``: every rank on 'data'."""
    return build_mesh(("data", "model"), mesh_shape, 0)


def make_mesh3(mesh_shape: Tuple[int, int, int] = (0, 1, 1)):
    """A 3-D ('data', 'seq', 'model') mesh; ``data=0`` takes the rest."""
    return build_mesh(("data", "seq", "model"), mesh_shape, 0)


def make_mesh_from_config(mesh_shape: Tuple[int, ...]):
    """``mesh.mesh_shape`` with 2 entries -> ``make_mesh``, 3 ->
    ``make_mesh3`` (the trainers' entry: ``--set
    mesh.mesh_shape=[2,2,2]`` reaches sequence parallelism)."""
    if len(mesh_shape) == 3:
        return make_mesh3(tuple(mesh_shape))
    if len(mesh_shape) == 2:
        return make_mesh(tuple(mesh_shape))
    raise ValueError(
        f"mesh.mesh_shape must have 2 or 3 entries, got {mesh_shape!r}")


# ----------------------------------------------------------------- batch


def data_rows(batch_size: int, mesh, accum: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch of ``batch_size`` over 'data'.
    With ``accum`` microbatches the rows are this rank's share of each
    microbatch (``[accum, n_data, rows]`` order), so that the microbatch
    split of every rank's shard lines up with the split of the global
    batch."""
    d = axis(mesh, "data")
    if batch_size % (d.size * accum):
        raise ValueError(f"batch {batch_size} does not split into {accum} "
                         f"microbatches over {d.size} data ranks")
    rows = torch.arange(batch_size).view(accum, d.size, -1)
    return rows[:, d.rank].reshape(-1)


def shard_batch(batch: Dict[str, Any], mesh, accum: int = 1,
                device: torch.device | str | None = None
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch dict (numpy or tensors): its
    rows over 'data' (``data_rows``) and, on a mesh whose 'seq' is above 1,
    its slice of ``raw``'s L axis. Collider slots are a set, not a
    sequence: they stay whole along 'seq'."""
    s = axis(mesh, "seq")
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device is not None:
            t = t.to(device)
        t = t[data_rows(t.shape[0], mesh, accum).to(t.device)]
        if k == "raw" and s.size > 1:
            n = t.shape[1]
            if n % s.size:
                raise ValueError(f"sequence length {n} does not split over "
                                 f"{s.size} seq ranks")
            t = t.narrow(1, s.rank * (n // s.size), n // s.size)
        out[k] = t
    return out


def featurize_seq(raw: torch.Tensor, length: torch.Tensor, seq: Axis
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``featurize`` of this rank's slice ``[B, Ls, 4]`` of a trace split
    over ``seq``: the rows of the whole trace's features that the slice
    holds, and their mask. The two rows before the slice come from the
    previous rank (velocity is a diff, acceleration a diff of velocity);
    rank 0 keeps the first-row rule, and time counts from the whole
    trace's first row."""
    if seq.size == 1:
        return featurize(raw, length)
    Ls = raw.shape[-2]
    heads = all_gather(raw[:, :1].detach(), seq, 1)          # [B, S, 4]
    tails = all_gather(raw[:, -2:].detach(), seq, 1)         # [B, 2S, 4]
    t0 = heads[:, :1, 3:4]
    if seq.rank == 0:
        feats = kinematics(raw, t0)
    else:
        halo = tails[:, 2 * (seq.rank - 1): 2 * seq.rank]
        feats = kinematics(torch.cat([halo, raw], dim=1), t0)[:, 2:]
    pos = torch.arange(Ls, device=raw.device) + seq.rank * Ls
    mask = pos < length[..., None]
    return feats * mask[..., None].to(raw.dtype), mask


# -------------------------------------------------- tensor parallelism

# (regex on the JAX path 'a/b/c', spec over the JAX layout). First match
# wins; everything else is replicated. The JAX package's table.
_TP_RULES = [
    (r".*(self_attn|cross_attn)/(q_proj|k_proj|v_proj)/kernel",
     (None, "model")),
    (r".*(self_attn|cross_attn)/(q_proj|k_proj|v_proj)/bias", ("model",)),
    (r".*(self_attn|cross_attn)/out_proj/kernel", ("model", None)),
    (r".*linear1/kernel", (None, "model")),
    (r".*linear1/bias", ("model",)),
    (r".*linear2/kernel", ("model", None)),
    (r".*moe/w1", ("model", None, None)),
    (r".*moe/w2", ("model", None, None)),
    (r".*moe/b1", ("model", None)),
    (r".*moe/b2", ("model", None)),
]


def _jax_path(name: str, norms: set) -> Tuple[str, bool]:
    """The JAX path of a parameter name and whether its layout is the JAX
    one transposed (a dense kernel)."""
    head, _, leaf = name.rpartition(".")
    if leaf == "weight" and head not in norms:
        return f"{head}.kernel".replace(".", "/"), True
    if leaf == "weight":
        return f"{head}.scale".replace(".", "/"), False
    return name.replace(".", "/"), False


def param_shardings(model: nn.Module, mesh, tensor_parallel: bool = False
                    ) -> Dict[str, Tuple]:
    """The spec of each parameter of ``model`` over its own layout: a
    tuple with "model" on the dimension split over 'model', ``()`` for a
    replicated one (everything without ``tensor_parallel``)."""
    norms = {n for n, m in model.named_modules()
             if isinstance(m, nn.LayerNorm)}
    n_model = axis(mesh, "model").size
    out = {}
    for name, p in model.named_parameters():
        spec: Tuple = ()
        if tensor_parallel:
            path, transposed = _jax_path(name, norms)
            for pattern, s in _TP_RULES:
                if re.fullmatch(pattern, path) and len(s) == p.dim():
                    spec = tuple(reversed(s)) if transposed else s
                    break
            if any(a == "model" and p.shape[d] % n_model
                   for d, a in enumerate(spec)):
                spec = ()
        out[name] = spec
    return out


class Placement:
    """A model's mesh and the spec of each of its parameters
    (``model.placement``). Deep copies share it."""

    def __init__(self, mesh, shardings: Dict[str, Tuple]):
        self.mesh = mesh
        self.shardings = shardings

    def __deepcopy__(self, memo):
        return self

    def sharded(self, name: str) -> bool:
        return "model" in self.shardings.get(name, ())


def shard_params(model: nn.Module, mesh, tensor_parallel: bool = False
                 ) -> nn.Module:
    """Place ``model`` on ``mesh`` in place: every parameter takes global
    rank 0's values (a replicated start), a parameter that
    ``param_shardings`` splits keeps this rank's slice over 'model', and
    the modules learn the axes they reduce over (``Dense.parallel``,
    ``MoEFFN.experts`` / ``token_axes``, ``seq`` on the encoders). Returns
    ``model``."""
    shardings = param_shardings(model, mesh, tensor_parallel)
    m_ax, d_ax, s_ax = (axis(mesh, n) for n in ("model", "data", "seq"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if dist.get_world_size() > 1:
                dist.broadcast(p.data, src=0)
            spec = shardings[name]
            if "model" in spec:
                d = spec.index("model")
                n = p.shape[d] // m_ax.size
                p.data = p.data.narrow(d, m_ax.rank * n, n).clone()
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, Dense) and \
                "model" in shardings.get(prefix + "weight", ()):
            kind = ("column" if shardings[prefix + "weight"][0] == "model"
                    else "row")
            mod.parallel = (m_ax, kind)
        if isinstance(mod, MoEFFN):
            mod.token_axes = (d_ax, s_ax)
            if "model" in shardings[prefix + "w1"]:
                mod.experts = (m_ax, m_ax.rank * mod.w1.shape[0])
        if hasattr(mod, "seq"):
            mod.seq = s_ax
    model.placement = Placement(mesh, shardings)
    return model


def _flat_all_reduce(tensors: List[torch.Tensor], axes: Iterable[Axis]):
    axes = [a for a in axes if a.size > 1]
    if not tensors or not axes:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for a in axes:
        dist.all_reduce(flat, group=a.group)
    off = 0
    for t in tensors:
        t.copy_(flat[off: off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def reduce_gradients(model: nn.Module) -> None:
    """Turn every rank's gradients of its copy of the loss into the
    one-device gradient: sum each over the ranks holding the same values
    of the parameter (every rank for a replicated one; the ranks of its
    'model' coordinate for a sharded one) and divide by the world size.
    Missing gradients count as zeros."""
    pl = model.placement
    mesh = pl.mesh
    axes = {n: axis(mesh, n) for n in mesh.mesh_dim_names}
    reps, shards = [], []
    for name, p in model.named_parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        (shards if pl.sharded(name) else reps).append(p.grad)
    _flat_all_reduce(reps, axes.values())
    _flat_all_reduce(shards, [a for n, a in axes.items() if n != "model"])
    world = math.prod(mesh.shape)
    for g in reps + shards:
        g.div_(world)


def grad_norm_sq(model: nn.Module, grads: List[torch.Tensor]
                 ) -> torch.Tensor:
    """Squared global norm of ``grads`` (``model.parameters()``' order):
    a model-sharded parameter's slices summed over 'model', a replicated
    one counted once."""
    pl = model.placement
    rep = torch.zeros((), device=grads[0].device)
    shard = torch.zeros((), device=grads[0].device)
    for (name, _), g in zip(model.named_parameters(), grads):
        if pl.sharded(name):
            shard = shard + (g * g).sum()
        else:
            rep = rep + (g * g).sum()
    m = axis(pl.mesh, "model")
    if m.size > 1:
        dist.all_reduce(shard, group=m.group)
    return rep + shard


def gather_params(model: nn.Module,
                  named: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, np.ndarray]:
    """Tensors laid out as a placed model's parameters (by default the
    parameters themselves, or ``named``: e.g. the optimizer's EMA) made
    whole, slices over 'model' gathered, as numpy arrays keyed by name."""
    pl = model.placement
    m = axis(pl.mesh, "model")
    if named is None:
        named = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for name, t in named.items():
            t = t.detach()
            if pl.sharded(name):
                t = all_gather(t, m, pl.shardings[name].index("model"))
            out[name] = t.cpu().numpy()
    return out
