"""Pipeline parallelism: GPipe microbatch streaming over a 'stage' mesh
axis (the JAX package's ``parallel/pipeline.py``).

The schedule is the program, as in the JAX package: the stacked per-layer
parameters split their leading (layer) dim over 'stage', so each rank
holds one layer (``shard_pipeline_params``); this rank's batch splits
into M microbatches that run M + S - 1 ticks. At tick t stage 0 reads
microbatch t, every other stage the activation its left neighbour sent at
the end of tick t - 1; every stage sends its output to its right
neighbour (a ring shift by +1, point to point: ``_RingShift``, whose
backward sends the cotangent the other way; the identity on a ring of one
rank); the last stage keeps its
output for microbatch j = t - s when 0 <= j < M. At the end the last
stage's outputs reach every stage (a sum of the one-hot-masked outputs
over 'stage'). Every stage runs every tick's ``stage_fn``, also on the
fill and drain ticks whose results nobody reads, so that the ranks'
autograd graphs have one shape and their backward passes exchange their
cotangents in the same order.

Gradients: ``pipeline_apply`` takes ``x`` replicated over 'stage' and
returns its output replicated over 'stage'. The backward of one rank's
copy of a loss of the output gives that rank's stage parameters their
gradient and ``x`` its whole gradient (the input enters through an
identity whose backward sums over 'stage'; the output's sum over 'stage'
passes the cotangent through unchanged). With a 'data' axis each rank
pipelines its own rows; their parameter gradients are summed over 'data'
by the caller, as for data parallelism.

This is bubble-inclusive GPipe (bubble fraction (S - 1) / (M + S - 1)).
The payload here is a stack of identical BiLSTM layers
(``bilstm_stage_fn``, through ``ops/rnn.lstm_recurrence``: on the card
the single-direction LSTM kernels #3t / #4 under grad, #3 without), but
``pipeline_apply`` takes any ``stage_fn(params_s, x) -> y`` with ``y`` of
``x``'s shape.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from room_slam_torch.ops.rnn import lstm_recurrence
from room_slam_torch.parallel.collectives import axis
from room_slam_torch.parallel.mesh import build_mesh

Params = Dict[str, torch.Tensor]


def make_pipeline_mesh(mesh_shape: Tuple[int, int] = (1, 0)):
    """A ('data', 'stage') mesh over every rank; ``stage=0`` takes the
    ranks 'data' leaves."""
    return build_mesh(("data", "stage"), mesh_shape, 1)


def stack_stage_params(per_stage: Sequence[Params]) -> Params:
    """Stack S per-stage parameter dicts along a new leading dim."""
    return {k: torch.stack([p[k] for p in per_stage])
            for k in per_stage[0]}


class StageParams(dict):
    """This rank's stage of stacked pipeline parameters (each ``[1,
    ...]``) and the number of stages the stack had (``num_stages``)."""

    num_stages: int = 0


def shard_pipeline_params(stacked: Params, mesh) -> StageParams:
    """This rank's layer of stacked ``[S, ...]`` parameters: its index
    along 'stage', as ``[1, ...]`` copies."""
    s = axis(mesh, "stage")
    out = StageParams({k: v[s.rank: s.rank + 1].detach().clone()
                       for k, v in stacked.items()})
    out.num_stages = next(iter(stacked.values())).shape[0]
    return out


def _ring_peers(mesh) -> Tuple[int, int]:
    """Global ranks of this rank's left and right neighbours along
    'stage' (a ring)."""
    d, s = mesh.get_coordinate()
    row = mesh.mesh[d]
    S = row.numel()
    return int(row[(s - 1) % S]), int(row[(s + 1) % S])


def _exchange(send: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    if to == frm == dist.get_rank():
        # a ring of one rank: the shift is the identity, as a ppermute
        # over a one-device axis is
        return send.view_as(send)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), to),
           dist.P2POp(dist.irecv, recv, frm)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingShift(torch.autograd.Function):
    """Send ``y`` to the right neighbour and return what the left one
    sent; the backward sends the cotangent left and takes the right
    neighbour's."""

    @staticmethod
    def forward(ctx, y, left, right):
        ctx.left, ctx.right = left, right
        return _exchange(y, right, left)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.left, ctx.right), None, None


class _CopyToStages(torch.autograd.Function):
    """The identity; the backward sums the cotangent over 'stage'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverStages(torch.autograd.Function):
    """The sum over 'stage'; the backward passes the cotangent through
    (every rank holds the same loss of the replicated result)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stage_params: Params, x: torch.Tensor, mesh,
                   num_microbatches: int) -> torch.Tensor:
    """Run ``x`` through S stages with GPipe microbatch pipelining.

    Args:
        stage_fn: ``(params_s, x_mb) -> y_mb`` for one stage, ``y_mb`` of
            ``x_mb``'s shape.
        stage_params: ``shard_pipeline_params``'s ``StageParams`` (or the
            whole ``[S, ...]`` stack, of which this rank takes its layer).
        x: this rank's rows ``[B, ...]`` (its 'data' shard), the same on
            every stage.
        mesh: a ('data', 'stage') mesh (``make_pipeline_mesh``).
        num_microbatches: M; ``B`` must divide by it.

    Returns:
        ``[B, ...]``: the last stage's output, on every stage.
    """
    st = axis(mesh, "stage")
    S, M = st.size, num_microbatches
    n_params = (stage_params.num_stages
                if isinstance(stage_params, StageParams)
                else next(iter(stage_params.values())).shape[0])
    if n_params != S:
        # one layer per rank: any other split would run the wrong layers
        raise ValueError(
            f"stage_params has {n_params} stages but the mesh 'stage' "
            f"axis has {S} ranks; they must match (one layer per rank)")
    row = 0 if isinstance(stage_params, StageParams) else st.rank
    params = {k: v[row] for k, v in stage_params.items()}
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    left, right = _ring_peers(mesh)
    x_mbs = _CopyToStages.apply(x, st.group).reshape(M, B // M,
                                                     *x.shape[1:])
    first = torch.tensor(st.rank == 0)
    last = torch.tensor(st.rank == S - 1)
    buf = torch.zeros_like(x_mbs[0])
    outs = [torch.zeros_like(x_mbs[0]) for _ in range(M)]
    for t in range(M + S - 1):
        inp = torch.where(first, x_mbs[min(t, M - 1)], buf)
        y = stage_fn(params, inp)
        # this stage works on microbatch j, valid when 0 <= j < M; y joins
        # the outputs on every rank and tick, masked, so that every tick's
        # shift lies on every rank's backward path
        j = t - st.rank
        jc = min(max(j, 0), M - 1)
        outs[jc] = torch.where(torch.tensor(0 <= j < M) & last, y,
                               outs[jc])
        buf = _RingShift.apply(y, left, right)
    out = torch.where(last, torch.stack(outs), torch.zeros_like(x_mbs))
    return _SumOverStages.apply(out, st.group).reshape(x.shape)


# A concrete homogeneous stage: one BiLSTM layer (d_model -> d_model) on a
# raw parameter dict, the payload of the pipeline tests and chip_smoke.py.


def bilstm_stage_fn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """One bidirectional LSTM layer from a raw parameter dict with keys
    ``w_ih_{fwd,bwd} [D, 4H]``, ``w_hh_{fwd,bwd} [H, 4H]``, ``b_{fwd,bwd}
    [4H]`` (H = D // 2, so the output has the input's shape), each
    direction through ``lstm_recurrence(use_kernel=True)``: the kernels on
    the card, the plain recurrence on the CPU."""
    ys = [lstm_recurrence(x @ p[f"w_ih_{d}"] + p[f"b_{d}"], p[f"w_hh_{d}"],
                          reverse=rev, use_kernel=True)
          for d, rev in (("fwd", False), ("bwd", True))]
    return torch.cat(ys, dim=-1)


def init_bilstm_stage_params(generator: torch.Generator, n_stages: int,
                             d_model: int,
                             device: torch.device | str = "cpu") -> Params:
    """Stacked U(-1/sqrt(H), 1/sqrt(H)) parameters of ``n_stages`` BiLSTM
    stages (the JAX package's init distribution; ``generator`` lives on
    ``device``)."""
    h = d_model // 2
    k = 1.0 / math.sqrt(h)
    shapes = [("w_ih_fwd", (d_model, 4 * h)), ("w_hh_fwd", (h, 4 * h)),
              ("b_fwd", (4 * h,)), ("w_ih_bwd", (d_model, 4 * h)),
              ("w_hh_bwd", (h, 4 * h)), ("b_bwd", (4 * h,))]
    return {name: (torch.rand((n_stages,) + shape, generator=generator,
                              device=device) * 2 - 1) * k
            for name, shape in shapes}


def sequential_apply(stage_fn, stacked: Params,
                     x: torch.Tensor) -> torch.Tensor:
    """What ``pipeline_apply`` computes: the stages back to back on one
    device (the tests' reference)."""
    for s in range(next(iter(stacked.values())).shape[0]):
        x = stage_fn({k: v[s] for k, v in stacked.items()}, x)
    return x
