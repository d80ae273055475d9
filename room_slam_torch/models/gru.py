"""BiGRU encoder and query decoder, the scale-up model family (counterpart
of the JAX package's ``models/gru.py``).

A bidirectional GRU encoder with torch ``nn.GRU`` numerics feeding the
same ``SimpleQueryDecoder`` and output contract as the ``lstm`` model. The
input gate matmuls for the whole sequence run outside the time loop; the
recurrence is ``ops/gru_cuda.bigru_recurrence``, which launches the CUDA
kernels for CUDA tensors and runs the plain loop for CPU tensors.

With ``compute_dtype="bfloat16"`` every ``[B, N, *]`` stream (the encoder
projections, the gate streams and the recurrence's outputs and residuals,
the decoder's q/k/v) is bfloat16; parameters, carries, the softmax and the
heads stay float32, and the outputs are float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from room_slam_torch.data.features import trace_stats
from room_slam_torch.models.common import (Dense, assemble_output,
                                           center_traces_xz,
                                           compute_dtype_of, dropout,
                                           reset_parameters)
from room_slam_torch.models.lstm import SimpleQueryDecoder
from room_slam_torch.ops.gru_cuda import bigru_recurrence
from room_slam_torch.ops.rnn import input_gates
from room_slam_torch.parallel.collectives import ONE_RANK, gather_sequence


class BiGRULayer(nn.Module):
    """One bidirectional GRU layer; output = concat(fwd, bwd), ``[B, N, 2H]``
    in the compute dtype.

    Weights keep the JAX layout: ``w_ih_* [in, 3H]``, ``b_ih_* [3H]``,
    ``w_hh_* [H, 3H]``, ``b_hh_* [3H]``, gate order r, z, n, all
    U(-1/sqrt(H), 1/sqrt(H)) as torch ``nn.GRU``."""

    def __init__(self, d_in: int, hidden: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        for d in ("fwd", "bwd"):
            self.register_parameter(
                f"w_ih_{d}", nn.Parameter(torch.empty(d_in, 3 * hidden)))
            self.register_parameter(
                f"b_ih_{d}", nn.Parameter(torch.empty(3 * hidden)))
            self.register_parameter(
                f"w_hh_{d}", nn.Parameter(torch.empty(hidden, 3 * hidden)))
            self.register_parameter(
                f"b_hh_{d}", nn.Parameter(torch.empty(3 * hidden)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        k = 1.0 / math.sqrt(self.hidden)
        for p in self.parameters(recurse=False):
            p.uniform_(-k, k, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        ys_f, ys_b = bigru_recurrence(
            input_gates(x, self.w_ih_fwd, self.b_ih_fwd),
            input_gates(x, self.w_ih_bwd, self.b_ih_bwd),
            self.w_hh_fwd.contiguous(), self.b_hh_fwd,
            self.w_hh_bwd.contiguous(), self.b_hh_bwd)
        return torch.cat([ys_f, ys_b], dim=-1)


class GRUTraceEncoder(nn.Module):
    """Linear proj -> stacked BiGRU -> linear out, plus the masked
    coordinate statistics used for relative decoding."""

    def __init__(self, input_dim: int = 11, d_model: int = 512,
                 num_layers: int = 2, dropout: float = 0.1,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        hidden = d_model // 2
        self.dropout = dropout
        self.num_layers = num_layers
        self.input_proj = Dense(input_dim, d_model, dtype=compute_dtype)
        for layer in range(num_layers):
            self.add_module(f"gru_{layer}", BiGRULayer(
                d_model if layer == 0 else 2 * hidden, hidden, compute_dtype))
        self.out_proj = Dense(2 * hidden, d_model, dtype=compute_dtype)

    def forward(self, traces: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        B, N, _ = traces.shape
        coords = traces[..., :3]
        if mask is None:
            mask = torch.ones(B, N, dtype=torch.bool, device=traces.device)
        mean, scale = trace_stats(coords, mask)
        x = self.input_proj(traces)
        for layer in range(self.num_layers):
            x = getattr(self, f"gru_{layer}")(x)
            if layer < self.num_layers - 1:
                x = dropout(x, self.dropout, self.training, generator)
        return self.out_proj(x), coords, mean, scale


class TraceToColliderGRU(nn.Module):
    """BiGRU encoder + simple query decoder; the output dict of the
    ``lstm`` model (``pred_boxes``, ``pred_classes`` and, when enabled,
    ``pred_objectness`` and ``pred_aux_boxes``), in float32.

    ``dropout`` is the encoder's inter-layer dropout rate (training mode
    only). ``generator`` seeds the initial weights; serving loads real
    weights through ``weights.py``."""

    # the mesh axis splitting the input sequence (parallel/mesh.py)
    seq = ONE_RANK

    def __init__(self, input_dim: int = 11, d_model: int = 512,
                 num_queries: int = 32, gru_layers: int = 2,
                 dropout: float = 0.1, num_classes: int = 4,
                 compute_dtype: str = "float32", objectness: bool = False,
                 center_xz: bool = False, refine_stages: int = 0,
                 extent_features: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        cd = compute_dtype_of(compute_dtype)
        self.objectness = objectness
        self.center_xz = center_xz
        self.refine_stages = refine_stages
        self.encoder = GRUTraceEncoder(input_dim, d_model, gru_layers,
                                       dropout, cd)
        self.decoder = SimpleQueryDecoder(
            d_model, num_queries, num_classes, objectness, refine_stages,
            extent_features, compute_dtype=cd)
        reset_parameters(self, generator)

    def forward(self, traces: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        """``generator`` draws the dropout masks in training mode
        (``model.train()``); it is unused in eval mode. With ``seq`` above
        one rank the input is this rank's slice of the sequence, gathered
        whole first: the recurrences take the whole sequence."""
        traces, mask = gather_sequence(traces, mask, self.seq)
        offs = None
        if self.center_xz:
            traces, offs = center_traces_xz(traces, mask)
        memory, coords, mean, scale = self.encoder(traces, mask, generator)
        outs = self.decoder(memory, coords, mean, scale, mask)
        return assemble_output(outs, offs, self.objectness,
                               self.refine_stages)
