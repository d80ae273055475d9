"""BiLSTM encoder and learnable-query decoder (counterpart of the JAX
package's ``models/lstm.py``).

The input gate matmuls for the whole sequence run outside the time loop;
the recurrence itself is ``ops/rnn_cuda.bilstm_recurrence``, which launches
the CUDA kernel for CUDA tensors and runs the plain loop for CPU tensors.

With ``compute_dtype="bfloat16"`` the ``[B, N, *]`` streams (the encoder
projections, the gate streams and the recurrence's outputs and residuals,
the decoder's q/k/v) are bfloat16, as in the JAX model; parameters,
carries, the softmax and the heads stay float32.

With ``hole_tokens=K`` the K largest interior holes of each walk's
raster (``ops/refine.hole_components``, no gradient) join the decoder's
memory as tokens whose coordinate is the hole centroid and whose feature
is its normalized geometry through the ``hole_proj`` MLP plus the learned
``hole_embed``.

Output: ``{'pred_boxes': [B, Q, 6], 'pred_classes': [B, Q, C]}`` plus
``pred_objectness [B, Q]`` and ``pred_aux_boxes [S, B, Q, 6]`` when
enabled. Parameter names and layouts follow the JAX tree, so
``weights.py`` maps one onto the other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from room_slam_torch.data.features import trace_stats
from room_slam_torch.models.common import (MLP, ContactRefineStage, Dense,
                                           assemble_output, center_traces_xz,
                                           compute_dtype_of, dropout,
                                           reset_parameters,
                                           trace_extent_planes)
from room_slam_torch.ops.refine import hole_components
from room_slam_torch.ops.rnn import input_gates
from room_slam_torch.ops.rnn_cuda import bilstm_recurrence


class BiLSTMLayer(nn.Module):
    """One bidirectional LSTM layer; output = concat(fwd, bwd), ``[B, N, 2H]``.

    Weights keep the JAX layout: ``w_ih_* [in, 4H]``, ``w_hh_* [H, 4H]``,
    one merged bias ``b_* [4H]``, gate order i, f, g, o. Under a compute
    dtype the weights are cast, not the product, so the gate streams come
    in that dtype."""

    def __init__(self, d_in: int, hidden: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        for d in ("fwd", "bwd"):
            self.register_parameter(
                f"w_ih_{d}", nn.Parameter(torch.empty(d_in, 4 * hidden)))
            self.register_parameter(
                f"w_hh_{d}", nn.Parameter(torch.empty(hidden, 4 * hidden)))
            self.register_parameter(
                f"b_{d}", nn.Parameter(torch.empty(4 * hidden)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        k = 1.0 / math.sqrt(self.hidden)
        for p in self.parameters(recurse=False):
            p.uniform_(-k, k, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        ys_f, ys_b = bilstm_recurrence(
            input_gates(x, self.w_ih_fwd, self.b_fwd),
            input_gates(x, self.w_ih_bwd, self.b_bwd),
            self.w_hh_fwd.contiguous(), self.w_hh_bwd.contiguous())
        return torch.cat([ys_f, ys_b], dim=-1)


class LSTMTraceEncoder(nn.Module):
    """Linear proj -> stacked BiLSTM -> linear out, plus the masked
    coordinate statistics used for relative decoding."""

    def __init__(self, input_dim: int = 11, d_model: int = 128,
                 num_layers: int = 2, dropout: float = 0.1,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        hidden = d_model // 2
        self.dropout = dropout
        self.input_proj = Dense(input_dim, d_model, dtype=compute_dtype)
        for layer in range(num_layers):
            self.add_module(f"lstm_{layer}", BiLSTMLayer(
                d_model if layer == 0 else 2 * hidden, hidden,
                compute_dtype))
        self.num_layers = num_layers
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
            x = getattr(self, f"lstm_{layer}")(x)
            if layer < self.num_layers - 1:
                # inter-layer dropout, as torch nn.LSTM and the reference
                x = dropout(x, self.dropout, self.training, generator)
        return self.out_proj(x), coords, mean, scale


class SimpleQueryDecoder(nn.Module):
    """Learnable queries, single-head dot-product attention, FiLM
    modulation, anchor-relative box heads, optional objectness head and
    contact-evidence refinement stages."""

    def __init__(self, d_model: int = 128, num_queries: int = 30,
                 num_classes: int = 4, objectness: bool = False,
                 refine_stages: int = 0, extent_features: bool = False,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        D = d_model
        self.objectness = objectness
        self.refine_stages = refine_stages
        self.extent_features = extent_features
        self.query_embed = nn.Parameter(torch.empty(num_queries, D))
        for name in ("gamma_1", "gamma_2", "beta_1", "beta_2"):
            self.add_module(name, Dense(D, D))
        # under bf16 the [B, N, D] projections stream in bf16; the FiLM
        # reduction, the softmax and every head stay float32
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, Dense(D, D, dtype=compute_dtype))
        self.inv_temp = nn.Parameter(torch.empty(()))
        self.center_delta_head = MLP(D, D, 3, 2)
        self.size_head = MLP(D, D, 3, 2)
        for i in range(refine_stages):
            self.add_module(f"refine_{i}",
                            ContactRefineStage(D, extent_features))
        self.class_head = Dense(D, num_classes)
        if objectness:
            self.objectness_head = Dense(D, 1)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.query_embed.normal_(0.0, 1.0, generator=generator)
        self.inv_temp.fill_(1.0)

    def forward(self, memory, coords, mean, scale,
                mask: Optional[torch.Tensor] = None):
        B, N, D = memory.shape
        q_batch = self.query_embed.expand(B, -1, -1)
        mem32 = memory.float()
        if mask is not None:
            m = mask[..., None].float()
            denom = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
            global_feat = (mem32 * m).sum(dim=1, keepdim=True) / denom
        else:
            global_feat = mem32.mean(dim=1, keepdim=True)
        gamma = self.gamma_2(torch.relu(self.gamma_1(global_feat)))
        beta = self.beta_2(torch.relu(self.beta_1(global_feat)))

        q = self.q_proj(q_batch)
        k = self.k_proj(memory)
        v = self.v_proj(memory)
        scores = torch.einsum("bqd,bnd->bqn", q, k).float() \
            * self.inv_temp / math.sqrt(D)
        if mask is not None:
            scores = torch.where(mask[:, None, :], scores,
                                 torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, dim=-1)                   # [B, Q, N]
        # v is consumed in its own dtype, as the reference does
        qfeat = torch.einsum("bqn,bnd->bqd", attn.to(v.dtype), v).float()
        decoded = qfeat * (1.0 + gamma) + beta

        norm_coords = (coords - mean) / scale
        anchor = torch.einsum("bqn,bnd->bqd", attn, norm_coords)
        delta = self.center_delta_head(decoded)
        size_norm = nn.functional.softplus(self.size_head(decoded)) + 1e-4

        def to_world(c_n, s_n):
            return torch.cat([c_n * scale + mean, s_n * scale], dim=-1)

        center_n = anchor + delta
        aux_boxes = []
        if self.refine_stages:
            pool_mask = mask if mask is not None else torch.ones(
                B, N, dtype=torch.bool, device=memory.device)
            extent = (trace_extent_planes(norm_coords, pool_mask)
                      if self.extent_features else None)
            for i in range(self.refine_stages):
                aux_boxes.append(to_world(center_n, size_norm))
                decoded, center_n, size_norm = getattr(self, f"refine_{i}")(
                    decoded, center_n, size_norm, norm_coords, v, pool_mask,
                    extent=extent)

        outs = [to_world(center_n, size_norm), self.class_head(decoded)]
        if self.objectness:
            outs.append(self.objectness_head(decoded)[..., 0])
        if aux_boxes:
            outs.append(torch.stack(aux_boxes))               # [S, B, Q, 6]
        return tuple(outs)


class TraceToColliderLSTM(nn.Module):
    """LSTM encoder + simple query decoder.

    ``dropout`` is the encoder's inter-layer dropout rate (training mode
    only). ``generator`` seeds the initial weights (the JAX package's init
    distributions); serving loads real weights through ``weights.py``."""

    def __init__(self, input_dim: int = 11, d_model: int = 128,
                 num_queries: int = 30, lstm_layers: int = 2,
                 dropout: float = 0.1,
                 num_classes: int = 4, compute_dtype: str = "float32",
                 objectness: bool = False, center_xz: bool = False,
                 refine_stages: int = 0, extent_features: bool = False,
                 hole_tokens: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        cd = compute_dtype_of(compute_dtype)
        self.hole_tokens = hole_tokens
        self.objectness = objectness
        self.center_xz = center_xz
        self.refine_stages = refine_stages
        self.encoder = LSTMTraceEncoder(input_dim, d_model, lstm_layers,
                                        dropout, cd)
        self.decoder = SimpleQueryDecoder(
            d_model, num_queries, num_classes, objectness, refine_stages,
            extent_features, compute_dtype=cd)
        if hole_tokens:
            self.hole_embed = nn.Parameter(torch.empty(d_model))
            self.hole_proj = MLP(6, d_model, d_model, 2)
        reset_parameters(self, generator)
        if hole_tokens:
            with torch.no_grad():
                self.hole_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, traces: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        """``generator`` draws the dropout masks in training mode
        (``model.train()``); it is unused in eval mode."""
        offs = None
        if self.center_xz:
            traces, offs = center_traces_xz(traces, mask)
        memory, coords, mean, scale = self.encoder(traces, mask, generator)
        if self.hole_tokens:
            memory, coords, mask = self._append_hole_tokens(
                memory, coords, mask, mean, scale)
        outs = self.decoder(memory, coords, mean, scale, mask)
        return assemble_output(outs, offs, self.objectness,
                               self.refine_stages)

    def _append_hole_tokens(self, memory, coords, mask, mean, scale):
        """Append the K largest interior holes of each walk's raster to
        the decoder memory (``[B, N + K, *]``): coordinate the hole
        centroid at the trace's mean height, feature the normalized
        geometry through ``hole_proj`` plus ``hole_embed``; slots of
        under 0.02 m^2 are masked out."""
        B, N, _ = memory.shape
        K = self.hole_tokens
        if mask is None:
            mask = torch.ones(B, N, dtype=torch.bool, device=memory.device)
        # the raster statistics are piecewise constant in the coordinates:
        # no gradient through them
        with torch.no_grad():
            h = hole_components(coords[..., 0].detach(),
                                coords[..., 2].detach(), mask, K)
        valid = h["area_m2"] > 0.02

        # empty slots read +-inf extents: zero them before the MLP
        def safe(a):
            return torch.where(valid, torch.nan_to_num(a, posinf=0.0,
                                                       neginf=0.0), 0.0)

        c_x, c_z = safe(h["c_x"]), safe(h["c_z"])
        s_x, s_z = safe(h["s_x"]), safe(h["s_z"])
        area = safe(h["area_m2"])
        sc = scale[:, :, 0]                                     # [B, 1]
        geom = torch.stack([
            (c_x - mean[:, :, 0]) / sc,
            (c_z - mean[:, :, 2]) / sc,
            s_x / sc,
            s_z / sc,
            torch.log1p(area),
            torch.minimum(s_x, s_z) / torch.clamp(torch.maximum(s_x, s_z),
                                                  min=1e-3),
        ], dim=-1)                                              # [B, K, 6]
        h_feat = self.hole_proj(geom) + self.hole_embed
        h_coords = torch.stack([c_x, mean[:, :, 1].expand(B, K), c_z],
                               dim=-1)
        return (torch.cat([memory, h_feat.to(memory.dtype)], dim=1),
                torch.cat([coords, h_coords], dim=1),
                torch.cat([mask, valid], dim=1))
