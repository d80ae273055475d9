"""Transformer encoder and DETR-style decoder (counterpart of the JAX
package's ``models/transformer.py``).

Post-norm layers with ReLU FFNs, as torch's ``nn.TransformerEncoderLayer``
/ ``nn.TransformerDecoderLayer`` compute them, with dropout at the same
points as the JAX model (attention probabilities, each sublayer's output,
the FFN's hidden units), drawn from the forward's ``generator``. The layer
norms follow flax's numerics (``models/common.LayerNorm``). With
``moe_experts > 0`` every encoder FFN is a switch-routed ``MoEFFN``
(named ``moe``); each stores its load-balance term for the train step.

After the decoder layers: single-head anchor attention over the
normalized raw coordinates (scale ``sqrt(D)``), relative box heads and
the optional objectness head and contact-evidence refinement stages, as in
the BiLSTM model. Everything is float32 (the JAX model takes no compute
dtype) and plain tensor ops: no kernel of the JAX package lies on this
path. Parameter names and layouts follow the JAX tree, so ``weights.py``
maps one onto the other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from room_slam_torch.data.features import trace_stats
from room_slam_torch.models.common import (MLP, ContactRefineStage, Dense,
                                           LayerNorm, MoEFFN,
                                           MultiHeadAttention,
                                           assemble_output, center_traces_xz,
                                           dropout, masked_scores,
                                           reset_parameters,
                                           sinusoidal_positions,
                                           trace_extent_planes)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer: self-attention with key padding, then a
    ReLU FFN (or ``MoEFFN`` with ``moe_experts > 0``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 512,
                 dropout: float = 0.1, moe_experts: int = 0):
        super().__init__()
        self.dropout = dropout
        self.moe_experts = moe_experts
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.norm1 = LayerNorm(d_model)
        if moe_experts:
            self.moe = MoEFFN(d_model, dim_feedforward, moe_experts, dropout)
        else:
            self.linear1 = Dense(d_model, dim_feedforward)
            self.linear2 = Dense(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        attn = self.self_attn(x, x, x, key_padding_mask=mask,
                              generator=generator)
        x = self.norm1(x + drop(attn))
        if self.moe_experts:
            ff = self.moe(x, mask=mask, generator=generator)
        else:
            ff = self.linear2(drop(torch.relu(self.linear1(x))))
        return self.norm2(x + drop(ff))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: query self-attention, cross-attention to
    the memory with key padding, ReLU FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 512,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                mem_mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        sa = self.self_attn(tgt, tgt, tgt, generator=generator)
        tgt = self.norm1(tgt + drop(sa))
        ca = self.cross_attn(tgt, memory, memory, key_padding_mask=mem_mask,
                             generator=generator)
        tgt = self.norm2(tgt + drop(ca))
        ff = self.linear2(drop(torch.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(ff))


class TraceEncoder(nn.Module):
    """``input_proj`` + sinusoidal positions + the encoder layers, plus the
    masked coordinate statistics used for relative decoding."""

    def __init__(self, input_dim: int = 11, d_model: int = 128,
                 nhead: int = 4, num_layers: int = 3,
                 dim_feedforward: int = 512, dropout: float = 0.1,
                 moe_experts: int = 0):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.input_proj = Dense(input_dim, d_model)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, nhead, dim_feedforward, dropout, moe_experts))

    def forward(self, traces: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        B, N, _ = traces.shape
        coords = traces[..., :3]
        if mask is None:
            mask = torch.ones(B, N, dtype=torch.bool, device=traces.device)
        mean, scale = trace_stats(coords, mask)
        x = self.input_proj(traces)
        x = x + sinusoidal_positions(N, self.d_model, x.dtype, x.device)[None]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, generator)
        return x, coords, mean, scale


class ColliderDecoder(nn.Module):
    """Learnable queries through the decoder layers over the trace memory,
    then anchor attention over the normalized raw coordinates, relative
    box heads, optional objectness head and refinement stages."""

    def __init__(self, d_model: int = 128, nhead: int = 4,
                 num_layers: int = 3, num_queries: int = 30,
                 dim_feedforward: int = 512, dropout: float = 0.1,
                 num_classes: int = 4, objectness: bool = False,
                 refine_stages: int = 0, extent_features: bool = False):
        super().__init__()
        D = d_model
        self.num_layers = num_layers
        self.objectness = objectness
        self.refine_stages = refine_stages
        self.extent_features = extent_features
        self.query_embed = nn.Parameter(torch.empty(num_queries, D))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                D, nhead, dim_feedforward, dropout))
        self.q_proj = Dense(D, D)
        self.k_proj = Dense(D, D)
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

    def forward(self, memory, coords, mean, scale,
                mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        B, N, D = memory.shape
        tgt = self.query_embed.expand(B, -1, -1)
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer_{i}")(tgt, memory, mask, generator)

        # anchor attention over the raw coordinates (one head, sqrt(D))
        scores = torch.einsum("bqd,bnd->bqn", self.q_proj(tgt),
                              self.k_proj(memory)) / math.sqrt(D)
        if mask is not None:
            scores = masked_scores(scores, mask[:, None, :])
        attn = torch.softmax(scores, dim=-1)
        norm_coords = (coords - mean) / scale
        anchor = torch.einsum("bqn,bnd->bqd", attn, norm_coords)
        delta = self.center_delta_head(tgt)
        size_norm = nn.functional.softplus(self.size_head(tgt)) + 1e-4

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
                tgt, center_n, size_norm = getattr(self, f"refine_{i}")(
                    tgt, center_n, size_norm, norm_coords, memory, pool_mask,
                    extent=extent)

        outs = [to_world(center_n, size_norm), self.class_head(tgt)]
        if self.objectness:
            outs.append(self.objectness_head(tgt)[..., 0])
        if aux_boxes:
            outs.append(torch.stack(aux_boxes))               # [S, B, Q, 6]
        return tuple(outs)


class TraceToColliderTransformer(nn.Module):
    """Transformer encoder + collider decoder (the JAX package's
    ``TraceToColliderTransformer``). ``generator`` seeds the initial
    weights (the JAX package's init distributions); serving loads real
    weights through ``weights.py``."""

    def __init__(self, input_dim: int = 11, d_model: int = 128,
                 nhead: int = 4, num_encoder_layers: int = 3,
                 num_decoder_layers: int = 3, num_queries: int = 30,
                 dim_feedforward: int = 512, dropout: float = 0.1,
                 num_classes: int = 4, objectness: bool = False,
                 center_xz: bool = False, refine_stages: int = 0,
                 extent_features: bool = False, moe_experts: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.objectness = objectness
        self.center_xz = center_xz
        self.refine_stages = refine_stages
        self.encoder = TraceEncoder(input_dim, d_model, nhead,
                                    num_encoder_layers, dim_feedforward,
                                    dropout, moe_experts)
        self.decoder = ColliderDecoder(
            d_model, nhead, num_decoder_layers, num_queries,
            dim_feedforward, dropout, num_classes, objectness,
            refine_stages, extent_features)
        reset_parameters(self, generator)

    def forward(self, traces: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None):
        """``generator`` draws the dropout masks in training mode
        (``model.train()``); it is unused in eval mode."""
        offs = None
        if self.center_xz:
            traces, offs = center_traces_xz(traces, mask)
        memory, coords, mean, scale = self.encoder(traces, mask, generator)
        outs = self.decoder(memory, coords, mean, scale, mask, generator)
        return assemble_output(outs, offs, self.objectness,
                               self.refine_stages)
