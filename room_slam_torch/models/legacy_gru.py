"""Legacy surface model: bidirectional GRU encoder and multi-head MLP decoder
(counterpart of the JAX package's ``models/legacy_gru.py``).

2D ``(x, y)`` movement windows -> per-window normalisation -> stacked
BiGRU layers -> the two final states -> a two-layer latent MLP -> heads
for class, position, size, orientation and validity over ``max_objects``
slots; positions and sizes are denormalised back to metres.

Each direction of each layer is one single-direction GRU: its input
product ``x @ w_ih + b_ih`` is a plain matmul, its recurrence
``ops/rnn.py`` ``gru_recurrence(use_kernel=True)``, which launches the
single-direction GRU kernels for CUDA tensors (the light kernel without
grad; the training forward and BPTT kernels through ``GRUFunction`` with
grad) and runs the plain loop for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from room_slam_torch.models.common import Dense, dropout, reset_parameters
from room_slam_torch.ops.rnn import gru_recurrence


class BiGRULayer(nn.Module):
    """One bidirectional GRU layer -> ``([B, N, 2H], final states [B, 2H])``.

    Weights keep the JAX layout: ``w_ih_* [in, 3H]``, ``b_ih_* [3H]``,
    ``w_hh_* [H, 3H]``, ``b_hh_* [3H]``, gate order r, z, n, all
    U(-1/sqrt(H), 1/sqrt(H)) as torch ``nn.GRU``. The final state is the
    forward direction's last step and the reverse direction's first."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
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

    def forward(self, x: torch.Tensor):
        outs, finals = [], []
        for d, reverse in (("fwd", False), ("bwd", True)):
            xg = torch.matmul(x, getattr(self, f"w_ih_{d}")) \
                + getattr(self, f"b_ih_{d}")
            ys = gru_recurrence(xg, getattr(self, f"w_hh_{d}"),
                                getattr(self, f"b_hh_{d}"), reverse,
                                use_kernel=True)
            outs.append(ys)
            finals.append(ys[:, 0] if reverse else ys[:, -1])
        return torch.cat(outs, dim=-1), torch.cat(finals, dim=-1)


class RoomSlamGRU(nn.Module):
    """GRU encoder + multi-head MLP decoder. Input ``[B, S, input_dim]``
    windows; output dict: ``classes [B, M, C]`` logits, ``positions
    [B, M, 2]``, ``sizes [B, M, 2]`` (softplus, > 0), ``orientations
    [B, M, 1]`` (radians), ``validity [B, M, 1]`` logits, and the shared
    views ``pred_classes`` and ``pred_boxes [B, M, 5]`` (x, y, w, h,
    theta).

    ``dropout`` applies between GRU layers and after the first latent
    layer in training mode, with masks from the ``generator`` given to
    ``forward``. ``generator`` here seeds the initial weights."""

    def __init__(self, hidden_size: int = 128, max_objects: int = 10,
                 num_classes: int = 4, gru_layers: int = 2,
                 dropout: float = 0.1, input_dim: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_objects = max_objects
        self.num_classes = num_classes
        self.gru_layers = gru_layers
        self.dropout = dropout
        self.input_dim = input_dim
        h = hidden_size // 2
        for layer in range(gru_layers):
            self.add_module(f"gru_{layer}", BiGRULayer(
                input_dim if layer == 0 else 2 * h, h))
        M = max_objects
        self.latent_proj = Dense(2 * h, hidden_size)
        self.latent_proj2 = Dense(hidden_size, hidden_size)
        self.class_head = Dense(hidden_size, M * num_classes)
        self.position_head = Dense(hidden_size, M * 2)
        self.size_head = Dense(hidden_size, M * 2)
        self.orientation_head = Dense(hidden_size, M)
        self.validity_head = Dense(hidden_size, M)
        reset_parameters(self, generator)

    def forward(self, traces: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None
                ) -> Dict[str, torch.Tensor]:
        B, S, _ = traces.shape
        # per-window normalisation: absolute position is factored out and
        # added back at decode
        if mask is None:
            mask = torch.ones(B, S, dtype=torch.bool, device=traces.device)
        m = mask[..., None].to(traces.dtype)
        denom = m.sum(1, keepdim=True).clamp(min=1.0)
        coords = traces[..., :self.input_dim]
        mean = (coords * m).sum(1, keepdim=True) / denom          # [B, 1, 2]
        centered = (coords - mean) * m
        rms = torch.sqrt((centered ** 2).sum((1, 2), keepdim=True)
                         / denom[..., :1])
        scale = rms.clamp(min=1e-3)                               # [B, 1, 1]
        feats = (coords - mean) / scale

        final = None
        for layer in range(self.gru_layers):
            feats, final = getattr(self, f"gru_{layer}")(feats)
            if layer < self.gru_layers - 1:
                feats = dropout(feats, self.dropout, self.training, generator)

        z = F.relu(self.latent_proj(final))
        z = dropout(z, self.dropout, self.training, generator)
        z = F.relu(self.latent_proj2(z))

        M = self.max_objects
        classes = self.class_head(z).view(B, M, self.num_classes)
        pos_n = self.position_head(z).view(B, M, 2)
        size_n = self.size_head(z).view(B, M, 2)
        orient = self.orientation_head(z).view(B, M, 1)
        validity = self.validity_head(z).view(B, M, 1)
        positions = pos_n * scale + mean
        sizes = (F.softplus(size_n) + 1e-4) * scale
        return {
            "classes": classes,
            "positions": positions,
            "sizes": sizes,
            "orientations": orient,
            "validity": validity,
            "pred_classes": classes,
            "pred_boxes": torch.cat([positions, sizes, orient], dim=-1),
        }
