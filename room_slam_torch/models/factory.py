"""Model factory (counterpart of the JAX package's ``models/factory.py``)."""

from __future__ import annotations

import torch
from torch import nn

from room_slam_torch.config import ModelConfig
from room_slam_torch.models.gru import TraceToColliderGRU
from room_slam_torch.models.legacy_gru import RoomSlamGRU
from room_slam_torch.models.lstm import TraceToColliderLSTM
from room_slam_torch.models.transformer import TraceToColliderTransformer


def build_model(cfg: ModelConfig,
                generator: torch.Generator | None = None) -> nn.Module:
    """Build a model by type: ``transformer``, ``lstm``, ``bigru`` or the
    legacy surface's ``gru``."""
    t = cfg.model_type.lower()
    if t == "transformer":
        return TraceToColliderTransformer(
            input_dim=cfg.input_dim,
            d_model=cfg.d_model,
            nhead=cfg.nhead,
            num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers,
            num_queries=cfg.num_queries,
            dim_feedforward=cfg.dim_feedforward,
            dropout=cfg.dropout,
            num_classes=cfg.num_classes,
            objectness=cfg.objectness,
            center_xz=cfg.center_xz,
            refine_stages=cfg.refine_stages,
            extent_features=cfg.extent_features,
            moe_experts=cfg.moe_experts,
            generator=generator,
        )
    if t == "lstm":
        return TraceToColliderLSTM(
            input_dim=cfg.input_dim,
            d_model=cfg.d_model,
            num_queries=cfg.num_queries,
            lstm_layers=cfg.lstm_layers,
            dropout=cfg.dropout,
            num_classes=cfg.num_classes,
            compute_dtype=cfg.compute_dtype,
            objectness=cfg.objectness,
            center_xz=cfg.center_xz,
            refine_stages=cfg.refine_stages,
            extent_features=cfg.extent_features,
            hole_tokens=cfg.hole_tokens,
            generator=generator,
        )
    if t == "bigru":
        return TraceToColliderGRU(
            input_dim=cfg.input_dim,
            d_model=cfg.d_model,
            num_queries=cfg.num_queries,
            gru_layers=cfg.lstm_layers,
            dropout=cfg.dropout,
            num_classes=cfg.num_classes,
            compute_dtype=cfg.compute_dtype,
            objectness=cfg.objectness,
            center_xz=cfg.center_xz,
            refine_stages=cfg.refine_stages,
            extent_features=cfg.extent_features,
            generator=generator,
        )
    if t == "gru":
        return RoomSlamGRU(
            hidden_size=cfg.d_model,
            max_objects=cfg.num_queries,
            num_classes=cfg.num_classes,
            dropout=cfg.dropout,
            generator=generator,
        )
    raise ValueError(f"Unknown model_type: {cfg.model_type}. Use "
                     "'transformer', 'lstm', 'bigru' or 'gru' (legacy "
                     "surface).")


def count_parameters(model: nn.Module) -> int:
    """Trainable parameters: the JAX package's count over its parameter
    tree (the same leaves, through the weight bridge)."""
    return sum(p.numel() for p in model.parameters())
