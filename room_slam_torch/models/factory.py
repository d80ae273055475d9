"""Model factory (counterpart of the JAX package's ``models/factory.py``)."""

from __future__ import annotations

import torch
from torch import nn

from room_slam_torch.config import ModelConfig
from room_slam_torch.models.gru import TraceToColliderGRU
from room_slam_torch.models.lstm import TraceToColliderLSTM

# model types of the JAX package that are still to be ported, with the
# ROADMAP queue 1 item that ports each
_NOT_PORTED = {
    "transformer": "item 13 (transformer and MoE)",
    "gru": "item 14 (legacy surface)",
}


def build_model(cfg: ModelConfig,
                generator: torch.Generator | None = None) -> nn.Module:
    """Build a model by type (``lstm`` and ``bigru`` so far)."""
    t = cfg.model_type.lower()
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
    if t in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported yet: ROADMAP queue "
            f"1 {_NOT_PORTED[t]}")
    raise ValueError(f"Unknown model_type: {cfg.model_type}")
