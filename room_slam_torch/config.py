"""Configuration dataclasses, a copy of ``room_slam_tpu/config.py``.

The fields and defaults match the JAX package one for one, so the same
``configs/*.json`` files and checkpoint sidecars load unchanged. The copy
exists because importing ``room_slam_tpu.config`` runs
``room_slam_tpu/__init__.py``, which imports jax.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Tuple

# Class labels of the benchmark (3D JSON) surface.
BENCH_LABELS: Dict[str, int] = {"BLOCK": 0, "LOW": 1, "MID": 2, "HIGH": 3}
BENCH_ID_TO_LABEL: Dict[int, str] = {v: k for k, v in BENCH_LABELS.items()}
NUM_BENCH_CLASSES = 4

# Class labels of the legacy (CSV 2D) surface.
LEGACY_LABELS: Dict[str, int] = {"GROUND": 0, "LOW": 1, "MID": 2, "BLOCK": 3}
LEGACY_ID_TO_LABEL: Dict[int, str] = {v: k for k, v in LEGACY_LABELS.items()}
NUM_LEGACY_CLASSES = 4


@dataclass
class DataConfig:
    """Dataset and augmentation settings."""

    data_dir: str = "dataset/train"
    val_dir: str = "dataset/val"
    max_trace_len: int = 3000
    max_colliders: int = 50

    augment_rotation: bool = True
    augment_translation: bool = True
    augment_scale: bool = True
    augment_collider_dropout: bool = True
    rotation_angles: Tuple[int, ...] = (0, 90, 180, 270)
    scale_range: Tuple[float, float] = (0.8, 1.2)
    translation_range: float = 1.0
    collider_dropout_prob: float = 0.2

    reverse_prob: float = 0.5
    noise_prob: float = 0.8
    noise_sigma: Tuple[float, float, float] = (0.02, 0.01, 0.02)
    crop_prob: float = 0.5
    time_warp_prob: float = 0.5
    dropout_gate_prob: float = 0.5


@dataclass
class ModelConfig:
    """Model architecture (see ``room_slam_tpu/config.py`` for what each
    switch does)."""

    model_type: str = "lstm"
    d_model: int = 128
    num_queries: int = 30
    nhead: int = 4
    enc_layers: int = 3
    dec_layers: int = 3
    dim_feedforward: int = 512
    dropout: float = 0.1
    lstm_layers: int = 2
    input_dim: int = 11
    num_classes: int = NUM_BENCH_CLASSES
    compute_dtype: str = "float32"
    # Kept readable for config compatibility. The port routes the
    # recurrence by the tensor's device, not by this flag.
    use_pallas_rnn: bool = True
    objectness: bool = False
    center_xz: bool = False
    refine_stages: int = 0
    extent_features: bool = False
    hole_tokens: int = 0
    moe_experts: int = 0


@dataclass
class TrainConfig:
    """Optimization settings."""

    batch_size: int = 20
    num_epochs: int = 200
    lr: float = 2e-4
    weight_decay: float = 1e-4
    warmup_epochs: int = 10
    val_every: int = 1
    iou_thresh: float = 0.5
    grad_clip: float = 1.0
    grad_accum: int = 1
    ema_decay: float = 0.0
    rng_impl: str = "threefry2x32"
    seed: int = 0
    save_dir: str = "./checkpoints"
    loss_weights: Tuple[float, float, float] = (2.0, 5.0, 2.0)
    footprint_weight: float = 0.0
    objectness_weight: float = 1.0
    objectness_iou: bool = False
    size_log_weight: float = 0.0
    coverage_weight: float = 0.0
    coverage_furniture_only: bool = False
    moe_aux_weight: float = 0.01
    aux_weight: float = 0.5
    lr_schedule: str = "plateau"
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    plateau_cooldown: int = 1
    plateau_min_scale: float = 1e-6 / 2e-4
    steps_per_epoch: int = 0
    matmul_precision: str = "bfloat16"


@dataclass
class MeshConfig:
    """Device mesh of a multi-rank run (``parallel/mesh.py``).

    ``mesh_shape`` is ``(n_data, n_model)`` for a ('data', 'model') mesh,
    ``(0, 1)`` putting every rank on 'data', or ``(n_data, n_seq,
    n_model)`` for a ('data', 'seq', 'model') mesh (sequence parallelism:
    each rank takes a slice of the raw trace's L axis); a 0 entry is
    filled with the ranks left. Set from the CLI with e.g. ``--set
    mesh.mesh_shape=[2,2,2]``. A recurrence encoder gathers its whole
    sequence on each rank before the recurrence."""

    data_axis: str = "data"
    model_axis: str = "model"
    mesh_shape: Tuple[int, ...] = (0, 1)


@dataclass
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        def build(tp, sub):
            names = {f.name for f in dataclasses.fields(tp)}
            # JSON round-trips tuples as lists; unknown keys are ignored
            return tp(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in (sub or {}).items() if k in names})

        return cls(
            data=build(DataConfig, d.get("data")),
            model=build(ModelConfig, d.get("model")),
            train=build(TrainConfig, d.get("train")),
            mesh=build(MeshConfig, d.get("mesh")),
        )

    @classmethod
    def from_json(cls, path: str | Path) -> "ExperimentConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def apply_overrides(self, overrides: List[str]) -> "ExperimentConfig":
        """Apply ``section.key=value`` overrides in place (the JAX
        package's ``--set``): the value takes the field's current type
        (bool from 1/true/yes, tuples as JSON lists); an unknown section or
        key raises."""
        for ov in overrides:
            key, sep, raw = ov.partition("=")
            section, _, name = key.partition(".")
            if not sep or not name:
                raise ValueError(f"override {ov!r}: expected section.key=value")
            target = getattr(self, section)
            old = getattr(target, name)
            if isinstance(old, bool):
                val: Any = raw.lower() in ("1", "true", "yes")
            elif isinstance(old, int):
                val = int(raw)
            elif isinstance(old, float):
                val = float(raw)
            elif isinstance(old, tuple):
                val = tuple(json.loads(raw))
            else:
                val = raw
            setattr(target, name, val)
        return self
