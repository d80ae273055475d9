"""Read and write the JAX package's checkpoints without flax.

A checkpoint is ``<stem>.msgpack`` (``{"params": ..., ["opt_state": ...]}``
serialized by ``flax.serialization.to_bytes``, where ``params`` is the
model's variables ``{"params": {...}}``) plus ``<stem>.json`` (the sidecar:
epoch, metrics, config). flax stores every array as msgpack
extension type 1 holding a packed ``(shape, dtype_name, bytes)`` tuple,
and numpy scalars as type 3. The port writes the same layout, with the
optimizer state in optax's layout when it is given one
(``loop.Optimizer.state_dict``, ``has_opt_state: true``), so the JAX
package's ``load_checkpoint`` and ``load_model_for_inference`` read what
the port trains, and each package resumes from the other's checkpoints.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from room_slam_torch.config import ExperimentConfig
from room_slam_torch.weights import state_dict_to_params

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _array_from_ext(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raise ValueError("bfloat16 checkpoint arrays are not supported")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def read_msgpack_tree(data: bytes) -> Dict[str, Any]:
    """Decode flax msgpack bytes into nested dicts of numpy arrays."""
    import msgpack

    def ext_hook(code, payload):
        if code == _EXT_NDARRAY:
            return _array_from_ext(payload)
        if code == _EXT_NPSCALAR:
            return _array_from_ext(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")

    tree = msgpack.unpackb(data, ext_hook=ext_hook, raw=False)
    _reject_chunked(tree)
    return tree


def _ext_from_array(code: int, arr: np.ndarray):
    import msgpack

    return msgpack.ExtType(code, msgpack.packb(
        (arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True))


def write_msgpack_tree(tree: Mapping[str, Any]) -> bytes:
    """Encode nested dicts of numpy arrays as flax msgpack bytes (what
    ``flax.serialization.to_bytes`` writes for the same tree)."""
    import msgpack

    def default(x):
        if isinstance(x, np.ndarray):
            return _ext_from_array(_EXT_NDARRAY, x)
        if isinstance(x, np.generic):
            return _ext_from_array(_EXT_NPSCALAR, np.asarray(x))
        raise TypeError(f"cannot serialize {type(x).__name__}")

    return msgpack.packb(tree, default=default, strict_types=True)


def save_checkpoint(path: str | Path,
                    state_dict: Mapping[str, torch.Tensor],
                    opt_state: Optional[Mapping[str, Any]] = None,
                    epoch: int = 0, val_loss: float = float("nan"),
                    metrics: Optional[Dict] = None,
                    config: Optional[ExperimentConfig] = None,
                    extra: Optional[Dict] = None,
                    model: Optional[nn.Module] = None) -> None:
    """Write ``<path>.msgpack`` (the model's parameters in the JAX layout,
    through ``weights.state_dict_to_params``, which needs ``model`` where it
    has layer norms, and ``opt_state`` when given:
    ``loop.Optimizer.state_dict()``, optax's layout) and the ``<path>.json``
    sidecar (``has_opt_state`` says which). ``extra`` merges more JSON state
    (the plateau scheduler) into the sidecar."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree: Dict[str, Any] = {"params": state_dict_to_params(state_dict,
                                                           model)}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    path.with_suffix(".msgpack").write_bytes(write_msgpack_tree(tree))
    side = {"epoch": int(epoch), "val_loss": float(val_loss),
            "metrics": metrics or {}, "has_opt_state": opt_state is not None,
            **(extra or {})}
    if config is not None:
        side["config"] = config.to_dict()
    path.with_suffix(".json").write_text(json.dumps(side, indent=2))


def _reject_chunked(node) -> None:
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            raise ValueError("chunked (> 1 GiB) checkpoint arrays are not "
                             "supported")
        for v in node.values():
            _reject_chunked(v)


def load_checkpoint(path: str | Path, with_opt_state: bool = False) -> tuple:
    """Return (the model's ``{"params": ...}`` tree of numpy arrays, the
    sidecar dict) of checkpoint stem ``path``; with ``with_opt_state``,
    (params, the optimizer state tree in optax's layout or None where the
    file has none, sidecar), the state ready for
    ``loop.Optimizer.load_state_dict``."""
    path = Path(path)
    side = json.loads(path.with_suffix(".json").read_text())
    tree = read_msgpack_tree(path.with_suffix(".msgpack").read_bytes())
    if with_opt_state:
        return tree["params"], tree.get("opt_state"), side
    return tree["params"], side


def load_config_from_checkpoint(path: str | Path) -> ExperimentConfig:
    side = json.loads(Path(path).with_suffix(".json").read_text())
    return ExperimentConfig.from_dict(side.get("config", {}))
