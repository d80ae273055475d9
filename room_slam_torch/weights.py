"""Weight bridge between the JAX package's parameter tree and this port.

The JAX tree is ``{"params": {...}}`` as nested dicts of numpy arrays (what
``flax`` checkpoints hold). The port's modules carry the same names, so a
flattened JAX path is the ``state_dict`` key, with two renames decided by
the module's type: a dense layer's ``kernel [in, out]`` is ``nn.Linear``'s
``weight [out, in]`` (transposed), and a layer norm's ``scale`` is its
``weight`` (``models/common.LayerNorm``, not transposed). Every other leaf
keeps its name and layout: LSTM ``w_ih_* [in, 4H]``, ``w_hh_* [H, 4H]``,
``b_* [4H]``, the MoE experts' ``w1 [E, D, F]``, ``b1``, ``w2``, ``b2``,
the scalar ``inv_temp``, ``log_radius_slack [1]``, ``query_embed [Q, D]``.

Both directions are strict: a key the other side does not know, a key left
unused, or a shape that differs raises.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = np.asarray(v)
    return flat


def _norms(model: nn.Module | None) -> set:
    """Names of ``model``'s layer norms (their ``weight`` is flax's
    ``scale``)."""
    if model is None:
        return set()
    return {n for n, m in model.named_modules()
            if isinstance(m, nn.LayerNorm)}


def _to_torch_key(jax_key: str, norms: set) -> Tuple[str, bool]:
    """(state_dict key, transpose?) of a flattened JAX path."""
    head, dot, leaf = jax_key.rpartition(".")
    norm = head in norms
    if leaf == ("scale" if norm else "kernel"):
        return f"{head}{dot}weight", not norm
    return jax_key, False


def _to_jax_key(torch_key: str, norms: set) -> Tuple[str, bool]:
    """(flattened JAX path, transpose?) of a state_dict key."""
    head, dot, leaf = torch_key.rpartition(".")
    if leaf != "weight":
        return torch_key, False
    if head in norms:
        return f"{head}{dot}scale", False
    return f"{head}{dot}kernel", True


def params_to_state_dict(params: Mapping[str, Any],
                         model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a JAX ``{"params": ...}`` tree onto ``model``'s ``state_dict``
    (CPU float32 tensors, ready for ``load_state_dict``)."""
    if set(params) != {"params"}:
        raise KeyError(f"expected a {{'params': ...}} tree, got keys "
                       f"{sorted(params)}")
    expected = model.state_dict()
    norms = _norms(model)
    out: Dict[str, torch.Tensor] = {}
    for jax_key, arr in _flatten(params["params"]).items():
        key, transpose = _to_torch_key(jax_key, norms)
        if key not in expected:
            raise KeyError(f"JAX parameter {jax_key!r} has no counterpart "
                           f"{key!r} in {type(model).__name__}")
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{jax_key}: shape {arr.shape} does not match "
                             f"{tuple(expected[key].shape)} of {key}")
        out[key] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"JAX tree leaves these parameters unset: {missing}")
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def state_dict_to_params(state_dict: Mapping[str, torch.Tensor],
                         model: nn.Module | None = None) -> Dict[str, Any]:
    """Inverse of ``params_to_state_dict``: a nested ``{"params": ...}``
    tree of numpy arrays in the JAX layout. ``model`` (the module the keys
    belong to) names the layer norms; without it every ``weight`` is a
    dense kernel, and a layer norm's raises."""
    norms = _norms(model)
    flat: Dict[str, np.ndarray] = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        jax_key, transpose = _to_jax_key(key, norms)
        if transpose:
            if arr.ndim != 2:
                raise ValueError(f"{key}: a dense weight must be 2-D, got "
                                 f"{arr.shape} (a layer norm's weight needs "
                                 "the model)")
            arr = arr.T
        flat[jax_key] = np.array(arr, order="C")
    return {"params": _unflatten(flat)}


def load_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load a JAX parameter tree into ``model`` in place and return it."""
    model.load_state_dict(params_to_state_dict(params, model), strict=True)
    return model


def random_params(model: nn.Module, seed: int) -> Dict[str, Any]:
    """Seeded random weights for ``model`` in the JAX layout, drawn with
    numpy (so both packages can be handed the same tree).

    Dense and LSTM leaves are U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in
    being the dense layer's input width or the LSTM's H. That includes the
    refinement deltas, which a fresh model starts at zero, so every stage
    does work. The MoE experts' ``w1`` / ``b1`` are U(+-1/sqrt(D)), ``w2``
    / ``b2`` U(+-1/sqrt(F)). A layer norm's ``scale`` is 1 + U(-0.1, 0.1)
    and its ``bias`` U(-0.1, 0.1), away from the identity. ``query_embed``
    is N(0, 1), ``hole_embed`` N(0, 0.02^2); ``inv_temp`` and
    ``log_radius_slack`` sit near their initial 1 and log(0.3)."""
    rng = np.random.default_rng(seed)
    flat = _flatten(state_dict_to_params(model.state_dict(), model)
                    ["params"])
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        head, dot, leaf = key.rpartition(".")

        def sibling(name: str) -> str:
            return f"{head}{dot}{name}"

        if leaf == "scale" or (leaf == "bias" and sibling("scale") in flat):
            base = 1.0 if leaf == "scale" else 0.0
            out[key] = (base + rng.uniform(-0.1, 0.1, arr.shape)
                        ).astype(np.float32)
            continue
        if leaf in ("kernel", "bias"):
            fan_in = flat[sibling("kernel")].shape[0]
        elif leaf.startswith(("w_ih_", "w_hh_", "b_")):
            fan_in = flat[sibling("w_hh_fwd")].shape[0]
        elif leaf in ("w1", "b1"):
            fan_in = flat[sibling("w1")].shape[1]
        elif leaf in ("w2", "b2"):
            fan_in = flat[sibling("w2")].shape[1]
        elif leaf == "query_embed":
            out[key] = rng.normal(size=arr.shape).astype(np.float32)
            continue
        elif leaf == "hole_embed":
            out[key] = (0.02 * rng.normal(size=arr.shape)).astype(np.float32)
            continue
        elif leaf == "inv_temp":
            out[key] = np.asarray(1.0 + rng.uniform(-0.1, 0.1), np.float32)
            continue
        elif leaf == "log_radius_slack":
            out[key] = (np.log(0.3) + rng.uniform(-0.1, 0.1, arr.shape)
                        ).astype(np.float32)
            continue
        else:
            raise KeyError(f"no random init rule for parameter {key!r}")
        bound = 1.0 / np.sqrt(fan_in)
        out[key] = rng.uniform(-bound, bound, arr.shape).astype(np.float32)
    return {"params": _unflatten(out)}


BIGRU_LAYER_PARAMS = tuple(f"{k}_{d}" for d in ("fwd", "bwd")
                           for k in ("w_ih", "b_ih", "w_hh", "b_hh"))


def bigru_layer_args(layer_params: Mapping[str, Any]
                     ) -> Tuple[torch.Tensor, ...]:
    """One ``BiGRULayer``'s flax parameters (``w_ih_fwd [D, 3H]``,
    ``b_ih_fwd [3H]``, ``w_hh_fwd [H, 3H]``, ``b_hh_fwd [3H]`` and the
    ``_bwd`` ones) as the eight weight tensors of ``ops/gru_cuda.py``
    ``bigru_layer``, in its order (CPU float32, the JAX layout). Strict: a
    name missing or unknown raises."""
    names = set(layer_params)
    if names != set(BIGRU_LAYER_PARAMS):
        raise KeyError(f"a BiGRULayer has {sorted(BIGRU_LAYER_PARAMS)}; got "
                       f"missing {sorted(set(BIGRU_LAYER_PARAMS) - names)}, "
                       f"unknown {sorted(names - set(BIGRU_LAYER_PARAMS))}")
    return tuple(torch.from_numpy(np.array(layer_params[n], dtype=np.float32,
                                           order="C"))
                 for n in BIGRU_LAYER_PARAMS)
