"""Reference-named ``.pth`` checkpoints from a JAX-layout parameter tree,
shared by ``tests/test_torch_pth.py`` and ``chip_smoke.py`` (so it imports
neither jax nor the JAX package).

``reference_state_dict`` inverts the layouts that
``train/torch_import.py`` documents: a dense kernel ``[in, out]`` becomes
``nn.Linear``'s weight ``[out, in]``; the q / k / v projections pack into
``nn.MultiheadAttention``'s ``in_proj_weight [3D, D]`` / ``in_proj_bias``;
a layer norm's ``scale`` is its ``weight``; the LSTM's merged bias ``b``
splits as ``bias_ih = b``, ``bias_hh = 0``; the reference's MLPs are
``Sequential``s with their Linear layers at 0, 2, ...
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _linear(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _norm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _mlp(sd: Dict, prefix: str, p: Mapping) -> None:
    for i in range(len(p)):
        _linear(sd, f"{prefix}.layers.{2 * i}", p[f"layer_{i}"])


def _mha(sd: Dict, prefix: str, p: Mapping) -> None:
    qkv = [p[n] for n in ("q_proj", "k_proj", "v_proj")]
    sd[f"{prefix}.in_proj_weight"] = np.concatenate(
        [np.asarray(d["kernel"]).T for d in qkv])
    sd[f"{prefix}.in_proj_bias"] = np.concatenate(
        [np.asarray(d["bias"]) for d in qkv])
    _linear(sd, f"{prefix}.out_proj", p["out_proj"])


def _lstm(sd: Dict, enc: Mapping) -> None:
    _linear(sd, "encoder.input_proj", enc["input_proj"])
    _linear(sd, "encoder.out_proj", enc["out_proj"])
    k = 0
    while f"lstm_{k}" in enc:
        layer = enc[f"lstm_{k}"]
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            def put(name, arr):
                sd[f"encoder.lstm.{name}_l{k}{suffix}"] = arr

            put("weight_ih", np.asarray(layer[f"w_ih_{d}"]).T)
            put("weight_hh", np.asarray(layer[f"w_hh_{d}"]).T)
            b = np.asarray(layer[f"b_{d}"])
            put("bias_ih", b)
            put("bias_hh", np.zeros_like(b))
        k += 1


def _lstm_decoder(sd: Dict, dec: Mapping) -> None:
    for n in ("q_proj", "k_proj", "v_proj", "class_head"):
        _linear(sd, f"decoder.{n}", dec[n])
    sd["decoder.inv_temp"] = np.asarray(dec["inv_temp"]).reshape(1)
    for n, (a, b) in (("gamma_mlp", ("gamma_1", "gamma_2")),
                      ("beta_mlp", ("beta_1", "beta_2"))):
        _linear(sd, f"decoder.{n}.0", dec[a])
        _linear(sd, f"decoder.{n}.2", dec[b])


def _transformer(sd: Dict, enc: Mapping, dec: Mapping) -> None:
    _linear(sd, "encoder.input_proj", enc["input_proj"])
    i = 0
    while f"layer_{i}" in enc:
        layer, p = enc[f"layer_{i}"], f"encoder.transformer.layers.{i}"
        _mha(sd, f"{p}.self_attn", layer["self_attn"])
        for n in ("linear1", "linear2"):
            _linear(sd, f"{p}.{n}", layer[n])
        for n in ("norm1", "norm2"):
            _norm(sd, f"{p}.{n}", layer[n])
        i += 1
    for n in ("q_proj", "k_proj", "class_head"):
        _linear(sd, f"decoder.{n}", dec[n])
    i = 0
    while f"layer_{i}" in dec:
        layer, p = dec[f"layer_{i}"], f"decoder.transformer.layers.{i}"
        _mha(sd, f"{p}.self_attn", layer["self_attn"])
        _mha(sd, f"{p}.multihead_attn", layer["cross_attn"])
        for n in ("linear1", "linear2"):
            _linear(sd, f"{p}.{n}", layer[n])
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{p}.{n}", layer[n])
        i += 1


def reference_state_dict(params: Mapping, model_type: str
                         ) -> Dict[str, torch.Tensor]:
    """The reference model's ``state_dict`` (CPU float32 tensors under the
    reference's names) holding the weights of the JAX-layout ``{"params":
    ...}`` tree ``params`` of an ``lstm`` or ``transformer`` without the
    port's extensions (objectness, centering, refinement, MoE)."""
    enc, dec = params["params"]["encoder"], params["params"]["decoder"]
    sd: Dict[str, np.ndarray] = {
        "decoder.query_embed.weight": np.asarray(dec["query_embed"])}
    if model_type == "lstm":
        _lstm(sd, enc)
        _lstm_decoder(sd, dec)
    elif model_type == "transformer":
        _transformer(sd, enc, dec)
    else:
        raise ValueError(f"no reference layout for {model_type!r}")
    _mlp(sd, "decoder.center_delta_head", dec["center_delta_head"])
    _mlp(sd, "decoder.size_head", dec["size_head"])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def write_reference_pth(path, params: Mapping, config: Mapping) -> None:
    """``torch.save`` a reference checkpoint: ``model_state_dict`` from
    ``reference_state_dict(params, config["model_type"])`` and ``config``
    (``model_type``, ``d_model``, ``num_queries``), as the reference's
    trainer saves it."""
    torch.save({"model_state_dict": reference_state_dict(
        params, config["model_type"]), "config": dict(config), "epoch": 0},
        path)
