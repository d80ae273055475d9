"""Import the reference's torch ``state_dict``s into the JAX layout (the
port's copy of the JAX package's ``train/torch_import.py``).

The reference saves ``torch.save({'model_state_dict': ..., 'config':
...})`` checkpoints. Its architectures compute what the JAX package's
(and so the port's) compute, so a name and layout mapping suffices:

- ``nn.Linear`` weight ``[out, in]`` -> dense kernel ``[in, out]``;
- ``nn.LSTM`` ``weight_ih_l{k}[_reverse] [4H, in]`` -> ``w_ih_{fwd|bwd}
  [in, 4H]``; ``bias_ih + bias_hh`` merge into one bias (only their sum
  is ever used);
- ``nn.MultiheadAttention``'s packed ``in_proj [3D, D]`` -> separate
  ``q_proj`` / ``k_proj`` / ``v_proj``;
- ``nn.LayerNorm`` (weight, bias) -> (scale, bias).

The result is a ``{"params": ...}`` tree of numpy arrays, which
``weights.load_params`` loads: one bridge for both checkpoint kinds.
``load_pth_checkpoint`` maps with the default layer counts (2 LSTM layers,
3 + 3 transformer layers), as the JAX package's does: a checkpoint with
more layers has its extra layers ignored.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _dense(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
            "bias": sd[f"{prefix}.bias"].copy()}


def _layernorm(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"].copy(),
            "bias": sd[f"{prefix}.bias"].copy()}


def _mlp(sd, prefix, num_layers=2):
    # the reference's MLP is a Sequential of Linear / ReLU pairs: the
    # Linear layers sit at 0, 2, ...
    return {f"layer_{i}": _dense(sd, f"{prefix}.layers.{2 * i}")
            for i in range(num_layers)}


def _seq_mlp2(sd, prefix, n1, n2):
    """Sequential(Linear, ReLU, Linear) -> two named dense layers (the
    FiLM gamma / beta MLPs)."""
    return {n1: _dense(sd, f"{prefix}.0"), n2: _dense(sd, f"{prefix}.2")}


def _mha(sd, prefix):
    """``nn.MultiheadAttention`` -> q / k / v / out dense layers."""
    w = sd[f"{prefix}.in_proj_weight"]            # [3D, D]
    b = sd[f"{prefix}.in_proj_bias"]              # [3D]
    d = w.shape[1]
    out = {name: {"kernel": np.ascontiguousarray(w[i * d:(i + 1) * d].T),
                  "bias": b[i * d:(i + 1) * d].copy()}
           for i, name in enumerate(("q_proj", "k_proj", "v_proj"))}
    out["out_proj"] = _dense(sd, f"{prefix}.out_proj")
    return out


def import_lstm_state_dict(sd: Dict[str, np.ndarray],
                           lstm_layers: int = 2) -> Dict:
    """Map a reference ``TraceToColliderLSTM`` state_dict."""
    enc = {"input_proj": _dense(sd, "encoder.input_proj"),
           "out_proj": _dense(sd, "encoder.out_proj")}
    for k in range(lstm_layers):
        layer = {}
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            w_ih = sd[f"encoder.lstm.weight_ih_l{k}{suffix}"]
            w_hh = sd[f"encoder.lstm.weight_hh_l{k}{suffix}"]
            b = (sd[f"encoder.lstm.bias_ih_l{k}{suffix}"]
                 + sd[f"encoder.lstm.bias_hh_l{k}{suffix}"])
            layer[f"w_ih_{direction}"] = np.ascontiguousarray(w_ih.T)
            layer[f"w_hh_{direction}"] = np.ascontiguousarray(w_hh.T)
            layer[f"b_{direction}"] = b
        enc[f"lstm_{k}"] = layer
    dec = {
        "query_embed": sd["decoder.query_embed.weight"].copy(),
        "q_proj": _dense(sd, "decoder.q_proj"),
        "k_proj": _dense(sd, "decoder.k_proj"),
        "v_proj": _dense(sd, "decoder.v_proj"),
        "inv_temp": sd["decoder.inv_temp"].reshape(()),
        "center_delta_head": _mlp(sd, "decoder.center_delta_head"),
        "size_head": _mlp(sd, "decoder.size_head"),
        "class_head": _dense(sd, "decoder.class_head"),
    }
    dec.update(_seq_mlp2(sd, "decoder.gamma_mlp", "gamma_1", "gamma_2"))
    dec.update(_seq_mlp2(sd, "decoder.beta_mlp", "beta_1", "beta_2"))
    return {"params": {"encoder": enc, "decoder": dec}}


def import_transformer_state_dict(sd: Dict[str, np.ndarray],
                                  enc_layers: int = 3,
                                  dec_layers: int = 3) -> Dict:
    """Map a reference ``TraceToColliderTransformer`` state_dict."""
    enc = {"input_proj": _dense(sd, "encoder.input_proj")}
    for i in range(enc_layers):
        p = f"encoder.transformer.layers.{i}"
        enc[f"layer_{i}"] = {
            "self_attn": _mha(sd, f"{p}.self_attn"),
            "linear1": _dense(sd, f"{p}.linear1"),
            "linear2": _dense(sd, f"{p}.linear2"),
            "norm1": _layernorm(sd, f"{p}.norm1"),
            "norm2": _layernorm(sd, f"{p}.norm2"),
        }
    dec = {
        "query_embed": sd["decoder.query_embed.weight"].copy(),
        "q_proj": _dense(sd, "decoder.q_proj"),
        "k_proj": _dense(sd, "decoder.k_proj"),
        "center_delta_head": _mlp(sd, "decoder.center_delta_head"),
        "size_head": _mlp(sd, "decoder.size_head"),
        "class_head": _dense(sd, "decoder.class_head"),
    }
    for i in range(dec_layers):
        p = f"decoder.transformer.layers.{i}"
        dec[f"layer_{i}"] = {
            "self_attn": _mha(sd, f"{p}.self_attn"),
            "cross_attn": _mha(sd, f"{p}.multihead_attn"),
            "linear1": _dense(sd, f"{p}.linear1"),
            "linear2": _dense(sd, f"{p}.linear2"),
            "norm1": _layernorm(sd, f"{p}.norm1"),
            "norm2": _layernorm(sd, f"{p}.norm2"),
            "norm3": _layernorm(sd, f"{p}.norm3"),
        }
    return {"params": {"encoder": enc, "decoder": dec}}


def import_state_dict(sd: Dict[str, np.ndarray], model_type: str,
                      **kwargs) -> Dict:
    if model_type == "lstm":
        return import_lstm_state_dict(sd, **kwargs)
    if model_type == "transformer":
        return import_transformer_state_dict(sd, **kwargs)
    raise ValueError(f"unsupported model_type {model_type}")


def load_pth_checkpoint(path: str):
    """Load a reference ``.pth`` checkpoint: ``(params, config dict)``,
    the parameters as a ``{"params": ...}`` tree in the JAX layout. The
    file is unpickled (``weights_only=False``, as the reference saves a
    config dict beside the weights): load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = ckpt.get("config", {})
    sd = {k: v.detach().cpu().numpy()
          for k, v in ckpt["model_state_dict"].items()}
    return import_state_dict(sd, cfg.get("model_type", "transformer")), cfg
