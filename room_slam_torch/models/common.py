"""Shared model pieces: dense layers, MLP heads, dropout, layer norm,
sinusoidal positions, multi-head attention, the switch-MoE FFN, trace
centering, output assembly and the contact-evidence refinement stage
(counterparts of the JAX package's ``models/common.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` with the JAX package's init: weight and bias
    ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)); ``zero_init`` starts both at 0
    (the refinement deltas, so an untrained stage is the identity).

    ``dtype`` is flax's compute dtype: input, weight and bias are cast to it
    and the output comes in it (bfloat16 halves the ``[B, N, D]`` streams).
    The parameters stay float32."""

    def __init__(self, in_features: int, out_features: int,
                 zero_init: bool = False, dtype: torch.dtype | None = None):
        self.zero_init = zero_init
        self.compute_dtype = dtype
        super().__init__(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return nn.functional.linear(x.to(cd), self.weight.to(cd),
                                    self.bias.to(cd))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        if self.zero_init:
            self.weight.zero_()
            self.bias.zero_()
            return
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)


def compute_dtype_of(name: str) -> torch.dtype | None:
    """``ModelConfig.compute_dtype`` as the ``Dense`` compute dtype: None
    for float32 (plain float32 layers), else the torch dtype."""
    if name == "float32":
        return None
    if name != "bfloat16":
        raise ValueError(f"compute_dtype={name!r}: float32 or bfloat16")
    return torch.bfloat16


def reset_parameters(module: nn.Module,
                     generator: torch.Generator | None = None) -> None:
    """Re-initialize every submodule of ``module`` from one generator, in
    module order. Every parameter-owning module of this package defines
    ``reset_parameters(generator)``."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: zero each element with probability ``rate`` and
    scale the kept ones by ``1 / (1 - rate)``; the identity in eval mode or
    at rate 0. The mask is drawn from ``generator`` (``torch.rand``), so a
    seeded trainer draws the same masks run after run."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``'s numerics (not torch's): epsilon 1e-6 and
    the fast variance ``E[x^2] - E[x]^2`` clipped at 0, then ``(x - mean)
    * (rsqrt(var + eps) * scale) + bias``. The scale is torch's ``weight``
    (flax's ``scale``; ``weights.py`` renames it by this type)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__(features, eps=eps)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def sinusoidal_positions(length: int, d_model: int,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """Sinusoidal position table ``[length, d_model]``: even columns
    ``sin(pos * div)``, odd ones ``cos``, computed in float32 and then
    cast to ``dtype``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(length, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def masked_scores(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``scores`` with the keys where ``mask`` (broadcast to it) is False
    set to the dtype's lowest finite value, as the JAX package masks."""
    return scores.masked_fill(~mask, torch.finfo(scores.dtype).min)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with torch ``nn.MultiheadAttention``'s
    numerics: separate ``q_proj`` / ``k_proj`` / ``v_proj`` / ``out_proj``
    dense layers, q divided by ``sqrt(head_dim)`` before the product, masked
    keys at the dtype's lowest value, the softmax in the stream dtype and
    dropout on the attention probabilities from ``generator``. Plain
    tensor ops: the JAX package computes attention outside any kernel."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        self.nhead = nhead
        self.dropout = dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(d_model, d_model))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``query [B, Tq, D]``, ``key`` / ``value [B, Tk, D]``,
        ``key_padding_mask [B, Tk]`` (True = valid)."""
        B, Tq, D = query.shape
        hd = D // self.nhead

        def split(x):
            return x.view(B, x.shape[1], self.nhead, hd).transpose(1, 2)

        q = split(self.q_proj(query)) / math.sqrt(hd)
        k = split(self.k_proj(key))
        v = split(self.v_proj(value))
        scores = torch.matmul(q, k.transpose(-1, -2))        # [B, H, Tq, Tk]
        if key_padding_mask is not None:
            scores = masked_scores(scores, key_padding_mask[:, None, None, :])
        attn = dropout(torch.softmax(scores, dim=-1), self.dropout,
                       self.training, generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Tq, D)
        return self.out_proj(out)


class MoEFFN(nn.Module):
    """Switch-style mixture-of-experts FFN: top-1 routing (``argmax``, a tie
    goes to the first expert) with dense dispatch, every expert computing
    every token (``[B, E, N, F]``) and the winner's output scaled by its
    gate probability, so gradients reach the router.

    Parameters as the JAX tree: ``gate`` a dense layer, ``w1 [E, D, F]``,
    ``b1 [E, F]`` (U(+-1/sqrt(D))), ``w2 [E, F, D]``, ``b2 [E, D]``
    (U(+-1/sqrt(F))). Each forward stores the load-balance term ``E *
    sum_e f_e * p_e`` over the valid tokens (``mask``) as ``self.aux``,
    where flax sows it under ``'losses'``; the train step
    (``train/loop.py``) reads it and clears it."""

    def __init__(self, d_model: int, dim_feedforward: int, num_experts: int,
                 dropout: float = 0.0):
        super().__init__()
        E, D, F = num_experts, d_model, dim_feedforward
        self.num_experts = E
        self.dropout = dropout
        self.gate = Dense(D, E)
        self.w1 = nn.Parameter(torch.empty(E, D, F))
        self.b1 = nn.Parameter(torch.empty(E, F))
        self.w2 = nn.Parameter(torch.empty(E, F, D))
        self.b2 = nn.Parameter(torch.empty(E, D))
        self.aux: Optional[torch.Tensor] = None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        b1 = 1.0 / math.sqrt(self.w1.shape[1])
        b2 = 1.0 / math.sqrt(self.w2.shape[1])
        for p, bound in ((self.w1, b1), (self.b1, b1), (self.w2, b2),
                         (self.b2, b2)):
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        E = self.num_experts
        probs = torch.softmax(self.gate(x), dim=-1)             # [B, N, E]
        top = probs.argmax(dim=-1)                              # [B, N]
        onehot = nn.functional.one_hot(top, E).to(x.dtype)
        route = onehot * probs.gather(-1, top[..., None])
        h = torch.relu(torch.einsum("bnd,edf->benf", x, self.w1)
                       + self.b1[None, :, None, :])             # [B, E, N, F]
        h = dropout(h, self.dropout, self.training, generator)
        y = (torch.einsum("benf,efd->bend", h, self.w2)
             + self.b2[None, :, None, :])                       # [B, E, N, D]
        out = torch.einsum("bend,bne->bnd", y, route)
        if mask is None:
            frac = onehot.float().mean(dim=(0, 1))
            mean_p = probs.float().mean(dim=(0, 1))
        else:
            m = mask.float()[..., None]
            denom = torch.clamp(m.sum(), min=1.0)
            frac = (onehot.float() * m).sum(dim=(0, 1)) / denom
            mean_p = (probs.float() * m).sum(dim=(0, 1)) / denom
        self.aux = E * torch.sum(frac * mean_p)
        return out


class MLP(nn.Sequential):
    """``num_layers``-layer ReLU MLP; layers are named ``layer_<i>``."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        for i in range(num_layers):
            out = output_dim if i == num_layers - 1 else hidden_dim
            self.add_module(f"layer_{i}", Dense(in_dim, out))
            in_dim = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self)
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x


def _full_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)


def center_traces_xz(traces: torch.Tensor, mask: Optional[torch.Tensor]):
    """Shift traces so the masked XZ mean sits at the origin.

    Returns (shifted traces, offsets ``[B, 1, 2]``). Padded rows are
    re-zeroed after the shift: the recurrences consume padding steps, so a
    shifted padding row would break translation invariance. The mean sums
    in float64 and rounds once, so the card and the CPU shift by the same
    float32 offset: the hole tokens' raster (``ops/refine.hole_components``)
    moves a point to another cell on a one-ulp shift.
    """
    if mask is None:
        mask = _full_mask(traces)
    m = mask[..., None].double()
    denom = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    xz = torch.stack([traces[..., 0], traces[..., 2]], dim=-1).double()
    offs = ((xz * m).sum(dim=1, keepdim=True) / denom).to(traces.dtype)
    shifted = traces.clone()
    shifted[..., 0] -= offs[..., 0]
    shifted[..., 2] -= offs[..., 1]
    shifted = torch.where(mask[..., None], shifted, torch.zeros_like(shifted))
    return shifted, offs


def uncenter_boxes_xz(boxes: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Undo ``center_traces_xz`` on boxes ``[..., Q, 6]`` (centers only)."""
    out = boxes.clone()
    out[..., 0] += offs[..., 0]
    out[..., 2] += offs[..., 1]
    return out


def assemble_output(outs, offs, objectness: bool, refine_stages: int):
    """Output dict of the query-decoder models: un-center boxes and unpack
    the optional objectness and per-stage entries of the decoder tuple."""
    boxes = outs[0]
    if offs is not None:
        boxes = uncenter_boxes_xz(boxes, offs)
    out = {"pred_boxes": boxes, "pred_classes": outs[1]}
    idx = 2
    if objectness:
        out["pred_objectness"] = outs[idx]
        idx += 1
    if refine_stages:
        aux = outs[idx]                                        # [S, B, Q, 6]
        out["pred_aux_boxes"] = (uncenter_boxes_xz(aux, offs)
                                 if offs is not None else aux)
    return out


def trace_extent_planes(norm_coords: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Masked XZ extent ``[B, 4] = (x_min, x_max, z_min, z_max)`` of the
    trace in normalized coordinates; zeros for an all-padding row."""
    big = torch.tensor(1e9, dtype=norm_coords.dtype, device=norm_coords.device)
    x, z = norm_coords[..., 0], norm_coords[..., 2]
    ext = torch.stack([
        torch.where(mask, x, big).amin(dim=-1),
        torch.where(mask, x, -big).amax(dim=-1),
        torch.where(mask, z, big).amin(dim=-1),
        torch.where(mask, z, -big).amax(dim=-1),
    ], dim=-1)
    return torch.where(mask.any(dim=-1, keepdim=True), ext,
                       torch.zeros_like(ext))


def extent_gap_features(center_n: torch.Tensor, size_n: torch.Tensor,
                        extent: torch.Tensor) -> torch.Tensor:
    """``[B, Q, 6]``: signed gaps from each box's four XZ faces to the trace
    extent planes (positive = inside), then the x and z spans."""
    x_min, x_max = extent[:, None, 0], extent[:, None, 1]
    z_min, z_max = extent[:, None, 2], extent[:, None, 3]
    cx, cz = center_n[..., 0], center_n[..., 2]
    hx, hz = 0.5 * size_n[..., 0], 0.5 * size_n[..., 2]
    spans = torch.stack([x_max - x_min, z_max - z_min], dim=-1)  # [B, 1, 2]
    return torch.cat([
        torch.stack([(cx - hx) - x_min, x_max - (cx + hx),
                     (cz - hz) - z_min, z_max - (cz + hz)], dim=-1),
        spans.expand(center_n.shape[0], center_n.shape[1], 2),
    ], dim=-1)


def contact_evidence(center_n, radius, norm_coords, values, mask):
    """Gaussian-pool trace evidence in the XZ plane around each query's
    current box center.

    Args:
        center_n ``[B, Q, 3]``, radius ``[B, Q]``, norm_coords ``[B, N, 3]``,
        values ``[B, N, D]``, mask ``[B, N]`` (True = valid).

    Returns:
        pooled values ``[B, Q, D]``, mean point offset from the center in
        radii ``[B, Q, 3]``, and the density ``[B, Q]``.
    """
    m = mask.to(torch.float32)
    px, pz = norm_coords[..., 0], norm_coords[..., 2]
    cx, cz = center_n[..., 0], center_n[..., 2]
    d2 = ((cx ** 2 + cz ** 2)[:, :, None]
          + (px ** 2 + pz ** 2)[:, None, :]
          - 2.0 * (torch.einsum("bq,bn->bqn", cx, px)
                   + torch.einsum("bq,bn->bqn", cz, pz)))
    w = torch.exp(-0.5 * d2 / torch.clamp(radius[..., None] ** 2, min=1e-8))
    w = w * m[:, None, :]
    wsum = w.sum(-1)
    wn = w / (wsum[..., None] + 1e-6)
    pooled_v = torch.einsum("bqn,bnd->bqd", wn.to(values.dtype),
                            values).float()
    pooled_p = torch.einsum("bqn,bnd->bqd", wn, norm_coords)
    offset = (pooled_p - center_n) / radius[..., None]
    density = wsum / torch.clamp(m.sum(-1)[:, None], min=1.0)
    return pooled_v, offset, density


class ContactRefineStage(nn.Module):
    """One box-refinement step from trace-contact evidence: pool evidence
    around the current box, then a bounded center step (at most one pooling
    radius) and a bounded log-size factor (at most e^+-1)."""

    def __init__(self, d_model: int, extent_features: bool = False):
        super().__init__()
        self.extent_features = extent_features
        feat = 2 * d_model + 8 + (6 if extent_features else 0)
        self.log_radius_slack = nn.Parameter(torch.empty(1))
        self.fuse = Dense(feat, d_model)
        self.dcenter = Dense(d_model, 3, zero_init=True)
        self.dsize = Dense(d_model, 3, zero_init=True)
        self.dfeat = Dense(d_model, d_model, zero_init=True)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.log_radius_slack.fill_(math.log(0.3))

    def forward(self, decoded, center_n, size_n, norm_coords, values, mask,
                extent=None):
        radius = (0.5 * torch.linalg.vector_norm(size_n[..., ::2], dim=-1)
                  + torch.exp(self.log_radius_slack[0]))
        pooled_v, offset, density = contact_evidence(
            center_n, radius, norm_coords, values, mask)
        feats = [decoded, pooled_v, offset, density[..., None], size_n,
                 radius[..., None]]
        if self.extent_features:
            feats.append(extent_gap_features(center_n, size_n, extent))
        h = torch.relu(self.fuse(torch.cat(feats, dim=-1)))
        center_n = center_n + torch.tanh(self.dcenter(h)) * radius[..., None]
        size_n = size_n * torch.exp(torch.tanh(self.dsize(h)))
        decoded = decoded + self.dfeat(h)
        return decoded, center_n, size_n
