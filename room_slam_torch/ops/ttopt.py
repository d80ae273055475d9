"""Test-time trace-consistency adaptation of predicted boxes (counterpart of
the JAX package's ``ops/ttopt.py``).

A fixed number of Adam steps on per-box XZ center and log-size deltas
against the physics the trace supplies: non-penetration (the walker's body
cannot overlap a solid), envelope bounding, optional contact attraction
(global, per-face kernel, per-face nearest approach), under a trust-region
pull toward the model's boxes. The gradient comes from
``torch.autograd.grad``; the Adam update is written out as optax's
(``m_hat / (sqrt(v_hat) + 1e-8)`` with bias correction, ``eps_root`` 0),
as optax rounds it, in float32. The loss and its gradient are evaluated in
float64 and the gradient rounded to float32: the loss is piecewise (a
point enters or leaves a box's body, a penetration count changes) and
Adam turns a gradient near 0 into a step of up to lr, so a float32
gradient's rounding noise, which differs between the card's and the CPU's
summation orders, would set the card's boxes up to lr apart from the
CPU's; in float64 both round to the same float32 gradient. Against the
JAX package's float32 gradient it differs by the same ~1e-7 relative as
another float32 summation order would, except on a trace of length 0,
whose 1e9 extent sentinel float32 absorbs (``x_min - x`` rounds to
``x_min``) and float64 does not. ``stop_gradient`` is
``detach``. At ties the gradients follow JAX's: ``torch.minimum`` /
``maximum`` / ``amin`` / ``amax`` split it evenly and ``relu`` gives 0 at
0, as JAX does, but ``jnp.abs`` gives +1 at 0 where ``torch.abs`` gives 0,
so the loss takes ``_abs``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TTOptParams(NamedTuple):
    """Hyperparameters of the adaptation (an operating-point dimension, not
    trained); the fields and defaults of the reference's."""

    steps: int = 150          # Adam steps per capture
    lr: float = 0.02          # Adam step size
    w_pen: float = 1.0        # non-penetration weight
    w_env: float = 0.2        # envelope-bounding weight
    w_att: float = 0.0        # contact-attraction weight
    w_trust: float = 0.3      # trust-region pull toward the model's boxes
    body_radius: float = 0.2  # walker body half-width around the sensor (m)
    body_below: float = 1.2   # body extends this far below the sensor (m)
    body_above: float = 0.3   # ... and this far above (m)
    env_margin: float = 0.5   # allowed footprint distance beyond the extent
    att_sigma: float = 0.3    # contact kernel width (m)
    w_att_faces: float = 0.0  # per-face gated kernel contact attraction
    att_mass: float = 3.0     # min kernel-weighted contact mass per face
    w_att_min: float = 0.0    # per-face nearest-approach attraction
    deadband: float = 0.0     # a box feels the non-penetration force only
                              # when some point penetrates deeper than this


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose gradient at 0 is +1, as ``jnp.abs``'s."""
    return torch.where(x >= 0, x, -x)


def _physics_loss(dc, dls, boxes0, px, pz, valid, ygate, extent,
                  p: TTOptParams) -> torch.Tensor:
    """Total physics loss of the adapted boxes: ``dc [Q, 2]`` XZ center
    deltas, ``dls [Q, 2]`` XZ log-size deltas, ``boxes0 [Q, 6]`` the
    model's estimate, ``px / pz / valid [L]``, ``ygate [Q, L]`` the
    box-body y-overlap indicator, ``extent`` the trace's (x_min, x_max,
    z_min, z_max). Every term is a sum of per-box quantities."""
    cx = boxes0[:, 0] + dc[:, 0]
    cz = boxes0[:, 2] + dc[:, 1]
    hx = 0.5 * boxes0[:, 3] * torch.exp(dls[:, 0])
    hz = 0.5 * boxes0[:, 5] * torch.exp(dls[:, 1])
    w_pt = valid[None, :] * ygate                               # [Q, L]

    # non-penetration: per-point depth inside the body-inflated footprint,
    # as a depth-weighted escape term plus a count-normalized mean depth
    dx_in = (hx[:, None] + p.body_radius) - _abs(px[None, :]
                                                      - cx[:, None])
    dz_in = (hz[:, None] + p.body_radius) - _abs(pz[None, :]
                                                      - cz[:, None])
    pen = torch.relu(torch.minimum(dx_in, dz_in)) * w_pt
    if p.deadband > 0.0:
        gate = (pen.amax(dim=1) > p.deadband).to(pen.dtype).detach()
        pen = pen * gate[:, None]
    sum_pen = pen.sum(dim=1)
    n_pen = (pen > 0).sum(dim=1).to(pen.dtype).detach()
    loss_pen = torch.sum(
        (pen ** 2).sum(dim=1) / torch.clamp(sum_pen.detach(), min=1e-6)
        + 0.5 * sum_pen / torch.clamp(n_pen, min=1.0))

    # envelope bounding: footprint distance beyond extent + margin
    x_min, x_max, z_min, z_max = extent
    ex = torch.relu(torch.maximum(x_min - (cx + hx), (cx - hx) - x_max))
    ez = torch.relu(torch.maximum(z_min - (cz + hz), (cz - hz) - z_max))
    d_out = torch.sqrt(ex ** 2 + ez ** 2 + 1e-12)
    loss_env = torch.relu(d_out - p.env_margin).sum()

    # contact attraction: kernel-weighted approach distance of nearby
    # outside points to the nearest face
    ax = torch.relu(_abs(px[None, :] - cx[:, None]) - hx[:, None])
    az = torch.relu(_abs(pz[None, :] - cz[:, None]) - hz[:, None])
    a = torch.sqrt(ax ** 2 + az ** 2 + 1e-12)                   # [Q, L]
    kw = torch.exp(-0.5 * (a / p.att_sigma) ** 2) * w_pt
    loss_att = torch.sum((kw * a).sum(dim=1) / (kw.sum(dim=1) + 1e-6))

    r = p.body_radius
    faces = None
    if p.w_att_faces > 0.0 or p.w_att_min > 0.0:
        band_z = (_abs(pz[None, :] - cz[:, None])
                  < hz[:, None] + p.att_sigma)
        band_x = (_abs(px[None, :] - cx[:, None])
                  < hx[:, None] + p.att_sigma)
        # outward distance beyond each XZ face plane and its sector band
        faces = ((px[None, :] - (cx[:, None] + hx[:, None]), band_z),
                 ((cx[:, None] - hx[:, None]) - px[None, :], band_z),
                 (pz[None, :] - (cz[:, None] + hz[:, None]), band_x),
                 ((cz[:, None] - hz[:, None]) - pz[None, :], band_x))

    # per-face gated kernel attraction toward touching distance
    loss_att_f = 0.0
    if p.w_att_faces > 0.0:
        def face(a_signed, band):
            kw_f = (torch.exp(-0.5 * ((a_signed - r) / p.att_sigma) ** 2)
                    * w_pt * band * (a_signed > 0))
            kw_d = kw_f.detach()
            mass = kw_d.sum(dim=1)
            gate = (mass > p.att_mass).to(torch.float32).detach()
            err = (kw_d * (a_signed - r) ** 2).sum(dim=1)
            return gate * err / torch.clamp(mass, min=1e-6)

        loss_att_f = sum(face(*f) for f in faces).sum()

    # per-face nearest-approach attraction
    loss_att_m = 0.0
    if p.w_att_min > 0.0:
        def face_min(a_signed, band):
            ok = (w_pt > 0) & band & (a_signed > 0)
            a_ok = torch.where(ok, a_signed, torch.inf)
            d_min = a_ok.amin(dim=1)                            # [Q]
            near = (ok & (a_signed < r + p.att_sigma)).to(
                torch.float32).detach().sum(dim=1)
            gate = (torch.isfinite(d_min)
                    & (d_min.detach() < r + p.att_sigma)
                    & (near >= p.att_mass)).to(torch.float32).detach()
            d_safe = torch.where(torch.isfinite(d_min), d_min, r)
            return gate * (d_safe - r) ** 2

        loss_att_m = sum(face_min(*f) for f in faces).sum()

    loss_trust = (dc ** 2).sum() + (dls ** 2).sum()
    return (p.w_pen * loss_pen + p.w_env * loss_env
            + p.w_att * loss_att + p.w_att_faces * loss_att_f
            + p.w_att_min * loss_att_m + p.w_trust * loss_trust)


def _ygate(boxes: torch.Tensor, py: torch.Tensor,
           p: TTOptParams) -> torch.Tensor:
    """``[Q, L]`` float: box q's y span overlaps the walker's body column
    ``[py - body_below, py + body_above]`` at point l."""
    by_lo = boxes[:, 1] - 0.5 * boxes[:, 4]
    by_hi = boxes[:, 1] + 0.5 * boxes[:, 4]
    return ((by_lo[:, None] < py[None, :] + p.body_above)
            & (by_hi[:, None] > py[None, :] - p.body_below)).to(boxes.dtype)


def penetration_depth(boxes: torch.Tensor, raw: torch.Tensor, length,
                      params: TTOptParams = TTOptParams()) -> torch.Tensor:
    """``[Q]`` mean in-body penetration depth (m) of the first ``length``
    points of ``raw [L, 4]`` into each box of ``boxes [Q, 6]``: per
    penetrating point the smallest axis distance to an XZ face, averaged
    over those points; 0 for a box the walk never crosses."""
    valid = (torch.arange(raw.shape[0], device=raw.device) < length).to(
        raw.dtype)
    px, pz = raw[:, 0], raw[:, 2]
    cx, cz = boxes[:, 0], boxes[:, 2]
    hx, hz = 0.5 * boxes[:, 3], 0.5 * boxes[:, 5]
    w_pt = valid[None, :] * _ygate(boxes, raw[:, 1], params)
    dx_in = (hx[:, None] + params.body_radius) - torch.abs(px[None, :]
                                                           - cx[:, None])
    dz_in = (hz[:, None] + params.body_radius) - torch.abs(pz[None, :]
                                                           - cz[:, None])
    pen = torch.relu(torch.minimum(dx_in, dz_in)) * w_pt
    n_pen = (pen > 0).sum(dim=1).to(pen.dtype)
    return pen.sum(dim=1) / torch.clamp(n_pen, min=1.0)


def adapt_boxes(boxes: torch.Tensor, raw: torch.Tensor, length,
                params: TTOptParams = TTOptParams()) -> torch.Tensor:
    """Adapt the XZ centers and sizes of ``boxes [Q, 6]`` to the capture's
    trace ``raw [L, 4]`` (first ``length`` points) by ``params.steps``
    Adam steps on ``_physics_loss``; y center and size are untouched.
    Runs with gradients enabled whatever the caller's mode."""
    # fresh copies made with autograd on, so the loop works under
    # ``torch.inference_mode`` too
    with torch.inference_mode(False), torch.enable_grad():
        boxes, raw = boxes.detach().clone(), raw.detach().clone()
        valid = (torch.arange(raw.shape[0], device=raw.device)
                 < length).to(raw.dtype)
        px, pz = raw[:, 0], raw[:, 2]
        extent = (torch.where(valid > 0, px, 1e9).amin(),
                  torch.where(valid > 0, px, -1e9).amax(),
                  torch.where(valid > 0, pz, 1e9).amin(),
                  torch.where(valid > 0, pz, -1e9).amax())
        ygate = _ygate(boxes, raw[:, 1], params)

        b1, b2, eps = 0.9, 0.999, 1e-8
        Q = boxes.shape[0]
        deltas = [torch.zeros(Q, 2, dtype=boxes.dtype, device=boxes.device)
                  for _ in range(2)]
        mu = [torch.zeros_like(d) for d in deltas]
        nu = [torch.zeros_like(d) for d in deltas]
        b1_t, b2_t = (torch.tensor(b, dtype=boxes.dtype, device=boxes.device)
                      for b in (b1, b2))
        # the loss and its gradient in float64 (see the module docstring)
        f64 = (boxes.double(), px.double(), pz.double(), valid.double(),
               ygate.double(), tuple(e.double() for e in extent))
        for step in range(1, params.steps + 1):
            leaves = [d.detach().double().requires_grad_(True)
                      for d in deltas]
            loss = _physics_loss(*leaves, *f64, params)
            grads = [g.to(boxes.dtype)
                     for g in torch.autograd.grad(loss, leaves)]
            bc1 = 1 - b1_t ** step
            bc2 = 1 - b2_t ** step
            with torch.no_grad():
                for i, g in enumerate(grads):
                    mu[i] = (1 - b1) * g + b1 * mu[i]
                    nu[i] = (1 - b2) * (g ** 2) + b2 * nu[i]
                    upd = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + eps)
                    deltas[i] = deltas[i] + (-params.lr) * upd
    dc, dls = deltas
    out = boxes.clone()
    out[:, 0] = out[:, 0] + dc[:, 0]
    out[:, 2] = out[:, 2] + dc[:, 1]
    out[:, 3] = out[:, 3] * torch.exp(dls[:, 0])
    out[:, 5] = out[:, 5] * torch.exp(dls[:, 1])
    return out
