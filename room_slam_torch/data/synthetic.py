"""Synthetic rooms and walks (counterpart of the JAX package's
``data/synthetic.py``), batched over rooms and walks in torch.

Every draw comes from ``data/prng.py``, JAX's threefry keys bit for bit,
through the same tree of ``split`` / ``fold_in`` calls, so a seed gives the
JAX package's rooms and walks. The arithmetic follows the reference's
float32 order; where XLA's CPU backend contracts ``a * b + c`` into one
rounding, ``prng.fma`` does too, and transcendentals (``exp``, ``log``,
``sin``, ``cos``, ``atan2``) are evaluated in float64 and rounded once, so
the card and the CPU agree. The reference's library functions round
differently in the last bit now and then, so values agree to ~1e-7
relative, and a walk whose reflection test lands within an ulp of a box's
edge can take the other branch.

- ``sample_room``: a rectangle or an L-shaped two-room layout (8 wall
  slots) and up to ``max_furniture`` pieces kept by sequential corridor
  rejection (a Python loop over the attempts, vectorised over rooms);
- ``simulate_trace``: the agent's heading walk with reflection, or the
  human's waypoint walk with per-wall clearance and a vertical wander; a
  Python loop over time whose every step is a few tensor ops over all
  walks at once (the reference's ``lax.scan``); the step keys' draws come
  up front in chunks of ``STEP_CHUNK`` steps, which bound their memory;
- ``box_evidence_mask``, ``generate_rooms_and_traces`` and
  ``write_synthetic_dataset`` as in the reference.

Everything runs on ``device`` (the card by default; ``device="cpu"``
asks for the CPU).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from room_slam_torch import resolve_device
from room_slam_torch.config import BENCH_LABELS
from room_slam_torch.data import formats, prng
from room_slam_torch.data.prng import fma

_BLOCK = BENCH_LABELS["BLOCK"]
_LOW = BENCH_LABELS["LOW"]
_MID = BENCH_LABELS["MID"]
_HIGH = BENCH_LABELS["HIGH"]

AGENT_RADIUS = 0.3          # clearance the walker keeps from boxes
WALK_SPEED = 2.0            # m/s
TURN_INTERVAL = 5.0         # s between random heading changes
WALL_THICKNESS = 0.125
AGENT_Y = -0.46             # the agent's constant head height
FLOOR_Y = -0.5              # the real rooms' floor level
N_WALL_SLOTS = 8            # box slots reserved for wall segments
HUMAN_SPAN = (3.0, 5.5)     # human-mode room side range (m)
AGENT_SPAN = (3.5, 9.0)
CORRIDOR = 2 * AGENT_RADIUS + 0.15
CLASS_P = (0.38, 0.31, 0.08, 0.23)   # LOW, MID, HIGH, BLOCK furniture
STEP_CHUNK = 512            # walk steps whose draws are made at once

F32 = torch.float32


def _in_f64(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` in float64 on float32 inputs, rounded once to float32."""
    return fn(*(x.double() for x in xs)).float()


def _log32(v: float) -> float:
    """float32 ``log`` of the float32 nearest ``v``, rounded once."""
    return float(np.float32(math.log(float(np.float32(v)))))


def _log_uniform(key, lo, hi):
    return _in_f64(torch.exp, prng.uniform(key, (), _log32(lo), _log32(hi)))


def _flat_keys(key: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    return key.reshape(-1, 2), tuple(key.shape[:-1])


def sample_room(key: torch.Tensor, max_colliders: int = 50,
                max_furniture: int = 8, multi_room_prob: float = 0.0,
                wall_adjacent_prob: float = 0.0,
                span_range: Tuple[float, float] = AGENT_SPAN
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layout per key (``key`` ``[..., 2]``): ``(boxes [..., M, 6],
    labels [..., M] int64, valid [..., M] bool)`` with M = max_colliders;
    wall segments in slots ``[0, N_WALL_SLOTS)``, furniture after them.
    The reference's ``sample_room``; its docstring gives the layout and
    the furniture priors."""
    keys, lead = _flat_keys(key)
    R, dev, M = keys.shape[0], keys.device, max_colliders
    kw, kh, kn, kf, km = prng.split(keys, 5).unbind(-2)
    span_lo, span_hi = span_range
    width = prng.uniform(kw, (), span_lo, span_hi)
    depth = prng.uniform(prng.fold_in(kw, 1), (), span_lo, span_hi)
    wall_h = prng.uniform(kh, (), 2.6, 4.0)
    wt = WALL_THICKNESS
    half_w, half_d = width / 2, depth / 2
    cy = wall_h / 2 + FLOOR_Y

    # the annex on the +x side, with a doorway in the shared wall
    multi = prng.uniform(km) < multi_room_prob
    kb1, kb2, kb3, kd1, kd2 = prng.split(prng.fold_in(km, 1), 5).unbind(-2)
    b_w = prng.uniform(kb1, (), 2.5, 6.0)
    b_d = torch.minimum(prng.uniform(kb2, (), 2.5, 7.0), depth - 0.6)
    zb_margin = half_d - b_d / 2 - 0.3
    zb = prng.uniform(kb3, (), -1.0, 1.0) * zb_margin.clamp_min(0.0)
    door_w = torch.minimum(prng.uniform(kd1, (), 1.6, 2.4), b_d - 0.4)
    zdoor_margin = b_d / 2 - door_w / 2 - 0.2
    zdoor = fma(prng.uniform(kd2, (), -1.0, 1.0),
                zdoor_margin.clamp_min(0.0), zb)
    door_lo, door_hi = zdoor - door_w / 2, zdoor + door_w / 2
    seg1_len = (door_lo + half_d).clamp_min(0.0)
    seg2_len = (half_d - door_hi).clamp_min(0.0)
    bx_c = half_w + b_w / 2

    def row(*cols):
        return torch.stack([c if torch.is_tensor(c)
                            else torch.full((R,), c, dtype=F32, device=dev)
                            for c in cols], -1)

    walls = torch.stack([
        torch.where(multi[:, None],
                    row(half_w + b_w, cy, zb, wt, wall_h, b_d),
                    row(half_w, cy, 0.0, wt, wall_h, depth)),
        row(-half_w, cy, 0.0, wt, wall_h, depth),
        row(0.0, cy, half_d, width, wall_h, wt),
        row(0.0, cy, -half_d, width, wall_h, wt),
        row(bx_c, cy, zb + b_d / 2, b_w, wall_h, wt),
        row(bx_c, cy, zb - b_d / 2, b_w, wall_h, wt),
        row(half_w, cy, (door_lo - half_d) / 2, wt, wall_h, seg1_len),
        row(half_w, cy, (door_hi + half_d) / 2, wt, wall_h, seg2_len),
    ], 1)
    slot = torch.arange(N_WALL_SLOTS, device=dev)
    wall_valid = (slot < 4) | (multi[:, None] & (slot < 6))
    wall_valid[:, 6] = multi & (seg1_len > 0.05)
    wall_valid[:, 7] = multi & (seg2_len > 0.05)

    # furniture candidates, then sequential rejection keeping a corridor
    # wider than the walker between kept boxes, walls and the spawn point
    A = max_furniture * 3
    n_f = prng.randint(kn, (), 2, max_furniture + 1)
    fkeys = prng.split(kf, A)                              # [R, A, 2]
    kc, ks, kl, kr2 = prng.split(fkeys, 4).unbind(-2)
    cls = prng.choice(kl, torch.tensor([_LOW, _MID, _HIGH, _BLOCK]),
                      CLASS_P)
    kh1, kh2, kh3 = prng.split(ks, 3).unbind(-2)
    h_low = prng.uniform(kh1, (), 0.25, 0.65)
    h_mid = prng.uniform(prng.fold_in(kh1, 1), (), 0.65, 1.2)
    h_high = prng.uniform(prng.fold_in(kh1, 2), (), 1.5, 2.3)
    blk_tall = prng.uniform(kh2) > 0.25
    h_blk = torch.where(
        blk_tall,
        wall_h[:, None] * prng.uniform(prng.fold_in(kh1, 3), (), 0.78, 1.0),
        prng.uniform(prng.fold_in(kh1, 4), (), 0.9, 1.4))
    h = torch.where(cls == _LOW, h_low,
                    torch.where(cls == _MID, h_mid,
                                torch.where(cls == _HIGH, h_high, h_blk)))
    kf1, kf2, kf3 = prng.split(prng.fold_in(ks, 1), 3).unbind(-2)
    # footprint: (major, minor) per class before the swap
    fa = torch.where(
        cls == _LOW, _log_uniform(kf1, 0.2, 1.6),
        torch.where(cls == _MID, prng.uniform(kf1, (), 0.6, 1.35),
                    torch.where(cls == _HIGH,
                                prng.uniform(kf1, (), 0.5, 1.3),
                                _log_uniform(kf1, 0.7, 2.8))))
    fb = torch.where(
        cls == _LOW, _log_uniform(kf2, 0.2, 1.6),
        torch.where(cls == _MID, prng.uniform(kf2, (), 0.35, 0.85),
                    torch.where(cls == _HIGH,
                                prng.uniform(kf2, (), 0.5, 1.3),
                                prng.uniform(kf2, (), 0.6, 1.2))))
    swap = prng.uniform(kf3) < 0.5
    fx, fz = torch.where(swap, fb, fa), torch.where(swap, fa, fb)
    elev = torch.where((cls == _LOW) & (prng.uniform(kh3) < 0.15),
                       prng.uniform(prng.fold_in(kh3, 1), (), 0.5, 1.2),
                       torch.zeros((), dtype=F32, device=dev))

    c = lambda v: v[:, None]                               # noqa: E731
    share_b = torch.where(multi,
                          (b_w * b_d) / fma(width, depth, b_w * b_d),
                          torch.zeros((), dtype=F32, device=dev))
    in_b = prng.uniform(kr2) < c(share_b)
    a_mx = c(half_w) - fx / 2 - wt - CORRIDOR
    a_mz = c(half_d) - fz / 2 - wt - CORRIDOR
    b_mx = c(b_w / 2) - fx / 2 - wt - CORRIDOR
    b_mz = c(b_d / 2) - fz / 2 - wt - CORRIDOR
    u = prng.uniform(kc, (), -1.0, 1.0)
    v = prng.uniform(prng.fold_in(kc, 1), (), -1.0, 1.0)
    px = torch.where(in_b, fma(u, b_mx.clamp_min(0.0), c(bx_c)),
                     u * a_mx.clamp_min(0.0))
    pz = torch.where(in_b, fma(v, b_mz.clamp_min(0.0), c(zb)),
                     v * a_mz.clamp_min(0.0))
    fits = torch.where(in_b, (b_mx > 0.0) & (b_mz > 0.0),
                       (a_mx > 0.0) & (a_mz > 0.0))
    # wall-adjacent snap: the outer face lands ``gap`` off a wall's inner
    # plane (main room only; the doorway wall stays clear)
    ksnap = prng.fold_in(kc, 2)
    snap = (prng.uniform(ksnap) < wall_adjacent_prob) & ~in_b
    side = prng.randint(prng.fold_in(ksnap, 1), (), 0, 4)
    side = torch.where(c(multi) & (side == 0), torch.ones_like(side), side)
    gap = prng.uniform(prng.fold_in(ksnap, 2), (), 0.02, 0.2)
    sx_c = c(half_w) - wt / 2 - gap - fx / 2
    sz_c = c(half_d) - wt / 2 - gap - fz / 2
    cax = c(half_w) - fx / 2 - wt - 0.05
    caz = c(half_d) - fz / 2 - wt - 0.05
    px_s = torch.where(side == 0, sx_c,
                       torch.where(side == 1, -sx_c, u * cax.clamp_min(0.0)))
    pz_s = torch.where(side == 2, sz_c,
                       torch.where(side == 3, -sz_c, v * caz.clamp_min(0.0)))
    fits_s = torch.where(
        side < 2,
        (c(width) - 2 * wt - fx - gap > CORRIDOR + 0.2) & (caz > 0.0),
        (c(depth) - 2 * wt - fz - gap > CORRIDOR + 0.2) & (cax > 0.0))
    px, pz = torch.where(snap, px_s, px), torch.where(snap, pz_s, pz)
    fits = torch.where(snap, fits_s, fits)
    covers_spawn = (px.abs() < fx / 2 + AGENT_RADIUS + 0.1) & (
        pz.abs() < fz / 2 + AGENT_RADIUS + 0.1)
    f_ok = fits & ~covers_spawn
    fboxes = torch.stack([px, h / 2 + FLOOR_Y + elev, pz, fx, h, fz], -1)

    kept = torch.zeros((R, A), dtype=torch.bool, device=dev)
    earlier = torch.arange(A, device=dev)
    for j in range(A):
        b = fboxes[:, j:j + 1]
        sep_x = (b[..., 0] - fboxes[..., 0]).abs() - (b[..., 3]
                                                      + fboxes[..., 3]) / 2
        sep_z = (b[..., 2] - fboxes[..., 2]).abs() - (b[..., 5]
                                                      + fboxes[..., 5]) / 2
        overlaps = (sep_x < CORRIDOR) & (sep_z < CORRIDOR) & kept & (
            earlier < j)
        kept[:, j] = f_ok[:, j] & ~overlaps.any(-1) & (kept.sum(-1) < n_f)

    # compact the kept candidates into the furniture slots
    order = torch.argsort((~kept).to(torch.int8), dim=-1,
                          stable=True)[:, :max_furniture]
    fvalid = kept.gather(1, order)
    boxes = torch.zeros((R, M, 6), dtype=F32, device=dev)
    labels = torch.full((R, M), -1, dtype=torch.int64, device=dev)
    valid = torch.zeros((R, M), dtype=torch.bool, device=dev)
    # slots past M drop out, as the reference's clamped slice updates do
    nw = min(M, N_WALL_SLOTS)
    s0, nf = nw, max(min(M, N_WALL_SLOTS + max_furniture) - nw, 0)
    boxes[:, :nw] = walls[:, :nw]
    labels[:, :nw] = torch.where(wall_valid, _BLOCK, -1)[:, :nw]
    valid[:, :nw] = wall_valid[:, :nw]
    order, fvalid = order[:, :nf], fvalid[:, :nf]
    boxes[:, s0:s0 + nf] = fboxes.gather(1, order[..., None].expand(-1, -1,
                                                                    6))
    labels[:, s0:s0 + nf] = torch.where(fvalid, cls.gather(1, order), -1)
    valid[:, s0:s0 + nf] = fvalid
    labels = torch.where(valid, labels, -1)
    return (boxes.reshape(lead + (M, 6)), labels.reshape(lead + (M,)),
            valid.reshape(lead + (M,)))


def _collide(pos: torch.Tensor, boxes: torch.Tensor, blocking: torch.Tensor,
             radius: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions ``[W, 2]`` (x, z) against box footprints ``[W, M, 6]``
    expanded by ``radius`` ``[W, M]``, over the ``blocking`` boxes only:
    ``(hit [W], normal [W, 2])`` of the deepest penetration, the normal
    along its axis of least penetration (ties to the first box; sign(0)
    = 0)."""
    dx = pos[:, :1] - boxes[..., 0]
    dz = pos[:, 1:] - boxes[..., 2]
    pen_x = boxes[..., 3] / 2 + radius - dx.abs()
    pen_z = boxes[..., 5] / 2 + radius - dz.abs()
    inside = (pen_x > 0) & (pen_z > 0) & blocking
    depth = torch.where(inside, torch.minimum(pen_x, pen_z), -math.inf)
    j = depth.argmax(-1, keepdim=True)
    hit = inside.gather(1, j)[:, 0]
    use_x = pen_x.gather(1, j) < pen_z.gather(1, j)
    zero = torch.zeros_like(pen_x[:, :1])
    nx = torch.where(use_x, dx.gather(1, j).sign(), zero)
    nz = torch.where(use_x, zero, dz.gather(1, j).sign())
    return hit, torch.cat([nx, nz], -1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0]))


class Room(NamedTuple):
    """What a walk needs of its room: boxes, the boxes that block the walk
    (valid, bottom below knee height), the clearance per box and, for the
    human walker, the waypoints' bounds ``[W, 4]`` (x_lo, x_hi, z_lo,
    z_hi)."""
    boxes: torch.Tensor
    blocking: torch.Tensor
    radius: torch.Tensor
    bounds: torch.Tensor | None


def _pace(k: torch.Tensor) -> torch.Tensor:
    """The human's log-uniform commanded pace (m/s)."""
    return _in_f64(torch.exp, prng.uniform(k, (), math.log(0.145),
                                        math.log(1.0)))


def _waypoint(k: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """A waypoint ``[..., 2]`` uniform in the walls' bounds, 60% of them
    snapped to a side (perimeter bias). ``bounds`` broadcasts against
    ``k``'s leading shape with a last axis of 4."""
    ku, kb, ks_ = prng.split(k, 3).unbind(-2)
    u = prng.uniform(ku, (2,))
    x_lo, x_hi, z_lo, z_hi = bounds.unbind(-1)
    pt = torch.stack([fma(u[..., 0], x_hi - x_lo, x_lo),
                      fma(u[..., 1], z_hi - z_lo, z_lo)], -1)
    side = prng.randint(kb, (), 0, 4)
    snapped = torch.stack([
        torch.where(side == 0, x_hi,
                    torch.where(side == 1, x_lo, pt[..., 0])),
        torch.where(side == 2, z_hi,
                    torch.where(side == 3, z_lo, pt[..., 1]))], -1)
    return torch.where((prng.uniform(ks_) < 0.6)[..., None], snapped, pt)


def agent_draws(skeys: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The agent's draws of step keys ``[..., 2]``: a new heading and a
    new turn interval (used when a turn is due)."""
    kt, ka, _ = prng.split(skeys, 3).unbind(-2)
    return {"ang": prng.uniform(ka, (), 0.0, 2 * math.pi),
            "turn": TURN_INTERVAL * prng.uniform(kt, (), 0.6, 1.4)}


def human_draws(skeys: torch.Tensor, bounds: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """The human's draws of step keys ``[W, C, 2]``: the renewed
    waypoint, its pace, the leg's time factor and the waypoint taken when
    blocked. ``bounds`` is ``[W, 4]``."""
    kt, ka, ks = prng.split(skeys, 3).unbind(-2)
    b = bounds[:, None]
    return {"wp": _waypoint(ka, b), "pace": _pace(ks),
            "leg": prng.uniform(kt, (), 0.8, 1.2),
            "wp_hit": _waypoint(prng.fold_in(ka, 1), b)}


def agent_step(state, draw, room: Room, dt: float):
    """One tick of the heading walk: ``state`` (pos [W, 2], heading [W],
    until_turn [W], speed [W]) -> (new state, hit [W])."""
    pos, ang, until_turn, speed = state
    turn = until_turn <= 0.0
    ang = torch.where(turn, draw["ang"], ang)
    until_turn = torch.where(turn, draw["turn"], until_turn)
    d = torch.stack([_in_f64(torch.cos, ang), _in_f64(torch.sin, ang)], -1)
    sdt = (speed * dt)[:, None]
    cand = fma(sdt, d, pos)
    hit, n = _collide(cand, room.boxes, room.blocking, room.radius)
    dn = fma(d[:, 0], n[:, 0], d[:, 1] * n[:, 1])
    refl = d - (2.0 * dn)[:, None] * n
    ang = torch.where(hit, _in_f64(torch.atan2, refl[:, 1], refl[:, 0]), ang)
    # on a hit hold position, or step out along the normal when the
    # current position is itself inside a box
    stuck, n0 = _collide(pos, room.boxes, room.blocking, room.radius)
    escape = fma(sdt, n0, pos)
    pos = torch.where(hit[:, None],
                      torch.where(stuck[:, None], escape, pos), cand)
    return (pos, ang, until_turn - dt, speed), hit


def human_step(state, draw, room: Room, dt: float):
    """One tick of the waypoint walk: ``state`` (pos [W, 2], waypoint
    [W, 2], until_turn [W], speed [W]) -> (new state, hit [W])."""
    pos, wp, until_turn, speed = state
    renew = (until_turn <= 0.0) | (_norm(wp - pos) < 0.25)
    wp = torch.where(renew[:, None], draw["wp"], wp)
    speed = torch.where(renew, draw["pace"], speed)
    leg_t = (1.5 * _norm(wp - pos) / speed).clamp(2.0, 40.0) * draw["leg"]
    until_turn = torch.where(renew, leg_t, until_turn)
    to_wp = wp - pos
    d = to_wp / _norm(to_wp).clamp_min(1e-6)[:, None]
    sdt = (speed * dt)[:, None]
    cand = fma(sdt, d, pos)
    hit, _ = _collide(cand, room.boxes, room.blocking, room.radius)
    # blocked: hold position this tick and aim somewhere new
    wp = torch.where(hit[:, None], draw["wp_hit"], wp)
    stuck, n0 = _collide(pos, room.boxes, room.blocking, room.radius)
    escape = fma(sdt, n0, pos)
    pos = torch.where(hit[:, None],
                      torch.where(stuck[:, None], escape, pos), cand)
    return (pos, wp, until_turn - dt, speed), hit


def walk_setup(keys: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
               human: bool):
    """Per-walk set-up of ``simulate_trace`` (keys ``[W, 2]``): the room,
    the initial state, the scan's key and the key of the vertical wander
    and its base height."""
    W, M = boxes.shape[:2]
    dev = keys.device
    k0, _, ky, kr, kscan = prng.split(keys, 5).unbind(-2)
    ang0 = prng.uniform(k0, (), 0.0, 2 * math.pi)
    pos0 = torch.zeros((W, 2), dtype=F32, device=dev)
    blocking = valid & (boxes[..., 1] - boxes[..., 4] / 2 < FLOOR_Y + 0.4)
    if human:
        y_base = prng.uniform(ky, (), 0.45, 0.9)
        wall_r = prng.uniform(kr, (N_WALL_SLOTS,), 0.0, 0.35)
        furn_r = prng.uniform(prng.fold_in(kr, 2), (), 0.25, 0.4)
        radius = torch.cat([wall_r, furn_r[:, None].expand(
            W, M - N_WALL_SLOTS)], -1)
        speed0 = _pace(prng.fold_in(kr, 1))
        wv = valid[:, :N_WALL_SLOTS]
        wx, wz = boxes[:, :N_WALL_SLOTS, 0], boxes[:, :N_WALL_SLOTS, 2]
        inf = torch.tensor(math.inf, dtype=F32, device=dev)
        bounds = torch.stack([
            torch.where(wv, wx, inf).amin(-1) + 0.3,
            torch.where(wv, wx, -inf).amax(-1) - 0.3,
            torch.where(wv, wz, inf).amin(-1) + 0.3,
            torch.where(wv, wz, -inf).amax(-1) - 0.3], -1)
        state0 = (pos0, pos0, torch.zeros((W,), dtype=F32, device=dev),
                  speed0)
    else:
        y_base = torch.full((W,), AGENT_Y, dtype=F32, device=dev)
        radius = torch.full((W, M), AGENT_RADIUS, dtype=F32, device=dev)
        bounds = None
        state0 = (pos0, ang0, torch.zeros((W,), dtype=F32, device=dev),
                  torch.full((W,), WALK_SPEED, dtype=F32, device=dev))
    return Room(boxes, blocking, radius, bounds), state0, kscan, ky, y_base


def simulate_trace(key: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, num_steps: int = 3000,
                   hz: float = 30.0, human: bool = False) -> torch.Tensor:
    """Random walks through rooms with reflection off box colliders: keys
    ``[..., 2]``, boxes ``[..., M, 6]``, valid ``[..., M]`` -> raw traces
    ``[..., num_steps, 4]`` of (x, y, z, t), time-sorted. The reference's
    ``simulate_trace``."""
    keys, lead = _flat_keys(key)
    W, M = keys.shape[0], boxes.shape[-2]
    boxes = boxes.reshape(W, M, 6)
    valid = valid.reshape(W, M)
    dev = keys.device
    dt = 1.0 / hz
    room, state, kscan, ky, y_base = walk_setup(keys, boxes, valid, human)
    step = human_step if human else agent_step
    path = torch.empty((W, num_steps, 2), dtype=F32, device=dev)
    for c0 in range(0, num_steps, STEP_CHUNK):
        c1 = min(c0 + STEP_CHUNK, num_steps)
        idx = torch.arange(c0, c1, device=dev)
        skeys = prng.fold_in(kscan[:, None], idx)          # split(kscan, S)
        draws = (human_draws(skeys, room.bounds) if human
                 else agent_draws(skeys))
        for i in range(c1 - c0):
            state, _ = step(state, {k: v[:, i] for k, v in draws.items()},
                            room, dt)
            path[:, c0 + i] = state[0]
    t = torch.arange(num_steps, dtype=F32, device=dev) * dt
    if human:
        kw1, kw2 = prng.split(prng.fold_in(ky, 1)).unbind(-2)
        amp = prng.uniform(kw1, (), 0.1, 0.3)[:, None]
        ph = prng.uniform(kw2, (2,), 0.0, 2 * math.pi)
        sin = lambda f, p: _in_f64(torch.sin, fma(t, f, p))   # noqa: E731
        wander = fma(0.03, _in_f64(torch.sin, t * 1.7),
                     fma(amp, sin(0.23, ph[:, :1]),
                         (0.5 * amp) * sin(0.61, ph[:, 1:])))
        y = y_base[:, None] + wander
    else:
        y = y_base[:, None].expand(W, num_steps)
    raw = torch.stack([path[..., 0], y, path[..., 1],
                       t.expand(W, -1)], -1)
    return raw.reshape(lead + raw.shape[1:])


def box_evidence_mask(raw: torch.Tensor, boxes: torch.Tensor,
                      labels: torch.Tensor, valid: torch.Tensor,
                      wall_margin: float = 0.8,
                      furniture_margin: float = 0.5) -> torch.Tensor:
    """True for the boxes a trace carries evidence for: some point comes
    within a per-class margin of the box's XZ footprint (walls get the
    wider one). ``raw`` ``[..., T, 4]``, boxes ``[..., M, 6]`` ->
    ``[..., M]``."""
    px, pz = raw[..., None, :, 0], raw[..., None, :, 2]
    ax = ((px - boxes[..., :, None, 0]).abs()
          - boxes[..., :, None, 3] / 2).clamp_min(0.0)
    az = ((pz - boxes[..., :, None, 2]).abs()
          - boxes[..., :, None, 5] / 2).clamp_min(0.0)
    # sqrt is monotone and correctly rounded: the min of the roots is the
    # root of the min
    d2 = fma(ax, ax, az * az) + 1e-12
    d = torch.sqrt(d2.amin(-1))
    margin = torch.where(labels == 0, wall_margin, furniture_margin)
    return valid & (d < margin)


def generate_rooms_and_traces(
        key: torch.Tensor, n_rooms: int, num_steps: int = 3000,
        max_colliders: int = 50, hz: float = 30.0, human: bool = False,
        multi_room_prob: float = 0.0, sim_steps: int | None = None,
        wall_adjacent_prob: float = 0.0,
        span_range: Tuple[float, float] | None = None,
        captures_per_room: int = 1, evidence_mask: bool = False,
        device: str | torch.device = "cuda") -> Dict[str, torch.Tensor]:
    """``n_rooms`` samples on ``device``: a dict of raw ``[n, T, 4]``,
    length ``[n]``, boxes ``[n, M, 6]``, labels ``[n, M]``, valid
    ``[n, M]``, as the reference's ``generate_rooms_and_traces``.

    ``sim_steps``: the walk runs that many ticks at ``hz`` and emits
    ``num_steps`` of them by the loader's linspace index.
    ``captures_per_room`` K > 1: K independent walks of each of
    ``n_rooms // K`` layouts (K = 1 keeps the single-key walker stream).
    ``evidence_mask``: drop GT boxes the walk carries no evidence for."""
    dev = resolve_device(device)
    key = key.to(dev)
    kr = prng.split(key)[0]
    S = num_steps if sim_steps is None else max(int(sim_steps), num_steps)
    if span_range is None:
        span_range = HUMAN_SPAN if human else AGENT_SPAN
    K = max(int(captures_per_room), 1)
    n_layouts = max(n_rooms // K, 1)
    k1, k2 = prng.split(prng.split(kr, n_layouts)).unbind(-2)
    boxes, labels, valid = sample_room(
        k1, max_colliders, multi_room_prob=multi_room_prob,
        wall_adjacent_prob=wall_adjacent_prob, span_range=span_range)
    wkeys = k2[:, None] if K == 1 else prng.split(k2, K)   # [R, K, 2]
    n_out = n_layouts * K
    wkeys = wkeys.reshape(n_out, 2)
    boxes = boxes.repeat_interleave(K, 0)
    labels = labels.repeat_interleave(K, 0)
    valid = valid.repeat_interleave(K, 0)
    raw = simulate_trace(wkeys, boxes, valid, S, hz, human)
    if S != num_steps:      # the loader's linspace indexing
        raw = raw[:, torch.from_numpy(np.linspace(
            0, S - 1, num_steps).astype(np.int64)).to(dev)]
    if evidence_mask:
        valid = box_evidence_mask(raw, boxes, labels, valid)
    return {"raw": raw,
            "length": torch.full((n_out,), num_steps, dtype=torch.int32,
                                 device=dev),
            "boxes": boxes, "labels": labels.to(torch.int32),
            "valid": valid}


def to_numpy(data: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A generated dict on the host."""
    return {k: v.cpu().numpy() for k, v in data.items()}


def write_synthetic_dataset(out_dir: str | Path, n_rooms: int,
                            num_steps: int = 3000, seed: int = 0,
                            max_colliders: int = 50, human: bool = False,
                            multi_room_prob: float = 0.0, hz: float = 30.0,
                            stem_prefix: str = "synthetic",
                            sim_steps: int | None = None,
                            wall_adjacent_prob: float = 0.0,
                            span_range: Tuple[float, float] | None = None,
                            device: str | torch.device = "cuda") -> None:
    """Generate rooms on ``device`` and write ``<stem>_trace.json`` /
    ``<stem>_collider.json`` pairs (the valid boxes only)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data = to_numpy(generate_rooms_and_traces(
        prng.key(seed), n_rooms, num_steps, max_colliders=max_colliders,
        hz=hz, human=human, multi_room_prob=multi_room_prob,
        sim_steps=sim_steps, wall_adjacent_prob=wall_adjacent_prob,
        span_range=span_range, device=device))
    for i in range(n_rooms):
        stem = f"{stem_prefix}_{i:04d}"
        formats.save_trace_json(out_dir / f"{stem}_trace.json",
                                data["raw"][i])
        v = data["valid"][i]
        formats.save_colliders_json(out_dir / f"{stem}_collider.json",
                                    data["boxes"][i][v],
                                    data["labels"][i][v])
    print(f"Wrote {n_rooms} synthetic trace/collider pairs to {out_dir}")
