"""The port's synthetic generator (``room_slam_torch/data/synthetic.py``)
and what it unlocks, against the JAX package on the CPU.

- ``_collide`` and ``box_evidence_mask`` on numpy-seeded boxes: hit,
  normal and mask equal (a mask only where the distance is not within
  1e-6 of its margin);
- ``sample_room``: labels and valid equal, boxes within 1e-5;
- one walker step of each mode, teacher-forced from JAX's recorded scan
  state at every tick of a walk: the next state within 1e-5;
- ``generate_rooms_and_traces`` and ``make_synthetic_datasets`` (mixed,
  ``captures_per_room`` 2, ``evidence_mask``, the sim factors) at 8 rooms
  x 256 steps: rooms as above, traces within 1e-4. A walk beyond that
  must show that its first departure follows a ``hit`` decision that the
  port took otherwise than JAX, with every step of that walk held to 1e-5
  by teacher forcing;
- the 14 checks of ``tests/test_synthetic.py`` run against the port, as
  cases of one test, at those tests' sizes;
- ``TraceColliderArrays.concat``, the training CLI's recipe
  (``--synthetic --synthetic_mode mixed --mix_real --mix_copies``),
  ``create_sample_data``, the demo and the precision manager of the train
  step.
"""

import ast
import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch import demo
from room_slam_torch.config import DataConfig as TDataConfig
from room_slam_torch.config import ExperimentConfig as TConfig
from room_slam_torch.data import formats as tformats
from room_slam_torch.data import legacy as tlegacy
from room_slam_torch.data import prng
from room_slam_torch.data import synthetic as ts
from room_slam_torch.data.dataset import TraceColliderArrays as TArrays
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch.train import driver as tdriver
from room_slam_torch.train import loop as tloop
from room_slam_torch.train.__main__ import main as train_cli
from room_slam_tpu.config import DataConfig, ExperimentConfig
from room_slam_tpu.data import legacy as jlegacy
from room_slam_tpu.data import synthetic as js
from room_slam_tpu.data.dataset import TraceColliderArrays as JArrays
from room_slam_tpu.train import driver as jdriver

REPO = Path(__file__).resolve().parents[1]
BOX_TOL = 1e-5
TRACE_TOL = 1e-4
STEP_TOL = 1e-5


def _tk(keys) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(jax.random.key_data(keys)).astype(np.int64))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- _collide


def _random_boxes(rng, n, M):
    size = rng.uniform(0.2, 2.0, (n, M, 3))
    elev = np.where(rng.uniform(size=(n, M)) < 0.2, 1.0, 0.0)
    boxes = np.concatenate([
        rng.uniform(-3, 3, (n, M, 1)),
        (size[..., 1] / 2 + js.FLOOR_Y + elev)[..., None],
        rng.uniform(-3, 3, (n, M, 1)), size], -1).astype(np.float32)
    return boxes, rng.uniform(size=(n, M)) < 0.8


def test_collide_matches_jax():
    rng = np.random.default_rng(0)
    n, M = 256, 12
    boxes, valid = _random_boxes(rng, n, M)
    boxes[:8, 1] = boxes[:8, 0]                      # ties: the first wins
    valid[:8, :2] = True
    pos = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    pos[8:16] = boxes[8:16, 0, [0, 2]]               # dx = dz = 0: sign 0
    radius = rng.uniform(0.0, 0.5, (n, M)).astype(np.float32)
    hit, normal = jax.vmap(js._collide)(pos, boxes, valid, radius)
    t_boxes = _t(boxes)
    blocking = _t(valid) & (t_boxes[..., 1] - t_boxes[..., 4] / 2
                            < ts.FLOOR_Y + 0.4)
    got_hit, got_n = ts._collide(_t(pos), t_boxes, blocking, _t(radius))
    np.testing.assert_array_equal(got_hit.numpy(), np.asarray(hit))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(normal))
    assert 20 < int(np.asarray(hit).sum()) < n


def test_box_evidence_mask_matches_jax():
    rng = np.random.default_rng(1)
    n, M, T = 16, 20, 200
    boxes, valid = _random_boxes(rng, n, M)
    labels = rng.integers(0, 4, (n, M))
    raw = np.cumsum(rng.normal(scale=0.1, size=(n, T, 4)), 1).astype(
        np.float32)
    ref = np.asarray(jax.vmap(js.box_evidence_mask)(raw, boxes, labels,
                                                    valid))
    got = ts.box_evidence_mask(_t(raw), _t(boxes), _t(labels),
                               _t(valid)).numpy()
    # the distance of each box to its nearest point, in float64
    ax = np.maximum(np.abs(raw[:, None, :, 0] - boxes[..., None, 0])
                    - boxes[..., None, 3] / 2, 0)
    az = np.maximum(np.abs(raw[:, None, :, 2] - boxes[..., None, 2])
                    - boxes[..., None, 5] / 2, 0)
    d = np.sqrt((ax.astype(np.float64) ** 2 + az ** 2).min(-1))
    margin = np.where(labels == 0, 0.8, 0.5)
    decided = np.abs(d - margin) > 1e-6
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(got[decided], ref[decided])
    assert 0.1 < ref.mean() < 0.9


# ------------------------------------------------------------ sample_room

ROOM_CASES = {"default": dict(),
              "mixed": dict(multi_room_prob=0.5, wall_adjacent_prob=0.5),
              "annex_human": dict(multi_room_prob=1.0,
                                  wall_adjacent_prob=1.0,
                                  span_range=(3.0, 5.5)),
              "narrow": dict(max_colliders=16, multi_room_prob=0.3)}


@pytest.mark.parametrize("case", list(ROOM_CASES))
def test_sample_room_matches_jax(case):
    kw = ROOM_CASES[case]
    keys = jax.random.split(jax.random.key(3), 32)
    ref = jax.jit(jax.vmap(lambda k: js.sample_room(k, **kw)))(keys)
    got = ts.sample_room(_tk(keys), **kw)
    rb, rl, rv = map(np.asarray, ref)
    np.testing.assert_array_equal(got[1].numpy(), rl)
    np.testing.assert_array_equal(got[2].numpy(), rv)
    np.testing.assert_allclose(got[0].numpy(), rb, rtol=0, atol=BOX_TOL)
    assert rv.sum() >= 32 * 6


# ------------------------------------------------------------ the walkers


def _jax_walk(key, boxes, valid, S, hz, human):
    """The JAX walk run eagerly with its ``lax.scan`` recorded: the raw
    trace, the state before every tick and the tick keys."""
    rec = {}
    scan = jax.lax.scan

    def recording(f, init, xs):
        def g(c, x):
            c2, y = f(c, x)
            return c2, (y, c)
        final, (ys, carries) = scan(g, init, xs)
        rec["carries"] = [np.asarray(c) for c in carries]
        rec["final"] = [np.asarray(c) for c in final]
        rec["keys"] = np.asarray(jax.random.key_data(xs)).astype(np.int64)
        return final, ys

    with mock.patch.object(jax.lax, "scan", recording):
        raw = np.asarray(js.simulate_trace(key, boxes, valid, S, hz, human))
    states = [np.concatenate([c, f[None]]) for c, f in
              zip(rec["carries"], rec["final"])]
    return raw, states, rec["keys"]


def _teacher_forced(key, boxes, valid, states, skeys, hz, human):
    """The port's step from each of JAX's states ``[S + 1, ...]`` with
    JAX's tick keys: the next states and each step's hit."""
    S = skeys.shape[0]
    room, _, _, _, _ = ts.walk_setup(
        _tk(key)[None].expand(S, 2), _t(boxes)[None].expand(S, -1, -1),
        _t(valid)[None].expand(S, -1), human)
    draws = (ts.human_draws(_t(skeys)[:, None], room.bounds) if human
             else ts.agent_draws(_t(skeys)[:, None]))
    draws = {k: v[:, 0] for k, v in draws.items()}
    step = ts.human_step if human else ts.agent_step
    state = tuple(_t(s[:-1]) for s in states)
    nxt, hit = step(state, draws, room, 1.0 / hz)
    return [n.numpy() for n in nxt], hit.numpy()


def _free_run(key, boxes, valid, S, hz, human):
    """The port's own walk: positions after every tick and each hit."""
    room, state, kscan, _, _ = ts.walk_setup(_tk(key)[None], _t(boxes)[None],
                                             _t(valid)[None], human)
    skeys = prng.split(kscan, S)
    draws = (ts.human_draws(skeys, room.bounds) if human
             else ts.agent_draws(skeys))
    step = ts.human_step if human else ts.agent_step
    pos, hits = [], []
    for i in range(S):
        state, hit = step(state, {k: v[:, i] for k, v in draws.items()},
                          room, 1.0 / hz)
        pos.append(state[0][0].numpy())
        hits.append(bool(hit[0]))
    return np.stack(pos), np.asarray(hits)


def _hold_by_teacher_forcing(key, boxes, valid, S, hz, human):
    """Every step of the walk from JAX's state within STEP_TOL; returns
    JAX's raw trace and the teacher-forced hits."""
    raw, states, skeys = _jax_walk(key, boxes, valid, S, hz, human)
    nxt, hit = _teacher_forced(key, boxes, valid, states, skeys, hz, human)
    for n, s in zip(nxt, states):
        np.testing.assert_allclose(n, s[1:], rtol=0, atol=STEP_TOL)
    return raw, hit


@pytest.mark.parametrize("human", [False, True], ids=["agent", "human"])
def test_walker_step_teacher_forced_matches_jax(human):
    hz = 37.0 if human else 30.0
    span = js.HUMAN_SPAN if human else (3.5, 9.0)
    boxes, _, valid = jax.jit(lambda k: js.sample_room(
        k, multi_room_prob=0.5, wall_adjacent_prob=0.5,
        span_range=span))(jax.random.key(3))
    boxes, valid = np.asarray(boxes), np.asarray(valid)
    raw, hit = _hold_by_teacher_forcing(jax.random.key(4), boxes, valid, 400,
                                        hz, human)
    assert hit.sum() > 0                      # reflections were exercised
    # the whole walk too: same positions and heights, exact times
    got = ts.simulate_trace(_tk(jax.random.key(4)), _t(boxes), _t(valid),
                            400, hz, human).numpy()
    np.testing.assert_allclose(got, raw, rtol=0, atol=TRACE_TOL)
    np.testing.assert_array_equal(got[:, 3], raw[:, 3])


def _walk_keys(key, n_rooms, K):
    """The walk key of every sample of ``generate_rooms_and_traces``."""
    kr, _ = jax.random.split(key)
    keys = []
    for k in jax.random.split(kr, max(n_rooms // K, 1)):
        k2 = jax.random.split(k)[1]
        keys += [k2] if K == 1 else list(jax.random.split(k2, K))
    return keys


def _check_traces(got, ref, walks):
    """Traces within TRACE_TOL; a walk beyond it is shown to part at a
    ``hit`` decision and held by teacher forcing. ``walks(i)`` gives
    sample i's (key, boxes, valid, S, hz, human, keep)."""
    for i in range(ref.shape[0]):
        if np.abs(got[i] - ref[i]).max() <= TRACE_TOL:
            continue
        key, boxes, valid, S, hz, human, keep = walks(i)
        raw, tf_hit = _hold_by_teacher_forcing(key, boxes, valid, S, hz,
                                               human)
        pos, hits = _free_run(key, boxes, valid, S, hz, human)
        far = np.abs(pos - raw[:, [0, 2]]).max(1) > TRACE_TOL
        first = int(np.argmax(far))
        assert far.any() and (hits[:first + 1] != tf_hit[:first + 1]).any(), (
            f"sample {i}: parts at tick {first} without a flipped hit")
        flip = int(np.argmax(hits != tf_hit))
        assert np.abs(pos[:flip] - raw[:flip, [0, 2]]).max() <= TRACE_TOL


def _generate(kw, device=None):
    if device is None:
        return jax.device_get(js.generate_rooms_and_traces(**kw))
    kw = dict(kw, key=_tk(kw["key"]), device=device)
    return ts.to_numpy(ts.generate_rooms_and_traces(**kw))


def _check_rooms(got, ref):
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_array_equal(got["length"], ref["length"])


GEN_KW = dict(key=jax.random.key(3), n_rooms=8, num_steps=256,
              max_colliders=50, hz=30.0, multi_room_prob=0.5,
              wall_adjacent_prob=0.5)
DS_KW = dict(n_rooms=8, seed=3, mode="mixed", multi_room_prob=0.5,
             wall_adjacent_prob=0.5, captures_per_room=2, evidence_mask=True)


def _cfgs(L=256, M=50):
    jc, tc = ExperimentConfig(), TConfig()
    for c in (jc, tc):
        c.data.max_trace_len, c.data.max_colliders = L, M
    return jc, tc


@pytest.fixture(scope="module")
def jax_datasets():
    """One JAX generation per static shape, shared by the tests."""
    jc, _ = _cfgs()
    return {"generate": _generate(GEN_KW),
            "dataset": jdriver.make_synthetic_datasets(jc, **DS_KW)}


def test_generate_rooms_and_traces_matches_jax(jax_datasets):
    ref = jax_datasets["generate"]
    got = _generate(GEN_KW, device="cpu")
    _check_rooms(got, ref)
    keys = _walk_keys(GEN_KW["key"], 8, 1)
    _check_traces(got["raw"], ref["raw"], lambda i: (
        keys[i], ref["boxes"][i], ref["valid"][i], 256, 30.0, False, None))
    assert got["raw"].shape == (8, 256, 4)


def test_make_synthetic_datasets_matches_jax(jax_datasets):
    """Mixed, two captures a room, the evidence mask, the sim factors
    (agent 1024 ticks at 30 Hz, human 614 at 37 Hz, each downsampled to
    256); val 4 rooms of seed + 10 000."""
    jtr, jva = jax_datasets["dataset"]
    _, tc = _cfgs()
    ttr, tva = tdriver.make_synthetic_datasets(tc, device="cpu", **DS_KW)
    for got, ref, seed, K, emask in ((ttr, jtr, 3, 2, True),
                                     (tva, jva, 10_003, 1, False)):
        _check_rooms(vars(got), vars(ref))
        assert got.names == ref.names
        assert got.rotation_angles == ref.rotation_angles
        n = ref.n_base
        k1, k2 = jax.random.split(jax.random.key(seed))
        halves = ((k1, n // 2, False), (k2, n - n // 2, True))
        walk = []
        for key, m, human in halves:
            hz = 37.0 if human else 30.0
            S = int(round(256 * (2.4 if human else 4.0)))
            walk += [(k, S, hz, human) for k in _walk_keys(key, m, K)]
        # the evidence mask drops boxes on the train split
        assert (got.valid.sum() < (got.labels >= 0).sum()) == emask
        _check_traces(got.raw, ref.raw, lambda i: (
            walk[i][0], ref.boxes[i], (ref.labels[i] >= 0), walk[i][1],
            walk[i][2], walk[i][3], None))


# ------------------------------------- tests/test_synthetic.py on the port


def _key(seed):
    return prng.key(seed)


def _np(*xs):
    return [x.numpy() for x in xs]


def _inside_ground_furniture(raw, boxes, valid, start):
    for j in np.where(valid)[0][start:]:
        if boxes[j, 1] - boxes[j, 4] / 2 >= ts.FLOOR_Y + 0.4:
            continue
        inside = (np.abs(raw[:, 0] - boxes[j, 0]) < boxes[j, 3] / 2) & (
            np.abs(raw[:, 2] - boxes[j, 2]) < boxes[j, 5] / 2)
        assert not inside.any(), j


def inv_room_layout():
    boxes, labels, valid = _np(*ts.sample_room(_key(0)))
    assert valid[:4].all() and (labels[:4] == 0).all()
    assert (boxes[0, 5] > 3) and (boxes[2, 3] > 3)
    assert valid.sum() >= 6
    assert (labels[~valid] == -1).all()


def inv_trace_stays_in_room_and_avoids_furniture():
    boxes, labels, valid = ts.sample_room(_key(1))
    raw = ts.simulate_trace(_key(2), boxes, valid, num_steps=2000).numpy()
    boxes, valid = _np(boxes, valid)
    assert np.all(np.diff(raw[:, 3]) > 0)
    assert np.all(np.abs(raw[:, 0]) <= boxes[0, 0] + 0.05)
    assert np.all(np.abs(raw[:, 2]) <= boxes[2, 2] + 0.05)
    _inside_ground_furniture(raw, boxes, valid, 4)
    assert raw[:, 0].std() > 0.3 and raw[:, 2].std() > 0.3


def inv_multi_room_layout():
    boxes, labels, valid = _np(*ts.sample_room(_key(3),
                                               multi_room_prob=1.0))
    nw = ts.N_WALL_SLOTS
    assert valid[:nw].sum() >= 6
    assert (labels[:nw][valid[:nw]] == 0).all()
    half_w = boxes[2, 3] / 2
    assert boxes[0, 0] > half_w + 0.5
    for s in (6, 7):
        if valid[s]:
            np.testing.assert_allclose(boxes[s, 0], half_w, atol=1e-5)
    covered = boxes[6, 5] * valid[6] + boxes[7, 5] * valid[7]
    assert covered < boxes[1, 5] - 1.0


def inv_walker_crosses_doorway():
    keys = torch.stack([_key(100 + s) for s in range(6)])
    boxes, labels, valid = ts.sample_room(keys, multi_room_prob=1.0)
    raw = ts.simulate_trace(prng.fold_in(keys, 1), boxes, valid,
                            num_steps=3000).numpy()
    boxes = boxes.numpy()
    entered = sum(bool((raw[s, :, 0] > boxes[s, 2, 3] / 2 + 0.2).any())
                  for s in range(6))
    assert np.all(raw[..., 0] <= boxes[:, None, 0, 0] + 0.05)
    assert entered >= 2, entered


def inv_furniture_priors_match_real_classes():
    d = ts.to_numpy(ts.generate_rooms_and_traces(_key(7), n_rooms=32,
                                                 num_steps=8, device="cpu"))
    boxes, labels, valid = d["boxes"], d["labels"], d["valid"]
    furn = valid.copy()
    furn[:, :ts.N_WALL_SLOTS] = False
    mid, low = furn & (labels == 2), furn & (labels == 1)
    assert mid.any() and low.any()
    assert boxes[mid][:, 4].min() >= 0.6 and boxes[mid][:, 4].max() <= 1.25
    assert boxes[low][:, 3].min() < 0.45
    base = boxes[low][:, 1] - boxes[low][:, 4] / 2
    assert (np.abs(base - ts.FLOOR_Y) < 1e-4).mean() > 0.6


def inv_batched_generation_and_roundtrip(tmp_path):
    d = ts.generate_rooms_and_traces(_key(0), n_rooms=3, num_steps=500,
                                     device="cpu")
    assert d["raw"].shape == (3, 500, 4) and d["boxes"].shape == (3, 50, 6)
    ts.write_synthetic_dataset(tmp_path, n_rooms=2, num_steps=300, seed=1,
                               device="cpu")
    pairs = tformats.find_data_pairs(tmp_path)
    assert len(pairs) == 2
    assert tformats.load_trace_json(pairs[0][0]).shape == (300, 4)
    b, _ = tformats.load_colliders_json(pairs[0][1])
    assert b.shape[1] == 6 and b.shape[0] >= 5


def inv_human_walker_matches_real_capture_stats():
    boxes, labels, valid = ts.sample_room(_key(3))
    keys = torch.stack([_key(100 + s) for s in range(6)])
    raw = ts.simulate_trace(keys, boxes.expand(6, -1, -1),
                            valid.expand(6, -1), num_steps=2000, hz=37.0,
                            human=True).numpy()
    dt = np.diff(raw[..., 3], axis=1)
    sp = np.linalg.norm(np.diff(raw[..., :3], axis=1), axis=-1) / dt
    assert 0.08 <= np.median(np.median(sp, axis=1)) <= 0.9
    assert 0.05 <= np.median(raw[..., 1].std(1)) <= 0.45
    assert 0.2 <= np.median(raw[..., 1].mean(1)) <= 1.1


def inv_sim_steps_extends_duration_not_points():
    L, S, hz = 200, 480, 30.0
    kw = dict(max_colliders=16, hz=hz, human=True, device="cpu")
    short = ts.to_numpy(ts.generate_rooms_and_traces(_key(7), 2, L, **kw))
    long = ts.to_numpy(ts.generate_rooms_and_traces(_key(7), 2, L,
                                                    sim_steps=S, **kw))
    assert long["raw"].shape == short["raw"].shape == (2, L, 4)
    assert short["raw"][..., 3].max() == pytest.approx((L - 1) / hz,
                                                       rel=1e-5)
    assert long["raw"][..., 3].max() == pytest.approx((S - 1) / hz,
                                                      rel=1e-5)
    assert np.all(np.diff(long["raw"][..., 3], axis=1) > 0)

    def path_len(raw):
        return np.linalg.norm(np.diff(raw[..., [0, 2]], axis=1),
                              axis=-1).sum(axis=1)

    assert (path_len(long["raw"]) > path_len(short["raw"])).all()


def inv_dataset_concat_tiles_real_into_synthetic():
    cfg = TDataConfig(max_trace_len=64, max_colliders=8)

    def make(n, seed, L=64, c=cfg):
        return TArrays.from_arrays(ts.to_numpy(ts.generate_rooms_and_traces(
            _key(seed), n, L, max_colliders=8, device="cpu")), c)

    big, small = make(6, 0), make(2, 1)
    mixed = TArrays.concat([big, small], [1, 3])
    assert mixed.n_base == 12 and mixed.raw.shape == (12, 64, 4)
    assert mixed.num_samples == 12 * len(big.rotation_angles)
    np.testing.assert_array_equal(mixed.raw[6:8], mixed.raw[8:10])
    np.testing.assert_array_equal(mixed.raw[:6], big.raw)
    assert mixed.gather(np.arange(8))["raw"].shape == (8, 64, 4)
    other = make(2, 2, 32, TDataConfig(max_trace_len=32, max_colliders=8))
    with pytest.raises(ValueError):
        TArrays.concat([big, other])


def inv_human_walker_covers_room_span():
    d = ts.to_numpy(ts.generate_rooms_and_traces(
        _key(11), 8, 1000, max_colliders=50, hz=37.0, human=True,
        sim_steps=2400, device="cpu"))
    covs, spans = [], []
    nw = ts.N_WALL_SLOTS
    for i in range(8):
        xy = d["raw"][i][:, [0, 2]]
        ext = xy.max(0) - xy.min(0)
        wv = d["valid"][i][:nw]
        wx, wz = d["boxes"][i][:nw, 0][wv], d["boxes"][i][:nw, 2][wv]
        covs.append((ext[0] / (wx.max() - wx.min()),
                     ext[1] / (wz.max() - wz.min())))
        spans.extend([wx.max() - wx.min(), wz.max() - wz.min()])
    covs, spans = np.array(covs), np.array(spans)
    lo, hi = ts.HUMAN_SPAN
    assert (spans > lo - 0.5).all() and (spans < hi + 0.5).all(), spans
    assert covs.mean() > 0.55, covs.mean()
    assert np.quantile(covs, 0.1) > 0.3


def inv_human_walker_effective_speed_matches_real_captures():
    raw = ts.generate_rooms_and_traces(
        _key(5), 8, 1000, max_colliders=50, hz=37.0, human=True,
        sim_steps=2400, device="cpu")["raw"].numpy()
    seg = np.linalg.norm(np.diff(raw[..., [0, 2]], axis=1), axis=-1)
    eff = seg.sum(1) / (raw[:, -1, 3] - raw[:, 0, 3])
    assert 0.24 <= eff.mean() <= 0.45, eff
    assert eff.min() > 0.10 and eff.max() < 0.9, eff


def inv_wall_adjacent_furniture_mode():
    wt2 = ts.WALL_THICKNESS / 2

    def min_wall_gap(b, half_w, half_d):
        return min(half_w - wt2 - (b[0] + b[3] / 2),
                   (b[0] - b[3] / 2) - (-half_w + wt2),
                   half_d - wt2 - (b[2] + b[5] / 2),
                   (b[2] - b[5] / 2) - (-half_d + wt2))

    keys = torch.stack([_key(s) for s in range(6)])
    adj = _np(*ts.sample_room(keys, wall_adjacent_prob=1.0))
    free = _np(*ts.sample_room(keys))
    nw = ts.N_WALL_SLOTS
    for s in range(6):
        boxes, valid = adj[0][s], adj[2][s]
        half_w, half_d = boxes[0, 0], boxes[2, 2]
        furn = np.where(valid)[0]
        furn = furn[furn >= nw]
        assert len(furn) >= 2
        for j in furn:
            assert min_wall_gap(boxes[j], half_w, half_d) < 0.21, (s, j)
        for j in np.where(free[2][s])[0]:
            if j >= nw:
                assert min_wall_gap(free[0][s][j], half_w, half_d) > \
                    ts.CORRIDOR - 0.01
    boxes, labels, valid = ts.sample_room(_key(7), wall_adjacent_prob=1.0)
    raw = ts.simulate_trace(_key(8), boxes, valid, num_steps=2000).numpy()
    _inside_ground_furniture(raw, boxes.numpy(), valid.numpy(), nw)
    assert raw[:, 0].std() > 0.3 and raw[:, 2].std() > 0.3


def inv_multi_capture_rooms_share_layout():
    d = ts.to_numpy(ts.generate_rooms_and_traces(
        _key(3), 8, 128, max_colliders=16, captures_per_room=2,
        device="cpu"))
    assert d["raw"].shape == (8, 128, 4)
    for i in range(0, 8, 2):
        np.testing.assert_array_equal(d["boxes"][i], d["boxes"][i + 1])
        assert not np.allclose(d["raw"][i], d["raw"][i + 1])
    assert not np.allclose(d["boxes"][0], d["boxes"][2])


def inv_evidence_mask_drops_unvisited_boxes():
    t = np.linspace(0, 2 * np.pi, 200)
    raw = torch.from_numpy(np.stack([np.cos(t), np.full_like(t, 1.0),
                                     np.sin(t), t], -1).astype(np.float32))
    boxes = torch.tensor([[1.2, 0.5, 0.0, 0.4, 1.0, 0.4],
                          [8.0, 0.5, 8.0, 0.4, 1.0, 0.4],
                          [0.0, 1.25, 1.55, 0.15, 2.5, 3.0]])
    labels = torch.tensor([1, 1, 0])
    m = ts.box_evidence_mask(raw, boxes, labels, torch.ones(3, dtype=bool))
    assert m.tolist() == [True, False, True], m
    m2 = ts.box_evidence_mask(raw, boxes, labels,
                              torch.tensor([True, True, False]))
    assert not m2[2]


INVARIANTS = [v for k, v in sorted(globals().items())
              if k.startswith("inv_")]


@pytest.mark.parametrize("check", INVARIANTS,
                         ids=[f.__name__[4:] for f in INVARIANTS])
def test_jax_suite_invariants_hold_for_the_port(check, tmp_path):
    if "tmp_path" in check.__code__.co_varnames[:check.__code__.co_argcount]:
        check(tmp_path)
    else:
        check()


def test_invariants_cover_the_jax_suite():
    tree = ast.parse((REPO / "tests" / "test_synthetic.py").read_text())
    names = {n.name[5:] for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert len(names) == 14
    assert names == {f.__name__[4:] for f in INVARIANTS}, names


# ------------------------------------------------- concat, CLI, sample data


def test_concat_matches_jax():
    g = np.random.default_rng(2)

    def arrays(n):
        return {"raw": g.normal(size=(n, 32, 4)).astype(np.float32),
                "length": g.integers(1, 33, n).astype(np.int32),
                "boxes": g.normal(size=(n, 8, 6)).astype(np.float32),
                "labels": g.integers(-1, 4, (n, 8)).astype(np.int32),
                "valid": g.uniform(size=(n, 8)) < 0.5}

    a, b = arrays(5), arrays(2)
    jcfg, tcfg = DataConfig(max_trace_len=32, max_colliders=8), \
        TDataConfig(max_trace_len=32, max_colliders=8)
    ref = JArrays.concat([JArrays.from_arrays(a, jcfg),
                          JArrays.from_arrays(b, jcfg)], [1, 3])
    got = TArrays.concat([TArrays.from_arrays(a, tcfg),
                          TArrays.from_arrays(b, tcfg)], [1, 3])
    for name in ("raw", "length", "boxes", "labels", "valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.names == ref.names
    assert (got.n_base, got.num_samples, got.rotation_angles) == \
        (ref.n_base, ref.num_samples, ref.rotation_angles)
    with pytest.raises(ValueError, match="rotation"):
        TArrays.concat([TArrays.from_arrays(a, tcfg),
                        TArrays.from_arrays(b, tcfg, augment=False)])


def test_train_cli_synthetic_recipe(tmp_path):
    """The flagship's recipe on the CPU: generated mixed rooms with two
    tiled copies of a real-capture directory, one epoch (d_model 32 to
    keep the CPU's epoch short)."""
    real = tmp_path / "real"
    write_rooms(real, 2, 0)
    seen = {}
    make = tdriver.make_synthetic_datasets

    def spy(*a, **kw):
        seen["sets"] = make(*a, **kw)
        return seen["sets"]

    def train_spy(cfg, **kw):
        seen.update(cfg=cfg, **kw)
        return train(cfg, **kw)

    train = tdriver.train_benchmark
    import room_slam_torch.train.__main__ as cli
    save = tmp_path / "ckpt"
    with mock.patch.object(cli, "make_synthetic_datasets", spy), \
            mock.patch.object(cli, "train_benchmark", train_spy):
        train_cli(["--config", str(REPO / "configs" / "flagship_v15.json"),
                   "--synthetic", "16", "--synthetic_mode", "mixed",
                   "--mix_real", str(real), "--mix_copies", "2",
                   "--max_trace_len", "64", "--d_model", "32",
                   "--epochs", "1", "--seed", "5",
                   "--save_dir", str(save), "--device", "cpu"])
    tr, va = seen["sets"]
    assert seen["train_ds"].n_base == tr.n_base + 2 * 2 == 20
    assert seen["val_ds"] is va and va.n_base == 4
    assert seen["cfg"].train.matmul_precision == "bfloat16"
    np.testing.assert_array_equal(seen["train_ds"].raw[16:18],
                                  seen["train_ds"].raw[18:20])
    hist = [json.loads(s) for s in
            (save / "history.jsonl").read_text().splitlines()]
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    assert (save / "best_model.msgpack").exists()
    with pytest.raises(SystemExit):
        train_cli(["--epochs", "1", "--device", "cpu"])  # no data at all


def test_create_sample_data_matches_jax(tmp_path):
    """The same files as the JAX package's for the same seed: names,
    objects equal (positions and sizes within 1e-5), CSV rows within
    1e-4 (the walks' tolerance)."""
    jlegacy.create_sample_data(tmp_path / "jax", n_traces=3, seed=4,
                               num_steps=300)
    tlegacy.create_sample_data(tmp_path / "port", n_traces=3, seed=4,
                               num_steps=300, device="cpu")
    # the CLI's flag writes the same files at the default 1500 ticks
    train_cli(["--create_sample_data", "--data_dir", str(tmp_path / "cli"),
               "--num_sample_traces", "2", "--seed", "4", "--device",
               "cpu"])
    cli = sorted(p.name for p in (tmp_path / "cli").iterdir())
    assert cli == ["sample_000.csv", "sample_000_objects.json",
                   "sample_001.csv", "sample_001_objects.json"]
    assert tformats.load_trace_csv(tmp_path / "cli" / cli[0]).shape == \
        (1500, 3)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 6
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".csv"):
            ra, rb = tformats.load_trace_csv(a), tformats.load_trace_csv(b)
            assert ra.shape == rb.shape == (300, 3)
            np.testing.assert_allclose(rb, ra, rtol=0, atol=TRACE_TOL)
            continue
        oa, ob = (json.loads(p.read_text())["objects"] for p in (a, b))
        assert [o["class_name"] for o in ob] == [o["class_name"] for o in oa]
        for x, y in zip(ob, oa):
            assert x["class_id"] == y["class_id"]
            np.testing.assert_allclose(x["position"] + x["size"],
                                       y["position"] + y["size"], atol=1e-5)


def test_demo_runs_the_baseline_on_generated_rooms(tmp_path, capsys):
    out = tmp_path / "preds.json"
    demo.main(["--n_rooms", "2", "--num_steps", "600", "--output", str(out),
               "--device", "cpu"])
    res = json.loads(out.read_text())["results"]
    assert [r["room"] for r in res] == [0, 1]
    assert all(len(r["objects"]) > 0 for r in res)
    assert "Room 1:" in capsys.readouterr().out
    demo.main(["--n_rooms", "2", "--num_steps", "600", "--save_viz",
               str(tmp_path / "viz"), "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "viz").iterdir()) == \
        ["demo_room_0.png", "demo_room_1.png"]


# ------------------------------------------------------ matmul precision


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.mark.parametrize("level,tf32", sorted(
    tloop.TF32_BY_PRECISION.items()))
def test_matmul_precision_restores_backends(level, tf32):
    before = _flags()
    with tloop.matmul_precision(level, "cuda"):
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    assert _flags() == before
    with pytest.raises(RuntimeError, match="inside"):
        with tloop.matmul_precision(level, "cuda"):
            raise RuntimeError("inside")
    assert _flags() == before
    with tloop.matmul_precision(level, "cpu"):    # the CPU: nothing changes
        assert _flags() == before
    with pytest.raises(ValueError, match="matmul_precision"):
        with tloop.matmul_precision("fp8", "cuda"):
            pass


def test_train_step_runs_inside_the_precision_manager():
    """The step's forward and backward run inside ``matmul_precision`` at
    ``train.matmul_precision``; the backends are the same after it."""
    _, cfg = _cfgs(L=32, M=8)
    cfg.model.d_model, cfg.train.batch_size = 16, 2
    cfg.train.matmul_precision = "tensorfloat32"
    from room_slam_torch.models.factory import build_model
    model = build_model(cfg.model, generator=torch.Generator().manual_seed(0))
    opt = tloop.make_optimizer(model, cfg)
    entered = []
    real = tloop.matmul_precision

    def spy(level, device):
        entered.append((level, str(device)))
        return real(level, device)

    data = ts.to_numpy(ts.generate_rooms_and_traces(
        prng.key(1), 2, 32, max_colliders=8, device="cpu"))
    ds = TArrays.from_arrays(data, cfg.data, augment=False)
    batch = {k: torch.from_numpy(v) for k, v in ds.gather([0, 1]).items()}
    before = _flags()
    with mock.patch.object(tloop, "matmul_precision", spy):
        losses = tloop.make_train_step(model, opt, cfg, augment=False)(
            batch, torch.Generator().manual_seed(0))
    assert entered == [("tensorfloat32", "cpu")]
    assert _flags() == before
    assert np.isfinite(float(losses["total_loss"]))
