"""Launch planning of the recurrences, on the CPU: which kernel of
``csrc/bilstm_fwd.cu`` / ``csrc/bigru_fwd.cu`` / ``csrc/bigru_bwd.cu``
takes a shape, the unit kernels' batch tile from the card's counts (fake
H100 counts here: 132 SMs), the wrappers' mirrors of the sources' layouts,
and what each wrapper launches and records in ``last_launch`` (the kernel
library and the launch replaced by fakes that record the call)."""

import pytest
import torch

from room_slam_torch.ops import gru_cuda, rnn_cuda
from room_slam_torch.ops.gru_cuda import (bigru_plan, bigru_smem_bytes,
                                          gru_bwd_kernel_route,
                                          gru_fwd_kernel_route)
from room_slam_torch.ops.rnn_cuda import (check_unit_mirror,
                                          lstm_fwd_kernel_route, unit_plan,
                                          unit_plans, unit_smem_bytes,
                                          unit_threads, unit_weight_regs)

H100_SMS = 132
# an H100's resident clusters of the cluster kernel at these sizes
CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


def _clusters(c, rows):
    return CLUSTERS[c]


@pytest.mark.parametrize("batch,dirs,per_sm,want", [
    (32, 1, 2, [1, 2, 4]),      # legacy GRU step: 32 blocks of one row
    (1, 2, 2, [1, 2, 4]),       # flagship serving: no padding rows
    (20, 2, 2, [1, 2, 4]),      # flagship training: 40 blocks
    (128, 2, 2, [1, 2, 4]),     # 256 blocks, two at once on each SM
    (128, 2, 1, [2, 1, 4]),     # one at once: a second wave costs more
    (500, 2, 2, [4, 2, 1]),     # many blocks an SM: fewer, wider tiles
])
def test_unit_plans_from_card_counts(batch, dirs, per_sm, want):
    """A step costs the FMA issue of the rows that share an SM plus a fixed
    part for each group of blocks that run together there."""
    assert unit_plans(batch, dirs, H100_SMS, lambda rows: per_sm) == want
    assert unit_plan(batch, dirs, H100_SMS, lambda rows: per_sm) == want[0]


def test_unit_plan_skips_tiles_the_card_does_not_run():
    per_sm = {1: 0, 2: 2, 4: 2}
    assert unit_plans(32, 1, H100_SMS, per_sm.__getitem__) == [2, 4]
    with pytest.raises(ValueError, match="no block"):
        unit_plan(32, 1, H100_SMS, lambda rows: 0)


def test_gru_route_and_cluster_plans():
    """The legacy model's one-direction H=64 launch takes the unit kernel;
    the scale-up shape (128, 256) and the one-direction (8, 256) launch keep
    the cluster kernel and the plans ``test_cluster_plan`` asserts, and a
    two-direction launch at small H stays on the cluster kernel too."""
    assert gru_fwd_kernel_route(64, 1) == "unit"
    assert gru_fwd_kernel_route(16, 1) == "unit"
    assert gru_fwd_kernel_route(65, 1) == "cluster"
    assert gru_fwd_kernel_route(256, 1) == "cluster"
    assert gru_fwd_kernel_route(256, 2) == "cluster"
    assert gru_fwd_kernel_route(16, 2) == "cluster"
    assert bigru_plan("fwd", 128, 256, _clusters) == (8, 20)
    assert bigru_plan("fwd", 8, 256, _clusters, dirs=1) == (4, 4)
    assert bigru_plan("fwd", 16, 256, _clusters) == (4, 4)


def test_lstm_route():
    """The unit kernel up to H=64 (the flagship's), the wide kernel where
    its W_hh fits one block's shared memory (up to H=118 in float32)."""
    assert lstm_fwd_kernel_route(64) == "unit"
    assert lstm_fwd_kernel_route(1) == "unit"
    assert lstm_fwd_kernel_route(65) == "wide"
    assert lstm_fwd_kernel_route(118) == "wide"


@pytest.mark.parametrize("hidden", [0, 119, 128, 200])
def test_shapes_no_kernel_takes_raise(hidden):
    with pytest.raises(ValueError, match="H"):
        lstm_fwd_kernel_route(hidden)
    if hidden > 0:
        # W_hh of H=526 = 2 x 263 fits no cluster size that divides it
        with pytest.raises(ValueError, match="cluster"):
            bigru_plan("fwd", 8, 526, _clusters, dirs=1)


def test_unit_layout_mirrors():
    """The h tile [64][R] double buffered; four lanes a unit, units padded
    to whole warps; a lane's W_hh quarter for each gate column."""
    for rows in (1, 2, 4):
        assert unit_smem_bytes(rows) == 2 * 64 * rows * 4
    assert [unit_threads(h) for h in (1, 8, 20, 48, 64)] == [32, 32, 96,
                                                            192, 256]
    assert unit_weight_regs(4) == 64 and unit_weight_regs(3) == 48


def test_unit_mirror_check_against_source_layout():
    """``check_unit_mirror`` accepts a source whose layout agrees at every
    H and tile, and names the first plan where one differs."""
    def layout(what, hidden, rows, gates=4, threads=unit_threads):
        if hidden > 64 or rows not in (1, 2, 4):
            return -1
        return (unit_smem_bytes(rows), threads(hidden),
                unit_weight_regs(gates))[what]

    check_unit_mirror(layout, 4, "bilstm_fwd")
    with pytest.raises(RuntimeError, match="H=1, R=1"):
        check_unit_mirror(lambda w, h, r: layout(w, h, r, gates=3), 4,
                          "bilstm_fwd")
    unpadded = lambda h: unit_threads(h) if h <= 8 else 4 * h  # noqa: E731
    with pytest.raises(RuntimeError, match="H=9, R=1"):
        check_unit_mirror(lambda w, h, r: layout(w, h, r, threads=unpadded),
                          4, "bilstm_fwd")


class _Recorder:
    """Stands in for ``launch``: records the function name and arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, lib, fn_name, dev, *args):
        self.calls.append((fn_name, args))


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' device checks, kernel libraries, card counts and
    launch replaced: CPU tensors pass as on a card with 132 SMs that holds
    two unit blocks an SM and ``CLUSTERS`` clusters."""
    rec = _Recorder()
    cpu = torch.device("cpu")
    monkeypatch.setattr(rnn_cuda, "_check_cuda",
                        lambda name, streams, w, smem: (cpu,
                                                        streams[0].dtype))
    monkeypatch.setattr(gru_cuda, "_check_cuda", lambda *a: cpu)
    for mod in (rnn_cuda, gru_cuda):
        monkeypatch.setattr(mod, "_library", lambda name: name)
        monkeypatch.setattr(mod, "launch", rec)
    monkeypatch.setattr(rnn_cuda, "_unit_counts",
                        lambda *a: (H100_SMS, lambda rows: 2))
    monkeypatch.setattr(gru_cuda, "_resident",
                        lambda *a: ("bigru_fwd", _clusters))
    monkeypatch.setattr(rnn_cuda, "_UNIT_PLANS", {})
    monkeypatch.setattr(gru_cuda, "_PLANS", {})
    return rec


def _gru_args(B, N, H, dtype=torch.float32):
    return (torch.zeros(B, N, 3 * H, dtype=dtype), torch.zeros(H, 3 * H),
            torch.zeros(3 * H))


def test_gru_wrapper_launches_and_records(fake_card):
    """The legacy shape launches the unit kernel's entry point (6 pointers,
    B, N, H, R, reverse) with the planner's tile; H=256 launches the
    cluster entry point (6 pointers, B, N, H, C, R, reverse); both record
    their plan in ``last_launch``; a forced plan is taken or refused."""
    fn = gru_cuda.gru_fwd_train_cuda
    fn(*_gru_args(32, 5, 64), True)
    name, args = fake_card.calls[-1]
    assert name == "gru_fwd_unit_train_f32"
    assert len(args) == 11 and args[6:] == (32, 5, 64, 1, 1)
    assert fn.last_launch == {"kernel": "unit", "cluster": 1, "rows": 1,
                              "clusters": 32, "resident": 264}
    gru_cuda.gru_fwd_cuda(*_gru_args(8, 5, 256, torch.bfloat16))
    name, args = fake_card.calls[-1]
    assert name == "gru_fwd_bf16"
    assert len(args) == 10 and args[4:] == (8, 5, 256, 4, 4, 0)
    assert gru_cuda.gru_fwd_cuda.last_launch["kernel"] == "cluster"
    fn(*_gru_args(32, 5, 64), False, plan=("unit", 4))
    assert fake_card.calls[-1][1][6:] == (32, 5, 64, 4, 0)
    assert fn.last_launch["clusters"] == 8
    fn(*_gru_args(32, 5, 64), False, plan=("cluster", 1, 4))
    assert fake_card.calls[-1][0] == "gru_fwd_train_f32"
    assert fake_card.calls[-1][1][6:] == (32, 5, 64, 1, 4, 0)
    with pytest.raises(ValueError, match="unit kernel"):
        fn(*_gru_args(8, 5, 256), False, plan=("unit", 1))
    with pytest.raises(ValueError, match="tiles"):
        fn(*_gru_args(32, 5, 64), False, plan=("unit", 3))
    with pytest.raises(ValueError, match="plan"):
        fn(*_gru_args(32, 5, 64), False, plan=("wide", 4))


def test_lstm_wrappers_launch_and_record(fake_card):
    """The serving shape launches the unit kernel with one row (R=1, wide
    0); H=96 the wide kernel (R=4, wide 1); a grid of one direction passes
    the reverse flag last; forced plans are taken or refused."""
    z = torch.zeros
    rnn_cuda.bilstm_fwd_cuda(z(1, 5, 256), z(1, 5, 256), z(64, 256),
                             z(64, 256))
    name, args = fake_card.calls[-1]
    assert name == "bilstm_fwd_f32" and args[6:] == (1, 5, 64, 1, 0)
    assert rnn_cuda.bilstm_fwd_cuda.last_launch == {
        "kernel": "unit", "cluster": 1, "rows": 1, "clusters": 2,
        "resident": 264}
    rnn_cuda.bilstm_fwd_train_cuda(z(5, 3, 384), z(5, 3, 384), z(96, 384),
                                   z(96, 384))
    name, args = fake_card.calls[-1]
    assert name == "bilstm_fwd_train_f32" and args[10:] == (5, 3, 96, 4, 1)
    assert rnn_cuda.bilstm_fwd_train_cuda.last_launch["kernel"] == "wide"
    rnn_cuda.lstm_fwd_train_cuda(z(17, 3, 64, dtype=torch.bfloat16),
                                 z(16, 64), True, plan=("unit", 2))
    name, args = fake_card.calls[-1]
    assert name == "lstm_fwd_train_bf16" and args[5:] == (17, 3, 16, 2, 0, 1)
    assert rnn_cuda.lstm_fwd_train_cuda.last_launch["clusters"] == 9
    rnn_cuda.lstm_fwd_cuda(z(4, 3, 256), z(64, 256), plan=("wide", 4))
    assert fake_card.calls[-1][1][3:] == (4, 3, 64, 4, 1, 0)
    with pytest.raises(ValueError, match="unit kernel"):
        rnn_cuda.lstm_fwd_cuda(z(4, 3, 384), z(96, 384), plan=("unit", 1))
    with pytest.raises(ValueError, match="plan"):
        rnn_cuda.lstm_fwd_cuda(z(4, 3, 256), z(64, 256), plan=("wide", 2))


# ---------------------------------------------------------------------------
# The one-direction GRU BPTT: the unit kernel at H <= 64, the cluster kernel
# (kLinear) above it and for two directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden,dirs,want", [
    (16, 1, "unit"), (64, 1, "unit"), (65, 1, "cluster"), (64, 2, "cluster"),
    (256, 2, "cluster")])
def test_gru_bwd_route(hidden, dirs, want):
    assert gru_bwd_kernel_route(hidden, dirs) == want


def test_gru_bwd_unit_mirror_check_against_source_layout():
    """The BPTT unit kernel's dg tile holds three [64][R] tiles (one per
    gate block of W_hh's row); ``check_unit_mirror`` with ``tiles=3``
    accepts a source laid out so and names the first plan of one laid out
    as the forward's single h tile."""
    def layout(what, hidden, rows, tiles=3):
        if hidden > 64 or rows not in (1, 2, 4):
            return -1
        return (unit_smem_bytes(rows, tiles), unit_threads(hidden),
                unit_weight_regs(3))[what]

    assert unit_smem_bytes(4, 3) == 2 * 3 * 64 * 4 * 4
    check_unit_mirror(layout, 3, "gru_bwd", tiles=3)
    with pytest.raises(RuntimeError, match="H=1, R=1"):
        check_unit_mirror(lambda w, h, r: layout(w, h, r, tiles=1), 3,
                          "gru_bwd", tiles=3)


def _bwd_args(B, N, H, dtype=torch.float32):
    z = torch.zeros
    return (z(H, 3 * H), z(B, N, 3 * H, dtype=dtype),
            *(z(B, N, H, dtype=dtype) for _ in range(3)))


def test_gru_bwd_wrapper_launches_unit_and_cluster(fake_card):
    """The legacy shape (32, 500, 64) launches ``gru_bwd_unit_*`` (7
    pointers, B, N, H, R, reverse) with the planner's one-row tile; the
    one-direction H=256 launch the cluster entry (7 pointers, B, N, H, C,
    R, reverse) at the planner's plan; both record it."""
    fn = gru_cuda.gru_bwd_cuda
    fn(*_bwd_args(32, 500, 64), True)
    name, args = fake_card.calls[-1]
    assert name == "gru_bwd_unit_f32"
    assert len(args) == 12 and args[7:] == (32, 500, 64, 1, 1)
    assert fn.last_launch == {"kernel": "unit", "cluster": 1, "rows": 1,
                              "clusters": 32, "resident": 264}
    fn(*_bwd_args(8, 1000, 256, torch.bfloat16))
    name, args = fake_card.calls[-1]
    c, r = bigru_plan("bwd", 8, 256, _clusters, dirs=1)
    assert name == "gru_bwd_bf16"
    assert len(args) == 13 and args[7:] == (8, 1000, 256, c, r, 0)
    assert fn.last_launch["kernel"] == "cluster"
    assert fn.last_launch["clusters"] == -(-8 // r)


def test_gru_bwd_launch_follows_its_route(fake_card, monkeypatch):
    """``gru_bwd_cuda`` asks ``gru_bwd_kernel_route``, not the forward's
    route: sending the legacy shape to the cluster kernel there moves the
    BPTT's launch and leaves the forward's on the unit kernel."""
    monkeypatch.setattr(gru_cuda, "gru_bwd_kernel_route",
                        lambda hidden, dirs: "cluster")
    gru_cuda.gru_bwd_cuda(*_bwd_args(32, 5, 64))
    assert fake_card.calls[-1][0] == "gru_bwd_f32"
    assert gru_cuda.gru_bwd_cuda.last_launch["kernel"] == "cluster"
    gru_cuda.gru_fwd_cuda(*_gru_args(32, 5, 64))
    assert fake_card.calls[-1][0] == "gru_fwd_unit_f32"


def test_gru_bwd_plan_forced_or_refused(fake_card):
    """``plan=`` takes a unit tile or a cluster plan that fits, and refuses
    a tile the unit kernel has not, the unit kernel above H=64, a cluster
    plan that does not fit and another kernel's plan."""
    fn = gru_cuda.gru_bwd_cuda
    fn(*_bwd_args(17, 5, 48), False, plan=("unit", 4))
    assert fake_card.calls[-1][0] == "gru_bwd_unit_f32"
    assert fake_card.calls[-1][1][7:] == (17, 5, 48, 4, 0)
    assert fn.last_launch["clusters"] == 5
    fn(*_bwd_args(32, 5, 64), True, plan=("cluster", 1, 4))
    assert fake_card.calls[-1][0] == "gru_bwd_f32"
    assert fake_card.calls[-1][1][7:] == (32, 5, 64, 1, 4, 1)
    n = len(fake_card.calls)
    with pytest.raises(ValueError, match="tiles"):
        fn(*_bwd_args(32, 5, 64), plan=("unit", 3))
    with pytest.raises(ValueError, match="unit kernel"):
        fn(*_bwd_args(4, 5, 256), plan=("unit", 1))
    with pytest.raises(ValueError, match="does not fit"):
        fn(*_bwd_args(32, 5, 64), plan=("cluster", 3, 4))
    with pytest.raises(ValueError, match="plan"):
        fn(*_bwd_args(32, 5, 64), plan=("wide", 4))
    assert len(fake_card.calls) == n


@pytest.mark.parametrize("hidden,cluster,rows,floats", [
    (256, 8, 20, 24576 + 2 * 768 * 20 + 96 * 20),   # the exchange tile
    (16, 1, 4, 768 + 20480 + 96 * 4)])              # grown to the stage
def test_fused_staging_reuses_exchange_tile(hidden, cluster, rows, floats):
    """#9's tensor-core products stage their operands in the exchange tile
    (idle between the chunk's two cluster barriers), grown to a ring of
    four bf16 buffers of two 128 x 32 tiles where it is smaller, then the
    chunk's 96 steps of sample indices; the scale-up plan (8 blocks of 20
    rows) still fits one block."""
    assert bigru_smem_bytes("fused", hidden, cluster, rows) == 4 * floats
    assert bigru_smem_bytes("fused", 256, 8, 20) <= gru_cuda.MAX_SMEM_BYTES
    assert bigru_plan("fused", 128, 256, _clusters) == (8, 20)
