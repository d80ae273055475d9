"""Launch planning of the recurrences, on the CPU: which kernel of
``csrc/bilstm_fwd.cu`` / ``csrc/bilstm_bwd.cu`` / ``csrc/bigru_fwd.cu`` /
``csrc/bigru_bwd.cu`` takes a shape, the unit kernels' batch tile from the card's counts (fake
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
                                          lstm_bwd_kernel_route,
                                          lstm_fwd_kernel_route, unit_plan,
                                          unit_plans, unit_smem_bytes,
                                          unit_threads, unit_weight_regs)

H100_SMS = 132
# an H100's resident clusters of the cluster kernel at these sizes
CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


def _clusters(c, rows):
    return CLUSTERS[c]


def _reg_clusters(c, rows):
    """An H100's resident clusters of the register cluster kernels: 15 of
    8 blocks, 7 of 16 (a non-portable size)."""
    return 120 // c if c <= 8 else 7


def _stream_clusters(c, rows):
    """Resident clusters of the stream kernels, any size from 1 to 16
    blocks: 7 of 9 to 16 (non-portable sizes), as the register kernels'."""
    return 120 // c if c <= 8 else 7


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
    the cluster kernel and the plans ``test_cluster_plan`` asserts; a
    two-direction launch at small H takes the unit kernel too, float32 or
    bf16."""
    assert gru_fwd_kernel_route(64, 1) == "unit"
    assert gru_fwd_kernel_route(16, 1) == "unit"
    assert gru_fwd_kernel_route(65, 1) == "cluster"
    assert gru_fwd_kernel_route(256, 1) == "cluster"
    assert gru_fwd_kernel_route(256, 2) == "cluster"
    assert gru_fwd_kernel_route(16, 2) == "unit"
    assert gru_fwd_kernel_route(16, 2, torch.bfloat16) == "unit"
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


@pytest.mark.parametrize("hidden", [0, 257, 300, 512])
def test_shapes_no_kernel_takes_raise(hidden):
    """No LSTM forward kernel takes H <= 0 (the error names the width); no
    register cluster plan takes H above 256 and no cluster plan of the GRU
    one at H=526 (their planners' errors name the width): those widths
    take the stream kernel."""
    if hidden <= 0:
        with pytest.raises(ValueError, match="H"):
            lstm_fwd_kernel_route(hidden)
        with pytest.raises(ValueError, match="H"):
            gru_fwd_kernel_route(hidden, 2)
        return
    with pytest.raises(ValueError, match=f"H={hidden}"):
        rnn_cuda.lstm_reg_plan("fwd", 8, hidden, _reg_clusters)
    assert lstm_fwd_kernel_route(hidden) == "stream"
    # W_hh of H=526 = 2 x 263 fits no cluster size that divides it
    with pytest.raises(ValueError, match="cluster"):
        bigru_plan("fwd", 8, 526, _clusters, dirs=1)
    assert gru_fwd_kernel_route(526, 1) == "stream"


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
    monkeypatch.setattr(gru_cuda, "_stream_resident",
                        lambda kind, *a: (f"bigru_{kind}", _stream_clusters))
    monkeypatch.setattr(rnn_cuda, "_cluster_resident",
                        lambda *a: _reg_clusters if "reg" in a
                        else _stream_clusters if "stream" in a
                        else _clusters)
    monkeypatch.setattr(rnn_cuda, "_UNIT_PLANS", {})
    monkeypatch.setattr(rnn_cuda, "_CLUSTER_PLANS", {})
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
    (16, 1, "unit"), (64, 1, "unit"), (65, 1, "cluster"), (64, 2, "unit"),
    (256, 2, "cluster")])
def test_gru_bwd_route(hidden, dirs, want):
    """float32 streams (the default): the unit kernel at H <= 64 in both
    direction counts, kLinear's cluster kernel above."""
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


# ---------------------------------------------------------------------------
# The LSTM BPTT (both grids): the unit kernel at H <= 64, the wide kernel
# above it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden,want", [
    (16, "unit"), (64, "unit"), (65, "wide"), (96, "wide"), (116, "wide"),
    (117, "cluster"), (118, "cluster"), (119, "cluster"), (256, "cluster")])
def test_lstm_bwd_route(hidden, want):
    """The wide BPTT kernel's W_hh^T and double-buffered [4][4H] dg tile
    fit one block to H=116 (the wide forward's smaller tile to H=118); the
    widths above, to 256, split W_hh across a cluster ("cluster" here):
    they take the register cluster kernel ("reg"), and the first cluster
    kernel only by a forced plan."""
    assert lstm_bwd_kernel_route(hidden) == {"cluster": "reg"}.get(want,
                                                                   want)
    if 64 < hidden <= 118:
        assert lstm_fwd_kernel_route(hidden) == "wide"


@pytest.mark.parametrize("hidden", [0, 257, 260, 384])
def test_lstm_bwd_route_raises_where_no_kernel_fits(hidden):
    """No BPTT kernel takes H <= 0, and no register or first cluster plan
    H above 256: the errors name the width; those widths take the stream
    kernel."""
    if hidden <= 0:
        with pytest.raises(ValueError, match="H"):
            lstm_bwd_kernel_route(hidden)
        return
    with pytest.raises(ValueError, match=f"H={hidden}"):
        rnn_cuda.lstm_reg_plan("bwd", 8, hidden, _reg_clusters)
    with pytest.raises(ValueError, match=f"H={hidden}"):
        rnn_cuda.lstm_cluster_plan("bwd", 8, hidden, _clusters)
    assert lstm_bwd_kernel_route(hidden) == "stream"


def test_lstm_bwd_unit_mirror_check_against_source_layout():
    """The LSTM BPTT unit kernel's dg tile holds four [64][R] tiles (one per
    gate block of W_hh's row); ``check_unit_mirror`` with ``tiles=4``
    accepts a source laid out so and names the first plan of one laid out
    as the GRU BPTT's three tiles."""
    def layout(what, hidden, rows, tiles=4):
        if hidden > 64 or rows not in (1, 2, 4):
            return -1
        return (unit_smem_bytes(rows, tiles), unit_threads(hidden),
                unit_weight_regs(4))[what]

    assert unit_smem_bytes(4, 4) == 2 * 4 * 64 * 4 * 4
    check_unit_mirror(layout, 4, "bilstm_bwd", tiles=4)
    with pytest.raises(RuntimeError, match="H=1, R=1"):
        check_unit_mirror(lambda w, h, r: layout(w, h, r, tiles=3), 4,
                          "bilstm_bwd", tiles=4)


def _lstm_bwd_args(B, N, H, dtype=torch.float32):
    """``bilstm_bwd_cuda``'s arguments: w_f, w_b, then gs, cs, dy of each
    direction."""
    z = torch.zeros
    one = (z(B, N, 4 * H, dtype=dtype), z(B, N, H, dtype=dtype),
           z(B, N, H, dtype=dtype))
    return (z(H, 4 * H), z(H, 4 * H), *one, *one)


def _lstm_bwd_one(B, N, H, dtype=torch.float32):
    """``lstm_bwd_cuda``'s arguments: w, gs, cs, dy."""
    return _lstm_bwd_args(B, N, H, dtype)[1:5]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_wrappers_launch_unit(fake_card, dtype):
    """The flagship training shape (20, 1500, 64) launches
    ``bilstm_bwd_unit_*`` (10 pointers, B, N, H, R) and the legacy-LSTM
    shape (32, 500, 64) ``lstm_bwd_unit_*`` (5 pointers, B, N, H, R,
    reverse), both with the planner's one-row tile, and record it."""
    sfx = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    fn = rnn_cuda.bilstm_bwd_cuda
    fn(*_lstm_bwd_args(20, 1500, 64, dtype))
    name, args = fake_card.calls[-1]
    assert name == f"bilstm_bwd_unit_{sfx}"
    assert len(args) == 14 and args[10:] == (20, 1500, 64, 1)
    assert fn.last_launch == {"kernel": "unit", "cluster": 1, "rows": 1,
                              "clusters": 40, "resident": 264}
    fn = rnn_cuda.lstm_bwd_cuda
    fn(*_lstm_bwd_one(32, 500, 64, dtype), True)
    name, args = fake_card.calls[-1]
    assert name == f"lstm_bwd_unit_{sfx}"
    assert len(args) == 10 and args[5:] == (32, 500, 64, 1, 1)
    assert fn.last_launch == {"kernel": "unit", "cluster": 1, "rows": 1,
                              "clusters": 32, "resident": 264}
    assert rnn_cuda.bilstm_bwd_cuda.launches >= 1 and fn.launches >= 1


def test_lstm_bwd_wide_entry_above_unit_width(fake_card):
    """H=96 launches the wide entries: ``bilstm_bwd_*`` (10 pointers, B, N,
    H) and ``lstm_bwd_*`` (5 pointers, B, N, H, reverse), 4-row tiles."""
    rnn_cuda.bilstm_bwd_cuda(*_lstm_bwd_args(5, 3, 96))
    name, args = fake_card.calls[-1]
    assert name == "bilstm_bwd_f32" and len(args) == 13
    assert args[10:] == (5, 3, 96)
    assert rnn_cuda.bilstm_bwd_cuda.last_launch == {
        "kernel": "wide", "cluster": 1, "rows": 4, "clusters": 4,
        "resident": None}
    rnn_cuda.lstm_bwd_cuda(*_lstm_bwd_one(5, 3, 96, torch.bfloat16), True)
    name, args = fake_card.calls[-1]
    assert name == "lstm_bwd_bf16" and len(args) == 9
    assert args[5:] == (5, 3, 96, 1)
    assert rnn_cuda.lstm_bwd_cuda.last_launch["clusters"] == 2


def test_lstm_bwd_launch_follows_its_route(fake_card, monkeypatch):
    """``bilstm_bwd_cuda`` and ``lstm_bwd_cuda`` ask
    ``lstm_bwd_kernel_route``, not the forward's route: sending H=64 to the
    wide kernel there moves both BPTT launches and leaves the forward's on
    the unit kernel, and the converse leaves the BPTT's on it."""
    monkeypatch.setattr(rnn_cuda, "lstm_bwd_kernel_route",
                        lambda hidden: "wide")
    rnn_cuda.bilstm_bwd_cuda(*_lstm_bwd_args(20, 5, 64))
    assert fake_card.calls[-1][0] == "bilstm_bwd_f32"
    assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == "wide"
    rnn_cuda.lstm_bwd_cuda(*_lstm_bwd_one(32, 5, 64))
    assert fake_card.calls[-1][0] == "lstm_bwd_f32"
    z = torch.zeros
    rnn_cuda.bilstm_fwd_train_cuda(z(20, 5, 256), z(20, 5, 256), z(64, 256),
                                   z(64, 256))
    assert fake_card.calls[-1][0] == "bilstm_fwd_train_f32"
    assert rnn_cuda.bilstm_fwd_train_cuda.last_launch["kernel"] == "unit"
    monkeypatch.setattr(rnn_cuda, "lstm_bwd_kernel_route",
                        lstm_bwd_kernel_route)
    monkeypatch.setattr(rnn_cuda, "lstm_fwd_kernel_route",
                        lambda hidden: "wide")
    rnn_cuda.bilstm_bwd_cuda(*_lstm_bwd_args(20, 5, 64))
    assert fake_card.calls[-1][0] == "bilstm_bwd_unit_f32"
    rnn_cuda.lstm_bwd_cuda(*_lstm_bwd_one(32, 5, 64))
    assert fake_card.calls[-1][0] == "lstm_bwd_unit_f32"


def test_lstm_bwd_plan_forced_or_refused(fake_card):
    """``plan=`` takes a unit tile, the wide kernel or a cluster plan, and
    refuses a tile the unit kernel has not, the unit kernel above H=64, a
    wide tile other than 4 rows, a cluster plan whose slice does not fit
    and another kernel's plan."""
    fn = rnn_cuda.bilstm_bwd_cuda
    fn(*_lstm_bwd_args(17, 5, 48), plan=("unit", 4))
    assert fake_card.calls[-1][0] == "bilstm_bwd_unit_f32"
    assert fake_card.calls[-1][1][10:] == (17, 5, 48, 4)
    assert fn.last_launch["clusters"] == 10
    rnn_cuda.lstm_bwd_cuda(*_lstm_bwd_one(17, 5, 48), True, plan=("unit", 2))
    assert fake_card.calls[-1][1][5:] == (17, 5, 48, 2, 1)
    assert rnn_cuda.lstm_bwd_cuda.last_launch["clusters"] == 9
    fn(*_lstm_bwd_args(32, 5, 64), plan=("wide", 4))
    assert fake_card.calls[-1][0] == "bilstm_bwd_f32"
    assert fn.last_launch["kernel"] == "wide"
    rnn_cuda.lstm_bwd_cuda(*_lstm_bwd_one(32, 5, 64), plan=("wide", 4))
    assert fake_card.calls[-1][0] == "lstm_bwd_f32"
    assert fake_card.calls[-1][1][5:] == (32, 5, 64, 0)
    n = len(fake_card.calls)
    with pytest.raises(ValueError, match="tiles"):
        fn(*_lstm_bwd_args(32, 5, 64), plan=("unit", 3))
    with pytest.raises(ValueError, match="unit kernel"):
        fn(*_lstm_bwd_args(4, 5, 96), plan=("unit", 1))
    with pytest.raises(ValueError, match="plan"):
        fn(*_lstm_bwd_args(32, 5, 64), plan=("wide", 2))
    with pytest.raises(ValueError, match="plan"):
        rnn_cuda.lstm_bwd_cuda(*_lstm_bwd_one(32, 5, 64),
                               plan=("tc", 4, 16))
    with pytest.raises(ValueError, match="does not fit"):
        rnn_cuda.lstm_bwd_cuda(*_lstm_bwd_one(32, 5, 256),
                               plan=("cluster", 4, 4))
    assert len(fake_card.calls) == n
    rnn_cuda.lstm_bwd_cuda(*_lstm_bwd_one(32, 5, 64), plan=("cluster", 1, 4))
    assert fake_card.calls[-1][0] == "lstm_bwd_cluster_f32"
    assert fake_card.calls[-1][1][5:] == (32, 5, 64, 1, 4, 0)


# ---------------------------------------------------------------------------
# The tensor-core kernels (bigru_fwd_tc_kernel, bigru_bwd_tc_kernel): bf16
# streams of two directions; f32 and one direction keep their kernels
# ---------------------------------------------------------------------------

# an H100's resident clusters of 4 and 8 blocks, as the cluster kernel's
TC_CLUSTERS = {4: 30, 8: 15}


@pytest.mark.parametrize("route", [gru_fwd_kernel_route,
                                   gru_bwd_kernel_route])
def test_tc_route_takes_bf16_two_directions(route):
    """bf16 streams of two directions at H=256 and 128 take the
    tensor-core kernel, at H <= 64 the unit kernel (faster there); float32
    (also the default dtype) keeps the cluster kernel; one direction keeps
    its route whatever the dtype; an H no tensor-core plan takes (not a
    multiple of 16, above 256, or no 8-unit warps at C = 4 and 8) keeps
    the cluster kernel, or the stream kernel where no cluster plan fits
    either (H=512)."""
    bf16 = torch.bfloat16
    assert route(256, 2, bf16) == route(128, 2, bf16) == "tc"
    assert route(64, 2, bf16) == route(32, 2, bf16) == "unit"
    assert route(256, 2) == route(256, 2, torch.float32) == "cluster"
    assert route(64, 1, bf16) == "unit" and route(256, 1, bf16) == "cluster"
    for hidden in (72, 88, 264):
        assert route(hidden, 2, bf16) == "cluster", hidden
    assert route(512, 2, bf16) == "stream"


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("batch,counts,want", [
    # (8, 16) needs 16 clusters of 8, a card of 15 runs a second wave
    (128, TC_CLUSTERS, [(4, 16), (8, 32), (4, 32), (8, 16)]),
    # the H100's own counts: 30 of each; (8, 16)'s 128 blocks fill more than
    # half the card and follow (4, 16), the order its sweep gave
    (128, {4: 30, 8: 30}, [(4, 16), (8, 16), (8, 32), (4, 32)]),
    (17, TC_CLUSTERS, [(8, 16), (4, 16), (8, 32), (4, 32)]),
    (1, TC_CLUSTERS, [(8, 16), (4, 16), (8, 32), (4, 32)])])
def test_tc_plans_from_card_counts(kind, batch, counts, want):
    """The plan whose grid needs a second wave comes last; between one-wave
    plans one m16 tile goes before two, a grid that leaves half the card's
    SMs free before one that does not, then the least mma.sync work a
    scheduler takes a step, ties to the smaller cluster."""
    resident = lambda c, rows: counts[c]   # noqa: E731
    assert gru_cuda.bigru_tc_plans(kind, batch, 256, resident,
                                   H100_SMS) == want
    assert gru_cuda.bigru_tc_plan(kind, batch, 256, resident,
                                  H100_SMS) == want[0]
    # a plan the card runs no cluster of is dropped; none at all raises
    assert (8, 16) not in gru_cuda.bigru_tc_plans(
        kind, batch, 256, lambda c, rows: 0 if (c, rows) == (8, 16) else 30,
        H100_SMS)
    with pytest.raises(ValueError, match="no plan"):
        gru_cuda.bigru_tc_plan(kind, batch, 256, lambda c, rows: 0, H100_SMS)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_tc_plan_rule(kind):
    """C = 2 at H=256 would need 16 warps of more than 128 registers: the
    rule refuses it, and tiles other than one or two m16 tiles, and H off
    the 16-deep k-steps or above 256; the double-buffered bf16 tile and the
    staged streams fit (219 KB for the BPTT at 4 x 32)."""
    fits = gru_cuda.tc_plan_fits
    assert fits(kind, 256, 4, 16) and fits(kind, 256, 8, 32)
    assert not fits(kind, 256, 2, 16) and not fits(kind, 256, 2, 32)
    assert fits(kind, 64, 2, 16) and fits(kind, 64, 8, 32)
    assert not fits(kind, 256, 4, 20) and not fits(kind, 256, 4, 8)
    assert not fits(kind, 264, 4, 16) and not fits(kind, 512, 8, 16)
    assert not fits(kind, 64, 16, 16)
    # the h or dg tile (as wide as at H=256 whatever H), then the staged
    # streams in rows of the block's U units: a ring of 3 steps of inputs
    # (3 xg streams; the BPTT's 6) and two steps of outputs (5; 4)
    tile, n_in, n_out = (256, 3, 5) if kind == "fwd" else (768, 6, 4)
    assert gru_cuda.tc_smem_bytes(kind, 256, 4, 32) == 2 * (
        2 * 32 * (tile + 8) + (3 * n_in + 2 * n_out) * 32 * (64 + 8))
    assert gru_cuda.tc_smem_bytes(kind, 256, 8, 16) == 2 * (
        2 * 16 * (tile + 8) + (4 * n_in + 2 * n_out) * 16 * (32 + 8))
    assert gru_cuda.tc_smem_bytes("bwd", 256, 4, 32) <= 232448
    assert gru_cuda.tc_threads(256, 4) == 256
    assert gru_cuda.tc_threads(256, 8) == 128


def _tc_layout(kind, pad=8, clusters=(1, 2, 4, 8)):
    """A source's ``bigru_<kind>_tc_layout`` laid out as the wrapper's
    mirror (tiles as wide as at H=256, the streams staged in rows of U
    units), with the rows' padding and the cluster sizes it takes."""
    def layout(what, hidden, c, rows):
        units = hidden // c if hidden % c == 0 else 0
        if (c not in clusters or rows not in (16, 32) or hidden % 16
                or hidden > 256 or units % 8 or not units or 4 * units > 256):
            return -1
        tile, n_in, n_out = (256, 3, 5) if kind == "fwd" else (768, 6, 4)
        ring = {16: 4, 32: 3}[rows]
        smem = 2 * (2 * rows * (tile + pad)
                    + (ring * n_in + 2 * n_out) * rows * (units + pad))
        return (smem, 4 * units, 96)[what]
    return layout


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_tc_mirror_check_against_source_layout(kind):
    """``check_tc_mirror`` accepts a source laid out as the wrapper's
    mirror, and names the first plan of one with unpadded rows or one that
    takes no cluster of 1 or 2 blocks."""
    gru_cuda.check_tc_mirror(_tc_layout(kind), kind)
    with pytest.raises(RuntimeError, match="H=16, plan 1x16"):
        gru_cuda.check_tc_mirror(_tc_layout(kind, pad=0), kind)
    with pytest.raises(RuntimeError, match="H=16, plan 1x16"):
        gru_cuda.check_tc_mirror(_tc_layout(kind, clusters=(4, 8)), kind)


@pytest.fixture
def fake_tc_card(fake_card, monkeypatch):
    """``fake_card`` whose tensor-core kernels run ``TC_CLUSTERS``
    clusters at once."""
    monkeypatch.setattr(gru_cuda, "_tc_resident", lambda kind, *a: (
        f"bigru_{kind}", lambda c, rows: TC_CLUSTERS[c], H100_SMS))
    return fake_card


def _bigru_args(B, N, H, dtype):
    """``bigru_fwd_cuda``'s arguments: xg_f, xg_b, w_f, b_f, w_b, b_b."""
    z = torch.zeros
    return (z(B, N, 3 * H, dtype=dtype), z(B, N, 3 * H, dtype=dtype),
            z(H, 3 * H), z(3 * H), z(H, 3 * H), z(3 * H))


def _bigru_bwd_args(B, N, H, dtype):
    """``bigru_bwd_cuda``'s arguments: w_f, w_b, then gs, hn, ys, dy of
    each direction."""
    one = _bwd_args(B, N, H, dtype)[1:]
    return (torch.zeros(H, 3 * H), torch.zeros(H, 3 * H), *one, *one)


def test_bigru_wrappers_launch_tc_entries(fake_tc_card):
    """At the scale-up batch and width with bf16 streams the three BiGRU
    wrappers launch the ``*_tc_bf16`` entries (the cluster entries'
    pointers, then B, N, H, C, R) with the planner's (4, 16) and record
    it; float32 streams launch the cluster entries at ``bigru_plan``'s
    (8, 20)."""
    bf16 = torch.bfloat16
    for fn, n_ptr, name in ((gru_cuda.bigru_fwd_cuda, 8, "bigru_fwd"),
                            (gru_cuda.bigru_fwd_train_cuda, 12,
                             "bigru_fwd_train")):
        fn(*_bigru_args(128, 3, 256, bf16))
        got, args = fake_tc_card.calls[-1]
        assert got == f"{name}_tc_bf16" and len(args) == n_ptr + 5
        assert args[n_ptr:] == (128, 3, 256, 4, 16)
        assert fn.last_launch == {"kernel": "tc", "cluster": 4, "rows": 16,
                                  "clusters": 16, "resident": 30}
        fn(*_bigru_args(128, 3, 256, torch.float32))
        got, args = fake_tc_card.calls[-1]
        assert got == f"{name}_f32" and args[n_ptr:] == (128, 3, 256, 8, 20)
        assert fn.last_launch["kernel"] == "cluster"
    fn = gru_cuda.bigru_bwd_cuda
    before = fn.launches
    fn(*_bigru_bwd_args(128, 3, 256, bf16))
    got, args = fake_tc_card.calls[-1]
    assert got == "bigru_bwd_tc_bf16" and len(args) == 19
    assert args[14:] == (128, 3, 256, 4, 16)
    assert fn.last_launch["kernel"] == "tc" and fn.launches == before + 1
    fn(*_bigru_bwd_args(128, 3, 256, torch.float32))
    got, args = fake_tc_card.calls[-1]
    c, r = bigru_plan("bwd", 128, 256, _clusters)
    assert got == "bigru_bwd_f32" and args[14:] == (128, 3, 256, c, r)
    # the served request's batch of one row takes the planner's pick there
    gru_cuda.bigru_fwd_cuda(*_bigru_args(1, 3, 256, bf16))
    assert fake_tc_card.calls[-1][1][8:] == (1, 3, 256, 8, 16)
    assert gru_cuda.bigru_fwd_cuda.last_launch["clusters"] == 2


def test_bigru_plans_forced_or_refused(fake_tc_card):
    """``plan=(C, R)`` still forces the cluster kernel for bf16 streams;
    ``plan=("tc", C, R)`` forces a tensor-core plan, and is refused for
    float32 streams, for H off the 16-deep k-steps and for a plan the
    rule does not take; the split kind (#10) keeps the cluster plans."""
    bf16 = torch.bfloat16
    fwd, bwd = gru_cuda.bigru_fwd_cuda, gru_cuda.bigru_bwd_cuda
    fwd(*_bigru_args(128, 3, 256, bf16), plan=(8, 20))
    assert fake_tc_card.calls[-1][0] == "bigru_fwd_bf16"
    assert fake_tc_card.calls[-1][1][8:] == (128, 3, 256, 8, 20)
    assert fwd.last_launch["kernel"] == "cluster"
    bwd(*_bigru_bwd_args(128, 3, 256, bf16), plan=(8, 20))
    assert fake_tc_card.calls[-1][0] == "bigru_bwd_bf16"
    gru_cuda.bigru_fwd_train_cuda(*_bigru_args(17, 3, 256, bf16),
                                  plan=("tc", 8, 32))
    assert fake_tc_card.calls[-1][0] == "bigru_fwd_train_tc_bf16"
    assert fake_tc_card.calls[-1][1][12:] == (17, 3, 256, 8, 32)
    assert gru_cuda.bigru_fwd_train_cuda.last_launch["clusters"] == 2
    bwd(*_bigru_bwd_args(5, 3, 64, bf16), plan=("tc", 4, 16))
    assert fake_tc_card.calls[-1][1][14:] == (5, 3, 64, 4, 16)
    gru_cuda.bigru_bwd_split_cuda(*_bigru_bwd_args(128, 3, 256, bf16),
                                  plan=(8, 20))
    assert fake_tc_card.calls[-1][0] == "bigru_bwd_split_bf16"
    n = len(fake_tc_card.calls)
    with pytest.raises(ValueError, match="bfloat16"):
        fwd(*_bigru_args(128, 3, 256, torch.float32), plan=("tc", 4, 16))
    with pytest.raises(ValueError, match="bfloat16"):
        bwd(*_bigru_bwd_args(128, 3, 256, torch.float32), plan=("tc", 4, 16))
    with pytest.raises(ValueError, match="does not fit"):
        fwd(*_bigru_args(5, 3, 24, bf16), plan=("tc", 1, 16))
    with pytest.raises(ValueError, match="does not fit"):
        bwd(*_bigru_bwd_args(5, 3, 40, bf16), plan=("tc", 1, 16))
    with pytest.raises(ValueError, match="does not fit"):
        fwd(*_bigru_args(128, 3, 256, bf16), plan=("tc", 2, 16))
    assert len(fake_tc_card.calls) == n


# ---------------------------------------------------------------------------
# Every width H = 1..256 on the card: each kernel, dtype and direction
# count gets a route and a plan, and wherever a kernel took H before the
# LSTM cluster kernels and the GRU's masked slices, the pick is unchanged
# (the planner of that time is kept here as it was).
# ---------------------------------------------------------------------------

def _before_bigru_plans(kind, batch, hidden, resident, dirs):
    """``bigru_plans`` as it was: the cluster size divides H."""
    keys = []
    for c in (1, 2, 4, 8):
        for rows in range(4, 33, 4):
            if hidden % c:
                continue
            U = hidden // c
            if U * (rows // 4) > gru_cuda.KIND_THREADS[kind] or (
                    kind == "fused" and U % 16) or bigru_smem_bytes(
                    kind, hidden, c, rows) > rnn_cuda.MAX_SMEM_BYTES:
                continue
            at_once = resident(c, rows)
            if at_once <= 0:
                continue
            waves = -(-dirs * -(-batch // rows) // at_once)
            keys.append((max(U * (rows // 4), 128) * waves, c, rows))
    return [(c, rows) for _, c, rows in sorted(keys)]


def _before_lstm_route(kind, hidden):
    """The LSTM routes as they were: unit to H=64, wide where it fits."""
    if hidden <= 64:
        return "unit"
    if kind == "fwd":
        fits = 4 * hidden <= 512 and rnn_cuda.bilstm_smem_bytes(
            hidden) <= rnn_cuda.MAX_SMEM_BYTES
    else:
        fits = rnn_cuda.bilstm_bwd_smem_bytes(
            hidden) <= rnn_cuda.MAX_SMEM_BYTES
    return "wide" if fits else None


@pytest.mark.parametrize("batch", [1, 5, 32, 128])
def test_every_width_gets_a_kernel_and_keeps_its_pick(batch):
    """Every H the unit and wide kernels took keeps its kernel; every H
    above them takes the register cluster kernel with a plan in each
    direction count, and the first cluster kernel, reached by a forced
    plan, still plans there too."""
    tc_counts = {4: 30, 8: 15}
    for hidden in range(1, 257):
        for kind in ("fwd", "bwd"):
            route = (rnn_cuda.lstm_fwd_kernel_route if kind == "fwd"
                     else rnn_cuda.lstm_bwd_kernel_route)(hidden)
            before = _before_lstm_route(kind, hidden)
            if before is not None:
                assert route == before, (kind, hidden)
            elif route == "reg":
                for dirs in (1, 2):
                    assert rnn_cuda.lstm_reg_plans(
                        kind, batch, hidden, _reg_clusters, dirs), (kind,
                                                                    hidden)
                    assert rnn_cuda.lstm_cluster_plans(
                        kind, batch, hidden, _clusters, dirs), (kind, hidden)
            else:
                pytest.fail(f"LSTM {kind} H={hidden}: route {route}")
            for dtype in (torch.float32, torch.bfloat16):
                for dirs in (1, 2):
                    groute = (gru_fwd_kernel_route if kind == "fwd"
                              else gru_bwd_kernel_route)(hidden, dirs, dtype)
                    if groute == "unit":
                        assert unit_plans(batch, dirs, H100_SMS,
                                          lambda rows: 2)
                        continue
                    if groute == "tc":
                        assert gru_cuda.bigru_tc_plans(
                            kind, batch, hidden,
                            lambda c, r: tc_counts[c], H100_SMS)
                        continue
                    got = gru_cuda.bigru_plans(kind, batch, hidden,
                                               _clusters, dirs)
                    assert got, (kind, hidden, dtype, dirs)
                    was = _before_bigru_plans(kind, batch, hidden,
                                              _clusters, dirs)
                    if was:
                        assert got == was, (kind, hidden, dirs)
                    else:   # a masked slice: the cluster does not divide H
                        assert all(hidden % c for c, _ in got)


def test_widths_refused_before_now_planned():
    """The widths up to 256 that no kernel took at B=32 (the H100 counts):
    LSTM forward H=119..256 (138), BPTT H=117..256 (140); the GRU cluster
    kernels 74 widths in the forward, 77 in the BPTT. Each now has a
    plan."""
    lstm = {k: [h for h in range(1, 257)
                if _before_lstm_route(k, h) is None] for k in ("fwd", "bwd")}
    assert lstm["fwd"] == list(range(119, 257))
    assert lstm["bwd"] == list(range(117, 257))
    for kind, want in (("fwd", 74), ("bwd", 77)):
        refused = [h for h in range(1, 257)
                   if not _before_bigru_plans(kind, 32, h, _clusters, 2)]
        assert len(refused) == want, kind
        for h in refused:
            assert gru_cuda.bigru_plans(kind, 32, h, _clusters, 2)
        for h in lstm[kind]:
            assert rnn_cuda.lstm_cluster_plan(kind, 32, h, _clusters)


def _lstm_cluster_source(kind, hidden, c, rows, every_block=True):
    """The sources' ``cluster_smem_bytes`` / ``valid_cluster_plan``,
    written out again (``every_block``: each block owns a unit)."""
    U = (hidden + c - 1) // c
    if not (0 < hidden <= 256 and c in (1, 2, 4, 8) and rows > 0
            and rows % 4 == 0 and ((c - 1) * U < hidden or not every_block)
            and U * (rows // 4) <= 512):
        return -1
    tile = hidden if kind == "fwd" else 4 * hidden
    return (4 * hidden * U + 2 * tile * rows) * 4


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_lstm_cluster_mirror_check_against_source_layout(kind):
    rnn_cuda.check_lstm_cluster_mirror(
        lambda h, c, r: _lstm_cluster_source(kind, h, c, r), kind)
    other = "bwd" if kind == "fwd" else "fwd"
    with pytest.raises(RuntimeError, match="H=1, plan 1x4"):
        rnn_cuda.check_lstm_cluster_mirror(
            lambda h, c, r: _lstm_cluster_source(other, h, c, r), kind)
    with pytest.raises(RuntimeError, match="H=1, plan 2x4"):
        rnn_cuda.check_lstm_cluster_mirror(
            lambda h, c, r: _lstm_cluster_source(kind, h, c, r, False), kind)


def test_gru_mirror_check_covers_masked_slices():
    """``_check_mirror`` holds the masked rule too: a source that still
    demands a dividing cluster fails at the first masked plan."""
    def source(h, c, r, masked=True):
        if not gru_cuda._plan_rule("fwd", h, c, r) or (
                not masked and h % c):
            return -1
        return bigru_smem_bytes("fwd", h, c, r)

    class Lib:
        def __init__(self, masked):
            self.bigru_fwd_smem_bytes = (
                lambda h, c, r: source(h, c, r, masked))

    gru_cuda._check_mirror(Lib(True), "bigru_fwd")
    with pytest.raises(RuntimeError, match="H=9, plan 2x4"):
        gru_cuda._check_mirror(Lib(False), "bigru_fwd")


def test_cluster_routes_launch_and_record(fake_card):
    """H=256 launches the register cluster entries (pointers, B, N, H, C, R
    and a one-direction grid's reverse flag) with the planner's plan; the
    first cluster kernel's entries take the same arguments under a forced
    ("cluster", C, R) plan; a GRU width no dividing cluster fits launches a
    masked plan."""
    z = torch.zeros
    ins = (z(32, 5, 1024), z(32, 5, 1024), z(256, 1024), z(256, 1024))
    rnn_cuda.bilstm_fwd_cuda(*ins)
    name, args = fake_card.calls[-1]
    want = rnn_cuda.lstm_reg_plan("fwd", 32, 256, _reg_clusters)
    assert name == "bilstm_fwd_reg_f32"
    assert args[6:] == (32, 5, 256, *want)
    assert rnn_cuda.bilstm_fwd_cuda.last_launch == {
        "kernel": "reg", "cluster": want[0], "rows": want[1],
        "clusters": 2 * -(-32 // want[1]), "resident": _reg_clusters(*want)}
    old = rnn_cuda.lstm_cluster_plan("fwd", 32, 256, _clusters)
    rnn_cuda.bilstm_fwd_cuda(*ins, plan=("cluster", *old))
    name, args = fake_card.calls[-1]
    assert name == "bilstm_fwd_cluster_f32"
    assert args[6:] == (32, 5, 256, *old)
    assert rnn_cuda.bilstm_fwd_cuda.last_launch == {
        "kernel": "cluster", "cluster": old[0], "rows": old[1],
        "clusters": 2 * -(-32 // old[1]), "resident": 15}
    for plan, entry in ((None, "reg"), (("cluster", 4, 4), "cluster")):
        rnn_cuda.lstm_fwd_train_cuda(z(3, 5, 520, dtype=torch.bfloat16),
                                     z(130, 520), True, plan=plan)
        name, args = fake_card.calls[-1]
        assert name == f"lstm_fwd_train_{entry}_bf16" and args[-1] == 1
        assert args[5:8] == (3, 5, 130)
    bwd = _lstm_bwd_args(5, 4, 200)
    for plan, entry in ((None, "reg"), (("cluster", 4, 4), "cluster")):
        rnn_cuda.bilstm_bwd_cuda(*bwd, plan=plan)
        name, args = fake_card.calls[-1]
        assert name == f"bilstm_bwd_{entry}_f32" and args[10:13] == (5, 4,
                                                                     200)
    gru_cuda.bigru_fwd_cuda(*_bigru_args(32, 5, 139, torch.float32))
    last = gru_cuda.bigru_fwd_cuda.last_launch
    assert last["kernel"] == "cluster" and 139 % last["cluster"]


# ---------------------------------------------------------------------------
# The register cluster kernels (bilstm_fwd_reg_kernel, bilstm_bwd_reg_kernel):
# the route above the wide kernels, their plan rule and layout mirror, the
# planner on the card's counts, and every entry's launch and record
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,first", [("fwd", 119), ("bwd", 117)])
def test_reg_route_above_the_wide_kernels(kind, first):
    """The forward's widths 119..256 and the BPTT's 117..256 take the
    register cluster kernel; the unit and wide kernels keep theirs below;
    257 takes the stream kernel."""
    route = (lstm_fwd_kernel_route if kind == "fwd"
             else lstm_bwd_kernel_route)
    assert [route(h) for h in range(first, 257)] == ["reg"] * (257 - first)
    assert {route(h) for h in range(1, 65)} == {"unit"}
    assert {route(h) for h in range(65, first)} == {"wide"}
    assert route(257) == "stream"


def _reg_source(kind, hidden, c, rows, every_block=True, cells=True):
    """The sources' ``valid_reg_plan`` and ``bilstm_<kind>_reg_layout``
    (forward tiles of 1, 2 or 4 rows, the BPTT's also 8), written out
    again: (bytes, threads, units) or -1s (``every_block``:
    each block owns a unit; ``cells``: a BPTT thread loads at most 4 of
    the 7 inputs of a cell a step)."""
    if not (0 < hidden <= 256 and 1 <= c <= 16 and rows in (1, 2, 4, 8)
            and (kind == "bwd" or rows < 8)):
        return (-1, -1, -1)
    u = 1
    while u < -(-hidden // c):
        u *= 2
    if kind == "fwd":
        lanes = 8 if hidden <= 128 else 16
        U = max(u, 32 // lanes)
        threads = U * lanes
        tk = (max(c * U, 16 * lanes) + 3) // 4 * 4
        floats = 2 * rows * tk + 26 * rows * (U + 1)
    else:
        U = max(u, 8)
        threads = ((hidden + 1) // 2 * (U // 8) + 31) // 32 * 32
        rq = min(rows, 4)
        floats = ((rows // rq) * (U // 8) * (32 * rq + 4)
                  + 2 * c * U * rows + 26 * rows * (U + 1))
    if ((c - 1) * U >= hidden and every_block) or threads > 256 or (
            cells and kind == "bwd" and 7 * U * rows > 4 * threads) \
            or floats * 4 > 232448:
        return (-1, -1, -1)
    return (floats * 4, threads, U)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_reg_mirror_check_against_source_layout(kind):
    """``check_reg_mirror`` accepts the sources' layout query written out,
    and names the first plan of a source whose rule differs: the other
    kind's layout, a source that lets a block own no unit, and (the BPTT)
    one that lets a thread load more of a step's inputs."""
    layout = lambda w, h, c, r: _reg_source(kind, h, c, r)[w]  # noqa: E731
    rnn_cuda.check_reg_mirror(layout, kind)
    other = "bwd" if kind == "fwd" else "fwd"
    with pytest.raises(RuntimeError, match="H=1, plan 1x1"):
        rnn_cuda.check_reg_mirror(
            lambda w, h, c, r: _reg_source(other, h, c, r)[w], kind)
    with pytest.raises(RuntimeError, match="H=1, plan 2x1"):
        rnn_cuda.check_reg_mirror(
            lambda w, h, c, r: _reg_source(kind, h, c, r, False)[w], kind)
    if kind == "bwd":
        with pytest.raises(RuntimeError, match="H=1, plan 1x4"):
            rnn_cuda.check_reg_mirror(
                lambda w, h, c, r: _reg_source(kind, h, c, r,
                                               cells=False)[w], kind)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_reg_plans_from_card_counts(kind):
    """Blocks have at most 256 threads, so above H=128 the slices are 16
    units and the cluster 9 to 16 blocks (units a block are a power of
    two: one C = ceil(H / U) for each U). At the timing shape (32, 256,
    two directions) the BPTT's 8 clusters of 16 blocks of 8 rows make one
    wave where the card holds 8 such clusters, two where it holds 7, and
    still beat 16 clusters of 4 rows; the forward takes tiles of 4 rows at
    most. The reference lstm request (1, 128) takes one row and the
    cluster whose blocks have 128 threads."""
    plan = rnn_cuda.lstm_reg_plan
    rows = 8 if kind == "bwd" else 4
    assert plan(kind, 32, 256, _reg_clusters) == (16, rows)
    assert plan(kind, 32, 256, lambda c, r: 8) == (16, rows)
    assert plan(kind, 1, 128, _reg_clusters) == (8, 1)
    assert {c for c, _ in rnn_cuda.lstm_reg_plans(
        kind, 5, 130, _reg_clusters)} == {9}
    assert {c for c, _ in rnn_cuda.lstm_reg_plans(
        kind, 5, 128, _reg_clusters)} == {4, 8, 16}
    assert rnn_cuda.reg_units(kind, 256, 16) == 16
    assert rnn_cuda.reg_threads(kind, 256, 16) == 256
    assert not rnn_cuda.lstm_reg_plans(kind, 32, 256, lambda c, r: 0)
    with pytest.raises(ValueError, match="no plan"):
        plan(kind, 32, 256, lambda c, r: 0)


_REG_ENTRIES = {
    "bilstm_fwd": (6, False), "bilstm_fwd_train": (10, False),
    "lstm_fwd": (3, True), "lstm_fwd_train": (5, True),
    "bilstm_bwd": (10, False), "lstm_bwd": (5, True)}


def _reg_call(name, B, N, H, dtype, plan=None):
    """Call the wrapper ``name`` at (B, N, H) on zeros of ``dtype``."""
    z = torch.zeros
    fn = getattr(rnn_cuda, f"{name}_cuda")
    kw = {} if plan is None else {"plan": plan}
    if name.startswith("bilstm_fwd"):
        xg = z(B, N, 4 * H, dtype=dtype)
        fn(xg, xg.clone(), z(H, 4 * H), z(H, 4 * H), **kw)
    elif name.startswith("lstm_fwd"):
        fn(z(B, N, 4 * H, dtype=dtype), z(H, 4 * H), True, **kw)
    elif name == "bilstm_bwd":
        fn(*_lstm_bwd_args(B, N, H, dtype), **kw)
    else:
        fn(*_lstm_bwd_one(B, N, H, dtype), True, **kw)
    return fn


@pytest.mark.parametrize("name", sorted(_REG_ENTRIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reg_entries_launch_and_record(fake_card, name, dtype):
    """Each of the six wrappers at H=256 and 130 launches
    ``<name>_reg_<dtype>`` with its pointers, then B, N, H, C, R (and a
    one-direction grid's reverse flag), the planner's plan for its
    direction count, and records it; the count rises by one a launch."""
    n_ptr, one_dir = _REG_ENTRIES[name]
    kind = "bwd" if name.endswith("bwd") else "fwd"
    sfx = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    for B, H in ((32, 256), (5, 130)):
        dirs = 1 if one_dir else 2
        want = rnn_cuda.lstm_reg_plan(kind, B, H, _reg_clusters, dirs)
        fn = getattr(rnn_cuda, f"{name}_cuda")
        before = fn.launches
        _reg_call(name, B, 7, H, dtype)
        assert fn.launches == before + 1
        called, args = fake_card.calls[-1]
        assert called == f"{name}_reg_{sfx}"
        assert len(args) == n_ptr + 5 + int(one_dir)
        assert args[n_ptr:n_ptr + 5] == (B, 7, H, *want)
        if one_dir:
            assert args[-1] == 1
        assert fn.last_launch == {
            "kernel": "reg", "cluster": want[0], "rows": want[1],
            "clusters": dirs * -(-B // want[1]),
            "resident": _reg_clusters(*want)}


@pytest.mark.parametrize("name", sorted(_REG_ENTRIES))
def test_reg_and_old_cluster_plans_forced_or_refused(fake_card, name):
    """``plan=("reg", C, R)`` takes any register plan that fits, and
    ``("cluster", C, R)`` still reaches the first cluster kernel; a plan
    whose blocks exceed 256 threads, a tile not of (1, 2, 4, 8), a cluster
    over 16 blocks or one leaving a block without a unit is refused before
    any launch, as is an old-cluster plan that does not fit."""
    fn = _reg_call(name, 9, 7, 256, torch.float32, plan=("reg", 16, 2))
    assert fake_card.calls[-1][0] == f"{name}_reg_f32"
    assert (fn.last_launch["kernel"], fn.last_launch["cluster"],
            fn.last_launch["rows"]) == ("reg", 16, 2)
    assert fn.last_launch["clusters"] == 5 * (2 if name.startswith("bi")
                                              else 1)
    _reg_call(name, 9, 7, 256, torch.bfloat16, plan=("cluster", 8, 8))
    assert fake_card.calls[-1][0] == f"{name}_cluster_bf16"
    assert fn.last_launch["kernel"] == "cluster"
    n = len(fake_card.calls)
    for bad in (("reg", 8, 8), ("reg", 16, 3), ("reg", 17, 1),
                ("reg", 12, 1), ("cluster", 4, 4)):
        with pytest.raises(ValueError, match="does not fit"):
            _reg_call(name, 9, 7, 256, torch.float32, plan=bad)
    assert len(fake_card.calls) == n


# ---------------------------------------------------------------------------
# The stream kernels (the first cluster kernels reading W_hh from global
# memory every step): every width to H=1024 gets a route, today's picks
# stay; their plan rule, mirror, planner and launches; the float32 BiGRU at
# H <= 64 on the unit kernels
# ---------------------------------------------------------------------------

def _before_gru_route(kind, hidden, dirs, dtype):
    """The GRU routes as they were: unit for one direction at H <= 64, tc
    for bf16 two-direction launches where a tc plan fits, else cluster."""
    if dirs == 1 and hidden <= 64:
        return "unit"
    if dirs == 2 and dtype == torch.bfloat16 and any(
            gru_cuda.tc_plan_fits(kind, hidden, c, r)
            for c in gru_cuda.TC_CLUSTER_SIZES for r in gru_cuda.TC_ROWS):
        return "tc"
    return "cluster"


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_every_width_to_1024_has_a_route(family):
    """Every H from 1 to 1024 (d_model 2048), forward and BPTT, one and two
    directions, float32 and bf16, gets a route on the H100's counts; up to
    H=256 every pick of before stays but the BiGRU's at H <= 64 (now the
    unit kernel), and above it every width a cluster plan took keeps it;
    the stream route has a plan in each direction count and dtype."""
    for hidden in range(1, 1025):
        for kind in ("fwd", "bwd"):
            if family == "lstm":
                route = (lstm_fwd_kernel_route if kind == "fwd"
                         else lstm_bwd_kernel_route)(hidden)
                before = _before_lstm_route(kind, hidden) or (
                    "reg" if hidden <= 256 else None)
                if before is not None:
                    assert route == before, (kind, hidden)
                else:
                    assert route == "stream", (kind, hidden)
                    for dirs in (1, 2)[:1 + (hidden % 61 == 0)]:
                        for wbytes in (4, 2):
                            assert rnn_cuda.stream_plans(
                                f"bilstm_{kind}", 32, hidden,
                                _stream_clusters, dirs, wbytes), hidden
                continue
            route_fn = (gru_fwd_kernel_route if kind == "fwd"
                        else gru_bwd_kernel_route)
            for dtype in (torch.float32, torch.bfloat16):
                for dirs in (1, 2):
                    route = route_fn(hidden, dirs, dtype)
                    before = _before_gru_route(kind, hidden, dirs, dtype)
                    if hidden <= 64:
                        assert route == "unit", (kind, hidden)
                    elif before != "cluster" or hidden <= 256 or \
                            _before_bigru_plans(kind, 32, hidden, _clusters,
                                                dirs):
                        assert route == before, (kind, hidden, dtype, dirs)
                    elif hidden % 61:
                        assert route == "stream", (kind, hidden, dirs)
                    else:   # the plans' existence at one width in 61
                        assert route == "stream", (kind, hidden, dirs)
                        assert gru_cuda.bigru_stream_plans(
                            kind, 32, hidden, _stream_clusters, dirs,
                            dtype.itemsize), (kind, hidden)


@pytest.mark.parametrize("source", sorted(rnn_cuda.STREAM_GATES))
def test_stream_plans_fit_a_block_and_the_cluster_bound(source):
    """Every plan the stream planner offers (B=1, 5, 32, 128; H=257 to
    1024) has at most 16 blocks, each owning a unit, at most 512 threads,
    and an exchange tile of (gates x H rows, padded to chunks of 8) x R
    float32 in a block's shared memory; the largest width is H=1816 for
    the LSTM BPTT (a 4H-row dg tile at 4 rows), past it the route raises
    naming the width and the card's limit."""
    gates = rnn_cuda.STREAM_GATES[source]
    for hidden in (257, 260, 300, 320, 384, 511, 512, 640, 760, 1000, 1024):
        for batch in (1, 5, 32, 128):
            plans = rnn_cuda.stream_plans(source, batch, hidden,
                                          _stream_clusters)
            assert plans, (hidden, batch)
            for c, rows in plans:
                U = -(-hidden // c)
                assert 1 <= c <= 16 and (c - 1) * U < hidden
                assert U * (rows // 4) <= 512 and rows % 4 == 0
                tile = -(-gates * hidden // 8) * 8
                assert rnn_cuda.stream_smem_bytes(source, hidden, rows) \
                    == 2 * tile * rows * 4 <= rnn_cuda.MAX_SMEM_BYTES
    lstm_bwd = "bilstm_bwd"
    assert rnn_cuda.stream_smem_bytes(lstm_bwd, 1816, 4) \
        <= rnn_cuda.MAX_SMEM_BYTES
    assert rnn_cuda.stream_smem_bytes(lstm_bwd, 1817, 4) \
        > rnn_cuda.MAX_SMEM_BYTES
    assert lstm_bwd_kernel_route(1816) == "stream"
    with pytest.raises(ValueError, match="H=1817.*H100"):
        lstm_bwd_kernel_route(1817)


def test_stream_planner_weighs_fma_against_l2():
    """At (32, 500, 512) f32 the LSTM forward takes 16 blocks a cluster
    (the least W_hh a block reads) over 16-row tiles (a block's FMA issue
    and its L2 bytes even; 8 rows read W_hh twice as often over the card,
    12 rows walk 4 past the batch); at B=1 one 4-row tile; a plan the card
    runs none of is dropped."""
    plan = rnn_cuda.stream_plans
    assert plan("bilstm_fwd", 32, 512, _stream_clusters)[0] == (16, 16)
    assert plan("bilstm_fwd", 1, 512, _stream_clusters)[0] == (16, 4)
    assert (16, 16) not in plan(
        "bilstm_fwd", 32, 512,
        lambda c, r: 0 if (c, r) == (16, 16) else _stream_clusters(c, r))
    assert not plan("bilstm_fwd", 32, 512, lambda c, r: 0)


def _stream_source(source, hidden, c, rows, max_c=16):
    """The sources' ``<source>_stream_smem_bytes`` written out again."""
    gates = rnn_cuda.STREAM_GATES[source]
    U = -(-hidden // c)
    if not (hidden > 0 and 1 <= c <= max_c and rows > 0 and rows % 4 == 0
            and (c - 1) * U < hidden and U * (rows // 4) <= 512):
        return -1
    smem = 2 * (-(-gates * hidden // 8) * 8) * rows * 4
    return smem if smem <= 232448 else -1


@pytest.mark.parametrize("source", sorted(rnn_cuda.STREAM_GATES))
def test_stream_mirror_check_against_source_layout(source):
    """``check_stream_mirror`` accepts the sources' query written out, and
    names the first plan of a source that takes no cluster above 8 blocks
    or lays out another source's tile."""
    rnn_cuda.check_stream_mirror(
        lambda h, c, r: _stream_source(source, h, c, r), source)
    with pytest.raises(RuntimeError, match="H=64, plan 10x4"):
        rnn_cuda.check_stream_mirror(
            lambda h, c, r: _stream_source(source, h, c, r, max_c=8), source)
    other = "bigru_bwd" if source != "bigru_bwd" else "bilstm_bwd"
    with pytest.raises(RuntimeError, match="_stream: the wrapper"):
        rnn_cuda.check_stream_mirror(
            lambda h, c, r: _stream_source(other, h, c, r), source)


def test_bwd_weights_transposed_for_the_stream_kernel():
    """The stream BPTT reads W_hh^T (consecutive threads on consecutive
    units): a contiguous transposed copy; every other kernel W_hh."""
    w = torch.arange(12.0).reshape(2, 6)
    (wt,) = rnn_cuda.bwd_weights("stream", [w])
    assert wt.is_contiguous() and torch.equal(wt, w.t())
    assert rnn_cuda.bwd_weights("cluster", [w])[0] is w


_STREAM_LSTM = dict(_REG_ENTRIES)
_STREAM_GRU = {"bigru_fwd": (8, False), "bigru_fwd_train": (12, False),
               "bigru_bwd": (14, False), "gru_fwd": (4, True),
               "gru_fwd_train": (6, True), "gru_bwd": (7, True)}


def _gru_call(name, B, N, H, dtype, plan=None):
    """Call the GRU wrapper ``name`` at (B, N, H) on zeros of ``dtype``."""
    kw = {} if plan is None else {"plan": plan}
    fn = getattr(gru_cuda, f"{name}_cuda")
    if name.startswith("bigru_fwd"):
        fn(*_bigru_args(B, N, H, dtype), **kw)
    elif name == "bigru_bwd":
        fn(*_bigru_bwd_args(B, N, H, dtype), **kw)
    elif name.startswith("gru_fwd"):
        fn(*_gru_args(B, N, H, dtype), True, **kw)
    else:
        fn(*_bwd_args(B, N, H, dtype), True, **kw)
    return fn


@pytest.mark.parametrize("name", sorted(_STREAM_LSTM) + sorted(_STREAM_GRU))
def test_stream_entries_launch_and_record(fake_card, name):
    """Each of the twelve wrappers at H=384 in f32 and 512 in bf16 (no
    cluster plan of the GRU fits either) launches ``<name>_stream_<dtype>``
    with its pointers, then B, N, H, C, R (and a one-direction grid's
    reverse flag), the stream planner's plan for its direction count and
    dtype, and records it; the count rises by one a launch; a forced
    ("stream", C, R) is taken, one that does not fit refused before any
    launch."""
    lstm = name in _STREAM_LSTM
    n_ptr, one_dir = (_STREAM_LSTM if lstm else _STREAM_GRU)[name]
    source = (("bilstm_bwd" if name.endswith("bwd") else "bilstm_fwd")
              if lstm else ("bigru_bwd" if name.endswith("bwd")
                            else "bigru_fwd"))
    call = _reg_call if lstm else _gru_call
    dirs = 1 if one_dir else 2
    for B, H, dtype in ((32, 384, torch.float32), (5, 512, torch.bfloat16)):
        sfx = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        want = rnn_cuda.stream_plans(source, B, H, _stream_clusters, dirs,
                                     dtype.itemsize)[0]
        fn = getattr(rnn_cuda if lstm else gru_cuda, f"{name}_cuda")
        before = fn.launches
        call(name, B, 1, H, dtype)
        assert fn.launches == before + 1
        called, args = fake_card.calls[-1]
        assert called == f"{name}_stream_{sfx}"
        assert len(args) == n_ptr + 5 + int(one_dir)
        assert args[n_ptr:n_ptr + 5] == (B, 1, H, *want)
        if one_dir:
            assert args[-1] == 1
        assert fn.last_launch == {
            "kernel": "stream", "cluster": want[0], "rows": want[1],
            "clusters": dirs * -(-B // want[1]),
            "resident": _stream_clusters(*want)}
    call(name, 9, 1, 512, dtype, plan=("stream", 12, 8))
    assert fake_card.calls[-1][1][n_ptr:n_ptr + 5] == (9, 1, 512, 12, 8)
    n = len(fake_card.calls)
    for bad in (("stream", 17, 4), ("stream", 16, 6), ("stream", 1, 8)):
        with pytest.raises(ValueError, match="does not fit"):
            call(name, 9, 1, 512, dtype, plan=bad)
    assert len(fake_card.calls) == n


def test_bigru_float32_two_directions_take_the_unit_kernels(fake_card):
    """The ``bigru`` model's default launches, (20, N, 64) f32 two
    directions: ``bigru_fwd_unit_f32`` (8 pointers, B, N, H, R),
    ``bigru_fwd_unit_train_f32`` (12 pointers) and ``bigru_bwd_unit_f32``
    (14 pointers: both directions in one launch), the unit planner's tile
    over 2 x ceil(B / R) blocks, recorded; ("unit", R) forces a tile, (C,
    R) the first cluster design; bf16 at H=64 takes the unit kernels
    too."""
    f32 = torch.float32
    for fn, n_ptr, entry, args in (
            (gru_cuda.bigru_fwd_cuda, 8, "bigru_fwd_unit",
             _bigru_args(20, 5, 64, f32)),
            (gru_cuda.bigru_fwd_train_cuda, 12, "bigru_fwd_unit_train",
             _bigru_args(20, 5, 64, f32)),
            (gru_cuda.bigru_bwd_cuda, 14, "bigru_bwd_unit",
             _bigru_bwd_args(20, 5, 64, f32))):
        before = fn.launches
        fn(*args)
        assert fn.launches == before + 1
        called, got = fake_card.calls[-1]
        assert called == f"{entry}_f32" and len(got) == n_ptr + 4
        assert got[n_ptr:] == (20, 5, 64, 1)
        assert fn.last_launch == {"kernel": "unit", "cluster": 1, "rows": 1,
                                  "clusters": 40, "resident": 264}
        fn(*args, plan=("unit", 4))
        assert fake_card.calls[-1][1][n_ptr:] == (20, 5, 64, 4)
        assert fn.last_launch["clusters"] == 10
        fn(*args, plan=(4, 4))
        called, got = fake_card.calls[-1]
        assert "unit" not in called and got[n_ptr:] == (20, 5, 64, 4, 4)
        assert fn.last_launch["kernel"] == "cluster"
        with pytest.raises(ValueError, match="unit kernel"):
            big = (_bigru_bwd_args if n_ptr == 14 else _bigru_args)(
                4, 5, 96, f32)
            fn(*big, plan=("unit", 1))
    assert gru_fwd_kernel_route(64, 2, torch.bfloat16) == "unit"
    assert gru_bwd_kernel_route(64, 2, torch.bfloat16) == "unit"
