"""Launch planning of the forward recurrences, on the CPU: which kernel of
``csrc/bilstm_fwd.cu`` / ``csrc/bigru_fwd.cu`` takes a shape, the unit
kernels' batch tile from the card's counts (fake H100 counts here: 132 SMs),
the wrappers' mirrors of the sources' layouts, and what each wrapper
launches and records in ``last_launch`` (the kernel library and the launch
replaced by fakes that record the call)."""

import pytest
import torch

from room_slam_torch.ops import gru_cuda, rnn_cuda
from room_slam_torch.ops.gru_cuda import bigru_plan, gru_fwd_kernel_route
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
