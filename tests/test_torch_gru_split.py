"""#10, the split BiGRU BPTT, on #6's route, on the CPU: at every width
#6's two-direction BPTT takes, ``bigru_bwd_split_cuda`` launches the same
kernel at the same plan as ``bigru_bwd_cuda`` (its kSplitCoef entry,
``bigru_bwd_split_*``), its first design stays reachable only by a forced
cluster plan, and above #6's pipe widths it keeps the first design (which
takes no such width); ``tools/bench_bigru_bwd.py``'s ``--tiles`` parser
takes kernel-named plans and refuses plans that do not fit. The kernel
libraries, the card's counts and the launch are fakes that record the
call (fake H100 counts, as ``tests/test_torch_plan.py``'s)."""

import functools

import pytest
import torch

from room_slam_torch.ops import gru_cuda, rnn_cuda
from room_slam_torch.tools import bench_bigru_bwd

H100_SMS = 132


def _clusters(c, rows):
    """Resident clusters of 1 to 16 blocks on an H100 (7 of the
    non-portable sizes above 8)."""
    return 120 // c if c <= 8 else 7


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' device check, kernel libraries, card counts and
    launch replaced: CPU tensors pass as on a card of 132 SMs; the launch
    records the entry's name and arguments."""
    calls = []
    cpu = torch.device("cpu")
    monkeypatch.setattr(gru_cuda, "_check_cuda", lambda *a: cpu)
    monkeypatch.setattr(gru_cuda, "_library", lambda name: name)
    monkeypatch.setattr(gru_cuda, "launch",
                        lambda lib, name, dev, *args: calls.append(
                            (name, args)))
    monkeypatch.setattr(rnn_cuda, "_unit_counts",
                        lambda *a: (H100_SMS, lambda rows: 2))
    for name in ("_resident", "_stream_resident", "_pipe_resident",
                 "_reg_resident"):
        monkeypatch.setattr(gru_cuda, name, lambda *a: ("lib", _clusters))
    monkeypatch.setattr(gru_cuda, "_tc_resident",
                        lambda *a: ("lib", lambda c, rows: 30 // (c // 4),
                                    H100_SMS))
    monkeypatch.setattr(rnn_cuda, "_UNIT_PLANS", {})
    monkeypatch.setattr(gru_cuda, "_PLANS", {})
    return calls


def _args(B, H, dtype):
    """``bigru_bwd_cuda``'s arguments at (B, N=2, H): W_hh of both
    directions, then gs, hn, ys, dy of each."""
    z = torch.zeros
    one = (z(B, 2, 3 * H, dtype=dtype), *(z(B, 2, H, dtype=dtype)
                                          for _ in range(3)))
    return (z(H, 3 * H), z(H, 3 * H), *one, *one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_launches_bwd_route_at_every_width(fake_card, monkeypatch,
                                                 dtype):
    """At H 1-1024 and a batch of 1 and of 128 (one grid and the scale-up
    batch's), #10 launches #6's kernel (``gru_bwd_kernel_route``) at #6's
    plan with the same arguments, on its own entry: ``bigru_bwd_split_*``
    where #6 launches ``bigru_bwd_*``. (The route, a pure function, is
    cached, and W_hh passed unpacked, to keep the sweep short.)"""
    monkeypatch.setattr(gru_cuda, "gru_bwd_kernel_route", functools.lru_cache(
        None)(gru_cuda.gru_bwd_kernel_route))
    monkeypatch.setattr(gru_cuda, "bwd_weights", lambda kernel, w, c: w)
    kernels = set()
    for H in range(1, 1025):
        for B in (1, 128):
            args = _args(B, H, dtype)
            gru_cuda.bigru_bwd_cuda(*args)
            name6, args6 = fake_card[-1]
            gru_cuda.bigru_bwd_split_cuda(*args)
            name10, args10 = fake_card[-1]
            kernel = gru_cuda.bigru_bwd_cuda.last_launch["kernel"]
            assert kernel == gru_cuda.gru_bwd_kernel_route(H, 2, dtype)
            assert gru_cuda.bigru_bwd_split_cuda.last_launch == \
                gru_cuda.bigru_bwd_cuda.last_launch, (H, B)
            assert name10 == name6.replace("bigru_bwd", "bigru_bwd_split")
            assert name10 != name6 and args10[14:] == args6[14:], (H, B)
            kernels.add(kernel)
    want = {"unit", "reg", "pipe"}
    assert kernels == (want | {"tc"} if dtype == torch.bfloat16 else want)


def test_split_first_design_forced_only(fake_card):
    """The first design (the split kind of the first cluster kernel) takes
    a forced cluster plan, bare or named; #10 has no stream kernel, and at
    #6's stream widths (above H=1024) it keeps the first design, which no
    cluster plan fits there: both raise naming the kernel."""
    for plan in (("cluster", 8, 20), (8, 20)):
        gru_cuda.bigru_bwd_split_cuda(*_args(128, 256, torch.bfloat16),
                                      plan=plan)
        assert fake_card[-1][0] == "bigru_bwd_split_bf16"
        assert fake_card[-1][1][-2:] == (8, 20)
        assert gru_cuda.bigru_bwd_split_cuda.last_launch["kernel"] == \
            "cluster"
    gru_cuda.bigru_bwd_split_cuda(*_args(16, 256, torch.bfloat16),
                                  plan=("tc", 8, 16))
    assert fake_card[-1][0] == "bigru_bwd_split_tc_bf16"
    gru_cuda.bigru_bwd_split_cuda(*_args(16, 64, torch.float32),
                                  plan=("unit", 2))
    assert fake_card[-1][0] == "bigru_bwd_split_unit_f32"
    assert fake_card[-1][1][-1] == 2
    with pytest.raises(ValueError, match="no stream kernel"):
        gru_cuda.bigru_bwd_split_cuda(*_args(4, 512, torch.float32),
                                      plan=("stream", 16, 4))
    assert gru_cuda.gru_bwd_kernel_route(1100, 2, torch.float32) == "stream"
    with pytest.raises(ValueError, match="no cluster"):
        gru_cuda.bigru_bwd_split_cuda(*_args(4, 1100, torch.float32))
    gru_cuda.bigru_bwd_cuda(*_args(4, 1100, torch.float32))
    assert fake_card[-1][0] == "bigru_bwd_stream_f32"


def test_tool_tiles_parser():
    """``--tiles`` takes CxR (a plan of the route's kernel) and
    kernel-named plans (the unit kernel's with C = 1), and refuses an
    unknown kernel or a plan that does not fit its kernel."""
    parse = bench_bigru_bwd.parse_tiles
    assert parse("4x16,tc8x32,cluster8x20,reg16x8,pipe16x12", 128, 256) == [
        ("tc", 4, 16), ("tc", 8, 32), ("cluster", 8, 20), ("reg", 16, 8),
        ("pipe", 16, 12)]
    assert parse("1x2,unit1x4", 20, 64) == [("unit", 2), ("unit", 4)]
    assert bench_bigru_bwd.plan_tile(("unit", 4)) == "1x4"
    assert bench_bigru_bwd.plan_tile(("tc", 4, 16)) == "4x16"
    for spec in ("tc2x16",       # 256 units over 2 blocks: 32 warps a block
                 "tc4x24",       # not one or two m16 tiles
                 "cluster3x4",   # no cluster of 3 blocks
                 "unit1x4",      # the unit kernel stops at H=64
                 "unit2x4",      # its cluster is one block
                 "reg16x3",      # a register tile of 3 rows
                 "wide4x4", "4by16"):
        with pytest.raises(ValueError, match="--tiles"):
            parse(spec, 128, 64 if spec == "unit2x4" else 256)
    cpu = torch.device("cpu")
    assert bench_bigru_bwd._tiles("auto", cpu, 5, 16) == ("plain", [None])
    with pytest.raises(ValueError, match="plain"):
        bench_bigru_bwd._tiles("tc4x16", cpu, 5, 16)
