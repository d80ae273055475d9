"""BiLSTM CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA card. On the card run
``python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest``.

Tolerances. Forward: max abs error 1e-4 on h and c and the gates (h and the
gates are bounded by 1; c by the step count). The kernel and cuBLAS sum
each dot product in different orders, and the difference travels down up
to 1500 dependent steps. Gradients: max relative error (max abs error over
the reference's max abs value) 1e-4, the JAX suite's bound for its Pallas
BPTT against autograd through the scan.
"""

import copy
from unittest import mock

import numpy as np
import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from room_slam_torch.ops import rnn_cuda

pytestmark = pytest.mark.gpu

ATOL = 1e-4
GRAD_REL = 1e-4
SHAPES = [(32, 500, 64), (20, 1500, 64), (5, 43, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, N, H, device, seed=0):
    g = np.random.default_rng(seed)
    arrs = [(g.normal(size=(B, N, 4 * H)) * 0.5),
            (g.normal(size=(B, N, 4 * H)) * 0.5),
            g.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H),
            g.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H)]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrs]


def _max_rel(a, b):
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


@pytest.mark.parametrize("shape", [(32, 500, 64), (1, 1500, 64),
                                   (5, 43, 64)])
def test_kernel_matches_plain(cuda, shape):
    ins = _inputs(*shape, cuda)
    before = rnn_cuda.bilstm_fwd_cuda.launches
    got = rnn_cuda.bilstm_recurrence(*ins)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_fwd_cuda.launches == before + 1
    ref = rnn_cuda.bilstm_recurrence_plain(*ins)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        err = (a - b).abs().max().item()
        assert err <= ATOL, err


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_train_kernel_matches_plain(cuda, shape):
    ins = _inputs(*shape, cuda)
    before = rnn_cuda.bilstm_fwd_train_cuda.launches
    got = rnn_cuda.bilstm_fwd_train(*ins)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_fwd_train_cuda.launches == before + 1
    ref = rnn_cuda.bilstm_fwd_train_plain(*ins)
    for a, b in zip(got, ref):       # ys_f, ys_b, cs_f, cs_b, gs_f, gs_b
        assert a.shape == b.shape and torch.isfinite(a).all()
        err = (a - b).abs().max().item()
        assert err <= ATOL, err


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_kernel_matches_plain(cuda, shape):
    ins = _inputs(*shape, cuda)
    ys_f, ys_b, cs_f, cs_b, gs_f, gs_b = rnn_cuda.bilstm_fwd_train_plain(*ins)
    g = torch.Generator(cuda).manual_seed(1)
    dy_f = torch.randn(ys_f.shape, device=cuda, generator=g)
    dy_b = torch.randn(ys_b.shape, device=cuda, generator=g)
    args = (ins[2], ins[3], gs_f, cs_f, dy_f, gs_b, cs_b, dy_b)
    before = rnn_cuda.bilstm_bwd_cuda.launches
    got = rnn_cuda.bilstm_bwd(*args)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_bwd_cuda.launches == before + 1
    ref = rnn_cuda.bilstm_bwd_plain(*args)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert _max_rel(a, b) <= GRAD_REL, _max_rel(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_grads_match_autograd(cuda, shape):
    """All four gradients of the kernel path against torch autograd through
    the plain loop, for one fixed upstream gradient."""
    ins = [t.requires_grad_(True) for t in _inputs(*shape, cuda)]
    g = torch.Generator(cuda).manual_seed(2)
    counts = (rnn_cuda.bilstm_fwd_cuda.launches,
              rnn_cuda.bilstm_fwd_train_cuda.launches,
              rnn_cuda.bilstm_bwd_cuda.launches)
    ys = rnn_cuda.bilstm_recurrence(*ins)
    dys = [torch.randn(y.shape, device=cuda, generator=g) for y in ys]
    got = torch.autograd.grad(ys, ins, dys)
    torch.cuda.synchronize()
    assert (rnn_cuda.bilstm_fwd_cuda.launches,
            rnn_cuda.bilstm_fwd_train_cuda.launches,
            rnn_cuda.bilstm_bwd_cuda.launches) == (counts[0], counts[1] + 1,
                                                   counts[2] + 1)
    ref = torch.autograd.grad(rnn_cuda.bilstm_recurrence_plain(*ins), ins,
                              dys)
    for name, a, b in zip(("dxg_f", "dxg_b", "dW_f", "dW_b"), got, ref):
        assert torch.isfinite(a).all(), name
        assert _max_rel(a, b) <= GRAD_REL, (name, _max_rel(a, b))


def test_kernel_refuses_grad(cuda):
    """With grad on, an input that needs a gradient never reaches the
    light kernel: the training forward and the backward kernel run instead.
    Under no_grad the same inputs launch the light kernel."""
    ins = _inputs(2, 5, 64, cuda)
    ins[2].requires_grad_(True)
    light = rnn_cuda.bilstm_fwd_cuda.launches
    train = rnn_cuda.bilstm_fwd_train_cuda.launches
    ys = rnn_cuda.bilstm_recurrence(*ins)
    (ys[0].sum() + ys[1].sum()).backward()
    assert rnn_cuda.bilstm_fwd_cuda.launches == light
    assert rnn_cuda.bilstm_fwd_train_cuda.launches == train + 1
    assert ins[2].grad is not None and torch.isfinite(ins[2].grad).all()
    with torch.no_grad():
        rnn_cuda.bilstm_recurrence(*ins)
    assert rnn_cuda.bilstm_fwd_cuda.launches == light + 1


def test_kernel_rejects_float64(cuda):
    ins = [t.double() for t in _inputs(2, 5, 64, cuda)]
    with pytest.raises(TypeError):
        rnn_cuda.bilstm_recurrence(*ins)


def test_new_kernels_raise_on_bad_inputs(cuda):
    """Wrong dtype, shape or device raises; nothing falls back to the plain
    version."""
    ins = _inputs(2, 5, 64, cuda)
    with pytest.raises(TypeError):
        rnn_cuda.bilstm_fwd_train_cuda(*[t.double() for t in ins])
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_fwd_train_cuda(ins[0], ins[1][:, :4], *ins[2:])
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_fwd_train(ins[0], ins[1].cpu(), *ins[2:])
    ys_f, ys_b, cs_f, cs_b, gs_f, gs_b = rnn_cuda.bilstm_fwd_train(*ins)
    args = [ins[2], ins[3], gs_f, cs_f, ys_f, gs_b, cs_b, ys_b]
    with pytest.raises(TypeError):
        rnn_cuda.bilstm_bwd_cuda(*[a.double() for a in args])
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_bwd_cuda(*args[:4], ys_f[:, :4], *args[5:])
    with pytest.raises(ValueError):
        rnn_cuda.bilstm_bwd(*args[:7], ys_b.cpu())
    # above every LSTM BPTT route's width (the pipe kernel is routed where
    # the first stream design's dg tile of 4H rows fits a block, to H=1816)
    H = 1817
    z = [torch.zeros(1, 3, d, device=cuda) for d in (4 * H, H, H)]
    w = torch.zeros(H, 4 * H, device=cuda)
    with pytest.raises(ValueError, match="H=1817"):
        rnn_cuda.bilstm_bwd_cuda(w, w, *z, *z)


# ---------------------------------------------------------------------------
# BiGRU kernels (csrc/bigru_fwd.cu, csrc/bigru_bwd.cu): W_hh split across a
# thread-block cluster at H=256. float32: values max abs error 1e-4,
# gradients max-rel 1e-4; bfloat16 streams: values rtol 0.05 / atol 0.03,
# gradients max-rel 0.1 (the JAX suite's bf16 bounds; kernel and plain
# version round at the same points, and a sum order that flips one rounding
# moves a value by one bf16 ulp).
# ---------------------------------------------------------------------------

from room_slam_torch.ops import gru_cuda  # noqa: E402

GRU_CASES = [((5, 43, 16), torch.float32), ((5, 43, 16), torch.bfloat16),
             ((16, 300, 256), torch.float32), ((128, 200, 256), torch.bfloat16)]


def _gru_inputs(B, N, H, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    xs = [torch.tensor(g.normal(size=(B, N, 3 * H)) * 0.5,
                       dtype=torch.float32, device=device).to(dtype)
          for _ in range(2)]
    ws = [torch.tensor(g.uniform(-1, 1, size=s) / np.sqrt(H),
                       dtype=torch.float32, device=device)
          for s in ((H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    return [xs[0], xs[1], *ws]


def _assert_close(a, b, dtype):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.isfinite(a).all()
    if dtype == torch.float32:
        assert (a - b).abs().max().item() <= ATOL
    else:
        torch.testing.assert_close(a.float(), b.float(), rtol=0.05, atol=0.03)


@pytest.mark.parametrize("shape,dtype", GRU_CASES)
def test_bigru_fwd_kernels_match_plain(cuda, shape, dtype):
    ins = _gru_inputs(*shape, dtype, cuda)
    counts = (gru_cuda.bigru_fwd_cuda.launches,
              gru_cuda.bigru_fwd_train_cuda.launches)
    light = gru_cuda.bigru_recurrence(*ins)
    train = gru_cuda.bigru_fwd_train(*ins)
    torch.cuda.synchronize()
    assert (gru_cuda.bigru_fwd_cuda.launches,
            gru_cuda.bigru_fwd_train_cuda.launches) == (counts[0] + 1,
                                                        counts[1] + 1)
    for a, b in zip(light, gru_cuda.bigru_fwd_plain(*ins)):
        _assert_close(a, b, dtype)
    for a, b in zip(train, gru_cuda.bigru_fwd_train_plain(*ins)):
        _assert_close(a, b, dtype)


@pytest.mark.parametrize("shape,dtype", GRU_CASES)
def test_bigru_bwd_kernel_matches_plain(cuda, shape, dtype):
    ins = _gru_inputs(*shape, dtype, cuda)
    ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = gru_cuda.bigru_fwd_train_plain(*ins)
    g = torch.Generator(cuda).manual_seed(1)
    dy_f, dy_b = (torch.randn(ys_f.shape, device=cuda, generator=g).to(dtype)
                  for _ in range(2))
    args = (ins[2], ins[4], gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)
    before = gru_cuda.bigru_bwd_cuda.launches
    got = gru_cuda.bigru_bwd(*args)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_bwd_cuda.launches == before + 1
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for a, b in zip(got, gru_cuda.bigru_bwd_plain(*args)):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert _max_rel(a.float(), b.float()) <= bound


@pytest.mark.parametrize("shape,dtype", GRU_CASES)
def test_bigru_function_grads_match_autograd(cuda, shape, dtype):
    """All six gradients of the kernel path against torch autograd through
    the plain loop, for one fixed upstream gradient."""
    ins = [t.requires_grad_(True) for t in _gru_inputs(*shape, dtype, cuda)]
    g = torch.Generator(cuda).manual_seed(2)
    ys = gru_cuda.bigru_recurrence(*ins)
    dys = [torch.randn(y.shape, device=cuda, generator=g).to(dtype)
           for y in ys]
    got = torch.autograd.grad(ys, ins, dys)
    ref = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*ins), ins, dys)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for name, a, b in zip(("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b", "db_b"),
                          got, ref):
        assert a.dtype == b.dtype and torch.isfinite(a).all(), name
        assert _max_rel(a.float(), b.float()) <= bound, (name, _max_rel(
            a.float(), b.float()))


def test_bigru_cluster_launches(cuda):
    """The scale-up shape (B=128, H=256) runs on clusters of several
    blocks, and the planner, told how many clusters the card holds at once,
    picks a grid that runs in one wave."""
    ins = _gru_inputs(128, 3, 256, torch.bfloat16, cuda)
    ys = gru_cuda.bigru_fwd_train_cuda(*ins)
    gru_cuda.bigru_bwd_cuda(ins[2], ins[4], ys[2], ys[4], ys[0], ys[0],
                            ys[3], ys[5], ys[1], ys[1])
    torch.cuda.synchronize()
    for fn in (gru_cuda.bigru_fwd_train_cuda, gru_cuda.bigru_bwd_cuda):
        last = fn.last_launch
        assert last["cluster"] >= 4, last
        assert last["resident"] >= last["clusters"], last
    with pytest.raises(TypeError):
        gru_cuda.bigru_fwd_cuda(*[t.half() if t.dim() == 3 else t
                                  for t in ins])


# ---------------------------------------------------------------------------
# Single-direction kernels: the GRU ones (gru_fwd, gru_fwd_train, gru_bwd)
# are csrc/bigru_*.cu with a grid of one direction, the LSTM ones
# (lstm_fwd, lstm_fwd_train, lstm_bwd, float32) csrc/bilstm_*.cu. Both
# walk orders; tolerances as above.
# ---------------------------------------------------------------------------

SINGLE_GRU_CASES = [((32, 500, 64), torch.float32),
                    ((5, 43, 16), torch.float32),
                    ((5, 43, 16), torch.bfloat16),
                    ((8, 300, 256), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", SINGLE_GRU_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_single_kernels_match_plain(cuda, shape, dtype, reverse):
    xg, _, w, b, _, _ = _gru_inputs(*shape, dtype, cuda)
    counts = (gru_cuda.gru_fwd_cuda.launches,
              gru_cuda.gru_fwd_train_cuda.launches,
              gru_cuda.gru_bwd_cuda.launches)
    with torch.no_grad():
        light = gru_cuda.gru_recurrence_kernel(xg, w, b, reverse)
    train = gru_cuda.gru_fwd_train(xg, w, b, reverse)
    ref = gru_cuda.gru_fwd_train_plain(xg, w, b, reverse)
    _assert_close(light, ref[0], dtype)
    for a, r in zip(train, ref):
        _assert_close(a, r, dtype)
    dy = torch.randn(ref[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1)).to(dtype)
    got = gru_cuda.gru_bwd(w, *ref[1:], ref[0], dy, reverse)
    torch.cuda.synchronize()
    assert (gru_cuda.gru_fwd_cuda.launches,
            gru_cuda.gru_fwd_train_cuda.launches,
            gru_cuda.gru_bwd_cuda.launches) == tuple(c + 1 for c in counts)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for a, r in zip(got, gru_cuda.gru_bwd_plain(w, *ref[1:], ref[0], dy,
                                                reverse)):
        assert a.dtype == r.dtype and torch.isfinite(a).all()
        assert _max_rel(a.float(), r.float()) <= bound
    if shape[-1] == 256:       # W_hh of H=256 is split across a cluster
        assert gru_cuda.gru_fwd_train_cuda.last_launch["cluster"] > 1


@pytest.mark.parametrize("shape,dtype", SINGLE_GRU_CASES[:3])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_function_grads_match_autograd(cuda, shape, dtype, reverse):
    """``GRUFunction``'s three gradients against torch autograd through the
    plain loop."""
    ins = _gru_inputs(*shape, dtype, cuda)
    x = [t.requires_grad_(True) for t in (ins[0], ins[2], ins[3])]
    ys = gru_cuda.gru_recurrence_kernel(*x, reverse)
    assert type(ys.grad_fn).__name__ == "GRUFunctionBackward"
    dy = torch.randn(ys.shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2)).to(dtype)
    got = torch.autograd.grad(ys, x, dy)
    ref = torch.autograd.grad(gru_cuda.gru_recurrence(*x, reverse), x, dy)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for name, a, b in zip(("dxg", "dW_hh", "db_hh"), got, ref):
        assert a.dtype == b.dtype and torch.isfinite(a).all(), name
        assert _max_rel(a.float(), b.float()) <= bound, name


@pytest.mark.parametrize("shape", [(32, 500, 64), (5, 43, 64)])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_single_kernels_match_plain(cuda, shape, reverse):
    xg, _, w, _ = _inputs(*shape, cuda)
    counts = (rnn_cuda.lstm_fwd_cuda.launches,
              rnn_cuda.lstm_fwd_train_cuda.launches,
              rnn_cuda.lstm_bwd_cuda.launches)
    with torch.no_grad():
        light = rnn_cuda.lstm_recurrence_kernel(xg, w, reverse)
    train = rnn_cuda.lstm_fwd_train(xg, w, reverse)
    ref = rnn_cuda.lstm_fwd_train_plain(xg, w, reverse)
    for a, r in zip((light, *train), (ref[0], *ref)):
        assert a.shape == r.shape and torch.isfinite(a).all()
        assert (a - r).abs().max().item() <= ATOL
    dy = torch.randn(ref[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    dg = rnn_cuda.lstm_bwd(w, ref[2], ref[1], dy, reverse)
    torch.cuda.synchronize()
    assert (rnn_cuda.lstm_fwd_cuda.launches,
            rnn_cuda.lstm_fwd_train_cuda.launches,
            rnn_cuda.lstm_bwd_cuda.launches) == tuple(c + 1 for c in counts)
    dg_ref = rnn_cuda.lstm_bwd_plain(w, ref[2], ref[1], dy, reverse)
    assert torch.isfinite(dg).all()
    assert _max_rel(dg, dg_ref) <= GRAD_REL
    x = [t.clone().requires_grad_(True) for t in (xg, w)]
    got = torch.autograd.grad(rnn_cuda.lstm_recurrence_kernel(*x, reverse),
                              x, dy)
    ref_g = torch.autograd.grad(rnn_cuda.lstm_recurrence(*x, reverse), x, dy)
    for name, a, b in zip(("dxg", "dW_hh"), got, ref_g):
        assert _max_rel(a, b) <= GRAD_REL, name


LSTM_BF16_SHAPES = [(32, 500, 64), (20, 1500, 64), (5, 43, 64)]


@pytest.mark.parametrize("shape", LSTM_BF16_SHAPES)
def test_lstm_kernels_bf16_match_plain(cuda, shape):
    """bf16 streams: the six LSTM kernels against their plain versions
    (values rtol 0.05 / atol 0.03, BPTT max-rel 0.1), and the Functions'
    gradients against autograd through the plain loop (max-rel 0.1)."""
    xg_f, xg_b, w_f, w_b = _inputs(*shape, cuda)
    bf = torch.bfloat16
    xg_f, xg_b = xg_f.to(bf), xg_b.to(bf)
    g = torch.Generator(cuda).manual_seed(1)
    dy = torch.randn(*shape, device=cuda, generator=g).to(bf)
    for a, b in zip(rnn_cuda.bilstm_fwd_cuda(xg_f, xg_b, w_f, w_b),
                    rnn_cuda.bilstm_recurrence_plain(xg_f, xg_b, w_f, w_b)):
        _assert_close(a, b, bf)
    res = rnn_cuda.bilstm_fwd_train_plain(xg_f, xg_b, w_f, w_b)
    for a, b in zip(rnn_cuda.bilstm_fwd_train_cuda(xg_f, xg_b, w_f, w_b),
                    res):
        _assert_close(a, b, bf)
    args = (w_f, w_b, res[4], res[2], dy, res[5], res[3], dy)
    for a, b in zip(rnn_cuda.bilstm_bwd_cuda(*args),
                    rnn_cuda.bilstm_bwd_plain(*args)):
        assert a.dtype == b.dtype == bf and torch.isfinite(a).all()
        assert _max_rel(a.float(), b.float()) <= 0.1
    x = [t.clone().requires_grad_(True) for t in (xg_f, xg_b, w_f, w_b)]
    got = torch.autograd.grad(rnn_cuda.bilstm_recurrence(*x), x, [dy, dy])
    ref = torch.autograd.grad(rnn_cuda.bilstm_recurrence_plain(*x), x,
                              [dy, dy])
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and _max_rel(a.float(), b.float()) <= 0.1
    for reverse in (False, True):
        _assert_close(rnn_cuda.lstm_fwd_cuda(xg_f, w_f, reverse),
                      rnn_cuda.lstm_recurrence(xg_f, w_f, reverse), bf)
        ref = rnn_cuda.lstm_fwd_train_plain(xg_f, w_f, reverse)
        for a, b in zip(rnn_cuda.lstm_fwd_train_cuda(xg_f, w_f, reverse),
                        ref):
            _assert_close(a, b, bf)
        dg = rnn_cuda.lstm_bwd_cuda(w_f, ref[2], ref[1], dy, reverse)
        dg_ref = rnn_cuda.lstm_bwd_plain(w_f, ref[2], ref[1], dy, reverse)
        assert dg.dtype == bf and _max_rel(dg.float(), dg_ref.float()) <= 0.1
        x = [t.clone().requires_grad_(True) for t in (xg_f, w_f)]
        got = torch.autograd.grad(
            rnn_cuda.lstm_recurrence_kernel(*x, reverse), x, dy)
        ref_g = torch.autograd.grad(rnn_cuda.lstm_recurrence(*x, reverse),
                                    x, dy)
        for a, b in zip(got, ref_g):
            assert a.dtype == b.dtype and _max_rel(a.float(),
                                                   b.float()) <= 0.1


def _bwd_args(shape, dtype, device):
    ins = _gru_inputs(*shape, dtype, device)
    ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = gru_cuda.bigru_fwd_train_plain(*ins)
    g = torch.Generator(device).manual_seed(1)
    dy_f, dy_b = (torch.randn(ys_f.shape, device=device, generator=g
                              ).to(dtype) for _ in range(2))
    return (ins[2], ins[4], gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b)


# #10 on each kernel of #6's route: the tensor-core chain (GRU_CASES[3]),
# the unit kernel, the register kernel in bf16 and f32, the pipe kernel
SPLIT_CASES = GRU_CASES + [((20, 300, 64), torch.bfloat16),
                           ((16, 300, 255), torch.bfloat16),
                           ((16, 300, 255), torch.float32),
                           ((8, 200, 512), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", SPLIT_CASES)
def test_bigru_bwd_split_kernel_matches_plain(cuda, shape, dtype):
    """#10 on #6's kernel (the launch's kernel asserted #6's) against its
    plain version (max-rel 1e-4 f32, 0.1 bf16), a second launch bit-equal,
    and, in float32, against #6 (the same function up to sum order)."""
    args = _bwd_args(shape, dtype, cuda)
    before = gru_cuda.bigru_bwd_split_cuda.launches
    got = gru_cuda.bigru_bwd_split_cuda(*args)
    again = gru_cuda.bigru_bwd_split_cuda(*args)
    torch.cuda.synchronize()
    assert gru_cuda.bigru_bwd_split_cuda.launches == before + 2
    kernel = gru_cuda.bigru_bwd_split_cuda.last_launch["kernel"]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for a, b in zip(got, gru_cuda.bigru_bwd_split_plain(*args)):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert _max_rel(a.float(), b.float()) <= bound
    got6 = gru_cuda.bigru_bwd_cuda(*args)
    assert kernel == gru_cuda.bigru_bwd_cuda.last_launch["kernel"]
    if dtype == torch.float32:
        for a, b in zip(got, got6):
            assert (a - b).abs().max().item() <= ATOL


def test_bigru_bwd_kernels_every_tool_plan(cuda):
    """#10 and #6 under each plan ``bench_bigru_bwd --tiles auto`` sweeps at
    the scale-up batch and width (fewer steps: the plans of the route's
    tensor-core kernel) against their plain versions, max-rel 0.1 in
    bf16."""
    args = _bwd_args((128, 200, 256), torch.bfloat16, cuda)
    kernel, plans = gru_cuda.card_bwd_plans(128, 256, cuda, torch.bfloat16)
    plans = plans[:6]
    assert kernel == "tc" and len(plans) > 1
    for fn, plain in ((gru_cuda.bigru_bwd_split_cuda,
                       gru_cuda.bigru_bwd_split_plain),
                      (gru_cuda.bigru_bwd_cuda, gru_cuda.bigru_bwd_plain)):
        ref = plain(*args)
        for p in plans:
            got = fn(*args, plan=p)
            last = fn.last_launch
            assert (last["kernel"], last["cluster"], last["rows"]) == p
            for a, b in zip(got, ref):
                assert _max_rel(a.float(), b.float()) <= 0.1, (fn, p)


# the last case takes the scale-up batch and width, so the planner gives
# it the scale-up plan (8 x 20 on an H100: 160 threads, 14 clusters)
FUSED_CASES = [((3, 53, 16, 24), torch.float32),
               ((2, 40, 16, 16), torch.bfloat16),
               ((16, 300, 256, 512), torch.bfloat16),
               ((128, 300, 256, 512), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", FUSED_CASES)
def test_bigru_layer_fused_matches_plain(cuda, shape, dtype):
    """#9 through ``bigru_layer`` under grad: the output and the nine
    gradients against the same layer with the fused backward's plain
    version, and bit for bit the same on a second run."""
    B, N, H, D = shape
    g = np.random.default_rng(4)
    x = torch.tensor(g.normal(size=(B, N, D)) * 0.5, dtype=torch.float32,
                     device=cuda).to(dtype)
    ws = [torch.tensor(g.uniform(-1, 1, size=sz) / np.sqrt(H),
                       dtype=torch.float32, device=cuda)
          for _ in range(2)
          for sz in ((D, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    dy = torch.randn(B, N, 2 * H, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5)).to(dtype)

    def grads():
        ins = [t.clone().requires_grad_(True) for t in (x, *ws)]
        y = gru_cuda.bigru_layer(*ins)
        return y, torch.autograd.grad(y, ins, dy)

    before = gru_cuda.bigru_bwd_fused_cuda.launches
    y, got = grads()
    _, again = grads()
    torch.cuda.synchronize()
    assert gru_cuda.bigru_bwd_fused_cuda.launches == before + 2
    with mock.patch.object(gru_cuda, "bigru_bwd_fused",
                           gru_cuda.bigru_bwd_fused_plain):
        y_ref, ref = grads()
    _assert_close(y, y_ref, dtype)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for a, a2, b in zip(got, again, ref):
        assert torch.equal(a, a2)
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert _max_rel(a.float(), b.float()) <= bound


# ---------------------------------------------------------------------------
# The unit kernels of csrc/bilstm_fwd.cu and csrc/bigru_fwd.cu (H <= 64):
# every batch tile the card runs and the planner's own pick, at batches of
# 1, 5 and 17 rows (no multiple of a 2- or 4-row tile), H of 16, 48 and 64,
# both walk orders, float32 and bfloat16, against the plain versions;
# tolerances as above. Above H=64 the wide LSTM kernel still runs.
# ---------------------------------------------------------------------------

UNIT_SHAPES = [(B, 37, H) for B in (1, 5, 17) for H in (16, 48, 64)]
UNIT_PLANS = [None, ("unit", 1), ("unit", 2), ("unit", 4)]


@pytest.mark.parametrize("shape", UNIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_unit_kernels_match_plain(cuda, shape, dtype):
    xg_f, xg_b, w_f, w_b = _inputs(*shape, cuda)
    xg_f, xg_b = xg_f.to(dtype), xg_b.to(dtype)
    light_ref = rnn_cuda.bilstm_recurrence_plain(xg_f, xg_b, w_f, w_b)
    train_ref = rnn_cuda.bilstm_fwd_train_plain(xg_f, xg_b, w_f, w_b)
    single_ref = [rnn_cuda.lstm_fwd_train_plain(xg_f, w_f, rev)
                  for rev in (False, True)]
    for plan in UNIT_PLANS:
        got = rnn_cuda.bilstm_fwd_cuda(xg_f, xg_b, w_f, w_b, plan=plan)
        assert rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"] == "unit"
        for a, r in zip(got, light_ref):
            _assert_close(a, r, dtype)
        got = rnn_cuda.bilstm_fwd_train_cuda(xg_f, xg_b, w_f, w_b, plan=plan)
        for a, r in zip(got, train_ref):
            _assert_close(a, r, dtype)
        for rev, ref in zip((False, True), single_ref):
            _assert_close(rnn_cuda.lstm_fwd_cuda(xg_f, w_f, rev, plan=plan),
                          ref[0], dtype)
            for a, r in zip(rnn_cuda.lstm_fwd_train_cuda(xg_f, w_f, rev,
                                                         plan=plan), ref):
                _assert_close(a, r, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", UNIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_unit_kernels_match_plain(cuda, shape, dtype):
    xg, _, w, b, _, _ = _gru_inputs(*shape, dtype, cuda)
    for rev in (False, True):
        ref = gru_cuda.gru_fwd_train_plain(xg, w, b, rev)
        for plan in UNIT_PLANS:
            _assert_close(gru_cuda.gru_fwd_cuda(xg, w, b, rev, plan=plan),
                          ref[0], dtype)
            assert gru_cuda.gru_fwd_cuda.last_launch["kernel"] == "unit"
            for a, r in zip(gru_cuda.gru_fwd_train_cuda(xg, w, b, rev,
                                                        plan=plan), ref):
                _assert_close(a, r, dtype)
    torch.cuda.synchronize()


def test_lstm_wide_kernel_above_unit_width(cuda):
    """H=96 takes the register cluster kernel on its route; the wide kernel
    (the first design, W_hh in shared memory) by a forced plan, both
    grids."""
    xg_f, xg_b, w_f, w_b = _inputs(5, 43, 96, cuda)
    assert rnn_cuda.lstm_fwd_kernel_route(96) == "reg"
    got = rnn_cuda.bilstm_fwd_train_cuda(xg_f, xg_b, w_f, w_b,
                                         plan=("wide", 4))
    assert rnn_cuda.bilstm_fwd_train_cuda.last_launch["kernel"] == "wide"
    for a, r in zip(got, rnn_cuda.bilstm_fwd_train_plain(xg_f, xg_b, w_f,
                                                         w_b)):
        _assert_close(a, r, torch.float32)
    _assert_close(rnn_cuda.lstm_fwd_cuda(xg_b, w_b, True, plan=("wide", 4)),
                  rnn_cuda.lstm_recurrence(xg_b, w_b, True), torch.float32)
    assert rnn_cuda.lstm_fwd_cuda.last_launch["kernel"] == "wide"


# ---------------------------------------------------------------------------
# The one-direction GRU BPTT unit kernel of csrc/bigru_bwd.cu (H <= 64): every
# batch tile the card runs and the planner's own pick, at the unit shapes
# above, both walk orders, float32 and bfloat16, against gru_bwd_plain
# (values as above, max-rel GRAD_REL / 0.1), and GRUFunction's gradients
# against autograd through the plain loop.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", UNIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_bwd_unit_kernels_match_plain(cuda, shape, dtype):
    xg, _, w, b, _, _ = _gru_inputs(*shape, dtype, cuda)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for rev in (False, True):
        ys, gs, hn = gru_cuda.gru_fwd_train_plain(xg, w, b, rev)
        dy = torch.randn(ys.shape, device=cuda, generator=torch.Generator(
            cuda).manual_seed(3)).to(dtype)
        ref = gru_cuda.gru_bwd_plain(w, gs, hn, ys, dy, rev)
        for plan in UNIT_PLANS:
            before = gru_cuda.gru_bwd_cuda.launches
            got = gru_cuda.gru_bwd_cuda(w, gs, hn, ys, dy, rev, plan=plan)
            assert gru_cuda.gru_bwd_cuda.launches == before + 1
            assert gru_cuda.gru_bwd_cuda.last_launch["kernel"] == "unit"
            for a, r in zip(got, ref):
                _assert_close(a, r, dtype)
                assert _max_rel(a.float(), r.float()) <= bound, plan
        x = [t.clone().requires_grad_(True) for t in (xg, w, b)]
        grads = torch.autograd.grad(gru_cuda.gru_recurrence_kernel(*x, rev),
                                    x, dy)
        assert gru_cuda.gru_bwd_cuda.last_launch["kernel"] == "unit"
        ref_g = torch.autograd.grad(gru_cuda.gru_recurrence(*x, rev), x, dy)
        for name, a, r in zip(("dxg", "dW_hh", "db_hh"), grads, ref_g):
            assert a.dtype == r.dtype and torch.isfinite(a).all(), name
            assert _max_rel(a.float(), r.float()) <= bound, name
    torch.cuda.synchronize()


# sample counts (B x 96-step chunks, a last chunk of 1), D and 3H that are
# no multiple of the 64 x 128 x 32 tensor-core tiles; D = 36 also leaves x's
# rows off 16-byte alignment (staged by value, not cp.async)
FUSED_EDGE_SHAPES = [(5, 97, 32, 40), (5, 97, 32, 36), (7, 61, 48, 20)]


@pytest.mark.parametrize("shape", FUSED_EDGE_SHAPES)
def test_bigru_layer_fused_tensor_core_edges(cuda, shape):
    """#9 in bf16 (its products on tensor cores) through ``bigru_layer``
    under grad at shapes off the mma tiles: the nine gradients against the
    layer with #9's plain version (max-rel 0.1), and a second run bit for
    bit."""
    B, N, H, D = shape
    g = np.random.default_rng(6)
    bf = torch.bfloat16
    x = torch.tensor(g.normal(size=(B, N, D)) * 0.5, dtype=torch.float32,
                     device=cuda).to(bf)
    ws = [torch.tensor(g.uniform(-1, 1, size=sz) / np.sqrt(sz[0]),
                       dtype=torch.float32, device=cuda)
          for _ in range(2)
          for sz in ((D, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    dy = torch.randn(B, N, 2 * H, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(7)).to(bf)

    def grads():
        ins = [t.clone().requires_grad_(True) for t in (x, *ws)]
        return torch.autograd.grad(gru_cuda.bigru_layer(*ins), ins, dy)

    before = gru_cuda.bigru_bwd_fused_cuda.launches
    got, again = grads(), grads()
    torch.cuda.synchronize()
    assert gru_cuda.bigru_bwd_fused_cuda.launches == before + 2
    with mock.patch.object(gru_cuda, "bigru_bwd_fused",
                           gru_cuda.bigru_bwd_fused_plain):
        ref = grads()
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2)
        assert a.dtype == r.dtype and torch.isfinite(a).all()
        assert _max_rel(a.float(), r.float()) <= 0.1


# ---------------------------------------------------------------------------
# The LSTM BPTT of csrc/bilstm_bwd.cu: the unit kernel (H <= 64) at every
# batch tile the card runs and the planner's own pick, B in {1, 5, 17}
# (ragged tiles) x N in {5, 17, 500} (5: shorter than the 8-step input
# ring; 17: two of its groups and a step) x H in {16, 20, 48, 64} (20:
# padding lanes), float32 and
# bfloat16, both grids (both directions; one direction in both walk
# orders), against bilstm_bwd_plain / lstm_bwd_plain (max-rel GRAD_REL /
# 0.1), bit-equal on a second launch, and BiLSTMFunction's /
# LSTMFunction's gradients against autograd through the plain loop; the
# wide kernel (H > 64) the same way at H=96.
# ---------------------------------------------------------------------------

LSTM_BWD_SHAPES = [(B, N, H) for B in (1, 5, 17) for N in (5, 17, 500)
                   for H in (16, 20, 48, 64)]
LSTM_BWD_WIDE_SHAPES = [(1, 17, 96), (5, 500, 96), (17, 43, 96)]


def _check_lstm_bwd(cuda, shape, dtype, plans, kernel, route=None):
    """The BPTT under each of ``plans`` on ``kernel``, then the Functions'
    gradients through the route, whose kernel is ``route`` (default
    ``kernel``; False: no route takes H, the Functions are not run)."""
    route = kernel if route is None else route
    xg_f, xg_b, w_f, w_b = _inputs(*shape, cuda)
    xg_f, xg_b = xg_f.to(dtype), xg_b.to(dtype)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    res = rnn_cuda.bilstm_fwd_train_plain(xg_f, xg_b, w_f, w_b)
    g = torch.Generator(cuda).manual_seed(3)
    dy_f, dy_b = (torch.randn(res[0].shape, device=cuda, generator=g
                              ).to(dtype) for _ in range(2))
    args = (w_f, w_b, res[4], res[2], dy_f, res[5], res[3], dy_b)
    ref = rnn_cuda.bilstm_bwd_plain(*args)
    # one direction: the forward direction's walk, and the backward one's
    # as a reverse LSTM; their plain versions are ref's two halves
    singles = ((False, args[0], args[2:5], ref[0]),
               (True, args[1], args[5:8], ref[1]))
    for plan in plans:
        before = rnn_cuda.bilstm_bwd_cuda.launches
        got = rnn_cuda.bilstm_bwd_cuda(*args, plan=plan)
        assert rnn_cuda.bilstm_bwd_cuda.launches == before + 1
        assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == kernel
        again = rnn_cuda.bilstm_bwd_cuda(*args, plan=plan)
        for a, a2, r in zip(got, again, ref):
            assert torch.equal(a, a2), plan
            assert a.dtype == r.dtype and torch.isfinite(a).all()
            assert _max_rel(a.float(), r.float()) <= bound, plan
        for rev, w, streams, r in singles:
            before = rnn_cuda.lstm_bwd_cuda.launches
            got = rnn_cuda.lstm_bwd_cuda(w, *streams, rev, plan=plan)
            assert rnn_cuda.lstm_bwd_cuda.launches == before + 1
            assert rnn_cuda.lstm_bwd_cuda.last_launch["kernel"] == kernel
            assert torch.equal(got, rnn_cuda.lstm_bwd_cuda(w, *streams, rev,
                                                           plan=plan))
            assert got.dtype == r.dtype and torch.isfinite(got).all()
            assert _max_rel(got.float(), r.float()) <= bound, (plan, rev)
    if route is False:
        torch.cuda.synchronize()
        return
    x = [t.clone().requires_grad_(True) for t in (xg_f, xg_b, w_f, w_b)]
    got = torch.autograd.grad(rnn_cuda.bilstm_recurrence(*x), x, [dy_f, dy_b])
    assert rnn_cuda.bilstm_bwd_cuda.last_launch["kernel"] == route
    ref_g = torch.autograd.grad(rnn_cuda.bilstm_recurrence_plain(*x), x,
                                [dy_f, dy_b])
    for name, a, r in zip(("dxg_f", "dxg_b", "dW_f", "dW_b"), got, ref_g):
        assert a.dtype == r.dtype and torch.isfinite(a).all(), name
        assert _max_rel(a.float(), r.float()) <= bound, name
    for rev in (False, True):
        x = [t.clone().requires_grad_(True) for t in (xg_f, w_f)]
        got = torch.autograd.grad(rnn_cuda.lstm_recurrence_kernel(*x, rev),
                                  x, dy_f)
        assert rnn_cuda.lstm_bwd_cuda.last_launch["kernel"] == route
        ref_g = torch.autograd.grad(rnn_cuda.lstm_recurrence(*x, rev), x,
                                    dy_f)
        for name, a, r in zip(("dxg", "dW_hh"), got, ref_g):
            assert a.dtype == r.dtype and torch.isfinite(a).all(), name
            assert _max_rel(a.float(), r.float()) <= bound, (name, rev)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", LSTM_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_unit_kernels_match_plain(cuda, shape, dtype):
    _check_lstm_bwd(cuda, shape, dtype, UNIT_PLANS, "unit")


@pytest.mark.parametrize("shape", LSTM_BWD_WIDE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_wide_kernel_matches_plain(cuda, shape, dtype):
    _check_lstm_bwd(cuda, shape, dtype, [("wide", 4)], "wide", route="reg")


# ---------------------------------------------------------------------------
# The tensor-core kernels of csrc/bigru_fwd.cu and csrc/bigru_bwd.cu (bf16
# streams, both directions): every plan the card runs and the route's own
# pick, at batches of 1, 5, 17 and 32 rows (padding rows in a 16- or 32-row
# tile), 17 and 300 steps, H of 64, 128 and 256, against the plain versions
# (values rtol 0.05 / atol 0.03, BPTT and gradients max-rel 0.1), a second
# launch bit for bit, and BiGRUFunction's six gradients against autograd
# through the plain loop.
# ---------------------------------------------------------------------------

TC_SHAPES = [(B, N, H) for B in (1, 5, 17, 32) for N in (17, 300)
             for H in (64, 128, 256)]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_bigru_tc_kernels_match_plain(cuda, shape):
    B, N, H = shape
    bf16 = torch.bfloat16
    ins = _gru_inputs(*shape, bf16, cuda)
    args = _bwd_args(shape, bf16, cuda)
    for kind, fn, a, ref in (
            ("fwd", gru_cuda.bigru_fwd_cuda, ins,
             gru_cuda.bigru_fwd_plain(*ins)),
            ("fwd_train", gru_cuda.bigru_fwd_train_cuda, ins,
             gru_cuda.bigru_fwd_train_plain(*ins)),
            ("bwd", gru_cuda.bigru_bwd_cuda, args,
             gru_cuda.bigru_bwd_plain(*args))):
        plans = gru_cuda.card_tc_plans(kind, B, H, cuda)
        assert plans, kind
        for plan in (None, *(("tc", c, r) for c, r in plans)):
            before = fn.launches
            got = fn(*a, plan=plan)
            again = fn(*a, plan=plan)
            assert fn.launches == before + 2
            last = fn.last_launch
            # at H <= 64 the route takes the unit kernels (faster there)
            route = "unit" if plan is None and H <= 64 else "tc"
            assert last["kernel"] == route, (kind, last)
            if route == "tc":
                want = plans[0] if plan is None else plan[1:]
                assert (last["cluster"], last["rows"]) == want, (kind, last)
            for x, x2, r in zip(got, again, ref):
                assert torch.equal(x, x2), (kind, plan)
                if kind == "bwd":
                    assert x.dtype == r.dtype and torch.isfinite(x).all()
                    assert _max_rel(x.float(), r.float()) <= 0.1, (kind, plan)
                else:
                    _assert_close(x, r, bf16)
    x = [t.clone().requires_grad_(True) for t in ins]
    dys = [args[5], args[9]]
    grads = torch.autograd.grad(gru_cuda.bigru_recurrence(*x), x, dys)
    route = "unit" if H <= 64 else "tc"
    assert gru_cuda.bigru_fwd_train_cuda.last_launch["kernel"] == route
    assert gru_cuda.bigru_bwd_cuda.last_launch["kernel"] == route
    ref = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*x), x, dys)
    for name, a, r in zip(("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b", "db_b"),
                          grads, ref):
        assert a.dtype == r.dtype and torch.isfinite(a).all(), name
        assert _max_rel(a.float(), r.float()) <= 0.1, (name, _max_rel(
            a.float(), r.float()))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The LSTM cluster kernels (H above the wide kernels' 118 / 116, up to 256):
# W_hh split by hidden units across a cluster, slices of ceil(H / C) units
# with the last one masked; light and training forward and the BPTT, one and
# two directions, float32 and bf16, under the card's first plans (forced:
# the route takes the register cluster kernels), against the plain versions
# (bounds as above), a second launch bit for bit; the Functions' gradients
# through the route.
# ---------------------------------------------------------------------------

LSTM_CLUSTER_SHAPES = [(1, 17, 119), (5, 43, 130), (32, 60, 192),
                       (17, 300, 256), (3, 20, 117)]


def _lstm_fwd_cases(shape, dtype, cuda):
    xg_f, xg_b, w_f, w_b = _inputs(*shape, cuda)
    xg_f, xg_b = xg_f.to(dtype), xg_b.to(dtype)
    ins = (xg_f, xg_b, w_f, w_b)
    return ((rnn_cuda.bilstm_fwd_cuda, ins,
             rnn_cuda.bilstm_recurrence_plain(*ins), 2, False),
            (rnn_cuda.bilstm_fwd_train_cuda, ins,
             rnn_cuda.bilstm_fwd_train_plain(*ins), 2, True),
            (rnn_cuda.lstm_fwd_cuda, (xg_b, w_b, True),
             (rnn_cuda.lstm_recurrence(xg_b, w_b, True),), 1, False),
            (rnn_cuda.lstm_fwd_train_cuda, (xg_f, w_f, False),
             rnn_cuda.lstm_fwd_train_plain(xg_f, w_f, False), 1, True))


@pytest.mark.parametrize("shape", LSTM_CLUSTER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_cluster_kernels_match_plain(cuda, shape, dtype):
    _check_lstm_cluster_kernels(cuda, shape, dtype, "cluster")


def _check_lstm_cluster_kernels(cuda, shape, dtype, kernel):
    """The cluster kernel ``kernel`` ("cluster": the first design, "reg":
    the register cluster kernel) under its card's first plans, forced, and
    (the register kernel, the route above the unit kernels) the route's
    own pick."""
    B, N, H = shape
    assert rnn_cuda.lstm_bwd_kernel_route(H) == "reg"
    assert rnn_cuda.lstm_fwd_kernel_route(H) == "reg"
    card_plans = (rnn_cuda.card_lstm_cluster_plans if kernel == "cluster"
                  else rnn_cuda.card_lstm_reg_plans)
    for fn, ins, ref, dirs, save in _lstm_fwd_cases(shape, dtype, cuda):
        plans = card_plans("fwd", B, H, cuda, dtype, save, dirs)
        assert plans
        route = [None] if kernel == "reg" else []
        for plan in (*route, *((kernel, c, r) for c, r in plans[:3])):
            before = fn.launches
            got = fn(*ins, plan=plan)
            got = got if isinstance(got, tuple) else (got,)
            assert fn.launches == before + 1
            last = fn.last_launch
            assert last["kernel"] == kernel, last
            want = plans[0] if plan is None else plan[1:]
            assert (last["cluster"], last["rows"]) == want, last
            again = fn(*ins, plan=plan)
            again = again if isinstance(again, tuple) else (again,)
            for a, a2, r in zip(got, again, ref):
                assert torch.equal(a, a2), plan
                _assert_close(a, r, dtype)
    plans = card_plans("bwd", B, H, cuda, dtype, False, 2)
    route = [None] if kernel == "reg" else []
    _check_lstm_bwd(cuda, shape, dtype,
                    [*route, *((kernel, c, r) for c, r in plans[:2])],
                    kernel, route="reg")


# The register cluster kernels, the route at these widths: W_hh in
# registers, the exchange by st.async on mbarriers; the reference lstm
# request's H=128 and the lstm at d_model 512's H=256 among the shapes.
LSTM_REG_SHAPES = [(1, 17, 119), (5, 43, 130), (32, 60, 192),
                   (17, 300, 256), (3, 20, 117), (1, 300, 128),
                   (32, 100, 256), (8, 5, 201)]


@pytest.mark.parametrize("shape", LSTM_REG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_reg_kernels_match_plain(cuda, shape, dtype):
    _check_lstm_cluster_kernels(cuda, shape, dtype, "reg")


# The register cluster kernels at the wide kernels' widths (H 65-118, their
# route since they replaced the first design there): the lane k count
# fitted to H (12 to H=96, 16 above), padding rows in 2- and 4-row tiles.
LSTM_MID_SHAPES = [(B, 33, H) for H in (65, 96, 116, 118)
                   for B in (1, 5, 17, 32)]


@pytest.mark.parametrize("shape", LSTM_MID_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_mid_kernels_match_plain(cuda, shape, dtype):
    _check_lstm_cluster_kernels(cuda, shape, dtype, "reg")


# ---------------------------------------------------------------------------
# The GRU cluster kernels (the first design, reached by a forced ("cluster",
# C, R) plan since the register cluster kernels took the route) at widths no
# dividing plan fits: slices of ceil(H / C) units, the last block's masked;
# BiGRU forward, training forward and BPTT, the one-direction GRU's, and
# BiGRUFunction's gradients (on the route).
# ---------------------------------------------------------------------------

MASKED_GRU_SHAPES = [((5, 43, 139), torch.float32),
                     ((5, 43, 201), torch.bfloat16),
                     ((17, 60, 255), torch.float32),
                     ((3, 30, 250), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", MASKED_GRU_SHAPES)
def test_gru_masked_slice_kernels_match_plain(cuda, shape, dtype):
    B, N, H = shape
    ins = _gru_inputs(*shape, dtype, cuda)
    args = _bwd_args(shape, dtype, cuda)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for fn, a, ref, kind, dirs in (
            (gru_cuda.bigru_fwd_cuda, ins, gru_cuda.bigru_fwd_plain(*ins),
             "fwd", 2),
            (gru_cuda.bigru_fwd_train_cuda, ins,
             gru_cuda.bigru_fwd_train_plain(*ins), "fwd", 2),
            (gru_cuda.bigru_bwd_cuda, args, gru_cuda.bigru_bwd_plain(*args),
             "bwd", 2),
            (gru_cuda.gru_fwd_cuda, (ins[1], ins[4], ins[5], True),
             (gru_cuda.bigru_fwd_plain(*ins)[1],), "fwd", 1),
            (gru_cuda.gru_bwd_cuda, (args[1], *args[6:], True),
             gru_cuda.bigru_bwd_plain(*args)[2:], "bwd", 1)):
        plan = ("cluster", *gru_cuda.card_plans(kind, B, H, cuda, dtype,
                                                dirs)[0])
        got = fn(*a, plan=plan)
        got = got if isinstance(got, tuple) else (got,)
        last = fn.last_launch
        assert last["kernel"] == "cluster" and H % last["cluster"], last
        again = fn(*a, plan=plan)
        again = again if isinstance(again, tuple) else (again,)
        for x, x2, r in zip(got, again, ref):
            assert torch.equal(x, x2)
            if fn in (gru_cuda.bigru_bwd_cuda, gru_cuda.gru_bwd_cuda):
                assert x.dtype == r.dtype and torch.isfinite(x).all()
                assert _max_rel(x.float(), r.float()) <= bound, fn.__name__
            else:
                _assert_close(x, r, dtype)
    x = [t.clone().requires_grad_(True) for t in ins]
    dys = [args[5], args[9]]
    grads = torch.autograd.grad(gru_cuda.bigru_recurrence(*x), x, dys)
    ref = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*x), x, dys)
    for name, a, r in zip(("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b", "db_b"),
                          grads, ref):
        assert a.dtype == r.dtype and torch.isfinite(a).all(), name
        assert _max_rel(a.float(), r.float()) <= bound, name
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# dW_hh and db_hh from bf16 operands: the products take the bf16 streams as
# they are with float32 sums and result, no float32 copy of a stream; they
# agree with the float32 products of the upcast streams (a bf16 x bf16
# product is exact in float32, so only the summation order differs).
# ---------------------------------------------------------------------------


class _Float32Outputs(TorchDispatchMode):
    """Records every operator (ours and those the library's own kernels
    dispatch) whose float32 output holds ``numel`` values or more."""

    def __init__(self, numel):
        super().__init__()
        self.numel = numel
        self.big = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32 \
                    and t.numel() >= self.numel:
                self.big.append((str(func), tuple(t.shape)))
        return out


@pytest.mark.parametrize("shape", [(8, 300, 64), (32, 2000, 256)])
def test_hidden_grads_take_bf16_operands(cuda, shape):
    B, N, H = shape
    g = torch.Generator(cuda).manual_seed(5)
    bf16 = torch.bfloat16
    ys, dhn = (torch.randn(B, N, H, device=cuda, generator=g).to(bf16)
               for _ in range(2))
    dx = torch.randn(B, N, 3 * H, device=cuda, generator=g).to(bf16)
    dg = torch.randn(B, N, 4 * H, device=cuda, generator=g).to(bf16)
    with _Float32Outputs(B * N * H) as seen:
        dw, db = gru_cuda.hidden_grads(ys, dx, dhn, True, torch.float32)
        dw4 = rnn_cuda._hidden_grad(ys, dg, False, torch.float32)
        torch.cuda.synchronize()
    assert not seen.big, seen.big    # no float32 copy of a stream
    assert dw.dtype == db.dtype == dw4.dtype == torch.float32
    f32 = torch.float32
    hp = rnn_cuda.prev_steps(ys, True).reshape(-1, H).to(f32)
    want_w = hp.t() @ torch.cat([dx[..., :2 * H], dhn], -1).reshape(
        -1, 3 * H).to(f32)
    want_b = torch.cat([dx[..., :2 * H], dhn], -1).reshape(
        -1, 3 * H).to(f32).sum(0)
    hp4 = rnn_cuda.prev_steps(ys, False).reshape(-1, H).to(f32)
    want_w4 = hp4.t() @ dg.reshape(-1, 4 * H).to(f32)
    for got, want in ((dw, want_w), (db, want_b), (dw4, want_w4)):
        assert _max_rel(got, want) <= 1e-4, _max_rel(got, want)


@pytest.mark.parametrize("B", [4, 8, 24])
def test_kernel_at_tta_view_batches(cuda, B):
    """#1 at the serving path's test-time view batches (R = 4, 8, 24 views
    of one 1500-step trace) on the unit kernel, against its plain
    version."""
    ins = _inputs(B, 1500, 64, cuda, seed=B)
    before = rnn_cuda.bilstm_fwd_cuda.launches
    got = rnn_cuda.bilstm_recurrence(*ins)
    torch.cuda.synchronize()
    assert rnn_cuda.bilstm_fwd_cuda.launches == before + 1
    assert rnn_cuda.bilstm_fwd_cuda.last_launch["kernel"] == "unit"
    ref = rnn_cuda.bilstm_recurrence_plain(*ins)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        err = (a - b).abs().max().item()
        assert err <= ATOL, err


def test_tta_serving_card_matches_cpu(cuda):
    """A small flagship-shaped model served with 8 test-time views, soft-NMS
    and the trace-informed passes on the card: two #1 launches at B=8 a
    request, and the colliders of the same predictor on the CPU."""
    import copy

    from room_slam_torch.config import ModelConfig
    from room_slam_torch.models.factory import build_model
    from room_slam_torch.predictor import build_predictor

    model = build_model(ModelConfig(d_model=32, num_queries=8,
                                    objectness=True, center_xz=True,
                                    refine_stages=2),
                        torch.Generator().manual_seed(0)).eval()
    g = np.random.default_rng(0)
    arr = np.cumsum(g.normal(size=(400, 4)) * [0.2, 0.01, 0.2, 0.0], 0)
    arr[:, 3] = np.arange(400) * 0.033
    arr = arr.astype(np.float32)
    kw = dict(max_trace_len=300, confidence_threshold=0.0,
              nms_threshold=0.5, tta_rotations=True, tta_reflect=True,
              soft_sigma=0.25, synth_walls=True, synth_furniture="v2",
              ttopt=True, ttopt_params={"deadband": 0.25}, extent_slack=1.0,
              verbose=False)
    on_card = build_predictor(copy.deepcopy(model), device=cuda, **kw)
    batches = []
    launch = rnn_cuda._bilstm_fwd_launch

    def spy(fn, save, xg_f, *args, **kwargs):
        batches.append((fn is rnn_cuda.bilstm_fwd_cuda, xg_f.shape[0]))
        return launch(fn, save, xg_f, *args, **kwargs)

    with mock.patch.object(rnn_cuda, "_bilstm_fwd_launch", spy):
        got = on_card(arr)
    assert batches == [(True, 8), (True, 8)]
    ref = build_predictor(model, device="cpu", **kw)(arr)
    assert [c["label"] for c in got] == [c["label"] for c in ref]
    for a, b in zip(got, ref):
        va = [a["confidence"], *a["center"].values(), *a["size"].values()]
        vb = [b["confidence"], *b["center"].values(), *b["size"].values()]
        np.testing.assert_allclose(va, vb, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# The stream kernels (the widths above the cluster kernels': W_hh read from
# global memory every step, clusters of up to 16 blocks) at H in {257, 320,
# 512} x B in {1, 5, 32}, a short walk, float32 and bf16, both direction
# counts: the LSTM's six wrappers (by a forced plan: the routes there are
# now the pipe kernels) and BiLSTMFunction's / LSTMFunction's gradients
# through the route (its BPTT bit-equal run to run), the GRU's six (the
# stream plan forced where another kernel takes the route: every width
# here since the forward pipe kernel, the BPTT's pipe kernel above 256)
# and BiGRUFunction's gradients where the route takes the stream kernel;
# against the plain versions at the bounds above.
# The pipe kernel (the LSTM BPTT's route above H=256) at the same shapes
# and at PIPE_WIDTHS, on its route and under the card's next plans, and its
# plans that do not fit refused.
# ---------------------------------------------------------------------------

STREAM_WIDTHS = (257, 320, 512)
STREAM_BATCHES = (1, 5, 32)
STREAM_N = 9


@pytest.mark.parametrize("H", STREAM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_stream_kernels_match_plain(cuda, H, dtype):
    assert rnn_cuda.lstm_fwd_kernel_route(H) == "pipe"
    assert rnn_cuda.lstm_bwd_kernel_route(H) == "pipe"
    for B in STREAM_BATCHES:
        shape = (B, STREAM_N, H)
        for fn, ins, ref, dirs, save in _lstm_fwd_cases(shape, dtype, cuda):
            first = rnn_cuda.card_lstm_stream_plans("fwd", B, H, cuda, dtype,
                                                    save, dirs)[0]
            got = fn(*ins, plan=("stream", *first))
            got = got if isinstance(got, tuple) else (got,)
            last = fn.last_launch
            assert last["kernel"] == "stream", last
            assert (last["cluster"], last["rows"]) == first
            for a, r in zip(got, ref):
                _assert_close(a, r, dtype)
        first = ("stream", *rnn_cuda.card_lstm_stream_plans(
            "bwd", B, H, cuda, dtype, False, 2)[0])
        _check_lstm_bwd(cuda, shape, dtype, [first], "stream", route="pipe")


# the pipe kernel's other instance families: blocks of more than four
# consumer warps (H 513-1024) and two k groups a thread (1025-2048; the
# route stops at 1816, where the first stream design does)
PIPE_WIDTHS = (640, 1024, 1100, 2048)


@pytest.mark.parametrize("H", STREAM_WIDTHS + PIPE_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_pipe_kernels_match_plain(cuda, H, dtype):
    """Both BPTT grids on the pipe kernel under the card's first three
    plans (the first through the route where it takes H), bit-equal run to
    run, and the Functions' gradients through the route; past H=1816 the
    route raises and the plans are forced."""
    routed = H <= 1816
    if routed:
        assert rnn_cuda.lstm_bwd_kernel_route(H) == "pipe"
    else:
        with pytest.raises(ValueError, match=f"H={H}"):
            rnn_cuda.lstm_bwd_kernel_route(H)
    for B in STREAM_BATCHES:
        plans = [("pipe", *p) for p in
                 rnn_cuda.card_lstm_pipe_plans(B, H, cuda, dtype, 2)[:3]]
        assert plans
        _check_lstm_bwd(cuda, (B, STREAM_N, H), dtype,
                        [None if routed else plans[0], *plans[1:]], "pipe",
                        route=None if routed else False)


def test_lstm_pipe_plans_that_do_not_fit_raise(cuda):
    """A pipe plan over 16 blocks, with a tile it has not, or whose block
    holds more cells than its threads is refused before any launch; so is
    a forward pipe plan over 16 blocks, with a tile it has not or whose
    block needs more than 16 consumer warps."""
    args = [t.to(cuda) for t in _inputs(5, 4, 512, cuda)]
    res = rnn_cuda.bilstm_fwd_train_plain(*args)
    bwd = (args[2], args[3], res[4], res[2], res[0], res[5], res[3], res[1])
    before = rnn_cuda.bilstm_bwd_cuda.launches
    for bad in (("pipe", 17, 4), ("pipe", 16, 6), ("pipe", 1, 16)):
        with pytest.raises(ValueError, match="does not fit"):
            rnn_cuda.bilstm_bwd_cuda(*bwd, plan=bad)
        with pytest.raises(ValueError, match="does not fit"):
            rnn_cuda.lstm_bwd_cuda(bwd[0], *bwd[2:5], plan=bad)
    fwd_before = rnn_cuda.bilstm_fwd_cuda.launches
    for bad in (("pipe", 17, 4), ("pipe", 16, 6), ("pipe", 1, 16)):
        with pytest.raises(ValueError, match="does not fit"):
            rnn_cuda.bilstm_fwd_cuda(*args, plan=bad)
    assert rnn_cuda.bilstm_bwd_cuda.launches == before
    assert rnn_cuda.bilstm_fwd_cuda.launches == fwd_before


# The GRU BPTT's pipe kernel (csrc/bigru_pipe.cu: the route of #6 and #8
# above H=256, to 1024) at STREAM_WIDTHS and its blocks of more than four
# consumer warps (640, 1024) x STREAM_BATCHES, float32 and bf16: both grids
# on the route against the plain versions, bit-equal run to run, and
# BiGRUFunction's / GRUFunction's gradients through the route; the card's
# next plans at one shape; its plans that do not fit refused.
GRU_PIPE_WIDTHS = STREAM_WIDTHS + (640, 1024)


def _check_gru_bwd(cuda, shape, dtype, plans, kernel):
    """The GRU BPTT, both grids (``bigru_bwd_cuda`` and ``gru_bwd_cuda`` in
    each walk order), under each of ``plans`` on ``kernel``, bit-equal run
    to run, against the plain versions (max-rel 1e-4 f32, 0.1 bf16)."""
    args = _bwd_args(shape, dtype, cuda)
    ref = gru_cuda.bigru_bwd_plain(*args)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    singles = ((False, args[0], args[2:6], ref[:2]),
               (True, args[1], args[6:], ref[2:]))
    for plan in plans:
        kw = {} if plan is None else {"plan": plan}
        before = gru_cuda.bigru_bwd_cuda.launches
        got = gru_cuda.bigru_bwd_cuda(*args, **kw)
        assert gru_cuda.bigru_bwd_cuda.launches == before + 1
        assert gru_cuda.bigru_bwd_cuda.last_launch["kernel"] == kernel
        again = gru_cuda.bigru_bwd_cuda(*args, **kw)
        for a, a2, r in zip(got, again, ref):
            assert torch.equal(a, a2), plan
            assert a.dtype == r.dtype and torch.isfinite(a).all()
            assert _max_rel(a.float(), r.float()) <= bound, plan
        for rev, w, streams, r in singles:
            got = gru_cuda.gru_bwd_cuda(w, *streams, rev, **kw)
            assert gru_cuda.gru_bwd_cuda.last_launch["kernel"] == kernel
            again = gru_cuda.gru_bwd_cuda(w, *streams, rev, **kw)
            for a, a2, b in zip(got, again, r):
                assert torch.equal(a, a2), (plan, rev)
                assert a.dtype == b.dtype and torch.isfinite(a).all()
                assert _max_rel(a.float(), b.float()) <= bound, (plan, rev)
    torch.cuda.synchronize()


@pytest.mark.parametrize("H", GRU_PIPE_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_pipe_kernels_match_plain(cuda, H, dtype):
    assert gru_cuda.gru_bwd_kernel_route(H, 2, dtype) == "pipe"
    assert gru_cuda.gru_bwd_kernel_route(H, 1, dtype) == "pipe"
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for B in STREAM_BATCHES:
        shape = (B, STREAM_N, H)
        _check_gru_bwd(cuda, shape, dtype, [None], "pipe")
        ins = _gru_inputs(*shape, dtype, cuda)
        g = torch.Generator(cuda).manual_seed(4)
        dys = [torch.randn(B, STREAM_N, H, device=cuda, generator=g
                           ).to(dtype) for _ in range(2)]
        x = [t.clone().requires_grad_(True) for t in ins]
        grads = torch.autograd.grad(gru_cuda.bigru_recurrence(*x), x, dys)
        assert gru_cuda.bigru_bwd_cuda.last_launch["kernel"] == "pipe"
        ref = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*x), x, dys)
        for name, a, r in zip(("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b",
                               "db_b"), grads, ref):
            assert a.dtype == r.dtype and torch.isfinite(a).all(), name
            assert _max_rel(a.float(), r.float()) <= bound, (B, name)
        for rev in (False, True):
            x = [t.clone().requires_grad_(True)
                 for t in (ins[0], ins[2], ins[3])]
            got = torch.autograd.grad(
                gru_cuda.gru_recurrence_kernel(*x, rev), x, dys[0])
            assert gru_cuda.gru_bwd_cuda.last_launch["kernel"] == "pipe"
            ref = torch.autograd.grad(gru_cuda.gru_recurrence(*x, rev), x,
                                      dys[0])
            for name, a, r in zip(("dxg", "dW_hh", "db_hh"), got, ref):
                assert a.dtype == r.dtype and torch.isfinite(a).all(), name
                assert _max_rel(a.float(), r.float()) <= bound, (B, name,
                                                                 rev)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_pipe_next_plans_match_plain(cuda, dtype):
    """Both grids under the card's next three pipe plans at (5, 9, 512)
    (the first is the route's), and the first stream design, forced,
    beside them."""
    B, H = 5, 512
    plans = [("pipe", *p) for p in
             gru_cuda.card_gru_pipe_plans(B, H, cuda, dtype, 2)[1:4]]
    assert plans
    _check_gru_bwd(cuda, (B, STREAM_N, H), dtype, plans, "pipe")
    first = ("stream", *gru_cuda.card_stream_plans("bwd", B, H, cuda, dtype,
                                                   False, 2)[0])
    _check_gru_bwd(cuda, (B, STREAM_N, H), dtype, [first], "stream")


def test_gru_pipe_plans_that_do_not_fit_raise(cuda):
    """A pipe plan over 16 blocks, with a tile it has not, whose block
    holds more cells than its threads, or above H=1024 is refused before
    any launch; so is a forward pipe plan over 16 blocks, with a tile it
    has not or whose block needs more than 16 consumer warps."""
    args = _bwd_args((5, 4, 512), torch.float32, cuda)
    before = (gru_cuda.bigru_bwd_cuda.launches,
              gru_cuda.gru_bwd_cuda.launches)
    for bad in (("pipe", 17, 4), ("pipe", 16, 6), ("pipe", 1, 16)):
        with pytest.raises(ValueError, match=f"plan {bad[1]}x{bad[2]} does "
                                             "not fit"):
            gru_cuda.bigru_bwd_cuda(*args, plan=bad)
        with pytest.raises(ValueError, match="does not fit"):
            gru_cuda.gru_bwd_cuda(args[0], *args[2:6], plan=bad)
    wide = _bwd_args((2, 3, 1032), torch.float32, cuda)
    with pytest.raises(ValueError, match="does not fit H=1032"):
        gru_cuda.bigru_bwd_cuda(*wide, plan=("pipe", 16, 1))
    ins = _gru_inputs(5, 4, 512, torch.float32, cuda)
    fwd_before = (gru_cuda.bigru_fwd_cuda.launches,
                  gru_cuda.gru_fwd_cuda.launches)
    for bad in (("pipe", 17, 4), ("pipe", 16, 6), ("pipe", 1, 16)):
        with pytest.raises(ValueError, match=f"plan {bad[1]}x{bad[2]} does "
                                             "not fit"):
            gru_cuda.bigru_fwd_cuda(*ins, plan=bad)
        with pytest.raises(ValueError, match="does not fit"):
            gru_cuda.gru_fwd_cuda(ins[0], ins[2], ins[3], plan=bad)
    assert (gru_cuda.bigru_bwd_cuda.launches,
            gru_cuda.gru_bwd_cuda.launches) == before
    assert (gru_cuda.bigru_fwd_cuda.launches,
            gru_cuda.gru_fwd_cuda.launches) == fwd_before


def _gru_stream_plan(kind, B, H, cuda, dtype, dirs, save=False):
    """None where the route takes the stream kernel, else its card's first
    plan, forced."""
    route = (gru_cuda.gru_fwd_kernel_route if kind == "fwd"
             else gru_cuda.gru_bwd_kernel_route)(H, dirs, dtype)
    if route == "stream":
        return None
    return ("stream", *gru_cuda.card_stream_plans(kind, B, H, cuda, dtype,
                                                  save, dirs)[0])


@pytest.mark.parametrize("H", STREAM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_stream_kernels_match_plain(cuda, H, dtype):
    assert gru_cuda.gru_fwd_kernel_route(H, 2, dtype) == "pipe"
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for B in STREAM_BATCHES:
        shape = (B, STREAM_N, H)
        ins = _gru_inputs(*shape, dtype, cuda)
        args = _bwd_args(shape, dtype, cuda)
        for fn, a, ref, kind, dirs, save in (
                (gru_cuda.bigru_fwd_cuda, ins, gru_cuda.bigru_fwd_plain(*ins),
                 "fwd", 2, False),
                (gru_cuda.bigru_fwd_train_cuda, ins,
                 gru_cuda.bigru_fwd_train_plain(*ins), "fwd", 2, True),
                (gru_cuda.bigru_bwd_cuda, args,
                 gru_cuda.bigru_bwd_plain(*args), "bwd", 2, False),
                (gru_cuda.gru_fwd_cuda, (ins[1], ins[4], ins[5], True),
                 (gru_cuda.bigru_fwd_plain(*ins)[1],), "fwd", 1, False),
                (gru_cuda.gru_fwd_train_cuda, (ins[0], ins[2], ins[3]),
                 gru_cuda.gru_fwd_train_plain(ins[0], ins[2], ins[3]), "fwd",
                 1, True),
                (gru_cuda.gru_bwd_cuda, (args[1], *args[6:], True),
                 gru_cuda.bigru_bwd_plain(*args)[2:], "bwd", 1, False)):
            plan = _gru_stream_plan(kind, B, H, cuda, dtype, dirs, save)
            kw = {} if plan is None else {"plan": plan}
            got = fn(*a, **kw)
            got = got if isinstance(got, tuple) else (got,)
            assert fn.last_launch["kernel"] == "stream", fn.last_launch
            again = fn(*a, **kw)
            again = again if isinstance(again, tuple) else (again,)
            for x, x2, r in zip(got, again, ref):
                assert torch.equal(x, x2)
                if kind == "bwd":
                    assert x.dtype == r.dtype and torch.isfinite(x).all()
                    assert _max_rel(x.float(), r.float()) <= bound, (B, fn)
                else:
                    _assert_close(x, r, dtype)
        if _gru_stream_plan("bwd", B, H, cuda, dtype, 2) is None:
            x = [t.clone().requires_grad_(True) for t in ins]
            dys = [args[5], args[9]]
            grads = torch.autograd.grad(gru_cuda.bigru_recurrence(*x), x,
                                        dys)
            assert gru_cuda.bigru_bwd_cuda.last_launch["kernel"] == "stream"
            ref_g = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*x), x, dys)
            for name, a, r in zip(("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b",
                                   "db_b"), grads, ref_g):
                assert a.dtype == r.dtype and torch.isfinite(a).all(), name
                assert _max_rel(a.float(), r.float()) <= bound, (B, name)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The forward pipe kernels (csrc/bilstm_fwd_pipe.cu and csrc/bigru_fwd_pipe.cu:
# the route of #1/#1t, #3/#3t, #5/#5t and #7/#7t above H=256) at
# STREAM_WIDTHS x STREAM_BATCHES, float32 and bf16: the eight forward
# wrappers on the route against the plain versions, bit-equal run to run,
# and the four Functions' gradients through the new forward; the card's
# next plans at one shape; plans that do not fit refused.
# ---------------------------------------------------------------------------


def _gru_fwd_cases(shape, dtype, cuda):
    ins = _gru_inputs(*shape, dtype, cuda)
    return ((gru_cuda.bigru_fwd_cuda, ins, gru_cuda.bigru_fwd_plain(*ins), 2,
             False),
            (gru_cuda.bigru_fwd_train_cuda, ins,
             gru_cuda.bigru_fwd_train_plain(*ins), 2, True),
            (gru_cuda.gru_fwd_cuda, (ins[1], ins[4], ins[5], True),
             (gru_cuda.gru_recurrence(ins[1], ins[4], ins[5], True),), 1,
             False),
            (gru_cuda.gru_fwd_train_cuda, (ins[0], ins[2], ins[3], False),
             gru_cuda.gru_fwd_train_plain(ins[0], ins[2], ins[3]), 1, True))


def _fwd_cases(family, shape, dtype, cuda):
    return (_lstm_fwd_cases if family == "lstm" else _gru_fwd_cases)(
        shape, dtype, cuda)


def _card_fwd_pipe_plans(family, B, H, cuda, dtype, save, dirs):
    if family == "lstm":
        return rnn_cuda.card_lstm_fwd_pipe_plans(B, H, cuda, dtype, save,
                                                 dirs)
    return gru_cuda.card_gru_fwd_pipe_plans(B, H, cuda, dtype, save, dirs)


def _check_fwd_pipe(cuda, family, shape, dtype, plans_of):
    """The four forward wrappers of ``family`` under each plan
    ``plans_of(save, dirs)`` gives (None: the route, the planner's pick),
    on the pipe kernel, bit-equal run to run, against the plain versions;
    returns the plans checked."""
    B, N, H = shape
    seen = []
    for fn, ins, ref, dirs, save in _fwd_cases(family, shape, dtype, cuda):
        card = _card_fwd_pipe_plans(family, B, H, cuda, dtype, save, dirs)
        assert card
        for plan in plans_of(card):
            kw = {} if plan is None else {"plan": plan}
            before = fn.launches
            got = fn(*ins, **kw)
            got = got if isinstance(got, tuple) else (got,)
            assert fn.launches == before + 1
            last = fn.last_launch
            assert last["kernel"] == "pipe", last
            assert (last["cluster"], last["rows"]) == (
                card[0] if plan is None else plan[1:]), last
            again = fn(*ins, **kw)
            again = again if isinstance(again, tuple) else (again,)
            for a, a2, r in zip(got, again, ref):
                assert torch.equal(a, a2), plan
                _assert_close(a, r, dtype)
            seen.append((fn.__name__, plan))
    torch.cuda.synchronize()
    return seen


@pytest.mark.parametrize("family", ["lstm", "gru"])
@pytest.mark.parametrize("H", STREAM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_pipe_kernels_match_plain(cuda, family, H, dtype):
    route = (rnn_cuda.lstm_fwd_kernel_route(H) if family == "lstm" else
             gru_cuda.gru_fwd_kernel_route(H, 2, dtype))
    assert route == "pipe"
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for B in STREAM_BATCHES:
        shape = (B, STREAM_N, H)
        _check_fwd_pipe(cuda, family, shape, dtype, lambda card: [None])
        # the Functions' gradients through the new forward (and the BPTT's
        # pipe route)
        if family == "lstm":
            ins = [t.to(dtype) if t.dim() == 3 else t
                   for t in _inputs(*shape, cuda)]
            both, plain_both = (rnn_cuda.bilstm_recurrence,
                                rnn_cuda.bilstm_recurrence_plain)
            one = (rnn_cuda.lstm_recurrence_kernel, rnn_cuda.lstm_recurrence,
                   (ins[0], ins[2]), rnn_cuda.lstm_fwd_train_cuda)
            fwd_train = rnn_cuda.bilstm_fwd_train_cuda
        else:
            ins = _gru_inputs(*shape, dtype, cuda)
            both, plain_both = (gru_cuda.bigru_recurrence,
                                gru_cuda.bigru_fwd_plain)
            one = (gru_cuda.gru_recurrence_kernel, gru_cuda.gru_recurrence,
                   (ins[0], ins[2], ins[3]), gru_cuda.gru_fwd_train_cuda)
            fwd_train = gru_cuda.bigru_fwd_train_cuda
        g = torch.Generator(cuda).manual_seed(5)
        dys = [torch.randn(B, STREAM_N, H, device=cuda, generator=g
                           ).to(dtype) for _ in range(2)]
        x = [t.clone().requires_grad_(True) for t in ins]
        got = torch.autograd.grad(both(*x), x, dys)
        assert fwd_train.last_launch["kernel"] == "pipe"
        ref = torch.autograd.grad(plain_both(*x), x, dys)
        for i, (a, r) in enumerate(zip(got, ref)):
            assert a.dtype == r.dtype and torch.isfinite(a).all(), i
            assert _max_rel(a.float(), r.float()) <= bound, (B, i)
        kernel_fn, plain_fn, args, train_one = one
        for rev in (False, True):
            x = [t.clone().requires_grad_(True) for t in args]
            got = torch.autograd.grad(kernel_fn(*x, rev), x, dys[0])
            assert train_one.last_launch["kernel"] == "pipe"
            ref = torch.autograd.grad(plain_fn(*x, rev), x, dys[0])
            for i, (a, r) in enumerate(zip(got, ref)):
                assert a.dtype == r.dtype and torch.isfinite(a).all(), i
                assert _max_rel(a.float(), r.float()) <= bound, (B, i, rev)
    torch.cuda.synchronize()


@pytest.mark.parametrize("family", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_pipe_next_plans_match_plain(cuda, family, dtype):
    """The four forward wrappers under the card's next three pipe plans at
    (5, 9, 512) and (32, 9, 512) (the first is the route's), forced."""
    for B in (5, 32):
        seen = _check_fwd_pipe(
            cuda, family, (B, STREAM_N, 512), dtype,
            lambda card: [("pipe", *p) for p in card[1:4]])
        assert seen


def test_fwd_pipe_plans_that_do_not_fit_raise(cuda):
    """A forward pipe plan over 16 blocks, with a tile it has not, whose
    block needs more than 16 consumer warps, or with 16 rows where the
    block has no room for two row groups is refused, naming the plan,
    before any launch."""
    shape = (5, 4, 1816)
    for family in ("lstm", "gru"):
        for fn, ins, _, _, _ in _fwd_cases(family, shape, torch.float32,
                                           cuda):
            before = fn.launches
            for bad in (("pipe", 17, 4), ("pipe", 16, 6), ("pipe", 1, 16),
                        ("pipe", 16, 16)):
                with pytest.raises(ValueError,
                                   match=f"{bad[1]}x{bad[2]} does not fit"):
                    fn(*ins, plan=bad)
            assert fn.launches == before


# ---------------------------------------------------------------------------
# The float32 BiGRU at H <= 64 (the bigru model's defaults) on the unit
# kernels: #5 / #5t with a grid of two directions and #6 in one launch of
# two, at ragged batches and short walks, under every unit tile the card
# runs and the planner's pick, against the plain versions (values 1e-4,
# max-rel 1e-4), the BPTT bit-equal run to run; BiGRUFunction's gradients.
# ---------------------------------------------------------------------------

BIGRU_UNIT_SHAPES = [(1, 17, 64), (5, 43, 16), (20, 300, 64), (17, 5, 48)]


@pytest.mark.parametrize("shape", BIGRU_UNIT_SHAPES)
def test_bigru_unit_kernels_match_plain(cuda, shape):
    B, N, H = shape
    f32 = torch.float32
    assert gru_cuda.gru_fwd_kernel_route(H, 2, f32) == "unit"
    assert gru_cuda.gru_bwd_kernel_route(H, 2, f32) == "unit"
    ins = _gru_inputs(*shape, f32, cuda)
    args = _bwd_args(shape, f32, cuda)
    tiles = [None, *(("unit", r) for r in (1, 2, 4))]
    for fn, a, ref in (
            (gru_cuda.bigru_fwd_cuda, ins, gru_cuda.bigru_fwd_plain(*ins)),
            (gru_cuda.bigru_fwd_train_cuda, ins,
             gru_cuda.bigru_fwd_train_plain(*ins)),
            (gru_cuda.bigru_bwd_cuda, args, gru_cuda.bigru_bwd_plain(*args))):
        for plan in tiles:
            kw = {} if plan is None else {"plan": plan}
            before = fn.launches
            got = fn(*a, **kw)
            assert fn.launches == before + 1
            last = fn.last_launch
            assert last["kernel"] == "unit", last
            assert last["clusters"] == 2 * -(-B // last["rows"]), last
            for x, r in zip(got, ref):
                if fn is gru_cuda.bigru_bwd_cuda:
                    assert torch.isfinite(x).all()
                    assert _max_rel(x, r) <= GRAD_REL, plan
                else:
                    _assert_close(x, r, f32)
            if fn is gru_cuda.bigru_bwd_cuda:
                again = fn(*a, **kw)
                assert all(torch.equal(x, y) for x, y in zip(got, again))
    x = [t.clone().requires_grad_(True) for t in ins]
    dys = [args[5], args[9]]
    grads = torch.autograd.grad(gru_cuda.bigru_recurrence(*x), x, dys)
    assert gru_cuda.bigru_bwd_cuda.last_launch["kernel"] == "unit"
    ref_g = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*x), x, dys)
    for name, a, r in zip(("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b", "db_b"),
                          grads, ref_g):
        assert torch.isfinite(a).all(), name
        assert _max_rel(a, r) <= GRAD_REL, name
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The GRU register cluster kernels (csrc/bigru_fwd_reg.cu,
# csrc/bigru_bwd_reg.cu), the route of #5/#5t, #7/#7t, #6 and #8 at H
# 65-256 (float32; bf16 with one direction, and with two where no
# tensor-core plan fits): every wrapper on the route, both walk orders,
# against the plain versions, the BPTT bit-equal run to run; the card's
# register plans forced; BiGRUFunction's and GRUFunction's gradients; plans
# that do not fit refused.
# ---------------------------------------------------------------------------

REG_GRU_WIDTHS = (65, 128, 139, 201, 255, 256)
REG_GRU_BATCHES = (1, 5, 17)
REG_GRU_N = 24


def _reg_kernel(name, H, dtype):
    """The kernel the route takes for wrapper ``name`` at H: the
    tensor-core kernels keep bf16 two-direction launches where a plan of
    theirs fits."""
    dirs = 2 if name.startswith("bi") else 1
    route = (gru_cuda.gru_bwd_kernel_route if name.endswith("bwd")
             else gru_cuda.gru_fwd_kernel_route)
    return route(H, dirs, dtype)


@pytest.mark.parametrize("H", REG_GRU_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_reg_kernels_match_plain(cuda, H, dtype):
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    for B in REG_GRU_BATCHES:
        shape = (B, REG_GRU_N, H)
        ins = _gru_inputs(*shape, dtype, cuda)
        args = _bwd_args(shape, dtype, cuda)
        ref_b = gru_cuda.bigru_bwd_plain(*args)
        for name, fn, a, ref in (
                ("bigru_fwd", gru_cuda.bigru_fwd_cuda, ins,
                 gru_cuda.bigru_fwd_plain(*ins)),
                ("bigru_fwd_train", gru_cuda.bigru_fwd_train_cuda, ins,
                 gru_cuda.bigru_fwd_train_plain(*ins)),
                ("bigru_bwd", gru_cuda.bigru_bwd_cuda, args, ref_b),
                ("gru_fwd", gru_cuda.gru_fwd_cuda,
                 (ins[1], ins[4], ins[5], True),
                 (gru_cuda.bigru_fwd_plain(*ins)[1],)),
                ("gru_fwd_train", gru_cuda.gru_fwd_train_cuda,
                 (ins[0], ins[2], ins[3], False),
                 gru_cuda.gru_fwd_train_plain(ins[0], ins[2], ins[3])),
                ("gru_bwd", gru_cuda.gru_bwd_cuda,
                 (args[0], *args[2:6], False), ref_b[:2]),
                ("gru_bwd", gru_cuda.gru_bwd_cuda,
                 (args[1], *args[6:], True), ref_b[2:])):
            route = _reg_kernel(name, H, dtype)
            kw = {} if route == "reg" else {"plan": ("reg", *(
                gru_cuda.card_gru_reg_plans(
                    "bwd" if name.endswith("bwd") else "fwd", B, H, cuda,
                    dtype, name.endswith("train"), 2)[0]))}
            got = fn(*a, **kw)
            got = got if isinstance(got, tuple) else (got,)
            assert fn.last_launch["kernel"] == "reg", (name, fn.last_launch)
            if name.endswith("bwd"):
                again = fn(*a, **kw)
                for x, x2, r in zip(got, again, ref):
                    assert torch.equal(x, x2), (name, B)
                    assert x.dtype == r.dtype and torch.isfinite(x).all()
                    assert _max_rel(x.float(), r.float()) <= bound, (name, B)
            else:
                for x, r in zip(got, ref):
                    _assert_close(x, r, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_reg_every_tile_matches_plain(cuda, dtype):
    """The card's register plans of each kernel forced, every tile (1, 2,
    4 and 8 rows) among them, at a masked width and a batch that pads the
    8-row tile."""
    B, H = 17, 201
    shape = (B, REG_GRU_N, H)
    ins = _gru_inputs(*shape, dtype, cuda)
    args = _bwd_args(shape, dtype, cuda)
    for kind, fn, a, ref, save in (
            ("fwd", gru_cuda.bigru_fwd_train_cuda, ins,
             gru_cuda.bigru_fwd_train_plain(*ins), True),
            ("fwd", gru_cuda.bigru_fwd_cuda, ins,
             gru_cuda.bigru_fwd_plain(*ins), False)):
        plans = gru_cuda.card_gru_reg_plans(kind, B, H, cuda, dtype, save)
        assert {r for _, r in plans} == {1, 2, 4, 8}
        for c, r in plans:
            for x, y in zip(fn(*a, plan=("reg", c, r)), ref):
                _assert_close(x, y, dtype)
    plans = [("reg", *p) for p in gru_cuda.card_gru_reg_plans(
        "bwd", B, H, cuda, dtype)]
    assert {p[2] for p in plans} == {1, 2, 4, 8}
    _check_gru_bwd(cuda, shape, dtype, plans, "reg")


@pytest.mark.parametrize("shape,dtype", [((5, 43, 139), torch.float32),
                                         ((9, 30, 255), torch.bfloat16)])
def test_gru_reg_function_grads_match_autograd(cuda, shape, dtype):
    """BiGRUFunction's six and GRUFunction's three gradients through the
    register kernels against torch autograd through the plain loops."""
    ins = _gru_inputs(*shape, dtype, cuda)
    bound = GRAD_REL if dtype == torch.float32 else 0.1
    g = torch.Generator(cuda).manual_seed(5)
    dys = [torch.randn(shape, device=cuda, generator=g).to(dtype)
           for _ in range(2)]
    x = [t.clone().requires_grad_(True) for t in ins]
    got = torch.autograd.grad(gru_cuda.bigru_recurrence(*x), x, dys)
    assert gru_cuda.bigru_bwd_cuda.last_launch["kernel"] == "reg"
    ref = torch.autograd.grad(gru_cuda.bigru_fwd_plain(*x), x, dys)
    for name, a, r in zip(("dxg_f", "dxg_b", "dW_f", "db_f", "dW_b", "db_b"),
                          got, ref):
        assert a.dtype == r.dtype and torch.isfinite(a).all(), name
        assert _max_rel(a.float(), r.float()) <= bound, name
    for rev in (False, True):
        x = [t.clone().requires_grad_(True) for t in (ins[0], ins[2], ins[3])]
        got = torch.autograd.grad(gru_cuda.gru_recurrence_kernel(*x, rev), x,
                                  dys[0])
        assert gru_cuda.gru_bwd_cuda.last_launch["kernel"] == "reg"
        ref = torch.autograd.grad(gru_cuda.gru_recurrence(*x, rev), x, dys[0])
        for name, a, r in zip(("dxg", "dW_hh", "db_hh"), got, ref):
            assert a.dtype == r.dtype and torch.isfinite(a).all(), name
            assert _max_rel(a.float(), r.float()) <= bound, (name, rev)
    torch.cuda.synchronize()


def test_gru_reg_plans_that_do_not_fit_raise(cuda):
    """A register plan over 16 blocks, with a tile it has not, whose
    blocks exceed 256 threads or above H=256 is refused before any
    launch."""
    ins = _gru_inputs(3, 5, 256, torch.float32, cuda)
    args = _bwd_args((3, 5, 256), torch.float32, cuda)
    for plan in (("reg", 17, 1), ("reg", 16, 3), ("reg", 8, 1)):
        with pytest.raises(ValueError, match="does not fit"):
            gru_cuda.bigru_fwd_cuda(*ins, plan=plan)
        with pytest.raises(ValueError, match="does not fit"):
            gru_cuda.bigru_bwd_cuda(*args, plan=plan)
    wide = _gru_inputs(3, 5, 264, torch.float32, cuda)
    with pytest.raises(ValueError, match="does not fit"):
        gru_cuda.gru_fwd_cuda(wide[0], wide[2], wide[3], plan=("reg", 16, 1))


# ---------------------------------------------------------------------------
# The exact matcher (csrc/hungarian.cu) against its plain version: the
# assignments equal to the bit, ties included.
# ---------------------------------------------------------------------------

HUNGARIAN_CASES = [      # B, Q, M, integer costs (ties), share valid
    (20, 30, 50, False, 0.3),     # the flagship's matcher shape
    (20, 30, 50, True, 0.3),
    (128, 32, 32, False, 0.4),    # the scale-up model's
    (128, 32, 32, True, 0.4),
    (7, 5, 9, True, 0.9),         # M > Q
    (3, 40, 40, False, 1.0),
]


def _hungarian_case(B, Q, M, ints, share, device, seed=0):
    from room_slam_torch.ops import hungarian
    g = np.random.default_rng(seed)
    cost = (g.integers(0, 3, (B, Q, M)) if ints
            else g.normal(size=(B, Q, M))).astype(np.float32)
    valid = g.uniform(size=(B, M)) < share
    valid[0] = False                         # an item with no valid column
    return hungarian, (torch.tensor(cost, device=device),
                       torch.tensor(valid, device=device))


@pytest.mark.parametrize("case", HUNGARIAN_CASES)
def test_hungarian_kernel_matches_plain(cuda, case):
    """Both matcher forms on the card (one launch each) against the plain
    version of the same inputs on the CPU."""
    hungarian, (cost, valid) = _hungarian_case(*case, cuda)
    for fn in (hungarian.hungarian_match_fast, hungarian.hungarian_match):
        before = hungarian.hungarian_cuda.launches
        rows, matched = fn(cost, valid)
        torch.cuda.synchronize()
        assert hungarian.hungarian_cuda.launches == before + 1
        ref_rows, ref_matched = fn(cost.cpu(), valid.cpu())
        assert torch.equal(rows.cpu(), ref_rows), fn.__name__
        assert torch.equal(matched.cpu(), ref_matched), fn.__name__
        assert not matched[0].any()


def test_hungarian_kernel_solvers(cuda):
    """``solve_square`` and ``solve_rect`` (a device ``n_rows`` per item,
    0 and n included) on the card against the plain version."""
    from room_slam_torch.ops import hungarian
    g = np.random.default_rng(1)
    sq = torch.tensor(g.integers(0, 4, (9, 33, 33)), dtype=torch.float32,
                      device=cuda)
    assert torch.equal(hungarian.solve_square(sq).cpu(),
                       hungarian.solve_square(sq.cpu()))
    rect = torch.tensor(g.normal(size=(9, 12, 40)), dtype=torch.float32,
                        device=cuda)
    k = torch.tensor([0, 12, 3, 7, 1, 12, 5, 9, 2], device=cuda)
    assert torch.equal(hungarian.solve_rect(rect, k).cpu(),
                       hungarian.solve_rect(rect.cpu(), k.cpu()))
    with pytest.raises(ValueError, match="1023"):
        hungarian.hungarian_cuda(torch.zeros(1, 2, 1024, device=cuda))


def test_optimizer_capturable_matches_host_step(cuda):
    """AdamW capturable (a device learning rate and step count) against
    AdamW with a float learning rate and a host step count on the card:
    the same parameters after three updates, each at a new learning rate
    (a float, then a device tensor), and the same count."""
    from room_slam_torch.config import ExperimentConfig
    from room_slam_torch.train.loop import make_optimizer

    cfg = ExperimentConfig()
    torch.manual_seed(0)
    base = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                               torch.nn.Linear(5, 3)).to(cuda)
    models, opts = [], []
    for capturable in (True, False):
        m = copy.deepcopy(base)
        models.append(m)
        opts.append(make_optimizer(m, cfg, capturable=capturable))
    assert [o.capturable for o in opts] == [True, False]
    x = torch.randn(4, 6, device=cuda, generator=torch.Generator(cuda)
                    .manual_seed(1))
    for i, lr in enumerate((1e-3, torch.tensor(5e-4, device=cuda), 2e-4)):
        for m, o in zip(models, opts):
            o.set_learning_rate(lr)
            o.zero_grad()
            (m(x * (i + 1)) ** 2).sum().backward()
            o.step()
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    assert opts[0].count == opts[1].count == 3
    assert opts[0].lr == pytest.approx(opts[1].lr)


def test_forward_val_set_card_matches_cpu(cuda, tmp_path):
    """The calibration tool's cached forward of a flagship checkpoint
    (random weights, max_trace_len 300) on the card against the same call
    on the CPU, the 8 views x 2 temporal windows + the full trace each a
    light ``bilstm_fwd`` launch a layer and batch."""
    from pathlib import Path

    from room_slam_torch.config import ExperimentConfig
    from room_slam_torch.data.rooms import write_rooms
    from room_slam_torch.models.factory import build_model
    from room_slam_torch.tools.calibrate import _forward_val_set
    from room_slam_torch.train.checkpoint import save_checkpoint
    from room_slam_torch.weights import load_params, random_params

    cfg = ExperimentConfig.from_json(
        Path(__file__).resolve().parents[1] / "configs/flagship_v15.json")
    cfg.data.max_trace_len = 300
    model = build_model(cfg.model)
    load_params(model, random_params(model, 0))
    save_checkpoint(tmp_path / "best", model.state_dict(), config=cfg,
                    model=model)
    write_rooms(tmp_path / "val", 5, seed=1, points=(400, 600))
    args = (str(tmp_path / "best"), str(tmp_path / "val"), 4)
    kw = dict(tta=True, tta_reflect=True, tta_windows=2)
    before = rnn_cuda.bilstm_fwd_cuda.launches
    got = _forward_val_set(*args, device="cuda", **kw)
    launched = rnn_cuda.bilstm_fwd_cuda.launches - before
    want = _forward_val_set(*args, device="cpu", **kw)
    assert launched == cfg.model.lstm_layers * 8 * 3 * 2
    assert got["names"] == want["names"]
    for k in want:
        if k != "names":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                       err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_ops_opcheck_on_card(cuda, dtype):
    """``torch.library.opcheck`` of ``room_slam::bilstm_fwd`` and
    ``room_slam::bigru_fwd`` on CUDA tensors: the schema and the fake
    implementation against the kernels' outputs; each call launches the
    kernel (#1 / #5)."""
    from room_slam_torch.ops import gru_cuda

    g = np.random.default_rng(7)
    B, N, H = 3, 29, 64

    def t(*shape, scale=0.5):
        return torch.tensor(g.normal(size=shape) * scale,
                            dtype=torch.float32, device=cuda)

    lstm = [t(B, N, 4 * H).to(dtype), t(B, N, 4 * H).to(dtype),
            t(H, 4 * H, scale=0.1), t(H, 4 * H, scale=0.1)]
    gru = [t(B, N, 3 * H).to(dtype), t(B, N, 3 * H).to(dtype),
           t(H, 3 * H, scale=0.1), t(3 * H, scale=0.1),
           t(H, 3 * H, scale=0.1), t(3 * H, scale=0.1)]
    tests = ("test_schema", "test_faketensor")
    before = (rnn_cuda.bilstm_fwd_cuda.launches,
              gru_cuda.bigru_fwd_cuda.launches)
    torch.library.opcheck(torch.ops.room_slam.bilstm_fwd.default, lstm,
                          test_utils=tests)
    torch.library.opcheck(torch.ops.room_slam.bigru_fwd.default, gru,
                          test_utils=tests)
    assert rnn_cuda.bilstm_fwd_cuda.launches > before[0]
    assert gru_cuda.bigru_fwd_cuda.launches > before[1]
    for op, ins, plain in (
            (torch.ops.room_slam.bilstm_fwd, lstm,
             rnn_cuda.bilstm_recurrence_plain),
            (torch.ops.room_slam.bigru_fwd, gru, gru_cuda.bigru_fwd_plain)):
        got, ref = op(*ins), plain(*ins)
        for a, b in zip(got, ref):
            assert a.dtype == dtype and a.shape == (B, N, H)
            err = (a.float() - b.float()).abs().max().item()
            assert err <= (ATOL if dtype == torch.float32 else 0.03), err


def test_exported_program_matches_live_on_card(cuda, tmp_path):
    """A small lstm's serving program exported on the card, and the same
    program exported on the CPU and moved to the card, against the live
    ``predict.run``: each call launches #1 once a layer."""
    from room_slam_torch.config import ExperimentConfig, ModelConfig
    from room_slam_torch.models.factory import build_model
    from room_slam_torch.predictor import build_predictor
    from room_slam_torch.tools.export import export_checkpoint, load_exported
    from room_slam_torch.train.checkpoint import save_checkpoint
    from room_slam_torch.weights import load_params, random_params

    cfg = ExperimentConfig()
    cfg.model = ModelConfig(model_type="lstm", d_model=32, num_queries=8,
                            lstm_layers=2, dropout=0.0, objectness=True,
                            refine_stages=1)
    model = build_model(cfg.model)
    load_params(model, random_params(model, 0))
    save_checkpoint(tmp_path / "best", model.state_dict(), config=cfg,
                    model=model)
    point = dict(max_trace_len=200, threshold=0.0, nms=0.1, extent=1.0,
                 top_k=5, fuse=True)
    for device in ("cuda", "cpu"):
        export_checkpoint(str(tmp_path / "best"),
                          str(tmp_path / f"{device}.pt2"), device=device,
                          **point)
    predict = build_predictor(model, max_trace_len=200,
                              confidence_threshold=0.0, nms_threshold=0.1,
                              refine_furniture=True, extent_slack=1.0,
                              top_k=5, fuse=True, device=cuda, verbose=False)
    g = np.random.default_rng(3)
    feats = torch.tensor(g.normal(size=(1, 200, 11)), dtype=torch.float32,
                         device=cuda)
    feats[..., 3] = torch.cumsum(feats[..., 3].abs() * 0.03, dim=-1)
    mask = torch.ones(1, 200, dtype=torch.bool, device=cuda)
    mask[0, 150:] = False
    live = predict.run(feats, mask)
    for device in ("cuda", "cpu"):
        fn = load_exported(str(tmp_path / f"{device}.pt2"), device="cuda")
        before = rnn_cuda.bilstm_fwd_cuda.launches
        served = fn(feats, mask)
        assert rnn_cuda.bilstm_fwd_cuda.launches - before == 2
        assert served.is_cuda
        torch.testing.assert_close(served, live, rtol=0, atol=1e-5)


# ---------------------------------------------------- diagnose, parallel

from room_slam_torch import diagnose as diag_mod  # noqa: E402
from room_slam_torch.config import ExperimentConfig  # noqa: E402
from room_slam_torch.data.features import process_traces_np  # noqa: E402
from room_slam_torch.models import gru as gru_mod  # noqa: E402
from room_slam_torch.models import lstm as lstm_mod  # noqa: E402
from room_slam_torch.models.factory import build_model  # noqa: E402
from room_slam_torch.weights import load_params, random_params  # noqa: E402


@pytest.mark.parametrize("model_type", ["lstm", "bigru"])
def test_diagnose_forward_through_the_kernels(cuda, model_type):
    """``diagnose``'s padded forward (N=1000) launches #1 (lstm) or #5
    (bigru) once a layer and gives the plain recurrence's boxes (the model
    outputs' 1e-3)."""
    cfg = ExperimentConfig.from_json("configs/flagship_v15.json")
    cfg.model.model_type = model_type
    model = build_model(cfg.model)
    load_params(model, random_params(model, 0))
    model = model.to(cuda).eval()
    g = np.random.default_rng(1)
    raw = g.normal(size=(700, 4)).astype(np.float32)
    raw[:, 3] = np.sort(g.uniform(0, 30, 700))
    feats = process_traces_np(raw, max_len=diag_mod.PAD_TO)
    wrapper = (rnn_cuda.bilstm_fwd_cuda if model_type == "lstm"
               else gru_cuda.bigru_fwd_cuda)
    before = wrapper.launches
    got = diag_mod._forward(model, feats)
    torch.cuda.synchronize()
    # the bigru takes its depth from lstm_layers too (models/factory.py)
    assert wrapper.launches - before == cfg.model.lstm_layers
    patch = (mock.patch.object(lstm_mod, "bilstm_recurrence",
                               rnn_cuda.bilstm_recurrence_plain)
             if model_type == "lstm" else
             mock.patch.object(gru_mod, "bigru_recurrence",
                               gru_cuda.bigru_fwd_plain))
    with patch:
        ref = diag_mod._forward(model, feats)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_one_rank_nccl_mesh_step_and_pipeline(cuda, tmp_path):
    """On a one-rank NCCL group: the flagship-shaped step on a (1, 1) mesh
    gives the unsharded step's losses (rtol 1e-5) and gradients (1e-4 of
    the largest), through #1t / #2 and the matcher; ``pipeline_apply`` of
    ``bilstm_stage_fn`` at S=1 gives ``sequential_apply``'s output (1e-4)
    and gradients (max-rel 1e-4) through #3t / #4; the all-reduce and
    all-gather autograd functions on the group are the identity, forward
    and backward."""
    import torch.distributed as dist

    from room_slam_torch.ops import hungarian
    from room_slam_torch.parallel import collectives as coll
    from room_slam_torch.parallel import mesh as mesh_lib
    from room_slam_torch.parallel import pipeline as pipe
    from room_slam_torch.train import loop

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        cfg = ExperimentConfig.from_json("configs/flagship_v15.json")
        cfg.data.max_trace_len, cfg.train.batch_size = 200, 8
        init = build_model(cfg.model,
                           generator=torch.Generator().manual_seed(0))
        g = np.random.default_rng(2)
        B, L, M = 8, 200, cfg.data.max_colliders
        raw = np.cumsum(g.normal(size=(B, L, 4)) * 0.1, axis=1)
        raw[..., 3] = np.arange(L) * 0.03
        boxes = np.zeros((B, M, 6), np.float32)
        boxes[:, :4] = g.uniform(0.5, 3.0, size=(B, 4, 6))
        batch = {"raw": raw.astype(np.float32),
                 "length": np.full(B, L, np.int32), "boxes": boxes,
                 "labels": np.where(np.arange(M) < 4, 0, -1).repeat(
                     B).reshape(M, B).T.astype(np.int32),
                 "valid": (np.arange(M) < 4)[None].repeat(B, 0),
                 "rotation_k": np.zeros(B, np.int32),
                 "weight": np.ones(B, np.float32)}
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
                 for k, v in batch.items()}
        mesh = mesh_lib.make_mesh((1, 1))

        def step(on_mesh):
            model = copy.deepcopy(init).to(cuda)
            if on_mesh:
                mesh_lib.shard_params(model, mesh)
            opt = loop.make_optimizer(model, cfg)
            run = loop.make_train_step(model, opt, cfg, augment=True,
                                       mesh=mesh if on_mesh else None)
            losses = run(batch, torch.Generator(device=cuda).manual_seed(0))
            return ({k: float(v) for k, v in losses.items()},
                    {n: p.grad.clone() for n, p in model.named_parameters()})

        ref_l, ref_g = step(False)
        before = (rnn_cuda.bilstm_fwd_train_cuda.launches,
                  rnn_cuda.bilstm_bwd_cuda.launches,
                  hungarian.hungarian_cuda.launches)
        got_l, got_g = step(True)
        after = (rnn_cuda.bilstm_fwd_train_cuda.launches,
                 rnn_cuda.bilstm_bwd_cuda.launches,
                 hungarian.hungarian_cuda.launches)
        assert [a - b for a, b in zip(after, before)] == [
            cfg.model.lstm_layers, cfg.model.lstm_layers, 1]
        for k, v in ref_l.items():
            assert abs(got_l[k] - v) <= 1e-5 * abs(v) + 1e-7, k
        top = max(v.abs().max().item() for v in ref_g.values())
        for k, v in ref_g.items():
            assert (got_g[k] - v).abs().max().item() <= 1e-4 * top, k

        pmesh = pipe.make_pipeline_mesh((1, 1))
        gen = torch.Generator(device=cuda).manual_seed(3)
        stacked = pipe.init_bilstm_stage_params(gen, 1, 64, cuda)
        x = torch.randn(8, 300, 64, generator=gen, device=cuda)

        def run(fn):
            xx = x.clone().requires_grad_(True)
            ps = {k: v.clone().requires_grad_(True)
                  for k, v in stacked.items()}
            out = fn(ps, xx)
            out.pow(2).mean().backward()
            return out.detach(), [ps[k].grad for k in sorted(ps)] + [xx.grad]

        before = (rnn_cuda.lstm_fwd_train_cuda.launches,
                  rnn_cuda.lstm_bwd_cuda.launches)
        out, grads = run(lambda ps, xx: pipe.pipeline_apply(
            pipe.bilstm_stage_fn, ps, xx, pmesh, 4))
        assert (rnn_cuda.lstm_fwd_train_cuda.launches - before[0],
                rnn_cuda.lstm_bwd_cuda.launches - before[1]) == (8, 8)
        ref, rgrads = run(lambda ps, xx: pipe.sequential_apply(
            pipe.bilstm_stage_fn, ps, xx))
        assert (out - ref).abs().max().item() <= ATOL
        for a, b in zip(grads, rgrads):
            assert _max_rel(a, b) <= GRAD_REL

        # the collectives' autograd functions on the one-rank NCCL group:
        # the identity, forward and backward
        group = coll.axis(pmesh, "stage").group
        xc = x.clone().requires_grad_(True)
        w = torch.randn(8, 600, 64, generator=gen, device=cuda)
        y = torch.cat([coll._AllReduce.apply(xc, group),
                       coll._AllGather.apply(xc, group, 1, 0, 1)], dim=1)
        (y * w).sum().backward()
        assert torch.equal(y, torch.cat([x, x], dim=1))
        assert torch.equal(xc.grad, w[:, :300] + w[:, 300:])
    finally:
        dist.destroy_process_group()
