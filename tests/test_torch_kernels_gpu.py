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

import numpy as np
import pytest
import torch

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
    wide = _inputs(1, 3, 128, cuda)     # W_hh^T of H=128 overflows a block
    with pytest.raises(ValueError, match="shared memory"):
        rnn_cuda.bilstm_fwd_train_cuda(*wide)


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
