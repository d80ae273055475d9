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
