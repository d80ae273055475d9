"""The single-direction recurrences of the port on the CPU against the JAX
package's Pallas kernels (interpret mode).

``ops/rnn.py`` ``gru_recurrence`` and ``lstm_recurrence`` (the plain loops,
and with ``use_kernel=True`` the dispatch to ``gru_cuda.gru_recurrence_kernel``
/ ``rnn_cuda.lstm_recurrence_kernel``) against ``gru_recurrence_pallas`` /
``lstm_recurrence_pallas``: values, and the gradients of ``GRUFunction`` /
``LSTMFunction`` (the kernels' plain versions on the CPU) against
``jax.grad`` through the Pallas kernels' ``custom_vjp``, both walk orders;
float64 gradchecks of both Functions; the launch plan of a one-direction
grid.

Tolerances, the JAX suite's: float32 values rtol 1e-5 / atol 1e-6,
gradients max-rel 1e-4 (max abs error over the reference's max abs value);
bfloat16 streams values rtol 0.05 / atol 0.03 and gradients max-rel 0.1
(both sides round to bf16 at the same points; a rounding that flips on one
side moves a value by one bf16 ulp, which later steps carry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.ops import gru_cuda, rnn_cuda
from room_slam_torch.ops.gru_cuda import GRUFunction, bigru_plan
from room_slam_torch.ops.rnn import gru_recurrence, lstm_recurrence
from room_slam_torch.ops.rnn_cuda import LSTMFunction
from room_slam_tpu.ops.gru_pallas import gru_recurrence_pallas
from room_slam_tpu.ops.rnn_pallas import lstm_recurrence_pallas

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=0.05, atol=0.03)
GRAD_REL = {"float32": 1e-4, "bfloat16": 0.1}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
B, H = 5, 16


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _max_rel(got, ref):
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


def _gru_inputs(N, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, N, 3 * H)) * 0.5).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) * 0.2).astype(np.float32),
            (rng.normal(size=(3 * H,)) * 0.2).astype(np.float32),
            rng.normal(size=(B, N, H)).astype(np.float32)]


@pytest.mark.parametrize("dtype,N", [("float32", 17), ("float32", 43),
                                     ("bfloat16", 17)])
def test_gru_matches_pallas(dtype, N):
    """Values of the plain loop and of the ``use_kernel`` dispatch, and
    ``GRUFunction``'s three gradients, against the interpret-mode Pallas
    kernel (the gate stream in ``dtype``; W_hh and b_hh float32)."""
    xg, w, b, dy = _gru_inputs(N, seed=N)
    td, jd = DTYPES[dtype]
    tol = F32 if dtype == "float32" else BF16
    tx = torch.from_numpy(xg).to(td)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    jx = jnp.asarray(xg).astype(jd)
    before = gru_cuda.gru_fwd_cuda.launches
    for reverse in (False, True):
        # the training call's outputs, which are the light call's (one
        # kernel body), and its VJP
        ref, vjp = jax.vjp(lambda x, ww, bb: gru_recurrence_pallas(
            x, ww, bb, reverse=reverse, interpret=True),
            jx, jnp.asarray(w), jnp.asarray(b))
        ref_g = vjp(jnp.asarray(dy).astype(jd))
        with torch.no_grad():
            light = gru_recurrence(tx, tw, tb, reverse, use_kernel=True)
        np.testing.assert_allclose(_np(light), _np(ref), **tol)
        np.testing.assert_allclose(_np(gru_recurrence(tx, tw, tb, reverse)),
                                   _np(ref), **tol)

        ins = [t.clone().requires_grad_(True) for t in (tx, tw, tb)]
        ys = gru_recurrence(*ins, reverse, use_kernel=True)
        assert type(ys.grad_fn).__name__ == "GRUFunctionBackward"
        got = torch.autograd.grad(ys, ins, torch.from_numpy(dy).to(td))
        for name, g, r, t in zip(("dxg", "dW_hh", "db_hh"), got, ref_g,
                                 (tx, tw, tb)):
            assert g.dtype == t.dtype, name
            assert _max_rel(g, r) < GRAD_REL[dtype], (name, reverse)
    assert gru_cuda.gru_fwd_cuda.launches == before     # CPU: no kernel


@pytest.mark.parametrize("N", [17, 43])
def test_lstm_matches_pallas(N):
    """Values (plain loop and the ``use_kernel`` dispatch) and
    ``LSTMFunction``'s two gradients against the interpret-mode Pallas
    kernel, float32."""
    rng = np.random.default_rng(N)
    xg = (rng.normal(size=(B, N, 4 * H)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(H, 4 * H)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(B, N, H)).astype(np.float32)
    tx, tw = torch.from_numpy(xg), torch.from_numpy(w)
    for reverse in (False, True):
        ref, vjp = jax.vjp(lambda x, ww: lstm_recurrence_pallas(
            x, ww, reverse=reverse, interpret=True),
            jnp.asarray(xg), jnp.asarray(w))
        ref_g = vjp(jnp.asarray(dy))
        with torch.no_grad():
            light = lstm_recurrence(tx, tw, reverse, use_kernel=True)
        np.testing.assert_allclose(light.numpy(), np.asarray(ref), **F32)
        ins = [t.clone().requires_grad_(True) for t in (tx, tw)]
        ys = lstm_recurrence(*ins, reverse, use_kernel=True)
        assert type(ys.grad_fn).__name__ == "LSTMFunctionBackward"
        np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ref),
                                   **F32)
        got = torch.autograd.grad(ys, ins, torch.from_numpy(dy))
        for name, g, r in zip(("dxg", "dW_hh"), got, ref_g):
            assert _max_rel(g, r) < GRAD_REL["float32"], (name, reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_functions_gradcheck(reverse):
    """The hand-written backwards (plain BPTT and the dW_hh / db_hh
    products, not autograd through the loop) against finite differences in
    float64."""
    g = torch.Generator().manual_seed(int(reverse))
    n, h = 7, 4

    def rand(*shape, s=0.3):
        return (torch.randn(*shape, generator=g, dtype=torch.float64) * s
                ).requires_grad_(True)

    assert torch.autograd.gradcheck(
        lambda x, w, b: GRUFunction.apply(x, w, b, reverse),
        [rand(2, n, 3 * h, s=0.5), rand(h, 3 * h), rand(3 * h)])
    assert torch.autograd.gradcheck(
        lambda x, w: LSTMFunction.apply(x, w, reverse),
        [rand(2, n, 4 * h, s=0.5), rand(h, 4 * h)])


def test_single_direction_plan_and_dispatch():
    """A grid of one direction holds half the clusters of a BiGRU grid: the
    legacy shape (B=32, H=64) takes one block of 4-row tiles, H=256 still
    splits W_hh across a cluster, and on a card holding 8 clusters of 8
    blocks B=128 runs in one wave. ``use_kernel`` takes no ``residuals``."""
    counts = {1: 132, 2: 66, 4: 30, 8: 15}

    def resident(c, rows):
        return counts[c]

    assert bigru_plan("fwd", 32, 64, resident, dirs=1) == (1, 4)
    assert bigru_plan("bwd", 32, 64, resident, dirs=1) == (1, 4)
    assert bigru_plan("fwd", 8, 256, resident, dirs=1)[0] > 1
    assert bigru_plan("bwd", 8, 256, resident, dirs=1)[0] > 1
    counts[8] = 8          # one direction: 8 tiles of 16 rows, one wave
    assert bigru_plan("bwd", 128, 256, resident, dirs=1) == (8, 16)
    x = torch.zeros(2, 3, 3 * H)
    with pytest.raises(ValueError, match="residuals"):
        gru_recurrence(x, torch.zeros(H, 3 * H), torch.zeros(3 * H),
                       residuals=True, use_kernel=True)
    with pytest.raises(ValueError):
        rnn_cuda.lstm_recurrence_kernel(torch.zeros(2, 3, 4 * H),
                                        torch.zeros(H, 3 * H))
