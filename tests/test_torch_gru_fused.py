"""The port's last two BiGRU kernels' plain versions on the CPU against the
JAX package, and the port's ``bench_bigru_bwd`` tool.

- #10, ``bigru_bwd_split_plain``, against the JAX micro-benchmark's
  ``_bwd_kernel_split`` itself. That kernel is a closure inside the tool's
  ``main()``: its code object (free variable ``pl`` only) is rebuilt into a
  function and run through ``pl.pallas_call(interpret=True)`` with the
  tool's BlockSpecs. The JAX kernel walks the backward-in-time direction on
  pre-flipped, time-major streams with h_prev built as ``_bigru_core_bwd``
  builds it, so that direction is flipped on the JAX side and flipped back.
- #9, ``bigru_layer`` (``BiGRULayerFunction``, whose backward on the CPU is
  ``bigru_bwd_fused_plain``), against ``bigru_layer_pallas(interpret=True)``
  at the JAX suite's shapes: the output and all nine gradients of
  ``sum(sin(.))``; the float32 case takes its weights from a JAX
  ``BiGRULayer`` through ``weights.bigru_layer_args``.
- The tool on the CPU writes JSON with the JAX tool's row keys.

Tolerances. float32: the JAX suite's rtol 1e-5 / atol 1e-6 on values and
max-rel 1e-4 on gradients (max abs error over the reference's max abs
value); only summation order differs. bfloat16 streams: rtol 0.05 / atol
0.03 on values and max-rel 0.1 on gradients, the suite's bf16 bounds: both
sides round at the same points, and a rounding that flips on one side moves
a value by one bf16 ulp, which the next steps carry.
"""

import functools
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from room_slam_torch.ops import gru_cuda
from room_slam_torch.weights import bigru_layer_args
from room_slam_tpu.models.gru import BiGRULayer
from room_slam_tpu.ops.gru_pallas import bigru_layer_pallas
from room_slam_tpu.ops.rnn_pallas import _pad_tm
from room_slam_tpu.tools import bench_bigru_bwd as jax_tool

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=0.05, atol=0.03)
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 0.1}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _max_rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _split_kernel():
    """The tool's ``_bwd_kernel_split``, rebuilt from its code object with
    ``pl`` as its one free variable."""
    code = next(c for c in jax_tool.main.__code__.co_consts
                if isinstance(c, types.CodeType)
                and c.co_name == "_bwd_kernel_split")
    assert code.co_freevars == ("pl",)
    return types.FunctionType(code, jax_tool.__dict__, None, None,
                              (types.CellType(pl),))


def _jax_split(w_f, w_b, streams, bb=8, chunk=4):
    """Run ``_bwd_kernel_split`` as the tool's ``run_split`` does, on
    time-major streams (gf, hnf, hpf, dyf, gb, hnb, hpb, dyb) of one dtype
    with f32 W_hh: ``(dxf, dhnf, dxb, dhnb)`` time-major."""
    N, B, H = streams[1].shape
    H3 = 3 * H
    dt = streams[0].dtype
    pads = [_pad_tm(a, chunk, bb) for a in streams]
    Np, Bp = pads[0].shape[:2]
    nc = Np // chunk
    rev = lambda b2, i: (nc - 1 - i, b2, 0)  # noqa: E731
    wspec = pl.BlockSpec((H3, H), lambda b2, i: (0, 0),
                         memory_space=pltpu.VMEM)
    g3 = pl.BlockSpec((chunk, bb, H3), rev, memory_space=pltpu.VMEM)
    g1 = pl.BlockSpec((chunk, bb, H), rev, memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(_split_kernel(), chunk=chunk, hidden=H),
        grid=(Bp // bb, nc),
        in_specs=[wspec, wspec, g3, g1, g1, g1, g3, g1, g1, g1],
        out_specs=[g3, g1, g3, g1],
        out_shape=[jax.ShapeDtypeStruct((Np, Bp, d), dt)
                   for d in (H3, H, H3, H)],
        scratch_shapes=[pltpu.VMEM((bb, H), jnp.float32),
                        pltpu.VMEM((bb, H), jnp.float32)],
        interpret=True,
    )(jnp.asarray(w_f.T).astype(dt), jnp.asarray(w_b.T).astype(dt), *pads)
    return [o[:N, :B] for o in out]


def _bwd_args(B, N, H, dtype, seed):
    """``bigru_bwd``'s arguments from the plain training forward of seeded
    gate streams, with a seeded upstream gradient."""
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.normal(size=(B, N, 3 * H)) * 0.5,
                       dtype=torch.float32).to(dtype) for _ in range(2)]
    ws = [torch.tensor(rng.normal(size=sz) * 0.2, dtype=torch.float32)
          for sz in ((H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    ys_f, ys_b, gs_f, gs_b, hn_f, hn_b = gru_cuda.bigru_fwd_train_plain(
        *xs, *ws)
    dy_f, dy_b = (torch.tensor(rng.normal(size=(B, N, H)),
                               dtype=torch.float32).to(dtype)
                  for _ in range(2))
    return ws[0], ws[2], gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b


@pytest.mark.parametrize("shape", [(5, 43, 16), (3, 17, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plain_matches_jax_split_kernel(shape, dtype):
    """#10's plain version against the JAX ``_bwd_kernel_split`` (and, in
    float32, against #6's plain version, which differs by sum order)."""
    args = _bwd_args(*shape, dtype, seed=sum(shape))
    w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b = args
    got = gru_cuda.bigru_bwd_split_plain(*args)
    assert all(g.dtype == dtype for g in got)
    jd = JDT[dtype]

    def tm(x, flip):    # [B, N, *] torch -> time-major jax, walk order
        a = np.swapaxes(_np(x), 0, 1)
        return jnp.asarray(a[::-1] if flip else a).astype(jd)

    def hprev(ys_t):    # as _bigru_core_bwd: zero, then ys one step back
        return jnp.concatenate([jnp.zeros_like(ys_t[:1]), ys_t[:-1]], 0)

    ysf_t, ysb_t = tm(ys_f, False), tm(ys_b, True)
    streams = [tm(gs_f, False), tm(hn_f, False), hprev(ysf_t),
               tm(dy_f, False), tm(gs_b, True), tm(hn_b, True),
               hprev(ysb_t), tm(dy_b, True)]
    ref = _jax_split(np.asarray(w_f), np.asarray(w_b), streams)
    tol = F32 if dtype == torch.float32 else BF16
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.swapaxes(_np(r), 0, 1)
        np.testing.assert_allclose(_np(g), r[:, ::-1] if i >= 2 else r,
                                   **tol, err_msg=str(i))
    if dtype == torch.float32:
        for g, r in zip(got, gru_cuda.bigru_bwd_plain(*args)):
            np.testing.assert_allclose(_np(g), _np(r), **F32)


def _layer_case(dtype):
    """``(x, weights)`` as numpy arrays: the float32 case at the JAX suite's
    (3, 53, 16, 24) with a JAX ``BiGRULayer``'s initial parameters (through
    ``bigru_layer_args``), the bf16 case at its (2, 40, 16, 16) with seeded
    normal weights."""
    rng = np.random.default_rng(0)
    if dtype == torch.float32:
        B, N, H, D = 3, 53, 16, 24
        x = (rng.normal(size=(B, N, D)) * 0.5).astype(np.float32)
        params = BiGRULayer(hidden=H).init(jax.random.key(1),
                                           jnp.asarray(x))["params"]
        ws = [t.numpy() for t in bigru_layer_args(params)]
        return x, ws
    B, N, H, D = 2, 40, 16, 16
    x = (rng.normal(size=(B, N, D)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=sz) * 0.1).astype(np.float32)
          for _ in range(2)
          for sz in ((D, 3 * H), (3 * H,), (H, 3 * H), (3 * H,))]
    return x, ws


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bigru_layer_matches_jax_fused_layer(dtype):
    """``bigru_layer`` against ``bigru_layer_pallas(interpret=True)``: the
    output (with and without grad) and the nine gradients of
    ``sum(sin(.))``, through ``BiGRULayerFunction`` and the fused
    backward's plain version."""
    x, ws = _layer_case(dtype)
    jd = JDT[dtype]
    jargs = [jnp.asarray(x).astype(jd)] + [jnp.asarray(w) for w in ws]
    targs = [torch.from_numpy(x).to(dtype)] + [torch.from_numpy(w)
                                               for w in ws]

    def jloss(*a):
        return jnp.sum(jnp.sin(bigru_layer_pallas(*a, interpret=True)
                               .astype(jnp.float32)))

    ref = bigru_layer_pallas(*jargs, interpret=True)
    ref_grads = jax.grad(jloss, tuple(range(9)))(*jargs)
    tol = F32 if dtype == torch.float32 else BF16
    with torch.no_grad():
        light = gru_cuda.bigru_layer(*targs)
    x_t = [t.clone().requires_grad_(True) for t in targs]
    before = gru_cuda.bigru_bwd_fused_cuda.launches
    y = gru_cuda.bigru_layer(*x_t)
    assert type(y.grad_fn).__name__ == "BiGRULayerFunctionBackward"
    for out in (light, y):
        assert out.dtype == dtype
        np.testing.assert_allclose(_np(out), _np(ref), **tol)
    grads = torch.autograd.grad(torch.sin(y.float()).sum(), x_t)
    assert gru_cuda.bigru_bwd_fused_cuda.launches == before  # CPU: plain
    names = ("dx", "dW_ih_f", "db_ih_f", "dW_hh_f", "db_hh_f", "dW_ih_b",
             "db_ih_b", "dW_hh_b", "db_hh_b")
    for name, g, r, t in zip(names, grads, ref_grads, targs):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert _max_rel(g, r) < GRAD_REL[dtype], (name, _max_rel(g, r))


def test_bigru_layer_args_is_strict():
    params = {f"{k}_{d}": np.zeros(1, np.float32) for d in ("fwd", "bwd")
              for k in ("w_ih", "b_ih", "w_hh", "b_hh")}
    assert len(bigru_layer_args(params)) == 8
    with pytest.raises(KeyError, match="missing"):
        bigru_layer_args({k: v for k, v in params.items() if k != "b_hh_bwd"})


def test_bench_tool_runs_on_cpu(tmp_path):
    """``python -m room_slam_torch.tools.bench_bigru_bwd --device cpu``
    writes JSON with the JAX tool's row keys (the plain versions standing
    for the launch plans)."""
    out = tmp_path / "bench.json"
    subprocess.run(
        [sys.executable, "-m", "room_slam_torch.tools.bench_bigru_bwd",
         "--device", "cpu", "--batch", "5", "--seq", "12", "--hidden", "16",
         "--tiles", "auto", "--reps", "1", "--output", str(out)],
        cwd=REPO, check=True, capture_output=True, timeout=300)
    result = json.loads(out.read_text())
    assert result["config"]["platform"] == "cpu"
    rows = result["measured_ms"]
    assert set(rows) == {"elementwise_pass_ms", "bwd_kernel@plain_ms",
                         "bwd_split@plain_ms", "dw_einsum_ms",
                         "hprev_build_ms", "core_bwd_ms", "full_vjp_ms"}
    assert all(np.isfinite(v) and v > 0 for v in rows.values())


def test_plan_mirror_check():
    """``_check_mirror`` passes a library whose ``bigru_bwd_smem_bytes``
    agrees with the wrapper's plan rule and shared-memory formula, and
    raises naming the plan where one value differs (the fused kind at
    H=256, plan 8x20, as if the source's chunk had changed)."""
    def smem(kind, H, C, R):
        name = {v: k for k, v in gru_cuda._BWD_KINDS.items()}[kind]
        return (gru_cuda.bigru_smem_bytes(name, H, C, R)
                if gru_cuda._plan_rule(name, H, C, R) else -1)

    gru_cuda._check_mirror(types.SimpleNamespace(bigru_bwd_smem_bytes=smem))
    fused = gru_cuda._BWD_KINDS["fused"]
    off = types.SimpleNamespace(bigru_bwd_smem_bytes=lambda k, H, C, R: (
        smem(k, H, C, R) + 4 * R * (k == fused and (H, C, R) == (256, 8, 20))))
    with pytest.raises(RuntimeError, match="H=256, plan 8x20"):
        gru_cuda._check_mirror(off)
