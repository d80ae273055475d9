"""The port's GPipe pipeline (``room_slam_torch/parallel/pipeline.py``)
on gloo CPU ranks against the JAX package's: a 4-stage BiLSTM pipeline on
('data', 'stage') meshes (1, 4) with 4 microbatches and (2, 4) with 8
gives ``sequential_apply``'s output, stage gradients and input gradient
of ``mean(out ** 2)`` computed by the JAX package, the JAX pipeline's own
test's case and tolerance (atol 1e-5; ``tests/test_pipeline.py`` holds the
JAX pipeline to the same sequential numbers). The same on a (4, 1) mesh,
one stage on every rank (the schedule with its shift the identity, the
only pipeline a one-card machine runs), against the first stage alone. A
stacked 8-stage set on a 4-stage mesh raises. One spawn of 4 ranks and one
of 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.parallel import pipeline as tpipe
from room_slam_tpu.parallel import pipeline as jpipe
from torch_parallel_cases import pipeline_mismatch, pipeline_run, spawn

S, D, B, L = 4, 8, 16, 12
ATOL = 1e-5


def _jax_case(params, x):
    """JAX's sequential output and gradients of ``mean(out ** 2)``."""

    def loss(p, x):
        return jnp.mean(jpipe.sequential_apply(jpipe.bilstm_stage_fn, p,
                                               x) ** 2)

    out = np.asarray(jax.jit(lambda p, x: jpipe.sequential_apply(
        jpipe.bilstm_stage_fn, p, x))(params, x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    params = {k: np.array(v) for k, v in params.items()}
    return params, x, out, {k: np.asarray(v) for k, v in gp.items()}, \
        np.asarray(gx)


@pytest.fixture(scope="module")
def case():
    """The JAX pipeline test's parameters and input, and JAX's sequential
    output and gradients."""
    params = jax.device_get(jpipe.init_bilstm_stage_params(
        jax.random.key(0), S, D))
    x = np.array(jax.random.normal(jax.random.key(1), (B, L, D),
                                   jnp.float32))
    return _jax_case(params, x)


@pytest.fixture(scope="module")
def one_stage(case):
    """The first stage of ``case`` alone, with its JAX numbers."""
    params, x, *_ = case
    return _jax_case({k: v[:1] for k, v in params.items()}, x)


@pytest.fixture(scope="module")
def four_ranks(case, one_stage, tmp_path_factory):
    return spawn(4, tmp_path_factory.mktemp("pipe4"), {
        "pipe": (pipeline_run, {"mesh": (1, 4), "params": case[0],
                                "x": case[1], "microbatches": 4}),
        "one_stage": (pipeline_run, {"mesh": (4, 1),
                                     "params": one_stage[0],
                                     "x": one_stage[1], "microbatches": 2}),
        "mismatch": (pipeline_mismatch, {
            "mesh": (1, 4),
            "params": jax.device_get(jpipe.init_bilstm_stage_params(
                jax.random.key(0), 8, 8))})})


def _check(res, out, gp, gx):
    np.testing.assert_allclose(res["out"], out, atol=ATOL)
    for k in gp:
        np.testing.assert_allclose(res["grads"][k], gp[k], atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(res["gx"], gx, atol=ATOL)


def test_sequential_apply_matches_jax(case):
    params, x, out, gp, gx = case
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tpipe.sequential_apply(tpipe.bilstm_stage_fn, tp, tx)
    y.pow(2).mean().backward()
    _check({"out": y.detach().numpy(),
            "grads": {k: v.grad.numpy() for k, v in tp.items()},
            "gx": tx.grad.numpy()}, out, gp, gx)
    stacked = tpipe.stack_stage_params(
        [{k: v[s] for k, v in tp.items()} for s in range(S)])
    assert stacked["w_hh_fwd"].shape == (S, D // 2, 2 * D)
    init = tpipe.init_bilstm_stage_params(torch.Generator().manual_seed(0),
                                          3, D)
    k = 1.0 / np.sqrt(D // 2)
    assert init["w_ih_bwd"].shape == (3, D, 2 * D)
    assert all(float(v.abs().max()) <= k for v in init.values())


def test_pipeline_on_four_ranks(case, four_ranks):
    params, x, out, gp, gx = case
    _check(four_ranks["pipe"], out, gp, gx)
    assert "stage" in four_ranks["mismatch"]


def test_pipeline_of_one_stage_a_rank(one_stage, four_ranks):
    params, x, out, gp, gx = one_stage
    _check(four_ranks["one_stage"], out, gp, gx)


def test_pipeline_with_data_parallelism(case, tmp_path):
    params, x, out, gp, gx = case
    res = spawn(8, tmp_path, {
        "pipe": (pipeline_run, {"mesh": (2, 4), "params": params, "x": x,
                                "microbatches": 8})})
    _check(res["pipe"], out, gp, gx)
