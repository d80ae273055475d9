"""The port's transformer family against the JAX package's on the same
bridged weights and inputs, at small width (d_model 32, 2 heads, 2 + 1
layers, FFN 64, 6 queries, B 5, N 17 and 43, ragged masks).

The weights come from ``weights.random_params`` (every layer norm's scale
and bias away from the identity, every refinement delta non-zero), handed
to both packages. Tolerances: values rtol 1e-5 / atol 1e-6 (float32, the
JAX suite's); gradients of a scalar loss max-rel 1e-4 per leaf (max abs
error over max abs reference). The keys' biases (``k_proj.bias``) shift
every score of a softmax row by the same amount, so their gradient is 0
in exact arithmetic and holds only rounding noise in both packages: they
are held to 1e-4 of the largest gradient instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.config import ModelConfig as TorchModelConfig
from room_slam_torch.models import common as tcommon
from room_slam_torch.models import transformer as ttrans
from room_slam_torch.models.factory import build_model as build_torch
from room_slam_torch.weights import (_flatten, load_params,
                                     params_to_state_dict, random_params,
                                     state_dict_to_params)
from room_slam_tpu.config import ModelConfig
from room_slam_tpu.models import common as jcommon
from room_slam_tpu.models import transformer as jtrans
from room_slam_tpu.models.factory import build_model

RTOL, ATOL = 1e-5, 1e-6
GRAD_REL = 1e-4
D, HEADS, FF, Q = 32, 2, 64, 6
B = 5
BASE = dict(model_type="transformer", d_model=D, nhead=HEADS, enc_layers=2,
            dec_layers=1, dim_feedforward=FF, num_queries=Q, dropout=0.0,
            use_pallas_rnn=False)
VARIANTS = {
    "reference": {},
    "objectness": dict(objectness=True),
    "center_xz": dict(center_xz=True),
    "refine_extent": dict(refine_stages=2, extent_features=True),
    "moe": dict(moe_experts=4),
}


def inputs(N, seed=0, width=11, walk=True):
    """``[B, N, width]`` float32 and a ragged mask (rows 1 and 3 short),
    padding zeroed; coordinates a random walk."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, width)).astype(np.float32)
    if walk:
        x[..., :3] += np.cumsum(rng.normal(size=(B, N, 3)) * 0.3, axis=1)
    m = np.ones((B, N), bool)
    m[1, N // 3:] = False
    m[3, 2 * N // 3:] = False
    x[~m] = 0.0
    return x, m


def close(got, ref, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def same_tree(a, b):
    """Two ``{"params": ...}`` trees have the same leaves and shapes."""
    fa, fb = _flatten(a["params"]), _flatten(b["params"])
    assert {k: np.shape(v) for k, v in fa.items()} == \
        {k: np.shape(v) for k, v in fb.items()}


def module_pair(jmod, tmod, *args, seed=0):
    """Seeded weights for the port module ``tmod`` in the JAX layout,
    loaded into it; the tree has the flax module ``jmod``'s leaves and
    shapes (its init on ``args``). Returns the tree and ``tmod`` in eval
    mode."""
    params = random_params(tmod, seed)
    same_tree(params, jax.jit(jmod.init)(jax.random.key(0),
                                         *(jnp.asarray(a) for a in args)))
    load_params(tmod, params)
    return params, tmod.eval()


@pytest.mark.parametrize("d_model", [32, 6])
@pytest.mark.parametrize("length", [17, 43])
def test_sinusoidal_positions(length, d_model):
    got = tcommon.sinusoidal_positions(length, d_model)
    close(got.numpy(), jcommon.sinusoidal_positions(length, d_model))
    assert got.dtype == torch.float32
    half = tcommon.sinusoidal_positions(length, d_model, torch.bfloat16)
    assert torch.equal(half, got.to(torch.bfloat16))


def test_layer_norm_matches_flax():
    """Inputs of a non-zero mean (the fast variance's weak case) and
    scale / bias away from the identity."""
    import flax.linen as nn

    x, _ = inputs(43, seed=1, width=D, walk=False)
    x = x * 3.0 + 5.0
    ln = tcommon.LayerNorm(D)
    params = random_params(ln, 1)
    load_params(ln, params)
    ref = jax.jit(nn.LayerNorm().apply)(params, jnp.asarray(x))
    close(ln(torch.from_numpy(x)).detach().numpy(), ref)
    assert ln.eps == 1e-6


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("tq,tk", [(17, 43), (43, 43)])
def test_multi_head_attention(tq, tk, masked):
    q, _ = inputs(tq, seed=2, width=D, walk=False)
    kv, m = inputs(tk, seed=3, width=D, walk=False)
    mask = m if masked else None
    jm = jcommon.MultiHeadAttention(D, HEADS)
    params, tm = module_pair(jm, tcommon.MultiHeadAttention(D, HEADS),
                             q, kv, kv, seed=2)
    ref = jax.jit(jm.apply)(params, jnp.asarray(q), jnp.asarray(kv),
                            jnp.asarray(kv), None if mask is None
                            else jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(kv),
                 torch.from_numpy(kv),
                 None if mask is None else torch.from_numpy(mask))
    close(got.numpy(), ref)


@pytest.mark.parametrize("moe", [0, 4])
def test_encoder_layer(moe):
    x, m = inputs(43, seed=4, width=D, walk=False)
    x = x + 2.0                        # layer norms of a non-zero mean
    jm = jtrans.EncoderLayer(D, HEADS, FF, 0.0, moe_experts=moe)
    params, tm = module_pair(jm, ttrans.EncoderLayer(D, HEADS, FF, 0.0, moe),
                             x, m, seed=4)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(m))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(m))
    close(got.numpy(), ref)


def test_decoder_layer():
    tgt, _ = inputs(Q, seed=5, width=D, walk=False)
    mem, m = inputs(43, seed=6, width=D, walk=False)
    jm = jtrans.DecoderLayer(D, HEADS, FF, 0.0)
    params, tm = module_pair(jm, ttrans.DecoderLayer(D, HEADS, FF, 0.0),
                             tgt, mem, m, seed=5)
    ref = jax.jit(jm.apply)(params, jnp.asarray(tgt), jnp.asarray(mem),
                            jnp.asarray(m))
    with torch.no_grad():
        got = tm(torch.from_numpy(tgt), torch.from_numpy(mem),
                 torch.from_numpy(m))
    close(got.numpy(), ref)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    """One model variant: the JAX model, the port's with the same seeded
    weights, the tree, 43-step inputs and the scalar loss's weights."""
    kw = {**BASE, **VARIANTS[request.param]}
    jmodel = build_model(ModelConfig(**kw))
    tmodel = build_torch(TorchModelConfig(**kw))
    params = random_params(tmodel, 7)
    load_params(tmodel, params)
    x, m = inputs(43, seed=8)
    same_tree(params, jax.jit(lambda k: {"params": jmodel.init(
        k, jnp.asarray(x), jnp.asarray(m))["params"]})(jax.random.key(0)))
    fwd = jax.jit(lambda p: jmodel.apply(p, jnp.asarray(x), jnp.asarray(m),
                                         deterministic=True))
    return request.param, fwd, tmodel, params, x, m


def test_model_forward_matches_jax(variant):
    name, fwd, tmodel, params, x, m = variant
    ref = fwd(params)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x), torch.from_numpy(m))
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        close(got[k].numpy(), ref[k], err_msg=f"{name}: {k}")


def test_model_gradients_match_jax(variant):
    """Gradients of ``sum_k <out_k, W_k>`` (W seeded) over every leaf."""
    name, fwd, tmodel, params, x, m = variant
    rng = np.random.default_rng(9)
    W = {k: rng.normal(size=np.shape(v)).astype(np.float32)
         for k, v in sorted(fwd(params).items())}

    def loss(p):
        out = fwd(p)
        return sum(jnp.sum(out[k] * W[k]) for k in W)

    jg = _flatten(jax.device_get(jax.jit(jax.grad(loss))(params))["params"])
    tmodel.eval().zero_grad()
    out = tmodel(torch.from_numpy(x), torch.from_numpy(m))
    sum((out[k] * torch.from_numpy(W[k])).sum() for k in W).backward()
    tg = _flatten(state_dict_to_params(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel)["params"])
    assert set(tg) == set(jg)
    top = max(np.abs(v).max() for v in jg.values())
    for k, v in jg.items():
        err = np.abs(tg[k] - v).max()
        scale = top if k.endswith("k_proj.bias") else np.abs(v).max()
        assert err <= GRAD_REL * scale, (name, k, err, scale)


def test_model_without_mask_matches_jax():
    """A mask-less call at N 17 (the encoder's all-valid mask, the decoder's
    unmasked anchor attention)."""
    kw = {**BASE, "refine_stages": 1}
    jmodel = build_model(ModelConfig(**kw))
    tmodel = build_torch(TorchModelConfig(**kw))
    params = random_params(tmodel, 10)
    load_params(tmodel, params)
    x, _ = inputs(17, seed=11)
    ref = jax.jit(lambda p: jmodel.apply(p, jnp.asarray(x),
                                         deterministic=True))(params)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x))
    for k in ref:
        close(got[k].numpy(), ref[k], err_msg=k)


def test_dropout_draws_from_the_generator():
    """Training mode draws every dropout mask from the forward's generator:
    the same seed gives the same outputs, another seed others; eval mode
    is deterministic and ignores it."""
    kw = {**BASE, "dropout": 0.3, "moe_experts": 2}
    model = build_torch(TorchModelConfig(**kw),
                        generator=torch.Generator().manual_seed(0))
    x, m = (torch.from_numpy(a) for a in inputs(17, seed=12))

    def run(seed):
        with torch.no_grad():
            return model(x, m, generator=torch.Generator().manual_seed(seed)
                         )["pred_boxes"]

    model.train()
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    model.eval()
    assert torch.equal(run(1), run(2))


def test_init_is_seeded_and_bridges_to_jax():
    """The generator seeds the init (the JAX package's distributions:
    layer norms at the identity, experts in their bounds); the tree it
    gives loads into the JAX model, whose forward matches."""
    kw = {**BASE, "moe_experts": 2, "objectness": True}
    a = build_torch(TorchModelConfig(**kw),
                    generator=torch.Generator().manual_seed(3))
    b = build_torch(TorchModelConfig(**kw),
                    generator=torch.Generator().manual_seed(3))
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    sd = a.state_dict()
    assert torch.equal(sd["encoder.layer_0.norm1.weight"], torch.ones(D))
    assert torch.equal(sd["encoder.layer_0.norm1.bias"], torch.zeros(D))
    assert sd["encoder.layer_1.moe.w2"].abs().max() <= 1 / np.sqrt(FF)
    params = state_dict_to_params(sd, a)
    x, m = inputs(17, seed=13)
    jmodel = build_model(ModelConfig(**kw))
    ref = jax.jit(lambda p: jmodel.apply(p, jnp.asarray(x), jnp.asarray(m),
                                         deterministic=True))(params)
    with torch.no_grad():
        got = a.eval()(torch.from_numpy(x), torch.from_numpy(m))
    for k in ref:
        close(got[k].numpy(), ref[k], err_msg=k)
    # and the state dict goes back through the bridge unchanged
    back = params_to_state_dict(params, a)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
