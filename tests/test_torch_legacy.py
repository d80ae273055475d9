"""The legacy GRU surface of the port on the CPU against the JAX package.

The ``RoomSlamGRU`` output dict through the weight bridge; the dataset
(``LegacyArrays`` of ``write_legacy_rooms`` files); ``legacy_criterion``'s
losses, gradients and assignments, and the invariance of both to the rows
of invalid columns; one training step against a JAX step built as
``train_legacy`` builds it (dropout 0); the rotated IoU and its mAP; the
occupancy baseline; the legacy checkpoint in both directions; and the
training and evaluation CLIs against the JAX ``evaluate_legacy``.

Tolerances: model outputs rtol 1e-4 / atol 1e-5 (float32 through two GRU
layers in another summation order); criterion losses rel 1e-5 and
gradients max-rel 1e-4; one step: losses rtol 1e-4, updated parameters
1e-6 where the gradient is live (AdamW's first step turns rounding noise
into +-lr elsewhere, so there 2 lr); rotated IoU atol 1e-5 (the same
clipping arithmetic in float32); AP 1e-6.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import evaluate as jax_evaluate
from room_slam_torch.data import legacy as tlegacy
from room_slam_torch.data.rooms import write_legacy_rooms
from room_slam_torch.evaluate import evaluate_legacy, load_legacy_model
from room_slam_torch.evaluate import main as evaluate_cli
from room_slam_torch.models.baseline import OccupancyBaseline
from room_slam_torch.models.factory import build_model as torch_build
from room_slam_torch.models.legacy_gru import RoomSlamGRU
from room_slam_torch.ops.iou import rotated_iou_2d
from room_slam_torch.ops.losses import legacy_criterion, legacy_match
from room_slam_torch.train import checkpoint as tckpt
from room_slam_torch.train.__main__ import main as train_cli
from room_slam_torch.train.driver import legacy_optimizer, make_legacy_step
from room_slam_torch.train.metrics import average_precision_rotated_2d
from room_slam_torch.weights import (_flatten, load_params, random_params,
                                     state_dict_to_params)
from room_slam_tpu.data import legacy as jlegacy
from room_slam_tpu.models.baseline import OccupancyBaseline as JaxBaseline
from room_slam_tpu.models.legacy_gru import RoomSlamGRU as JaxGRU
from room_slam_tpu.ops.hungarian import hungarian_match
from room_slam_tpu.ops.iou import rotated_iou_2d as jax_rotated_iou
from room_slam_tpu.ops.losses import legacy_criterion as jax_criterion
from room_slam_tpu.train import checkpoint as jckpt
from room_slam_tpu.train.metrics import \
    average_precision_rotated_2d as jax_ap

HIDDEN, SEQ, M, B = 32, 48, 10, 4
OUT_KEYS = ("classes", "positions", "sizes", "orientations", "validity")


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    """Seeded legacy rooms: walks of 60-130 points (some shorter than a
    window of 100, which resamples them), their windows of ``SEQ``."""
    d = tmp_path_factory.mktemp("legacy_rooms")
    write_legacy_rooms(d, 4, seed=0, points=(60, 130))
    return d


def _models(dropout=0.0, seed=3, layers=2):
    model = RoomSlamGRU(hidden_size=HIDDEN, max_objects=M, dropout=dropout,
                        gru_layers=layers)
    params = random_params(model, seed)
    load_params(model, params)
    return model, JaxGRU(hidden_size=HIDDEN, max_objects=M, dropout=dropout,
                         gru_layers=layers), params


def _jax_init(jmodel):
    return jax.device_get(jax.jit(lambda k: jmodel.init(
        {"params": k}, jnp.zeros((1, SEQ, 2))))(jax.random.key(0)))


def _traces(seed=0, n=3):
    rng = np.random.default_rng(seed)
    xy = np.cumsum(rng.normal(size=(n, SEQ, 2)) * 0.1, axis=1) + \
        rng.normal(size=(n, 1, 2)) * 3
    return xy.astype(np.float32)


def test_model_output_dict_matches_jax():
    model, jmodel, params = _models()
    traces = _traces()
    mask = np.ones(traces.shape[:2], bool)
    mask[1, 30:] = False
    for m in (None, mask):
        ref = jax.jit(lambda p, x, mm: jmodel.apply(p, x, mm))(
            params, jnp.asarray(traces), None if m is None
            else jnp.asarray(m))
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(traces),
                               None if m is None else torch.from_numpy(m))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_weight_bridge_and_factory():
    """JAX ``init`` parameters load into the port and map back unchanged,
    under the JAX names; the factory's ``gru`` type is this model."""
    jparams = _jax_init(JaxGRU(hidden_size=HIDDEN, max_objects=M))
    model = load_params(RoomSlamGRU(hidden_size=HIDDEN, max_objects=M),
                        jparams)
    back = _flatten(state_dict_to_params(model.state_dict())["params"])
    ref = _flatten(jparams["params"])
    assert set(back) == set(ref)
    assert {"gru_0.w_ih_fwd", "gru_0.b_ih_fwd", "gru_1.w_hh_bwd",
            "gru_1.b_hh_bwd", "latent_proj.kernel", "latent_proj2.bias",
            "class_head.kernel", "validity_head.bias"} <= set(back)
    for k in ref:
        np.testing.assert_array_equal(back[k], np.asarray(ref[k]), err_msg=k)
    from room_slam_torch.config import ModelConfig as TorchModelConfig
    built = torch_build(TorchModelConfig(model_type="gru", d_model=HIDDEN,
                                         num_queries=M, dropout=0.0))
    assert isinstance(built, RoomSlamGRU)
    assert built.state_dict().keys() == model.state_dict().keys()


def _criterion_case(seed=0):
    """Outputs and targets near them (a shuffled subset of the predicted
    positions plus noise, so no two assignments tie), one sample padded."""
    rng = np.random.default_rng(seed)
    out = {"classes": rng.normal(size=(B, M, 4)),
           "positions": rng.normal(size=(B, M, 2)) * 2,
           "sizes": rng.uniform(0.2, 2, size=(B, M, 2)),
           "orientations": rng.normal(size=(B, M, 1)),
           "validity": rng.normal(size=(B, M, 1))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    boxes = np.zeros((B, M, 5), np.float32)
    for i in range(B):
        boxes[i, :, :2] = out["positions"][i, rng.permutation(M)] \
            + rng.normal(scale=0.05, size=(M, 2))
    boxes[..., 2:4] = rng.uniform(0.2, 2, size=(B, M, 2))
    boxes[..., 4] = rng.normal(size=(B, M)) * 0.3
    valid = np.arange(M)[None] < np.array([[7], [10], [3], [5]])
    labels = np.where(valid, rng.integers(0, 4, (B, M)), -1).astype(np.int32)
    weight = np.array([1, 1, 1, 0], np.float32)
    targets = {"boxes": boxes, "labels": labels, "valid_mask": valid}
    return out, targets, weight


def _torch_criterion_grads(out, targets, weight):
    tout = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in out.items()}
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    losses = legacy_criterion(tout, tt, torch.from_numpy(weight))
    grads = torch.autograd.grad(losses["total_loss"],
                                [tout[k] for k in OUT_KEYS])
    return losses, dict(zip(OUT_KEYS, grads))


def test_legacy_criterion_matches_jax():
    out, targets, weight = _criterion_case()
    losses, grads = _torch_criterion_grads(out, targets, weight)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    ref = jax_criterion({k: jnp.asarray(v) for k, v in out.items()}, jt,
                        jnp.asarray(weight))
    assert set(losses) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5,
                                   err_msg=k)

    def total(*arrs):
        return jax_criterion(dict(zip(OUT_KEYS, arrs)), jt,
                             jnp.asarray(weight))["total_loss"]

    ref_g = jax.jit(jax.grad(total, argnums=tuple(range(5))))(
        *(jnp.asarray(out[k]) for k in OUT_KEYS))
    for k, r in zip(OUT_KEYS, ref_g):
        r = np.asarray(r)
        rel = np.abs(grads[k].numpy() - r).max() / (np.abs(r).max() + 1e-9)
        assert rel < 1e-4, (k, rel)

    # the same assignment on every matched column as JAX's exact solver
    prob = jax.nn.softmax(jnp.asarray(out["classes"]), -1)
    safe = jnp.clip(jt["labels"], 0, 3)
    cost = -jnp.take_along_axis(
        prob[:, :, None, :], jnp.broadcast_to(
            safe[:, None, :, None], (B, M, M, 1)), -1)[..., 0] \
        + 5.0 * jnp.abs(jnp.asarray(out["positions"])[:, :, None, :]
                        - jt["boxes"][:, None, :, :2]).sum(-1)
    ref_rows, ref_matched = jax.vmap(hungarian_match)(cost, jt["valid_mask"])
    rows, matched = legacy_match(
        {k: torch.from_numpy(out[k]) for k in ("classes", "positions")},
        {k: torch.from_numpy(v) for k, v in targets.items()})
    np.testing.assert_array_equal(matched.numpy(), np.asarray(ref_matched))
    np.testing.assert_array_equal(np.where(matched, rows, -1),
                                  np.where(ref_matched, ref_rows, -1))


def test_invalid_columns_carry_no_weight(monkeypatch):
    """The port's matcher gives invalid columns row 0 and JAX's exact solver
    some other row: scattering random rows into the invalid columns changes
    no loss and no gradient."""
    from room_slam_torch.ops import losses as loss_mod

    out, targets, weight = _criterion_case(seed=1)
    losses, grads = _torch_criterion_grads(out, targets, weight)
    match = loss_mod.hungarian_match_batch
    rng = np.random.default_rng(2)

    def scrambled(cost, valid):
        rows, matched = match(cost, valid)
        noise = torch.from_numpy(rng.integers(0, M, rows.shape))
        return torch.where(valid.bool(), rows, noise), matched

    monkeypatch.setattr(loss_mod, "hungarian_match_batch", scrambled)
    losses2, grads2 = _torch_criterion_grads(out, targets, weight)
    for k in losses:
        assert torch.equal(losses[k], losses2[k]), k
    for k in grads:
        assert torch.equal(grads[k], grads2[k]), k


def test_train_step_matches_jax(rooms):
    """One ``make_legacy_step`` update against the JAX step of
    ``train_legacy`` (optax ``clip_by_global_norm(1.0)`` + ``adamw(lr)``),
    dropout 0, same parameters and batch (one GRU layer and windows of 24:
    the model test above stacks two, and more only lengthen JAX's compile);
    the targets moved next to the predictions."""
    lr = 3e-3
    model, jmodel, params = _models(dropout=0.0, seed=5, layers=1)
    ds = tlegacy.LegacyArrays(rooms, seq_len=24, max_objects=M)
    sel = np.arange(B) % len(ds)
    traces = ds.traces[sel, :, 1:3].copy()
    with torch.no_grad():
        pos = model(torch.from_numpy(traces))["positions"].numpy()
    rng = np.random.default_rng(4)
    boxes = ds.boxes[sel].copy()
    for i in range(B):
        boxes[i, :, :2] = pos[i, rng.permutation(M)] + rng.normal(
            scale=0.05, size=(M, 2))
    batch = {"traces": traces, "boxes": boxes, "labels": ds.labels[sel],
             "valid": ds.valid[sel], "weight": np.array([1, 1, 1, 0],
                                                        np.float32)}

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jmodel.apply(p, jb["traces"], deterministic=False,
                           rngs={"dropout": jax.random.key(0)})
        ls = jax_criterion(out, {"boxes": jb["boxes"], "labels": jb["labels"],
                                 "valid_mask": jb["valid"]}, jb["weight"])
        return ls["total_loss"], ls

    jgrads, ref_losses = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    new = optax.apply_updates(params, updates)

    opt = legacy_optimizer(model, lr)
    losses = make_legacy_step(model, opt)(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    assert set(losses) == set(ref_losses)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    got = _flatten(state_dict_to_params(model.state_dict())["params"])
    ref = _flatten(jax.device_get(new)["params"])
    g = _flatten(state_dict_to_params({n: p.grad for n, p in opt.named})
                 ["params"])
    scale = max(np.abs(v).max() for v in g.values())
    for k in ref:
        live = np.abs(g[k]) > 1e-5 * scale
        diff = np.abs(got[k] - np.asarray(ref[k]))
        assert diff[live].max(initial=0.0) <= 1e-6, (k, diff[live].max())
        assert diff.max() <= 2 * lr + 1e-6, k


def _boxes(rng, n):
    return np.concatenate([rng.normal(size=(n, 2)) * 1.5,
                           rng.uniform(0.2, 3, (n, 2)),
                           rng.uniform(-3, 3, (n, 1))], 1).astype(np.float32)


def test_rotated_iou_and_ap_match_jax():
    rng = np.random.default_rng(0)
    pb, gb = _boxes(rng, 20), _boxes(rng, 10)     # 200 pairs
    got = rotated_iou_2d(torch.from_numpy(pb)[:, None],
                         torch.from_numpy(gb)[None]).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jax.vmap(
        jax_rotated_iou, in_axes=(None, 0)), in_axes=(0, None)))(pb, gb))
    assert (ref > 0).mean() > 0.3          # overlaps of every kind
    np.testing.assert_allclose(got, ref, atol=1e-5)

    sq = [0.0, 0.0, 1.0, 1.0, 0.0]
    inter = 2 * (np.sqrt(2) - 1)
    rect = [1.0, 2.0, 2.0, 0.5, 0.7]
    cases = [(sq, sq, 1.0), (sq, [5.0, 0.0, 1.0, 1.0, 0.3], 0.0),
             (sq, [0.5, 0.0, 1.0, 1.0, 0.0], 0.5 / 1.5),
             (sq, [0.0, 0.0, 1.0, 1.0, np.pi / 4], inter / (2 - inter)),
             (sq, [0.0, 0.0, 1.0, 1.0, np.pi / 2], 1.0),
             (rect, rect[:4] + [0.7 + np.pi], 1.0)]
    a = torch.tensor([c[0] for c in cases])
    b = torch.tensor([c[1] for c in cases])
    np.testing.assert_allclose(rotated_iou_2d(a, b).numpy(),
                               [c[2] for c in cases], atol=1e-5)

    # mAP over 3 images: GT, predictions near some of them, false alarms
    g_img = rng.integers(0, 3, 30)
    g_lab = rng.integers(0, 4, 30)
    gt = _boxes(rng, 30)
    keep = rng.random(30) < 0.7
    pred = np.concatenate([gt[keep] + rng.normal(scale=0.1, size=(
        keep.sum(), 5)).astype(np.float32), _boxes(rng, 10)])
    p_lab = np.concatenate([g_lab[keep], rng.integers(0, 4, 10)])
    p_img = np.concatenate([g_img[keep], rng.integers(0, 3, 10)])
    p_score = rng.random(len(pred)).astype(np.float32)
    got_map, got_aps = average_precision_rotated_2d(
        pred, p_lab, p_score, p_img, gt, g_lab, g_img, iou_thresh=0.3)
    ref_map, ref_aps = jax_ap(pred, p_lab, p_score, p_img, gt, g_lab, g_img,
                              iou_thresh=0.3)
    assert 0 < ref_map < 1
    assert abs(got_map - ref_map) < 1e-6
    assert got_aps.keys() == ref_aps.keys()
    for c in ref_aps:
        assert abs(got_aps[c] - ref_aps[c]) < 1e-6


def test_legacy_arrays_match_jax(rooms):
    for seq_len in (SEQ, 100):
        got = tlegacy.LegacyArrays(rooms, seq_len=seq_len, max_objects=M)
        ref = jlegacy.LegacyArrays(rooms, seq_len=seq_len, max_objects=M)
        assert len(got) == len(ref) > 0
        for k in ("traces", "boxes", "labels", "valid", "trace_id"):
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                          err_msg=k)
    pairs = tlegacy.find_legacy_pairs(rooms)
    assert len(pairs) == 4
    for a, b in zip(tlegacy.load_objects_json(pairs[0][1]),
                    jlegacy.load_objects_json(pairs[0][1])):
        np.testing.assert_array_equal(a, b)


def test_baseline_matches_jax(tmp_path):
    write_legacy_rooms(tmp_path, 2, seed=7, points=(1500, 2500))
    ds = tlegacy.LegacyArrays(tmp_path)
    for tid in range(2):
        full = np.concatenate([ds.traces[i]
                               for i in np.where(ds.trace_id == tid)[0]])
        got = OccupancyBaseline(device="cpu").predict(full)
        assert got == JaxBaseline().predict(full)
        assert len(got) > 0


def test_checkpoint_round_trips(tmp_path):
    """A port checkpoint restores into the JAX ``evaluate_legacy``
    template, and a JAX one loads into the port with the JAX outputs."""
    model, jmodel, params = _models(seed=8)
    tckpt.save_checkpoint(tmp_path / "port_legacy", model.state_dict(),
                          epoch=3, val_loss=1.5)
    template = _jax_init(jmodel)
    restored, _, side = jckpt.load_checkpoint(tmp_path / "port_legacy",
                                              template)
    assert side["epoch"] == 3
    ref = _flatten(params["params"])
    for k, v in _flatten(restored["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), ref[k], err_msg=k)

    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * 1.5, template)
    jckpt.save_checkpoint(tmp_path / "jax_legacy", jparams, epoch=1)
    loaded, side = load_legacy_model(str(tmp_path / "jax_legacy"), HIDDEN, M,
                                     device="cpu")
    assert side["epoch"] == 1 and not loaded.training
    traces = _traces(seed=9)
    out = jmodel.apply(jparams, jnp.asarray(traces))
    with torch.no_grad():
        got = loaded(torch.from_numpy(traces))
    for k in out:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(out[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_train_and_evaluate_clis_match_jax(rooms, tmp_path, capsys):
    """``python -m room_slam_torch.train`` auto-detects the CSV surface and
    trains on the CPU; ``python -m room_slam_torch.evaluate`` scores its
    checkpoint with the baseline beside it, as the JAX ``evaluate_legacy``
    does on the same checkpoint."""
    train_cli(["--data_dir", str(rooms), "--epochs", "2", "--batch_size",
               "4", "--hidden_size", str(HIDDEN), "--seq_len", str(SEQ),
               "--save_dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "auto-detected surface: legacy" in out
    summary = json.loads(out[out.rindex("\n{") + 1:])
    assert np.isfinite(summary["best_val_loss"])
    ckpt = str(tmp_path / "best_model_legacy")
    evaluate_cli(["--checkpoint", ckpt, "--data_dir", str(rooms),
                  "--hidden_size", str(HIDDEN), "--threshold", "0.0",
                  "--compare_baseline", "--output",
                  str(tmp_path / "m.json"), "--device", "cpu"])
    got = json.loads((tmp_path / "m.json").read_text())
    args = argparse.Namespace(checkpoint=ckpt, data_dir=str(rooms),
                              hidden_size=HIDDEN, max_objects=M,
                              threshold=0.0, iou_thresh=0.5,
                              compare_baseline=True, visualize=None)
    ref = jax_evaluate.evaluate_legacy(args)
    for k in ("mAP", "baseline_mAP"):
        assert abs(got[k] - ref[k]) < 1e-6, k
    assert got["checkpoint_epoch"] == ref["checkpoint_epoch"]
    direct = evaluate_legacy(ckpt, str(rooms), HIDDEN, M, threshold=0.0,
                             device="cpu")
    assert direct["mAP"] == got["mAP"]
    for argv in (["--surface", "bench"], ["--visualize", str(tmp_path)]):
        with pytest.raises(NotImplementedError, match="item"):
            evaluate_cli(["--checkpoint", ckpt, *argv, "--device", "cpu"])


def test_dropout_draws_from_the_generator():
    """Training mode draws dropout masks from the step's generator (the
    same seed gives the same outputs); eval mode is deterministic."""
    model, _, _ = _models(dropout=0.5)
    x = torch.from_numpy(_traces())
    a, b = (model.train()(x, generator=torch.Generator().manual_seed(1))
            ["positions"] for _ in range(2))
    c = model(x, generator=torch.Generator().manual_seed(2))["positions"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        e = model.eval()(x)["positions"]
    assert not torch.equal(a, e)
