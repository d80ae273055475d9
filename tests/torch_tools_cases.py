"""Shared inputs of the model-selection tools' tests: small JAX-package
checkpoints (written with the JAX ``save_checkpoint``, which both packages
load) and seeded room directories with a ragged last batch."""

import functools
from pathlib import Path

import jax
import numpy as np

from room_slam_torch.data.rooms import write_rooms
from room_slam_tpu.config import ExperimentConfig
from room_slam_tpu.models.factory import build_model, init_params
from room_slam_tpu.train.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
MAX_LEN = 48


@functools.lru_cache(maxsize=None)
def _init(model_type, d_model, num_queries, objectness):
    """The config and initial parameters of one small model (one JAX init
    compile a shape, shared by the checkpoints drawn from it)."""
    cfg = ExperimentConfig.from_json(REPO / "configs/flagship_v15.json")
    cfg.model.model_type = model_type
    cfg.model.d_model, cfg.model.num_queries = d_model, num_queries
    cfg.model.use_pallas_rnn = False
    cfg.model.objectness = objectness
    cfg.data.max_trace_len = MAX_LEN
    return cfg, init_params(build_model(cfg.model), cfg.model,
                            seq_len=MAX_LEN)


def small_checkpoint(path, seed=0, model_type="lstm", d_model=32,
                     num_queries=12, noise=0.2, objectness=True):
    """A flagship-shaped checkpoint (d_model 32, 12 queries, traces of
    ``MAX_LEN``) with noise on every leaf; ``model_type`` "bigru" takes the
    flagship's config with that model type."""
    cfg, params = _init(model_type, d_model, num_queries, objectness)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + noise * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)
    save_checkpoint(path, params, config=cfg)
    return str(path)


def rooms(path, n=5, seed=4, points=(120, 200)):
    write_rooms(path, n, seed=seed, points=points)
    return str(path)


def doctor(cached, seed=0):
    """A copy of cached forwards whose first candidates of each capture are
    noisy copies of its valid GT boxes (two of each where the query axis
    has room), with logits favouring the GT's label by a few discrete
    margins (so that confidences tie) and objectness at a few levels: AP,
    the NMS and the post-passes then see true positives, duplicates and
    ties. Both packages are handed the same copy."""
    rng = np.random.default_rng(seed)
    out = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
           for k, v in cached.items()}
    _, Q, _ = out["pred_boxes"].shape
    C = out["pred_logits"].shape[-1]
    for i in range(out["pred_boxes"].shape[0]):
        gv = np.where(out["gt_valid"][i])[0][:Q]
        if 2 * len(gv) <= Q:
            gv = np.concatenate([gv, gv])
        n = len(gv)
        noise = rng.normal(0, 0.08, (n, 6)) * [1, 0.3, 1, 0.2, 0.2, 0.2]
        boxes = out["gt_boxes"][i, gv] + noise
        boxes[:, 3:] = np.abs(boxes[:, 3:]) + 0.05
        out["pred_boxes"][i, :n] = boxes
        lab = out["gt_labels"][i, gv]
        logits = rng.normal(0, 0.3, (n, C))
        logits[np.arange(n), lab] += rng.choice([1.0, 2.0, 2.0, 3.0], n)
        out["pred_logits"][i, :n] = logits
        if "pred_objectness" in out:
            out["pred_objectness"][i, :n] = rng.choice([0.0, 1.0, 2.0], n)
    for k in ("pred_boxes", "pred_logits", "pred_objectness"):
        if k in out:
            out[k] = out[k].astype(np.float32)
    return out


def assert_cells(got, want, tol=1e-6):
    """The same cells in the same order: the operating point and the
    counts equal, mAP and det_f1 within ``tol``, AP per class within its
    rounding (1e-3)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k.startswith(("mAP", "det_f1")):
                assert abs(g[k] - v) <= tol, (k, g[k], v, w)
            elif k.startswith("AP_per_class"):
                assert g[k].keys() == v.keys(), (k, g[k], v)
                for c in v:
                    assert abs(g[k][c] - v[c]) <= 1e-3, (k, c, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)
