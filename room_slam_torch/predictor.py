"""Single-trace predictor: featurize -> forward -> post-passes ->
post-process -> collider dicts (counterpart of the JAX package's
``predictor.py``).

Each call featurizes the trace in every test-time view (rotations,
reflection, scales; row 0 is the capture frame), pads the views to
``[R, max_trace_len, F]`` with a mask, and on the model's device runs the
forward, maps each view's boxes back to the capture frame, pools the R·Q
candidates and runs the trace-informed post-passes in the reference's
order (refine -> ycal -> wall synthesis -> furniture synthesis -> ttopt ->
extent mask -> qscore) and ``post_process``; one stacked result comes back
to the host.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from room_slam_torch import resolve_device
from room_slam_torch.data import formats
from room_slam_torch.data.augment import unreflect_boxes, unrotate_boxes
from room_slam_torch.data.features import process_traces_np
from room_slam_torch.ops import qscore as qscore_ops
from room_slam_torch.ops import refine
from room_slam_torch.ops.nms import post_process
from room_slam_torch.ops.ttopt import TTOptParams, adapt_boxes


def model_input_dim(model: nn.Module, default: int = 11) -> int:
    """The encoder's input width, read from ``encoder.input_proj`` (the
    source of truth even where the saved config disagrees); ``default``
    for a model without one."""
    proj = getattr(getattr(model, "encoder", None), "input_proj", None)
    return int(proj.in_features) if isinstance(proj, nn.Linear) else default


def adapt_features(feats: np.ndarray, in_feat: int) -> np.ndarray:
    """Truncate or zero-pad the trailing feature dim to the model's input
    width, so a checkpoint trained on fewer features (e.g. raw 4-D) runs."""
    cur = feats.shape[-1]
    if cur == in_feat:
        return feats
    if cur > in_feat:
        return feats[..., :in_feat]
    pad = np.zeros((*feats.shape[:-1], in_feat - cur), feats.dtype)
    return np.concatenate([feats, pad], axis=-1)


def _max_confidence(logits: torch.Tensor, objectness) -> torch.Tensor:
    """The auto gates' signal: the largest candidate confidence."""
    conf = torch.softmax(logits, dim=-1).amax(dim=-1)
    if objectness is not None:
        conf = conf * torch.sigmoid(objectness)
    return conf.amax()


def build_predictor(model: nn.Module, max_trace_len: int = 3000,
                    confidence_threshold: float = 0.7,
                    nms_threshold: float = 0.3,
                    refine_clearance: float | None = None,
                    refine_trust: float = 0.4,
                    refine_furniture: bool = False,
                    synth_walls: bool = False,
                    extent_slack: float | None = None,
                    consensus: bool = False,
                    top_k: int | None = None,
                    tta_rotations: bool = False,
                    tta_reflect: bool = False,
                    tta_scales: tuple = (),
                    fuse: bool = False,
                    ttopt: bool = False,
                    ttopt_params: dict | None = None,
                    soft_sigma: float | None = None,
                    synth_furniture: bool | str = False,
                    y_planes: tuple | None = None,
                    qscore: str | None = None,
                    qscore_auto: float | None = None,
                    device: str | torch.device = "cuda",
                    verbose: bool = True
                    ) -> Callable[[np.ndarray], List[Dict]]:
    """Return ``predict_array([N, 4] raw trace) -> list of collider dicts``,
    ordered by descending confidence. Moves ``model`` to ``device``.

    ``tta_rotations`` forwards the four 90-degree Y rotations,
    ``tta_reflect`` also the x-mirrored copy of each, ``tta_scales`` every
    view again at those uniform scales (scales outer, reflection, then
    rotations inner); boxes return to the capture frame (unrotate,
    unreflect, unscale) and all views' candidates pool into one pass.
    ``refine_clearance`` snaps wall boxes to the extent-implied planes
    (``refine_trust``, ``refine_furniture``); ``y_planes`` = (floor, ceil)
    snaps tall BLOCK boxes; ``synth_walls`` / ``synth_furniture`` (True or
    "v1", or "v2") append trace-implied candidates; ``ttopt`` adapts the
    boxes to the trace's physics (``ttopt_params`` overrides
    ``TTOptParams``; its ``"auto": tau`` key applies the adaptation only
    when the largest raw candidate confidence is below tau);
    ``extent_slack`` drops boxes entirely outside the trace extent before
    NMS; ``qscore`` (a weight JSON path) rescales each candidate's ranking
    confidence by the learned quality model, gated like ttopt by
    ``qscore_auto``; ``soft_sigma`` makes the NMS soft (pair it with
    ``nms_threshold`` ~0.5). The gates read the pooled model outputs from
    before synthesis appends rows. The trace-informed passes use the
    capture frame's row and need feature columns 0..3 (x, y, z, t).

    ``predict_array.prepare`` / ``run`` / ``finish`` are its three stages
    and ``predict_array.views`` the ``(k, mirrored, scale)`` view list.
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    in_feat = model_input_dim(model)
    qscore_params = (None if qscore is None
                     else qscore_ops.load_params(qscore, dev))
    tcfg = dict(ttopt_params) if ttopt_params else {}
    ttopt_tau = tcfg.pop("auto", None)
    ttopt_cfg = TTOptParams(**tcfg)

    views = [(k, m, s) for s in (1.0, *tta_scales)
             for m in ((0, 1) if tta_reflect else (0,))
             for k in (range(4) if tta_rotations else (0,))]
    view_ks = torch.tensor([k for k, _, _ in views], device=dev)
    view_ms = torch.tensor([bool(m) for _, m, _ in views], device=dev)
    view_ss = torch.tensor([s for _, _, s in views], dtype=torch.float32,
                           device=dev)

    @torch.no_grad()
    def run(traces: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``traces [R, L, F]`` (row r in view r's frame), ``mask [R, L]``
        -> ``[R·Q + synthesized, 9]``: boxes, keep, label, confidence."""
        R = traces.shape[0]
        out = model(traces, mask)
        boxes_r = unrotate_boxes(out["pred_boxes"], view_ks)
        boxes_r = torch.where(view_ms[:, None, None],
                              unreflect_boxes(boxes_r), boxes_r)
        boxes_r = boxes_r / view_ss[:, None, None]
        boxes0 = boxes_r.reshape(-1, 6)
        logits0 = out["pred_classes"].reshape(boxes0.shape[0], -1)
        obj = out.get("pred_objectness")
        obj0 = None if obj is None else obj.reshape(-1)
        raw0 = traces[0, :, :4]
        length = mask[0].sum()
        has_raw = traces.shape[-1] >= 4
        if refine_clearance is not None and has_raw:
            boxes0 = refine.refine_walls(
                boxes0, logits0.argmax(-1), raw0, length,
                clearance=refine_clearance, trust=refine_trust,
                furniture_aware=refine_furniture)
        # the auto gates read the raw pooled outputs, before synthesis
        sig_logits, sig_obj = logits0, obj0
        cand = None
        if y_planes is not None:
            boxes0 = refine.snap_y_planes(boxes0, logits0.argmax(-1),
                                          y_planes[0], y_planes[1])
        if synth_walls and has_raw:
            boxes0, logits0, obj_s, cand = refine.synthesize_walls(
                boxes0, logits0,
                torch.zeros_like(boxes0[:, 0]) if obj0 is None else obj0,
                raw0, length,
                clearance=(0.3 if refine_clearance is None
                           else refine_clearance),
                furniture_aware=refine_furniture)
            obj0 = None if obj0 is None else obj_s
        if synth_furniture and has_raw:
            synth = (refine.synthesize_furniture_v2 if synth_furniture == "v2"
                     else refine.synthesize_furniture)
            Qb = boxes0.shape[0]
            boxes0, logits0, obj0, nv = synth(boxes0, logits0, obj0, raw0,
                                              length)
            cand = nv if cand is None else torch.cat([cand, nv[Qb:]])
        if ttopt and has_raw:
            adapted = adapt_boxes(boxes0, raw0, length, ttopt_cfg)
            if ttopt_tau is None:
                boxes0 = adapted
            else:
                boxes0 = torch.where(
                    _max_confidence(sig_logits, sig_obj) < ttopt_tau,
                    adapted, boxes0)
        if extent_slack is not None and has_raw:
            outside = refine.outside_extent_mask(boxes0, raw0, length,
                                                 slack=extent_slack)
            cand = ~outside if cand is None else cand & ~outside
        conf_scale = None
        if qscore_params is not None and has_raw:
            conf_scale = qscore_ops.quality_scale(
                qscore_params, boxes0, logits0, obj0, raw0, length)
            if qscore_auto is not None:
                conf_scale = torch.where(
                    _max_confidence(sig_logits, sig_obj) < qscore_auto,
                    conf_scale, torch.ones_like(conf_scale))
        keep, labels, conf, boxes = post_process(
            boxes0, logits0, confidence_threshold=confidence_threshold,
            nms_threshold=nms_threshold, consensus=consensus, top_k=top_k,
            objectness=obj0, candidate_mask=cand, fuse=fuse,
            return_boxes=True, soft_sigma=soft_sigma, conf_scale=conf_scale)
        return torch.cat([boxes, keep[:, None].float(),
                          labels[:, None].float(), conf[:, None]], dim=-1)

    rot_cos = [1.0, 0.0, -1.0, 0.0]
    rot_sin = [0.0, 1.0, 0.0, -1.0]

    def prepare(arr: np.ndarray):
        """Host: featurize each view (scale, mirror, then x' = c x + s z,
        z' = -s x + c z), pad to ``[R, max_trace_len, F]`` with a mask,
        copy both to the device."""
        if arr.shape[0] > max_trace_len and verbose:
            print(f"Downsampling traces from {arr.shape[0]} to "
                  f"{max_trace_len} points")
        feats = []
        for k, m, sc in views:
            a = np.asarray(arr, np.float32)
            if k or m or sc != 1.0:
                c, s = rot_cos[k], rot_sin[k]
                a = a.copy()
                a[:, :3] *= sc
                x0 = -a[:, 0] if m else a[:, 0]
                z0 = a[:, 2].copy()
                a[:, 0], a[:, 2] = c * x0 + s * z0, -s * x0 + c * z0
            feats.append(adapt_features(
                process_traces_np(a, max_len=max_trace_len), in_feat))
        n = feats[0].shape[0]
        padded = np.zeros((len(views), max_trace_len, feats[0].shape[-1]),
                          np.float32)
        mask = np.zeros((len(views), max_trace_len), bool)
        for r, f in enumerate(feats):
            padded[r, :n] = f
            mask[r, :n] = True
        return torch.from_numpy(padded).to(dev), torch.from_numpy(mask).to(dev)

    def finish(stacked: torch.Tensor) -> List[Dict]:
        """Fetch ``run``'s result to the host and build collider dicts."""
        stacked = stacked.cpu().numpy()
        boxes = stacked[:, :6]
        keep = stacked[:, 6] > 0.5
        labels = stacked[:, 7].astype(np.int64)
        conf = stacked[:, 8]
        order = np.argsort(-conf * keep)
        return [formats.collider_to_dict(boxes[i], labels[i], conf[i])
                for i in order if keep[i]]

    def predict_array(arr: np.ndarray) -> List[Dict]:
        if arr.shape[0] == 0:
            if verbose:
                print("Warning: No traces found in file")
            return []
        return finish(run(*prepare(arr)))

    predict_array.prepare = prepare
    predict_array.run = run
    predict_array.finish = finish
    predict_array.views = views
    return predict_array
