"""Inference CLI of the port (the root ``inference.py``'s flags).

    python -m room_slam_torch.inference --checkpoint checkpoints/best_model \
        --input trace.json --output predictions.json --threshold 0.7 \
        --nms 0.3 [--consensus] [--top_k K] [--fuse] [--tta] [--tta_reflect]
        [--tta_scales 0.9,1.1] [--refine CLEARANCE] [--refine_trust M]
        [--refine_furniture] [--synth_walls] [--synth_furniture [v1|v2]]
        [--ycal FLOOR,CEIL|colliders.json] [--ttopt] [--ttopt_params JSON]
        [--extent_slack M] [--soft SIGMA] [--qscore weights.json]
        [--qscore_auto TAU] [--device cuda]

Reads the JAX package's and the port's checkpoints (msgpack + JSON
sidecar) and the reference's ``.pth`` files, and writes the same collider
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import torch
from torch import nn

from room_slam_torch.data import formats
from room_slam_torch.ops.refine import y_planes_from_colliders
from room_slam_torch.predictor import build_predictor
from room_slam_torch.train.driver import load_model_for_inference


def predict(model: nn.Module, traces_file: str, max_trace_len: int = 3000,
            confidence_threshold: float = 0.7, nms_threshold: float = 0.3,
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
            device: str | torch.device = "cuda") -> List[Dict]:
    """Featurize one trace file, forward, post-pass and post-process (see
    ``build_predictor``); returns collider dicts ordered by descending
    confidence."""
    predict_array = build_predictor(
        model, max_trace_len=max_trace_len,
        confidence_threshold=confidence_threshold,
        nms_threshold=nms_threshold, refine_clearance=refine_clearance,
        refine_trust=refine_trust, refine_furniture=refine_furniture,
        synth_walls=synth_walls, extent_slack=extent_slack,
        consensus=consensus, top_k=top_k, tta_rotations=tta_rotations,
        tta_reflect=tta_reflect, tta_scales=tta_scales, fuse=fuse,
        ttopt=ttopt, ttopt_params=ttopt_params, soft_sigma=soft_sigma,
        synth_furniture=synth_furniture, y_planes=y_planes, qscore=qscore,
        qscore_auto=qscore_auto, device=device)
    return predict_array(formats.load_trace_json(traces_file))


def _ycal(spec: str | None):
    """``--ycal``: a ``'floor,ceil'`` literal or a colliders JSON path."""
    if not spec:
        return None
    if "," in spec and not os.path.exists(spec):
        lo, hi = spec.split(",")
        return (float(lo), float(hi))
    return y_planes_from_colliders(spec)


def main(argv: List[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint stem (<stem>.msgpack + <stem>.json)")
    parser.add_argument("--input", required=True, help="trace JSON file")
    parser.add_argument("--output", default=None,
                        help="write the collider JSON here")
    parser.add_argument("--threshold", type=float, default=0.7,
                        help="confidence threshold (default: 0.7)")
    parser.add_argument("--nms", type=float, default=0.3,
                        help="NMS IoU threshold (default: 0.3)")
    parser.add_argument("--refine", type=float, default=None,
                        metavar="CLEARANCE",
                        help="snap wall predictions to the trace-extent "
                             "planes with this walker clearance (m)")
    parser.add_argument("--refine_trust", type=float, default=0.4,
                        metavar="METERS",
                        help="with --refine: the largest snap distance "
                             "(default: 0.4)")
    parser.add_argument("--refine_furniture", action="store_true",
                        help="with --refine: wall planes sit beyond "
                             "predicted furniture lining the envelope")
    parser.add_argument("--synth_walls", action="store_true",
                        help="append the 4 trace-extent wall candidates")
    parser.add_argument("--consensus", action="store_true",
                        help="rescore detections by NMS cluster size")
    parser.add_argument("--extent_slack", type=float, default=None,
                        metavar="METERS",
                        help="drop predictions entirely outside the trace "
                             "extent + this margin")
    parser.add_argument("--top_k", type=int, default=None,
                        help="keep only the K best detections after NMS")
    parser.add_argument("--tta", action="store_true",
                        help="pool the four 90-degree rotations' candidates")
    parser.add_argument("--tta_reflect", action="store_true",
                        help="also pool the x-mirrored copy of every view")
    parser.add_argument("--tta_scales", default="",
                        help="comma list of extra uniform scales to forward "
                             "every view at")
    parser.add_argument("--ttopt", action="store_true",
                        help="adapt the candidate boxes to the trace's "
                             "physics")
    parser.add_argument("--ttopt_params", default=None,
                        help="JSON TTOptParams overrides for --ttopt; "
                             "'{\"auto\": tau}' adapts only when the largest "
                             "candidate confidence is below tau")
    parser.add_argument("--fuse", action="store_true",
                        help="weighted box fusion of NMS clusters")
    parser.add_argument("--soft", type=float, default=None,
                        help="soft-NMS Gaussian sigma (pair with --nms 0.5)")
    parser.add_argument("--synth_furniture", nargs="?", const="v1",
                        default=None, choices=["v1", "v2"],
                        help="append hole-implied furniture candidates; "
                             "'v2' adds boundary-notch and tall-BLOCK rows")
    parser.add_argument("--qscore", default=None,
                        help="learned-quality weight JSON: rescales each "
                             "candidate's confidence before NMS")
    parser.add_argument("--qscore_auto", type=float, default=None,
                        help="apply --qscore only when the largest "
                             "candidate confidence is below this")
    parser.add_argument("--ycal", default=None,
                        help="floor/ceiling calibration: 'floor,ceil' in "
                             "metres or a seen room's colliders JSON; snaps "
                             "tall BLOCK predictions to those planes")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU)")
    args = parser.parse_args(argv)

    print(f"Loading model from {args.checkpoint}")
    model, cfg = load_model_for_inference(args.checkpoint, device=args.device)

    print(f"Processing {args.input}")
    predictions = predict(
        model, args.input, max_trace_len=cfg.data.max_trace_len,
        confidence_threshold=args.threshold, nms_threshold=args.nms,
        refine_clearance=args.refine, refine_trust=args.refine_trust,
        refine_furniture=args.refine_furniture,
        synth_walls=args.synth_walls, extent_slack=args.extent_slack,
        consensus=args.consensus, top_k=args.top_k, tta_rotations=args.tta,
        tta_reflect=args.tta_reflect,
        tta_scales=tuple(float(x) for x in args.tta_scales.split(",") if x),
        fuse=args.fuse, ttopt=args.ttopt,
        ttopt_params=(json.loads(args.ttopt_params)
                      if args.ttopt_params else None),
        soft_sigma=args.soft, synth_furniture=args.synth_furniture,
        y_planes=_ycal(args.ycal), qscore=args.qscore,
        qscore_auto=args.qscore_auto, device=args.device)

    print(f"\nFound {len(predictions)} colliders:")
    for i, pred in enumerate(predictions):
        c = pred["center"]
        print(f"  {i + 1}. {pred['label']} at "
              f"({c['x']:.2f}, {c['y']:.2f}, {c['z']:.2f}) "
              f"- confidence: {pred['confidence']:.3f}")

    if args.output:
        formats.save_predictions_json(args.output, predictions,
                                      args.threshold, args.nms)
        print(f"\nResults saved to {args.output}")


if __name__ == "__main__":
    main()
