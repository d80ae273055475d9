"""UDP pose ingestion (counterpart of the JAX package's ``data/ingest.py``):
the host side of the phone sender, the Unity receiver and the debug
listener, and live room inference on the card while the trace grows.

Wire format, unchanged, so that either package's sender and receiver talk
to the other's: one JSON object per UDP datagram on port 4399,

    {"x": 0.12, "y": 1.43, "z": -0.88,
     "qx": 0.0, "qy": 0.0, "qz": 0.0, "qw": 1.0, "timestamp": 12.5}

positions in ARKit's right-handed frame; the receiver flips handedness into
Unity's left-handed frame (z -> -z). ``timestamp`` (the sender's clock) is
an extension that ``replay`` writes and the receivers prefer over receive
time.

Subcommands:
    listen  - print incoming packets
    record  - receive poses, apply the handedness flip, write
              ``human_data_YYYYMMDD_HHMMSS.json`` rows {timestamp, x, y, z}
    replay  - stream a recorded or generated trace back out as pose packets
              at a configurable rate (the phone's test double)
    live    - record AND rerun ``predictor.build_predictor`` on the growing
              trace every ``--interval`` seconds, printing the current room
              estimate and (optionally) rewriting a predictions JSON. The
              predictor pads or downsamples to the checkpoint's fixed
              ``max_trace_len``, so every refresh runs one fixed-shape
              program on ``--device`` (default ``cuda``): the flagship's
              BiLSTM layers launch kernel #1, a ``bigru``'s kernel #5,
              through the same custom ops as an exported artifact
              (``tools/export.py``).

    python -m room_slam_torch.data.ingest live --checkpoint CKPT \\
        --port 4399 --interval 2 --output live.json [--device cuda|cpu]
    python -m room_slam_torch.data.ingest replay trace.json --hz 30
"""

from __future__ import annotations

import argparse
import json
import socket
import time
from datetime import datetime
from pathlib import Path
from typing import List, Optional

DEFAULT_PORT = 4399
# the receive buffer asked for (the kernel caps it at its own limit): a
# burst that arrives during a model load or a refresh queues there
RECV_BUFFER_BYTES = 1 << 22


def _bind(host: str, port: int) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RECV_BUFFER_BYTES)
    sock.bind((host, port))
    return sock


def listen(host: str = "0.0.0.0", port: int = DEFAULT_PORT,
           max_packets: Optional[int] = None) -> int:
    """Debug echo listener; returns the number of packets printed."""
    sock = _bind(host, port)
    print(f"Listening on {host}:{port} ... Ctrl+C to stop")
    n = 0
    try:
        while max_packets is None or n < max_packets:
            data, addr = sock.recvfrom(4096)
            print(f"[{addr[0]}:{addr[1]}] {data.decode(errors='replace')}")
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        sock.close()
    return n


class _Clock:
    """A pose's time relative to the first: the sender's ``timestamp``
    where the packet carries one (receive times are distorted whenever
    packets queue in the kernel buffer), else the receive time."""

    def __init__(self):
        self.t_send0: Optional[float] = None
        self.t_start: Optional[float] = None

    def __call__(self, pose: dict, recv_t: float) -> float:
        ts = pose.get("timestamp")
        if ts is not None:
            if self.t_send0 is None:
                self.t_send0 = float(ts)
            return float(ts) - self.t_send0
        if self.t_start is None:
            self.t_start = recv_t
        return recv_t - self.t_start


def _z(pose: dict, flip_handedness: bool) -> float:
    z = float(pose.get("z", 0.0))
    return -z if flip_handedness else z


def record(
    out_dir: str = ".",
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    duration: Optional[float] = None,
    max_points: Optional[int] = None,
    flip_handedness: bool = True,
) -> Path:
    """Receive pose packets and write a trace JSON; timestamps are seconds
    since the first packet."""
    sock = _bind(host, port)
    sock.settimeout(0.5)
    print(f"Recording poses from {host}:{port} "
          f"(duration={duration}, max_points={max_points}) ...")
    rows: List[dict] = []
    clock = _Clock()
    t_wall = time.monotonic()
    try:
        while True:
            if duration is not None and time.monotonic() - t_wall > duration:
                break
            if max_points is not None and len(rows) >= max_points:
                break
            try:
                data, _ = sock.recvfrom(4096)
            except socket.timeout:
                continue
            try:
                pose = json.loads(data)
            except json.JSONDecodeError:
                continue
            rows.append({
                "timestamp": clock(pose, time.monotonic()),
                "x": float(pose.get("x", 0.0)),
                "y": float(pose.get("y", 0.0)),
                "z": _z(pose, flip_handedness),
            })
    except KeyboardInterrupt:
        pass
    finally:
        sock.close()

    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    out = Path(out_dir) / f"human_data_{stamp}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f)
    print(f"Recorded {len(rows)} poses -> {out}")
    return out


def replay(
    trace_file: str,
    host: str = "127.0.0.1",
    port: int = DEFAULT_PORT,
    hz: float = 30.0,
    realtime: bool = False,
    flip_handedness: bool = True,
) -> int:
    """Stream a trace file out as pose packets, in time order; returns the
    number sent."""
    from room_slam_torch.data import formats

    arr = formats.sort_by_time(formats.load_trace_json(trace_file))
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    n = 0
    period = 1.0 / hz if hz > 0 else 0.0
    for x, y, z, t in arr:
        pose = {
            "x": float(x), "y": float(y),
            # undo the receiver-side flip so that record() round-trips
            "z": float(-z) if flip_handedness else float(z),
            "qx": 0.0, "qy": 0.0, "qz": 0.0, "qw": 1.0,
            "timestamp": float(t),
        }
        sock.sendto(json.dumps(pose).encode(), (host, port))
        n += 1
        if realtime and period:
            time.sleep(period)
    sock.close()
    return n


def live(
    checkpoint: str,
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    interval: float = 2.0,
    min_points: int = 50,
    duration: Optional[float] = None,
    max_points: Optional[int] = None,
    output: Optional[str] = None,
    threshold: float = 0.5,
    nms: float = 0.3,
    refine: Optional[float] = None,
    extent_slack: Optional[float] = None,
    consensus: bool = False,
    tta: bool = False,
    tta_reflect: bool = False,
    flip_handedness: bool = True,
    device: str = "cuda",
) -> list:
    """Streamed room inference: accumulate poses like ``record`` and rerun
    the predictor on the whole trace so far every ``interval`` seconds, on
    ``device``. Returns the final prediction list."""
    import numpy as np

    from room_slam_torch import resolve_device
    from room_slam_torch.data import formats
    from room_slam_torch.predictor import build_predictor
    from room_slam_torch.train.driver import load_model_for_inference

    dev = resolve_device(device)
    # bind BEFORE the (slow) model load so that early packets queue in the
    # kernel's receive buffer instead of being dropped
    sock = _bind(host, port)
    t_bind = time.monotonic()
    sock.settimeout(0.2)

    print(f"Loading model from {checkpoint}")
    model, cfg = load_model_for_inference(checkpoint, device=dev)
    predict_array = build_predictor(
        model, max_trace_len=cfg.data.max_trace_len,
        confidence_threshold=threshold, nms_threshold=nms,
        refine_clearance=refine, extent_slack=extent_slack,
        consensus=consensus, tta_rotations=tta, tta_reflect=tta_reflect,
        device=dev, verbose=False)
    print(f"Live inference on {host}:{port} "
          f"(refresh every {interval}s once {min_points}+ points) ...")
    rows: List[List[float]] = []  # [x, y, z, t]
    preds: list = []
    clock = _Clock()

    def add_pose(pose: dict, recv_t: float) -> None:
        # the sender's clock (where present) keeps the true inter-point dt
        # of a drained burst, whose receive times are near-identical and
        # would blow up the velocity features
        rows.append([float(pose.get("x", 0.0)), float(pose.get("y", 0.0)),
                     _z(pose, flip_handedness), clock(pose, recv_t)])

    # Drain the backlog that queued during the model load: it all arrives
    # now in one burst, so its receive times are back-dated uniformly over
    # the load window (packets that carry a timestamp are exact anyway).
    t_loaded = time.monotonic()
    burst: List[dict] = []
    sock.setblocking(False)
    while True:
        try:
            data, _ = sock.recvfrom(4096)
        except (BlockingIOError, OSError):
            break
        try:
            burst.append(json.loads(data))
        except json.JSONDecodeError:
            continue
    sock.settimeout(0.2)
    for i, pose in enumerate(burst):
        frac = (i + 1) / len(burst)
        add_pose(pose, t_bind + frac * (t_loaded - t_bind))

    t_wall = time.monotonic()
    last_run = t_wall

    def refresh(now: float) -> list:
        p = predict_array(np.asarray(rows, dtype=np.float32))
        summary = ", ".join(
            f"{d['label']}@({d['center']['x']:.1f},{d['center']['z']:.1f})"
            f":{d['confidence']:.2f}" for d in p[:6])
        print(f"[t={now - t_wall:6.1f}s n={len(rows):5d}] "
              f"{len(p)} colliders  {summary}")
        if output:
            formats.save_predictions_json(output, p, threshold, nms)
        return p

    try:
        while True:
            now = time.monotonic()
            if duration is not None and now - t_wall > duration:
                break
            if max_points is not None and len(rows) >= max_points:
                break
            try:
                data, _ = sock.recvfrom(4096)
            except socket.timeout:
                data = None
            if data is not None:
                try:
                    pose = json.loads(data)
                except json.JSONDecodeError:
                    pose = None
                if pose is not None:
                    add_pose(pose, now)
            if len(rows) >= min_points and now - last_run >= interval:
                preds = refresh(now)
                last_run = time.monotonic()
    except KeyboardInterrupt:
        pass
    finally:
        sock.close()

    if len(rows) >= min_points:
        preds = refresh(time.monotonic())
    print(f"Final estimate: {len(preds)} colliders from {len(rows)} poses")
    return preds


def main():
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("listen")
    pl.add_argument("--host", default="0.0.0.0")
    pl.add_argument("--port", type=int, default=DEFAULT_PORT)
    pl.add_argument("--max_packets", type=int, default=None)

    pr = sub.add_parser("record")
    pr.add_argument("--out_dir", default=".")
    pr.add_argument("--host", default="0.0.0.0")
    pr.add_argument("--port", type=int, default=DEFAULT_PORT)
    pr.add_argument("--duration", type=float, default=None)
    pr.add_argument("--max_points", type=int, default=None)

    ps = sub.add_parser("replay")
    ps.add_argument("trace_file")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=DEFAULT_PORT)
    ps.add_argument("--hz", type=float, default=30.0)
    ps.add_argument("--realtime", action="store_true")

    pv = sub.add_parser("live")
    pv.add_argument("--checkpoint", required=True)
    pv.add_argument("--host", default="0.0.0.0")
    pv.add_argument("--port", type=int, default=DEFAULT_PORT)
    pv.add_argument("--interval", type=float, default=2.0,
                    help="seconds between model refreshes")
    pv.add_argument("--min_points", type=int, default=50)
    pv.add_argument("--duration", type=float, default=None)
    pv.add_argument("--max_points", type=int, default=None)
    pv.add_argument("--output", default=None,
                    help="predictions JSON, rewritten at each refresh")
    pv.add_argument("--threshold", type=float, default=0.5)
    pv.add_argument("--nms", type=float, default=0.3)
    pv.add_argument("--refine", type=float, default=None,
                    metavar="CLEARANCE")
    pv.add_argument("--extent_slack", type=float, default=None,
                    metavar="METERS")
    pv.add_argument("--consensus", action="store_true")
    pv.add_argument("--tta", action="store_true",
                    help="4-way rotation test-time augmentation per "
                         "refresh (see predictor.build_predictor)")
    pv.add_argument("--tta_reflect", action="store_true",
                    help="also pool the x-mirrored copy of every TTA view "
                         "(8-view dihedral pooling with --tta)")
    pv.add_argument("--device", default="cuda",
                    help="device of the refreshes (cpu runs the plain "
                         "recurrences)")

    args = p.parse_args()
    if args.cmd == "listen":
        listen(args.host, args.port, args.max_packets)
    elif args.cmd == "record":
        record(args.out_dir, args.host, args.port, args.duration,
               args.max_points)
    elif args.cmd == "replay":
        n = replay(args.trace_file, args.host, args.port, args.hz,
                   args.realtime)
        print(f"Sent {n} pose packets")
    elif args.cmd == "live":
        live(args.checkpoint, args.host, args.port, args.interval,
             args.min_points, args.duration, args.max_points, args.output,
             args.threshold, args.nms, args.refine, args.extent_slack,
             args.consensus, args.tta, args.tta_reflect, device=args.device)


if __name__ == "__main__":
    main()
