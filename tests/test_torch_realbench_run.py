"""The capture benchmark's scoring runs on the CPU against the JAX
package's: ``realbench.run`` (per-capture rows, per-directory aggregates,
the bootstrap) and its CLI, and ``diagnose_zeroshot.diagnose``, with
``forward_captures`` patched in both packages to hand them one cached
forward (the JAX tool's, doctored with noisy GT copies so that the
metrics are not all 0; the forward itself is held to JAX's in
``test_torch_realbench.py``).

Tolerances: every float of the reports within 1e-6 (``run``'s metrics
come from the same detections up to float32 fused boxes) and 1e-4 for
``diagnose``'s IoUs and errors, everything else equal.
"""

import json
import sys
from unittest import mock

import pytest

from room_slam_torch.tools import diagnose_zeroshot as tdz
from room_slam_torch.tools import realbench as trb
from room_slam_tpu.tools import diagnose_zeroshot as jdz
from room_slam_tpu.tools import realbench as jrb
from torch_tools_cases import doctor, rooms, small_checkpoint

CELL = {"threshold": 0.0, "nms": 0.3, "refine": None, "trust": 0.4,
        "synth": False, "extent": 1.0, "consensus": False, "top_k": 8,
        "fuse": True, "ttopt": False, "support": None, "pen_beta": None}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("realbench_run")
    ck = small_checkpoint(d / "a")
    dirs = [rooms(d / "room_a", 4, seed=7), rooms(d / "room_b", 2, seed=8)]
    cached = doctor(jrb.forward_captures(ck, dirs, 2), seed=4)
    return {"ckpt": ck, "dirs": dirs, "cached": cached}


def assert_close(got, want, tol, path=""):
    """Nested reports equal, floats within ``tol``."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), (path, got.keys() ^ want.keys())
        for k in want:
            assert_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _patched(case, fn):
    return mock.patch.object(fn, "forward_captures",
                             lambda *a, **k: dict(case["cached"]))


def test_run_matches_jax(case):
    with _patched(case, jrb):
        want = jrb.run(case["ckpt"], case["dirs"], dict(CELL), bootstrap=50,
                       batch_size=2, seed=3)
    with _patched(case, trb):
        got = trb.run(case["ckpt"], case["dirs"], dict(CELL), bootstrap=50,
                      batch_size=2, seed=3, device="cpu")
    assert_close(json.loads(json.dumps(got, default=float)),
                 json.loads(json.dumps(want, default=float)), 1e-6)
    assert want["aggregate"]["mAP@0.25"] > 0.1
    assert set(want["per_dir"]) == {"room_a", "room_b"}
    assert want["bootstrap"]["resamples"] == 50


def test_cli_matches_jax(case, tmp_path):
    """Every flag of the fixed operating point, the same report JSON."""
    args = ["--checkpoint", case["ckpt"], "--dirs", ",".join(case["dirs"]),
            "--threshold", "0.0", "--nms", "0.5", "--refine", "0.3",
            "--trust", "0.6", "--synth", "--extent", "1.0", "--consensus",
            "--top_k", "9", "--fuse", "--support", "0.25", "--pen_beta",
            "1.0", "--soft", "0.25", "--synthf", "v2", "--ycal", "0.0,2.7",
            "--refine_furniture", "--bootstrap", "20", "--batch_size", "2"]
    with _patched(case, jrb), mock.patch.object(
            sys, "argv", ["realbench", *args, "--output",
                          str(tmp_path / "j.json")]):
        jrb.main()
    with _patched(case, trb):
        trb.main([*args, "--device", "cpu", "--output",
                  str(tmp_path / "t.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    assert_close(json.loads((tmp_path / "t.json").read_text()), want, 1e-6)
    assert want["operating_point"]["ycal"] == [0.0, 2.7]


def test_diagnose_matches_jax(case):
    d = case["dirs"][0]
    only = {k: v[:4] for k, v in case["cached"].items()}   # room_a
    with mock.patch.object(jrb, "forward_captures", lambda *a, **k: only):
        want = jdz.diagnose(case["ckpt"], d, dict(CELL), batch_size=2)
    with mock.patch.object(tdz, "forward_captures", lambda *a, **k: only):
        got = tdz.diagnose(case["ckpt"], d, dict(CELL), batch_size=2,
                           device="cpu")
    assert_close(json.loads(json.dumps(got, default=float)),
                 json.loads(json.dumps(want, default=float)), 1e-4)
    assert want["aggregate"]["all"]["hit@0.25"] > 0
