"""The port's behaviour probes (``room_slam_torch/diagnose.py``) against
the root ``diagnose.py`` on small ``lstm`` and ``bigru`` checkpoints
(JAX init plus noise, written by the JAX package and loaded by the port
through the weight bridge) and a seeded walk: every forward's
``pred_boxes`` within rtol 1e-5 / atol 1e-6 (the float32 forward's
tolerance), the numbers each probe compares, the verdicts and the printed
report (numbers to the printed digits)."""

import re
import sys

import numpy as np
import pytest

import diagnose as root_diagnose
import room_slam_torch.diagnose as diag
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch.train.driver import load_model_for_inference
from torch_tools_cases import small_checkpoint

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    d = tmp_path_factory.mktemp("diag_rooms")
    return str(write_rooms(d, 1, seed=2, points=(700, 900))[0])


def _shape(report):
    text = re.sub(r"-?\d+\.\d*(?:e[-+]\d+)?", "#", report)
    return re.sub(r"\s*([][])\s*", r"\1", re.sub(r" +", " ", text))


@pytest.mark.parametrize("model_type", ["lstm", "bigru"])
def test_probes_match_root(model_type, walk, tmp_path, monkeypatch, capsys):
    ckpt = small_checkpoint(tmp_path / "best_model", seed=1,
                            model_type=model_type, d_model=16,
                            num_queries=6)
    boxes = []
    forward = root_diagnose._forward

    def recording(model, params, feats, pad_to=1000):
        out = forward(model, params, feats, pad_to)
        boxes.append(np.asarray(out["pred_boxes"][0]))
        return out

    monkeypatch.setattr(root_diagnose, "_forward", recording)
    monkeypatch.setattr(sys, "argv", ["diagnose.py", ckpt, walk])
    root_diagnose.main()
    ref_out = capsys.readouterr().out

    model, _ = load_model_for_inference(ckpt, "cpu")
    results = diag.run_probes(model, walk)
    diag.summarize(results)
    out = capsys.readouterr().out

    got = [b for _, p in results for b in p.boxes]
    assert len(got) == len(boxes) == 8
    for g, r in zip(got, boxes):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
    t1, t2, t3 = (p for _, p in results)
    ref = [np.abs(boxes[0] - boxes[1]).mean(),
           np.abs(boxes[0] - boxes[2]).mean(),
           np.abs(boxes[3] - boxes[4]).mean()]
    np.testing.assert_allclose([t1.values["d12"], t1.values["d13"],
                                t2.values["d"]], ref, rtol=RTOL, atol=ATOL)
    for k, b in zip(("c1", "c2", "c05"), boxes[5:]):
        np.testing.assert_allclose(t3.values[k], b.mean(axis=0)[:3],
                                   rtol=RTOL, atol=ATOL)
    # the same report, verdicts included, up to the printed numbers and
    # numpy's padding of them
    assert _shape(out) == _shape(ref_out.split("\n", 1)[1])
    assert f"Passed: {sum(p.ok for _, p in results)}/3" in ref_out


def test_cli(walk, tmp_path, capsys):
    ckpt = small_checkpoint(tmp_path / "best_model", model_type="lstm",
                            d_model=16, num_queries=6)
    diag.main([ckpt, walk, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"Loading model from {ckpt}")
    assert "DIAGNOSIS SUMMARY" in out and "Passed: " in out
    with pytest.raises(RuntimeError, match="CUDA"):
        diag.main([ckpt, walk])
