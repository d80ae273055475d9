"""The port's serving pieces outside the model: the native trace parser
(its parse equals the JAX package's native parser and the Python parser on
written files; a declined file goes to the Python parser; the build is
keyed by the source's hash and a failed build raises) and the predictor's
test-time view list against the JAX predictor's."""

import json
import shutil

import numpy as np
import pytest
import torch

from room_slam_torch.config import ModelConfig
from room_slam_torch.data import formats as tformats
from room_slam_torch.models.factory import build_model
from room_slam_torch.native import trace_parser as tnative
from room_slam_torch.predictor import build_predictor
from room_slam_tpu.data import formats as jformats
from room_slam_tpu.native import trace_parser as jnative
from room_slam_tpu.predictor import build_predictor as jax_build

ROWS = [{"timestamp": 0.5, "x": 1.25, "y": -0.5, "z": 3.0},
        {"x": -2.0, "y": 1e-3, "z": 7, "timestamp": 1.0, "note": 'a\\"b'},
        {"timestamp": 2, "y": 0.0, "x": 0.1, "z": -1.5e2, "extra": [1, 2]}]


def _files(tmp_path):
    """Trace files in every container shape the parsers take."""
    rng = np.random.default_rng(0)
    big = [{"timestamp": float(t), "x": float(x), "y": float(y),
            "z": float(z)} for x, y, z, t in rng.normal(size=(500, 4))]
    cases = {
        "list": ROWS,
        "traces": {"traces": ROWS, "metadata": {"device": "phone",
                                                "ok": True, "n": None}},
        "trajectory": {"trajectory": big},
        "empty": [],
        "pretty": ROWS,
    }
    paths = {}
    for name, data in cases.items():
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(data, indent=2 if name == "pretty"
                                          else None))
    return paths


def test_native_parser_matches_jax_native_and_python(tmp_path):
    for name, path in _files(tmp_path).items():
        got = tnative.parse_trace_file(path)
        assert got is not None and got.dtype == np.float32, name
        np.testing.assert_array_equal(got, jnative.parse_trace_file(str(path)),
                                      err_msg=name)
        with open(path) as f:
            py = tformats.parse_trace_records(json.load(f))
        np.testing.assert_array_equal(got, py, err_msg=name)
        np.testing.assert_array_equal(tformats.load_trace_json(path),
                                      jformats.load_trace_json(path))


def test_declined_file_goes_to_the_python_parser(tmp_path):
    """A row object outside any array is a structural surprise: the
    native parser declines (None), and ``load_trace_json`` parses the file
    in Python, as the reference does."""
    path = tmp_path / "declined.json"
    path.write_text(json.dumps({"x": 1, "y": 2, "z": 3, "timestamp": 4,
                                "traces": ROWS}))
    assert tnative.parse_trace_file(path) is None
    assert jnative.parse_trace_file(str(path)) is None
    got = tformats.load_trace_json(path)
    np.testing.assert_array_equal(got, jformats.load_trace_json(path))
    np.testing.assert_array_equal(got, tformats.parse_trace_records(
        json.loads(path.read_text())))
    assert got.shape == (3, 4)


def test_native_build_is_keyed_by_source_and_failure_raises(tmp_path,
                                                            monkeypatch):
    src = tmp_path / "trace_parser.cc"
    shutil.copy(tnative.SRC, src)
    monkeypatch.setattr(tnative, "SRC", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    first = tnative.build()
    assert first.exists() and first.parent == tmp_path / "build"
    assert tnative.build() == first                       # reused
    src.write_text(src.read_text() + "\n// edited\n")
    assert tnative.library_path() != first                # rebuilt
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build()


@pytest.mark.parametrize("opts", [
    {}, dict(tta_rotations=True), dict(tta_reflect=True),
    dict(tta_rotations=True, tta_reflect=True, tta_scales=(0.9, 1.1))])
def test_view_list_matches_jax(opts):
    """Scales outer, reflection in the middle, rotations inner; row 0 the
    capture frame."""
    model = build_model(ModelConfig(d_model=16, num_queries=4,
                                    lstm_layers=1))
    views = build_predictor(model, max_trace_len=16, device="cpu",
                            **opts).views
    assert views == jax_build(None, None, max_trace_len=16, **opts).views
    assert views[0] == (0, 0, 1.0)
    arr = np.random.default_rng(1).normal(size=(20, 4)).astype(np.float32)
    arr[:, 3] = np.arange(20) * 0.1
    x, m = build_predictor(model, max_trace_len=16, device="cpu",
                           verbose=False, **opts).prepare(arr)
    assert tuple(x.shape[:2]) == (len(views), 16) and bool(m.all())
    assert x.dtype == torch.float32
