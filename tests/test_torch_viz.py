"""The port's plots against the JAX package's and the root scripts', by the
data each figure draws (``tests/torch_viz_cases.py``: lines, rectangles,
scatter offsets, texts and titles; strings exact, coordinates within
1e-6, the demo's generated walks within the generator's 1e-4), on seeded
rooms, all on the Agg backend: the dataset plots, the
augmentation check, ``visualize``, ``demo --save_viz`` and the dataset
report. The legacy ``evaluate --visualize`` is held to the root script in
``tests/test_torch_legacy.py``."""

import ast
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import demo as root_demo  # noqa: E402
import visualize as root_visualize  # noqa: E402
from room_slam_torch import demo as tdemo  # noqa: E402
from room_slam_torch import visualize as tvisualize  # noqa: E402
from room_slam_torch.data import formats  # noqa: E402
from room_slam_torch.data.dataset import \
    print_dataset_statistics as torch_stats  # noqa: E402
from room_slam_torch.data.rooms import write_rooms  # noqa: E402
from room_slam_torch.viz import augmentation as taug  # noqa: E402
from room_slam_torch.viz import dataset_plots as tplots  # noqa: E402
from room_slam_tpu.config import DataConfig  # noqa: E402
from room_slam_tpu.data.dataset import \
    print_dataset_statistics as jax_stats  # noqa: E402
from room_slam_tpu.viz import augmentation as jaug  # noqa: E402
from room_slam_tpu.viz import dataset_plots as jplots  # noqa: E402
from torch_viz_cases import (assert_same_figure, figure_data,  # noqa: E402
                             record_savefig)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz_rooms")
    write_rooms(d, 2, seed=4, points=(150, 300))
    return d


def _run_main(main, argv, monkeypatch):
    """A root-style ``main()`` that reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    main()


def _same_records(got, ref):
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert_same_figure(got[name], ref[name])


def test_dataset_plots_match_jax(rooms, tmp_path, monkeypatch, capsys):
    rec = record_savefig(monkeypatch)
    argv = ["--data_dir", str(rooms), "--per_trace", "--compare"]
    _run_main(jplots.main, argv + ["--out_dir", str(tmp_path / "j")],
              monkeypatch)
    ref, rec_j = dict(rec), capsys.readouterr().out
    rec.clear()
    tplots.main(argv + ["--out_dir", str(tmp_path / "t")])
    assert capsys.readouterr().out == rec_j.replace(
        str(tmp_path / "j"), str(tmp_path / "t"))
    assert {"overview.png", "agent_vs_human.png",
            "analysis_room_000_trace.png"} <= set(ref)
    _same_records(rec, ref)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())

    # the agent-vs-human figure with both groups filled, and its printout
    traces = {f"{g}_{i}": formats.sort_by_time(formats.load_trace_json(t))
              for i, (t, _) in enumerate(formats.find_data_pairs(rooms))
              for g in ("agent", "human")}
    traces["agent_0"][:, 1] = 1.2                  # constant sensor height
    figs = [f(traces) for f in (jplots.plot_agent_vs_human,
                                tplots.plot_agent_vs_human)]
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "agent: 2 traces" in out
    assert_same_figure(figure_data(figs[1]), figure_data(figs[0]))
    plt.close("all")


def test_augmentation_check_matches_jax(rooms, tmp_path, monkeypatch,
                                        capsys):
    rec = record_savefig(monkeypatch)
    _run_main(jaug.main, ["--data_dir", str(rooms), "--index", "1",
                          "--out", str(tmp_path / "a.png")], monkeypatch)
    ref, out_j = dict(rec), capsys.readouterr().out
    rec.clear()
    taug.main(["--data_dir", str(rooms), "--index", "1", "--out",
               str(tmp_path / "b.png"), "--stochastic_out",
               str(tmp_path / "s.png"), "--seed", "3", "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert_same_figure(rec["b.png"], ref["a.png"])
    check = [ln for ln in out_t.splitlines() if "90° rotation" in ln]
    assert check == [ln for ln in out_j.splitlines() if "90° rotation" in ln]
    assert check[0].startswith("✓")
    # the random draws are torch's, not jax's: the original panel and the
    # layout are the JAX figure's
    stoch = rec["s.png"]["axes"]
    assert len(stoch) == 6 and stoch[0]["title"] == "original"
    assert [a["title"].split(" (")[0] for a in stoch[1:]] == \
        [f"random draw {j}" for j in range(1, 6)]
    np.testing.assert_allclose(stoch[0]["lines"][0],
                               ref["a.png"]["axes"][0]["lines"][0], atol=1e-6)
    plt.close("all")


def test_visualize_matches_root(rooms, tmp_path, monkeypatch, capsys):
    trace, coll = formats.find_data_pairs(rooms)[0]
    boxes, labels = formats.load_colliders_json(coll)
    preds = tmp_path / "p.json"
    formats.save_predictions_json(
        preds, [formats.collider_to_dict(b + 0.1, l, 0.5 + 0.1 * i)
                for i, (b, l) in enumerate(zip(boxes[:3], labels[:3]))],
        0.3, 0.3)
    rec = record_savefig(monkeypatch)
    for main, name in ((lambda a: _run_main(root_visualize.main, a,
                                            monkeypatch), "j.png"),
                       (tvisualize.main, "t.png")):
        main(["--input", str(trace), "--colliders", str(coll),
              "--predictions", str(preds), "--output",
              str(tmp_path / name), "--side_view"])
    assert_same_figure(rec["t.png"], rec["j.png"])
    assert rec["t.png"]["axes"][1]["title"].startswith("Side View")
    assert (tmp_path / "t.png").stat().st_size > 0
    plt.close("all")


def test_demo_save_viz_matches_root(tmp_path, monkeypatch, capsys):
    rec = record_savefig(monkeypatch)
    _run_main(root_demo.main, ["--n_rooms", "2", "--num_steps", "600",
                               "--save_viz", str(tmp_path / "j")],
              monkeypatch)
    ref = dict(rec)
    rec.clear()
    tdemo.main(["--n_rooms", "2", "--num_steps", "600", "--save_viz",
                str(tmp_path / "t"), "--device", "cpu"])
    assert sorted(ref) == ["demo_room_0.png", "demo_room_1.png"]
    # the generated walks hold to the generator's own tolerance
    # (tests/test_torch_synthetic.py: traces within 1e-4)
    for name in ref:
        assert_same_figure(rec[name], ref[name], atol=1e-4)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(ref)
    plt.close("all")


def test_dataset_statistics_match_jax(rooms, capsys):
    cfg = DataConfig(max_trace_len=256)
    for rot in (True, False):
        jax_stats(str(rooms), cfg, augment_rotation=rot)
        ref = capsys.readouterr().out
        torch_stats(str(rooms), cfg, augment_rotation=rot)
        assert capsys.readouterr().out == ref
    assert "Label distribution" in ref


def test_plots_import_matplotlib_only_when_drawing(monkeypatch, tmp_path):
    """No module of the port imports matplotlib at module level, so
    ``evaluate``, ``demo`` and ``diagnose`` import on a machine without
    it; drawing there raises an ImportError that names matplotlib."""
    for f in (REPO / "room_slam_torch").rglob("*.py"):
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any((n or "").startswith("matplotlib")
                               for n in names), f
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tdemo.plot_room(str(tmp_path), 0, np.zeros((4, 4), np.float32),
                        np.zeros((0, 6), np.float32), [])
