"""The port's trainers on several ranks: with ``torch.distributed`` up on
2 gloo CPU ranks, ``train_benchmark_fused``, ``train_benchmark`` and the
train CLI train on the mesh of ``mesh.mesh_shape`` (every rank on
'data'), each rank on its part of each batch with the whole run's
augmentation draws, and give the one-process run's losses (rtol 1e-5);
only rank 0 writes checkpoints and logs. One spawn of 2 ranks."""

import numpy as np

from room_slam_torch.config import ExperimentConfig
from room_slam_torch.data.rooms import write_rooms
from room_slam_torch.train.driver import train_benchmark, \
    train_benchmark_fused
from torch_parallel_cases import drivers, spawn


def _config(tmp):
    cfg = ExperimentConfig()
    cfg.data.data_dir, cfg.data.val_dir = str(tmp / "train"), str(
        tmp / "val")
    cfg.data.max_trace_len, cfg.data.max_colliders = 48, 16
    cfg.model.model_type, cfg.model.d_model = "lstm", 16
    cfg.model.num_queries, cfg.model.dropout = 12, 0.0
    cfg.model.objectness = True
    cfg.train.batch_size, cfg.train.num_epochs = 4, 1
    return cfg


def test_trainers_on_two_ranks(tmp_path):
    write_rooms(tmp_path / "train", 3, seed=0, points=(60, 120))
    write_rooms(tmp_path / "val", 2, seed=1, points=(60, 120))
    cfg = _config(tmp_path)
    res = spawn(2, tmp_path / "ranks", {"drivers": (drivers, {
        "cfg": cfg.to_dict(), "dir": str(tmp_path / "out")})})["drivers"]
    for name, fn in (("fused", train_benchmark_fused),
                     ("epoch", train_benchmark)):
        cfg.train.save_dir = str(tmp_path / "one" / name)
        ref = fn(cfg, device="cpu", verbose=False)["history"]
        assert len(ref) == len(res[name]) == 1
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(res[name][0][k], ref[0][k],
                                       rtol=1e-5, err_msg=f"{name} {k}")
    files = res["files"]
    assert files[1] == []
    for name in ("fused", "epoch", "cli"):
        assert f"{name}_r0/best_model.json" in files[0], files[0]
    assert "fused_r0/final_model.json" in files[0]
