"""The port's sequence parallelism (``room_slam_torch/parallel/mesh.py``)
on 8 gloo CPU ranks, a ('data', 'seq', 'model') mesh of (2, 2, 2), dropout
off, as the JAX package's ``tests/test_train_loop.py`` holds its sharded
step (to the one-device loss at rtol 1e-4):

- ``featurize_seq`` of each rank's slice (the halo of two rows from the
  previous rank) gives ``featurize``'s rows of the whole trace, bit for
  bit;
- a switch-MoE transformer step with ``tensor_parallel=True`` (attention
  K/V and the decoder memory gathered over 'seq', the experts split over
  'model'): the loss against the JAX one-device loss at rtol 1e-4, and
  losses, gradients and updated parameters against the port's one-device
  step (``tests/test_torch_parallel.py``'s tolerances);
- an lstm step with augmentation (the recurrence gathers its whole input)
  against the port's one-device step on the same generator.

One spawn of 8 ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.data.features import featurize
from room_slam_tpu.config import (DataConfig, ExperimentConfig, ModelConfig,
                                  TrainConfig)
from room_slam_tpu.data.dataset import TraceColliderArrays
from room_slam_tpu.models.factory import build_model
from room_slam_tpu.train import loop as jloop
from room_slam_torch.data.rooms import write_rooms
from test_torch_parallel import (_assert_grads, _assert_params,
                                 _one_device, _params, _payload)
from torch_parallel_cases import featurize_slices, spawn, train_step

L, M = 64, 16
MESH = (2, 2, 2)


def _configs():
    data = DataConfig(max_trace_len=L, max_colliders=M)
    return {
        "sp": ExperimentConfig(
            data=data,
            model=ModelConfig(model_type="transformer", d_model=32, nhead=2,
                              enc_layers=1, dec_layers=1, num_queries=10,
                              dim_feedforward=64, dropout=0.0,
                              use_pallas_rnn=False, moe_experts=4,
                              objectness=True, center_xz=True),
            train=TrainConfig(batch_size=4, lr=3e-3)),
        "sp_lstm": ExperimentConfig(
            data=data,
            model=ModelConfig(model_type="lstm", d_model=32, num_queries=12,
                              lstm_layers=1, dropout=0.0,
                              use_pallas_rnn=False, objectness=True),
            train=TrainConfig(batch_size=4, lr=3e-3)),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp_rooms")
    write_rooms(d, 4, seed=3, points=(40, 120))
    ds = TraceColliderArrays(d, DataConfig(max_trace_len=L, max_colliders=M),
                             augment=False, verbose=False)
    batch = ds.gather(np.arange(4))
    # one walk ends in the first half: the second slice holds only padding
    batch["raw"][0, 20:] = 0.0
    batch["length"][0] = 20
    cfgs = _configs()
    params = {k: _params(c) for k, c in cfgs.items()}
    cases = {
        "feats": (featurize_slices, {"mesh": MESH, "raw": batch["raw"],
                                     "length": batch["length"]}),
        "sp": (train_step, _payload(cfgs["sp"], params["sp"], batch, MESH,
                                    tensor_parallel=True)),
        "sp_lstm": (train_step, _payload(cfgs["sp_lstm"],
                                         params["sp_lstm"], batch, MESH,
                                         augment=True, seed=3)),
    }
    return spawn(8, tmp_path_factory.mktemp("sp_ranks"), cases), batch, \
        cfgs, params


def test_featurize_seq_takes_the_halo(run):
    res, batch, *_ = run
    feats, mask = featurize(torch.from_numpy(batch["raw"]),
                            torch.from_numpy(batch["length"]))
    np.testing.assert_array_equal(res["feats"][0], feats.numpy())
    np.testing.assert_array_equal(res["feats"][1], mask.numpy())
    assert batch["length"].min() < L // 2 < batch["length"].max()


def test_sequence_parallel_transformer_step(run):
    res, batch, cfgs, params = run
    cfg, got = cfgs["sp"], res["sp"]
    model = build_model(cfg.model)
    tx = jloop.make_optimizer(cfg)
    p = jax.tree_util.tree_map(jnp.array, params["sp"])
    state = jloop.TrainState(p, tx.init(p), jnp.asarray(0))
    _, ref = jloop.make_train_step(model, tx, cfg, augment=False)(
        state, batch, jax.random.key(0))
    np.testing.assert_allclose(got["losses"][0]["total_loss"],
                               float(ref["total_loss"]), rtol=1e-4)
    losses, grads, new = _one_device(cfg, params["sp"], batch, False, 0)
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][0][k], v, rtol=1e-5,
                                   err_msg=k)
    _assert_grads(got["grads"], grads, 1e-5)
    _assert_params(got["params"], new, grads, cfg.train.lr)
    assert "encoder.layer_0.moe.w1" in got["sharded"]


def test_sequence_parallel_lstm_step(run):
    res, batch, cfgs, params = run
    cfg, got = cfgs["sp_lstm"], res["sp_lstm"]
    losses, grads, new = _one_device(cfg, params["sp_lstm"], batch, True, 3)
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][0][k], v, rtol=1e-5,
                                   err_msg=k)
    _assert_grads(got["grads"], grads, 1e-5)
    _assert_params(got["params"], new, grads, cfg.train.lr)
