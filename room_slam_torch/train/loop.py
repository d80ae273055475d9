"""Training and evaluation steps (counterpart of the JAX package's
``train/loop.py``).

One training step: augment -> featurize -> forward (train mode, dropout
from the step's generator) -> set criterion (Hungarian matching on the
device: ``ops/hungarian.py``'s kernel on the card) -> backward (the
recurrences through their autograd ``Function``s: the training forward and
BPTT kernels on the card) -> clip by global norm -> AdamW [-> parameter
EMA]. Nothing in a step reads a value back to the host.

Above the step, as in the JAX package: ``make_train_steps`` (N steps on one
batch), ``make_train_epoch`` (an epoch over a device index plan),
``make_eval_epoch`` (a whole split's mean losses and metric sums), the
device plateau scheduler (``SchedState``, ``sched_init``,
``sched_update``) and ``make_fused_run`` / ``fused_run_init``: epochs,
validation, the scheduler and the best parameters, all on the device with
no host read. PyTorch runs eagerly, so these are Python loops over device
work, not one dispatch.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from room_slam_torch.config import DataConfig, ExperimentConfig
from room_slam_torch.data.augment import Sample, apply_augment, draw_rands
from room_slam_torch.data.features import featurize
from room_slam_torch.models.common import MoEFFN
from room_slam_torch.ops.losses import set_criterion
from room_slam_torch.parallel import mesh as mesh_lib
from room_slam_torch.parallel.collectives import all_reduce, axis
from room_slam_torch.train.metrics import metrics_sums
from room_slam_torch.weights import params_to_state_dict, state_dict_to_params

Batch = Dict[str, torch.Tensor]


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay))``, plus the parameter EMA when ``train.ema_decay > 0``.

    Clipping uses optax's formula: when the global norm ``g`` reaches
    ``grad_clip``, every gradient becomes ``grad / g * grad_clip`` (torch's
    ``clip_grad_norm_`` divides by ``g + 1e-6`` instead). AdamW is
    ``torch.optim.AdamW`` with optax's defaults (betas 0.9 / 0.999, eps
    1e-8 outside the square root, decoupled decay on every parameter); a
    parameter without a gradient gets a zero gradient, as in optax.

    ``state_dict`` / ``load_state_dict`` read and write the state in the
    layout flax serializes for the JAX package's optimizer,
    ``inject_hyperparams(chain(clip_by_global_norm, adamw[, ema]))``, so a
    checkpoint resumes in either package.

    The learning rate is a 0-d float32 tensor, as ``inject_hyperparams``
    keeps it, and ``set_learning_rate`` takes a number or a tensor. On the
    card AdamW keeps its default there: a float learning rate and the step
    count on the host (a tensor is read back). ``capturable=True`` (the
    fused run's, on the card) keeps both on the device, so that the
    scheduler's device value goes in without a host read; it costs a
    host-bound step a few ms (PERF.md).

    On a model placed on a mesh (``parallel/mesh.shard_params``, before
    the optimizer is made) ``step`` first turns the gradients into the
    one-device ones (``reduce_gradients``) and takes the global norm with
    each sharded parameter counted once (``grad_norm_sq``)."""

    def __init__(self, model: nn.Module, cfg: ExperimentConfig,
                 capturable: bool = False):
        t = cfg.train
        self.model = model
        self.named = list(model.named_parameters())
        self.params = [p for _, p in self.named]
        self.grad_clip = t.grad_clip
        dev = self.params[0].device if self.params else torch.device("cpu")
        self.capturable = capturable
        lr = (torch.tensor(t.lr, dtype=torch.float32, device=dev)
              if capturable or dev.type != "cuda" else t.lr)
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=t.weight_decay, capturable=self.capturable)
        self.ema_decay = t.ema_decay
        self.ema = ({n: p.detach().clone() for n, p in self.named}
                    if t.ema_decay > 0 else None)

    @property
    def lr(self) -> float:
        return float(self.adamw.param_groups[0]["lr"])

    def set_learning_rate(self, lr: float | torch.Tensor) -> None:
        for group in self.adamw.param_groups:
            if not isinstance(group["lr"], torch.Tensor):
                group["lr"] = float(lr)
            elif isinstance(lr, torch.Tensor):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(float(lr))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        placed = hasattr(self.model, "placement")
        if placed:
            mesh_lib.reduce_gradients(self.model)
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        g_norm = torch.sqrt(mesh_lib.grad_norm_sq(self.model, grads)
                            if placed else sum((g * g).sum() for g in grads))
        trigger = g_norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(trigger, g, g / g_norm * self.grad_clip))
        self.adamw.step()
        if self.ema is not None:
            d = self.ema_decay
            for n, p in self.named:
                self.ema[n].mul_(d).add_(p, alpha=1.0 - d)


    @property
    def count(self) -> int:
        """Updates taken (optax's ``count``)."""
        st = self.adamw.state.get(self.params[0]) if self.params else None
        return int(st["step"]) if st else 0

    def state_dict(self) -> Dict[str, Any]:
        """The state as flax serializes the JAX package's optimizer state:
        ``count`` and ``hyperparams/learning_rate`` of
        ``inject_hyperparams``; ``inner_state/1/0/{count, mu, nu}`` of
        AdamW's ``scale_by_adam``, ``mu`` and ``nu`` in the parameters'
        tree; ``inner_state/2/ema`` with ``train.ema_decay > 0``; the
        stateless transforms as the empty dicts flax writes. Scalars are
        0-d numpy arrays (int32 counts, a float32 learning rate)."""
        count = np.asarray(self.count, np.int32)
        moments = {}
        for key in ("exp_avg", "exp_avg_sq"):
            moments[key] = state_dict_to_params({
                n: self.adamw.state.get(p, {}).get(key, torch.zeros_like(p))
                for n, p in self.named}, self.model)
        inner: Dict[str, Any] = {
            "0": {},
            "1": {"0": {"count": count, "mu": moments["exp_avg"],
                        "nu": moments["exp_avg_sq"]}, "1": {}, "2": {}}}
        if self.ema is not None:
            inner["2"] = {"ema": state_dict_to_params(self.ema,
                                                      self.model)}
        return {"count": count.copy(),
                "hyperparams": {"learning_rate": np.asarray(self.lr,
                                                            np.float32)},
                "hyperparams_states": {}, "inner_state": inner}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a state of ``state_dict``'s layout (as the JAX package
        or this port wrote it): AdamW's moments and step count, the
        learning rate and, where both sides keep one, the EMA."""
        adam = state["inner_state"]["1"]["0"]
        mu = params_to_state_dict(adam["mu"], self.model)
        nu = params_to_state_dict(adam["nu"], self.model)
        count = int(np.asarray(adam["count"]))
        self.adamw.state.clear()
        if count > 0:
            for n, p in self.named:
                self.adamw.state[p] = {
                    "step": torch.tensor(
                        float(count),
                        device=p.device if self.capturable else "cpu"),
                    "exp_avg": mu[n].to(p.device, p.dtype),
                    "exp_avg_sq": nu[n].to(p.device, p.dtype)}
        self.set_learning_rate(float(np.asarray(
            state["hyperparams"]["learning_rate"])))
        ema = state["inner_state"].get("2", {}).get("ema")
        if self.ema is not None and ema is not None:
            with torch.no_grad():
                for n, v in params_to_state_dict(ema, self.model).items():
                    self.ema[n].copy_(v)


def make_optimizer(model: nn.Module, cfg: ExperimentConfig,
                   capturable: bool = False) -> Optimizer:
    return Optimizer(model, cfg, capturable)


def eval_model(model: nn.Module, opt: Optimizer) -> nn.Module:
    """The model to validate with and save as best model: a copy holding
    the Polyak average when ``train.ema_decay > 0``, else ``model``."""
    if opt.ema is None:
        return model
    avg = copy.deepcopy(model)
    avg.load_state_dict(opt.ema, strict=False)
    return avg


def warmup_cosine_lr(cfg: ExperimentConfig, epoch: int) -> float:
    """Linear warmup over ``warmup_epochs``, then cosine decay to 0 over
    the remaining epochs (``train.lr_schedule = 'cosine'``)."""
    t = cfg.train
    if epoch < t.warmup_epochs:
        scale = (epoch + 1) / t.warmup_epochs
    else:
        scale = 0.5 * (1 + math.cos(
            math.pi * (epoch - t.warmup_epochs)
            / max(t.num_epochs - t.warmup_epochs, 1)))
    return t.lr * scale


class PlateauScheduler:
    """Host-side ReduceLROnPlateau with torch semantics: mode=min,
    relative threshold, cooldown, min_lr."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 5,
                 threshold: float = 1e-3, cooldown: int = 1,
                 min_lr: float = 1e-6):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0

    def step(self, value: float) -> float:
        # torch order: count the bad epoch first, then, in cooldown,
        # decrement the counter and suppress num_bad
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> Dict[str, float]:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, state: Dict[str, float]) -> None:
        self.lr = float(state["lr"])
        self.best = float(state["best"])
        self.num_bad = int(state["num_bad"])
        self.cooldown_counter = int(state["cooldown_counter"])


def _loss_weight_dict(cfg: ExperimentConfig) -> Dict[str, float]:
    t = cfg.train
    return {
        "class_loss": t.loss_weights[0],
        "l1_loss": t.loss_weights[1],
        "giou_loss": t.loss_weights[2],
        "footprint_loss": t.footprint_weight,
        "objectness_loss": t.objectness_weight,
        "objectness_iou": 1.0 if t.objectness_iou else 0.0,
        "size_log_loss": t.size_log_weight,
        "aux_loss": t.aux_weight,
        "coverage_loss": t.coverage_weight,
        "coverage_furniture_only": 1.0 if t.coverage_furniture_only else 0.0,
    }


def _targets(sample: Sample) -> Batch:
    return {"boxes": sample.boxes, "labels": sample.labels,
            "valid_mask": sample.valid}


def prepare_batch(batch: Batch, cfg: DataConfig,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, Batch]:
    """Augment (when ``generator`` is given) and featurize a batch:
    returns ``(feats, mask, targets)``."""
    return _prepare(batch, cfg, generator)[:3]


def _prepare(batch: Batch, cfg: DataConfig,
             generator: Optional[torch.Generator] = None, mesh=None,
             accum: int = 1):
    """``prepare_batch`` and the sample weights. With ``mesh``, ``batch``
    is the global batch, augmented whole (the draws of the one-device
    step), and what comes back is this rank's part of it
    (``parallel/mesh.shard_batch`` with ``accum`` microbatches, featurized
    by ``featurize_seq``)."""
    sample = Sample(raw=batch["raw"], length=batch["length"],
                    boxes=batch["boxes"], labels=batch["labels"],
                    valid=batch["valid"])
    if generator is not None:
        B, L = sample.raw.shape[:2]
        r = draw_rands(generator, B, L, sample.boxes.shape[1], cfg,
                       device=sample.raw.device)
        sample = apply_augment(sample, batch["rotation_k"], r, cfg)
    weight = batch["weight"]
    if mesh is None:
        feats, mask = featurize(sample.raw, sample.length)
        return feats, mask, _targets(sample), weight
    local = mesh_lib.shard_batch({**sample._asdict(), "weight": weight},
                                 mesh, accum)
    weight = local.pop("weight")
    sample = Sample(**local)
    feats, mask = mesh_lib.featurize_seq(sample.raw, sample.length,
                                         axis(mesh, "seq"))
    return feats, mask, _targets(sample), weight


# train.matmul_precision (JAX's jax_default_matmul_precision names) -> TF32
# products in cuBLAS / cuDNN, as XLA's GPU backend computes each level on
# float32 operands: 'bfloat16' is JAX's legacy name for DEFAULT, the
# fastest level, which XLA runs as TF32 on this card
TF32_BY_PRECISION = {"float32": False, "highest": False,
                     "tensorfloat32": True, "high": True,
                     "bfloat16": True, "default": True}


@contextlib.contextmanager
def matmul_precision(level: str, device: torch.device | str):
    """Run the body with float32 matmuls and convolutions at ``level`` on a
    CUDA ``device`` (TF32 on or off, ``TF32_BY_PRECISION``); the previous
    ``torch.backends`` flags come back on exit, also on an exception. On
    the CPU nothing changes (as in JAX). The hand-written kernels keep
    their own operand types."""
    if level not in TF32_BY_PRECISION:
        raise ValueError(f"train.matmul_precision={level!r}: expected one "
                         f"of {sorted(TF32_BY_PRECISION)}")
    if torch.device(device).type != "cuda":
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = TF32_BY_PRECISION[level]
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def make_train_step(model: nn.Module, opt: Optimizer, cfg: ExperimentConfig,
                    augment: bool = True, mesh=None
                    ) -> Callable[[Batch, torch.Generator], Batch]:
    """Return ``step(batch, generator) -> losses``: one optimizer update.
    ``generator`` (on the batch's device) draws the augmentation and the
    dropout masks. With ``train.grad_accum = A`` the batch is split into A
    microbatches, each normalizing its own weighted loss, and their
    gradients are averaged into one update. The forward and backward run
    at ``train.matmul_precision`` (``matmul_precision``). Losses come back
    as detached device tensors (the mean over microbatches).

    With ``model.moe_experts`` and a non-zero ``train.moe_aux_weight`` w,
    each microbatch's ``moe_aux`` is the mean over the ``MoEFFN`` layers of
    their load-balance terms, and ``total_loss`` gains ``w * moe_aux``.

    With ``mesh`` (the model placed on it by ``parallel/mesh.shard_params``
    and ``opt`` made after that), ``batch`` is the global batch on every
    rank and the step is the one-device step of it: each rank augments it
    whole with the same draws, takes its part (``_prepare``), computes the
    global loss with means over 'data' and the gradients of
    ``reduce_gradients``; every rank returns the global losses."""
    lw = _loss_weight_dict(cfg)
    data = axis(mesh, "data")
    A = max(1, int(cfg.train.grad_accum))
    precision = cfg.train.matmul_precision
    moe_w = cfg.train.moe_aux_weight if cfg.model.moe_experts else 0.0
    moe_layers = [m for m in model.modules() if isinstance(m, MoEFFN)]

    def step(batch: Batch, generator: torch.Generator) -> Batch:
        feats, mask, targets, weight = _prepare(
            batch, cfg.data, generator if augment else None, mesh, A)
        B, dev = feats.shape[0], feats.device
        if B % A:
            raise ValueError(f"train.grad_accum={A} must divide the batch "
                             f"size {B}")
        mb = B // A
        model.train()
        opt.zero_grad()
        losses: Batch = {}
        with matmul_precision(precision, feats.device):
            for a in range(A):
                sl = slice(a * mb, (a + 1) * mb)
                out = model(feats[sl], mask[sl], generator=generator)
                part = set_criterion(
                    out, {k: v[sl] for k, v in targets.items()},
                    weight[sl], lw, data=data)
                if moe_w:
                    # the mean over the layers, so the weight does not
                    # depend on the encoder's depth
                    aux = (sum(m.aux for m in moe_layers) / len(moe_layers)
                           if moe_layers else torch.zeros((), device=dev))
                    part["moe_aux"] = aux
                    part["total_loss"] = part["total_loss"] + moe_w * aux
                for m in moe_layers:
                    # a term with autograd history would keep the model
                    # from being copied (the EMA's evaluation model)
                    m.aux = None
                (part["total_loss"] / A).backward()
                for k, v in part.items():
                    losses[k] = losses.get(k, 0.0) + v.detach() / A
        opt.step()
        return losses

    return step


def make_eval_step(model: nn.Module, cfg: ExperimentConfig
                   ) -> Callable[[Batch], Tuple[Batch, Batch]]:
    """Validation loss step (no augmentation, eval mode): ``step(batch) ->
    (losses, outputs)``. The objectness term is monitored but kept out of
    the total, so the total stays comparable with the reference's."""
    lw = {
        "class_loss": cfg.train.loss_weights[0],
        "l1_loss": cfg.train.loss_weights[1],
        "giou_loss": cfg.train.loss_weights[2],
        "objectness_loss": 0.0,
        "objectness_iou": 1.0 if cfg.train.objectness_iou else 0.0,
    }

    @torch.no_grad()
    def step(batch: Batch):
        model.eval()
        feats, mask, targets = prepare_batch(batch, cfg.data)
        out = model(feats, mask)
        return set_criterion(out, targets, batch["weight"], lw), out

    return step


def make_eval_epoch(cfg: ExperimentConfig, iou_thresh: float = 0.5,
                    mesh=None) -> Callable:
    """Whole-split evaluation: ``epoch(model, data, plan) -> (mean losses,
    metric sums)`` with the training loss weights, over the batches of an
    index plan (``TraceColliderArrays.epoch_plan``, numpy or already on the
    device: ``device_plan``) on device-resident ``data``. The results are
    device tensors; nothing is read back. With ``mesh`` each rank
    evaluates its part of every batch (``_prepare``) and every rank gets
    the global results."""
    lw = _loss_weight_dict(cfg)
    data_ax = axis(mesh, "data")

    @torch.no_grad()
    def epoch(model: nn.Module, data: Batch, plan: Dict[str, Any]):
        model.eval()
        losses: Batch = {}
        sums: Batch = {}
        plan = device_plan(plan, data["raw"].device)
        nb = plan["base_idx"].shape[0]
        for i in range(nb):
            feats, mask, targets, weight = _prepare(
                gather_batch(data, plan, i), cfg.data, mesh=mesh)
            out = model(feats, mask)
            for k, v in set_criterion(out, targets, weight, lw,
                                      data=data_ax).items():
                losses[k] = losses.get(k, 0.0) + v / nb
            local = {"boxes": targets["boxes"], "labels": targets["labels"],
                     "valid": targets["valid_mask"], "weight": weight}
            for k, v in metrics_sums(out, local, iou_thresh).items():
                sums[k] = sums.get(k, 0) + all_reduce(v, data_ax)
        return losses, sums

    return epoch


def device_plan(plan: Dict[str, Any], dev: torch.device
                ) -> Dict[str, torch.Tensor]:
    """An index plan's arrays as tensors on ``dev`` (one copy each; tensors
    already there are kept)."""
    return {k: torch.as_tensor(v).to(dev) for k, v in plan.items()}


def gather_batch(data: Batch, plan: Dict[str, Any], i: int) -> Batch:
    """Batch ``i`` of an index plan (numpy, or tensors on the data's
    device) from device-resident dataset arrays."""
    dev = data["raw"].device
    idx = torch.as_tensor(plan["base_idx"][i]).to(dev).long()
    batch = {k: v[idx] for k, v in data.items()}
    batch["weight"] = torch.as_tensor(plan["weight"][i]).to(dev)
    if "rotation_k" in plan:
        batch["rotation_k"] = torch.as_tensor(plan["rotation_k"][i]).to(dev)
    return batch


def make_train_steps(model: nn.Module, opt: Optimizer, cfg: ExperimentConfig,
                     augment: bool = True, mesh=None
                     ) -> Callable[[Batch, torch.Generator, int],
                                   torch.Tensor]:
    """``run(batch, generator, n) -> total_loss [n]``: ``n`` optimizer
    updates on one batch, the losses kept on the device (the JAX package's
    multi-step runner; ``bench.py`` times the headline with it)."""
    step = make_train_step(model, opt, cfg, augment, mesh)

    def run(batch: Batch, generator: torch.Generator, n: int
            ) -> torch.Tensor:
        return torch.stack([step(batch, generator)["total_loss"]
                            for _ in range(n)])

    return run


def make_train_epoch(model: nn.Module, opt: Optimizer, cfg: ExperimentConfig,
                     augment: bool = True, mesh=None) -> Callable:
    """``epoch(data, plan, generator) -> mean losses``: one pass over an
    index plan (``base_idx``, ``rotation_k``, ``weight``, each ``[nb,
    B]``, numpy or on the device) of device-resident ``data``, one update a
    batch (``make_train_step``, with ``mesh`` too); the losses' epoch means
    come back as device tensors."""
    step = make_train_step(model, opt, cfg, augment, mesh)

    def epoch(data: Batch, plan: Dict[str, Any],
              generator: torch.Generator) -> Batch:
        plan = device_plan(plan, data["raw"].device)
        nb = plan["base_idx"].shape[0]
        per = [step(gather_batch(data, plan, i), generator)
               for i in range(nb)]
        return {k: torch.stack([p[k] for p in per]).mean() for k in per[0]}

    return epoch


class SchedState(NamedTuple):
    """Device-side ReduceLROnPlateau state (torch semantics, as
    ``PlateauScheduler``): 0-d tensors."""

    lr: torch.Tensor
    best: torch.Tensor
    num_bad: torch.Tensor
    cooldown: torch.Tensor


def sched_init(cfg: ExperimentConfig,
               device: torch.device | str = "cpu") -> SchedState:
    return SchedState(
        lr=torch.tensor(cfg.train.lr, dtype=torch.float32, device=device),
        best=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        num_bad=torch.tensor(0, dtype=torch.int32, device=device),
        cooldown=torch.tensor(0, dtype=torch.int32, device=device))


def sched_update(s: SchedState, value: torch.Tensor,
                 cfg: ExperimentConfig) -> SchedState:
    """One plateau step on the device, in the JAX package's order: the bad
    epoch counted, then, in cooldown, the counter decremented and
    ``num_bad`` zeroed, then the decay."""
    t = cfg.train
    min_lr = t.lr * t.plateau_min_scale
    value = value.to(torch.float32)
    improved = value < s.best * (1.0 - 1e-3)
    best = torch.where(improved, value, s.best)
    zero = torch.zeros_like(s.num_bad)
    num_bad = torch.where(improved, zero, s.num_bad + 1)
    in_cooldown = s.cooldown > 0
    cooldown = torch.where(in_cooldown, s.cooldown - 1, s.cooldown)
    num_bad = torch.where(in_cooldown, zero, num_bad)
    decay = num_bad > t.plateau_patience
    lr = torch.where(decay, torch.clamp(s.lr * t.plateau_factor, min=min_lr),
                     s.lr)
    cooldown = torch.where(decay, torch.full_like(cooldown,
                                                  t.plateau_cooldown),
                           cooldown)
    num_bad = torch.where(decay, zero, num_bad)
    return SchedState(lr=lr, best=best, num_bad=num_bad, cooldown=cooldown)


METRIC_KEYS = ("iou_sum", "iou_cnt", "tp", "fp", "fn", "cls_correct",
               "cls_total")


def fused_run_init(cfg: ExperimentConfig, model: nn.Module, opt: Optimizer
                   ) -> Tuple[SchedState, Batch]:
    """The initial ``(sched, best)`` carry of ``make_fused_run``'s
    segments: the scheduler at ``train.lr`` and the best parameters as
    copies of the evaluation model's (never views of the live ones),
    ``val_loss`` inf and ``epoch`` -1, on the parameters' device."""
    dev = opt.params[0].device
    best = {"params": {k: v.detach().clone() for k, v in
                       eval_model(model, opt).state_dict().items()},
            "val_loss": torch.tensor(float("inf"), device=dev),
            "epoch": torch.tensor(-1, dtype=torch.int32, device=dev)}
    return sched_init(cfg, dev), best


def make_fused_run(model: nn.Module, opt: Optimizer, cfg: ExperimentConfig,
                   mesh=None) -> Callable:
    """A segment of a whole training run with no host read: ``run(sched,
    best, train_data, val_data, plans, val_plan, epoch_ids, generator) ->
    (sched, best, history)``.

    Each epoch trains over its plan (``plans``: ``base_idx``,
    ``rotation_k``, ``weight``, each ``[E, nb, B]`` on the device), then
    validates the evaluation parameters (the EMA when ``train.ema_decay >
    0``) over ``val_plan`` at ``train.matmul_precision``, steps the plateau
    scheduler (whatever ``train.lr_schedule`` says, as the JAX package's
    fused run) and hands its learning rate to AdamW as a device value, and
    keeps the best parameters by ``torch.where(is_best, new, old)`` in
    ``best``'s buffers. ``history`` holds ``[E]`` tensors of
    ``train_loss``, ``val_loss``, ``lr`` and the seven metric sums.
    ``generator`` draws the augmentation and dropout in
    ``train_benchmark``'s order. With ``mesh`` the steps and the
    validation run on each rank's part of every batch
    (``make_train_step``, ``make_eval_epoch``)."""
    epoch_fn = make_train_epoch(model, opt, cfg, augment=True, mesh=mesh)
    eval_fn = make_eval_epoch(cfg, cfg.train.iou_thresh, mesh)

    def run(sched: SchedState, best: Batch, train_data: Batch,
            val_data: Batch, plans: Dict[str, torch.Tensor],
            val_plan: Dict[str, torch.Tensor], epoch_ids: torch.Tensor,
            generator: torch.Generator):
        records = []
        for e in range(plans["base_idx"].shape[0]):
            plan = {k: v[e] for k, v in plans.items()}
            train_loss = epoch_fn(train_data, plan, generator)["total_loss"]
            em = eval_model(model, opt)
            with matmul_precision(cfg.train.matmul_precision,
                                  train_data["raw"].device):
                val_losses, sums = eval_fn(em, val_data, val_plan)
            val_loss = val_losses["total_loss"]
            sched = sched_update(sched, val_loss, cfg)
            opt.set_learning_rate(sched.lr)
            is_best = val_loss < best["val_loss"]
            with torch.no_grad():
                for k, v in em.state_dict().items():
                    old = best["params"][k]
                    old.copy_(torch.where(is_best, v, old))
            best = {"params": best["params"],
                    "val_loss": torch.where(is_best, val_loss,
                                            best["val_loss"]),
                    "epoch": torch.where(is_best, epoch_ids[e],
                                         best["epoch"])}
            records.append({"train_loss": train_loss.float(),
                            "val_loss": val_loss.float(),
                            "lr": sched.lr.clone(),
                            **{k: sums[k].float() for k in METRIC_KEYS}})
        history = {k: torch.stack([r[k] for r in records])
                   for k in records[0]}
        return sched, best, history

    return run
