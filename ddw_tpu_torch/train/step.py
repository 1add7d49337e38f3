"""Train and eval steps — the port of ``ddw_tpu.train.step``.

``ddw_tpu`` compiles forward, backward, the gradient ``pmean`` and the optax
update into one SPMD program. The port runs the same sequence eagerly in
each process of a ``torch.distributed`` group (:mod:`ddw_tpu_torch.runtime.
dist`), in the order of ``_dp_step_body``:

1. forward and backward on this rank's batch (BatchNorm in training mode
   updates the running statistics in place);
2. ``all_reduce`` mean of the gradients;
3. ``all_reduce`` mean of the *updated* BatchNorm running statistics, which
   neither DDP nor SyncBatchNorm does;
4. mean loss and accuracy;
5. the optimizer update, in place.

State: :class:`TrainState` holds the model (its parameters are the params,
its BatchNorm buffers the batch stats), the optimizer state and the step.
The optimizers are written over tensors with optax's arithmetic (:class:
`Optimizer`): ``torch.optim`` puts Adam's epsilon and bias correction
elsewhere, clips over every parameter and keeps state for frozen ones.

Dropout masks come from a CPU ``torch.Generator`` seeded by ``(seed, rank,
step)``, so a chained step draws exactly the mask of the per-step path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ddw_tpu_torch.runtime.dist import all_reduce_mean_, process_topology
from ddw_tpu_torch.utils.config import TrainCfg


@dataclasses.dataclass
class TrainState:
    """The model (params = its parameters, batch stats = its BatchNorm
    buffers, both updated in place), the optimizer state (a nested dict of
    tensors, see :class:`Optimizer`) and the number of steps taken."""

    model: nn.Module
    opt_state: dict
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Sparse categorical cross-entropy from logits, mean over the batch."""
    return F.cross_entropy(logits.float(), labels.long())


def _decayed(decay: float, t: torch.Tensor) -> torch.Tensor:
    """``decay * t`` as JAX computes it: the Python scalar takes ``t``'s
    dtype first (weak typing), so a bf16 moment is scaled by bf16(decay)."""
    return torch.tensor(decay, dtype=t.dtype, device=t.device) * t


class Optimizer:
    """adam | adamw | adadelta | sgd (momentum 0.9) with optax's arithmetic,
    a dynamic learning rate in the state, optional global-norm clipping, and
    frozen leaves left alone (optax ``multi_transform`` with
    ``set_to_zero``: no update, no state, not in the clipping norm). A leaf
    is frozen when its top-level name is in ``frozen_prefixes`` or when
    ``trainable_mask(name)`` (a leaf-level mask over dotted parameter names,
    e.g. :func:`ddw_tpu_torch.models.lora.lora_optimizer`'s) is False.

    The state is ``{"learning_rate", "count", <moments>}`` with one tensor
    per trainable leaf in each moment dict: ``mu``/``nu`` (adam, adamw),
    ``e_g``/``e_x`` (adadelta), ``trace`` (sgd). ``moment_dtype="bfloat16"``
    stores ``mu`` and ``trace`` in bf16, as optax's ``mu_dtype`` /
    ``accumulator_dtype`` do."""

    B1, B2, EPS = 0.9, 0.999, 1e-8              # optax.adam defaults
    RHO, DELTA_EPS = 0.9, 1e-6                  # optax.adadelta defaults
    MOMENTUM = 0.9

    def __init__(self, name: str, learning_rate: float,
                 weight_decay: float = 0.0, moment_dtype: str = "float32",
                 grad_clip_norm: float = 0.0,
                 frozen_prefixes: tuple[str, ...] = (),
                 trainable_mask: Callable[[str], bool] | None = None):
        if weight_decay and name != "adamw":
            raise ValueError(f"weight_decay is only implemented for "
                             f"optimizer='adamw', got {name!r}")
        if moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown moment_dtype {moment_dtype!r}; "
                             f"use 'float32' or 'bfloat16'")
        if name not in ("adam", "adamw", "adadelta", "sgd"):
            raise KeyError(f"unknown optimizer {name!r} "
                           f"(have adam, adamw, adadelta, sgd)")
        if name == "adadelta" and moment_dtype == "bfloat16":
            raise ValueError("moment_dtype='bfloat16' is not supported for "
                             "adadelta (its accumulators feed rsqrt like "
                             "Adam's nu) — use adam/adamw/sgd or drop the "
                             "flag")
        self.name, self.learning_rate = name, learning_rate
        self.weight_decay = weight_decay
        self.mu_dtype = (torch.bfloat16 if moment_dtype == "bfloat16"
                         else torch.float32)
        self.clip = grad_clip_norm
        self.frozen_prefixes = tuple(frozen_prefixes)
        self.trainable_mask = trainable_mask

    def trainable(self, name: str) -> bool:
        if name.split(".", 1)[0] in self.frozen_prefixes:
            return False
        return self.trainable_mask is None or self.trainable_mask(name)

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        train = {n: p for n, p in params.items() if self.trainable(n)}
        dev = next(iter(params.values())).device

        def zeros(dtype=torch.float32):
            return {n: torch.zeros(p.shape, dtype=dtype, device=p.device)
                    for n, p in train.items()}

        state = {"learning_rate": torch.tensor(self.learning_rate,
                                               dtype=torch.float32, device=dev),
                 "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.name in ("adam", "adamw"):
            state.update(mu=zeros(self.mu_dtype), nu=zeros())
        elif self.name == "adadelta":
            state.update(e_g=zeros(), e_x=zeros())
        else:
            state.update(trace=zeros(self.mu_dtype))
        return state

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor | None], state: dict) -> None:
        """One update, in place on ``params`` and ``state``."""
        names = [n for n in params if self.trainable(n)]
        g = {n: grads[n] if grads.get(n) is not None
             else torch.zeros_like(params[n]) for n in names}
        if self.clip:
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g.values()))
            keep = norm < self.clip
            g = {n: torch.where(keep, t, (t / norm) * self.clip)
                 for n, t in g.items()}
        lr = state["learning_rate"]
        state["count"] += 1
        count = state["count"].float()
        if self.name in ("adam", "adamw"):
            bc1 = 1 - torch.tensor(self.B1, device=count.device) ** count
            bc2 = 1 - torch.tensor(self.B2, device=count.device) ** count
            for n in names:
                mu = (1 - self.B1) * g[n] + _decayed(self.B1, state["mu"][n])
                nu = (1 - self.B2) * (g[n] * g[n]) + self.B2 * state["nu"][n]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
                if self.name == "adamw":
                    u = u + self.weight_decay * params[n]
                params[n].add_(u * -lr)
                state["mu"][n].copy_(mu)
                state["nu"][n].copy_(nu)
        elif self.name == "adadelta":
            for n in names:
                e_g = (1 - self.RHO) * (g[n] * g[n]) + self.RHO * state["e_g"][n]
                u = (torch.sqrt(state["e_x"][n] + self.DELTA_EPS)
                     / torch.sqrt(e_g + self.DELTA_EPS)) * g[n]
                e_x = (1 - self.RHO) * (u * u) + self.RHO * state["e_x"][n]
                params[n].add_(u * -lr)
                state["e_g"][n].copy_(e_g)
                state["e_x"][n].copy_(e_x)
        else:
            for n in names:
                tr = g[n] + _decayed(self.MOMENTUM, state["trace"][n])
                params[n].add_(tr * -lr)
                state["trace"][n].copy_(tr)


class EmaOptimizer:
    """``with_param_ema``: the inner optimizer, then a Polyak shadow of the
    post-update parameters, ``shadow = d*shadow + (1-d)*p``, kept in the
    optimizer state (``{"inner": ..., "shadow": {name: f32 tensor}}``)."""

    def __init__(self, inner: Optimizer, decay: float):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"ema decay must be in (0, 1), got {decay}")
        self.inner, self.decay = inner, decay

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {"inner": self.inner.init(params),
                "shadow": {n: p.detach().float().clone()
                           for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params, grads, state) -> None:
        self.inner.update(params, grads, state["inner"])
        d = self.decay
        for n, s in state["shadow"].items():
            s.copy_(d * s + (1.0 - d) * params[n].float())


def make_optimizer(cfg: TrainCfg,
                   frozen_prefixes: tuple[str, ...] = ()) -> Optimizer:
    """The optimizer of ``cfg`` (``optimizer``, ``learning_rate``,
    ``weight_decay``, ``moment_dtype``, ``grad_clip_norm``) with the given
    top-level parameter names frozen."""
    return Optimizer(cfg.optimizer, cfg.learning_rate, cfg.weight_decay,
                     cfg.moment_dtype, cfg.grad_clip_norm, frozen_prefixes)


def with_param_ema(tx: Optimizer, decay: float) -> EmaOptimizer:
    return EmaOptimizer(tx, decay)


def init_state(model: nn.Module, tx) -> TrainState:
    """A fresh :class:`TrainState` for ``model`` (weights already drawn or
    loaded) and optimizer ``tx``."""
    return TrainState(model, tx.init(dict(model.named_parameters())), 0)


def _lr_holder(state: TrainState) -> dict:
    os_ = state.opt_state
    return os_["inner"] if "inner" in os_ else os_


def ema_params(state: TrainState) -> dict[str, torch.Tensor] | None:
    """The Polyak shadow params, or ``None`` when EMA is off."""
    return state.opt_state.get("shadow")


def get_lr(state: TrainState) -> float:
    """The current dynamic learning rate."""
    return float(_lr_holder(state)["learning_rate"])


def set_lr(state: TrainState, lr: float) -> TrainState:
    """Set the dynamic learning rate (in place; returns ``state``)."""
    _lr_holder(state)["learning_rate"].fill_(lr)
    return state


def dropout_generator(seed: int, rank: int, step: int,
                      micro: int = 0) -> torch.Generator:
    """The dropout stream of one (rank, step, microbatch): the role of
    ``fold_in(fold_in(rng, rank), step)`` (+ the microbatch index)."""
    key = seed & 0xFFFFFFFF
    for part in (rank, step, micro):
        key = (key * 1_000_003 + part + 1) % (1 << 62)
    return torch.Generator().manual_seed(key)


def forward_and_grads(state: TrainState, images: torch.Tensor,
                      labels: torch.Tensor, dropout_rng: torch.Generator):
    """Forward in training mode, loss and accuracy, backward. Returns
    ``(loss, acc, batch_stats, grads)``: the batch stats are the model's
    buffers, already updated by the forward; ``grads`` maps every parameter
    name to its gradient, ``None`` where none reaches it (a frozen base)."""
    model = state.model
    model.train()
    named = list(model.named_parameters())
    logits = model(images, dropout_rng=dropout_rng)
    loss = cross_entropy_loss(logits, labels)
    acc = (logits.argmax(-1) == labels.long()).float().mean()
    wants = [p for _, p in named if p.requires_grad]
    got = iter(torch.autograd.grad(loss, wants, allow_unused=True))
    grads = {n: next(got) if p.requires_grad else None for n, p in named}
    return loss.detach(), acc.detach(), state.batch_stats, grads


def accumulate_grads(state: TrainState, images: torch.Tensor,
                     labels: torch.Tensor, seed: int, rank: int,
                     accum: int):
    """Gradient accumulation over ``accum`` equal microbatches of the batch
    (``scan_microbatches``): BatchNorm statistics thread through the
    microbatches in order, each microbatch draws its own dropout mask, and
    the mean of the microbatch gradients, losses and accuracies is returned
    like :func:`forward_and_grads`."""
    b = images.shape[0]
    if b % accum:
        raise ValueError(f"per-device batch {b} not divisible by "
                         f"grad_accum_steps {accum}")
    mb = b // accum
    return scan_microbatches(state, images.reshape(accum, mb, *images.shape[1:]),
                             labels.reshape(accum, mb, *labels.shape[1:]),
                             seed, rank)


def scan_microbatches(state: TrainState, im: torch.Tensor, lb: torch.Tensor,
                      seed: int, rank: int):
    """The :func:`accumulate_grads` loop over pre-split ``im/lb[accum, mb,
    ...]``."""
    accum = im.shape[0]
    gsum: dict[str, torch.Tensor | None] = {}
    lsum = asum = 0.0
    for i in range(accum):
        loss, acc, _, grads = forward_and_grads(
            state, im[i], lb[i], dropout_generator(seed, rank, state.step, i))
        for n, g in grads.items():
            if g is None:
                gsum.setdefault(n, None)
            else:
                prev = gsum.get(n)
                gsum[n] = g if prev is None else prev + g
        lsum, asum = lsum + loss, asum + acc
    inv = 1.0 / accum
    grads = {n: None if g is None else g * inv for n, g in gsum.items()}
    return lsum * inv, asum * inv, state.batch_stats, grads


def _dp_step_body(tx, grad_accum_steps: int, state: TrainState,
                  images: torch.Tensor, labels: torch.Tensor, seed: int):
    """One optimizer update on this rank's batch, in ``_dp_step_body``'s
    order. Returns ``(loss, accuracy)`` as world-mean device scalars."""
    rank, _ = process_topology()
    if grad_accum_steps > 1:
        loss, acc, bstats, grads = accumulate_grads(
            state, images, labels, seed, rank, grad_accum_steps)
    else:
        loss, acc, bstats, grads = forward_and_grads(
            state, images, labels, dropout_generator(seed, rank, state.step))
    all_reduce_mean_([g for g in grads.values() if g is not None])
    all_reduce_mean_(list(bstats.values()))  # world-consistent BN statistics
    metrics = torch.stack([loss.float(), acc.float()])
    all_reduce_mean_([metrics])
    tx.update(state.params, grads, state.opt_state)
    state.step += 1
    return metrics[0], metrics[1]


def make_train_step(tx, grad_accum_steps: int = 1) -> Callable:
    """``step(state, images, labels, seed) -> metrics``: one data-parallel
    update of ``state`` in place; ``metrics["loss"|"accuracy"]`` are device
    scalars already averaged over the world. ``grad_accum_steps > 1`` runs
    the batch as that many sequential microbatches."""

    def step(state, images, labels, seed):
        loss, acc = _dp_step_body(tx, grad_accum_steps, state, images,
                                  labels, seed)
        return {"loss": loss, "accuracy": acc}

    return step


def make_train_chain(tx, grad_accum_steps: int = 1) -> Callable:
    """``chain(state, images[K, B, ...], labels[K, B], seed) -> metrics``:
    K updates in one call over a super-batch, ``metrics`` as ``[K]`` device
    arrays fetched once. Each update is the per-step body, so the result is
    that of K :func:`make_train_step` calls."""

    def chain(state, images, labels, seed):
        out = [_dp_step_body(tx, grad_accum_steps, state, images[k],
                             labels[k], seed) for k in range(images.shape[0])]
        return {"loss": torch.stack([l for l, _ in out]),
                "accuracy": torch.stack([a for _, a in out])}

    return chain


def chain_plan(steps_per_epoch: int, k: int) -> tuple[int, ...]:
    """Chain lengths covering one epoch exactly: ``steps_per_epoch // k``
    full chains plus one trailing partial chain. ``k=1`` is per-step
    dispatch. The trainer and the loader's super-batches share the plan."""
    if steps_per_epoch < 1:
        raise ValueError(f"steps_per_epoch must be >= 1, got {steps_per_epoch}")
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    if k <= 1:
        return (1,) * steps_per_epoch
    n_full, tail = divmod(steps_per_epoch, k)
    return (k,) * n_full + ((tail,) if tail else ())


def fetch_metrics_mean(values) -> float:
    """The per-step mean of accumulated device metrics (scalars and ``[k]``
    chain arrays) with one host fetch."""
    if not values:
        return float("nan")
    return float(torch.cat([torch.as_tensor(v).reshape(-1).float()
                            for v in values]).mean())


@torch.no_grad()
def _swap_params(model: nn.Module, params: dict[str, torch.Tensor]) -> dict:
    old = {}
    for n, p in model.named_parameters():
        old[n] = p.detach().clone()
        p.copy_(params[n])
    return old


def make_eval_step() -> Callable:
    """``eval_step(state, images, labels, params=None) -> metrics``: the
    model in eval mode, world-mean loss and accuracy. ``params`` (e.g. the
    EMA shadow) replace the model's parameters for the call."""
    @torch.no_grad()
    def eval_step(state, images, labels, params=None):
        model = state.model
        model.eval()
        old = _swap_params(model, params) if params is not None else None
        try:
            logits = model(images)
        finally:
            if old is not None:
                _swap_params(model, old)
        loss = cross_entropy_loss(logits, labels)
        acc = (logits.argmax(-1) == labels.long()).float().mean()
        metrics = torch.stack([loss, acc])
        all_reduce_mean_([metrics])
        return {"loss": metrics[0], "accuracy": metrics[1]}

    return eval_step


def params_checksum(state: TrainState) -> float:
    """Sum of |params| in f32: equal across ranks iff they are in lockstep."""
    with torch.no_grad():
        return float(sum(p.detach().float().abs().sum()
                         for p in state.model.parameters()))
