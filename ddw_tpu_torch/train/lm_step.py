"""LM train and eval steps — the port of ``ddw_tpu.train.lm_step``.

``ddw_tpu`` compiles forward, backward, the gradient ``pmean`` over its
(data, seq) mesh and the optax update into one ``shard_map`` program. The
port runs the same sequence eagerly in each process of a
``torch.distributed`` group (:mod:`ddw_tpu_torch.runtime.dist`):

1. forward in training mode and backward on this rank's ``(inputs,
   targets)`` next-token pairs (pre-shifted on the host), optionally as
   ``grad_accum_steps`` sequential microbatches;
2. the mean of the gradients over data x seq (the world);
3. the world-mean loss and token accuracy;
4. the optimizer update, in place.

Sequence parallelism: with ``seq_axis`` and a ``mesh`` of ``(data, seq)``
each rank holds its ``[B_local, S / n_seq]`` shard of the tokens, and the
model, built with the same ``seq_axis``, runs ring attention over the
axis; the steps bind ``mesh`` (:func:`ddw_tpu_torch.runtime.mesh.
bind_mesh`) around the forward. A model whose ``num_experts > 0`` adds its
Switch load-balance loss (the mean of the blocks' sown ``moe_aux_loss``)
with ``aux_loss_weight`` and reports it as ``aux_loss``; its
``expert_axis`` must be an axis of the step.

A model built with ``lora_rank > 0`` gets the LoRA mask here
(``_maybe_lora_tx``), so a plain optimizer cannot fine-tune the frozen base
alongside the adapters. Dropout masks come from :func:`ddw_tpu_torch.train.
step.dropout_generator` seeded by ``(seed, rank, step, microbatch)``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

import contextlib

from ddw_tpu_torch.runtime.dist import all_reduce_mean_, group_topology
from ddw_tpu_torch.runtime.mesh import bind_mesh
from ddw_tpu_torch.train.step import (TrainState, _swap_params,
                                      apply_gradients, dropout_generator)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy: ``logits [B, S, V]`` against ``targets [B,
    S]``, the mean over every token (``cross_entropy_loss`` broadcast over
    the sequence)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def token_accuracy(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == targets.long()).float().mean()


def _maybe_lora_tx(model, tx):
    """The LoRA freezing mask for a model built with ``lora_rank > 0``,
    applied in the shared optimizer layer as ``ddw_tpu`` does: by
    :func:`init_lm_state` and by the step factories alike."""
    if getattr(model, "lora_rank", 0):
        from ddw_tpu_torch.models.lora import lora_optimizer

        return lora_optimizer(tx)
    return tx


def _lm_axes(model, mesh, data_axis: str, seq_axis) -> tuple:
    """The model/step axis contract (``ddw_tpu``'s ``_lm_axes``): the
    model's ``seq_axis`` is the step's, a routing model's ``expert_axis``
    is one of the step's axes, and the axes span the mesh's ranks (the
    gradient mean runs over the world)."""
    axes = (data_axis,) if seq_axis is None else (data_axis, seq_axis)
    if (getattr(model, "seq_axis", None) or None) != (seq_axis or None):
        raise ValueError(f"model.seq_axis={model.seq_axis!r} but step "
                         f"seq_axis={seq_axis!r} — construct the model with "
                         f"the axis it will run under")
    expert_axis = getattr(model, "expert_axis", None)
    if expert_axis and expert_axis not in axes:
        raise ValueError(f"model.expert_axis={expert_axis!r} is not a step "
                         f"mesh axis {axes}")
    if (seq_axis or expert_axis) and mesh is None:
        raise ValueError("a sequence- or expert-parallel step needs the "
                         "mesh its axes name (mesh=)")
    if mesh is not None:
        size = 1
        for ax in axes:
            size *= mesh.shape[ax]
        if size != int(mesh.ranks.size):
            raise ValueError(f"step axes {axes} cover {size} of the mesh's "
                             f"{int(mesh.ranks.size)} ranks")
    return axes


def _bound(mesh):
    return bind_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def init_lm_state(model, tx, generator: torch.Generator,
                  device=None) -> TrainState:
    """Seeded init (the same weights on every rank: the rank-0 broadcast):
    flax's initialisers drawn from ``generator`` (a CPU generator), the
    model moved to ``device``, and the optimizer state of ``tx`` (with the
    LoRA mask when the model has adapters)."""
    from ddw_tpu_torch.models.convert import init_lm_weights

    tx = _maybe_lora_tx(model, tx)
    init_lm_weights(model, generator)
    if device is not None:
        model.to(device)
    return TrainState(model, tx.init(dict(model.named_parameters())), 0)


def _trainable(tx, name: str) -> bool:
    return getattr(tx, "inner", tx).trainable(name)


def moe_aux(model) -> torch.Tensor | None:
    """The mean over MoE blocks of the aux loss the last forward sowed
    (selected by name), ``None`` for a dense model."""
    if not getattr(model, "num_experts", 0):
        return None
    from ddw_tpu_torch.models.moe import collect_sown

    sown = collect_sown(model, "moe_aux_loss")
    return sum(sown) / len(sown)


def _forward_and_grads(state: TrainState, inputs, targets, dropout_rng,
                       tx=None, aux_loss_weight: float = 0.01):
    model = state.model
    model.train()
    named = list(model.named_parameters())
    logits = model(inputs.long(), dropout_rng=dropout_rng)
    loss = lm_loss(logits, targets)
    acc = token_accuracy(logits.detach(), targets)
    del logits
    aux = moe_aux(model)
    total = loss if aux is None else loss + aux_loss_weight * aux
    wanted = [p.requires_grad and (tx is None or _trainable(tx, n))
              for n, p in named]
    got = iter(torch.autograd.grad(
        total, [p for (_, p), w in zip(named, wanted) if w]))
    grads = {n: next(got) if w else None for (n, _), w in zip(named, wanted)}
    aux = torch.zeros((), device=loss.device) if aux is None else aux.detach()
    return loss.detach(), acc, grads, aux


def lm_forward_and_grads(state: TrainState, inputs: torch.Tensor,
                         targets: torch.Tensor,
                         dropout_rng: torch.Generator | None, tx=None):
    """Forward in training mode, loss and token accuracy, backward. Returns
    ``(loss, accuracy, grads)``; ``grads`` maps every parameter name to its
    gradient, ``None`` for the leaves ``tx`` freezes (not computed)."""
    return _forward_and_grads(state, inputs, targets, dropout_rng, tx)[:3]


def _accumulate(tx, state: TrainState, inputs, targets, seed: int, rank: int,
                accum: int, aux_w: float):
    """``accum`` equal microbatches of the local batch, the sequence kept
    whole; each draws its own dropout masks. The mean of the microbatch
    gradients, losses, accuracies and aux losses."""
    b = inputs.shape[0]
    if b % accum:
        raise ValueError(f"local batch {b} not divisible by grad_accum_steps "
                         f"{accum}")
    mb = b // accum
    gsum: dict[str, torch.Tensor | None] = {}
    lsum = asum = xsum = 0.0
    for i in range(accum):
        sl = slice(i * mb, (i + 1) * mb)
        loss, acc, grads, aux = _forward_and_grads(
            state, inputs[sl], targets[sl],
            dropout_generator(seed, rank, state.step, i), tx, aux_w)
        for n, g in grads.items():
            prev = gsum.get(n)
            gsum[n] = g if prev is None else (prev if g is None else prev + g)
        lsum, asum, xsum = lsum + loss, asum + acc, xsum + aux
    inv = 1.0 / accum
    grads = {n: None if g is None else g * inv for n, g in gsum.items()}
    return lsum * inv, asum * inv, grads, xsum * inv


def _lm_step_body(tx, grad_accum_steps: int, state: TrainState, inputs,
                  targets, seed: int, aux_w: float = 0.01):
    """One optimizer update; returns ``(loss, accuracy, aux)`` as
    world-mean device scalars."""
    rank, _ = group_topology()
    if grad_accum_steps > 1:
        loss, acc, grads, aux = _accumulate(tx, state, inputs, targets, seed,
                                            rank, grad_accum_steps, aux_w)
    else:
        loss, acc, grads, aux = _forward_and_grads(
            state, inputs, targets, dropout_generator(seed, rank, state.step),
            tx, aux_w)
    all_reduce_mean_([g for g in grads.values() if g is not None])
    metrics = torch.stack([loss.float(), acc.float(), aux.float()])
    all_reduce_mean_([metrics])
    apply_gradients(state, tx, grads)
    return metrics[0], metrics[1], metrics[2]


def _metrics(model, loss, acc, aux) -> dict:
    out = {"loss": loss, "accuracy": acc}
    if getattr(model, "num_experts", 0):
        out["aux_loss"] = aux
    return out


def make_lm_train_step(model, tx, grad_accum_steps: int = 1,
                       seq_axis: str | None = None, mesh=None,
                       data_axis: str = "data",
                       aux_loss_weight: float = 0.01) -> Callable:
    """``step(state, inputs [B, S], targets [B, S], seed) -> metrics``: one
    update of ``state`` in place on this rank's shard of the tokens (its
    data shard's rows; with ``seq_axis``, its sequence shard of them);
    ``metrics["loss"|"accuracy"]`` (and ``aux_loss`` for MoE) are device
    scalars averaged over the world."""
    _lm_axes(model, mesh, data_axis, seq_axis)
    tx = _maybe_lora_tx(model, tx)

    def step(state, inputs, targets, seed):
        with _bound(mesh):
            return _metrics(model, *_lm_step_body(
                tx, grad_accum_steps, state, inputs, targets, seed,
                aux_loss_weight))

    return step


def make_lm_train_chain(model, tx, grad_accum_steps: int = 1,
                        seq_axis: str | None = None, mesh=None,
                        data_axis: str = "data",
                        aux_loss_weight: float = 0.01) -> Callable:
    """``chain(state, inputs [K, B, S], targets [K, B, S], seed) ->
    metrics`` as ``[K]`` arrays (``TrainCfg.steps_per_dispatch``): K updates,
    each the per-step body, so the result is that of K
    :func:`make_lm_train_step` calls."""
    _lm_axes(model, mesh, data_axis, seq_axis)
    tx = _maybe_lora_tx(model, tx)

    def chain(state, inputs, targets, seed):
        with _bound(mesh):
            out = [_lm_step_body(tx, grad_accum_steps, state, inputs[k],
                                 targets[k], seed, aux_loss_weight)
                   for k in range(inputs.shape[0])]
        return _metrics(model, *[torch.stack(col) for col in zip(*out)])

    return chain


def make_lm_eval_step(model, seq_axis: str | None = None,
                      mesh=None, data_axis: str = "data") -> Callable:
    """``eval_step(state, inputs, targets, params=None) -> metrics``: the
    model in eval mode, world-mean loss and token accuracy. ``params`` (the
    EMA shadow) replace the model's parameters for the call."""
    _lm_axes(model, mesh, data_axis, seq_axis)

    @torch.no_grad()
    def eval_step(state, inputs, targets, params=None):
        m = state.model
        m.eval()
        old = _swap_params(m, params) if params is not None else None
        try:
            with _bound(mesh):
                logits = m(inputs.long())
        finally:
            if old is not None:
                _swap_params(m, old)
        metrics = torch.stack([lm_loss(logits, targets),
                               token_accuracy(logits, targets)])
        del logits
        all_reduce_mean_([metrics])
        return {"loss": metrics[0], "accuracy": metrics[1]}

    return eval_step
