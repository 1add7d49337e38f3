"""LM train and eval steps — the port of ``ddw_tpu.train.lm_step``.

``ddw_tpu`` compiles forward, backward, the gradient ``pmean`` over its
(data, seq) mesh and the optax update into one ``shard_map`` program. The
port runs the same sequence eagerly in each process of a
``torch.distributed`` group (:mod:`ddw_tpu_torch.runtime.dist`), data
parallel only:

1. forward in training mode and backward on this rank's ``(inputs,
   targets)`` next-token pairs (pre-shifted on the host), optionally as
   ``grad_accum_steps`` sequential microbatches;
2. ``all_reduce`` mean of the gradients over the group;
3. the world-mean loss and token accuracy;
4. the optimizer update, in place.

A model built with ``lora_rank > 0`` gets the LoRA mask here
(``_maybe_lora_tx``), so a plain optimizer cannot fine-tune the frozen base
alongside the adapters. Dropout masks come from :func:`ddw_tpu_torch.train.
step.dropout_generator` seeded by ``(seed, rank, step, microbatch)``.

Not yet ported, refused naming ``ROADMAP.md``: sequence parallelism
(``seq_axis``, the ring attention of slice 5) here, and MoE (the expert MLP
and its aux loss) by ``build_lm``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ddw_tpu_torch.models.lm import _not_ported
from ddw_tpu_torch.runtime.dist import all_reduce_mean_, process_topology
from ddw_tpu_torch.train.step import (TrainState, _swap_params,
                                      dropout_generator)


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


def _refuse_seq_axis(seq_axis) -> None:
    if seq_axis is not None:
        raise _not_ported("sequence-parallel LM training (seq_axis)")


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


def lm_forward_and_grads(state: TrainState, inputs: torch.Tensor,
                         targets: torch.Tensor,
                         dropout_rng: torch.Generator | None, tx=None):
    """Forward in training mode, loss and token accuracy, backward. Returns
    ``(loss, accuracy, grads)``; ``grads`` maps every parameter name to its
    gradient, ``None`` for the leaves ``tx`` freezes (not computed)."""
    model = state.model
    model.train()
    named = list(model.named_parameters())
    logits = model(inputs.long(), dropout_rng=dropout_rng)
    loss = lm_loss(logits, targets)
    acc = token_accuracy(logits.detach(), targets)
    del logits
    wanted = [p.requires_grad and (tx is None or _trainable(tx, n))
              for n, p in named]
    got = iter(torch.autograd.grad(
        loss, [p for (_, p), w in zip(named, wanted) if w]))
    grads = {n: next(got) if w else None for (n, _), w in zip(named, wanted)}
    return loss.detach(), acc, grads


def _accumulate(tx, state: TrainState, inputs, targets, seed: int, rank: int,
                accum: int):
    """``accum`` equal microbatches of the local batch, the sequence kept
    whole; each draws its own dropout masks. The mean of the microbatch
    gradients, losses and accuracies."""
    b = inputs.shape[0]
    if b % accum:
        raise ValueError(f"local batch {b} not divisible by grad_accum_steps "
                         f"{accum}")
    mb = b // accum
    gsum: dict[str, torch.Tensor | None] = {}
    lsum = asum = 0.0
    for i in range(accum):
        sl = slice(i * mb, (i + 1) * mb)
        loss, acc, grads = lm_forward_and_grads(
            state, inputs[sl], targets[sl],
            dropout_generator(seed, rank, state.step, i), tx)
        for n, g in grads.items():
            prev = gsum.get(n)
            gsum[n] = g if prev is None else (prev if g is None else prev + g)
        lsum, asum = lsum + loss, asum + acc
    inv = 1.0 / accum
    grads = {n: None if g is None else g * inv for n, g in gsum.items()}
    return lsum * inv, asum * inv, grads


def _lm_step_body(tx, grad_accum_steps: int, state: TrainState, inputs,
                  targets, seed: int):
    """One optimizer update; returns ``(loss, accuracy)`` as world-mean
    device scalars."""
    rank, _ = process_topology()
    if grad_accum_steps > 1:
        loss, acc, grads = _accumulate(tx, state, inputs, targets, seed,
                                       rank, grad_accum_steps)
    else:
        loss, acc, grads = lm_forward_and_grads(
            state, inputs, targets, dropout_generator(seed, rank, state.step),
            tx)
    all_reduce_mean_([g for g in grads.values() if g is not None])
    metrics = torch.stack([loss.float(), acc.float()])
    all_reduce_mean_([metrics])
    tx.update(state.params, grads, state.opt_state)
    state.step += 1
    return metrics[0], metrics[1]


def make_lm_train_step(model, tx, grad_accum_steps: int = 1,
                       seq_axis: str | None = None) -> Callable:
    """``step(state, inputs [B, S], targets [B, S], seed) -> metrics``: one
    data-parallel update of ``state`` in place; ``metrics["loss"|
    "accuracy"]`` are device scalars averaged over the world."""
    _refuse_seq_axis(seq_axis)
    tx = _maybe_lora_tx(model, tx)

    def step(state, inputs, targets, seed):
        loss, acc = _lm_step_body(tx, grad_accum_steps, state, inputs,
                                  targets, seed)
        return {"loss": loss, "accuracy": acc}

    return step


def make_lm_train_chain(model, tx, grad_accum_steps: int = 1,
                        seq_axis: str | None = None) -> Callable:
    """``chain(state, inputs [K, B, S], targets [K, B, S], seed) ->
    metrics`` as ``[K]`` arrays (``TrainCfg.steps_per_dispatch``): K updates,
    each the per-step body, so the result is that of K
    :func:`make_lm_train_step` calls."""
    _refuse_seq_axis(seq_axis)
    tx = _maybe_lora_tx(model, tx)

    def chain(state, inputs, targets, seed):
        out = [_lm_step_body(tx, grad_accum_steps, state, inputs[k],
                             targets[k], seed)
               for k in range(inputs.shape[0])]
        return {"loss": torch.stack([l for l, _ in out]),
                "accuracy": torch.stack([a for _, a in out])}

    return chain


def make_lm_eval_step(model, seq_axis: str | None = None) -> Callable:
    """``eval_step(state, inputs, targets, params=None) -> metrics``: the
    model in eval mode, world-mean loss and token accuracy. ``params`` (the
    EMA shadow) replace the model's parameters for the call."""
    _refuse_seq_axis(seq_axis)

    @torch.no_grad()
    def eval_step(state, inputs, targets, params=None):
        m = state.model
        m.eval()
        old = _swap_params(m, params) if params is not None else None
        try:
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
