"""Pipeline parallelism for the LM — the port of ``ddw_tpu.parallel.pipeline``:
GPipe and interleaved microbatch schedules over a ``pipe`` mesh axis.

``ddw_tpu`` stacks the blocks per stage (``[n_stages, blocks_per_stage,
...]`` leaves sharded over ``pipe``) and runs every rank through the same
``lax.scan`` of ticks, on masked garbage outside a stage's window, with
``jax.grad`` transposing the ``ppermute`` hops. The port cannot run masked
SPMD ticks: each rank runs only its own work.

- **Residency.** A rank's module holds the blocks of its own chunks (chunk
  ``c`` on rank ``c % n``; GPipe has one chunk a rank, interleaved ``v``),
  under their global names (``backbone_block{i}``), plus the replicated
  embedding and head (:func:`init_pp_state`). :func:`pp_params_from_lm` /
  :func:`lm_params_from_pp` convert a flat LM tree to ``ddw_tpu``'s stacked
  layout and back.
- **Schedule.** ``ddw_tpu``'s ticks: at tick ``t`` rank ``r`` runs chunk
  ``k = (t - r) // n`` on microbatch ``j = (t - r) % n`` (interleaved,
  ``m <= n``) or chunk ``r`` on microbatch ``t - r`` (GPipe). A rank walks
  its own (tick, chunk, microbatch) events in tick order; every input it
  needs was sent at the tick before, so blocking receives and deferred
  sends cannot deadlock.
- **Backward.** An explicit schedule in reverse tick order: the last chunk
  starts from its microbatch's share of the loss, every other chunk waits
  for its output's gradient from the next rank, runs ``autograd.backward``
  on the activations it kept, and sends its input's gradient back.
- **Loss and gradients.** ``ddw_tpu``'s: the mean over microbatches of the
  last chunk's cross-entropy, plus ``aux_loss_weight`` times the MoE aux
  loss summed over blocks and microbatches over ``m * depth``; embedding
  and head gradients summed over ``pipe`` (only the first and last chunk
  produce them), every gradient averaged over ``data`` (DP x PP).

Scope, as ``ddw_tpu``'s: dropout 0, no sequence axis, no expert axis (MoE
experts stay local), no LoRA. No per-stage rematerialisation: a rank keeps
its chunks' activations for every microbatch until the backward.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ddw_tpu_torch.ops.ring_reduce import recv, send
from ddw_tpu_torch.runtime.dist import all_reduce_mean_
from ddw_tpu_torch.train.lm_step import lm_loss, token_accuracy
from ddw_tpu_torch.train.step import apply_gradients

PIPE_AXIS = "pipe"


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return np.stack(trees)


def _index(tree, *idx):
    if isinstance(tree, dict):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def pp_params_from_lm(params: dict, n_stages: int, depth: int,
                      virtual_stages: int = 1) -> dict:
    """A flat LM params tree (flax names, numpy or tensors) in ``ddw_tpu``'s
    pipeline layout: ``{"embed", "stages", "head"}`` with every block leaf
    stacked ``[n_stages, depth / n_stages, ...]`` (GPipe) or ``[v,
    n_stages, depth / (n * v), ...]`` (interleaved; ``leaf[k, r]`` is chunk
    ``k * n + r``)."""
    v = virtual_stages
    if depth % (n_stages * v):
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages "
                         f"x {v} virtual stages")
    bpc = depth // (n_stages * v)
    blocks = [params[f"backbone_block{i}"] for i in range(depth)]

    def chunk(c):
        return _stack(blocks[c * bpc:(c + 1) * bpc])

    if v == 1:
        stages = _stack([chunk(r) for r in range(n_stages)])
    else:
        stages = _stack([_stack([chunk(k * n_stages + r)
                                 for r in range(n_stages)])
                         for k in range(v)])
    embed = {"tok_embed": params["tok_embed"]}
    if "pos_embed" in params:
        embed["pos_embed"] = params["pos_embed"]
    return {"embed": embed, "stages": stages,
            "head": {"LayerNorm_0": params["LayerNorm_0"],
                     "head": params["head"]}}


def lm_params_from_pp(pp: dict, n_stages: int, depth: int,
                      virtual_stages: int = 1) -> dict:
    """The inverse of :func:`pp_params_from_lm`."""
    v = virtual_stages
    bpc = depth // (n_stages * v)
    out = {"tok_embed": pp["embed"]["tok_embed"],
           "LayerNorm_0": pp["head"]["LayerNorm_0"],
           "head": pp["head"]["head"]}
    if "pos_embed" in pp["embed"]:
        out["pos_embed"] = pp["embed"]["pos_embed"]
    for c in range(n_stages * v):
        k, r = divmod(c, n_stages)
        for b in range(bpc):
            out[f"backbone_block{c * bpc + b}"] = (
                _index(pp["stages"], r, b) if v == 1
                else _index(pp["stages"], k, r, b))
    return out


def bubble_fraction(n_stages: int, num_microbatches: int,
                    virtual_stages: int = 1) -> float:
    """Idle fraction of the schedule: GPipe ``(n-1)/(m+n-1)``; interleaved
    ``m*v`` busy of ``v*n + m - 1`` chunk-ticks (``m <= n`` only)."""
    n, m, v = n_stages, num_microbatches, virtual_stages
    if v == 1:
        return (n - 1) / (m + n - 1)
    if m > n:
        raise ValueError(
            f"interleaved schedule is only defined for num_microbatches "
            f"({m}) <= n_stages ({n}) — the stall-free window "
            f"make_pp_lm_train_step enforces")
    return (v * n + m - 1 - v * m) / (v * n + m - 1)


def owned_blocks(depth: int, n: int, v: int, rank: int) -> list[list[int]]:
    """The blocks of each chunk rank ``rank`` runs, chunk by chunk."""
    bpc = depth // (n * v)
    return [list(range((k * n + rank) * bpc, (k * n + rank + 1) * bpc))
            for k in range(v)]


class PipeLayout:
    """A pipeline state's placement: the rank's chunks. Every leaf it holds
    is whole; block leaves live only on their owner, the embedding, head
    and scalars on every rank (written once, by pipe rank 0 of data
    replica 0)."""

    def __init__(self, mesh, pipe_axis: str, data_axis, depth: int,
                 virtual_stages: int):
        self.mesh, self.pipe_axis, self.data_axis = mesh, pipe_axis, data_axis
        self.n = mesh.shape[pipe_axis]
        self.v = virtual_stages
        self.rank = mesh.axis_index(pipe_axis)
        self.chunks = owned_blocks(depth, self.n, self.v, self.rank)

    def writes(self, leaf) -> bool:
        if self.data_axis and self.mesh.axis_index(self.data_axis):
            return False
        owner_only = leaf.name is not None and leaf.name.startswith(
            "backbone_block")
        return owner_only or self.rank == 0


def init_pp_state(model, tx, mesh, generator: torch.Generator | None = None,
                  pipe_axis: str = PIPE_AXIS, virtual_stages: int = 1,
                  data_axis: str | None = "data", device=None):
    """The rank's pipeline TrainState from a TransformerLM: the weights
    drawn from ``generator`` (the same on every rank; ``None`` keeps the
    model's), the blocks of other ranks' chunks removed from the module,
    the optimizer state over what remains. ``virtual_stages`` must match
    the step's (1 for GPipe)."""
    from ddw_tpu_torch.models.convert import init_lm_weights
    from ddw_tpu_torch.train.step import TrainState

    if generator is not None:
        init_lm_weights(model, generator)
    n = mesh.shape[pipe_axis]
    if model.depth % (n * virtual_stages):
        raise ValueError(f"depth {model.depth} not divisible by {n} stages "
                         f"x {virtual_stages} virtual stages")
    lay = PipeLayout(mesh, pipe_axis,
                     data_axis if data_axis in mesh.axis_names else None,
                     model.depth, virtual_stages)
    mine = {i for ch in lay.chunks for i in ch}
    for i in range(model.depth):
        if i not in mine:
            delattr(model, f"backbone_block{i}")
    if device is not None:
        model.to(device)
    return TrainState(model, tx.init(dict(model.named_parameters())), 0,
                      layout=lay)


def make_pp_lm_train_step(model, tx, mesh, pipe_axis: str = PIPE_AXIS,
                          data_axis: str | None = None,
                          num_microbatches: int = 4,
                          aux_loss_weight: float = 0.01,
                          schedule: str = "gpipe",
                          virtual_stages: int = 2) -> Callable:
    """``step(state, inputs [B, S], targets [B, S]) -> metrics``: one
    pipelined update of ``state`` (from :func:`init_pp_state`) in place, on
    this data replica's batch (the same on every pipe rank of a replica).
    ``metrics`` has ``loss``, ``accuracy`` (``aux_loss`` for MoE) and the
    schedule's analytic ``pp_bubble_fraction``; ``step.eval_step(state,
    inputs, targets)`` is the forward-only half."""
    if model.dropout:
        raise ValueError("pipeline step supports dropout=0 models only")
    if model.seq_axis:
        raise ValueError("pipeline step composes with DP, not SP — build the "
                         "model with seq_axis=None")
    if getattr(model, "expert_axis", None):
        raise ValueError("pipeline step does not implement expert parallelism "
                         "— build the MoE model with expert_axis=None (dense "
                         "experts) or use make_lm_train_step for EP")
    if getattr(model, "lora_rank", 0):
        raise ValueError("pipeline step does not support LoRA adapters — use "
                         "make_lm_train_step")
    n = mesh.shape[pipe_axis]
    m = num_microbatches
    if schedule not in ("gpipe", "interleaved"):
        raise ValueError(f"schedule must be 'gpipe' or 'interleaved', "
                         f"got {schedule!r}")
    v = virtual_stages if schedule == "interleaved" else 1
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    if model.depth % (n * v):
        raise ValueError(f"depth {model.depth} not divisible by pipe axis {n}"
                         + (f" x virtual_stages {v}" if v > 1 else ""))
    if schedule == "interleaved" and m > n:
        raise ValueError(
            f"interleaved schedule requires num_microbatches ({m}) <= "
            f"n_stages ({n}): beyond that window two chunks of one device "
            f"contend for the same tick (the stall-free property breaks) — "
            f"use schedule='gpipe' for large microbatch counts")
    bubble = bubble_fraction(n, m, v)
    moe = getattr(model, "num_experts", 0) > 0
    rope = model.pos_encoding == "rope"
    depth = model.depth
    n_ticks = (m + n - 1) if v == 1 else (v * n + m - 1)
    group = mesh.group(pipe_axis)
    data_g = mesh.group(data_axis) if data_axis else None

    def peer(offset: int) -> int:
        r = mesh.axis_index(pipe_axis)
        return dist.get_global_rank(group, (r + offset) % n)

    def events(r: int):
        for t in range(n_ticks):
            q = t - r
            if v == 1:
                k, j, ok = 0, q, 0 <= q < m
            else:
                k, j = q // n, q % n
                ok = q >= 0 and k < v and j < m
            if ok:
                yield k, j

    def check(state):
        lay = state.layout
        if not isinstance(lay, PipeLayout) or lay.v != v or lay.n != n:
            raise ValueError(
                f"stages layout mismatch: build the state with "
                f"init_pp_state(..., virtual_stages={v}) over a mesh whose "
                f"'{pipe_axis}' axis has {n} ranks for schedule={schedule!r}")
        return lay

    def run(state, inputs, targets, train: bool):
        lay = check(state)
        lm = state.model
        r = lay.rank
        b, s = inputs.shape
        if b % m:
            raise ValueError(f"per-shard batch {b} not divisible by "
                             f"num_microbatches {m}")
        mb = b // m
        inputs = inputs.long().reshape(m, mb, s)
        targets = targets.reshape(m, mb, s)
        positions = (torch.arange(s, device=inputs.device) if rope
                     else None)
        last = v * n - 1
        kept, sends = {}, []
        ce_sum = torch.zeros((), device=inputs.device)
        acc_sum = torch.zeros((), device=inputs.device)
        aux_sum = torch.zeros((), device=inputs.device)
        lm.train(train)
        with torch.set_grad_enabled(train):
            for k, j in events(r):
                c = k * n + r
                if c == 0:
                    x_in = None
                    x = lm.tok_embed(inputs[j])
                    if not rope:
                        x = x + lm.pos_embed[:s].to(lm.dtype)[None]
                else:
                    x_in = recv((mb, s, lm.hidden), lm.dtype,
                                inputs.device, peer(-1), group)
                    x = x_in.requires_grad_(train)
                aux = None
                for i in lay.chunks[k]:
                    blk = getattr(lm, f"backbone_block{i}")
                    x = blk(x, positions)
                    if moe:
                        a = blk.moe.sown["moe_aux_loss"]
                        aux = a if aux is None else aux + a
                obj = None
                if aux is not None:
                    aux_sum = aux_sum + aux.detach()
                    obj = aux_loss_weight * aux / (m * depth)
                if c == last:
                    logits = lm.head(lm.LayerNorm_0(x.to(torch.float32)))
                    ce = lm_loss(logits, targets[j])
                    ce_sum = ce_sum + ce.detach()
                    acc_sum = acc_sum + token_accuracy(logits.detach(),
                                                       targets[j])
                    obj = ce / m if obj is None else obj + ce / m
                    y = None
                else:
                    y = x
                    sends.append(send(x, peer(1), group))
                kept[(k, j)] = (x_in, y, obj)
            for req, _ in sends:
                req.wait()
        if train:
            backward(lay, kept, mb, s, inputs.device, lm.dtype)
        totals = torch.stack([ce_sum, acc_sum, aux_sum])
        dist.all_reduce(totals, group=group)
        totals = totals / torch.tensor([m, m, m * depth],
                                       device=totals.device)
        if data_g is not None:
            all_reduce_mean_([totals], data_g)
        out = {"loss": totals[0], "accuracy": totals[1]}
        if moe:
            out["aux_loss"] = totals[2]
        return out

    def backward(lay, kept, mb, s, device, dtype):
        r = lay.rank
        sends = []
        for k, j in reversed(list(events(r))):
            c = k * n + r
            x_in, y, obj = kept.pop((k, j))
            outs, grads = [], []
            if y is not None:
                dy = recv((mb, s, y.shape[-1]), dtype, device, peer(1),
                          group)
                outs.append(y)
                grads.append(dy)
            if obj is not None:
                outs.append(obj)
                grads.append(torch.ones_like(obj))
            if outs:
                torch.autograd.backward(outs, grads)
            if c > 0:
                g = (x_in.grad if x_in.grad is not None
                     else torch.zeros_like(x_in))
                sends.append(send(g, peer(-1), group))
        for req, _ in sends:
            req.wait()

    def step(state, inputs, targets):
        lm = state.model
        for p in lm.parameters():
            p.grad = None
        metrics = run(state, inputs, targets, True)
        named = list(lm.named_parameters())
        grads = {nm: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for nm, p in named}
        shared = [g for nm, g in grads.items()
                  if not nm.startswith("backbone_block")]
        for g in shared:   # embedding and head: summed over the stages
            dist.all_reduce(g, group=group)
        if data_g is not None:
            all_reduce_mean_(list(grads.values()), data_g)
        apply_gradients(state, tx, grads)
        for p in lm.parameters():
            p.grad = None
        metrics["pp_bubble_fraction"] = torch.tensor(bubble)
        return metrics

    @torch.no_grad()
    def eval_step(state, inputs, targets):
        return run(state, inputs, targets, False)

    def place_state(state):
        check(state)
        return state

    step.eval_step = eval_step
    step.place_state = place_state
    return step
