"""Mixture-of-Experts MLP with expert parallelism — the port of
``ddw_tpu.models.moe``: Switch top-1 and GShard top-2 routing.

The routing is ``ddw_tpu``'s, op for op: a static per-expert capacity
``C = ceil(cf * k * T / E)``, dense dispatch and combine tensors
``[T, E, C]``, queue positions by a cumulative sum in token order (first
choices claim capacity before second ones), tokens past capacity dropped
to the residual. Expert weights are stacked ``[E, ...]`` leaves under
``ddw_tpu``'s names (``moe/gate``, ``moe/w1 [E, D, H]``, ``moe/b1``,
``moe/w2 [E, H, D]``, ``moe/b2``), the same tree with and without expert
parallelism.

Expert parallelism over ``expert_axis`` (a name of the bound mesh, see
:func:`ddw_tpu_torch.runtime.mesh.bind_mesh`): each rank routes its own
tokens against all ``E`` experts, one ``all_to_all_single`` inside an
autograd ``Function`` ships each expert's token block to the rank that
owns it, the owner applies its ``E / n`` experts, and the inverse exchange
brings the results back (:func:`ddw_tpu_torch.parallel.comm.all_to_all_grad`;
its backward is the same exchange).

``ddw_tpu`` sows the Switch load-balance loss and the routing telemetry
into flax's ``intermediates``; here each :class:`MoEMlp` keeps what its last
forward sowed in ``sown`` and :func:`collect_sown` gathers one name over a
model, as ``ddw_tpu``'s does over the collection.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddw_tpu_torch.models.lm import DenseGeneral
from ddw_tpu_torch.parallel.comm import all_to_all_grad
from ddw_tpu_torch.runtime.mesh import axis_group


def collect_sown(model: nn.Module, name: str) -> list:
    """Every value sown under ``name`` by the MoE blocks of ``model``'s last
    forward, in module order. Consumers select by name: the blocks also sow
    routing telemetry that must not leak into a loss."""
    return [m.sown[name] for m in model.modules()
            if isinstance(m, MoEMlp) and name in m.sown]


def _queue_pos(onehot: torch.Tensor) -> torch.Tensor:
    """Each token's position in its chosen expert's queue (arrival order)."""
    return ((torch.cumsum(onehot, 0) - 1.0) * onehot).sum(-1)


def top1_routing(gate_logits: torch.Tensor, capacity: int):
    """Switch top-1 routing: ``gate_logits [T, E]`` (f32) -> ``(dispatch
    [T, E, C], combine [T, E, C], aux_loss, stats)``; ``stats`` holds
    ``drop_rate``, ``balance_entropy`` and ``expert_frac [E]``."""
    t, e = gate_logits.shape
    probs = torch.softmax(gate_logits, -1)
    expert_idx = probs.argmax(-1)
    onehot = F.one_hot(expert_idx, e).to(probs.dtype)
    gate = (probs * onehot).sum(-1)
    pos = _queue_pos(onehot)
    keep = pos < capacity
    cap_oh = F.one_hot(pos.long().clamp(0, capacity), capacity + 1)[
        :, :capacity].to(probs.dtype)
    dispatch = (onehot * keep[:, None])[:, :, None] * cap_oh[:, None, :]
    combine = dispatch * gate[:, None, None]
    frac = onehot.mean(0)
    aux = e * (frac * probs.mean(0)).sum()
    stats = {"drop_rate": 1.0 - keep.to(probs.dtype).mean(),
             "balance_entropy": (-(frac * torch.log(frac + 1e-9)).sum()
                                 / torch.log(torch.tensor(float(e)))),
             "expert_frac": frac}
    return dispatch, combine, aux, stats


def top2_routing(gate_logits: torch.Tensor, capacity: int):
    """GShard top-2 routing: the two most probable experts, gates
    renormalised over the pair, first choices claiming capacity before
    second ones. The aux loss is over first choices; ``drop_rate`` counts
    dropped (token, choice) slots over ``2T``."""
    t, e = gate_logits.shape
    probs = torch.softmax(gate_logits, -1)
    # a stable sort breaks ties toward the lower expert, as lax.top_k does
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :2], top_i[:, :2]
    gates = top_p / top_p.sum(-1, keepdim=True)
    dispatch = torch.zeros((t, e, capacity), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((e,), dtype=probs.dtype, device=probs.device)
    kept = 0.0
    assign_frac = torch.zeros((e,), dtype=probs.dtype, device=probs.device)
    for choice in range(2):
        onehot = F.one_hot(top_i[:, choice], e).to(probs.dtype)
        pos = _queue_pos(onehot) + onehot @ counts
        keep = pos < capacity
        cap_oh = F.one_hot(pos.long().clamp(0, capacity), capacity + 1)[
            :, :capacity].to(probs.dtype)
        d_c = (onehot * keep[:, None])[:, :, None] * cap_oh[:, None, :]
        dispatch = dispatch + d_c
        combine = combine + d_c * gates[:, choice][:, None, None]
        counts = counts + onehot.sum(0)
        kept = kept + keep.to(probs.dtype).sum()
        assign_frac = assign_frac + onehot.mean(0) / 2.0
    first = F.one_hot(top_i[:, 0], e).to(probs.dtype).mean(0)
    aux = e * (first * probs.mean(0)).sum()
    stats = {"drop_rate": 1.0 - kept / (2.0 * t),
             "balance_entropy": (-(assign_frac * torch.log(assign_frac + 1e-9)
                                   ).sum() / torch.log(torch.tensor(float(e)))),
             "expert_frac": assign_frac}
    return dispatch, combine, aux, stats


def router_fn(router: str):
    """``(routing fn, choices per token k)`` for a router name."""
    if router == "top1":
        return top1_routing, 1
    if router == "top2":
        return top2_routing, 2
    raise ValueError(f"unknown router {router!r}; use 'top1' or 'top2'")


def expert_capacity(cf: float, k: int, tokens: int, experts: int) -> int:
    """Static per-expert capacity ``ceil(cf * k * T / E)`` (>= 1)."""
    return max(1, int(-(-cf * k * tokens // experts)))


class MoEMlp(nn.Module):
    """Drop-in MoE replacement for a block's dense MLP. ``expert_axis=None``
    computes every expert locally; an axis name partitions the experts over
    that axis of the bound mesh (its size must divide ``num_experts``).
    ``forward(x, no_drop=True)`` (decode) sets the capacity to T: a
    generated continuation must not depend on which other rows route to the
    same expert."""

    flax_layout = True   # w1/b1/w2/b2 in flax's layout and names

    def __init__(self, hidden: int, num_experts: int, mlp_dim: int,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 expert_axis: str | None = None, router: str = "top1"):
        super().__init__()
        router_fn(router)
        self.num_experts, self.mlp_dim = num_experts, mlp_dim
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.expert_axis, self.router = expert_axis, router
        e = num_experts
        self.gate = DenseGeneral((hidden,), (e,), torch.float32)
        self.w1 = nn.Parameter(torch.empty(e, hidden, mlp_dim))
        self.b1 = nn.Parameter(torch.zeros(e, mlp_dim))
        self.w2 = nn.Parameter(torch.empty(e, mlp_dim, hidden))
        self.b2 = nn.Parameter(torch.zeros(e, hidden))
        self.sown: dict = {}

    def _ffn(self, blocks, w1, b1, w2, b2):
        dt = self.dtype
        h = torch.einsum("...ecd,edh->...ech", blocks, w1.to(dt))
        h = F.gelu(h + b1.to(dt)[..., None, :], approximate="tanh")
        out = torch.einsum("...ech,ehd->...ecd", h, w2.to(dt))
        return out + b2.to(dt)[..., None, :]

    def forward(self, x: torch.Tensor, no_drop: bool = False,
                expert_axis=None) -> torch.Tensor:
        route, k = router_fn(self.router)
        b, s, d = x.shape
        t, e = b * s, self.num_experts
        if k > e:
            raise ValueError(f"{self.router} routing needs at least {k} "
                             f"experts, got {e}")
        xt = x.reshape(t, d)
        gate_logits = self.gate(xt.to(torch.float32))
        capacity = (t if no_drop
                    else expert_capacity(self.capacity_factor, k, t, e))
        dispatch, combine, aux, stats = route(gate_logits, capacity)
        self.sown = {"moe_aux_loss": aux,
                     "moe_drop_rate": stats["drop_rate"],
                     "moe_balance_entropy": stats["balance_entropy"],
                     "gate_logits": gate_logits}
        dt = self.dtype
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), xt.to(dt))
        axis = expert_axis if expert_axis is not None else self.expert_axis
        if axis is None or no_drop:
            expert_out = self._ffn(expert_in, self.w1, self.b1, self.w2,
                                   self.b2)
        else:
            group, n, me = axis_group(axis)
            if e % n:
                raise ValueError(f"num_experts {e} not divisible by "
                                 f"{axis!r} axis size {n}")
            el = e // n
            # [E, C, D] -> [n_owner, E_local, C, D]; after the exchange rank
            # r holds [n_src, E_local, C, D]: its experts' tokens from every
            # source rank
            grouped = expert_in.reshape(n, el, capacity, d)
            received = all_to_all_grad(grouped, group)
            sl = slice(me * el, (me + 1) * el)
            out_blocks = self._ffn(received, self.w1[sl], self.b1[sl],
                                   self.w2[sl], self.b2[sl])
            expert_out = all_to_all_grad(out_blocks, group).reshape(
                e, capacity, d)
        out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)
        return out.reshape(b, s, d)
