"""Ring attention over a ``seq`` axis — the port of
``ddw_tpu.parallel.ring_attention``.

Each of the N ranks of the ``seq`` group holds Q/K/V shards of S/N tokens.
Q stays put; K and V travel around the ring, packed into one tensor, one
hop per step (:func:`ddw_tpu_torch.parallel.comm.ring_shift_grad`, over
:func:`ddw_tpu_torch.ops.ring_reduce.ring_shift`, host-staged over gloo).
At every attended hop the rank runs
:func:`ddw_tpu_torch.ops.flash_attention.flash_mha_lse` on its Q against
the visiting block — K3 on the card at the ``pallas`` tier, K4/K5 in its
backward — and folds the hop's ``(out, lse)`` into a running softmax
combine (:func:`_combine`).

Causal masking is by global position, resolved per hop as ``ddw_tpu``
does (the visiting block is rank ``(me - hop) % n``'s):

- hop 0, the diagonal block: causal flash with equal offsets;
- a past block (``hop <= me``): non-causal flash;
- a future block: the compute is skipped. The rank is a Python int here,
  so a plain ``if`` replaces ``lax.cond``; the rank still takes part in
  every shift, or the ring would deadlock.

Gradients: the lse output of every hop carries its cotangent into K4/K5's
``g_lse`` term (``delta = rowsum(dO*O) - g_lse``), and the hop transport's
backward shifts the K/V cotangent the other way, so dK/dV come home to the
rank that owns the block. Under causal masking the last visiting block is
tied to the output with a zero weight, so every rank runs every shift's
backward in the same order (a skipped hop would otherwise leave its
neighbours waiting).
"""

from __future__ import annotations

import torch

from ddw_tpu_torch.ops.flash_attention import flash_mha_lse
from ddw_tpu_torch.parallel.comm import ring_shift_grad
from ddw_tpu_torch.runtime.mesh import axis_group

_NEG_INF = -1e30


def _combine(o1, lse1, o2, lse2):
    """Softmax-combine two partial attentions over disjoint key sets: a
    convex combination weighted by ``exp(lse_i - lse)``; safe at the
    ``-1e30`` sentinel (an all-masked row stays the zero vector)."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2 * w2, lse


def ring_attention(q, k, v, group, causal: bool = False,
                   sm_scale: float | None = None, block_q: int = 128,
                   block_k: int = 128, impl: str = "auto") -> torch.Tensor:
    """Blockwise ring attention over ``group``: an axis name of the bound
    mesh (:func:`ddw_tpu_torch.runtime.mesh.bind_mesh`), a ``(mesh, axis)``
    pair or a process group. Per-rank ``q/k/v [B, H, S_local, D]`` (the
    local sequence shard); returns the local shard of the output in q's
    dtype. ``impl`` picks each hop's attention tier as
    :func:`flash_mha_lse` does, by the local score footprint."""
    g, n, me = axis_group(group)
    b, h, s_local, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / float(d) ** 0.5
    out = torch.zeros((b, h, s_local, d), dtype=torch.float32,
                      device=q.device)
    lse = torch.full((b, h, s_local), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack([k, v])
    for hop in range(n):
        if not causal or hop == 0 or hop <= me:
            o_h, lse_h = flash_mha_lse(q, kv[0], kv[1], causal and hop == 0,
                                       sm_scale, block_q, block_k, impl=impl)
            out, lse = _combine(out, lse, o_h.to(torch.float32), lse_h)
        if hop != n - 1:
            kv = ring_shift_grad(kv, g)
    if causal and n > 1:
        out = out + 0.0 * kv.sum().to(out.dtype)
    return out.to(q.dtype)
