"""Decoder-only transformer LM — the port of ``ddw_tpu.models.lm`` (eval).

Pre-LN blocks, learned absolute or rotary positions, GQA, optional LoRA
adapters, an untied f32 vocab head. Submodules carry flax's names
(``tok_embed``, ``pos_embed``, ``backbone_block{i}/{LayerNorm_0, attn/{query,
key, value, out}, LayerNorm_1, fc1, fc2}``, ``LayerNorm_0``, ``head``) and
hold their parameters in flax's layout, so ``ddw_tpu``'s parameter tree maps
onto them leaf for leaf (:mod:`ddw_tpu_torch.models.convert`). Dtype
placement follows flax: embeddings and projections compute in ``dtype``
(bf16 by default; flax's ``promote_dtype`` casts the f32 params), LayerNorm
and the head in f32, ``gelu`` is the tanh approximation.

Full mode and three decode modes off one module, the modes ``ddw_tpu``'s
``decode`` / ``slot_decode`` / ``paged_decode`` flags give; here the kind of
cache passed to ``forward`` selects the mode:

- full mode, ``model(tokens)``: causal attention through
  :func:`ddw_tpu_torch.ops.flash_attention.flash_mha`, which dispatches on
  the score-matrix size — at the LM's batch-scoring shapes to K3;
- decode mode, ``model(tokens, cache=init_cache(model, batch))``: the
  contiguous KV cache and the tiled online-softmax attention of
  ``lm.py:112-264`` (tile 256, tiles past the filled position skipped and
  counted in ``tiles_computed``, NaN output once a write passes ``max_len``);
- slot mode, ``cache=init_slot_cache(model, n_slots)``: the cache's batch
  dim is a pool of serving slots, each row at its own depth (one write per
  row, per-row NaN poison; ``serve/slots.py``);
- paged mode, ``cache=init_paged_cache(model, n_blocks, block_size)`` with
  ``block_tables [B, n_tbl]`` and host ``start_pos [B]`` per call: K/V in a
  global pool of fixed-size blocks (block 0 the null block that takes
  unallocated and overshoot writes); each tile is gathered back through the
  table into the contiguous layout, so the tile loop, and its bits, are the
  contiguous path's (per-query NaN poison; ``serve/blocks.py``).

The cache is a dict with flax's leaf names; the port updates its K/V
tensors in place and keeps the indices and depths as host integers, so the
tile-skip rule reads no device value back.

Training mode (``model.train()``) applies flax's dropout after attention
and after the MLP of every block, with masks drawn from an explicit
generator (``dropout_rng``); ``remat`` rematerialises each block in the
backward (``"full"``: ``torch.utils.checkpoint``; ``"dots"``: a selective
checkpoint that keeps the matrix products). Each block seeds its own mask
generator from a seed drawn up front, so a checkpoint's replay draws the
masks of the first run.

Heterogeneous-adapter serving: ``forward(adapters=(stacks, idx))`` gathers
each row's ``(A, B)`` pair from the adapter stacks of
:class:`~ddw_tpu_torch.serve.adapters.AdapterPool` by the row's slot index
and adds its delta (:func:`~ddw_tpu_torch.models.lora.row_lora_delta`) after
the base projection, never folded into its weight, so a slot-0 row (the
null adapter, all zeros) gives the adapter-free model's bits.

Sequence parallelism: built with ``seq_axis`` (an axis name of the mesh
bound by :func:`ddw_tpu_torch.runtime.mesh.bind_mesh`), full mode takes
this rank's sequence shard, runs attention as
:func:`ddw_tpu_torch.parallel.ring_attention.ring_attention` (GQA's K/V
heads repeated before the ring) and reads the position table, or RoPE's
positions, at the global offset ``rank * s_local``. ``num_experts > 0``
replaces each block's MLP with :class:`ddw_tpu_torch.models.moe.MoEMlp`
(``moe``), its experts over ``expert_axis`` when one is named; the decode
modes run every expert locally and never drop a token.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ddw_tpu_torch.ops.flash_attention import flash_mha
from ddw_tpu_torch.ops.rope import apply_rope
from ddw_tpu_torch.utils.device import torch_dtype

_NEG = -1e30
_TILE = 256


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` (and ``nn.Dense``): ``kernel [*in, *feats]``
    in flax's layout contracts the last ``len(in_dims)`` axes of x; inputs,
    kernel and bias are cast to ``dtype`` first."""

    flax_layout = True

    def __init__(self, in_dims: tuple[int, ...], features: tuple[int, ...],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_dims, self.features, self.dtype = in_dims, features, dtype
        self.kernel = nn.Parameter(torch.empty(*in_dims, *features))
        self.bias = nn.Parameter(torch.empty(*features))

    def project(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, w.to(self.dtype), dims=len(self.in_dims))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(x.to(self.dtype), self.kernel) \
            + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics in f32 with the fast
    variance ``E[x^2] - E[x]^2`` clipped at 0, eps 1e-6,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``; f32 out."""

    flax_layout = True

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class Embed(nn.Module):
    """flax ``nn.Embed``: the table cast to ``dtype``, then gathered (the
    port gathers first; the cast is elementwise, so the bits are the same)."""

    flax_layout = True

    def __init__(self, num: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding).to(self.dtype)


def _add_delta(y: torch.Tensor, adapters: dict | None, name: str,
               x_in: torch.Tensor, contract_ndim: int = 1) -> torch.Tensor:
    """``y`` plus the per-row adapter delta of projection ``name`` (its
    gathered ``(a [B, *in, r], b [B, r, *feats])`` in ``adapters``) on the
    projection's input ``x_in``, cast to ``y``'s dtype as ``ddw_tpu`` adds
    it — before RoPE and before the cache write."""
    ab = adapters.get(name) if adapters else None
    if ab is None:
        return y
    from ddw_tpu_torch.models.lora import row_lora_delta

    return y + row_lora_delta(x_in, ab[0], ab[1], contract_ndim).to(y.dtype)


class CausalSelfAttention(nn.Module):
    """Causal self-attention, full or contiguous-cache decode mode."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 max_len: int = 2048, num_kv_heads: int = 0,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_targets: tuple[str, ...] = ("query", "value"),
                 seq_axis=None):
        from ddw_tpu_torch.models.lora import maybe_lora_dense

        super().__init__()
        self.num_heads, self.max_len = num_heads, max_len
        self.seq_axis = seq_axis
        self.head_dim = hidden // num_heads
        self.kv_heads = num_kv_heads or num_heads
        if num_heads % self.kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {self.kv_heads}")
        self.groups = num_heads // self.kv_heads
        lora = dict(rank=lora_rank, alpha=lora_alpha, targets=lora_targets,
                    dtype=dtype)
        hd = self.head_dim
        self.query = maybe_lora_dense((hidden,), (num_heads, hd), "query",
                                      **lora)
        self.key = maybe_lora_dense((hidden,), (self.kv_heads, hd), "key",
                                    **lora)
        self.value = maybe_lora_dense((hidden,), (self.kv_heads, hd), "value",
                                      **lora)
        self.out = maybe_lora_dense((num_heads, hd), (hidden,), "out", **lora)

    def forward(self, x: torch.Tensor, positions=None,
                cache: dict | None = None,
                step: "_DecodeStep | None" = None,
                adapters: dict | None = None) -> torch.Tensor:
        q = _add_delta(self.query(x), adapters, "query", x)  # [B, S, H, hd]
        k = _add_delta(self.key(x), adapters, "key", x)
        v = _add_delta(self.value(x), adapters, "value", x)
        if positions is not None:
            q = apply_rope(q, positions, seq_axis=1)
            k = apply_rope(k, positions, seq_axis=1)
        if cache is not None:
            out = self._decode(q, k, v, cache, step).to(x.dtype)
        else:
            if self.groups > 1:  # K/V heads broadcast over their query group
                k = k.repeat_interleave(self.groups, dim=2)
                v = v.repeat_interleave(self.groups, dim=2)
            if self.seq_axis is not None:
                from ddw_tpu_torch.parallel.ring_attention import \
                    ring_attention

                out = ring_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), self.seq_axis,
                                     causal=True).transpose(1, 2)
            else:
                out = flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True
                                ).transpose(1, 2)
        return _add_delta(self.out(out), adapters, "out", out, 2)

    def _decode(self, q, k, v, cache: dict, step: "_DecodeStep"
                ) -> torch.Tensor:
        """``lm.py:112-264``: write K/V (contiguous: at the cache index,
        clamped to fit as ``dynamic_update_slice`` does; slot: each row at
        its own depth; paged: through the block table, out-of-capacity
        positions to the null block 0), then online softmax over 256-key
        tiles in f32, skipping tiles past the deepest filled position.
        Returns ``[B, S, H, hd]`` f32, NaN where a write ran past
        ``max_len`` (contiguous: every row; slot: the row; paged: the
        query)."""
        b, s = q.shape[:2]
        tile, cap = step.tile, step.cap
        if step.mode == "paged":
            ck, cv = cache["kv_block_key"], cache["kv_block_value"]
            ck[step.w_blk, step.w_off] = k.to(ck.dtype)
            cv[step.w_blk, step.w_off] = v.to(cv.dtype)
            tpb = tile // ck.shape[1]
            tables = step.tables

            def kv_tile(src, st):
                blocks = tables[:, st // ck.shape[1]:st // ck.shape[1] + tpb]
                return src[blocks].reshape(b, tile, *src.shape[2:])
        else:
            ck, cv = cache["cached_key"], cache["cached_value"]
            if step.mode == "slot":
                ck[step.rows, step.w_idx] = k[:, 0].to(ck.dtype)
                cv[step.rows, step.w_idx] = v[:, 0].to(cv.dtype)
                cache["cache_index"] = cache["cache_index"] + s
            else:
                if s > cap:
                    raise ValueError(
                        f"{s} tokens exceed the cache capacity {cap}")
                start = max(0, min(step.pos, cap - s))
                ck[:, start:start + s] = k.to(ck.dtype)
                cv[:, start:start + s] = v.to(cv.dtype)
                cache["cache_index"] = step.pos + s

            def kv_tile(src, st):
                return src[:, st:st + tile]
        hd, dev = self.head_dim, q.device
        q32 = (q.to(torch.float32) / float(hd) ** 0.5).transpose(1, 2)
        qpos = step.qpos                     # [S] or [B, S]
        m = torch.full((b, self.num_heads, s), _NEG, device=dev)
        l = torch.zeros((b, self.num_heads, s), device=dev)
        o = torch.zeros((b, self.num_heads, s, hd), device=dev)
        tiles = 0
        for t in range(cap // tile):
            st = t * tile
            if st > step.last:
                break
            k_t = kv_tile(ck, st).to(torch.float32)
            v_t = kv_tile(cv, st).to(torch.float32)
            if self.groups > 1:
                k_t = k_t.repeat_interleave(self.groups, dim=2)
                v_t = v_t.repeat_interleave(self.groups, dim=2)
            s_t = torch.einsum("bhqd,bkhd->bhqk", q32, k_t)
            kpos = st + torch.arange(tile, device=dev)
            if qpos.dim() == 2:
                masked = (kpos[None, None, :] > qpos[:, :, None])[:, None]
            else:
                masked = kpos[None, :] > qpos[:, None]
            s_t = s_t.masked_fill(masked, _NEG)
            m_new = torch.maximum(m, s_t.amax(-1))
            p = torch.exp(s_t - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(-1)
            o = o * scale[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_t)
            m = m_new
            tiles += 1
        cache["tiles_computed"] += tiles
        out = (o / l[..., None]).transpose(1, 2)
        if step.mode == "contiguous":
            if step.pos + s > self.max_len:  # a write past max_len: loud
                out = torch.full_like(out, float("nan"))
        elif step.overflow is not None:      # slot: [B, 1]; paged: [B, S]
            out = out.masked_fill(step.overflow[:, :, None, None],
                                  float("nan"))
        return out


@dataclasses.dataclass
class _DecodeStep:
    """What every layer of one decode-mode call shares, computed once per
    call: the mode, the host depth(s), the query positions on the device,
    the deepest filled position (the tile-skip bound, a host int), the
    write indices and the overflow mask."""

    mode: str                      # "contiguous" | "slot" | "paged"
    tile: int
    cap: int
    pos: object                    # int, or an int64 array [B]
    qpos: torch.Tensor             # [S] or [B, S]
    last: int
    rows: torch.Tensor | None = None     # slot: arange(B)
    w_idx: torch.Tensor | None = None    # slot: clamped write depth [B]
    w_blk: torch.Tensor | None = None    # paged: block of each write [B, S]
    w_off: torch.Tensor | None = None    # paged: offset in it [B, S]
    tables: torch.Tensor | None = None   # paged: [B, n_tbl]
    overflow: torch.Tensor | None = None  # slot [B, 1] / paged [B, S]


def host_to_device(arr, device: torch.device) -> torch.Tensor:
    """A small host int array on ``device``. To the card it goes through
    pinned memory without blocking, so the copy waits for no earlier kernel
    (a pageable copy would hold the host until the queue drains)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def dropout(h: torch.Tensor, rate: float,
            gen: torch.Generator) -> torch.Tensor:
    """``flax.linen.Dropout`` in training: keep each element with
    probability ``1 - rate`` (a uniform draw below it, from ``gen`` on h's
    device) and rescale the kept ones by ``1 / (1 - rate)``."""
    keep_prob = 1.0 - rate
    u = torch.rand(h.shape, generator=gen, device=h.device)
    return torch.where(u < keep_prob, h / keep_prob, torch.zeros_like(h))


class DecoderBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, max_len: int, num_kv_heads: int = 0,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_targets: tuple[str, ...] = ("query", "value"),
                 dropout_rate: float = 0.0, seq_axis=None,
                 num_experts: int = 0, expert_axis=None,
                 capacity_factor: float = 1.25, moe_router: str = "top1"):
        from ddw_tpu_torch.models.lora import maybe_lora_dense

        super().__init__()
        self.dropout_rate = dropout_rate
        lora = dict(rank=lora_rank, alpha=lora_alpha, targets=lora_targets,
                    dtype=dtype)
        self.LayerNorm_0 = LayerNorm(hidden)
        self.attn = CausalSelfAttention(hidden, num_heads, dtype, max_len,
                                        num_kv_heads, lora_rank, lora_alpha,
                                        lora_targets, seq_axis)
        self.LayerNorm_1 = LayerNorm(hidden)
        if num_experts:
            from ddw_tpu_torch.models.moe import MoEMlp

            self.moe = MoEMlp(hidden, num_experts, mlp_dim, capacity_factor,
                              dtype, expert_axis, moe_router)
        else:
            self.fc1 = maybe_lora_dense((hidden,), (mlp_dim,), "fc1", **lora)
            self.fc2 = maybe_lora_dense((mlp_dim,), (hidden,), "fc2", **lora)

    def forward(self, x, positions=None, cache=None,
                dropout_seed: int | None = None, step=None, adapters=None):
        """``dropout_seed`` (training only) seeds this block's mask
        generator, so that a rematerialised replay draws the same masks.
        ``adapters`` maps this block's projection names to their gathered
        per-row ``(a, b)`` pairs."""
        gen = None
        if dropout_seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
        h = self.attn(self.LayerNorm_0(x), positions, cache, step, adapters)
        if gen is not None:
            h = dropout(h, self.dropout_rate, gen)
        x = x + h
        h = self.LayerNorm_1(x)
        if hasattr(self, "moe"):
            h = self.moe(h, no_drop=cache is not None)
        else:
            h = F.gelu(_add_delta(self.fc1(h), adapters, "fc1", h),
                       approximate="tanh")
            h = _add_delta(self.fc2(h), adapters, "fc2", h)
        if gen is not None:
            h = dropout(h, self.dropout_rate, gen)
        return x + h


# The matrix products a "dots" checkpoint keeps (jax.checkpoint_policies.
# checkpoint_dots); everything else is recomputed in the backward.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class TransformerLM(nn.Module):
    """Decoder-only LM over integer token ids: ``forward(tokens [B, S]) ->
    logits [B, S, vocab]`` (f32); with ``cache=`` the decode mode."""

    flax_layout = True

    def __init__(self, vocab_size: int = 256, max_len: int = 2048,
                 hidden: int = 256, depth: int = 4, num_heads: int = 4,
                 mlp_dim: int = 1024, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, seq_axis=None,
                 num_experts: int = 0, num_kv_heads: int = 0,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_targets: tuple[str, ...] = ("query", "value"),
                 pos_encoding: str = "learned", remat: str = "none",
                 expert_axis=None, capacity_factor: float = 1.25,
                 moe_router: str = "top1"):
        super().__init__()
        if lora_rank:
            from ddw_tpu_torch.models.lora import validate_lora_targets

            validate_lora_targets(lora_targets)
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"unknown pos_encoding {pos_encoding!r}; use "
                             f"'learned' or 'rope'")
        if pos_encoding == "rope" and (hidden // num_heads) % 2:
            raise ValueError("RoPE needs an even head_dim")
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat {remat!r}; use 'none', 'full' or "
                             f"'dots'")
        self.vocab_size, self.max_len, self.hidden = vocab_size, max_len, hidden
        self.depth, self.num_heads, self.dropout = depth, num_heads, dropout
        self.dtype, self.pos_encoding = dtype, pos_encoding
        self.remat, self.lora_rank = remat, lora_rank
        self.kv_heads = num_kv_heads or num_heads
        self.seq_axis, self.expert_axis = seq_axis, expert_axis
        self.num_experts = num_experts
        self.tok_embed = Embed(vocab_size, hidden, dtype)
        if pos_encoding == "learned":
            self.pos_embed = nn.Parameter(torch.empty(max_len, hidden))
        for i in range(depth):
            setattr(self, f"backbone_block{i}", DecoderBlock(
                hidden, num_heads, mlp_dim, dtype, max_len, num_kv_heads,
                lora_rank, lora_alpha, lora_targets, dropout, seq_axis,
                num_experts, expert_axis, capacity_factor, moe_router))
        self.LayerNorm_0 = LayerNorm(hidden)
        self.head = DenseGeneral((hidden,), (vocab_size,), torch.float32)

    def blocks(self) -> list[DecoderBlock]:
        return [getattr(self, f"backbone_block{i}") for i in range(self.depth)]

    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                adapters=None,
                dropout_rng: torch.Generator | None = None,
                block_tables: torch.Tensor | None = None,
                start_pos=None) -> torch.Tensor:
        """``dropout_rng`` (a CPU generator) is required in training mode
        with ``dropout > 0``: one seed per block is drawn from it. A paged
        cache takes ``block_tables [B, n_tbl]`` (int, on the model's
        device) and ``start_pos`` (host ints [B]) per call.

        ``adapters``: an optional ``(stacks, idx)`` pair for heterogeneous-
        adapter serving — ``stacks`` is ``{f"backbone_block{i}": {target:
        (a_stack [S+1, *in, r], b_stack [S+1, r, *feats])}}`` with slot 0
        all zeros (the null adapter), ``idx`` a per-row ``[B]`` slot vector.
        Each row's pair is gathered once here; call arguments of fixed
        shape, so adapter churn changes contents, never shapes."""
        row_adapters = None
        if adapters is not None:
            stacks, idx = adapters
            if not isinstance(idx, torch.Tensor):
                idx = host_to_device(idx, tokens.device)
            idx = idx.to(device=tokens.device, dtype=torch.long)
            row_adapters = {
                blk: {name: (a[idx], b[idx])
                      for name, (a, b) in targets.items()}
                for blk, targets in stacks.items()}
        seeds = [None] * self.depth
        if self.training and self.dropout > 0:
            if dropout_rng is None:
                raise ValueError("dropout in training mode needs a "
                                 "dropout_rng torch.Generator")
            seeds = torch.randint(1 << 62, (self.depth,),
                                  generator=dropout_rng).tolist()
        s = tokens.shape[1]
        x = self.tok_embed(tokens)
        step = None
        if cache is not None:
            step = self._decode_step(tokens, cache, block_tables, start_pos)
        positions = None
        offset = 0
        if self.seq_axis is not None and cache is None:
            from ddw_tpu_torch.runtime.mesh import axis_group

            _, n_shards, shard = axis_group(self.seq_axis)
            # the global length must fit the table (a clamped slice would
            # reuse the last positions on trailing shards); RoPE has none
            if self.pos_encoding == "learned" and s * n_shards > self.max_len:
                raise ValueError(f"global sequence {s}*{n_shards} exceeds "
                                 f"max_len {self.max_len}")
            offset = shard * s
        if self.pos_encoding == "learned" and offset:
            x = x + self.pos_embed[offset:offset + s].to(self.dtype)[None]
        elif self.pos_encoding == "learned":
            if s > self.max_len:
                raise ValueError(f"sequence {s} exceeds max_len "
                                 f"{self.max_len}")
            if step is not None and step.mode != "contiguous":
                # per-row gather at each row's own depth (clamped; the
                # attention poisons rows past max_len anyway)
                rows = step.qpos.clamp(0, self.max_len - 1)
                x = x + self.pos_embed[rows].to(self.dtype)
            else:
                offset = 0 if step is None else step.pos
                start = max(0, min(offset, self.max_len - s))  # slice clamps
                x = x + self.pos_embed[start:start + s].to(self.dtype)[None]
        else:
            positions = (offset + torch.arange(s, device=tokens.device)
                         if step is None else step.qpos)
        remat = (self.remat != "none" and cache is None
                 and torch.is_grad_enabled())
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        for i, block in enumerate(self.blocks()):
            if remat:
                x = checkpoint(block, x, positions, None, seeds[i],
                               use_reentrant=False, **kw)
            else:
                layer = None if cache is None \
                    else cache[f"backbone_block{i}"]["attn"]
                x = block(x, positions, layer, seeds[i], step,
                          None if row_adapters is None
                          else row_adapters.get(f"backbone_block{i}"))
        return self.head(self.LayerNorm_0(x))

    def _decode_step(self, tokens, cache: dict, block_tables,
                     start_pos) -> _DecodeStep:
        """The per-call decode state, from the cache's kind: paged (its
        layers hold ``kv_block_key``; depth from ``start_pos``), slot (its
        ``pos_index`` is a [B] host array) or contiguous (an int)."""
        b, s = tokens.shape
        dev = tokens.device
        tile = min(_TILE, self.max_len)
        cap = -(-self.max_len // tile) * tile
        ar = torch.arange(s, device=dev)
        if "kv_block_key" in cache["backbone_block0"]["attn"]:
            bs = cache["backbone_block0"]["attn"]["kv_block_key"].shape[1]
            n_tbl = cap // bs
            pos = (np.zeros((b,), np.int64) if start_pos is None
                   else np.asarray(start_pos, np.int64).reshape(b))
            if block_tables is None:
                block_tables = torch.zeros((b, n_tbl), dtype=torch.long,
                                           device=dev)
            tables = block_tables.to(device=dev, dtype=torch.long)
            qpos = host_to_device(pos, dev)[:, None] + ar   # [B, S]
            safe = qpos < cap
            entry = torch.gather(tables, 1,
                                 (qpos // bs).clamp(0, n_tbl - 1))
            return _DecodeStep(
                "paged", tile, cap, pos, qpos, int(pos.max()) + s - 1,
                w_blk=torch.where(safe, entry, 0),
                w_off=torch.where(safe, qpos % bs, 0), tables=tables,
                overflow=qpos >= self.max_len)
        pos = cache["pos_index"]
        cache["pos_index"] = pos + s
        if isinstance(pos, np.ndarray):
            if s != 1:
                raise ValueError(f"slot_decode processes one token per slot "
                                 f"per call, got S={s}")
            pos_d = host_to_device(pos, dev)
            return _DecodeStep(
                "slot", tile, cap, pos, pos_d[:, None] + ar,
                int(pos.max()) + s - 1,
                rows=torch.arange(b, device=dev),
                w_idx=pos_d.clamp(0, cap - s),
                overflow=host_to_device(pos + s > self.max_len,
                                        dev).bool()[:, None])
        return _DecodeStep("contiguous", tile, cap, pos, pos + ar,
                           pos + s - 1)

    @staticmethod
    def frozen_prefixes(freeze_base: bool) -> tuple[str, ...]:
        return ()


def build_lm(cfg, seq_axis=None, expert_axis=None) -> TransformerLM:
    """Construct from an :class:`ddw_tpu_torch.utils.config.LMCfg`."""
    return TransformerLM(
        vocab_size=cfg.vocab_size, max_len=cfg.max_len, hidden=cfg.hidden,
        depth=cfg.depth, num_heads=cfg.num_heads, mlp_dim=cfg.mlp_dim,
        dropout=cfg.dropout, dtype=torch_dtype(cfg.dtype), seq_axis=seq_axis,
        num_experts=cfg.num_experts, num_kv_heads=cfg.num_kv_heads,
        lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
        lora_targets=tuple(cfg.lora_targets), pos_encoding=cfg.pos_encoding,
        remat=cfg.remat, expert_axis=expert_axis,
        capacity_factor=cfg.capacity_factor, moe_router=cfg.moe_router)


def _kv_shape(model: TransformerLM) -> tuple[int, int, int]:
    """(cap, kv_heads, head_dim): cap is max_len rounded up to the tile."""
    tile = min(_TILE, model.max_len)
    return (-(-model.max_len // tile) * tile, model.kv_heads,
            model.hidden // model.num_heads)


def init_cache(model: TransformerLM, batch: int) -> dict:
    """A fresh zeroed decode cache for ``model`` on its device: per layer
    ``cached_key``/``cached_value [batch, cap, kv_heads, head_dim]`` in the
    model dtype (cap = max_len rounded up to the 256 tile), ``cache_index``
    and ``tiles_computed``; top-level ``pos_index``. The serving modes take
    their own caches (:func:`init_slot_cache`, :func:`init_paged_cache`)."""
    dev = model.head.kernel.device
    cap, kv, hd = _kv_shape(model)
    cache: dict = {"pos_index": 0}
    for i in range(model.depth):
        cache[f"backbone_block{i}"] = {"attn": {
            "cached_key": torch.zeros((batch, cap, kv, hd), dtype=model.dtype,
                                      device=dev),
            "cached_value": torch.zeros((batch, cap, kv, hd),
                                        dtype=model.dtype, device=dev),
            "cache_index": 0, "tiles_computed": 0}}
    return cache


def init_slot_cache(model: TransformerLM, n_slots: int) -> dict:
    """The slot-mode cache (``slot_decode``): the contiguous layout over
    ``n_slots`` rows, with ``cache_index`` and ``pos_index`` host int64
    arrays [n_slots] — one depth per row."""
    cache = {"pos_index": np.zeros((n_slots,), np.int64)}
    dev = model.head.kernel.device
    cap, kv, hd = _kv_shape(model)
    for i in range(model.depth):
        cache[f"backbone_block{i}"] = {"attn": {
            "cached_key": torch.zeros((n_slots, cap, kv, hd),
                                      dtype=model.dtype, device=dev),
            "cached_value": torch.zeros((n_slots, cap, kv, hd),
                                        dtype=model.dtype, device=dev),
            "cache_index": np.zeros((n_slots,), np.int64),
            "tiles_computed": 0}}
    return cache


def init_paged_cache(model: TransformerLM, kv_cache_blocks: int,
                     block_size: int) -> dict:
    """The paged-mode cache (``paged_decode``): per layer
    ``kv_block_key``/``kv_block_value [kv_cache_blocks, block_size,
    kv_heads, head_dim]`` (block 0 the null block) and ``tiles_computed``.
    Depths are host state of the caller, passed per call, so the same cache
    serves a prefill group and the decode batch."""
    tile = min(_TILE, model.max_len)
    if block_size < 1 or tile % block_size:
        raise ValueError(f"kv_block_size {block_size} must be >= 1 and "
                         f"divide the attention tile {tile}")
    if kv_cache_blocks < 2:
        raise ValueError("paged_decode needs kv_cache_blocks >= 2 (block 0 "
                         "is the reserved null block)")
    dev = model.head.kernel.device
    _, kv, hd = _kv_shape(model)
    shape = (kv_cache_blocks, block_size, kv, hd)
    cache: dict = {}
    for i in range(model.depth):
        cache[f"backbone_block{i}"] = {"attn": {
            "kv_block_key": torch.zeros(shape, dtype=model.dtype, device=dev),
            "kv_block_value": torch.zeros(shape, dtype=model.dtype,
                                          device=dev),
            "tiles_computed": 0}}
    return cache


def set_cache_lengths(cache: dict, length: int) -> dict:
    """The cache with every ``cache_index`` and the ``pos_index`` set to
    ``length`` (K/V tensors shared, not copied). After a padded-bucket
    prefill the indices snap back to the true prompt length, so decode
    overwrites the pad rows before any query attends them."""
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out[key] = set_cache_lengths(val, length)
        else:
            out[key] = int(length) if key in ("cache_index", "pos_index") \
                else val
    return out


def _pick(logits: torch.Tensor, temperature: float, top_k: int, top_p: float,
          generator: torch.Generator | None) -> torch.Tensor:
    """Greedy argmax, or a categorical draw (Gumbel-max, as
    ``jax.random.categorical``) after the top-k then top-p masks."""
    if temperature == 0.0:
        return logits.argmax(-1)
    logits = logits.to(torch.float32) / temperature
    if top_k:
        kth = torch.topk(logits, min(top_k, logits.shape[-1])).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = ((cum - probs) < top_p).sum(-1, keepdim=True)
        cutoff = torch.gather(srt, -1, keep - 1)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    u = u.clamp(torch.finfo(torch.float32).tiny, 1.0)
    return (logits - torch.log(-torch.log(u))).argmax(-1)


@torch.inference_mode()
def generate(model: TransformerLM, prompt, num_steps: int,
             generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             prompt_len: int | None = None) -> torch.Tensor:
    """Autoregressive continuation through the decode mode: one batched
    prefill of ``prompt [B, P]`` into a fresh cache, then ``num_steps``
    one-token steps. Returns ``[B, num_steps]`` int32 on the model's device.
    Greedy when ``temperature == 0``; else categorical sampling from
    ``generator`` with optional ``top_k``/``top_p`` masks (k first, then p).
    ``prompt_len``: the true prompt length when ``prompt`` is right-padded to
    a bucket — continuation starts after position ``prompt_len - 1`` and
    decode overwrites the pad region."""
    dev = model.head.kernel.device
    prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.long)
    b, plen = prompt.shape
    if plen > model.max_len or (
            prompt_len is None and plen + num_steps > model.max_len):
        raise ValueError(f"prompt {plen} + steps {num_steps} exceeds "
                         f"max_len {model.max_len}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    if (top_k or top_p) and temperature == 0.0:
        raise ValueError("top_k/top_p require temperature > 0 (greedy decode "
                         "ignores them silently otherwise)")
    was_training = model.training
    model.eval()
    try:
        cache = init_cache(model, b)
        logits = model(prompt, cache=cache)
        if prompt_len is None:
            last = logits[:, -1]
        else:
            last = logits[:, prompt_len - 1]
            cache = set_cache_lengths(cache, prompt_len)
        toks = []
        for _ in range(num_steps):
            tok = _pick(last, temperature, top_k, top_p, generator)
            toks.append(tok)
            last = model(tok[:, None], cache=cache)[:, 0]
    finally:
        model.train(was_training)
    if not toks:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    return torch.stack(toks, 1).to(torch.int32)
