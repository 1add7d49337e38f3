"""Paged KV-cache pool — the port of ``ddw_tpu.serve.blocks``: block
tables and copy-on-write prefix reuse.

:class:`~ddw_tpu_torch.serve.slots.SlotPool` reserves a contiguous
``max_len`` strip of K/V per resident stream; here K/V lives in ONE global
pool of fixed ``block_size``-token blocks (vLLM's design, arXiv 2309.06180),
each resident stream holds a *block table*, and capacity follows actual
usage. The host half — allocator, LIFO free lists, refcounts, the
chain-hashed prefix cache, copy-on-write, preemption, the KV wire format —
is ``ddw_tpu``'s, copied line for line. The device half runs the LM's paged
mode (:func:`~ddw_tpu_torch.models.lm.init_paged_cache`; tables and depths
are call arguments, so one cache serves prefill groups and the decode
batch):

- **prefill**: one bucketed forward of a group of new requests' prompt
  *suffixes*, each starting at its prefix-hit offset;
- **decode**: every resident row advances ``steps_per_tick`` tokens, the
  dispatch narrowed to the smallest power-of-two row bucket covering live
  rows (``decode_buckets``); each tick's ``[rows, n_tbl]`` table is copied
  to the device once and the picks stay there until the chain's fetch;
- **copy**: clone one block, the copy-on-write primitive;
- **spec_draft / spec_verify** (the speculative tick): on a DRAFT pool one
  lagged S=2 step ``(prev, cur)`` then ``k - 1`` single steps propose ``k``
  tokens per row; on the TARGET pool one S=k+1 pass per row at its own
  depth scores the current token and the ``k`` drafts. Both write past a
  row's ``filled`` without advancing it; :meth:`BlockPool.commit_spec`
  advances by the accepted count, and frees the blocks held only for
  rejected positions. Stale K/V beyond a row's depth is never attended:
  each query masks every key past its own position.

The cache is updated in place (where ``ddw_tpu`` donates it). Attention
gathers each tile of a row's blocks back into the contiguous layout and
runs the contiguous path's tile loop, so paged outputs are bit-identical to
:func:`ddw_tpu_torch.models.lm.generate` at equal shapes.

Prefix cache + copy-on-write: prompt blocks are content-addressed by a
per-block chain hash (block j's key commits to every token before it; the
same ``hashlib`` digest over the same int32 token bytes as ``ddw_tpu``).
FULL blocks the new request never writes are shared by refcount; a block it
WILL write is cloned (``cow_copies``): no stream ever writes a block with
``ref > 1``. Finished streams decref their blocks; unreferenced registered
blocks park in an LRU of idle cached blocks, unregistered ones free at
once. Out of blocks mid-decode (only with ``overcommit > 1``), the tick
allocator preempts the YOUNGEST stream of the lowest lane by recompute.

With an :class:`~ddw_tpu_torch.serve.adapters.AdapterPool` attached
(``adapters=``) every prefill, decode and verify forward takes its stacks
and the rows' slot indices (slot 0 the null adapter for base, free and
warmup rows). Not ported (refused by name, ``ROADMAP.md``): tensor
parallelism (a ``mesh``).
"""

from __future__ import annotations

import base64
import collections
import hashlib
import threading

import numpy as np
import torch

from ddw_tpu_torch.models.lm import (TransformerLM, host_to_device,
                                     init_paged_cache)
from ddw_tpu_torch.serve.bucketing import batch_bucket
from ddw_tpu_torch.serve.slots import _pick
from ddw_tpu_torch.utils.device import torch_dtype


class OutOfBlocks(RuntimeError):
    """Internal: the free list AND the idle prefix cache are exhausted."""


KV_WIRE_VERSION = 1


class KVWireError(ValueError):
    """A migration payload failed validation — version skew, geometry
    mismatch, hash-chain corruption, or truncation. Raised BEFORE any
    pool state changes: a rejected import leaves the pool bit-identical
    to before the call (no partial import, ever)."""


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to ddw_tpu_torch; "
                               f"see ROADMAP.md for the slice that brings it")


class _Stream:
    """One resident request's pool-side state (host bookkeeping only)."""

    __slots__ = ("row", "blocks", "prompt_len", "filled", "total", "seq",
                 "lane", "adapter_slot", "salt")

    def __init__(self, row: int, prompt_len: int, total: int, seq: int,
                 lane: str = "interactive", adapter_slot: int = 0,
                 salt: bytes = b""):
        self.row = row
        self.blocks: list[int] = []   # physical block ids, table order
        self.prompt_len = prompt_len  # effective prompt (incl. resumed toks)
        self.filled = 0               # cache positions holding valid K/V
        self.total = total            # positions ever needed: P + steps - 1
        self.seq = seq                # admission order (preemption victims
        #                               are picked youngest-first)
        self.lane = lane              # "interactive" | "batch" — batch
        #                               streams are preempted before ANY
        #                               interactive stream
        self.adapter_slot = adapter_slot  # AdapterPool slot (0 = base model)
        self.salt = salt              # prefix-cache chain salt (the adapter
        #                               digest bytes; b"" = base — today's
        #                               hashes exactly)


class BlockPool:
    """Paged continuous-batching cache pool over a
    :class:`~ddw_tpu_torch.models.lm.TransformerLM` (weights loaded, on its
    device).

    ``n_blocks`` is the USABLE block count (one extra null block is
    allocated on the device — unallocated table entries and overshoot
    writes route there); ``max_resident`` bounds the decode batch dimension
    (rows are host indices: a compute knob, not a memory one).
    ``overcommit`` scales the admission budget: 1.0 (default) pre-commits
    every stream's worst-case remaining blocks, so mid-decode allocation
    never fails; > 1.0 oversubscribes and relies on preemption.
    """

    def __init__(self, model: TransformerLM, n_blocks: int,
                 block_size: int, max_resident: int,
                 steps_per_tick: int = 4, overcommit: float = 1.0,
                 interactive_reserve: int = 0, decode_buckets: bool = True,
                 mesh=None, adapters=None):
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (a BlockPool mesh, "
                              "tp > 1)")
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if interactive_reserve < 0:
            raise ValueError(f"interactive_reserve must be >= 0, got "
                             f"{interactive_reserve}")
        if max_resident < 1:
            raise ValueError(
                f"max_resident must be >= 1, got {max_resident}")
        if steps_per_tick < 1:
            raise ValueError(
                f"steps_per_tick must be >= 1, got {steps_per_tick}")
        tile = min(256, model.max_len)
        if block_size < 1 or tile % block_size:
            raise ValueError(
                f"block_size {block_size} must divide the attention tile "
                f"{tile} (= min(256, max_len)) — the gathered block view "
                f"must reproduce the contiguous cache layout exactly")
        if overcommit < 1.0:
            raise ValueError(f"overcommit must be >= 1, got {overcommit}")
        self.block_size = block_size
        self.n_blocks = n_blocks          # usable (null excluded)
        self.max_resident = max_resident
        self.steps_per_tick = steps_per_tick
        self.max_len = model.max_len
        self.overcommit = overcommit
        self.interactive_reserve = interactive_reserve  # blocks held back
        #                             from BATCH-lane admission so an
        #                             interactive arrival never waits on a
        #                             batch release
        self.decode_buckets = decode_buckets  # shrink each decode tick to
        #                             the smallest pow2 row bucket covering
        #                             live rows
        self.model = model
        self.device = model.head.kernel.device
        self._adapters = adapters       # optional AdapterPool: stacks and
        #                                 per-row slots ride every forward
        cap = -(-model.max_len // tile) * tile
        self.n_tbl = cap // block_size    # block-table width (cap coverage)
        self._cap = cap
        self.cache = self._init_cache()
        self._ev_lock = threading.Lock()   # event log is read off-thread
        self._reset_host()

    def _init_cache(self) -> dict:
        return init_paged_cache(self.model, self.n_blocks + 1,
                                self.block_size)

    # -- host accounting ------------------------------------------------------
    def _reset_host(self) -> None:
        # block 0 is the reserved null block: never allocated, catches
        # unallocated-table-entry and overshoot writes
        self._free = list(range(self.n_blocks, 0, -1))   # pop() -> block 1
        self._ref = np.zeros(self.n_blocks + 1, np.int64)
        self._free_rows = list(range(self.max_resident - 1, -1, -1))
        self._streams: dict[int, _Stream] = {}
        self._committed = 0           # worst-case blocks still owed to
        #                               resident streams (admission budget)
        self._seq = 0
        self._full_map: dict[bytes, int] = {}     # chain hash -> block
        self._tail_map: dict[tuple, int] = {}     # (chain, tail) -> block
        self._block_keys: dict[int, list] = {}    # block -> its map keys
        self._cached: collections.OrderedDict[int, bool] = \
            collections.OrderedDict()             # idle registered, LRU
        self.stats = {"prefix_hit_tokens": 0, "prefix_hit_blocks": 0,
                      "prefix_miss_blocks": 0, "cow_copies": 0,
                      "preemptions": 0, "batch_preemptions": 0,
                      "decode_rows_skipped": 0}
        self.last_decode_bucket = 0   # rows the last decode tick dispatched
        # prefix-index feed: a bounded register/evict event log, plus the
        # token prefix behind every registered full-block chain
        with self._ev_lock:
            self._prefix_tokens: dict[bytes, tuple] = {}
            self._events: list[tuple] = []   # (seq, kind, key hex, tokens)
            self._event_seq = 0
            self._event_floor = 0            # seqs <= floor were compacted

    def reset(self) -> None:
        """Fresh device + host state after an engine failure (the
        :meth:`SlotPool.reset` contract)."""
        self.cache = self._init_cache()
        self._reset_host()

    @property
    def free_slots(self) -> int:
        """Free resident ROWS (the engine health view's slot analogue)."""
        return len(self._free_rows)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def free_blocks_effective(self) -> int:
        """Free + idle-cached (reclaimable on pressure)."""
        return len(self._free) + len(self._cached)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.block_size)

    def total_positions(self, prompt_len: int, num_steps: int) -> int:
        """Cache positions a request ever writes: the prompt plus every
        generated token EXCEPT the last (picked, never fed back)."""
        return prompt_len + num_steps - 1

    def can_admit(self, prompt_len: int, num_steps: int,
                  lane: str = "interactive") -> bool:
        """Admission on free BLOCKS, not free rows: conservative — counts
        the request's worst-case need against free-minus-committed (prefix
        hits only ever help). ``overcommit`` scales the budget. The BATCH
        lane admits only what fits BEHIND the interactive-reserve
        watermark: its budget is docked ``interactive_reserve`` blocks, so
        batch backfill can never occupy the headroom an interactive
        arrival would otherwise have to preempt for."""
        if not self._free_rows:
            return False
        need = self.blocks_for(self.total_positions(prompt_len, num_steps))
        budget = self.free_blocks_effective * self.overcommit
        if lane == "batch":
            budget -= self.interactive_reserve
        return budget - self._committed >= need

    @property
    def reserve_occupancy_pct(self) -> float:
        """How much of the interactive reserve is currently eaten into:
        0 means the full reserve sits uncommitted (an interactive arrival
        needing up to ``interactive_reserve`` blocks admits instantly),
        100 means interactive traffic itself has consumed it all (batch
        admission is then fully shut; interactive keeps admitting on the
        plain budget and, past that, preempts batch residents)."""
        if not self.interactive_reserve:
            return 0.0
        avail = self.free_blocks_effective - self._committed
        free = max(0, min(self.interactive_reserve, avail))
        return 100.0 * (1.0 - free / self.interactive_reserve)

    def min_remaining_steps(self) -> int | None:
        """Fewest cache positions any resident stream still needs — the
        basis of the projected-block-release ``retry_after_ms`` hint."""
        if not self._streams:
            return None
        return min(st.total - st.filled for st in self._streams.values())

    def gauges(self) -> dict[str, float]:
        used = self.n_blocks - len(self._free) - len(self._cached)
        toks = sum(st.filled for st in self._streams.values())
        nbatch = sum(1 for st in self._streams.values()
                     if st.lane == "batch")
        # reserve gauges are summable across replicas; the occupancy ratio
        # is derived at snapshot/render time from the summed pair
        avail = self.free_blocks_effective - self._committed
        return {
            "blocks_total": float(self.n_blocks),
            "blocks_free": float(len(self._free)),
            "blocks_cached": float(len(self._cached)),
            "blocks_used": float(used),
            "block_tokens_used": float(toks),
            "block_tokens_capacity": float(used * self.block_size),
            "resident_streams": float(len(self._streams)),
            "batch_resident_streams": float(nbatch),
            "interactive_reserve_blocks": float(self.interactive_reserve),
            "reserve_free_blocks": float(
                max(0, min(self.interactive_reserve, avail))),
            "prefix_cache_keys": float(len(self._full_map)),
            "decode_bucket": float(self.last_decode_bucket),
            "tp_degree": 1.0,
        }

    # -- allocator ------------------------------------------------------------
    def _alloc(self) -> int:
        if self._free:
            blk = self._free.pop()
        elif self._cached:
            blk, _ = self._cached.popitem(last=False)   # LRU reclaim
            self._unregister(blk)
        else:
            raise OutOfBlocks("block pool exhausted")
        self._ref[blk] = 1
        return blk

    def _incref(self, blk: int) -> None:
        if self._ref[blk] == 0:       # idle cached -> active again
            self._cached.pop(blk, None)
        self._ref[blk] += 1

    def _decref(self, blk: int) -> None:
        self._ref[blk] -= 1
        if self._ref[blk] < 0:
            raise AssertionError(f"block {blk} refcount underflow")
        if self._ref[blk] == 0:
            if blk in self._block_keys:
                # still content-addressed: park idle (hittable), reclaim LRU
                self._cached[blk] = True
            else:
                self._free.append(blk)

    def _unregister(self, blk: int) -> None:
        for kind, key in self._block_keys.pop(blk, ()):
            m = self._full_map if kind == "full" else self._tail_map
            if m.get(key) == blk:
                del m[key]
                if kind == "full":
                    with self._ev_lock:
                        self._prefix_tokens.pop(key, None)
                    self._emit("evict", key)

    # -- fleet prefix-index feed ----------------------------------------------
    _EVENT_CAP = 4096             # retained register/evict events

    def _emit(self, kind: str, key: bytes, tokens: tuple | None = None
              ) -> None:
        with self._ev_lock:
            self._event_seq += 1
            self._events.append((self._event_seq, kind, key.hex(),
                                 None if tokens is None else list(tokens)))
            if len(self._events) > self._EVENT_CAP:
                drop = len(self._events) - self._EVENT_CAP
                self._event_floor = self._events[drop - 1][0]
                del self._events[:drop]

    def prefix_summary(self) -> dict:
        """The cheap health-view summary: the event-log head seq (pollers
        fetch deltas only when it moved) and the registered key count."""
        with self._ev_lock:
            return {"seq": self._event_seq, "keys": len(self._full_map)}

    def prefix_events(self, since: int = 0) -> dict:
        """Register/evict events with seq > ``since`` — the fleet prefix
        index's delta feed (JSON-clean: hex keys, int token lists). A
        ``since`` outside the retained window — the log was compacted, or
        the pool reset under the poller — returns a full snapshot of the
        currently registered prefixes with ``reset`` set, so the poller
        simply replaces everything it believed about this replica."""
        with self._ev_lock:
            if since < self._event_floor or since > self._event_seq:
                return {"seq": self._event_seq, "reset": True,
                        "events": [["register", h.hex(), list(toks)]
                                   for h, toks in
                                   self._prefix_tokens.items()]}
            return {"seq": self._event_seq, "reset": False,
                    "events": [[kind, key, toks]
                               for s, kind, key, toks in self._events
                               if s > since]}

    # -- prefix cache ---------------------------------------------------------
    def _chain_hashes(self, prompt: np.ndarray,
                      salt: bytes = b"") -> list[bytes]:
        """Per-full-block chain hashes: ``h[j]`` commits to tokens
        ``[0, (j+1)*bs)`` — equal hashes mean equal tokens at equal
        positions, which (K/V being deterministic in tokens+positions+
        params) means bit-identical block content.

        ``salt`` seeds the chain (the request's adapter digest): adapted
        K/V is a function of tokens+positions+params **+adapter**, so two
        tenants' identical prompts under different adapters land on
        DISJOINT chains — cross-adapter reuse is structurally impossible.
        The empty salt reproduces today's hashes bit-for-bit, so base
        traffic, the fleet prefix index, and KV migration (which only ever
        exports unsalted chains) are untouched."""
        bs = self.block_size
        out, h = [], salt
        for j in range(len(prompt) // bs):
            h = hashlib.sha1(h + prompt[j * bs:(j + 1) * bs].tobytes()
                             ).digest()
            out.append(h)
        return out

    def lookup(self, prompt: np.ndarray, salt: bytes = b"") -> int:
        """Longest cached prefix (tokens) WITHOUT mutating state — capped
        at ``P - 1`` so at least one real token always prefills (its
        logits pick the first output token)."""
        bs = self.block_size
        p = len(prompt)
        hashes = self._chain_hashes(prompt, salt)
        hit = 0
        for j, h in enumerate(hashes):
            if self._full_map.get(h) is None:
                break
            hit = (j + 1) * bs
        full = p // bs
        if hit == full * bs and p % bs:
            chain = hashes[full - 1] if full else salt
            if (chain, prompt[full * bs:].tobytes()) in self._tail_map:
                hit = p
        return min(hit, p - 1)

    def admit(self, prompt: np.ndarray, num_steps: int,
              seq_hint: int | None = None,
              lane: str = "interactive", adapter_slot: int = 0,
              salt: bytes = b"") -> tuple[int, int]:
        """Claim a row and the prompt's blocks for one request. Prefix-hit
        FULL blocks the request never writes are shared by refcount; the
        block holding the first written position (``hit`` onward) is cloned
        (CoW) when hit; the rest allocate fresh. Returns ``(row, hit)`` —
        the engine prefills only ``prompt[hit:]``. The caller must have
        checked :meth:`can_admit` (raises :class:`OutOfBlocks` otherwise —
        a clean unwind, nothing leaked)."""
        bs = self.block_size
        p = len(prompt)
        if p < 1:
            raise ValueError("empty prompt")
        if not self._free_rows:
            raise RuntimeError("no free resident rows")
        hit = self.lookup(prompt, salt)
        hashes = self._chain_hashes(prompt, salt)
        st = _Stream(self._free_rows[-1], p,
                     self.total_positions(p, num_steps), self._seq,
                     lane=lane, adapter_slot=adapter_slot, salt=salt)
        blocks: list[int] = []
        try:
            # shared full hit blocks: everything strictly before the first
            # written position's block
            n_shared = hit // bs
            for j in range(n_shared):
                blk = self._full_map[hashes[j]]
                self._incref(blk)
                blocks.append(blk)
            # the partial tail hit (if any) is WRITTEN from position `hit`
            # onward -> clone, never share (the no-write-at-ref>1
            # invariant). hit % bs != 0 implies hit == p - 1 (lookup only
            # returns block multiples or the clamped p - 1), leaving two
            # sources: the clamped full-coverage case clones the LAST FULL
            # block (suffix = the recomputed final token), a tail-map hit
            # clones the registered partial tail.
            if hit % bs:
                j = hit // bs
                if p % bs == 0:
                    src = self._full_map[hashes[j]]
                else:
                    chain = hashes[j - 1] if j else salt
                    src = self._tail_map[(chain, prompt[j * bs:].tobytes())]
                dst = self._alloc()
                self._copy(dst, src)
                self.stats["cow_copies"] += 1
                blocks.append(dst)
            # fresh blocks for the uncovered prompt tail
            n_prompt = self.blocks_for(p)
            fresh = n_prompt - len(blocks)
            for _ in range(fresh):
                blocks.append(self._alloc())
        except OutOfBlocks:
            for blk in blocks:
                self._decref(blk)
            raise
        hit_blocks = n_shared + (1 if hit % bs else 0)
        self.stats["prefix_hit_tokens"] += hit
        self.stats["prefix_hit_blocks"] += hit_blocks
        self.stats["prefix_miss_blocks"] += len(blocks) - hit_blocks
        st.blocks = blocks
        row = self._free_rows.pop()
        assert row == st.row
        self._seq += 1
        self._committed += self.blocks_for(st.total) - len(blocks)
        self._streams[row] = st
        return row, hit

    def register(self, row: int, prompt: np.ndarray) -> None:
        """Publish the row's prompt blocks into the prefix cache — call
        AFTER its prefill fetched (content is on device). Keep-first: a
        hash already mapped stays mapped (refcounts remain consistent
        either way; first-writer wins)."""
        bs = self.block_size
        st = self._streams[row]
        hashes = self._chain_hashes(prompt, st.salt)
        for j, h in enumerate(hashes):
            blk = st.blocks[j]
            if h not in self._full_map:
                self._full_map[h] = blk
                self._block_keys.setdefault(blk, []).append(("full", h))
                if st.salt:
                    # salted (adapter) chains publish a holder-only event:
                    # the gateway routes adapter traffic to residents by the
                    # salted key, but the tokens stay out of the index — a
                    # warm-replay through normal prefill would re-register
                    # them UNSALTED, i.e. as base-model KV
                    self._emit("register", h)
                else:
                    toks = tuple(int(t) for t in prompt[:(j + 1) * bs])
                    with self._ev_lock:
                        self._prefix_tokens[h] = toks
                    self._emit("register", h, toks)
        t = len(prompt) % bs
        if t:
            j = len(prompt) // bs
            chain = hashes[j - 1] if j else st.salt
            key = (chain, prompt[j * bs:].tobytes())
            blk = st.blocks[j]
            if key not in self._tail_map:
                self._tail_map[key] = blk
                self._block_keys.setdefault(blk, []).append(("tail", key))

    def note_prefilled(self, row: int) -> None:
        """Prefill wrote the prompt: the row's valid depth is its prompt
        length (bucket-pad garbage beyond it is overwritten write-before-
        read by decode, exactly the contiguous path's discipline)."""
        st = self._streams[row]
        st.filled = st.prompt_len

    def set_filled(self, row: int, n: int) -> None:
        """Pin a row's valid-K/V depth explicitly. The draft pool's P == 1
        edge: nothing prefills (the lone prompt token is written by the
        first lagged draft step itself), so the engine rewinds the pointer
        that :meth:`admit`'s ``prompt_len`` bookkeeping would imply."""
        self._streams[row].filled = n

    def release(self, row: int, preempted: bool = False) -> None:
        """Return a finished (or preempted) stream's row and blocks.
        Unregistered blocks free IMMEDIATELY; registered ones park in the
        idle prefix cache until allocation pressure reclaims them."""
        st = self._streams.pop(row)
        self._committed -= self.blocks_for(st.total) - len(st.blocks)
        for blk in st.blocks:
            self._decref(blk)
        self._free_rows.append(row)
        if preempted:
            self.stats["preemptions"] += 1
            if st.lane == "batch":
                self.stats["batch_preemptions"] += 1

    # -- KV block migration ---------------------------------------------------
    def _leaves(self) -> list[torch.Tensor]:
        """The cache's non-scalar leaves in flax's flatten order (dict keys
        sorted as strings, so ``backbone_block10`` precedes
        ``backbone_block2``): per layer ``kv_block_key``, ``kv_block_value``
        — the order ``ddw_tpu``'s wire format carries."""
        return [self.cache[name]["attn"][leaf] for name in sorted(self.cache)
                for leaf in ("kv_block_key", "kv_block_value")]

    def _leaf_meta(self) -> list[tuple[tuple[int, ...], str]]:
        """Per-block payload geometry: for every leaf the shape and dtype
        name of one block's slice ``leaf[blk]`` (numpy's names:
        ``bfloat16``, ``float32``)."""
        return [(tuple(leaf.shape[1:]), str(leaf.dtype).removeprefix("torch."))
                for leaf in self._leaves()]

    def export_blocks(self, prompt, skip_hashes=()) -> dict | None:
        """Serialize ``prompt``'s REGISTERED full-block chain into the
        versioned migration wire format of ``ddw_tpu`` — call after
        :meth:`register` published the blocks. JSON-clean (hex hashes, int
        token lists, base64 payloads of each leaf's raw little-endian bytes;
        bf16 moves as its 16-bit words). ``skip_hashes`` (hex) names a warm
        prefix the receiver already holds: those leading blocks ship
        hash-only. Returns ``None`` when the prompt has no registered full
        block."""
        prompt = np.asarray(prompt, np.int32)
        bs = self.block_size
        hashes = self._chain_hashes(prompt)
        n = 0
        for h in hashes:
            if self._full_map.get(h) is None:
                break
            n += 1
        if n == 0:
            return None
        skip = set(skip_hashes)
        start = 0
        while start < n and hashes[start].hex() in skip:
            start += 1
        leaves = self._leaves()
        payload = []
        for j in range(start, n):
            blk = self._full_map[hashes[j]]
            payload.append([
                base64.b64encode(leaf[blk].contiguous().view(torch.uint8)
                                 .cpu().numpy().tobytes()).decode("ascii")
                for leaf in leaves])
        return {
            "version": KV_WIRE_VERSION,
            "block_size": bs,
            "tp": 1,                  # tensor parallelism is not ported
            "leaves": [[list(s), d] for s, d in self._leaf_meta()],
            "hashes": [h.hex() for h in hashes[:n]],
            "tokens": [int(t) for t in prompt[:n * bs]],
            "start_block": start,
            "payload": payload,
        }

    @torch.no_grad()
    def import_blocks(self, wire: dict) -> dict:
        """Land a migration payload (``ddw_tpu``'s or this pool's): validate
        EVERYTHING first (version, geometry, hash-chain integrity, payload
        completeness — any defect raises :class:`KVWireError` before the
        pool changes), then allocate a block per carried hash not already
        registered, write the payload and register each block under its
        ORIGINAL chain hash. Imported blocks end ref 0 + registered (idle
        LRU), so the next :meth:`admit` prefix-hits them. Returns
        ``{"imported", "skipped", "bytes"}``."""
        bs = self.block_size
        if not isinstance(wire, dict):
            raise KVWireError("wire payload must be a dict")
        if wire.get("version") != KV_WIRE_VERSION:
            raise KVWireError(
                f"wire version {wire.get('version')!r} != "
                f"{KV_WIRE_VERSION} — refusing cross-version import")
        if wire.get("block_size") != bs:
            raise KVWireError(
                f"wire block_size {wire.get('block_size')!r} != {bs}")
        meta = self._leaf_meta()
        try:
            wire_meta = [(tuple(int(d) for d in s), str(t))
                         for s, t in wire.get("leaves", ())]
        except (TypeError, ValueError) as e:
            raise KVWireError(f"malformed leaf metadata: {e}") from e
        if wire_meta != meta:
            raise KVWireError("cache leaf geometry mismatch — sender and "
                              "receiver pools disagree on model shape")
        hashes_hex = wire.get("hashes")
        if not isinstance(hashes_hex, (list, tuple)) or not hashes_hex:
            raise KVWireError("wire carries no chain hashes")
        n = len(hashes_hex)
        try:
            tokens = np.asarray(wire.get("tokens", ()), np.int32)
        except (TypeError, ValueError, OverflowError) as e:
            raise KVWireError(f"malformed token list: {e}") from e
        if tokens.ndim != 1 or len(tokens) != n * bs:
            raise KVWireError(
                f"token list length {tokens.size} != {n} blocks * "
                f"{bs} tokens")
        chain = self._chain_hashes(tokens)
        if [h.hex() for h in chain] != [str(h) for h in hashes_hex]:
            raise KVWireError("chain hash mismatch — wire tokens do not "
                              "reproduce the carried hashes")
        start = wire.get("start_block", 0)
        if not isinstance(start, int) or not 0 <= start <= n:
            raise KVWireError(f"start_block {start!r} outside [0, {n}]")
        payload = wire.get("payload")
        if not isinstance(payload, (list, tuple)) or \
                len(payload) != n - start:
            got = len(payload) if isinstance(payload, (list, tuple)) else 0
            raise KVWireError(f"truncated payload: {got} block rows for "
                              f"{n - start} carried blocks")
        decoded = []
        for row in payload:
            if not isinstance(row, (list, tuple)) or len(row) != len(meta):
                got = len(row) if isinstance(row, (list, tuple)) else 0
                raise KVWireError(f"truncated payload row: {got} leaves for "
                                  f"{len(meta)}")
            arrs = []
            for b64, (shape, dtype) in zip(row, meta):
                try:
                    raw = base64.b64decode(b64, validate=True)
                except Exception as e:
                    raise KVWireError(f"undecodable leaf payload: {e}") \
                        from e
                tdt = torch_dtype(dtype)
                want = int(torch.empty((), dtype=tdt).element_size()
                           * np.prod(shape, dtype=np.int64))
                if len(raw) != want:
                    raise KVWireError(f"truncated leaf payload: {len(raw)} "
                                      f"bytes, expected {want}")
                arrs.append(torch.frombuffer(bytearray(raw), dtype=torch.uint8)
                            .view(tdt).reshape(shape))
            decoded.append(arrs)
        # -- validation done; land the blocks (all-or-nothing) --
        new_hashes = [chain[j] for j in range(start, n)
                      if chain[j] not in self._full_map]
        if len(new_hashes) > self.free_blocks_effective:
            raise OutOfBlocks(
                f"pool cannot hold {len(new_hashes)} imported blocks "
                f"({self.free_blocks_effective} reclaimable)")
        landed: list[int] = []
        skipped = 0
        nbytes = 0
        leaves = self._leaves()
        try:
            for j in range(start, n):
                h = chain[j]
                if h in self._full_map:      # keep-first dedupe / warm skip
                    skipped += 1
                    continue
                blk = self._alloc()
                for leaf, arr in zip(leaves, decoded[j - start]):
                    leaf[blk].copy_(arr)
                self._full_map[h] = blk
                self._block_keys.setdefault(blk, []).append(("full", h))
                toks = tuple(int(t) for t in tokens[:(j + 1) * bs])
                with self._ev_lock:
                    self._prefix_tokens[h] = toks
                self._emit("register", h, toks)
                landed.append(blk)
                nbytes += sum(a.numel() * a.element_size()
                              for a in decoded[j - start])
        except OutOfBlocks:
            # only reachable when LRU reclaim evicted a chain member the
            # precheck counted as held — unwind to the pre-call state
            for blk in landed:
                self._unregister(blk)
                self._decref(blk)
            raise
        # ref 1 -> 0: registered blocks park in the idle LRU, hittable by
        # the next admit. Held at ref 1 during the loop so allocation
        # pressure can never reclaim an earlier block of this very chain.
        for blk in landed:
            self._decref(blk)
        return {"imported": len(landed), "skipped": skipped,
                "bytes": nbytes}

    # -- decode-tick allocation (+ preemption policy) -------------------------
    def _extend(self, st: _Stream, k: int) -> None:
        writes = min(k, st.total - st.filled)
        if writes <= 0:
            return
        need = (st.filled + writes - 1) // self.block_size + 1
        while len(st.blocks) < need:
            st.blocks.append(self._alloc())
            self._committed -= 1

    def prepare_tick(self, k: int) -> list[int]:
        """On-demand allocation for one decode tick: every resident stream
        gets blocks covering its next ``min(k, remaining)`` writes —
        interactive streams first, so on a contended tick the batch lane
        is the one that goes short. On exhaustion the victim is the
        YOUNGEST stream of the LOWEST lane: any batch resident is
        preempted (blocks released, row freed) before any interactive
        stream — the lane contract — and allocation retries; within a
        lane, youngest-first means oldest streams always make progress,
        so the policy cannot livelock. Returns the preempted rows; the
        engine re-queues their requests at their lane's queue head."""
        victims: list[int] = []
        order = sorted(self._streams.values(),
                       key=lambda s: (s.lane == "batch", s.seq))
        for st in order:
            while st.row in self._streams:
                try:
                    self._extend(st, k)
                    break
                except OutOfBlocks:
                    live = [s for s in self._streams.values() if s is not st]
                    victim = (max(live,
                                  key=lambda s: (s.lane == "batch", s.seq))
                              if live else st)
                    self.release(victim.row, preempted=True)
                    victims.append(victim.row)
                    if victim is st:
                        break
        return victims

    def preempt_youngest(self, lane: str = "batch") -> int | None:
        """Preempt the youngest resident stream of ``lane`` outright —
        the admission-side arm of the lane contract: when an interactive
        head cannot fit (blocks or rows), batch residents are evicted by
        recompute BEFORE the head waits on anything interactive. Returns
        the freed row (the engine re-queues its request) or None when no
        stream of that lane is resident."""
        cands = [s for s in self._streams.values() if s.lane == lane]
        if not cands:
            return None
        victim = max(cands, key=lambda s: s.seq)
        self.release(victim.row, preempted=True)
        return victim.row

    def extend_row(self, row: int, k: int) -> None:
        """Allocate blocks covering one row's next ``min(k, remaining)``
        writes (raises :class:`OutOfBlocks`; nothing to unwind — blocks
        already granted stay on the stream and are reclaimed at release).
        A speculative tick drives this directly instead of
        :meth:`prepare_tick` because a victim must leave the target and the
        draft pools together."""
        self._extend(self._streams[row], k)

    def stream_order(self, row: int) -> tuple[bool, int]:
        """Preemption sort key for a resident row — ``(is_batch, seq)``:
        max() over live rows reproduces :meth:`prepare_tick`'s victim
        policy (batch before interactive, youngest first) at the engine
        level, where the two spec pools pick ONE joint victim."""
        st = self._streams[row]
        return (st.lane == "batch", st.seq)

    def commit_spec(self, row: int, advance: int) -> None:
        """Advance a row's write pointer by the ACCEPTED positions of a
        speculative tick and roll back the rest: ``spec_draft`` /
        ``spec_verify`` wrote up to ``k + 1`` positions past ``filled``
        without advancing it, so moving ``filled`` forward ``advance``
        rewinds the pointer inside the partially filled tail block
        (rejected K/V beyond it is garbage, overwritten before it is read
        next tick) and any block allocated ONLY for rejected positions is
        freed here — ``_committed`` re-grows by each freed block, exactly
        reversing ``_extend``'s decrement, so the admission budget stays
        worst-case-correct. Prompt blocks (the only ones the prefix cache
        ever registers) are never freed."""
        st = self._streams[row]
        st.filled = min(st.filled + advance, st.total)
        need = max(self.blocks_for(st.filled),
                   self.blocks_for(st.prompt_len))
        while len(st.blocks) > need:
            self._decref(st.blocks.pop())
            self._committed += 1

    def table(self, row: int) -> np.ndarray:
        out = np.zeros((self.n_tbl,), np.int32)
        st = self._streams[row]
        out[:len(st.blocks)] = st.blocks
        return out

    def _tables_starts(self, rows) -> tuple[np.ndarray, np.ndarray]:
        tables = np.zeros((len(rows), self.n_tbl), np.int32)
        starts = np.zeros((len(rows),), np.int32)
        for i, row in enumerate(rows):
            st = self._streams.get(row) if row is not None else None
            if st is not None:
                tables[i, :len(st.blocks)] = st.blocks
                starts[i] = st.filled
        return tables, starts

    def _adapter_extras(self, rows):
        """The forward's ``adapters`` argument: ``(stacks, idx[R])`` with
        ``idx[i]`` the row's adapter slot (0 = base / free / warmup row →
        the null stack row, delta exactly 0); None when no pool is
        attached."""
        if self._adapters is None:
            return None
        idx = np.zeros((len(rows),), np.int64)
        for i, row in enumerate(rows):
            st = self._streams.get(row) if row is not None else None
            if st is not None:
                idx[i] = st.adapter_slot
        return (self._adapters.stacks(), host_to_device(idx, self.device))

    # -- device work ----------------------------------------------------------
    @torch.no_grad()
    def _copy(self, dst: int, src: int) -> None:
        """Clone block ``src`` into ``dst`` in every layer (copy-on-write)."""
        for leaf in self._leaves():
            leaf[dst].copy_(leaf[src])

    @torch.no_grad()
    def prefill(self, rows, padded_suffixes, true_lens, temps, keys
                ) -> np.ndarray:
        """One grouped suffix-prefill forward: ``padded_suffixes [G, S]``
        (one suffix-length bucket), ``rows`` the claimed resident rows
        (``None`` = dummy pad row -> null table), per-row true suffix
        lengths / temperatures / step keys. Each row starts at its hit
        offset and writes straight into its blocks; the returned
        ``first_tokens [G]`` (host) are picked from the last REAL suffix
        position's logits."""
        padded_suffixes = np.asarray(padded_suffixes, np.int64)
        g = padded_suffixes.shape[0]
        tables, starts = self._tables_starts(rows)
        # starts for prefill are the HIT offsets, not filled (filled is 0
        # until note_prefilled); hit = prompt_len - true suffix len
        for i, row in enumerate(rows):
            if row is not None:
                starts[i] = (self._streams[row].prompt_len
                             - int(true_lens[i]))
        logits = self.model(host_to_device(padded_suffixes, self.device),
                            cache=self.cache,
                            adapters=self._adapter_extras(rows),
                            block_tables=host_to_device(tables, self.device),
                            start_pos=starts)
        idx = host_to_device(np.asarray(true_lens, np.int64) - 1,
                             self.device)
        last = logits[torch.arange(g, device=self.device), idx]
        return _pick(last, temps, keys).cpu().numpy().astype(np.int32)

    def _live_bucket(self) -> int:
        """Smallest pow2 row bucket covering live rows (rows allocate
        lowest-first, so live rows sit low); ``max_resident`` when
        bucketing is off."""
        if not self.decode_buckets:
            return self.max_resident
        top = 1 + (max(self._streams) if self._streams else 0)
        return batch_bucket(top, self.max_resident)

    def decode(self, tokens, temperatures, keys) -> np.ndarray:
        """Advance every LIVE resident row ``steps_per_tick`` tokens
        (``tokens [R]`` current per-row token, ``temperatures [R]``,
        ``keys [R, k]``). With ``decode_buckets`` the dispatch shrinks to
        the smallest pow2 row bucket covering live rows; each row's chain
        depends only on its own table, start and keys, so per-row results
        do not depend on the bucket. Block tables must already cover the
        tick (:meth:`prepare_tick`). Returns ``[R, k]`` (rows beyond the
        bucket read 0 — no stream lives there)."""
        k = self.steps_per_tick
        r = self.max_resident
        nb = self._live_bucket()
        toks = self._decode_dispatch(
            np.asarray(tokens)[:nb], np.asarray(temperatures)[:nb],
            np.asarray(keys)[:nb], list(range(nb)))
        self.last_decode_bucket = nb
        if nb < r:
            self.stats["decode_rows_skipped"] += r - nb
            out = np.zeros((r, k), toks.dtype)
            out[:nb] = toks
            toks = out
        for st in self._streams.values():
            st.filled = min(st.filled + k, st.total)
        return toks

    @torch.no_grad()
    def _decode_dispatch(self, tokens, temps, keys, rows) -> np.ndarray:
        """One decode chain over ``rows`` (``None`` = null-table warmup
        row): the tick's table goes to the device once, the depths stay
        host ints, the picks stay on the device until the one fetch."""
        tables, starts = self._tables_starts(rows)
        tables_d = host_to_device(tables, self.device)
        tok = host_to_device(tokens, self.device)
        keys = np.asarray(keys)
        adapters = self._adapter_extras(rows)
        out = []
        for j in range(self.steps_per_tick):
            logits = self.model(tok[:, None], cache=self.cache,
                                adapters=adapters,
                                block_tables=tables_d, start_pos=starts + j)
            tok = _pick(logits[:, 0], temps, keys[:, j])
            out.append(tok)
        return torch.stack(out, 1).cpu().numpy().astype(np.int32)

    def spec_draft(self, prev_tokens, cur_tokens, temps, keys) -> np.ndarray:
        """Draft-model proposal round (called on the DRAFT pool): a live
        draft row has processed the picked history H up to ``H[:-2]`` (it
        lags the target one position), so the round first feeds the lag
        pair ``[H[-2], H[-1]]`` as one S=2 step — its second position
        proposes draft 1 — then chains ``k - 1`` single-token steps for
        drafts 2..k (``keys [R, k]``: the ORIGINAL per-step seeds, so a
        self-draft reproduces the target's own picks). Writes ``k + 1``
        positions past ``filled`` WITHOUT advancing it; the engine advances
        via :meth:`commit_spec` after verification. Returns ``[R, k]``."""
        r = self.max_resident
        k = np.asarray(keys).shape[1]
        nb = self._live_bucket()
        drafts = self._spec_draft_dispatch(
            np.asarray(prev_tokens)[:nb], np.asarray(cur_tokens)[:nb],
            np.asarray(temps)[:nb], np.asarray(keys)[:nb], list(range(nb)))
        if nb < r:
            out = np.zeros((r, k), drafts.dtype)
            out[:nb] = drafts
            drafts = out
        return drafts

    @torch.no_grad()
    def _spec_draft_dispatch(self, prev, cur, temps, keys, rows
                             ) -> np.ndarray:
        tables, starts = self._tables_starts(rows)
        tables_d = host_to_device(tables, self.device)
        keys = np.asarray(keys)
        k = keys.shape[1]
        pair = host_to_device(np.stack([prev, cur], axis=1), self.device)
        logits = self.model(pair, cache=self.cache, block_tables=tables_d,
                            start_pos=starts)
        tok = _pick(logits[:, 1], temps, keys[:, 0])
        out = [tok]
        for j in range(1, k):
            logits = self.model(tok[:, None], cache=self.cache,
                                block_tables=tables_d,
                                start_pos=starts + 1 + j)
            tok = _pick(logits[:, 0], temps, keys[:, j])
            out.append(tok)
        return torch.stack(out, 1).cpu().numpy().astype(np.int32)

    def spec_verify(self, tokens, temps, keys) -> np.ndarray:
        """Target verification (called on the TARGET pool): score all
        ``k + 1`` positions — ``tokens [R, k+1]`` = current token + the k
        drafts — in ONE multi-token paged pass per row at its own depth,
        picking position ``j`` with the ORIGINAL step seed ``keys[:, j]``.
        The engine accepts drafts while they match the picks, so every
        emitted token is by induction the token sequential decode would
        have picked. Writes without advancing ``filled`` (:meth:`commit_spec`
        advances / rolls back); positions past a row's allocated blocks
        route to the null block and only ever back picks the engine
        discards. Returns picks ``[R, k+1]``."""
        r = self.max_resident
        s = np.asarray(tokens).shape[1]
        nb = self._live_bucket()
        picks = self._spec_verify_dispatch(
            np.asarray(tokens)[:nb], np.asarray(temps)[:nb],
            np.asarray(keys)[:nb], list(range(nb)))
        self.last_decode_bucket = nb
        if nb < r:
            self.stats["decode_rows_skipped"] += r - nb
            out = np.zeros((r, s), picks.dtype)
            out[:nb] = picks
            picks = out
        return picks

    @torch.no_grad()
    def _spec_verify_dispatch(self, tokens, temps, keys, rows) -> np.ndarray:
        tables, starts = self._tables_starts(rows)
        keys = np.asarray(keys)
        logits = self.model(host_to_device(tokens, self.device),
                            cache=self.cache,
                            adapters=self._adapter_extras(rows),
                            block_tables=host_to_device(tables, self.device),
                            start_pos=starts)
        picks = [_pick(logits[:, j], temps, keys[:, j])
                 for j in range(logits.shape[1])]
        return torch.stack(picks, 1).cpu().numpy().astype(np.int32)

    def warmup_spec(self, spec_k: int, role: str) -> None:
        """Run one spec program per resident bucket of the ladder
        (null-table rows, like :meth:`warmup`): the verify pass on the
        target pool, the lagged draft chain on the draft pool."""
        for nb in self.resident_ladder():
            if role == "verify":
                self._spec_verify_dispatch(
                    np.zeros((nb, spec_k + 1), np.int32),
                    np.zeros((nb,), np.float32),
                    np.zeros((nb, spec_k + 1), np.int64), [None] * nb)
            else:
                self._spec_draft_dispatch(
                    np.zeros((nb,), np.int32), np.zeros((nb,), np.int32),
                    np.zeros((nb,), np.float32),
                    np.zeros((nb, spec_k), np.int64), [None] * nb)

    def resident_ladder(self) -> tuple[int, ...]:
        """Decode-batch bucket ladder: pow2 row counts up to
        ``max_resident`` (always included, so full width stays exact).
        One entry when bucketing is off."""
        if not self.decode_buckets:
            return (self.max_resident,)
        out, b = [], 1
        while b < self.max_resident:
            out.append(b)
            b *= 2
        out.append(self.max_resident)
        return tuple(out)

    def warmup(self, buckets, max_group: int = 0) -> None:
        """Run the paged program shapes once: one suffix prefill per
        (bucket, power-of-two group), the decode chain at every resident
        bucket of the ladder, and the CoW copy. Warmup rows use the null
        table, so every write lands in the null block — pool state stays
        clean, no reset needed."""
        cap_g = max_group or min(8, self.max_resident)
        for bucket in sorted(set(buckets)):
            g = 1
            while True:
                self.prefill([None] * g, np.zeros((g, bucket), np.int32),
                             np.ones((g,), np.int32),
                             np.zeros((g,), np.float32),
                             np.zeros((g,), np.int64))
                if g >= cap_g:
                    break
                g = min(g * 2, cap_g)
        k = self.steps_per_tick
        for nb in self.resident_ladder():
            self._decode_dispatch(np.zeros((nb,), np.int32),
                                  np.zeros((nb,), np.float32),
                                  np.zeros((nb, k), np.int64), [None] * nb)
        self._copy(0, 0)
