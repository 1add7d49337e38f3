"""AdapterPool — hot-swappable LoRA adapters managed like KV blocks; the
port of ``ddw_tpu.serve.adapters``.

Multi-tenant serving (S-LoRA lineage, arXiv 2311.03285) wants one engine to
decode MANY fine-tuned variants of one base model in the same batch. The
mechanism mirrors the paged KV pool one layer up:

- **Slots, not checkpoints.** The pool owns per-target device STACKS shaped
  ``[slots+1, *in_dims, rank]`` / ``[slots+1, rank, *feats]`` (f32, on the
  model's device); loading an adapter writes its ``(lora_a, lora_b)`` leaves
  into one slot row in place. Slot 0 is reserved all-zeros — the NULL
  adapter — so a base-model request is just "row with adapter index 0" and
  its delta is exactly ``+0.0``.
- **Stacks are call arguments.** :class:`ddw_tpu_torch.serve.blocks.
  BlockPool` passes ``(stacks, row_idx)`` into its prefill, decode and
  spec-verify forwards the same way it passes block tables; their shapes
  never change while adapters load or evict.
- **Refcounted pin-while-in-flight.** Every admitted request pins its
  adapter; eviction refuses pinned slots. Idle adapters evict LRU by a
  monotonic use sequence (not wall clock — deterministic under test).
- **Digest-keyed identity.** An adapter id maps to the sha256 of its
  leaves (the same hex as ``ddw_tpu``'s for the same numpy leaves);
  re-loading the same id with different bytes is REFUSED (a silent swap
  would corrupt the prefix cache, whose chain hashes are salted by this
  digest — see ``BlockPool._chain_hashes``).

The ``.npz`` package of :func:`save_adapter` is ``ddw_tpu``'s byte for byte
(the same flattened leaf keys and JSON header, ``ddw_tpu.adapter.v1``), so a
file saved by either package loads in the other. Ranks smaller than the pool
rank are zero-padded at load (padding A with zero columns and B with zero
rows leaves the delta unchanged), so one pool serves mixed-rank adapters.
"""

from __future__ import annotations

import hashlib
import io
import json
import threading
from typing import Mapping

import numpy as np
import torch
from torch import nn


class AdapterError(RuntimeError):
    """Base for adapter-pool failures that are NOT client errors."""


class AdapterPoolFull(AdapterError):
    """No free slot and every resident adapter is pinned."""


class AdapterDigestMismatch(AdapterError):
    """An id is being re-loaded with different bytes than it registered."""


class UnknownAdapter(ValueError):
    """A request named an ``adapter_id`` the pool does not hold — a client
    error (a gateway maps it to a structured 400)."""

    def __init__(self, adapter_id: str, loaded: tuple[str, ...] = ()):
        super().__init__(f"unknown adapter {adapter_id!r}; "
                         f"loaded: {sorted(loaded)}")
        self.adapter_id = adapter_id
        self.loaded = tuple(loaded)


def _leaf_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def extract_adapter(params) -> dict:
    """Pull the LoRA leaves out of a trained parameter tree (a nested
    flax-layout mapping, or an ``nn.Module`` whose parameter names carry the
    same paths) into the pool's wire format: ``{block: {target: {"lora_a":
    a, "lora_b": b}}}`` (numpy). The block is the TOP-LEVEL module name
    (``backbone_block3``), the target the projection name (``query`` …
    ``fc2``) — the path in between (``attn``) is flattened away."""
    if isinstance(params, nn.Module):
        tree: dict = {}
        for name, p in params.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = p
        params = tree
    out: dict = {}

    def walk(node, path):
        if not isinstance(node, Mapping):
            return
        if "lora_a" in node and "lora_b" in node:
            block, target = path[0], path[-1]
            out.setdefault(block, {})[target] = {
                "lora_a": _leaf_numpy(node["lora_a"]),
                "lora_b": _leaf_numpy(node["lora_b"])}
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(params, ())
    if not out:
        raise ValueError("param tree holds no lora_a/lora_b leaves — was the "
                         "model built with lora_rank > 0?")
    return out


def adapter_digest(adapter: Mapping) -> str:
    """Content digest of an adapter tree: sha256 over (path, shape, dtype,
    bytes) of every leaf in sorted path order. This is the identity the
    prefix cache salts with."""
    h = hashlib.sha256()
    for block in sorted(adapter):
        for target in sorted(adapter[block]):
            for leaf in ("lora_a", "lora_b"):
                arr = np.ascontiguousarray(
                    _leaf_numpy(adapter[block][target][leaf]))
                h.update(f"{block}/{target}/{leaf}:{arr.shape}:"
                         f"{arr.dtype}".encode())
                h.update(arr.tobytes())
    return h.hexdigest()


def save_adapter(path, adapter: Mapping, *, rank: int, alpha: float,
                 meta: dict | None = None) -> str:
    """Write an adapter package (single ``.npz``: flattened leaves + JSON
    header). Returns the content digest."""
    arrays = {}
    for block in sorted(adapter):
        for target in sorted(adapter[block]):
            for leaf in ("lora_a", "lora_b"):
                arrays[f"{block}/{target}/{leaf}"] = _leaf_numpy(
                    adapter[block][target][leaf])
    header = {"format": "ddw_tpu.adapter.v1", "rank": int(rank),
              "alpha": float(alpha), "digest": adapter_digest(adapter),
              "meta": meta or {}}
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return header["digest"]


def load_adapter(path) -> tuple[dict, dict]:
    """Read a package written by :func:`save_adapter` (either package's) →
    ``(adapter, info)`` where ``info`` holds ``rank``/``alpha``/``digest``/
    ``meta``. The stored digest is re-verified against the bytes — a torn
    or tampered file is refused."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header.get("format") != "ddw_tpu.adapter.v1":
            raise ValueError(f"not an adapter package: {path}")
        adapter: dict = {}
        for key in z.files:
            if key == "__header__":
                continue
            block, target, leaf = key.split("/")
            adapter.setdefault(block, {}).setdefault(target, {})[leaf] = z[key]
    digest = adapter_digest(adapter)
    if digest != header["digest"]:
        raise AdapterDigestMismatch(
            f"package {path} digest {digest[:12]} != recorded "
            f"{header['digest'][:12]}")
    return adapter, header


class _Entry:
    __slots__ = ("adapter_id", "digest", "slot", "pins", "last_use",
                 "rank", "alpha")

    def __init__(self, adapter_id, digest, slot, rank, alpha, last_use):
        self.adapter_id = adapter_id
        self.digest = digest
        self.slot = slot
        self.pins = 0
        self.last_use = last_use
        self.rank = rank
        self.alpha = alpha


def _target_module(block: nn.Module, target: str) -> nn.Module:
    return getattr(block.attn, target) if target in (
        "query", "key", "value", "out") else getattr(block, target)


class AdapterPool:
    """Slot pool of hot-loadable LoRA adapters for ONE model shape.

    ``model`` is the serving :class:`~ddw_tpu_torch.models.lm.TransformerLM`
    (its projection shapes fix the stacks'); ``slots`` is the number of
    USABLE slots (the stacks hold ``slots + 1`` rows, row 0 being the
    reserved null adapter); ``rank`` is the pool rank every loaded adapter
    is padded to.
    """

    def __init__(self, model, slots: int, rank: int, *,
                 targets: tuple[str, ...] | None = None,
                 dtype: torch.dtype = torch.float32):
        from ddw_tpu_torch.models.lora import (LM_LORA_TARGETS,
                                               validate_lora_targets)

        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.slots = int(slots)
        self.rank = int(rank)
        self.targets = tuple(targets or LM_LORA_TARGETS)
        validate_lora_targets(self.targets)
        self._lock = threading.RLock()
        self._by_id: dict[str, _Entry] = {}
        self._seq = 0
        self.loads = 0
        self.evictions = 0
        self.pin_events = 0
        # the stack shapes come from the model's own projections: lora_a is
        # [*in_dims, rank], lora_b [rank, *features], as a LoRA clone of the
        # model would hold them
        dev = model.head.kernel.device
        n = self.slots + 1
        self._stacks = {
            f"backbone_block{i}": {
                target: (
                    torch.zeros((n, *mod.in_dims, self.rank), dtype=dtype,
                                device=dev),
                    torch.zeros((n, self.rank, *mod.features), dtype=dtype,
                                device=dev))
                for target in self.targets
                for mod in (_target_module(blk, target),)}
            for i, blk in enumerate(model.blocks())}

    # ---------------------------------------------------------------- load
    @torch.no_grad()
    def load(self, adapter_id: str, adapter: Mapping, *, alpha: float = 16.0,
             rank: int | None = None, digest: str | None = None) -> int:
        """Stage ``adapter`` into a slot under ``adapter_id``; returns the
        slot. Idempotent for identical bytes; REFUSES the same id with a
        different digest. When the pool is full, evicts the least-recently
        used unpinned adapter; raises :class:`AdapterPoolFull` if every
        resident adapter is pinned."""
        want = adapter_digest(adapter)
        if digest is not None and digest != want:
            raise AdapterDigestMismatch(
                f"adapter {adapter_id!r}: supplied digest {digest[:12]} does "
                f"not match bytes {want[:12]}")
        with self._lock:
            ent = self._by_id.get(adapter_id)
            if ent is not None:
                if ent.digest != want:
                    raise AdapterDigestMismatch(
                        f"adapter {adapter_id!r} already loaded with digest "
                        f"{ent.digest[:12]}; refusing silent swap to "
                        f"{want[:12]} — unload first")
                self._seq += 1
                ent.last_use = self._seq
                return ent.slot
            a_rank = rank or _infer_rank(adapter)
            if a_rank > self.rank:
                raise ValueError(
                    f"adapter {adapter_id!r} rank {a_rank} exceeds pool rank "
                    f"{self.rank}")
            scale = float(alpha) / float(a_rank)
            rows = {}                # validated before any slot changes
            for block, targets in self._stacks.items():
                for target, (a_stack, b_stack) in targets.items():
                    leaf = adapter.get(block, {}).get(target)
                    if leaf is None:        # untargeted projection: null row
                        rows[block, target] = None
                        continue
                    a = _pad_rank(_leaf_numpy(leaf["lora_a"])
                                  .astype(np.float32), self.rank, axis=-1)
                    # alpha/rank folds into B here, once, so the per-row
                    # delta needs no per-row scale
                    b = _pad_rank(_leaf_numpy(leaf["lora_b"])
                                  .astype(np.float32) * scale,
                                  self.rank, axis=0)
                    if a.shape != tuple(a_stack.shape[1:]):
                        raise ValueError(
                            f"adapter {adapter_id!r} {block}/{target} "
                            f"lora_a shape {a.shape} != pool "
                            f"{tuple(a_stack.shape[1:])}")
                    if b.shape != tuple(b_stack.shape[1:]):
                        raise ValueError(
                            f"adapter {adapter_id!r} {block}/{target} "
                            f"lora_b shape {b.shape} != pool "
                            f"{tuple(b_stack.shape[1:])}")
                    rows[block, target] = (a, b)
            slot = self._free_slot()
            for (block, target), ab in rows.items():
                a_stack, b_stack = self._stacks[block][target]
                if ab is None:
                    a_stack[slot].zero_()
                    b_stack[slot].zero_()
                else:
                    a_stack[slot].copy_(torch.from_numpy(ab[0]))
                    b_stack[slot].copy_(torch.from_numpy(ab[1]))
            self._seq += 1
            self._by_id[adapter_id] = _Entry(adapter_id, want, slot,
                                             a_rank, alpha, self._seq)
            self.loads += 1
            return slot

    def _free_slot(self) -> int:
        used = {e.slot for e in self._by_id.values()}
        for s in range(1, self.slots + 1):
            if s not in used:
                return s
        victim = min((e for e in self._by_id.values() if e.pins == 0),
                     key=lambda e: e.last_use, default=None)
        if victim is None:
            raise AdapterPoolFull(
                f"all {self.slots} adapter slots pinned; cannot evict")
        self._evict(victim)
        return victim.slot

    @torch.no_grad()
    def _evict(self, ent: _Entry) -> None:
        del self._by_id[ent.adapter_id]
        for targets in self._stacks.values():
            for a_stack, b_stack in targets.values():
                a_stack[ent.slot].zero_()
                b_stack[ent.slot].zero_()
        self.evictions += 1

    def unload(self, adapter_id: str) -> None:
        """Explicit eviction. Refuses while pinned — in-flight rows hold the
        slot exactly like in-flight requests hold KV blocks."""
        with self._lock:
            ent = self._require(adapter_id)
            if ent.pins:
                raise AdapterError(
                    f"adapter {adapter_id!r} has {ent.pins} in-flight pins; "
                    f"refusing unload")
            self._evict(ent)
            self.evictions -= 1   # explicit unload is not an LRU eviction

    # ----------------------------------------------------------- pin/unpin
    def pin(self, adapter_id: str) -> int:
        """Take a refcount on the adapter for one in-flight request; returns
        its slot. Raises :class:`UnknownAdapter` for an id the pool does not
        hold."""
        with self._lock:
            ent = self._require(adapter_id)
            ent.pins += 1
            self._seq += 1
            ent.last_use = self._seq
            self.pin_events += 1
            return ent.slot

    def unpin(self, adapter_id: str) -> None:
        with self._lock:
            ent = self._by_id.get(adapter_id)
            if ent is None:      # already unloaded after its last unpin: no-op
                return
            if ent.pins <= 0:
                raise AdapterError(f"unpin underflow for {adapter_id!r}")
            ent.pins -= 1

    def _require(self, adapter_id: str) -> _Entry:
        ent = self._by_id.get(adapter_id)
        if ent is None:
            raise UnknownAdapter(adapter_id, tuple(self._by_id))
        return ent

    # ------------------------------------------------------------- queries
    def has(self, adapter_id: str) -> bool:
        with self._lock:
            return adapter_id in self._by_id

    def slot_of(self, adapter_id: str) -> int:
        with self._lock:
            return self._require(adapter_id).slot

    def digest_of(self, adapter_id: str) -> str:
        with self._lock:
            return self._require(adapter_id).digest

    def salt_of(self, adapter_id: str) -> bytes:
        """Prefix-cache salt: the digest bytes. Seeding the chain hash with
        this makes two tenants' identical prompts hash to DISJOINT chains —
        cross-adapter KV reuse is structurally impossible."""
        return bytes.fromhex(self.digest_of(adapter_id))

    def pins_of(self, adapter_id: str) -> int:
        with self._lock:
            return self._require(adapter_id).pins

    def loaded(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._by_id))

    def lru_order(self) -> tuple[str, ...]:
        """Resident ids, least-recently-used first (the eviction order for
        unpinned adapters) — a test hook."""
        with self._lock:
            return tuple(e.adapter_id for e in
                         sorted(self._by_id.values(),
                                key=lambda e: e.last_use))

    def stacks(self):
        """The device stacks to pass (with a per-row index vector) into the
        serving forwards. Shapes are fixed for the pool's lifetime —
        adapter churn swaps CONTENTS, never shapes."""
        with self._lock:
            return self._stacks

    def gauges(self) -> dict[str, float]:
        with self._lock:
            pinned = sum(1 for e in self._by_id.values() if e.pins)
            return {
                "serve.adapter.slots_total": float(self.slots),
                "serve.adapter.slots_used": float(len(self._by_id)),
                "serve.adapter.slots_pinned": float(pinned),
                "serve.adapter.pins_inflight": float(
                    sum(e.pins for e in self._by_id.values())),
            }

    def view(self) -> dict:
        """JSON-able state for a stats view and the adapter admin
        response."""
        with self._lock:
            return {
                "slots": self.slots,
                "rank": self.rank,
                "loads": self.loads,
                "evictions": self.evictions,
                "adapters": {
                    e.adapter_id: {"slot": e.slot, "pins": e.pins,
                                   "digest": e.digest, "rank": e.rank,
                                   "alpha": e.alpha}
                    for e in self._by_id.values()},
            }


def _pad_rank(arr: np.ndarray, rank: int, axis: int) -> np.ndarray:
    have = arr.shape[axis]
    if have == rank:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis if axis >= 0 else arr.ndim + axis] = (0, rank - have)
    return np.pad(arr, pad)


def _infer_rank(adapter: Mapping) -> int:
    for targets in adapter.values():
        for leaf in targets.values():
            return int(_leaf_numpy(leaf["lora_a"]).shape[-1])
    raise ValueError("empty adapter tree")
