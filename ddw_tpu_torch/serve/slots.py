"""Slot-based KV-cache pool — the port of ``ddw_tpu.serve.slots``, the
contiguous baseline of continuous batching (``EngineCfg(paged=False)``).

The pool owns ONE slot-mode cache (:func:`~ddw_tpu_torch.models.lm.
init_slot_cache`) whose batch dim is ``n_slots`` serving slots, each row at
its own depth, and three operations over it:

- **prefill**: one bucketed causal forward of a group of new requests'
  prompts into a fresh contiguous cache, which also picks each request's
  first token;
- **insert**: copy one row of that cache into pool row ``slot``, its
  indices snapped to the TRUE prompt length so decode overwrites the pad;
- **decode**: advance every slot ``steps_per_tick`` tokens, the picks kept
  on the device until the chain's one fetch. The pool cache is updated in
  place (where ``ddw_tpu`` donates it).

Masking is per row, so a slot admitted mid-flight neither stalls nor
perturbs its neighbours. Free slots keep decoding a dummy token; released
rows are index-reset to 0 so they never force extra tiles for live rows.

Picks: greedy rows take the raw argmax; sampled rows draw a Gumbel-max
categorical with one generator per request and step, seeded from the
request's own ``torch.Generator`` (``serve/engine.py``), so seeded sampling
is reproducible inside the port (the draws are not JAX's).
"""

from __future__ import annotations

import numpy as np
import torch

from ddw_tpu_torch.models.lm import (TransformerLM, host_to_device,
                                     init_cache, init_slot_cache)


def _pick(logits: torch.Tensor, temperatures, keys) -> torch.Tensor:
    """Next-token picks over ``logits [G, V]`` (f32): greedy rows
    (temperature 0) the raw argmax — bit for bit the greedy branch of
    :func:`ddw_tpu_torch.models.lm.generate` — sampled rows divide by their
    temperature and draw a Gumbel-max categorical from a generator seeded
    with the row's step key (an int). Returns ``[G]`` on the device."""
    out = logits.argmax(-1)
    temps = np.asarray(temperatures, np.float64)
    for i in np.flatnonzero(temps > 0):
        gen = torch.Generator(device=logits.device).manual_seed(
            int(keys[i]))
        u = torch.rand(logits.shape[-1], generator=gen,
                       device=logits.device)
        u = u.clamp(torch.finfo(torch.float32).tiny, 1.0)
        row = logits[i].to(torch.float32) / float(temps[i])
        out[i] = (row - torch.log(-torch.log(u))).argmax()
    return out


class SlotPool:
    """Fixed-capacity continuous-batching cache pool over a
    :class:`~ddw_tpu_torch.models.lm.TransformerLM` (weights loaded, on its
    device)."""

    def __init__(self, model: TransformerLM, n_slots: int,
                 steps_per_tick: int = 4):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if steps_per_tick < 1:
            raise ValueError(
                f"steps_per_tick must be >= 1, got {steps_per_tick}")
        self.n_slots = n_slots
        self.steps_per_tick = steps_per_tick
        self.max_len = model.max_len
        self.model = model
        self.device = model.head.kernel.device
        self.cache = init_slot_cache(model, n_slots)
        self._free = list(range(n_slots - 1, -1, -1))  # pop() -> slot 0 first

    # -- slot bookkeeping ---------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        """Claim a free slot id; raises when the pool is full (the engine
        checks ``free_slots`` first — admission control lives above)."""
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        return self._free.pop()

    def release(self, slot: int) -> None:
        """Return ``slot`` to the pool and reset its row indices to 0 — a
        parked row at depth 0 masks every attention tile, so finished
        requests stop contributing to live rows' tile count."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        self._set_depth(slot, 0)
        self._free.append(slot)

    def _set_depth(self, slot: int, depth: int) -> None:
        self.cache["pos_index"][slot] = depth
        for key, layer in self.cache.items():
            if key != "pos_index":
                layer["attn"]["cache_index"][slot] = depth

    def reset(self) -> None:
        """Fresh state after an engine failure: a crash mid-decode can
        leave rows whose indices describe no live request. Re-init the cache
        and free every slot."""
        self.cache = init_slot_cache(self.model, self.n_slots)
        self._free = list(range(self.n_slots - 1, -1, -1))

    @torch.no_grad()
    def warmup(self, buckets) -> None:
        """Run every program shape the given prompt-length buckets need
        once: one prefill per (bucket, power-of-two group size up to
        n_slots), one insert per group size, the decode chain. Leaves the
        pool state as it was (indices snap back to 0)."""
        buckets = sorted(set(buckets))
        for bucket in buckets:
            g = 1
            while g <= self.n_slots:
                cache_g, _ = self.prefill(np.zeros((g, bucket), np.int32),
                                          np.ones((g,), np.int32),
                                          np.zeros((g,), np.float32),
                                          np.zeros((g,), np.int64))
                if bucket == buckets[0]:
                    slot = self.acquire()
                    self.insert(slot, cache_g, 1, row=0)
                    self.release(slot)
                g *= 2
        self.decode(np.zeros((self.n_slots,), np.int32),
                    np.zeros((self.n_slots,), np.float32),
                    np.zeros((self.n_slots, self.steps_per_tick), np.int64))
        for slot in range(self.n_slots):
            self._set_depth(slot, 0)

    # -- device work --------------------------------------------------------
    @torch.no_grad()
    def prefill(self, padded_prompts, true_lens, temperatures, keys) -> tuple:
        """Run a GROUP of new requests' bucketed prompts through the decode
        mode in one forward: ``padded_prompts [G, L]`` (one length bucket),
        per-row ``true_lens [G]`` / ``temperatures [G]`` / step-0 ``keys
        [G]``. Returns ``(prefill_cache, first_tokens [G])`` (host); row g
        splices into the pool via :meth:`insert`; dummy pad rows are never
        inserted."""
        padded_prompts = np.asarray(padded_prompts, np.int64)
        if padded_prompts.ndim != 2:
            raise ValueError(
                f"prefill expects [G, L] prompts, got {padded_prompts.shape}")
        g = padded_prompts.shape[0]
        cache = init_cache(self.model, g)
        logits = self.model(host_to_device(padded_prompts, self.device),
                            cache=cache)
        idx = host_to_device(np.asarray(true_lens, np.int64) - 1,
                             self.device)
        last = logits[torch.arange(g, device=self.device), idx]
        toks = _pick(last, temperatures, keys)
        return cache, toks.cpu().numpy().astype(np.int32)

    def insert(self, slot: int, prefill_cache: dict, true_len: int,
               row: int = 0) -> None:
        """Copy row ``row`` of a (group) prefill cache into pool row
        ``slot`` with its indices snapped to the true prompt length."""
        for key, layer in self.cache.items():
            if key == "pos_index":
                continue
            src = prefill_cache[key]["attn"]
            for leaf in ("cached_key", "cached_value"):
                layer["attn"][leaf][slot].copy_(src[leaf][row])
        self._set_depth(slot, true_len)

    @torch.no_grad()
    def decode(self, tokens, temperatures, keys) -> np.ndarray:
        """Advance EVERY slot ``steps_per_tick`` tokens. ``tokens [S]`` is
        each slot's current token, ``temperatures [S]`` per slot (0 =
        greedy), ``keys [S, k]`` per-slot per-step sample keys (ignored for
        greedy rows). Returns the ``[S, k]`` token block (host); the pool
        cache advances in place."""
        tok = host_to_device(tokens, self.device)
        keys = np.asarray(keys)
        out = []
        for j in range(self.steps_per_tick):
            logits = self.model(tok[:, None], cache=self.cache)
            tok = _pick(logits[:, 0], temperatures, keys[:, j])
            out.append(tok)
        return torch.stack(out, 1).cpu().numpy().astype(np.int32)
