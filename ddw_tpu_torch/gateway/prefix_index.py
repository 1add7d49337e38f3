"""Fleet-wide prefix-cache index — who holds which prompt prefix warm.

The chain-hashed prefix cache is per-engine: each
:class:`~ddw_tpu_torch.serve.blocks.BlockPool` knows which prompt blocks IT
holds, so an N-replica fleet re-prefills the same system prompt N times —
O(fleet) prefill work for what is one cached computation. This module is
the control-plane half of closing that gap: a content-hash index over
:class:`~ddw_tpu_torch.gateway.ReplicaSet` members mapping the SAME per-block
chain hashes the pools compute (:func:`chain_hash_hexes` reproduces them
bit-for-bit) to the replica slots holding them warm.

The index is fed by the pools' register/evict event logs
(:meth:`~ddw_tpu_torch.serve.blocks.BlockPool.prefix_events`), pulled through a
duck-typed ``prefix_events(since)`` on each replica — a direct method call
for in-thread engines, one HTTP delta fetch (``GET /v1/prefix/events``)
relayed by :class:`~ddw_tpu_torch.deploy.ProcessReplica` for child processes.
Polling is rate-limited per replica and driven from the routing path
itself, so the index is freshest exactly when traffic is flowing. The
seq/reset protocol makes holder loss self-healing: a pool that restarted
(or compacted past the poller) answers with a full snapshot and ``reset``
set, and the index simply replaces everything it believed about that slot.

Two consumers:

- **cache-aware routing** (:meth:`~ddw_tpu_torch.gateway.ReplicaSet._order`):
  :meth:`PrefixIndex.match` returns each replica's longest cached prefix
  for a prompt; the router credits the expected prefill savings (matched
  tokens x the replica's per-prefilled-token EWMA) against its projected
  wait, so requests chase their prefix only while the holder's queue
  stays cheaper than a cold prefill elsewhere;
- **warm replay** (:meth:`~ddw_tpu_torch.gateway.ReplicaSupervisor.recycle`):
  the index retains the TOKEN prefixes behind its keys (even after the
  last holder died), so a recycled/deployed replica re-warms by replaying
  the top-K hot prefixes through its normal prefill path — bit-identical
  by construction, no KV shipping.

The port of ``ddw_tpu.gateway.prefix_index``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np

__all__ = ["PrefixIndex", "chain_hash_hexes"]


def chain_hash_hexes(tokens, block_size: int, salt: bytes = b"") -> list[str]:
    """Per-full-block chain hashes of ``tokens``, hex-encoded — the exact
    keys :meth:`BlockPool._chain_hashes` computes (SHA1 over the previous
    digest + the block's int32 token bytes), so index lookups and pool
    registrations can never disagree about what a prefix is. ``salt``
    seeds the chain exactly as the pool's adapter salting does (the
    adapter digest bytes): salted and unsalted chains over the same
    tokens share no keys, so adapter-tagged lookups can only ever match
    blocks prefilled under the SAME adapter."""
    arr = np.asarray(tokens, np.int32).reshape(-1)
    out, h = [], bytes(salt)
    for j in range(len(arr) // block_size):
        h = hashlib.sha1(
            h + arr[j * block_size:(j + 1) * block_size].tobytes()).digest()
        out.append(h.hex())
    return out


class PrefixIndex:
    """Content-hash prefix index over a replica fleet.

    Thread-safe; all methods may be called from routing, supervisor, and
    HTTP threads concurrently. Replica identity is the ReplicaSet SLOT
    (list position) — stable across restarts and replacement, which is
    exactly the identity routing decisions need.
    """

    MAX_KEYS = 4096               # coldest keys drop past this bound

    def __init__(self, hot_k: int = 8, poll_interval_s: float = 0.2):
        self.hot_k = hot_k
        self.poll_interval_s = poll_interval_s
        self._lock = threading.Lock()
        self._holders: dict[str, set[int]] = {}    # key -> replica slots
        self._tokens: dict[str, list[int]] = {}    # key -> token prefix
        self._hits: dict[str, int] = {}            # routing-time matches
        self._recency: dict[str, int] = {}         # key -> last-touch tick
        self._touch = 0
        self._block_size = 0      # learned from the feed: the shortest
        #                           registered prefix IS one block
        self._seq: dict[int, int] = {}             # slot -> last feed seq
        self._last_poll: dict[int, float] = {}

    # -- feed -----------------------------------------------------------------
    def poll(self, replicas) -> None:
        """Pull each replica's register/evict delta feed (duck-typed
        ``prefix_events(since)``; replicas without one stay invisible).
        Rate-limited per slot so the routing path can call this on every
        request — process replicas answer over HTTP."""
        now = time.monotonic()
        for slot, eng in enumerate(list(replicas)):
            fetch = getattr(eng, "prefix_events", None)
            if fetch is None:
                continue
            with self._lock:
                if now - self._last_poll.get(slot, -1e9) \
                        < self.poll_interval_s:
                    continue
                self._last_poll[slot] = now
                since = self._seq.get(slot, 0)
            try:
                feed = fetch(since)
            except Exception:
                continue            # unreachable replica: stale is fine
            if feed:
                self.observe(slot, feed)

    def observe(self, slot: int, feed: dict) -> None:
        """Apply one replica's feed (``{"seq", "reset", "events"}``).
        ``reset`` drops everything believed about the slot first — the
        pool restarted under the poller, or compacted past it."""
        with self._lock:
            if feed.get("reset"):
                for holders in self._holders.values():
                    holders.discard(slot)
            for ev in feed.get("events", ()):
                kind, key = ev[0], ev[1]
                toks = ev[2] if len(ev) > 2 else None
                if kind == "register":
                    self._holders.setdefault(key, set()).add(slot)
                    if toks:
                        self._tokens[key] = [int(t) for t in toks]
                        if (not self._block_size
                                or len(toks) < self._block_size):
                            self._block_size = len(toks)
                    self._hits.setdefault(key, 0)
                    self._touch += 1
                    self._recency[key] = self._touch
                elif kind == "evict":
                    holders = self._holders.get(key)
                    if holders is not None:
                        holders.discard(slot)
                    # tokens/hits stay: a key every holder evicted is
                    # precisely what warm replay exists to restore
            self._seq[slot] = int(feed.get("seq", self._seq.get(slot, 0)))
            self._compact_locked()

    def drop_replica(self, slot: int) -> None:
        """Forget a slot's holdings (replica replaced/abandoned). Token
        prefixes are retained for warm replay."""
        with self._lock:
            for holders in self._holders.values():
                holders.discard(slot)
            self._seq.pop(slot, None)
            self._last_poll.pop(slot, None)

    def _compact_locked(self) -> None:
        over = len(self._tokens) - self.MAX_KEYS
        if over <= 0:
            return
        coldest = sorted(self._tokens,
                         key=lambda h: (self._hits.get(h, 0),
                                        self._recency.get(h, 0)))[:over]
        for key in coldest:
            self._tokens.pop(key, None)
            self._holders.pop(key, None)
            self._hits.pop(key, None)
            self._recency.pop(key, None)

    # -- consumers ------------------------------------------------------------
    def match(self, prompt, count_hit: bool = True,
              with_hashes: bool = False, salt: bytes = b""):
        """Longest cached prefix (tokens) of ``prompt`` per replica slot —
        empty until the feed has taught the index its block size. Matches
        are capped at ``len(prompt) - 1`` (the pool always prefills at
        least one real token, so savings can never exceed that). With
        ``count_hit`` the longest matched key is credited for the hot
        list.

        ``with_hashes`` returns ``(matches, hexes)`` instead, where
        ``hexes`` is the prompt's full-block chain-hash list (hex, block
        order) this match walked — the migration plane's transfer
        directory reads it to name warm blocks a receiver can skip, so
        router and directory hash each prompt ONCE per route instead of
        twice. ``hexes`` is ``[]`` when matching was impossible (no feed
        yet / prompt too short)."""
        with self._lock:
            bs = self._block_size
            have = bool(self._holders)
        p = int(np.asarray(prompt).reshape(-1).shape[0])
        if not bs or not have or p < 2:
            return ({}, []) if with_hashes else {}
        hexes = chain_hash_hexes(prompt, bs, salt)
        out: dict[int, int] = {}
        with self._lock:
            best = None
            for j in range(len(hexes), 0, -1):
                holders = self._holders.get(hexes[j - 1])
                if not holders:
                    continue
                if best is None:
                    best = hexes[j - 1]
                for slot in holders:
                    if slot not in out:
                        out[slot] = min(j * bs, p - 1)
            if best is not None and count_hit:
                self._hits[best] = self._hits.get(best, 0) + 1
                self._touch += 1
                self._recency[best] = self._touch
        return (out, hexes) if with_hashes else out

    @property
    def block_size(self) -> int:
        """The fleet's KV block size as learned from the feed (0 until
        the first registration arrives) — the unit ``match`` hashes in
        and the migration router converts token credits to block counts
        with."""
        with self._lock:
            return self._block_size

    def hot(self, k: int | None = None) -> list[list[int]]:
        """The top-K hottest prefixes as TOKEN lists, hottest first, each
        chain reduced to its longest retained prefix (replaying the long
        one re-registers every block under it). This is what a recycled
        replica replays through its normal prefill path to rejoin warm."""
        n = k if k is not None else self.hot_k
        with self._lock:
            cands = sorted(
                self._tokens.items(),
                key=lambda kv: (self._hits.get(kv[0], 0),
                                self._recency.get(kv[0], 0), len(kv[1])),
                reverse=True)
        chosen: list[list[int]] = []
        for _, toks in cands:
            if len(chosen) >= n:
                break
            if any(sel[:len(toks)] == toks for sel in chosen):
                continue        # covered by a hotter, longer prefix
            chosen.append(list(toks))
        return chosen

    def summary(self) -> dict:
        """The ``/stats`` view: key count, per-slot holdings, hot list."""
        with self._lock:
            per: dict[int, int] = {}
            for holders in self._holders.values():
                for slot in holders:
                    per[slot] = per.get(slot, 0) + 1
            hot = sorted(self._tokens,
                         key=lambda h: (self._hits.get(h, 0),
                                        self._recency.get(h, 0)),
                         reverse=True)[:self.hot_k]
            return {
                "keys": len(self._tokens),
                "block_size": self._block_size,
                "holders": {str(s): n for s, n in sorted(per.items())},
                "hot": [{"key": h[:12],
                         "tokens": len(self._tokens[h]),
                         "hits": self._hits.get(h, 0),
                         "holders": sorted(self._holders.get(h, ()))}
                        for h in hot],
            }
