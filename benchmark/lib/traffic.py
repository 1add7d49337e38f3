"""Traffic from the seed: the training tables and the serving client pool.

Training cells read a seeded table through the program's loader: a
``raw_u8`` table of random images with random labels, or a ``tokens_i32``
table of random token rows, written under the run's temporary directory.

Serving cells draw their requests from a mix file. A block of
``size_block`` (prompt length, output length) pairs comes from the mix's
own ``sizes_seed``; every run serves that block over and over, each pass in
an order drawn from the run's seed, which also draws the token ids. The
clients are a closed loop: each of ``clients`` sends its next request when
the previous one completes. The arithmetic follows the repository's
``tools/load_gen.py`` (log-normal lengths clipped to a range).
"""

from __future__ import annotations

import hashlib
import math
import time

import numpy as np

from benchmark.lib.weights import sub_seed


def image_table(store_root: str, n: int, size: int, classes: int, seed: int,
                device):
    """A ``raw_u8`` table of ``n`` ``size``-square RGB images of uniform
    noise with random labels, drawn on ``device``. Returns ``(table,
    images [n, size, size, 3] uint8, labels [n])`` on the host."""
    import torch

    from ddw_tpu_torch.data.store import Record, TableStore

    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "images"))
    lab = torch.randint(0, classes, (n,), generator=g, device=device)
    images = torch.randint(0, 256, (n, size, size, 3), generator=g,
                           device=device, dtype=torch.uint8).cpu().numpy()
    labels = lab.to(torch.int32).cpu().numpy()
    meta = {"encoding": "raw_u8", "height": size, "width": size}
    table = TableStore(store_root).write(
        "train", (Record(f"img/{i:06d}", images[i].tobytes(), "",
                         int(labels[i])) for i in range(n)),
        shard_size=256, meta=meta)
    return table, images, labels


def token_table(store_root: str, rows: int, seq: int, vocab: int, seed: int):
    """A ``tokens_i32`` table of ``rows`` random rows of ``seq + 1`` token
    ids; returns ``(table, tokens [rows, seq + 1] int32)``."""
    from ddw_tpu_torch.data.prep import write_token_table
    from ddw_tpu_torch.data.store import TableStore

    rng = np.random.default_rng(sub_seed(seed, "tokens"))
    tokens = rng.integers(0, vocab, (rows, seq + 1), dtype=np.int32)
    return write_token_table(TableStore(store_root), "train", tokens), tokens


def row_key(row: np.ndarray) -> bytes:
    """A digest of one row's bytes, to find a batch row in its table."""
    return hashlib.blake2b(np.ascontiguousarray(row).tobytes(),
                           digest_size=16).digest()


def _lognormal_ints(rng, n: int, spec: dict) -> np.ndarray:
    v = rng.lognormal(math.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)


class Requests:
    """The requests of one run, in the order clients take them."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        sizes = np.random.default_rng(mix["sizes_seed"])
        block, n = mix["size_block"], mix["requests"]
        prompt = _lognormal_ints(sizes, block, mix["prompt_tokens"])
        out = _lognormal_ints(sizes, block, mix["output_tokens"])
        # every run takes the same block of sizes over and over, each time
        # in another order drawn from its seed
        rng = np.random.default_rng(sub_seed(seed, "order"))
        order = np.concatenate([rng.permutation(block)
                                for _ in range(-(-n // block))])[:n]
        self.prompt_len, self.out_len = prompt[order], out[order]
        rng = np.random.default_rng(sub_seed(seed, "prompts"))
        self.prompts = [rng.integers(0, vocab, int(p), dtype=np.int32)
                        for p in self.prompt_len]
        self.n = n
        # each client's first request stops after a share of its output, so
        # that completions are spread from the start: the same evenly spaced
        # shares in every run, in an order drawn from the seed
        k = mix["clients"]
        shares = (np.arange(k) + 0.5) / k
        rng = np.random.default_rng(sub_seed(seed, "ramp"))
        self.ramp_share = np.resize(rng.permutation(shares), n)


class Record:
    """One request as the client saw it (host perf_counter seconds)."""

    __slots__ = ("i", "sent", "first", "done", "tokens", "stamps", "n_out",
                 "failed", "late", "in_window")

    def __init__(self, i: int, sent: float, n_out: int, in_window: bool):
        self.i, self.sent = i, sent
        self.first = self.done = None
        self.tokens: list[int] = []
        self.stamps: list[float] = []     # when each token was delivered
        self.n_out, self.failed, self.in_window = n_out, None, in_window
        self.late = False           # still answering when the wait ended

    @property
    def ttft_s(self) -> float:
        """Sent to first token; a request that never gave one counts with
        its whole wait, so it misses any tail it falls in."""
        end = self.first if self.first is not None else self.done
        return end - self.sent


class ClientPool:
    """Drives ``submit(prompt, n_out, on_token) -> future`` from the
    driver's thread. Token callbacks come from the engine's thread; they
    stamp the first token and count every token delivered."""

    def __init__(self, mix: dict, reqs: Requests, submit):
        self.mix, self.reqs, self.submit = mix, reqs, submit
        self.records: list[Record] = []
        self.delivered = 0
        self.next = 0
        self.inflight: dict = {}

    def _send(self, in_window: bool, ramp: bool) -> None:
        i = self.next
        if i >= self.reqs.n:
            raise RuntimeError(f"the mix's {self.reqs.n} requests ran out")
        self.next += 1
        n_out = int(self.reqs.out_len[i])
        if ramp:
            n_out = max(1, int(math.ceil(n_out * self.reqs.ramp_share[i])))
        rec = Record(i, time.perf_counter(), n_out, in_window)

        def on_token(index, token, rec=rec):
            now = time.perf_counter()
            if index == 0:
                rec.first = now
            rec.stamps.append(now)
            self.delivered += 1

        try:
            fut = self.submit(self.reqs.prompts[i], n_out, on_token)
        except Exception as e:           # refused at submission: a failure
            rec.failed, rec.done = repr(e), time.perf_counter()
            self.records.append(rec)
            return
        self.records.append(rec)
        self.inflight[fut] = rec

    def start(self) -> None:
        """Every client sends its first request (ramp requests,
        shortened)."""
        for _ in range(self.mix["clients"]):
            self._send(False, True)

    def _reap(self, done) -> int:
        import concurrent.futures as cf

        finished = 0
        for fut in done:
            rec = self.inflight.pop(fut)
            rec.done = time.perf_counter()
            try:
                res = fut.result()
                rec.tokens = [int(t) for t in res.tokens]
            except (cf.CancelledError, Exception) as e:
                rec.failed = repr(e)
            finished += 1
        return finished

    def run_until(self, t_end: float, window_open: float | None) -> None:
        """Keep the load on until ``t_end``: requests sent at or after
        ``window_open`` belong to the window."""
        import concurrent.futures as cf

        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            if not self.inflight:
                time.sleep(min(t_end - now, 0.01))
                continue
            done, _ = cf.wait(list(self.inflight), timeout=t_end - now,
                              return_when=cf.FIRST_COMPLETED)
            n = self._reap(done)
            now = time.perf_counter()
            for _ in range(n):
                if now < t_end:
                    self._send(window_open is not None and now >= window_open,
                               False)

    def drain(self, timeout_s: float) -> None:
        """Wait for every request in flight, at most ``timeout_s``; those
        still answering then are late, not failed, and leave the check's
        sample."""
        import concurrent.futures as cf

        done, _ = cf.wait(list(self.inflight), timeout=timeout_s)
        self._reap(done)
        for rec in self.inflight.values():
            rec.late, rec.done = True, time.perf_counter()
        self.inflight.clear()


def percentile(values, q: float) -> float:
    """The ``q``-th percentile with linear interpolation between order
    statistics (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def serve_e2e(records: list, delivered: int, window_s: float) -> dict:
    """The tokens delivered in the window over its length, and the 95th
    percentile of time to first token over every request sent in it,
    failures included."""
    out = {"serve_tokens_per_s": delivered / window_s}
    mine = [r for r in records if r.in_window]
    if mine:
        out["ttft_p95_ms"] = percentile([r.ttft_s for r in mine], 95) * 1e3
    return out
