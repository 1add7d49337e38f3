"""The rate and tail arithmetic: all the work over the whole window, and
the tail over every request sent in it, failures counted."""

import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest

from benchmark.lib import traffic


@pytest.mark.parametrize("n", [1, 2, 7, 100, 401])
def test_percentile_is_numpys_linear_rule(n):
    v = np.random.default_rng(n).exponential(1.0, n)
    for q in (50, 95, 99):
        assert traffic.percentile(list(v), q) == pytest.approx(
            np.percentile(v, q))


def _record(sent, first, done, in_window=True, failed=None):
    r = traffic.Record(0, sent, 4, in_window)
    r.first, r.done, r.failed = first, done, failed
    return r


def test_serve_e2e_counts_failures_and_the_whole_window():
    recs = [_record(0.0, 0.1 * (i + 1), 1.0) for i in range(19)]
    # a failed request that never gave a token: its whole wait counts
    recs.append(_record(0.0, None, 30.0, failed="never"))
    # sent before the window: not in its tail
    recs.append(_record(-5.0, 100.0, 101.0, in_window=False))
    out = traffic.serve_e2e(recs, delivered=500, window_s=20.0)
    assert out["serve_tokens_per_s"] == 25.0
    ttft = [0.1 * (i + 1) for i in range(19)] + [30.0]
    assert out["ttft_p95_ms"] == pytest.approx(
        np.percentile(ttft, 95) * 1e3)
    assert out["ttft_p95_ms"] > 1900          # the failure moved the tail


def test_requests_share_sizes_across_seeds():
    mix = {"clients": 4, "requests": 64, "size_block": 16, "sizes_seed": 3,
           "prompt_tokens": {"median": 100, "sigma": 0.8, "min": 10,
                             "max": 400},
           "output_tokens": {"median": 20, "sigma": 0.5, "min": 4,
                             "max": 64}}
    a, b = traffic.Requests(mix, 1000, 1), traffic.Requests(mix, 1000, 2**33)
    for k in range(0, 64, 16):           # each block: the same sizes
        assert sorted(a.prompt_len[k:k + 16]) == sorted(b.prompt_len[k:k + 16])
        assert sorted(a.out_len[k:k + 16]) == sorted(b.out_len[k:k + 16])
    assert list(a.prompt_len) != list(b.prompt_len)
    assert a.prompt_len.min() >= 10 and a.prompt_len.max() <= 400
    assert [len(p) for p in a.prompts] == list(a.prompt_len)


class _FakeEngine:
    """Answers after ``delay`` seconds on its own thread; every fifth
    request fails."""

    def __init__(self, delay):
        self.delay, self.n = delay, 0

    def submit(self, prompt, n_out, on_token):
        fut = cf.Future()
        self.n += 1
        fail = self.n % 5 == 0

        def work():
            time.sleep(self.delay)
            if fail:
                fut.set_exception(RuntimeError("boom"))
                return
            for i in range(n_out):
                on_token(i, 7)

            class R:
                tokens = np.full(n_out, 7, np.int32)

            fut.set_result(R())

        threading.Thread(target=work, daemon=True).start()
        return fut


def test_closed_loop_keeps_its_clients_busy():
    mix = {"clients": 4, "requests": 512,
           "size_block": 8, "sizes_seed": 1,
           "prompt_tokens": {"median": 8, "sigma": 0.1, "min": 4, "max": 16},
           "output_tokens": {"median": 3, "sigma": 0.1, "min": 2, "max": 4}}
    reqs = traffic.Requests(mix, 100, 5)
    eng = _FakeEngine(0.01)
    pool = traffic.ClientPool(mix, reqs, eng.submit)
    pool.start()
    assert len(pool.inflight) == 4
    t0 = time.perf_counter()
    pool.run_until(t0 + 0.3, t0)
    assert len(pool.inflight) == 4             # each client always has one
    pool.drain(10.0)
    mine = [r for r in pool.records if r.in_window]
    assert len(mine) > 10
    assert any(r.failed for r in mine)
    done = [r for r in mine if not r.failed]
    assert all(len(r.tokens) == r.n_out for r in done)
    assert pool.delivered == sum(len(r.stamps) for r in pool.records)
