"""The HTTP gateway of the PyTorch port (``ddw_tpu_torch.gateway``) on the
CPU, against ``ddw_tpu``'s gateway over the same weights (one package
``ddw_tpu`` wrote, loaded by both): a two-replica port ``Gateway`` gives,
unary and streaming, the greedy tokens of a two-replica JAX ``Gateway``
and of sequential ``generate``; each package's ``GatewayClient`` drives
the other's gateway to the same tokens; seeded sampling gives the same
tokens in-thread and over HTTP (and through relayed ``step_seeds``);
``/healthz``, ``/readyz``, ``/stats`` and ``/metrics`` carry ``ddw_tpu``'s
keys; 429 + ``Retry-After`` and 504 map as in ``ddw_tpu``; ``/v1/predict``
on the depthwise kernel's path (its plain version here) equals
``predict_logits``; the client honours ``Retry-After``; the router's
least-outstanding spill matches ``ddw_tpu``'s on scripted fakes; and a
SIGTERM drains the in-flight stream in full (last: draining is terminal).
Every gateway is stopped."""

import concurrent.futures
import http.client
import http.server
import inspect
import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ddw_tpu import gateway as jax_gateway
from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.runtime.launcher import Launcher as JaxLauncher
from ddw_tpu.serve import EngineCfg as JaxEngineCfg
from ddw_tpu.serve import Overloaded as JaxOverloaded
from ddw_tpu.serve import ServingEngine as JaxServingEngine
from ddw_tpu.serve.metrics import EngineMetrics as JaxEngineMetrics
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch import gateway
from ddw_tpu_torch.gateway import (Gateway, GatewayClient, GatewayDeadline,
                                   GatewayError, GatewayOverloaded,
                                   GatewayUnavailable, ReplicaSet,
                                   runtime_grace_s)
from ddw_tpu_torch.models.convert import to_flax_variables
from ddw_tpu_torch.models.layers import init_weights
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.ops.depthwise_conv import depthwise_conv3x3_cuda
from ddw_tpu_torch.serve import EngineCfg, Overloaded, ServingEngine
from ddw_tpu_torch.serve.lanes import item_generator
from ddw_tpu_torch.serve.metrics import EngineMetrics
from ddw_tpu_torch.serving.lm_package import LMPackagedModel
from ddw_tpu_torch.serving.package import PackagedModel, save_packaged_model
from ddw_tpu_torch.utils.config import ModelCfg

VOCAB = 64
CFG = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=2,
           mlp_dim=64, dropout=0.0, dtype="float32")
WAIT = 60
STEPS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pkg_dir(tmp_path_factory):
    cfg = JaxLMCfg(**CFG)
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(0)},
                                    np.zeros((1, 8), np.int32))["params"]
    return jax_lm_package.save_lm_package(
        str(tmp_path_factory.mktemp("gw_pkg") / "pkg"), cfg, params)


@pytest.fixture(scope="module")
def pm(pkg_dir):
    return LMPackagedModel(pkg_dir, device="cpu")


@pytest.fixture(scope="module")
def jpm(pkg_dir):
    return jax_lm_package.load_lm_package(pkg_dir)


@pytest.fixture(scope="module")
def gw(pm):
    """The port's shared gateway: two replicas, 2 slots each. The drain
    test (last in this file) drains it; stop() is idempotent."""
    g = Gateway([ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2,
                                                    steps_per_tick=2),
                               replica_id=i) for i in range(2)],
                grace_s=60.0)
    g.start(warmup_prompt_lens=(8, 16))
    yield g
    g.stop()


@pytest.fixture(scope="module")
def jgw(jpm):
    g = jax_gateway.Gateway(
        [JaxServingEngine(lm=jpm, cfg=JaxEngineCfg(n_slots=2,
                                                   steps_per_tick=2),
                          replica_id=i) for i in range(2)], grace_s=60.0)
    g.start(warmup_prompt_lens=(8, 16))
    yield g
    g.stop()


@pytest.fixture(scope="module")
def cli(gw):
    c = GatewayClient("127.0.0.1", gw.port)
    assert c.wait_ready(WAIT)
    return c


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


def _fan_out(client, prompts, steps, **kw):
    """Concurrent calls, even indices streamed; (results, streamed)."""
    results, streamed = {}, {i: [] for i in range(0, len(prompts), 2)}

    def call(i):
        stream = i % 2 == 0
        on_tok = ((lambda idx, t, i=i: streamed[i].append((idx, t)))
                  if stream else None)
        results[i] = client.generate(prompts[i], steps, stream=stream,
                                     on_token=on_tok, **kw)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    return results, streamed


def test_port_gateway_equals_jax_gateway_and_sequential(pm, jpm, gw, jgw,
                                                        cli):
    """Greedy tokens over the wire, unary and chunked streaming, from both
    two-replica gateways over the same weights, equal sequential generate
    of both packages; the streamed lines carry every token in order."""
    prompts = _prompts([3, 9, 14, 5, 21, 7], seed=1)
    refs = [jpm.generate(p[None], STEPS)[0] for p in prompts]
    assert all(np.array_equal(pm.generate(p[None], STEPS)[0], r)
               for p, r in zip(prompts, refs))
    got, streamed = _fan_out(cli, prompts, STEPS)
    jcli = jax_gateway.GatewayClient("127.0.0.1", jgw.port)
    assert jcli.wait_ready(WAIT)
    jgot, _ = _fan_out(jcli, prompts, STEPS)
    for i, ref in enumerate(refs):
        assert np.array_equal(got[i]["tokens"], ref), i
        assert np.array_equal(jgot[i]["tokens"], ref), i
        assert got[i]["total_ms"] >= got[i]["ttft_ms"] >= 0
    for i, seen in streamed.items():
        assert [idx for idx, _ in seen] == list(range(STEPS))
        assert [t for _, t in seen] == list(got[i]["tokens"])
    assert set(got[0]) == set(jgot[0])      # the same reply fields


def test_each_packages_client_drives_the_others_gateway(jpm, gw, jgw):
    prompts = _prompts([4, 11, 6, 17], seed=2)
    refs = [jpm.generate(p[None], STEPS)[0] for p in prompts]
    jax_on_port = jax_gateway.GatewayClient("127.0.0.1", gw.port)
    port_on_jax = GatewayClient("127.0.0.1", jgw.port)
    assert jax_on_port.wait_ready(WAIT) and port_on_jax.wait_ready(WAIT)
    a, _ = _fan_out(jax_on_port, prompts, STEPS)
    b, _ = _fan_out(port_on_jax, prompts, STEPS)
    for i, ref in enumerate(refs):
        assert np.array_equal(a[i]["tokens"], ref), i
        assert np.array_equal(b[i]["tokens"], ref), i
    assert jax_on_port.healthz()["status"] == "alive"
    assert port_on_jax.readyz()[0] == 200


def test_seeded_sampling_equal_in_thread_and_over_http(pm, gw, cli):
    """A seed samples the same tokens through an in-thread engine, over
    HTTP (unary and streaming), and from relayed per-step seeds; a batch
    job's item i samples item_generator(seed, i)'s tokens. A JAX
    ``key_data`` key is refused with a 400."""
    p = _prompts([9], seed=3)[0]
    with ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2,
                                            steps_per_tick=2)) as eng:
        ref = eng.generate(p, STEPS, temperature=0.8,
                           rng=torch.Generator().manual_seed(11)).tokens
        items = _prompts([5, 8, 3], seed=4)
        bref = [eng.submit_batch_item(x, 6, temperature=0.9,
                                      rng=item_generator(5, i))
                .result(timeout=WAIT).tokens for i, x in enumerate(items)]
    assert not np.array_equal(ref, pm.generate(p[None], STEPS)[0])
    for stream in (False, True):
        out = cli.generate(p, STEPS, temperature=0.8, seed=11,
                           stream=stream)
        assert np.array_equal(out["tokens"], ref), stream
    from ddw_tpu_torch.serve.engine import draw_step_seeds

    seeds = draw_step_seeds(torch.Generator().manual_seed(11), STEPS)
    out = cli.generate(p, STEPS, temperature=0.8, step_seeds=seeds)
    assert np.array_equal(out["tokens"], ref)
    job = cli._json_call("POST", "/v1/batch", {
        "kind": "generate", "items": [x.tolist() for x in items],
        "num_steps": 6, "temperature": 0.9, "seed": 5})
    deadline = time.monotonic() + WAIT
    while cli._json_call("GET", f"/v1/batch/{job['job_id']}")[
            "state"] != "done" and time.monotonic() < deadline:
        time.sleep(0.02)
    rows = cli.batch_results(job["job_id"])
    assert [r["tokens"] for r in rows] == [list(b) for b in bref]
    with pytest.raises(GatewayError) as ei:
        cli._json_call("POST", "/v1/generate", {
            "prompt": p.tolist(), "num_steps": 2, "temperature": 0.8,
            "key_data": [0, 11]})
    assert ei.value.status == 400 and "key_data" in ei.value.body["message"]


def test_endpoints_carry_the_jax_gateways_keys(gw, jgw, cli):
    """/healthz, /readyz, /stats and /metrics of the two gateways, after
    the same traffic, expose the same keys and metric names."""
    jcli = jax_gateway.GatewayClient("127.0.0.1", jgw.port)
    p = _prompts([6], seed=5)[0]
    for c in (cli, jcli):           # the same traffic on both: both lanes
        c.generate(p, 3)
        job = c._json_call("POST", "/v1/batch", {
            "kind": "generate", "items": [p.tolist()], "num_steps": 2})
        deadline = time.monotonic() + WAIT
        while c._json_call("GET", f"/v1/batch/{job['job_id']}")[
                "state"] != "done" and time.monotonic() < deadline:
            time.sleep(0.02)
    assert set(cli.healthz()) == set(jcli.healthz())
    (s1, r1), (s2, r2) = cli.readyz(), jcli.readyz()
    assert s1 == s2 == 200 and set(r1) == set(r2)
    st, jst = cli.stats(), jcli.stats()
    assert set(st) == set(jst)
    assert set(st["replica_health"][0]) == set(jst["replica_health"][0])
    for k in ("prefix_index", "supervisor", "deploy", "lanes"):
        assert set(st[k]) == set(jst[k]), k

    def names(text):
        return {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                if ln and not ln.startswith("#")}

    assert names(cli.metrics_text()) == names(jcli.metrics_text())
    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=10)
    conn.request("POST", "/v1/generate", body=b"{not json",
                 headers={"Content-Length": "9"})
    assert conn.getresponse().status == 400
    conn.close()
    with pytest.raises(GatewayError) as exc:
        cli._json_call("GET", "/nope")
    assert exc.value.status == 404


def test_429_maps_overloaded_and_504_maps_deadline(pm, monkeypatch):
    """``ddw_tpu``'s drill on the port: ``serve:stall`` holds the only
    slot mid-decode, so a queued short-deadline request is provably
    waiting when the full queue refuses the next one with 429 (the
    engine's ``retry_after_ms`` in the body, ``Retry-After`` in the
    header); clearing the stall sheds the queued one as 504 and the held
    stream finishes in full."""
    g = Gateway(ServingEngine(lm=pm, cfg=EngineCfg(
        n_slots=1, steps_per_tick=1, queue_depth=1)), grace_s=60.0,
        supervise=False)
    g.start(warmup_prompt_lens=(8,))
    try:
        raw = GatewayClient("127.0.0.1", g.port, max_retries=0)
        assert raw.wait_ready(WAIT)
        p = _prompts([5])[0]
        raw.generate(p, 2)
        monkeypatch.setenv("DDW_FAULT", "serve:stall:site=decode")
        box, first_tok = {}, threading.Event()
        t = threading.Thread(target=lambda: box.update(r=raw.generate(
            p, 80, stream=True, on_token=lambda i, tok: first_tok.set())))
        t.start()
        assert first_tok.wait(WAIT)
        shed_box = {}

        def shed_probe():
            try:
                shed_box["r"] = raw.generate(p, 2, timeout_s=0.01)
            except GatewayDeadline as e:
                shed_box["exc"] = e

        shed = threading.Thread(target=shed_probe)
        shed.start()
        deadline = time.monotonic() + WAIT
        eng = g.replica_set.replicas[0]
        while eng._ctrl.depth("lm") < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        with pytest.raises(GatewayOverloaded) as exc:
            raw.generate(p, 2)
        body = exc.value.body
        assert body["error"] == "overloaded"
        assert body["capacity"] == 1 and body["depth"] == 1
        assert body["retry_after_ms"] > 0
        conn = http.client.HTTPConnection("127.0.0.1", g.port, timeout=10)
        data = json.dumps({"prompt": p.tolist(), "num_steps": 2}).encode()
        conn.request("POST", "/v1/generate", body=data,
                     headers={"Content-Length": str(len(data))})
        resp = conn.getresponse()
        assert resp.status == 429
        assert int(resp.getheader("Retry-After")) >= 1
        assert json.loads(resp.read())["error"] == "overloaded"
        conn.close()
        monkeypatch.delenv("DDW_FAULT")
        shed.join(timeout=WAIT)
        assert shed_box["exc"].body["error"] == "deadline_exceeded"
        assert shed_box["exc"].body["waited_ms"] >= 10.0
        t.join(timeout=WAIT)
        assert len(box["r"]["tokens"]) == 80
        snap = raw.stats()
        assert snap["serve.shed_overloaded"] >= 1.0
        assert snap["serve.shed_deadline"] >= 1.0
    finally:
        monkeypatch.delenv("DDW_FAULT", raising=False)
        g.stop()


def test_predict_route_on_the_depthwise_path_equals_predict_logits(
        tmp_path):
    """``/v1/predict`` and a ``/v1/batch`` predict job over a MobileNetV2
    package with ``dw_impl="pallas"``: on CPU tensors its depthwise layers
    take K1's plain version (no launch), and the logits over HTTP equal
    the package's own ``predict_logits``."""
    mcfg = ModelCfg(name="mobilenet_v2", num_classes=5, dropout=0.0,
                    dtype="float32", width_mult=0.35, dw_impl="pallas",
                    freeze_base=False)
    model = build_model(mcfg, (32, 32))
    init_weights(model, torch.Generator().manual_seed(0))
    v = to_flax_variables(model)
    d = save_packaged_model(str(tmp_path / "img"), mcfg,
                            [f"c{i}" for i in range(5)], v["params"],
                            v.get("batch_stats"), 32, 32)
    pkg = PackagedModel(d, device="cpu")
    imgs = np.random.RandomState(0).rand(5, 32, 32, 3).astype(
        np.float32) * 2 - 1
    ref = pkg.predict_logits(imgs)
    before = depthwise_conv3x3_cuda.launches
    g = Gateway(ServingEngine(image=pkg, cfg=EngineCfg(max_batch=4,
                                                       max_wait_ms=1.0)),
                grace_s=30.0)
    g.start(warmup_prompt_lens=())
    try:
        c = GatewayClient("127.0.0.1", g.port)
        assert c.wait_ready(WAIT)
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda x: c.predict(
                x.tolist(), return_logits=True), imgs))
        got = np.asarray([o["logits"] for o in outs], np.float32)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        assert [o["label"] for o in outs] == pkg.predict(imgs)
        job = c._json_call("POST", "/v1/batch", {
            "kind": "predict", "items": [x.tolist() for x in imgs[:2]]})
        deadline = time.monotonic() + WAIT
        while c._json_call("GET", f"/v1/batch/{job['job_id']}")[
                "state"] != "done" and time.monotonic() < deadline:
            time.sleep(0.02)
        rows = c.batch_results(job["job_id"])
        assert [r["class_index"] for r in rows] == \
            [int(i) for i in ref[:2].argmax(-1)]
        assert [r["label"] for r in rows] == pkg.predict(imgs[:2])
    finally:
        g.stop()
    assert depthwise_conv3x3_cuda.launches == before


def test_grace_window_equals_the_jax_launchers_default():
    from ddw_tpu_torch.runtime.launcher import Launcher

    want = inspect.signature(JaxLauncher.__init__).parameters[
        "preempt_grace_s"].default
    port = inspect.signature(Launcher.__init__).parameters[
        "preempt_grace_s"].default
    assert port == runtime_grace_s() == want
    assert runtime_grace_s() == jax_gateway.runtime_grace_s()
    assert set(gateway.__all__ if hasattr(gateway, "__all__") else ()) \
        <= set(dir(gateway))
    for name in ("Gateway", "GatewayClient", "ReplicaSet",
                 "ReplicaSupervisor", "PrefixIndex", "ServerLifecycle",
                 "CircuitBreaker", "chain_hash_hexes"):
        assert hasattr(gateway, name) and hasattr(jax_gateway, name), name


def test_client_backoff_honors_retry_after():
    """A scripted stub answers 429 twice — first with the body's
    ``retry_after_ms``, then with only the header — and the port's client
    waits out each in turn; a 504 is never retried."""
    script = [
        (429, {"Retry-After": "9"}, {"error": "overloaded",
                                     "retry_after_ms": 150.0}),
        (429, {"Retry-After": "1"}, {"error": "overloaded"}),
        (200, {}, {"tokens": [7], "queue_ms": 0.0}),
    ]
    arrivals = []

    class Stub(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            arrivals.append(time.monotonic())
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            status, headers, body = script[min(len(arrivals) - 1,
                                               len(script) - 1)]
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = GatewayClient("127.0.0.1", srv.server_address[1], max_retries=3)
        out = c.generate([1, 2, 3], 1)
        assert out["tokens"] == [7] and c.retries == 2
        gap1 = arrivals[1] - arrivals[0]
        gap2 = arrivals[2] - arrivals[1]
        assert 0.15 <= gap1 < 1.0, gap1
        assert 1.0 <= gap2 < 3.0, gap2
        script[:] = [(504, {}, {"error": "deadline_exceeded"})]
        arrivals.clear()
        with pytest.raises(GatewayDeadline):
            c.generate([1], 1)
        assert len(arrivals) == 1
    finally:
        srv.shutdown()
        srv.server_close()


class _FakeEngine:
    def __init__(self, metrics_cls, overloaded, refuse=0):
        self.refuse, self.calls, self.futures = refuse, 0, []
        self.metrics = metrics_cls()
        self._overloaded = overloaded

    def start(self):
        return self

    def stop(self):
        pass

    def warmup(self, *a, **kw):
        pass

    def submit_generate(self, prompt, num_steps, **kw):
        self.calls += 1
        if self.refuse > 0:
            self.refuse -= 1
            raise self._overloaded("lm", 1, 1, retry_after_ms=42.0)
        f = concurrent.futures.Future()
        self.futures.append(f)
        return f


def _routing_trace(rs_cls, metrics_cls, overloaded):
    """Least-outstanding routing, the sideways spill and the full-fleet
    refusal on scripted fakes; returns what each step observed."""
    out = []
    a, b = (_FakeEngine(metrics_cls, overloaded),
            _FakeEngine(metrics_cls, overloaded))
    rs = rs_cls([a, b])
    f0 = rs.submit_generate([1], 1)
    rs.submit_generate([1], 1)
    rs.submit_generate([1], 1)
    out.append(((a.calls, b.calls), rs.outstanding()))
    f0.set_result(None)
    out.append(rs.outstanding())
    a2, b2 = (_FakeEngine(metrics_cls, overloaded, refuse=1),
              _FakeEngine(metrics_cls, overloaded))
    rs2 = rs_cls([a2, b2])
    fut = rs2.submit_generate([1], 1)
    out.append((fut in b2.futures, rs2.retried_429, rs2.outstanding()))
    snap = rs2.snapshot()
    out.append((snap["gateway.replicas"], snap["gateway.retried_429"]))
    rs3 = rs_cls([_FakeEngine(metrics_cls, overloaded, refuse=5),
                  _FakeEngine(metrics_cls, overloaded, refuse=5)])
    try:
        rs3.submit_generate([1], 1)
        out.append("served")
    except overloaded:
        out.append(("refused", rs3.outstanding()))
    return out


def test_routing_and_spill_equal_jax_on_scripted_fakes():
    got = _routing_trace(ReplicaSet, EngineMetrics, Overloaded)
    want = _routing_trace(jax_gateway.ReplicaSet, JaxEngineMetrics,
                          JaxOverloaded)
    assert got == want
    assert got[0] == ((2, 1), [2, 1]) and got[-1][0] == "refused"


# -- drain lifecycle (LAST: draining the module gateway is terminal) ---------

def test_sigterm_drains_inflight_and_refuses_new(pm, gw, cli):
    """A SIGTERM'd port gateway finishes the in-flight stream in full
    (token-identical) while refusing new work with 503, then stops."""
    gw.install_sigterm()
    prompt = _prompts([5], seed=4)[0]
    ref = pm.generate(prompt[None, :], 80)[0]
    seen, box = [], {}

    def long_req():
        box["r"] = cli.generate(prompt, 80, stream=True,
                                on_token=lambda i, t: seen.append(t))

    t = threading.Thread(target=long_req)
    t.start()
    deadline = time.monotonic() + WAIT
    while not seen and time.monotonic() < deadline:
        time.sleep(0.002)
    assert seen, "stream never started"
    port = gw.port
    os.kill(os.getpid(), signal.SIGTERM)
    raw = GatewayClient("127.0.0.1", port, max_retries=0)
    refused = status = None
    try:
        status, _body = raw.readyz()
        raw.generate(prompt, 2)
    except GatewayUnavailable as e:
        refused = e
    except OSError:
        refused = "closed"
    t.join(timeout=WAIT)
    assert np.array_equal(box["r"]["tokens"], ref)
    for _ in range(600):
        if gw.lifecycle.state == "stopped":
            break
        time.sleep(0.05)
    assert gw.lifecycle.state == "stopped"
    assert gw.drained_clean is True
    if isinstance(refused, GatewayUnavailable):
        assert refused.body["error"] == "unavailable"
        assert status in (200, 503)
    gw.lifecycle.restore_sigterm()
