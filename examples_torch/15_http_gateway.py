"""HTTP gateway: the serving engine behind a network front door (the port's
mirror of ``examples/15_http_gateway.py``).

Example 14 drives the continuous-batching engine from Python in the same
process; this example runs the full service shape end to end:

1. package a small TransformerLM, put TWO engine replicas behind a
   :class:`Gateway` (least-outstanding routing), warm the program lattice
   (readiness is gated on warmup), and fire concurrent requests through
   the :class:`GatewayClient` — half unary JSON, half chunked per-token
   streaming — every output verified token-identical to the sequential
   ``LMPackagedModel.generate`` path;
2. overload a tiny-queue gateway and catch the 429 backpressure reply
   (structured body + ``Retry-After``), then let the client's honoring
   backoff retry it to completion;
3. drain: SIGTERM the gateway while a long stream is in flight — the
   stream completes in full within the grace window, new requests get
   503, and the process stops clean;
4. print the fleet SLO snapshot and a slice of the Prometheus exposition.

    python examples_torch/15_http_gateway.py --quick --device cpu
    python examples_torch/15_http_gateway.py          # on the card
"""

import argparse
import os
import signal
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="lm.key=value")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ddw_tpu_torch.gateway import (Gateway, GatewayClient,
                                       GatewayOverloaded, ReplicaSet)
    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.serve import EngineCfg, ServingEngine
    from ddw_tpu_torch.serving.lm_package import (load_lm_package,
                                                  save_lm_package)
    from ddw_tpu_torch.utils.config import LMCfg, apply_overrides

    cfgs = {"lm": LMCfg(vocab_size=128, max_len=160, hidden=64, depth=2,
                        num_heads=4, mlp_dim=128, dropout=0.0,
                        dtype="float32")}
    apply_overrides(cfgs, args.overrides)
    cfg = cfgs["lm"]
    params = to_flax_variables(init_lm_weights(
        build_lm(cfg), torch.Generator().manual_seed(0)))["params"]
    workdir = args.workdir or tempfile.mkdtemp(prefix="ddw_http_gateway_")
    pm = load_lm_package(
        save_lm_package(os.path.join(workdir, "lm_pkg"), cfg, params),
        device=args.device)

    rng = np.random.RandomState(0)
    lens = [int(rng.randint(3, 24)) for _ in range(args.requests)]
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]
    refs = [pm.generate(p[None, :], args.steps)[0] for p in prompts]

    print(f"[1] {args.replicas}-replica fleet behind HTTP: "
          f"{args.requests} concurrent requests (unary + streaming)")
    engines = [ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2,
                                                  steps_per_tick=4),
                             replica_id=i)
               for i in range(args.replicas)]
    gw = Gateway(ReplicaSet(engines), grace_s=60.0)
    gw.start(warmup_prompt_lens=sorted({8, 16, 32}))
    gw.install_sigterm()
    cli = GatewayClient("127.0.0.1", gw.port)
    assert cli.wait_ready(60.0)

    results, streamed = {}, {}

    def call(i):
        if i % 2 == 0:
            chunks = streamed.setdefault(i, [])
            results[i] = cli.generate(
                prompts[i], args.steps, stream=True,
                on_token=lambda idx, tok: chunks.append(tok))
        else:
            results[i] = cli.generate(prompts[i], args.steps)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(args.requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    matches = sum(bool(np.array_equal(results[i]["tokens"], refs[i]))
                  for i in range(args.requests))
    stream_ok = all(streamed[i] == list(results[i]["tokens"])
                    for i in streamed)
    print(f"    http_matches_sequential={matches}/{args.requests} "
          f"streamed_chunks_consistent={stream_ok}")
    assert matches == args.requests and stream_ok

    print("[2] backpressure over HTTP: queue_depth=1, one slot")
    small = Gateway(ServingEngine(lm=pm, cfg=EngineCfg(
        n_slots=1, steps_per_tick=1, queue_depth=1)), grace_s=30.0)
    small.start(warmup_prompt_lens=(8,))
    raw = GatewayClient("127.0.0.1", small.port, max_retries=0)
    occupier = threading.Thread(
        target=lambda: raw.generate(prompts[0], 120))
    occupier.start()
    time.sleep(0.1)
    filler = threading.Thread(target=lambda: raw.generate(prompts[1], 2))
    filler.start()
    time.sleep(0.05)
    try:
        raw.generate(prompts[2], 2)
        print("    (queue drained before the probe — no refusal this run)")
    except GatewayOverloaded as e:
        print(f"    429 body={e.body} (Retry-After honored by the "
              f"retrying client below)")
        patient = GatewayClient("127.0.0.1", small.port, max_retries=6)
        out = patient.generate(prompts[2], 2)
        print(f"    retried to completion after {patient.retries} "
              f"backoff sleeps: tokens={out['tokens']}")
    occupier.join()
    filler.join()
    small.stop()

    print("[3] SIGTERM drain: stream in flight completes, new requests 503")
    seen = []
    box = {}
    long_steps = min(120, cfg.max_len - len(prompts[0]))

    def long_req():
        box["r"] = cli.generate(prompts[0], long_steps, stream=True,
                                on_token=lambda i, t: seen.append(t))

    t = threading.Thread(target=long_req)
    t.start()
    while not seen:
        time.sleep(0.005)
    os.kill(os.getpid(), signal.SIGTERM)
    t.join()
    print(f"    in_flight_completed={len(box['r']['tokens'])}/{long_steps} "
          f"state={gw.lifecycle.state}")
    for _ in range(200):
        if gw.lifecycle.state == "stopped":
            break
        time.sleep(0.05)
    assert len(box["r"]["tokens"]) == long_steps
    assert gw.lifecycle.state == "stopped"
    gw.lifecycle.restore_sigterm()

    print("[4] fleet SLO snapshot + Prometheus exposition")
    snap = gw.replica_set.snapshot()
    for key in ("serve.completed", "serve.ttft_ms_p50", "serve.total_ms_p99",
                "serve.tokens_per_sec", "gateway.replicas",
                "gateway.retried_429"):
        print(f"    {key} = {snap[key]:.1f}")
    prom = [ln for ln in gw.replica_set.prometheus().splitlines()
            if ln.startswith(("ddw_serve_completed_total",
                              "ddw_serve_tokens_per_sec",
                              "ddw_gateway_replicas"))]
    for ln in prom:
        print(f"    {ln}")

    print("http gateway: token-identical streaming over the wire, "
          "Retry-After backpressure, graceful SIGTERM drain")


if __name__ == "__main__":
    main()
