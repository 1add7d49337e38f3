#!/usr/bin/env python3
"""Where K6's time goes on the card: the ring all-reduce of
``ddw_tpu_torch.ops.ring_reduce`` timed per call at 2 and 4 ranks, over a
tree shaped like the full-width ``lm_flash`` LM's gradients (102 leaves,
28,360,704 f32 values of seeded random data), over its largest leaf alone,
and over a leaf of 1,000 values.

    python3 tools/torch_ring_profile.py [--ranks 2 4] [--calls 5]

The ranks are processes from ``spawn_cpu`` (a gloo group) that all work on
``cuda:0``. Without MPS the card time-slices them, so a launch that waits
for a neighbour holds the card until its slice ends; under an MPS daemon
(``CUDA_MPS_PIPE_DIRECTORY`` set in the environment) they run concurrently.
The JSON line says which. Times: CUDA events on every rank, a group barrier
before each call, the max over ranks, the median of ``--calls`` calls; every
call must give the first call's bits. Prints one JSON line per rank count,
each with the card's name and ``nvidia-smi`` power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LM_CFG = dict(vocab_size=8192, max_len=2048, hidden=512, depth=6,
              num_heads=8, mlp_dim=2048, dtype="bfloat16")  # bench.py lm_flash


def _rank(calls: int) -> dict:
    import torch
    import torch.distributed as dist

    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.ops import ring_reduce as rr
    from ddw_tpu_torch.runtime import all_reduce_sum
    from ddw_tpu_torch.runtime.dist import process_topology
    from ddw_tpu_torch.utils.config import LMCfg

    torch.cuda.set_device(0)
    rank, n = process_topology()
    gen = torch.Generator(device="cuda").manual_seed(rank)
    shapes = {k: p.shape for k, p in
              build_lm(LMCfg(**LM_CFG)).named_parameters()}
    tree = {k: torch.randn(s, generator=gen, device="cuda")
            for k, s in shapes.items()}
    cases = {"tree": tree, "largest_leaf": tree["tok_embed.embedding"],
             "leaf_1000": torch.randn(1000, generator=gen, device="cuda")}
    out = {}
    for name, x in cases.items():
        first = all_reduce_sum(x, impl="pallas")
        times = []
        for _ in range(calls):
            torch.cuda.synchronize()
            dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = all_reduce_sum(x, impl="pallas")
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            same = (all(torch.equal(got[k], first[k]) for k in got)
                    if isinstance(got, dict) else torch.equal(got, first))
            if not same:
                raise RuntimeError(f"{name}: a call gave other bits")
        every = [None] * n
        dist.all_gather_object(every, times)
        out[name] = [max(t) for t in zip(*every)]
    rr.close_comms()
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ring_profile: no CUDA device", file=sys.stderr)
        return 2
    from ddw_tpu_torch.ops import _build
    from ddw_tpu_torch.runtime.dist import spawn_cpu

    _build.build("ring_reduce.cu")  # once, before the ranks load it
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for n in args.ranks:
        t0 = time.perf_counter()
        res = spawn_cpu(_rank, n, args.calls, timeout_s=600)[0]
        print(json.dumps({
            "ranks": n, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi,
            "mps": bool(os.environ.get("CUDA_MPS_PIPE_DIRECTORY")),
            **{f"{k}_ms": v for k, v in res.items()},
            **{f"{k}_median_ms": statistics.median(v)
               for k, v in res.items()},
            "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
