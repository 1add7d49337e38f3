#!/usr/bin/env python3
"""Where K6's time goes on the card: the ring all-reduce of
``ddw_tpu_torch.ops.ring_reduce`` timed per call at 2 and 4 ranks, in its
two variants in turns: ``packed`` (the whole tree in one launch per ring
dtype, what ``all_reduce_sum(impl="pallas")`` runs) and ``per_leaf`` (the
earlier design, one launch per leaf). Cases: a tree shaped like the
full-width ``lm_flash`` LM's gradients (102 leaves, 28,360,704 f32 values of
seeded random data), its largest leaf alone, a leaf of 1,000 values, and a
tree of one value, whose time is 2n - 1 waits for a neighbour and nearly no
bytes: the per-wait cost.

    python3 tools/torch_ring_profile.py [--ranks 2 4] [--calls 5]

The ranks are processes from ``spawn_cpu`` (a gloo group) that all work on
``cuda:0``. Without MPS the card time-slices them, so a launch that waits
for a neighbour holds the card until its slice ends; under an MPS daemon
(``CUDA_MPS_PIPE_DIRECTORY`` set in the environment) they run concurrently.
The JSON line says which. Times: CUDA events on every rank, a group barrier
before each call, the max over ranks, the median of ``--calls`` calls of
each variant (packed, per_leaf, then per_leaf, packed, ...); every call must
give the first call's bits. Prints one JSON line per rank count, each with
the card's name and ``nvidia-smi`` power limit.
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
VARIANTS = ("packed", "per_leaf")


def _rank(calls: int) -> dict:
    import torch
    import torch.distributed as dist

    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.ops import ring_reduce as rr
    from ddw_tpu_torch.runtime.dist import process_topology
    from ddw_tpu_torch.utils.config import LMCfg

    torch.cuda.set_device(0)
    rank, n = process_topology()
    gen = torch.Generator(device="cuda").manual_seed(rank)
    with torch.device("meta"):
        params = dict(build_lm(LMCfg(**LM_CFG)).named_parameters())
    tree = [torch.randn(params[k].shape, generator=gen, device="cuda")
            for k in sorted(params)]
    cases = {"tree": tree, "largest_leaf": [max(tree, key=torch.numel)],
             "leaf_1000": [torch.randn(1000, generator=gen, device="cuda")],
             "leaf_1": [torch.randn(1, generator=gen, device="cuda")]}
    k6 = rr.ring_all_reduce_cuda
    out = {}
    for name, leaves in cases.items():
        first = rr.ring_all_reduce_tree_pallas(leaves)
        times = {v: [] for v in VARIANTS}
        for i in range(calls):
            for variant in VARIANTS[::1 if i % 2 == 0 else -1]:
                torch.cuda.synchronize()
                dist.barrier()
                before = k6.launches
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                got = rr.ring_all_reduce_tree_pallas(leaves,
                                                     _variant=variant)
                end.record()
                end.synchronize()
                times[variant].append(start.elapsed_time(end))
                out[f"{name}_{variant}_launches"] = k6.launches - before
                if not all(torch.equal(g, f) for g, f in zip(got, first)):
                    raise RuntimeError(f"{name}: a {variant} call gave "
                                       f"other bits")
        every = [None] * n
        dist.all_gather_object(every, times)
        for v in VARIANTS:
            out[f"{name}_{v}_ms"] = [max(t) for t in
                                     zip(*(e[v] for e in every))]
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
        res = spawn_cpu(_rank, n, args.calls, timeout_s=900)[0]
        medians = {f"{k[:-3]}_median_ms": statistics.median(v)
                   for k, v in res.items() if k.endswith("_ms")}
        print(json.dumps({
            "ranks": n, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi,
            "mps": bool(os.environ.get("CUDA_MPS_PIPE_DIRECTORY")),
            "waits_per_packed_call": 2 * n - 1, **res, **medians,
            "per_wait_ms": medians["leaf_1_packed_median_ms"] / (2 * n - 1),
            "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
