#!/usr/bin/env python3
"""Where the time of one LM train step goes, on the card, for the port's LM
training path (ddw_tpu_torch).

    python3 tools/torch_lm_train_profile.py [--impl auto|xla] [--batch 32]

Builds bench.py's ``lm_flash`` LM (vocab 8192, 2048 positions, hidden 512, 6
layers of 8 heads of 64, MLP 2048, bf16) from seeded random weights with
adam 3e-4, warms up two steps of ``make_lm_train_step`` on a batch of
seeded tokens, then profiles (``torch.profiler``, CPU + CUDA activities):

- one whole step, for the wall time and the device's idle share;
- the step's phases one by one, each ending in a synchronise: forward and
  loss, backward, optimizer update.

``--impl xla`` raises the attention dispatch thresholds so attention runs
on the ``xla`` tier (autograd through one f32 score matrix per layer)
instead of K3/K4/K5. Prints one JSON line: wall and device ms of the step,
device ms by category (K3, K4, K5, bf16 GEMMs, the f32 GEMMs: the vocab
head's forward and backward, and on the ``xla`` tiers the attention's
f32 score products too; softmax / cross-entropy, reductions, elementwise,
copies) for each phase, the optimizer's device ms, the idle share, and the
top kernels. Needs a CUDA card; exits 2 without one, and 4 (printing the
error as JSON) when the step does not fit in the card's memory, as the
``xla`` tier does not at batch 32.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CFG = dict(vocab_size=8192, max_len=2048, hidden=512, depth=6, num_heads=8,
           mlp_dim=2048, dtype="bfloat16")


def _category(name: str) -> str:
    n = name.lower()
    for key, cat in (("flash_fwd", "k3_flash_fwd"),
                     ("flash_bwd_dq", "k4_flash_dq"),
                     ("flash_bwd_dkv", "k5_flash_dkv")):
        if key in n:
            return cat
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(k in n for k in ("gemm", "nvjet", "sm90", "cutlass", "xmma",
                            "cublas")):
        # on the kernel tier the only f32 products of a step are the vocab
        # head's; on the xla tiers the f32 score products land here too
        return "gemm_f32_vocab_head" if any(
            k in n for k in ("sgemm", "simt", "f32f32", "tf32")) \
            else "gemm_bf16"
    if any(k in n for k in ("softmax", "nll_loss", "cross_entropy")):
        return "softmax_cross_entropy"
    if "reduce" in n:
        return "reductions"
    if any(k in n for k in ("elementwise", "vectorized", "copy_kernel",
                            "fill", "index", "gather", "embedding",
                            "foreach")):
        return "elementwise"
    return "other"


def _device_breakdown(prof):
    """Device ms by category, and (ms, calls, category, name) per kernel,
    from device-side entries only (a CPU op's own entry repeats the device
    time of the kernels it launched)."""
    from torch.autograd import DeviceType

    by_cat: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or \
                evt.key.startswith("Activity Buffer"):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us <= 0:
            continue
        cat = _category(evt.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, evt.count, cat, evt.key[:90]))
    return by_cat, kernels


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="auto", choices=("auto", "xla"))
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lm_train_profile: needs a CUDA card", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.ops import flash_attention as fa
    from ddw_tpu_torch.train.lm_step import (init_lm_state, lm_loss,
                                             make_lm_train_step)
    from ddw_tpu_torch.train.step import make_optimizer
    from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

    if args.impl == "xla":
        fa._XLA_PLAIN_MAX = fa._XLA_CKPT_MAX = 1 << 62
    cfg = LMCfg(**CFG)
    model = build_lm(cfg)
    tx = make_optimizer(TrainCfg(optimizer="adam", learning_rate=3e-4))
    state = init_lm_state(model, tx, torch.Generator().manual_seed(0), "cuda")
    step = make_lm_train_step(model, tx)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (args.batch, cfg.max_len + 1)).astype(
            np.int32)).cuda()
    inputs, targets = toks[:, :-1], toks[:, 1:]
    try:
        for _ in range(2):
            step(state, inputs, targets, 1)
        torch.cuda.synchronize()
    except torch.OutOfMemoryError:
        # the xla tier keeps f32 score matrices per layer for the backward
        print(json.dumps({"impl": args.impl, "batch": args.batch,
                          "error": "out of memory",
                          "device": torch.cuda.get_device_name(0)}))
        return 4
    counters = (fa.flash_attention_cuda, fa.flash_attention_dq_cuda,
                fa.flash_attention_dkv_cuda)
    before = [c.launches for c in counters]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        m = step(state, inputs, targets, 1)
        float(m["loss"])                    # fetches the loss: work done
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = [c.launches - b for c, b in zip(counters, before)]
    step_cats, kernels = _device_breakdown(prof)

    # the phases one by one
    params = dict(model.named_parameters())
    phases = {}
    model.train()
    with profile(activities=acts) as prof:
        loss = lm_loss(model(inputs.long()), targets)
        torch.cuda.synchronize()
    phases["forward_and_loss"] = _device_breakdown(prof)[0]
    with profile(activities=acts) as prof:
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
    phases["backward"] = _device_breakdown(prof)[0]
    grads = dict(zip(params, grads))
    with profile(activities=acts) as prof:
        tx.update(params, grads, state.opt_state)
        torch.cuda.synchronize()
    phases["optimizer"] = _device_breakdown(prof)[0]

    device_ms = sum(step_cats.values())
    if device_ms <= 0:
        print("torch_lm_train_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 3
    kernels.sort(reverse=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    tokens = args.batch * cfg.max_len
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "impl": args.impl, "batch": args.batch, "seq": cfg.max_len,
        "launches": dict(zip(("k3", "k4", "k5"), launches)),
        "step_wall_ms": wall_ms, "tokens_per_s": tokens / wall_ms * 1e3,
        "step_device_ms": device_ms,
        # one stream: kernels and copies do not overlap
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "step_device_ms_by_category": step_cats,
        "phase_device_ms_by_category": phases,
        "phase_device_ms": {k: sum(v.values()) for k, v in phases.items()},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": [{"ms": ms, "calls": n, "category": c, "name": k}
                        for ms, n, c, k in kernels[:15]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
