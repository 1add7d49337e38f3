#!/usr/bin/env python3
"""Where the time of one training step goes, on the card, for the port's
training main path (ddw_tpu_torch).

    python3 tools/torch_train_profile.py [--dw-impl pallas|xla] [--steps 5]

Builds the full-width bf16 MobileNetV2 (width 1.0, 224x224x3, 5 classes,
unfrozen, dropout 0.5) from a seeded init with adam, as ``chip_smoke.py``'s
train phase trains it, warms up three steps on one batch of 128 seeded
images, then runs ``--steps`` steps of ``make_train_step`` under
``torch.profiler`` (CPU + CUDA activities). Prints one JSON line: the wall
time per step, the device time by kernel category (the port's depthwise
kernels K1 and K2, library convolutions and GEMMs, elementwise and
BatchNorm work, reductions, copies, other), the device's idle share of the
wall time, and the top kernels by device time. Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 128


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--dw-impl", default="pallas", choices=("pallas", "xla"))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torch_serving_profile import _category
    from ddw_tpu_torch.models.layers import init_params
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.train.step import (init_state, make_optimizer,
                                          make_train_step)
    from ddw_tpu_torch.utils.config import ModelCfg, TrainCfg

    cfg = ModelCfg(name="mobilenet_v2", num_classes=5, dtype="bfloat16",
                   dw_impl=args.dw_impl, freeze_base=False)
    model = build_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    model.cuda()
    tx = make_optimizer(TrainCfg(optimizer="adam"))
    state = init_state(model, tx)
    step = make_train_step(tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(BATCH, 224, 224, 3, device="cuda", generator=gen) * 2 - 1
    y = torch.randint(0, 5, (BATCH,), device="cuda", generator=gen,
                      dtype=torch.int32)
    for _ in range(3):
        step(state, x, y, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, x, y, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_cat: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        # device-side entries only: a CPU op's own entry repeats the device
        # time of the kernels it launched
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
    device_ms = sum(by_cat.values())
    if device_ms <= 0:
        print("torch_train_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 3
    kernels.sort(reverse=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    steps = args.steps
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "dw_impl": args.dw_impl, "batch": BATCH, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "images_per_s": BATCH * steps / wall_ms * 1e3,
        "device_ms_per_step": device_ms / steps,
        # one stream: kernels and copies do not overlap
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_ms_per_step_by_category": {k: v / steps
                                           for k, v in by_cat.items()},
        "top_kernels": [{"ms_per_step": ms / steps, "calls": n,
                         "category": c, "name": k}
                        for ms, n, c, k in kernels[:15]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
