#!/usr/bin/env python3
"""Where the time of one ``PackagedModel.predict_logits`` call goes, on the
card, for the port's serving main path (ddw_tpu_torch).

    python3 tools/torch_serving_profile.py [--dw-impl pallas|xla]

Builds the full-width bf16 MobileNetV2 (width 1.0, 224x224x3, 5 classes) from
seeded random weights, packages and loads it, warms it up, then runs
``predict_logits`` over 512 decoded images (4 sub-batches of 128) under
``torch.profiler`` (CPU + CUDA activities). Prints one JSON line: the wall time per image, the
device time by kernel category (the port's depthwise kernel, library
convolutions, elementwise/BatchNorm work, copies between host and device,
other), the device's idle share of the wall time, and the top kernels by
device time. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

IMAGES = 512


def _category(name: str) -> str:
    n = name.lower()
    if "dw3x3_fwd_kernel" in n:
        return "depthwise_kernel"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(k in n for k in ("conv", "xmma", "cudnn", "gemm", "sm90", "cutlass",
                            "implicit", "nchwtonhwc", "nhwctonchw", "winograd")):
        return "library_conv"
    if any(k in n for k in ("elementwise", "vectorized", "clamp", "rsqrt",
                            "batch_norm", "copy_kernel", "fill")):
        return "elementwise"
    if "reduce" in n or "mean" in n:
        return "reductions"
    return "other"


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--dw-impl", default="pallas", choices=("pallas", "xla"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_profile: needs a CUDA card", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.mobilenet_v2 import init_weights
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.serving.package import (PackagedModel,
                                               save_packaged_model)
    from ddw_tpu_torch.utils.config import ModelCfg

    cfg = ModelCfg(name="mobilenet_v2", num_classes=5, dropout=0.0,
                   dtype="bfloat16", dw_impl=args.dw_impl)
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    v = to_flax_variables(model)
    x = np.random.RandomState(0).uniform(
        -1, 1, (IMAGES, 224, 224, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="ddw_profile_") as tmp:
        pm = PackagedModel(save_packaged_model(
            os.path.join(tmp, "pkg"), cfg, list("abcde"), v["params"],
            v["batch_stats"]))
    pm.predict_logits(x)
    pm.predict_logits(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pm.predict_logits(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_cat: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        # device-side entries only (kernels, copies): a CPU op's own entry
        # repeats the device time of the kernels it launched
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
        print("torch_serving_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 3
    kernels.sort(reverse=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "dw_impl": args.dw_impl, "images": IMAGES,
        "sub_batches": -(-IMAGES // 128),
        "wall_ms": wall_ms, "wall_ms_per_image": wall_ms / IMAGES,
        "images_per_s": IMAGES / wall_ms * 1e3,
        "device_ms": device_ms,
        # one stream: kernels and copies do not overlap
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_ms_by_category": by_cat,
        "top_kernels": [{"ms": ms, "calls": n, "category": c, "name": k}
                        for ms, n, c, k in kernels[:12]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
