#!/usr/bin/env python3
"""Smoke run of ddw_tpu_torch on one NVIDIA card: build, check and time the
port's CUDA kernels, then drive the serving main path end to end.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing one JSON line; any failure exits non-zero:

1. device — the card's name, and ``nvidia-smi``'s name and power limit.
   Without CUDA the script exits 2 at once.
2. build  — compile every kernel of the path from ``ddw_tpu_torch/ops/csrc``
   with ``nvcc`` (one process per source, all started together).
3. kernel — the depthwise 3x3 kernel (K1) against its plain PyTorch version
   at the six stride-1 shapes of MobileNetV2-224 at batch 128, in bf16 and
   f32 (TF32 off): f32 within 1e-5 * max|y|, bf16 within one bf16 ulp (both
   accumulate in f32). Times (CUDA events, median of 25 single launches,
   L2 flushed before each) for the kernel, the plain version and
   ``F.conv2d(groups=C)`` (timed only, the yardstick), beside the bound.
4. main   — a full-width bf16 MobileNetV2 (width 1.0, 224x224x3, 5 classes,
   ``dw_impl="pallas"``) from seeded random weights is saved with
   ``save_packaged_model``, loaded with ``PackagedModel`` on the card, scores a
   300-image ``raw_u8`` table through ``BatchScorer.score_table`` and predicts
   a few decoded arrays. K1's launch count must be 13 per forward batch.
   Logits are held against the same package with the plain depthwise on the
   card (bf16: equal argmax wherever the top-2 margin exceeds the tolerance;
   f32: within 1e-3 relative), and ``predict_logits`` images/s is measured.
5. The ``kernels`` JSON line, the ``nvidia-smi`` line, and last the result
   line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCH = 128
N_IMAGES = 300
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS = 67e12            # H100 SXM, float32 outside the tensor cores
# (H, W, C) of the 13 stride-1 depthwise layers of MobileNetV2-224, with the
# number of layers at each.
DW_SHAPES = (((112, 112, 32), 1), ((56, 56, 144), 1), ((28, 28, 192), 2),
             ((14, 14, 384), 4), ((14, 14, 576), 2), ((7, 7, 960), 3))
LAYERS_PER_FORWARD = sum(n for _, n in DW_SHAPES)


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each timed by CUDA events with the
    L2 cache flushed (a 256 MiB write) before it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bf16_ulp(t):
    """One bf16 ulp at each element of ``t`` (float32 tensor)."""
    import torch

    mag = t.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from ddw_tpu_torch.ops import _build

    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    for src, (path, seconds, report) in zip(sources, built):
        regs = [ln.split("Used", 1)[1].strip() for ln in report.splitlines()
                if "Used" in ln and "registers" in ln]
        emit(phase="build", source=src, library=os.path.basename(path),
             nvcc_seconds=round(seconds, 3), ptxas=regs)
    emit(phase="build", wall_seconds=round(time.perf_counter() - t0, 3))


def phase_kernel(flush):
    """K1 against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from ddw_tpu_torch.ops.depthwise_conv import (depthwise_conv3x3_cuda,
                                                  depthwise_conv3x3_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    per_forward = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "bound_ms": 0.0}
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for (h, w, c), layers in DW_SHAPES:
            x = torch.randn(BATCH, h, w, c, device="cuda", generator=gen)
            taps = torch.randn(3, 3, c, device="cuda", generator=gen)
            x, taps = x.to(dtype), taps.to(dtype)
            y = depthwise_conv3x3_cuda(x, taps)
            torch.cuda.synchronize()
            ref = depthwise_conv3x3_plain(x, taps)
            err = (y.float() - ref.float()).abs()
            if dtype == torch.float32:
                tol = 1e-5 * ref.abs().max().item()
                ok = err.max().item() <= tol
                tol_desc = f"1e-5*max|y| = {tol:.3g}"
            else:
                ok = bool((err <= bf16_ulp(ref.float())).all())
                tol_desc = "1 bf16 ulp elementwise"
            check(ok and bool(torch.isfinite(y).all()),
                  f"K1 {dtype} {(h, w, c)} within {tol_desc}")
            max_err = max(max_err, err.max().item())

            cl = x.permute(0, 3, 1, 2)           # channels_last view
            wl = taps.permute(2, 0, 1).unsqueeze(1).contiguous()
            ms = median_ms(lambda: depthwise_conv3x3_cuda(x, taps), flush)
            plain_ms = median_ms(lambda: depthwise_conv3x3_plain(x, taps),
                                 flush)
            lib_ms = median_ms(lambda: F.conv2d(cl, wl, padding=1, groups=c),
                               flush)
            elems = BATCH * h * w * c
            nbytes = (2 * elems + 9 * c) * x.element_size()
            flops = 2 * 9 * elems
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            emit(phase="kernel", kernel="depthwise_conv3x3_fwd",
                 dtype=str(dtype).removeprefix("torch."),
                 shape=[BATCH, h, w, c], layers_per_forward=layers,
                 max_abs_err=err.max().item(), tolerance=tol_desc, ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                 bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                 >= flops / F32_FLOPS else "operations",
                 bytes=nbytes, flops=flops)
            if dtype == torch.bfloat16:  # the main path's dtype
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms),
                                 ("bound_ms", bound_ms)):
                    per_forward[key] += layers * val
            del x, taps, y, ref, err, cl, wl
    # the scalar path (odd C, no vector loads)
    x = torch.randn(2, 9, 7, 13, device="cuda", generator=gen)
    taps = torch.randn(3, 3, 13, device="cuda", generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        y = depthwise_conv3x3_cuda(x.to(dtype), taps.to(dtype))
        ref = depthwise_conv3x3_plain(x.to(dtype), taps.to(dtype))
        check(torch.equal(y, ref), f"K1 scalar path {dtype} equals plain")
    emit(phase="kernel", kernel="depthwise_conv3x3_fwd", odd_c_scalar_path="ok")
    return per_forward, max_err


def make_package(root: str, dtype: str, dw_impl: str, variables) -> str:
    from ddw_tpu_torch.serving.package import save_packaged_model
    from ddw_tpu_torch.utils.config import ModelCfg

    cfg = ModelCfg(name="mobilenet_v2", num_classes=5, dropout=0.0,
                   freeze_base=True, allow_frozen_random=True, dtype=dtype,
                   dw_impl=dw_impl)
    out = os.path.join(root, f"pkg_{dtype}_{dw_impl}")
    return save_packaged_model(out, cfg, [f"c{i}" for i in range(5)],
                               variables["params"], variables["batch_stats"])


def seeded_variables(images):
    """Flax-layout weights of the full-width model from a seeded generator,
    with the head calibrated on the smoke images as served (bf16): logits
    centred per class and of unit spread, so that the classes differ across
    images. (A random backbone maps every image to nearly one feature
    vector; uncalibrated, one class wins everywhere.)"""
    import torch

    from ddw_tpu_torch.data.loader import dequantize_raw_u8
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.mobilenet_v2 import init_weights
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.utils.config import ModelCfg

    model = build_model(ModelCfg(name="mobilenet_v2", num_classes=5,
                                 dtype="bfloat16", dw_impl="pallas"))
    init_weights(model, torch.Generator().manual_seed(SEED))
    x = images[:BATCH].astype("float32")
    dequantize_raw_u8(x)
    model.cuda().eval()
    with torch.inference_mode():
        logits = model(torch.from_numpy(x).cuda())
        mean = logits.mean(0)
        std = (logits - mean).std()
        model.head.weight.div_(std)
        model.head.bias.sub_(mean).div_(std)
    return to_flax_variables(model)


def synthetic_images(n: int):
    """Seeded smooth uint8 images (low-frequency colour fields plus noise)."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    yy, xx = np.mgrid[0:224, 0:224].astype(np.float32) / 224.0
    out = np.empty((n, 224, 224, 3), np.uint8)
    for i in range(n):
        f = rng.uniform(0.5, 4.0, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        base = np.stack([np.sin(2 * np.pi * (f[k, 0] * xx + f[k, 1] * yy)
                                + ph[k]) for k in range(3)], -1)
        img = 127.5 + 100.0 * base + rng.normal(0, 10.0, base.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def phase_main(tmp: str):
    import numpy as np
    import torch

    from ddw_tpu_torch.data.loader import dequantize_raw_u8
    from ddw_tpu_torch.data.store import Record, TableStore
    from ddw_tpu_torch.ops.depthwise_conv import depthwise_conv3x3_cuda
    from ddw_tpu_torch.serving.batch import BatchScorer
    from ddw_tpu_torch.serving.package import PackagedModel

    images = synthetic_images(N_IMAGES)
    variables = seeded_variables(images)
    pkg = make_package(tmp, "bfloat16", "pallas", variables)
    pkg_plain = make_package(tmp, "bfloat16", "pallas_interpret", variables)
    store = TableStore(os.path.join(tmp, "tables"))
    table = store.write(
        "smoke_raw_u8",
        (Record(f"img{i:04d}", images[i].tobytes(), "", -1)
         for i in range(N_IMAGES)),
        shard_size=100, meta={"encoding": "raw_u8", "height": 224,
                              "width": 224})
    decoded = images[:4].astype(np.float32)
    dequantize_raw_u8(decoded)

    pm = PackagedModel(pkg)                     # the card, by default
    check(pm.device.type == "cuda", "PackagedModel resolved to the card")

    # --- the main path, counted -------------------------------------------
    depthwise_conv3x3_cuda.launches = 0
    t0 = time.perf_counter()
    scored = BatchScorer(pm).score_table(table, out_store=store,
                                         out_name="smoke_predictions")
    preds = pm.predict(list(decoded))
    wall = time.perf_counter() - t0
    launches = depthwise_conv3x3_cuda.launches
    forwards = -(-N_IMAGES // BATCH) + 1        # 3 scorer batches + predict
    emit(phase="main", scored=len(scored), predict=preds,
         k1_launches=launches, forward_batches=forwards,
         expected_launches=LAYERS_PER_FORWARD * forwards,
         wall_seconds=wall)
    check(launches == LAYERS_PER_FORWARD * forwards,
          f"K1 launched {launches} times, expected "
          f"{LAYERS_PER_FORWARD} x {forwards}")
    check(len(scored) == N_IMAGES, "every record scored")
    out = store.table("smoke_predictions")
    check([(r.path, r.label) for r in out.iter_records()] == scored,
          "predictions table reads back as scored")

    # --- right answers: kernel path against the plain depthwise -----------
    x_all = images.astype(np.float32)
    dequantize_raw_u8(x_all)
    logits = pm.predict_logits(x_all)
    ref = PackagedModel(pkg_plain).predict_logits(x_all)
    check(logits.shape == (N_IMAGES, 5) and np.isfinite(logits).all(),
          "finite logits of shape [300, 5]")
    scale = float(np.abs(ref).max())
    tol = 0.05 * max(scale, 1.0)                # bf16 through ~50 layers
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > tol
    agree = np.argmax(logits, -1) == np.argmax(ref, -1)
    bf16_err = float(np.abs(logits - ref).max())
    emit(phase="main", bf16_max_abs_diff=bf16_err, bf16_tolerance=tol,
         decisive=int(decisive.sum()), argmax_agree=int(agree.sum()),
         classes_seen=sorted({int(c) for c in np.argmax(ref, -1)}))
    check(bf16_err <= tol, f"bf16 logits within {tol:.3g} of the plain path")
    check(bool(decisive.any()) and bool(agree[decisive].all()),
          "bf16 argmax equal wherever the top-2 margin exceeds the tolerance")
    check(len(set(np.argmax(ref, -1))) > 1, "classes differ across images")
    check([c for _, c in scored] ==
          [pm.classes[i] for i in np.argmax(logits, -1)],
          "scorer classes equal predict_logits argmax")
    check(all(p == c for p, (_, c), d in zip(preds, scored, decisive) if d),
          "predict equals the scorer where decisive")

    f32_pkg = make_package(tmp, "float32", "pallas", variables)
    f32_plain_pkg = make_package(tmp, "float32", "pallas_interpret", variables)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x128 = x_all[:BATCH]
    f32_k = PackagedModel(f32_pkg).predict_logits(x128)
    f32_p = PackagedModel(f32_plain_pkg).predict_logits(x128)
    f32_rel = float(np.abs(f32_k - f32_p).max()
                    / max(np.abs(f32_p).max(), 1e-30))
    check(f32_rel <= 1e-3, f"f32 logits within 1e-3 relative ({f32_rel:.3g})")
    torch.backends.cudnn.allow_tf32 = True
    emit(phase="main", f32_max_rel_diff=f32_rel, f32_tolerance=1e-3,
         tf32_for_f32_check=False)

    # --- throughput of predict_logits (bf16, sub-batch 128) ---------------
    x_tp = np.ascontiguousarray(np.tile(x_all, (4, 1, 1, 1))[:1024])
    pm.predict_logits(x_tp)
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm.predict_logits(x_tp)             # fetches logits: completes work
        runs.append(time.perf_counter() - t0)
    runs.sort()
    emit(phase="main", predict_logits_images=len(x_tp),
         images_per_s_median=len(x_tp) / runs[len(runs) // 2],
         images_per_s_runs=[len(x_tp) / r for r in runs])
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    try:
        import ddw_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    name, smi = phase_device()
    phase_build()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    per_forward, max_err = phase_kernel(flush)
    torch.backends.cudnn.allow_tf32 = True
    del flush
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ddw_chip_smoke_") as tmp:
        launches = phase_main(tmp)
    print(json.dumps({"kernels": [{
        "name": "depthwise_conv3x3_fwd",
        "route": "cuda",
        "source": "ddw_tpu_torch/ops/csrc/depthwise_conv.cu",
        "replaces": "ddw_tpu/ops/depthwise_conv.py:74",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": per_forward["ms"],
        "plain_ms": per_forward["plain_ms"],
        "bound_ms": per_forward["bound_ms"],
        "bound_by": "bytes",
        "library_ms": per_forward["library_ms"],
        "per": "one bf16 forward at batch 128: the 13 stride-1 layers",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
