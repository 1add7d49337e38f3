#!/usr/bin/env python3
"""K1 and K2, the depthwise 3x3 kernels, by variant on the card
(ddw_tpu_torch).

    python3 tools/torch_dw_profile.py [--reps N] [--check-only] [--out DIR]
                                      [--dtypes bfloat16 float32] [--sweep]

Builds ``csrc/depthwise_sm90.cu`` (the ``"tma"`` variant) and
``csrc/depthwise_conv.cu`` (``"simt"``), one ``nvcc`` each, together; prints
ptxas's registers, spills and shared memory for every kernel and writes both
full reports to ``--out`` (by default the git-ignored build directory
``ddw_tpu_torch/ops/build/``). Then holds the ``"tma"`` kernels against the
plain versions on the same inputs: K1, with and without ``flip``, equal bit
for bit; K2 within 1e-5 * sum|xpad * g| per (dy, dx, c) and bit-identical on
a second launch; at the 13 stride-1 layers of MobileNetV2-224 at batch 128
and at the edges of the tile plan (B = 1, H and W that no tile divides, C
not a multiple of the channel block, in bf16 and f32). Unless
``--check-only``: times ``"tma"`` and ``"simt"`` in turns (tma, simt, simt,
tma) per layer beside the library call (cuDNN ``F.conv2d(groups=C)`` for
K1, ``aten.convolution_backward``'s weight gradient for K2, TF32 off) and
the bound (bytes over 3.35 TB/s) and ``y.copy_(x)``, which moves K1's
bytes (the floor a kernel reaches under this timing), and sums one pass
over the 13 layers
(CUDA events, median of N single launches, the L2 flushed before each).
With ``--sweep``, also times each bf16 layer's tma kernels on other tile
plans (``SWEEP``) and on rings of 3 and 4 stages, beside the plan's own.
Prints one JSON line per result and the card's name and power limit last.
Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BATCH = 128
# (H, W, C) of the 13 stride-1 depthwise layers of MobileNetV2-224, with the
# number of layers at each.
DW_SHAPES = (((112, 112, 32), 1), ((56, 56, 144), 1), ((28, 28, 192), 2),
             ((14, 14, 384), 4), ((14, 14, 576), 2), ((7, 7, 960), 3))
# [B, H, W, C] at the edges of the tile plan, with a channel block forced
# where the plan's own would cover C in one block.
EDGES = (((1, 15, 13, 64), None), ((2, 9, 7, 64), None),
         ((3, 8, 8, 40), None), ((3, 8, 8, 40), (4, 8, 16)),
         ((2, 8, 8, 200), None), ((1, 7, 7, 960), None),
         ((2, 17, 30, 48), (8, 16, 32)))
# (th, tw, cb) plans beside each layer's own for --sweep
SWEEP = {(112, 112, 32): ((8, 16, 32), (8, 32, 32), (12, 16, 32)),
         (56, 56, 144): ((4, 14, 144), (8, 14, 48), (8, 14, 72)),
         (28, 28, 192): ((4, 28, 64), (4, 14, 128), (8, 14, 32)),
         (14, 14, 384): ((7, 14, 64), (14, 14, 32), (4, 14, 128)),
         (14, 14, 576): ((7, 14, 64), (7, 7, 144), (7, 7, 128)),
         (7, 7, 960): ((7, 7, 144), (7, 7, 64), (4, 7, 256))}


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def median_ms(fn, flush, reps: int, warmup: int = 3) -> float:
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


def build(out_dir: str) -> None:
    from ddw_tpu_torch.ops import _build

    sources = ("depthwise_sm90.cu", "depthwise_conv.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    os.makedirs(out_dir, exist_ok=True)
    for src, (_, seconds, report) in zip(sources, built):
        with open(os.path.join(out_dir, f"ptxas_{src}.txt"), "w") as f:
            f.write(report)
        kernel = None
        for line in report.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "Used" in line and "registers" in line:
                emit(phase="ptxas", source=src, kernel=kernel,
                     report=line.split("Used", 1)[1].strip())
            elif "spill" in line:
                emit(phase="ptxas", source=src, kernel=kernel,
                     spills=line.strip())
        emit(phase="build", source=src, nvcc_seconds=round(seconds, 3))


def wgrad_tolerance(x, g):
    """Per (dy, dx, c): 1e-5 * sum_{b,h,w} |xpad * g|, in float64."""
    import torch
    import torch.nn.functional as F

    _, h, w, c = x.shape
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    gd = g.double()
    return 1e-5 * torch.stack(
        [(xp[:, dy:dy + h, dx:dx + w] * gd).abs().sum((0, 1, 2))
         for dy in range(3) for dx in range(3)]).reshape(3, 3, c)


def check(shape, dtype, gen, tiles=None) -> dict:
    """The tma kernels against the plain versions at one shape; ``tiles``
    forces a (th, tw, cb) plan. Raises on a failed check."""
    import torch

    from ddw_tpu_torch.ops import depthwise_conv as dc

    b, h, w, c = shape
    x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    taps = torch.randn(3, 3, c, device="cuda", generator=gen).to(dtype)
    g = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    plan = (dc.dw_tile_plan(b, h, w, c, dtype) if tiles is None else
            dc._tile_plan_of(b, h, w, c, x.element_size(), *tiles))
    if plan is None:
        raise RuntimeError(f"tiles {tiles} make no plan for {shape} {dtype}")
    for flip in (False, True):
        y = dc.depthwise_conv3x3_cuda(x, taps, flip=flip, _variant="tma",
                                      _plan=plan)
        ref = dc.depthwise_conv3x3_plain(x, taps, flip=flip)
        if not torch.equal(y, ref):
            err = (y.float() - ref.float()).abs().max().item()
            raise RuntimeError(f"K1 tma {shape} {dtype} flip={flip}: max "
                               f"|err| {err}")
    d1 = dc.depthwise_conv3x3_wgrad_cuda(x, g, _variant="tma", _plan=plan)
    d2 = dc.depthwise_conv3x3_wgrad_cuda(x, g, _variant="tma", _plan=plan)
    ratio = ((d1.double() - dc.depthwise_conv3x3_wgrad_plain(x, g).double())
             .abs() / wgrad_tolerance(x, g)).max().item()
    if not (torch.equal(d1, d2) and ratio <= 1.0):
        raise RuntimeError(f"K2 tma {shape} {dtype}: bit-identical "
                           f"{torch.equal(d1, d2)}, error/tolerance {ratio}")
    return {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "plan": plan._asdict(), "k1_bit_identical": True,
            "k2_err_over_tolerance": ratio, "k2_bit_identical": True}


def time_layer(hwc, dtype, gen, flush, reps: int) -> dict:
    import torch

    from ddw_tpu_torch.ops import depthwise_conv as dc

    h, w, c = hwc
    x = torch.randn(BATCH, h, w, c, device="cuda", generator=gen).to(dtype)
    taps = torch.randn(3, 3, c, device="cuda", generator=gen).to(dtype)
    g = torch.randn(BATCH, h, w, c, device="cuda", generator=gen).to(dtype)
    cl, gl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    wl = taps.permute(2, 0, 1).unsqueeze(1).contiguous()
    elems, nbytes = BATCH * h * w * c, x.element_size()
    k1 = {"tma": lambda: dc.depthwise_conv3x3_cuda(x, taps, _variant="tma"),
          "simt": lambda: dc.depthwise_conv3x3_cuda(x, taps, _variant="simt")}
    k2 = {"tma": lambda: dc.depthwise_conv3x3_wgrad_cuda(x, g, _variant="tma"),
          "simt": lambda: dc.depthwise_conv3x3_wgrad_cuda(x, g,
                                                          _variant="simt")}
    y = torch.empty_like(x)
    row = {"shape": [BATCH, h, w, c],
           "dtype": str(dtype).removeprefix("torch."),
           "plan": dc.dw_tile_plan(BATCH, h, w, c, dtype)._asdict(),
           "copy_ms": median_ms(lambda: y.copy_(x), flush, reps)}
    # bytes beyond one read of x: K1 writes y and reads the taps, K2 reads g
    # and writes f32 [3, 3, C]
    for name, fns, lib, out_bytes in (
            ("k1", k1, lambda: torch.nn.functional.conv2d(
                cl, wl, padding=1, groups=c), elems * nbytes + 9 * c * nbytes),
            ("k2", k2, lambda: torch.ops.aten.convolution_backward(
                gl, cl, wl, None, [1, 1], [1, 1], [1, 1], False, [0, 0], c,
                [False, True, False]), elems * nbytes + 9 * c * 4)):
        turns = {"tma": [], "simt": []}
        for variant in ("tma", "simt", "simt", "tma"):
            turns[variant].append(median_ms(fns[variant], flush, reps))
        bound = (elems * nbytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        row[name] = {"tma_ms": turns["tma"], "simt_ms": turns["simt"],
                     "library_ms": median_ms(lib, flush, reps),
                     "bound_ms": bound,
                     "share_of_bound": bound / min(turns["tma"])}
    return row


def sweep_layer(hwc, gen, flush, reps: int) -> dict:
    """The bf16 tma kernels at one layer on the plan's own tiles, on the
    ``SWEEP`` alternatives and on rings of 3 and 4 stages (the plan's
    tiles)."""
    import torch

    from ddw_tpu_torch.ops import depthwise_conv as dc

    h, w, c = hwc
    x, g = (torch.randn(BATCH, h, w, c, device="cuda",
                        generator=gen).bfloat16() for _ in range(2))
    taps = torch.randn(3, 3, c, device="cuda", generator=gen).bfloat16()
    own = dc.dw_tile_plan(BATCH, h, w, c, torch.bfloat16)
    plans = {"own": own,
             **{str(t): dc._tile_plan_of(BATCH, h, w, c, 2, *t)
                for t in SWEEP[hwc]},
             **{f"stages_{n}": own._replace(stages=n) for n in (3, 4)}}
    rows = {}
    for name, plan in plans.items():
        rows[name] = {
            "tiles": [plan.th, plan.tw, plan.cb], "stages": plan.stages,
            "k1_ms": median_ms(lambda: dc.depthwise_conv3x3_cuda(
                x, taps, _plan=plan), flush, reps),
            "k2_ms": median_ms(lambda: dc.depthwise_conv3x3_wgrad_cuda(
                x, g, _plan=plan), flush, reps)}
    return {"shape": [BATCH, h, w, c], "plans": rows}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16"],
                    choices=["bfloat16", "float32"])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dw_profile: no CUDA card", file=sys.stderr)
        return 2
    from ddw_tpu_torch.ops import _build

    build(args.out or _build.BUILD_DIR)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for (h, w, c), _ in DW_SHAPES:
            emit(phase="check", **check((BATCH, h, w, c), dtype, gen))
        for shape, tiles in EDGES:
            emit(phase="check", edge=True, **check(shape, dtype, gen, tiles))
    if not args.check_only:
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        for name in args.dtypes:
            dtype = getattr(torch, name)
            per_pass = {k: {"tma_ms": 0.0, "simt_ms": 0.0, "library_ms": 0.0,
                            "bound_ms": 0.0} for k in ("k1", "k2")}
            copy_ms = 0.0
            for hwc, layers in DW_SHAPES:
                row = time_layer(hwc, dtype, flush=flush, gen=gen,
                                 reps=args.reps)
                emit(phase="time", layers_per_pass=layers, **row)
                copy_ms += layers * row["copy_ms"]
                for k in ("k1", "k2"):
                    for key in ("tma_ms", "simt_ms"):
                        per_pass[k][key] += layers * min(row[k][key])
                    for key in ("library_ms", "bound_ms"):
                        per_pass[k][key] += layers * row[k][key]
            for k, v in per_pass.items():
                emit(phase="pass", kernel=k, dtype=name,
                     share_of_bound=v["bound_ms"] / v["tma_ms"], **v,
                     copy_ms=copy_ms,
                     per="one pass at batch 128 over the 13 stride-1 layers, "
                         "the faster of each variant's two turns")
        if args.sweep:
            for hwc, _ in DW_SHAPES:
                emit(phase="sweep", **sweep_layer(hwc, gen, flush, args.reps))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
