#!/usr/bin/env python3
"""K3, the flash-attention forward, by variant on the card (ddw_tpu_torch).

    python3 tools/torch_flash_fwd_profile.py [--reps N] [--check-only]
                                             [--out DIR]

Builds ``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_attention.cu`` (one
``nvcc`` each, together), prints ptxas's register, spill and shared-memory
report of the sm90 kernels and writes both sources' full reports (with any
note that it serialised ``wgmma``) to ``--out``, by default the
git-ignored build directory ``ddw_tpu_torch/ops/build/``. Then holds the ``sm90`` variant (TMA, ``wgmma``) and the
``mma`` variant (``mma.sync``) against ``flash_attention_plain`` on the same
inputs, with ``chip_smoke.py``'s K3 tolerances (bf16: |dout| <= max(2 bf16
ulp, 1e-3 * max|v|), |dlse| <= 1e-4 * max(1, |lse|)), at the LM slice's
shape and at the edges the sm90 design creates (a query tail tile, offsets,
a ring hop with fully masked rows, a key mask inside a block, head dim
128), and checks that two launches give the same bits. Unless
``--check-only``: times both at the LM's [512, 2048, 64] and [256, 2048,
64], causal in turns (sm90, mma, mma, sm90) and non-causal, beside
``F.scaled_dot_product_attention`` and the bound (CUDA events, median of N
single launches, the L2 flushed before each). Prints one JSON line per
result and the card's name and power limit. Needs a CUDA card; exits 2
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

BF16_FLOPS = 989e12        # H100 SXM, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
HEADS, SEQ, HEAD_DIM = 8, 2048, 64


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


def visible_pairs(sq, sk, causal, q_offset=0, k_offset=0, k_valid=None):
    import numpy as np

    kpos = k_offset + np.arange(sk)
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kpos[None, :] <= (q_offset + np.arange(sq))[:, None]
    if k_valid is not None:
        keep &= kpos[None, :] < k_valid
    return int(keep.sum())


KERNELS = ("sm90", "mma")


def flops_full(bh: int) -> int:
    """Q.K^T and P.V over every (query, key) pair at the LM's shape."""
    return 2 * 2 * bh * SEQ * SEQ * HEAD_DIM


def ref_block_q(sq: int) -> int:
    """A query block that divides Sq for the plain version (whose numerics
    do not depend on it): 128, else 64, else all of Sq."""
    return next(b for b in (128, 64, sq) if sq % b == 0)


def launch(kernel, q, k, v, causal, q_offset=0, k_offset=0, k_valid=None):
    """One K3 launch of ``kernel`` ("sm90" or "mma")."""
    from ddw_tpu_torch.ops.flash_attention import flash_attention_cuda

    return flash_attention_cuda(q, k, v, causal, q_offset, k_offset,
                                k_valid=k_valid, _variant=kernel)


def check_case(name, q, k, v, variant, *, causal, q_offset=0, k_offset=0,
               k_valid=None, fully_masked_rows=0):
    import torch

    from ddw_tpu_torch.ops.flash_attention import flash_attention_plain

    run = lambda: launch(variant, q, k, v, causal, q_offset, k_offset,
                         k_valid)
    out, lse = run()
    out2, lse2 = run()
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q, k, v, causal, q_offset, k_offset,
                                         block_q=ref_block_q(q.shape[1]),
                                         k_valid=k_valid)
    err = (out.float() - ref.float()).abs()
    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    tol = torch.maximum(2 * ulp, torch.full_like(err, 1e-3 * v.float().abs()
                                                 .max().item()))
    live = slice(fully_masked_rows, None)
    lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0))[:, live]
    row = {"case": name, "variant": variant, "shape": list(q.shape),
           "sk": k.shape[1], "causal": causal, "q_offset": q_offset,
           "k_offset": k_offset, "k_valid": k_valid,
           "max_abs_err": err.max().item(),
           "worst_err_over_tol": (err / tol).max().item(),
           "lse_max_rel_err": lse_err.max().item(),
           "out_ok": bool((err <= tol).all()) and bool(
               torch.isfinite(out).all()),
           "lse_ok": lse_err.max().item() <= 1e-4,
           "identical_bits": bool(torch.equal(out, out2)
                                  and torch.equal(lse, lse2))}
    if fully_masked_rows:
        dead = slice(0, fully_masked_rows)
        row["masked_rows_ok"] = bool((out[:, dead] == 0).all()) and bool(
            (lse[:, dead] <= -1e29).all())
    if not row["out_ok"]:  # where the first bad element is
        bad = (err > tol).nonzero()[0].tolist()
        row["first_bad"] = bad
        row["first_bad_got_ref"] = [out[tuple(bad)].item(),
                                    ref[tuple(bad)].item()]
    emit(phase="check", **row)
    return row["out_ok"] and row["lse_ok"] and row["identical_bits"] and \
        row.get("masked_rows_ok", True)


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out", default=os.path.join(
                        os.path.dirname(os.path.dirname(os.path.abspath(
                            __file__))), "ddw_tpu_torch", "ops", "build"),
                    help="directory for the full ptxas reports")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    from concurrent.futures import ThreadPoolExecutor

    from ddw_tpu_torch.ops import _build

    sources = ["flash_fwd_sm90.cu", "flash_attention.cu"]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    os.makedirs(args.out, exist_ok=True)
    for src, (_, seconds, report) in zip(sources, built):
        path = os.path.join(args.out, f"ptxas_{src}.txt")
        with open(path, "w") as f:
            f.write(report)
        # the kernels' names, registers, spills, and any note of ptxas's
        # (serialised wgmma, for one)
        emit(phase="build", source=src, nvcc_seconds=round(seconds, 3),
             report=path, ptxas=[ln.strip()[:160] for ln in report.splitlines()
                                 if src != "flash_attention.cu" and not any(
                                     w in ln for w in ("Function properties",
                                                       "Compile time"))])

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(bh, sq, sk, d):
        mk = lambda s: torch.randn(bh, s, d, device="cuda", generator=gen)
        return (mk(sq).to(torch.bfloat16), mk(sk).to(torch.bfloat16),
                mk(sk).to(torch.bfloat16))

    ok = True
    cases = [
        ("small_causal", (2, 256, 256, 64), dict(causal=True)),
        ("small_noncausal", (2, 256, 256, 64), dict(causal=False)),
        ("q_tail_sq200", (3, 200, 256, 64), dict(causal=True)),
        ("sq2112_sk2048_qoff64", (16, 2112, 2048, 64),
         dict(causal=True, q_offset=64)),
        ("ring_hop_q1000_k1152", (16, 1024, 1024, 64),
         dict(causal=True, q_offset=1000, k_offset=1152,
              fully_masked_rows=152)),
        ("kvalid1000", (16, 1024, 2048, 64),
         dict(causal=False, k_valid=1000)),
        ("d128_causal", (16, 1024, 1024, 128), dict(causal=True)),
        ("noncausal_d128", (16, 1024, 1024, 128), dict(causal=False)),
        ("slice_causal", (512, SEQ, SEQ, HEAD_DIM), dict(causal=True)),
    ]
    for name, (bh, sq, sk, d), kw in cases:
        q, k, v = qkv(bh, sq, sk, d)
        for kernel in KERNELS:
            ok &= check_case(name, q, k, v, kernel, **kw)
        del q, k, v
    emit(phase="check", all_ok=ok)
    if args.check_only:
        print(smi, flush=True)
        return 0 if ok else 1

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for batch in (64, 32):
        bh = batch * HEADS
        q, k, v = qkv(bh, SEQ, SEQ, HEAD_DIM)
        flops = 4 * HEAD_DIM * bh * visible_pairs(SEQ, SEQ, True)
        nbytes = 4 * bh * SEQ * HEAD_DIM * 2 + bh * SEQ * 4
        times = {kernel: [] for kernel in KERNELS}
        for kernel in KERNELS + KERNELS[::-1]:
            times[kernel].append(median_ms(
                lambda: launch(kernel, q, k, v, True), flush, args.reps))
        q4, k4, v4 = (t.view(batch, HEADS, SEQ, HEAD_DIM) for t in (q, k, v))
        sdpa = median_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), flush, args.reps)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        best = {kernel: min(t) for kernel, t in times.items()}
        noncausal = {kernel: median_ms(lambda: launch(kernel, q, k, v, False),
                                       flush, args.reps)
                     for kernel in KERNELS}
        noncausal["sdpa"] = median_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4), flush,
            args.reps)
        emit(phase="time", shape=[bh, SEQ, HEAD_DIM], causal=True,
             ms=times, sdpa_ms=sdpa, bound_ms=bound, flops=flops,
             tflops={kn: flops / t / 1e9 for kn, t in best.items()},
             sm90_speedup_over_mma=best["mma"] / best["sm90"],
             sm90_over_sdpa=best["sm90"] / sdpa,
             sm90_share_of_bound=bound / best["sm90"],
             noncausal_ms=noncausal, noncausal_flops=flops_full(bh),
             reps=args.reps)
        del q, k, v, q4, k4, v4
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    sys.exit(rc)
