#!/usr/bin/env python3
"""K4 and K5, the flash-attention backward, by variant on the card
(ddw_tpu_torch).

    python3 tools/torch_flash_bwd_profile.py [--reps N] [--check-only]
                                             [--out DIR]

Builds ``csrc/flash_bwd_sm90.cu`` and ``csrc/flash_attention.cu`` (one
``nvcc`` each, together), prints ptxas's register, spill and shared-memory
report of the sm90 kernels and writes both sources' full reports (with any
note that it serialised ``wgmma``) to ``--out``, by default the git-ignored
build directory ``ddw_tpu_torch/ops/build/``. Then holds the ``sm90``
variant (TMA, ``wgmma``) and the ``mma`` variant (``mma.sync``) of K4 (dQ)
and K5 (dK/dV) against ``flash_attention_dq_plain`` and
``flash_attention_dkv_plain`` on the same inputs, with ``chip_smoke.py``'s
backward tolerance (bf16: |err| <= max(2 bf16 ulp, 5e-3 * max|ref|)
elementwise), at the LM's training shape and at the edges the sm90 design
meets (query and key tail tiles, offsets, ring hops with fully masked rows,
which must get exactly zero dq, a key mask inside a block, head dim 128),
and checks that two launches give the same bits. Unless ``--check-only``:
times both at the LM's [256, 2048, 64] bf16, causal in turns (sm90, mma,
mma, sm90) and non-causal, each kernel and the whole backward (delta + K4 +
K5, as ``FlashAttentionFn.backward`` runs it), beside the backward of
``F.scaled_dot_product_attention`` (dq, dk and dv in one call) and the
bounds (CUDA events, median of N single launches, the L2 flushed before
each). Prints one JSON line per result and the card's name and power limit.
Needs a CUDA card; exits 2 without one.
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
BATCH, HEADS, SEQ, HEAD_DIM = 32, 8, 2048, 64  # the LM train step's attention
KERNELS = ("sm90", "mma")


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


def divisor_block(n: int) -> int:
    """A block that divides n for the plain versions (whose numerics do not
    depend on it beyond the grouping of f32 sums): 128, else 64, else n."""
    return next(b for b in (128, 64, n) if n % b == 0)


def bwd_inputs(q, k, v, gen, causal, q_offset, k_offset, k_valid):
    """do, lse from the plain forward, and delta = rowsum(do * out) - g_lse
    with a nonzero g_lse: what FlashAttentionFn's backward hands K4, K5."""
    import torch

    from ddw_tpu_torch.ops.flash_attention import flash_attention_plain

    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    out, lse = flash_attention_plain(
        q, k, v, causal, q_offset, k_offset, block_q=divisor_block(q.shape[1]),
        block_k=divisor_block(k.shape[1]), k_valid=k_valid)
    g_lse = 0.1 * torch.randn(lse.shape, device="cuda", generator=gen)
    delta = ((do.float() * out.float()).sum(-1) - g_lse).contiguous()
    return do, lse.contiguous(), delta


def close(got, ref):
    import torch

    err = (got.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    tol = torch.maximum(2 * torch.exp2(torch.floor(torch.log2(mag)) - 7),
                        torch.full_like(err, 5e-3 * top))
    ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
    return ok, err.max().item(), (err / tol).max().item()


def check_case(name, q, k, v, gen, *, causal, q_offset=0, k_offset=0,
               k_valid=None, fully_masked_rows=0):
    import torch

    from ddw_tpu_torch.ops.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dkv_plain,
        flash_attention_dq_cuda, flash_attention_dq_plain)

    do, lse, delta = bwd_inputs(q, k, v, gen, causal, q_offset, k_offset,
                                k_valid)
    args = (q, k, v, do, lse, delta, causal, q_offset, k_offset, None)
    blocks = (divisor_block(q.shape[1]), divisor_block(k.shape[1]), k_valid)
    ref = {"dq": flash_attention_dq_plain(*args, *blocks)}
    ref["dk"], ref["dv"] = flash_attention_dkv_plain(*args, *blocks)
    ok = True
    for kernel in KERNELS:
        runs = []
        for _ in range(2):
            dq = flash_attention_dq_cuda(*args, k_valid, _variant=kernel)
            dk, dv = flash_attention_dkv_cuda(*args, k_valid, _variant=kernel)
            runs.append({"dq": dq, "dk": dk, "dv": dv})
        torch.cuda.synchronize()
        row = {"case": name, "variant": kernel, "shape": list(q.shape),
               "sk": k.shape[1], "causal": causal, "q_offset": q_offset,
               "k_offset": k_offset, "k_valid": k_valid,
               "identical_bits": all(torch.equal(runs[0][n], runs[1][n])
                                     for n in ref)}
        case_ok = row["identical_bits"]
        for n in ref:
            good, err, worst = close(runs[0][n], ref[n])
            row[n] = {"ok": good, "max_abs_err": err, "worst_err_over_tol":
                      worst}
            case_ok &= good
        if fully_masked_rows:
            row["masked_rows_zero_dq"] = bool(
                (runs[0]["dq"][:, :fully_masked_rows] == 0).all())
            case_ok &= row["masked_rows_zero_dq"]
        row["ok"] = case_ok
        emit(phase="check", **row)
        ok &= case_ok
    return ok


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
    torch.backends.cuda.matmul.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from ddw_tpu_torch.ops import _build
    from ddw_tpu_torch.ops.flash_attention import (flash_attention_dkv_cuda,
                                                   flash_attention_dq_cuda,
                                                   flash_attention_plain)

    sources = ["flash_bwd_sm90.cu", "flash_attention.cu"]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    os.makedirs(args.out, exist_ok=True)
    for src, (_, seconds, report) in zip(sources, built):
        path = os.path.join(args.out, f"ptxas_{src}.txt")
        with open(path, "w") as f:
            f.write(report)
        # the sm90 kernels' names, registers, spills, and any note of
        # ptxas's (serialised wgmma, for one)
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
        ("ragged_q100_at100_k200", (6, 100, 200, 64),
         dict(causal=True, q_offset=100)),
        ("q_tail_sq200", (3, 200, 256, 64), dict(causal=True)),
        ("k_tail_sq256_sk200", (3, 256, 200, 64), dict(causal=False)),
        ("sq2112_sk2048_qoff64", (16, 2112, 2048, 64),
         dict(causal=True, q_offset=64)),
        ("ring_hop_k192", (16, 1024, 1024, 64),
         dict(causal=True, k_offset=192, fully_masked_rows=192)),
        ("ring_hop_q1000_k1152", (16, 1024, 1024, 64),
         dict(causal=True, q_offset=1000, k_offset=1152,
              fully_masked_rows=152)),
        ("kvalid1000", (16, 1024, 2048, 64),
         dict(causal=False, k_valid=1000)),
        ("d128_causal", (16, 1024, 1024, 128), dict(causal=True)),
        ("noncausal_d128", (16, 1024, 1024, 128), dict(causal=False)),
        ("d128_ragged_q100_k200", (6, 100, 200, 128),
         dict(causal=True, q_offset=100)),
        ("train_shape_causal", (BATCH * HEADS, SEQ, SEQ, HEAD_DIM),
         dict(causal=True)),
    ]
    for name, (bh, sq, sk, d), kw in cases:
        q, k, v = qkv(bh, sq, sk, d)
        ok &= check_case(name, q, k, v, gen, **kw)
        del q, k, v
        torch.cuda.empty_cache()
    emit(phase="check", all_ok=ok)
    if args.check_only:
        print(smi, flush=True)
        return 0 if ok else 1

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bh, s, d = BATCH * HEADS, SEQ, HEAD_DIM
    q, k, v = qkv(bh, s, s, d)
    for causal in (True, False):
        do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        out, lse = flash_attention_plain(q, k, v, causal)
        g_lse = torch.zeros_like(lse)
        delta = ((do.float() * out.float()).sum(-1) - g_lse).contiguous()
        a = (q, k, v, do, lse, delta, causal)
        pairs = bh * visible_pairs(s, s, causal)

        def backward_total(kn):  # FlashAttentionFn.backward's kernel calls
            dl = ((do.float() * out.float()).sum(-1) - g_lse).contiguous()
            flash_attention_dq_cuda(q, k, v, do, lse, dl, causal, _variant=kn)
            flash_attention_dkv_cuda(q, k, v, do, lse, dl, causal,
                                     _variant=kn)

        fns = {
            "dq": lambda kn: flash_attention_dq_cuda(*a, _variant=kn),
            "dkv": lambda kn: flash_attention_dkv_cuda(*a, _variant=kn),
            "backward_total": backward_total}
        times = {key: {kn: [] for kn in KERNELS} for key in fns}
        for kn in KERNELS + KERNELS[::-1]:
            for key, fn in fns.items():
                times[key][kn].append(median_ms(lambda: fn(kn), flush,
                                                args.reps))
        q4, k4, v4, do4 = (t.view(BATCH, HEADS, s, d).detach()
                           .requires_grad_(t is not do)
                           for t in (q, k, v, do))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        sdpa = median_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True), flush, args.reps)
        row = {"shape": [bh, s, d], "causal": causal, "ms": times,
               "sdpa_backward_ms": sdpa, "reps": args.reps}
        for key, products, outs in (("dq", 3, 1), ("dkv", 4, 2)):
            flops = products * 2 * d * pairs
            nbytes = (4 + outs) * bh * s * d * 2 + 2 * bh * s * 4
            bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
            best = {kn: min(t) for kn, t in times[key].items()}
            row[key] = {"bound_ms": bound, "flops": flops, "bytes": nbytes,
                        "best_ms": best,
                        "tflops": {kn: flops / t / 1e9
                                   for kn, t in best.items()},
                        "share_of_bound": {kn: bound / t
                                           for kn, t in best.items()},
                        "sm90_speedup_over_mma": best["mma"] / best["sm90"]}
        total = {kn: min(t) for kn, t in times["backward_total"].items()}
        row["backward_total"] = {"best_ms": total,
                                 "over_sdpa": {kn: t / sdpa
                                               for kn, t in total.items()}}
        emit(phase="time", **row)
        del q4, k4, v4, do4, o4, do, out, lse, delta, a, fns
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    sys.exit(rc)
