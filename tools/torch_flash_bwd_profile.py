#!/usr/bin/env python3
"""K4 and K5, the flash-attention backward, by variant on the card
(ddw_tpu_torch).

    python3 tools/torch_flash_bwd_profile.py [--reps N] [--check-only]
                                             [--out DIR] [--head-dim D ...]
                                             [--dtype bfloat16|float16|float32 ...]
    python3 tools/torch_flash_bwd_profile.py --tree LABEL=DIR [--tree ...]
                                             [--order L1,L2,L2,L1]
                                             [--shapes 256x64 128x128 ...]

Builds ``csrc/flash_bwd_sm90.cu`` and ``csrc/flash_attention_bwd.cu`` (one
``nvcc`` each, together), prints ptxas's register, spill and shared-memory
report of the sm90 kernels and writes both sources' full reports (with any
note that it serialised ``wgmma``) to ``--out``, by default the git-ignored
build directory ``ddw_tpu_torch/ops/build/``. Then holds the ``sm90``
variant (TMA, ``wgmma``) and the ``mma`` variant (``mma.sync``) of K4 (dQ)
and K5 (dK/dV) against ``flash_attention_dq_plain`` and
``flash_attention_dkv_plain`` on the same inputs, with ``chip_smoke.py``'s
backward tolerance (|err| <= max(2 ulp of the dtype, 5e-3 * max|ref|)
elementwise; f32 1e-5 * max|ref|), at the LM's training shape and at the
edges the sm90 design meets (query and key tail tiles, offsets, ring hops
with fully masked rows, which must get exactly zero dq, a key mask inside a
block, head dim 128), checks that two launches give the same bits, and that
sm90 writes no output column at or past d (one more launch into NaN-filled
buffers one compiled width longer). Unless ``--check-only``: times both at
[32 * 512 / D, 2048, D] (the LM's hidden width over D-wide heads, so a
call's FLOPs stay the LM's), causal in turns (sm90, mma, mma, sm90) and
non-causal, each kernel and the whole backward (delta + K4 + K5, as
``FlashAttentionFn.backward`` runs it), beside the backward of
``F.scaled_dot_product_attention`` (dq, dk and dv in one call) and the
bounds (CUDA events, median of N single launches, the L2 flushed before
each). ``--head-dim`` and ``--dtype`` take several values: every pair runs,
on the kernels that shape takes (``_bwd_variant``: sm90 and mma side by
side only where sm90 takes it, else its one kernel); the head-dim-64 cases
are scaled to each D. Prints one JSON line per result and the card's name
and power limit. Needs a CUDA card; exits 2 without one.

``--tree LABEL=DIR`` (given twice or more) times K4 and K5 of several
checkouts in turns instead: each DIR is the root of a checkout of this
repository (``.`` for this one; another commit unpacked with ``git
archive`` into a git-ignored directory, or a copy with an edited kernel).
Every tree builds its own flash-attention sources (all at once, before any
timing; the line counts the sm90 backward's spill-free kernels and
ptxas's notes of injected fences and serialised wgmma), then each label of
``--order`` (default: each label, then each again in reverse) runs in a
fresh process that imports that tree's ``ddw_tpu_torch`` and times
``flash_attention_dq_cuda`` and ``flash_attention_dkv_cuda`` (the variant
its own ``_bwd_variant`` picks) at each ``BHxD`` shape of ``--shapes`` over
2,048 tokens in bf16, causal and non-causal, with this tool's timer
(``--reps`` launches, 40 by default here). The last line before the card's
name gives each label's median over its runs and, for each shape, the pairs
(the n-th run of a label against the n-th run of the first label) in which
that label was faster.
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
    if got.dtype == torch.float32:
        tol = torch.full_like(err, 1e-5 * top)
    else:
        mag = ref.float().abs().clamp_min(torch.finfo(got.dtype).tiny)
        bits = 7 if got.dtype == torch.bfloat16 else 10
        tol = torch.maximum(
            2 * torch.exp2(torch.floor(torch.log2(mag)) - bits),
            torch.full_like(err, 5e-3 * top))
    ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
    return ok, err.max().item(), (err / tol).max().item()


def kernels_for(dtype, d: int) -> tuple[str, ...]:
    """The kernels to hold and time at this dtype and head dim: sm90 and
    mma in turns where the shape takes sm90, else the one it takes."""
    from ddw_tpu_torch.ops.flash_attention import _bwd_variant

    variant = _bwd_variant(dtype, d)
    return KERNELS if variant == "sm90" else (variant,)


def sm90_writes_nothing_past_d(q, k, v, args, k_valid, dq, dk, dv) -> bool:
    """One more launch of each sm90 C entry into NaN-filled buffers one
    compiled width longer than dq, dk and dv gives their bits and leaves
    the tails NaN: no column at or past d is written (one of a row would
    land on the next row's first columns, which the bits compare, or past
    the last row, in the tail)."""
    import torch

    from ddw_tpu_torch.ops.flash_attention import (_KERNEL_DTYPES,
                                                   _default_scale,
                                                   _sm90_bwd_lib,
                                                   compiled_width)

    _, _, _, do, lse, delta, causal, q_offset, k_offset, _ = args
    bh, sq, d = q.shape
    tail = compiled_width("sm90", d)
    bufs = [torch.full((t.numel() + tail,), float("nan"), dtype=t.dtype,
                       device=t.device) for t in (dq, dk, dv)]
    common = (bh, sq, k.shape[1], d, _KERNEL_DTYPES[q.dtype], int(causal),
              q_offset, k_offset, _default_scale(None, d),
              -1 if k_valid is None else k_valid,
              torch.cuda.current_stream().cuda_stream)
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    lib = _sm90_bwd_lib()
    errs = (lib.ddw_flash_bwd_dq_sm90(*ins, bufs[0].data_ptr(), *common),
            lib.ddw_flash_bwd_dkv_sm90(*ins, bufs[1].data_ptr(),
                                       bufs[2].data_ptr(), *common))
    torch.cuda.synchronize()
    return errs == (0, 0) and all(
        torch.equal(buf[:t.numel()].view_as(t), t)
        and bool(buf[t.numel():].isnan().all())
        for buf, t in zip(bufs, (dq, dk, dv)))


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
    for kernel in kernels_for(q.dtype, q.shape[2]):
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
        if kernel == "sm90":
            row["no_column_past_d"] = sm90_writes_nothing_past_d(
                q, k, v, args, k_valid, **runs[0])
            case_ok &= row["no_column_past_d"]
        if fully_masked_rows:
            row["masked_rows_zero_dq"] = bool(
                (runs[0]["dq"][:, :fully_masked_rows] == 0).all())
            case_ok &= row["masked_rows_zero_dq"]
        row["ok"] = case_ok
        emit(phase="check", **row)
        ok &= case_ok
    return ok


CASES = [
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
    ("kvalid1000", (16, 1024, 2048, 64), dict(causal=False, k_valid=1000)),
    ("d128_causal", (16, 1024, 1024, 128), dict(causal=True)),
    ("noncausal_d128", (16, 1024, 1024, 128), dict(causal=False)),
    ("d128_ragged_q100_k200", (6, 100, 200, 128),
     dict(causal=True, q_offset=100)),
    ("train_shape_causal", (BATCH * HEADS, SEQ, SEQ, HEAD_DIM),
     dict(causal=True)),
]


def run_checks(d_arg: int, dtype, gen) -> bool:
    """CASES on the kernels head dim ``d_arg`` takes in ``dtype``: the
    head-dim-64 cases scaled to ``d_arg`` (batch*heads times 64 / d) unless
    that is the default shape, where every case runs."""
    import torch

    def qkv(bh, sq, sk, d):
        mk = lambda s: torch.randn(bh, s, d, device="cuda", generator=gen)
        return mk(sq).to(dtype), mk(sk).to(dtype), mk(sk).to(dtype)

    cases = CASES
    if (d_arg, dtype) != (HEAD_DIM, torch.bfloat16):  # the same cases at D
        cases = [(name, (bh * HEAD_DIM // d_arg or 1, sq, sk, d_arg), kw)
                 for name, (bh, sq, sk, d), kw in cases if d == HEAD_DIM]
    ok = True
    for name, (bh, sq, sk, d), kw in cases:
        q, k, v = qkv(bh, sq, sk, d)
        ok &= check_case(name, q, k, v, gen, **kw)
        del q, k, v
        torch.cuda.empty_cache()
    return ok


def time_shape(d_arg: int, dtype, gen, flush, reps: int) -> None:
    """K4, K5 and the whole backward at [32 * 512 / D, 2048, D], causal and
    not, on each kernel the shape takes in turns, beside SDPA's backward and
    the bounds: one JSON line each."""
    import torch
    import torch.nn.functional as F

    from ddw_tpu_torch.ops.flash_attention import (flash_attention_dkv_cuda,
                                                   flash_attention_dq_cuda,
                                                   flash_attention_plain)

    kernels = kernels_for(dtype, d_arg)
    heads = max(1, HEADS * HEAD_DIM // d_arg)
    peak = 67e12 if dtype == torch.float32 else BF16_FLOPS  # f32: CUDA cores
    bh, s, d = BATCH * heads, SEQ, d_arg
    mk = lambda: torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype)
    q, k, v = mk(), mk(), mk()
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
        times = {key: {kn: [] for kn in kernels} for key in fns}
        for kn in kernels + kernels[::-1]:
            for key, fn in fns.items():
                times[key][kn].append(median_ms(lambda: fn(kn), flush, reps))
        q4, k4, v4, do4 = (t.view(BATCH, heads, s, d).detach()
                           .requires_grad_(t is not do)
                           for t in (q, k, v, do))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        sdpa = median_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True), flush, reps)
        row = {"shape": [bh, s, d], "dtype": str(dtype)[6:],
               "causal": causal, "ms": times, "sdpa_backward_ms": sdpa,
               "reps": reps}
        for key, products, outs in (("dq", 3, 1), ("dkv", 4, 2)):
            flops = products * 2 * d * pairs
            nbytes = (4 + outs) * bh * s * d * q.element_size() \
                + 2 * bh * s * 4
            bound = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
            best = {kn: min(t) for kn, t in times[key].items()}
            row[key] = {"bound_ms": bound, "flops": flops, "bytes": nbytes,
                        "best_ms": best,
                        "tflops": {kn: flops / t / 1e9
                                   for kn, t in best.items()},
                        "share_of_bound": {kn: bound / t
                                           for kn, t in best.items()}}
            if kernels == KERNELS:
                row[key]["sm90_speedup_over_mma"] = best["mma"] / best["sm90"]
        total = {kn: min(t) for kn, t in times["backward_total"].items()}
        row["backward_total"] = {"best_ms": total,
                                 "over_sdpa": {kn: t / sdpa
                                               for kn, t in total.items()}}
        emit(phase="time", **row)
        del q4, k4, v4, do4, o4, do, out, lse, delta, a, fns
        torch.cuda.empty_cache()


TREE_SHAPES = ("256x64", "128x128", "64x256")


def tree_child(tree: str, label: str, shapes: list, reps: int) -> None:
    """Time one tree's K4 and K5 (in a process of its own, which imports
    that tree's package): one JSON line."""
    sys.path.insert(0, tree)
    import torch

    from ddw_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {tree}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"phase": "tree", "label": label, "tree": tree}
    for shape in shapes:
        bh, d = (int(x) for x in shape.split("x"))
        q, k, v, do = (torch.randn(bh, SEQ, d, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        row[f"{shape}_variant"] = fa._bwd_variant(q.dtype, d)
        for causal in (True, False):
            out, lse = fa.flash_attention_cuda(q, k, v, causal)
            delta = (do.float() * out.float()).sum(-1).contiguous()
            a = (q, k, v, do, lse, delta, causal)
            tag = f"{shape}_{'causal' if causal else 'noncausal'}"
            row[f"{tag}_dq_ms"] = median_ms(
                lambda: fa.flash_attention_dq_cuda(*a), flush, reps)
            row[f"{tag}_dkv_ms"] = median_ms(
                lambda: fa.flash_attention_dkv_cuda(*a), flush, reps)
        del q, k, v, do, out, lse, delta
    emit(**row)


def tree_build(tree: str) -> dict:
    """Build one tree's backward sources and its sm90 forward (for the lse)
    in a process of its own (the mma.sync backward for shapes the tree's
    sm90 one does not take): seconds, and the sm90 backward's spill-free
    kernels and ptxas's notes of injected fences (C7519) or serialised
    wgmma (C7510)."""
    code = ("import json; from concurrent.futures import ThreadPoolExecutor; "
            "from ddw_tpu_torch.ops import _build; "
            "srcs = ('flash_bwd_sm90.cu', 'flash_attention_bwd.cu', "
            "'flash_fwd_sm90.cu'); "
            "b = list(ThreadPoolExecutor(3).map(_build.build, srcs)); "
            "r = b[0][2]; "
            "print(json.dumps({'seconds': max(x[1] for x in b), "
            "'spill_free_kernels': "
            "r.count(' 0 bytes spill stores, 0 bytes spill loads'), "
            "'injected_fences': r.count('C7519'), "
            "'serialised_wgmma': r.count('C7510')}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare_trees(specs: list, order: str | None, shapes: list,
                  reps: int) -> dict:
    """Build every tree, time each label of the order in a fresh process,
    and count the pairs each label wins against the first."""
    from concurrent.futures import ThreadPoolExecutor

    trees = {label: os.path.abspath(path)
             for label, path in (t.split("=", 1) for t in specs)}
    with ThreadPoolExecutor(len(trees)) as pool:
        for label, report in zip(trees, pool.map(tree_build, trees.values())):
            emit(phase="tree_build", label=label, **report)
    labels = list(trees)
    runs = {label: [] for label in labels}
    for label in (order.split(",") if order else labels + labels[::-1]):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree-child",
             trees[label], label, "--shapes", *shapes, "--reps", str(reps)],
            capture_output=True, text=True, check=True).stdout
        print(out, end="", flush=True)
        runs[label].append(next(row for row in map(json.loads,
                                                   out.splitlines())
                                if row.get("phase") == "tree"))
    first = labels[0]
    wins, medians = {}, {}
    for label in labels:
        medians[label] = {key: sorted(r[key] for r in runs[label])[
            len(runs[label]) // 2] for key in runs[label][0]
            if key.endswith("_ms")}
    for label in labels[1:]:
        pairs = list(zip(runs[first], runs[label]))
        wins[label] = {key: sum(b[key] < a[key] for a, b in pairs)
                       for key in runs[first][0] if key.endswith("_ms")}
        wins[label]["pairs"] = len(pairs)
    return {"against": first, "wins": wins, "medians": medians}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=None,
                    help="launches a median (default 20; 40 with --tree)")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--order", default=None)
    ap.add_argument("--shapes", nargs="+", default=list(TREE_SHAPES))
    ap.add_argument("--tree-child", nargs=2, metavar=("DIR", "LABEL"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out", default=os.path.join(
                        os.path.dirname(os.path.dirname(os.path.abspath(
                            __file__))), "ddw_tpu_torch", "ops", "build"),
                    help="directory for the full ptxas reports")
    ap.add_argument("--head-dim", type=int, nargs="+", default=[HEAD_DIM])
    ap.add_argument("--dtype", nargs="+", default=["bfloat16"],
                    choices=("bfloat16", "float16", "float32"))
    args = ap.parse_args()
    if args.reps is None:
        args.reps = 40 if args.tree or args.tree_child else 20
    if args.tree_child:
        tree_child(*args.tree_child, args.shapes, args.reps)
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.tree:
        if len(args.tree) < 2:
            ap.error("--tree needs two trees or more")
        emit(phase="tree_wins", **compare_trees(
            args.tree, args.order, args.shapes, args.reps))
        print(smi, flush=True)
        return 0
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from ddw_tpu_torch.ops import _build

    sources = ["flash_bwd_sm90.cu", "flash_attention_bwd.cu"]
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
                                 if src != "flash_attention_bwd.cu" and not any(
                                     w in ln for w in ("Function properties",
                                                       "Compile time"))])

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(d, getattr(torch, t)) for d in args.head_dim
              for t in args.dtype]
    ok = True
    for d, dtype in shapes:
        ok &= run_checks(d, dtype, gen)
    emit(phase="check", all_ok=ok)
    if not args.check_only:
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        for d, dtype in shapes:
            time_shape(d, dtype, gen, flush, args.reps)
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    sys.exit(rc)
