#!/usr/bin/env python3
"""Smoke run of ddw_tpu_torch on one NVIDIA card: build, check and time the
port's CUDA kernels, then drive the serving, training, workshop (the
example chain), vision-family, pretrained-transfer, LM-scoring,
LM-training, online-serving and collective main paths end to end.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing one JSON line; any failure exits non-zero:

1. device — the card's name, and ``nvidia-smi``'s name and power limit.
   Without CUDA the script exits 2 at once.
2. build  — compile every kernel of the path from ``ddw_tpu_torch/ops/csrc``
   with ``nvcc`` (one process per source, all started together).
2b. decode — the JPEG decoder this machine resolves (``native``: the libjpeg
   pipeline of ``ddw_tpu_torch/native``, built with g++ at first use; or
   ``pil``, the reference's fallback, printed with the build error). With
   the native pipeline: ``decode_batch_native`` equal to
   ``decode_one_native`` image by image on 128 seeded 256 px JPEGs, within
   the reference's PIL closeness (mean |diff| < 0.08), and the images/s of
   one batch call at 224 px beside the host's core count (a host number).
3. kernel — at the six stride-1 shapes of MobileNetV2-224 at batch 128, in
   bf16 and f32 (TF32 off): the depthwise 3x3 kernel (K1, the ``"tma"``
   variant of ``depthwise_sm90.cu`` that the shape picks) equal to its plain
   PyTorch version bit for bit, with and without ``flip``; the
   weight-gradient kernel (K2, ``"tma"``) against its plain version within
   1e-5 * sum|xpad*g| per (dy, dx, c) (the sum in float64), and two K2
   launches bit-identical; the same at the tile plan's edges (B = 1, 15x13
   and 9x7 at C = 64, C = 40, 200 and 48 not multiples of the channel
   block; tiles on every border), every launch counted on ``"tma"``; the
   C = 13 scalar case on ``"simt"``; the autograd Function's dx
   bit-identical and dw within one bf16 ulp (f32: 1e-5 * sum|xpad*g|) of
   the plain path's autograd. Times (CUDA events, median of 25 single
   launches, L2 flushed before each) for each kernel, ``"tma"`` and
   ``"simt"`` in turns (tma, simt, simt, tma; the faster median of each),
   its plain version and one library call (timed only, the yardstick:
   ``F.conv2d(groups=C)`` for K1, ``aten.convolution_backward`` weight
   gradient for K2), beside the bound.
4. main   — a full-width bf16 MobileNetV2 (width 1.0, 224x224x3, 5 classes,
   ``dw_impl="pallas"``) from seeded random weights is saved with
   ``save_packaged_model``, loaded with ``PackagedModel`` on the card, scores a
   300-image ``raw_u8`` table through ``BatchScorer.score_table`` and predicts
   a few decoded arrays. K1's launch count must be 13 per forward batch,
   all on ``"tma"``; the bf16 logits must equal the plain path's.
   Logits are held against the same package with the plain depthwise on the
   card (bf16: equal argmax wherever the top-2 margin exceeds the tolerance;
   f32: within 1e-3 relative), and ``predict_logits`` images/s is measured.
5. train  — ``Trainer.fit`` trains a full-width unfrozen bf16 MobileNetV2
   (default ``ModelCfg`` freeze fields, so the registry auto-unfreezes;
   ``dw_impl="pallas"``) from a seeded init on a seeded class-dependent
   ``raw_u8`` table (1,152 train, 256 val images at 224x224) for 2 epochs at
   batch 128 with adam, checkpointing; then ``fit(resume=True)`` to epoch 3
   continues at epoch 2. Checks: 26 K1 launches (13 forward, 13 dx) and 13
   K2 launches per train step, 13 K1 per eval batch, all on ``"tma"``;
   finite losses, epoch 2
   below epoch 1; one train step with the kernels against one with the
   plain depthwise from the same weights and batch (bf16 loss within 2e-2
   relative, f32 per-leaf gradients within 1e-3 of the leaf's max |grad|,
   TF32 off); the checkpoint's weights served through
   ``save_packaged_model`` -> ``PackagedModel`` -> ``BatchScorer`` on the
   val table, at the trainer's val accuracy. Step ms (median of 10) and
   training images/s. Last, one more resumed epoch with ``trace_dir`` and
   ``monitor_interval_s`` set: its K1/K2 counts and variants those of the
   untraced resumed epoch, the Chrome trace naming K1's and K2's kernels
   (``dw3x3_fwd_tma_kernel`` once per K1 launch of the steps,
   ``dw3x3_wgrad_tma_kernel`` once per K2 launch), the ``trace_dir`` param
   and the ``sys.device_hbm_*`` series in the run; the traced epoch's
   seconds beside the untraced one's.
5b. workshop — the workshop chain (BASELINE.json configs 1, 3, 4, 5)
   through ``examples_torch``'s ``main(argv)`` in this process, on a seeded
   synthetic flowers tree (5 classes x 64 JPEGs at 256 px; 288 train, 32 val
   at 224x224), at full width (MobileNetV2 1.0, bf16, ``dw_impl="pallas"``):
   01 single-process and then with 2 ETL workers and ``--materialize``
   (split membership and label index equal; raw_u8 at 224); config 1, 02
   with SmallCNN in f32 for 1 epoch (val accuracy and images/s, no
   threshold); config 3, 04 with 4 TPE trials 2 at a time on the card (each
   trial thread on its own CUDA stream), unfrozen, 1 epoch at batch 32:
   every trial ``STATUS_OK`` (``fmin`` records a trial that raised as
   failed and goes on, so a kernel that failed would hide there; the errors
   are printed), exactly 4 x 13 x (2 x 9 + 1) K1 and 4 x 13 x 9 K2
   launches, all ``tma``, the best trial registered in Production and the
   HTML report written; 04 ``--cache-features``: 13 K1 launches per
   featurised batch of 64, all ``tma``, and the cached val features within
   2e-2 x max|feature| of the full model's GAP output (the head's input)
   on the same images, then 4 head-only trials; config 4, 05 with 2
   sequential trials, each 2 gloo ranks (processes) that share the card,
   every rank's K1/K2 counts exact and on ``tma``; config 5, the Production
   package scores the val table with ``BatchScorer`` in this process and
   with ``merge=True`` over 2 gloo ranks, and the merged table equals the
   single-process one record for record. Each step's wall seconds.
5c. vision — resnet50, convnext_tiny and ViT (hidden 192, depth 6, 4 heads
   of 48, MLP 768, patch 16) at full width from the trainer's seeded init,
   bf16, batch 128, 224x224: ``Trainer.fit`` for 3 epochs of 3 steps on a
   seeded 384-image class table (finite losses, the last epoch's below the
   first's), the trained weights packaged and ``predict_logits`` over 512
   images (bf16 logits within 0.1 x std, rms, of the same package in f32
   with TF32 off); epoch images/s trained and median images/s scored. ViT
   runs at the default attention thresholds (the xla tier, as in the
   reference: no flash launch) and again in a child process with
   ``DDW_ATTN_XLA_PLAIN_MAX=0 DDW_ATTN_XLA_CKPT_MAX=0``: 6 K3 launches per
   forward and 6 K4 + 6 K5 per train step, all on mma; against the xla
   tier from the same weights and batch, the one-step loss within 5e-3
   relative and every leaf's gradient within 5e-2 RMS gap over RMS (the
   lm_train bf16 bounds), each epoch's train and val loss within 2e-2
   relative, the logits of the package it trained within 0.1 x std (rms)
   of the xla-trained one's, and the same package's logits within 2e-2
   (rms) and 1e-1 (max) x std; its own loss falling.
5d. pretrained — ``examples_torch/08_pretrained_transfer.py``'s ``main`` at
   its quick size (32x32, MobileNetV2 0.35 in f32, batch 8) with
   ``model.dw_impl=pallas``: pretrain 6 epochs, export both layouts,
   convert (the two artifacts agree), frozen transfer from the artifact
   against a frozen random backbone (pretrained must win), package and
   score; K1/K2 counts exact and all ``tma``. Before it, K1 (bit for bit)
   and K2 (1e-5 * sum|xpad*g|) in f32 against their plain versions at the
   six stride-1 depthwise shapes this model gets, [8, 16, 16, 16] down to
   [8, 1, 1, 336].
6. lm_kernel — the flash-attention forward kernel (K3) against its plain
   PyTorch version. Three variants, chosen by shape (``_fwd_variant``): sm90
   (TMA and wgmma, ``flash_fwd_sm90.cu``) for bf16 at block_k 128 and head
   dim 64 or 128, mma (``mma.sync``) for other bf16 blocks of 16k keys and
   head dim 32, CUDA cores for f32 and other bf16 blocks. Cases: the LM
   slice's shape [512, 2048, 64] causal in bf16 and f32, a ring hop's offset
   (keys from global 192: query rows 0-191 see no key and must give out 0,
   lse <= -1e29), non-causal at head dim 128, a short block with a key mask
   at head dim 32, a bf16 block of 40 keys (CUDA cores) and one of 64 keys
   (mma), and S=2047 padded through ``flash_mha``; on the sm90 path also a
   query tail tile inside a head (sq 200 against sk 256), sq 2112 against sk
   2048 at q_offset 64, a ring hop at q_offset 1000 and k_offset 1152 (152
   fully masked rows), k_valid 1000 inside a K block, and head dim 128
   causal. Every case runs twice and must give the same bits, on the variant
   its shape picks. f32 within 1e-5 * max|v| (lse 1e-5 * max(1, |lse|)),
   bf16 within max(2 bf16 ulp, 1e-3 * max|v|) elementwise (lse 1e-4). Times
   at [512, 2048, 64] and at the training shape [256, 2048, 64], causal
   bf16 (median of 10, L2 flushed), of the sm90 and mma kernels in turns
   (sm90, mma, mma, sm90) beside the bound (989 TFLOP/s bf16), the plain
   version and ``F.scaled_dot_product_attention`` (timed only, the
   yardstick).
7. lm     — bench.py's ``lm_flash`` LM (vocab 8192, 2048 positions, hidden
   512, 6 layers of 8 heads, bf16) from seeded flax-layout weights
   (``init_lm_weights``), saved with ``save_lm_package`` and loaded by
   ``LMPackagedModel``; ``LMBatchScorer`` (batch 64) scores a 256 x 2,049
   ``tokens_i32`` table with exactly 6 K3 launches per batch (24, all on the
   sm90 variant), twice
   (cold, warm; tokens/s); logits of one batch of 64 with K3 against the
   ``xla`` tier (bf16: rms within 2e-2 * std and max within 1e-1 * std,
   the tiers rounding p against different maxima; f32: max within 1e-4 *
   std; TF32 off);
   ``score`` at batch 8 (the ``xla_ckpt`` tier: no K3); greedy ``generate``
   of 32 tokens from 256-token prompts at batch 8 (first token = the full
   forward's argmax, padded-bucket decode = unpadded decode, both up to
   near-ties below 2e-2 * std) and one seeded sampled run repeated.
8. lm_bwd_kernel — the flash-attention backward kernels, K4 (dQ) and K5
   (dK/dV), against their plain PyTorch versions on the same inputs (q, k,
   v, do, the forward's lse and delta = rowsum(do * out) - g_lse with a
   nonzero g_lse). Three variants, chosen by shape (``_bwd_variant``): sm90
   (TMA and wgmma, ``flash_bwd_sm90.cu``) for bf16 at head dim 64 or 128,
   mma (``mma.sync``) for bf16 at head dim 32, CUDA cores for f32. Cases:
   the LM-training shape [256, 2048, 64] causal in bf16 (sm90, and mma
   forced) and f32 (TF32 off), a ring hop's offset (query rows that see no
   key must get exactly zero dq), non-causal at head dim 128, head dim 32
   with a key mask, 100 queries at global 100 against 200 keys on the CUDA
   cores (f32) and on sm90 (bf16: query and key tail tiles), and S=2047
   padded through ``flash_mha``'s backward. f32 within 1e-5 * max|ref|,
   bf16 within max(2 bf16 ulp, 5e-3 * max|ref|) elementwise; two launches
   of each bit-identical, on the variant the case names. Times at [256,
   2048, 64] bf16 causal (median of 10, L2 flushed) of the sm90 and mma
   kernels in turns (sm90, mma, mma, sm90), and of the whole backward
   (delta, K4, K5) on each, beside the bounds, the plain versions and the
   backward of causal ``F.scaled_dot_product_attention`` (timed only, the
   yardstick; one call gives dq, dk and dv).
8b. vit_kernel — K3, K4 and K5 at ViT's shape: 196 tokens padded to 256
   with k_valid 196, [512, 256, 48], non-causal, in bf16 (the mma.sync
   kernels) and f32 (CUDA cores), and a ragged case (192 queries against
   320 keys at k_offset 64, causal: the first 64-row block sees no key),
   each against its plain version with lm_kernel's and lm_bwd_kernel's
   tolerances, two launches bit-identical, every launch counted on its
   variant. Times (median of 10, L2 flushed) of one bf16 call of each at
   ViT's shape beside the bound (the 256 x 196 pairs a head the call
   computes; K and V read at their 196 valid rows, every other tensor at
   256), the plain versions and SDPA on the unpadded [128, 4, 196, 48]
   (forward, and its whole backward beside K4's and K5's).
9. lm_train — the same full-width bf16 LM from ``init_lm_weights`` with a
   seeded generator, trained by ``LMTrainer.fit_tables`` on a seeded,
   learnable ``tokens_i32`` table (arithmetic sequences mod the vocab, 160
   train and 32 val rows of 2,049 tokens) at batch 32 with adam 3e-4 for 2
   epochs with checkpoints, then ``resume=True`` to epoch 3. Checks: 6 K3 +
   6 K4 + 6 K5 launches per train step and 6 K3 per val batch, every K3,
   K4 and K5 on the sm90 variant; finite
   losses, epoch 2 below epoch 1, the resume at epoch 2; one bf16 step with
   the kernels against one with the plain versions on the card (loss
   within 5e-3 relative, per-leaf gradients within 5e-2 RMS gap over RMS;
   the key projections' biases, whose exact gradient is zero, left out);
   in f32 at batch 4 the kernel tier against the ``xla`` tier, TF32 off
   (loss within 1e-5 relative, per-leaf max gap within 1e-4 of the leaf's
   max |grad|, the key biases left out); one ``remat="full"`` step (12 K3,
   6 K4, 6 K5 launches; the loss within 1e-6 relative and gradients within
   1e-5 of each leaf's max of those without remat); the checkpoint through
   ``save_lm_package`` -> ``LMPackagedModel.score`` on the val rows at the
   trainer's last val_loss (within 1e-4 relative). Step ms (median of 10)
   and training tokens/s. Last, one more resumed epoch with ``tracer=``: its
   spans are ``ddw_tpu``'s chain-boundary ``train_chain`` spans, one per
   step, and its K3-K5 counts and variants (all sm90) those of the untraced
   resumed epoch.
9b. serve — the online serving engine (``ServingEngine``) on the card. The
   same full-width bf16 LM (another seed) through ``save_lm_package`` ->
   ``LMPackagedModel`` -> ``ServingEngine`` with the default ``EngineCfg``
   (paged KV blocks of 16, n_slots 8, 16 resident rows, steps_per_tick 4):
   ``warmup`` over every prompt bucket, then 32 seeded greedy requests from
   4 threads with staggered arrivals (prompts of 16-1,024 tokens, 8 of them
   on one 256-token prefix; 32-128 new tokens each), then a repeat of the
   last to finish (its cached tail is cloned). Each stream's tokens must
   equal ``LMPackagedModel.generate``'s, or first differ where the
   sequential path's top-2 margin is under 0.05 of its max |logit| (a bf16
   near-tie: the engine's GEMMs run 16 rows, sequential ones 1); the count
   of such streams is printed. Checks: ``prefix_hit_tokens`` > 0,
   ``cow_copies`` >= 1, ``blocks_used`` == 0 at the end, no K3 launch. The
   same with ``block_overcommit=3.0`` and 256 blocks (``preemptions`` > 0)
   and with ``paged=False`` (the slot lane); a full queue gives a
   structured ``Overloaded``; ``generate_speculative`` with a 2-layer draft
   against greedy ``generate`` (same near-tie rule). The image lane:
   bf16 MobileNetV2 1.0 at 224 (the main phase's package, ``pallas``), 64
   requests through ``predict`` in batches of up to 8: exactly 13 K1
   launches per image batch, all ``tma``; logits within phase_main's
   tolerance of ``predict_logits`` with argmax equal wherever decisive.
   Prints engine and sequential decode tokens/s, TTFT and total p50/p99
   from ``snapshot()``, image requests/s and the phase's wall seconds.
9c. serve_plus — the rest of the engine on the same package, mix and
   drafts. (a) ``EngineCfg(spec_k=4)`` with the twin draft over the 32
   requests (tokens/s beside serve's paged run, acceptance, the final
   effective width), then 8 of them with the random 2-layer draft
   (acceptance near 0); every token of every stream within 0.05 logits of
   its argmax (serve's rule). (b) ``adapter_slots=4``, rank 8: three seeded
   adapters (nonzero B) written by ``save_adapter`` and loaded from their
   ``.npz``, two rows each beside two base rows in one batch; each token
   within 0.05 of the argmax of a forward that carries the row's adapter;
   the adapters change their rows; an unknown ``adapter_id`` refused with
   no pin or queue entry left; an unload/load cycle leaves the pool's
   gauges as they were; the same prompt under two adapters shares no
   prefix block, under one it does. (c) Tenants ``gold`` and ``bronze``
   (weights 3:1) on the batch lane, a ``submit_batch(kind="generate")`` job
   of 16 items and interactive requests at once: every item recorded once,
   every stream within the rule; a ``QuotaExceeded`` for a capped tenant,
   its charge released; ``submit_batch(kind="predict")`` of 64 images
   through the image lane: 13 K1 launches a batch, all ``tma``, logits
   within serve's tolerance of ``predict_logits``. (d) The mix with
   ``trace`` and ``telemetry`` on and ``monitor_interval_s`` into a run,
   then with both off (tokens/s of each): each request one trace id whose
   queue, prefill and decode spans chain by parent from submission to its
   last token, written as a Chrome trace; telemetry samples present and an
   ``SLOMonitor`` over the feed not paging; ``sys.device_hbm_*`` series in
   the run (whether ``psutil`` gave the host keys is printed). No K3 launch
   on the LM lane. The phase's wall seconds.
10. ring — the collective layer (K6, the ring all-reduce) at N = 2, then
   N = 4 ranks: processes from ``spawn_cpu`` joined by gloo, all on this
   one card (NCCL refuses two ranks on one device; K6 maps its neighbours'
   buffers through CUDA IPC instead). Each rank takes one bf16 backward of
   the same full-width LM (``init_lm_weights``, one seed) on its own batch
   of 4 x 2,049 tokens and sums the f32 gradient tree (102 leaves,
   28,360,704 values) with ``all_reduce_sum(impl="pallas")``, which rings
   the whole tree in one K6 launch (the pack plan's count, checked to be
   1). Checks: that launch count; every rank holds the same bits; bit
   for bit ``all_reduce_sum`` on CPU copies (the plain version over the
   same gloo group); within 1e-6 * sum|g| per value of the float64 sum;
   every later call identical to the first, the earlier per-leaf K6 too;
   the tree in bf16 bit-equal to the plain version's; leaves of 1, 33 and
   n*128-7 values and an int32 leaf; a tree of f32, bf16 and int32 leaves
   with a view at a 4-byte offset in two launches (one per ring dtype); a
   300-leaf tree in the two launches its plan makes (256 arrays a launch);
   a pack that a small-slot ``RingComm`` splits into 3+ launches; at N = 4
   a (data=2, seq=2) mesh whose seq rings stay in their rows; a size-1
   axis launches nothing; at N = 2, last, a peer that never arrives makes
   K6 trap and the rank fail within 5 s of a 2 s wait bound. Times: CUDA
   events, a group barrier before each call, max over ranks, median of 5
   calls of the whole tree, in turns with 2 calls of the earlier per-leaf
   K6 (one launch per leaf), beside the bound (every rank's input read and
   output written once, 2 * N * bytes / 3.35 TB/s, and over NVLink on four
   cards; it assumes ranks that run at once) and the plain version's time;
   the yardstick ``torch.distributed.all_reduce`` over the same gloo group
   on each CUDA leaf by the same protocol (median of 3 calls, held to K6's
   sum), or its error if gloo refuses. The ranks are time-sliced on the
   card, so the times include the scheduling. The phase's wall seconds.
11. The ``kernels`` JSON line, the ``nvidia-smi`` line, and last the result
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


def k1_k2_turns(fns, flush) -> dict:
    """Each variant's median in turns (tma, simt, simt, tma): the faster of
    its two medians."""
    turns = {"tma": [], "simt": []}
    for variant in ("tma", "simt", "simt", "tma"):
        turns[variant].append(median_ms(fns[variant], flush))
    return {v: min(t) for v, t in turns.items()}


# [B, H, W, C] at the edges of the "tma" tile plan, each with the (th, tw,
# cb) it runs on (None: the plan's own). B = 1; H and W that no tile
# divides; a C that is not a multiple of the channel block (40 under a
# forced block of 16, 200 and 48 under the plan's or a forced 32); every
# case has tiles on all four borders.
DW_EDGES = (((1, 15, 13, 64), None), ((2, 9, 7, 64), None),
            ((3, 8, 8, 40), None), ((3, 8, 8, 40), (4, 8, 16)),
            ((2, 8, 8, 200), None), ((1, 7, 7, 960), None),
            ((2, 17, 30, 48), (8, 16, 32)))


def tma_check(x, taps, g, what: str, plan=None) -> tuple[float, float]:
    """The tma K1 (plain and flipped) equal to the plain version bit for
    bit, and the tma K2 within 1e-5 * sum|xpad*g| and bit-identical on two
    launches, every launch counted as tma. Returns K2's max |error| and its
    largest error over tolerance."""
    import torch

    from ddw_tpu_torch.ops.depthwise_conv import (
        depthwise_conv3x3_cuda, depthwise_conv3x3_plain,
        depthwise_conv3x3_wgrad_cuda, depthwise_conv3x3_wgrad_plain)

    before = (depthwise_conv3x3_cuda.launches_by_variant["tma"],
              depthwise_conv3x3_wgrad_cuda.launches_by_variant["tma"])
    for flip in (False, True):
        y = depthwise_conv3x3_cuda(x, taps, flip=flip, _plan=plan)
        torch.cuda.synchronize()
        check(torch.equal(y, depthwise_conv3x3_plain(x, taps, flip=flip)),
              f"K1 tma {what} flip={flip}: equal to the plain version bit "
              f"for bit")
    d1 = depthwise_conv3x3_wgrad_cuda(x, g, _plan=plan)
    d2 = depthwise_conv3x3_wgrad_cuda(x, g, _plan=plan)
    torch.cuda.synchronize()
    check(torch.equal(d1, d2), f"K2 tma {what}: two launches give the same "
          f"bits")
    err = (d1.double() - depthwise_conv3x3_wgrad_plain(x, g).double()).abs()
    wtol = wgrad_tolerance(x, g)
    check(bool((err <= wtol).all()) and bool(torch.isfinite(d1).all()),
          f"K2 tma {what} within 1e-5*sum|xpad*g|")
    check((depthwise_conv3x3_cuda.launches_by_variant["tma"],
           depthwise_conv3x3_wgrad_cuda.launches_by_variant["tma"])
          == (before[0] + 2, before[1] + 2), f"{what}: every launch on tma")
    return err.max().item(), (err / wtol).max().item()


def phase_kernel(flush):
    """K1 and K2, and the autograd Function, against their plain versions at
    the main path's shapes and at the tile plan's edges; both variants timed
    in turns."""
    import torch
    import torch.nn.functional as F

    from ddw_tpu_torch.ops.depthwise_conv import (
        _tile_plan_of, depthwise_conv3x3, depthwise_conv3x3_cuda,
        depthwise_conv3x3_plain, depthwise_conv3x3_wgrad_cuda,
        depthwise_conv3x3_wgrad_plain, dw_tile_plan)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    keys = ("ms", "ms_simt", "plain_ms", "library_ms", "bound_ms")
    per_pass = {"k1": dict.fromkeys(keys, 0.0), "k2": dict.fromkeys(keys, 0.0)}
    per_layer = {"k1": [], "k2": []}
    max_err = {"k1": 0.0, "k2": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for (h, w, c), layers in DW_SHAPES:
            x = torch.randn(BATCH, h, w, c, device="cuda", generator=gen)
            taps = torch.randn(3, 3, c, device="cuda", generator=gen)
            g = torch.randn(BATCH, h, w, c, device="cuda", generator=gen)
            x, taps, g = x.to(dtype), taps.to(dtype), g.to(dtype)
            name = str(dtype).removeprefix("torch.")
            elems = BATCH * h * w * c
            flops = 2 * 9 * elems
            plan = dw_tile_plan(BATCH, h, w, c, dtype)
            k2_err, k2_ratio = tma_check(x, taps, g, f"{dtype} {(h, w, c)}")

            # -- K1 --------------------------------------------------------
            cl = x.permute(0, 3, 1, 2)           # channels_last view
            wl = taps.permute(2, 0, 1).unsqueeze(1).contiguous()
            nbytes = (2 * elems + 9 * c) * x.element_size()
            turns = k1_k2_turns({v: (lambda v=v: depthwise_conv3x3_cuda(
                x, taps, _variant=v)) for v in ("tma", "simt")}, flush)
            k1 = {"ms": turns["tma"], "ms_simt": turns["simt"],
                  "plain_ms": median_ms(
                      lambda: depthwise_conv3x3_plain(x, taps), flush),
                  "library_ms": median_ms(
                      lambda: F.conv2d(cl, wl, padding=1, groups=c), flush),
                  "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                  flops / F32_FLOPS) * 1e3}
            emit(phase="kernel", kernel="depthwise_conv3x3_fwd", dtype=name,
                 shape=[BATCH, h, w, c], layers_per_forward=layers,
                 variant="tma", plan=plan._asdict(), max_abs_err=0.0,
                 tolerance="bit for bit, with and without flip", **k1,
                 share_of_bound=k1["bound_ms"] / k1["ms"],
                 bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                 >= flops / F32_FLOPS else "operations",
                 bytes=nbytes, flops=flops)

            # -- K2 --------------------------------------------------------
            max_err["k2"] = max(max_err["k2"], k2_err)
            gl = g.permute(0, 3, 1, 2)
            k2nbytes = 2 * elems * x.element_size() + 9 * c * 4
            turns = k1_k2_turns({v: (lambda v=v: depthwise_conv3x3_wgrad_cuda(
                x, g, _variant=v)) for v in ("tma", "simt")}, flush)
            k2 = {"ms": turns["tma"], "ms_simt": turns["simt"],
                  "plain_ms": median_ms(
                      lambda: depthwise_conv3x3_wgrad_plain(x, g), flush),
                  "library_ms": median_ms(
                      lambda: torch.ops.aten.convolution_backward(
                          gl, cl, wl, None, [1, 1], [1, 1], [1, 1], False,
                          [0, 0], c, [False, True, False]), flush),
                  "bound_ms": max(k2nbytes / HBM_BYTES_PER_S,
                                  flops / F32_FLOPS) * 1e3}
            emit(phase="kernel", kernel="depthwise_conv3x3_wgrad",
                 dtype=name, shape=[BATCH, h, w, c],
                 layers_per_step=layers, variant="tma", max_abs_err=k2_err,
                 max_err_over_tolerance=k2_ratio,
                 tolerance="1e-5*sum|xpad*g| per (dy,dx,c)", **k2,
                 share_of_bound=k2["bound_ms"] / k2["ms"],
                 bound_by="bytes" if k2nbytes / HBM_BYTES_PER_S
                 >= flops / F32_FLOPS else "operations",
                 bytes=k2nbytes, flops=flops, deterministic=True)
            if dtype == torch.bfloat16:  # the main path's dtype
                for kern, vals in (("k1", k1), ("k2", k2)):
                    for key in keys:
                        per_pass[kern][key] += layers * vals[key]
                    per_layer[kern].append(
                        {"shape": [BATCH, h, w, c], "layers": layers,
                         "tiles": [plan.th, plan.tw, plan.cb],
                         **{k: vals[k] for k in ("ms", "ms_simt",
                                                 "library_ms", "bound_ms")},
                         "share_of_bound": vals["bound_ms"] / vals["ms"]})

            # -- the Function: dx (K1 on flipped taps) and dw (K2) ---------
            grads = []
            for interpret in (False, True):
                xa = x.clone().requires_grad_(True)
                wa = taps.clone().requires_grad_(True)
                depthwise_conv3x3(xa, wa, impl="pallas",
                                  interpret=interpret).backward(g)
                grads.append((xa.grad, wa.grad))
            torch.cuda.synchronize()
            (dx_k, dw_k), (dx_p, dw_p) = grads
            check(torch.equal(dx_k, dx_p), f"Function dx {dtype} {(h, w, c)} "
                  f"bit-identical to the plain path")
            dw_err = (dw_k.float() - dw_p.float()).abs()
            if dtype == torch.float32:
                dw_ok = bool((dw_err.double()
                              <= wgrad_tolerance(x, g)).all())
            else:
                dw_ok = bool((dw_err <= bf16_ulp(dw_p.float())).all())
            check(dw_ok and dw_k.dtype == dtype,
                  f"Function dw {dtype} {(h, w, c)} against the plain path")
            emit(phase="kernel", kernel="DepthwiseKernelFn", dtype=name,
                 shape=[BATCH, h, w, c], dx_bit_identical=True,
                 dw_max_abs_diff=dw_err.max().item())
            del x, taps, g, cl, wl, gl, grads, dx_k, dw_k, dx_p, dw_p
    # the tile plan's edges, on the tma variant
    for dtype in (torch.bfloat16, torch.float32):
        for shape, tiles in DW_EDGES:
            x, g = (torch.randn(*shape, device="cuda", generator=gen).to(dtype)
                    for _ in range(2))
            taps = torch.randn(3, 3, shape[-1], device="cuda",
                               generator=gen).to(dtype)
            plan = None if tiles is None else _tile_plan_of(
                *shape, x.element_size(), *tiles)
            check(tiles is None or plan is not None, f"tiles {tiles} plan "
                  f"{shape}")
            what = f"edge {dtype} {list(shape)} tiles {tiles}"
            k2_err, k2_ratio = tma_check(x, taps, g, what, plan)
            max_err["k2"] = max(max_err["k2"], k2_err)
            emit(phase="kernel", edge=list(shape), dtype=str(dtype),
                 plan=(plan or dw_tile_plan(*shape, dtype))._asdict(),
                 k1_bit_identical=True, k2_max_err_over_tolerance=k2_ratio)
    # the scalar path (odd C, no vector loads): the simt variant
    x = torch.randn(2, 9, 7, 13, device="cuda", generator=gen)
    taps = torch.randn(3, 3, 13, device="cuda", generator=gen)
    g = torch.randn(2, 9, 7, 13, device="cuda", generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        xd, td, gd = x.to(dtype), taps.to(dtype), g.to(dtype)
        before = (depthwise_conv3x3_cuda.launches_by_variant["simt"],
                  depthwise_conv3x3_wgrad_cuda.launches_by_variant["simt"])
        y = depthwise_conv3x3_cuda(xd, td)
        check(torch.equal(y, depthwise_conv3x3_plain(xd, td)),
              f"K1 scalar path {dtype} equals plain")
        check(torch.equal(depthwise_conv3x3_cuda(xd, td, flip=True),
                          depthwise_conv3x3_plain(xd, td, flip=True)),
              f"K1 scalar path {dtype} flipped equals plain")
        dw = depthwise_conv3x3_wgrad_cuda(xd, gd)
        err = (dw.double() - depthwise_conv3x3_wgrad_plain(xd, gd).double())
        check(bool((err.abs() <= wgrad_tolerance(xd, gd)).all()),
              f"K2 scalar path {dtype} within tolerance")
        check((depthwise_conv3x3_cuda.launches_by_variant["simt"],
               depthwise_conv3x3_wgrad_cuda.launches_by_variant["simt"])
              == (before[0] + 2, before[1] + 1), f"C = 13 {dtype} on simt")
    emit(phase="kernel", odd_c_scalar_path="ok", variant="simt")
    return per_pass, per_layer, max_err


BF16_FLOPS = 989e12         # H100 SXM, dense bf16 tensor cores
# the LM slice: lm_flash of bench.py at LMBatchScorer's batch of 64
LM_BATCH, LM_HEADS, LM_SEQ, LM_HEAD_DIM = 64, 8, 2048, 64


def causal_pairs(sq: int, sk: int, q_offset: int, k_offset: int,
                 causal: bool, k_valid) -> int:
    """(query, key) pairs one row block attends: the work this data needs."""
    import numpy as np

    kpos = k_offset + np.arange(sk)
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kpos[None, :] <= (q_offset + np.arange(sq))[:, None]
    if k_valid is not None:
        keep &= kpos[None, :] < k_valid
    return int(keep.sum())


def k3_check(name, q, k, v, *, causal, q_offset=0, k_offset=0, k_valid=None,
             block_k=128, fully_masked_rows=0, phase="lm_kernel"):
    """K3 against its plain version on the same inputs, with the slice's
    tolerances, launched twice (the same bits, on the variant its shape
    picks); returns the max |out| error."""
    import torch

    from ddw_tpu_torch.ops.flash_attention import (_fwd_variant,
                                                   flash_attention_cuda,
                                                   flash_attention_plain)

    variant = _fwd_variant(q.dtype, q.shape[2], block_k)
    before = flash_attention_cuda.launches_by_variant[variant]
    out, lse = flash_attention_cuda(q, k, v, causal, q_offset, k_offset,
                                    block_k=block_k, k_valid=k_valid)
    out2, lse2 = flash_attention_cuda(q, k, v, causal, q_offset, k_offset,
                                      block_k=block_k, k_valid=k_valid)
    torch.cuda.synchronize()
    check(flash_attention_cuda.launches_by_variant[variant] == before + 2,
          f"K3 {name}: both launches on the {variant} variant")
    check(torch.equal(out, out2) and torch.equal(lse, lse2),
          f"K3 {name}: two launches give the same bits")
    del out2, lse2
    # the plain version needs a query block that divides Sq; its numerics
    # do not depend on which (tests/test_torch_flash_attention.py)
    block_q = next(b for b in (128, 64, q.shape[1]) if q.shape[1] % b == 0)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, q_offset, k_offset,
                                         block_q=block_q, block_k=block_k,
                                         k_valid=k_valid)
    err = (out.float() - ref.float()).abs()
    vmax = v.float().abs().max().item()
    lse_tol = ref_lse.abs().clamp_min(1.0)
    live = slice(fully_masked_rows, None)
    lse_err = ((lse - ref_lse).abs() / lse_tol)[:, live]
    if q.dtype == torch.float32:
        ok = err.max().item() <= 1e-5 * vmax
        lse_ok = lse_err.max().item() <= 1e-5
        tol = "|dout| <= 1e-5*max|v|, |dlse| <= 1e-5*max(1,|lse|)"
    else:
        elt = torch.maximum(2 * bf16_ulp(ref.float()),
                            torch.full_like(err, 1e-3 * vmax))
        ok = bool((err <= elt).all())
        lse_ok = lse_err.max().item() <= 1e-4
        tol = ("|dout| <= max(2 bf16 ulp, 1e-3*max|v|), "
               "|dlse| <= 1e-4*max(1,|lse|)")
    check(ok and bool(torch.isfinite(out).all()), f"K3 {name}: out within {tol}")
    check(lse_ok and bool(torch.isfinite(lse).all()),
          f"K3 {name}: lse within {tol}")
    if fully_masked_rows:
        dead = slice(0, fully_masked_rows)
        check(bool((out[:, dead] == 0).all())
              and bool((lse[:, dead] <= -1e29).all()),
              f"K3 {name}: fully masked rows give out 0 and lse <= -1e29")
    emit(phase=phase, case=name, variant=variant, shape=list(q.shape),
         sk=k.shape[1], dtype=str(q.dtype).removeprefix("torch."),
         causal=causal, q_offset=q_offset, k_offset=k_offset,
         k_valid=k_valid, block_k=block_k, max_abs_err=err.max().item(),
         lse_max_rel_err=lse_err.max().item(), tolerance=tol,
         fully_masked_rows=fully_masked_rows, identical_bits=True)
    return err.max().item()


def k3_times(q, k, v, flush, batch):
    """K3's sm90 and mma kernels at one causal bf16 shape, timed in turns
    (sm90, mma, mma, sm90), beside the bound, the plain version and SDPA."""
    import torch.nn.functional as F

    from ddw_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                   flash_attention_plain)

    bh, s, d = q.shape
    flops = 4 * d * bh * causal_pairs(s, s, 0, 0, True, None)
    nbytes = 4 * bh * s * d * 2 + bh * s * 4
    turns = {"sm90": [], "mma": []}
    for var in ("sm90", "mma", "mma", "sm90"):
        turns[var].append(median_ms(lambda: flash_attention_cuda(
            q, k, v, True, _variant=var), flush, reps=10))
    q4, k4, v4 = (t.view(batch, LM_HEADS, s, d) for t in (q, k, v))
    times = {
        "ms": min(turns["sm90"]),
        "ms_mma": min(turns["mma"]),
        "turns_ms": turns,
        "plain_ms": median_ms(lambda: flash_attention_plain(q, k, v, True),
                              flush, reps=3, warmup=1),
        "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), flush, reps=10),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS
        else "operations"}
    times["sm90_tflops"] = flops / times["ms"] / 1e9
    emit(phase="lm_kernel", kernel="flash_attention_fwd", dtype="bfloat16",
         shape=[bh, s, d], causal=True, **times, bytes=nbytes, flops=flops,
         library="F.scaled_dot_product_attention(is_causal=True)")
    return times


def phase_lm_kernel(flush):
    """K3 against its plain version at the LM slice's shapes and the edge
    cases a ring hop, a padded sequence or the sm90 kernel's tiles give it;
    times of the sm90 and mma kernels at the scoring and training shapes
    beside the bound, the plain version and SDPA."""
    import torch

    from ddw_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                   flash_mha)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def qkv(bh, sq, sk, d, dtype):
        mk = lambda s: torch.randn(bh, s, d, device="cuda", generator=gen)
        return mk(sq).to(dtype), mk(sk).to(dtype), mk(sk).to(dtype)

    bh, s, d = LM_BATCH * LM_HEADS, LM_SEQ, LM_HEAD_DIM
    max_err = 0.0

    def case(name, shape, dtype, **kw):
        nonlocal max_err
        q, k, v = qkv(*shape, dtype)
        max_err = max(max_err, k3_check(name, q, k, v, **kw))

    q, k, v = qkv(bh, s, s, d, torch.bfloat16)
    max_err = max(max_err, k3_check("slice_bf16_causal", q, k, v,
                                    causal=True))
    times = {"scoring": k3_times(q, k, v, flush, LM_BATCH)}
    del q, k, v
    tb = TRAIN_LM_BATCH * LM_HEADS
    q, k, v = qkv(tb, s, s, d, torch.bfloat16)
    times["training"] = k3_times(q, k, v, flush, TRAIN_LM_BATCH)
    del q, k, v
    torch.cuda.empty_cache()

    case("slice_f32_causal", (bh, s, s, d), torch.float32, causal=True)
    # a ring hop's offset: keys start at global 192, so query rows 0-191
    # see no key at all
    q, k, v = qkv(64, 1024, 1024, d, torch.bfloat16)
    max_err = max(max_err, k3_check("offset_k192_bf16", q, k, v, causal=True,
                                    k_offset=192, fully_masked_rows=192))
    q, k, v = (t.float() for t in (q, k, v))
    max_err = max(max_err, k3_check("offset_k192_f32", q, k, v, causal=True,
                                    k_offset=192, fully_masked_rows=192))
    case("noncausal_d128_bf16", (64, 1024, 1024, 128), torch.bfloat16,
         causal=False)
    case("d32_block40_kvalid70_f32", (6, 48, 80, 32), torch.float32,
         causal=False, block_k=40, k_valid=70)
    # bf16 blocks that are not a multiple of 16 take the CUDA-core path,
    # other multiples of 16 than 128 the mma.sync one
    case("block40_causal_bf16_cuda_cores", (64, 640, 640, d), torch.bfloat16,
         causal=True, block_k=40)
    case("block64_causal_bf16_mma", (64, 640, 640, d), torch.bfloat16,
         causal=True, block_k=64)
    # the sm90 kernel's edges: a query tile past Sq inside one head, more
    # queries than keys at an offset, a ring hop whose first 152 rows see no
    # key, a key mask inside a K block, head dim 128 causal
    case("sm90_q_tail_sq200", (3, 200, 256, d), torch.bfloat16, causal=True)
    case("sm90_sq2112_sk2048_qoff64", (64, 2112, 2048, d), torch.bfloat16,
         causal=True, q_offset=64)
    case("sm90_ring_hop_q1000_k1152", (64, 1024, 1024, d), torch.bfloat16,
         causal=True, q_offset=1000, k_offset=1152, fully_masked_rows=152)
    case("sm90_kvalid1000_sk2048", (64, 1024, 2048, d), torch.bfloat16,
         causal=False, k_valid=1000)
    case("sm90_causal_d128", (64, 1024, 1024, 128), torch.bfloat16,
         causal=True)
    # a padded sequence through flash_mha: S=2047 pads to 2048 with
    # k_valid=2047 (K3 against the plain version inside the same padding)
    q, k, v = (t.view(8, LM_HEADS, s, d)[:, :, :s - 1]
               for t in qkv(8 * LM_HEADS, s, s, d, torch.bfloat16))
    before = flash_attention_cuda.launches_by_variant["sm90"]
    out = flash_mha(q, k, v, causal=True, impl="pallas")
    check(flash_attention_cuda.launches_by_variant["sm90"] == before + 1,
          "flash_mha(impl='pallas') launched K3 once, on the sm90 variant")
    ref = flash_mha(q, k, v, causal=True, impl="pallas", interpret=True)
    err = (out.float() - ref.float()).abs()
    vmax = v.float().abs().max().item()
    check(out.shape == q.shape and bool(
        (err <= torch.maximum(2 * bf16_ulp(ref.float()),
                              torch.full_like(err, 1e-3 * vmax))).all()),
        "K3 padded S=2047 through flash_mha within max(2 bf16 ulp, "
        "1e-3*max|v|)")
    emit(phase="lm_kernel", case="padded_s2047_flash_mha_bf16",
         shape=list(q.shape), max_abs_err=err.max().item())
    max_err = max(max_err, err.max().item())
    return times, max_err


# the LM-training slice: lm_flash at the trainer's batch of 32
TRAIN_LM_BATCH = 32


def bwd_inputs(q, k, v, gen, causal, q_offset=0, k_offset=0, k_valid=None,
               block_k=128):
    """do, the forward's lse (K3) and delta = rowsum(do * out) - g_lse with
    a nonzero g_lse: what FlashAttentionFn's backward hands K4 and K5."""
    import torch

    from ddw_tpu_torch.ops.flash_attention import flash_attention_cuda

    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, q_offset, k_offset,
                                    block_k=block_k, k_valid=k_valid)
    g_lse = 0.1 * torch.randn(lse.shape, device="cuda", generator=gen)
    delta = ((do.float() * out.float()).sum(-1) - g_lse).contiguous()
    return do, lse, delta


def bwd_close(got, ref):
    """The slice's tolerance: f32 within 1e-5 * max|ref|, bf16 within
    max(2 bf16 ulp, 5e-3 * max|ref|) elementwise."""
    import torch

    err = (got.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    if got.dtype == torch.float32:
        ok = err.max().item() <= 1e-5 * top
    else:
        ok = bool((err <= torch.maximum(
            2 * bf16_ulp(ref.float()),
            torch.full_like(err, 5e-3 * top))).all())
    return ok and bool(torch.isfinite(got).all()), err.max().item(), \
        err.max().item() / max(top, 1e-30)


def k45_check(name, q, k, v, gen, *, causal, q_offset=0, k_offset=0,
              k_valid=None, block_q=128, block_k=128, fully_masked_rows=0,
              variants=(None,), phase="lm_bwd_kernel"):
    """K4 and K5 against their plain versions on the same inputs; two
    launches of each bit-identical, on the variant its shape picks (None)
    or on each forced one of ``variants``. Returns K4's and K5's max
    |error| on the variant the shape picks."""
    import torch

    from ddw_tpu_torch.ops.flash_attention import (
        _bwd_variant, flash_attention_dkv_cuda, flash_attention_dkv_plain,
        flash_attention_dq_cuda, flash_attention_dq_plain)

    do, lse, delta = bwd_inputs(q, k, v, gen, causal, q_offset, k_offset,
                                k_valid, block_k)
    args = (q, k, v, do, lse, delta, causal, q_offset, k_offset, None)
    rq = flash_attention_dq_plain(*args, block_q, block_k, k_valid)
    rk, rv = flash_attention_dkv_plain(*args, block_q, block_k, k_valid)
    errs = {"dq": 0.0, "dkv": 0.0}
    for forced in variants:
        variant = forced or _bwd_variant(q.dtype, q.shape[2])
        before = (flash_attention_dq_cuda.launches_by_variant[variant],
                  flash_attention_dkv_cuda.launches_by_variant[variant])
        run = lambda: (flash_attention_dq_cuda(*args, k_valid,
                                               _variant=forced),
                       *flash_attention_dkv_cuda(*args, k_valid,
                                                 _variant=forced))
        (dq, dk, dv), (dq2, dk2, dv2) = run(), run()
        torch.cuda.synchronize()
        check((flash_attention_dq_cuda.launches_by_variant[variant],
               flash_attention_dkv_cuda.launches_by_variant[variant])
              == (before[0] + 2, before[1] + 2),
              f"K4/K5 {name}: every launch on the {variant} variant")
        check(torch.equal(dq, dq2) and torch.equal(dk, dk2)
              and torch.equal(dv, dv2),
              f"K4/K5 {name} ({variant}): two launches give the same bits")
        del dq2, dk2, dv2
        row = {}
        for out_name, got, ref in (("dq", dq, rq), ("dk", dk, rk),
                                   ("dv", dv, rv)):
            ok, err, rel = bwd_close(got, ref)
            check(ok, f"K4/K5 {name} ({variant}): {out_name} within the "
                  f"slice's tolerance (max |err| {err:.3g}, {rel:.3g} of "
                  f"max |ref|)")
            row[out_name] = {"max_abs_err": err, "err_over_max_ref": rel}
        if fully_masked_rows:
            check(bool((dq[:, :fully_masked_rows] == 0).all()),
                  f"K4 {name} ({variant}): rows that see no key get "
                  f"exactly zero dq")
        emit(phase=phase, case=name, variant=variant,
             shape=list(q.shape), sk=k.shape[1],
             dtype=str(q.dtype).removeprefix("torch."), causal=causal,
             q_offset=q_offset, k_offset=k_offset, k_valid=k_valid,
             bit_identical_relaunch=True,
             fully_masked_rows=fully_masked_rows, **row)
        if forced is None:  # the kernel this shape runs on the main path
            errs["dq"] = max(errs["dq"], row["dq"]["max_abs_err"])
            errs["dkv"] = max(errs["dkv"], row["dk"]["max_abs_err"],
                              row["dv"]["max_abs_err"])
    return errs


def k45_times(q, k, v, gen, flush):
    """K4's and K5's sm90 and mma kernels at the training shape (bf16,
    causal), timed in turns (sm90, mma, mma, sm90), beside the bounds, the
    plain versions and SDPA's whole backward; and the whole backward as
    FlashAttentionFn runs it (delta, K4, K5) on each variant."""
    import torch
    import torch.nn.functional as F

    from ddw_tpu_torch.ops.flash_attention import (
        flash_attention_cuda, flash_attention_dkv_cuda,
        flash_attention_dkv_plain, flash_attention_dq_cuda,
        flash_attention_dq_plain)

    bh, s, d = q.shape
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    out, lse = flash_attention_cuda(q, k, v, True)
    g_lse = 0.1 * torch.randn(lse.shape, device="cuda", generator=gen)
    delta = ((do.float() * out.float()).sum(-1) - g_lse).contiguous()
    args = (q, k, v, do, lse, delta, True, 0, 0, None)
    pairs = bh * causal_pairs(s, s, 0, 0, True, None)
    q4, k4, v4, do4 = (t.view(TRAIN_LM_BATCH, LM_HEADS, s, d).detach()
                       .requires_grad_(t is not do) for t in (q, k, v, do))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    library_ms = median_ms(lambda: torch.autograd.grad(
        sdpa, (q4, k4, v4), do4, retain_graph=True), flush, reps=10)

    def backward_total(variant):  # FlashAttentionFn.backward's kernel work
        dl = ((do.float() * out.float()).sum(-1) - g_lse).contiguous()
        flash_attention_dq_cuda(q, k, v, do, lse, dl, True, _variant=variant)
        flash_attention_dkv_cuda(q, k, v, do, lse, dl, True, _variant=variant)

    fns = {"dq": lambda var: flash_attention_dq_cuda(*args, _variant=var),
           "dkv": lambda var: flash_attention_dkv_cuda(*args, _variant=var),
           "total": backward_total}
    turns = {key: {"sm90": [], "mma": []} for key in fns}
    for var in ("sm90", "mma", "mma", "sm90"):
        for key, fn in fns.items():
            turns[key][var].append(median_ms(lambda: fn(var), flush, reps=10))
    total = {var: min(t) for var, t in turns["total"].items()}
    times = {}
    for key, plain, products, outs in (
            ("dq", lambda: flash_attention_dq_plain(*args), 3, 1),
            ("dkv", lambda: flash_attention_dkv_plain(*args), 4, 2)):
        flops = products * 2 * d * pairs
        nbytes = (4 + outs) * bh * s * d * 2 + 2 * bh * s * 4
        times[key] = {
            "ms": min(turns[key]["sm90"]),
            "ms_mma": min(turns[key]["mma"]),
            "turns_ms": turns[key],
            "plain_ms": median_ms(plain, flush, reps=5, warmup=1),
            "library_ms": library_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            flops / BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / BF16_FLOPS else "operations",
            "backward_total_ms": total["sm90"],
            "backward_total_ms_mma": total["mma"]}
        times[key]["tflops"] = flops / times[key]["ms"] / 1e9
        times[key]["share_of_bound"] = (times[key]["bound_ms"]
                                        / times[key]["ms"])
        emit(phase="lm_bwd_kernel", kernel=f"flash_attention_{key}",
             variant="sm90", dtype="bfloat16", shape=[bh, s, d], causal=True,
             **times[key], bytes=nbytes, flops=flops,
             backward_total_turns_ms=turns["total"],
             library="backward of F.scaled_dot_product_attention"
                     "(is_causal=True): dq, dk and dv in one call")
    return times


def phase_lm_bwd_kernel(flush):
    """K4 and K5 against their plain versions at the training shape and the
    edge cases; times at the training shape beside the bounds, the plain
    versions and SDPA's backward."""
    import torch

    from ddw_tpu_torch.ops.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dq_cuda, flash_mha)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def qkv(bh, sq, sk, d, dtype):
        mk = lambda s: torch.randn(bh, s, d, device="cuda", generator=gen)
        return mk(sq).to(dtype), mk(sk).to(dtype), mk(sk).to(dtype)

    bh, s, d = TRAIN_LM_BATCH * LM_HEADS, LM_SEQ, LM_HEAD_DIM
    errs = {"dq": 0.0, "dkv": 0.0}

    def case(*a, **kw):  # K4's and K5's max |error| over every case
        for key, err in k45_check(*a, **kw).items():
            errs[key] = max(errs[key], err)

    q, k, v = qkv(bh, s, s, d, torch.bfloat16)
    # the sm90 kernels this shape runs, and the mma.sync ones timed beside
    case("train_shape_bf16_causal", q, k, v, gen, causal=True,
         variants=(None, "mma"))
    times = k45_times(q, k, v, gen, flush)
    del q, k, v
    torch.cuda.empty_cache()

    q, k, v = qkv(bh, s, s, d, torch.float32)
    case("train_shape_f32_causal", q, k, v, gen, causal=True)
    del q, k, v
    # a ring hop's offset: keys from global 192, rows 0-191 see no key
    q, k, v = qkv(64, 1024, 1024, d, torch.bfloat16)
    case("offset_k192_bf16", q, k, v, gen, causal=True, k_offset=192,
         fully_masked_rows=192)
    q, k, v = (t.float() for t in (q, k, v))
    case("offset_k192_f32", q, k, v, gen, causal=True, k_offset=192,
         fully_masked_rows=192)
    q, k, v = qkv(64, 1024, 1024, 128, torch.bfloat16)
    case("noncausal_d128_bf16", q, k, v, gen, causal=False)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(6, 48, 80, 32, dtype)
        case(f"d32_kvalid70_{str(dtype)[6:]}", q, k, v, gen, causal=False,
             block_q=48, block_k=40, k_valid=70)
    # ragged tiles on the CUDA cores: 100 queries at global 100, 200 keys
    q, k, v = qkv(6, 100, 200, 64, torch.float32)
    case("ragged_f32_block40_cuda_cores", q, k, v, gen, causal=True,
         q_offset=100, block_q=100, block_k=40)
    # the same ragged tiles on sm90: query and key tail tiles under TMA's
    # bounds (the forward's lse from 40-key blocks)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    case("ragged_bf16_d64_sm90", q, k, v, gen, causal=True, q_offset=100,
         block_q=100, block_k=40)
    # S=2047 padded through flash_mha's backward (K4/K5 against the plain
    # path inside the same padding)
    q, k, v = (t.view(8, LM_HEADS, s, d)[:, :, :s - 1].contiguous()
               for t in qkv(8 * LM_HEADS, s, s, d, torch.bfloat16))
    g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    grads = []
    counts = lambda: (flash_attention_dq_cuda.launches,
                      flash_attention_dkv_cuda.launches,
                      flash_attention_dq_cuda.launches_by_variant["sm90"],
                      flash_attention_dkv_cuda.launches_by_variant["sm90"])
    for interpret in (False, True):
        before = counts()
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        flash_mha(*ins, causal=True, impl="pallas",
                  interpret=interpret).backward(g)
        grads.append([t.grad for t in ins])
        want = (1, 1, 1, 1) if not interpret else (0, 0, 0, 0)
        check(tuple(a - b for a, b in zip(counts(), before)) == want,
              f"flash_mha backward (interpret={interpret}) launched K4/K5 "
              f"{want[:2]}, on the sm90 variant")
    row = {}
    for name, got, ref in zip(("dq", "dk", "dv"), *grads):
        ok, err, rel = bwd_close(got, ref)
        check(ok and got.shape == q.shape,
              f"padded S=2047 {name} through flash_mha's backward within "
              f"max(2 bf16 ulp, 5e-3*max|ref|)")
        row[name] = err
        key = "dq" if name == "dq" else "dkv"
        errs[key] = max(errs[key], err)
    emit(phase="lm_bwd_kernel", case="padded_s2047_flash_mha_bwd_bf16",
         shape=list(q.shape), max_abs_err=row)
    return times, errs


# ViT at 224/16 (hidden 192 over 4 heads, bench.py's vit): 196 tokens of
# head dim 48, padded by flash_mha to one 128-block multiple, 256, with
# k_valid 196; at the vision phase's batch of 128 the kernels see [512, 256,
# 48]
VIT_BATCH, VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM, VIT_PADDED = 128, 4, 196, 48, 256


def vit_kernel_times(q, k, v, gen, flush):
    """K3, K4 and K5 (mma, bf16) at ViT's padded shape, non-causal with
    k_valid 196: CUDA events with the L2 flushed, beside the bound (the
    pairs this call computes: 256 query rows x 196 keys a head; the bytes
    of K and V at their 196 valid rows, of Q, dO and the outputs at all
    256), the plain versions and SDPA (forward, and its whole backward) on
    the unpadded [128, 4, 196, 48]."""
    import torch
    import torch.nn.functional as F

    from ddw_tpu_torch.ops.flash_attention import (
        flash_attention_cuda, flash_attention_dkv_cuda,
        flash_attention_dkv_plain, flash_attention_dq_cuda,
        flash_attention_dq_plain, flash_attention_plain)

    bh, s, d = q.shape
    kv = VIT_TOKENS
    pairs = bh * causal_pairs(s, s, 0, 0, False, kv)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    out, lse = flash_attention_cuda(q, k, v, False, k_valid=kv)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, False, 0, 0, None)
    unpad = lambda t: t.view(VIT_BATCH, VIT_HEADS, s, d)[:, :, :kv]
    q4, k4, v4, do4 = (unpad(t).detach().contiguous().requires_grad_(
        t is not do) for t in (q, k, v, do))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4)
    sdpa_bwd_ms = median_ms(lambda: torch.autograd.grad(
        sdpa, (q4, k4, v4), do4, retain_graph=True), flush, reps=10)
    rows = {}
    for key, fn, plain, products, outs, library_ms in (
            ("fwd", lambda: flash_attention_cuda(q, k, v, False, k_valid=kv),
             lambda: flash_attention_plain(q, k, v, False, k_valid=kv),
             2, 1, median_ms(lambda: F.scaled_dot_product_attention(
                 q4, k4, v4), flush, reps=10)),
            ("dq", lambda: flash_attention_dq_cuda(*args, kv),
             lambda: flash_attention_dq_plain(*args, 128, 128, kv), 3, 1,
             sdpa_bwd_ms),
            ("dkv", lambda: flash_attention_dkv_cuda(*args, kv),
             lambda: flash_attention_dkv_plain(*args, 128, 128, kv), 4, 2,
             sdpa_bwd_ms)):
        flops = products * 2 * d * pairs
        # K and V read at their kv valid rows (no output depends on the
        # padded ones); Q, dO and every output at all s rows; lse (and
        # delta) f32 per query row
        q_rows = 1 if key == "fwd" else 2
        nbytes = ((q_rows + outs) * s + 2 * kv) * bh * d * 2 \
            + (1 if key == "fwd" else 2) * bh * s * 4
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
        rows[key] = {
            "ms": median_ms(fn, flush, reps=10),
            "plain_ms": median_ms(plain, flush, reps=3, warmup=1),
            "library_ms": library_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / BF16_FLOPS else "operations",
            "flops": flops, "bytes": nbytes}
        rows[key]["share_of_bound"] = rows[key]["bound_ms"] / rows[key]["ms"]
        emit(phase="vit_kernel", kernel=key, variant="mma", dtype="bfloat16",
             shape=[bh, s, d], k_valid=kv, causal=False, **rows[key],
             library="F.scaled_dot_product_attention at [128, 4, 196, 48]"
                     + (" (forward)" if key == "fwd" else
                        ": its whole backward, dq, dk and dv in one call"))
    return rows


def phase_vit_kernel(flush):
    """K3, K4 and K5 at ViT's shape ([512, 196->256, 48], non-causal,
    k_valid 196) in bf16 (mma) and f32 (CUDA cores) against their plain
    versions with lm_kernel's and lm_bwd_kernel's tolerances, a ragged case
    (Sq 192 against Sk 320 at k_offset 64, causal: the first 64-row block
    sees no key), and the times at ViT's shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def qkv(bh, sq, sk, d, dtype):
        mk = lambda n: torch.randn(bh, n, d, device="cuda", generator=gen)
        return mk(sq).to(dtype), mk(sk).to(dtype), mk(sk).to(dtype)

    bh, s, d = VIT_BATCH * VIT_HEADS, VIT_PADDED, VIT_HEAD_DIM
    errs = {"k3": 0.0, "dq": 0.0, "dkv": 0.0}
    times = None
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        q, k, v = qkv(bh, s, s, d, dtype)
        errs["k3"] = max(errs["k3"], k3_check(
            f"vit_{tag}", q, k, v, causal=False, k_valid=VIT_TOKENS,
            phase="vit_kernel"))
        for key, err in k45_check(f"vit_{tag}", q, k, v, gen, causal=False,
                                  k_valid=VIT_TOKENS,
                                  phase="vit_kernel").items():
            errs[key] = max(errs[key], err)
        if dtype == torch.bfloat16:
            times = vit_kernel_times(q, k, v, gen, flush)
        del q, k, v
        q, k, v = qkv(64, 192, 320, d, dtype)
        errs["k3"] = max(errs["k3"], k3_check(
            f"vit_ragged_{tag}", q, k, v, causal=True, k_offset=64,
            block_k=64, fully_masked_rows=64, phase="vit_kernel"))
        for key, err in k45_check(f"vit_ragged_{tag}", q, k, v, gen,
                                  causal=True, k_offset=64, block_q=64,
                                  block_k=64, fully_masked_rows=64,
                                  phase="vit_kernel").items():
            errs[key] = max(errs[key], err)
        del q, k, v
    torch.cuda.empty_cache()
    return times, errs


def arithmetic_tokens(n: int, seed: int, vocab: int, seq: int):
    """A learnable corpus: arithmetic sequences mod the vocab."""
    import numpy as np

    rng = np.random.RandomState(seed)
    starts = rng.randint(0, vocab, size=(n, 1))
    steps = rng.randint(1, 8, size=(n, 1))
    return ((starts + steps * np.arange(seq + 1)[None, :])
            % vocab).astype(np.int32)


def lm_grads(lm_cfg, params, inputs, targets):
    """Loss and {name: grad} of one training-mode forward and backward of a
    fresh LM on the card loaded with ``params``; no optimizer update."""
    import torch

    from ddw_tpu_torch.models.convert import load_flax_variables
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.train.lm_step import lm_forward_and_grads
    from ddw_tpu_torch.train.step import TrainState

    model = load_flax_variables(build_lm(lm_cfg), {"params": params}).cuda()
    loss, _, grads = lm_forward_and_grads(TrainState(model, {}, 0), inputs,
                                          targets, None)
    torch.cuda.synchronize()
    return loss.float().item(), grads


# Softmax is invariant to the key projection's bias (it adds q . b_k to a
# whole row of scores), so that leaf's exact gradient is zero and both
# computations give rounding noise there: it is left out of the gradient
# comparisons.
ZERO_GRAD_LEAVES = ("attn.key.bias",)
# bf16 bounds of a step through K3-K5 against the plain versions (lm_train)
# or the xla tier (vision's ViT): the loss (relative) and each leaf's
# gradient (RMS gap over RMS)
BF16_LOSS_TOL, BF16_GRAD_RMS_TOL = 5e-3, 5e-2


def grad_gaps(got, ref):
    """Per leaf: the RMS gap over the leaf's RMS, and the max gap over the
    leaf's max |grad|; the largest of each over all leaves but the key
    biases, with the leaf that gives it."""
    rms, mx = [], []
    for n in ref:
        if n.endswith(ZERO_GRAD_LEAVES):
            continue
        diff, r = got[n].float() - ref[n].float(), ref[n].float()
        rms.append(((diff.square().mean().sqrt()
                     / r.square().mean().sqrt().clamp_min(1e-30)).item(), n))
        mx.append(((diff.abs().max() / r.abs().max().clamp_min(1e-30))
                   .item(), n))
    return max(rms), max(mx)


def phase_lm_train(tmp: str):
    """The LM-training main path: LMTrainer.fit_tables at full width with
    K3, K4 and K5 on every layer, resume, kernel-vs-plain and kernel-vs-xla
    steps, a remat step, and the trained checkpoint packaged and scored."""
    import dataclasses
    import functools
    import statistics
    import warnings

    import numpy as np
    import torch

    from ddw_tpu_torch.checkpoint.ckpt import restore_checkpoint
    from ddw_tpu_torch.data.prep import write_token_table
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.models import lm as lm_mod
    from ddw_tpu_torch.ops import flash_attention as fa
    from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                                  save_lm_package)
    from ddw_tpu_torch.train.lm_step import make_lm_train_step
    from ddw_tpu_torch.train.lm_trainer import LMTrainer
    from ddw_tpu_torch.train.step import make_optimizer
    from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

    counters = (fa.flash_attention_cuda, fa.flash_attention_dq_cuda,
                fa.flash_attention_dkv_cuda)

    def zero_counts():
        fa.reset_forward_counts()
        fa.reset_backward_counts()

    def counts():
        return tuple(c.launches for c in counters)

    depth, vocab = LM_CFG["depth"], LM_CFG["vocab_size"]
    store = TableStore(os.path.join(tmp, "lm_train_tables"))
    n_train, n_val = 160, 32
    toks = arithmetic_tokens(n_train + n_val, SEED + 6, vocab, LM_SEQ)
    train_t = write_token_table(store, "lm_train", toks[:n_train],
                                shard_size=32)
    val_t = write_token_table(store, "lm_val", toks[n_train:], shard_size=32)
    lm_cfg = LMCfg(**LM_CFG)
    ckdir = os.path.join(tmp, "lm_ckpt")
    train_cfg = TrainCfg(batch_size=TRAIN_LM_BATCH, epochs=2, warmup_epochs=0,
                         optimizer="adam", learning_rate=3e-4,
                         checkpoint_dir=ckdir, seed=SEED)
    steps_per_epoch = n_train // TRAIN_LM_BATCH
    val_steps = n_val // TRAIN_LM_BATCH

    # --- the main path, counted ------------------------------------------
    trainer = LMTrainer(lm_cfg, train_cfg)
    check(trainer.device.type == "cuda", "LMTrainer resolved to the card")
    zero_counts()
    t0 = time.perf_counter()
    res = trainer.fit_tables(train_t, val_t)
    fit_s = time.perf_counter() - t0
    k3, k4, k5 = counts()
    k3_by_variant, k4_by_variant, k5_by_variant = (
        dict(c.launches_by_variant) for c in counters)
    steps, evals = 2 * steps_per_epoch, 2 * val_steps
    hist = res.history
    emit(phase="lm_train", fit_seconds=fit_s, history=hist,
         train_steps=steps, eval_batches=evals, k3_launches=k3,
         k3_launches_by_variant=k3_by_variant, k4_launches=k4,
         k4_launches_by_variant=k4_by_variant, k5_launches=k5,
         k5_launches_by_variant=k5_by_variant,
         expected=[depth * (steps + evals), depth * steps, depth * steps])
    for name, n, by_variant in (("K3", k3, k3_by_variant),
                                ("K4", k4, k4_by_variant),
                                ("K5", k5, k5_by_variant)):
        check(by_variant["sm90"] == n, f"every {name} launch of the fit on "
              f"the sm90 variant: {by_variant}")
    check((k3, k4, k5) == (depth * (steps + evals), depth * steps,
                           depth * steps),
          f"launches K3 {k3}, K4 {k4}, K5 {k5}: expected 6 K3 + 6 K4 + 6 K5 "
          f"per train step ({steps}) and 6 K3 per val batch ({evals})")
    check(all(np.isfinite([r["loss"], r["val_loss"]]).all() for r in hist),
          "finite train and val losses")
    check(hist[1]["loss"] < hist[0]["loss"],
          f"epoch-2 train loss {hist[1]['loss']:.4f} below epoch 1's "
          f"{hist[0]['loss']:.4f}")

    # --- resume continues at epoch 2 -------------------------------------
    zero_counts()
    res3 = LMTrainer(lm_cfg, dataclasses.replace(train_cfg, epochs=3)
                     ).fit_tables(train_t, val_t, resume=True)
    emit(phase="lm_train", resumed_history=res3.history,
         launches=list(counts()), state_step=res3.state.step)
    check([r["epoch"] for r in res3.history] == [2], "resume ran epoch 2 only")
    check(res3.state.step == 3 * steps_per_epoch, "resumed step count")
    check(counts() == (depth * (steps_per_epoch + val_steps),
                       depth * steps_per_epoch, depth * steps_per_epoch),
          "resumed run's launch counts")

    # --- step time and training tokens/s ---------------------------------
    batch = torch.from_numpy(toks[:TRAIN_LM_BATCH]).cuda()
    inputs, targets = batch[:, :-1], batch[:, 1:]
    state = res3.state
    step = make_lm_train_step(state.model, make_optimizer(train_cfg))
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, inputs, targets, SEED + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times[2:])
    tokens_per_s = TRAIN_LM_BATCH * LM_SEQ / step_ms * 1e3
    emit(phase="lm_train", step_ms_median=step_ms, step_ms_runs=times[2:],
         batch=TRAIN_LM_BATCH, step_tokens_per_s=tokens_per_s,
         epoch_tokens_per_s=[r["tokens_per_sec"]
                             for r in hist + res3.history],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    del step, state, trainer, res
    torch.cuda.empty_cache()

    # --- kernels against the plain versions: one bf16 step ---------------
    tree, at = restore_checkpoint(ckdir, {})
    check(at == 3 * steps_per_epoch, "latest checkpoint is the resumed run's")
    params = tree["params"]
    zero_counts()
    loss_k, g_k = lm_grads(lm_cfg, params, inputs, targets)
    check(counts() == (depth, depth, depth), "the kernel step ran 6 K3, "
          "6 K4 and 6 K5")
    mha = lm_mod.flash_mha
    lm_mod.flash_mha = functools.partial(mha, interpret=True)  # plain
    try:
        loss_p, g_p = lm_grads(lm_cfg, params, inputs, targets)
    finally:
        lm_mod.flash_mha = mha
    check(counts() == (depth, depth, depth), "the plain step ran no kernel")
    loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-12)
    (rms, rms_leaf), (mx, mx_leaf) = grad_gaps(g_k, g_p)
    emit(phase="lm_train", kernel_vs_plain_bf16_loss=[loss_k, loss_p],
         loss_rel_diff=loss_rel, loss_tolerance=BF16_LOSS_TOL,
         grad_rms_gap_over_rms_max=rms, worst_rms_leaf=rms_leaf,
         grad_rms_tolerance=BF16_GRAD_RMS_TOL, grad_max_gap_over_max=mx,
         worst_max_leaf=mx_leaf, leaves=len(g_p),
         left_out=list(ZERO_GRAD_LEAVES))
    check(loss_rel <= BF16_LOSS_TOL, f"bf16 loss within {BF16_LOSS_TOL} "
          f"relative ({loss_rel:.3g})")
    check(rms <= BF16_GRAD_RMS_TOL, f"bf16 per-leaf gradients within "
          f"{BF16_GRAD_RMS_TOL} RMS gap over RMS ({rms:.3g})")
    del g_k, g_p

    # --- f32 at batch 4: the kernel tier against the xla tier -------------
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(lm_cfg, dtype="float32")
    saved = fa._XLA_PLAIN_MAX, fa._XLA_CKPT_MAX
    try:
        fa._XLA_PLAIN_MAX = fa._XLA_CKPT_MAX = 0           # the kernel tier
        zero_counts()
        loss_kf, g_kf = lm_grads(f32, params, inputs[:4], targets[:4])
        check(counts() == (depth, depth, depth), "f32: K3, K4 and K5 on "
              "every layer")
        fa._XLA_PLAIN_MAX = fa._XLA_CKPT_MAX = 1 << 62     # the xla tier
        loss_xf, g_xf = lm_grads(f32, params, inputs[:4], targets[:4])
        check(counts() == (depth, depth, depth), "f32 xla tier: no kernel")
    finally:
        fa._XLA_PLAIN_MAX, fa._XLA_CKPT_MAX = saved
    f32_rel = abs(loss_kf - loss_xf) / max(abs(loss_xf), 1e-12)
    (f32_rms, _), (f32_mx, f32_leaf) = grad_gaps(g_kf, g_xf)
    emit(phase="lm_train", kernel_vs_xla_f32_loss=[loss_kf, loss_xf],
         loss_rel_diff=f32_rel, loss_tolerance=1e-5,
         grad_max_gap_over_max=f32_mx, worst_max_leaf=f32_leaf,
         grad_max_tolerance=1e-4, grad_rms_gap_over_rms_max=f32_rms,
         tf32=False)
    check(f32_rel <= 1e-5, f"f32 loss within 1e-5 relative ({f32_rel:.3g})")
    check(f32_mx <= 1e-4, f"f32 per-leaf gradients within 1e-4 of the "
          f"leaf's max |grad| ({f32_mx:.3g})")
    del g_kf, g_xf

    # --- remat="full": the block forward runs again in the backward -------
    zero_counts()
    loss_r, g_r = lm_grads(dataclasses.replace(lm_cfg, remat="full"), params,
                           inputs, targets)
    remat_counts = counts()
    loss_n, g_n = lm_grads(lm_cfg, params, inputs, targets)
    bit_identical = loss_r == loss_n and all(torch.equal(g_r[n], g_n[n])
                                             for n in g_n)
    _, (r_mx, _) = grad_gaps(g_r, g_n)
    emit(phase="lm_train", remat_full_launches=list(remat_counts),
         remat_loss=[loss_r, loss_n], remat_bit_identical=bit_identical,
         remat_grad_max_gap_over_max=r_mx)
    check(remat_counts == (2 * depth, depth, depth),
          f"remat='full' step launched {remat_counts}, expected 12 K3, "
          f"6 K4, 6 K5")
    check(abs(loss_r - loss_n) <= 1e-6 * abs(loss_n) and r_mx <= 1e-5,
          "remat='full' gives the loss (within 1e-6 relative) and the "
          "gradients (within 1e-5 of each leaf's max) of no remat")
    del g_r, g_n
    torch.cuda.empty_cache()

    # --- the trained checkpoint, packaged and scored ----------------------
    pkg = save_lm_package(os.path.join(tmp, "lm_trained_pkg"), lm_cfg,
                          params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm = LMPackagedModel(pkg)
    nll = pm.score(toks[n_train:n_train + TRAIN_LM_BATCH])
    mean_nll = float(np.mean(nll))
    rel = abs(mean_nll - res3.val_loss) / max(abs(res3.val_loss), 1e-12)
    emit(phase="lm_train", packaged_mean_nll=mean_nll,
         trainer_val_loss=res3.val_loss, rel_diff=rel, tolerance=1e-4)
    check(bool(np.isfinite(nll).all()) and rel <= 1e-4,
          f"packaged checkpoint's mean NLL {mean_nll:.5f} equals the "
          f"trainer's val_loss {res3.val_loss:.5f} within 1e-4 relative")

    # --- one more resumed epoch with a tracer ------------------------------
    from ddw_tpu_torch.obs.trace import Tracer

    tracer = Tracer(process="train")
    zero_counts()
    res4 = LMTrainer(lm_cfg, dataclasses.replace(train_cfg, epochs=4),
                     tracer=tracer).fit_tables(train_t, val_t, resume=True)
    traced = counts()
    traced_by = [dict(c.launches_by_variant) for c in counters]
    spans = tracer.drain()
    emit(phase="lm_train", traced_epoch=[r["epoch"] for r in res4.history],
         spans=[(e["name"], e["cat"], e["args"]["step"]) for e in spans],
         launches=list(traced), launches_by_variant=traced_by)
    check([(e["name"], e["cat"]) for e in spans]
          == [("train_chain", "train")] * steps_per_epoch,
          "the tracer holds one train_chain span per step, ddw_tpu's names")
    check(traced == (depth * (steps_per_epoch + val_steps),
                     depth * steps_per_epoch, depth * steps_per_epoch)
          and all(b.get("sm90") == n for b, n in zip(traced_by, traced)),
          f"the traced epoch's launches {traced} are the untraced resumed "
          f"epoch's, all sm90 ({traced_by})")
    return ({"k3": k3, "k4": k4, "k5": k5, "k3_by_variant": k3_by_variant,
             "k4_by_variant": k4_by_variant, "k5_by_variant": k5_by_variant,
             "traced": traced, "traced_by_variant": traced_by},
            step_ms, tokens_per_s)


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
    from ddw_tpu_torch.models.layers import init_weights
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
    from ddw_tpu_torch.ops.depthwise_conv import (depthwise_conv3x3_cuda,
                                                  reset_depthwise_counts)
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
    reset_depthwise_counts()
    t0 = time.perf_counter()
    scored = BatchScorer(pm).score_table(table, out_store=store,
                                         out_name="smoke_predictions")
    preds = pm.predict(list(decoded))
    wall = time.perf_counter() - t0
    launches = depthwise_conv3x3_cuda.launches
    by_variant = dict(depthwise_conv3x3_cuda.launches_by_variant)
    forwards = -(-N_IMAGES // BATCH) + 1        # 3 scorer batches + predict
    emit(phase="main", scored=len(scored), predict=preds,
         k1_launches=launches, k1_launches_by_variant=by_variant,
         forward_batches=forwards,
         expected_launches=LAYERS_PER_FORWARD * forwards,
         wall_seconds=wall)
    check(launches == LAYERS_PER_FORWARD * forwards,
          f"K1 launched {launches} times, expected "
          f"{LAYERS_PER_FORWARD} x {forwards}")
    check(by_variant["tma"] == launches, f"every K1 launch of the serving "
          f"path on the tma variant: {by_variant}")
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
    check(bf16_err == 0.0, f"bf16 logits equal to the plain path's (K1 is "
          f"bit-identical to its plain version), max |diff| {bf16_err}")
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
    return launches, by_variant


TRAIN_IMAGES, VAL_IMAGES = 1152, 256


def class_table(store, name: str, n: int, seed: int):
    """A seeded raw_u8 table of 224x224 images whose class (5) sets a
    dominant colour and a stripe frequency, under shifts and noise."""
    import numpy as np

    from ddw_tpu_torch.data.store import Record

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:224, 0:224].astype(np.float32) / 224.0
    templates = []
    for c in range(5):
        t = np.full((224, 224, 3), 60.0, np.float32)
        t[..., c % 3] += 120.0 * (1 + c // 3) / 2
        t += 40.0 * np.sin(2 * np.pi * (c + 1) * 2 * (xx + yy))[..., None]
        templates.append(t)

    def records():
        for i in range(n):
            c = i % 5
            img = np.roll(templates[c], rng.randint(224, size=2), (0, 1))
            img = img + rng.normal(0, 20.0, img.shape)
            yield Record(f"{name}/{i:05d}",
                         np.clip(img, 0, 255).astype(np.uint8).tobytes(),
                         f"c{c}", c)

    return store.write(name, records(), shard_size=128,
                       meta={"encoding": "raw_u8", "height": 224,
                             "width": 224})


def step_once(model_cfg, variables, images, labels, seed):
    """One forward+backward in training mode of a fresh model loaded with
    ``variables``; returns (loss, {name: grad})."""
    import torch

    from ddw_tpu_torch.models.convert import load_flax_variables
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.train.step import (TrainState, dropout_generator,
                                          forward_and_grads)

    model = load_flax_variables(build_model(model_cfg), variables).cuda()
    state = TrainState(model, {}, 0)
    loss, _, _, grads = forward_and_grads(state, images, labels,
                                          dropout_generator(seed, 0, 0))
    torch.cuda.synchronize()
    return loss.float().item(), grads


def phase_train(tmp: str):
    """The training main path: Trainer.fit, resume, kernel-vs-plain step,
    and the trained checkpoint served."""
    import dataclasses
    import statistics
    import warnings

    import numpy as np
    import torch

    from ddw_tpu_torch.checkpoint.ckpt import restore_checkpoint
    from ddw_tpu_torch.data.loader import ShardedLoader
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.ops.depthwise_conv import (depthwise_conv3x3_cuda,
                                                  depthwise_conv3x3_wgrad_cuda,
                                                  reset_depthwise_counts)
    from ddw_tpu_torch.serving.batch import BatchScorer
    from ddw_tpu_torch.serving.package import (PackagedModel,
                                               save_packaged_model)
    from ddw_tpu_torch.train.step import make_optimizer, make_train_step
    from ddw_tpu_torch.train.trainer import Trainer
    from ddw_tpu_torch.utils.config import DataCfg, ModelCfg, TrainCfg

    store = TableStore(os.path.join(tmp, "train_tables"))
    t0 = time.perf_counter()
    train_t = class_table(store, "train_raw_u8", TRAIN_IMAGES, SEED + 1)
    val_t = class_table(store, "val_raw_u8", VAL_IMAGES, SEED + 2)
    emit(phase="train", tables_seconds=time.perf_counter() - t0)
    data_cfg = DataCfg(img_height=224, img_width=224)
    model_cfg = ModelCfg(name="mobilenet_v2", num_classes=5, dtype="bfloat16",
                         dw_impl="pallas")      # default freeze fields
    ckdir = os.path.join(tmp, "ckpt")
    train_cfg = TrainCfg(batch_size=BATCH, epochs=2, warmup_epochs=0,
                         optimizer="adam", checkpoint_dir=ckdir, seed=SEED)
    steps_per_epoch = TRAIN_IMAGES // BATCH
    val_steps = VAL_IMAGES // BATCH

    # --- the main path, counted ------------------------------------------
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = Trainer(data_cfg, model_cfg, train_cfg)
    check(any("auto-unfreezing" in str(w.message) for w in caught),
          "the registry auto-unfroze the random backbone")
    check(trainer.model.freeze_base is False and trainer.device.type == "cuda",
          "unfrozen model on the card")
    reset_depthwise_counts()
    t0 = time.perf_counter()
    res = trainer.fit(train_t, val_t)
    fit_s = time.perf_counter() - t0
    k1, k2 = depthwise_conv3x3_cuda.launches, depthwise_conv3x3_wgrad_cuda.launches
    k1_by = dict(depthwise_conv3x3_cuda.launches_by_variant)
    k2_by = dict(depthwise_conv3x3_wgrad_cuda.launches_by_variant)
    steps, evals = 2 * steps_per_epoch, 2 * val_steps
    exp_k1 = LAYERS_PER_FORWARD * (2 * steps + evals)
    exp_k2 = LAYERS_PER_FORWARD * steps
    hist = [{k: v for k, v in r.items()} for r in res.history]
    emit(phase="train", fit_seconds=fit_s, history=hist, train_steps=steps,
         eval_batches=evals, k1_launches=k1, k1_expected=exp_k1,
         k2_launches=k2, k2_expected=exp_k2, k1_launches_by_variant=k1_by,
         k2_launches_by_variant=k2_by)
    check(k1 == exp_k1, f"K1 launched {k1} times, expected {exp_k1} = 13 x "
          f"(2 x {steps} train steps + {evals} eval batches)")
    check(k2 == exp_k2, f"K2 launched {k2} times, expected {exp_k2} = 13 x "
          f"{steps} train steps")
    check(k1_by["tma"] == k1 and k2_by["tma"] == k2, f"every K1 and K2 "
          f"launch of the training path on the tma variant: {k1_by}, {k2_by}")
    check(all(np.isfinite([r["loss"], r["val_loss"]]).all() for r in hist),
          "finite train and val losses")
    check(hist[1]["loss"] < hist[0]["loss"],
          f"epoch-2 train loss {hist[1]['loss']:.4f} below epoch 1's "
          f"{hist[0]['loss']:.4f}")

    # --- resume continues at epoch 2 -------------------------------------
    reset_depthwise_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res3 = Trainer(data_cfg, model_cfg,
                       dataclasses.replace(train_cfg, epochs=3)).fit(
                           train_t, val_t, resume=True)
    k1r = depthwise_conv3x3_cuda.launches
    k2r = depthwise_conv3x3_wgrad_cuda.launches
    emit(phase="train", resumed_epochs=[r["epoch"] for r in res3.history],
         resumed_history=res3.history, k1_launches=k1r, k2_launches=k2r,
         state_step=res3.state.step)
    check([r["epoch"] for r in res3.history] == [2], "resume ran epoch 2 only")
    check(res3.state.step == 3 * steps_per_epoch, "resumed step count")
    check(k1r == LAYERS_PER_FORWARD * (2 * steps_per_epoch + val_steps)
          and k2r == LAYERS_PER_FORWARD * steps_per_epoch,
          "resumed run's launch counts")

    # --- step time and training images/s ---------------------------------
    images_per_s = [r["images_per_sec"] for r in hist + res3.history]
    it = iter(ShardedLoader(train_t, BATCH, prefetch_to="cuda"))
    images, labels = next(it)
    it.close()
    state = res3.state
    step = make_train_step(make_optimizer(train_cfg, ()))
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, images, labels, SEED + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times[2:])
    emit(phase="train", step_ms_median=step_ms, step_ms_runs=times[2:],
         batch=BATCH, step_images_per_s=BATCH / step_ms * 1e3,
         epoch_images_per_s=images_per_s)

    # --- kernels against the plain depthwise: one step -------------------
    tree, at = restore_checkpoint(ckdir, {})
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    x_step, y_step = images[:32].clone(), labels[:32].clone()
    no_drop = dataclasses.replace(model_cfg, dropout=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss_k, _ = step_once(no_drop, variables, x_step, y_step, SEED)
        loss_p, _ = step_once(dataclasses.replace(
            no_drop, dw_impl="pallas_interpret"), variables, x_step, y_step,
            SEED)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = dataclasses.replace(no_drop, dtype="float32")
        loss_kf, g_k = step_once(f32, variables, x_step, y_step, SEED)
        loss_pf, g_p = step_once(dataclasses.replace(
            f32, dw_impl="pallas_interpret"), variables, x_step, y_step, SEED)
        torch.backends.cudnn.allow_tf32 = True
    bf16_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-12)
    leaf_rel = max((g_k[n] - g_p[n]).abs().max().item()
                   / max(g_p[n].abs().max().item(), 1e-30) for n in g_p)
    emit(phase="train", kernel_vs_plain_bf16_loss=[loss_k, loss_p],
         bf16_loss_rel_diff=bf16_rel, bf16_tolerance=2e-2,
         f32_loss=[loss_kf, loss_pf], f32_grad_leaf_rel_diff_max=leaf_rel,
         f32_tolerance=1e-3, tf32_for_f32_check=False, leaves=len(g_p))
    check(bf16_rel <= 2e-2, f"bf16 loss within 2e-2 relative ({bf16_rel:.3g})")
    check(leaf_rel <= 1e-3, f"f32 per-leaf grads within 1e-3 of the leaf's "
          f"max |grad| ({leaf_rel:.3g})")

    # --- the trained checkpoint, served ----------------------------------
    tree, at = restore_checkpoint(ckdir, {})
    check(at == 3 * steps_per_epoch, "latest checkpoint is the resumed run's")
    pkg = save_packaged_model(os.path.join(tmp, "trained_pkg"), model_cfg,
                              [f"c{i}" for i in range(5)], tree["params"],
                              tree["batch_stats"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm = PackagedModel(pkg)
    scored = BatchScorer(pm).score_table(val_t)
    labels_val = [rec.label for rec in val_t.iter_records()]
    acc = float(np.mean([c == lbl for (_, c), lbl in zip(scored, labels_val)]))
    emit(phase="train", served_records=len(scored), served_accuracy=acc,
         trainer_val_accuracy=res3.val_accuracy)
    check(len(scored) == VAL_IMAGES, "every val record scored")
    check(abs(acc - res3.val_accuracy) <= 2.0 / VAL_IMAGES,
          f"served accuracy {acc:.4f} equals the trainer's val accuracy "
          f"{res3.val_accuracy:.4f} (within 2 images)")

    # --- one more resumed epoch under the profiler and the monitor -------
    from ddw_tpu_torch.tracking.tracker import Tracker

    trace_dir = os.path.join(tmp, "train_trace")
    tracker = Tracker(os.path.join(tmp, "train_runs"), "traced")
    run = tracker.start_run("epoch4")
    reset_depthwise_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res4 = Trainer(data_cfg, model_cfg, dataclasses.replace(
            train_cfg, epochs=4, trace_dir=trace_dir,
            monitor_interval_s=0.5), run=run).fit(train_t, val_t,
                                                   resume=True)
    run.end()
    k1t, k2t = (depthwise_conv3x3_cuda.launches,
                depthwise_conv3x3_wgrad_cuda.launches)
    k1t_by = dict(depthwise_conv3x3_cuda.launches_by_variant)
    k2t_by = dict(depthwise_conv3x3_wgrad_cuda.launches_by_variant)
    traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
    check(len(traces) == 1, f"one Chrome trace in trace_dir ({traces})")
    with open(traces[0]) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    n_fwd = sum("dw3x3_fwd_tma_kernel" in n for n in kernels)
    n_wgrad = sum("dw3x3_wgrad_tma_kernel" in n for n in kernels)
    runv = tracker.get_run(run.run_id)
    hbm = len(runv.metric_history("sys.device_hbm_used_gb"))
    emit(phase="train", traced_epoch=[r["epoch"] for r in res4.history],
         traced_epoch_seconds=res4.history[0]["epoch_seconds"],
         untraced_epoch_seconds=res3.history[0]["epoch_seconds"],
         k1_launches=k1t, k2_launches=k2t, k1_launches_by_variant=k1t_by,
         k2_launches_by_variant=k2t_by, trace_bytes=os.path.getsize(
             traces[0]), trace_kernel_events=len(kernels),
         trace_k1_kernels=n_fwd, trace_k2_kernels=n_wgrad,
         trace_dir_param=runv.params().get("trace_dir"),
         monitor_hbm_samples=hbm)
    check([r["epoch"] for r in res4.history] == [3], "the traced run ran "
          "epoch 3 only")
    check((k1t, k2t) == (k1r, k2r) and k1t_by["tma"] == k1t
          and k2t_by["tma"] == k2t, f"the traced epoch's K1/K2 launches "
          f"({k1t}, {k2t}, {k1t_by}, {k2t_by}) are the untraced resumed "
          f"epoch's ({k1r}, {k2r}), all tma")
    check(n_fwd == LAYERS_PER_FORWARD * 2 * steps_per_epoch
          and n_wgrad == LAYERS_PER_FORWARD * steps_per_epoch,
          f"the trace names K1's kernel once per K1 launch of the steps "
          f"({n_fwd}) and K2's once per K2 launch ({n_wgrad})")
    check(runv.params().get("trace_dir") == trace_dir and hbm > 0,
          "the run holds the trace_dir param and the sys.device_hbm_* "
          "series")
    return {"k1": k1, "k2": k2, "k1_by_variant": k1_by,
            "k2_by_variant": k2_by, "k1_traced": k1t, "k2_traced": k2t,
            "k1_traced_by_variant": k1t_by,
            "k2_traced_by_variant": k2t_by}, step_ms


WORKSHOP_PER_CLASS, WORKSHOP_SRC_PX = 64, 256
WORKSHOP_FEATURE_TOL = 2e-2     # bf16 backbone: of the largest |feature|


def run_example(name: str, argv: list) -> dict:
    """``examples_torch/<name>.py``'s ``main(argv)`` in this process (flags
    before the ``section.key=value`` overrides), its printed lines kept and
    shown on stderr if it raises."""
    import contextlib
    import importlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = importlib.import_module(f"examples_torch.{name}").main(argv)
    except BaseException:
        print(buf.getvalue(), file=sys.stderr)
        raise
    return {"out": out, "seconds": time.perf_counter() - t0,
            "lines": buf.getvalue().splitlines()}


def dw_counts() -> dict:
    from ddw_tpu_torch.ops.depthwise_conv import (depthwise_conv3x3_cuda,
                                                  depthwise_conv3x3_wgrad_cuda)

    return {"k1": dict(depthwise_conv3x3_cuda.launches_by_variant),
            "k2": dict(depthwise_conv3x3_wgrad_cuda.launches_by_variant)}


def check_trials(trials, step: str) -> list:
    """Every trial ended STATUS_OK (``fmin`` records a trial that raised as
    failed and carries on: a kernel that failed to build or launch would
    hide there); returns ``[(status, loss)]``."""
    rows = [(t["status"], t["loss"]) for t in trials.results]
    bad = [t for t in trials.results if t["status"] != "ok"]
    for t in bad:
        print(f"workshop {step}: trial {t['params']} ended {t['status']}: "
              f"{t.get('error')}", file=sys.stderr)
    check(not bad, f"every {step} trial ended STATUS_OK: {rows}")
    return rows


def phase_workshop(tmp: str):
    """The workshop chain (BASELINE.json configs 1, 3, 4 and 5) through the
    example scripts' ``main`` on a seeded synthetic flowers tree, at full
    width: MobileNetV2 1.0, 224x224, bf16, ``dw_impl="pallas"``."""
    import numpy as np
    import torch

    from ddw_tpu_torch.data.prep import generate_synthetic_flowers
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.ops.depthwise_conv import reset_depthwise_counts
    from ddw_tpu_torch.serving.batch import BatchScorer
    from ddw_tpu_torch.tracking.registry import ModelRegistry
    from ddw_tpu_torch.train.transfer import _decode_record
    from ddw_tpu_torch.utils.config import DataCfg
    from examples_torch.common import require_tables, score_distributed

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "workshop")
    t0 = time.perf_counter()
    source = generate_synthetic_flowers(
        os.path.join(work, "raw_flowers"), WORKSHOP_PER_CLASS,
        WORKSHOP_SRC_PX, seed=SEED)
    flags = ["--workdir", work, "--source", source, "--device", "cuda"]
    data = ["data.sample_fraction=1.0", "data.shard_size=16"]
    mnv2 = data + ["model.name=mobilenet_v2", "model.width_mult=1.0",
            "model.dtype=bfloat16", "model.dw_impl=pallas", "train.epochs=1",
            "train.batch_size=32"]
    seconds = {"synthetic_tree": time.perf_counter() - t0}
    launches = {}

    # 1. prep: single process, then 2 workers; then decode at 224
    one = run_example("01_data_prep", flags + data)
    two = run_example("01_data_prep", flags + ["--etl-procs", "2",
                                               "--materialize"] + data)
    seconds["prep_single"], seconds["prep_2_workers_materialize"] = (
        one["seconds"], two["seconds"])

    def split(out):
        return ({r.path for r in out["train"].iter_records()},
                {r.path for r in out["val"].iter_records()})

    a, b = one["out"], two["out"]
    prep_equal = (split(a) == split(b)
                  and a["label_to_idx"] == b["label_to_idx"])
    n_train, n_val = a["train"].num_records, a["val"].num_records
    dec = b["silver_train_decoded"]
    emit(phase="workshop", step="prep", images=5 * WORKSHOP_PER_CLASS,
         train=n_train, val=n_val, label_to_idx=a["label_to_idx"],
         split_and_index_equal=prep_equal,
         decoded=[dec.meta["height"], dec.meta["width"]],
         seconds=seconds["prep_2_workers_materialize"])
    check(prep_equal, "2-worker prep: the split membership and label index "
          "of the single-process prep")
    check(n_train + n_val == 5 * WORKSHOP_PER_CLASS
          and (dec.meta["height"], dec.meta["width"]) == (224, 224),
          "every image prepared, decoded at 224")

    # 2. config 1: small CNN, f32, 1 epoch
    reset_depthwise_counts()
    c1 = run_example("02_train_single_node", flags + data + [
        "model.name=small_cnn", "model.dtype=float32", "train.epochs=1"])
    seconds["config1_small_cnn"] = c1["seconds"]
    row = c1["out"].history[-1]
    launches["config1"] = dw_counts()
    emit(phase="workshop", step="config1_small_cnn",
         val_accuracy=c1["out"].val_accuracy,
         images_per_s=row["images_per_sec"], loss=row["loss"],
         seconds=c1["seconds"], kernel_launches=launches["config1"])
    check(np.isfinite([row["loss"], row["val_loss"]]).all(),
          "config 1: finite losses")

    # 3. config 3: TPE, 4 trials, 2 at a time on the card, unfrozen
    # MobileNetV2, 1 epoch at batch 32 (K1 and K2)
    reset_depthwise_counts()
    c3 = run_example("04_hyperopt_parallel", flags + mnv2 + [
        "model.freeze_base=false", "tune.max_evals=4", "tune.parallelism=2"])
    launches["config3"] = dw_counts()
    seconds["config3_hpo"] = c3["seconds"]
    trials3 = check_trials(c3["out"]["trials"], "config 3")
    steps, evals = n_train // 32, max(1, n_val // 32)
    want_k1 = 4 * LAYERS_PER_FORWARD * (2 * steps + evals)
    want_k2 = 4 * LAYERS_PER_FORWARD * steps
    reg = ModelRegistry(os.path.join(work, "registry"))
    prod = reg.get_version("flowers_classifier", stage="Production")
    emit(phase="workshop", step="config3_hpo", trials=trials3,
         best=c3["out"]["best"], registered_version=prod,
         report=os.path.basename(c3["out"]["report"]),
         kernel_launches=launches["config3"], k1_expected=want_k1,
         k2_expected=want_k2, seconds=c3["seconds"])
    got = launches["config3"]
    check(got["k1"]["tma"] == want_k1 and got["k1"]["simt"] == 0
          and got["k2"]["tma"] == want_k2 and got["k2"]["simt"] == 0,
          f"config 3: K1 {want_k1} and K2 {want_k2} launches, all tma "
          f"(13 x (2 x {steps} steps + {evals} eval) and 13 x {steps} a "
          f"trial): {got}")
    check(prod == c3["out"]["version"] and os.path.exists(
        c3["out"]["report"]), "best trial registered in Production, report "
          "written")

    # 4. the --cache-features variant: featurise with K1, head-only trials
    reset_depthwise_counts()
    c4 = run_example("04_hyperopt_parallel", flags + ["--cache-features"]
                     + mnv2 + ["tune.max_evals=4", "tune.parallelism=2"])
    launches["cache_features"] = dw_counts()
    seconds["cache_features_hpo"] = c4["seconds"]
    trials4 = check_trials(c4["out"]["trials"], "cached-feature")
    feat_train, feat_val, full_state = c4["out"]["features"]
    batches = -(-n_train // 64) + -(-n_val // 64)
    want = LAYERS_PER_FORWARD * batches
    got = launches["cache_features"]
    check(got["k1"]["tma"] == want and got["k1"]["simt"] == 0
          and sum(got["k2"].values()) == 0,
          f"featurisation: {want} K1 launches (13 x {batches} batches), "
          f"all tma, no K2: {got}")
    # the cached features against the full model's GAP output (the head's
    # input), on the val images in one batch
    model = full_state.model.eval()
    store = TableStore(os.path.join(work, "tables"))
    _, val_t = require_tables(store, DataCfg())      # the decoded tables
    pooled = []
    hook = model.head.register_forward_hook(
        lambda mod, inp, out: pooled.append(inp[0].float().cpu()))
    x = np.stack([_decode_record(r, val_t.meta, 224, 224)
                  for r in val_t.iter_records()])
    with torch.inference_mode():
        model(torch.from_numpy(x).cuda())
    hook.remove()
    cached = np.stack([np.frombuffer(r.content, np.float32)
                       for r in feat_val.iter_records()])
    ref = pooled[0].numpy()
    feat_err = float(np.abs(cached - ref).max())
    feat_scale = float(np.abs(ref).max())
    emit(phase="workshop", step="cache_features", trials=trials4,
         feature_dim=feat_train.meta["feature_dim"],
         featurised=[feat_train.num_records, feat_val.num_records],
         kernel_launches=got, k1_expected=want,
         feature_max_abs_err=feat_err, feature_max_abs=feat_scale,
         feature_tolerance=WORKSHOP_FEATURE_TOL * feat_scale,
         seconds=c4["seconds"])
    check(cached.shape == ref.shape and np.isfinite(cached).all(),
          "cached features of the val table, finite")
    check(feat_err <= WORKSHOP_FEATURE_TOL * feat_scale,
          f"cached features within {WORKSHOP_FEATURE_TOL} x max|feature| "
          f"of the full model's pooled features ({feat_err:.3g})")

    # 5. config 4: 2 sequential trials, each data-parallel over 2 gloo ranks
    # that share the card
    c5 = run_example("05_hyperopt_distributed", flags + ["--procs", "2"]
                     + mnv2 + ["model.freeze_base=false",
                               "tune.max_evals=2"])
    seconds["config4_distributed_hpo"] = c5["seconds"]
    trials5 = check_trials(c5["out"]["trials"], "config 4")
    rank_counts = [t["kernel_launches"] for t in c5["out"]["trials"].results]
    for t in c5["out"]["trials"].results:
        b = int(t["params"]["batch_size"])
        st, ev = max(1, n_train // (2 * b)), max(1, n_val // (2 * b))
        for r in t["kernel_launches"]:
            check(r["k1"] == {"tma": LAYERS_PER_FORWARD * (2 * st + ev),
                              "simt": 0}
                  and r["k2"] == {"tma": LAYERS_PER_FORWARD * st, "simt": 0},
                  f"config 4 rank at batch {b}: 13 x (2 x {st} + {ev}) K1 "
                  f"and 13 x {st} K2 launches, all tma: {r}")
    launches["config4_ranks"] = rank_counts
    emit(phase="workshop", step="config4_distributed_hpo", trials=trials5,
         batch_sizes=[t["params"]["batch_size"]
                      for t in c5["out"]["trials"].results],
         rank_kernel_launches=rank_counts, seconds=c5["seconds"])

    # 6. config 5: the Production package scores the val table, in one
    # process and merged from 2 gloo ranks
    pkg = reg.model_path("flowers_classifier", stage="Production")
    reset_depthwise_counts()
    t0 = time.perf_counter()
    single = BatchScorer(pkg).score_table(val_t, out_store=store,
                                          out_name="single_predictions")
    launches["config5_single"] = dw_counts()
    seconds["config5_single"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = score_distributed(pkg, store, val_t.manifest["name"],
                             "predictions", 2, device="cuda")
    seconds["config5_2_ranks"] = time.perf_counter() - t0

    def records(name):
        return sorted((r.path, r.content, r.label, r.label_idx)
                      for r in store.table(name).iter_records())

    merged = store.table("predictions")
    merged_equal = (records("predictions") == records("single_predictions")
                    and sorted(rows) == sorted(single))
    emit(phase="workshop", step="config5_scoring", records=len(single),
         merged_records=merged.num_records,
         merged_from=merged.meta.get("merged_from"),
         merged_equal=merged_equal, kernel_launches=launches[
             "config5_single"], seconds=[seconds["config5_single"],
                                         seconds["config5_2_ranks"]])
    check(merged_equal and len(single) == n_val, "the 2-rank merged table "
          "equals the single-process table record for record")
    check(launches["config5_single"]["k1"]["tma"]
          == LAYERS_PER_FORWARD * -(-n_val // 128), "single-process scoring:"
          " 13 K1 launches a batch of 128, all tma")

    k1 = {v: sum(launches[s]["k1"][v] for s in
                 ("config3", "cache_features", "config5_single"))
          for v in ("tma", "simt")}
    k2 = {v: launches["config3"]["k2"][v] for v in ("tma", "simt")}
    seconds["phase"] = time.perf_counter() - t_phase
    emit(phase="workshop", k1_launches_by_variant=k1,
         k2_launches_by_variant=k2, merged_equal=merged_equal,
         seconds=seconds)
    return {"k1": k1, "k2": k2, "by_step": launches}


# lm_flash of bench.py: vocab 8192, max_len 2048, hidden 512, depth 6, 8 heads
# of 64, MLP 2048, bf16, learned positions
LM_CFG = dict(vocab_size=8192, max_len=LM_SEQ, hidden=512, depth=6,
              num_heads=LM_HEADS, mlp_dim=2048, dtype="bfloat16")
LM_ROWS = 256


def first_divergence_margins(logits, ref_tokens, got_tokens):
    """For each row whose tokens differ from ``ref_tokens``: the reference
    logits' top-2 margin at the first differing step. ``logits [B, T, V]``
    are the reference's logits at the steps that chose ``ref_tokens``."""
    import torch

    margins = []
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu()
    for r in range(ref_tokens.shape[0]):
        diff = (ref_tokens[r] != got_tokens[r]).nonzero()[0]
        if len(diff):
            margins.append(float(gap[r, diff[0]]))
    return margins


def phase_lm(tmp: str):
    """The LM serving path: LMBatchScorer over a 256 x 2,049 token table
    (K3 on every layer of every batch of 64), kernel against the xla tier,
    LMPackagedModel.score at batch 8 (xla_ckpt, no K3) and generate."""
    import numpy as np
    import torch

    from ddw_tpu_torch.data.prep import write_token_table
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm, generate
    from ddw_tpu_torch.ops import flash_attention as fa
    from ddw_tpu_torch.serving.batch import LMBatchScorer
    from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                                  save_lm_package)
    from ddw_tpu_torch.utils.config import LMCfg

    depth, k3 = LM_CFG["depth"], fa.flash_attention_cuda
    params = to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**LM_CFG)), torch.Generator().manual_seed(SEED)))[
            "params"]
    pkg = {dt: save_lm_package(os.path.join(tmp, f"lm_{dt}"),
                               LMCfg(**dict(LM_CFG, dtype=dt)), params)
           for dt in ("bfloat16", "float32")}
    pm = LMPackagedModel(pkg["bfloat16"])       # the card, by default
    check(pm.device.type == "cuda", "LMPackagedModel resolved to the card")
    store = TableStore(os.path.join(tmp, "lm_tables"))
    toks = np.random.RandomState(SEED + 4).randint(
        0, LM_CFG["vocab_size"], (LM_ROWS, LM_SEQ + 1)).astype(np.int32)
    table = write_token_table(store, "lm_tokens", toks, shard_size=64)

    # --- the main path, counted ------------------------------------------
    scorer = LMBatchScorer(pm)                  # batch_per_device=64
    batches = -(-LM_ROWS // scorer.batch)
    runs = []
    for i in range(2):                          # cold, then warm
        fa.reset_forward_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = scorer.score_table(table, out_store=store,
                                  out_name=f"lm_scores_{i}")
        runs.append(time.perf_counter() - t0)   # NLLs fetched: work done
        launches = k3.launches
        by_variant = dict(k3.launches_by_variant)
        check(launches == depth * batches,
              f"K3 launched {launches} times, expected {depth} x {batches}")
        check(by_variant["sm90"] == launches, f"every K3 launch of the "
              f"scoring run on the sm90 variant: {by_variant}")
    nll = np.array([v for _, v in rows])
    scored_tokens = LM_ROWS * LM_SEQ
    emit(phase="lm", rows=len(rows), batch=scorer.batch, k3_launches=launches,
         k3_launches_by_variant=by_variant,
         expected_launches=depth * batches, score_table_seconds=runs,
         tokens_per_s=[scored_tokens / r for r in runs],
         nll_mean=float(nll.mean()), nll_min=float(nll.min()),
         nll_max=float(nll.max()))
    check(len(rows) == LM_ROWS and bool(np.isfinite(nll).all()),
          "256 finite NLLs")
    check([p for p, _ in rows] == [r.path for r in table.iter_records()],
          "scores in table order")

    # --- kernel tier against the xla tier, one batch of 64 ----------------
    # bf16: the two tiers round p to bf16 against different maxima (the K
    # block's, the whole row's), so single attention outputs differ by a
    # bf16 ulp and a few of the 1e9 logits by several percent of their std
    # (3.8% over 16.7M logits at this width on the CPU); the RMS stays near
    # 0.65%. bf16 holds the RMS to 2e-2 * std and the max to 1e-1 * std;
    # f32 holds the max to 1e-4 * std.
    torch.backends.cuda.matmul.allow_tf32 = False
    cmp = {}
    for dt, rel, rms_rel in (("bfloat16", 1e-1, 2e-2),
                             ("float32", 1e-4, 1e-4)):
        model = pm.model if dt == "bfloat16" else \
            LMPackagedModel(pkg[dt]).model
        batch = torch.from_numpy(toks[:scorer.batch, :-1]).long().cuda()
        with torch.inference_mode():
            before = k3.launches
            logits_k = model(batch)
            check(k3.launches == before + depth, f"{dt}: K3 on every layer")
            saved = fa._XLA_PLAIN_MAX, fa._XLA_CKPT_MAX
            fa._XLA_PLAIN_MAX = fa._XLA_CKPT_MAX = 1 << 62  # the xla tier
            try:
                logits_x = model(batch)
            finally:
                fa._XLA_PLAIN_MAX, fa._XLA_CKPT_MAX = saved
            check(k3.launches == before + depth, f"{dt}: xla tier, no K3")
            diff = (logits_k - logits_x).abs_()
            err = diff.max().item()
            rms = diff.square_().mean().sqrt().item()
            std = logits_x.std().item()
            finite = bool(torch.isfinite(logits_k).all())
        cmp[dt] = {"max_abs_diff": err, "rms_diff": rms, "logits_std": std,
                   "max_tolerance": rel * std, "rms_tolerance": rms_rel * std}
        check(err <= rel * std and rms <= rms_rel * std and finite,
              f"{dt} logits with K3 against the xla tier's: max {err:.3g} "
              f"<= {rel} * std, rms {rms:.3g} <= {rms_rel} * std "
              f"(std {std:.3g})")
        del diff
        del logits_k, logits_x, model
        torch.cuda.empty_cache()
    emit(phase="lm", kernel_vs_xla_logits=cmp, tf32=False)

    # --- LMPackagedModel.score at batch 8: xla_ckpt, no K3 ----------------
    before = k3.launches
    s8 = pm.score(toks[:8])
    check(k3.launches == before, "score at batch 8 launched no K3")
    check(fa._attn_impl(torch.empty(8, LM_HEADS, LM_SEQ, 0),
                        torch.empty(8, LM_HEADS, LM_SEQ, 0), "auto")
          == "xla_ckpt", "batch 8 dispatches to xla_ckpt")
    d8 = float(np.abs(s8 - nll[:8]).max())
    emit(phase="lm", score_batch8=s8.tolist(), scorer_nll=nll[:8].tolist(),
         max_abs_diff=d8)
    check(d8 <= 2e-2, f"batch-8 score within 2e-2 of the scorer's ({d8:.3g})")

    # --- generate: greedy from 256-token prompts, batch 8 -----------------
    prompts = toks[:8, :256]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = pm.generate(prompts, 32)
    gen_s = time.perf_counter() - t0
    check(k3.launches == before, "generate launched no K3")
    check(greedy.shape == (8, 32) and greedy.min() >= 0
          and greedy.max() < LM_CFG["vocab_size"], "greedy tokens [8, 32]")
    with torch.inference_mode():
        full = pm.model(torch.from_numpy(prompts).long().cuda())[:, -1]
    tol = 2e-2 * full.std().item()
    first = full.argmax(-1).cpu().numpy()
    top2 = torch.topk(full, 2, -1).values
    decisive = ((top2[:, 0] - top2[:, 1]) > tol).cpu().numpy()
    check(bool(decisive.any()) and bool(
        (first == greedy[:, 0])[decisive].all()),
        "first generated token = argmax of the full forward's last logits "
        "wherever the top-2 margin exceeds 2e-2 * std")
    # decode from the padded bucket (200 -> 256) against the unpadded prompt
    short = toks[:8, :200]
    padded = pm.generate(short, 32)
    ref = generate(pm.model, torch.from_numpy(short), 32).cpu().numpy()
    with torch.inference_mode():
        seq = torch.from_numpy(np.concatenate([short, ref], 1)).long().cuda()
        ref_logits = pm.model(seq)[:, 199:231]
    margins = first_divergence_margins(ref_logits, ref, padded)
    same_rows = int((padded == ref).all(1).sum())
    check(all(m <= tol for m in margins),
          f"padded-bucket decode equals unpadded decode up to near-ties "
          f"(diverging rows' margins {margins}, tolerance {tol:.3g})")
    # a seeded sampled run, twice
    sampled = [pm.generate(prompts, 32,
                           torch.Generator(device="cuda").manual_seed(SEED),
                           temperature=1.0, top_k=50, top_p=0.95)
               for _ in range(2)]
    check(np.array_equal(*sampled), "seeded sampling repeats token for token")
    emit(phase="lm", generate_seconds=gen_s,
         decode_tokens_per_s=8 * 32 / gen_s, first_token_decisive_rows=int(
             decisive.sum()), padded_equals_unpadded_rows=same_rows,
         diverging_row_margins=margins, near_tie_tolerance=tol,
         sampled_distinct_tokens=int(len(np.unique(sampled[0]))))
    return by_variant, runs


RING_RANKS = (2, 4)
RING_BATCH = 4             # rows of 2,049 tokens per rank's backward
# The timed tree calls, in turns: the packed K6 all_reduce_sum runs (5
# calls) and the earlier per-leaf K6 (2 calls, one launch per leaf).
RING_TURNS = ("packed", "per_leaf", "packed", "packed", "per_leaf", "packed",
              "packed")
RING_SMALL_SLOT_BYTES = 4096   # 1,024-value slots: a pack of several launches
RING_MANY_LEAVES = 300         # past the 256 arrays one launch takes
NVLINK_BYTES_PER_S = 450e9     # H100 SXM, each way


def bits_equal(a, b) -> bool:
    """Same dtype, shape and bytes (NaNs and signed zeros included)."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def ring_rank(seed: int) -> dict:
    """One rank of the ``ring`` phase, spawned; every rank works on cuda:0.
    The full-width LM's f32 gradient tree from one bf16 backward on this
    rank's own batch, summed over the group by ``all_reduce_sum(impl=
    "pallas")`` (K6), with every check of the phase; returns its numbers."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from ddw_tpu_torch.models.convert import init_lm_weights
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.ops import ring_reduce as rr
    from ddw_tpu_torch.runtime import MeshSpec, all_reduce_sum, make_mesh
    from ddw_tpu_torch.runtime.dist import process_topology
    from ddw_tpu_torch.train.lm_step import lm_forward_and_grads
    from ddw_tpu_torch.train.step import TrainState
    from ddw_tpu_torch.utils.config import LMCfg

    torch.cuda.set_device(0)
    rank, n = process_topology()
    torch.set_num_threads(max(1, (os.cpu_count() or n) // n))  # host share
    k6 = rr.ring_all_reduce_cuda
    steps, t_step = {}, [time.perf_counter()]

    def step(name):  # host seconds of each step, for the phase line
        now = time.perf_counter()
        steps[name] = round(now - t_step[0], 3)
        t_step[0] = now

    cfg = LMCfg(**LM_CFG)
    model = init_lm_weights(build_lm(cfg),
                            torch.Generator().manual_seed(SEED)).cuda()
    step("model")
    toks = torch.from_numpy(np.random.RandomState(seed + rank).randint(
        0, cfg.vocab_size, (RING_BATCH, LM_SEQ + 1)).astype(np.int64)).cuda()
    _, _, grads = lm_forward_and_grads(TrainState(model, {}, 0),
                                       toks[:, :-1], toks[:, 1:], None)
    del model, toks
    step("backward")
    names = sorted(grads)
    numel = sum(grads[k].numel() for k in names)
    check(all(grads[k].dtype == torch.float32 for k in names),
          "the gradient tree is f32")
    expect = len(rr.ring_pack_plan([grads[k].numel() for k in names], n,
                                   rr.slot_elems_of(rr.SLOT_BYTES)).launches)
    check(expect == 1, f"{n} ranks: the LM tree packs into {expect} launches")

    def synced():
        torch.cuda.synchronize()
        dist.barrier()

    def reset_counts():
        k6.launches = 0
        k6.launches_by_variant = dict.fromkeys(k6.launches_by_variant, 0)

    # The main path: one all_reduce_sum of the whole tree, counted.
    synced()
    reset_counts()
    out = all_reduce_sum(grads, impl="pallas")
    torch.cuda.synchronize()
    launches = k6.launches
    check(launches == expect == k6.launches_by_variant["packed"],
          f"{n} ranks: K6 launched {k6.launches_by_variant}, expected "
          f"{expect} packed launch (the pack plan's)")
    step("main_call")
    cpu_out = {k: out[k].cpu() for k in names}
    digests = [hashlib.sha256(cpu_out[k].numpy().tobytes()).hexdigest()
               for k in names]
    every = [None] * n
    dist.all_gather_object(every, digests)
    check(all(d == digests for d in every),
          f"{n} ranks: every rank holds the same bits")
    cpu = {k: grads[k].cpu() for k in names}
    t0 = time.perf_counter()
    plain = all_reduce_sum(cpu, impl="pallas")
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(bits_equal(cpu_out[k], plain[k]) for k in names),
          f"{n} ranks: K6 equals its plain version over gloo bit for bit")
    max_err = max(float((cpu_out[k] - plain[k]).abs().max()) for k in names)
    del plain
    step("hashes_and_plain")
    flat = torch.cat([cpu[k].reshape(-1).double() for k in names])
    mag = flat.abs()
    dist.all_reduce(flat)
    dist.all_reduce(mag)
    got = torch.cat([cpu_out[k].reshape(-1).double() for k in names])
    gap = (got - flat).abs()
    check(bool((gap <= 1e-6 * mag).all()), f"{n} ranks: within 1e-6 * "
          f"sum|g| of the float64 sum (worst gap {float(gap.max()):.3e})")
    worst_rel = float((gap / mag.clamp_min(1e-300)).max())
    del flat, mag, got, gap, cpu_out
    step("float64_sum")

    # The same tree in bf16: an f32 ring, bf16 back, the plain version's
    # bits.
    gb = {k: grads[k].to(torch.bfloat16) for k in names}
    outb = all_reduce_sum(gb, impl="pallas")
    plainb = all_reduce_sum({k: gb[k].cpu() for k in names}, impl="pallas")
    check(all(bits_equal(outb[k].cpu(), plainb[k]) for k in names),
          f"{n} ranks: the bf16 tree equals the plain version's bf16 bits")
    del gb, outb, plainb
    step("bf16")

    # Edge leaves: sizes 1, 33 and under n*128 (f32), an int32 leaf, and a
    # leaf that a small-slot RingComm splits into several segments.
    def edge(size, dtype, r):
        g = np.random.RandomState(seed + 1000 * size + r)
        if dtype == torch.int32:
            return torch.from_numpy(g.randint(-2**28, 2**28, size)
                                    .astype(np.int32))  # no overflow at 4
        return torch.from_numpy(g.randn(size).astype(np.float32))

    cases = [(1, torch.float32), (33, torch.float32),
             (n * 128 - 7, torch.float32), (1000, torch.int32)]
    for size, dtype in cases:
        x = edge(size, dtype, rank)
        got = all_reduce_sum(x.cuda(), impl="pallas").cpu()
        check(bits_equal(got, all_reduce_sum(x, impl="pallas")),
              f"{n} ranks: edge leaf of {size} {dtype} equals plain")
        ref = sum(edge(size, dtype, r).double() for r in range(n))
        if dtype == torch.int32:
            check(torch.equal(got.double(), ref), f"int32 leaf of {size} is "
                  f"the exact sum")
        else:
            check(bool(((got.double() - ref).abs() <= 1e-6 * sum(
                edge(size, dtype, r).double().abs() for r in range(n))).all()),
                f"{n} ranks: edge leaf of {size} within 1e-6 * sum|x|")
    # A tree of f32 and int32 leaves (a bf16 one among the f32, a view at a
    # 4-byte offset that K6 copies to align): one launch per ring dtype.
    base = edge(5001, torch.float32, rank)
    mixed = {"a": edge(33, torch.float32, rank),
             "b": edge(1000, torch.int32, rank),
             "c": edge(700, torch.float32, rank).to(torch.bfloat16),
             "d": base[1:], "e": edge(n * 128 - 7, torch.int32, rank)}
    on_card = {k: v.cuda() for k, v in mixed.items()}
    on_card["d"] = base.cuda()[1:]
    before = k6.launches
    got = all_reduce_sum(on_card, impl="pallas")
    mixed_launches = k6.launches - before
    check(mixed_launches == 2, f"{n} ranks: the f32 + int32 tree took "
          f"{mixed_launches} launches, expected 2 (one per ring dtype)")
    plain = all_reduce_sum(mixed, impl="pallas")
    check(all(bits_equal(got[k].cpu(), plain[k]) for k in mixed),
          f"{n} ranks: the mixed tree equals the plain version")
    # More leaves than one launch takes: the plan's launches, the plain bits.
    many = [edge(1 + i, torch.float32, rank) for i in range(RING_MANY_LEAVES)]
    before = k6.launches
    got = rr.ring_all_reduce_tree_pallas([x.cuda() for x in many])
    many_launches = k6.launches - before
    check(many_launches == len(rr.ring_pack_plan(
        [x.numel() for x in many], n, rr.slot_elems_of(rr.SLOT_BYTES))
        .launches) == 2, f"{n} ranks: {RING_MANY_LEAVES} leaves took "
        f"{many_launches} launches, expected 2")
    check(all(bits_equal(g.cpu(), p) for g, p in zip(
        got, rr.ring_all_reduce_tree_plain(many))),
        f"{n} ranks: the {RING_MANY_LEAVES}-leaf tree equals plain")
    # A pack wider than a small slot: several launches along the plan.
    comm = rr.RingComm(None, torch.device("cuda", 0),
                       slot_bytes=RING_SMALL_SLOT_BYTES)
    xs = [edge(n * 3 * comm.slot_elems + 77, torch.float32, rank),
          edge(33, torch.float32, rank), edge(n * 700, torch.float32, rank)]
    before = k6.launches
    got = rr.ring_all_reduce_tree_pallas([x.cuda() for x in xs], comm=comm)
    segments = k6.launches - before
    check(segments == len(rr.ring_pack_plan(
        [x.numel() for x in xs], n, comm.slot_elems).launches) >= 3,
        f"{n} ranks: the small-slot pack ran as {segments} launches (>= 3, "
        f"the plan's)")
    check(all(bits_equal(g.cpu(), p) for g, p in zip(
        got, rr.ring_all_reduce_tree_plain(
            xs, None, slot_bytes=RING_SMALL_SLOT_BYTES))),
        f"{n} ranks: the small-slot pack equals the plain version")
    comm.close()

    # A size-1 mesh axis is a world of one: the input back, no launch.
    solo = make_mesh(MeshSpec((("data", -1), ("seq", 1))))
    before = k6.launches
    leaf = grads[names[0]]
    check(all_reduce_sum(leaf, (solo, "seq"), impl="pallas") is leaf
          and k6.launches == before, "a world of one launches nothing")
    step("edge_segment_solo")
    sub = None
    if n == 4:
        mesh = make_mesh(MeshSpec((("data", 2), ("seq", 2))))
        x = edge(5000, torch.float32, rank)
        got = all_reduce_sum(x.cuda(), (mesh, "seq"), impl="pallas").cpu()
        check(bits_equal(got, all_reduce_sum(x, (mesh, "seq"),
                                             impl="pallas")),
              "the seq-axis ring equals its plain version")
        mates = [rank - rank % 2, rank - rank % 2 + 1]
        ref = sum(edge(5000, torch.float32, r).double() for r in mates)
        check(bool(((got.double() - ref).abs() <= 1e-6 * sum(
            edge(5000, torch.float32, r).double().abs() for r in mates))
            .all()), "the seq ring sums its own data row's two ranks only")
        sub = mates

    step("subgroup")

    # Time: a group barrier before each call, CUDA events on every rank;
    # every timed call must give the main call's bits. The packed K6 through
    # all_reduce_sum and the earlier per-leaf K6 in turns.
    leaves = [grads[k] for k in names]
    times = {"packed": [], "per_leaf": []}
    per_leaf_launches = 0
    for variant in RING_TURNS:
        synced()
        before = k6.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if variant == "packed":
            again = all_reduce_sum(grads, impl="pallas")
        else:
            again = dict(zip(names, rr.ring_all_reduce_tree_pallas(
                leaves, _variant="per_leaf")))
            per_leaf_launches = k6.launches - before
        end.record()
        end.synchronize()
        times[variant].append(start.elapsed_time(end))
        check(all(bits_equal(out[k], again[k]) for k in names),
              f"{n} ranks: every call gives identical bits ({variant})")
        del again
    every = [None] * n
    dist.all_gather_object(every, times)
    rr.close_comms()
    step("timed_calls_and_close")
    library = gloo_all_reduce_times(grads, out, names, synced)
    step("library_gloo")
    trap = ring_trap(rank) if n == 2 else None
    return {"leaves": len(names), "values": numel, "launches": launches,
            "segments_small_slot": segments, "mixed_launches": mixed_launches,
            "many_leaves_launches": many_launches,
            "per_leaf_launches": per_leaf_launches, "max_abs_err": max_err,
            "worst_gap_over_sum_abs": worst_rel, "plain_ms": plain_ms,
            "call_ms_max_over_ranks": [
                max(t) for t in zip(*(e["packed"] for e in every))],
            "per_leaf_ms_max_over_ranks": [
                max(t) for t in zip(*(e["per_leaf"] for e in every))],
            "library": library, "seq_group": sub, "trap": trap,
            "host_s_by_step": steps}


RING_LIBRARY_CALLS = 3


def gloo_all_reduce_times(grads, out, names, synced):
    """K6's yardstick: ``torch.distributed.all_reduce`` over the same gloo
    group on each leaf of the same CUDA gradient tree (gloo stages CUDA
    tensors through the host), timed by K6's protocol: a barrier, CUDA
    events, the max over ranks, the median of 3 calls. Each call sums fresh
    copies and is held to K6's sum (within 1e-5 of the leaf's max |sum|,
    gloo adds in its own order). Returns ``{"ms_max_over_ranks": [...]}``
    or, when gloo refuses, ``{"error": ...}``."""
    import statistics

    import torch
    import torch.distributed as dist

    times = []
    try:
        for _ in range(RING_LIBRARY_CALLS):
            bufs = [grads[k].clone() for k in names]
            synced()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for b in bufs:
                dist.all_reduce(b)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            check(all(float((b - out[k]).abs().max()) <= 1e-5 * float(
                out[k].abs().max()) for b, k in zip(bufs, names)),
                "gloo's all_reduce of the tree agrees with K6's sum")
            del bufs
    except RuntimeError as e:
        if str(e).startswith("check failed"):
            raise
        return {"call": "torch.distributed.all_reduce (gloo, CUDA leaves)",
                "error": str(e).splitlines()[0]}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, times)
    per_call = [max(t) for t in zip(*every)]
    return {"call": "torch.distributed.all_reduce per leaf (gloo, CUDA "
                    "leaves)", "ms_max_over_ranks": per_call,
            "ms": statistics.median(per_call)}


RING_TRAP_BOUND_S = 2.0


def ring_trap(rank: int):
    """A peer that never arrives: rank 0 launches K6 with a 2 s wait bound
    while rank 1 stays away (its buffer mapped, its process alive). The
    kernel must trap and the rank see a CUDA error within a few seconds of
    the bound, not hang. Rank 0's CUDA context is dead afterwards, so this
    is the last thing the rank does."""
    import torch

    from ddw_tpu_torch.ops import ring_reduce as rr

    comm = rr.RingComm(None, torch.device("cuda", 0),
                       timeout_s=RING_TRAP_BOUND_S)
    if rank != 0:
        time.sleep(RING_TRAP_BOUND_S + 3)
        return None
    t0 = time.perf_counter()
    try:
        rr.ring_all_reduce_cuda(torch.ones(1000, device="cuda"), comm)
        torch.cuda.synchronize()
    except RuntimeError as e:  # torch's AcceleratorError is one
        return {"seconds": time.perf_counter() - t0,
                "error": str(e).splitlines()[0]}
    raise RuntimeError("check failed: K6 with an absent peer returned "
                       "without an error")


def phase_ring():
    """The collective layer at N = 2 and 4 ranks sharing the card: K6 over
    the full-width LM's gradient tree, through ``all_reduce_sum``."""
    import statistics

    import torch

    from ddw_tpu_torch.runtime.dist import spawn_cpu

    torch.cuda.empty_cache()
    rows, t_phase = {}, time.perf_counter()
    for n in RING_RANKS:
        t0 = time.perf_counter()
        res = spawn_cpu(ring_rank, n, SEED + 40, timeout_s=300)
        r = res[0]
        check(r["leaves"] == 102 and r["values"] == 28_360_704,
              f"the LM's gradient tree: {r['leaves']} leaves, "
              f"{r['values']} values")
        tree_bytes = r["values"] * 4
        row = {"ms": statistics.median(r["call_ms_max_over_ranks"]),
               "per_leaf_ms": statistics.median(
                   r["per_leaf_ms_max_over_ranks"]),
               "per_leaf_launches": r["per_leaf_launches"],
               "plain_ms": max(x["plain_ms"] for x in res),
               "bound_ms": 2 * n * tree_bytes / HBM_BYTES_PER_S * 1e3,
               "bound_ms_4_cards_nvlink": 2 * (n - 1) / n * tree_bytes
               / NVLINK_BYTES_PER_S * 1e3,
               "launches": r["launches"],
               "max_abs_err": max(x["max_abs_err"] for x in res),
               "library": r["library"]}
        emit(phase="ring", ranks=n, leaves=r["leaves"], values=r["values"],
             tree_bytes=tree_bytes,
             call_ms_max_over_ranks=r["call_ms_max_over_ranks"],
             per_leaf_ms_max_over_ranks=r["per_leaf_ms_max_over_ranks"],
             segments_small_slot=r["segments_small_slot"],
             mixed_tree_launches=r["mixed_launches"],
             many_leaves_launches=r["many_leaves_launches"],
             worst_gap_over_sum_abs=max(x["worst_gap_over_sum_abs"]
                                        for x in res),
             seq_groups=[x["seq_group"] for x in res],
             rank0_host_s_by_step=r["host_s_by_step"],
             wall_s=time.perf_counter() - t0, **row)
        if n == 2:
            trap = r["trap"]
            check(trap["seconds"] < RING_TRAP_BOUND_S + 5, f"an absent peer "
                  f"failed the rank after {trap['seconds']:.2f} s (bound "
                  f"{RING_TRAP_BOUND_S} s)")
            emit(phase="ring", absent_peer_trap=trap,
                 wait_bound_s=RING_TRAP_BOUND_S)
        rows[n] = row
    emit(phase="ring", seconds=time.perf_counter() - t_phase)
    return rows


DECODE_IMAGES, DECODE_SRC_PX, DECODE_PX = 128, 256, 224
DECODE_PIL_MEAN_TOL = 0.08   # tests/test_native_decode.py's closeness


def smooth_jpegs(n: int, px: int, seed: int) -> list:
    """Seeded smooth colour fields (the reference's decode-test images, at
    ``px`` square), JPEG quality 90."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:px, 0:px].astype(np.float32)
    out = []
    for i in range(n):
        f = rng.uniform(8, 40, size=3)
        arr = np.stack([(np.sin(x / f[0] + i) + 1) * 120,
                        (np.cos(y / f[1]) + 1) * 120,
                        (x + y + f[2] * i) % 255], -1).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def phase_decode():
    """The JPEG decoder this machine resolves (``native``: the libjpeg
    pipeline of ``ddw_tpu_torch/native``, built with g++ at first use; or
    ``pil``, the reference's fallback, with the build error). On 128 seeded
    JPEGs of 256 px decoded to 224 px: the images/s of PIL on a pool of one
    thread per host core (the loader's fallback path) and, with the native
    pipeline, of one ``decode_batch_native`` call, which must equal
    ``decode_one_native`` image by image and stay within the reference's
    PIL closeness (mean |native - PIL| < 0.08 on [-1, 1]). Host numbers,
    beside the host's core count. Returns the decoder's name."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ddw_tpu_torch.data.loader import _preprocess_image_pil, active_decoder
    from ddw_tpu_torch.native import decode as native

    t0 = time.perf_counter()
    decoder = active_decoder()
    build_s = time.perf_counter() - t0
    cores = os.cpu_count()
    jpegs = smooth_jpegs(DECODE_IMAGES, DECODE_SRC_PX, SEED + 21)
    decode_pil = lambda c: _preprocess_image_pil(c, DECODE_PX, DECODE_PX)

    def rate(fn) -> list:
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            runs.append(DECODE_IMAGES / (time.perf_counter() - t0))
        return sorted(runs)

    with ThreadPoolExecutor(max_workers=cores) as pool:
        pil_runs = rate(lambda: list(pool.map(decode_pil, jpegs)))
    row = dict(phase="decode", decoder=decoder, host_cores=cores,
               first_use_seconds=build_s, build_error=native.build_error(),
               images=DECODE_IMAGES, src_px=DECODE_SRC_PX, out_px=DECODE_PX,
               pil_pool_images_per_s_median=pil_runs[2],
               pil_pool_images_per_s_runs=pil_runs)
    if decoder != "native":
        emit(**row, note="the native pipeline did not build or load here: "
                         "the loader, the scorers and materialize_decoded "
                         "decode with PIL (the reference's fallback)")
        return decoder
    imgs, ok = native.decode_batch_native(jpegs, DECODE_PX, DECODE_PX,
                                          threads=cores)
    check(bool(ok.all()), "every seeded JPEG decodes natively")
    check(all(np.array_equal(imgs[i], native.decode_one_native(
        c, DECODE_PX, DECODE_PX)) for i, c in enumerate(jpegs)),
        "decode_batch_native equals decode_one_native image by image")
    pil_gap = [float(np.abs(imgs[i] - decode_pil(c)).mean())
               for i, c in enumerate(jpegs)]
    check(max(pil_gap) < DECODE_PIL_MEAN_TOL,
          f"native within the reference's PIL closeness (mean |diff| "
          f"{max(pil_gap):.4f} < {DECODE_PIL_MEAN_TOL})")
    out = np.empty((DECODE_IMAGES, DECODE_PX, DECODE_PX, 3), np.float32)
    runs = rate(lambda: native.decode_batch_native(
        jpegs, DECODE_PX, DECODE_PX, threads=cores, out=out))
    emit(**row, pil_mean_abs_diff_max=max(pil_gap),
         batch_call_images_per_s_median=runs[2],
         batch_call_images_per_s_runs=runs, threads=cores)
    return decoder


# the vision families at full width (bench.py's resnet50 and vit rows, and
# convnext_tiny): bf16, batch 128, 224x224, a seeded raw_u8 table
VISION_MODELS = ("resnet50", "convnext_tiny", "vit")
VISION_TRAIN, VISION_VAL, VISION_EPOCHS, VISION_SCORE = 384, 128, 3, 512
VISION_BF16_RMS_TOL = 0.1       # of the f32 logits' std: bf16 through depth
VIT_LOSS_TOL = 2e-2             # relative: the K3-K5 tier's fit against
                                # xla's, per epoch, bf16
VIT_RMS_TOL, VIT_MAX_TOL = 2e-2, 1e-1   # of std: lm phase's K3-vs-xla bound


def flash_counts() -> dict:
    """K3's, K4's and K5's launches, total and by variant."""
    from ddw_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                   flash_attention_dkv_cuda,
                                                   flash_attention_dq_cuda)

    return {k: {"total": fn.launches, **fn.launches_by_variant}
            for k, fn in (("k3", flash_attention_cuda),
                          ("k4", flash_attention_dq_cuda),
                          ("k5", flash_attention_dkv_cuda))}


def reset_flash_counts() -> None:
    from ddw_tpu_torch.ops.flash_attention import (reset_backward_counts,
                                                   reset_forward_counts)

    reset_forward_counts()
    reset_backward_counts()


def vision_cfgs(name: str):
    from ddw_tpu_torch.utils.config import DataCfg, ModelCfg, TrainCfg

    return (DataCfg(img_height=224, img_width=224),
            ModelCfg(name=name, num_classes=5, dtype="bfloat16",
                     freeze_base=False, dropout=0.0),
            TrainCfg(batch_size=BATCH, epochs=VISION_EPOCHS, warmup_epochs=0,
                     optimizer="adam", seed=SEED))


def vision_one_step(name: str, images, labels):
    """The loss and ``{name: grad}`` of one training forward and backward
    from the trainer's seeded init on a fixed batch (dropout 0): the same
    weights and batch in any process."""
    import torch

    from ddw_tpu_torch.models.layers import init_params
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.train.step import (TrainState, dropout_generator,
                                          forward_and_grads)

    _, mcfg, tcfg = vision_cfgs(name)
    model = build_model(mcfg)
    init_params(model, torch.Generator().manual_seed(tcfg.seed))
    loss, _, _, grads = forward_and_grads(TrainState(model.cuda(), {}, 0),
                                          images, labels,
                                          dropout_generator(tcfg.seed, 0, 0))
    torch.cuda.synchronize()
    return loss.float().item(), grads


def vision_run(name: str, tables, pkg_dir: str, score_x) -> dict:
    """``Trainer.fit`` from the seeded init, then the trained weights
    packaged and ``PackagedModel.predict_logits`` over ``score_x`` (median
    of 3 timed calls); the flash kernels' counts on each path."""
    import numpy as np
    import torch

    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.serving.package import (PackagedModel,
                                               save_packaged_model)
    from ddw_tpu_torch.train.trainer import Trainer

    data, mcfg, tcfg = vision_cfgs(name)
    reset_flash_counts()
    t0 = time.perf_counter()
    res = Trainer(data, mcfg, tcfg).fit(*tables)
    fit_s = time.perf_counter() - t0
    train_counts = flash_counts()
    v = to_flax_variables(res.state.model)
    pkg = save_packaged_model(pkg_dir, mcfg, [f"c{i}" for i in range(5)],
                              v["params"], v.get("batch_stats"))
    pm = PackagedModel(pkg)
    reset_flash_counts()
    logits = pm.predict_logits(score_x)
    score_counts = flash_counts()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm.predict_logits(score_x)
        runs.append(time.perf_counter() - t0)
    hist = res.history
    return {"history": hist, "fit_seconds": fit_s,
            "train_images_per_s": hist[-1]["images_per_sec"],
            "score_images_per_s": len(score_x) / sorted(runs)[1],
            "score_runs_s": runs, "logits": logits, "variables": v,
            "train_counts": train_counts, "score_counts": score_counts,
            "finite": bool(np.isfinite([[r["loss"], r["val_loss"]]
                                        for r in hist]).all()
                           and np.isfinite(logits).all())}


def vit_kernel_child(work: str) -> None:
    """The ViT run of the vision phase with both attention thresholds at 0
    (``DDW_ATTN_XLA_PLAIN_MAX=0 DDW_ATTN_XLA_CKPT_MAX=0``, read at import),
    in its own process: the same fit, the same one-step loss and gradients
    and the same package scored, every attention through K3 forward and
    K4/K5 backward. Writes its results to ``work/child.json``, the one-step
    gradients to ``child_grads.npz`` and the logits to ``child_logits_*``."""
    import numpy as np

    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.ops import flash_attention as fa
    from ddw_tpu_torch.serving.package import PackagedModel

    check(fa._XLA_PLAIN_MAX == 0 and fa._XLA_CKPT_MAX == 0,
          "the child reads both thresholds as 0")
    store = TableStore(os.path.join(work, "tables"))
    tables = (store.table("vision_train"), store.table("vision_val"))
    with np.load(os.path.join(work, "vit_inputs.npz")) as z:
        score_x, step_x, step_y = z["score_x"], z["step_x"], z["step_y"]
    import torch

    reset_flash_counts()
    loss, grads = vision_one_step("vit", torch.from_numpy(step_x).cuda(),
                                  torch.from_numpy(step_y).cuda())
    step_counts = flash_counts()
    np.savez(os.path.join(work, "child_grads.npz"),
             **{n: g.float().cpu().numpy() for n, g in grads.items()
                if g is not None})
    del grads
    run = vision_run("vit", tables, os.path.join(work, "pkg_vit_kernel"),
                     score_x)
    del run["variables"]
    ref_logits = PackagedModel(os.path.join(work, "pkg_vit")).predict_logits(
        score_x)
    np.save(os.path.join(work, "child_logits_same_pkg.npy"), ref_logits)
    np.save(os.path.join(work, "child_logits_own_pkg.npy"), run.pop("logits"))
    with open(os.path.join(work, "child.json"), "w") as f:
        json.dump({"one_step_loss": loss, "step_counts": step_counts,
                   **{k: run[k] for k in ("history", "fit_seconds",
                                          "train_images_per_s",
                                          "score_images_per_s",
                                          "train_counts", "score_counts",
                                          "finite")}}, f)


def phase_vision(tmp: str) -> dict:
    """resnet50, convnext_tiny and ViT at full width from the trainer's
    seeded init, bf16, batch 128, 224x224: ``Trainer.fit`` for 3 epochs of
    3 steps on a seeded class table (finite losses, the last epoch's below
    the first's), the trained weights packaged and ``predict_logits`` over
    512 images, bf16 logits within 0.1 x std (rms) of the same package in
    f32 (TF32 off); images/s trained and scored. ViT runs at the default
    attention thresholds (the xla tier, as the reference: no flash launch)
    and again in a child process with both thresholds at 0, where K3 must
    launch 6 times per forward and K4 and K5 6 times each per train step,
    all on mma. Against the default run: the one-step loss and every
    leaf's gradient from the same weights and batch within lm_train's bf16
    bounds (5e-3 relative, 5e-2 RMS gap over RMS), each epoch's train and
    val loss of the fit within 2e-2 relative, the logits of the package it
    trained within 0.1 x std (rms) of the default-trained package's, and
    the logits of one package within the lm phase's K3-vs-xla tolerance;
    its own fit's loss falling."""
    import numpy as np
    import torch

    import dataclasses

    from ddw_tpu_torch.data.loader import ShardedLoader, dequantize_raw_u8
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.serving.package import (PackagedModel,
                                               save_packaged_model)

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "vision")
    store = TableStore(os.path.join(work, "tables"))
    tables = (class_table(store, "vision_train", VISION_TRAIN, SEED + 31),
              class_table(store, "vision_val", VISION_VAL, SEED + 32))
    score_x = np.stack([np.frombuffer(r.content, np.uint8).reshape(
        224, 224, 3) for t in tables for r in t.iter_records()]).astype(
            np.float32)[:VISION_SCORE]
    dequantize_raw_u8(score_x)
    it = iter(ShardedLoader(tables[0], BATCH, shuffle=False))
    step_x, step_y = next(it)
    it.close()
    np.savez(os.path.join(work, "vit_inputs.npz"), score_x=score_x,
             step_x=step_x, step_y=step_y)
    steps = VISION_EPOCHS * (VISION_TRAIN // BATCH)
    evals = VISION_EPOCHS * (VISION_VAL // BATCH)
    forwards = -(-VISION_SCORE // BATCH)
    out = {}
    for name in VISION_MODELS:
        run = vision_run(name, tables, os.path.join(work, f"pkg_{name}"),
                         score_x)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        v = run.pop("variables")
        f32_pkg = save_packaged_model(
            os.path.join(work, f"pkg_{name}_f32"),
            dataclasses.replace(vision_cfgs(name)[1], dtype="float32"),
            [f"c{i}" for i in range(5)], v["params"], v.get("batch_stats"))
        ref = PackagedModel(f32_pkg).predict_logits(score_x[:BATCH])
        torch.backends.cudnn.allow_tf32 = True
        got = run["logits"][:BATCH]
        rms = float(np.sqrt(np.mean((got - ref) ** 2)) / ref.std())
        hist = run["history"]
        falling = hist[-1]["loss"] < hist[0]["loss"]
        row = {k: run[k] for k in ("fit_seconds", "train_images_per_s",
                                   "score_images_per_s", "train_counts",
                                   "score_counts")}
        emit(phase="vision", model=name, history=hist, **row,
             bf16_vs_f32_rms_over_std=rms, tolerance=VISION_BF16_RMS_TOL,
             train_steps=steps, eval_batches=evals, score_images=VISION_SCORE)
        check(run["finite"], f"{name}: finite losses and logits")
        check(falling, f"{name}: last epoch's loss {hist[-1]['loss']:.4f} "
              f"below the first's {hist[0]['loss']:.4f}")
        check(rms <= VISION_BF16_RMS_TOL,
              f"{name}: bf16 logits within {VISION_BF16_RMS_TOL} x std (rms) "
              f"of the f32 run of the same weights ({rms:.4f})")
        if name == "vit":
            check(all(c["total"] == 0 for c in
                      (*run["train_counts"].values(),
                       *run["score_counts"].values())),
                  "vit at the default thresholds launches no flash kernel "
                  "(the xla tier, as the reference)")
        run["bf16_vs_f32_rms_over_std"] = rms
        out[name] = run

    # --- ViT through K3-K5: a child process with both thresholds at 0 ----
    default_loss, default_grads = vision_one_step(
        "vit", torch.from_numpy(step_x).cuda(), torch.from_numpy(step_y).cuda())
    env = dict(os.environ, DDW_ATTN_XLA_PLAIN_MAX="0",
               DDW_ATTN_XLA_CKPT_MAX="0")
    code = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
            f"chip_smoke.vit_kernel_child({work!r})")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, "the ViT kernel-tier child process ran")
    with open(os.path.join(work, "child.json")) as f:
        child = json.load(f)
    same_pkg = np.load(os.path.join(work, "child_logits_same_pkg.npy"))
    own_pkg = np.load(os.path.join(work, "child_logits_own_pkg.npy"))
    ref = out["vit"]["logits"]
    std = float(ref.std())
    rms = float(np.sqrt(np.mean((same_pkg - ref) ** 2))) / std
    mx = float(np.abs(same_pkg - ref).max()) / std
    own_rms = float(np.sqrt(np.mean((own_pkg - ref) ** 2))) / std
    rel = abs(child["one_step_loss"] - default_loss) / abs(default_loss)
    with np.load(os.path.join(work, "child_grads.npz")) as z:
        (g_rms, g_rms_leaf), (g_mx, g_mx_leaf) = grad_gaps(
            {n: torch.from_numpy(z[n]) for n in z.files},
            {n: g.cpu() for n, g in default_grads.items() if g is not None})
    del default_grads
    hist, d_hist = child["history"], out["vit"]["history"]
    epoch_rel = max(abs(c[k] - d[k]) / abs(d[k]) for c, d in
                    zip(hist, d_hist) for k in ("loss", "val_loss"))
    sc, tc, st = child["score_counts"], child["train_counts"], \
        child["step_counts"]
    exp_train = {"k3": 6 * (steps + evals), "k4": 6 * steps, "k5": 6 * steps}
    emit(phase="vision", model="vit", tier="pallas (thresholds 0)",
         child_seconds=child_s, history=child["history"],
         train_images_per_s=child["train_images_per_s"],
         score_images_per_s=child["score_images_per_s"],
         one_step_loss=child["one_step_loss"], default_one_step_loss=
         default_loss, loss_rel_diff=rel, loss_tolerance=BF16_LOSS_TOL,
         grad_rms_gap_over_rms_max=g_rms, worst_rms_leaf=g_rms_leaf,
         grad_max_gap_over_max=g_mx, worst_max_leaf=g_mx_leaf,
         grad_rms_tolerance=BF16_GRAD_RMS_TOL,
         left_out=list(ZERO_GRAD_LEAVES), epoch_loss_rel_diff=epoch_rel,
         epoch_loss_tolerance=VIT_LOSS_TOL,
         trained_logits_rms_over_std=own_rms,
         trained_logits_tolerance=VISION_BF16_RMS_TOL,
         logits_rms_over_std=rms, logits_max_over_std=mx,
         logits_tolerance=[VIT_RMS_TOL, VIT_MAX_TOL], train_counts=tc,
         score_counts=sc, step_counts=st, expected_train=exp_train)
    check(child["finite"], "vit (kernel tier): finite losses and logits")
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"vit (kernel tier): last epoch's loss {hist[-1]['loss']:.4f} "
          f"below the first's {hist[0]['loss']:.4f}")
    check(st["k3"] == {"total": 6, "sm90": 0, "mma": 6, "cuda_cores": 0}
          and st["k4"]["mma"] == st["k4"]["total"] == 6
          and st["k5"]["mma"] == st["k5"]["total"] == 6,
          f"one ViT train step: 6 K3 + 6 K4 + 6 K5 launches, all mma: {st}")
    check(all(tc[k]["total"] == tc[k]["mma"] == n
              for k, n in exp_train.items()),
          f"ViT Trainer.fit: {exp_train} launches, all mma: {tc}")
    check(sc["k3"]["total"] == sc["k3"]["mma"] == 6 * forwards
          and sc["k4"]["total"] == sc["k5"]["total"] == 0,
          f"ViT scoring: 6 K3 launches per forward of 128, all mma: {sc}")
    check(rel <= BF16_LOSS_TOL, f"ViT one-step loss through K3-K5 within "
          f"{BF16_LOSS_TOL} of the xla tier's ({rel:.3g})")
    check(g_rms <= BF16_GRAD_RMS_TOL,
          f"ViT one-step gradients through K3-K5 within {BF16_GRAD_RMS_TOL} "
          f"RMS gap over RMS of the xla tier's, every leaf ({g_rms:.3g}, "
          f"{g_rms_leaf})")
    check(len(hist) == len(d_hist) and epoch_rel <= VIT_LOSS_TOL,
          f"ViT fit through K3-K5: every epoch's loss within {VIT_LOSS_TOL} "
          f"of the xla tier's fit ({epoch_rel:.3g})")
    check(own_rms <= VISION_BF16_RMS_TOL,
          f"ViT package trained through K3-K5: logits within "
          f"{VISION_BF16_RMS_TOL} x std (rms) of the xla-trained package's "
          f"({own_rms:.3g})")
    check(rms <= VIT_RMS_TOL and mx <= VIT_MAX_TOL,
          f"ViT logits through K3 within {VIT_RMS_TOL} (rms) and "
          f"{VIT_MAX_TOL} (max) x std of the xla tier's ({rms:.3g}, "
          f"{mx:.3g})")
    out["vit_kernel"] = child
    emit(phase="vision", wall_seconds=time.perf_counter() - t_phase)
    return out


PRETRAIN_EPOCHS = 6
PRETRAIN_WIDTH, PRETRAIN_PX, PRETRAIN_BATCH = 0.35, 32, 8   # 08's --quick


def mbv2_dw_shapes(width: float, px: int) -> list:
    """(H, W, C) of every stride-1 depthwise layer of MobileNetV2 at
    ``width`` on ``px`` x ``px`` images, in order, from the port's own
    block table and width rounding (SAME: a stride-2 layer gives ceil)."""
    from ddw_tpu_torch.models.mobilenet_v2 import (_INVERTED_RESIDUAL_CFG,
                                                   _make_divisible)

    h, ch, shapes = -(-px // 2), _make_divisible(32 * width), []
    for t, c, n, s in _INVERTED_RESIDUAL_CFG:
        for j in range(n):
            if s == 1 or j > 0:
                shapes.append((h, h, ch * t))
            else:
                h = -(-h // 2)
            ch = _make_divisible(c * width)
    return shapes


def pretrained_kernel_check() -> None:
    """K1 (bit for bit) and K2 (within its tolerance), f32, against their
    plain versions at every stride-1 depthwise shape 08's MobileNetV2 gets
    (batch 8, 32x32, width 0.35: 16x16 down to 1x1); the shape rule first
    held to ``DW_SHAPES`` at 224 and width 1."""
    import torch

    full = mbv2_dw_shapes(1.0, 224)
    check([(s, full.count(s)) for s in dict.fromkeys(full)]
          == [(s, n) for s, n in DW_SHAPES],
          "the depthwise shape rule gives DW_SHAPES at 224, width 1")
    shapes = list(dict.fromkeys(mbv2_dw_shapes(PRETRAIN_WIDTH, PRETRAIN_PX)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    errs = []
    for h, w, c in shapes:
        x, g = (torch.randn(PRETRAIN_BATCH, h, w, c, device="cuda",
                            generator=gen) for _ in range(2))
        taps = torch.randn(3, 3, c, device="cuda", generator=gen)
        errs.append(tma_check(x, taps, g, f"08's {(h, w, c)}"))
    emit(phase="pretrained", kernel_shapes=[[PRETRAIN_BATCH, *s]
                                            for s in shapes],
         dtype="float32", k1="bit for bit, with and without flip",
         k2_max_abs_err=max(e for e, _ in errs),
         k2_max_err_over_tolerance=max(r for _, r in errs))


def phase_pretrained(tmp: str) -> dict:
    """``examples_torch/08_pretrained_transfer.py``'s ``main`` on the card
    at its quick size (``--quick``: 32x32 images, MobileNetV2 0.35 in f32,
    batch 8) with ``model.dw_impl=pallas``, after 01's quick prep: pretrain
    6 epochs, export both layouts, convert, frozen transfer from the
    artifact against a frozen random backbone (3 epochs each), package and
    score. First K1 and K2 against their plain versions at this model's
    depthwise shapes. Checks: the two artifacts agree (max |diff| < 1e-5),
    pretrained beats random, and the exact K1/K2 counts of every step, all
    ``tma``."""
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.ops.depthwise_conv import reset_depthwise_counts

    t0 = time.perf_counter()
    pretrained_kernel_check()
    work = os.path.join(tmp, "pretrained")
    flags = ["--quick", "--workdir", work, "--device", "cuda"]
    run_example("01_data_prep", flags)
    reset_depthwise_counts()
    r = run_example("08_pretrained_transfer",
                    flags + ["--pretrain-epochs", str(PRETRAIN_EPOCHS),
                             "model.dw_impl=pallas"])
    k1k2 = {k: dict(c, total=sum(c.values())) for k, c in dw_counts().items()}
    res = r["out"]
    store = TableStore(os.path.join(work, "tables"))
    batch = PRETRAIN_BATCH

    def steps(name):
        return store.table(name).num_records // batch

    pre_s, pre_v = steps("pretrain_train"), steps("pretrain_val")
    s, v = steps("silver_train"), steps("silver_val")
    e = len(res["pretrained"].history)
    scored = len(res["scored"])
    exp_k1 = LAYERS_PER_FORWARD * (
        PRETRAIN_EPOCHS * (2 * pre_s + pre_v)     # unfrozen pretraining
        + 2 * e * (s + v)                         # two frozen head fits
        + -(-scored // batch))                    # scoring, batches of 8
    exp_k2 = LAYERS_PER_FORWARD * PRETRAIN_EPOCHS * pre_s
    emit(phase="pretrained", seconds=time.perf_counter() - t0,
         example_seconds=r["seconds"], lines=r["lines"][-8:],
         artifact_max_diff=res["artifact_max_diff"],
         pretrain_val_accuracy=res["pretrain"].val_accuracy,
         pretrained_frozen_val_accuracy=res["pretrained"].val_accuracy,
         random_frozen_val_accuracy=res["random"].val_accuracy,
         packaged_accuracy=res["packaged_accuracy"], launches=k1k2,
         expected={"k1": exp_k1, "k2": exp_k2})
    check(res["artifact_max_diff"] < 1e-5,
          "the torch- and keras-layout artifacts agree")
    check(res["contract_ok"], "frozen-pretrained beats frozen-random")
    check(k1k2["k1"]["total"] == k1k2["k1"]["tma"] == exp_k1
          and k1k2["k2"]["total"] == k1k2["k2"]["tma"] == exp_k2,
          f"K1/K2 launches {k1k2} equal {exp_k1} / {exp_k2}, all tma")
    return k1k2


def vit_paths(vision: dict, kern: str) -> dict:
    """A flash kernel's launches on the ViT paths of the vision phase (the
    child run with both thresholds at 0)."""
    child = vision["vit_kernel"]
    return {"vit_training": child["train_counts"][kern]["total"],
            "vit_scoring": child["score_counts"][kern]["total"]}


def vit_variants(vision: dict, kern: str) -> dict:
    child = vision["vit_kernel"]
    drop = lambda c: {k: v for k, v in c.items() if k != "total"}
    return {"vit_training": drop(child["train_counts"][kern]),
            "vit_scoring": drop(child["score_counts"][kern])}


def at_vit_shape(row: dict) -> dict:
    return {"shape": [VIT_BATCH * VIT_HEADS, VIT_PADDED, VIT_HEAD_DIM],
            "k_valid": VIT_TOKENS, "causal": False, "variant": "mma",
            **{k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by",
                                   "share_of_bound")}}


SERVE_REQUESTS = 32          # concurrent greedy LM requests per engine run
SERVE_SHARED = 256           # the prefix 8 of them share
SERVE_CLIENTS = 4            # submitting threads
SERVE_IMAGES = 64
SERVE_TOKEN_TIE = 0.05       # logits: how far under the argmax a bf16
#                              near-tie may pick (stream_check)
SERVE_IMAGE_TOL = 1e-2       # of max |logit|: batch 8 against 128, same K1
SERVE_DRAFT_NOISE = 0.1      # the twin draft's head noise, of its std
SERVE_SMALL_POOL = 256       # blocks of the preemption run (the largest
#                              request needs 72; 16 rows hold ~600)


def serve_mix():
    """32 seeded prompts of 16-1,024 tokens (8 of them, every fourth, start
    with one 256-token prefix), each asking for 32-128 new tokens."""
    import numpy as np

    rng = np.random.RandomState(SEED + 12)
    vocab = LM_CFG["vocab_size"]
    shared = rng.randint(0, vocab, SERVE_SHARED).astype(np.int32)
    prompts, steps = [], []
    for i in range(SERVE_REQUESTS):
        if i % 4 == 0:
            tail = rng.randint(0, vocab, rng.randint(1, 1025 - SERVE_SHARED))
            prompts.append(np.concatenate([shared, tail]).astype(np.int32))
        else:
            prompts.append(rng.randint(0, vocab, rng.randint(16, 1025)
                                       ).astype(np.int32))
        steps.append(int(rng.randint(32, 129)))
    return prompts, steps


def serve_engine_run(pm, prompts, steps, cfg, draft=None, **engine_kw
                     ) -> dict:
    """One engine over the mix: warm up every bucket, then submit from
    SERVE_CLIENTS threads with seeded staggered arrivals (request i with
    trace id ``req-i``); every future is waited on with a timeout and the
    engine stopped. With tracing or telemetry on, the drained ring and feed
    come back too."""
    import threading

    import numpy as np
    import torch

    from ddw_tpu_torch.serve import ServingEngine

    eng = ServingEngine(lm=pm, cfg=cfg, draft=draft, **engine_kw)
    try:
        t0 = time.perf_counter()
        eng.warmup(sorted({len(p) for p in prompts}))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        eng.start()
        futs = [None] * len(prompts)

        def client(c):
            rng = np.random.RandomState(SEED + 20 + c)
            for i in range(c, len(prompts), SERVE_CLIENTS):
                futs[i] = eng.submit_generate(prompts[i], steps[i],
                                              trace_id=f"req-{i}")
                time.sleep(float(rng.uniform(0.0, 0.02)))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        order = []
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _, i=i: order.append(i))
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        # then a repeat of the last request to finish whose prompt does not
        # end one token into a block: its blocks are the newest idle ones,
        # so it hits its own cached tail and clones it (copy-on-write)
        again = [i for i in order if len(prompts[i]) % 16 != 1][-1]
        repeat = eng.submit_generate(prompts[again], steps[again]).result(
            timeout=600)
        snap = eng.snapshot()
        trace = eng.trace_events() if cfg.trace else None
        feed = eng.telemetry_events() if cfg.telemetry else None
    finally:
        eng.stop()
    return {"tokens": [r.tokens for r in results], "snap": snap,
            "total_ms": [r.total_ms for r in results],
            "wall": wall, "warmup_s": warm,
            "tokens_per_s": sum(steps) / wall, "repeat": again,
            "repeat_tokens": repeat.tokens, "trace": trace, "feed": feed}


def teacher_forced_readings(pm, prompt, tokens, adapters=None):
    """The logits each of ``tokens`` was picked from, by one decode-mode
    forward (the contiguous cache at batch 1, generate's prefill path) over
    ``prompt`` and all but the last token, carrying ``adapters`` (an
    ``(stacks, [slot])`` pair) when the stream had one: per token, the top
    logit minus the token's (0 where it is the argmax), and the top-2
    margin."""
    import numpy as np
    import torch

    from ddw_tpu_torch.models.lm import init_cache

    tokens = np.asarray(tokens, np.int64).reshape(-1)
    seq = np.concatenate([np.asarray(prompt, np.int64), tokens[:-1]])
    with torch.inference_mode():
        logits = pm.model(torch.from_numpy(seq[None]).to(pm.device),
                          cache=init_cache(pm.model, 1),
                          adapters=adapters)[0, len(prompt) - 1:]
        logits = logits.float()
        top2 = torch.topk(logits, 2, dim=-1).values
        picked = logits.gather(1, torch.from_numpy(tokens[:, None]).to(
            logits.device))[:, 0]
        deficit = (top2[:, 0] - picked).cpu().numpy()
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    return deficit, margin


def stream_check(pm, prompts, refs, got, ref_readings=None) -> dict:
    """Every token of every stream against the logits it was picked from
    (teacher_forced_readings over the stream's own tokens): each must be
    the argmax there or within SERVE_TOKEN_TIE of it, a bf16 near-tie that
    another batch width may round the other way. The same readings over
    the sequential tokens give the limit's two sides: their largest
    deficit (what a sound path reads) and the median top-2 margin (what a
    wrong token would typically need to hide in). ``ref_readings`` caches
    the sequential readings by prompt index across calls."""
    import numpy as np

    ref_readings = {} if ref_readings is None else ref_readings
    ref_def, ref_margin, got_def, diverged = [], [], [], 0
    for i, (p, r, g) in enumerate(zip(prompts, refs, got)):
        key = (len(p), bytes(np.asarray(p, np.int32)), len(r))
        if key not in ref_readings:
            ref_readings[key] = teacher_forced_readings(pm, p, r)
        d_ref, m_ref = ref_readings[key]
        ref_def.append(d_ref)
        ref_margin.append(m_ref)
        if np.array_equal(np.asarray(r), np.asarray(g)):
            got_def.append(d_ref)
        else:
            diverged += 1
            got_def.append(teacher_forced_readings(pm, p, g)[0])
    ref_def, got_def = np.concatenate(ref_def), np.concatenate(got_def)
    return {"diverged": diverged, "tokens_checked": int(got_def.size),
            "tokens_not_argmax": int((got_def > 0).sum()),
            "max_deficit": float(got_def.max()),
            "sequential_max_deficit": float(ref_def.max()),
            "median_top2_margin": float(np.median(np.concatenate(
                ref_margin))),
            "limit": SERVE_TOKEN_TIE,
            "all_near_ties": bool(max(got_def.max(), ref_def.max())
                                  <= SERVE_TOKEN_TIE)}


def forced_check(pm, prompts, got, adapters=None) -> dict:
    """stream_check's rule without sequential references: every token of
    every stream within SERVE_TOKEN_TIE of the argmax of the logits it was
    picked from, the stream's own adapter carried (``adapters``: the pool's
    stacks and one slot per stream, or None for base streams)."""
    import numpy as np

    deficits = []
    for i, (p, g) in enumerate(zip(prompts, got)):
        ad = None if adapters is None else (adapters[0], [adapters[1][i]])
        deficits.append(teacher_forced_readings(pm, p, g, ad)[0])
    d = np.concatenate(deficits)
    return {"streams": len(got), "tokens_checked": int(d.size),
            "tokens_not_argmax": int((d > 0).sum()),
            "max_deficit": float(d.max()), "limit": SERVE_TOKEN_TIE,
            "all_near_ties": bool(d.max() <= SERVE_TOKEN_TIE)}


def phase_serve(tmp: str) -> tuple[dict, dict]:
    """The online serving engine on the card: the full-width bf16 LM
    through the paged engine (default EngineCfg), under preemption and on
    the slot lane, each against sequential generate; a full queue's
    Overloaded; the full-width MobileNetV2 package through the image lane
    (13 K1 launches a batch, all tma); speculative against greedy. Returns
    the summary and what serve_plus reuses (the package, mix, references,
    drafts and image inputs)."""
    import numpy as np
    import torch

    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.ops.depthwise_conv import (depthwise_conv3x3_cuda,
                                                  reset_depthwise_counts)
    from ddw_tpu_torch.serve import EngineCfg, Overloaded, ServingEngine
    from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                                  save_lm_package)
    from ddw_tpu_torch.serving.package import PackagedModel
    from ddw_tpu_torch.utils.config import LMCfg

    t_phase = time.perf_counter()
    lm_cfg = LMCfg(**LM_CFG)
    params = to_flax_variables(init_lm_weights(
        build_lm(lm_cfg), torch.Generator().manual_seed(SEED + 11)))["params"]
    pkg = save_lm_package(os.path.join(tmp, "serve_lm"), lm_cfg, params)
    pm = LMPackagedModel(pkg)                   # the card, by default
    check(pm.device.type == "cuda", "LMPackagedModel resolved to the card")
    prompts, steps = serve_mix()
    k3_before = flash_counts()

    # --- sequential generate: the reference tokens and the baseline -------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = [pm.generate(p[None], n)[0] for p, n in zip(prompts, steps)]
    seq_s = time.perf_counter() - t0
    seq_tps = sum(steps) / seq_s

    # --- the engine: paged (default), preemption, slot lane ---------------
    runs, ref_readings = {}, {}
    for name, cfg in (
            ("paged", EngineCfg()),
            ("preemption", EngineCfg(block_overcommit=3.0,
                                     kv_cache_blocks=SERVE_SMALL_POOL)),
            ("slot", EngineCfg(paged=False))):
        run = serve_engine_run(pm, prompts, steps, cfg)
        again = run["repeat"]
        tie = stream_check(pm, prompts + [prompts[again]],
                           refs + [refs[again]],
                           run["tokens"] + [run["repeat_tokens"]],
                           ref_readings)
        snap = run["snap"]
        runs[name] = {
            "wall_s": run["wall"], "warmup_s": run["warmup_s"],
            "tokens_per_s": run["tokens_per_s"],
            "snapshot_tokens_per_s": snap.get("serve.tokens_per_sec"),
            **{k: snap.get(f"serve.{k}") for k in (
                "completed", "prefills", "decode_ticks", "prefix_hit_tokens",
                "cow_copies", "preemptions", "blocks_used",
                "decode_rows_skipped", "ttft_ms_p50", "ttft_ms_p99",
                "total_ms_p50", "total_ms_p99", "queue_ms_p50")},
            "streams_equal": SERVE_REQUESTS + 1 - tie["diverged"], **tie}
        emit(phase="serve", run=name, **runs[name])
        check(snap["serve.completed"] == SERVE_REQUESTS + 1,
              f"{name}: every request completed")
        check(tie["all_near_ties"], f"{name}: every token of every stream "
              f"is the sequential path's argmax or within {SERVE_TOKEN_TIE} "
              f"of it ({tie})")
        if cfg.paged:
            check(snap["serve.blocks_used"] == 0.0,
                  f"{name}: no block held after the last request")
            check(snap["serve.prefix_hit_tokens"] > 0,
                  f"{name}: the shared prefix hit the cache")
    check(runs["paged"]["cow_copies"] >= 1,
          "paged: a copy-on-write clone of a shared block")
    check(runs["preemption"]["preemptions"] > 0,
          "the small overcommitted pool preempted streams")
    check(flash_counts() == k3_before,
          "the LM lane launched no flash-attention kernel")

    # --- a full queue is refused, structured --------------------------------
    eng = ServingEngine(lm=pm, cfg=EngineCfg(n_slots=1, queue_depth=2))
    try:
        eng.submit_generate(prompts[1], 4)
        eng.submit_generate(prompts[2], 4)
        try:
            eng.submit_generate(prompts[3], 4)
            refused = None
        except Overloaded as e:
            refused = e.to_dict()
    finally:
        eng.stop()
    check(refused is not None and refused["error"] == "overloaded"
          and refused["capacity"] == 2, f"a full queue gives Overloaded "
          f"({refused})")

    # --- speculative against greedy: a random 2-layer draft of the same
    # vocab (it agrees with the target almost never), and the target's twin
    # with SERVE_DRAFT_NOISE on its head, which agrees often enough that
    # rounds accept some drafts and rewind the rest ---------------------------
    draft_cfg = LMCfg(**dict(LM_CFG, depth=2))
    kernel = params["head"]["kernel"]
    twin = dict(params, head=dict(params["head"], kernel=(
        kernel + SERVE_DRAFT_NOISE * kernel.std() * np.random.RandomState(
            SEED + 14).standard_normal(kernel.shape)).astype(np.float32)))
    drafts = {
        "two_layer": LMPackagedModel(save_lm_package(
            os.path.join(tmp, "serve_draft"), draft_cfg, to_flax_variables(
                init_lm_weights(build_lm(draft_cfg), torch.Generator(
                ).manual_seed(SEED + 13)))["params"])),
        "twin": LMPackagedModel(save_lm_package(
            os.path.join(tmp, "serve_twin"), lm_cfg, twin))}
    sp_prompt = prompts[5][None, :128]
    greedy = pm.generate(sp_prompt, 64)
    spec_stats = {}
    for name, dm in drafts.items():
        spec, stats = pm.generate_speculative(dm, sp_prompt, 64, k=4)
        spec_tie = stream_check(pm, [sp_prompt[0]], greedy, spec)
        spec_stats[name] = stats
        emit(phase="serve", speculative=name, stats=stats, **spec_tie)
        check(spec_tie["all_near_ties"], f"speculative ({name} draft) equals "
              f"greedy up to bf16 near-ties ({spec_tie})")
    rate = spec_stats["twin"]["acceptance_rate"]
    check(0.0 < rate < 1.0, f"the twin draft is partly accepted ({rate})")

    # --- the image lane: the main phase's package, K1 on every batch --------
    images = synthetic_images(SERVE_IMAGES)
    img_pkg = os.path.join(tmp, "pkg_bfloat16_pallas")
    if not os.path.isdir(img_pkg):
        img_pkg = make_package(tmp, "bfloat16", "pallas",
                               seeded_variables(synthetic_images(N_IMAGES)))
    img = PackagedModel(img_pkg)
    x = images.astype(np.float32)
    from ddw_tpu_torch.data.loader import dequantize_raw_u8

    dequantize_raw_u8(x)
    ref = img.predict_logits(x)
    eng = ServingEngine(image=img, cfg=EngineCfg())
    try:
        eng.warmup()                            # builds K1, every bucket
        eng.start()
        torch.cuda.synchronize()
        before = eng.snapshot()["serve.image_batches"]
        reset_depthwise_counts()
        t0 = time.perf_counter()
        out = eng.predict(list(x), timeout_s=600)
        img_wall = time.perf_counter() - t0
        batches = int(eng.snapshot()["serve.image_batches"] - before)
        launches = depthwise_conv3x3_cuda.launches
        by_variant = dict(depthwise_conv3x3_cuda.launches_by_variant)
    finally:
        eng.stop()
    got = np.stack([r.logits for r in out])
    tol = SERVE_IMAGE_TOL * max(float(np.abs(ref).max()), 1.0)
    # the closest two requests' logits: a request-order fault moves a row at
    # least this far, so the tolerance must sit below it
    apart = float(min(np.abs(ref[i] - ref[j]).max()
                      for i in range(len(ref)) for j in range(i)))
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > tol
    agree = np.argmax(got, -1) == np.argmax(ref, -1)
    err = float(np.abs(got - ref).max())
    emit(phase="serve", image_requests=SERVE_IMAGES, image_batches=batches,
         k1_launches=launches, k1_launches_by_variant=by_variant,
         image_requests_per_s=SERVE_IMAGES / img_wall,
         max_abs_diff_vs_predict_logits=err, tolerance=tol,
         closest_requests_apart=apart,
         decisive=int(decisive.sum()), argmax_agree=int(agree.sum()))
    check(launches == LAYERS_PER_FORWARD * batches,
          f"K1 launched {launches} times, expected {LAYERS_PER_FORWARD} x "
          f"{batches} image batches")
    check(by_variant["tma"] == launches, f"every K1 launch of the image "
          f"lane on tma: {by_variant}")
    check(tol < apart, f"the tolerance {tol:.3g} lies below the closest two "
          f"requests' distance {apart:.3g}, so swapped requests fail")
    check(err <= tol and bool(decisive.any())
          and bool(agree[decisive].all()),
          f"image-lane logits within {tol:.3g} of predict_logits, argmax "
          f"equal wherever decisive")

    wall = time.perf_counter() - t_phase
    summary = {
        "engine_tokens_per_s": runs["paged"]["tokens_per_s"],
        "sequential_tokens_per_s": seq_tps,
        "ttft_ms_p50": runs["paged"]["ttft_ms_p50"],
        "ttft_ms_p99": runs["paged"]["ttft_ms_p99"],
        "total_ms_p50": runs["paged"]["total_ms_p50"],
        "total_ms_p99": runs["paged"]["total_ms_p99"],
        "image_requests_per_s": SERVE_IMAGES / img_wall,
        "k1_launches": launches, "k1_launches_by_variant": by_variant,
        "streams_diverged": {n: r["diverged"] for n, r in runs.items()},
        "speculative_acceptance": {n: st["acceptance_rate"]
                                   for n, st in spec_stats.items()},
        "wall_seconds": wall}
    emit(phase="serve", sequential_seconds=seq_s, **summary)
    return summary, {"pm": pm, "prompts": prompts, "steps": steps,
                     "refs": refs, "ref_readings": ref_readings,
                     "drafts": drafts, "img": img, "images": x,
                     "image_ref": ref, "image_tol": tol,
                     "paged_tokens_per_s": runs["paged"]["tokens_per_s"]}


SERVE_PLUS_SPEC_K = 4
SERVE_PLUS_SHORT = 8          # requests of the random-draft mix
SERVE_PLUS_PROMPT = 256       # prompt cut of the adapter / tenant / bulk
#                               requests (the mix's first 256 tokens)
SERVE_PLUS_STEPS = 32         # their new tokens
SERVE_ADAPTERS = 3
SERVE_ADAPTER_RANK = 8
SERVE_ADAPTER_B_STD = 0.02    # the seeded adapters' B: a delta of about
#                               0.1 on unit-scale projection inputs
SERVE_BULK_ITEMS = 16
SERVE_TENANT_ITEMS = 8        # batch-lane items of each weighted tenant
SERVE_TTFT_SLO_MS = 10_000.0  # the healthy-run objective: serve's TTFT p99
#                               was 2.3-2.9 s on the H100


def seeded_adapter(model, seed: int) -> dict:
    """One LoRA adapter tree over every projection of ``model`` (ddw_tpu's
    wire format: {block: {target: {lora_a, lora_b}}}), A ~ N(0, 1/fan_in)
    and a nonzero B ~ N(0, SERVE_ADAPTER_B_STD^2), rank 8."""
    import math

    import numpy as np

    from ddw_tpu_torch.models.lora import LM_LORA_TARGETS

    rng = np.random.RandomState(seed)
    out = {}
    for i, blk in enumerate(model.blocks()):
        targets = {}
        for t in LM_LORA_TARGETS:
            mod = getattr(blk.attn, t) if t in ("query", "key", "value",
                                                "out") else getattr(blk, t)
            fan_in = math.prod(mod.in_dims)
            targets[t] = {
                "lora_a": (rng.standard_normal(
                    (*mod.in_dims, SERVE_ADAPTER_RANK)) / math.sqrt(fan_in)
                    ).astype(np.float32),
                "lora_b": (SERVE_ADAPTER_B_STD * rng.standard_normal(
                    (SERVE_ADAPTER_RANK, *mod.features))).astype(np.float32)}
        out[f"backbone_block{i}"] = targets
    return out


def phase_serve_plus(tmp: str, ctx: dict) -> dict:
    """The rest of the online serving engine on serve's package, mix and
    drafts: the speculative tick, LoRA adapters, tenants and bulk jobs,
    tracing, telemetry and the system monitor (the module docstring's
    9c)."""
    import numpy as np
    import torch

    from ddw_tpu_torch.obs.slo import SLOMonitor, SLOObjective
    from ddw_tpu_torch.obs.trace import chrome_trace, span_index
    from ddw_tpu_torch.ops.depthwise_conv import (depthwise_conv3x3_cuda,
                                                  reset_depthwise_counts)
    from ddw_tpu_torch.serve import (EngineCfg, QuotaExceeded, ServingEngine,
                                     UnknownAdapter, save_adapter)
    from ddw_tpu_torch.tracking.tracker import Tracker
    from ddw_tpu_torch.utils.sysmon import host_keys_available

    t_phase = time.perf_counter()
    pm, prompts, steps = ctx["pm"], ctx["prompts"], ctx["steps"]
    refs, ref_readings = ctx["refs"], ctx["ref_readings"]
    k3_before = flash_counts()
    out: dict = {}

    # --- (a) the speculative tick: the twin draft over the mix, then the
    # random 2-layer draft over a short one --------------------------------
    spec = {}
    for name, n in (("twin", len(prompts)), ("two_layer", SERVE_PLUS_SHORT)):
        run = serve_engine_run(pm, prompts[:n], steps[:n],
                               EngineCfg(spec_k=SERVE_PLUS_SPEC_K),
                               draft=ctx["drafts"][name])
        again = run["repeat"]
        tie = stream_check(pm, prompts[:n] + [prompts[again]],
                           refs[:n] + [refs[again]],
                           run["tokens"] + [run["repeat_tokens"]],
                           ref_readings)
        snap = run["snap"]
        spec[name] = {
            "requests": n, "tokens_per_s": run["tokens_per_s"],
            "wall_s": run["wall"], "warmup_s": run["warmup_s"],
            **{k: snap.get(f"serve.{k}") for k in (
                "spec_acceptance_rate", "spec_k_effective",
                "spec_tokens_per_tick", "spec_proposed", "spec_accepted",
                "spec_bonus", "decode_ticks", "completed", "blocks_used",
                "ttft_ms_p50", "ttft_ms_p99")},
            "streams_equal": n + 1 - tie["diverged"], **tie}
        emit(phase="serve_plus", spec_draft=name, **spec[name])
        check(snap["serve.completed"] == n + 1,
              f"spec ({name}): every request completed")
        check(snap["serve.spec_proposed"] > 0,
              f"spec ({name}): the speculative tick ran")
        check(snap["serve.blocks_used"] == 0.0,
              f"spec ({name}): no block held after the last request")
        check(tie["all_near_ties"], f"spec ({name}): every token of every "
              f"stream within {SERVE_TOKEN_TIE} of its argmax ({tie})")
    check(spec["two_layer"]["spec_acceptance_rate"] < 0.1,
          f"the random draft is almost never accepted "
          f"({spec['two_layer']['spec_acceptance_rate']})")
    check(0.0 < spec["twin"]["spec_acceptance_rate"] < 1.0,
          f"the twin draft is partly accepted "
          f"({spec['twin']['spec_acceptance_rate']})")
    out["spec_tokens_per_s"] = spec["twin"]["tokens_per_s"]
    out["spec_off_tokens_per_s"] = ctx["paged_tokens_per_s"]
    out["spec_acceptance"] = {n: r["spec_acceptance_rate"]
                              for n, r in spec.items()}
    out["spec_k_effective"] = {n: r["spec_k_effective"]
                               for n, r in spec.items()}
    out["spec_streams_diverged"] = {n: r["diverged"] for n, r in spec.items()}

    # --- (b) LoRA adapters: three seeded adapters from their .npz files
    # and base rows in one batch ---------------------------------------------
    short = [p[:SERVE_PLUS_PROMPT] for p in prompts]
    eng = ServingEngine(lm=pm, cfg=EngineCfg(
        adapter_slots=4, adapter_rank=SERVE_ADAPTER_RANK))
    try:
        paths = []
        for i in range(SERVE_ADAPTERS):
            path = os.path.join(tmp, f"adapter_{i}.npz")
            save_adapter(path, seeded_adapter(pm.model, SEED + 30 + i),
                         rank=SERVE_ADAPTER_RANK, alpha=16.0)
            paths.append(path)
            eng.load_adapter(f"a{i}", path=path)
        eng.warmup([SERVE_PLUS_PROMPT])
        eng.start()
        names = [f"a{i}" for i in range(SERVE_ADAPTERS)] * 2 + [None, None]
        # rows 0-5: each adapter on two prompts; rows 6 and 7: base rows on
        # the prompts of rows 0 and 1
        ad_prompts = short[:6] + short[:2]
        t0 = time.perf_counter()
        futs = [eng.submit_generate(p, SERVE_PLUS_STEPS, adapter_id=n)
                for p, n in zip(ad_prompts, names)]
        got = [f.result(timeout=600).tokens for f in futs]
        ad_wall = time.perf_counter() - t0
        slots = [0 if n is None else eng.adapters.slot_of(n) for n in names]
        ad_tie = forced_check(pm, ad_prompts, got,
                              (eng.adapters.stacks(), slots))
        changed = sum(not np.array_equal(got[i], got[6 + i]) for i in (0, 1))
        # an unknown id: refused, nothing pinned, nothing queued
        try:
            eng.submit_generate(short[0], 4, adapter_id="nope")
            unknown = None
        except UnknownAdapter as e:
            unknown = str(e)
        g_before, view_before = eng.adapters.gauges(), eng.adapter_view()
        check(unknown is not None and g_before[
            "serve.adapter.pins_inflight"] == 0
              and eng.health()["queue_depth"] == 0,
              f"an unknown adapter_id is refused with no leak ({unknown})")
        # an unload / load cycle leaves the pool where it was
        eng.unload_adapter("a2")
        eng.load_adapter("a2", path=paths[2])
        g_after, view_after = eng.adapters.gauges(), eng.adapter_view()
        check(g_after == g_before and {
            k: (v["slot"], v["digest"], v["pins"])
            for k, v in view_after["adapters"].items()} == {
            k: (v["slot"], v["digest"], v["pins"])
            for k, v in view_before["adapters"].items()},
              f"an unload/load cycle leaves the pool's gauges and slots as "
              f"they were ({g_before} -> {g_after})")
        # prefix isolation: the same prompt under a0, then a1, then a0
        iso = max((6, 7), key=lambda i: len(short[i]))   # not in the batch
        hits = [eng.snapshot()["serve.prefix_hit_tokens"]]
        for n in ("a0", "a1", "a0"):
            eng.generate(short[iso], 4, adapter_id=n)
            hits.append(eng.snapshot()["serve.prefix_hit_tokens"])
        snap = eng.snapshot()
        check(hits[2] == hits[1] and hits[3] > hits[2],
              f"same prompt under two adapters shares no prefix block, "
              f"under one it does (prefix_hit_tokens {hits})")
        check(eng.adapters.gauges()["serve.adapter.pins_inflight"] == 0,
              "every pin returned")
    finally:
        eng.stop()
    ad_tokens = len(names) * SERVE_PLUS_STEPS
    out["adapter_tokens_per_s"] = ad_tokens / ad_wall
    emit(phase="serve_plus", adapters=SERVE_ADAPTERS,
         rank=SERVE_ADAPTER_RANK, rows=len(names),
         tokens_per_s=ad_tokens / ad_wall, wall_s=ad_wall,
         rows_changed_by_their_adapter=int(changed),
         adapter_loads=snap["serve.adapter_loads"],
         adapter_evictions=snap["serve.adapter_evictions"],
         adapter_pins=snap["serve.adapter_pins"],
         prefix_hit_tokens=hits, **ad_tie)
    check(ad_tie["all_near_ties"], f"adapters: every token of every stream "
          f"within {SERVE_TOKEN_TIE} of the argmax of its own adapter's "
          f"logits ({ad_tie})")
    check(changed >= 1, "the adapters change the tokens of their rows")

    # --- (c) tenants on the batch lane, a bulk generate job, interactive
    # traffic, a quota refusal, then a bulk predict job on the image lane ---
    cfg = EngineCfg(tenants=({"name": "gold", "weight": 3.0},
                             {"name": "bronze", "weight": 1.0},
                             {"name": "capped", "token_quota": 64}))
    eng = ServingEngine(lm=pm, image=ctx["img"], cfg=cfg)
    try:
        eng.warmup([SERVE_PLUS_PROMPT])
        eng.start()
        f_cap = eng.submit_generate(short[0], 48, tenant="capped")
        try:
            eng.submit_generate(short[1], 48, tenant="capped")
            quota = None
        except QuotaExceeded as e:
            quota = e.to_dict()
        check(quota is not None and quota["tenant"] == "capped",
              f"a capped tenant's second request gives QuotaExceeded "
              f"({quota})")
        done_order = []
        tenant_futs = []
        for i in range(SERVE_TENANT_ITEMS):
            for t in ("gold", "bronze"):
                f = eng.submit_batch_item(short[len(tenant_futs) % 8],
                                          SERVE_PLUS_STEPS, tenant=t)
                f.add_done_callback(lambda _, t=t: done_order.append(t))
                tenant_futs.append((t, len(tenant_futs) % 8, f))
        bulk = [short[8 + i] for i in range(SERVE_BULK_ITEMS)]
        t0 = time.perf_counter()
        job = eng.submit_batch(bulk, kind="generate",
                               num_steps=SERVE_PLUS_STEPS)
        inter = [eng.submit_generate(short[24 + i], SERVE_PLUS_STEPS)
                 for i in range(4)]
        inter_tokens = [f.result(timeout=600).tokens for f in inter]
        prog = job.wait(timeout_s=600)
        bulk_wall = time.perf_counter() - t0
        tenant_tokens = [f.result(timeout=600).tokens
                         for _, _, f in tenant_futs]
        f_cap.result(timeout=600)
        rows = job.result_rows()
        tenancy = eng.tenancy.view()
        check(prog["state"] == "done" and prog["completed"]
              == SERVE_BULK_ITEMS and prog["failed"] == 0
              and [r["index"] for r in rows] == list(range(SERVE_BULK_ITEMS)),
              f"the bulk job recorded every item once ({prog})")
        check(tenancy["capped"]["tokens_held"] == 0
              and tenancy["gold"]["tokens_held"] == 0,
              "every quota charge released")
        bulk_tie = forced_check(
            pm, bulk + [short[24 + i] for i in range(4)]
            + [short[j] for _, j, _ in tenant_futs],
            [r["tokens"] for r in rows] + inter_tokens + tenant_tokens)
        check(bulk_tie["all_near_ties"], f"bulk, tenant and interactive "
              f"streams within {SERVE_TOKEN_TIE} of their argmax "
              f"({bulk_tie})")
        # the image lane's bulk job: each request's future, to read its
        # logits beside the job's rows
        x = list(ctx["images"])
        by_id = {id(item): i for i, item in enumerate(x)}
        pred_futs = {}
        submit_pred = eng.submit_batch_predict

        def recorded(item, timeout_s=0.0):
            fut = submit_pred(item, timeout_s=timeout_s)
            pred_futs[by_id[id(item)]] = fut
            return fut

        eng.submit_batch_predict = recorded
        torch.cuda.synchronize()
        before = eng.snapshot()["serve.image_batches"]
        reset_depthwise_counts()
        t0 = time.perf_counter()
        pjob = eng.submit_batch(x, kind="predict")
        pprog = pjob.wait(timeout_s=600)
        pred_wall = time.perf_counter() - t0
        batches = int(eng.snapshot()["serve.image_batches"] - before)
        launches = depthwise_conv3x3_cuda.launches
        by_variant = dict(depthwise_conv3x3_cuda.launches_by_variant)
        logits = np.stack([pred_futs[i].result(timeout=600).logits
                           for i in range(len(x))])
        snap = eng.snapshot()
    finally:
        eng.stop()
    err = float(np.abs(logits - ctx["image_ref"]).max())
    tol = ctx["image_tol"]
    prow = pjob.result_rows()
    emit(phase="serve_plus", bulk_items=SERVE_BULK_ITEMS,
         bulk_wall_s=bulk_wall, bulk_progress=prog,
         tenant_completion_order=done_order, tenancy=tenancy,
         quota_refusal=quota, **bulk_tie,
         batch_items=snap.get("serve.batch_items"),
         batch_preemptions=snap.get("serve.batch_preemptions"))
    emit(phase="serve_plus", bulk_predict=len(x), image_batches=batches,
         k1_launches=launches, k1_launches_by_variant=by_variant,
         images_per_s=len(x) / pred_wall, max_abs_diff_vs_predict_logits=err,
         tolerance=tol, progress=pprog)
    check(pprog["completed"] == len(x) and [r["index"] for r in prow]
          == list(range(len(x))), "the predict job recorded every image "
          "once")
    check(launches == LAYERS_PER_FORWARD * batches and batches > 0,
          f"bulk predict: K1 launched {launches} times, expected "
          f"{LAYERS_PER_FORWARD} x {batches} image batches")
    check(by_variant["tma"] == launches, f"every K1 launch of the bulk "
          f"predict job on tma: {by_variant}")
    check(err <= tol and all(r["class_index"] == int(np.argmax(lg))
                             for r, lg in zip(prow, logits)),
          f"bulk predict logits within {tol:.3g} of predict_logits ({err:.3g})"
          f", rows' classes their argmax")
    out.update(bulk_items_per_s=SERVE_BULK_ITEMS / bulk_wall,
               bulk_predict_images_per_s=len(x) / pred_wall,
               k1_launches=launches, k1_launches_by_variant=by_variant)

    # --- (d) tracing, telemetry and the monitor on one run of the mix, then
    # the same run with both off --------------------------------------------
    tracker = Tracker(os.path.join(tmp, "serve_runs"), "serve_plus")
    mrun = tracker.start_run("observed")
    on = serve_engine_run(pm, prompts, steps,
                          EngineCfg(trace=True, telemetry=True), run=mrun,
                          monitor_interval_s=0.1)
    mrun.end()
    off = serve_engine_run(pm, prompts, steps, EngineCfg())
    evs = on["trace"]["events"]
    idx = span_index(evs)
    chains_ok = 0
    for i, total_ms in enumerate(on["total_ms"]):
        chain = idx.get(f"req-{i}", [])
        names_i = [e["name"] for e in chain]
        linked = all(b["parent"] == a["span"]
                     for a, b in zip(chain, chain[1:]))
        span_ms = ((chain[-1]["ts"] + chain[-1]["dur"] - chain[0]["ts"])
                   / 1e3 if chain else 0.0)
        if (names_i[:1] == ["queue"] and names_i[-1:] == ["decode"]
                and linked and abs(span_ms - total_ms)
                <= 1.0 + 1e-3 * total_ms):
            chains_ok += 1
    trace_path = os.path.join(tmp, "serve_trace.json")
    with open(trace_path, "w") as f:
        json.dump(chrome_trace(evs), f)
    feed = on["feed"]
    mon = SLOMonitor([SLOObjective(name="ttft", kind="latency",
                                   signal="serve.ttft_ms",
                                   threshold=SERVE_TTFT_SLO_MS,
                                   target=0.99)])
    mon.ingest(feed["source"], feed["samples"])
    now = max(s["ts"] for s in feed["samples"])
    states = [mon.evaluate([feed], now=now)["ttft"] for _ in range(3)]
    runv = tracker.get_run(mrun.run_id)
    hbm = {k: len(runv.metric_history(f"sys.device_hbm_{k}"))
           for k in ("used_gb", "limit_gb", "percent")}
    overhead = 1.0 - on["tokens_per_s"] / off["tokens_per_s"]
    emit(phase="serve_plus", traced_tokens_per_s=on["tokens_per_s"],
         untraced_tokens_per_s=off["tokens_per_s"],
         trace_telemetry_overhead=overhead, trace_events=len(evs),
         spans_dropped=on["trace"]["dropped"], chains_ok=chains_ok,
         chrome_trace_bytes=os.path.getsize(trace_path),
         telemetry_samples=len(feed["samples"]),
         telemetry_dropped=feed["dropped"], slo_states=states,
         slo_budget=mon.status()["objectives"]["ttft"]["budget"],
         monitor_series=hbm, host_keys=host_keys_available(),
         host_keys_note=(None if host_keys_available() else
                         "psutil does not import here: the sys.host_* "
                         "keys are absent"))
    check(chains_ok == len(prompts), f"each request one trace id whose "
          f"queue -> prefill -> decode spans chain from submission to its "
          f"last token ({chains_ok} of {len(prompts)})")
    check(on["trace"]["dropped"] == 0, "no span dropped")
    check(len(feed["samples"]) > 0 and any(
        s["name"] == "serve.ttft_ms" for s in feed["samples"]),
        "telemetry samples, TTFT observations among them")
    check("page" not in states, f"the SLO monitor does not page on the "
          f"healthy run ({states})")
    check(min(hbm.values()) > 0, f"monitor_interval_s logged the "
          f"sys.device_hbm_* series ({hbm})")
    check(flash_counts() == k3_before,
          "the LM lane launched no flash-attention kernel")
    out.update(traced_tokens_per_s=on["tokens_per_s"],
               untraced_tokens_per_s=off["tokens_per_s"],
               trace_telemetry_overhead=overhead,
               wall_seconds=time.perf_counter() - t_phase)
    emit(phase="serve_plus", **out)
    return out


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
    decoder = phase_decode()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    per_pass, per_layer, max_err = phase_kernel(flush)
    torch.backends.cudnn.allow_tf32 = True
    k3_times, k3_err = phase_lm_kernel(flush)
    torch.backends.cuda.matmul.allow_tf32 = False
    bwd_times, bwd_err = phase_lm_bwd_kernel(flush)
    vit_times, vit_err = phase_vit_kernel(flush)
    del flush
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ddw_chip_smoke_") as tmp:
        serving_k1, serving_k1_by = phase_main(tmp)
        train_launches, step_ms = phase_train(tmp)
        torch.cuda.empty_cache()
        workshop = phase_workshop(tmp)
        torch.cuda.empty_cache()
        vision = phase_vision(tmp)
        torch.cuda.empty_cache()
        pretrained = phase_pretrained(tmp)
        torch.cuda.empty_cache()
        k3_launches, score_runs = phase_lm(tmp)
        torch.cuda.empty_cache()
        lm_train_launches, lm_step_ms, lm_tokens_per_s = phase_lm_train(tmp)
        torch.cuda.empty_cache()
        serve, serve_ctx = phase_serve(tmp)
        torch.cuda.empty_cache()
        serve_plus = phase_serve_plus(tmp, serve_ctx)
        del serve_ctx
    torch.cuda.empty_cache()
    ring = phase_ring()
    src = "ddw_tpu_torch/ops/csrc/depthwise_sm90.cu"
    simt = {"simt": "ddw_tpu_torch/ops/csrc/depthwise_conv.cu (C * bytes "
                    "not a multiple of 16, or unaligned pointers)"}
    print(json.dumps({"kernels": [{
        "name": "depthwise_conv3x3_fwd",
        "route": "cuda",
        "source": src,
        "replaces": "ddw_tpu/ops/depthwise_conv.py:74",
        "variant": "tma",
        "launches": train_launches["k1"],
        "launches_by_path": {"train": train_launches["k1"],
                             "serving": serving_k1,
                             "workshop": sum(workshop["k1"].values()),
                             "pretrained": pretrained["k1"]["total"],
                             "online_serving": serve["k1_launches"],
                             "online_bulk_predict": serve_plus["k1_launches"],
                             "train_traced_epoch": train_launches[
                                 "k1_traced"]},
        "launches_by_variant": {"train": train_launches["k1_by_variant"],
                                "serving": serving_k1_by,
                                "workshop": workshop["k1"],
                                "pretrained": pretrained["k1"],
                                "online_serving": serve[
                                    "k1_launches_by_variant"],
                                "online_bulk_predict": serve_plus[
                                    "k1_launches_by_variant"],
                                "train_traced_epoch": train_launches[
                                    "k1_traced_by_variant"]},
        "max_abs_err": max_err["k1"],
        **per_pass["k1"],
        "share_of_bound": per_pass["k1"]["bound_ms"] / per_pass["k1"]["ms"],
        "bound_by": "bytes",
        "per": "one bf16 pass at batch 128 over the 13 stride-1 layers "
               "(a forward, or the dx of a backward); ms_simt is the "
               "per-thread-load kernel it replaces on this path, timed in "
               "turns with it",
        "layers": per_layer["k1"],
        "other_variants": simt,
    }, {
        "name": "depthwise_conv3x3_wgrad",
        "route": "cuda",
        "source": src,
        "replaces": "ddw_tpu/ops/depthwise_conv.py:91",
        "variant": "tma",
        "launches": train_launches["k2"],
        "launches_by_path": {"train": train_launches["k2"],
                             "workshop": sum(workshop["k2"].values()),
                             "pretrained": pretrained["k2"]["total"],
                             "train_traced_epoch": train_launches[
                                 "k2_traced"]},
        "launches_by_variant": {"train": train_launches["k2_by_variant"],
                                "workshop": workshop["k2"],
                                "pretrained": pretrained["k2"],
                                "train_traced_epoch": train_launches[
                                    "k2_traced_by_variant"]},
        "max_abs_err": max_err["k2"],
        **per_pass["k2"],
        "share_of_bound": per_pass["k2"]["bound_ms"] / per_pass["k2"]["ms"],
        "bound_by": "bytes",
        "per": "one bf16 backward at batch 128 over the 13 stride-1 "
               "layers; ms_simt as for the forward",
        "layers": per_layer["k2"],
        "other_variants": simt,
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ddw_tpu_torch/ops/csrc/flash_fwd_sm90.cu",
        "replaces": "ddw_tpu/ops/flash_attention.py:217",
        "variant": "sm90",
        "launches": lm_train_launches["k3"],
        "launches_by_path": {"lm_training": lm_train_launches["k3"],
                             "lm_batch_scoring": sum(k3_launches.values()),
                             "lm_training_traced": lm_train_launches[
                                 "traced"][0],
                             **vit_paths(vision, "k3")},
        "launches_by_variant": {
            "lm_training": lm_train_launches["k3_by_variant"],
            "lm_batch_scoring": k3_launches,
            "lm_training_traced": lm_train_launches["traced_by_variant"][0],
            **vit_variants(vision, "k3")},
        "max_abs_err": k3_err,
        **{k: k3_times["scoring"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ms_mma", "sm90_tflops")},
        "per": "one bf16 causal call at [512, 2048, 64]: one layer of a "
               "64-row LM scoring batch; ms_mma is the mma.sync kernel it "
               "replaces on this path, timed in turns with it",
        "other_variants": {
            "mma": "ddw_tpu_torch/ops/csrc/flash_attention.cu "
                   "(bf16, block_k a multiple of 16 other than 128, or D 32 "
                   "or 48: ViT's)",
            "cuda_cores": "ddw_tpu_torch/ops/csrc/flash_attention.cu "
                          "(f32, other bf16 blocks)"},
        "at_train_shape": {k: k3_times["training"][k] for k in (
            "ms", "ms_mma", "library_ms", "bound_ms", "sm90_tflops")},
        "at_vit_shape": at_vit_shape(vit_times["fwd"]),
        "max_abs_err_at_vit_shape": vit_err["k3"],
    }] + [{
        "name": f"flash_attention_{key}",
        "route": "cuda",
        "source": "ddw_tpu_torch/ops/csrc/flash_bwd_sm90.cu",
        "replaces": f"ddw_tpu/ops/flash_attention.py:{line}",
        "variant": "sm90",
        "launches": lm_train_launches[kern],
        "launches_by_path": {"lm_training": lm_train_launches[kern],
                             "lm_training_traced": lm_train_launches[
                                 "traced"][idx],
                             **vit_paths(vision, kern)},
        "launches_by_variant": {
            "lm_training": lm_train_launches[f"{kern}_by_variant"],
            "lm_training_traced": lm_train_launches["traced_by_variant"][
                idx],
            **vit_variants(vision, kern)},
        "max_abs_err": bwd_err[key],
        **{k: bwd_times[key][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_mma",
            "tflops", "share_of_bound", "backward_total_ms",
            "backward_total_ms_mma")},
        "per": "one bf16 causal call at [256, 2048, 64]: one layer of a "
               "32-row LM train step; library_ms is SDPA's whole backward "
               "(dq, dk and dv in one call), to be compared with "
               "backward_total_ms (delta, K4 and K5 as FlashAttentionFn "
               "runs them); ms_mma is the mma.sync kernel it replaces on "
               "this path, timed in turns with it",
        "other_variants": {
            "mma": "ddw_tpu_torch/ops/csrc/flash_attention.cu (bf16, D 32 "
                   "or 48: ViT's)",
            "cuda_cores": "ddw_tpu_torch/ops/csrc/flash_attention.cu (f32)"},
        "at_vit_shape": at_vit_shape(vit_times[key]),
        "max_abs_err_at_vit_shape": vit_err[key],
    } for key, line, kern, idx in (("dq", 425, "k4", 1),
                                    ("dkv", 445, "k5", 2))] + [{
        "name": "ring_all_reduce",
        "route": "cuda",
        "source": "ddw_tpu_torch/ops/csrc/ring_reduce.cu",
        "replaces": "ddw_tpu/ops/ring_reduce.py:112",
        "variant": "packed",
        "launches": sum(ring[n]["launches"] for n in RING_RANKS),
        "launches_by_path": {f"all_reduce_sum_{n}_ranks": ring[n]["launches"]
                             for n in RING_RANKS},
        "launches_per_tree_call": {f"{n}_ranks": ring[n]["launches"]
                                   for n in RING_RANKS},
        "max_abs_err": max(ring[n]["max_abs_err"] for n in RING_RANKS),
        **{k: ring[4][k] for k in ("ms", "plain_ms", "bound_ms",
                                   "per_leaf_ms")},
        "per_leaf_ms_2_ranks": ring[2]["per_leaf_ms"],
        "per_leaf_launches_per_tree_call": {
            f"{n}_ranks": ring[n]["per_leaf_launches"] for n in RING_RANKS},
        "bound_by": "bytes",
        "library_ms": ring[4]["library"].get("ms"),
        "library": ring[4]["library"]["call"],
        "library_error": ring[4]["library"].get("error"),
        "library_ms_2_ranks": ring[2]["library"].get("ms"),
        **{f"{k}_2_ranks": ring[2][k] for k in ("ms", "plain_ms",
                                                 "bound_ms")},
        "bound_ms_4_cards_nvlink": ring[4]["bound_ms_4_cards_nvlink"],
        "per": "one all_reduce_sum(impl='pallas') of the full-width LM's f32 "
               "gradient tree (102 leaves, 28,360,704 values) at 4 ranks "
               "that share the card (max over ranks; *_2_ranks at 2); "
               "launches are rank 0's at 2 and 4 ranks; plain_ms is the "
               "plain version over gloo on the host; per_leaf_ms is the "
               "earlier design (one launch per leaf), timed in turns with "
               "it",
    }],
        "decoder": decoder,
        "vision": {m: {k: vision[m][k] for k in (
            "train_images_per_s", "score_images_per_s")}
            for m in (*VISION_MODELS, "vit_kernel")},
        "train_step_ms": step_ms,
        "lm_score_tokens_per_s": LM_ROWS * LM_SEQ / score_runs[-1],
        "lm_train_step_ms": lm_step_ms,
        "lm_train_tokens_per_s": lm_tokens_per_s,
        "online_serving": {k: serve[k] for k in (
            "engine_tokens_per_s", "sequential_tokens_per_s", "ttft_ms_p50",
            "ttft_ms_p99", "total_ms_p50", "total_ms_p99",
            "image_requests_per_s", "streams_diverged", "wall_seconds")},
        "online_serving_plus": {k: serve_plus[k] for k in (
            "spec_tokens_per_s", "spec_off_tokens_per_s", "spec_acceptance",
            "spec_k_effective", "adapter_tokens_per_s",
            "bulk_items_per_s", "bulk_predict_images_per_s",
            "traced_tokens_per_s", "untraced_tokens_per_s",
            "trace_telemetry_overhead", "wall_seconds")}}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
