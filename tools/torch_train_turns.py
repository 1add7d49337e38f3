#!/usr/bin/env python3
"""Training throughput of several checkouts of the port, in turns, on one
card (ddw_tpu_torch): the lm_wide LM's tokens/s and ViT's images/s on the
flash-attention kernel tier.

    python3 tools/torch_train_turns.py --tree LABEL=DIR --tree LABEL=DIR ...
                                       [--order L1,L2,L2,L1] [--steps N]
                                       [--arms lm_wide vit]

Each DIR is the root of a checkout of this repository (``.`` for this one;
another commit unpacked with ``git archive`` into a git-ignored directory).
Every tree builds its flash-attention sources first (all trees at once,
before any timing). Then each label of ``--order`` (default: each label,
then each again in reverse) runs in a fresh process that imports that
tree's ``ddw_tpu_torch`` with both attention thresholds at 0
(``DDW_ATTN_XLA_PLAIN_MAX=0 DDW_ATTN_XLA_CKPT_MAX=0``, read at import, as
``chip_smoke.py``'s lm_wide phase and ViT child force the kernel tier) and
times, after two warm-up steps, ``--steps`` optimizer steps of each arm,
each step ended by a synchronise, on the host clock:

- ``lm_wide``: bench.py's ``lm_flash`` LM with 2 heads of 256 (vocab 8192,
  2,048 positions, hidden 512, 6 layers, MLP 2048, bf16) from seeded
  weights, adam 3e-4, ``make_lm_train_step`` on 32 seeded rows of 2,049
  tokens: training tokens/s (6 K3 + 6 K4 + 6 K5 launches a step);
- ``vit``: the vision phase's ViT (hidden 192, 6 layers of 4 heads of 48,
  patch 16) at 224 x 224, bf16, batch 128, adam, ``make_train_step`` on
  seeded images: training images/s (196 tokens padded to 256, k_valid 196).

Each run prints one JSON line with the medians and every step's time and
the K3/K4/K5 launches by variant of its timed steps. The last line before
the card's name and power limit pairs the n-th run of each label with the
n-th run of the first label and counts, per arm, the pairs in which that
label was faster, beside each label's range. Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

LM_CFG = dict(vocab_size=8192, max_len=2048, hidden=512, depth=6,
              num_heads=2, mlp_dim=2048, dtype="bfloat16")
LM_BATCH = 32
VIT_BATCH, VIT_PX = 128, 224
ARMS = ("lm_wide", "vit")


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def timed_steps(step, steps: int) -> list:
    """Seconds of each of ``steps`` calls of ``step()`` after two warm-up
    calls, each ended by a synchronise."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def lm_wide_arm(steps: int) -> dict:
    import numpy as np
    import torch

    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.train.lm_step import init_lm_state, make_lm_train_step
    from ddw_tpu_torch.train.step import make_optimizer
    from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

    cfg = LMCfg(**LM_CFG)
    model = build_lm(cfg)
    tx = make_optimizer(TrainCfg(optimizer="adam", learning_rate=3e-4))
    state = init_lm_state(model, tx, torch.Generator().manual_seed(0), "cuda")
    step = make_lm_train_step(model, tx)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LM_BATCH, cfg.max_len + 1)).astype(
            np.int32)).cuda()
    inputs, targets = toks[:, :-1], toks[:, 1:]
    secs = timed_steps(lambda: step(state, inputs, targets, 1), steps)
    med = sorted(secs)[len(secs) // 2]
    return {"tokens_per_s": LM_BATCH * cfg.max_len / med, "step_s": secs}


def vit_arm(steps: int) -> dict:
    import torch

    from ddw_tpu_torch.models.layers import init_params
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.train.step import (init_state, make_optimizer,
                                          make_train_step)
    from ddw_tpu_torch.utils.config import ModelCfg, TrainCfg

    mcfg = ModelCfg(name="vit", num_classes=5, dtype="bfloat16",
                    freeze_base=False, dropout=0.0)
    model = build_model(mcfg)
    init_params(model, torch.Generator().manual_seed(0))
    tx = make_optimizer(TrainCfg(optimizer="adam", learning_rate=1e-3))
    state = init_state(model.cuda(), tx)
    step = make_train_step(tx)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(VIT_BATCH, VIT_PX, VIT_PX, 3, device="cuda",
                        generator=gen)
    labels = torch.randint(0, 5, (VIT_BATCH,), device="cuda", generator=gen)
    secs = timed_steps(lambda: step(state, images, labels, 1), steps)
    med = sorted(secs)[len(secs) // 2]
    return {"images_per_s": VIT_BATCH / med, "step_s": secs}


def tree_child(tree: str, label: str, arms: list, steps: int) -> None:
    """One tree's arms in a process of its own, which imports that tree's
    package with the kernel tier forced: one JSON line."""
    os.environ["DDW_ATTN_XLA_PLAIN_MAX"] = "0"
    os.environ["DDW_ATTN_XLA_CKPT_MAX"] = "0"
    sys.path.insert(0, tree)
    from ddw_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(tree):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {tree}")
    row = {"phase": "tree", "label": label, "tree": tree}
    for arm in arms:
        fa.reset_forward_counts()
        fa.reset_backward_counts()
        row[arm] = {"lm_wide": lm_wide_arm, "vit": vit_arm}[arm](steps)
        row[arm]["launches_by_variant"] = {
            kern: dict(fn.launches_by_variant) for kern, fn in (
                ("k3", fa.flash_attention_cuda),
                ("k4", fa.flash_attention_dq_cuda),
                ("k5", fa.flash_attention_dkv_cuda))}
    emit(**row)


def tree_build(tree: str) -> dict:
    """Build one tree's flash-attention sources in a process of its own."""
    code = ("import json; from ddw_tpu_torch.ops import _build; "
            "srcs = ('flash_fwd_sm90.cu', 'flash_bwd_sm90.cu', "
            "'flash_attention.cu', 'flash_attention_bwd.cu'); "
            "from concurrent.futures import ThreadPoolExecutor as P; "
            "s = list(P(4).map(_build.build, srcs)); "
            "print(json.dumps({'seconds': max(x[1] for x in s)}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--order", default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    ap.add_argument("--tree-child", nargs=2, metavar=("DIR", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree_child:
        tree_child(*args.tree_child, args.arms, args.steps)
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if len(args.tree) < 2:
        ap.error("--tree needs two trees or more")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    trees = {label: os.path.abspath(path)
             for label, path in (t.split("=", 1) for t in args.tree)}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(trees)) as pool:
        for label, rep in zip(trees, pool.map(tree_build, trees.values())):
            emit(phase="tree_build", label=label, **rep)
    labels = list(trees)
    runs = {label: [] for label in labels}
    for label in (args.order.split(",") if args.order
                  else labels + labels[::-1]):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree-child",
             trees[label], label, "--arms", *args.arms, "--steps",
             str(args.steps)], capture_output=True, text=True,
            check=True).stdout
        print(out, end="", flush=True)
        runs[label].append(next(row for row in map(json.loads,
                                                   out.splitlines())
                                if row.get("phase") == "tree"))
    metric = {"lm_wide": "tokens_per_s", "vit": "images_per_s"}
    first = labels[0]
    summary = {"against": first, "ranges": {}, "wins": {}}
    for label in labels:
        summary["ranges"][label] = {
            arm: [min(r[arm][metric[arm]] for r in runs[label]),
                  max(r[arm][metric[arm]] for r in runs[label])]
            for arm in args.arms}
    for label in labels[1:]:
        pairs = list(zip(runs[first], runs[label]))
        summary["wins"][label] = {
            arm: sum(b[arm][metric[arm]] > a[arm][metric[arm]]
                     for a, b in pairs) for arm in args.arms}
        summary["wins"][label]["pairs"] = len(pairs)
    emit(phase="tree_wins", **summary)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
