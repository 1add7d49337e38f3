"""LoRA fine-tuning — the transfer contract, attention-era (the port's
mirror of ``examples/09_lora_finetune.py``).

Pretrain a base LM on one token process, then adapt it to a shifted task
training only rank-r adapters (+ the vocab head): the LM step applies the
freezing mask itself when the model carries ``lora_rank``, as
``frozen_prefixes`` does for the CNN families.

    python examples_torch/09_lora_finetune.py --quick --device cpu

Args: lm.key=value / train.* overrides; --rank for the adapter rank;
--targets to choose adapted projections (comma list from
query,key,value,out,fc1,fc2).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ddw_tpu_torch.models.convert import (load_flax_variables,  # noqa: E402
                                          to_flax_variables)
from ddw_tpu_torch.models.lm import build_lm  # noqa: E402
from ddw_tpu_torch.models.lora import (count_trainable, lora_mask,  # noqa
                                       merge_base_params)
from ddw_tpu_torch.runtime.mesh import (DATA_AXIS, MeshSpec,  # noqa: E402
                                        make_mesh)
from ddw_tpu_torch.train.lm_step import (init_lm_state,  # noqa: E402
                                         make_lm_train_step)
from ddw_tpu_torch.train.step import make_optimizer  # noqa: E402
from ddw_tpu_torch.utils.config import (LMCfg, TrainCfg,  # noqa: E402
                                        apply_overrides)
from ddw_tpu_torch.utils.device import resolve_device  # noqa: E402


def successor_text(rng, n_seqs, seq_len, vocab, step):
    """Affine successor streams (the example-07 corpus) with a configurable
    step — pretrain on one step, adapt to another."""
    start = rng.randint(0, vocab, size=(n_seqs, 1))
    seq = (start + step * np.arange(seq_len + 1)[None, :]) % vocab
    noise = rng.rand(n_seqs, seq_len + 1) < 0.05
    seq = np.where(noise, rng.randint(0, vocab, size=seq.shape), seq)
    return seq.astype(np.int32)


def fit(step_fn, state, data, steps, batch_size, seed, device):
    """Returns (first_loss, last_loss) — the first step's loss is computed
    before any update applies, i.e. the zero-shot loss."""
    first = last = float("nan")
    for i in range(steps):
        # modular gather: a constant [batch_size, seq] shape even when
        # batch_size does not divide len(data)
        idx = (np.arange(batch_size) + i * batch_size) % len(data)
        batch = torch.from_numpy(data[idx]).long().to(device)
        metrics = step_fn(state, batch[:, :-1], batch[:, 1:], seed + i)
        last = float(metrics["loss"])
        if i == 0:
            first = last
    return first, last


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny model + few steps")
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--targets", default="query,value")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfgs = {"lm": LMCfg(vocab_size=64, max_len=128, hidden=64, depth=2,
                        num_heads=4, mlp_dim=128, dtype="float32"),
            "train": TrainCfg(batch_size=8, learning_rate=3e-3,
                              optimizer="adam", warmup_epochs=0)}
    apply_overrides(cfgs, args.overrides)
    lm_cfg, train_cfg = cfgs["lm"], cfgs["train"]
    seq = 32 if args.quick else min(lm_cfg.max_len, 128)
    pre_steps, ft_steps = (30, 40) if args.quick else (200, 200)

    # data parallel over the world (one rank here): the batch rounds to a
    # multiple of the data axis, as the JAX example's shard_map needs
    dp = make_mesh(MeshSpec(((DATA_AXIS, -1),))).shape[DATA_AXIS]
    train_cfg.batch_size = max(train_cfg.batch_size, dp) // dp * dp
    rng = np.random.RandomState(train_cfg.seed)

    # -- 1. pretrain the base LM on the step-1 successor process ------------
    base = build_lm(lm_cfg)
    tx = make_optimizer(train_cfg)
    state = init_lm_state(base, tx, torch.Generator().manual_seed(
        train_cfg.seed), device=device)
    step_fn = make_lm_train_step(base, tx)
    pre_data = successor_text(rng, 512, seq, lm_cfg.vocab_size, step=1)
    t0 = time.time()
    _, pre_loss = fit(step_fn, state, pre_data, pre_steps,
                      train_cfg.batch_size, 1, device)
    print(f"pretrain: loss {pre_loss:.3f}  ({time.time() - t0:.1f}s)")

    # -- 2. LoRA-adapt to the step-3 process --------------------------------
    lora_cfg = dataclasses.replace(
        lm_cfg, lora_rank=args.rank,
        lora_targets=tuple(args.targets.split(",")))
    tuned = build_lm(lora_cfg)
    ft_tx = make_optimizer(train_cfg)   # the LM step applies the mask
    ft_state = init_lm_state(tuned, ft_tx, torch.Generator().manual_seed(2),
                             device=device)
    grafted = merge_base_params(to_flax_variables(tuned)["params"],
                                to_flax_variables(base)["params"])
    load_flax_variables(tuned, {"params": grafted})
    ft_step = make_lm_train_step(tuned, ft_tx)
    ft_data = successor_text(rng, 512, seq, lm_cfg.vocab_size, step=3)

    trainable, total = count_trainable(grafted)
    print(f"adapters: rank {args.rank} on {args.targets} -> "
          f"{trainable}/{total} params train ({trainable / total:.1%})")
    zs_loss, ft_loss = fit(ft_step, ft_state, ft_data, ft_steps,
                           train_cfg.batch_size, 3, device)
    print(f"adapt: loss {zs_loss:.3f} -> {ft_loss:.3f}")

    # -- 3. the base stayed frozen ------------------------------------------
    after = to_flax_variables(tuned)["params"]
    mask = lora_mask(grafted)

    def moved(a, b, m):
        if isinstance(a, dict):
            return [x for k in a for x in moved(a[k], b[k], m[k])]
        return [bool((a != b).any()) and not m]

    assert not any(moved(grafted, after, mask)), \
        "frozen base parameters moved"
    print(f"final: adapt_loss={ft_loss:.3f} "
          f"trainable_frac={trainable / total:.3f} base_frozen=True")
    return {"pretrain_loss": pre_loss, "zero_shot_loss": zs_loss,
            "adapt_loss": ft_loss, "trainable": trainable, "total": total}


if __name__ == "__main__":
    main()
