"""Long-context LM training — DP x sequence parallelism over gloo ranks (the
port's mirror of ``examples/07_lm_long_context.py``).

Trains a character-level TransformerLM on synthetic text with the sequence
axis split across ranks, so the context grows with the ranks instead of one
device's memory: attention runs as a ring
(``ddw_tpu_torch.parallel.ring_attention``, K3 forward and K4/K5 backward
at every attended hop at the kernel tier), and the gradients are averaged
over data x seq. The ranks are ``--procs`` processes joined by a gloo group
(``runtime.dist.spawn_cpu``); on the card they share it.

    python examples_torch/07_lm_long_context.py --quick --device cpu
    python examples_torch/07_lm_long_context.py --quick --procs 4 --moe 4

Args: lm.key=value overrides (e.g. lm.hidden=512), train.* for the loop,
--seq-devices to size the seq axis (default: half the ranks), --moe E to
route the MLPs through E Switch experts partitioned over the data axis
(expert parallelism: an all-to-all token exchange), --pipeline STAGES to
train the same model under the GPipe schedule instead (stages over the
ranks), --trainer for LMTrainer's managed loop, --speculative to decode
the trained model through draft-verified rounds as well.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ddw_tpu_torch.utils.config import (LMCfg, TrainCfg,  # noqa: E402
                                        apply_overrides)


def synthetic_text(rng: np.random.RandomState, n_seqs: int, seq_len: int,
                   vocab: int) -> np.ndarray:
    """A noisy affine successor process: the next token is predictable, so
    the loss curve means something."""
    step = rng.randint(1, vocab - 1)
    start = rng.randint(0, vocab, size=(n_seqs, 1))
    seq = (start + step * np.arange(seq_len + 1)[None, :]) % vocab
    noise = rng.rand(n_seqs, seq_len + 1) < 0.05
    seq = np.where(noise, rng.randint(0, vocab, size=seq.shape), seq)
    return seq.astype(np.int32)


def _pipeline_fix(lm_cfg, train_cfg, stages: int) -> None:
    lm_cfg.dropout = 0.0  # the pipeline step is deterministic
    if lm_cfg.depth % stages:
        adjusted = max(stages, lm_cfg.depth // stages * stages)
        print(f"[pipeline] adjusting lm.depth {lm_cfg.depth} -> {adjusted} "
              f"(must divide {stages} stages)")
        lm_cfg.depth = adjusted


def _trainer_rank(lm_cfg, train_cfg, sp, device, procs):
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.train.lm_trainer import LMTrainer

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // procs))
    rng = np.random.RandomState(train_cfg.seed)
    tr = LMTrainer(lm_cfg, train_cfg, device=device, seq_devices=sp)
    dp = tr.mesh.shape["data"]
    seq_len = min(lm_cfg.max_len - 1, 64 * sp) // sp * sp
    # the 0.9 train split must cover at least one global batch
    n_seqs = max(96, 3 * train_cfg.batch_size * dp)
    corpus = synthetic_text(rng, n_seqs, seq_len, lm_cfg.vocab_size)
    res = tr.fit(corpus)
    return {"history": res.history, "epochs_run": res.epochs_run,
            "val_loss": res.val_loss, "val_accuracy": res.val_accuracy,
            "mesh": tr.mesh.shape,
            "params": to_flax_variables(res.state.model)["params"]}


def _loop_rank(lm_cfg, train_cfg, sp, stages, moe, steps, device, procs):
    """The raw step loop of one rank: DP x SP (x EP), or DP x PP."""
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.runtime.mesh import (DATA_AXIS, SEQ_AXIS, MeshSpec,
                                            make_mesh, process_count)
    from ddw_tpu_torch.train.lm_step import (init_lm_state,
                                             make_lm_eval_step,
                                             make_lm_train_step)
    from ddw_tpu_torch.train.step import make_optimizer
    from ddw_tpu_torch.utils.device import resolve_device

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // procs))
    dev = resolve_device(device)
    n = process_count()
    gen = torch.Generator().manual_seed(train_cfg.seed)
    tx = make_optimizer(train_cfg)
    if stages:
        from ddw_tpu_torch.parallel.pipeline import (init_pp_state,
                                                     make_pp_lm_train_step)

        dp = n // stages
        mesh = make_mesh(MeshSpec(((DATA_AXIS, dp), ("pipe", stages))))
        model = build_lm(lm_cfg)
        state = init_pp_state(model, tx, mesh, gen, device=dev)
        pp = make_pp_lm_train_step(model, tx, mesh, data_axis=DATA_AXIS,
                                   num_microbatches=2)
        step = lambda st, i, t, seed: pp(st, i, t)  # noqa: E731
        eval_step = None
        sp = 1
    else:
        dp = n // sp
        mesh = make_mesh(MeshSpec(((DATA_AXIS, dp), (SEQ_AXIS, sp))))
        seq_axis = SEQ_AXIS if sp > 1 else None
        model = build_lm(lm_cfg, seq_axis=seq_axis,
                         expert_axis=DATA_AXIS if moe else None)
        state = init_lm_state(model, tx, gen, dev)
        step = make_lm_train_step(model, tx, train_cfg.grad_accum_steps,
                                  seq_axis=seq_axis, mesh=mesh)
        eval_step = make_lm_eval_step(model, seq_axis=seq_axis, mesh=mesh)
    # global batch and sequence divisible by the mesh axes
    batch = max(train_cfg.batch_size, dp) // dp * dp
    if stages:   # two microbatches must divide each data shard
        batch = -(-batch // (2 * dp)) * (2 * dp)
    seq_len = min(lm_cfg.max_len, 64 * sp) // sp * sp
    tokens = synthetic_text(np.random.RandomState(train_cfg.seed), batch,
                            seq_len, lm_cfg.vocab_size)
    rows = batch // dp
    d = mesh.axis_index(DATA_AXIS)
    local = tokens[d * rows:(d + 1) * rows]
    s_loc = seq_len // sp
    r = mesh.axis_index(SEQ_AXIS) if SEQ_AXIS in mesh.shape else 0
    x = torch.from_numpy(local[:, :-1][:, r * s_loc:(r + 1) * s_loc]).to(dev)
    y = torch.from_numpy(local[:, 1:][:, r * s_loc:(r + 1) * s_loc]).to(dev)
    log = []
    t0 = time.time()
    for i in range(steps):
        metrics = step(state, x, y, i)
        if i % max(1, steps // 6) == 0:
            log.append(f"step {i:4d}  loss={float(metrics['loss']):.4f}  "
                       f"acc={float(metrics['accuracy']):.3f}")
    float(metrics["loss"])
    dt = time.time() - t0
    final = eval_step(state, x, y) if eval_step else metrics
    return {"log": log, "mesh": mesh.shape, "batch": batch,
            "seq_len": seq_len, "seconds": dt, "steps": steps,
            "loss": float(final["loss"]), "acc": float(final["accuracy"]),
            "aux": (float(metrics["aux_loss"]) if "aux_loss" in metrics
                    else None),
            "n_params": sum(p.numel() for p in state.model.parameters()),
            "params": to_flax_variables(state.model)["params"],
            "prompt": tokens[:1, :16], "stream": tokens[0, 16:32]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny model + few steps")
    ap.add_argument("--procs", type=int, default=4,
                    help="ranks (processes) of the gloo group")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card, shared by the ranks) "
                         "or 'cpu'")
    ap.add_argument("--seq-devices", type=int, default=0,
                    help="ranks on the seq axis (0 = half the ranks)")
    ap.add_argument("--moe", type=int, default=0, metavar="E",
                    help="route MLPs through E Switch experts, partitioned "
                         "over the data axis (expert parallelism)")
    ap.add_argument("--pipeline", type=int, default=0, metavar="STAGES",
                    help="train under the GPipe pipeline schedule with this "
                         "many stages instead of DPxSP")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--speculative", action="store_true",
                    help="also decode via draft-verified speculative rounds")
    ap.add_argument("--trainer", action="store_true",
                    help="train via LMTrainer (epochs, checkpoints, tracker, "
                         "LR schedules) instead of the raw step loop")
    ap.add_argument("overrides", nargs="*",
                    help="lm.key=value / train.key=value")
    args = ap.parse_args(argv)

    from ddw_tpu_torch.models.convert import load_flax_variables
    from ddw_tpu_torch.models.lm import build_lm, generate
    from ddw_tpu_torch.runtime.dist import spawn_cpu
    from ddw_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(args.device))
    cfgs = {"lm": LMCfg(), "train": TrainCfg(warmup_epochs=0)}
    if args.quick:
        cfgs["lm"].hidden, cfgs["lm"].depth, cfgs["lm"].mlp_dim = 64, 2, 128
        cfgs["lm"].vocab_size, cfgs["lm"].max_len = 64, 512
        cfgs["lm"].dtype = "float32"
    apply_overrides(cfgs, args.overrides)
    lm_cfg, train_cfg = cfgs["lm"], cfgs["train"]
    n = args.procs
    sp = args.seq_devices or max(1, n // 2)
    if n % sp:
        raise SystemExit(f"seq devices {sp} must divide the {n} ranks")
    if args.moe:
        lm_cfg.num_experts = args.moe
    if args.pipeline:
        if n % args.pipeline:
            raise SystemExit(f"stages {args.pipeline} must divide the {n} "
                             f"ranks")
        _pipeline_fix(lm_cfg, train_cfg, args.pipeline)
        sp = 1
    out: dict = {}
    if args.trainer:
        if args.speculative or args.steps:
            raise SystemExit("--trainer runs epochs, not --steps, and skips "
                             "the generation demos — use train.epochs=N, and "
                             "run --speculative without --trainer")
        if args.pipeline:
            train_cfg.pipeline_stages = args.pipeline
            mb = train_cfg.pipeline_microbatches
            if mb < 1 or train_cfg.batch_size % mb:
                fixed = next(c for c in range(min(max(mb, 1),
                                                  train_cfg.batch_size), 0, -1)
                             if train_cfg.batch_size % c == 0)
                print(f"[pipeline] adjusting pipeline_microbatches {mb} -> "
                      f"{fixed} (must divide batch_size "
                      f"{train_cfg.batch_size})")
                train_cfg.pipeline_microbatches = fixed
        res = spawn_cpu(_trainer_rank, n, lm_cfg, train_cfg, sp, device, n,
                        timeout_s=1800)[0]
        for row in res["history"]:
            print({k: round(v, 4) if isinstance(v, float) else v
                   for k, v in row.items()})
        print(f"trainer: mesh {res['mesh']} epochs={res['epochs_run']} "
              f"val_loss={res['val_loss']:.4f} "
              f"val_accuracy={res['val_accuracy']:.3f}")
        return res
    steps = args.steps or (60 if args.quick else 300)
    ranks = spawn_cpu(_loop_rank, n, lm_cfg, train_cfg, sp, args.pipeline,
                      args.moe, steps, device, n, timeout_s=1800)
    res = ranks[0]
    print(f"mesh: {res['mesh']}  global_batch={res['batch']}  "
          f"seq_len={res['seq_len']}  rank-0 params={res['n_params']:,}")
    for line in res["log"]:
        print(line)
    tok_s = steps * res["batch"] * res["seq_len"] / res["seconds"]
    aux = f" aux={res['aux']:.3f}" if res["aux"] is not None else ""
    print(f"final: loss={res['loss']:.4f} acc={res['acc']:.3f} "
          f"tokens/sec={tok_s:,.0f} ({res['seconds']:.1f}s for {steps} "
          f"steps){aux}")
    # the trained weights into one process (a pipeline's blocks from every
    # stage), then the KV-cached greedy continuation
    params = {}
    for rk in ranks:
        params.update(rk["params"])
    model = build_lm(lm_cfg)
    load_flax_variables(model, {"params": params})
    model.to(device)
    cont = generate(model, res["prompt"], 16).cpu().numpy()
    match = float((cont[0] == res["stream"]).mean())
    print(f"generate: 16-token greedy continuation matches training stream "
          f"{match:.0%}")
    out.update(res, tokens_per_sec=tok_s, generate_match=match)
    if args.speculative:
        from ddw_tpu_torch.models.spec_decode import generate_speculative

        spec, stats = generate_speculative(model, model, res["prompt"], 16,
                                           k=4)
        assert (spec.cpu().numpy() == cont).all(), "spec decode diverged"
        print(f"speculative: identical 16 tokens in {stats['target_calls']} "
              f"target calls incl. prefill (acceptance "
              f"{stats['acceptance_rate']:.0%}, "
              f"{stats['tokens_per_target_call']:.1f} tok/call; plain greedy "
              f"= 1.0)")
        out["speculative"] = stats
    return out


if __name__ == "__main__":
    main()
