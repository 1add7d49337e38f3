"""Contract 10 (beyond parity) — FSDP training + elastic world-size resume
(the port's mirror of ``examples/10_fsdp_elastic.py``).

The reference's failure story is "Spark barrier restarts the whole gang on
the same worker count"; this goes further: train with ZeRO-3/FSDP
fully-sharded state (``train.fsdp=true`` — every rank holds about 1/N of
the parameters and moments), checkpoint per-rank shards (no process ever
gathers the full state), then RESUME ON A DIFFERENT RANK COUNT — the
sharded restore assembles each new shard from the overlapping saved ones.

    python examples_torch/10_fsdp_elastic.py --quick --device cpu

Phase 1 fits on ``--procs`` ranks (a rank is one process on one device,
started by :class:`ddw_tpu_torch.runtime.Launcher`, joined by gloo; on one
card they share it); phase 2 resumes the same run on half as many ranks and
finishes training. On a cluster this is losing (or gaining) half the
devices between jobs.
"""

import dataclasses
import os
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

from examples_torch.common import (parse_args, rank_threads,  # noqa: E402
                                   require_tables, setup)


def fsdp_rank(cfgs, train_tbl, val_tbl, run_dir, run_id, device,
              resume: bool) -> dict:
    """One rank of the FSDP fit: its share of the batch and of the state."""
    from ddw_tpu_torch.parallel.zero import fsdp_fraction_sharded
    from ddw_tpu_torch.runtime.dist import group_topology
    from ddw_tpu_torch.tracking.tracker import Run
    from ddw_tpu_torch.train.trainer import Trainer

    world = group_topology()[1]
    rank_threads(world)
    res = Trainer(cfgs["data"], cfgs["model"], cfgs["train"],
                  run=Run(run_dir, run_id), device=device).fit(
                      train_tbl, val_tbl, resume=resume)
    state = res.state
    return {"history": res.history, "val_loss": res.val_loss,
            "val_accuracy": res.val_accuracy, "step": int(state.step),
            "world": world,
            "fraction_sharded": fsdp_fraction_sharded(state,
                                                      state.layout.mesh)}


def main(argv=None):
    def extra(ap):
        ap.add_argument("--procs", type=int, default=2,
                        help="ranks of phase 1 (phase 2 runs on half)")

    args = parse_args(__doc__, extra=extra, argv=argv)
    ws = setup(args)
    cfgs = ws["cfgs"]
    train_tbl, val_tbl = require_tables(ws["store"], cfgs["data"])
    if args.procs < 2:
        raise SystemExit("--procs must be >= 2 for the elastic phase")

    from ddw_tpu_torch.runtime import Launcher

    # the ranks import the package from this checkout
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(REPO)] + ([os.environ["PYTHONPATH"]]
                                   if os.environ.get("PYTHONPATH") else []))
    ckpt_dir = os.path.join(ws["workdir"], "fsdp_ckpt")
    tcfg = dataclasses.replace(
        cfgs["train"], fsdp=True, checkpoint_dir=ckpt_dir,
        checkpoint_every_epochs=1, async_checkpoint=False)
    run = ws["tracker"].start_run("fsdp_elastic")

    # -- phase 1: all the ranks -------------------------------------------
    half_epochs = max(1, tcfg.epochs // 2)
    cfgs1 = {**cfgs, "train": dataclasses.replace(tcfg, epochs=half_epochs)}
    print(f"phase 1: {args.procs} ranks fsdp=true epochs={half_epochs}")
    res1 = Launcher(np=args.procs, timeout_s=3600).run(
        fsdp_rank, cfgs1, train_tbl, val_tbl, run.run_dir, run.run_id,
        ws["device"], False)
    print(f"phase 1 done: val_acc={res1['val_accuracy']:.4f} "
          f"params sharded={res1['fraction_sharded']:.0%} over "
          f"{res1['world']} ranks")

    # -- phase 2: resume on HALF the ranks --------------------------------
    half = args.procs // 2
    cfgs2 = {**cfgs, "train": tcfg}
    print(f"phase 2: resume on {half} rank(s) (elastic {args.procs} -> "
          f"{half})")
    res2 = Launcher(np=half, timeout_s=3600).run(
        fsdp_rank, cfgs2, train_tbl, val_tbl, run.run_dir, run.run_id,
        ws["device"], True)
    run.end()
    print(f"phase 2 done: val_loss={res2['val_loss']:.4f} "
          f"val_accuracy={res2['val_accuracy']:.4f} "
          f"world={res2['world']} "
          f"base_step_continued={res2['step'] > res1['step']} "
          f"(step {res1['step']} -> {res2['step']})")
    return {"phase1": res1, "phase2": res2}


if __name__ == "__main__":
    main()
