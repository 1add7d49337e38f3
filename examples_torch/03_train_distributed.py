"""Contract 3 — distributed data-parallel training (the port's mirror of
``examples/03_train_distributed.py``): LR x world with a 5-epoch warmup,
the gradient all-reduce in the step, shard-by-rank loading with infinite
repeat, floor-divided step accounting, rank-0 logging, and the
np=-1-then-distributed ladder: ``--smoke`` first runs the same code path in
one process.

    python examples_torch/03_train_distributed.py --quick          # 2 ranks
    python examples_torch/03_train_distributed.py --quick --smoke  # 1

Where ``ddw_tpu`` runs one SPMD program over a device mesh, the port runs
``--procs`` processes joined by a gloo group (``runtime.dist.spawn_cpu``),
each a data-parallel rank; on one card they share it.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch.common import (parse_args, rank_threads,  # noqa: E402
                                   require_tables, setup)


def _train_rank(cfgs, train_tbl, val_tbl, run_dir, run_id, device, procs):
    """One data-parallel rank: the trainer over this rank's shards."""
    from ddw_tpu_torch.tracking.tracker import Run
    from ddw_tpu_torch.train.trainer import Trainer

    rank_threads(procs)
    res = Trainer(cfgs["data"], cfgs["model"], cfgs["train"],
                  run=Run(run_dir, run_id), device=device).fit(train_tbl,
                                                               val_tbl)
    return {"history": res.history, "val_loss": res.val_loss,
            "val_accuracy": res.val_accuracy}


def main(argv=None):
    def extra(ap):
        ap.add_argument("--smoke", action="store_true",
                        help="np=-1 analog: the same path in one process")
        ap.add_argument("--procs", type=int, default=2,
                        help="data-parallel ranks (processes)")

    args = parse_args(__doc__, extra=extra, argv=argv)
    ws = setup(args)
    cfgs = ws["cfgs"]
    train_tbl, val_tbl = require_tables(ws["store"], cfgs["data"])
    world = 1 if args.smoke else args.procs
    print(f"ranks: {world} ({'smoke' if args.smoke else 'distributed'})")

    run = ws["tracker"].start_run("distributed_smoke" if args.smoke
                                  else "distributed")
    rank_args = (cfgs, train_tbl, val_tbl, run.run_dir, run.run_id,
                 ws["device"], world)
    if world == 1:
        res = _train_rank(*rank_args)
    else:
        from ddw_tpu_torch.runtime.dist import spawn_cpu

        res = spawn_cpu(_train_rank, world, *rank_args, timeout_s=3600)[0]
    run.end()
    for row in res["history"]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in row.items()})
    print(f"world={world} global_batch={cfgs['train'].batch_size * world} "
          f"val_loss={res['val_loss']:.4f} "
          f"val_accuracy={res['val_accuracy']:.4f} "
          f"images/sec={res['history'][-1]['images_per_sec']:.0f}")
    return {**res, "world": world, "run_id": run.run_id}


if __name__ == "__main__":
    main()
