"""Contract 4b — sequential TPE where each trial is a whole-group
distributed job (the port's mirror of ``examples/05_hyperopt_distributed.py``):
hyperparameters as train-function arguments, the space lr x dropout x
batch_size {32, 64, 128}, sequential trials because each trial owns every
rank, per-trial rank-0 checkpoints under a shared root, nested child runs
under one parent.

    python examples_torch/05_hyperopt_distributed.py --quick tune.max_evals=4

Each trial spawns ``--procs`` processes joined by a gloo group
(``runtime.dist.spawn_cpu``), data-parallel ranks that share the card.
With ``tune.prune=true`` rank 0 carries each epoch's validation loss to this
process's pruner through a ``TrialLink`` and broadcasts the verdict, so
every rank of a pruned trial stops at the same epoch boundary; the trial
records ``STATUS_PRUNED`` and its run ends ``PRUNED``.
"""

import contextlib
import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ddw_tpu_torch.tune import (STATUS_OK, TrialLink, Trials,  # noqa: E402
                                choice, fmin, loguniform, make_pruner,
                                uniform)
from examples_torch.common import (parse_args, rank_threads,  # noqa: E402
                                   require_tables, setup)


def _trial_rank(data_cfg, model_cfg, train_cfg, train_tbl, val_tbl, run_dir,
                run_id, device, procs, reporter=None):
    """One rank of one trial: the data-parallel trainer (reporting each
    epoch to the coordinator's pruner through ``reporter`` when pruning is
    on), and this rank's depthwise kernel launches by variant (the process
    is new, so they are the trial's)."""
    from ddw_tpu_torch.ops.depthwise_conv import (
        depthwise_conv3x3_cuda, depthwise_conv3x3_wgrad_cuda)
    from ddw_tpu_torch.tracking.tracker import Run
    from ddw_tpu_torch.train.trainer import Trainer

    rank_threads(procs)
    res = Trainer(data_cfg, model_cfg, train_cfg, run=Run(run_dir, run_id),
                  device=device,
                  on_epoch=None if reporter is None else reporter.on_epoch
                  ).fit(train_tbl, val_tbl)
    return {"val_accuracy": res.val_accuracy, "val_loss": res.val_loss,
            "history": res.history, "epochs_run": res.epochs_run,
            "kernel_launches": {
                "k1": dict(depthwise_conv3x3_cuda.launches_by_variant),
                "k2": dict(depthwise_conv3x3_wgrad_cuda.launches_by_variant)}}


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: ap.add_argument(
        "--procs", type=int, default=2,
        help="data-parallel ranks (processes) of every trial"), argv=argv)
    ws = setup(args)
    cfgs = ws["cfgs"]
    tune_cfg = cfgs["tune"]
    train_tbl, val_tbl = require_tables(ws["store"], cfgs["data"])

    space = {
        "learning_rate": loguniform("learning_rate", -5, 0),
        "dropout": uniform("dropout", 0.1, 0.9),
        "batch_size": choice("batch_size", [32, 64, 128] if not args.quick
                             else [4, 8, 16]),
    }

    ckpt_root = os.path.join(ws["workdir"], "tune_ckpts")
    parent = ws["tracker"].start_run("hyperopt_distributed")
    trial_no = {"n": 0}
    # pruning pays off most here: every pruned epoch frees every rank
    pruner = make_pruner(tune_cfg)

    def train_and_evaluate(params, trial=None):
        """Whole-group data-parallel training of one trial."""
        from ddw_tpu_torch.runtime.dist import spawn_cpu

        trial_no["n"] += 1
        model_cfg = copy.deepcopy(cfgs["model"])
        train_cfg = copy.deepcopy(cfgs["train"])
        model_cfg.dropout = float(params["dropout"])
        train_cfg.learning_rate = float(params["learning_rate"])
        train_cfg.batch_size = int(params["batch_size"])
        train_cfg.checkpoint_dir = os.path.join(ckpt_root,
                                                f"trial_{trial_no['n']:03d}")
        run = ws["tracker"].start_run(f"trial_{trial_no['n']:03d}",
                                      parent_run_id=parent.run_id)
        run.log_params(params)
        link = TrialLink(trial) if trial is not None else None
        try:
            with link or contextlib.nullcontext():
                ranks = spawn_cpu(_trial_rank, args.procs, cfgs["data"],
                                  model_cfg, train_cfg, train_tbl, val_tbl,
                                  run.run_dir, run.run_id, ws["device"],
                                  args.procs,
                                  link and link.ranks_side(),
                                  timeout_s=3600)
        except Exception:
            run.end(status="FAILED")
            raise  # fmin records STATUS_FAIL
        if link is not None and link.pruned is not None:
            epochs = sorted({r["epochs_run"] for r in ranks})
            print(f"trial {trial_no['n']:03d} pruned: every rank stopped "
                  f"after epoch(s) {epochs}")
            run.end(status="PRUNED")
            link.raise_if_pruned()  # fmin records STATUS_PRUNED
        res = ranks[0]
        run.log_metric("final_val_accuracy", res["val_accuracy"])
        run.end()
        return {"loss": -res["val_accuracy"], "status": STATUS_OK,
                "val_accuracy": res["val_accuracy"],
                "kernel_launches": [r["kernel_launches"] for r in ranks]}

    trials = Trials()
    best = fmin(train_and_evaluate, space, max_evals=tune_cfg.max_evals,
                algo=tune_cfg.algo, parallelism=1,  # trials own every rank
                trials=trials, seed=tune_cfg.seed,
                n_startup_trials=min(tune_cfg.n_startup_trials,
                                     tune_cfg.max_evals // 2 or 1),
                pruner=pruner)
    parent.log_params({f"best.{k}": v for k, v in best.items()})
    parent.end()
    print(f"best params: {best}")
    for t in trials.results:
        print(f"trial status={t['status']} loss={t['loss']}"
              + (f" error={t['error']}" if "error" in t else ""))
    if any(t["status"] == STATUS_OK for t in trials.results):
        print(f"best val_accuracy: {trials.best['val_accuracy']:.4f}")
    print(f"per-trial checkpoints under {ckpt_root}")

    from ddw_tpu_torch.tracking.report import write_report

    report = write_report(ws["tracker"].root, ws["tracker"].experiment)
    print(f"report: {report}")
    return {"best": best, "trials": trials, "report": report,
            "ckpt_root": ckpt_root}


if __name__ == "__main__":
    main()
