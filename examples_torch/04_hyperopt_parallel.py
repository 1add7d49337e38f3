"""Contract 4a — parallel hyperparameter tuning over single-node trials (the
port's mirror of ``examples/04_hyperopt_parallel.py``): TPE over
{optimizer, log-uniform LR, uniform dropout}, ``tune.parallelism`` trials in
flight (the SparkTrials(parallelism=4) role), each trial a child run under
one parent; the best child found by a metric query, registered and moved to
Production; an HTML report of the search.

    python examples_torch/04_hyperopt_parallel.py --quick tune.max_evals=6

Where ``ddw_tpu`` gives each concurrent trial a device of its own, here
concurrent trials are threads that share the card, each launching on a CUDA
stream of its own (on the CPU, plain threads). ``fmin`` records a trial that
raises as ``STATUS_FAIL`` and goes on; the returned trials carry each error.
"""

import contextlib
import copy
import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from ddw_tpu_torch.models.convert import to_flax_variables  # noqa: E402
from ddw_tpu_torch.serving.package import save_packaged_model  # noqa: E402
from ddw_tpu_torch.train.trainer import Trainer  # noqa: E402
from ddw_tpu_torch.tune import (STATUS_OK, Trials, choice,  # noqa: E402
                                choice_of, fmin, loguniform, uniform)
from ddw_tpu_torch.utils.device import resolve_device  # noqa: E402
from examples_torch.common import (parse_args, require_tables,  # noqa: E402
                                   setup)


def _extra_flags(ap):
    ap.add_argument(
        "--cache-features", action="store_true",
        help="frozen-transfer HPO fast path: featurise once, then every "
             "trial trains only the head from the shared cache (every "
             "searched hyperparameter sits above the pooled features)")
    ap.add_argument(
        "--nested-space", action="store_true",
        help="conditional search space: each optimizer carries its own "
             "learning-rate range")


def main(argv=None):
    args = parse_args(__doc__, extra=_extra_flags, argv=argv)
    ws = setup(args)
    cfgs = ws["cfgs"]
    tune_cfg = cfgs["tune"]
    device = resolve_device(ws["device"])
    train_tbl, val_tbl = require_tables(ws["store"], cfgs["data"])

    feat_ctx = None
    if args.cache_features:
        from ddw_tpu_torch.train.transfer import prepare_feature_tables
        from examples_torch.common import ensure_frozen_backbone_cfg

        ensure_frozen_backbone_cfg(cfgs["model"])
        feat_train, feat_val, _, full_state = prepare_feature_tables(
            cfgs["data"], cfgs["model"], cfgs["train"], train_tbl, val_tbl,
            ws["store"], device=device)
        feat_ctx = (feat_train, feat_val, full_state)
        print(f"[features] cached {feat_train.num_records}+"
              f"{feat_val.num_records} records "
              f"(dim {feat_train.meta['feature_dim']}) — trials train heads "
              f"only")

    if args.nested_space:
        space = {
            "optimizer": choice_of("optimizer", {
                "adam": {"adam_lr": loguniform("adam_lr", -9, -2)},
                "adadelta": {"adadelta_lr": loguniform("adadelta_lr", -4, 1)},
            }),
            "dropout": uniform("dropout", 0.1, 0.9),
        }
    else:
        space = {
            "optimizer": choice("optimizer", ["adadelta", "adam"]),
            "learning_rate": loguniform("learning_rate", -5, 0),
            "dropout": uniform("dropout", 0.1, 0.9),
        }

    # Trial slots: one CUDA stream each on the card, none on the CPU.
    parallelism = max(1, tune_cfg.parallelism)
    slot_lock = threading.Lock()
    free_slots = [torch.cuda.Stream(device) if device.type == "cuda"
                  else None for _ in range(parallelism)]

    parent = ws["tracker"].start_run("hyperopt_parallel")

    from ddw_tpu_torch.tune import make_pruner

    pruner = make_pruner(tune_cfg)

    def objective(params, trial=None):
        with slot_lock:
            stream = free_slots.pop()
        try:
            model_cfg = copy.deepcopy(cfgs["model"])
            train_cfg = copy.deepcopy(cfgs["train"])
            model_cfg.dropout = float(params["dropout"])
            train_cfg.optimizer = params["optimizer"]
            lr = params.get("learning_rate",
                            params.get("adam_lr", params.get("adadelta_lr")))
            train_cfg.learning_rate = float(lr)
            train_cfg.scale_lr_by_world = False
            train_cfg.checkpoint_dir = ""
            run = ws["tracker"].start_run("trial",
                                          parent_run_id=parent.run_id)
            run.log_params(params)
            on_epoch = (None if trial is None else
                        lambda row: trial.report(row["epoch"],
                                                 row["val_loss"]))
            on_stream = (torch.cuda.stream(stream) if stream is not None
                         else contextlib.nullcontext())
            try:
                with on_stream:
                    if feat_ctx is not None:
                        from ddw_tpu_torch.train.transfer import (
                            make_head_trainer, merge_head_params)

                        f_train, f_val, full_state = feat_ctx
                        trainer = make_head_trainer(
                            cfgs["data"], model_cfg, train_cfg, full_state,
                            run=run, on_epoch=on_epoch, device=device)
                        res = trainer.fit(f_train, f_val)
                        res.state = merge_head_params(full_state, res.state)
                    else:
                        trainer = Trainer(cfgs["data"], model_cfg, train_cfg,
                                          run=run, on_epoch=on_epoch,
                                          device=device)
                        res = trainer.fit(train_tbl, val_tbl)
                    if stream is not None:
                        stream.synchronize()  # weights final for any stream
            except Exception as e:
                from ddw_tpu_torch.tune import Pruned

                run.end(status="PRUNED" if isinstance(e, Pruned)
                        else "FAILED")
                raise  # fmin records STATUS_PRUNED / STATUS_FAIL
            run.log_metric("final_val_accuracy", res.val_accuracy)
            run.end()
            # the reference minimises -accuracy
            return {"loss": -res.val_accuracy, "status": STATUS_OK,
                    "val_accuracy": res.val_accuracy, "run_id": run.run_id,
                    "state": res.state, "model_cfg": model_cfg}
        finally:
            with slot_lock:
                free_slots.append(stream)

    trials = Trials()
    best = fmin(objective, space, max_evals=tune_cfg.max_evals,
                algo=tune_cfg.algo, parallelism=parallelism, trials=trials,
                seed=tune_cfg.seed, n_startup_trials=tune_cfg.n_startup_trials,
                gamma=tune_cfg.gamma, pruner=pruner)
    parent.log_params({f"best.{k}": v for k, v in best.items()})
    parent.end()
    print(f"best params: {best}")
    for t in trials.results:
        print(f"trial status={t['status']} loss={t['loss']}"
              + (f" error={t['error']}" if "error" in t else ""))

    children = ws["tracker"].search_runs(parent_run_id=parent.run_id,
                                         order_by_metric="final_val_accuracy")
    best_run = children[0]
    print(f"best child run {best_run.run_id}: "
          f"{best_run.final_metrics()['final_val_accuracy']:.4f}")

    # registry flow: package the best trial, register, move to Production
    best_trial = trials.best
    label_to_idx = train_tbl.meta["label_to_idx"]
    classes = [c for c, _ in sorted(label_to_idx.items(),
                                    key=lambda kv: kv[1])]
    pkg_dir = os.path.join(ws["workdir"], "best_model_pkg")
    v = to_flax_variables(best_trial["state"].model)
    save_packaged_model(pkg_dir, best_trial["model_cfg"], classes,
                        v["params"], v.get("batch_stats"),
                        img_height=cfgs["data"].img_height,
                        img_width=cfgs["data"].img_width)
    version = ws["registry"].register(
        "flowers_classifier", pkg_dir, run_id=best_trial["run_id"],
        metrics={"val_accuracy": best_trial["val_accuracy"]})
    ws["registry"].transition("flowers_classifier", version, "Production")
    print(f"registered flowers_classifier v{version} -> Production")

    from ddw_tpu_torch.tracking.report import write_report

    report = write_report(ws["tracker"].root, ws["tracker"].experiment)
    print(f"report: {report}")
    return {"best": best, "trials": trials, "version": version,
            "pkg_dir": pkg_dir, "report": report,
            "parent_run_id": parent.run_id, "features": feat_ctx}


if __name__ == "__main__":
    main()
