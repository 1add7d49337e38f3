"""Tracker/registry CLI — the text-mode ``mlflow ui`` role.

The reference inspects experiments through the MLflow UI and
``mlflow.search_runs`` (``01_hyperopt_single_machine_model.py:253-262``);
in-tree equivalent:

    python -m ddw_tpu_torch.tracking <runs_root> experiments
    python -m ddw_tpu_torch.tracking <runs_root> runs [-e EXP] [--sort METRIC]
    python -m ddw_tpu_torch.tracking <runs_root> show RUN_ID [-e EXP]
    python -m ddw_tpu_torch.tracking <runs_root> series RUN_ID KEY [-e EXP]
    python -m ddw_tpu_torch.tracking <runs_root> report [-e EXP] [-o OUT.html]
    python -m ddw_tpu_torch.tracking <registry_root> models
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _fmt_ts(unix) -> str:
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(float(unix)))
    except (TypeError, ValueError):
        return "-"


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def cmd_experiments(args) -> None:
    root = args.root
    if not os.path.isdir(root):
        raise SystemExit(f"no tracker root at {root}")
    for exp in sorted(os.listdir(root)):
        exp_dir = os.path.join(root, exp)
        if not os.path.isdir(exp_dir):
            continue
        n = sum(1 for d in os.listdir(exp_dir)
                if os.path.exists(os.path.join(exp_dir, d, "meta.json")))
        print(f"{exp}  ({n} runs)")


def _exp_dir(args) -> str:
    """Validated experiment dir — the CLI is read-only and must neither create
    directories (a typoed -e would otherwise materialize an empty experiment)
    nor traceback on missing ones."""
    exp_dir = os.path.join(args.root, args.experiment)
    if not os.path.isdir(exp_dir):
        raise SystemExit(f"no experiment {args.experiment!r} under {args.root} "
                         f"(try the 'experiments' subcommand)")
    return exp_dir


def _get_run(args):
    from ddw_tpu_torch.tracking.tracker import Run

    run_dir = os.path.join(_exp_dir(args), args.run_id)
    if not os.path.exists(os.path.join(run_dir, "meta.json")):
        raise SystemExit(f"no run {args.run_id!r} in experiment "
                         f"{args.experiment!r} under {args.root}")
    return Run(run_dir, args.run_id, writable=False)


def cmd_runs(args) -> None:
    from ddw_tpu_torch.tracking.tracker import Run

    exp_dir = _exp_dir(args)
    rows = []
    for d in sorted(os.listdir(exp_dir)):
        if not os.path.exists(os.path.join(exp_dir, d, "meta.json")):
            continue
        run = Run(os.path.join(exp_dir, d), d, writable=False)
        meta = run.meta()
        finals = run.final_metrics()
        rows.append((meta.get("start_unix", 0), run.run_id,
                     meta.get("name", ""), meta.get("status", "?"),
                     meta.get("parent_run_id") or "", finals))
    if args.sort:
        rows.sort(key=lambda r: r[5].get(args.sort, float("-inf")), reverse=True)
    else:
        rows.sort()
    for start, rid, name, status, parent, finals in rows:
        shown = {k: _fmt_val(v) for k, v in sorted(finals.items())
                 if not k.startswith("sys.")}
        nested = f" (child of {parent})" if parent else ""
        print(f"{rid}  {_fmt_ts(start)}  {status:<9} {name}{nested}")
        if shown:
            print("    " + "  ".join(f"{k}={v}" for k, v in shown.items()))


def cmd_show(args) -> None:
    run = _get_run(args)
    art_dir = os.path.join(run.run_dir, "artifacts")  # path only: no mkdir
    print(json.dumps({
        "meta": run.meta(),
        "params": run.params(),
        "final_metrics": run.final_metrics(),
        "artifacts": sorted(os.listdir(art_dir)) if os.path.isdir(art_dir) else [],
    }, indent=2, default=str))


def cmd_series(args) -> None:
    for step, value in _get_run(args).metric_history(args.key):
        print(f"{step}\t{_fmt_val(value)}")


def cmd_report(args) -> None:
    from ddw_tpu_torch.tracking.report import write_report

    _exp_dir(args)  # validate before writing anything
    out = write_report(args.root, args.experiment, args.out or None,
                       include_sys=not args.no_sys)
    print(out)


def cmd_models(args) -> None:
    from ddw_tpu_torch.tracking.registry import ModelRegistry

    reg = ModelRegistry(args.root)
    for name in reg.list_models():
        print(name)
        for v in reg.list_versions(name):
            print(f"    v{v.get('version')}  stage={v.get('stage', 'None'):<10} "
                  f"run={v.get('source_run_id') or '-'}  "
                  f"{_fmt_ts(v.get('created_unix'))}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m ddw_tpu_torch.tracking",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("root", help="tracker root dir (or registry root for 'models')")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("experiments")
    p_runs = sub.add_parser("runs")
    p_runs.add_argument("-e", "--experiment", default="default")
    p_runs.add_argument("--sort", default="", help="final metric to sort by, desc")
    p_show = sub.add_parser("show")
    p_show.add_argument("run_id")
    p_show.add_argument("-e", "--experiment", default="default")
    p_series = sub.add_parser("series")
    p_series.add_argument("run_id")
    p_series.add_argument("key")
    p_series.add_argument("-e", "--experiment", default="default")
    p_report = sub.add_parser("report")
    p_report.add_argument("-e", "--experiment", default="default")
    p_report.add_argument("-o", "--out", default="",
                          help="output path (default <root>/<exp>_report.html)")
    p_report.add_argument("--no-sys", action="store_true",
                          help="omit the sys.* utilization section")
    sub.add_parser("models")

    args = ap.parse_args(argv)
    {"experiments": cmd_experiments, "runs": cmd_runs, "show": cmd_show,
     "series": cmd_series, "report": cmd_report, "models": cmd_models}[args.cmd](args)


if __name__ == "__main__":
    main()
