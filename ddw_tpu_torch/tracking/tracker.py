"""File-based experiment tracker — the MLflow tracking role (the port's copy
of ``ddw_tpu.tracking.tracker``; same on-disk layout, so both packages read
each other's runs).

The reference leans on MLflow throughout (SURVEY.md §5 "Metrics / logging"):
``mlflow.start_run`` / autolog (``02_model_training_single_node.py:195``), explicit
param/metric logging from rank 0 into a run the coordinator created
(``03_model_training_distributed.py:361-373``), nested parent/child runs for HPO
(``02_hyperopt_distributed_model.py:240-260``), run search ordered by metric
(``01_hyperopt_single_machine_model.py:253-262``), and artifact logging.

In-tree equivalent: an experiment is a directory of run directories; a run holds
``meta.json`` (id, name, parent, tags, status), ``params.json``, ``metrics.jsonl``
(append-only (key, value, step, ts) lines — full per-epoch series, the autolog
role), and an ``artifacts/`` dir. Nested runs record ``parent_run_id`` — the
``MLFLOW_PARENT_RUN_ID`` plumbing (reference ``02_hyperopt_distributed_model.py:
244-247``) becomes just passing a run id. Worker-side logging needs no host/token
plumbing (reference ``00_setup.py:15-17``): rank-0-only writes to a shared
filesystem, with metrics already world-averaged by the step (MetricAverage role).

:func:`Tracker.search_runs` reproduces the best-run query
(``search_runs(parentRunId tag, order by metrics.accuracy DESC)``,
reference ``01_hyperopt_single_machine_model.py:253-262``).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Iterator


def _is_writer() -> bool:
    from ddw_tpu_torch.runtime.dist import process_topology

    return process_topology()[0] == 0


class Run:
    """Handle to one run directory. Writes are rank-0-only no-ops elsewhere."""

    def __init__(self, run_dir: str, run_id: str, writable: bool = True):
        self.run_dir = run_dir
        self.run_id = run_id
        self._writable = writable and _is_writer()

    # -- logging ---------------------------------------------------------------
    def log_params(self, params: dict[str, Any]) -> None:
        if not self._writable:
            return
        path = os.path.join(self.run_dir, "params.json")
        cur = {}
        if os.path.exists(path):
            with open(path) as f:
                cur = json.load(f)
        cur.update({k: v for k, v in params.items()})
        with open(path, "w") as f:
            json.dump(cur, f, indent=2, default=str)

    def log_param(self, key: str, value: Any) -> None:
        self.log_params({key: value})

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        if not self._writable:
            return
        with open(os.path.join(self.run_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"key": key, "value": float(value), "step": step,
                                "ts": time.time()}) + "\n")

    def log_metrics(self, metrics: dict[str, float], step: int = 0) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def log_artifact(self, local_path: str, name: str | None = None) -> str:
        dst = os.path.join(self.run_dir, "artifacts", name or os.path.basename(local_path))
        if self._writable:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if os.path.isdir(local_path):
                if os.path.exists(dst):
                    shutil.rmtree(dst)
                shutil.copytree(local_path, dst)
            else:
                shutil.copy2(local_path, dst)
        return dst

    def artifact_dir(self, name: str = "") -> str:
        d = os.path.join(self.run_dir, "artifacts", name)
        if self._writable:
            os.makedirs(d, exist_ok=True)
        return d

    def set_tags(self, tags: dict[str, str]) -> None:
        if not self._writable:
            return
        meta = self.meta()
        meta.setdefault("tags", {}).update(tags)
        with open(os.path.join(self.run_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)

    def end(self, status: str = "FINISHED") -> None:
        if not self._writable:
            return
        meta = self.meta()
        meta["status"] = status
        meta["end_unix"] = time.time()
        with open(os.path.join(self.run_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)

    # -- reading ---------------------------------------------------------------
    def meta(self) -> dict:
        with open(os.path.join(self.run_dir, "meta.json")) as f:
            return json.load(f)

    def params(self) -> dict:
        path = os.path.join(self.run_dir, "params.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def metric_history(self, key: str) -> list[tuple[int, float]]:
        out = []
        path = os.path.join(self.run_dir, "metrics.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec["key"] == key:
                        out.append((rec["step"], rec["value"]))
        return out

    def final_metrics(self) -> dict[str, float]:
        """Last logged value per key (the per-run summary MLflow shows)."""
        out: dict[str, float] = {}
        path = os.path.join(self.run_dir, "metrics.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    out[rec["key"]] = rec["value"]
        return out

    def metric_series(self) -> dict[str, list[tuple[int, float]]]:
        """Every logged series in ONE pass over metrics.jsonl
        (``{key: [(step, value), ...]}``). Bulk consumers (the HTML report)
        use this instead of per-key :meth:`metric_history` calls, which would
        re-parse the file once per key."""
        out: dict[str, list[tuple[int, float]]] = {}
        path = os.path.join(self.run_dir, "metrics.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    out.setdefault(rec["key"], []).append((rec["step"], rec["value"]))
        return out

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end("FAILED" if exc_type else "FINISHED")


class Tracker:
    """Experiment store rooted at a directory (``mlflow.set_experiment`` analog)."""

    def __init__(self, root: str, experiment: str = "default"):
        self.root = root
        self.experiment = experiment
        self.exp_dir = os.path.join(root, experiment)
        if _is_writer():
            os.makedirs(self.exp_dir, exist_ok=True)

    def start_run(
        self,
        name: str = "",
        parent_run_id: str | None = None,
        tags: dict[str, str] | None = None,
        run_id: str | None = None,
    ) -> Run:
        """Create a run. Multi-host jobs MUST share one run id: the coordinator
        creates the run and the id reaches other processes either explicitly
        (pass ``run_id=``) or via the ``DDW_RUN_ID`` env var — the analog of the
        reference's MLFLOW_PARENT_RUN_ID / host-token plumbing to workers
        (``00_setup.py:15-17``, ``02_hyperopt_distributed_model.py:244-247``).
        A fresh uuid per process would point non-coordinator Run handles at
        directories that don't exist."""
        if run_id is None:
            run_id = os.environ.get("DDW_RUN_ID") or uuid.uuid4().hex[:16]
        run_dir = os.path.join(self.exp_dir, run_id)
        if _is_writer():
            os.makedirs(run_dir, exist_ok=True)
            meta = {
                "run_id": run_id,
                "name": name,
                "parent_run_id": parent_run_id,
                "tags": tags or {},
                "status": "RUNNING",
                "start_unix": time.time(),
            }
            with open(os.path.join(run_dir, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2)
        return Run(run_dir, run_id)

    def get_run(self, run_id: str) -> Run:
        return Run(os.path.join(self.exp_dir, run_id), run_id)

    def iter_runs(self) -> Iterator[Run]:
        if not os.path.isdir(self.exp_dir):
            return
        for d in sorted(os.listdir(self.exp_dir)):
            if os.path.exists(os.path.join(self.exp_dir, d, "meta.json")):
                yield Run(os.path.join(self.exp_dir, d), d)

    def search_runs(
        self,
        parent_run_id: str | None = None,
        order_by_metric: str | None = None,
        ascending: bool = False,
    ) -> list[Run]:
        """Filter by parent and order by a metric's final value (the best-child
        query, reference ``01_hyperopt_single_machine_model.py:253-262``)."""
        runs = [
            r for r in self.iter_runs()
            if parent_run_id is None or r.meta().get("parent_run_id") == parent_run_id
        ]
        if order_by_metric is not None:
            def keyfn(r: Run):
                v = r.final_metrics().get(order_by_metric)
                return (v is None, v if ascending else -(v if v is not None else 0.0))
            runs.sort(key=keyfn)
        return runs
