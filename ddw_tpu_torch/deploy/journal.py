"""RolloutJournal — the durable, crash-safe record of one weight rollout.

The :class:`~ddw_tpu_torch.deploy.DeployController` mutates the fleet one replica
at a time; a gateway death between two replica steps strands a MIXED-digest
fleet that keeps serving two different models until an operator notices.
This journal makes the rollout itself durable with exactly the discipline
:class:`~ddw_tpu_torch.serve.lanes.JobLedger` uses for bulk jobs::

    <journal_dir>/meta.json     the rollout plan + terminal state
                                (atomic tmp-write + fsync + os.replace)
    <journal_dir>/steps.jsonl   one row per completed replica step,
                                appended + flushed + fsync'd as it lands

``meta.json`` is written ONCE at :meth:`begin` with status ``rolling`` and
rewritten ONLY at :meth:`finish` with the terminal status — so a journal
whose meta still says ``rolling`` is, by construction, a rollout some dead
gateway never finished. ``steps.jsonl`` is the per-replica progress made
durable: a restarted gateway's reconciler re-rolls exactly the replicas
whose step row never landed. A kill -9 between the append and the next step
costs at most the re-run of one replica step (idempotent: re-staging and
recycling a replica already on the target digest converges to the same
fleet), and a TORN final row — half a JSON line, the classic
power-cut artifact — is skipped on load, which re-runs that step.

The journal holds one rollout at a time: :meth:`begin` truncates whatever
terminal record the previous rollout left (history belongs to tracing and
``/stats``, not the recovery path).

The port of ``ddw_tpu.deploy.journal``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import json
import os
import threading

__all__ = ["RolloutJournal"]

# meta.json statuses that mean "nothing to recover"
TERMINAL = ("done", "rolled_back", "aborted", "rejected")


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class RolloutJournal:
    """Fsync'd per-step rollout record under one directory. All writes are
    best-effort against OSError EXCEPT :meth:`begin` — a rollout that cannot
    journal its plan must not pretend to be durable, so begin raises."""

    def __init__(self, journal_dir: str):
        self.dir = journal_dir
        self.meta_path = os.path.join(journal_dir, "meta.json")
        self.rows_path = os.path.join(journal_dir, "steps.jsonl")
        self._meta: dict | None = None
        self._rows_f = None
        self._io_lock = threading.Lock()

    # -- writer side (the controller) ----------------------------------------
    def begin(self, meta: dict) -> None:
        """Journal the rollout plan with status ``rolling`` and truncate the
        previous rollout's step rows. ``meta`` must carry everything a
        reconciler needs to converge the fleet with NO in-memory state:
        strategy, target_dir, draft staging, per-replica old dirs."""
        os.makedirs(self.dir, exist_ok=True)
        self._meta = dict(meta)
        self._meta["status"] = "rolling"
        _write_json_atomic(self.meta_path, self._meta)
        with self._io_lock:
            if self._rows_f is not None:
                self._rows_f.close()
            self._rows_f = open(self.rows_path, "w")

    def resume_appending(self) -> None:
        """Re-open the step log for appending WITHOUT touching meta — the
        reconciler's mode: the interrupted rollout's rows stay, resumed
        steps land after them."""
        os.makedirs(self.dir, exist_ok=True)
        try:
            with open(self.meta_path) as f:
                self._meta = json.load(f)
        except (OSError, ValueError):
            self._meta = {"status": "rolling"}
        with self._io_lock:
            if self._rows_f is not None:
                self._rows_f.close()
            self._rows_f = open(self.rows_path, "a")
            try:
                # A torn final row (crash mid-append) has no trailing
                # newline; appending straight after it would weld the
                # resumed step onto the torn fragment and corrupt BOTH.
                # Terminate the fragment so it stays a lone skippable line.
                if self._rows_f.tell() > 0:
                    with open(self.rows_path, "rb") as rf:
                        rf.seek(-1, os.SEEK_END)
                        torn = rf.read(1) != b"\n"
                    if torn:
                        self._rows_f.write("\n")
                        self._rows_f.flush()
            except OSError:
                pass

    def record_step(self, row: dict) -> None:
        """Append one completed replica step, durable before returning."""
        with self._io_lock:
            if self._rows_f is None:
                return
            try:
                self._rows_f.write(json.dumps(row) + "\n")
                self._rows_f.flush()
                os.fsync(self._rows_f.fileno())
            except (OSError, TypeError):
                pass    # a read-only disk degrades durability, not the roll

    def note(self, **kw) -> None:
        """Merge keys into meta (status unchanged) — e.g. the target digest
        once the first replica settles, so a resume can recognize replicas
        already converged."""
        if self._meta is None:
            return
        self._meta.update(kw)
        try:
            _write_json_atomic(self.meta_path, self._meta)
        except OSError:
            pass

    def finish(self, status: str) -> None:
        """Rewrite meta with a terminal status and close the step log. A
        crash BEFORE this call is exactly what the reconciler detects."""
        if self._meta is not None:
            self._meta["status"] = status
            try:
                _write_json_atomic(self.meta_path, self._meta)
            except OSError:
                pass
        with self._io_lock:
            if self._rows_f is not None:
                try:
                    self._rows_f.close()
                except OSError:
                    pass
                self._rows_f = None

    # -- reader side (the reconciler) ----------------------------------------
    @classmethod
    def load(cls, journal_dir: str) -> dict | None:
        """The unfinished rollout a previous gateway life left behind, or
        None (no journal / terminal status / unreadable meta). Returns
        ``{"meta": {...}, "steps": [...]}`` with any torn final row skipped
        — the reconciler re-runs that replica's step."""
        meta_path = os.path.join(journal_dir, "meta.json")
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        if meta.get("status") in TERMINAL:
            return None
        steps: list[dict] = []
        try:
            with open(os.path.join(journal_dir, "steps.jsonl")) as f:
                for line in f:
                    try:
                        row = json.loads(line)
                        if isinstance(row, dict):
                            steps.append(row)
                    except ValueError:
                        pass    # torn final append: re-run that step
        except OSError:
            pass
        return {"meta": meta, "steps": steps}
