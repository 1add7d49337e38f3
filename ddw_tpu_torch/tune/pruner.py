"""Trial pruning — early-stop hopeless HPO trials on intermediate metrics.

Beyond the Hyperopt parity contract (hyperopt has no pruning; every trial runs
its full budget — the reference's 20-eval search at
``01_hyperopt_single_machine_model.py:226-238`` pays full training cost for
every config, good or bad). The median rule here is the standard one
(popularized by Google Vizier and Optuna's ``MedianPruner``): at each
reporting step, a trial whose intermediate objective is worse than the median
of what other trials reported at the same step is stopped.

Protocol: pruning-aware objectives accept ``(params, trial)`` and call
``trial.report(step, value)`` once per epoch (typically via
``Trainer(..., on_epoch=...)``); ``report`` raises :class:`Pruned` when the
rule fires, ``fmin`` records the trial with ``STATUS_PRUNED`` and moves on.
Pruned trials never enter the TPE good/bad split (``Trials.completed`` filters
on ``STATUS_OK``) — a half-trained loss is not comparable to a final one.

Thread-safe: parallel ``fmin`` reports from worker threads concurrently.
A trial that runs as spawned ranks reports through a :class:`TrialLink`.
"""

from __future__ import annotations

import math
import threading

STATUS_PRUNED = "pruned"


class Pruned(Exception):
    """A pruner decided this trial is not worth finishing."""

    def __init__(self, step: int, value: float):
        super().__init__(f"pruned at step {step} (value {value:g})")
        self.step = step
        self.value = value


class Trial:
    """Per-trial reporting handle handed to pruning-aware objectives."""

    def __init__(self, pruner, trial_id: int, params: dict):
        self._pruner = pruner
        self.trial_id = trial_id
        self.params = params

    def report(self, step: int, value: float) -> None:
        """Record an intermediate objective value (lower is better, same
        orientation as the trial loss). Raises :class:`Pruned` when the rule
        says stop."""
        if self._pruner.should_prune(self.trial_id, step, float(value)):
            raise Pruned(step, float(value))


class _BasePruner:
    """Shared trial-id bookkeeping for the pruning rules."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 0

    def make_trial(self, params: dict) -> Trial:
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._register(tid)
        return Trial(self, tid, params)

    def _register(self, trial_id: int) -> None:  # hook for per-trial state
        pass


class MedianPruner(_BasePruner):
    """Median rule with warmup: at reporting step ``s``, prune when the
    trial's value is strictly worse than the median of all OTHER trials'
    values at the same step.

    ``warmup_steps``: never prune at steps below this (early epochs are noisy).
    ``min_trials``: need at least this many other trials reporting at the step
    before the median is trusted.
    """

    def __init__(self, warmup_steps: int = 1, min_trials: int = 3):
        super().__init__()
        self.warmup_steps = warmup_steps
        self.min_trials = min_trials
        self._history: dict[int, dict[int, float]] = {}

    def _register(self, trial_id: int) -> None:
        self._history[trial_id] = {}

    def should_prune(self, trial_id: int, step: int, value: float) -> bool:
        if not math.isfinite(value):
            # A NaN/inf objective never recovers — prune unconditionally
            # (warmup/min-trial guards exist for noisy-but-finite curves).
            # NaN must also never enter the history: `nan > median` is False
            # and a NaN at the median index would disable pruning for peers.
            return True
        with self._lock:
            self._history[trial_id][step] = value
            if step < self.warmup_steps:
                return False
            others = [h[step] for tid, h in self._history.items()
                      if tid != trial_id and step in h]
            if len(others) < self.min_trials:
                return False
            others.sort()
            n = len(others)
            median = (others[n // 2] if n % 2
                      else 0.5 * (others[n // 2 - 1] + others[n // 2]))
            return value > median


class ASHAPruner(_BasePruner):
    """Asynchronous Successive Halving (Li et al. 1810.05934) — the modern
    default for parallel HPO pruning, beside the median rule.

    ``step`` is 0-indexed like the Trainer's epoch number (the examples
    report ``row["epoch"]``), so ``step + 1`` is the resource consumed. A
    rung sits where the consumed resource reaches
    ``min_resource * reduction_factor**k`` — with the defaults the FIRST
    reported epoch is rung 0, so bad configs stop after one epoch. A trial
    at a rung continues only if its value is within the top
    ``1/reduction_factor`` fraction of everything recorded AT that rung so
    far (asynchronous: decisions use whatever has been recorded, no waiting
    for a full bracket — exactly what a constant-liar parallel ``fmin``
    needs). Lower is better, same orientation as the trial loss.

    Same ``make_trial`` / ``should_prune`` protocol as :class:`MedianPruner`,
    so ``fmin``/``Trainer(on_epoch=...)`` plumbing is shared.
    """

    def __init__(self, min_resource: int = 1, reduction_factor: int = 3):
        if min_resource < 1 or reduction_factor < 2:
            raise ValueError(f"need min_resource >= 1 and reduction_factor "
                             f">= 2, got {min_resource}, {reduction_factor}")
        super().__init__()
        self.min_resource = min_resource
        self.reduction_factor = reduction_factor
        # rung -> {trial_id: value}: keyed so a re-reported step (resume,
        # double-firing hook) overwrites instead of double-counting a trial
        # in the rung population
        self._rungs: dict[int, dict[int, float]] = {}

    def _rung_of(self, step: int) -> int | None:
        """Rung index when ``step + 1`` units of resource are consumed, or
        None between rungs."""
        consumed = step + 1
        r = self.min_resource
        k = 0
        while r <= consumed:
            if r == consumed:
                return k
            r *= self.reduction_factor
            k += 1
        return None

    def should_prune(self, trial_id: int, step: int, value: float) -> bool:
        if not math.isfinite(value):
            return True  # same rationale as MedianPruner: never recovers
        rung = self._rung_of(step)
        if rung is None:
            return False
        with self._lock:
            recorded = self._rungs.setdefault(rung, {})
            recorded[trial_id] = value
            if len(recorded) < self.reduction_factor:
                return False  # too few at this rung to cut anything
            srt = sorted(recorded.values())
            # continue only in the top 1/eta fraction (at least one survives)
            keep = max(1, len(srt) // self.reduction_factor)
            return value > srt[keep - 1]


def make_pruner(tune_cfg):
    """The one ``TuneCfg -> pruner`` dispatch every consumer shares (examples
    04/05 and any future script): ``tune.prune=false`` -> None;
    ``tune.pruner`` selects the rule; unknown names refuse loudly."""
    if not tune_cfg.prune:
        return None
    if tune_cfg.pruner == "median":
        return MedianPruner(tune_cfg.prune_warmup_epochs,
                            tune_cfg.prune_min_trials)
    if tune_cfg.pruner == "asha":
        return ASHAPruner(tune_cfg.asha_min_resource,
                          tune_cfg.asha_reduction_factor)
    raise ValueError(f"unknown tune.pruner {tune_cfg.pruner!r}; "
                     f"use 'median' or 'asha'")


class TrialLink:
    """Pruning for a trial that runs as a set of spawned ranks (the port's
    example 05; ``ddw_tpu`` reports in process). Rank 0 carries each
    epoch's row to the coordinating process over a queue; the coordinator
    feeds it to the trial's :meth:`Trial.report` and sends the verdict
    back; rank 0 broadcasts the verdict over the trial's process group, so
    every rank stops at the same epoch boundary and returns normally (no
    process is killed, no group is left hanging).

    Coordinator::

        link = TrialLink(trial)          # before spawning the ranks
        with link:                       # answers reports while ranks run
            spawn_cpu(fn, n, ..., link.ranks_side(), ...)
        link.raise_if_pruned()           # -> fmin records STATUS_PRUNED

    Ranks: ``Trainer(..., on_epoch=ranks_side.on_epoch)``.
    """

    def __init__(self, trial: Trial, timeout_s: float = 600.0):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.trial = trial
        self.timeout_s = timeout_s
        self._reports = ctx.Queue()
        self._verdicts = ctx.Queue()
        self.pruned: Pruned | None = None
        self._thread: threading.Thread | None = None

    def ranks_side(self) -> "RankReporter":
        """The picklable half each spawned rank receives."""
        return RankReporter(self._reports, self._verdicts, self.timeout_s)

    def _serve(self) -> None:
        while True:
            msg = self._reports.get()
            if msg is None:
                return
            step, value = msg
            prune = False
            if self.pruned is None:
                try:
                    self.trial.report(step, value)
                except Pruned as p:
                    self.pruned, prune = p, True
            self._verdicts.put(prune)

    def __enter__(self) -> "TrialLink":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="trial-link")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._reports.put(None)
        self._thread.join(timeout=self.timeout_s)

    def raise_if_pruned(self) -> None:
        if self.pruned is not None:
            raise self.pruned


class RankReporter:
    """A spawned rank's end of a :class:`TrialLink`: ``on_epoch(row)`` is
    the trainer's epoch callback. Rank 0 reports ``row["val_loss"]`` at
    ``row["epoch"]`` and waits for the coordinator's verdict; the verdict
    goes to every rank by a broadcast from rank 0 over the group, and a True
    return stops the trainer at this epoch boundary."""

    def __init__(self, reports, verdicts, timeout_s: float):
        self._reports, self._verdicts = reports, verdicts
        self.timeout_s = timeout_s

    def on_epoch(self, row: dict) -> bool:
        import torch
        import torch.distributed as dist

        from ddw_tpu_torch.runtime.dist import group_topology

        rank, world = group_topology()
        stop = torch.zeros(1, dtype=torch.int32)
        if rank == 0:
            self._reports.put((int(row["epoch"]), float(row["val_loss"])))
            stop[0] = int(self._verdicts.get(timeout=self.timeout_s))
        if world > 1:
            dist.broadcast(stop, src=0)
        return bool(stop.item())
