"""Pruning a trial that runs as spawned ranks (``ddw_tpu_torch.tune.
TrialLink``, the port's example 05 with ``tune.prune``): two gloo ranks
report each epoch through rank 0 to the coordinating process's pruner; its
verdict is broadcast, both ranks stop at the same epoch boundary and exit
0, and ``fmin`` records ``STATUS_PRUNED`` (as ``ddw_tpu``'s in-process
trial does)."""

from ddw_tpu_torch.runtime.dist import process_topology, spawn_cpu
from ddw_tpu_torch.tune import (STATUS_OK, STATUS_PRUNED, Trial, TrialLink,
                                Trials, fmin, uniform)


class _PruneFrom:
    """Prunes trial 0 from epoch ``step`` on; later trials never."""

    def __init__(self, step):
        self.step = step
        self.reports = []
        self.trials = 0

    def make_trial(self, params):
        self.trials += 1
        return Trial(self, self.trials - 1, params)

    def should_prune(self, trial_id, step, value):
        self.reports.append((trial_id, step, value))
        return trial_id == 0 and step >= self.step


def _epochs(reporter, epochs):
    """A rank's training loop: one report per epoch boundary, stop when the
    verdict says so. Returns (rank, epochs run)."""
    rank, _ = process_topology()
    run = 0
    for epoch in range(epochs):
        run = epoch + 1
        if reporter is not None and reporter.on_epoch(
                {"epoch": epoch, "val_loss": 1.0 / (epoch + 1)}):
            break
    return rank, run


def test_distributed_trial_is_pruned_through_the_coordinator():
    pruner = _PruneFrom(1)
    ranks_seen = []

    def objective(params, trial):
        with TrialLink(trial) as link:
            ranks = spawn_cpu(_epochs, 2, link.ranks_side(), 5,
                              timeout_s=120)
        ranks_seen.append(ranks)
        link.raise_if_pruned()
        return {"loss": params["x"], "status": STATUS_OK}

    trials = Trials()
    fmin(objective, {"x": uniform("x", 0, 1)}, max_evals=2, algo="random",
         trials=trials, seed=0, pruner=pruner)
    assert [t["status"] for t in trials.results] == [STATUS_PRUNED,
                                                     STATUS_OK]
    assert trials.results[0]["pruned_at"] == 1
    # both ranks of the pruned trial stopped after epoch 1, cleanly; the
    # other trial ran all five epochs; only rank 0 reported
    assert ranks_seen == [[(0, 2), (1, 2)], [(0, 5), (1, 5)]]
    assert [(t, s) for t, s, _ in pruner.reports] == \
        [(0, 0), (0, 1)] + [(1, e) for e in range(5)]
