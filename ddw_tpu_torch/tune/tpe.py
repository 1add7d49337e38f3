"""TPE hyperparameter search — the Hyperopt ``fmin(..., tpe.suggest)`` role.

Reimplements Tree-structured Parzen Estimator search (Bergstra et al. 2011,
"Algorithms for Hyper-Parameter Optimization") against the reference's usage
contract (``Part 2 - Distributed Tuning & Inference/01_hyperopt_single_machine_
model.py:223-238``): ``fmin(objective, space, algo=tpe, max_evals=N, trials)``
where the objective returns ``{'loss': float, 'status': STATUS_OK}`` and the
reference negates accuracy into a loss (``:178-181``).

Algorithm (per dimension, factored like hyperopt):
1. First ``n_startup_trials`` draws are random (rng seeded — deterministic).
2. Afterwards, completed trials are split by the ``gamma`` quantile of loss into
   *good* (lowest) and *bad* sets.
3. Continuous dims: 1-D Parzen (Gaussian-mixture) estimators l(x) over good and
   g(x) over bad observations in the internal space (log-space for loguniform),
   bandwidths from neighbor spacing, plus a uniform prior component; draw
   ``n_ei_candidates`` from l and keep the candidate maximizing l(x)/g(x).
4. choice dims: categorical estimators with add-one smoothing; same EI ratio.

Two execution modes mirror the reference (SURVEY.md §2d):
- ``parallelism > 1`` — the SparkTrials role: up to N objectives in flight on a
  thread pool; suggestions use the trials completed so far (async TPE).
- ``parallelism = 1`` — sequential loop in the calling thread; required when each trial owns the
  whole device mesh (the documented SparkTrials/Horovod incompatibility,
  ``02_hyperopt_distributed_model.py:341-344``).
"""

from __future__ import annotations

import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable

import numpy as np

from ddw_tpu_torch.tune.space import ChoiceOf, Dim, sample_space, validate_space

STATUS_OK = "ok"
STATUS_FAIL = "fail"


class Trials:
    """Trial bookkeeping (hyperopt ``Trials`` role). Thread-safe appends."""

    def __init__(self):
        self._lock = threading.Lock()
        self.results: list[dict[str, Any]] = []

    def record(self, params: dict, loss: float | None, status: str, extra: dict | None = None):
        with self._lock:
            self.results.append({"params": params, "loss": loss, "status": status,
                                 **(extra or {})})

    def completed(self) -> list[dict]:
        with self._lock:
            return [t for t in self.results if t["status"] == STATUS_OK and t["loss"] is not None]

    @property
    def best(self) -> dict | None:
        done = self.completed()
        return min(done, key=lambda t: t["loss"]) if done else None

    def __len__(self):
        return len(self.results)


# ---------------------------------------------------------------------------
# Parzen estimators
# ---------------------------------------------------------------------------

def _parzen_logpdf(x: np.ndarray, obs: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Log-density of a 1-D Gaussian-mixture Parzen estimator with a uniform prior
    component over [lo, hi] (hyperopt's adaptive-Parzen flavor, simplified)."""
    span = hi - lo
    if len(obs) == 0:
        return np.full_like(x, -np.log(span))
    srt = np.sort(obs)
    # bandwidth per observation: max neighbor gap, floored
    if len(srt) > 1:
        gaps = np.diff(srt)
        left = np.concatenate([[gaps[0]], gaps])
        right = np.concatenate([gaps, [gaps[-1]]])
        sigma = np.maximum(left, right)
    else:
        sigma = np.array([span / 2.0])
    sigma = np.clip(sigma, span / 100.0, span)
    # mixture: each obs + one uniform prior pseudo-component
    k = len(srt)
    x_ = x[:, None]
    comp = -0.5 * ((x_ - srt[None, :]) / sigma[None, :]) ** 2 - np.log(sigma[None, :] * np.sqrt(2 * np.pi))
    prior = np.full((len(x), 1), -np.log(span))
    all_comp = np.concatenate([comp, prior], axis=1)
    return np.logaddexp.reduce(all_comp, axis=1) - np.log(k + 1)


def _parzen_sample(rng: np.random.RandomState, obs: np.ndarray, lo: float, hi: float,
                   n: int) -> np.ndarray:
    """Draw from the good-set mixture (uniform prior component included)."""
    out = np.empty(n)
    srt = np.sort(obs)
    span = hi - lo
    if len(srt) > 1:
        gaps = np.diff(srt)
        left = np.concatenate([[gaps[0]], gaps])
        right = np.concatenate([gaps, [gaps[-1]]])
        sigma = np.clip(np.maximum(left, right), span / 100.0, span)
    elif len(srt) == 1:
        sigma = np.array([span / 2.0])
    for i in range(n):
        j = rng.randint(len(srt) + 1)
        if j == len(srt) or len(srt) == 0:  # prior component
            out[i] = rng.uniform(lo, hi)
        else:
            out[i] = np.clip(rng.normal(srt[j], sigma[j]), lo, hi)
    return out


def _suggest_dim(rng: np.random.RandomState, dim: Dim, good: list, bad: list,
                 n_candidates: int) -> Any:
    if dim.kind == "choice":
        k = len(dim.options)
        gc = np.bincount([dim.options.index(v) for v in good], minlength=k) + 1.0
        bc = np.bincount([dim.options.index(v) for v in bad], minlength=k) + 1.0
        score = np.log(gc / gc.sum()) - np.log(bc / bc.sum())
        # sample candidates from the good distribution, keep the best EI score
        probs = gc / gc.sum()
        cands = rng.choice(k, size=n_candidates, p=probs)
        best = cands[np.argmax(score[cands])]
        return dim.options[int(best)]
    lo, hi = dim.bounds_internal()
    g_obs = np.array([dim.to_internal(v) for v in good])
    b_obs = np.array([dim.to_internal(v) for v in bad])
    cands = _parzen_sample(rng, g_obs, lo, hi, n_candidates)
    ei = _parzen_logpdf(cands, g_obs, lo, hi) - _parzen_logpdf(cands, b_obs, lo, hi)
    return dim.from_internal(float(cands[np.argmax(ei)]))


def suggest(space: dict[str, Dim], trials: Trials, rng: np.random.RandomState,
            n_startup_trials: int = 5, gamma: float = 0.25,
            n_ei_candidates: int = 24,
            pending: list[dict] | None = None) -> dict[str, Any]:
    """One TPE suggestion given completed history.

    ``pending`` are the param dicts of trials currently in flight (async mode).
    They join the *bad* Parzen set — the "constant liar" strategy — so the EI
    ratio is depressed around points already being evaluated and concurrent
    workers don't pile onto the same proposal (round-1 advisor note on
    duplicate concurrent proposals).
    """
    validate_space(space)
    done = trials.completed()
    pending = pending or []
    if len(done) < n_startup_trials:
        draw = sample_space(space, rng)
        # Startup draws are uniform; only all-categorical spaces can collide
        # with an in-flight draw with non-zero probability — reroll a few times.
        for _ in range(8):
            if draw not in pending:
                break
            draw = sample_space(space, rng)
        return draw
    losses = np.array([t["loss"] for t in done])
    # Elitist split: ceil(gamma * sqrt(n)) capped at 25 — hyperopt's split, which
    # keeps the good set small; a linear gamma*n fraction lets mediocre trials
    # crowd out the few excellent ones and stalls convergence.
    n_good = max(1, min(int(np.ceil(gamma * np.sqrt(len(done)))), 25))
    order = np.argsort(losses)
    good_idx, bad_idx = set(order[:n_good].tolist()), set(order[n_good:].tolist())
    def histories(name: str) -> tuple[list, list]:
        """(good, bad) observed values for one dim; trials without the dim
        (other branches of a ChoiceOf) simply don't contribute — which is how
        conditional dims condition on their branch."""
        good = [done[i]["params"][name] for i in good_idx if name in done[i]["params"]]
        bad = [done[i]["params"][name] for i in bad_idx if name in done[i]["params"]]
        bad += [p[name] for p in pending if name in p]
        return good, bad

    out = {}
    for name, dim in space.items():
        if isinstance(dim, ChoiceOf):
            # two-stage TPE on the tree: pick the branch by EI over branch
            # values, then suggest the selected branch's sub-dims from the
            # sub-histories (only trials that took this branch have them)
            val = _suggest_dim(rng, dim.branch_dim(), *histories(name),
                               n_ei_candidates)
            out[name] = val
            for sub_name, sub_dim in dim.subspace(val).items():
                out[sub_name] = _suggest_dim(rng, sub_dim, *histories(sub_name),
                                             n_ei_candidates)
        else:
            out[name] = _suggest_dim(rng, dim, *histories(name), n_ei_candidates)
    return out


# ---------------------------------------------------------------------------
# fmin
# ---------------------------------------------------------------------------

def fmin(
    objective: Callable[..., dict | float],
    space: dict[str, Dim],
    max_evals: int = 20,
    algo: str = "tpe",
    parallelism: int = 1,
    trials: Trials | None = None,
    seed: int = 0,
    n_startup_trials: int = 5,
    gamma: float = 0.25,
    pruner=None,
) -> dict[str, Any]:
    """Minimize ``objective`` over ``space``; returns the best param dict.

    ``objective`` returns ``{'loss': float, 'status': STATUS_OK, ...}`` (hyperopt
    contract; a bare float is accepted too). A raised exception records a failed
    trial (STATUS_FAIL) and the search continues.

    ``pruner`` (e.g. :class:`ddw_tpu_torch.tune.pruner.MedianPruner`) enables
    early-stopping of hopeless trials — beyond the hyperopt contract. With a
    pruner set, the objective is called as ``objective(params, trial)`` and
    should call ``trial.report(step, value)`` per epoch; a fired rule raises
    ``Pruned``, the trial records as ``STATUS_PRUNED``, and the search
    continues (pruned trials never enter the TPE good/bad split).
    """
    validate_space(space)
    trials = trials if trials is not None else Trials()
    rng = np.random.RandomState(seed)

    def propose(pending: list[dict] | None = None) -> dict:
        if algo == "random":
            return sample_space(space, rng)
        return suggest(space, trials, rng, n_startup_trials, gamma,
                       pending=pending)

    def run_one(params: dict) -> None:
        from ddw_tpu_torch.tune.pruner import Pruned, STATUS_PRUNED

        try:
            if pruner is not None:
                res = objective(params, pruner.make_trial(params))
            else:
                res = objective(params)
            if isinstance(res, (int, float)):
                res = {"loss": float(res), "status": STATUS_OK}
            if res.get("status", STATUS_OK) == STATUS_OK:
                trials.record(params, float(res["loss"]), STATUS_OK,
                              {k: v for k, v in res.items() if k not in ("loss", "status")})
            else:
                trials.record(params, None, res.get("status", STATUS_FAIL))
        except Pruned as p:
            trials.record(params, None, STATUS_PRUNED,
                          {"pruned_at": p.step, "last_value": p.value})
        except Exception as e:  # failed trial, keep searching
            trials.record(params, None, STATUS_FAIL, {"error": repr(e)})

    if parallelism <= 1:
        for _ in range(max_evals):
            run_one(propose())
    else:
        # SparkTrials role: up to `parallelism` objectives in flight; each new
        # proposal sees the trials completed so far (async TPE).
        submitted = 0
        with ThreadPoolExecutor(max_workers=parallelism) as pool:
            inflight: dict = {}  # future -> its proposed params (the pending set)
            while submitted < max_evals or inflight:
                while submitted < max_evals and len(inflight) < parallelism:
                    params = propose(pending=list(inflight.values()))
                    inflight[pool.submit(run_one, params)] = params
                    submitted += 1
                done, _ = wait(set(inflight), return_when=FIRST_COMPLETED)
                for f in done:
                    del inflight[f]
    best = trials.best
    if best is None:
        raise RuntimeError(f"all {max_evals} trials failed; last errors: "
                           f"{[t.get('error') for t in trials.results[-3:]]}")
    return dict(best["params"])
