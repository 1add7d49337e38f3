"""The port's hyperparameter search (``ddw_tpu_torch.tune``, a copy of the
host-numpy ``ddw_tpu.tune``) against the JAX package: from one seed,
``sample_space`` and TPE ``suggest`` propose the same trials bit for bit
(flat and ``choice_of`` spaces), sequential ``fmin`` returns the same best
and trial list, the median and ASHA pruners decide the same on the same
curves, a raising objective is a ``STATUS_FAIL`` trial, and a parallel
``fmin`` records every trial with its best at the minimum loss; and
``TuneCfg`` / ``default_cfgs`` are field for field the JAX package's."""

import dataclasses
import math

import numpy as np
import pytest

import ddw_tpu.tune as jt
from ddw_tpu.tune import tpe as jtpe
from ddw_tpu.utils.config import TuneCfg as JaxTuneCfg
from ddw_tpu.utils.config import default_cfgs as jax_default_cfgs
import ddw_tpu_torch.tune as tt
from ddw_tpu_torch.tune import tpe as ttpe
from ddw_tpu_torch.utils.config import TuneCfg, apply_overrides, default_cfgs


def _flat(m):
    return {"optimizer": m.choice("optimizer", ["adadelta", "adam"]),
            "learning_rate": m.loguniform("learning_rate", -5, 0),
            "dropout": m.uniform("dropout", 0.1, 0.9),
            "units": m.quniform("units", 8, 64, 8)}


def _nested(m):
    return {"optimizer": m.choice_of("optimizer", {
                "adam": {"adam_lr": m.loguniform("adam_lr", -9, -2)},
                "adadelta": {"adadelta_lr": m.loguniform("adadelta_lr",
                                                         -4, 1)},
                "sgd": None}),
            "dropout": m.uniform("dropout", 0.1, 0.9)}


def _loss(p):
    lr = p.get("learning_rate", p.get("adam_lr", p.get("adadelta_lr", 0.1)))
    return ((math.log(lr) + 4.0) ** 2 + (p["dropout"] - 0.3) ** 2
            + (0.5 if p["optimizer"] == "adadelta" else 0.0))


@pytest.mark.parametrize("space", [_flat, _nested])
def test_sample_space_and_suggest_are_bit_identical(space):
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    sj, st = space(jt), space(tt)
    for _ in range(6):
        assert tt.sample_space(st, rt) == jt.sample_space(sj, rj)
    trials_j, trials_t = jt.Trials(), tt.Trials()
    for _ in range(14):
        pj = jtpe.suggest(sj, trials_j, rj, n_startup_trials=4)
        pt = ttpe.suggest(st, trials_t, rt, n_startup_trials=4)
        assert pt == pj
        trials_j.record(pj, _loss(pj), jt.STATUS_OK)
        trials_t.record(pt, _loss(pt), tt.STATUS_OK)
    # constant-liar proposals with trials in flight
    pending = [trials_j.results[0]["params"], trials_j.results[1]["params"]]
    assert ttpe.suggest(st, trials_t, rt, pending=pending) == \
        jtpe.suggest(sj, trials_j, rj, pending=pending)


@pytest.mark.parametrize("algo", ["tpe", "random"])
def test_sequential_fmin_matches_jax(algo):
    kw = dict(max_evals=12, algo=algo, seed=5, n_startup_trials=4,
              gamma=0.25, parallelism=1)
    tj, tt_ = jt.Trials(), tt.Trials()
    bj = jt.fmin(lambda p: {"loss": _loss(p), "status": jt.STATUS_OK},
                 _flat(jt), trials=tj, **kw)
    bt = tt.fmin(lambda p: {"loss": _loss(p), "status": tt.STATUS_OK},
                 _flat(tt), trials=tt_, **kw)
    assert bt == bj
    assert tt_.results == tj.results
    assert tt_.best == tj.best


def test_failed_objective_is_recorded_and_search_continues():
    calls = []

    def objective(p):
        calls.append(p)
        if len(calls) % 3 == 1:
            raise RuntimeError("kernel launch failed")
        return _loss(p)

    trials = tt.Trials()
    best = tt.fmin(objective, _flat(tt), max_evals=6, seed=0,
                   trials=trials, parallelism=1)
    statuses = [t["status"] for t in trials.results]
    assert statuses.count(tt.STATUS_FAIL) == 2 and len(statuses) == 6
    fails = [t for t in trials.results if t["status"] == tt.STATUS_FAIL]
    assert all("kernel launch failed" in t["error"] for t in fails)
    assert best == trials.best["params"]
    with pytest.raises(RuntimeError, match="all 2 trials failed"):
        tt.fmin(lambda p: 1 / 0, _flat(tt), max_evals=2, parallelism=1)


@pytest.mark.parametrize("rule", ["median", "asha"])
def test_pruners_decide_as_jax(rule):
    cfg = dict(prune=True, pruner=rule, prune_warmup_epochs=1,
               prune_min_trials=2, asha_min_resource=1,
               asha_reduction_factor=2)
    pj = jt.make_pruner(JaxTuneCfg(**cfg))
    pt = tt.make_pruner(TuneCfg(**cfg))
    rng = np.random.RandomState(0)
    curves = [np.cumsum(rng.uniform(-0.3, 0.1, 6)) + rng.uniform(0, 1)
              for _ in range(7)]
    for i, curve in enumerate(curves):
        tj = pj.make_trial({"i": i})
        tr = pt.make_trial({"i": i})
        for step, value in enumerate(curve):
            outcomes = []
            for trial, exc in ((tj, jt.Pruned), (tr, tt.Pruned)):
                try:
                    trial.report(step, float(value))
                    outcomes.append(None)
                except exc as e:
                    outcomes.append((e.step, e.value))
            assert outcomes[0] == outcomes[1], (i, step)
            if outcomes[0] is not None:
                break
    assert tt.make_pruner(TuneCfg()) is None
    with pytest.raises(ValueError, match="pruner"):
        tt.make_pruner(TuneCfg(prune=True, pruner="hyperband"))


def test_parallel_fmin_records_every_trial():
    def objective(p):
        return {"loss": _loss(p), "status": tt.STATUS_OK}

    trials = tt.Trials()
    best = tt.fmin(objective, _nested(tt), max_evals=10, parallelism=3,
                   seed=1, n_startup_trials=3, trials=trials)
    assert len(trials.results) == 10
    assert all(t["status"] == tt.STATUS_OK for t in trials.results)
    losses = [t["loss"] for t in trials.results]
    assert trials.best["loss"] == min(losses)
    assert best == trials.best["params"]


def test_tune_cfg_and_default_cfgs_match_jax():
    fields = [(f.name, f.type, f.default)
              for f in dataclasses.fields(TuneCfg)]
    assert fields == [(f.name, f.type, f.default)
                      for f in dataclasses.fields(JaxTuneCfg)]
    cfgs = default_cfgs()
    assert sorted(cfgs) == sorted(jax_default_cfgs())
    apply_overrides(cfgs, ["tune.max_evals=4", "tune.pruner=asha",
                           "tune.prune=true"])
    assert cfgs["tune"] == TuneCfg(max_evals=4, pruner="asha", prune=True)
    with pytest.raises(KeyError, match="TuneCfg has no field"):
        apply_overrides(cfgs, ["tune.trials=3"])
