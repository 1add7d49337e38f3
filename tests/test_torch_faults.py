"""Fault injection in the PyTorch port (``ddw_tpu_torch.runtime.faults``)
against ``ddw_tpu.runtime.faults``: every spec string the JAX fault tests
parse gives equal fields in both packages (gang, serve, deploy and
autoscale scopes), the malformed ones raise in both, the exit codes are
the same numbers, and the serve hook fires, filters and aborts alike. Then
the serve scope wired into the port's engine: ``DDW_FAULT=serve:*`` at the
admit, prefill and decode sites (a raise degrades, a crash fails every
future with a structured ``ReplicaFailed``, a stall holds the loop until
``force_fail``), with per-site counts that restart every generation.
Every future is waited on with a timeout and every engine stopped."""

import dataclasses
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.runtime import faults as jax_faults
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.runtime import faults
from ddw_tpu_torch.serve import (DEGRADED, FAILED, EngineCfg, ReplicaFailed,
                                 ServingEngine)
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

VOCAB = 64
CFG = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=2,
           mlp_dim=64, dropout=0.0, dtype="float32")
WAIT = 60           # seconds any one future or event may take

# every spec string the JAX fault tests parse (tests/test_faults.py,
# test_elastic.py, test_fleet_supervision.py, test_rollout.py,
# test_deploy.py, test_autoscale.py), plus each scope's bare kinds
SPECS = [
    "crash:rank=1:step=3", "stall", "preempt:rank=*:gen=*:attempt=*:step=5",
    "raise:step=2", "preempt:step=0", "preempt:step=4", "raise:step=0",
    "preempt:step=3", "kill:rank=1:step=3", "kill:rank=1:step=3:egen=*",
    "ckpt_async_torn:step=4", "host_lost:rank=2:step=3", "shrink_veto",
    "shrink_veto:rank=0:step=*", "bind_fail:attempt=0", "exit0_early",
    "ckpt_torn:rank=0:step=2:gen=1",
    "serve:crash", "serve:stall:site=decode:replica=1:after=5:gen=*",
    "serve:raise:site=admit", "serve:stall", "serve:crash:site=decode:replica=0",
    "serve:stall:site=decode:replica=1", "serve:crash:site=decode:after=1",
    "serve:crash:site=batch:replica=*", "serve:raise:site=prefill:after=2",
    "deploy:degrade_canary:ttft_ms=700", "deploy:crash_mid_roll:after=1",
    "deploy:degrade_canary:ttft_ms=30", "deploy:degrade_canary:errors=2",
    "deploy:degrade_canary:ttft_ms=30:replica=0", "deploy:crash_mid_roll",
    "autoscale:spawn_fail", "autoscale:flap:after=3",
    "autoscale:stall_drain", "autoscale:flap", "autoscale:crash_mid_scale",
    "autoscale:crash_mid_scale:after=2",
]
BAD = ["explode", "crash:when=3", "crash:rank=x", "serve:explode",
       "serve:crash:site=warp", "serve:crash:when=3", "serve:crash:after=x",
       "deploy:meteor", "deploy:degrade_canary:jitter=1",
       "autoscale:meteor", "autoscale:flap:jitter=1"]
PARSERS = ("parse_fault", "parse_serve_fault", "parse_deploy_fault",
           "parse_autoscale_fault")


def _fields(spec):
    return None if spec is None else (type(spec).__name__,
                                      dataclasses.asdict(spec))


@pytest.mark.parametrize("text", SPECS)
def test_every_spec_parses_to_equal_fields_in_both_packages(text):
    for name in PARSERS:
        got = _fields(getattr(faults, name)(text))
        want = _fields(getattr(jax_faults, name)(text))
        assert got == want, (name, text)
    # exactly one scope claims a non-empty spec
    assert sum(getattr(faults, n)(text) is not None for n in PARSERS) == 1


@pytest.mark.parametrize("text", BAD)
def test_malformed_specs_raise_in_both_packages(text):
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError):
            mod.parse_fault(text)


def test_exit_codes_kinds_and_sites_equal():
    for name in ("EXIT_FAULT_CRASH", "EXIT_PREEMPTED", "EXIT_COORD_BIND",
                 "EXIT_HOST_LOST", "KINDS", "SERVE_KINDS", "SERVE_SITES"):
        assert getattr(faults, name) == getattr(jax_faults, name), name
    assert faults.parse_fault("") is None
    assert faults.parse_serve_fault("crash:rank=1") is None


def test_matching_matrix_equal_across_packages():
    """The pure ``matches`` of each scope on a grid of calls."""
    for text in ("crash:rank=1:step=3", "kill:rank=1:step=3:egen=*",
                 "shrink_veto"):
        a, b = faults.parse_fault(text), jax_faults.parse_fault(text)
        for site in ("step", "coord_bind", "shrink_vote"):
            for rank in (0, 1):
                for step in (0, 2, 3):
                    for gen in (0, 1):
                        kw = dict(step=step, rank=rank, gen=gen, attempt=0,
                                  egen=gen)
                        assert a.matches(site, **kw) == b.matches(site,
                                                                  **kw)
    for text in ("serve:crash", "serve:stall:site=decode:replica=1:after=5"
                 ":gen=*", "serve:raise:site=admit"):
        a = faults.parse_serve_fault(text)
        b = jax_faults.parse_serve_fault(text)
        for site in faults.SERVE_SITES:
            for replica in (0, 1):
                for n in (0, 4, 5, 9):
                    for gen in (0, 1, 7):
                        assert a.matches(site, replica, n, gen) == \
                            b.matches(site, replica, n, gen)


def test_serve_fault_fires_filters_and_stall_aborts(monkeypatch):
    """The serve hook: ``raise`` fires at its site only; ``stall`` holds
    until the abort signal, then raises ServeCrash. ``t0`` is taken BEFORE
    the timer starts, so the held time is measured from the earliest
    moment the abort could fire."""
    monkeypatch.setenv("DDW_FAULT", "serve:raise:site=admit")
    with pytest.raises(faults.FaultInjected):
        faults.maybe_serve_fault("admit", replica=0, n=0, gen=0)
    faults.maybe_serve_fault("decode", replica=0, n=0, gen=0)
    faults.maybe_serve_fault("admit", replica=1, n=0, gen=0)
    monkeypatch.setenv("DDW_FAULT", "serve:crash")
    with pytest.raises(faults.ServeCrash):
        faults.maybe_serve_fault("decode", replica=0, n=3, gen=0)
    monkeypatch.setenv("DDW_FAULT", "serve:stall")
    abort = threading.Event()
    t0 = time.monotonic()
    timer = threading.Timer(0.1, abort.set)
    timer.start()
    try:
        with pytest.raises(faults.ServeCrash, match="stall aborted"):
            faults.maybe_serve_fault("decode", replica=0, n=0, gen=0,
                                     should_abort=abort.is_set)
        assert time.monotonic() - t0 >= 0.1
    finally:
        timer.cancel()
    monkeypatch.delenv("DDW_FAULT")
    faults.maybe_serve_fault("decode", replica=0, n=0, gen=0)   # no-op


def test_stall_resumes_when_the_spec_is_cleared(monkeypatch):
    monkeypatch.setenv("DDW_FAULT", "serve:stall")
    done = threading.Event()

    def hold():
        faults.maybe_serve_fault("decode", replica=0, n=0, gen=0)
        done.set()

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    assert not done.wait(0.1)
    monkeypatch.delenv("DDW_FAULT")
    assert done.wait(WAIT)


def test_deploy_and_autoscale_hooks_equal(monkeypatch):
    for mod in (faults, jax_faults):
        monkeypatch.setenv("DDW_FAULT", "deploy:crash_mid_roll:after=1")
        assert mod.maybe_deploy_fault("mid_roll", n=0) is None
        with pytest.raises(mod.DeployCrash):
            mod.maybe_deploy_fault("mid_roll", n=1)
        monkeypatch.setenv("DDW_FAULT", "deploy:degrade_canary:ttft_ms=30")
        assert _fields(mod.maybe_deploy_fault("judge", replica=2)) == \
            _fields(jax_faults.parse_deploy_fault(
                "deploy:degrade_canary:ttft_ms=30"))
        monkeypatch.setenv("DDW_FAULT", "autoscale:spawn_fail")
        with pytest.raises(mod.FaultInjected):
            mod.maybe_autoscale_fault("spawn")
        monkeypatch.setenv("DDW_FAULT", "autoscale:crash_mid_scale:after=1")
        mod.maybe_autoscale_fault("mid_scale", n=0)
        with pytest.raises(mod.AutoscaleCrash):
            mod.maybe_autoscale_fault("mid_scale", n=1)
        monkeypatch.setenv("DDW_FAULT", "autoscale:flap")
        assert mod.maybe_autoscale_fault("decide").kind == "flap"


def test_gang_hook_raise_and_preemption_flag(monkeypatch, tmp_path):
    """The train scope's primitives (the trainers' fit-loop hooks are
    driven below): ``raise`` fires on its step only, ``preempt`` sets the
    flag through SIGTERM, and the torn step dir is the layout the port's
    checkpoint quarantine reads."""
    monkeypatch.delenv("DDW_FAULT", raising=False)
    faults.maybe_fault("step", step=2)
    monkeypatch.setenv("DDW_FAULT", "raise:step=2")
    faults.maybe_fault("step", step=1)
    with pytest.raises(faults.FaultInjected):
        faults.maybe_fault("step", step=2)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        monkeypatch.setenv("DDW_FAULT", "preempt:step=0")
        faults.reset_preemption()
        faults.maybe_fault("step", step=0)
        deadline = time.monotonic() + WAIT
        while not faults.preemption_requested() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert faults.preemption_requested()
    finally:
        faults.reset_preemption()
        signal.signal(signal.SIGTERM, prev)
    d = faults._write_torn_step_dir(str(tmp_path), 7)
    from ddw_tpu_torch.checkpoint.ckpt import latest_step

    assert d.endswith("step_0000000007")
    assert latest_step(str(tmp_path)) is None   # torn: quarantined


# -- the gang scope in the trainers (tests/test_faults.py's trainer cases) ----

@pytest.fixture()
def preemption_cleanup():
    """Restore the SIGTERM disposition and the flag after a test that
    exercises SIGTERM."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    faults.reset_preemption()
    signal.signal(signal.SIGTERM, prev)


def _lm_trainer(tmp_path, epochs=3):
    from ddw_tpu_torch.train.lm_trainer import LMTrainer
    from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

    lm = LMCfg(vocab_size=32, max_len=16, hidden=16, depth=1, num_heads=2,
               mlp_dim=32, dropout=0.0, dtype="float32")
    tr = TrainCfg(batch_size=2, epochs=epochs, warmup_epochs=0, seed=0,
                  learning_rate=1e-2, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every_epochs=1)
    return LMTrainer(lm, tr, device="cpu")


def _toy_tokens():
    rng = np.random.RandomState(0)
    starts = rng.randint(0, 32, size=(44, 1))
    return ((starts + np.arange(17)[None]) % 32).astype(np.int32)


@pytest.mark.faults
def test_lm_trainer_graceful_preemption_checkpoints_then_resumes(
        tmp_path, monkeypatch, preemption_cleanup):
    """SIGTERM mid-epoch -> the step loop checkpoints the live state with
    ``preempted: True`` and raises Preempted; a resume run completes all
    epochs from that point."""
    import json
    import os

    from ddw_tpu_torch.checkpoint.ckpt import latest_step

    toks = _toy_tokens()
    monkeypatch.setenv("DDW_FAULT", "preempt:step=4")
    with pytest.raises(faults.Preempted) as exc:
        _lm_trainer(tmp_path).fit(toks, val_fraction=0.1)
    assert exc.value.step == 4

    ck = str(tmp_path / "ck")
    assert latest_step(ck) == 4
    with open(os.path.join(ck, "step_0000000004", "metadata.json")) as f:
        assert json.load(f)["preempted"] is True

    monkeypatch.delenv("DDW_FAULT")
    faults.reset_preemption()
    res = _lm_trainer(tmp_path).fit(toks, val_fraction=0.1, resume=True)
    assert res.epochs_run == 3
    assert np.isfinite(res.val_loss)


@pytest.fixture()
def tables(tmp_path):
    from ddw_tpu_torch.data.store import Record, TableStore

    def records(n, seed):
        rng = np.random.RandomState(seed)
        for i in range(n):
            img = rng.randint(0, 60, (24, 24, 3)) + 150 * (i % 5 == 0)
            yield Record(f"img/{i:04d}", img.clip(0, 255).astype(np.uint8)
                         .tobytes(), f"c{i % 5}", i % 5)

    store = TableStore(str(tmp_path / "tables"))
    meta = {"encoding": "raw_u8", "height": 24, "width": 24}
    return (store.write("train", records(32, 0), 16, meta),
            store.write("val", records(16, 1), 16, meta))


def _vision(tmp_path, epochs=1, ckpt=False):
    from ddw_tpu_torch.train.trainer import Trainer
    from ddw_tpu_torch.utils.config import DataCfg, ModelCfg, TrainCfg

    data = DataCfg(img_height=24, img_width=24, loader_workers=2,
                   shuffle_buffer=32)
    model = ModelCfg(name="small_cnn", num_classes=5, dropout=0.0,
                     dtype="float32")
    tr = TrainCfg(batch_size=4, epochs=epochs, warmup_epochs=0, seed=0,
                  learning_rate=1e-2,
                  checkpoint_dir=str(tmp_path / "ck") if ckpt else "",
                  checkpoint_every_epochs=1)
    return Trainer(data, model, tr, device="cpu")


@pytest.mark.faults
def test_vision_trainer_step_hook_fires(tables, tmp_path, monkeypatch):
    """The vision Trainer's per-step hook is live: an injected 'raise' at
    global step 0 propagates out of fit before any step executes."""
    monkeypatch.setenv("DDW_FAULT", "raise:step=0")
    with pytest.raises(faults.FaultInjected):
        _vision(tmp_path).fit(*tables)


@pytest.mark.slow
@pytest.mark.faults
def test_vision_trainer_graceful_preemption(tables, tmp_path, monkeypatch,
                                            preemption_cleanup):
    """Checkpoint-on-SIGTERM mid-run, then a resumed fit completes the
    remaining epochs."""
    from ddw_tpu_torch.checkpoint.ckpt import latest_step

    monkeypatch.setenv("DDW_FAULT", "preempt:step=3")
    with pytest.raises(faults.Preempted):
        _vision(tmp_path, epochs=4, ckpt=True).fit(*tables)
    assert (latest_step(str(tmp_path / "ck")) or 0) > 0

    monkeypatch.delenv("DDW_FAULT")
    faults.reset_preemption()
    res = _vision(tmp_path, epochs=4, ckpt=True).fit(*tables, resume=True)
    assert res.epochs_run == 4
    assert np.isfinite(res.val_loss)


def test_vision_trainer_elastic_park_point(tables, tmp_path, monkeypatch):
    """Under an elastic gang (a rendezvous directory, no process group) the
    fit loop's park point leaves through ElasticRestart once a newer
    recovery record exists, and the loaders read the rank's half of the
    batch from its partition."""
    from ddw_tpu_torch.runtime import elastic

    monkeypatch.setenv("DDW_RENDEZVOUS_DIR", str(tmp_path / "rdzv"))
    monkeypatch.setenv("DDW_NUM_PROCESSES", "2")
    monkeypatch.setenv("DDW_PROCESS_ID", "1")
    elastic.reset_context()
    try:
        trainer = _vision(tmp_path)
        loader, _ = trainer._loaders(*tables)
        assert (loader.batch_size, loader.cur_shard, loader.shard_count) \
            == (2, 1, 2)
        elastic.GangRendezvous(str(tmp_path / "rdzv"), 2, -1).post_recovery(
            1, dead_rank=0)
        with pytest.raises(elastic.ElasticRestart) as exc:
            trainer.fit(*tables)
        assert exc.value.step == 0
    finally:
        elastic.reset_context()


def test_lm_fit_tables_partitions_by_the_gang(tmp_path, monkeypatch):
    """An elastic gang's LM ranks, outside a process group, read ddw_tpu's
    per-process partition of the global batch: half the rows of each
    batch, from their half of the table's shards."""
    from ddw_tpu_torch.data import loader
    from ddw_tpu_torch.data.prep import write_token_table
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.runtime import elastic

    store = TableStore(str(tmp_path / "tables"))
    toks = _toy_tokens()
    train = write_token_table(store, "train", toks[:32], shard_size=8)
    val = write_token_table(store, "val", toks[32:40], shard_size=8)
    seen = []
    init = loader.ShardedLoader.__init__

    def spy(self, *args, **kw):
        seen.append({k: kw.get(k) for k in ("batch_size", "cur_shard",
                                             "shard_count")})
        init(self, *args, **kw)

    monkeypatch.setattr(loader.ShardedLoader, "__init__", spy)
    monkeypatch.setenv("DDW_RENDEZVOUS_DIR", str(tmp_path / "rdzv"))
    monkeypatch.setenv("DDW_NUM_PROCESSES", "2")
    monkeypatch.setenv("DDW_PROCESS_ID", "1")
    elastic.reset_context()
    try:
        res = _lm_trainer(tmp_path, epochs=1).fit_tables(train, val)
    finally:
        elastic.reset_context()
    assert seen and all(s == {"batch_size": 1, "cur_shard": 1,
                              "shard_count": 2} for s in seen)
    assert np.isfinite(res.val_loss)


# -- the serve scope in the port's engine -------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pm(tmp_path_factory):
    cfg = JaxLMCfg(**CFG)
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(0)},
                                    np.zeros((1, 8), np.int32))["params"]
    out = jax_lm_package.save_lm_package(
        str(tmp_path_factory.mktemp("faults_pkg") / "pkg"), cfg, params)
    return LMPackagedModel(out, device="cpu")


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("paged", [True, False])
def test_engine_raise_degrades_then_heals(pm, monkeypatch, paged):
    """``serve:raise:site=prefill`` fails the group it hit (structured,
    degraded); with the spec gone the replica serves and heals."""
    monkeypatch.setenv("DDW_FAULT", "serve:raise:site=prefill")
    p = _prompts([5])[0]
    ref = pm.generate(p[None], 4)[0]
    with ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2, paged=paged)) as eng:
        with pytest.raises(ReplicaFailed) as ei:
            eng.submit_generate(p, 4).result(timeout=WAIT)
        assert ei.value.kind == "error"
        assert eng.state == DEGRADED
        monkeypatch.delenv("DDW_FAULT")
        got = eng.submit_generate(p, 4).result(timeout=WAIT).tokens
        assert np.array_equal(got, ref)
        assert eng.state != DEGRADED


def test_engine_crash_fails_every_future_and_restart_runs_clean(
        pm, monkeypatch):
    """``serve:crash:site=decode`` kills the loop at the first decode
    tick: every future resolves with ReplicaFailed (never a hang), later
    submissions are refused, and restart() — generation 1, which the
    default ``gen=0`` spares — serves sequential generate's tokens."""
    monkeypatch.setenv("DDW_FAULT", "serve:crash:site=decode")
    prompts = _prompts([3, 9, 6])
    refs = [pm.generate(p[None], 5)[0] for p in prompts]
    eng = ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2)).start()
    try:
        futs = [eng.submit_generate(p, 5) for p in prompts]
        for f in futs:
            with pytest.raises(ReplicaFailed) as ei:
                f.result(timeout=WAIT)
            assert ei.value.replica == 0
        assert eng.state == FAILED and eng.failure.kind == "crash"
        with pytest.raises(ReplicaFailed):
            eng.submit_generate(prompts[0], 2)
        eng.restart()
        assert eng.generation == 1 and eng._fault_n == {}
        got = [eng.submit_generate(p, 5).result(timeout=WAIT).tokens
               for p in prompts]
        assert all(np.array_equal(g, r) for g, r in zip(got, refs))
        assert eng._fault_n.get("decode", 0) > 0
    finally:
        eng.stop()


def test_engine_after_counts_per_site_and_replica_filter(pm, monkeypatch):
    """``after=2`` lets replica 1's first two admit checks pass and fires
    from the third on (the spec matches ``n >= after``): each firing is a
    recoverable loop error with the request still queued, so the error
    budget (3 in a row) turns the replica FAILED and the queued future
    resolves with ReplicaFailed. Replica 0 under the same spec serves
    untouched."""
    monkeypatch.setenv("DDW_FAULT", "serve:raise:site=admit:replica=1:after=2")
    p = _prompts([4])[0]
    ref = pm.generate(p[None], 2)[0]
    with ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2)) as e0, \
            ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2),
                          replica_id=1) as e1:
        for _ in range(3):
            assert np.array_equal(
                e0.submit_generate(p, 2).result(timeout=WAIT).tokens, ref)
        for _ in range(2):
            assert np.array_equal(
                e1.submit_generate(p, 2).result(timeout=WAIT).tokens, ref)
        with pytest.raises(ReplicaFailed) as ei:
            e1.submit_generate(p, 2).result(timeout=WAIT)
        assert ei.value.phase == "queued"
        assert e1.state == FAILED and e1.metrics.loop_errors == 3
        assert e1._fault_n["admit"] == 5
        assert e0.metrics.loop_errors == 0 and e0.state != FAILED


def test_engine_stall_holds_the_loop_until_force_fail(pm, monkeypatch):
    """``serve:stall:site=decode`` wedges the tick: the heartbeat goes
    stale while the stream waits, force_fail() aborts the stall (the
    thread stays joinable) and fails the future, restart() serves."""
    monkeypatch.setenv("DDW_FAULT", "serve:stall:site=decode")
    p = _prompts([6])[0]
    ref = pm.generate(p[None], 3)[0]
    eng = ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2)).start()
    try:
        t0 = time.monotonic()
        fut = eng.submit_generate(p, 3)
        deadline = t0 + WAIT
        while eng.health()["last_tick_age_s"] < 0.2 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.health()["last_tick_age_s"] >= 0.2
        assert not fut.done()
        eng.force_fail("stalled", "drill")
        with pytest.raises(ReplicaFailed):
            fut.result(timeout=WAIT)
        eng._thread.join(timeout=WAIT)
        assert not eng._thread.is_alive()
        eng.restart()           # gen 1: the default gen=0 spec is spent
        assert np.array_equal(
            eng.submit_generate(p, 3).result(timeout=WAIT).tokens, ref)
    finally:
        eng.stop()
