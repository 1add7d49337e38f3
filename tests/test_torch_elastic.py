"""Elastic gang recovery in the PyTorch port (``ddw_tpu_torch.runtime.
elastic``, the launcher's elastic and shrink modes, the async-checkpoint
fault drills), case for case with ``tests/test_elastic.py``, plus the
cross-package checks: a ``ddw_tpu`` ``GangRendezvous`` and the port's on
one control directory read each other's records, votes and commits, and
their host all-reduce over mixed members gives bit-equal float64 sums.

Tier-1 keeps the pure rendezvous units (threaded fake gangs, no
subprocess) and one real-process representative per drill class: the
single-rank respawn, the torn async checkpoint and the shrink on a lost
host. The rest ride ``slow``, as in ``ddw_tpu``'s file. The ranks import
this module to find their functions, so it imports nothing of JAX at the
top; ``ddw_tpu`` is imported inside the cross-package tests only."""

import functools
import os
import threading
import time

import numpy as np
import pytest

from ddw_tpu_torch.runtime.elastic import ElasticRestart, GangRendezvous
from ddw_tpu_torch.runtime.launcher import Launcher
from ddw_tpu_torch.runtime.supervisor import GangFailure, GangSupervisor

TOTAL_STEPS = 6


# -- pure topology units (threaded fake gang, no subprocess) -----------------

def _threads(n, fn):
    errs = []

    def run(r):
        try:
            fn(r)
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    return errs


def test_rendezvous_barrier_and_reduce(tmp_path):
    """All ranks meet at the barrier; the host all-reduce folds in rank
    order (deterministic, bit-identical everywhere)."""
    root = str(tmp_path)
    out = {}

    def worker(r):
        rdzv = GangRendezvous(root, world_size=3, rank=r)
        rdzv.announce()
        rdzv.barrier("start")
        total = rdzv.all_reduce(0, np.full((2,), float(r + 1)))
        mean = rdzv.all_reduce(1, float(r), op="mean")
        out[r] = (total, mean)

    assert _threads(3, worker) == []
    for r in range(3):
        np.testing.assert_array_equal(out[r][0], np.full((2,), 6.0))
        assert out[r][1] == pytest.approx(1.0)
    rdzv = GangRendezvous(root, 3, 0)
    assert rdzv.member(0, 1)["pid"] == os.getpid()


def test_barrier_aborts_with_elastic_restart_on_recovery(tmp_path):
    """Survivors parked at a barrier leave via ElasticRestart the moment
    the driver posts the recovery record."""
    root = str(tmp_path)
    rdzv0 = GangRendezvous(root, world_size=2, rank=0)
    caught = []

    def survivor(_):
        try:
            rdzv0.barrier(3, timeout_s=20.0)
        except ElasticRestart as e:
            caught.append(e)

    t = threading.Thread(target=survivor, args=(0,))
    t.start()
    time.sleep(0.1)      # park first
    GangRendezvous(root, 2, -1).post_recovery(1, dead_rank=1, exit_code=-9)
    t.join(timeout=5)
    assert not t.is_alive()
    assert caught and caught[0].generation == 1
    assert caught[0].record["dead_rank"] == 1
    assert caught[0].step == 3
    rdzv0.advance(caught[0].generation)
    assert rdzv0.recovery_pending() is None
    assert os.environ.pop("DDW_ELASTIC_GEN") == "1"


def test_reduce_aborts_and_regenerations_do_not_mix(tmp_path):
    """A reduce parked under a dead peer aborts; contributions of the old
    generation are invisible to the re-formed gang."""
    root = str(tmp_path)
    r0 = GangRendezvous(root, world_size=2, rank=0)
    with pytest.raises(ElasticRestart):
        threading.Timer(
            0.1, lambda: GangRendezvous(root, 2, -1).post_recovery(
                1, dead_rank=1)).start()
        r0.all_reduce(5, 1.0, timeout_s=20.0)
    out = {}

    def worker(r):
        rdzv = GangRendezvous(root, 2, r, generation=1)
        out[r] = float(rdzv.all_reduce(5, float(10 + r)))

    assert _threads(2, worker) == []
    assert out[0] == out[1] == 21.0


def test_maybe_elastic_restart_hook(tmp_path, monkeypatch):
    """The trainers' chain-boundary hook: free no-op outside elastic mode,
    raises once a newer recovery record exists."""
    from ddw_tpu_torch.runtime import elastic

    elastic.reset_context()
    elastic.maybe_elastic_restart(step=0)          # no env: no-op
    monkeypatch.setenv("DDW_RENDEZVOUS_DIR", str(tmp_path))
    monkeypatch.setenv("DDW_NUM_PROCESSES", "2")
    monkeypatch.setenv("DDW_PROCESS_ID", "0")
    elastic.reset_context()
    elastic.maybe_elastic_restart(step=1)          # no record yet: no-op
    GangRendezvous(str(tmp_path), 2, -1).post_recovery(1, dead_rank=1)
    with pytest.raises(ElasticRestart) as exc:
        elastic.maybe_elastic_restart(step=7)
    assert exc.value.generation == 1 and exc.value.step == 7
    elastic.reset_context()


def test_fault_spec_egen_and_new_kinds():
    from ddw_tpu_torch.runtime.faults import parse_fault

    spec = parse_fault("kill:rank=1:step=3")
    assert spec.kind == "kill" and spec.site == "step"
    assert spec.matches("step", step=3, rank=1, gen=0, egen=0, attempt=0)
    assert not spec.matches("step", step=3, rank=1, gen=0, egen=1, attempt=0)
    chase = parse_fault("kill:rank=1:step=3:egen=*")
    assert chase.matches("step", step=3, rank=1, gen=0, egen=2, attempt=0)
    assert not chase.matches("step", step=3, rank=1, gen=1, egen=0,
                             attempt=0)
    torn = parse_fault("ckpt_async_torn:step=4")
    assert torn.site == "ckpt_async"
    assert torn.matches("ckpt_async", step=4, rank=0, gen=0, egen=0,
                        attempt=0)
    assert not torn.matches("step", step=4, rank=0, gen=0, egen=0, attempt=0)


def test_topology_follows_the_elastic_context(tmp_path, monkeypatch):
    """The one topology query: without a process group, the elastic
    context's (rank, world) — remapped by an adopted shrink — and the
    checkpoint writer is the rank whose env id is 0; the process group's
    world (what a collective spans) stays one."""
    from ddw_tpu_torch.checkpoint import ckpt
    from ddw_tpu_torch.runtime import dist, elastic

    monkeypatch.setenv("DDW_RENDEZVOUS_DIR", str(tmp_path))
    monkeypatch.setenv("DDW_NUM_PROCESSES", "3")
    monkeypatch.setenv("DDW_PROCESS_ID", "2")
    elastic.reset_context()
    try:
        assert dist.process_topology() == (2, 3)
        assert dist.group_topology() == (0, 1)
        assert not ckpt._is_writer()
        GangRendezvous(str(tmp_path), 3, -1).post_shrink(
            1, dead_rank=0, assignment={1: 0, 2: 1}, world_size=2)
        elastic.context().advance(1)
        assert dist.process_topology() == (1, 2)
        monkeypatch.setenv("DDW_PROCESS_ID", "0")
        assert ckpt._is_writer()
    finally:
        elastic.reset_context()
        _pop_topology_env()


# -- cross-package: one control directory, two packages ---------------------

def test_rendezvous_interoperates_with_ddw_tpu(tmp_path):
    """A ddw_tpu rank and a port rank share one control directory: they
    meet at one barrier, the host all-reduce over the mixed members is
    bit-equal on both sides (and to the float64 fold in rank order), and
    records, votes and commits posted by either package are read by the
    other."""
    from ddw_tpu.runtime import elastic as jel

    root = str(tmp_path)
    rng = np.random.RandomState(0)
    parts = [rng.standard_normal((3, 5)) * 10 ** rng.uniform(-3, 3, (3, 5))
             for _ in range(3)]
    classes = [jel.GangRendezvous, GangRendezvous, jel.GangRendezvous]
    out = {}

    def worker(r):
        rdzv = classes[r](root, world_size=3, rank=r)
        rdzv.announce()
        rdzv.barrier("start", timeout_s=20.0)
        out[r] = rdzv.all_reduce(0, parts[r], timeout_s=20.0)

    assert _threads(3, worker) == []
    want = (parts[0] + parts[1]) + parts[2]
    for r in range(3):
        assert out[r].dtype == np.float64
        assert out[r].tobytes() == want.tobytes()
    assert GangRendezvous(root, 3, 0).member(0, 0)["pid"] == os.getpid()
    assert jel.GangRendezvous(root, 3, 0).member(0, 1)["rank"] == 1

    try:
        # a ddw_tpu driver proposes a shrink; the port's survivor votes on
        # it; the ddw_tpu driver reads the vote and commits; the port adopts
        jdriver = jel.GangRendezvous(root, 3, -1)
        jdriver.post_shrink(1, dead_rank=2, assignment={0: 0, 1: 1},
                            world_size=2, exit_code=85,
                            coordinator="127.0.0.1:1234")
        port1 = GangRendezvous(root, world_size=3, rank=1)
        assert port1.recovery_pending()["kind"] == "shrink"
        port1._check_recovery(0)                  # ack, keeps parking
        jel0 = jel.GangRendezvous(root, world_size=3, rank=0)
        jel0._check_recovery(0)
        assert jdriver.wait_votes(1, [0, 1], timeout_s=5.0) == {
            0: "ack", 1: "ack"}
        jdriver.commit_recovery(1)
        assert port1.recovery_committed(1)
        with pytest.raises(ElasticRestart):
            port1._check_recovery(4)
        port1.advance(1)
        assert (port1.rank, port1.world_size) == (1, 2)
        assert port1.coordinator_for(1) == "127.0.0.1:1234"
        # and the other way: a port driver's grow, read by ddw_tpu
        GangRendezvous(root, 2, -1).post_grow(2, current_ranks=[0, 1],
                                              world_size=3)
        jrec = jel.GangRendezvous(root, 2, 0, generation=1)
        assert jrec.recovery_pending()["kind"] == "grow"
        assert jrec.record_for(2) == GangRendezvous(root, 2, 0).record_for(2)
    finally:
        _pop_topology_env()


def test_host_all_reduce_mixed_members_bit_equal(tmp_path, monkeypatch):
    """The module-level host_all_reduce of each package (the port's through
    runtime.collectives) over one gang of two ddw_tpu and two port ranks:
    sum and mean bit-equal everywhere; outside elastic mode both are the
    identity."""
    from ddw_tpu.runtime import elastic as jel

    from ddw_tpu_torch.runtime import collectives

    monkeypatch.delenv("DDW_RENDEZVOUS_DIR", raising=False)
    jel.reset_context()
    x = np.arange(6.0).reshape(2, 3) / 7.0
    np.testing.assert_array_equal(collectives.host_all_reduce(0, x),
                                  jel.host_all_reduce(0, x))
    root = str(tmp_path)
    rng = np.random.RandomState(1)
    vals = [rng.standard_normal(17).astype(np.float32) for _ in range(4)]
    ranks = [jel.GangRendezvous(root, 4, 0), GangRendezvous(root, 4, 1),
             jel.GangRendezvous(root, 4, 2), GangRendezvous(root, 4, 3)]
    out = {}

    def worker(r):
        out[r] = (ranks[r].all_reduce("s", vals[r], timeout_s=20.0),
                  ranks[r].all_reduce("m", vals[r], op="mean",
                                      timeout_s=20.0))

    assert _threads(4, worker) == []
    for r in range(1, 4):
        assert out[r][0].tobytes() == out[0][0].tobytes()
        assert out[r][1].tobytes() == out[0][1].tobytes()
    assert out[0][0].dtype == np.float32      # the contribution's float type


# -- real-process drills ------------------------------------------------------

def _elastic_worker(ckpt_dir: str, total_steps: int) -> dict:
    """The elastic supervised-worker contract: explicit-topology gang (the
    launcher's elastic mode keeps the ranks outside a process group),
    checkpoint via the rank-0 writer, per-step fault hook + chain-boundary
    park hook, host all-reduce as the per-step gang data barrier."""
    import os

    import numpy as np

    from ddw_tpu_torch.checkpoint.ckpt import CheckpointManager
    from ddw_tpu_torch.runtime import elastic
    from ddw_tpu_torch.runtime.faults import maybe_fault

    mgr = CheckpointManager(ckpt_dir)
    state = {"w": np.zeros((4,), np.float32), "step": np.asarray(0, np.int32)}
    start = 0
    if mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        start = int(start)
    elastic.elastic_barrier("start")
    for step in range(start, total_steps):
        maybe_fault("step", step=step, ckpt_dir=ckpt_dir)
        elastic.maybe_elastic_restart(step=step)
        total = elastic.host_all_reduce(step, np.ones(()))  # gang barrier
        state = {"w": state["w"] + float(total),
                 "step": np.asarray(step + 1, np.int32)}
        mgr.save(state, step + 1)      # env-guarded rank-0 writer
    mgr.close()
    ctx = elastic.context()
    return {"final_step": int(state["step"]), "resume_step": start,
            "w": float(state["w"][0]), "pid": os.getpid(),
            "egen": ctx.generation if ctx is not None else 0}


def _gang(tmp_path, elastic_restarts=1, timeout_s=120, **kw):
    return Launcher(np=2, devices_per_proc=1, timeout_s=timeout_s,
                    elastic_restarts=elastic_restarts,
                    rendezvous_dir=str(tmp_path / "rdzv"), **kw)


@pytest.mark.faults
def test_elastic_single_rank_respawn(tmp_path, monkeypatch,
                                     worker_pythonpath):
    """Kill exactly one rank mid-epoch: only that rank is respawned (the
    survivor's pid is identical across generations), the run resumes from
    the latest durable checkpoint, and the forensics land in the
    supervisor's attempt record tagged elastic."""
    baseline = Launcher(np=-1).run(functools.partial(
        _elastic_worker, str(tmp_path / "base"), TOTAL_STEPS))
    assert baseline["final_step"] == TOTAL_STEPS

    monkeypatch.setenv("DDW_FAULT", "kill:rank=1:step=3")
    launcher = _gang(tmp_path)
    sup = GangSupervisor(launcher, max_restarts=0, backoff_base_s=0.05,
                         jitter=0.0)
    out = sup.run(functools.partial(_elastic_worker, str(tmp_path / "ck"),
                                    TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 3
    assert out["w"] == TOTAL_STEPS * 2
    assert out["egen"] == 1

    assert len(launcher.elastic_events) == 1
    ev = launcher.elastic_events[0]
    assert ev.dead_rank == 1 and ev.generation == 1
    assert ev.exit_signal == 9                      # SIGKILL forensics
    rdzv = GangRendezvous(launcher.last_rendezvous_dir, 2, -1)
    assert rdzv.member(0, 0)["pid"] == rdzv.member(1, 0)["pid"]
    assert rdzv.member(0, 1)["pid"] != rdzv.member(1, 1)["pid"]
    assert rdzv.member(1, 1)["pid"] == ev.respawn_pid
    assert out["pid"] == rdzv.member(1, 0)["pid"]

    assert [a.recovery for a in sup.attempts] == ["elastic"]
    assert sup.attempts[0].dead_rank == 1
    assert sup.attempts[0].exit_signal == 9
    assert sup.attempts[0].kind == "rank-death"


@pytest.mark.faults
@pytest.mark.slow   # three gang launches of real processes — tier-2 drill
def test_elastic_budget_exhausted_falls_back_to_whole_world(
        tmp_path, monkeypatch, worker_pythonpath):
    """egen=* re-kills the respawned rank, the elastic budget (1) exhausts,
    the launcher kills the gang and the supervisor's whole-world restart
    completes the run."""
    monkeypatch.setenv("DDW_FAULT", "kill:rank=1:step=3:egen=*")
    launcher = _gang(tmp_path, elastic_restarts=1)
    sup = GangSupervisor(launcher, max_restarts=1, backoff_base_s=0.05,
                         jitter=0.0)
    out = sup.run(functools.partial(_elastic_worker, str(tmp_path / "ck"),
                                    TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 3
    assert out["w"] == TOTAL_STEPS * 2
    kinds = [(a.kind, a.recovery) for a in sup.attempts]
    assert ("rank-death", "elastic") in kinds
    assert ("crash", "whole-world") in kinds


@pytest.mark.faults
@pytest.mark.slow
def test_elastic_exhausts_into_gangfailure(tmp_path, monkeypatch,
                                           worker_pythonpath):
    """Elastic budget out AND whole-world budget out -> GangFailure with
    both the elastic events and the gang attempts in the record."""
    monkeypatch.setenv("DDW_FAULT", "kill:rank=1:step=3:egen=*:gen=*")
    sup = GangSupervisor(_gang(tmp_path, elastic_restarts=1),
                         max_restarts=0, backoff_base_s=0.05, jitter=0.0)
    with pytest.raises(GangFailure) as exc:
        sup.run(functools.partial(_elastic_worker, str(tmp_path / "ck"),
                                  TOTAL_STEPS))
    recs = [a.recovery for a in exc.value.attempts]
    assert "elastic" in recs and "whole-world" in recs


# -- torn ASYNC checkpoint: quarantined across generations -------------------

def _async_ckpt_worker(ckpt_dir: str, total_steps: int,
                       sharded: bool = False) -> dict:
    """Supervised worker writing checkpoints through the ASYNC writer
    (bounded in-flight depth 2). DDW_FAULT=ckpt_async_torn fires on the
    background writer thread mid-write. The sharded format checkpoints a
    TrainState (a one-layer LM whose every weight steps by 1.0)."""
    import numpy as np

    if sharded:
        import torch

        from ddw_tpu_torch.checkpoint.sharded import ShardedCheckpointManager
        from ddw_tpu_torch.models.lm import build_lm
        from ddw_tpu_torch.train.step import Optimizer, TrainState
        from ddw_tpu_torch.utils.config import LMCfg

        model = build_lm(LMCfg(vocab_size=8, max_len=4, hidden=4, depth=1,
                               num_heads=1, mlp_dim=8, dtype="float32"))
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        tx = Optimizer("sgd", 0.1)
        state = TrainState(model, tx.init(dict(model.named_parameters())), 0)
        mgr = ShardedCheckpointManager(ckpt_dir, async_write=True,
                                       max_inflight=2)
        start = 0
        if mgr.latest_step() is not None:
            state, start = mgr.restore(state)
            start = int(start)
        for step in range(start, total_steps):
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
            state.step = step + 1
            mgr.save(state, step + 1)
        mgr.close()
        return {"final_step": int(state.step), "resume_step": start}
    from ddw_tpu_torch.checkpoint.ckpt import CheckpointManager

    mgr = CheckpointManager(ckpt_dir, async_write=True, max_inflight=2)
    state = {"w": np.zeros((4,), np.float32), "step": np.asarray(0, np.int32)}
    start = 0
    if mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        start = int(start)
    for step in range(start, total_steps):
        state = {"w": state["w"] + 1.0,
                 "step": np.asarray(step + 1, np.int32)}
        mgr.save(state, step + 1)
    mgr.close()
    return {"final_step": int(state["step"]), "resume_step": start}


@pytest.mark.faults
def test_torn_async_write_quarantined_across_generations(
        tmp_path, monkeypatch, worker_pythonpath):
    """The writer process dies mid-async-write of step 3 leaving a torn
    dir; the restarted generation quarantines it and resumes from step 2."""
    ckpt_dir = str(tmp_path / "ck")
    monkeypatch.setenv("DDW_FAULT", "ckpt_async_torn:rank=0:step=3")
    sup = GangSupervisor(Launcher(np=1, devices_per_proc=1, timeout_s=120),
                         max_restarts=1, backoff_base_s=0.05, jitter=0.0)
    out = sup.run(functools.partial(_async_ckpt_worker, ckpt_dir,
                                    TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 2
    names = os.listdir(ckpt_dir)
    assert any(n.startswith("step_0000000003.torn") for n in names)
    assert "step_0000000003" not in [n for n in names if "." not in n]


@pytest.mark.faults
@pytest.mark.slow
def test_torn_async_sharded_write_quarantined(tmp_path, monkeypatch,
                                              worker_pythonpath):
    """The sharded-format twin of the torn-async drill."""
    ckpt_dir = str(tmp_path / "ck")
    monkeypatch.setenv("DDW_FAULT", "ckpt_async_torn:rank=0:step=3")
    sup = GangSupervisor(Launcher(np=1, devices_per_proc=1, timeout_s=120),
                         max_restarts=1, backoff_base_s=0.05, jitter=0.0)
    out = sup.run(functools.partial(_async_ckpt_worker, ckpt_dir,
                                    TOTAL_STEPS, True))
    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 2
    assert any(n.startswith("step_0000000003.torn")
               for n in os.listdir(ckpt_dir))


# -- shrink recovery: N-1 elastic reshard ------------------------------------

def _pop_topology_env():
    """advance() on a shrink/grow record mirrors the remapped identity into
    the process env; threaded fakes share this process's env."""
    for k in ("DDW_ELASTIC_GEN", "DDW_PROCESS_ID", "DDW_NUM_PROCESSES"):
        os.environ.pop(k, None)


def test_shrink_two_phase_vote_then_commit(tmp_path):
    """Survivors vote on a shrink proposal but adopt nothing until the
    driver's commit marker lands."""
    root = str(tmp_path)
    r0 = GangRendezvous(root, world_size=3, rank=0)
    r1 = GangRendezvous(root, world_size=3, rank=1)
    driver = GangRendezvous(root, 3, -1)
    try:
        driver.post_shrink(1, dead_rank=2, assignment={0: 0, 1: 1},
                           world_size=2, exit_code=85)
        r0._check_recovery(0)
        assert driver.read_votes(1) == {0: "ack"}
        assert r0.generation == 0
        r1._check_recovery(0)
        votes = driver.wait_votes(1, [0, 1], timeout_s=5.0)
        assert votes == {0: "ack", 1: "ack"}
        driver.commit_recovery(1)
        with pytest.raises(ElasticRestart) as exc:
            r0._check_recovery(7)
        assert exc.value.generation == 1 and exc.value.step == 7
        r0.advance(1)
        assert (r0.rank, r0.world_size) == (0, 2)
        with pytest.raises(ElasticRestart):
            r1._check_recovery(None)
        r1.advance(1)
        assert (r1.rank, r1.world_size) == (1, 2)
        assert os.environ["DDW_NUM_PROCESSES"] == "2"
    finally:
        _pop_topology_env()


def test_shrink_remap_and_evicted_zombie(tmp_path):
    """A non-identity assignment renumbers survivors contiguously; the
    evicted rank cannot adopt the record."""
    root = str(tmp_path)
    driver = GangRendezvous(root, 3, -1)
    try:
        driver.post_shrink(1, dead_rank=0, assignment={1: 0, 2: 1},
                           world_size=2, exit_code=85)
        driver.commit_recovery(1)
        r2 = GangRendezvous(root, world_size=3, rank=2)
        with pytest.raises(ElasticRestart):
            r2._check_recovery(4)
        r2.advance(1)
        assert (r2.rank, r2.world_size) == (1, 2)
        zombie = GangRendezvous(root, world_size=3, rank=0)
        with pytest.raises(ElasticRestart) as exc:
            zombie._check_recovery(4)
        with pytest.raises(RuntimeError, match="evicted"):
            zombie.advance(exc.value.generation)
    finally:
        _pop_topology_env()


def test_shrink_veto_pins_until_retry_supersedes(tmp_path, monkeypatch):
    """shrink_veto vetoes exactly the first proposal this process votes on;
    the vetoer stays pinned until the driver's retry, which it acks."""
    monkeypatch.setenv("DDW_FAULT", "shrink_veto")
    root = str(tmp_path)
    r0 = GangRendezvous(root, world_size=2, rank=0)
    driver = GangRendezvous(root, 2, -1)
    try:
        driver.post_shrink(1, dead_rank=1, assignment={0: 0}, world_size=1)
        r0._check_recovery(3)
        assert driver.read_votes(1) == {0: "veto"}
        driver.commit_recovery(1)
        r0._check_recovery(3)
        assert r0.generation == 0
        driver.post_shrink(2, dead_rank=1, assignment={0: 0}, world_size=1)
        r0._check_recovery(3)
        assert driver.read_votes(2) == {0: "ack"}
        driver.commit_recovery(2)
        with pytest.raises(ElasticRestart) as exc:
            r0._check_recovery(3)
        assert exc.value.generation == 2
        r0.advance(2)
        assert (r0.rank, r0.world_size) == (0, 1)
    finally:
        _pop_topology_env()


def test_shrink_vote_timeout_returns_none(tmp_path):
    driver = GangRendezvous(str(tmp_path), 2, -1)
    driver.post_shrink(1, dead_rank=1, assignment={0: 0}, world_size=1)
    assert driver.wait_votes(1, [0], timeout_s=0.3) is None
    assert not driver.recovery_committed(1)


def test_reduce_membership_follows_shrunken_world(tmp_path):
    """Barrier/reduce scans use the adopted world size: a survivor gang at
    world-1 never waits on the evicted rank's part file."""
    root = str(tmp_path)
    driver = GangRendezvous(root, 3, -1)
    driver.post_shrink(1, dead_rank=0, assignment={1: 0, 2: 1},
                       world_size=2, exit_code=85)
    driver.commit_recovery(1)
    out = {}

    def survivor(i):
        rdzv = GangRendezvous(root, world_size=3, rank=i + 1)
        with pytest.raises(ElasticRestart):
            rdzv.all_reduce(5, 99.0, timeout_s=20.0)
        rdzv.advance(1)
        assert (rdzv.rank, rdzv.world_size) == (i, 2)
        rdzv.announce()
        rdzv.barrier("start", timeout_s=20.0)
        out[rdzv.rank] = float(rdzv.all_reduce(5, float(rdzv.rank + 1),
                                               timeout_s=20.0))

    try:
        assert _threads(2, survivor) == []
    finally:
        _pop_topology_env()
    assert out == {0: 3.0, 1: 3.0}


def test_fault_spec_host_lost_and_shrink_veto():
    from ddw_tpu_torch.runtime.faults import EXIT_HOST_LOST, parse_fault

    assert EXIT_HOST_LOST == 85
    spec = parse_fault("host_lost:rank=2:step=3")
    assert spec.kind == "host_lost" and spec.site == "step"
    assert spec.matches("step", step=3, rank=2, gen=0, egen=0, attempt=0)
    assert spec.matches("step", step=3, rank=2, gen=0, egen=4, attempt=0)
    assert not spec.matches("step", step=3, rank=1, gen=0, egen=0, attempt=0)
    veto = parse_fault("shrink_veto:rank=0")
    assert veto.site == "shrink_vote"
    assert veto.matches("shrink_vote", step=0, rank=0, gen=0, egen=0,
                        attempt=0)
    assert not veto.matches("shrink_vote", step=1, rank=0, gen=0, egen=0,
                            attempt=0)
    always = parse_fault("shrink_veto:rank=0:step=*")
    assert always.matches("shrink_vote", step=5, rank=0, gen=0, egen=0,
                          attempt=0)


def test_fault_multi_spec_chain(monkeypatch):
    from ddw_tpu_torch.runtime.faults import active_faults

    monkeypatch.setenv("DDW_FAULT",
                       "host_lost:rank=2:step=3;shrink_veto:rank=0")
    specs = active_faults()
    assert [s.kind for s in specs] == ["host_lost", "shrink_veto"]
    assert specs[0].site == "step" and specs[1].site == "shrink_vote"


# -- real-process shrink drills ----------------------------------------------

N_SAMPLES = 8


def _shrink_worker(ckpt_dir: str, total_steps: int) -> dict:
    """Shrink-drill worker: each step's gang contribution is a coverage
    vector over N_SAMPLES virtual samples partitioned by
    ShardedLoader.shard_plan at the CURRENT (rank, world); the update is
    world-independent, so the final params must be bit-identical to any
    uninterrupted run's."""
    import os

    import numpy as np

    from ddw_tpu_torch.checkpoint.ckpt import CheckpointManager
    from ddw_tpu_torch.data.loader import ShardedLoader
    from ddw_tpu_torch.runtime import elastic
    from ddw_tpu_torch.runtime.faults import maybe_fault

    mgr = CheckpointManager(ckpt_dir, keep=total_steps + 2)
    state = {"w": np.zeros((N_SAMPLES,), np.float32),
             "step": np.asarray(0, np.int32)}
    start = 0
    if mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        start = int(start)
    elastic.elastic_barrier("start")
    coverage_ok = True
    for step in range(start, total_steps):
        maybe_fault("step", step=step, ckpt_dir=ckpt_dir)
        elastic.maybe_elastic_restart(step=step)
        rank, world = elastic.process_topology()
        contrib = np.zeros((N_SAMPLES + 1,), np.float64)
        contrib[0] = 1.0
        for i in ShardedLoader.shard_plan(N_SAMPLES, world)[rank]:
            contrib[i + 1] = float(i + 1)
        tot = elastic.host_all_reduce(step, contrib)
        coverage_ok = (coverage_ok and tot[0] == world
                       and bool(np.array_equal(
                           tot[1:], np.arange(1., N_SAMPLES + 1.))))
        state = {"w": state["w"] + tot[1:].astype(np.float32),
                 "step": np.asarray(step + 1, np.int32)}
        mgr.save(state, step + 1)
    mgr.close()
    ctx = elastic.context()
    rank, world = elastic.process_topology()
    return {"final_step": int(state["step"]), "resume_step": start,
            "w": [float(x) for x in state["w"]], "pid": os.getpid(),
            "egen": ctx.generation if ctx is not None else 0,
            "world": world, "coverage_ok": bool(coverage_ok)}


def _shrink_gang(tmp_path, np_=3, **kw):
    kw.setdefault("elastic_restarts", 1)
    kw.setdefault("min_world_size", 2)
    return Launcher(np=np_, devices_per_proc=1, timeout_s=120,
                    rendezvous_dir=str(tmp_path / "rdzv"), **kw)


@pytest.mark.faults
def test_shrink_recovery_on_host_lost(tmp_path, monkeypatch,
                                      worker_pythonpath):
    """Rank 2 of 3 dies permanently (host_lost) mid-epoch: the survivors
    vote, shrink to world 2, keep their pids, cover every sample exactly
    once at the new size, and finish with params bit-identical to an
    uninterrupted 2-rank run restored from the same checkpoint; the
    forensics and the tracker carry the shrink."""
    import shutil

    from ddw_tpu_torch.tracking.tracker import Tracker

    ckpt = str(tmp_path / "ck")
    monkeypatch.setenv("DDW_FAULT", "host_lost:rank=2:step=3")
    launcher = _shrink_gang(tmp_path)
    run = Tracker(str(tmp_path / "mlruns"), "gang").start_run("shrink")
    sup = GangSupervisor(launcher, max_restarts=0, backoff_base_s=0.05,
                         jitter=0.0, tracker_run=run)
    out = sup.run(functools.partial(_shrink_worker, ckpt, TOTAL_STEPS))
    run.end()

    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 3
    assert out["world"] == 2 and out["egen"] == 1
    assert out["coverage_ok"] is True
    assert out["w"] == [TOTAL_STEPS * float(i) for i in
                        range(1, N_SAMPLES + 1)]

    assert [e.kind for e in launcher.elastic_events] == ["shrink"]
    ev = launcher.elastic_events[0]
    assert ev.dead_rank == 2 and ev.exit_code == 85
    assert ev.respawn_pid is None
    assert (ev.old_world, ev.new_world) == (3, 2)

    rdzv = GangRendezvous(launcher.last_rendezvous_dir, 2, -1)
    for r in (0, 1):
        assert rdzv.member(1, r)["pid"] == rdzv.member(0, r)["pid"]
    assert rdzv.member(1, 2) is None
    assert out["pid"] == rdzv.member(1, 0)["pid"]

    assert [a.recovery for a in sup.attempts] == ["shrink"]
    a = sup.attempts[0]
    assert a.dead_rank == 2 and a.kind == "rank-death"
    assert (a.old_world_size, a.new_world_size) == (3, 2)
    assert run.final_metrics()["supervisor.shrink_recoveries"] == 1.0
    assert [v for _, v in run.metric_history("gang.world_size")] == [3.0, 2.0]

    ref_ckpt = str(tmp_path / "ref_ck")
    os.makedirs(ref_ckpt)
    shutil.copytree(os.path.join(ckpt, "step_0000000003"),
                    os.path.join(ref_ckpt, "step_0000000003"))
    monkeypatch.delenv("DDW_FAULT")
    ref = GangSupervisor(
        Launcher(np=2, devices_per_proc=1, timeout_s=120, elastic_restarts=1,
                 rendezvous_dir=str(tmp_path / "rdzv_ref")),
        max_restarts=0, backoff_base_s=0.05, jitter=0.0,
    ).run(functools.partial(_shrink_worker, ref_ckpt, TOTAL_STEPS))
    assert ref["resume_step"] == 3 and ref["coverage_ok"] is True
    assert ref["w"] == out["w"]


@pytest.mark.faults
@pytest.mark.slow   # two extra real-process gang drills — tier-2 budget
def test_shrink_veto_retry_then_adopt(tmp_path, monkeypatch,
                                      worker_pythonpath):
    """A survivor vetoes the first shrink proposal; the retry at a bumped
    generation is acked and the run completes at world 2 (generation 2)."""
    monkeypatch.setenv("DDW_FAULT",
                       "host_lost:rank=2:step=3;shrink_veto:rank=0")
    launcher = _shrink_gang(tmp_path)
    sup = GangSupervisor(launcher, max_restarts=0, backoff_base_s=0.05,
                         jitter=0.0)
    out = sup.run(functools.partial(_shrink_worker, str(tmp_path / "ck"),
                                    TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["world"] == 2 and out["coverage_ok"] is True
    assert [e.kind for e in launcher.elastic_events] == ["shrink"]
    assert launcher.elastic_events[0].generation == 2
    assert out["egen"] == 2


@pytest.mark.faults
@pytest.mark.slow
def test_shrink_always_vetoed_falls_back_to_whole_world(
        tmp_path, monkeypatch, worker_pythonpath):
    """A survivor that vetoes every proposal exhausts the shrink retries:
    the supervisor's whole-world restart completes the run at full world."""
    monkeypatch.setenv("DDW_FAULT",
                       "host_lost:rank=2:step=3;shrink_veto:rank=0:step=*")
    launcher = _shrink_gang(tmp_path)
    sup = GangSupervisor(launcher, max_restarts=1, backoff_base_s=0.05,
                         jitter=0.0)
    out = sup.run(functools.partial(_shrink_worker, str(tmp_path / "ck"),
                                    TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 3
    assert out["world"] == 3
    assert not any(e.kind == "shrink" for e in launcher.elastic_events)
    assert ("crash", "whole-world") in [(a.kind, a.recovery)
                                        for a in sup.attempts]


@pytest.mark.faults
@pytest.mark.slow
def test_shrink_below_min_world_falls_back_to_whole_world(
        tmp_path, monkeypatch, worker_pythonpath):
    """min_world_size is the floor: a loss that would shrink below it goes
    straight to the whole-world rung."""
    monkeypatch.setenv("DDW_FAULT", "host_lost:rank=1:step=3")
    launcher = _shrink_gang(tmp_path, np_=2)
    sup = GangSupervisor(launcher, max_restarts=1, backoff_base_s=0.05,
                         jitter=0.0)
    out = sup.run(functools.partial(_shrink_worker, str(tmp_path / "ck"),
                                    TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["world"] == 2
    assert launcher.elastic_events == []
    assert ("crash", "whole-world") in [(a.kind, a.recovery)
                                        for a in sup.attempts]


@pytest.mark.faults
@pytest.mark.slow
def test_gang_drill_cli_smoke(tmp_path):
    """tools/torch_gang_drill.py in its smoke mode, as a subprocess: exit 0
    with a one-line JSON verdict covering shrink, regrow and bit-identity
    with an uninterrupted run."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DDW_DRILL_SMOKE="1")
    env.pop("DDW_FAULT", None)          # the drill arms its own fault
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "torch_gang_drill.py"),
         "--out", str(tmp_path / "drill")],
        capture_output=True, text=True, env=env, cwd=repo, timeout=900)
    assert out.returncode == 0, f"drill failed:\n{out.stdout}\n{out.stderr}"
    d = json.loads(out.stdout.strip().splitlines()[-1])
    assert d["verdict"] == "ok" and d["bit_identical"] is True
    kinds = [e["kind"] for e in d["events"]]
    assert "shrink" in kinds and "grow" in kinds
    assert d["drill"]["coverage_ok"] and d["reference"]["coverage_ok"]
