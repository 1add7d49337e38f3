"""The port's launcher (``ddw_tpu_torch.runtime.launcher``, the
HorovodRunner role): ``np=-1`` local mode and real multi-process gangs, case
for case with ``tests/test_launcher.py``. A rank is one process on one
device joined by gloo, so the world report's device count is the rank
count; ``devices_per_proc`` other than 1 raises. The ranks import this
module to find their functions: nothing of JAX at the top."""

import functools
import os
import pickle

import pytest

from ddw_tpu_torch.runtime.launcher import GangError, Launcher


def _world_report(scale: float = 1.0):
    """Runs inside each worker: an all-reduce over every rank of the
    group."""
    import torch
    import torch.distributed as dist

    from ddw_tpu_torch.runtime.dist import group_topology

    rank, world = group_topology()
    total = torch.full((1,), float(scale))
    if world > 1:
        dist.all_reduce(total)
    return {"processes": world, "process_index": rank,
            "global_devices": world, "psum": float(total[0]),
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "jax_platforms": os.environ.get("JAX_PLATFORMS")}


def _report(out):
    return {k: out[k] for k in ("processes", "process_index",
                                "global_devices", "psum")}


def test_local_mode_runs_in_process():
    out = Launcher(np=-1).run(_world_report, scale=2.0)
    assert out["process_index"] == 0
    assert out["psum"] == pytest.approx(2.0 * out["global_devices"])


def test_multiprocess_gang_and_rank0_return(worker_pythonpath):
    out = Launcher(np=2, devices_per_proc=1, timeout_s=300).run(
        functools.partial(_world_report, scale=1.0))
    assert _report(out) == {"processes": 2, "process_index": 0,
                            "global_devices": 2, "psum": 2.0}
    # the spawn hides no device: the workers see the driver's environment
    assert out["cuda_visible"] == os.environ.get("CUDA_VISIBLE_DEVICES")
    assert out["jax_platforms"] == os.environ.get("JAX_PLATFORMS")


def test_multiprocess_worker_error_propagates(worker_pythonpath):
    with pytest.raises(RuntimeError, match="crashed|raised"):
        Launcher(np=2, devices_per_proc=1, timeout_s=300).run(_boom)


def test_worker_error_is_structured_gangerror(worker_pythonpath):
    """Crash failures carry machine-readable exit codes + rank-0 traceback
    (what GangSupervisor classifies on), not only a message string."""
    with pytest.raises(GangError) as exc:
        Launcher(np=2, devices_per_proc=1, timeout_s=300).run(_boom)
    assert exc.value.kind == "crash"
    assert len(exc.value.exit_codes) == 2
    assert exc.value.rank0_traceback is not None
    assert "intentional worker failure" in exc.value.rank0_traceback


def _boom():
    raise ValueError("intentional worker failure")


@pytest.mark.faults
def test_coordinator_bind_race_respawns_on_fresh_port(monkeypatch,
                                                      worker_pythonpath):
    """A coordinator that can't bind its probed port (bind_fail, which
    fires only on spawn attempt 0) makes the launcher respawn the whole
    gang on a fresh port."""
    monkeypatch.setenv("DDW_FAULT", "bind_fail:rank=0")
    launcher = Launcher(np=2, devices_per_proc=1, timeout_s=300)
    out = launcher.run(functools.partial(_world_report, scale=1.0))
    assert _report(out) == {"processes": 2, "process_index": 0,
                            "global_devices": 2, "psum": 2.0}
    assert launcher.last_spawn_attempts == 2


@pytest.mark.faults
def test_coordinator_bind_retries_bounded(monkeypatch, worker_pythonpath):
    """attempt=* re-fires the bind failure on every respawn: the launcher
    gives up after spawn_retries with the structured coord-bind error."""
    monkeypatch.setenv("DDW_FAULT", "bind_fail:rank=0:attempt=*")
    launcher = Launcher(np=2, devices_per_proc=1, timeout_s=300,
                        spawn_retries=2)
    with pytest.raises(GangError) as exc:
        launcher.run(_world_report)
    assert exc.value.kind == "coord-bind"
    assert launcher.last_spawn_attempts == 2


def test_result_written_atomically(tmp_path):
    from ddw_tpu_torch.runtime._launch_worker import _write_result

    p = str(tmp_path / "result.pkl")
    _write_result(p, ("ok", {"x": 1}))
    with open(p, "rb") as f:
        assert pickle.load(f) == ("ok", {"x": 1})
    _write_result(p, ("error", "tb"))
    with open(p, "rb") as f:
        assert pickle.load(f)[0] == "error"
    assert os.listdir(tmp_path) == ["result.pkl"]


def test_unpicklable_result_degrades_to_error(tmp_path):
    from ddw_tpu_torch.runtime._launch_worker import _write_result

    p = str(tmp_path / "result.pkl")
    _write_result(p, ("ok", lambda: None))
    with open(p, "rb") as f:
        status, value = pickle.load(f)
    assert status == "error" and "not picklable" in value


def test_devices_per_proc_other_than_one_raises():
    with pytest.raises(ValueError, match="devices_per_proc=2"):
        Launcher(np=2, devices_per_proc=2)


def test_public_names_and_defaults_equal_ddw_tpu():
    """The port keeps ddw_tpu's public names, signatures and defaults
    (runtime/__init__, the Launcher, GangError, ElasticEvent), and the
    bind-failure test of the worker classifies the same texts."""
    import dataclasses
    import inspect

    import ddw_tpu.runtime as jrt
    from ddw_tpu.runtime import _launch_worker as jworker
    from ddw_tpu.runtime import launcher as jlauncher

    import ddw_tpu_torch.runtime as trt
    from ddw_tpu_torch.runtime import _launch_worker as tworker
    from ddw_tpu_torch.runtime import launcher as tlauncher

    for name in ("ElasticEvent", "GangError", "Launcher", "ElasticRestart",
                 "GangRendezvous", "elastic_barrier", "elastic_enabled",
                 "host_all_reduce", "maybe_elastic_restart", "FaultInjected",
                 "Preempted", "install_preemption_handler", "maybe_fault",
                 "preemption_requested", "request_preemption",
                 "reset_preemption", "AttemptReport", "GangFailure",
                 "GangSupervisor", "restart_generation"):
        assert hasattr(jrt, name) and hasattr(trt, name), name

    def params(fn):
        return [(p.name, p.default) for p in
                inspect.signature(fn).parameters.values()]

    assert params(tlauncher.Launcher.__init__) == params(
        jlauncher.Launcher.__init__)
    assert params(tlauncher.GangError.__init__) == params(
        jlauncher.GangError.__init__)
    assert [f.name for f in dataclasses.fields(tlauncher.ElasticEvent)] == [
        f.name for f in dataclasses.fields(jlauncher.ElasticEvent)]
    for text in ("OSError: [Errno 98] Address already in use", "fine",
                 "failed to bind to 127.0.0.1", "EADDRINUSE"):
        assert tworker._looks_like_bind_failure(text) == \
            jworker._looks_like_bind_failure(text)
