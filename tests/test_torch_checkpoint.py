"""The port's checkpoint manager (``ddw_tpu_torch.checkpoint.ckpt``): the
cases of ``tests/test_checkpoint.py`` (sync/async equivalence, snapshot
consistency, error surfacing, retention, torn-directory quarantine with
fallback, ``state_bytes``, the async in-flight bound) re-run against the
port, plus the state file's layout: flax-layout weights that
``ddw_tpu``'s serialization reads, optimizer state restored exactly."""

import os
import threading

import numpy as np
import pytest
import torch
from flax import serialization

import ddw_tpu_torch.checkpoint.ckpt as ckpt_mod
from ddw_tpu_torch.checkpoint.ckpt import (BestCheckpointKeeper,
                                           CheckpointManager)
from ddw_tpu_torch.train.step import init_state, make_optimizer
from ddw_tpu_torch.utils.config import TrainCfg


def _state(x: float, moment_dtype: str = "float32"):
    model = torch.nn.Linear(4, 4)
    with torch.no_grad():
        model.weight.fill_(x)
        model.bias.fill_(-x)
    opt = make_optimizer(TrainCfg(optimizer="adam", moment_dtype=moment_dtype))
    state = init_state(model, opt)
    state.step = 7
    return state


def _w(state) -> np.ndarray:
    return state.model.weight.detach().numpy()


def test_async_save_matches_sync(tmp_path):
    s = _state(1.5)
    sync = CheckpointManager(str(tmp_path / "sync"))
    asyn = CheckpointManager(str(tmp_path / "async"), async_write=True)
    sync.save(s, 10, metadata={"epoch": 1})
    asyn.save(s, 10, metadata={"epoch": 1})
    asyn.wait()
    assert sync.latest_step() == asyn.latest_step() == 10
    a, astep = asyn.restore(_state(0.0))
    b, bstep = sync.restore(_state(0.0))
    assert astep == bstep == 10 and a.step == 7
    np.testing.assert_array_equal(_w(a), _w(b))
    assert asyn.read_metadata(10)["epoch"] == 1
    with open(tmp_path / "sync" / "step_0000000010" / "state.msgpack",
              "rb") as f1, \
            open(tmp_path / "async" / "step_0000000010" / "state.msgpack",
                 "rb") as f2:
        assert f1.read() == f2.read()  # byte-identical serialization


def test_async_snapshot_is_consistent(tmp_path):
    """The host snapshot happens inside save(); changing the state after
    must not change the written checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    s = _state(2.0)
    mgr.save(s, 1)
    with torch.no_grad():
        s.model.weight.fill_(-1.0)
    mgr.save(s, 2)
    mgr.wait()
    restored, step = mgr.restore(_state(0.0), step=1)
    assert step == 1
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 2.0,
                                                        np.float32))


def test_async_write_error_surfaces(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "f"), async_write=True)
    mgr.save(_state(1.0), 1)
    mgr.wait()
    # unserializable leaf -> background write fails -> wait() re-raises
    mgr.save({"w": object()}, 2)
    with pytest.raises(Exception):
        mgr.wait()
    mgr.save(_state(3.0), 3)
    mgr.wait()
    assert mgr.latest_step() == 3
    mgr.close()
    assert mgr._executor is None
    mgr.save(_state(4.0), 4)
    assert mgr.latest_step() == 4


def test_retention_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    for i in range(1, 5):
        mgr.save(_state(float(i)), i)
    mgr.wait()
    steps = sorted(int(d[len("step_"):]) for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps == [3, 4]


def _tear(ckpt_dir, step, mode):
    """Corrupt a step dir in one of the ways a non-atomic kill could."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    if mode == "no_meta":
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "state.msgpack"), "wb") as f:
            f.write(b"torn")
    elif mode == "truncated_state":
        with open(os.path.join(d, "state.msgpack"), "r+b") as f:
            f.truncate(8)  # metadata's state_bytes no longer matches
    elif mode == "no_state":
        os.remove(os.path.join(d, "state.msgpack"))
    elif mode == "bad_meta":
        with open(os.path.join(d, "metadata.json"), "w") as f:
            f.write("{not json")


@pytest.mark.faults
@pytest.mark.parametrize("mode", ["no_meta", "truncated_state", "no_state",
                                  "bad_meta"])
def test_torn_latest_step_quarantined_restore_falls_back(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)
    mgr.save(_state(2.0), 2)
    if mode == "no_meta":
        _tear(str(tmp_path), 3, mode)
    else:
        mgr.save(_state(3.0), 3)
        _tear(str(tmp_path), 3, mode)
    assert mgr.latest_step() == 2
    restored, step = mgr.restore(_state(0.0))
    assert step == 2
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 2.0,
                                                        np.float32))
    names = os.listdir(tmp_path)
    assert "step_0000000003" not in names
    assert any(n.startswith("step_0000000003.torn") for n in names)


@pytest.mark.faults
def test_restore_explicit_torn_step_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)
    _tear(str(tmp_path), 2, "no_meta")
    with pytest.raises(FileNotFoundError, match="missing or torn"):
        mgr.restore(_state(0.0), step=2)
    restored, step = mgr.restore(_state(0.0))
    assert step == 1


def test_metadata_records_state_bytes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)
    path = tmp_path / "step_0000000001" / "state.msgpack"
    assert mgr.read_metadata(1)["state_bytes"] == os.path.getsize(path)


def test_async_save_returns_before_write_completes(tmp_path, monkeypatch):
    orig = ckpt_mod._write_host_state
    started, release = threading.Event(), threading.Event()

    def held(*a, **kw):
        started.set()
        assert release.wait(30)
        return orig(*a, **kw)

    monkeypatch.setattr(ckpt_mod, "_write_host_state", held)
    mgr = CheckpointManager(str(tmp_path), async_write=True, max_inflight=2)
    mgr.save(_state(1.0), 1)
    assert started.wait(10)
    assert len(mgr._pending) == 1 and not mgr._pending[0].done()
    mgr.save(_state(2.0), 2)
    assert len(mgr._pending) == 2 and not mgr._pending[0].done()
    release.set()
    mgr.wait()
    assert mgr.latest_step() == 2


def test_async_inflight_bound_blocks_at_capacity(tmp_path, monkeypatch):
    orig = ckpt_mod._write_host_state
    release = threading.Event()
    writes = []

    def held(ckpt_dir, host_state, step, metadata, keep):
        assert release.wait(30)
        writes.append(step)
        return orig(ckpt_dir, host_state, step, metadata, keep)

    monkeypatch.setattr(ckpt_mod, "_write_host_state", held)
    mgr = CheckpointManager(str(tmp_path), async_write=True, max_inflight=2)
    mgr.save(_state(1.0), 1)
    mgr.save(_state(2.0), 2)
    blocked = threading.Event()

    def third():
        mgr.save(_state(3.0), 3)
        blocked.set()

    t = threading.Thread(target=third)
    t.start()
    assert not blocked.wait(0.3)        # at capacity: save 3 is parked
    release.set()
    t.join(timeout=10)
    assert blocked.is_set() and not t.is_alive()
    mgr.wait()
    assert writes == [1, 2, 3]
    assert mgr.latest_step() == 3


def test_async_write_error_surfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save({"w": object()}, 1)
    with pytest.raises(Exception):
        mgr.save(_state(2.0), 2)
    mgr.save(_state(3.0), 3)
    mgr.wait()
    assert mgr.latest_step() == 3


def test_state_file_layout_and_exact_restore(tmp_path):
    """Weights in flax layout (what ddw_tpu's msgpack reader sees), the
    optimizer state — bf16 moments included — restored bit for bit."""
    s = _state(0.5, moment_dtype="bfloat16")
    opt = make_optimizer(TrainCfg(optimizer="adam", moment_dtype="bfloat16"))
    g = {"weight": torch.randn(4, 4), "bias": torch.randn(4)}
    opt.update(s.params, g, s.opt_state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(s, 3)
    with open(tmp_path / "step_0000000003" / "state.msgpack", "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    assert set(tree) == {"params", "batch_stats", "opt_state", "step"}
    np.testing.assert_array_equal(tree["params"]["kernel"],
                                  _w(s).T)   # flax Dense: [in, out]
    restored, step = mgr.restore(_state(0.0, moment_dtype="bfloat16"))
    assert step == 3 and restored.step == 7
    for name in ("mu", "nu"):
        for k, t in s.opt_state[name].items():
            r = restored.opt_state[name][k]
            assert r.dtype == t.dtype and torch.equal(r, t)
    assert torch.equal(restored.opt_state["count"], s.opt_state["count"])
    np.testing.assert_array_equal(_w(restored), _w(s))
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(init_state(torch.nn.Linear(4, 4),
                               make_optimizer(TrainCfg(optimizer="sgd"))))


def test_best_keeper_keeps_the_best_val_loss(tmp_path):
    keeper = BestCheckpointKeeper(str(tmp_path))
    assert keeper.maybe_save(_state(1.0), 10, {"val_loss": 2.0})
    assert not keeper.maybe_save(_state(2.0), 20, {"val_loss": 3.0})
    assert not keeper.maybe_save(_state(2.0), 25, {"val_loss": float("nan")})
    assert keeper.maybe_save(_state(3.0), 30, {"val_loss": 1.0})
    keeper.close()
    again = BestCheckpointKeeper(str(tmp_path))   # the bar survives
    assert again.best_val_loss == 1.0
    restored, _ = again.restore(_state(0.0))
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 3.0,
                                                        np.float32))
    assert again.read_metadata()["train_step"] == 30
