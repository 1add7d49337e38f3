"""The sharded checkpoint of the port (``ddw_tpu_torch.checkpoint.sharded``)
on ``ddw_tpu``'s on-disk format, against ``ddw_tpu.checkpoint.sharded``.

In this process: the commit protocol (``commit_<i>`` markers, the atomic
rename, ``proc_bytes`` in ``index.json``), the torn-directory quarantine
and fall-back, an explicitly named torn step, a pre-audit index, retention
and metadata, the async writer (byte-identical to the synchronous one, its
errors surfacing at the next boundary) — the cases of
``tests/test_sharded_ckpt.py``. Across packages and world sizes: a
checkpoint ``ddw_tpu`` writes from a 4-device ZeRO state restores in the
port on two gloo ranks (one ``spawn_cpu``) and in one process, and the
checkpoint the two ranks write restores in ``ddw_tpu`` on 4 devices and on
one, every leaf bit for bit."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from ddw_tpu_torch.runtime.dist import spawn_cpu

LM = dict(vocab_size=32, max_len=32, hidden=32, depth=2, num_heads=2,
          mlp_dim=64, dtype="float32")


def _trees():
    """Seeded params, adam moments and scalars in the flax layout."""
    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.utils.config import LMCfg

    params = to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**LM)), torch.Generator().manual_seed(0)))["params"]
    rng = np.random.RandomState(1)

    def like(tree):
        if isinstance(tree, dict):
            return {k: like(v) for k, v in tree.items()}
        return rng.randn(*tree.shape).astype(np.float32)

    return {"params": params, "mu": like(params), "nu": like(params),
            "count": 3, "lr": 0.002, "step": 5}


def _port_state(trees=None):
    """A port TrainState (adam) holding ``trees``, or zeros."""
    from ddw_tpu_torch.models.convert import load_flax_variables
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.train.step import init_state, make_optimizer
    from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

    model = build_lm(LMCfg(**LM))
    state = init_state(model, make_optimizer(TrainCfg()))
    if trees is None:
        return state
    load_flax_variables(model, {"params": trees["params"]})
    idx = {".".join(k): k for k in _paths(trees["params"])}
    with torch.no_grad():
        for key in ("mu", "nu"):
            for n, t in state.opt_state[key].items():
                t.copy_(torch.tensor(_get(trees[key], idx[n])))
        state.opt_state["count"].fill_(trees["count"])
        state.opt_state["learning_rate"].fill_(trees["lr"])
    state.step = trees["step"]
    return state


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _port_trees(state) -> dict:
    """The flax-layout trees a port TrainState holds (gathered)."""
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.parallel.zero import gathered

    out = {}
    with gathered(state):
        out["params"] = to_flax_variables(state.model)["params"]
    for key in ("mu", "nu"):
        d = state.opt_state[key]
        if state.layout is not None:
            d = state.layout.compute_tree(d)
        tree: dict = {}
        for n, t in d.items():
            node = tree
            parts = n.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t.detach().numpy().copy()
        out[key] = tree
    out["count"] = int(state.opt_state["count"])
    out["lr"] = float(state.opt_state["learning_rate"])
    out["step"] = int(state.step)
    return out


def _assert_trees_equal(got: dict, want: dict):
    for key in ("params", "mu", "nu"):
        for path in _paths(want[key]):
            np.testing.assert_array_equal(np.asarray(_get(got[key], path)),
                                          np.asarray(_get(want[key], path)),
                                          err_msg=f"{key}{path}")
    assert got["count"] == want["count"] and got["step"] == want["step"]
    assert np.float32(got["lr"]) == np.float32(want["lr"])


@functools.cache
def _jax():
    import types

    import jax

    from ddw_tpu.checkpoint import sharded as jsh
    from ddw_tpu.parallel import zero as jzero
    from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu.train import step as jstep
    from ddw_tpu.utils.config import TrainCfg

    return types.SimpleNamespace(jax=jax, sh=jsh, zero=jzero,
                                 MeshSpec=MeshSpec, make_mesh=make_mesh,
                                 step=jstep, TrainCfg=TrainCfg)


def _jax_state(trees):
    J = _jax()
    jnp = J.jax.numpy
    tx = J.step.make_optimizer(J.TrainCfg())
    params = J.jax.tree_util.tree_map(jnp.asarray, trees["params"])
    opt = tx.init(params)

    def fill(path, leaf):
        key = J.jax.tree_util.keystr(path)
        for name in ("mu", "nu"):
            if f".{name}[" in key:
                sub = [p.key for p in path if hasattr(p, "key")]
                return jnp.asarray(_get(trees[name], sub))
        if key.endswith("count"):
            return jnp.asarray(trees["count"], leaf.dtype)
        if "learning_rate" in key:
            return jnp.asarray(trees["lr"], leaf.dtype)
        return leaf

    opt = J.jax.tree_util.tree_map_with_path(fill, opt)
    return J.step.TrainState(params, {}, opt,
                             jnp.asarray(trees["step"], jnp.int32))


def _jax_trees(state) -> dict:
    J = _jax()
    out = {"params": J.jax.tree_util.tree_map(np.asarray, state.params)}
    inner = state.opt_state.inner_state[0]
    out["mu"] = J.jax.tree_util.tree_map(np.asarray, inner.mu)
    out["nu"] = J.jax.tree_util.tree_map(np.asarray, inner.nu)
    out["count"] = int(state.opt_state.count)
    out["lr"] = float(state.opt_state.hyperparams["learning_rate"])
    out["step"] = int(state.step)
    return out


def _jax_mesh(n):
    J = _jax()
    return J.make_mesh(J.MeshSpec((("data", n),)),
                       devices=J.jax.devices()[:n])


def _jax_save(d, trees, n=4):
    J = _jax()
    state = _jax_state(trees)
    mesh = _jax_mesh(n)
    sh = J.zero.zero_state_shardings(state, mesh)
    state = J.jax.tree.map(J.jax.device_put, state, sh)
    J.sh.save_sharded(d, state, step=7, metadata={"epoch": 1})


def _jax_restore(d, trees, n):
    J = _jax()
    target = _jax_state(trees)
    mesh = _jax_mesh(n)
    sh = J.zero.zero_state_shardings(target, mesh)
    state, at = J.sh.restore_sharded(d, target, sh)
    return _jax_trees(state), at


# ---- the ranks ---------------------------------------------------------------

def _rank(trees, jax_dir, port_dir):
    from ddw_tpu_torch.checkpoint.sharded import (restore_sharded,
                                                  save_sharded)
    from ddw_tpu_torch.parallel.zero import place
    from ddw_tpu_torch.runtime.mesh import make_data_mesh

    torch.set_num_threads(1)
    mesh = make_data_mesh()
    state = place(_port_state(trees), "zero", mesh)
    save_sharded(port_dir, state, step=9, metadata={"epoch": 2})
    target = place(_port_state(), "zero", mesh)
    target, at = restore_sharded(jax_dir, target)
    fsdp = place(_port_state(), "fsdp", mesh)
    fsdp, at2 = restore_sharded(port_dir, fsdp)
    return {"from_jax": (_port_trees(target), at),
            "fsdp_from_port": (_port_trees(fsdp), at2),
            "held": sum(t.numel() for t in state.opt_state["mu"].values())}


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.fixture(scope="module")
def cross(trees, tmp_path_factory):
    jax_dir = str(tmp_path_factory.mktemp("from_jax"))
    port_dir = str(tmp_path_factory.mktemp("from_port"))
    _jax_save(jax_dir, trees)
    ranks = spawn_cpu(_rank, 2, trees, jax_dir, port_dir, timeout_s=240)
    return ranks, jax_dir, port_dir


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---- across packages and world sizes -------------------------------------------

def test_jax_checkpoint_restores_in_the_port_on_two_ranks(cross, trees):
    """ddw_tpu's 4-device ZeRO checkpoint (one process file, four moment
    slices per leaf) restores onto the port's 2-rank ZeRO placement: each
    rank reads the slices it holds, and the gathered state is the saved one
    bit for bit."""
    ranks, _, _ = cross
    for rk in ranks:
        got, at = rk["from_jax"]
        assert at == 7
        _assert_trees_equal(got, trees)


def test_port_checkpoint_restores_in_jax_on_4_and_1_devices(cross, trees):
    """The two ranks' checkpoint (proc_0 and proc_1, moments split by
    ddw_tpu's rule) restores in ddw_tpu on 4 devices and on 1."""
    _, _, port_dir = cross
    with open(os.path.join(port_dir, "step_0000000009", "index.json")) as f:
        index = json.load(f)
    assert index["n_processes"] == 2 and index["metadata"] == {"epoch": 2}
    for n in (4, 1):
        got, at = _jax_restore(port_dir, trees, n)
        assert at == 9
        _assert_trees_equal(got, trees)


def test_port_checkpoint_restores_across_placements_and_worlds(cross, trees):
    """The same checkpoint restores onto an FSDP placement on the two ranks
    and into one unplaced process; a rank held half of every moment."""
    from ddw_tpu_torch.checkpoint.sharded import restore_sharded

    ranks, jax_dir, port_dir = cross
    for rk in ranks:
        got, at = rk["fsdp_from_port"]
        assert at == 9
        _assert_trees_equal(got, trees)
    total = sum(np.asarray(_get(trees["mu"], p)).size
                for p in _paths(trees["mu"]))
    assert ranks[0]["held"] == ranks[1]["held"] == total // 2
    for d, at_want in ((port_dir, 9), (jax_dir, 7)):
        state, at = restore_sharded(d, _port_state())
        assert at == at_want
        _assert_trees_equal(_port_trees(state), trees)


# ---- the commit protocol and the audit, one process ---------------------------

def _state(seed=0):
    trees = _trees()
    trees["step"] = seed
    return _port_state(trees)


def test_commit_protocol_and_proc_bytes(tmp_path):
    from ddw_tpu_torch.checkpoint.sharded import save_sharded

    d = str(tmp_path / "ck")
    path = save_sharded(d, _state(), step=3, metadata={"epoch": 0})
    assert path.endswith("step_0000000003")
    files = set(os.listdir(path))
    assert {"index.json", "proc_0.bin", "proc_0.json", "commit_0"} <= files
    assert not any(f.endswith(".tmp") for f in os.listdir(d))
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    assert index["proc_bytes"] == {
        "0": os.path.getsize(os.path.join(path, "proc_0.bin"))}
    assert index["leaves"][".step"] == {"shape": [], "dtype": "int32"}


def test_torn_shard_file_quarantined_and_falls_back(tmp_path):
    from ddw_tpu_torch.checkpoint.sharded import (latest_complete_step,
                                                  restore_sharded,
                                                  save_sharded)

    d = str(tmp_path / "ck")
    save_sharded(d, _state(1), step=1)
    save_sharded(d, _state(2), step=2)
    binp = os.path.join(d, "step_0000000002", "proc_0.bin")
    with open(binp, "r+b") as f:
        f.truncate(os.path.getsize(binp) - 7)
    assert latest_complete_step(d) == 1
    assert os.path.isdir(os.path.join(d, "step_0000000002.torn0"))
    state, at = restore_sharded(d, _port_state())
    assert at == 1 and state.step == 1


def test_missing_index_quarantined(tmp_path):
    from ddw_tpu_torch.checkpoint.sharded import (latest_complete_step,
                                                  save_sharded)

    d = str(tmp_path / "ck")
    save_sharded(d, _state(1), step=1)
    save_sharded(d, _state(2), step=2)
    os.remove(os.path.join(d, "step_0000000002", "index.json"))
    assert latest_complete_step(d) == 1
    assert os.path.isdir(os.path.join(d, "step_0000000002.torn0"))


def test_explicit_torn_step_raises(tmp_path):
    from ddw_tpu_torch.checkpoint.sharded import restore_sharded, \
        save_sharded

    d = str(tmp_path / "ck")
    save_sharded(d, _state(1), step=1)
    os.remove(os.path.join(d, "step_0000000001", "proc_0.json"))
    with pytest.raises(FileNotFoundError, match="torn"):
        restore_sharded(d, _port_state(), step=1)


def test_pre_audit_checkpoint_still_restores(tmp_path):
    from ddw_tpu_torch.checkpoint.sharded import restore_sharded, \
        save_sharded

    d = str(tmp_path / "ck")
    save_sharded(d, _state(4), step=4)
    ip = os.path.join(d, "step_0000000004", "index.json")
    with open(ip) as f:
        index = json.load(f)
    del index["proc_bytes"]
    with open(ip, "w") as f:
        json.dump(index, f)
    state, at = restore_sharded(d, _port_state())
    assert at == 4 and state.step == 4


def test_missing_checkpoint_and_structure_mismatch(tmp_path):
    from ddw_tpu_torch.checkpoint.sharded import restore_sharded, \
        save_sharded
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.train.step import init_state, make_optimizer
    from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

    target = _port_state()
    assert restore_sharded(str(tmp_path / "none"), target) == (target, None)
    d = str(tmp_path / "ck")
    save_sharded(d, _state(), step=1)
    wider = init_state(build_lm(LMCfg(**dict(LM, hidden=64))),
                       make_optimizer(TrainCfg()))
    with pytest.raises(ValueError, match="target shape"):
        restore_sharded(d, wider)
    sgd = init_state(build_lm(LMCfg(**LM)),
                     make_optimizer(TrainCfg(optimizer="sgd")))
    with pytest.raises(KeyError, match="no leaf"):
        restore_sharded(d, sgd)


def test_manager_latest_metadata_retention(tmp_path):
    from ddw_tpu_torch.checkpoint.sharded import ShardedCheckpointManager

    mgr = ShardedCheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in (3, 6, 9):
        mgr.save(_state(s), s, metadata={"epoch": s // 3})
    assert mgr.latest_step() == 9
    assert mgr.read_metadata() == {"epoch": 3}
    assert sorted(os.listdir(str(tmp_path / "ck"))) == [
        "step_0000000006", "step_0000000009"]
    state, at = mgr.restore(_port_state())
    assert at == 9 and state.step == 9
    mgr.close()


def test_async_save_matches_sync_and_errors_surface(tmp_path, monkeypatch):
    from ddw_tpu_torch.checkpoint import sharded as sh

    s = _state(5)
    sh.save_sharded(str(tmp_path / "sync"), s, step=5)
    mgr = sh.ShardedCheckpointManager(str(tmp_path / "async"),
                                      async_write=True)
    mgr.save(s, 5)
    with torch.no_grad():    # the snapshot was taken inside save()
        for p in s.model.parameters():
            p.zero_()
    mgr.wait()
    for name in ("proc_0.bin", "proc_0.json"):
        with open(tmp_path / "sync" / "step_0000000005" / name, "rb") as a, \
                open(tmp_path / "async" / "step_0000000005" / name,
                     "rb") as b:
            assert a.read() == b.read(), name

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(sh, "write_snapshot", boom)
    mgr.save(s, 6)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.close()
