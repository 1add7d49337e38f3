"""ZeRO-1 and ZeRO-3/FSDP of the port (``ddw_tpu_torch.parallel.zero``)
against ``ddw_tpu.parallel.zero`` on the CPU, and the trainers' ``zero`` /
``fsdp`` paths with sharded resume.

Placements are compared in this process: the port's per-leaf specs (by
``ddw_tpu``'s checkpoint path) equal ``ddw_tpu``'s ``zero_state_shardings``
/ ``fsdp_state_shardings`` on the same trees, leaf for leaf. The steps run
in two gloo processes from one ``spawn_cpu``: ZeRO-1 and FSDP against the
plain DP step and against ``ddw_tpu``'s GSPMD steps on a 2-device CPU mesh
(the LM, stateless norms, SGD so that no optimizer amplifies rounding),
gradient accumulation against one shot, and ``LMTrainer`` / ``Trainer``
fits with ``zero`` / ``fsdp`` (EMA on, a sharded checkpoint, resume).
f32 tolerances: loss 1e-5; parameters 1e-6 against the port's DP step and
1e-5 against ``ddw_tpu``'s."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from ddw_tpu_torch.runtime.dist import spawn_cpu

W = 2
LM = dict(vocab_size=32, max_len=32, hidden=32, depth=2, num_heads=2,
          mlp_dim=64, dtype="float32")
IMG = 16


def _weights():
    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.utils.config import LMCfg

    return to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**LM)), torch.Generator().manual_seed(0)))["params"]


def _tokens(n=8, seed=1):
    return np.random.RandomState(seed).randint(0, 32, (n, 13)).astype(
        np.int32)


def _tables(root):
    from ddw_tpu_torch.data.store import Record, TableStore

    def records(n, seed):
        rng = np.random.RandomState(seed)
        for i in range(n):
            img = rng.randint(0, 60, (IMG, IMG, 3)) + 150 * (i % 5 == 0)
            yield Record(f"img/{i:04d}", img.clip(0, 255).astype(np.uint8)
                         .tobytes(), f"c{i % 5}", i % 5)

    store = TableStore(root)
    meta = {"encoding": "raw_u8", "height": IMG, "width": IMG}
    store.write("train", records(32, 0), 16, meta)
    store.write("val", records(16, 1), 16, meta)
    return root


# ---- the ranks ---------------------------------------------------------------

def _rank(weights, ckpt_root, table_root):
    from ddw_tpu_torch.data.store import TableStore
    from ddw_tpu_torch.models.convert import (load_flax_variables,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.parallel import zero
    from ddw_tpu_torch.runtime.mesh import make_data_mesh, process_index
    from ddw_tpu_torch.train.lm_trainer import LMTrainer
    from ddw_tpu_torch.train.step import (Optimizer, TrainState,
                                          make_train_step)
    from ddw_tpu_torch.train.trainer import Trainer
    from ddw_tpu_torch.utils.config import (DataCfg, LMCfg, ModelCfg,
                                            TrainCfg)

    torch.set_num_threads(1)
    out = {}
    r = process_index()
    mesh = make_data_mesh()
    toks = _tokens()
    half = slice(4 * r, 4 * r + 4)
    x, y = torch.tensor(toks[half, :-1]), torch.tensor(toks[half, 1:])
    for clip, accum in ((0.0, 1), (0.5, 1), (0.0, 2)):
        res = {}
        for kind in ("dp", "zero", "fsdp"):
            model = load_flax_variables(build_lm(LMCfg(**LM)),
                                        {"params": weights})
            tx = Optimizer("sgd", 0.1, grad_clip_norm=clip)
            state = TrainState(model, tx.init(dict(model.named_parameters())),
                               0)
            step = (make_train_step(tx, accum) if kind == "dp" else
                    getattr(zero, f"make_{kind}_train_step")(model, tx, mesh,
                                                             "data", accum))
            losses = [float(step(state, x, y, 0)["loss"]) for _ in range(2)]
            with zero.gathered(state):
                params = to_flax_variables(model)["params"]
            if kind == "fsdp":
                res["resident"] = sum(p.numel()
                                      for p in model.parameters())
            res[kind] = (losses, params)
        out[(clip, accum)] = res

    lm_cfg = LMCfg(**LM)
    corpus = np.random.RandomState(3).randint(0, 32, (40, 13))
    for kind in ("zero", "fsdp"):
        base = dict(batch_size=4, warmup_epochs=0, learning_rate=1e-2,
                    ema_decay=0.9, **{kind: True})
        d = os.path.join(ckpt_root, f"lm_{kind}")
        straight = LMTrainer(lm_cfg, TrainCfg(epochs=2, **base),
                             device="cpu").fit(corpus)
        LMTrainer(lm_cfg, TrainCfg(epochs=1, checkpoint_dir=d, **base),
                  device="cpu").fit(corpus)
        resumed = LMTrainer(lm_cfg, TrainCfg(epochs=2, checkpoint_dir=d,
                                             **base),
                            device="cpu").fit(corpus, resume=True)
        out[f"lm_{kind}"] = (straight.history, resumed.history,
                             sorted(os.listdir(os.path.join(
                                 d, "step_0000000008"))))

    store = TableStore(table_root)
    train, val = store.table("train"), store.table("val")
    data = DataCfg(img_height=IMG, img_width=IMG, shuffle_buffer=16,
                   loader_workers=1)
    mcfg = ModelCfg(name="small_cnn", num_classes=5, dtype="float32",
                    dropout=0.0)
    for kind in ("plain", "zero", "fsdp"):
        kw = {} if kind == "plain" else {kind: True}
        tc = TrainCfg(batch_size=8, epochs=1, warmup_epochs=0,
                      learning_rate=1e-2, **kw)
        res = Trainer(data, mcfg, tc, device="cpu").fit(train, val)
        out[f"cnn_{kind}"] = res.history
    # Trainer's sharded resume: epoch 1 checkpointed, epoch 2 resumed
    for kind in ("zero", "fsdp"):
        d = os.path.join(ckpt_root, f"cnn_{kind}")
        tc = TrainCfg(batch_size=8, epochs=2, warmup_epochs=0,
                      learning_rate=1e-2, checkpoint_dir=d, **{kind: True})
        straight = Trainer(data, mcfg, dataclasses.replace(
            tc, checkpoint_dir=""), device="cpu").fit(train, val)
        Trainer(data, mcfg, dataclasses.replace(tc, epochs=1),
                device="cpu").fit(train, val)
        resumed = Trainer(data, mcfg, tc, device="cpu").fit(train, val,
                                                            resume=True)
        out[f"cnn_{kind}_resume"] = (straight.history, resumed.history)
    return out


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("zero_ckpt"))
    tables = _tables(str(tmp_path_factory.mktemp("zero_tables")))
    return spawn_cpu(_rank, W, weights, ckpt, tables, timeout_s=240)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def _jax():
    import types

    import jax
    import optax

    from ddw_tpu.models.lm import build_lm
    from ddw_tpu.models.registry import build_model
    from ddw_tpu.parallel import zero as jzero
    from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu.train import step as jstep
    from ddw_tpu.utils.config import LMCfg, ModelCfg, TrainCfg

    return types.SimpleNamespace(jax=jax, optax=optax, build_lm=build_lm,
                                 build_model=build_model, zero=jzero,
                                 MeshSpec=MeshSpec, make_mesh=make_mesh,
                                 step=jstep, LMCfg=LMCfg, ModelCfg=ModelCfg,
                                 TrainCfg=TrainCfg)


def _jax_specs(tree) -> dict:
    J = _jax()
    return {J.jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            J.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _states(family: str, train_kw: dict):
    """The same tree in both packages: (jax TrainState, port TrainState)."""
    from ddw_tpu_torch.models.convert import load_flax_variables
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.train.step import init_state, make_optimizer, \
        with_param_ema
    from ddw_tpu_torch.utils.config import LMCfg, ModelCfg, TrainCfg

    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.layers import init_params

    J = _jax()
    ema = train_kw.pop("ema", 0.0)
    if family == "lm":
        tm = build_lm(LMCfg(**LM))
    else:
        tm = build_model(ModelCfg(name="vit", num_classes=5,
                                  dtype="float32"), image_size=(32, 32))
    init_params(tm, torch.Generator().manual_seed(0))
    params = to_flax_variables(tm)["params"]
    load_flax_variables(tm, {"params": params})
    jtx = J.step.make_optimizer(J.TrainCfg(**train_kw))
    ttx = make_optimizer(TrainCfg(**train_kw))
    if ema:
        jtx, ttx = (J.step.with_param_ema(jtx, ema),
                    with_param_ema(ttx, ema))
    jstate = J.step.TrainState(params, {}, jtx.init(params), np.int32(0))
    return jstate, init_state(tm, ttx)


MESH_CASES = [("lm", {}), ("lm", {"grad_clip_norm": 1.0}),
              ("lm", {"optimizer": "sgd", "ema": 0.9}), ("vit", {})]


@pytest.mark.parametrize("kind", ["zero", "fsdp"])
@pytest.mark.parametrize("family,train_kw", MESH_CASES)
def test_leaf_placements_equal_jax(kind, family, train_kw):
    """The port places every leaf of the same TrainState where ddw_tpu
    does (the largest dim of the flax layout the axis divides), under
    ddw_tpu's checkpoint paths, and reports the same sharded fractions."""
    from ddw_tpu_torch.parallel import zero as tzero
    from ddw_tpu_torch.runtime.mesh import Mesh

    J = _jax()
    jstate, tstate = _states(family, dict(train_kw))
    jmesh = J.make_mesh(J.MeshSpec((("data", 4),)),
                        devices=J.jax.devices()[:4])
    tmesh = Mesh(("data",), np.arange(4), {"data": None})
    want = _jax_specs(getattr(J.zero, f"{kind}_state_shardings")(jstate,
                                                                 jmesh))
    got = getattr(tzero, f"{kind}_state_shardings")(
        tstate, tmesh, clip=bool(train_kw.get("grad_clip_norm")))
    assert {k: tuple(v) for k, v in got.items()} == want
    for frac in ("zero_fraction_sharded", "fsdp_fraction_sharded"):
        assert getattr(tzero, frac)(tstate, tmesh) == pytest.approx(
            getattr(J.zero, frac)(jstate, jmesh))


@pytest.mark.parametrize("exclude", [frozenset(), frozenset({1})])
def test_leaf_spec_equals_jax(exclude):
    from ddw_tpu_torch.parallel.zero import _leaf_spec

    J = _jax()
    rng = np.random.RandomState(0)
    for _ in range(50):
        shape = tuple(int(s) for s in rng.choice([1, 2, 3, 4, 6, 8, 12, 16],
                                                 rng.randint(1, 5)))
        for n in (2, 3, 4):
            assert tuple(_leaf_spec(shape, n, "data", exclude)) == tuple(
                J.zero._leaf_spec(shape, n, "data", exclude)), (shape, n)


@pytest.mark.parametrize("clip,accum", [(0.0, 1), (0.5, 1), (0.0, 2)])
def test_sharded_steps_equal_dp(ranks, clip, accum):
    """ZeRO-1 and FSDP take the plain DP step's two SGD updates (with
    global-norm clipping over the shards, and as two microbatches); FSDP
    keeps about 1/2 of the parameters resident between steps."""
    J = _jax()
    for rk in ranks:
        res = rk[(clip, accum)]
        dp_losses, dp = res["dp"]
        for kind in ("zero", "fsdp"):
            losses, params = res[kind]
            np.testing.assert_allclose(losses, dp_losses, rtol=1e-6)
            for (path, a), (_, b) in zip(
                    J.jax.tree_util.tree_flatten_with_path(params)[0],
                    J.jax.tree_util.tree_flatten_with_path(dp)[0]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                           err_msg=str(path))
        total = sum(np.asarray(a).size for a in
                    J.jax.tree_util.tree_leaves(dp))
        assert res["resident"] < 0.6 * total
    accum1 = ranks[0][(0.0, 1)]["zero"][1]
    accum2 = ranks[0][(0.0, 2)]["zero"][1]
    for a, b in zip(J.jax.tree_util.tree_leaves(accum1),
                    J.jax.tree_util.tree_leaves(accum2)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["zero", "fsdp"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_sharded_steps_equal_jax(ranks, weights, kind, clip):
    """Two SGD steps of the port's ZeRO-1 / FSDP step equal ddw_tpu's GSPMD
    step on a 2-device mesh from the same weights and batches."""
    J = _jax()
    mesh = J.make_mesh(J.MeshSpec((("data", W),)),
                       devices=J.jax.devices()[:W])
    model = J.build_lm(J.LMCfg(**LM))
    tx = J.step.make_optimizer(J.TrainCfg(optimizer="sgd", learning_rate=0.1,
                                          grad_clip_norm=clip))
    params = J.jax.tree_util.tree_map(np.asarray, weights)
    state = J.step.TrainState(params, {}, tx.init(params), np.int32(0))
    step = getattr(J.zero, f"make_{kind}_train_step")(model, tx, mesh,
                                                      donate=False)
    state = step.place_state(state)
    toks = _tokens()
    losses = []
    for _ in range(2):
        state, m = step(state, toks[:, :-1], toks[:, 1:],
                        J.jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    got_losses, got = ranks[0][(clip, 1)][kind]
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    want = dict(J.jax.tree_util.tree_flatten_with_path(
        J.jax.device_get(state.params))[0])
    for path, a in J.jax.tree_util.tree_flatten_with_path(got)[0]:
        np.testing.assert_allclose(a, np.asarray(want[path]), rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("kind", ["zero", "fsdp"])
def test_lm_trainer_sharded_resume(ranks, kind):
    """LMTrainer with train.zero / train.fsdp and EMA: a run checkpointed
    after epoch 1 and resumed (every rank restoring its own blocks) ends
    where the uninterrupted two-epoch run ends; the checkpoint is one shard
    file per rank."""
    straight, resumed, files = ranks[0][f"lm_{kind}"]
    assert len(resumed) == 1 and resumed[0]["epoch"] == 1
    for key in ("loss", "val_loss", "accuracy", "val_accuracy"):
        np.testing.assert_allclose(resumed[0][key], straight[1][key],
                                   rtol=1e-6, err_msg=key)
    assert {"index.json", "proc_0.bin", "proc_1.bin", "proc_0.json",
            "proc_1.json", "commit_0", "commit_1"} <= set(files)
    for a, b in zip(ranks[0][f"lm_{kind}"][0], ranks[1][f"lm_{kind}"][0]):
        assert {k: a[k] for k in ("loss", "val_loss")} == \
            {k: b[k] for k in ("loss", "val_loss")}


def test_vision_trainer_zero_and_fsdp_equal_plain(ranks):
    """Trainer.fit with train.zero / train.fsdp (SmallCNN, stateless norm)
    gives the plain data-parallel fit's metrics."""
    for rk in ranks:
        plain = rk["cnn_plain"][0]
        for kind in ("zero", "fsdp"):
            row = rk[f"cnn_{kind}"][0]
            for key in ("loss", "val_loss", "accuracy", "val_accuracy"):
                np.testing.assert_allclose(row[key], plain[key], rtol=1e-5,
                                           atol=1e-6, err_msg=key)


@pytest.mark.parametrize("kind", ["zero", "fsdp"])
def test_vision_trainer_sharded_resume(ranks, kind):
    """Trainer with train.zero / train.fsdp, checkpointed after epoch 1 in
    the sharded format and resumed, ends where two straight epochs end."""
    for rk in ranks:
        straight, resumed = rk[f"cnn_{kind}_resume"]
        assert [r["epoch"] for r in resumed] == [1]
        for key in ("loss", "val_loss", "accuracy", "val_accuracy"):
            np.testing.assert_allclose(resumed[0][key], straight[1][key],
                                       rtol=1e-6, err_msg=key)


def test_zero_and_fsdp_are_mutually_exclusive(tmp_path):
    from ddw_tpu_torch.train.lm_trainer import LMTrainer
    from ddw_tpu_torch.train.trainer import Trainer
    from ddw_tpu_torch.utils.config import (DataCfg, LMCfg, ModelCfg,
                                            TrainCfg)

    both = TrainCfg(zero=True, fsdp=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        LMTrainer(LMCfg(**LM), both, device="cpu")
    root = _tables(str(tmp_path))
    from ddw_tpu_torch.data.store import TableStore

    store = TableStore(root)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(DataCfg(img_height=IMG, img_width=IMG),
                ModelCfg(name="small_cnn", dtype="float32"), both,
                device="cpu").fit(store.table("train"), store.table("val"))
    for kw in (dict(zero=True, pipeline_stages=2),):
        with pytest.raises(ValueError, match="pipeline_stages"):
            LMTrainer(LMCfg(**LM), TrainCfg(**kw), device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        LMTrainer(dataclasses.replace(LMCfg(**LM), num_experts=2),
                  TrainCfg(fsdp=True), device="cpu")
