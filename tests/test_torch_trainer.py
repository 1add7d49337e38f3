"""The port's trainer (``ddw_tpu_torch.train.trainer``) on the CPU: the LR
schedule against ``ddw_tpu``'s for one metric stream, learning on a
synthetic ``raw_u8`` table, resume bit-identical to an uninterrupted run, the
loss trajectory against the JAX ``Trainer`` from the same weights and
batches, the refusals of unported features, tracker logging, the
``trace_dir`` / ``monitor_interval_s`` / ``tracer=`` hooks, and one
2-process gloo data-parallel step against JAX's 2-device mesh step.
MobileNetV2 width 0.35, 32x32 images (64x64 for the DP step), f32."""

import dataclasses
import glob
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.data.store import TableStore as JaxStore
from ddw_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
from ddw_tpu.train import step as jstep
from ddw_tpu.train.schedule import ScheduleSuite as JaxScheduleSuite
from ddw_tpu.train.trainer import Trainer as JaxTrainer
from ddw_tpu.utils.config import DataCfg as JaxDataCfg
from ddw_tpu.utils.config import ModelCfg as JaxModelCfg
from ddw_tpu.utils.config import TrainCfg as JaxTrainCfg
from ddw_tpu_torch.data.store import Record, TableStore
from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.runtime.dist import spawn_cpu
from ddw_tpu_torch.tracking.tracker import Tracker
from ddw_tpu_torch.train import step as tstep
from ddw_tpu_torch.train.schedule import ScheduleSuite
from ddw_tpu_torch.train.trainer import Trainer
from ddw_tpu_torch.utils.config import (DataCfg, ModelCfg, TrainCfg,
                                        apply_overrides)

IMG = 32


_COLOURS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1))


def _class_records(n, seed, size=IMG):
    """Class c of 5: its own colour mix over dark noise."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        c = i % 5
        img = rng.randint(0, 60, (size, size, 3))
        img = img + 150 * np.asarray(_COLOURS[c])
        yield Record(f"img/{i:04d}", img.clip(0, 255).astype(np.uint8)
                     .tobytes(), f"c{c}", c)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    store = TableStore(str(tmp_path_factory.mktemp("tables")))
    meta = {"encoding": "raw_u8", "height": IMG, "width": IMG}
    train = store.write("train", _class_records(96, 0), 16, meta)
    val = store.write("val", _class_records(32, 1), 16, meta)
    return store.root, train, val


def _cfgs(tmp_path, **train_kw):
    data = DataCfg(img_height=IMG, img_width=IMG, shuffle_buffer=64,
                   loader_workers=1)
    model = ModelCfg(width_mult=0.35, dtype="float32", dw_impl="pallas",
                     dropout=0.0, freeze_base=False)
    train = TrainCfg(**{"batch_size": 16, "epochs": 2, "warmup_epochs": 0,
                        "learning_rate": 3e-3, "optimizer": "adam",
                        **train_kw})
    return data, model, train


# -- schedule ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(warmup_epochs=2, plateau_patience=1, early_stop_patience=2),
    dict(warmup_epochs=1, lr_schedule="cosine", cosine_final_lr_frac=0.1),
    dict(warmup_epochs=0, scale_lr_by_world=False, plateau_patience=2),
])
def test_lr_sequence_matches_jax_schedule(kw):
    world, spe = 4, 3
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7]
    cfg = dict(learning_rate=1e-3, optimizer="adam", epochs=len(metrics),
               **kw)
    jtx = jstep.make_optimizer(JaxTrainCfg(**cfg))
    jp = {"w": jnp.zeros(3)}
    jstate = jstep.TrainState(jp, {}, jtx.init(jp), jnp.zeros((), jnp.int32))
    model = torch.nn.Linear(1, 1)
    state = tstep.init_state(model,
                             tstep.make_optimizer(TrainCfg(**cfg)))
    jsuite = JaxScheduleSuite.build(JaxTrainCfg(**cfg), world, None)
    suite = ScheduleSuite.build(TrainCfg(**cfg), world, None)
    jstate = jsuite.initial_state(jstate, 0, False)
    state = suite.initial_state(state, 0, False)
    seq, jseq, stops, jstops = [], [], [], []
    for epoch, val_loss in enumerate(metrics):
        for s in range(spe):
            for su, st, out, get, set_ in (
                    (suite, state, seq, tstep.get_lr, tstep.set_lr),
                    (jsuite, jstate, jseq, jstep.get_lr, jstep.set_lr)):
                lr = su.lr_for_batch(epoch, s, spe)
                if lr is not None:
                    st = set_(st, lr)
                out.append(get(st))
                if su is suite:
                    state = st
                else:
                    jstate = st
        state, stop = suite.epoch_end(state, val_loss, epoch)
        jstate, jstop = jsuite.epoch_end(jstate, val_loss, epoch)
        stops.append(stop)
        jstops.append(jstop)
    np.testing.assert_allclose(seq, jseq, rtol=1e-6)
    assert stops == jstops
    assert suite.state_dicts() == jsuite.state_dicts()


# -- the trainer ---------------------------------------------------------------

def test_fit_learns_and_logs(tables, tmp_path):
    _, train, val = tables
    data, model, cfg = _cfgs(tmp_path, epochs=5, debug_cross_host_checks=True)
    run = Tracker(str(tmp_path / "mlruns")).start_run("fit")
    res = Trainer(data, model, cfg, run=run, device="cpu").fit(train, val)
    losses = [r["loss"] for r in res.history]
    assert res.epochs_run == 5 and res.state.step == 5 * (96 // 16)
    assert losses[-1] < losses[0]
    # twice chance in 30 steps from scratch (ddw_tpu's Trainer, same data
    # and settings: 0.63). Val accuracy stays near chance in both packages
    # this early: BatchNorm's running statistics lag the fast-moving weights.
    assert res.history[-1]["accuracy"] >= 0.4, res.history
    assert all(r["images_per_sec"] > 0 for r in res.history)
    params = run.params()
    assert params["steps_per_epoch"] == 6 and params["world_size"] == 1
    assert params["train.optimizer"] == "adam"
    assert len(run.metric_history("val_loss")) == 5
    assert len(run.metric_history("params_checksum")) == 5


def test_trace_dir_monitor_and_tracer_hooks(tables, tmp_path):
    """``trace_dir`` profiles the first epoch's steps into a Chrome trace
    and logs the param; ``monitor_interval_s`` logs sys.* series (when
    psutil imports); ``tracer=`` records one ``train_chain`` span per chain
    boundary, ddw_tpu's names; a tee'd run's hub gets ``train.chain_ms``.
    The hooks leave the losses as an unhooked run's."""
    from ddw_tpu_torch.obs.telemetry import TelemetryHub, tee_run
    from ddw_tpu_torch.obs.trace import Tracer
    from ddw_tpu_torch.utils.sysmon import host_keys_available

    _, train, val = tables
    data, model, cfg = _cfgs(tmp_path, epochs=1, steps_per_dispatch=3)
    plain = Trainer(data, model, cfg, device="cpu").fit(train, val)
    hooked = dataclasses.replace(cfg, trace_dir=str(tmp_path / "trace"),
                                 monitor_interval_s=0.02)
    run = Tracker(str(tmp_path / "mlruns")).start_run("hooks")
    hub = TelemetryHub()
    tracer = Tracer(process="train")
    res = Trainer(data, model, hooked, run=tee_run(run, hub), device="cpu",
                  tracer=tracer).fit(train, val)
    assert [r["loss"] for r in res.history] == \
        [r["loss"] for r in plain.history]
    traces = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert any(e.get("cat") == "cpu_op"
                   for e in json.load(f)["traceEvents"])
    assert run.params()["trace_dir"] == str(tmp_path / "trace")
    spans = tracer.drain()
    assert [(e["name"], e["args"]["k"]) for e in spans] == \
        [("train_chain", 3)] * 2
    assert hub.signals()["train.chain_ms"] == "dist"
    if host_keys_available():
        assert len(run.metric_history("sys.host_mem_percent")) >= 1


def test_resume_equals_uninterrupted_bit_for_bit(tables, tmp_path):
    # dropout on, plateau counters and the loader stream must round-trip
    _, train, val = tables
    data, model, cfg = _cfgs(tmp_path, plateau_patience=1, plateau_factor=0.5)
    model = dataclasses.replace(model, dropout=0.3)

    def fit(epochs, ckpt, resume=False):
        c = dataclasses.replace(cfg, epochs=epochs,
                                checkpoint_dir=str(tmp_path / ckpt))
        return Trainer(data, model, c, device="cpu").fit(train, val,
                                                         resume=resume)

    full = fit(3, "a")
    fit(2, "b")
    resumed = fit(3, "b", resume=True)
    assert [r["epoch"] for r in resumed.history] == [2]
    for key in ("loss", "accuracy", "val_loss", "val_accuracy", "lr"):
        assert resumed.history[0][key] == full.history[2][key], key
    a, b = to_flax_variables(full.state.model), \
        to_flax_variables(resumed.state.model)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert resumed.state.step == full.state.step == 18


def test_loss_trajectory_tracks_jax_trainer(tables, tmp_path):
    # From the same weights and byte-identical batches, SGD. The transfer
    # configuration (freeze_base, the backbone in inference mode) keeps the
    # comparison well conditioned: see test_torch_train_step for why
    # unfrozen batch-8 training amplifies rounding.
    root, train, val = tables
    jmodel = JaxMobileNetV2(width_mult=0.35, dtype=jnp.float32,
                            dw_impl="xla", dropout=0.0, freeze_base=True)
    v = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, IMG, IMG, 3)),
        train=False)
    v = jax.tree_util.tree_map(np.array, v)
    kw = dict(batch_size=16, epochs=2, warmup_epochs=0, learning_rate=0.05,
              optimizer="sgd", seed=1)
    jtx = jstep.make_optimizer(JaxTrainCfg(**kw), ("backbone",))
    jstate = jstep.TrainState(v["params"], v["batch_stats"],
                              jtx.init(v["params"]), jnp.zeros((), jnp.int32))
    jstore = JaxStore(root)
    jres = JaxTrainer(
        JaxDataCfg(img_height=IMG, img_width=IMG, shuffle_buffer=64,
                   loader_workers=1),
        JaxModelCfg(width_mult=0.35, dtype="float32", dropout=0.0),
        JaxTrainCfg(**kw),
        mesh=make_mesh(MeshSpec((("data", 1),)), devices=jax.devices()[:1]),
        model=jmodel, initial=(jstate, jtx)).fit(
            jstore.table("train"), jstore.table("val"))

    data, _, _ = _cfgs(tmp_path)
    mcfg = ModelCfg(width_mult=0.35, dtype="float32", dw_impl="pallas",
                    dropout=0.0, freeze_base=True, allow_frozen_random=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = load_flax_variables(build_model(mcfg), v)
    tx = tstep.make_optimizer(TrainCfg(**kw), ("backbone",))
    res = Trainer(data, mcfg, TrainCfg(**kw), model=model,
                  initial=(tstep.init_state(model, tx), tx),
                  device="cpu").fit(train, val)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in res.history],
                                   [r[key] for r in jres.history], rtol=1e-4)
    np.testing.assert_allclose([r["accuracy"] for r in res.history],
                               [r["accuracy"] for r in jres.history],
                               rtol=1e-6)


def test_unported_features_are_refused(tables, tmp_path):
    """ZeRO/FSDP and the pipeline fields are configs now (slice 5); zero
    with fsdp is refused as ddw_tpu refuses it."""
    cfgs = {"data": DataCfg(), "model": ModelCfg(), "train": TrainCfg()}
    apply_overrides(cfgs, ["train.zero=true", "train.batch_size=64",
                           "model.dropout=0.1"])
    assert cfgs["train"].zero and cfgs["train"].batch_size == 64
    assert cfgs["model"].dropout == 0.1
    root, train, val = tables
    data, model, _ = _cfgs(tmp_path)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(data, model, TrainCfg(zero=True, fsdp=True),
                device="cpu").fit(train, val)
    with pytest.raises(KeyError):
        apply_overrides(cfgs, ["train.nope=1"])
    data, model, cfg = _cfgs(tmp_path)
    with pytest.raises(FileNotFoundError, match="w.npz"):
        Trainer(data, dataclasses.replace(model, pretrained_path="w.npz"),
                cfg, device="cpu").fit(*tables[1:])
    with pytest.raises(ValueError, match="num_devices"):
        Trainer(data, model, dataclasses.replace(cfg, num_devices=2),
                device="cpu").fit(*tables[1:])
    with pytest.warns(UserWarning, match="auto-unfreezing"):
        m = build_model(ModelCfg(width_mult=0.35))
    assert m.freeze_base is False
    with pytest.warns(UserWarning, match="allow_frozen_random"):
        m = build_model(ModelCfg(width_mult=0.35, allow_frozen_random=True))
    assert m.freeze_base is True


# -- data parallel -------------------------------------------------------------

DP_IMG, DP_BATCH = 64, 8


def _dp_variables():
    jmodel = JaxMobileNetV2(width_mult=0.35, dtype=jnp.float32,
                            dw_impl="xla", dropout=0.0, freeze_base=False)
    v = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(5)}, jnp.zeros((1, DP_IMG, DP_IMG, 3)),
        train=False)
    rng = np.random.RandomState(6)
    x = rng.randn(2 * DP_BATCH, DP_IMG, DP_IMG, 3).astype(np.float32)
    y = rng.randint(0, 5, 2 * DP_BATCH).astype(np.int32)
    return jmodel, jax.tree_util.tree_map(np.array, v), x, y


def _dp_worker(variables, x, y):
    """One rank of the gloo group: its half of the batch, one SGD step."""
    from ddw_tpu_torch.runtime.dist import process_topology

    rank, world = process_topology()
    model = load_flax_variables(build_model(ModelCfg(
        width_mult=0.35, dtype="float32", dw_impl="pallas", dropout=0.0,
        freeze_base=False)), variables)
    tx = tstep.make_optimizer(TrainCfg(optimizer="sgd", learning_rate=0.05))
    state = tstep.init_state(model, tx)
    half = slice(rank * DP_BATCH, (rank + 1) * DP_BATCH)
    m = tstep.make_train_step(tx)(state, torch.from_numpy(x[half]),
                                  torch.from_numpy(y[half]), 0)
    return world, float(m["loss"]), to_flax_variables(model)


def test_two_process_gloo_step_matches_jax_two_device_step():
    jmodel, v, x, y = _dp_variables()
    tx = jstep.make_optimizer(JaxTrainCfg(optimizer="sgd", learning_rate=0.05))
    jstate = jstep.TrainState(v["params"], v["batch_stats"],
                              tx.init(v["params"]), jnp.zeros((), jnp.int32))
    mesh = make_mesh(MeshSpec((("data", 2),)), devices=jax.devices()[:2])
    step = jstep.make_train_step(jmodel, tx, mesh, donate=False)
    jnew, jm = step(jstate, jnp.asarray(x), jnp.asarray(y),
                    jax.random.PRNGKey(0))

    (w0, l0, v0), (w1, l1, v1) = spawn_cpu(_dp_worker, 2, v, x, y,
                                           timeout_s=240)
    assert w0 == w1 == 2
    # the ranks are in lockstep: params and averaged BN statistics equal
    assert l0 == l1
    for a, b in zip(jax.tree_util.tree_leaves(v0), jax.tree_util.tree_leaves(v1)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(l0, float(jm["loss"]), rtol=1e-3)
    ref_bs = jax.device_get(jnew.batch_stats)
    for a, b in zip(jax.tree_util.tree_leaves(v0["batch_stats"]),
                    jax.tree_util.tree_leaves(ref_bs)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    # the update -lr * mean(grads): per-rank batches of 8 amplify rounding
    # as test_torch_train_step describes, so the whole update to 5e-2
    upd = [np.asarray(a) - np.asarray(p) for a, p in zip(
        jax.tree_util.tree_leaves(v0["params"]),
        jax.tree_util.tree_leaves(v["params"]))]
    ref = [np.asarray(a) - np.asarray(p) for a, p in zip(
        jax.tree_util.tree_leaves(jax.device_get(jnew.params)),
        jax.tree_util.tree_leaves(v["params"]))]
    num = sum(((a - b) ** 2).sum() for a, b in zip(upd, ref))
    assert (num / sum((b ** 2).sum() for b in ref)) ** 0.5 <= 5e-2
