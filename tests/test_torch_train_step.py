"""The port's train step (``ddw_tpu_torch.train.step``) against
``ddw_tpu.train.step`` on the CPU: the forward/backward in BatchNorm training
mode, every optimizer against optax, frozen masking, the LR plumbing, EMA,
gradient accumulation, the chain, and three SGD steps end to end against the
JAX step on a 1-device mesh. MobileNetV2 width 0.35, 32x32 images, batch 8,
f32, dropout 0; the port's depthwise layers run their plain versions, JAX's
the Pallas kernel in interpret mode where the test compares gradients leaf by
leaf and XLA's grouped conv where it drives the training-mode step (the
kernels' own parity is test_torch_depthwise's)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddw_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
from ddw_tpu.train import step as jstep
from ddw_tpu.utils.config import TrainCfg as JaxTrainCfg
from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.train import step as tstep
from ddw_tpu_torch.utils.config import ModelCfg, TrainCfg

WIDTH, IMG, BATCH = 0.35, 32, 8


def _jax_model(dw_impl="pallas_interpret", freeze_base=False):
    return JaxMobileNetV2(width_mult=WIDTH, dtype=jnp.float32,
                          dw_impl=dw_impl, dropout=0.0,
                          freeze_base=freeze_base)


@functools.lru_cache(maxsize=None)
def _init_variables():
    """flax variables with non-trivial BatchNorm scale, bias and running
    statistics."""
    v = jax.jit(_jax_model("xla").init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)),
        train=False)
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.RandomState(1)
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(v[coll])[0]:
            key = jax.tree_util.keystr(path)
            if key.endswith("['scale']") or key.endswith("['var']"):
                leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
            elif "BatchNorm" in key:
                leaf[...] = rng.uniform(-0.2, 0.2, leaf.shape)
    return v


def _variables():
    return jax.tree_util.tree_map(np.copy, _init_variables())


def _port_model(v, freeze_base=False):
    cfg = ModelCfg(width_mult=WIDTH, dtype="float32", dw_impl="pallas",
                   dropout=0.0, freeze_base=freeze_base,
                   allow_frozen_random=freeze_base)
    with pytest.warns(UserWarning) if freeze_base else _nullcontext():
        model = build_model(cfg)
    return load_flax_variables(model, v)


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _batch(seed, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, IMG, IMG, 3).astype(np.float32),
            rng.randint(0, 5, size=(n,)).astype(np.int32))


def _grads_as_flax(model, grads):
    """Port gradients in flax layout (through the weight mapping)."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in clone.named_parameters():
            g = grads[n]
            p.copy_(g if g is not None else torch.zeros_like(p))
    return to_flax_variables(clone)["params"]


def _assert_trees_close(got, ref, rel, what):
    """Per leaf: max |got - ref| <= rel * max(max |ref_leaf|, 1e-3 * the
    largest |ref| of the tree). The floor is for leaves whose exact value is
    zero and which hold rounding noise only: the bias of a BatchNorm that
    feeds a training-mode BatchNorm (which removes constants) gets no
    gradient in exact arithmetic."""
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_ref) == len(flat_got), what
    scale = max(np.abs(np.asarray(r)).max() for _, r in flat_ref)
    for path, r in flat_ref:
        r = np.asarray(r)
        err = np.abs(np.asarray(flat_got[path]) - r).max()
        assert err <= rel * max(np.abs(r).max(), 1e-3 * scale), \
            (what, jax.tree_util.keystr(path), err, np.abs(r).max())


def _tree_rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| over every leaf of the tree."""
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)
    num = sum(float(((np.asarray(p) - np.asarray(q)) ** 2).sum())
              for p, q in zip(a, b))
    return (num / sum(float((np.asarray(q) ** 2).sum()) for q in b)) ** 0.5


def test_forward_and_grads_bn_training_mode_matches_jax():
    v = _variables()
    x, y = _batch(0)
    jmodel = _jax_model("xla")
    jstate = jstep.TrainState(v["params"], v["batch_stats"], None,
                              jnp.zeros((), jnp.int32))
    fg = jax.jit(functools.partial(jstep.forward_and_grads, jmodel))
    loss_j, acc_j, bs_j, g_j = fg(jstate, jnp.asarray(x), jnp.asarray(y),
                                  jax.random.PRNGKey(0))

    model = _port_model(v)
    state = tstep.TrainState(model, {}, 0)
    loss, acc, _, grads = tstep.forward_and_grads(
        state, torch.from_numpy(x), torch.from_numpy(y),
        tstep.dropout_generator(0, 0, 0))
    # Batch statistics of 8 images whose last stages are 2x2 and 1x1 make
    # this network amplify rounding: a 1e-6 relative change of the input
    # moves JAX's own features by ~1.5e-3 and, where a ReLU6 input near 0
    # changes side, its gradients by up to ~2% (global L2). Hence 1e-4 on
    # the loss and the running statistics, 1e-3 on the head, 5e-2 on the
    # whole gradient; the backward itself is held tightly (1e-4 per leaf)
    # with eval-mode BatchNorm below.
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    assert float(acc) == float(acc_j)
    # running statistics: fast variance, biased, m * ra + (1 - m) * batch
    _assert_trees_close(to_flax_variables(model)["batch_stats"],
                        jax.device_get(bs_j), 1e-4, "batch_stats")
    got, ref = _grads_as_flax(model, grads), jax.device_get(g_j)
    _assert_trees_close(got["head"], ref["head"], 1e-3, "head grads")
    assert _tree_rel_l2(got, ref) <= 5e-2


def test_backward_matches_jax_grad_through_pallas_interpret():
    # Every leaf's gradient, BatchNorm on its running statistics (no batch
    # statistics to amplify rounding); the depthwise layers are the Pallas
    # kernel in interpret mode in JAX and the Function's plain path here.
    v = _variables()
    x, y = _batch(1)
    jmodel = _jax_model("pallas_interpret")

    def loss_fn(params):
        logits = jmodel.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, x,
                              train=False)
        return jstep.cross_entropy_loss(logits, y)

    ref = jax.device_get(jax.jit(jax.grad(loss_fn))(v["params"]))
    model = _port_model(v).eval()
    loss = tstep.cross_entropy_loss(model(torch.from_numpy(x)),
                                    torch.from_numpy(y))
    named = list(model.named_parameters())
    grads = dict(zip([n for n, _ in named],
                     torch.autograd.grad(loss, [p for _, p in named])))
    _assert_trees_close(_grads_as_flax(model, grads), ref, 1e-4, "grads")


OPT_CASES = [
    ("adam", {}, ()),
    ("adamw", {"weight_decay": 1e-2}, ()),
    ("adadelta", {"learning_rate": 1.0}, ()),
    ("sgd", {}, ()),
    ("adam", {"grad_clip_norm": 0.5}, ()),
    ("adam", {"moment_dtype": "bfloat16"}, ()),
    ("sgd", {"moment_dtype": "bfloat16"}, ()),
    ("adam", {"grad_clip_norm": 0.5}, ("backbone",)),
]


@pytest.mark.parametrize("name,kw,frozen", OPT_CASES)
def test_optimizer_matches_optax(name, kw, frozen):
    rng = np.random.RandomState(2)
    params = {"backbone": {"k": rng.randn(4, 3).astype(np.float32)},
              "head": {"b": rng.randn(5).astype(np.float32)}}
    grads = [{"backbone": {"k": 2 * rng.randn(4, 3).astype(np.float32)},
              "head": {"b": 2 * rng.randn(5).astype(np.float32)}}
             for _ in range(3)]
    kw = {"learning_rate": 1e-2, **kw}
    tx = jstep.make_optimizer(JaxTrainCfg(optimizer=name, **kw), frozen)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    opt = tstep.make_optimizer(TrainCfg(optimizer=name, **kw), frozen)
    tp = {"backbone.k": torch.tensor(params["backbone"]["k"]),
          "head.b": torch.tensor(params["head"]["b"])}
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        gt = {"backbone.k": None if frozen else torch.tensor(g["backbone"]["k"]),
              "head.b": torch.tensor(g["head"]["b"])}
        opt.update(tp, gt, ts)
        np.testing.assert_allclose(tp["backbone.k"].numpy(),
                                   np.asarray(jp["backbone"]["k"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tp["head.b"].numpy(),
                                   np.asarray(jp["head"]["b"]),
                                   rtol=1e-6, atol=1e-7)
    if frozen:
        np.testing.assert_array_equal(tp["backbone.k"].numpy(),
                                      params["backbone"]["k"])
        assert all("backbone.k" not in d for d in ts.values()
                   if isinstance(d, dict))
    if kw.get("moment_dtype") == "bfloat16":
        moment = ts["mu"] if name == "adam" else ts["trace"]
        assert moment["head.b"].dtype == torch.bfloat16


def test_optimizer_refusals_match_jax():
    for kw, err in (({"optimizer": "adam", "weight_decay": 0.1}, ValueError),
                    ({"optimizer": "adadelta", "moment_dtype": "bfloat16"},
                     ValueError),
                    ({"moment_dtype": "float16"}, ValueError),
                    ({"optimizer": "lamb"}, KeyError)):
        with pytest.raises(err):
            jstep.make_optimizer(JaxTrainCfg(**kw))
        with pytest.raises(err):
            tstep.make_optimizer(TrainCfg(**kw))


def test_lr_plumbing_and_ema_match_optax():
    rng = np.random.RandomState(3)
    p0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) for _ in range(3)]
    cfg = dict(optimizer="adam", learning_rate=1e-2)
    tx = jstep.with_param_ema(jstep.make_optimizer(JaxTrainCfg(**cfg)), 0.9)
    jp = {"w": jnp.asarray(p0)}
    js = tx.init(jp)
    jstate = jstep.TrainState(jp, {}, js, jnp.zeros((), jnp.int32))
    jstate = jstep.set_lr(jstate, 0.05)
    js = jstate.opt_state

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.tensor(p0))
    opt = tstep.with_param_ema(tstep.make_optimizer(TrainCfg(**cfg)), 0.9)
    state = tstep.init_state(model, opt)
    assert tstep.get_lr(state) == pytest.approx(1e-2)
    tstep.set_lr(state, 0.05)
    assert tstep.get_lr(state) == pytest.approx(0.05)
    assert tstep.get_lr(state) == pytest.approx(jstep.get_lr(jstate))
    for g in grads:
        upd, js = tx.update({"w": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(state.params, {"w": torch.tensor(g)}, state.opt_state)
    np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tstep.ema_params(state)["w"].numpy(),
                               np.asarray(js.shadow["w"]), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="ema decay"):
        tstep.with_param_ema(opt.inner, 1.0)


def test_frozen_base_masks_updates_and_bn_stats():
    v = _variables()
    model = _port_model(v, freeze_base=True)
    opt = tstep.make_optimizer(TrainCfg(optimizer="adam", learning_rate=0.1),
                               model.frozen_prefixes(True))
    state = tstep.init_state(model, opt)
    before = {n: t.detach().clone()
              for n, t in {**state.params, **state.batch_stats}.items()}
    step = tstep.make_train_step(opt)
    x, y = _batch(4)
    m = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
    assert np.isfinite(float(m["loss"])) and state.step == 1
    for n, t in {**state.params, **state.batch_stats}.items():
        same = torch.equal(t, before[n])
        assert same == n.startswith("backbone"), n
    assert set(state.opt_state["mu"]) == {"head.weight", "head.bias"}


def test_grad_accum_matches_jax_accumulate():
    # BatchNorm statistics thread through the two microbatches in order.
    v = _variables()
    x, y = _batch(5)
    jmodel = _jax_model("xla")
    jstate = jstep.TrainState(v["params"], v["batch_stats"], None,
                              jnp.zeros((), jnp.int32))
    acc_fn = jax.jit(functools.partial(jstep.accumulate_grads, jmodel),
                     static_argnames="accum")
    loss_j, _, bs_j, g_j = acc_fn(jstate, jnp.asarray(x), jnp.asarray(y),
                                  jax.random.PRNGKey(0), accum=2)
    model = _port_model(v)
    state = tstep.TrainState(model, {}, 0)
    loss, _, _, grads = tstep.accumulate_grads(
        state, torch.from_numpy(x), torch.from_numpy(y), 0, 0, 2)
    # microbatches of 4 condition worse than the batch of 8 above: 1e-3
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-3)
    _assert_trees_close(to_flax_variables(model)["batch_stats"],
                        jax.device_get(bs_j), 1e-3, "batch_stats")
    assert _tree_rel_l2(_grads_as_flax(model, grads), jax.device_get(g_j)) \
        <= 5e-2
    with pytest.raises(ValueError, match="not divisible"):
        tstep.accumulate_grads(state, torch.from_numpy(x[:3]),
                               torch.from_numpy(y[:3]), 0, 0, 2)


def test_chain_equals_per_step_with_dropout():
    # Inside the port, bit for bit: the chain draws each step's dropout mask
    # from (seed, rank, step) as the per-step path does.
    v = _variables()
    cfg = ModelCfg(width_mult=WIDTH, dtype="float32", dw_impl="pallas",
                   dropout=0.5, freeze_base=False)
    xs, ys = zip(*(_batch(10 + k) for k in range(3)))
    finals = []
    for chained in (False, True):
        model = load_flax_variables(build_model(cfg), v)
        opt = tstep.make_optimizer(TrainCfg(optimizer="adam"))
        state = tstep.init_state(model, opt)
        if chained:
            m = tstep.make_train_chain(opt)(
                state, torch.from_numpy(np.stack(xs)),
                torch.from_numpy(np.stack(ys)), 7)
            losses = m["loss"].tolist()
        else:
            step = tstep.make_train_step(opt)
            losses = [float(step(state, torch.from_numpy(x),
                                 torch.from_numpy(y), 7)["loss"])
                      for x, y in zip(xs, ys)]
        finals.append((losses, to_flax_variables(model), state.step))
    (l0, v0, s0), (l1, v1, s1) = finals
    assert l0 == l1 and s0 == s1 == 3
    for a, b in zip(jax.tree_util.tree_leaves(v0),
                    jax.tree_util.tree_leaves(v1)):
        np.testing.assert_array_equal(a, b)
    # the same seed draws the same mask, another seed another
    u = [torch.rand(4, generator=tstep.dropout_generator(s, 0, 2))
         for s in (1, 1, 2)]
    assert torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])


def test_chain_plan_and_metric_mean():
    assert tstep.chain_plan(7, 1) == (1,) * 7
    assert tstep.chain_plan(7, 3) == (3, 3, 1)
    assert tstep.chain_plan(6, 3) == jstep.chain_plan(6, 3)
    with pytest.raises(ValueError):
        tstep.chain_plan(0, 2)
    vals = [torch.tensor(1.0), torch.tensor([2.0, 3.0])]
    assert tstep.fetch_metrics_mean(vals) == 2.0
    assert np.isnan(tstep.fetch_metrics_mean([]))


def test_three_sgd_steps_match_jax_train_step():
    # The transfer-learning step (freeze_base: the backbone in inference
    # mode, only the head trains) end to end against the JAX step on a
    # 1-device mesh. Unfrozen, three steps of this network at batch 8 are
    # chaotic: a 1e-6 relative change of the input moves the params of
    # either package by several percent after three steps, so the unfrozen
    # path is held one step at a time (the tests above).
    v = _variables()
    batches = [_batch(20 + k) for k in range(3)]
    cfg = dict(optimizer="sgd", learning_rate=0.05)
    jmodel = _jax_model("xla", freeze_base=True)
    tx = jstep.make_optimizer(JaxTrainCfg(**cfg), ("backbone",))
    jstate = jstep.TrainState(
        jax.tree_util.tree_map(jnp.asarray, v["params"]),
        jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        tx.init(v["params"]), jnp.zeros((), jnp.int32))
    mesh = make_mesh(MeshSpec((("data", 1),)), devices=jax.devices()[:1])
    jstep_fn = jstep.make_train_step(jmodel, tx, mesh, donate=False)

    model = _port_model(v, freeze_base=True)
    opt = tstep.make_optimizer(TrainCfg(**cfg), model.frozen_prefixes(True))
    state = tstep.init_state(model, opt)
    step = tstep.make_train_step(opt)
    for x, y in batches:
        jstate, jm = jstep_fn(jstate, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(1))
        m = step(state, torch.from_numpy(x), torch.from_numpy(y), 1)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    got = to_flax_variables(model)
    _assert_trees_close(got["params"], jax.device_get(jstate.params), 1e-5,
                        "params")
    _assert_trees_close(got["batch_stats"],
                        jax.device_get(jstate.batch_stats), 1e-6,
                        "batch_stats")
    assert state.step == int(jstate.step) == 3
