"""The LM train step of the PyTorch port (``ddw_tpu_torch.train.lm_step``)
against ``ddw_tpu.train.lm_step`` on the CPU: one step and a three-step
trajectory from the same weights (learned and rotary positions, GQA, adam
and sgd, the ``xla`` tier and the kernel tier with the Pallas kernels in
interpret mode against the plain versions of K3-K5), per-leaf gradients,
the LoRA step with the base frozen, and inside the port gradient
accumulation (remat, dropout and chains: test_torch_lm_remat.py)."""

import copy
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
from ddw_tpu.train import lm_step as jlm
from ddw_tpu.train import step as jstep
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu.utils.config import TrainCfg as JaxTrainCfg
from ddw_tpu_torch.models import lora as tlora
from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.models.lm import build_lm
from ddw_tpu_torch.ops import flash_attention as tfa
from ddw_tpu_torch.train import lm_step as tlm
from ddw_tpu_torch.train import step as tstep
from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

jfa = importlib.import_module("ddw_tpu.ops.flash_attention")

VOCAB = 32
BASE = dict(vocab_size=VOCAB, max_len=64, hidden=32, depth=2, num_heads=4,
            mlp_dim=64, dropout=0.0, dtype="float32")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test: under several test workers per host,
    torch's default pool (one thread per core, in every worker) spends its
    time waiting at OpenMP barriers for descheduled threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def _params(seed, kw):
    jm = jax_build_lm(JaxLMCfg(**dict(BASE, **dict(kw))))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)},
                              np.zeros((1, 8), np.int32))["params"]
    return jax.tree_util.tree_map(np.array, params)


def _setup(seed=0, **kw):
    """(jax model, flax params as numpy, a fresh port model with them)."""
    key = tuple(sorted(kw.items()))
    params = _params(seed, key)
    cfg = dict(BASE, **kw)
    jm = jax_build_lm(JaxLMCfg(**cfg))
    tm = load_flax_variables(build_lm(LMCfg(**cfg)), {"params": params})
    return jm, params, tm


def _batch(seed, b=4, s=16):
    toks = np.random.RandomState(seed).randint(0, VOCAB, (b, s + 1)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


def _grad_tree(model, grads):
    """The port's gradients as a flax-layout tree (through a clone holding
    them as its parameters)."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in clone.named_parameters():
            p.copy_(grads[n] if grads[n] is not None else torch.zeros_like(p))
    return to_flax_variables(clone)["params"]


def _assert_trees_close(got, want, rtol, atol, what, skip=()):
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        if any(s in jax.tree_util.keystr(path) for s in skip):
            continue
        np.testing.assert_allclose(
            np.asarray(flat_g[path]), np.asarray(w), rtol=rtol, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _force_kernel_tier(monkeypatch):
    for mod in (tfa, jfa):
        monkeypatch.setattr(mod, "_XLA_PLAIN_MAX", 0)
        monkeypatch.setattr(mod, "_XLA_CKPT_MAX", 0)


def _jax_loss_grads(jm, params, x, y):
    def loss(p):
        return jlm.lm_loss(jm.apply({"params": p}, jnp.asarray(x),
                                    train=True), jnp.asarray(y))
    return jax.jit(jax.value_and_grad(loss))(params)


CASES = {
    "learned-adam-xla": (dict(), "adam", False),
    "rope-sgd-kernel": (dict(pos_encoding="rope"), "sgd", True),
    "gqa-adam-kernel": (dict(num_kv_heads=2), "adam", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case, monkeypatch):
    """Loss and token accuracy of each step within 1e-5, the first step's
    per-leaf gradients within 1e-5 (f32: only the order of sums differs),
    params after three sgd updates (lr 1e-2) within 2e-5 relative plus
    1e-6, and after three adam updates (lr 1e-3) within 2e-5 relative plus
    0.2 * lr but for the key projection. Adam moves an element by about lr
    whatever its gradient's size; each query row's ds sums to zero, so the
    key projection's gradient cancels (exactly, for its bias, to which
    softmax is invariant) and some of its elements sit at the rounding
    floor, where both packages step by noise scaled to lr. The losses,
    which the key projection feeds, hold it to 1e-5."""
    kw, opt, kernel_tier = CASES[case]
    jm, params, tm = _setup(**kw)
    if kernel_tier:
        _force_kernel_tier(monkeypatch)
    lr = 1e-3 if opt == "adam" else 1e-2
    cfg = dict(optimizer=opt, learning_rate=lr)
    jtx = jstep.make_optimizer(JaxTrainCfg(**cfg))
    jstate = jstep.TrainState(jax.tree_util.tree_map(jnp.asarray, params),
                              {}, jtx.init(params), jnp.zeros((), jnp.int32))
    mesh = make_mesh(MeshSpec((("data", 1),)), devices=jax.devices()[:1])
    jfn = jlm.make_lm_train_step(jm, jtx, mesh, seq_axis=None, donate=False)
    tx = tstep.make_optimizer(TrainCfg(**cfg))
    state = tstep.TrainState(tm, tx.init(dict(tm.named_parameters())), 0)
    step = tlm.make_lm_train_step(tm, tx)

    x, y = _batch(1)
    calls = []
    plain = tfa.flash_attention_dq_plain
    monkeypatch.setattr(tfa, "flash_attention_dq_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    _, _, g = tlm.lm_forward_and_grads(state, torch.from_numpy(x),
                                       torch.from_numpy(y), None)
    assert len(calls) == (BASE["depth"] if kernel_tier else 0)
    _, jg = _jax_loss_grads(jm, params, x, y)
    _assert_trees_close(_grad_tree(tm, g), jax.device_get(jg), 1e-5, 1e-6,
                        "grad")
    for k in range(3):
        x, y = _batch(10 + k)
        jstate, jmet = jfn(jstate, jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(k))
        m = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["accuracy"]),
                                   float(jmet["accuracy"]), atol=1e-6)
    _assert_trees_close(to_flax_variables(tm)["params"],
                        jax.device_get(jstate.params), 2e-5,
                        0.2 * lr if opt == "adam" else 1e-6, "param",
                        skip=("['key']",) if opt == "adam" else ())
    assert state.step == int(jstate.step) == 3


def test_grad_accum_equals_one_full_batch_step():
    """grad_accum_steps=2 equals one full-batch step (dropout off, sgd, so
    the update is linear in the gradients): loss within 1e-6, params within
    1e-6."""
    _, _, tm1 = _setup(seed=2)
    _, _, tm2 = _setup(seed=2)
    x, y = (torch.from_numpy(a) for a in _batch(4, b=8))
    out = []
    for tm, accum in ((tm1, 1), (tm2, 2)):
        tx = tstep.make_optimizer(TrainCfg(optimizer="sgd",
                                           learning_rate=0.1))
        state = tstep.TrainState(tm, tx.init(dict(tm.named_parameters())), 0)
        out.append(tlm.make_lm_train_step(tm, tx, accum)(state, x, y, 5))
    assert abs(float(out[0]["loss"]) - float(out[1]["loss"])) < 1e-6
    for (n, a), (_, b) in zip(tm1.named_parameters(), tm2.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, err_msg=n)
    with pytest.raises(ValueError, match="not divisible"):
        tx = tstep.make_optimizer(TrainCfg())
        tlm.make_lm_train_step(tm1, tx, 3)(
            tstep.TrainState(tm1, tx.init(dict(tm1.named_parameters())), 0),
            x, y, 0)


LORA = dict(lora_rank=2, lora_targets=("query", "value", "fc1"))


def test_lora_step_matches_jax_and_moves_only_adapters_and_head():
    """The LoRA mask is applied by the step itself (``_maybe_lora_tx``):
    three adam steps equal JAX's within 2e-5, adapters and head move, every
    base leaf stays bit for bit, and the optimizer keeps no state for it."""
    jm, params, tm = _setup(seed=6, **LORA)
    rng = np.random.RandomState(6)
    params = jax.tree_util.tree_map(np.copy, params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if jax.tree_util.keystr(path).endswith("['lora_b']"):
            leaf[...] = 0.1 * rng.randn(*leaf.shape)
    tm = load_flax_variables(tm, {"params": params})
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    jtx = jstep.make_optimizer(JaxTrainCfg(learning_rate=1e-2))
    jstate = jstep.TrainState(jax.tree_util.tree_map(jnp.asarray, params),
                              {}, jlm._maybe_lora_tx(jm, jtx).init(params),
                              jnp.zeros((), jnp.int32))
    mesh = make_mesh(MeshSpec((("data", 1),)), devices=jax.devices()[:1])
    jfn = jlm.make_lm_train_step(jm, jtx, mesh, seq_axis=None, donate=False)
    tx = tstep.make_optimizer(TrainCfg(learning_rate=1e-2))
    masked = tlm._maybe_lora_tx(tm, tx)
    state = tstep.TrainState(tm, masked.init(dict(tm.named_parameters())), 0)
    assert set(state.opt_state["mu"]) == {
        n for n in before if tlora.is_lora_trainable(n)}
    step = tlm.make_lm_train_step(tm, tx)     # a plain optimizer
    for k in range(3):
        x, y = _batch(30 + k)
        jstate, jmet = jfn(jstate, jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(k))
        m = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    _assert_trees_close(to_flax_variables(tm)["params"],
                        jax.device_get(jstate.params), 2e-5, 1e-5, "param")
    for n, p in tm.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved == tlora.is_lora_trainable(n), n


def test_lora_mask_merge_and_count():
    """lora_mask, merge_base_params (with its three errors) and
    count_trainable, as ``ddw_tpu.models.lora``'s."""
    from ddw_tpu.models import lora as jlora

    params = {
        "backbone": {"attn": {"kernel": np.zeros((2, 2), np.float32),
                              "lora_a": np.zeros((2, 1), np.float32),
                              "lora_b": np.zeros((1, 2), np.float32)}},
        "head": {"kernel": np.zeros((2, 2), np.float32)},
    }
    mask = tlora.lora_mask(params)
    assert mask == jlora.lora_mask(params)
    assert mask["backbone"]["attn"] == {"kernel": False, "lora_a": True,
                                        "lora_b": True}
    flat = {"backbone.attn.kernel": 0, "backbone.attn.lora_b": 0,
            "head.kernel": 0}
    assert tlora.lora_mask(flat) == {"backbone.attn.kernel": False,
                                     "backbone.attn.lora_b": True,
                                     "head.kernel": True}
    assert tlora.count_trainable(params) == jlora.count_trainable(params) \
        == (8, 12)
    base = {"backbone": {"attn": {"kernel": np.ones((2, 2), np.float32)}}}
    merged = tlora.merge_base_params(params, base)
    assert (merged["backbone"]["attn"]["kernel"] == 1).all()
    assert merged["backbone"]["attn"]["lora_a"] is \
        params["backbone"]["attn"]["lora_a"]
    for bad, match in (
            ({"backbone": {"mlp": {"kernel": np.ones((2, 2))}}}, "absent"),
            ({"backbone": {"attn": {"kernel": np.ones((3, 2))}}}, "shape"),
            ({"head": {"kernel": {"x": np.ones(1)}}}, "subtree")):
        with pytest.raises(ValueError, match=match):
            tlora.merge_base_params(params, bad)
        with pytest.raises(ValueError, match=match):
            jlora.merge_base_params(params, bad)


def test_frozen_leaves_get_no_update_under_adamw_and_ema():
    """A leaf-level mask on the port's optimizer: frozen leaves keep their
    bits and get no moments under adamw's weight decay, and an EMA wrap
    changes nothing about that."""
    _, params, tm = _setup(seed=7, **LORA)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tx = tstep.with_param_ema(tlora.lora_optimizer(tstep.make_optimizer(
        TrainCfg(optimizer="adamw", weight_decay=0.1, learning_rate=1e-2))),
        0.9)
    state = tstep.TrainState(tm, tx.init(dict(tm.named_parameters())), 0)
    step = tlm.make_lm_train_step(tm, tx)
    for k in range(2):
        x, y = _batch(40 + k)
        step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
    inner = state.opt_state["inner"]
    for n, p in tm.named_parameters():
        trainable = tlora.is_lora_trainable(n)
        assert (n in inner["mu"]) == trainable, n
        assert torch.equal(p, before[n]) != trainable, n


def test_init_lm_state_and_refusals():
    """init_lm_state draws flax's initialisers from the generator and masks
    a LoRA model's optimizer; sequence parallelism is refused naming the
    roadmap."""
    tm = build_lm(LMCfg(**dict(BASE, **LORA)))
    tx = tstep.make_optimizer(TrainCfg())
    state = tlm.init_lm_state(tm, tx, torch.Generator().manual_seed(0))
    assert all(tlora.is_lora_trainable(n) for n in state.opt_state["mu"])
    again = tlm.init_lm_state(build_lm(LMCfg(**dict(BASE, **LORA))), tx,
                              torch.Generator().manual_seed(0))
    for (n, a), (_, b) in zip(state.model.named_parameters(),
                              again.model.named_parameters()):
        assert torch.equal(a, b), n
    for fn in (tlm.make_lm_train_step, tlm.make_lm_train_chain):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn(tm, tx, seq_axis="seq")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlm.make_lm_eval_step(tm, seq_axis="seq")


def test_eval_step_matches_jax_and_reads_params():
    jm, params, tm = _setup(seed=8)
    x, y = _batch(50)
    state = tstep.TrainState(tm, {}, 0)
    ev = tlm.make_lm_eval_step(tm)
    m = ev(state, torch.from_numpy(x), torch.from_numpy(y))
    mesh = make_mesh(MeshSpec((("data", 1),)), devices=jax.devices()[:1])
    jm_ = jlm.make_lm_eval_step(jm, mesh, seq_axis=None)(
        jstep.TrainState(params, {}, (), 0), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    assert float(m["accuracy"]) == pytest.approx(float(jm_["accuracy"]))
    zeros = {n: torch.zeros_like(p) for n, p in tm.named_parameters()}
    mz = ev(state, torch.from_numpy(x), torch.from_numpy(y), zeros)
    assert float(mz["loss"]) == pytest.approx(np.log(VOCAB), abs=1e-5)
    assert torch.equal(ev(state, torch.from_numpy(x),
                          torch.from_numpy(y))["loss"], m["loss"])

