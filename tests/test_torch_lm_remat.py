"""Remat, dropout and chained steps of the port's LM training
(``ddw_tpu_torch.models.lm``, ``ddw_tpu_torch.train.lm_step``) on the CPU:
gradients with ``remat="full"`` and ``"dots"`` equal those without (and
``ddw_tpu``'s, the mirror of ``tests/test_lm_remat.py``), seeded dropout
that a remat replay redraws bit for bit, and K chained updates equal to K
single steps."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.train import lm_step as jlm
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
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
def _params(seed):
    """ddw_tpu's initial weights of the BASE LM, as numpy."""
    jm = jax_build_lm(JaxLMCfg(**BASE))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)},
                              np.zeros((1, 8), np.int32))["params"]
    return jax.tree_util.tree_map(np.array, params)


def _batch(seed, b=4, s=16):
    toks = np.random.RandomState(seed).randint(0, VOCAB, (b, s + 1)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


def _grad_tree(model, grads):
    """The port's gradients as a flax-layout tree (through a model holding
    them as its parameters)."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(grads[n])
    return to_flax_variables(model)["params"]


def _assert_trees_close(got, want, rtol, atol, what):
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_allclose(
            np.asarray(flat_g[path]), np.asarray(w), rtol=rtol, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _remat_model(remat, dropout, params, **kw):
    cfg = dict(BASE, remat=remat, dropout=dropout, **kw)
    return load_flax_variables(build_lm(LMCfg(**cfg)), {"params": params})


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_gradients_match_none_and_jax(mode, monkeypatch):
    """remat changes the schedule, never the function: the port's gradients
    with remat equal its own without (within 1e-6) and JAX's (within 1e-5),
    on the kernel tier, where K3's plain version runs twice per block."""
    params = _params(3)
    for mod in (tfa, jfa):
        monkeypatch.setattr(mod, "_XLA_PLAIN_MAX", 0)
        monkeypatch.setattr(mod, "_XLA_CKPT_MAX", 0)
    jm = jax_build_lm(JaxLMCfg(**BASE))
    x, y = _batch(6)
    grads = {}
    for r in ("none", mode):
        tm = _remat_model(r, 0.0, params)
        state = tstep.TrainState(tm, {}, 0)
        loss, _, g = tlm.lm_forward_and_grads(
            state, torch.from_numpy(x), torch.from_numpy(y), None)
        grads[r] = (float(loss), _grad_tree(tm, g))
    assert grads[mode][0] == pytest.approx(grads["none"][0], abs=1e-6)
    _assert_trees_close(grads[mode][1], grads["none"][1], 1e-6, 1e-7,
                        f"remat={mode}")
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jlm.lm_loss(
        jm.apply({"params": p}, jnp.asarray(x), train=True),
        jnp.asarray(y))))(params)
    assert grads[mode][0] == pytest.approx(float(jl), abs=1e-5)
    _assert_trees_close(grads[mode][1], jax.device_get(jg), 1e-5, 1e-6,
                        f"remat={mode} vs jax")


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_dropout_is_seeded_and_replayed_by_remat(mode):
    """Dropout in training mode: the same (seed, rank, step) gives the same
    masks, another step other masks, eval mode none; and with remat the
    recomputed forward draws the first run's masks, so the gradients are
    bit for bit those without remat (the replay trap: torch's checkpoint
    restores only the default RNG states, not a passed generator)."""
    params = _params(4)
    x, y = (torch.from_numpy(a) for a in _batch(7))

    def run(remat, step):
        tm = _remat_model(remat, 0.25, params)
        state = tstep.TrainState(tm, {}, step)
        loss, _, g = tlm.lm_forward_and_grads(
            state, x, y, tstep.dropout_generator(9, 0, step))
        return float(loss), g

    l0, g0 = run("none", 0)
    l0b, g0b = run("none", 0)
    l1, _ = run("none", 1)
    lr, gr = run(mode, 0)
    assert l0 == l0b and l0 != l1
    assert lr == l0
    for n in g0:
        assert torch.equal(g0[n], g0b[n]) and torch.equal(g0[n], gr[n]), n
    tm = _remat_model("none", 0.25, params)
    with pytest.raises(ValueError, match="dropout_rng"):
        tm.train()(x)
    with torch.no_grad():
        no_drop = tlm.lm_loss(_remat_model("none", 0.0, params).train()(x),
                              y)
        eval_loss = tlm.lm_loss(tm.eval()(x), y)
    assert float(eval_loss) == pytest.approx(float(no_drop), abs=1e-6)
    assert abs(l0 - float(no_drop)) > 1e-4


def test_chain_equals_single_steps_with_dropout():
    """K chained updates over a [K, B, S] super-batch equal K single
    steps bit for bit, dropout masks included."""
    params = _params(5)
    xs, ys = zip(*[_batch(20 + k) for k in range(3)])
    x3, y3 = torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(ys))
    results = []
    for chained in (False, True):
        tm = _remat_model("none", 0.1, params)
        tx = tstep.make_optimizer(TrainCfg(optimizer="adam",
                                           learning_rate=1e-2))
        state = tstep.TrainState(tm, tx.init(dict(tm.named_parameters())), 0)
        if chained:
            m = tlm.make_lm_train_chain(tm, tx)(state, x3, y3, 3)
            losses = m["loss"].tolist()
        else:
            step = tlm.make_lm_train_step(tm, tx)
            losses = [float(step(state, x3[k], y3[k], 3)["loss"])
                      for k in range(3)]
        results.append((losses, {n: p.detach().clone()
                                 for n, p in tm.named_parameters()}))
    assert results[0][0] == results[1][0]
    for n, p in results[0][1].items():
        assert torch.equal(p, results[1][1][n]), n
