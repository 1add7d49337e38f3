"""The MoE MLP and expert parallelism of the port (``ddw_tpu_torch.models.
moe``, the LM's ``num_experts`` / ``expert_axis``, the MoE aux loss in
``make_lm_train_step``) against ``ddw_tpu.models.moe`` on the CPU.

Routing runs in this process on the same seeded logits through both
packages and must agree exactly (dispatch, combine, aux loss, telemetry),
capacity and drop order included. The expert-parallel layer and LM step run
in four gloo processes from one ``spawn_cpu``, against the dense layer and
against ``ddw_tpu``'s step under ``shard_map`` on the 8-device CPU mesh.
f32 tolerances: layer outputs 2e-5, the step's loss 1e-5 and its
parameters after one SGD step 1e-5, decode against the full forward 1e-5."""

import functools

import numpy as np
import pytest
import torch

from ddw_tpu_torch.runtime.dist import spawn_cpu

N = 4
VOCAB = 32
LM = dict(vocab_size=VOCAB, max_len=64, hidden=32, depth=2, num_heads=2,
          mlp_dim=64, dtype="float32", num_experts=4, capacity_factor=8.0)


def _layer_params(router):
    """An MoEMlp's weights (flax layout, numpy) drawn through the port."""
    from ddw_tpu_torch.models.convert import init_lm_weights, \
        to_flax_variables
    from ddw_tpu_torch.models.moe import MoEMlp

    m = MoEMlp(16, 4, 32, 16.0, torch.float32, router=router)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        m.gate.kernel.copy_(torch.randn(m.gate.kernel.shape, generator=g))
        m.gate.bias.zero_()
    init_lm_weights(m, g)
    return to_flax_variables(m)["params"]


def _lm_params():
    from ddw_tpu_torch.models.convert import init_lm_weights, \
        to_flax_variables
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.utils.config import LMCfg

    return to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**LM)), torch.Generator().manual_seed(3)))["params"]


def _x():
    return np.random.RandomState(1).randn(8, 6, 16).astype(np.float32)


def _tokens():
    return np.random.RandomState(2).randint(0, VOCAB, (8, 17)).astype(
        np.int32)


# ---- the ranks ---------------------------------------------------------------

def _rank(layer_params, lm_params):
    from ddw_tpu_torch.models.convert import (load_flax_variables,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.models.moe import MoEMlp
    from ddw_tpu_torch.runtime.mesh import MeshSpec, bind_mesh, make_mesh
    from ddw_tpu_torch.train.lm_step import make_lm_train_step
    from ddw_tpu_torch.train.step import Optimizer, TrainState
    from ddw_tpu_torch.utils.config import LMCfg

    torch.set_num_threads(1)
    out = {}
    mesh = make_mesh(MeshSpec((("data", N),)))
    r = mesh.axis_index("data")
    x = torch.tensor(_x()[2 * r:2 * r + 2])
    for router, params in layer_params.items():
        res = {}
        for axis in (None, "data"):
            m = MoEMlp(16, 4, 32, 16.0, torch.float32, expert_axis=axis,
                       router=router)
            load_flax_variables(m, {"params": params})
            with bind_mesh(mesh):
                res[axis] = m(x).detach().numpy()
        out[router] = res
    toks = _tokens()
    xt, yt = (torch.tensor(toks[2 * r:2 * r + 2, :-1]),
              torch.tensor(toks[2 * r:2 * r + 2, 1:]))
    for axis in (None, "data"):
        model = load_flax_variables(
            build_lm(LMCfg(**LM), expert_axis=axis), {"params": lm_params})
        tx = Optimizer("sgd", 0.1)
        state = TrainState(model, tx.init(dict(model.named_parameters())), 0)
        m = make_lm_train_step(model, tx, mesh=mesh)(state, xt, yt, 0)
        out[f"step_{axis}"] = (float(m["loss"]), float(m["accuracy"]),
                               float(m["aux_loss"]),
                               to_flax_variables(model)["params"])
    bad = MoEMlp(8, 6, 16, dtype=torch.float32, expert_axis="data")
    try:
        with bind_mesh(mesh):
            bad(torch.zeros((1, 2, 8)))
        out["divisible"] = None
    except ValueError as e:
        out["divisible"] = str(e)
    return out


@pytest.fixture(scope="module")
def layer_params():
    return {router: _layer_params(router) for router in ("top1", "top2")}


@pytest.fixture(scope="module")
def lm_params():
    return _lm_params()


@pytest.fixture(scope="module")
def ranks(layer_params, lm_params):
    return spawn_cpu(_rank, N, layer_params, lm_params, timeout_s=240)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def _jax():
    import jax

    import ddw_tpu.models.moe as jmoe

    return jax, jmoe


# ---- routing, in process -------------------------------------------------------

def _logits_cases():
    rng = np.random.RandomState(0)
    t, e = 64, 4
    balanced = np.eye(e, dtype=np.float32)[np.arange(t) % e] * 10.0
    collapsed = np.zeros((t, e), np.float32)
    collapsed[:, 0] = 10.0
    return {"random": rng.randn(t, e).astype(np.float32),
            "sharp": rng.randn(12, e).astype(np.float32) * 2,
            "balanced": balanced, "collapsed": collapsed}


@pytest.mark.parametrize("router", ["top1", "top2"])
@pytest.mark.parametrize("case", ["random", "sharp", "balanced", "collapsed"])
@pytest.mark.parametrize("capacity", [1, 2, 16, 64])
def test_routing_equals_jax(router, case, capacity):
    """Dispatch, combine, aux loss and telemetry equal ddw_tpu's on the same
    logits, at ample and tight capacities: the cumulative queue order
    decides which tokens (and which second choices) drop."""
    from ddw_tpu_torch.models import moe as tmoe

    jax, jmoe = _jax()
    logits = _logits_cases()[case]
    got = tmoe.router_fn(router)[0](torch.tensor(logits), capacity)
    want = jmoe.router_fn(router)[0](jax.numpy.asarray(logits), capacity)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    for key in ("drop_rate", "balance_entropy", "expert_frac"):
        np.testing.assert_allclose(got[3][key].numpy(),
                                   np.asarray(want[3][key]), rtol=1e-6,
                                   atol=1e-7)


def test_routing_invariants():
    from ddw_tpu_torch.models.moe import top1_routing, top2_routing

    logits = torch.tensor(_logits_cases()["random"])
    d, c, aux, stats = top1_routing(logits, 64)
    assert torch.allclose(d.sum((1, 2)), torch.ones(64))
    assert torch.allclose(c.sum((1, 2)), torch.softmax(logits, -1).amax(-1))
    assert float(d.sum(0).max()) <= 1.0 and float(stats["drop_rate"]) == 0
    assert float(aux) >= 1.0 - 1e-6
    d2, c2, _, s2 = top2_routing(logits, 64)
    assert torch.allclose(d2.sum((1, 2)), torch.full((64,), 2.0))
    assert torch.allclose(c2.sum((1, 2)), torch.ones(64), atol=1e-6)
    d1, _, _, s1 = top1_routing(logits, 2)
    per_tok = d1.sum((1, 2))
    assert set(per_tok.tolist()) <= {0.0, 1.0}
    assert float(s1["drop_rate"]) == pytest.approx(
        1.0 - float(per_tok.mean()))
    with pytest.raises(ValueError, match="unknown router"):
        from ddw_tpu_torch.models.moe import MoEMlp

        MoEMlp(8, 4, 8, router="top3")


def test_moe_layer_matches_jax(layer_params):
    """The dense MoEMlp forward equals ddw_tpu's from the same weights."""
    from ddw_tpu_torch.models.convert import load_flax_variables
    from ddw_tpu_torch.models.moe import MoEMlp

    jax, jmoe = _jax()
    for router, params in layer_params.items():
        m = load_flax_variables(MoEMlp(16, 4, 32, 16.0, torch.float32,
                                       router=router), {"params": params})
        want = jmoe.MoEMlp(4, 32, 16.0, jax.numpy.float32,
                           router=router).apply({"params": params}, _x())
        np.testing.assert_allclose(m(torch.tensor(_x())).detach().numpy(),
                                   np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("router", ["top1", "top2"])
def test_ep_layer_matches_dense(ranks, router):
    """Experts over four ranks (two all-to-all exchanges) == every expert
    local, each rank routing its own tokens."""
    for rk in ranks:
        np.testing.assert_allclose(rk[router]["data"], rk[router][None],
                                   rtol=2e-5, atol=2e-5)


def test_ep_lm_step_matches_dense_and_jax(ranks, lm_params):
    """One SGD step of the MoE LM with experts over data=4 equals the dense
    step and ddw_tpu's EP step (shard_map, the same weights): loss, token
    accuracy, the Switch aux loss and every updated parameter."""
    import optax

    from ddw_tpu.models.lm import build_lm as jbuild
    from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu.train import lm_step as jlm
    from ddw_tpu.train.step import TrainState
    from ddw_tpu.utils.config import LMCfg as JLMCfg

    jax, _ = _jax()
    mesh = make_mesh(MeshSpec((("data", N),)), devices=jax.devices()[:N])
    model = jbuild(JLMCfg(**LM), expert_axis="data")
    tx = optax.sgd(0.1)
    params = jax.tree_util.tree_map(jax.numpy.asarray, lm_params)
    state = TrainState(params, {}, tx.init(params),
                       jax.numpy.zeros((), jax.numpy.int32))
    step = jlm.make_lm_train_step(model, tx, mesh, seq_axis=None,
                                  donate=False)
    toks = _tokens()
    new, m = step(state, toks[:, :-1], toks[:, 1:], jax.random.PRNGKey(0))
    want = dict(jax.tree_util.tree_flatten_with_path(new.params)[0])
    for rk in ranks:
        for axis in (None, "data"):
            loss, acc, aux, p = rk[f"step_{axis}"]
            np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-5)
            np.testing.assert_allclose(acc, float(m["accuracy"]), atol=1e-6)
            np.testing.assert_allclose(aux, float(m["aux_loss"]), rtol=1e-5)
            for path, got in jax.tree_util.tree_flatten_with_path(p)[0]:
                np.testing.assert_allclose(
                    got, np.asarray(want[path]), rtol=1e-5, atol=1e-5,
                    err_msg=jax.tree_util.keystr(path))


def test_expert_count_must_divide_the_axis(ranks):
    assert all("not divisible" in rk["divisible"] for rk in ranks)


def test_step_rejects_a_foreign_expert_axis():
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.train.lm_step import make_lm_train_step
    from ddw_tpu_torch.train.step import Optimizer
    from ddw_tpu_torch.utils.config import LMCfg

    model = build_lm(LMCfg(**LM), expert_axis="nonexistent")
    with pytest.raises(ValueError, match="expert_axis"):
        make_lm_train_step(model, Optimizer("adam", 1e-3))


def test_decode_path_matches_full_forward(lm_params):
    """KV-cached decode of the MoE LM (every expert local, no drops) equals
    its full forward, prefill and per token, and the full forward equals
    ddw_tpu's from the same weights."""
    from ddw_tpu.models.lm import build_lm as jbuild
    from ddw_tpu.utils.config import LMCfg as JLMCfg
    from ddw_tpu_torch.models.convert import load_flax_variables
    from ddw_tpu_torch.models.lm import build_lm, init_cache
    from ddw_tpu_torch.utils.config import LMCfg

    jax, _ = _jax()
    tokens = np.random.RandomState(0).randint(0, VOCAB, (2, 12))
    model = load_flax_variables(build_lm(LMCfg(**LM)),
                                {"params": lm_params}).eval()
    with torch.no_grad():
        full = model(torch.tensor(tokens))
        prefill = model(torch.tensor(tokens), cache=init_cache(model, 2))
        cache = init_cache(model, 2)
        steps = torch.stack([model(torch.tensor(tokens[:, t:t + 1]),
                                   cache=cache)[:, 0] for t in range(12)], 1)
    np.testing.assert_allclose(prefill.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = jbuild(JLMCfg(**LM)).apply({"params": lm_params}, tokens)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
