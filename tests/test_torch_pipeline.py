"""Pipeline parallelism of the port (``ddw_tpu_torch.parallel.pipeline``)
against ``ddw_tpu.parallel.pipeline`` on the CPU.

The port runs in four gloo processes from one ``spawn_cpu``: GPipe over
``pipe=4``, the interleaved schedule (``v=2``), DP x PP over ``(data=2,
pipe=2)`` and MoE with local experts; each rank returns the weights it
holds. The JAX side runs in this process: the single-device LM step and
``ddw_tpu``'s pipeline step under ``shard_map`` on the 8-device CPU mesh,
from the same numpy weights. f32 tolerances: loss 1e-5, accuracy 1e-6,
parameters after one step 1e-5."""

import functools

import numpy as np
import pytest
import torch

from ddw_tpu_torch.runtime.dist import spawn_cpu

N = 4
VOCAB = 32
TINY = dict(vocab_size=VOCAB, max_len=64, hidden=32, num_heads=2,
            mlp_dim=64, dropout=0.0, dtype="float32")
MOE = dict(TINY, depth=4, num_experts=4, capacity_factor=4.0)
# name: (mesh, lm config, schedule, microbatches, virtual stages, batch, seq)
CASES = {
    "gpipe": ((("pipe", 4),), dict(TINY, depth=8), "gpipe", 2, 1, 8, 16),
    "interleaved": ((("pipe", 4),), dict(TINY, depth=8), "interleaved", 2, 2,
                    8, 16),
    "dp_pp": ((("data", 2), ("pipe", 2)), dict(TINY, depth=4), "gpipe", 2, 1,
              8, 16),
    "moe": ((("pipe", 4),), MOE, "gpipe", 2, 1, 4, 12),
}


def _weights(cfg):
    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.utils.config import LMCfg

    return to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**cfg)), torch.Generator().manual_seed(1)))["params"]


def _batch(name):
    _, _, _, _, _, b, s = CASES[name]
    toks = np.random.RandomState(len(name)).randint(0, VOCAB, (b, s + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _tx(name):
    return ("sgd", 0.1)


# ---- the ranks ---------------------------------------------------------------

def _rank(weights):
    from ddw_tpu_torch.models.convert import (load_flax_variables,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.parallel.pipeline import (init_pp_state,
                                                 make_pp_lm_train_step)
    from ddw_tpu_torch.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu_torch.train.step import Optimizer
    from ddw_tpu_torch.utils.config import LMCfg

    torch.set_num_threads(1)
    out = {}
    for name, (axes, cfg, schedule, m, v, _, _) in CASES.items():
        mesh = make_mesh(MeshSpec(axes))
        model = load_flax_variables(build_lm(LMCfg(**cfg)),
                                    {"params": weights[name]})
        opt, lr = _tx(name)
        tx = Optimizer(opt, lr)
        state = init_pp_state(model, tx, mesh, virtual_stages=v)
        data = "data" if "data" in mesh.shape else None
        step = make_pp_lm_train_step(model, tx, mesh, data_axis=data,
                                     num_microbatches=m, schedule=schedule,
                                     virtual_stages=v)
        x, y = _batch(name)
        if data:
            d = mesh.axis_index("data")
            rows = slice(d * len(x) // 2, (d + 1) * len(x) // 2)
            x, y = x[rows], y[rows]
        met = step(state, torch.tensor(x), torch.tensor(y))
        out[name] = ({k: float(val) for k, val in met.items()},
                     to_flax_variables(state.model)["params"],
                     sorted(nm for nm, _ in state.model.named_parameters()))
        if name == "gpipe":
            ev = step.eval_step(state, torch.tensor(x), torch.tensor(y))
            out["eval"] = float(ev["loss"])
            try:
                step(state, torch.tensor(x[:5]), torch.tensor(y[:5]))
                out["divisible"] = None
            except ValueError as e:
                out["divisible"] = str(e)
            istep = make_pp_lm_train_step(model, tx, mesh,
                                          num_microbatches=2,
                                          schedule="interleaved",
                                          virtual_stages=2)
            try:
                istep(state, torch.tensor(x), torch.tensor(y))
                out["layout"] = None
            except ValueError as e:
                out["layout"] = str(e)
    return out


@pytest.fixture(scope="module")
def weights():
    return {name: _weights(case[1]) for name, case in CASES.items()}


@pytest.fixture(scope="module")
def ranks(weights):
    return spawn_cpu(_rank, N, weights, timeout_s=240)


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
    from ddw_tpu.parallel import pipeline as jpp
    from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu.train import lm_step
    from ddw_tpu.train.step import TrainState
    from ddw_tpu.utils.config import LMCfg

    return types.SimpleNamespace(jax=jax, optax=optax, build_lm=build_lm,
                                 pp=jpp, MeshSpec=MeshSpec,
                                 make_mesh=make_mesh, lm_step=lm_step,
                                 TrainState=TrainState, LMCfg=LMCfg)


def _jax_tx(name):
    J = _jax()
    opt, lr = _tx(name)
    return getattr(J.optax, opt)(lr)


def _merged(ranks, name):
    params = {}
    for rk in ranks:
        params.update(rk[name][1])
    return params


def _assert_close(got: dict, want: dict, J):
    flat = dict(J.jax.tree_util.tree_flatten_with_path(got)[0])
    wflat = J.jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(wflat)
    for path, w in wflat:
        np.testing.assert_allclose(flat[path], np.asarray(w), rtol=1e-5,
                                   atol=1e-5,
                                   err_msg=J.jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["gpipe", "interleaved", "dp_pp"])
def test_pipeline_step_matches_single_device(ranks, weights, name):
    """One pipelined SGD step (GPipe, interleaved v=2, DP x PP) equals the
    plain single-device step of ddw_tpu from the same weights: loss,
    accuracy and every updated parameter, gathered from the stages."""
    J = _jax()
    cfg = CASES[name][1]
    model = J.build_lm(J.LMCfg(**cfg))
    mesh = J.make_mesh(J.MeshSpec((("data", 1),)),
                       devices=J.jax.devices()[:1])
    tx = _jax_tx(name)
    params = J.jax.tree_util.tree_map(np.asarray, weights[name])
    state = J.TrainState(params, {}, tx.init(params), np.int32(0))
    step = J.lm_step.make_lm_train_step(model, tx, mesh, seq_axis=None,
                                        donate=False)
    x, y = _batch(name)
    new, m = step(state, x, y, J.jax.random.PRNGKey(0))
    for rk in ranks:
        np.testing.assert_allclose(rk[name][0]["loss"], float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(rk[name][0]["accuracy"],
                                   float(m["accuracy"]), atol=1e-6)
    _assert_close(_merged(ranks, name), new.params, J)


@pytest.mark.parametrize("name", ["moe"])
def test_pipeline_step_matches_jax_pipeline(ranks, weights, name):
    """The same step through ddw_tpu's pipeline (stacked stage params under
    shard_map on four devices; MoE with local experts, whose per-microbatch
    routing only the pipeline reproduces): metrics, the schedule's bubble
    fraction, the aux loss, and the weights back through
    lm_params_from_pp."""
    J = _jax()
    _, cfg, schedule, m, v, _, _ = CASES[name]
    model = J.build_lm(J.LMCfg(**cfg))
    mesh = J.make_mesh(J.MeshSpec((("pipe", N),)),
                       devices=J.jax.devices()[:N])
    tx = _jax_tx(name)
    pp = J.pp.pp_params_from_lm(weights[name], N, cfg["depth"], v)
    state = J.TrainState(pp, {}, tx.init(pp), np.int32(0))
    step = J.pp.make_pp_lm_train_step(model, tx, mesh, num_microbatches=m,
                                      donate=False, schedule=schedule,
                                      virtual_stages=v)
    new, met = step(step.place_state(state), *_batch(name))
    for rk in ranks:
        got = rk[name][0]
        for key in met:
            np.testing.assert_allclose(got[key], float(met[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    want = J.pp.lm_params_from_pp(J.jax.device_get(new.params), N,
                                  cfg["depth"], v)
    _assert_close(_merged(ranks, name), want, J)


def test_stage_local_residency(ranks):
    """Each rank holds the embedding, the head and only its chunks' blocks:
    one block a rank under GPipe (depth 8 over 4: two), chunks r and r + 4
    under the interleaved schedule."""
    for r, rk in enumerate(ranks):
        for name, want in (("gpipe", {2 * r, 2 * r + 1}),
                           ("interleaved", {r, r + 4})):
            names = rk[name][2]
            blocks = {int(n.split(".")[0][len("backbone_block"):])
                      for n in names if n.startswith("backbone_block")}
            assert blocks == want, (name, r, blocks)
            assert "tok_embed.embedding" in names and "head.kernel" in names


def test_params_round_trip_equals_jax(weights):
    """pp_params_from_lm / lm_params_from_pp give ddw_tpu's stacked
    [n, bpc, ...] and [v, n, bpc, ...] layouts and round-trip exactly."""
    from ddw_tpu_torch.parallel import pipeline as tpp

    J = _jax()
    params = weights["gpipe"]
    for n, v in ((4, 1), (2, 1), (4, 2), (2, 2)):
        got = tpp.pp_params_from_lm(params, n, 8, v)
        want = J.pp.pp_params_from_lm(params, n, 8, v)
        _assert_close(got, want, J)
        back = tpp.lm_params_from_pp(got, n, 8, v)
        _assert_close(back, params, J)


def test_bubble_fraction_and_refusals():
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.parallel import pipeline as tpp
    from ddw_tpu_torch.runtime.mesh import Mesh
    from ddw_tpu_torch.train.step import Optimizer
    from ddw_tpu_torch.utils.config import LMCfg

    J = _jax()
    for n, m, v in ((4, 4, 1), (4, 4, 2), (4, 2, 2), (2, 8, 1), (4, 4, 4)):
        assert tpp.bubble_fraction(n, m, v) == pytest.approx(
            J.pp.bubble_fraction(n, m, v))
    assert tpp.bubble_fraction(4, 4, 2) == pytest.approx(3 / 11)
    with pytest.raises(ValueError, match="stall-free"):
        tpp.bubble_fraction(4, 20, 2)
    mesh = Mesh(("pipe",), np.arange(4), {"pipe": None})
    model = build_lm(LMCfg(**dict(TINY, depth=8)))
    tx = Optimizer("sgd", 0.1)
    with pytest.raises(ValueError, match="stall-free"):
        tpp.make_pp_lm_train_step(model, tx, mesh, num_microbatches=8,
                                  schedule="interleaved", virtual_stages=2)
    with pytest.raises(ValueError, match="schedule"):
        tpp.make_pp_lm_train_step(model, tx, mesh, schedule="1f1b")
    with pytest.raises(ValueError, match="virtual_stages"):
        tpp.make_pp_lm_train_step(model, tx, mesh, num_microbatches=2,
                                  schedule="interleaved", virtual_stages=3)
    moe = build_lm(LMCfg(**MOE), expert_axis="data")
    with pytest.raises(ValueError, match="expert parallelism"):
        tpp.make_pp_lm_train_step(moe, tx, mesh)
    drop = build_lm(LMCfg(**dict(TINY, depth=8, dropout=0.1)))
    with pytest.raises(ValueError, match="dropout"):
        tpp.make_pp_lm_train_step(drop, tx, mesh)


def test_step_refusals_in_the_ranks(ranks):
    assert all("num_microbatches" in rk["divisible"] for rk in ranks)
    assert all("layout mismatch" in rk["layout"] for rk in ranks)
    assert len({rk["eval"] for rk in ranks}) == 1
