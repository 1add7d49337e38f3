"""Tensor-parallel training of the port (``ddw_tpu_torch.parallel.sharding``
and the FSDP x TP step of ``parallel.zero``) against
``ddw_tpu.parallel.sharding`` / ``parallel.zero`` on the CPU.

Rule resolution, divisibility errors and the decode-cache placement are
compared in this process on the same trees. The steps run in four gloo
processes from one ``spawn_cpu`` over ``(data=2, model=2)``: the ViT
DP x TP step (Megatron column/row layers over the ``model`` group) and the
FSDP x TP 2-D step, and the LM DP x TP step with its vocab-split embedding
and head, each against ``ddw_tpu``'s GSPMD step on a 4-device CPU mesh from
the same weights (SGD). f32 tolerances: loss 1e-5, parameters after one
step 1e-5."""

import functools
import warnings

import numpy as np
import pytest
import torch

from ddw_tpu_torch.runtime.dist import spawn_cpu

N = 4
VIT = dict(name="vit", num_classes=5, dropout=0.0, dtype="float32")
LM = dict(vocab_size=32, max_len=32, hidden=32, depth=2, num_heads=4,
          num_kv_heads=2, mlp_dim=64, dtype="float32")
LR = 0.1


def _vit_params():
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.layers import init_params
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.utils.config import ModelCfg

    m = build_model(ModelCfg(**VIT), image_size=(32, 32))
    init_params(m, torch.Generator().manual_seed(0))
    return to_flax_variables(m)["params"]


def _lm_params():
    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.utils.config import LMCfg

    return to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**LM)), torch.Generator().manual_seed(1)))["params"]


def _images():
    rng = np.random.RandomState(0)
    return (rng.rand(8, 32, 32, 3).astype(np.float32),
            rng.randint(0, 5, (8,)).astype(np.int32))


def _tokens():
    t = np.random.RandomState(2).randint(0, 32, (8, 13)).astype(np.int32)
    return t[:, :-1], t[:, 1:]


# ---- the ranks ---------------------------------------------------------------

def _rank(vit_params, lm_params):
    from ddw_tpu_torch.models.convert import (load_flax_variables,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.parallel.sharding import (LM_TP_RULES, VIT_TP_RULES,
                                                 make_sharded_train_step)
    from ddw_tpu_torch.parallel.zero import make_fsdp_tp_train_step
    from ddw_tpu_torch.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu_torch.train.step import Optimizer, init_state
    from ddw_tpu_torch.utils.config import LMCfg, ModelCfg

    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec((("data", 2), ("model", 2))))
    d = mesh.axis_index("data")
    rows = slice(4 * d, 4 * d + 4)
    out = {}
    cases = {"vit_tp": ("vit", make_sharded_train_step, VIT_TP_RULES),
             "vit_fsdp_tp": ("vit", make_fsdp_tp_train_step, VIT_TP_RULES),
             "lm_tp": ("lm", make_sharded_train_step, LM_TP_RULES)}
    for name, (family, make, rules) in cases.items():
        if family == "vit":
            model = build_model(ModelCfg(**VIT), image_size=(32, 32))
            load_flax_variables(model, {"params": vit_params})
            x, y = _images()
        else:
            model = load_flax_variables(build_lm(LMCfg(**LM)),
                                        {"params": lm_params})
            x, y = _tokens()
        tx = Optimizer("sgd", LR)
        state = init_state(model, tx)
        step = make(model, tx, mesh, rules)
        m = step(state, torch.tensor(x[rows]), torch.tensor(y[rows]), 0)
        lay = state.layout
        held = {n: tuple(p.shape) for n, p in model.named_parameters()}
        if lay.fsdp:
            held = {n: tuple(t.shape) for n, t in lay.shards.items()}
        full = lay.full_params(model)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.data = full[n]
        out[name] = (float(m["loss"]), to_flax_variables(model)["params"],
                     held, dict(lay.rest))
    return out


@pytest.fixture(scope="module")
def params():
    return _vit_params(), _lm_params()


@pytest.fixture(scope="module")
def ranks(params):
    return spawn_cpu(_rank, N, *params, timeout_s=240)


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
    from ddw_tpu.parallel import sharding as jsh
    from ddw_tpu.parallel import zero as jzero
    from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu.train.step import TrainState
    from ddw_tpu.utils.config import LMCfg, ModelCfg

    mesh = make_mesh(MeshSpec((("data", 2), ("model", 2))),
                     devices=jax.devices()[:N])
    return types.SimpleNamespace(jax=jax, optax=optax, build_lm=build_lm,
                                 build_model=build_model, sh=jsh, zero=jzero,
                                 mesh=mesh, TrainState=TrainState,
                                 LMCfg=LMCfg, ModelCfg=ModelCfg)


def _jax_specs(tree) -> dict:
    J = _jax()
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(s.spec)
            for path, s in J.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tmesh():
    from ddw_tpu_torch.runtime.mesh import Mesh

    return Mesh(("data", "model"), np.arange(4).reshape(2, 2),
                {"data": None, "model": None})


# ---- rules, in process ----------------------------------------------------------

@pytest.mark.parametrize("which", ["VIT_TP_RULES", "LM_TP_RULES",
                                   "LM_TP_RULES_REPLICATED_KV"])
def test_rule_resolution_equals_jax(params, which):
    """Every leaf resolves to ddw_tpu's spec (fc1 column-split on its output
    dim, the attention heads, the vocab of the embedding and head)."""
    from ddw_tpu_torch.parallel import sharding as tsh

    J = _jax()
    tree = params[0] if which == "VIT_TP_RULES" else params[1]
    if which == "LM_TP_RULES_REPLICATED_KV":
        tree = _lm_params()
    want = _jax_specs(J.sh.shardings_for_params(tree, J.mesh,
                                                getattr(J.sh, which)))
    got = tsh.shardings_for_params(tree, _tmesh(), getattr(tsh, which))
    assert {k: tuple(v) for k, v in got.items()} == want
    if which == "VIT_TP_RULES":
        assert got["backbone_block0/mlp/fc1/kernel"] == (None, "model")


def test_divisibility_errors_and_lm_rules_for():
    from ddw_tpu_torch.parallel import sharding as tsh

    J = _jax()
    with pytest.raises(ValueError, match="not divisible"):
        tsh.check_spec_divisibility("k", (3, 8), tsh.P("model"), _tmesh())
    with pytest.raises(ValueError, match="not divisible"):
        J.sh.check_spec_divisibility(
            "k", (3, 8), J.jax.sharding.PartitionSpec("model"), J.mesh)
    tsh.check_spec_divisibility("k", (4, 8), tsh.P("model", "data"),
                                _tmesh())
    for mod in (tsh, J.sh):
        rules, kv = mod.lm_tp_rules_for(4, 2, 2)
        assert rules is mod.LM_TP_RULES and kv
        with pytest.raises(ValueError, match="does not divide num_heads"):
            mod.lm_tp_rules_for(3, 0, 2)
        with pytest.raises(ValueError, match="tp must be"):
            mod.lm_tp_rules_for(4, 0, 0)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            rules, kv = mod.lm_tp_rules_for(4, 1, 2)
        assert rules is mod.LM_TP_RULES_REPLICATED_KV and not kv
        assert any(issubclass(x.category, RuntimeWarning) for x in w)


@pytest.mark.parametrize("kv_sharded", [True, False])
def test_decode_cache_placement_equals_jax(kv_sharded):
    """The paged KV pool on the heads axis (replicated under the GQA
    fallback), everything else replicated, as ddw_tpu places it."""
    from ddw_tpu_torch.parallel import sharding as tsh

    J = _jax()
    cache = {f"backbone_block{i}": {"attn": {
        "kv_block_key": np.zeros((9, 16, 2, 8), np.float32),
        "kv_block_value": np.zeros((9, 16, 2, 8), np.float32),
        "tiles_computed": np.zeros((), np.int32)}} for i in range(2)}
    want = _jax_specs(J.sh.decode_cache_shardings(cache, J.mesh,
                                                  kv_sharded))
    got = tsh.decode_cache_shardings(cache, _tmesh(), kv_sharded)
    assert {k: tuple(v) for k, v in got.items()} == want


# ---- the steps -------------------------------------------------------------------

def _jax_step(name, params):
    J = _jax()
    tx = J.optax.sgd(LR)
    if name.startswith("vit"):
        model = J.build_model(J.ModelCfg(**VIT))
        x, y = _images()
        rules = J.sh.VIT_TP_RULES
    else:
        model = J.build_lm(J.LMCfg(**LM))
        x, y = _tokens()
        rules = J.sh.LM_TP_RULES
    state = J.TrainState(params, {}, tx.init(params), np.int32(0))
    if name == "vit_fsdp_tp":
        step = J.zero.make_fsdp_tp_train_step(model, tx, J.mesh, rules,
                                              donate=False)
    else:
        step = J.sh.make_sharded_train_step(model, tx, J.mesh, rules)
    state = step.place_state(state)
    new, m = step(state, x, y, J.jax.random.PRNGKey(0))
    shard_shapes = {J.jax.tree_util.keystr(path):
                    leaf.addressable_shards[0].data.shape
                    for path, leaf in J.jax.tree_util.tree_flatten_with_path(
                        new.params)[0]}
    return float(m["loss"]), J.jax.device_get(new.params), shard_shapes


@pytest.mark.parametrize("name", ["vit_tp", "vit_fsdp_tp", "lm_tp"])
def test_tp_steps_equal_jax(ranks, params, name):
    """One SGD step of DP x TP (ViT, and the LM with its vocab-split
    embedding and head) and of FSDP x TP equals ddw_tpu's GSPMD step, and
    each rank holds exactly its block of every leaf."""
    J = _jax()
    p = params[0] if name.startswith("vit") else params[1]
    loss, want, shard_shapes = _jax_step(name, p)
    flat = dict(J.jax.tree_util.tree_flatten_with_path(want)[0])
    for rk in ranks:
        got_loss, got, held, rest = rk[name]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        for path, a in J.jax.tree_util.tree_flatten_with_path(got)[0]:
            np.testing.assert_allclose(a, np.asarray(flat[path]), rtol=1e-5,
                                       atol=1e-5, err_msg=str(path))
    # the placement: the blocks ddw_tpu's shards have, leaf for leaf
    _, _, held, _ = ranks[0][name]
    from ddw_tpu_torch.models.convert import flax_leaf_index
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.utils.config import LMCfg, ModelCfg

    model = (build_model(ModelCfg(**VIT), image_size=(32, 32))
             if name.startswith("vit") else build_lm(LMCfg(**LM)))
    for n, (coll, path, dims, _, to_flax) in flax_leaf_index(model).items():
        if coll != "params" or n not in held:
            continue
        shape = held[n]
        flax_shape = to_flax(np.zeros(shape)).shape if to_flax else shape
        key = "".join(f"['{k}']" for k in path)
        assert tuple(flax_shape) == tuple(shard_shapes[key]), n


def test_fsdp_tp_placement_equals_jax(ranks, params):
    """The 2-D rest specs of the FSDP x TP state equal ddw_tpu's
    fsdp_tp_state_shardings (fc1 tiled P('data', 'model'))."""
    from ddw_tpu_torch.models.convert import flax_leaf_index
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.utils.config import ModelCfg

    J = _jax()
    tx = J.optax.sgd(LR)
    state = J.TrainState(params[0], {}, tx.init(params[0]), np.int32(0))
    want = _jax_specs(J.zero.fsdp_tp_state_shardings(state, J.mesh,
                                                     J.sh.VIT_TP_RULES).params)
    rest = ranks[0]["vit_fsdp_tp"][3]
    idx = flax_leaf_index(build_model(ModelCfg(**VIT), image_size=(32, 32)))
    got = {"/".join(idx[n][1]): tuple(s) for n, s in rest.items()}
    assert got == want
    assert got["backbone_block0/mlp/fc1/kernel"] == ("data", "model")
