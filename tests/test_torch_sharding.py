"""Tensor-parallel training of the port (``ddw_tpu_torch.parallel.sharding``
and the FSDP x TP step of ``parallel.zero``) against
``ddw_tpu.parallel.sharding`` / ``parallel.zero`` on the CPU.

Rule resolution, divisibility errors and the decode-cache placement are
compared in this process on the same trees. The steps run in four gloo
processes from one ``spawn_cpu`` over ``(data=2, model=2)``: the ViT
DP x TP step (Megatron column/row layers over the ``model`` group) and the
FSDP x TP 2-D step, and the LM DP x TP step with its vocab-split embedding
and head, each against ``ddw_tpu``'s GSPMD step on a 4-device CPU mesh from
the same weights (SGD). A LoRA-built LM (all six targets, a seeded nonzero
``lora_b``, ``lora_optimizer``) takes the DP x TP and FSDP x TP steps, and,
with one K/V head, the GQA fallback's replicated K/V. f32 tolerances: loss
1e-5, parameters after one step 1e-5."""

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
LORA_LM = dict(LM, lora_rank=2, lora_alpha=4.0,
               lora_targets=("query", "key", "value", "out", "fc1", "fc2"))
LORA_GQA_LM = dict(LORA_LM, num_kv_heads=1)
LORA_B_STD = 0.5
LR = 0.1


def _vit_params():
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.layers import init_params
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.utils.config import ModelCfg

    m = build_model(ModelCfg(**VIT), image_size=(32, 32))
    init_params(m, torch.Generator().manual_seed(0))
    return to_flax_variables(m)["params"]


def _lm_params(cfg=LM):
    """Seeded weights of the LM ``cfg``; a LoRA-built one gets a nonzero
    ``lora_b`` (at init it is zero, and dA with it)."""
    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.utils.config import LMCfg

    params = to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**cfg)), torch.Generator().manual_seed(1)))["params"]
    rng = np.random.RandomState(3)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (LORA_B_STD * rng.randn(*v.shape)).astype(np.float32)
                if k == "lora_b" else v for k, v in node.items()}

    return walk(params)


# case: (family, LM config, step, rules)
CASES = {"vit_tp": ("vit", None, "tp", "VIT_TP_RULES"),
         "vit_fsdp_tp": ("vit", None, "fsdp_tp", "VIT_TP_RULES"),
         "lm_tp": ("lm", LM, "tp", "LM_TP_RULES"),
         "lm_lora_tp": ("lm", LORA_LM, "tp", "LM_TP_RULES"),
         "lm_lora_fsdp_tp": ("lm", LORA_LM, "fsdp_tp", "LM_TP_RULES"),
         "lm_lora_gqa_tp": ("lm", LORA_GQA_LM, "tp",
                            "LM_TP_RULES_REPLICATED_KV")}


def _images():
    rng = np.random.RandomState(0)
    return (rng.rand(8, 32, 32, 3).astype(np.float32),
            rng.randint(0, 5, (8,)).astype(np.int32))


def _tokens():
    t = np.random.RandomState(2).randint(0, 32, (8, 13)).astype(np.int32)
    return t[:, :-1], t[:, 1:]


# ---- the ranks ---------------------------------------------------------------

def _rank(vit_params, lm_params, ckpt_dir):
    from ddw_tpu_torch.checkpoint.sharded import save_sharded
    from ddw_tpu_torch.models.convert import (load_flax_variables,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.models.lora import lora_optimizer
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.parallel import sharding
    from ddw_tpu_torch.parallel.zero import make_fsdp_tp_train_step
    from ddw_tpu_torch.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu_torch.train.step import Optimizer, init_state
    from ddw_tpu_torch.utils.config import LMCfg, ModelCfg

    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec((("data", 2), ("model", 2))))
    d = mesh.axis_index("data")
    rows = slice(4 * d, 4 * d + 4)
    out = {}
    makes = {"tp": sharding.make_sharded_train_step,
             "fsdp_tp": make_fsdp_tp_train_step}
    for name, (family, cfg, kind, rules) in CASES.items():
        tx = Optimizer("sgd", LR)
        if family == "vit":
            model = build_model(ModelCfg(**VIT), image_size=(32, 32))
            load_flax_variables(model, {"params": vit_params})
            x, y = _images()
        else:
            model = load_flax_variables(build_lm(LMCfg(**cfg)),
                                        {"params": lm_params[name]})
            x, y = _tokens()
            if cfg.get("lora_rank"):
                tx = lora_optimizer(tx)
        state = init_state(model, tx)
        step = makes[kind](model, tx, mesh, getattr(sharding, rules))
        m = step(state, torch.tensor(x[rows]), torch.tensor(y[rows]), 0)
        if name == "lm_lora_fsdp_tp":
            save_sharded(ckpt_dir, state, step=1)
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
    return _vit_params(), {name: _lm_params(cfg)
                           for name, (family, cfg, _, _) in CASES.items()
                           if family == "lm"}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("lora_fsdp_tp"))


@pytest.fixture(scope="module")
def ranks(params, ckpt_dir):
    return spawn_cpu(_rank, N, *params, ckpt_dir, timeout_s=240)


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
                                   "LM_TP_RULES_REPLICATED_KV",
                                   "LM_TP_RULES+lora"])
def test_rule_resolution_equals_jax(params, which):
    """Every leaf resolves to ddw_tpu's spec (fc1 column-split on its output
    dim, the attention heads, the vocab of the embedding and head); a
    LoRA-built LM's adapter leaves replicate, as ddw_tpu's do."""
    from ddw_tpu_torch.parallel import sharding as tsh

    J = _jax()
    rules = which.split("+")[0]
    tree = params[0] if which == "VIT_TP_RULES" else params[1]["lm_tp"]
    if which == "LM_TP_RULES_REPLICATED_KV":
        tree = _lm_params()
    if which == "LM_TP_RULES+lora":
        tree = params[1]["lm_lora_tp"]
    want = _jax_specs(J.sh.shardings_for_params(tree, J.mesh,
                                                getattr(J.sh, rules)))
    got = tsh.shardings_for_params(tree, _tmesh(), getattr(tsh, rules))
    assert {k: tuple(v) for k, v in got.items()} == want
    if which == "VIT_TP_RULES":
        assert got["backbone_block0/mlp/fc1/kernel"] == (None, "model")
    if which == "LM_TP_RULES+lora":
        for leaf in ("attn/query/lora_a", "attn/out/lora_b", "fc1/lora_b",
                     "fc2/lora_a"):
            assert got[f"backbone_block0/{leaf}"] == ()


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

@functools.cache
def _jax_step(name):
    """ddw_tpu's step of case ``name`` from the fixture's weights: (loss,
    new params, each leaf's shard shape)."""
    from ddw_tpu.models.lora import lora_optimizer

    J = _jax()
    family, cfg, kind, rules = CASES[name]
    params = _vit_params() if family == "vit" else _lm_params(cfg)
    tx = J.optax.sgd(LR)
    rules = getattr(J.sh, rules)
    if family == "vit":
        model = J.build_model(J.ModelCfg(**VIT))
        x, y = _images()
    else:
        model = J.build_lm(J.LMCfg(**cfg))
        x, y = _tokens()
        if cfg.get("lora_rank"):
            tx = lora_optimizer(tx)
    state = J.TrainState(params, {}, tx.init(params), np.int32(0))
    if kind == "fsdp_tp":
        step = J.zero.make_fsdp_tp_train_step(model, tx, J.mesh, rules,
                                              donate=False)
    else:
        step = J.sh.make_sharded_train_step(model, tx, J.mesh, rules)
    def shard_shapes(tree):
        return {J.jax.tree_util.keystr(path):
                leaf.addressable_shards[0].data.shape
                for path, leaf in J.jax.tree_util.tree_flatten_with_path(
                    tree)[0]}

    state = step.place_state(state)
    # the rules' placement; the TP step's jit leaves its outputs' shardings
    # to GSPMD, which after the step splits a replicated LoRA leaf the way
    # its layer computes, so the adapter leaves are held to the placement
    placed = shard_shapes(state.params)
    new, m = step(state, x, y, J.jax.random.PRNGKey(0))
    shapes = shard_shapes(new.params)
    shapes.update({k: v for k, v in placed.items() if "lora_" in k})
    return float(m["loss"]), J.jax.device_get(new.params), shapes


@pytest.mark.parametrize("name", list(CASES))
def test_tp_steps_equal_jax(ranks, params, name):
    """One SGD step of DP x TP (ViT, and the LM with its vocab-split
    embedding and head) and of FSDP x TP equals ddw_tpu's GSPMD step, and
    each rank holds exactly its block of every leaf. The LoRA-built LM's
    cases step only the adapter leaves and the head (lora_optimizer); a
    nonzero B makes dA nonzero, so the model group's sum of the adapter
    gradients shows (a rank's own share would miss it by far more than
    1e-5); the GQA case also holds the replicated K/V layers' summed
    gradients."""
    J = _jax()
    loss, want, shard_shapes = _jax_step(name)
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
             if name.startswith("vit") else build_lm(LMCfg(**CASES[name][1])))
    for n, (coll, path, dims, _, to_flax) in flax_leaf_index(model).items():
        if coll != "params" or n not in held:
            continue
        shape = held[n]
        flax_shape = to_flax(np.zeros(shape)).shape if to_flax else shape
        key = "".join(f"['{k}']" for k in path)
        assert tuple(flax_shape) == tuple(shard_shapes[key]), n


@pytest.mark.parametrize("name", ["vit_fsdp_tp", "lm_lora_fsdp_tp"])
def test_fsdp_tp_placement_equals_jax(ranks, params, name):
    """The 2-D rest specs of the FSDP x TP state equal ddw_tpu's
    fsdp_tp_state_shardings (fc1 tiled P('data', 'model'); a LoRA leaf,
    replicated over model, split over data on its largest dim)."""
    from ddw_tpu_torch.models.convert import flax_leaf_index
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.utils.config import LMCfg, ModelCfg

    J = _jax()
    family, cfg, _, rules = CASES[name]
    tx = J.optax.sgd(LR)
    p = params[0] if family == "vit" else params[1][name]
    state = J.TrainState(p, {}, tx.init(p), np.int32(0))
    want = _jax_specs(J.zero.fsdp_tp_state_shardings(
        state, J.mesh, getattr(J.sh, rules)).params)
    rest = ranks[0][name][3]
    model = (build_model(ModelCfg(**VIT), image_size=(32, 32))
             if family == "vit" else build_lm(LMCfg(**cfg)))
    idx = flax_leaf_index(model)
    got = {"/".join(idx[n][1]): tuple(s) for n, s in rest.items()}
    assert got == want
    if family == "vit":
        assert got["backbone_block0/mlp/fc1/kernel"] == ("data", "model")
    else:
        assert got["backbone_block0/fc2/lora_a"] == ("data", None)


def test_lora_fsdp_tp_checkpoint_restores_in_jax(ranks, params, ckpt_dir):
    """The four ranks' sharded checkpoint of the LoRA LM's FSDP x TP state
    (each rank's rest blocks, the adapter leaves split over data only)
    restores in ddw_tpu onto its fsdp_tp_state_shardings, and in one port
    process, to the parameters ddw_tpu's step gives."""
    from ddw_tpu.checkpoint import sharded as jckpt
    from ddw_tpu.models.lora import lora_optimizer

    from ddw_tpu_torch.checkpoint.sharded import restore_sharded
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.models.lora import lora_optimizer as port_lora_tx
    from ddw_tpu_torch.train.step import Optimizer, init_state
    from ddw_tpu_torch.utils.config import LMCfg

    J = _jax()
    name = "lm_lora_fsdp_tp"
    _, cfg, _, rules = CASES[name]
    p = params[1][name]
    _, want, _ = _jax_step(name)
    tx = lora_optimizer(J.optax.sgd(LR))
    target = J.TrainState(p, {}, tx.init(p), np.int32(0))
    sh = J.zero.fsdp_tp_state_shardings(target, J.mesh, getattr(J.sh, rules))
    got, at = jckpt.restore_sharded(ckpt_dir, target, sh)
    assert at == 1 and int(got.step) == 1
    state, at = restore_sharded(ckpt_dir, init_state(
        build_lm(LMCfg(**cfg)), port_lora_tx(Optimizer("sgd", LR))))
    assert at == 1
    port = to_flax_variables(state.model)["params"]
    flat = dict(J.jax.tree_util.tree_flatten_with_path(want)[0])
    for tree in (J.jax.device_get(got.params), port):
        for path, a in J.jax.tree_util.tree_flatten_with_path(tree)[0]:
            np.testing.assert_allclose(np.asarray(a), np.asarray(flat[path]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=str(path))
