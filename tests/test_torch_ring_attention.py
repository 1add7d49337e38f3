"""Ring attention and the sequence-parallel LM of the port
(``ddw_tpu_torch.parallel.ring_attention``, the LM's ``seq_axis``,
``make_lm_train_step(seq_axis=...)``, ``LMTrainer(seq_devices=...)`` and
``examples_torch/07``) against ``ddw_tpu`` on the CPU.

The JAX side runs in this process on the 8-device CPU mesh under
``shard_map``, the Pallas kernel in interpret mode where ``ddw_tpu``'s own
tests run it so. The port runs in four gloo processes from one
``spawn_cpu``; each rank runs every case and returns its shards. f32
tolerances: ring forward 1e-5 and gradients 1e-4 against ``ddw_tpu``'s ring
and against full attention; the DP x SP step's loss 1e-5 and its
parameters after one SGD step 1e-5.

JAX is imported by the parent's fixtures only, so the ranks, which import
this module to find their function, start with torch alone."""

import functools
import types

import numpy as np
import pytest
import torch

from ddw_tpu_torch.runtime.dist import spawn_cpu

N = 4
B, H, D = 1, 2, 16
# (name, causal, local shard length, impl): 12 is no block multiple
RING = (("causal", True, 32, "auto"), ("full", False, 32, "auto"),
        ("ragged", True, 12, "pallas"))
LM = {"learned": dict(vocab_size=32, max_len=64, hidden=32, depth=2,
                      num_heads=2, mlp_dim=64, dtype="float32"),
      "rope_gqa": dict(vocab_size=32, max_len=64, hidden=32, depth=2,
                       num_heads=4, num_kv_heads=2, mlp_dim=64,
                       dtype="float32", pos_encoding="rope")}
SEQ = 16          # global sequence of the DP x SP step, 8 per seq rank
LR = 0.1


def _qkv(s_local):
    rng = np.random.RandomState(s_local)
    return [rng.randn(B, H, s_local * N, D).astype(np.float32)
            for _ in range(3)]


def _tokens():
    return np.random.RandomState(5).randint(0, 32, (4, SEQ + 1)).astype(
        np.int32)


@functools.cache
def _jax():
    import importlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from ddw_tpu.models.lm import build_lm
    from ddw_tpu.parallel.ring_attention import ring_attention
    from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu.train import lm_step
    from ddw_tpu.train.step import make_optimizer
    from ddw_tpu.utils.compat import shard_map
    from ddw_tpu.utils.config import LMCfg, TrainCfg

    fa = importlib.import_module("ddw_tpu.ops.flash_attention")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, P=PartitionSpec, build_lm=build_lm,
        ring_attention=ring_attention, MeshSpec=MeshSpec,
        make_mesh=make_mesh, lm_step=lm_step, make_optimizer=make_optimizer,
        shard_map=shard_map, LMCfg=LMCfg, TrainCfg=TrainCfg, fa=fa)


def _lm_params():
    """Seeded weights for both packages, flax layout as numpy (drawn
    through the port, so the ranks start before any JAX work: XLA's idle
    CPU threads slow a spawn that follows a compile)."""
    from ddw_tpu_torch.models.convert import (init_lm_weights,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.utils.config import LMCfg

    return {key: to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**cfg)), torch.Generator().manual_seed(0)))["params"]
        for key, cfg in LM.items()}


# ---- the ranks ---------------------------------------------------------------

def _rank(lm_params):
    from ddw_tpu_torch.models.convert import (load_flax_variables,
                                              to_flax_variables)
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.parallel.ring_attention import ring_attention
    from ddw_tpu_torch.runtime.mesh import MeshSpec, bind_mesh, make_mesh
    from ddw_tpu_torch.train.lm_step import make_lm_train_step
    from ddw_tpu_torch.train.lm_trainer import LMTrainer
    from ddw_tpu_torch.train.step import TrainState, make_optimizer
    from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

    torch.set_num_threads(1)
    out = {}
    seq = make_mesh(MeshSpec((("seq", N),)))
    r = seq.axis_index("seq")
    for name, causal, s_local, impl in RING:
        sl = slice(r * s_local, (r + 1) * s_local)
        q, k, v = (torch.tensor(t[:, :, sl]).requires_grad_()
                   for t in _qkv(s_local))
        with bind_mesh(seq):
            o = ring_attention(q, k, v, "seq", causal=causal, impl=impl)
        (o ** 2).sum().backward()
        out[name] = [o.detach().numpy()] + [t.grad.numpy()
                                             for t in (q, k, v)]

    mesh = make_mesh(MeshSpec((("data", 2), ("seq", 2))))
    d, s = mesh.axis_index("data"), mesh.axis_index("seq")
    toks = _tokens()
    rows, cols = slice(2 * d, 2 * d + 2), slice(8 * s, 8 * s + 8)
    x = torch.tensor(toks[rows, :-1][:, cols])
    y = torch.tensor(toks[rows, 1:][:, cols])
    for key, cfg in LM.items():
        model = load_flax_variables(build_lm(LMCfg(**cfg), seq_axis="seq"),
                                    {"params": lm_params[key]})
        tx = make_optimizer(TrainCfg(optimizer="sgd", learning_rate=LR))
        state = TrainState(model, tx.init(dict(model.named_parameters())), 0)
        m = make_lm_train_step(model, tx, seq_axis="seq", mesh=mesh)(
            state, x, y, 0)
        out[key] = (float(m["loss"]), float(m["accuracy"]),
                    to_flax_variables(model)["params"])
    # the learned table bounds the global sequence: 2 x 40 > 64
    short = build_lm(LMCfg(**LM["learned"]), seq_axis="seq")
    try:
        with bind_mesh(mesh):
            short(torch.zeros((1, 40), dtype=torch.long))
        out["max_len"] = None
    except ValueError as e:
        out["max_len"] = str(e)
    # LMTrainer over (data=2, seq=2), one epoch
    tr = LMTrainer(LMCfg(**LM["learned"]),
                   TrainCfg(batch_size=2, epochs=1, warmup_epochs=0,
                            learning_rate=1e-2), device="cpu", seq_devices=2)
    corpus = np.random.RandomState(9).randint(0, 32, (40, SEQ + 1))
    res = tr.fit(corpus)
    out["trainer"] = (tr.mesh.shape, res.history,
                      float(sum(p.double().sum() for p in
                                res.state.model.parameters())))
    return out


@pytest.fixture(scope="module")
def lm_params():
    return _lm_params()


@pytest.fixture(scope="module")
def ranks(lm_params):
    return spawn_cpu(_rank, N, lm_params, timeout_s=240)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---- ring attention ----------------------------------------------------------

def _jax_ring(causal, s_local, impl):
    """ddw_tpu's ring (under shard_map on 4 devices) and full attention:
    ``(out, grads)`` of ``sum(out ** 2)`` for each."""
    J = _jax()
    mesh = J.make_mesh(J.MeshSpec((("seq", N),)),
                       devices=J.jax.devices()[:N])
    spec = J.P(None, None, "seq", None)
    q, k, v = _qkv(s_local)

    def ring(q, k, v):
        return J.shard_map(
            lambda q, k, v: J.ring_attention(q, k, v, "seq", causal=causal,
                                             impl=impl),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False)(q, k, v)

    def full(q, k, v):
        return J.fa.mha_reference(q, k, v, causal=causal)

    res = {}
    for name, fn in (("ring", ring), ("full", full)):
        out = np.asarray(J.jax.jit(fn)(q, k, v))
        grads = J.jax.jit(J.jax.grad(
            lambda *a: J.jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)
        res[name] = [out] + [np.asarray(g) for g in grads]
    return res


@pytest.mark.parametrize("name,causal,s_local,impl", RING)
def test_ring_matches_jax_ring_and_full_attention(ranks, name, causal,
                                                  s_local, impl):
    """Forward and the q/k/v gradients of sum(out^2): the port's ring (each
    rank its shard; the ragged case pads 12 keys to the kernel tier's
    block) equals ddw_tpu's ring and full attention."""
    got = [np.concatenate([rk[name][i] for rk in ranks], axis=2)
           for i in range(4)]
    want = _jax_ring(causal, s_local, impl)
    for ref in (want["ring"], want["full"]):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
        for g, w in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


# ---- the DP x SP LM step -------------------------------------------------------

@pytest.mark.parametrize("key", sorted(LM))
def test_dp_sp_lm_step_matches_jax(ranks, lm_params, key):
    """(data=2, seq=2): the gradient mean over data x seq and one SGD update
    equal ddw_tpu's shard_map step from the same weights, with learned
    positions sliced at rank * s_local and with RoPE + GQA."""
    J = _jax()
    mesh = J.make_mesh(J.MeshSpec((("data", 2), ("seq", 2))),
                       devices=J.jax.devices()[:4])
    model = J.build_lm(J.LMCfg(**LM[key]), seq_axis="seq")
    tx = J.make_optimizer(J.TrainCfg(optimizer="sgd", learning_rate=LR))
    from ddw_tpu.train.step import TrainState

    params = J.jax.tree_util.tree_map(J.jnp.asarray, lm_params[key])
    state = TrainState(params, {}, tx.init(params),
                       J.jnp.zeros((), J.jnp.int32))
    step = J.lm_step.make_lm_train_step(model, tx, mesh, seq_axis="seq",
                                        donate=False)
    toks = _tokens()
    new, m = step(state, toks[:, :-1], toks[:, 1:], J.jax.random.PRNGKey(1))
    for rk in ranks:
        loss, acc, p = rk[key]
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(acc, float(m["accuracy"]), atol=1e-6)
        flat = dict(J.jax.tree_util.tree_flatten_with_path(p)[0])
        for path, w in J.jax.tree_util.tree_flatten_with_path(
                new.params)[0]:
            np.testing.assert_allclose(flat[path], np.asarray(w), rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=J.jax.tree_util.keystr(path))


def test_global_sequence_past_max_len_is_refused(ranks):
    assert all("exceeds max_len" in rk["max_len"] for rk in ranks)


def test_lm_trainer_seq_devices_trains_one_epoch(ranks):
    """LMTrainer(seq_devices=2) on four ranks: a (data=2, seq=2) mesh, one
    finite epoch, the same metrics and parameters on every rank."""
    shapes = {str(rk["trainer"][0]) for rk in ranks}
    assert shapes == {str({"data": 2, "seq": 2})}
    rows = [rk["trainer"][1][0] for rk in ranks]
    for key in ("loss", "val_loss", "accuracy", "val_accuracy"):
        vals = {row[key] for row in rows}
        assert len(vals) == 1 and np.isfinite(vals.pop())
    assert len({rk["trainer"][2] for rk in ranks}) == 1


def test_example_07_quick():
    """``examples_torch/07 --quick`` on two CPU ranks: DP x SP steps, the
    greedy continuation and the speculative decode of the trained model."""
    import importlib

    ex = importlib.import_module("examples_torch.07_lm_long_context")
    out = ex.main(["--quick", "--device", "cpu", "--procs", "2", "--seq-devices", "2",
                   "--steps", "4", "--speculative"])
    assert out["mesh"] == {"data": 1, "seq": 2}
    assert np.isfinite(out["loss"]) and out["tokens_per_sec"] > 0
    assert out["speculative"]["rounds"] >= 1
