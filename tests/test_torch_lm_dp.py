"""The port's LM train step data parallel over a 2-process gloo group
(``ddw_tpu_torch.runtime.dist.spawn_cpu``) against ``ddw_tpu``'s step on a
2-device CPU mesh: each rank takes half of the batch, and the gradients
and metrics are averaged over the group (JAX's ``pmean``)."""

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
from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.models.lm import build_lm
from ddw_tpu_torch.runtime.dist import spawn_cpu
from ddw_tpu_torch.train import lm_step as tlm
from ddw_tpu_torch.train import step as tstep
from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

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


def _dp_worker(params, x, y):
    """One rank of the gloo group: its half of the batch, one sgd step."""
    from ddw_tpu_torch.runtime.dist import process_topology

    torch.set_num_threads(1)
    rank, world = process_topology()
    tm = load_flax_variables(build_lm(LMCfg(**BASE)), {"params": params})
    tx = tstep.make_optimizer(TrainCfg(optimizer="sgd", learning_rate=0.1))
    state = tstep.TrainState(tm, tx.init(dict(tm.named_parameters())), 0)
    half = slice(rank * 4, (rank + 1) * 4)
    m = tlm.make_lm_train_step(tm, tx)(state, torch.from_numpy(x[half]),
                                       torch.from_numpy(y[half]), 0)
    return world, float(m["loss"]), float(m["accuracy"]), \
        to_flax_variables(tm)["params"]


def test_two_process_gloo_lm_step_matches_jax_two_device_step():
    """The ranks in lockstep bit for bit; the loss within 1e-5 and the
    params within 1e-5 relative plus 1e-6 (sgd, f32) of JAX's."""
    jm = jax_build_lm(JaxLMCfg(**BASE))
    params = jax.tree_util.tree_map(np.array, jm.init(
        {"params": jax.random.PRNGKey(9)}, np.zeros((1, 8), np.int32))[
            "params"])
    toks = np.random.RandomState(60).randint(0, VOCAB, (8, 17)).astype(
        np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    jtx = jstep.make_optimizer(JaxTrainCfg(optimizer="sgd",
                                           learning_rate=0.1))
    jstate = jstep.TrainState(jax.tree_util.tree_map(jnp.asarray, params),
                              {}, jtx.init(params), jnp.zeros((), jnp.int32))
    mesh = make_mesh(MeshSpec((("data", 2),)), devices=jax.devices()[:2])
    jnew, jmet = jlm.make_lm_train_step(jm, jtx, mesh, seq_axis=None,
                                        donate=False)(
        jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    (w0, l0, a0, p0), (w1, l1, a1, p1) = spawn_cpu(_dp_worker, 2, params, x,
                                                   y, timeout_s=240)
    assert w0 == w1 == 2 and (l0, a0) == (l1, a1)
    for a, b in zip(jax.tree_util.tree_leaves(p0),
                    jax.tree_util.tree_leaves(p1)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(l0, float(jmet["loss"]), rtol=1e-5)
    assert a0 == pytest.approx(float(jmet["accuracy"]), abs=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(p0),
                    jax.tree_util.tree_leaves(jax.device_get(jnew.params))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
