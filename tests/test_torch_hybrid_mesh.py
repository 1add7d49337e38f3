"""The hybrid (slice-aware) half of the port's ``runtime.mesh``
(``HybridMeshSpec``, ``make_hybrid_mesh``, ``device_slice_index``,
``make_data_mesh``'s slice detection) against ``ddw_tpu.runtime.mesh``.

A slice is a group of ranks. The cases of ``tests/test_hybrid_mesh.py``
that need no JAX devices run in this process over rank ids (a world of one
builds the grid without process groups): the slice-major layout equal to
``ddw_tpu``'s over the same ids and slice function, the wildcards, the
refusal of cross-slice ``model`` / ``seq`` axes, unequal slices. Four gloo
processes from one ``spawn_cpu`` train one LM step over a hybrid data mesh
whose slices interleave the ranks, equal to the flat mesh's step
(parameters to 1e-6 in f32: the same gradients summed in another rank
order)."""

import numpy as np
import pytest
import torch

from ddw_tpu_torch.runtime.dist import spawn_cpu
from ddw_tpu_torch.runtime.mesh import (DATA_AXIS, HybridMeshSpec,
                                        device_slice_index, make_data_mesh,
                                        make_hybrid_mesh)

RANKS = list(range(8))


def two_slices(r):
    return r // 4


def _jax_ids(spec, n, fn):
    import jax

    from ddw_tpu.runtime.mesh import make_hybrid_mesh as jmake

    mesh = jmake(spec, devices=jax.devices()[:n],
                 slice_index_fn=lambda d: fn(d.id))
    return dict(mesh.shape), np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("spec", [
    ((DATA_AXIS, 2, 2), ("model", 1, 2)),
    ((DATA_AXIS, -1, 1), ("model", 1, -1)),
    ((DATA_AXIS, 2, 4),),
    (("pipe", 2, 1), (DATA_AXIS, 1, 4)),
])
def test_slice_major_layout_equals_jax(spec):
    mesh = make_hybrid_mesh(spec, ranks=RANKS, slice_index_fn=two_slices)
    shape, ids = _jax_ids(spec, 8, two_slices)
    assert mesh.shape == shape
    np.testing.assert_array_equal(mesh.ranks, ids)


def test_slice_major_layout():
    mesh = make_hybrid_mesh(((DATA_AXIS, 2, 2), ("model", 1, 2)),
                            ranks=RANKS, slice_index_fn=two_slices)
    assert mesh.shape == {"data": 4, "model": 2}
    arr = mesh.ranks
    for i in range(4):
        assert two_slices(arr[i, 0]) == two_slices(arr[i, 1])
    col = [two_slices(arr[i, 0]) for i in range(4)]
    assert col[0] == col[1] and col[2] == col[3] and col[0] != col[2]
    whole = make_hybrid_mesh(ranks=RANKS, slice_index_fn=two_slices)
    assert whole.shape == {"data": 8}


def test_cross_slice_tp_and_sp_refused():
    with pytest.raises(ValueError, match="refused"):
        make_hybrid_mesh(((DATA_AXIS, 1, 4), ("model", 2, 1)), ranks=RANKS,
                         slice_index_fn=two_slices)
    with pytest.raises(ValueError, match="refused"):
        make_hybrid_mesh((("seq", 2, 4),), ranks=RANKS,
                         slice_index_fn=two_slices)
    # a wildcard that resolves to one slice is legal anywhere
    HybridMeshSpec((("model", -1, 4),)).resolve(1, 4)


def test_bad_shapes_refused():
    with pytest.raises(ValueError, match="unequal slices"):
        make_hybrid_mesh(ranks=RANKS[:7], slice_index_fn=two_slices)
    with pytest.raises(ValueError, match="dcn"):
        make_hybrid_mesh(((DATA_AXIS, 3, 4),), ranks=RANKS,
                         slice_index_fn=two_slices)
    with pytest.raises(ValueError, match="ici"):
        make_hybrid_mesh(((DATA_AXIS, 2, 3),), ranks=RANKS,
                         slice_index_fn=two_slices)
    with pytest.raises(ValueError, match="at most one"):
        HybridMeshSpec(((DATA_AXIS, -1, 2), ("model", -1, 2))).resolve(2, 4)


def test_make_data_mesh_auto_detects_slices():
    interleaved = lambda r: r % 2  # noqa: E731
    multi = make_data_mesh(ranks=RANKS, slice_index_fn=interleaved)
    order = [interleaved(r) for r in multi.ranks.ravel()]
    assert multi.shape == {"data": 8} and order == sorted(order)
    single = make_data_mesh(ranks=RANKS, slice_index_fn=lambda r: 0)
    assert list(single.ranks) == RANKS
    uneven = make_data_mesh(ranks=RANKS[:6], slice_index_fn=two_slices)
    assert list(uneven.ranks) == RANKS[:6]


def test_device_slice_index_without_slice_information(monkeypatch):
    """A rank with no slice information is one slice (ddw_tpu's rule for
    an accelerator without slice_index); DDW_RANKS_PER_SLICE groups
    ranks."""
    monkeypatch.delenv("DDW_RANKS_PER_SLICE", raising=False)
    assert {device_slice_index(r) for r in RANKS} == {0}
    monkeypatch.setenv("DDW_RANKS_PER_SLICE", "4")
    assert [device_slice_index(r) for r in RANKS] == [0] * 4 + [1] * 4
    mesh = make_data_mesh(ranks=RANKS)
    assert list(mesh.ranks) == RANKS


def test_unported_collectives_stay_refused():
    """host_all_reduce waits for the elastic runtime (ROADMAP.md item 16)."""
    from ddw_tpu_torch.runtime import host_all_reduce

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        host_all_reduce("tag", 1.0)


# ---- a DP step over a hybrid mesh, four ranks ---------------------------------

LM = dict(vocab_size=32, max_len=32, hidden=32, depth=1, num_heads=2,
          mlp_dim=64, dtype="float32")


def _rank():
    from ddw_tpu_torch.models.convert import init_lm_weights
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu_torch.train.lm_step import init_lm_state, make_lm_train_step
    from ddw_tpu_torch.train.step import Optimizer
    from ddw_tpu_torch.utils.config import LMCfg

    torch.set_num_threads(1)
    toks = np.random.RandomState(0).randint(0, 32, (8, 9))
    out = {}
    meshes = {"flat": make_mesh(MeshSpec(((DATA_AXIS, 4),))),
              "hybrid": make_hybrid_mesh(((DATA_AXIS, 2, 2),),
                                         slice_index_fn=lambda r: r % 2)}
    for name, mesh in meshes.items():
        model = init_lm_weights(build_lm(LMCfg(**LM)),
                                torch.Generator().manual_seed(0))
        tx = Optimizer("sgd", 0.1)
        state = init_lm_state(model, tx, torch.Generator().manual_seed(0))
        d = mesh.axis_index(DATA_AXIS)
        x = torch.tensor(toks[2 * d:2 * d + 2, :-1])
        y = torch.tensor(toks[2 * d:2 * d + 2, 1:])
        m = make_lm_train_step(model, tx, mesh=mesh)(state, x, y, 0)
        out[name] = (mesh.ranks.tolist(), float(m["loss"]),
                     [p.detach().numpy().copy() for p in model.parameters()])
    return out


def test_hybrid_dp_step_equals_flat():
    ranks = spawn_cpu(_rank, 4, timeout_s=240)
    for rk in ranks:
        assert rk["hybrid"][0] == [0, 2, 1, 3]     # slice-major
        np.testing.assert_allclose(rk["hybrid"][1], rk["flat"][1],
                                   rtol=1e-6)
        for a, b in zip(rk["hybrid"][2], rk["flat"][2]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
