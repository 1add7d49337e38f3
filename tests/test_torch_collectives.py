"""The port's collective layer (``ddw_tpu_torch.runtime.collectives``, the
plain version of K6 in ``ddw_tpu_torch.ops.ring_reduce`` and the process
mesh of ``runtime.mesh``) against ``ddw_tpu``'s on the CPU.

The JAX side runs in this process on the 8-device CPU mesh, with
``ring_all_reduce_pallas`` in Pallas's TPU interpreter as
``tests/test_collectives.py`` runs it. The port runs in gloo processes from
``spawn_cpu``, one spawn per world size; each rank runs every case and
returns its results. The rings must agree bit for bit: the port keeps the
128-lane row framing and the order of the additions.

JAX is imported by the parent's fixtures only (:func:`_jax`), so the ranks,
which import this module to find their function, start with torch alone."""

import concurrent.futures
import functools
import types

import numpy as np
import pytest
import torch

from ddw_tpu_torch.ops import ring_reduce as rr
from ddw_tpu_torch.runtime import collectives as coll
from ddw_tpu_torch.runtime import mesh as tmesh
from ddw_tpu_torch.runtime.dist import spawn_cpu

NS = (2, 4)
SHAPES = ((33,), (4, 50), (256,), (3, 700))
SEG_SHAPE = (4 * 560,)  # 640-value rows at n=4: five 128-value segments
SEG_BUDGET = 4 * 128 * 4 * 4  # ddw_tpu's budget for 128-value segments at n=4
BF16_SHAPE = (96,)
SUB_SHAPE = (160,)
# The mixed tree one all_reduce_sum(impl="pallas") rings as one pack per ring
# dtype: f32 leaves around an int32 and a bf16 leaf (None: n * 128 - 7).
MIX = {"a": (1,), "b": (33,), "c_int": (300,), "d": None, "e_bf16": (200,),
       "f": (3, 700)}


# The integer and bool ring dtypes (numpy names), each with values that
# overflow its range when summed over the ranks; INT_TREE mixes them with
# f32 and f16 leaves for all_reduce_sum at every impl.
INT_DTYPES = ("int8", "uint8", "int16", "uint32", "bool")
INT_SHAPE = (3, 150)
INT_TREE = {"b": "bool", "f": "float32", "h": "float16", "i16": "int16",
            "i8": "int8", "u32": "uint32", "u8": "uint8"}


def _mix_shape(key, n):
    return MIX[key] or (n * 128 - 7,)


def _int_values(rng, dtype, shape):
    """Seeded values of ``dtype`` from the whole range (bool: about a third
    True): the sums over 2 or 4 ranks overflow every integer dtype."""
    if dtype == "bool":
        return rng.rand(*shape) < 0.3
    if dtype.startswith("float"):
        return rng.randn(*shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(info.min, int(info.max) + 1, shape,
                       dtype=np.int64).astype(dtype)


@functools.cache
def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    import ddw_tpu.ops.ring_reduce as jrr
    from ddw_tpu.runtime import collectives as jcoll
    from ddw_tpu.runtime.mesh import MeshSpec, make_mesh
    from ddw_tpu.utils.compat import shard_map

    return types.SimpleNamespace(jax=jax, jnp=jnp, P=PartitionSpec, rr=jrr,
                                 coll=jcoll, MeshSpec=MeshSpec,
                                 make_mesh=make_mesh, shard_map=shard_map)


def _root(n):
    return 3 if n == 4 else 1


def _inputs(n):
    """Per-rank inputs ``(n, *shape)``, made from a seed with numpy."""
    rng = np.random.RandomState(100 + n)
    x = {f"s{i}": rng.randn(n, *s).astype(np.float32)
         for i, s in enumerate(SHAPES)}
    x["bf16"] = rng.randn(n, *BF16_SHAPE).astype(np.float32)
    x["seg"] = rng.randn(n, *SEG_SHAPE).astype(np.float32)
    x["int"] = rng.randint(-2**30, 2**30, (n, 300)).astype(np.int32)
    x["sub"] = rng.randn(n, *SUB_SHAPE).astype(np.float32)
    for key in MIX:
        if key == "c_int":
            x[f"mix_{key}"] = rng.randint(-2**30, 2**30, (n, 300)).astype(
                np.int32)
        else:
            x[f"mix_{key}"] = rng.randn(n, *_mix_shape(key, n)).astype(
                np.float32)
    for dt in INT_DTYPES:
        x[f"int_{dt}"] = _int_values(rng, dt, (n, *INT_SHAPE))
    for key, dt in INT_TREE.items():
        x[f"itree_{key}"] = _int_values(rng, dt, (n, 257))
    return x


def _mix_leaf(key, v, bf16):
    """A mixed-tree input as its dtype: the bf16 leaf rounded from f32."""
    return bf16(v) if key == "e_bf16" else v


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---- the JAX side: one jit per case family on the 8-device CPU mesh ----

def _smap(fn, n, *xs):
    J = _jax()
    mesh = J.make_mesh(J.MeshSpec((("data", n),)), devices=J.jax.devices()[:n])
    f = J.jax.jit(J.shard_map(
        lambda *a: J.jax.tree.map(lambda o: o[None], fn(*[t[0] for t in a])),
        mesh=mesh, in_specs=J.P("data"), out_specs=J.P("data"),
        check_vma=False))
    return J.jax.tree.map(np.asarray, f(*xs))


def _jax_refs(n, x):
    J = _jax()
    shaped = [x[f"s{i}"] for i in range(len(SHAPES))]
    refs = {}
    pallas, ring = _smap(lambda *a: (
        [J.rr.ring_all_reduce_pallas(t, "data") for t in a],
        [J.coll.ring_all_reduce(t, "data") for t in a]), n, *shaped)
    for i in range(len(SHAPES)):
        refs[f"pallas_s{i}"], refs[f"ring_s{i}"] = pallas[i], ring[i]
    (refs["psum"], refs["mean"], refs["bcast"], refs["gather"],
     refs["gather_tiled"], refs["tree"]) = _smap(lambda t: (
         J.coll.all_reduce_sum(t, "data"), J.coll.all_reduce_mean(t, "data"),
         J.coll.broadcast_from(t, "data", root=_root(n)),
         J.coll.all_gather_axis(t, "data"),
         J.coll.all_gather_axis(t, "data", tiled=True),
         {impl: J.coll.all_reduce_sum({"a": t, "b": t * 2}, "data",
                                      impl=impl)
          for impl in ("psum", "ring", "pallas")}), n, x["s3"])
    refs["bf16"] = _smap(lambda t: J.rr.ring_all_reduce_pallas(t, "data"), n,
                         J.jnp.asarray(x["bf16"], J.jnp.bfloat16))
    keys = sorted(MIX)
    refs["mix"] = _smap(
        lambda *a: J.coll.all_reduce_sum(dict(zip(keys, a)), "data",
                                         impl="pallas"), n,
        *[_mix_leaf(k, x[f"mix_{k}"],
                    lambda v: J.jnp.asarray(v, J.jnp.bfloat16)) for k in keys])
    ints = _smap(lambda *a: [J.rr.ring_all_reduce_pallas(t, "data")
                             for t in a], n,
                 *[x[f"int_{dt}"] for dt in INT_DTYPES])
    for dt, got in zip(INT_DTYPES, ints):
        refs[f"int_{dt}"] = got
    tkeys = sorted(INT_TREE)
    refs["itree"] = _smap(lambda *a: {
        impl: J.coll.all_reduce_sum(dict(zip(tkeys, a)), "data", impl=impl)
        for impl in ("psum", "ring", "pallas")}, n,
        *[x[f"itree_{k}"] for k in tkeys])
    return refs


def _all_jax_refs():
    J = _jax()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for n in NS:
            x = _inputs(n)
            out[n] = _jax_refs(n, x)
            mp.setattr(J.rr, "_VMEM_BUDGET_BYTES", SEG_BUDGET)
            out[n]["seg"] = _smap(
                lambda t: J.rr.ring_all_reduce_pallas(t, "data"), n, x["seg"])
            mp.undo()
    mesh = J.make_mesh(J.MeshSpec((("data", 2), ("seq", 2))),
                       devices=J.jax.devices()[:4])
    sub = _inputs(4)["sub"].reshape(2, 2, *SUB_SHAPE)
    out["sub"] = np.asarray(J.jax.jit(J.shard_map(
        lambda t: J.rr.ring_all_reduce_pallas(t[0, 0], "seq")[None, None],
        mesh=mesh, in_specs=J.P("data", "seq"),
        out_specs=J.P("data", "seq"), check_vma=False))(sub)).reshape(
            4, *SUB_SHAPE)
    return out


# ---- the port side: every case in every rank of one spawn per world ----

def _rank_cases(x):
    """One rank: every case on its slice of the inputs; numpy results."""
    from ddw_tpu_torch.runtime.dist import process_topology

    torch.set_num_threads(1)
    r, n = process_topology()
    t = {k: torch.from_numpy(v[r]) for k, v in x.items()}
    out = {}
    for i in range(len(SHAPES)):
        s = t[f"s{i}"]
        out[f"pallas_s{i}"] = coll.all_reduce_sum(s, impl="pallas")
        out[f"pallas_direct_s{i}"] = coll.ring_all_reduce_pallas(s)
        out[f"ring_s{i}"] = coll.ring_all_reduce(s)
    s = t["s3"]
    out["psum"] = coll.all_reduce_sum(s)
    out["mean"] = coll.all_reduce_mean(s)
    out["bcast"] = coll.broadcast_from(s, root=_root(n))
    out["gather"] = coll.all_gather_axis(s)
    out["gather_tiled"] = coll.all_gather_axis(s, tiled=True)
    out["tree"] = {impl: coll.all_reduce_sum({"b": s * 2, "a": s}, impl=impl)
                   for impl in ("psum", "ring", "pallas")}
    try:
        coll.all_reduce_sum({"a": s}, impl="nccl")
    except KeyError as e:
        out["unknown_impl"] = str(e)
    mix = {k: _mix_leaf(k, t[f"mix_{k}"], lambda v: v.to(torch.bfloat16))
           for k in MIX}
    hops, shift = [], rr.ring_shift
    rr.ring_shift = lambda *a, **kw: hops.append(1) or shift(*a, **kw)
    try:
        out["mix"] = coll.all_reduce_sum(mix, impl="pallas")
    finally:
        rr.ring_shift = shift
    out["mix_hops"] = len(hops)
    out["mix_per_leaf"] = {k: coll.ring_all_reduce_pallas(v)
                           for k, v in mix.items()}
    for key in ("mix", "mix_per_leaf"):
        out[key]["e_bf16"] = out[key]["e_bf16"].view(torch.int16)
    try:
        coll.all_reduce_sum({"a": t["s0"], "b": torch.zeros(3, device="meta")},
                            impl="pallas")
    except ValueError as e:
        out["mixed_devices"] = str(e)
    for dt in INT_DTYPES:
        out[f"int_{dt}"] = coll.ring_all_reduce_pallas(t[f"int_{dt}"])
    itree = {k: t[f"itree_{k}"] for k in INT_TREE}
    out["itree"] = {impl: coll.all_reduce_sum(itree, impl=impl)
                    for impl in ("psum", "ring", "pallas")}
    slot, rr.SLOT_BYTES = rr.SLOT_BYTES, 512
    try:  # 512 bytes: 512 int8 columns a launch, 128 uint32 ones
        out["itree_small_slot"] = coll.all_reduce_sum(itree, impl="pallas")
    finally:
        rr.SLOT_BYTES = slot
    bf = t["bf16"].to(torch.bfloat16)
    out["bf16"] = coll.all_reduce_sum(bf, impl="pallas")
    out["bf16_dtype"] = str(out["bf16"].dtype)
    out["bf16"] = out["bf16"].view(torch.int16)  # numpy has no bf16
    out["int"] = coll.all_reduce_sum(t["int"], impl="pallas")
    slot, rr.SLOT_BYTES = rr.SLOT_BYTES, 128 * 4
    try:
        out["seg"] = coll.all_reduce_sum(t["seg"], impl="pallas")
    finally:
        rr.SLOT_BYTES = slot
    mesh = tmesh.make_mesh(tmesh.MeshSpec((("data", -1), ("seq", 1))))
    out["solo"] = coll.all_reduce_sum(t["s0"], (mesh, "seq"), impl="pallas")
    out["solo_size"] = mesh.shape["seq"]
    if n == 4:
        mesh = tmesh.make_mesh(tmesh.MeshSpec((("data", 2), ("seq", 2))))
        out["sub"] = coll.all_reduce_sum(t["sub"], (mesh, "seq"),
                                         impl="pallas")
        out["sub_coords"] = (mesh.axis_index("data"), mesh.axis_index("seq"))
    return coll.tree_map(
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, out)


@pytest.fixture(scope="module")
def _results():
    """The port's ranks run in a thread's spawns while this thread computes
    the JAX references."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(lambda: {
            n: spawn_cpu(_rank_cases, n, _inputs(n), timeout_s=240)
            for n in NS})
        refs = _all_jax_refs()
        return port.result(), refs


@pytest.fixture(scope="module")
def port(_results):
    return _results[0]


@pytest.fixture(scope="module")
def jax_refs(_results):
    return _results[1]


def _bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("i", range(len(SHAPES)))
@pytest.mark.parametrize("n", NS)
def test_plain_k6_bit_equal_to_pallas_ring(port, jax_refs, n, i):
    """all_reduce_sum(impl="pallas") and ring_all_reduce_pallas equal
    ddw_tpu's ring_all_reduce_pallas (interpret mode) bit for bit, on every
    rank."""
    for r in range(n):
        want = jax_refs[n][f"pallas_s{i}"][r]
        _bits_equal(port[n][r][f"pallas_s{i}"], want)
        _bits_equal(port[n][r][f"pallas_direct_s{i}"], want)


@pytest.mark.parametrize("n", NS)
def test_plain_k6_bf16_rings_in_f32(port, jax_refs, n):
    """A bf16 leaf comes back bf16, bit-equal to ddw_tpu's f32 ring."""
    want = jax_refs[n]["bf16"]
    for r in range(n):
        assert port[n][r]["bf16_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(port[n][r]["bf16"],
                                      want[r].view(np.int16))


@pytest.mark.parametrize("n", NS)
def test_plain_k6_tree_packs_bit_equal(port, jax_refs, n):
    """all_reduce_sum(impl="pallas") of a tree that mixes f32, bf16 and
    int32 leaves of edge sizes rings one pack per ring dtype (two groups of
    2(n-1) hops) and equals ddw_tpu's all_reduce_sum(impl="pallas"), one
    kernel per leaf in interpret mode, and the port's per-leaf ring, bit for
    bit on every rank; a tree on two devices raises."""
    for r in range(n):
        got = port[n][r]["mix"]
        assert sorted(got) == sorted(MIX)
        for key in MIX:
            want = jax_refs[n]["mix"][key][r]
            if key == "e_bf16":
                want = want.view(np.int16)
            _bits_equal(got[key], want)
            _bits_equal(got[key], port[n][r]["mix_per_leaf"][key])
        assert got["c_int"].dtype == np.int32
        assert port[n][r]["mix_hops"] == 2 * 2 * (n - 1)
        assert "one device" in port[n][r]["mixed_devices"]


@pytest.mark.parametrize("dtype", INT_DTYPES)
@pytest.mark.parametrize("n", NS)
def test_plain_k6_integer_and_bool_rings_bit_equal(port, jax_refs, n, dtype):
    """int8, uint8, int16, uint32 and bool ring in their own dtype, bit-equal
    to ddw_tpu's ring_all_reduce_pallas (interpret mode): integer sums wrap
    (the values span each dtype's range, so the sums overflow), bool adds
    as logical or."""
    x = _inputs(n)[f"int_{dtype}"]
    for r in range(n):
        got = port[n][r][f"int_{dtype}"]
        assert got.dtype == np.dtype(dtype)
        _bits_equal(got, jax_refs[n][f"int_{dtype}"][r])
    if dtype == "bool":
        np.testing.assert_array_equal(port[n][0]["int_bool"], x.any(0))
    else:
        wrapped = x.astype(np.int64).sum(0).astype(dtype)  # modulo 2**bits
        np.testing.assert_array_equal(port[n][0][f"int_{dtype}"], wrapped)


@pytest.mark.parametrize("impl", ["psum", "ring", "pallas"])
@pytest.mark.parametrize("n", NS)
def test_integer_tree_through_every_impl(port, jax_refs, n, impl):
    """all_reduce_sum of a tree of int8, uint8, int16, uint32, bool, f32 and
    f16 leaves equals ddw_tpu's all_reduce_sum at the same impl: the rings
    (ppermute and K6) bit for bit; psum bit for bit on the integers (gloo
    lacks int16 and uint32: they sum in int32 and through an int32 view),
    bool as the int32 count of True values (what lax.psum returns), the
    floats within 1e-6 (f32) and 2e-3 (f16) relative, since the reduction
    order is the library's. K6 with a 512-byte slot (several launches per
    dtype) gives the same bits."""
    for r in range(n):
        got, want = port[n][r]["itree"][impl], jax_refs[n]["itree"][impl]
        assert sorted(got) == sorted(INT_TREE)
        for key in INT_TREE:
            w = want[key][r]
            if impl == "psum" and key in ("f", "h"):
                assert got[key].dtype == w.dtype
                tol = 1e-6 if key == "f" else 2e-3
                np.testing.assert_allclose(got[key].astype(np.float32),
                                           w.astype(np.float32), rtol=tol,
                                           atol=tol)
            else:
                _bits_equal(got[key], w)
        if impl == "psum":
            assert got["b"].dtype == np.int32
            np.testing.assert_array_equal(
                got["b"], _inputs(n)["itree_b"].sum(0).astype(np.int32))
        if impl == "pallas":
            for key in INT_TREE:
                _bits_equal(port[n][r]["itree_small_slot"][key], got[key])


@pytest.mark.parametrize("n", NS)
def test_plain_k6_segments(port, jax_refs, n):
    """Rows longer than a slot run as sequential segments, on both sides
    (ddw_tpu's VMEM budget and the port's slot shrunk to 128 values):
    segments change no bits."""
    chunk = rr.ring_chunks(torch.zeros(SEG_SHAPE), n, lane=128).shape[1]
    assert len(rr.ring_segments(chunk, rr.slot_elems_of(128 * 4))) >= 5
    for r in range(n):
        _bits_equal(port[n][r]["seg"], jax_refs[n]["seg"][r])


@pytest.mark.parametrize("i", range(len(SHAPES)))
@pytest.mark.parametrize("n", NS)
def test_ring_all_reduce_bit_equal(port, jax_refs, n, i):
    """The point-to-point ring equals ddw_tpu's ppermute ring bit for bit."""
    for r in range(n):
        _bits_equal(port[n][r][f"ring_s{i}"], jax_refs[n][f"ring_s{i}"][r])


@pytest.mark.parametrize("n", NS)
def test_psum_and_mean(port, jax_refs, n):
    for r in range(n):
        np.testing.assert_allclose(port[n][r]["psum"], jax_refs[n]["psum"][r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(port[n][r]["mean"], jax_refs[n]["mean"][r],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", NS)
def test_broadcast_and_gather_exact(port, jax_refs, n):
    """broadcast_from(root) and all_gather_axis, stacked and tiled."""
    for r in range(n):
        for key in ("bcast", "gather", "gather_tiled"):
            _bits_equal(port[n][r][key], jax_refs[n][key][r])
    assert port[n][0]["gather"].shape == (n, *SHAPES[3])
    assert port[n][0]["gather_tiled"].shape == (n * SHAPES[3][0],
                                                *SHAPES[3][1:])


@pytest.mark.parametrize("n", NS)
def test_tree_dispatch(port, jax_refs, n):
    """all_reduce_sum over a dict tree: psum within 1e-6, the rings bit for
    bit; an unknown impl raises KeyError."""
    for r in range(n):
        got, want = port[n][r]["tree"], jax_refs[n]["tree"]
        for impl in ("psum", "ring", "pallas"):
            assert sorted(got[impl]) == ["a", "b"]
            for key in ("a", "b"):
                if impl == "psum":
                    np.testing.assert_allclose(got[impl][key],
                                               want[impl][key][r], rtol=1e-6,
                                               atol=1e-6)
                else:
                    _bits_equal(got[impl][key], want[impl][key][r])
        assert "unknown allreduce impl" in port[n][r]["unknown_impl"]


@pytest.mark.parametrize("n", NS)
def test_int32_rings_exact(port, n):
    """int32 rings in int32: the exact sum, wrapping modulo 2**32."""
    x = _inputs(n)["int"]
    want = x.astype(np.int64).sum(0)
    want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
    for r in range(n):
        _bits_equal(port[n][r]["int"], want)


@pytest.mark.parametrize("n", NS)
def test_size_one_mesh_axis_is_identity(port, n):
    for r in range(n):
        assert port[n][r]["solo_size"] == 1
        _bits_equal(port[n][r]["solo"], _inputs(n)["s0"][r])


def test_subgroup_ring_stays_in_its_group(port, jax_refs):
    """On a (data=2, seq=2) mesh the seq ring of each data row sums that
    row's two ranks only, bit-equal to ddw_tpu's MESH-addressed ring."""
    x = _inputs(4)["sub"]
    for r in range(4):
        assert port[4][r]["sub_coords"] == (r // 2, r % 2)
        _bits_equal(port[4][r]["sub"], jax_refs["sub"][r])
        np.testing.assert_allclose(port[4][r]["sub"],
                                   x[r // 2 * 2:r // 2 * 2 + 2].sum(0),
                                   rtol=1e-6, atol=1e-6)


def test_world_of_one_is_identity():
    """Without a process group every collective returns its input and no
    kernel launches."""
    x = torch.arange(5.0)
    before = rr.ring_all_reduce_cuda.launches
    for impl in ("psum", "ring", "pallas"):
        assert coll.all_reduce_sum({"a": x}, impl=impl)["a"] is x
    assert coll.all_reduce_mean(x) is x
    assert coll.broadcast_from(x, root=0) is x
    assert coll.ring_all_reduce(x) is x
    assert coll.ring_all_reduce_pallas(x) is x
    assert coll.all_gather_axis(x).shape == (1, 5)
    assert torch.equal(coll.all_gather_axis(x, tiled=True), x)
    assert rr.ring_all_reduce_cuda.launches == before
    mesh = tmesh.make_data_mesh()
    assert mesh.shape == {"data": 1} and mesh.group("data") is None
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)
    assert tmesh.is_coordinator() and tmesh.global_device_count() == 1


def test_ring_framing_matches_jax():
    J = _jax()
    x = np.random.RandomState(3).randn(3, 700).astype(np.float32)
    for n in NS:
        for lane in (1, 128):
            _bits_equal(rr.ring_chunks(torch.from_numpy(x), n, lane).numpy(),
                        np.asarray(J.rr.ring_chunks(J.jnp.asarray(x), n,
                                                    lane)))
    assert rr.ring_segments(640, 128) == [(s, 128) for s in range(0, 640, 128)]
    assert rr.ring_segments(300, 128) == [(0, 128), (128, 128), (256, 44)]


LM_FLASH = dict(vocab_size=8192, max_len=2048, hidden=512, depth=6,
                num_heads=8, mlp_dim=2048,
                dtype="bfloat16")  # bench.py lm_flash


def _covers_once(plan):
    """The launches tile [0, width) in order, and each names exactly the
    arrays with a column in its range."""
    p0 = 0
    for launch in plan.launches:
        assert launch.p0 == p0 < launch.p1
        p0 = launch.p1
        assert launch.leaves == tuple(
            i for i, (o, c) in enumerate(zip(plan.offsets, plan.chunks))
            if c and o < launch.p1 and o + c > launch.p0)
    assert p0 == plan.width


@pytest.mark.parametrize("n", NS)
def test_pack_plan_places_whole_rows_on_lanes(n):
    sizes = [1, 33, n * 128 - 7, 2100, 0, 96, 300]
    plan = rr.ring_pack_plan(sizes, n, rr.slot_elems_of(rr.SLOT_BYTES))
    assert plan.chunks == tuple(rr.ring_chunk_len(s, n, 128) for s in sizes)
    assert all(o % 128 == 0 for o in plan.offsets)
    assert plan.offsets == tuple(np.cumsum((0,) + plan.chunks[:-1]))
    assert plan.width == sum(plan.chunks)
    assert plan.launches == (rr.PackLaunch(0, plan.width, (0, 1, 2, 3, 5, 6)),)


@pytest.mark.parametrize("n", NS)
def test_pack_plan_lm_tree_is_one_launch(n):
    """The lm_flash LM's 102-leaf gradient tree packs into one launch under
    the default slot: 14,180,352 columns a hop at n=2, 7,090,176 at n=4."""
    from ddw_tpu_torch.models.lm import build_lm
    from ddw_tpu_torch.utils.config import LMCfg

    with torch.device("meta"):
        params = dict(build_lm(LMCfg(**LM_FLASH)).named_parameters())
    sizes = [params[k].numel() for k in sorted(params)]
    assert len(sizes) == 102 and sum(sizes) == 28_360_704
    plan = rr.ring_pack_plan(sizes, n, rr.slot_elems_of(rr.SLOT_BYTES))
    assert plan.width == {2: 14_180_352, 4: 7_090_176}[n]
    assert plan.launches == (rr.PackLaunch(0, plan.width, tuple(range(102))),)


@pytest.mark.parametrize("n", NS)
def test_pack_plan_small_slot_covers_every_column_once(n):
    """A 512-byte slot cuts the pack into 128-column launches; 256 arrays
    (the kernel's table) end a launch before the next array's row."""
    sizes = [1, 33, n * 128 - 7, 2100, 0, 5000]
    plan = rr.ring_pack_plan(sizes, n, rr.slot_elems_of(512))
    assert len(plan.launches) == plan.width // 128
    assert all(la.p1 - la.p0 == 128 and len(la.leaves) == 1
               for la in plan.launches)
    _covers_once(plan)
    capped = rr.ring_pack_plan([1] * 600 + [5000], n, 1 << 20)
    assert [la.leaves for la in capped.launches] == [
        tuple(range(256)), tuple(range(256, 512)), tuple(range(512, 601))]
    _covers_once(capped)


def test_ring_dtype_groups():
    """One ring per ring dtype: bf16 and f16 join f32; int32, uint32, int16,
    int8, uint8 and bool each ring apart, in order of first appearance;
    64-bit dtypes, which ddw_tpu never holds, raise."""
    f32, bf16, f16, i32 = (torch.float32, torch.bfloat16, torch.float16,
                           torch.int32)
    assert rr.ring_dtype_groups([bf16, i32, f32, f16, i32]) == [
        (f32, [0, 2, 3]), (i32, [1, 4])]
    assert rr.ring_dtype_groups([torch.int8, torch.uint32, f16, torch.bool,
                                 torch.uint8, torch.int16, torch.int8]) == [
        (torch.int8, [0, 6]), (torch.uint32, [1]), (f32, [2]),
        (torch.bool, [3]), (torch.uint8, [4]), (torch.int16, [5])]
    for wide in (torch.float64, torch.int64):
        with pytest.raises(TypeError, match="64-bit"):
            rr.ring_dtype_groups([f32, wide])


def test_mesh_spec_resolves_like_jax():
    J = _jax()
    for axes, total in (((("data", -1),), 8), ((("data", 2), ("seq", -1)), 8),
                        ((("data", 2), ("seq", 2)), 4)):
        assert tmesh.MeshSpec(axes).resolve(total) == \
            J.MeshSpec(axes).resolve(total)
    for axes in ((("data", -1), ("seq", -1)), (("data", 3),)):
        with pytest.raises(ValueError):
            tmesh.MeshSpec(axes).resolve(8)


def test_unported_dtype_raises_naming_roadmap():
    """Every dtype ddw_tpu rings passes K6's dtype check, and only the
    device check refuses a CPU tensor; f64, which ddw_tpu (run without
    x64) never holds, is refused by the dtype check, by name, on any
    device. Slots count bytes: a 512-byte slot takes 512 int8 columns."""
    comm = types.SimpleNamespace(device=torch.device("cuda", 0), own=1, n=2)
    for dt in (torch.float32, torch.int32, torch.uint32, torch.int16,
               torch.int8, torch.uint8, torch.bool):
        assert rr._RING_DTYPES[dt] in range(5)
        with pytest.raises(ValueError, match="K6 needs tensors on cuda:0"):
            rr.ring_all_reduce_cuda([torch.zeros(3, dtype=dt)], comm)
        assert rr.ring_all_reduce_plain(torch.zeros(3, dtype=dt)).dtype == dt
    with pytest.raises(TypeError, match="64-bit"):
        rr.ring_all_reduce_plain(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(TypeError, match="64-bit"):
        rr.ring_all_reduce_cuda([torch.zeros(3, dtype=torch.float64)], comm)
    assert [rr.slot_elems_of(512, b) for b in (4, 2, 1)] == [128, 256, 512]
