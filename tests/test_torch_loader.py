"""The port's data path (``ddw_tpu_torch.data``) against ``ddw_tpu.data`` on
the CPU: host batches byte-identical to the JAX ``ShardedLoader``'s on one
``raw_u8`` table (shuffle, ``skip_records``, ``shard_plan`` and record-stride
sharding, infinite repeat), the device-side dequantize within 1 ULP of the
host one, super-batches, and the prep plan (split membership, label index,
silver tables) equal to ``ddw_tpu.data.prep``'s."""

import numpy as np
import pytest
import torch

from ddw_tpu.data.loader import ShardedLoader as JaxLoader
from ddw_tpu.data.prep import prepare_flowers as jax_prepare_flowers
from ddw_tpu.data.prep import scan_jpeg_tree as jax_scan_jpeg_tree
from ddw_tpu.data.store import TableStore as JaxStore
from ddw_tpu_torch.data.loader import ShardedLoader, dequantize_raw_u8_device
from ddw_tpu_torch.data.prep import (build_label_index, label_from_path,
                                     prepare_flowers, scan_jpeg_tree)
from ddw_tpu_torch.data.store import Record, TableStore

H = W = 8


@pytest.fixture(scope="module")
def raw_table(tmp_path_factory):
    """70 records of seeded 8x8 uint8 pixels in 7 shards of 10."""
    rng = np.random.RandomState(0)
    store = TableStore(str(tmp_path_factory.mktemp("raw")))
    recs = [Record(f"img/{i:03d}", rng.randint(0, 256, (H, W, 3),
                                               np.uint8).tobytes(),
                   f"c{i % 5}", i % 5) for i in range(70)]
    store.write("raw", recs, shard_size=10,
                meta={"encoding": "raw_u8", "height": H, "width": W})
    return store.root


def _take(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True, seed=3, shuffle_buffer=16),
    dict(shuffle=True, seed=3, shuffle_buffer=16, skip_records=13),
    dict(shuffle=True, seed=1, cur_shard=1, shard_count=3),
    dict(shuffle=True, seed=2, cur_shard=5, shard_count=9),   # stride
    dict(shuffle=False, cur_shard=0, shard_count=2, num_epochs=2),
])
def test_host_batches_byte_identical_to_jax(raw_table, kw):
    # 9 batches of 8 run past one pass of every worker's records: repeat
    n = 9 if kw.get("num_epochs") is None else 4
    port = _take(ShardedLoader(TableStore(raw_table).table("raw"), 8,
                               (H, W), **kw), n)
    ref = _take(JaxLoader(JaxStore(raw_table).table("raw"), 8, (H, W),
                          **kw), n)
    for (x, y), (xr, yr) in zip(port, ref):
        assert x.dtype == xr.dtype == np.float32
        assert x.tobytes() == np.asarray(xr).tobytes()
        assert y.dtype == np.int32 and y.tobytes() == np.asarray(yr).tobytes()


def test_shard_plan_and_refusals_match_jax(raw_table):
    for n, k in ((7, 3), (10, 4), (3, 5), (1, 1)):
        assert ShardedLoader.shard_plan(n, k) == JaxLoader.shard_plan(n, k)
    table = TableStore(raw_table).table("raw")
    with pytest.raises(ValueError, match="out of range"):
        ShardedLoader(table, 4, (H, W), cur_shard=2, shard_count=2)
    with pytest.raises(ValueError, match="materialized table size"):
        ShardedLoader(table, 4, (H + 1, W))
    loader = ShardedLoader(table, 4, (H, W), cur_shard=1, shard_count=3)
    ref = JaxLoader(JaxStore(raw_table).table("raw"), 4, (H, W),
                    cur_shard=1, shard_count=3)
    assert loader.records_per_worker == ref.records_per_worker
    assert loader.steps_per_epoch() == ref.steps_per_epoch()


def test_device_dequant_within_one_ulp_of_host(raw_table):
    table = TableStore(raw_table).table("raw")
    host = _take(ShardedLoader(table, 8, (H, W), seed=4), 3)
    dev = _take(ShardedLoader(table, 8, (H, W), seed=4, prefetch_to="cpu"), 3)
    for (x, y), (xd, yd) in zip(host, dev):
        assert isinstance(xd, torch.Tensor) and xd.dtype == torch.float32
        assert np.array_equal(y, yd.numpy())
        ulp = np.spacing(np.abs(x).astype(np.float32))
        assert (np.abs(xd.numpy() - x) <= ulp).all()
    u8 = torch.arange(256, dtype=torch.uint8)
    ref = u8.numpy().astype(np.float32) / 127.5 - 1.0
    assert np.array_equal(dequantize_raw_u8_device(u8).numpy(), ref)


def test_super_batches_stack_in_plan_order(raw_table):
    table = TableStore(raw_table).table("raw")
    flat = _take(ShardedLoader(table, 4, (H, W), seed=5, prefetch_to="cpu"),
                 6)
    sup = _take(ShardedLoader(table, 4, (H, W), seed=5, prefetch_to="cpu",
                              super_batch=(2, 1)), 4)
    assert [tuple(x.shape[:2]) for x, _ in sup] == [(2, 4), (1, 4)] * 2
    stacked = [b for x, y in sup for b in zip(x, y)]
    for (x, y), (xs, ys) in zip(flat, stacked):
        assert torch.equal(x, xs) and torch.equal(y, ys)
    with pytest.raises(ValueError, match="prefetch_to"):
        ShardedLoader(table, 4, (H, W), super_batch=2)
    # an all-ones plan is plain per-step batches
    assert ShardedLoader(table, 4, (H, W), super_batch=(1, 1))._super_plan \
        is None


def test_prep_matches_jax(flowers_dir, tmp_path):
    assert scan_jpeg_tree(flowers_dir, 0.5, seed=7) == \
        jax_scan_jpeg_tree(flowers_dir, 0.5, seed=7)
    paths = scan_jpeg_tree(flowers_dir)
    labels = [label_from_path(p) for p in paths]
    assert build_label_index(labels) == {
        c: i for i, c in enumerate(sorted(set(labels)))}
    tr, va, idx = prepare_flowers(flowers_dir, TableStore(str(tmp_path / "p")),
                                  sample_fraction=0.8, shard_size=16)
    jtr, jva, jidx = jax_prepare_flowers(flowers_dir,
                                         JaxStore(str(tmp_path / "j")),
                                         sample_fraction=0.8, shard_size=16)
    assert idx == jidx
    for a, b in ((tr, jtr), (va, jva)):
        assert a.num_records == b.num_records and a.meta == b.meta
        ra = [(r.path, r.content, r.label, r.label_idx)
              for r in a.iter_records()]
        rb = [(r.path, r.content, r.label, r.label_idx)
              for r in b.iter_records()]
        assert ra == rb


def test_feature_and_token_tables_are_refused(tmp_path):
    """Cached-feature tables are still refused, naming the roadmap; token
    tables are read (the LM training slice) as next-token pairs."""
    store = TableStore(str(tmp_path))
    t = store.write("features_f32", [Record("a", b"\0" * 16)],
                    meta={"encoding": "features_f32"})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ShardedLoader(t, 1, (H, W))
    toks = np.arange(4, dtype=np.int32)
    t = store.write("tokens_i32", [Record("a", toks.tobytes())],
                    meta={"encoding": "tokens_i32", "seq_plus_one": 4})
    x, y = _take(ShardedLoader(t, 1), 1)[0]
    assert x.tolist() == [[0, 1, 2]] and y.tolist() == [[1, 2, 3]]


@pytest.fixture(scope="module")
def token_tables(tmp_path_factory):
    """The same 45 seeded [17]-token rows (shards of 8) written by both
    packages' write_token_table."""
    from ddw_tpu.data.prep import write_token_table as jax_write_token_table
    from ddw_tpu_torch.data.prep import write_token_table

    toks = np.random.RandomState(1).randint(0, 1000, (45, 17)).astype(
        np.int32)
    root = tmp_path_factory.mktemp("tok")
    write_token_table(TableStore(str(root / "port")), "toks", toks,
                      shard_size=8)
    jax_write_token_table(JaxStore(str(root / "jax")), "toks", toks,
                          shard_size=8)
    return str(root / "port"), str(root / "jax")


@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True, seed=3, shuffle_buffer=16),
    dict(shuffle=True, seed=3, shuffle_buffer=16, skip_records=19),
    dict(shuffle=True, seed=1, cur_shard=1, shard_count=2),
    dict(shuffle=True, seed=2, cur_shard=3, shard_count=7),  # stride
])
def test_token_batches_byte_identical_to_jax(token_tables, kw):
    """tokens_i32 batches: (inputs [B, S], targets [B, S]) int32 next-token
    pairs, byte for byte the JAX loader's, including skip_records resume
    and both kinds of sharding; the table files are byte-identical too."""
    port_root, jax_root = token_tables
    port = _take(ShardedLoader(TableStore(port_root).table("toks"), 4,
                               **kw), 8)
    ref = _take(JaxLoader(JaxStore(jax_root).table("toks"), 4, **kw), 8)
    for (x, y), (xr, yr) in zip(port, ref):
        assert x.dtype == y.dtype == np.int32 and x.shape == (4, 16)
        assert x.tobytes() == np.asarray(xr).tobytes()
        assert y.tobytes() == np.asarray(yr).tobytes()
        assert (x[:, 1:] == y[:, :-1]).all()


def test_token_batches_on_device_and_super_batches(token_tables):
    """prefetch_to gives the same batches as tensors; super-batches stack
    them in plan order."""
    table = TableStore(token_tables[0]).table("toks")
    host = _take(ShardedLoader(table, 4, seed=5), 6)
    dev = _take(ShardedLoader(table, 4, seed=5, prefetch_to="cpu"), 6)
    sup = _take(ShardedLoader(table, 4, seed=5, prefetch_to="cpu",
                              super_batch=(2, 1)), 4)
    assert [tuple(x.shape) for x, _ in sup] == [(2, 4, 16), (1, 4, 16)] * 2
    stacked = [b for x, y in sup for b in zip(x, y)]
    for (x, y), (xd, yd), (xs, ys) in zip(host, dev, stacked):
        assert xd.dtype == torch.int32 and np.array_equal(x, xd.numpy())
        assert np.array_equal(y, yd.numpy())
        assert torch.equal(xd, xs) and torch.equal(yd, ys)
