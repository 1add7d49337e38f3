"""The port's data prep leftovers on the CPU against ``ddw_tpu.data``:
``generate_synthetic_flowers`` writes byte-identical JPEGs; the 2-worker
``prepare_flowers_distributed`` (worker 1 in a spawned process) gives the
split membership and label index of ``prepare_flowers`` and the same part and
merged tables as JAX's; ``await_parts`` refuses a stale run token and honours
``abort``; ``merge_shards`` adopts the parts' shard files verbatim."""

import filecmp
import multiprocessing
import os

import pytest

from ddw_tpu.data import prep as jprep
from ddw_tpu.data.store import TableStore as JaxStore
from ddw_tpu_torch.data import prep
from ddw_tpu_torch.data.store import Record, RecordSchema, TableStore


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("flowers")
    ours = prep.generate_synthetic_flowers(str(root / "ours"),
                                           images_per_class=6, size=40,
                                           seed=3)
    theirs = jprep.generate_synthetic_flowers(str(root / "theirs"),
                                              images_per_class=6, size=40,
                                              seed=3)
    return ours, theirs


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_flowers_are_byte_identical(trees):
    ours, theirs = trees
    files = _files(ours)
    assert files == _files(theirs) and len(files) == 30
    assert sorted({f.split(os.sep)[0] for f in files}) == \
        prep.FLOWER_CLASSES == jprep.FLOWER_CLASSES
    match, mismatch, errors = filecmp.cmpfiles(ours, theirs, files,
                                               shallow=False)
    assert mismatch == [] and errors == [] and len(match) == 30


def _rows(table):
    return sorted((r.path, r.content, r.label, r.label_idx)
                  for r in table.iter_records())


def test_two_worker_prep_equals_single_and_jax(trees, tmp_path):
    source = trees[0]
    kw = dict(sample_fraction=0.8, shard_size=4)
    single = prep.prepare_flowers(source, TableStore(str(tmp_path / "one")),
                                  **kw)
    root = str(tmp_path / "two")
    # the worker process imports the port alone (no JAX)
    proc = multiprocessing.get_context("spawn").Process(
        target=prep.prepare_flowers_distributed,
        args=(source, TableStore(root), 1, 2), kwargs=kw)
    proc.start()
    try:
        tr, va, idx = prep.prepare_flowers_distributed(
            source, TableStore(root), 0, 2, merge_timeout_s=120,
            abort=lambda: (f"worker exited with {proc.exitcode}"
                           if proc.exitcode not in (None, 0) else None),
            **kw)
    finally:
        proc.join(timeout=60)
    assert proc.exitcode == 0
    assert idx == single[2]
    assert _rows(tr) == _rows(single[0]) and _rows(va) == _rows(single[1])
    assert tr.meta["worker_count"] == 2 and tr.meta["label_to_idx"] == idx

    # JAX's parts and merge from the same plan: the same record streams
    jroot = str(tmp_path / "jax")
    jprep.prepare_flowers_distributed(source, JaxStore(jroot), 1, 2, **kw)
    jtr, jva, jidx = jprep.prepare_flowers_distributed(
        source, JaxStore(jroot), 0, 2, merge_timeout_s=30, **kw)
    assert jidx == idx
    for a, b in ((tr, jtr), (va, jva)):
        assert [(r.path, r.content, r.label, r.label_idx)
                for r in a.iter_records()] == \
            [(r.path, r.content, r.label, r.label_idx)
             for r in b.iter_records()]
        assert a.meta == b.meta
        assert [s["sha256"] for s in a.manifest["shards"]] == \
            [s["sha256"] for s in b.manifest["shards"]]
    with pytest.raises(ValueError, match="out of range"):
        prep.prepare_flowers_distributed(source, TableStore(root), 2, 2)


def test_await_parts_refuses_a_stale_run_token(tmp_path):
    store = TableStore(str(tmp_path))
    store.write("preds_p0", [Record("a", b"")], meta={"run_id": "now"})
    store.write("preds_p1", [Record("b", b"")], meta={"run_id": "earlier"})
    with pytest.raises(TimeoutError, match=r"preds_p1 \(stale run_id\)"):
        store.await_parts(["preds_p0", "preds_p1"], "now", timeout_s=0.5)
    with pytest.raises(TimeoutError, match="preds_p2"):
        store.await_parts(["preds_p2"], "now", timeout_s=0.3)
    with pytest.raises(RuntimeError, match="worker 1 died"):
        store.await_parts(["preds_p1"], "now", timeout_s=60,
                          abort=lambda: "worker 1 died")
    store.write("preds_p1", [Record("c", b"x")], meta={"run_id": "now"})
    parts = store.await_parts(["preds_p0", "preds_p1"], "now", timeout_s=5)
    merged = store.merge_shards("preds", parts, meta={"run_id": "now"})
    assert [r.path for r in merged.iter_records()] == ["a", "c"]
    assert merged.manifest["schema"] == list(RecordSchema().fields)
    assert [s["sha256"] for s in merged.manifest["shards"]] == \
        [p.manifest["shards"][0]["sha256"] for p in parts]
    assert os.path.samefile(merged.shard_paths[1], parts[1].shard_paths[0])
    assert store.exists("preds") and not store.exists("nope")
    assert [r.path for r in merged.take(1)] == ["a"]
    # the JAX package reads the merged table and agrees on run tokens
    assert [r.path for r in JaxStore(store.root).table("preds")
            .iter_records()] == ["a", "c"]
    assert TableStore.run_token("t", 1, "d") == JaxStore.run_token("t", 1,
                                                                   "d")
