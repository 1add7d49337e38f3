"""Packaged-model serving in the PyTorch port (``ddw_tpu_torch.serving``)
against ``ddw_tpu.serving`` on the CPU: the msgpack codec against flax's,
packages crossing between the two packages in both directions (f32 and int8),
both ``BatchScorer``s on one table, and the port's 2-rank ``merge=True``
scoring (gloo processes) against its single-process table."""

import io
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from ddw_tpu.data.store import TableStore as JaxTableStore
from ddw_tpu.serving import batch as jax_batch
from ddw_tpu.serving import package as jax_package
from ddw_tpu.utils.config import ModelCfg as JaxModelCfg
from ddw_tpu_torch.data.store import Record, TableStore
from ddw_tpu_torch.serving import _msgpack
from ddw_tpu_torch.serving.batch import (BatchScorer, _scoring_run_id,
                                         merge_predictions)
from ddw_tpu_torch.serving.package import PackagedModel, save_packaged_model
from ddw_tpu_torch.utils.config import ModelCfg
from examples_torch.common import score_distributed

HW = 32
CLASSES = ["daisy", "dandelion", "roses", "sunflowers", "tulips"]
CFG = dict(name="mobilenet_v2", num_classes=5, width_mult=0.35, dropout=0.0,
           allow_frozen_random=True, dtype="float32", dw_impl="pallas")


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).randint(
        0, 256, (20, HW, HW, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def variables(images):
    """Flax variables of a small MobileNetV2 with non-trivial statistics and
    a head centred on the test images, so that the classes differ across
    images (a random backbone maps them all to nearly one feature)."""
    from ddw_tpu.models.mobilenet_v2 import MobileNetV2

    model = MobileNetV2(width_mult=0.35, dtype=jnp.float32, dropout=0.0)
    init = jax.jit(model.init, static_argnames="train")
    v = init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, HW, HW, 3)),
             train=False)
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.RandomState(0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            v["batch_stats"])[0]:
        var = jax.tree_util.keystr(path).endswith("['var']")
        leaf[...] = rng.uniform(0.5, 1.5, leaf.shape) if var else \
            rng.uniform(-0.2, 0.2, leaf.shape)
    v["params"]["head"]["kernel"] *= 50.0
    logits = jax.jit(model.apply, static_argnames="train")(
        v, jnp.asarray(_as_float(images)), train=False)
    v["params"]["head"]["bias"] -= np.asarray(logits).mean(axis=0)
    return v


def _as_float(u8):
    return u8.astype(np.float32) / 127.5 - 1.0


def _jax_save(path, v, quantize=None):
    return jax_package.save_packaged_model(
        str(path), JaxModelCfg(**CFG), CLASSES, v["params"],
        v["batch_stats"], img_height=HW, img_width=HW, quantize=quantize)


def _port_save(path, v, quantize=None):
    return save_packaged_model(
        str(path), ModelCfg(**CFG), CLASSES, v["params"], v["batch_stats"],
        img_height=HW, img_width=HW, quantize=quantize)


def test_msgpack_matches_flax_both_ways():
    rng = np.random.RandomState(0)
    tree = {
        "params": {"a": rng.randn(3, 4).astype(np.float32),
                   "big": rng.randn(70000).astype(np.float32),
                   "q": rng.randint(-127, 128, (5, 2)).astype(np.int8)},
        "batch_stats": {},
        "scalars": {"f": np.float32(1.5), "i": np.int64(-7),
                    "b": np.bool_(True)},
        # (flax turns lists into {"0": ...} maps before encoding)
        "plain": {"ints": {str(i): n for i, n in enumerate(
                      [0, 127, 128, 255, 256, -1, -32, -33, -200, 70000,
                       -70000, 2 ** 33, -(2 ** 40)])},
                  "float": 2.25, "none": None, "t": True, "f": False,
                  "s": "x" * 40, "long": "y" * 300, "bin": b"\x00\x01"},
        **{f"k{i}": np.arange(i, dtype=np.int32) for i in range(20)},
    }
    blob = serialization.to_bytes(tree)
    assert _msgpack.packb(tree) == blob
    ours = _msgpack.unpackb(blob)
    theirs = serialization.msgpack_restore(_msgpack.packb(tree))
    for got in (ours, theirs):
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_g, flat_t):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_msgpack_bfloat16_decodes_losslessly():
    x = jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16)
    got = _msgpack.unpackb(serialization.to_bytes({"w": np.asarray(x)}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(serialization.to_bytes({"w": 1}) + b"\x00")


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_both_packages_write_identical_artifacts(tmp_path, variables,
                                                 quantize):
    a = _jax_save(tmp_path / "jax", variables, quantize)
    b = _port_save(tmp_path / "port", variables, quantize)
    with open(os.path.join(a, "params.msgpack"), "rb") as f:
        blob_a = f.read()
    with open(os.path.join(b, "params.msgpack"), "rb") as f:
        assert f.read() == blob_a
    with open(os.path.join(a, "package.json")) as fa, \
            open(os.path.join(b, "package.json")) as fb:
        meta_a, meta_b = json.load(fa), json.load(fb)
    meta_a.pop("preprocess_impl"), meta_b.pop("preprocess_impl")
    assert meta_a == meta_b


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_is_quantized_tree_and_load_packaged_model(tmp_path, variables,
                                                   images, quantize):
    from ddw_tpu.serving.quantize import is_quantized_tree as jax_is_q
    from ddw_tpu_torch.serving.package import load_packaged_model
    from ddw_tpu_torch.serving.quantize import is_quantized_tree

    pkg = _port_save(tmp_path / "pkg", variables, quantize)
    with open(os.path.join(pkg, "params.msgpack"), "rb") as f:
        tree = _msgpack.unpackb(f.read())
    assert is_quantized_tree(tree) == jax_is_q(tree) == (quantize == "int8")
    assert not is_quantized_tree(variables) and not is_quantized_tree(1.0)
    pm = load_packaged_model(pkg, device="cpu")
    assert isinstance(pm, PackagedModel) and pm.device.type == "cpu"
    x = _as_float(images[:4])
    np.testing.assert_array_equal(
        pm.predict_logits(x), PackagedModel(pkg, device="cpu")
        .predict_logits(x))


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packages_cross_load(tmp_path, variables, images, writer, quantize):
    save = _jax_save if writer == "jax" else _port_save
    pkg = save(tmp_path / "pkg", variables, quantize)
    with warnings.catch_warnings():
        # tolerated, not required: the decoder the JAX side records depends
        # on whether its native build is present
        warnings.filterwarnings("ignore", message=".*image decoder.*")
        ours = PackagedModel(pkg, device="cpu")
    theirs = jax_package.PackagedModel(pkg)
    assert ours.content_digest == theirs.content_digest
    assert ours.classes == theirs.classes == CLASSES
    x = _as_float(images)
    got, ref = ours.predict_logits(x), theirs.predict_logits(x)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert ours.predict(x) == theirs.predict(x)
    assert len(set(ours.predict(x))) > 1, "classes differ across images"


def test_decoder_skew_warns(tmp_path, variables):
    pkg = _port_save(tmp_path / "pkg", variables)
    meta_path = os.path.join(pkg, "package.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["preprocess_impl"] = "native"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.warns(UserWarning, match="image decoder"):
        PackagedModel(pkg, device="cpu")


def test_predict_inputs(tmp_path, variables, images):
    pm = PackagedModel(_port_save(tmp_path / "pkg", variables), device="cpu")
    assert pm.predict_logits([]).shape == (0, 5)
    x = _as_float(images[:3])
    assert pm.predict(list(x)) == pm.predict(x)
    assert list(pm.predict(x, return_indices=True)) == [
        CLASSES.index(c) for c in pm.predict(x)]
    with pytest.raises(TypeError, match="cannot decode"):
        pm.predict([1, 2])


def test_batch_scorers_agree_on_raw_u8_table(tmp_path, variables, images):
    store = TableStore(str(tmp_path / "tables"))
    table = store.write(
        "u8", (Record(f"img{i}", im.tobytes()) for i, im in enumerate(images)),
        shard_size=8, meta={"encoding": "raw_u8", "height": HW, "width": HW})
    pkg = _port_save(tmp_path / "pkg", variables)

    ours = BatchScorer(pkg, workers=2, device="cpu").score_table(
        table, out_store=store)
    jax_store = JaxTableStore(str(tmp_path / "tables"))
    jax_table = jax_store.table("u8")
    theirs = jax_batch.BatchScorer(jax_package.PackagedModel(pkg)).score_table(
        jax_table, out_store=jax_store, out_name="jax_predictions")
    assert ours == theirs
    assert [p for p, _ in ours] == [f"img{i}" for i in range(len(images))]
    # each store reads the other's output table; both carry one run token
    mine, other = store.table("jax_predictions"), jax_store.table("predictions")
    assert [(r.path, r.label) for r in mine.iter_records()] == ours
    assert [(r.path, r.label) for r in other.iter_records()] == ours
    assert mine.meta["run_id"] == other.meta["run_id"]


def test_port_scorer_decode_path_matches_predict(tmp_path, variables, images):
    from PIL import Image

    def jpeg(im):
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="JPEG", quality=90)
        return buf.getvalue()

    blobs = [jpeg(im) for im in images[:10]]
    store = TableStore(str(tmp_path / "tables"))
    table = store.write("jpeg", (Record(f"j{i}", b) for i, b in
                                 enumerate(blobs)), shard_size=4)
    pm = PackagedModel(_port_save(tmp_path / "pkg", variables), device="cpu")
    got = BatchScorer(pm, batch_per_device=3, workers=2).score_table(table)
    assert got == list(zip([f"j{i}" for i in range(10)], pm.predict(blobs)))


def test_scorer_process_topology(tmp_path, variables, images, monkeypatch):
    store = TableStore(str(tmp_path / "tables"))
    table = store.write(
        "u8", (Record(f"img{i}", im.tobytes()) for i, im in enumerate(images)),
        shard_size=5, meta={"encoding": "raw_u8", "height": HW, "width": HW})
    scorer = BatchScorer(_port_save(tmp_path / "pkg", variables),
                         device="cpu")
    monkeypatch.setenv("DDW_NUM_PROCESSES", "2")
    monkeypatch.setenv("DDW_PROCESS_ID", "1")
    # rank 1 writes its part and leaves the merge to rank 0
    merged_part = scorer.score_table(table, out_store=store)
    assert not store.exists("predictions")
    part = scorer.score_table(table, out_store=store, merge=False)
    assert part == merged_part
    # rank 1 of 2 takes shards 1 and 3 of 4
    assert [p for p, _ in part] == [f"img{i}" for i in (*range(5, 10),
                                                        *range(15, 20))]
    assert [r.path for r in store.table("predictions_p1").iter_records()] == \
        [p for p, _ in part]
    monkeypatch.setenv("DDW_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="topology"):
        scorer.score_table(table)


def test_scorer_refuses_wrong_size_table(tmp_path, variables, images):
    store = TableStore(str(tmp_path / "tables"))
    table = store.write("u8", [Record("a", images[0].tobytes())],
                        meta={"encoding": "raw_u8", "height": 16,
                              "width": 64})
    scorer = BatchScorer(_port_save(tmp_path / "pkg", variables),
                         device="cpu")
    with pytest.raises(ValueError, match="materialized table is 16x64"):
        scorer.score_table(table)


def test_two_rank_merged_scoring_equals_single_process(tmp_path, variables,
                                                        images, monkeypatch):
    store = TableStore(str(tmp_path / "tables"))
    table = store.write(
        "u8", (Record(f"img{i:02d}", im.tobytes(), CLASSES[i % 5], i % 5)
               for i, im in enumerate(images)),
        shard_size=3, meta={"encoding": "raw_u8", "height": HW, "width": HW})
    pkg = _port_save(tmp_path / "pkg", variables)
    scorer = BatchScorer(pkg, device="cpu", batch_per_device=4)
    single = scorer.score_table(table, out_store=store, out_name="single")

    # an earlier run with other weights left a part under the same name
    stale = jax.tree_util.tree_map(np.copy, variables)
    stale["params"]["head"]["bias"] += 1.0
    old = BatchScorer(_port_save(tmp_path / "old", stale), device="cpu")
    monkeypatch.setenv("DDW_NUM_PROCESSES", "2")
    monkeypatch.setenv("DDW_PROCESS_ID", "1")
    old.score_table(table, out_store=store, out_name="merged", merge=False)
    monkeypatch.setenv("DDW_PROCESS_ID", "0")
    scorer.score_table(table, out_store=store, out_name="merged", merge=False)
    run_id = _scoring_run_id(table, scorer.model.content_digest)
    assert store.table("merged_p1").meta["run_id"] != run_id
    with pytest.raises(TimeoutError, match=r"merged_p1 \(stale run_id\)"):
        merge_predictions(store, "merged", 2, run_id, timeout_s=0.5)
    assert not store.exists("merged")
    monkeypatch.delenv("DDW_NUM_PROCESSES")
    monkeypatch.delenv("DDW_PROCESS_ID")

    # the ranks run examples_torch's scoring rank, which imports no JAX
    rows = score_distributed(pkg, store, "u8", "merged", 2, device="cpu",
                             batch_per_device=4)
    merged = store.table("merged")
    assert merged.meta["run_id"] == run_id
    assert merged.meta["merged_from"] == ["merged_p0", "merged_p1"]
    assert sorted(rows) == sorted(single)
    want = sorted((r.path, r.content, r.label, r.label_idx)
                  for r in store.table("single").iter_records())
    got = sorted((r.path, r.content, r.label, r.label_idx)
                 for r in merged.iter_records())
    assert got == want and len(got) == len(images)
