"""The port's native host code (``ddw_tpu_torch.native``: the libjpeg decode
pipeline and the shard codec) against ``ddw_tpu.native`` on the CPU, on
seeded numpy images encoded as JPEGs with PIL: the same pixels bit for bit
(RGB, grayscale, an upscaled small image, a corrupt file that falls back to
PIL), the same ``preprocess_image`` and ``active_decoder`` in both packages,
byte-equal ``materialize_decoded`` tables, the same records from native and
Python shard reads, and a ``ddw_tpu`` package saved with the native decoder
loading in the port without a skew warning. Where g++ or libjpeg is
missing, the tests skip and say which."""

import io
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import ddw_tpu.data.loader as jloader
import ddw_tpu.native.decode as jdecode
from ddw_tpu.data.prep import materialize_decoded as j_materialize
from ddw_tpu.data.store import TableStore as JStore
from ddw_tpu_torch.data import loader as tloader
from ddw_tpu_torch.data import store as tstore
from ddw_tpu_torch.data.prep import materialize_decoded as t_materialize
from ddw_tpu_torch.data.store import Record, TableStore
from ddw_tpu_torch.native import codec as tcodec
from ddw_tpu_torch.native import decode as tdecode


@pytest.fixture(scope="module")
def native():
    """Skip unless both packages build their native libraries here."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native pipeline cannot build")
    if not tdecode.native_available():
        pytest.skip(f"the native pipeline did not build or load here "
                    f"(libjpeg missing?): {tdecode.build_error()}")
    if not jdecode.native_available():
        pytest.skip("ddw_tpu's native pipeline did not build here")
    if not tcodec.native_available():
        pytest.skip("the native shard codec did not build here")


def _jpeg(h, w, mode="RGB", seed=0, quality=90):
    """A seeded noisy image (the case the two decoders differ most on)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img = Image.fromarray(base).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


_CASES = {
    "rgb_256": lambda: _jpeg(256, 256, seed=1),
    "rgb_odd_333x517": lambda: _jpeg(333, 517, seed=2),
    "grayscale_300x200": lambda: _jpeg(300, 200, "L", seed=3),
    "upscaled_40x50": lambda: _jpeg(40, 50, seed=4),
    "exact_224": lambda: _jpeg(224, 224, seed=5),
    "dct_scaled_448": lambda: _jpeg(448, 448, seed=6),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_decode_one_equals_ddw_tpu_bit_for_bit(native, case):
    content = _CASES[case]()
    for h, w in ((224, 224), (32, 48)):
        got = tdecode.decode_one_native(content, h, w)
        want = jdecode.decode_one_native(content, h, w)
        assert got is not None and got.dtype == np.float32
        assert got.shape == (h, w, 3)
        assert np.array_equal(got, want)
        assert np.array_equal(tloader.preprocess_image(content, h, w),
                              jloader.preprocess_image(content, h, w))


def test_decode_batch_equals_ddw_tpu_and_falls_back_on_corrupt(native):
    contents = [_CASES[c]() for c in sorted(_CASES)]
    corrupt = contents[0][:200] + b"\x00" * 50
    batch = contents + [b"not a jpeg", corrupt]
    got, ok = tdecode.decode_batch_native(batch, 224, 224, threads=3)
    want, jok = jdecode.decode_batch_native(batch, 224, 224, threads=3)
    assert ok.tolist() == jok.tolist()
    assert ok[:len(contents)].all() and not ok[len(contents)]
    assert np.array_equal(got[ok], want[jok])
    for i in range(len(contents)):
        assert np.array_equal(got[i],
                              tdecode.decode_one_native(batch[i], 224, 224))
    # a file the native decoder refuses goes to PIL, in both packages
    assert tdecode.decode_one_native(b"not a jpeg", 8, 8) is None
    from PIL import Image

    png = io.BytesIO()
    Image.fromarray(np.full((20, 30, 3), 77, np.uint8)).save(png, "PNG")
    png = png.getvalue()
    assert tdecode.decode_one_native(png, 16, 16) is None
    np.testing.assert_array_equal(tloader.preprocess_image(png, 16, 16),
                                  jloader.preprocess_image(png, 16, 16))
    # a caller buffer of the wrong dtype is refused before the library runs
    with pytest.raises(ValueError, match="float32"):
        tdecode.decode_batch_native(contents[:1], 8, 8,
                                    out=np.empty((1, 8, 8, 3), np.float64))
    empty, eok = tdecode.decode_batch_native([], 8, 8)
    assert empty.shape == (0, 8, 8, 3) and eok.shape == (0,)


def test_active_decoder_agrees_across_packages(native):
    assert tloader.active_decoder() == jloader.active_decoder() == "native"


def test_pil_fallback_matches_ddw_tpus_pil_path(monkeypatch):
    """Where the native pipeline is unavailable both packages decode with
    PIL, to the same pixels, and say ``pil``."""
    content = _CASES["rgb_256"]()
    monkeypatch.setattr(tdecode, "decode_one_native", lambda *a: None)
    monkeypatch.setattr(tdecode, "native_available", lambda: False)
    assert tloader.active_decoder() == "pil"
    np.testing.assert_array_equal(
        tloader.preprocess_image(content, 64, 64),
        jloader._preprocess_image_pil(content, 64, 64))


def _silver(root, n=12):
    """A silver-like table of seeded JPEGs in both stores (the same
    records, written by each package)."""
    recs = [Record(f"img/{i:03d}.jpg", _jpeg(96 + 8 * i, 120, seed=10 + i),
                   f"c{i % 3}", i % 3) for i in range(n)]
    t = TableStore(os.path.join(root, "t")).write(
        "silver", recs, shard_size=5, meta={"label_to_idx": {}})
    from ddw_tpu.data.store import Record as JRecord

    j = JStore(os.path.join(root, "j")).write(
        "silver", [JRecord(r.path, r.content, r.label, r.label_idx)
                   for r in recs], shard_size=5, meta={"label_to_idx": {}})
    return t, j


def _shard_bytes(table):
    return [open(p, "rb").read() for p in table.shard_paths]


def test_materialize_decoded_is_byte_equal_across_packages(native, tmp_path):
    t, j = _silver(str(tmp_path))
    out_t = t_materialize(t, TableStore(str(tmp_path / "t")), "decoded",
                          48, 64, shard_size=5)
    out_j = j_materialize(j, JStore(str(tmp_path / "j")), "decoded", 48, 64,
                          shard_size=5)
    assert out_t.meta["encoding"] == out_j.meta["encoding"] == "raw_u8"
    assert _shard_bytes(out_t) == _shard_bytes(out_j)
    assert out_t.manifest["shards"] == out_j.manifest["shards"]


def test_native_and_python_shard_reads_give_the_same_records(native,
                                                             tmp_path,
                                                             monkeypatch):
    t, _ = _silver(str(tmp_path), n=7)
    assert tstore._native_reader() is tcodec
    native_recs = [r for p in t.shard_paths for r in tstore.read_shard(p)]
    native_pairs = [x for p in t.shard_paths
                    for x in tstore.read_shard_contents(p)]
    monkeypatch.setenv("DDW_NATIVE_CODEC", "0")
    assert tstore._native_reader() is None
    py_recs = [r for p in t.shard_paths for r in tstore.read_shard(p)]
    py_pairs = [x for p in t.shard_paths
                for x in tstore.read_shard_contents(p)]
    assert native_recs == py_recs and len(py_recs) == 7
    assert native_pairs == py_pairs == [(r.content, r.label_idx)
                                        for r in py_recs]
    # a corrupt shard raises from the native codec, not a silent re-read
    monkeypatch.delenv("DDW_NATIVE_CODEC")
    bad = tmp_path / "bad.ddws"
    bad.write_bytes(open(t.shard_paths[0], "rb").read()[:40])
    with pytest.raises(RuntimeError, match="native codec"):
        list(tstore.read_shard(str(bad)))


def test_loader_batches_decode_natively_and_equal_ddw_tpus(native, tmp_path):
    """The JPEG batch path: one native call per batch in both packages'
    ShardedLoader, the same host batches bit for bit."""
    from ddw_tpu.data.loader import ShardedLoader as JLoader

    t, j = _silver(str(tmp_path), n=12)
    kw = dict(batch_size=4, image_size=(40, 56), num_epochs=1, seed=3,
              shuffle_buffer=8, workers=2)
    got = list(tloader.ShardedLoader(t, **kw))
    want = list(JLoader(j, **kw))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)


def test_ddw_tpu_native_package_loads_without_skew_warning(native,
                                                           tmp_path):
    from ddw_tpu.serving.package import save_packaged_model as j_save
    from ddw_tpu.utils.config import ModelCfg as JModelCfg
    from ddw_tpu_torch.models.convert import to_flax_variables
    from ddw_tpu_torch.models.layers import init_params
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.serving.package import PackagedModel
    from ddw_tpu_torch.utils.config import ModelCfg

    model = build_model(ModelCfg(name="small_cnn", dtype="float32"))
    init_params(model, torch.Generator().manual_seed(0))
    v = to_flax_variables(model)
    pkg = j_save(str(tmp_path / "pkg"), JModelCfg(name="small_cnn",
                                                  dtype="float32"),
                 ["a", "b", "c", "d", "e"], v["params"], None, 32, 32)
    import json

    with open(os.path.join(pkg, "package.json")) as f:
        assert json.load(f)["preprocess_impl"] == "native"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pm = PackagedModel(pkg, device="cpu")
    content = _CASES["rgb_256"]()
    from ddw_tpu.serving.package import PackagedModel as JPackaged

    x = pm._decode_one(content)
    assert np.array_equal(x, JPackaged(pkg)._decode_one(content))
    assert pm.predict([content]) and len(pm.predict([content, content])) == 2
