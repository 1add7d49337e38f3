"""Packaged LMs in the PyTorch port (``ddw_tpu_torch.serving.lm_package``,
``serving.batch.LMBatchScorer``, ``data.prep.write_token_table``) against
``ddw_tpu`` on the CPU: packages crossing between the two packages in both
directions (f32 and int8, LoRA included), bucketed scoring and generation,
token tables byte-identical across packages and both batch scorers on one
table."""

import json
import os

import jax
import numpy as np
import pytest

from ddw_tpu.data.prep import write_token_table as jax_write_token_table
from ddw_tpu.data.store import TableStore as JaxTableStore
from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.serving.batch import LMBatchScorer as JaxLMBatchScorer
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.data.prep import write_token_table
from ddw_tpu_torch.data.store import Record, TableStore
from ddw_tpu_torch.serving.batch import LMBatchScorer
from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                              load_lm_package,
                                              save_lm_package, sequence_nll)
from ddw_tpu_torch.utils.config import LMCfg

VOCAB = 32
CFG = dict(vocab_size=VOCAB, max_len=64, hidden=32, depth=2, num_heads=2,
           mlp_dim=64, dropout=0.0, dtype="float32")


def _params(seed=0, **kw):
    model = jax_build_lm(JaxLMCfg(**dict(CFG, **kw)))
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        np.zeros((1, 8), np.int32))["params"]
    return jax.tree_util.tree_map(np.array, params)


def _tokens(n=4, seq=16, seed=0):
    return np.random.RandomState(seed).randint(
        0, VOCAB, size=(n, seq + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_packages_cross_both_ways(tmp_path, params, quantize):
    """A package from either package loads in the other with the same
    bytes, the same digest and the same scores."""
    jdir = jax_lm_package.save_lm_package(
        str(tmp_path / "jax"), JaxLMCfg(**CFG), params, quantize=quantize)
    tdir = save_lm_package(str(tmp_path / "torch"), LMCfg(**CFG), params,
                           quantize=quantize)
    for name in ("params.msgpack", "package.json"):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    toks = _tokens()
    want = jax_lm_package.LMPackagedModel(tdir).score(toks)
    port = LMPackagedModel(jdir, device="cpu")
    assert port.content_digest == jax_lm_package.LMPackagedModel(
        jdir).content_digest
    np.testing.assert_allclose(port.score(toks), want, rtol=1e-5, atol=1e-5)


def test_lora_package_loads_and_scores(tmp_path):
    kw = dict(lora_rank=2, lora_targets=("query", "value"))
    p = _params(seed=1, **kw)
    p["backbone_block0"]["attn"]["query"]["lora_b"] += 0.1
    d = jax_lm_package.save_lm_package(str(tmp_path / "lora"),
                                       JaxLMCfg(**dict(CFG, **kw)), p)
    toks = _tokens(seed=1)
    np.testing.assert_allclose(
        load_lm_package(d, device="cpu").score(toks),
        jax_lm_package.LMPackagedModel(d).score(toks), rtol=1e-5, atol=1e-5)


def test_score_on_a_bucket_padded_width_equals_unpadded(tmp_path, params):
    import torch

    pm = LMPackagedModel(save_lm_package(str(tmp_path / "pkg"),
                                         LMCfg(**CFG), params), device="cpu")
    for seq in (5, 16):  # pad-to-bucket and exact-bucket widths
        toks = _tokens(n=3, seq=seq, seed=seq)
        with torch.inference_mode():
            ref = sequence_nll(pm.model, torch.from_numpy(toks).long())
        np.testing.assert_allclose(pm.score(toks), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        pm.score(_tokens(1, 128))
    with pytest.raises(ValueError, match="token ids outside"):
        pm.score(np.full((1, 5), VOCAB, np.int32))


def test_generate_matches_jax_package(tmp_path, params):
    d = save_lm_package(str(tmp_path / "pkg"), LMCfg(**CFG), params)
    pm = LMPackagedModel(d, device="cpu")
    jpm = jax_lm_package.LMPackagedModel(d)
    for plen in (3, 8):  # padded into the 8-bucket, and exact
        prompt = np.random.RandomState(plen).randint(
            0, VOCAB, (2, plen)).astype(np.int32)
        np.testing.assert_array_equal(pm.generate(prompt, 6),
                                      jpm.generate(prompt, 6))
    with pytest.raises(ValueError, match="exceeds"):
        pm.generate(np.zeros((1, 60), np.int32), 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pm.generate_speculative(pm, np.zeros((1, 4), np.int32), 4)


def test_format_guards(tmp_path, params):
    from ddw_tpu_torch.serving.package import PackagedModel

    d = save_lm_package(str(tmp_path / "pkg"), LMCfg(**CFG), params)
    with pytest.raises(ValueError, match="LMPackagedModel"):
        PackagedModel(d, device="cpu")
    with pytest.raises(ValueError, match="reserved keys"):
        save_lm_package(str(tmp_path / "z"), LMCfg(**CFG), params,
                        extra_meta={"kind": "my-lm"})
    with pytest.raises(ValueError, match="quantize"):
        save_lm_package(str(tmp_path / "x"), LMCfg(**CFG), params,
                        quantize="int4")
    meta = json.load(open(os.path.join(d, "package.json")))
    meta["kind"] = "image"
    json.dump(meta, open(os.path.join(d, "package.json"), "w"))
    with pytest.raises(ValueError, match="not an lm package"):
        LMPackagedModel(d, device="cpu")


def test_token_tables_are_byte_identical(tmp_path):
    toks = _tokens(n=22, seq=16, seed=3)
    t = write_token_table(TableStore(str(tmp_path / "t")), "toks", toks,
                          shard_size=8)
    j = jax_write_token_table(JaxTableStore(str(tmp_path / "j")), "toks",
                              toks, shard_size=8)
    assert t.meta == j.meta == {"encoding": "tokens_i32", "seq_plus_one": 17}
    assert len(t.shard_paths) == len(j.shard_paths) == 3
    for a, b in zip(t.shard_paths, j.shard_paths):
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="num_seqs"):
        write_token_table(TableStore(str(tmp_path / "t")), "bad",
                          np.zeros((3, 1), np.int32))


def test_lm_batch_scorer_matches_jax(tmp_path, params):
    """Both scorers on one table (22 rows: the last batch is padded) give
    the same NLLs, in table order, and write the same scores table."""
    d = save_lm_package(str(tmp_path / "pkg"), LMCfg(**CFG), params)
    store = TableStore(str(tmp_path / "store"))
    toks = _tokens(n=22, seq=16, seed=4)
    tbl = write_token_table(store, "toks", toks, shard_size=8)
    rows = LMBatchScorer(d, device="cpu", batch_per_device=16).score_table(
        tbl, out_store=store)
    jstore = JaxTableStore(str(tmp_path / "store"))
    jrows = JaxLMBatchScorer(d, batch_per_device=2).score_table(
        jstore.table("toks"), out_store=jstore, out_name="jax_scores")
    assert [p for p, _ in rows] == [p for p, _ in jrows] == \
        [r.path for r in tbl.iter_records()]
    np.testing.assert_allclose([v for _, v in rows], [v for _, v in jrows],
                               rtol=1e-5, atol=1e-5)
    out = store.table("lm_scores")
    jout = store.table("jax_scores")
    assert out.num_records == 22
    assert out.meta["metric"] == "mean_next_token_nll"
    assert out.meta["run_id"] == jout.meta["run_id"]
    rec = next(out.iter_records())
    assert float(rec.label) == pytest.approx(
        np.frombuffer(rec.content, np.float32)[0], abs=1e-5)


def test_lm_batch_scorer_refusals(tmp_path, params, monkeypatch):
    d = save_lm_package(str(tmp_path / "pkg"), LMCfg(**CFG), params)
    store = TableStore(str(tmp_path / "store"))
    scorer = LMBatchScorer(d, device="cpu", batch_per_device=4)
    bad = store.write("bad", [Record(path="x", content=b"12")], meta={})
    with pytest.raises(ValueError, match="tokens_i32"):
        scorer.score_table(bad)
    with pytest.raises(ValueError, match="max_len"):
        scorer.score_table(write_token_table(store, "long",
                                             _tokens(n=4, seq=100)))
    oov = _tokens(n=4, seq=16)
    oov[0, 3] = VOCAB + 5
    with pytest.raises(ValueError, match="token ids outside"):
        scorer.score_table(write_token_table(store, "oov", oov))
    monkeypatch.setenv("DDW_PROCESS_ID", "1")
    monkeypatch.setenv("DDW_NUM_PROCESSES", "2")
    tbl = write_token_table(store, "toks", _tokens(n=6), shard_size=2)
    # rank 1 of 2 writes its part; the merge is rank 0's
    assert scorer.score_table(tbl, out_store=store) == \
        scorer.score_table(tbl, out_store=store, merge=False)
    assert not store.exists("lm_scores")
    rows = scorer.score_table(tbl, out_store=store, merge=False)
    assert [p for p, _ in rows] == ["seq/00000002", "seq/00000003"]
    assert store.table("lm_scores_p1").num_records == 2
