"""LMTrainer in the PyTorch port (``ddw_tpu_torch.train.lm_trainer``) on the
CPU with a tiny LM: the loss and val history of ``fit`` against
``ddw_tpu``'s LMTrainer from the same initial weights, and the mirrors of
``tests/test_lm_trainer.py``: checkpoint resume, the already-complete
resume, token tables through the sharded loader, the refusals,
keep-best, EMA evaluation and the plateau cut; plus chained dispatch equal
to per-step dispatch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu.utils.config import TrainCfg as JaxTrainCfg
from ddw_tpu_torch.checkpoint.ckpt import CheckpointManager
from ddw_tpu_torch.data.prep import write_token_table
from ddw_tpu_torch.data.store import Record, TableStore
from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.train import lm_step as tlm
from ddw_tpu_torch.train import lm_trainer as tlt
from ddw_tpu_torch.train.step import TrainState, ema_params
from ddw_tpu_torch.utils.config import LMCfg, TrainCfg

VOCAB, SEQ = 64, 32
LM = dict(vocab_size=VOCAB, max_len=64, hidden=32, depth=2, num_heads=2,
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


def _tokens(n=64, seq=SEQ, seed=0):
    """Memorizable corpus: arithmetic sequences mod VOCAB."""
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, VOCAB, size=(n, 1))
    steps = rng.randint(1, 4, size=(n, 1))
    pos = np.arange(seq + 1)[None, :]
    return ((starts + steps * pos) % VOCAB).astype(np.int32)


def _cfgs(**train_kw):
    kw = dict(batch_size=4, epochs=3, warmup_epochs=0, learning_rate=5e-3,
              seed=0)
    kw.update(train_kw)
    return LMCfg(**LM), TrainCfg(**kw)


def _trainer(lm, tr):
    return tlt.LMTrainer(lm, tr, device="cpu")


def test_fit_history_matches_jax(monkeypatch):
    """Both trainers from the same flax weights (the port's init_lm_state
    patched to load ddw_tpu's seed-0 init): per-epoch train loss, val loss
    and LR within 1e-4 relative over three epochs of adam (f32; sums in
    another order), token accuracies within 1e-6 plus one token in 1e3."""
    lm, tr = _cfgs()
    jcfg = JaxTrainCfg(**dataclasses.asdict(tr) | {"num_devices": 1})
    jres = JaxLMTrainer(JaxLMCfg(**LM), jcfg).fit(_tokens())
    params = jax_build_lm(JaxLMCfg(**LM)).init(
        {"params": jax.random.PRNGKey(tr.seed)},
        jnp.zeros((1, 8), jnp.int32), train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)

    def shared_init(model, tx, generator, device=None):
        load_flax_variables(model, {"params": params})
        tx = tlm._maybe_lora_tx(model, tx)
        return TrainState(model, tx.init(dict(model.named_parameters())), 0)

    monkeypatch.setattr(tlt, "init_lm_state", shared_init)
    res = _trainer(lm, tr).fit(_tokens())
    assert res.epochs_run == jres.epochs_run == 3
    for row, jrow in zip(res.history, jres.history):
        assert row["epoch"] == jrow["epoch"]
        for key in ("loss", "val_loss", "lr"):
            assert row[key] == pytest.approx(jrow[key], rel=1e-4), key
        for key in ("accuracy", "val_accuracy"):
            assert row[key] == pytest.approx(jrow[key], abs=1e-3), key
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def test_checkpoint_resume_continues(tmp_path):
    lm, tr = _cfgs(checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every_epochs=1)
    res2 = _trainer(lm, dataclasses.replace(tr, epochs=2)).fit(_tokens())
    res4 = _trainer(lm, dataclasses.replace(tr, epochs=4)).fit(
        _tokens(), resume=True)
    assert res2.epochs_run == 2 and res4.epochs_run == 4
    assert res4.state.step == 2 * res2.state.step
    assert res4.history[0]["epoch"] == 2  # the numbering continues


def test_resume_already_complete_returns_checkpointed_metrics(tmp_path):
    lm, tr = _cfgs(epochs=2, checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every_epochs=1)
    res = _trainer(lm, tr).fit(_tokens())
    assert res.epochs_run == 2
    with pytest.warns(UserWarning, match="already complete"):
        res2 = _trainer(lm, tr).fit(_tokens(), resume=True)
    assert res2.epochs_run == 2 and np.isfinite(res2.val_loss)
    assert res2.val_loss == pytest.approx(res.val_loss, abs=1e-6)
    assert res2.val_accuracy == pytest.approx(res.val_accuracy, abs=1e-6)


def test_fit_tables_learns_and_resumes(tmp_path):
    """Token tables through the sharded loader (device "cpu": batches
    prefetched as tensors), exact epoch-boundary resume: the resumed run's
    epochs equal those of an uninterrupted run bit for bit."""
    store = TableStore(str(tmp_path / "store"))
    toks = _tokens(n=96)
    train_tbl = write_token_table(store, "lm_train", toks[:80])
    val_tbl = write_token_table(store, "lm_val", toks[80:])
    lm, tr = _cfgs(epochs=3, checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every_epochs=1)
    res = _trainer(lm, tr).fit_tables(train_tbl, val_tbl)
    assert res.epochs_run == 3 and np.isfinite(res.val_loss)
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    res5 = _trainer(lm, dataclasses.replace(tr, epochs=5)).fit_tables(
        train_tbl, val_tbl, resume=True)
    assert res5.epochs_run == 5 and res5.history[0]["epoch"] == 3
    assert res5.state.step == 5 * (80 // 4)
    whole = _trainer(lm, dataclasses.replace(
        tr, epochs=5, checkpoint_dir="")).fit_tables(train_tbl, val_tbl)
    for a, b in zip(whole.history[3:], res5.history):
        assert (a["loss"], a["val_loss"]) == (b["loss"], b["val_loss"])


def test_fit_tables_refusals(tmp_path):
    store = TableStore(str(tmp_path / "store"))
    tok_tbl = write_token_table(store, "toks", _tokens(n=32))
    short = write_token_table(store, "short", _tokens(n=32, seq=8))
    lm, tr = _cfgs(batch_size=16)
    bad = store.write("bad", [Record(path="x", content=b"1234")], meta={})
    with pytest.raises(ValueError, match="tokens_i32"):
        _trainer(lm, tr).fit_tables(bad, tok_tbl)
    with pytest.raises(ValueError, match="disagree"):
        _trainer(lm, tr).fit_tables(tok_tbl, short)
    tiny = write_token_table(store, "tiny", _tokens(n=8))
    with pytest.raises(ValueError, match="global batch"):
        _trainer(lm, tr).fit_tables(tiny, tok_tbl)
    with pytest.raises(ValueError, match="global batch"):
        _trainer(lm, tr).fit_tables(tok_tbl, tiny)


def test_keep_best_checkpoint(tmp_path):
    """The <dir>/best slot tracks the minimum val_loss across the fit and
    its resume."""
    lm, tr = _cfgs(epochs=3, checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every_epochs=1, checkpoint_keep_best=True)
    res = _trainer(lm, tr).fit(_tokens())
    best_dir = str(tmp_path / "ck" / "best")
    meta = CheckpointManager(best_dir).read_metadata()
    assert meta["metrics"]["val_loss"] == pytest.approx(
        min(r["val_loss"] for r in res.history), abs=1e-6)
    res4 = _trainer(lm, dataclasses.replace(tr, epochs=4)).fit(
        _tokens(), resume=True)
    all_vals = [r["val_loss"] for r in res.history + res4.history]
    meta2 = CheckpointManager(best_dir).read_metadata()
    assert meta2["metrics"]["val_loss"] == pytest.approx(min(all_vals),
                                                         abs=1e-6)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _trainer(lm, _cfgs(checkpoint_keep_best=True)[1]).fit(_tokens())


def test_ema_evaluates_shadow():
    """Eval reads the Polyak shadow, which lags the live params."""
    lm, tr = _cfgs(epochs=2, ema_decay=0.9)
    res = _trainer(lm, tr).fit(_tokens())
    assert res.epochs_run == 2 and np.isfinite(res.val_loss)
    shadow = ema_params(res.state)
    assert shadow is not None
    diffs = [float((shadow[n] - p.detach()).abs().max())
             for n, p in res.state.model.named_parameters()]
    assert max(diffs) > 0
    plain = _trainer(lm, dataclasses.replace(tr, ema_decay=0.0)).fit(
        _tokens())
    assert plain.history[0]["loss"] == pytest.approx(res.history[0]["loss"],
                                                     abs=1e-6)
    assert plain.val_loss != res.val_loss  # the shadow, not the params


def test_refusals():
    lm, tr = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlt.LMTrainer(lm, tr, device="cpu", seq_devices=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlt.LMTrainer(dataclasses.replace(lm, num_experts=2), tr,
                      device="cpu")
    for kw in (dict(zero=True), dict(fsdp=True), dict(pipeline_stages=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            _cfgs(**kw)
    with pytest.raises(ValueError, match="ema_decay"):
        tlt.LMTrainer(dataclasses.replace(lm, lora_rank=2),
                      dataclasses.replace(tr, ema_decay=0.9), device="cpu")
    with pytest.raises(ValueError, match="num_devices"):
        _trainer(lm, dataclasses.replace(tr, num_devices=4)).fit(_tokens())
    with pytest.raises(ValueError, match=r"seq_len\+1"):
        _trainer(lm, tr).fit(np.zeros((8,), np.int32))


def test_plateau_actually_cuts_lr():
    rng = np.random.RandomState(3)
    noise = rng.randint(0, VOCAB, size=(64, SEQ + 1)).astype(np.int32)
    # lr=1.0 on unlearnable noise: val_loss jumps about, and a
    # patience-1 cut fires on the first epoch that does not improve
    lm, tr = _cfgs(epochs=4, plateau_patience=1, plateau_factor=0.5,
                   learning_rate=1.0)
    res = _trainer(lm, tr).fit(noise)
    lrs = [r["lr"] for r in res.history]
    assert min(lrs) < max(lrs), lrs
    assert lrs[-1] < lrs[0], lrs


def test_chained_dispatch_equals_per_step(tmp_path):
    """steps_per_dispatch=3 (chain plan 3, 3, 1 over 7 steps) gives the
    per-step history bit for bit, through fit and through fit_tables'
    device-stacked super-batches, with dropout on."""
    lm, tr = _cfgs(epochs=2, batch_size=8)
    lm = dataclasses.replace(lm, dropout=0.1)
    store = TableStore(str(tmp_path / "s"))
    toks = _tokens(n=72)
    tables = (write_token_table(store, "tr", toks[:56]),
              write_token_table(store, "va", toks[56:]))
    for run in (lambda t: t.fit(toks), lambda t: t.fit_tables(*tables)):
        a = run(_trainer(lm, tr))
        b = run(_trainer(lm, dataclasses.replace(tr, steps_per_dispatch=3)))
        assert [(r["loss"], r["val_loss"]) for r in a.history] == \
            [(r["loss"], r["val_loss"]) for r in b.history]
        assert a.state.step == b.state.step


def test_trained_checkpoint_packages_and_scores(tmp_path):
    """The trainer's checkpoint weights go through save_lm_package into
    LMPackagedModel, whose mean NLL on the val rows equals the trainer's
    last val_loss (the same f32 forward; within 1e-5)."""
    from ddw_tpu_torch.checkpoint.ckpt import restore_checkpoint
    from ddw_tpu_torch.serving.lm_package import (LMPackagedModel,
                                                  save_lm_package)

    store = TableStore(str(tmp_path / "store"))
    toks = _tokens(n=48)
    train_tbl = write_token_table(store, "tr", toks[:40])
    val_tbl = write_token_table(store, "va", toks[40:])
    lm, tr = _cfgs(epochs=2, checkpoint_dir=str(tmp_path / "ck"))
    res = _trainer(lm, tr).fit_tables(train_tbl, val_tbl)
    tree, _ = restore_checkpoint(tr.checkpoint_dir, {})
    pkg = save_lm_package(str(tmp_path / "pkg"), lm, tree["params"])
    nll = LMPackagedModel(pkg, device="cpu").score(toks[40:])
    assert float(np.mean(nll)) == pytest.approx(res.val_loss, abs=1e-5)
    assert torch.equal(
        res.state.model.head.kernel.detach(),
        torch.from_numpy(np.array(tree["params"]["head"]["kernel"])))
