"""The whole run with the timed path broken underneath: ``correct`` comes
out false for each fault a cell can have, and true without one; and K2
returning twice the depthwise weight gradient, which only the depthwise
leaves' own number sees. CPU size;
the harness's look for a card is skipped. The image cells run in float32
here: at this size BatchNorm over a few pixels turns bfloat16's rounding
into gaps as large as the faults'."""

import time

import pytest
import torch

from benchmark.calibrate import k2_double
from benchmark.lib.harness import run_cell
from benchmark.lib.manifest import Bench
import tiny

TRAIN_CELLS = ("mnv2_finetune_b256", "mnv2_transfer_b256", "sc2_train_s4096")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("root")), tiny.LIMITS,
                          {"tiny_mnv2": {"dtype": "float32"}})


def unchanged(drv, x, y):
    """The step runs and reports its loss, but hands its state back as it
    found it."""
    params = {n: p.detach().clone()
              for n, p in drv.state.model.named_parameters()}
    opt = {k: ({n: t.clone() for n, t in v.items()}
               if isinstance(v, dict) else v.clone())
           for k, v in drv.state.opt_state.items()}
    out = drv.step(drv.state, x, y, drv.seed)
    with torch.no_grad():
        for n, p in drv.state.model.named_parameters():
            p.copy_(params[n])
    drv.state.opt_state = opt
    drv.state.step -= 1
    return out


def half_batch(drv, x, y):
    """Half of the batch left out: the mean is taken over the rest."""
    b = x.shape[0] // 2
    return drv.step(drv.state, x[:b], y[:b], drv.seed)


def altered_token(drv):
    """Every decode tick's first token of each row is off by one."""
    pool = drv.engine.pool
    decode, vocab = pool.decode, drv.cfg["vocab_size"]

    def broken(*a, **k):
        toks = decode(*a, **k)
        toks[:, 0] = (toks[:, 0] + 1) % vocab
        return toks

    pool.decode = broken


def _run(root, cell, hooks=None):
    return run_cell(root, cell, 2**31 + 77, 0.3, False, "cpu",
                    time.perf_counter(), hooks=hooks)


@pytest.mark.parametrize("cell", sorted(tiny.LIMITS))
def test_sound_run_is_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_training_fault_is_caught(root, cell, fault):
    r = _run(root, cell, {"step": fault})
    assert not r["correct"], r["checks"]


def test_altered_token_is_caught(root):
    r = _run(root, "sc2_serve_chat", {"engine": altered_token})
    assert not r["correct"], r["checks"]


def test_doubled_k2_is_caught_by_the_depthwise_leaves(root, monkeypatch):
    k2_double(monkeypatch.setattr)
    r = _run(root, "mnv2_finetune_b256")
    checks = {k: v["value"] <= v["limit"] for k, v in r["checks"].items()}
    assert checks == {"grad_gap_median": True, "grad_gap_dw": False,
                      "change_gap": True, "rows_unmatched": True}, r["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.LIMITS))
def test_traced_run_reports_the_host_and_counter_metrics(root, cell):
    # long enough that requests complete outside the traced stretch too
    r = run_cell(root, cell, 2**31 + 78, 2.0, True, "cpu",
                 time.perf_counter())
    # the CPU trace has none of the card's kernels: no roofline share
    want = {m["name"] for m in Bench(root).metrics_of(cell, "per_layer")
            if m["source"] in ("host_clock", "program_counter")}
    assert want and want <= set(r["metrics"]), r["metrics"]
    assert r["correct"], r["checks"]
