"""The port's multi-rank dry run (``ddw_tpu_torch.dryrun``), the
counterpart of ``__graft_entry__.dryrun_multichip``: four gloo ranks on the
CPU run one step of every parallelism strategy at ``ddw_tpu``'s dry-run
sizes and print each arm's ``dryrun ... OK`` line, in ``ddw_tpu``'s
order."""

import os

import numpy as np
import pytest

# arm -> a piece of its line that the arm's own check produced
ARMS = {"DP": "global_batch=16", "DP+accum": "microbatches=2",
        "DPxTP": "fc1 sharding=P(None, 'model')",
        "FSDPxTP": "fc1 tiled=P('data', 'model')",
        "SP": "ring-vs-full err=", "DPxSP(LM)": "seq=16",
        "DPxSP(rope+GQA)": "kv_heads=2", "LoRA": "base_frozen=True",
        "ZeRO-1": "opt-state sharded=", "ZeRO-ckpt": "round-trip",
        "FSDP": "(1/4 residency)", "DPxPP": "stage blocks=",
        "DPxPP-interleaved": "bubble=0.200", "EP": "experts=4",
        "hybrid": "(slice-major)"}


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    import contextlib
    import io

    from ddw_tpu_torch.dryrun import dryrun_multichip

    ckpt = tmp_path_factory.mktemp("dryrun_ckpt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = dryrun_multichip(4, "cpu", ckpt_dir=str(ckpt))
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("dryrun ")]
    return lines, out, ckpt


def test_arms_print_in_order(dryrun):
    lines, _, _ = dryrun
    assert [ln.split()[1] for ln in lines] == list(ARMS), lines


@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_ok_line(dryrun, arm):
    lines, _, _ = dryrun
    line = next(ln for ln in lines if ln.split()[1] == arm)
    assert " OK:" in line and ARMS[arm] in line, line
    for tok in line.split():
        if tok.startswith(("loss=", "aux=")):
            assert np.isfinite(float(tok.split("=")[1])), line


def test_zero_checkpoint_kept_across_the_spawn(dryrun):
    """The ZeRO arm's sharded checkpoint holds one shard file per rank,
    the four ranks agree on the state they wrote, and it restores in this
    process (a world of one) to that state."""
    import warnings

    import torch

    from ddw_tpu_torch.checkpoint.sharded import restore_sharded
    from ddw_tpu_torch.models.layers import init_params
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.train.step import init_state, make_optimizer
    from ddw_tpu_torch.utils.config import ModelCfg, TrainCfg

    _, out, ckpt = dryrun
    files = os.listdir(ckpt / "step_0000000001")
    assert {f"proc_{i}.bin" for i in range(4)} <= set(files)
    checks = {(rk["zero_checks"]["params"],
               tuple(sorted(rk["zero_checks"]["mu"].items())))
              for rk in out}
    assert len(checks) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = build_model(ModelCfg(
            name="mobilenet_v2", num_classes=5, dropout=0.5,
            freeze_base=True, allow_frozen_random=True, dtype="float32",
            width_mult=0.35), image_size=(32, 32))
    init_params(model, torch.Generator().manual_seed(1))
    state = init_state(model, make_optimizer(
        TrainCfg(), type(model).frozen_prefixes(True)))
    state, at = restore_sharded(str(ckpt), state)
    want = out[0]["zero_checks"]
    assert at == 1 and state.step == 1
    np.testing.assert_allclose(
        float(sum(p.double().sum() for p in model.parameters())),
        want["params"], rtol=1e-12)
    for n, t in state.opt_state["mu"].items():
        np.testing.assert_allclose(float(t.double().sum()), want["mu"][n],
                                   rtol=1e-12)
