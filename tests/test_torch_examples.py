"""The port's example chain (``examples_torch/``) on the CPU: each script
runs ``--quick --device cpu`` against one shared workdir, in dependency
order, as a user would start it: 01 prep -> 02 single node -> 03 on 2 gloo
ranks -> 10 an FSDP fit on 2 launcher ranks resumed on 1 -> 13 a supervised
2-rank gang restarted after a crash, then failing with forensics -> 06
package and 2-process merged scoring -> 08 pretrain, export,
convert and frozen transfer at one epoch each, and one short 04 run with
2 parallel trials, the only tier-1 representative of the HPO arms; then
the LM examples: 09 LoRA fine-tuning, 11 the LM lifecycle (train, package,
score, generate, speculative), 14 the online serving engine and 15 the
HTTP gateway (two replicas, 429 backpressure, a SIGTERM drain). The other
arms (cached features, the nested space, 05's distributed trials with and
without pruning, int8, the multi-worker prep, 08 at its full length, where
the pretrained backbone must beat the random one) are ``slow``."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_slow = pytest.mark.slow

# (script, extra arguments, fragment its output must hold)
_EXAMPLES = [
    ("01_data_prep.py", [], "silver_train: 180 records"),
    ("02_train_single_node.py", ["train.epochs=1"], "val_accuracy="),
    ("03_train_distributed.py", ["train.epochs=1"], "world=2 global_batch=16"),
    ("10_fsdp_elastic.py", ["train.epochs=2"], "base_step_continued=True"),
    ("13_supervised_gang.py", [], "rank0_traceback_captured=True"),
    ("04_hyperopt_parallel.py",
     ["tune.max_evals=2", "tune.parallelism=2", "train.epochs=1"],
     "registered flowers_classifier v1 -> Production"),
    ("06_packaged_inference.py", ["train.epochs=1"],
     "predictions table of 20 records written"),
    ("08_pretrained_transfer.py", ["--pretrain-epochs", "1", "train.epochs=1"],
     "[score] 20 rows"),
    ("09_lora_finetune.py", [], "base_frozen=True"),
    ("11_lm_lifecycle.py", [], "[speculative] identical tokens"),
    ("14_online_serving.py", [], "engine_matches_sequential=12/12"),
    ("15_http_gateway.py", [], "http_matches_sequential=10/10"),
    pytest.param("08_pretrained_transfer.py", [], "random-frozen 0.",
                 marks=_slow),
    pytest.param("02_train_single_node.py",
                 ["--cache-features", "train.epochs=1"], "val_accuracy=",
                 marks=_slow),
    pytest.param("04_hyperopt_parallel.py",
                 ["--cache-features", "tune.max_evals=2",
                  "tune.parallelism=2", "train.epochs=1"],
                 "trials train heads only", marks=_slow),
    pytest.param("04_hyperopt_parallel.py",
                 ["--nested-space", "tune.max_evals=2", "tune.parallelism=2",
                  "train.epochs=1"], "best params", marks=_slow),
    pytest.param("05_hyperopt_distributed.py",
                 ["tune.max_evals=2", "train.epochs=1"], "best val_accuracy",
                 marks=_slow),
    pytest.param("05_hyperopt_distributed.py",
                 ["tune.max_evals=3", "tune.prune=true",
                  "tune.prune_warmup_epochs=0", "tune.prune_min_trials=1",
                  "train.epochs=2"], "pruned: every rank stopped",
                 marks=_slow),
    pytest.param("06_packaged_inference.py", ["--int8", "train.epochs=1"],
                 "int8 weight-only", marks=_slow),
    pytest.param("01_data_prep.py", ["--etl-procs", "2", "--materialize"],
                 "silver_val_decoded: 20 records", marks=_slow),
]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("workshop_torch"))


def _id(example):
    script, extra, _ = getattr(example, "values", example)
    flags = [a.lstrip("-") for a in extra if a.startswith("--")]
    return "-".join([script.split("_")[0], *flags])


@pytest.mark.parametrize("script,extra,expect", _EXAMPLES,
                         ids=[_id(e) for e in _EXAMPLES])
def test_example_runs(script, extra, expect, workdir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    where = [] if script == "09_lora_finetune.py" else ["--workdir", workdir]
    cmd = [sys.executable, os.path.join(REPO, "examples_torch", script),
           "--quick", *where, "--device", "cpu", *extra]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, (proc.stdout[-1500:], proc.stderr[-2500:])
    assert expect in proc.stdout, proc.stdout[-1500:]
    if script == "04_hyperopt_parallel.py":
        assert proc.stdout.count("trial status=ok") == 2, proc.stdout
    if script == "08_pretrained_transfer.py":
        assert "[convert] torch and keras layout round-trips agree" \
            in proc.stdout, proc.stdout
        if not extra:
            assert "(OK)" in proc.stdout, proc.stdout


def test_examples_run_on_the_card_unless_told_otherwise(workdir, monkeypatch):
    """Without ``--device`` an example resolves the card, and with no card
    it raises instead of training on the CPU."""
    import importlib

    import torch

    sys.path.insert(0, REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex04 = importlib.import_module("examples_torch.04_hyperopt_parallel")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex04.main(["--quick", "--workdir", workdir, "tune.max_evals=1"])
