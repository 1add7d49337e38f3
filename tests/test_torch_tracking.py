"""The port's tracking layer on the CPU against ``ddw_tpu.tracking``: a
model registry written by either package is read by the other (versions,
stages, the Production path), ``render_report`` over one runs tree gives the
same HTML in both packages (the clock fixed; the title names each package),
and the text CLI prints the same lines in both."""

import contextlib
import io
import os
import time

import pytest

from ddw_tpu.tracking import __main__ as jcli
from ddw_tpu.tracking import report as jreport
from ddw_tpu.tracking.registry import ModelRegistry as JaxRegistry
from ddw_tpu.tracking.tracker import Tracker as JaxTracker
from ddw_tpu_torch.tracking import ModelRegistry, Tracker
from ddw_tpu_torch.tracking import __main__ as tcli
from ddw_tpu_torch.tracking import report as treport


def _artifact(tmp_path, name, body):
    d = tmp_path / name
    d.mkdir()
    (d / "package.json").write_text(body)
    return str(d)


@pytest.mark.parametrize("writer,reader", [(ModelRegistry, JaxRegistry),
                                           (JaxRegistry, ModelRegistry)])
def test_registry_is_read_by_the_other_package(tmp_path, writer, reader):
    root = str(tmp_path / "registry")
    w = writer(root)
    v1 = w.register("flowers", _artifact(tmp_path, "a", "1"), run_id="r1",
                    metrics={"val_accuracy": 0.5})
    v2 = w.register("flowers", _artifact(tmp_path, "b", "2"), run_id="r2")
    w.transition("flowers", v1, "Production")
    w.transition("flowers", v2, "Production")   # archives v1
    r = reader(root)
    assert r.list_models() == ["flowers"]
    assert [m["stage"] for m in r.list_versions("flowers")] == \
        ["Archived", "Production"]
    assert r.get_version("flowers", stage="Production") == v2 == 2
    with open(os.path.join(r.model_path("flowers", "production"),
                           "package.json")) as f:
        assert f.read() == "2"
    r.transition("flowers", v1, "Staging")
    assert w.get_version("flowers", stage="staging") == v1
    with pytest.raises(LookupError):
        r.get_version("flowers", stage="None")
    with pytest.raises(ValueError, match="stage"):
        r.transition("flowers", v1, "Prod")


@pytest.fixture
def runs_root(tmp_path):
    root = str(tmp_path / "runs")
    tr = Tracker(root, "workshop")
    parent = tr.start_run("hyperopt_parallel")
    for i, acc in enumerate((0.4, 0.7)):
        child = tr.start_run("trial", parent_run_id=parent.run_id)
        child.log_params({"dropout": 0.1 * (i + 1), "optimizer": "adam"})
        for epoch in range(3):
            child.log_metrics({"loss": 1.0 / (epoch + 1 + i),
                               "val_accuracy": acc + 0.01 * epoch},
                              step=epoch)
        child.log_metric("final_val_accuracy", acc)
        child.end(status="FAILED" if i == 0 else "FINISHED")
    parent.log_params({"best.dropout": 0.2})
    parent.end()
    return root


def test_report_html_equals_jax_report(runs_root, monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-01-01 00:00:00")
    ours = treport.render_report(runs_root, "workshop")
    theirs = jreport.render_report(runs_root, "workshop")
    assert "ddw_tpu_torch report" in ours
    assert ours.replace("ddw_tpu_torch report", "ddw_tpu report") == theirs
    assert ours.count("<tr class='child'>") == 2 and "<svg" in ours
    out = treport.write_report(runs_root, "workshop",
                               os.path.join(runs_root, "r.html"))
    with open(out) as f:
        assert f.read() == ours


@pytest.mark.parametrize("argv", [["experiments"], ["runs", "-e", "workshop"],
                                  ["runs", "-e", "workshop", "--sort",
                                   "final_val_accuracy"]])
def test_cli_prints_what_the_jax_cli_prints(runs_root, argv):
    outs = []
    for cli in (tcli, jcli):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main([runs_root, *argv])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0]


def test_cli_models_and_search_runs(runs_root, tmp_path):
    reg = ModelRegistry(str(tmp_path / "registry"))
    reg.register("flowers", _artifact(tmp_path, "m", "x"), run_id="r9")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main([reg.root, "models"])
    assert buf.getvalue().startswith("flowers\n    v1  stage=None")
    parent = [r for r in Tracker(runs_root, "workshop").iter_runs()
              if r.meta()["name"] == "hyperopt_parallel"][0]
    best = Tracker(runs_root, "workshop").search_runs(
        parent_run_id=parent.run_id, order_by_metric="final_val_accuracy")
    jbest = JaxTracker(runs_root, "workshop").search_runs(
        parent_run_id=parent.run_id, order_by_metric="final_val_accuracy")
    assert [r.run_id for r in best] == [r.run_id for r in jbest]
    assert best[0].final_metrics()["final_val_accuracy"] == 0.7
