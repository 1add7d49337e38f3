"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root names the cells, configurations and metrics;
everything that belongs to one of them sits in a file of its own under the
benchmark's directory:

- ``configs/<config>.json``: the configuration as it is run (the path is the
  manifest's ``file``);
- ``families/<family>.py``: what the drivers need of a model family that a
  configuration's ``family`` key names: the port's model built from the
  configuration, its leaves and the rule of their seeded weights, its
  plain reference, its FLOPs and its hand kernels' least times;
- ``traffic/<mix>.json``: a traffic mix, read by the driver its ``kind``
  names;
- ``limits/<workload>.json``: the limit of each number the cell's
  correctness check compares, with the readings it was set from;
- ``metrics/<metric>.py``: the reader of a per-layer metric, a ``read(run)``
  function that returns a number or None;
- ``kernels/<op>.json``: the kernel-name patterns that count toward one
  operation's roofline.

A new cell, mix, configuration, model family or metric is new files and a
new manifest entry; no code here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "optax", "ddw_tpu"})


def forbidden_loaded(modules) -> list[str]:
    """Names in ``modules`` whose top-level name (before the first dot),
    compared whole, is a forbidden one: ``ddw_tpu_torch`` is not
    ``ddw_tpu``."""
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


class Bench:
    """``BENCHMARK.json`` under ``root`` and the data files beside it, in
    ``root/<data_dir>``."""

    def __init__(self, root: str, data_dir: str = "benchmark"):
        self.root = root
        self.data = os.path.join(root, data_dir)
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)

    def _json(self, *parts: str) -> dict:
        with open(os.path.join(self.data, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", f"{workload}.json")

    def kernel_op(self, op: str) -> dict:
        return self._json("kernels", f"{op}.json")

    def metrics_of(self, workload: str, group: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports:
        those that list it under ``workloads``, and those without the
        key."""
        return [m for m in self.manifest[group]
                if workload in m.get("workloads", [workload])]

    def _module(self, sub: str, name: str):
        path = os.path.join(self.data, sub, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"_bench_{sub}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def family(self, name: str):
        """The module ``families/<name>.py``."""
        return self._module("families", name)

    def problems(self) -> list[str]:
        """Breaches of the manifest's naming and cross-reference rules."""
        out = []
        m = self.manifest
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            names = [e["name"] for e in m[group]]
            if len(names) != len(set(names)):
                out.append(f"duplicate names in {group}")
            out += [f"{group}: bad name {n!r}" for n in names
                    if not NAME_RE.match(n)]
        configs = {c["name"] for c in m["configs"]}
        cells = {w["name"] for w in m["workloads"]}
        for w in m["workloads"]:
            if w["config"] not in configs:
                out.append(f"{w['name']}: unknown config {w['config']!r}")
            if not NAME_RE.match(w["traffic"]):
                out.append(f"{w['name']}: bad traffic name")
            if not os.path.exists(os.path.join(
                    self.data, "traffic", f"{w['traffic']}.json")):
                out.append(f"{w['name']}: no traffic file")
        for group in ("end_to_end", "per_layer"):
            for e in m[group]:
                if not UNIT_RE.match(e["unit"]):
                    out.append(f"{e['name']}: bad unit {e['unit']!r}")
                if e["better"] not in ("lower", "higher"):
                    out.append(f"{e['name']}: bad 'better'")
                for c in e.get("workloads", []):
                    if c not in cells:
                        out.append(f"{e['name']}: unknown cell {c!r}")
        e2e = {e["name"] for e in m["end_to_end"]}
        for e in m["per_layer"]:
            if e["moves"] not in e2e:
                out.append(f"{e['name']}: moves unknown {e['moves']!r}")
            if not os.path.exists(os.path.join(
                    self.data, "metrics", f"{e['name']}.py")):
                out.append(f"{e['name']}: no reader")
        for c in m["configs"]:
            with open(os.path.join(self.root, c["file"])) as f:
                family = json.load(f).get("family", "")
            if not NAME_RE.match(family) or not os.path.exists(os.path.join(
                    self.data, "families", f"{family}.py")):
                out.append(f"{c['name']}: no family module {family!r}")
            for k in c["reduced"]:
                if not NAME_RE.match(k):
                    out.append(f"{c['name']}: bad reduced key {k!r}")
        return out
