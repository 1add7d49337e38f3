"""Name for name: every public top-level name of ``ddw_tpu`` has its place in
``ddw_tpu_torch``.

Scope. The sources are parsed (AST; nothing is imported, so no JAX). For
each ``ddw_tpu/**/*.py`` the port's module of the same path must exist, and
every name the JAX module defines at top level (``def``, ``class`` or an
assignment, also inside a top-level ``if``/``try``/``with``; not starting
with ``_``) must be bound at top level in that port module, by a definition,
an assignment or an import (a re-export counts). A name the JAX module only
imports, for its own use or as a package's re-export, is not held. Where
the port answers a name differently, :data:`EXCEPTIONS` says so, one line
each: the port's counterpart as ``(module, name)``, which must be bound
there, or why there is none. An entry that is no longer needed fails too.
"""

from __future__ import annotations

import ast
import functools
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "ddw_tpu", "ddw_tpu_torch"

# (JAX module, name or None for the whole module) -> the port's
# (module, name), or the reason there is none
EXCEPTIONS = {
    ("ops/s2d_conv", "S2DConv"): ("models/layers", "S2DConv"),
    ("ops/s2d_conv", "conv_or_s2d"): ("models/layers", "conv_or_s2d"),
    ("train/step", "EmaState"): ("train/step", "EmaOptimizer"),
    ("train/step", "batch_sharding"): ("data/loader", "ShardedLoader"),
    ("train/step", "replicated_sharding"): ("data/loader", "ShardedLoader"),
    ("utils/config", "require_tpu_or_exit"): ("utils/config",
                                              "require_gpu_or_exit"),
    ("utils/config", "vit_geometry_env"): "TPU tile-geometry A/B override; "
                                          "widths come from the benchmark's "
                                          "config files",
    ("utils/config", "lm_heads_env"): "TPU tile-geometry A/B override; "
                                      "widths come from the benchmark's "
                                      "config files",
    ("utils/compat", None): "shims over JAX's own API changes; the port "
                            "calls no JAX",
}


def bound_names(source: str) -> dict[str, str]:
    """Top-level names of ``source``: ``{name: "def" | "assign" |
    "import"}``, a definition or assignment winning over an import."""
    out: dict[str, str] = {}

    def walk(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                out[n.name] = "def"
            elif isinstance(n, ast.Assign):
                for t in n.targets:
                    for x in ast.walk(t):
                        if isinstance(x, ast.Name):
                            out[x.id] = "assign"
            elif isinstance(n, (ast.AnnAssign, ast.AugAssign)):
                if isinstance(n.target, ast.Name):
                    out[n.target.id] = "assign"
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                for a in n.names:
                    out.setdefault((a.asname or a.name).split(".")[0],
                                   "import")
            elif isinstance(n, (ast.If, ast.Try, ast.With)):
                walk(n.body)
                for h in getattr(n, "handlers", ()):
                    walk(h.body)
                walk(getattr(n, "orelse", ()))
                walk(getattr(n, "finalbody", ()))

    walk(ast.parse(source).body)
    return out


def public_defined(names: dict[str, str]) -> set[str]:
    return {n for n, how in names.items()
            if how != "import" and not n.startswith("_")}


@functools.lru_cache(maxsize=None)
def _modules(pkg: str) -> dict[str, str]:
    """``{module path without .py: file}`` under ``pkg``."""
    root = os.path.join(REPO, pkg)
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)[:-3].replace(os.sep, "/")] \
                    = path
    return out


@functools.lru_cache(maxsize=None)
def _names(path: str) -> dict[str, str]:
    with open(path, encoding="utf-8") as f:
        return bound_names(f.read())


def test_every_module_has_a_counterpart():
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT_PKG)
    missing = sorted(m for m in jax_mods
                     if m not in port_mods and (m, None) not in EXCEPTIONS)
    assert not missing, f"ddw_tpu modules with no ddw_tpu_torch file: " \
                        f"{missing}"


def test_every_public_name_is_bound():
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT_PKG)
    missing = []
    for mod, path in sorted(jax_mods.items()):
        if (mod, None) in EXCEPTIONS:
            continue
        port = _names(port_mods[mod]) if mod in port_mods else {}
        for name in sorted(public_defined(_names(path))):
            if name not in port and (mod, name) not in EXCEPTIONS:
                missing.append(f"{mod}.{name}")
    assert not missing, f"public ddw_tpu names unbound in their " \
                        f"ddw_tpu_torch module: {missing}"


def test_the_exception_table_is_live():
    """Each entry is still needed, and its counterpart is bound."""
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT_PKG)
    stale = []
    for (mod, name), answer in EXCEPTIONS.items():
        if mod not in jax_mods:
            stale.append(f"{mod}: no such ddw_tpu module")
            continue
        if name is None:
            if mod in port_mods:
                stale.append(f"{mod}: the port has the module")
            continue
        if name not in public_defined(_names(jax_mods[mod])):
            stale.append(f"{mod}.{name}: not a public ddw_tpu name")
        if mod in port_mods and name in _names(port_mods[mod]):
            stale.append(f"{mod}.{name}: the port binds it")
        if isinstance(answer, tuple):
            pmod, pname = answer
            if pmod not in port_mods or \
                    pname not in _names(port_mods[pmod]):
                stale.append(f"{mod}.{name}: counterpart {pmod}.{pname} "
                             f"is not bound")
    assert not stale, stale


def test_the_scan_counts_reexports_not_uses():
    """The port side counts an import as a binding; the JAX side holds only
    what a module defines, also inside a top-level ``try``/``if``."""
    src = ("import os\nfrom a.b import used\nfrom .c import shown as again\n"
           "X: int = 1\nY = Z = 2\n_p = 3\n"
           "try:\n    def f(): pass\nexcept ImportError:\n    g = None\n"
           "if X:\n    class K: pass\n"
           "def outer():\n    inner = 1\n")
    names = bound_names(src)
    assert {"os", "used", "again"} <= set(names)
    assert public_defined(names) == {"X", "Y", "Z", "f", "g", "K", "outer"}
