"""Search-space primitives — the hyperopt ``hp.*`` role.

The reference's spaces (SURVEY.md §6):
``{'optimizer': hp.choice(['Adadelta','Adam']), 'learning_rate':
hp.loguniform(-5, 0), 'dropout': hp.uniform(0.1, 0.9)}``
(``Part 2 - Distributed Tuning & Inference/01_hyperopt_single_machine_model.py:
194-198``) and ``batch_size: hp.choice([32, 64, 128])``
(``02_hyperopt_distributed_model.py:322-326``).

Each primitive describes one dimension; internally every dimension maps to a
continuous *unit space* where the TPE Parzen estimators operate:
uniform -> affine, loguniform -> log-space, quniform -> rounded affine,
choice -> categorical (handled discretely).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dim:
    """One search dimension. ``kind`` in {uniform, loguniform, quniform, choice}."""

    label: str
    kind: str
    low: float = 0.0
    high: float = 1.0
    q: float = 1.0
    options: tuple = ()

    # -- transformed (internal) space: continuous dims become unbounded-ish reals --
    def to_internal(self, value: Any) -> float:
        if self.kind == "choice":
            return float(self.options.index(value))
        if self.kind == "loguniform":
            return math.log(value)
        return float(value)

    def from_internal(self, x: float) -> Any:
        if self.kind == "choice":
            return self.options[int(np.clip(round(x), 0, len(self.options) - 1))]
        if self.kind == "loguniform":
            x = math.exp(x)
        if self.kind == "quniform":
            x = round(x / self.q) * self.q
        return float(np.clip(x, *self.bounds_natural()))

    def bounds_natural(self) -> tuple[float, float]:
        if self.kind == "loguniform":
            return (math.exp(self.low), math.exp(self.high))
        if self.kind == "choice":
            return (0, len(self.options) - 1)
        return (self.low, self.high)

    def bounds_internal(self) -> tuple[float, float]:
        """Bounds in the internal space (log-space for loguniform)."""
        if self.kind == "choice":
            return (0.0, float(len(self.options) - 1))
        return (self.low, self.high)

    def sample(self, rng: np.random.RandomState) -> Any:
        if self.kind == "choice":
            return self.options[rng.randint(len(self.options))]
        x = rng.uniform(self.low, self.high)
        if self.kind == "loguniform":
            return math.exp(x)
        if self.kind == "quniform":
            return round(x / self.q) * self.q
        return x


def uniform(label: str, low: float, high: float) -> Dim:
    return Dim(label, "uniform", low=low, high=high)


def loguniform(label: str, low: float, high: float) -> Dim:
    """Bounds are in log space, hyperopt-style: value in [e^low, e^high]."""
    return Dim(label, "loguniform", low=low, high=high)


def quniform(label: str, low: float, high: float, q: float) -> Dim:
    return Dim(label, "quniform", low=low, high=high, q=q)


def choice(label: str, options: Sequence[Any]) -> Dim:
    return Dim(label, "choice", options=tuple(options))


@dataclasses.dataclass(frozen=True)
class ChoiceOf:
    """Conditional (tree-structured) dimension — hyperopt's ``hp.choice`` over
    *sub-spaces* rather than scalar options (the idiom behind the reference's
    optimizer choice, ``Part 2 - Distributed Tuning & Inference/
    01_hyperopt_single_machine_model.py:194-198``, generalized: each optimizer
    can carry its own LR range). Drawing the branch value activates that
    branch's own dims; dims of unselected branches are *absent* from the
    trial's params — which is exactly how the TPE estimators condition on the
    branch (a sub-dim's history only contains trials that took its branch).

    Sub-dim names must be unique across branches (enforced by
    :func:`choice_of`): presence of the name in a trial's params then implies
    which branch that trial took, so no extra bookkeeping is needed.
    """

    label: str
    branches: tuple  # ((value, ((name, Dim), ...)), ...)

    def branch_dim(self) -> Dim:
        """The categorical over branch values."""
        return Dim(self.label, "choice",
                   options=tuple(v for v, _ in self.branches))

    def subspace(self, value) -> dict[str, Dim]:
        for v, sub in self.branches:
            if v == value:
                return dict(sub)
        raise KeyError(f"{self.label}: unknown branch {value!r}")

    def sample(self, rng: np.random.RandomState) -> dict[str, Any]:
        v = self.branch_dim().sample(rng)
        out = {self.label: v}
        for name, dim in self.subspace(v).items():
            out[name] = dim.sample(rng)
        return out


def choice_of(label: str, branches: dict[Any, dict[str, Dim] | None]) -> ChoiceOf:
    """``hp.choice`` over sub-spaces: ``choice_of('optimizer', {'adam':
    {'adam_lr': loguniform(...)}, 'sgd': {'sgd_lr': ..., 'momentum': ...}})``.
    A branch with no extra dims may map to ``None``/``{}``."""
    if not branches:
        raise ValueError(f"{label}: at least one branch required")
    seen = {label}
    norm = []
    for value, sub in branches.items():
        sub = dict(sub or {})
        for name in sub:
            if name in seen:
                raise ValueError(
                    f"{label}: sub-dimension {name!r} appears in more than one "
                    f"branch (or collides with the branch label) — conditional "
                    f"dims must have branch-unique names")
            seen.add(name)
        norm.append((value, tuple(sub.items())))
    return ChoiceOf(label, tuple(norm))


def validate_space(space: dict[str, Any]) -> None:
    """Reject dimension-name collisions across the WHOLE space — including a
    ``ChoiceOf`` sub-dim shadowing a top-level dim, which ``choice_of`` alone
    cannot see. A collision would silently clobber params in a draw and merge
    unrelated TPE histories (different bounds!) under one name."""
    seen: set[str] = set()
    for name, dim in space.items():
        names = [name]
        if isinstance(dim, ChoiceOf):
            names += [sub_name for _, sub in dim.branches for sub_name, _ in sub]
        for n in names:
            if n in seen:
                raise ValueError(
                    f"search space: dimension name {n!r} appears more than "
                    f"once — every dim (conditional sub-dims included) needs "
                    f"a space-unique name")
            seen.add(n)


def sample_space(space: dict[str, Any], rng: np.random.RandomState) -> dict[str, Any]:
    """One random draw from every dimension (startup / random-search mode).
    ``ChoiceOf`` dims contribute their branch value plus the selected branch's
    sub-dims only."""
    out: dict[str, Any] = {}
    for name, dim in space.items():
        if isinstance(dim, ChoiceOf):
            out.update(dim.sample(rng))
        else:
            out[name] = dim.sample(rng)
    return out
