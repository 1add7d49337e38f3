"""LoRA — the port of ``ddw_tpu.models.lora``: the adapted projection and
its training pieces.

A targeted projection carries a rank-``r`` update ``dW = A B * alpha / r``
beside its frozen kernel, under the same parameter names and shapes as the
``DenseGeneral`` it replaces (``kernel``, ``bias``, ``lora_a [*in, r]``,
``lora_b [r, *feats]``), so a LoRA-trained LM package loads and scores.
Training freezes the base: :func:`lora_mask` marks the adapter leaves (and
the head) trainable, :func:`lora_optimizer` applies it to an optimizer at
leaf granularity, :func:`merge_base_params` grafts a base checkpoint into a
LoRA tree, :func:`count_trainable` counts what trains.
:func:`row_lora_delta` is the per-row delta of heterogeneous-adapter
serving (:class:`ddw_tpu_torch.serve.adapters.AdapterPool`).
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Sequence

import torch
from torch import nn

from ddw_tpu_torch.models.lm import DenseGeneral

# Projections the LM routes through maybe_lora_dense; anything else in
# lora_targets is a config error.
LM_LORA_TARGETS = ("query", "key", "value", "out", "fc1", "fc2")
LORA_PARAM_NAMES = ("lora_a", "lora_b")


class LoRADenseGeneral(DenseGeneral):
    """``DenseGeneral`` plus a rank-``rank`` adapter, in ``dtype``:
    ``y = x.kernel + (x.lora_a).lora_b * (alpha / rank) + bias``."""

    def __init__(self, in_dims: tuple[int, ...], features: tuple[int, ...],
                 rank: int, alpha: float = 16.0,
                 dtype: torch.dtype = torch.bfloat16):
        if rank <= 0:
            raise ValueError(f"rank must be positive, got {rank}")
        super().__init__(in_dims, features, dtype)
        self.rank, self.alpha = rank, alpha
        self.lora_a = nn.Parameter(torch.zeros(*in_dims, rank))
        self.lora_b = nn.Parameter(torch.zeros(rank, *features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        a = self.project(x, self.lora_a)                     # [..., rank]
        delta = torch.tensordot(a, self.lora_b.to(self.dtype), dims=1)
        y = self.project(x, self.kernel) + delta * (self.alpha / self.rank)
        return y + self.bias.to(self.dtype)


def row_lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   contract_ndim: int = 1) -> torch.Tensor:
    """Per-ROW adapter delta for heterogeneous-adapter batched serving
    (S-LoRA, arXiv 2311.03285): each batch row carries its OWN ``(A, B)``
    pair, gathered from an adapter stack by the row's slot index, so one
    decode tick serves many adapters (and the base model) at once.

    ``x`` is ``[B, S, *in_dims]``; ``a`` is ``[B, *in_dims, r]``; ``b`` is
    ``[B, r, *feats]`` with ``alpha / rank`` already folded in (the pool
    pre-scales at load). ``a`` and ``b`` are cast to ``x``'s dtype, as
    ``ddw_tpu``'s does. Returns ``[B, S, *feats]``. A zero ``b`` row (the
    reserved null adapter) contributes exactly ``+0.0``."""
    bsz, s = x.shape[:2]
    n_in = math.prod(x.shape[2:2 + contract_ndim])
    r = a.shape[-1]
    feats = b.shape[2:]
    h = torch.bmm(x.reshape(bsz, s, n_in),
                  a.to(x.dtype).reshape(bsz, n_in, r))
    out = torch.bmm(h, b.to(x.dtype).reshape(bsz, r, -1))
    return out.reshape(bsz, s, *feats)


def validate_lora_targets(targets: Sequence[str],
                          known: Sequence[str] = LM_LORA_TARGETS) -> None:
    """Raise on a target the model does not route through
    :func:`maybe_lora_dense` (a typo would otherwise adapt nothing)."""
    bad = set(targets) - set(known)
    if bad:
        raise ValueError(f"unknown lora_targets {sorted(bad)}; this model "
                         f"can adapt {list(known)}")


def maybe_lora_dense(in_dims: tuple[int, ...], features: tuple[int, ...],
                     name: str, *, rank: int, alpha: float,
                     targets: Sequence[str], dtype) -> DenseGeneral:
    """``LoRADenseGeneral`` when ``name`` is targeted (and ``rank > 0``),
    else the plain ``DenseGeneral``: the same parameter paths either way.
    ``in_dims`` are the contracted trailing input dims."""
    if rank and name in tuple(targets):
        return LoRADenseGeneral(in_dims, features, rank, alpha, dtype)
    return DenseGeneral(in_dims, features, dtype)


def _path(key: str) -> tuple[str, ...]:
    return tuple(key.split("."))


def is_lora_trainable(name: str,
                      extra_trainable: Sequence[str] = ("head",)) -> bool:
    """Whether the leaf at ``name`` (dotted, as ``named_parameters`` gives
    it) trains under LoRA: an adapter leaf anywhere, or any leaf under a
    top-level key in ``extra_trainable``."""
    path = _path(name)
    return (any(p in LORA_PARAM_NAMES for p in path)
            or path[0] in tuple(extra_trainable))


def lora_mask(params, extra_trainable: Sequence[str] = ("head",)):
    """Bool tree over ``params`` (a nested flax-layout dict, or a flat dict
    of dotted names): True where the optimizer should update: adapter
    leaves (``lora_a``/``lora_b``) anywhere, plus every leaf under a
    top-level key in ``extra_trainable``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + _path(k)) for k, v in node.items()}
        return is_lora_trainable(".".join(path), extra_trainable)
    return walk(params, ())


def lora_optimizer(tx, extra_trainable: Sequence[str] = ("head",)):
    """A copy of the port's optimizer ``tx`` that updates only adapter
    (and ``extra_trainable``) leaves: optax ``multi_transform`` with
    ``set_to_zero`` on the rest, at leaf granularity. Frozen leaves get no
    update, no optimizer state and no share of the clipping norm."""
    out = copy.copy(tx)
    out.trainable_mask = functools.partial(
        is_lora_trainable, extra_trainable=tuple(extra_trainable))
    return out


def merge_base_params(lora_params, base_params, _path_str: str = ""):
    """Graft a base (non-LoRA) checkpoint into a LoRA parameter tree (nested
    dicts): every base leaf replaces its counterpart; adapter leaves keep
    their init. Raises on a base key missing from the LoRA tree or a shape
    mismatch: a silent partial graft would fine-tune from garbage."""
    if not isinstance(base_params, dict):
        if (getattr(lora_params, "shape", None) is not None
                and tuple(lora_params.shape) != tuple(base_params.shape)):
            raise ValueError(f"shape mismatch at {_path_str!r}: "
                             f"{tuple(lora_params.shape)} vs "
                             f"{tuple(base_params.shape)}")
        return base_params
    if not isinstance(lora_params, dict):
        raise ValueError(f"base has subtree at {_path_str!r}, LoRA tree has "
                         f"leaf")
    out = dict(lora_params)
    for k, v in base_params.items():
        if k not in lora_params:
            raise ValueError(f"base key {_path_str + '/' + k!r} absent from "
                             f"the LoRA param tree")
        out[k] = merge_base_params(lora_params[k], v, _path_str + "/" + k)
    return out


def count_trainable(params, extra_trainable: Sequence[str] = ("head",)
                    ) -> tuple[int, int]:
    """``(trainable, total)`` parameter counts under the LoRA mask."""
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, path + _path(k))
        else:
            yield (math.prod(tuple(node.shape)),
                   is_lora_trainable(".".join(path), extra_trainable))
    sizes = list(walk(params, ()))
    return sum(n for n, m in sizes if m), sum(n for n, _ in sizes)
