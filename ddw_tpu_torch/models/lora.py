"""LoRA for inference — the port of ``ddw_tpu.models.lora``'s forward pieces.

A targeted projection carries a rank-``r`` update ``dW = A B * alpha / r``
beside its frozen kernel, under the same parameter names and shapes as the
``DenseGeneral`` it replaces (``kernel``, ``bias``, ``lora_a [*in, r]``,
``lora_b [r, *feats]``), so a LoRA-trained LM package loads and scores.
Training (``lora_optimizer``, ``merge_base_params``) comes with LM training
and ``row_lora_delta`` (per-row adapters) with the serving pools
(``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ddw_tpu_torch.models.lm import DenseGeneral

# Projections the LM routes through maybe_lora_dense; anything else in
# lora_targets is a config error.
LM_LORA_TARGETS = ("query", "key", "value", "out", "fc1", "fc2")


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
