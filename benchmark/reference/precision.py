"""Precision of the references' products.

The references compute in float32 with TF32 off. The correctness control
runs them one precision below the configurations' bfloat16: fp8, as a
program that moved its matrix products to fp8 would — each operand of a
product or convolution rounded to e4m3 with a per-tensor scale (its
largest magnitude to 448), and the gradient that reaches a product's output
rounded to e5m2 with a per-tensor scale (to 57344). Where a reference marks
a tensor that the program keeps in bfloat16 between its operations
(``stored``: MobileNetV2's activations), the control keeps it in e4m3, its
gradient in e5m2. Elementwise arithmetic, normalisation and the loss stay
in float32. A bfloat16 reference (operands, outputs, stored tensors and
their gradients rounded to bfloat16) witnesses what the configurations' own
rounding does to a compared number.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (t / scale).to(dtype).to(t.dtype) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _Operand(torch.autograd.Function):
    """fp8: forward e4m3-rounded, the gradient as it comes. bf16: both
    rounded to bfloat16, as a bfloat16 program's casts round them."""

    @staticmethod
    def forward(ctx, t, bf16):
        ctx.bf16 = bf16
        return _bf16(t) if bf16 else _round(t, torch.float8_e4m3fn,
                                             _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return (_bf16(g) if ctx.bf16 else g), None


class _Output(torch.autograd.Function):
    """fp8: forward unchanged, the gradient e5m2-rounded. bf16: both
    rounded to bfloat16, as a product with a bfloat16 output rounds
    them."""

    @staticmethod
    def forward(ctx, t, bf16):
        ctx.bf16 = bf16
        return _bf16(t) if bf16 else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if ctx.bf16:
            return _bf16(g), None
        return _round(g, torch.float8_e5m2, _E5M2_MAX), None


class _Stored(torch.autograd.Function):
    """fp8: forward e4m3-rounded, the gradient e5m2-rounded. bf16: both
    rounded to bfloat16."""

    @staticmethod
    def forward(ctx, t, bf16):
        ctx.bf16 = bf16
        return _bf16(t) if bf16 else _round(t, torch.float8_e4m3fn,
                                             _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        if ctx.bf16:
            return _bf16(g), None
        return _round(g, torch.float8_e5m2, _E5M2_MAX), None


class Precision:
    """``operand`` and ``output`` hooks around every product: the identity
    in float32; fp8 rounding for the control; bfloat16 rounding, the
    configurations' own precision, as a witness of what rounding alone
    does to a number."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        return _Operand.apply(t, self.name == "bf16")

    def output(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32" or not t.requires_grad and \
                self.name == "fp8":
            return t
        return _Output.apply(t, self.name == "bf16")

    def stored(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor the program keeps in its low precision between
        operations."""
        if self.name == "float32":
            return t
        return _Stored.apply(t, self.name == "bf16")


FLOAT32 = Precision("float32")
FP8 = Precision("fp8")
BF16 = Precision("bf16")
