"""The leaf layers the model families share, and the init rules over every
leaf type of the zoo.

- :class:`Conv` is flax's ``nn.Conv`` with SAME padding (JAX's split of the
  padding, low side first, on stride 2); :class:`S2DConv` runs the same
  stride-2 parameter through :func:`ddw_tpu_torch.ops.s2d_conv.
  space_to_depth_conv`, and :func:`conv_or_s2d` picks between them;
- :class:`BatchNorm` is flax's BatchNorm in f32 (the fast variance, the
  running statistics updated as ``m*ra + (1-m)*batch``); inside
  :func:`batch_moments_reduced` it normalises over the batch of every rank
  (the sharded-state steps' global batch);
- :class:`GRN` is ConvNeXt V2's global response normalisation;
- :func:`dropout` is ``flax.linen.Dropout`` with an explicit generator;
- :func:`init_params` is the training init with flax's rules, and
  :func:`init_weights` draws random weights with every layer doing
  non-trivial work, for tests and the chip smoke run.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
from torch import nn

from ddw_tpu_torch.models.lm import DenseGeneral, LayerNorm
from ddw_tpu_torch.ops.depthwise_conv import DepthwiseConv3x3, conv2d_same
from ddw_tpu_torch.ops.s2d_conv import space_to_depth_conv

_BN_EPS = 1e-3  # Keras's value, so converted pretrained weights reproduce

# set by batch_moments_reduced: sums a [2C+1] moment vector over the ranks
_moment_reducer: Callable[[torch.Tensor], torch.Tensor] | None = None


@contextlib.contextmanager
def batch_moments_reduced(reduce: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block, :class:`BatchNorm` in training mode takes its
    batch moments over every rank's batch: ``reduce`` (a differentiable sum
    over the ranks, e.g. :func:`ddw_tpu_torch.parallel.comm.
    all_reduce_sum_grad`) sums each layer's per-channel sum, sum of squares
    and row count before the mean and the fast variance are formed, so
    every rank normalises with, and updates its running statistics from,
    the global batch's moments (GSPMD's view of a batch-sharded BatchNorm).
    """
    global _moment_reducer
    prev, _moment_reducer = _moment_reducer, reduce
    try:
        yield
    finally:
        _moment_reducer = prev


class Conv(nn.Module):
    """Convolution with SAME padding (flax ``nn.Conv``); ``weight`` is
    ``[out, in/groups, kh, kw]`` in f32, cast to ``dtype`` for the conv.
    With ``bias`` (off here, on in flax's default) the f32 ``bias`` is cast
    to ``dtype`` and added to the rounded output, as flax adds it."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x.to(self.dtype), self.weight.to(self.dtype),
                        self.stride, self.groups)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class S2DConv(Conv):
    """Drop-in for the stem's stride-2 bias-free :class:`Conv`: the same
    ``weight`` ``[out, in, k, k]`` (so the same checkpoint leaf), run through
    :func:`space_to_depth_conv`."""

    def __init__(self, cin: int, cout: int, kernel: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, kernel, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return space_to_depth_conv(
            x.to(self.dtype), self.weight.to(self.dtype).permute(2, 3, 1, 0))


def conv_or_s2d(cin: int, cout: int, kernel: int, *, stride: int = 1,
                groups: int = 1, dtype: torch.dtype = torch.bfloat16,
                s2d: bool = False) -> Conv:
    """The stem-conv dispatch of the CNN families: a plain SAME
    :class:`Conv` or its space-to-depth form, with the same parameter.
    ``s2d=True`` only expresses a stride-2 ungrouped convolution."""
    if s2d:
        if stride != 2 or groups != 1:
            raise ValueError(
                f"s2d=True expresses exactly a stride-2 ungrouped conv; got "
                f"strides={stride}, groups={groups}")
        return S2DConv(cin, cout, kernel, dtype)
    return Conv(cin, cout, kernel, stride, groups, dtype)


class BatchNorm(nn.Module):
    """flax's BatchNorm in f32 over the last (channel) axis: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``, on the running statistics in eval
    mode and on the batch's in training mode, with flax's fast variance
    ``E[x^2] - E[x]^2`` clipped at 0 (biased); training mode also updates
    the running statistics in place as ``m*ra + (1-m)*batch`` with ``m =
    momentum`` (flax's convention; torch's BatchNorm would use the unbiased
    variance and ``1-m``). Under :func:`batch_moments_reduced` the batch
    moments are the global batch's."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = _BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if _moment_reducer is None:
                mean = x.mean(dim=axes)
                var = ((x * x).mean(dim=axes) - mean * mean).clamp_min(0.0)
            else:
                c = x.shape[-1]
                rows = x.numel() // c
                moments = _moment_reducer(torch.cat([
                    x.sum(dim=axes), (x * x).sum(dim=axes),
                    x.new_full((1,), float(rows))]))
                count = moments[2 * c]
                mean = moments[:c] / count
                var = (moments[c:2 * c] / count - mean * mean).clamp_min(0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


class GRN(nn.Module):
    """Global response normalisation in f32: ``gamma * (x * nx) + beta +
    x`` with ``nx`` the per-channel spatial L2 norm over its cross-channel
    mean; cast back to the input dtype."""

    flax_layout = True

    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        gx = torch.sqrt((xf * xf).sum(dim=(1, 2), keepdim=True) + 1e-6)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (xf * nx) + self.beta + xf).to(x.dtype)


def dropout(h: torch.Tensor, rate: float,
            rng: torch.Generator | None) -> torch.Tensor:
    """``flax.linen.Dropout`` in training: keep each element with
    probability ``1 - rate`` (a uniform draw below it) and rescale by
    ``1 / (1 - rate)``. The uniforms come from ``rng`` (a CPU generator, so
    the mask does not depend on the device)."""
    if rng is None:
        raise ValueError("dropout in training mode needs a dropout_rng "
                         "torch.Generator")
    keep_prob = 1.0 - rate
    u = torch.rand(h.shape, generator=rng).to(h.device)
    return torch.where(u < keep_prob, h / keep_prob, torch.zeros_like(h))


def _fan_in(mod: nn.Module) -> int:
    if isinstance(mod, Conv):
        return math.prod(mod.weight.shape[1:])
    if isinstance(mod, DepthwiseConv3x3):
        return 9
    return mod.weight.shape[1]  # nn.Linear [out, in]


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Training init with flax's rules, in module order from ``generator``:
    conv, dense and ``DenseGeneral`` kernels (and LoRA's ``lora_a``) from
    ``lecun_normal`` (a normal truncated at two standard deviations, scaled
    to variance 1/fan_in, fan_in the product of the contracted dims), biases
    zero, BatchNorm and LayerNorm scale one and bias zero, running mean zero
    and variance one, a ``pos_embed`` normal(0.02); LoRA's ``lora_b``,
    ConvNeXt's GRN parameters and every kernel marked ``zero_init`` (its
    ``project``) zero, as flax's initialisers there are. The numbers differ
    from flax's for the same seed (another generator)."""

    def lecun(w: torch.Tensor, fan_in: int) -> None:
        std = fan_in ** -0.5 / .87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)

    for mod in model.modules():
        if isinstance(mod, (Conv, DepthwiseConv3x3, nn.Linear)):
            lecun(mod.weight, _fan_in(mod))
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
        elif isinstance(mod, DenseGeneral):
            fan_in = math.prod(mod.in_dims)
            if getattr(mod, "zero_init", False):
                mod.kernel.zero_()
            else:
                lecun(mod.kernel, fan_in)
            mod.bias.zero_()
            if hasattr(mod, "lora_a"):
                lecun(mod.lora_a, fan_in)
                mod.lora_b.zero_()
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, GRN):
            mod.gamma.zero_()
            mod.beta.zero_()
        if isinstance(getattr(mod, "pos_embed", None), nn.Parameter):
            mod.pos_embed.copy_(
                torch.randn(mod.pos_embed.shape, generator=generator) * 0.02)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: conv, dense and ``DenseGeneral``
    kernels normal with variance 1/fan_in (flax's LeCun scale), BatchNorm
    scale/bias and running statistics, LayerNorm and GRN parameters, conv
    and ``DenseGeneral`` biases and LoRA factors drawn around their initial
    values (none left at zero), so that every layer does non-trivial work.
    The numbers differ from flax's for the same seed; tests that compare the
    two packages carry weights across instead."""

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=generator) * std + mean

    for mod in model.modules():
        if isinstance(mod, (Conv, DepthwiseConv3x3, nn.Linear)):
            w = mod.weight
            w.copy_(normal(w.shape, _fan_in(mod) ** -0.5))
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
            elif getattr(mod, "bias", None) is not None:
                mod.bias.copy_(normal(mod.bias.shape, 0.1))
        elif isinstance(mod, BatchNorm):
            c = mod.scale.shape
            mod.scale.copy_(normal(c, 0.1, 1.0))
            mod.bias.copy_(normal(c, 0.1))
            mod.mean.copy_(normal(c, 0.1))
            mod.var.copy_(torch.rand(c, generator=generator) + 0.5)
        elif isinstance(mod, DenseGeneral):
            fan_in = math.prod(mod.in_dims)
            mod.kernel.copy_(normal(mod.kernel.shape, fan_in ** -0.5))
            mod.bias.copy_(normal(mod.bias.shape, 0.1))
            if hasattr(mod, "lora_a"):
                mod.lora_a.copy_(normal(mod.lora_a.shape, fan_in ** -0.5))
                mod.lora_b.copy_(normal(mod.lora_b.shape, 0.1))
        elif isinstance(mod, LayerNorm):
            c = mod.scale.shape
            mod.scale.copy_(normal(c, 0.1, 1.0))
            mod.bias.copy_(normal(c, 0.1))
        elif isinstance(mod, GRN):
            mod.gamma.copy_(normal(mod.gamma.shape, 0.1))
            mod.beta.copy_(normal(mod.beta.shape, 0.1))
        if isinstance(getattr(mod, "pos_embed", None), nn.Parameter):
            mod.pos_embed.copy_(normal(mod.pos_embed.shape, 0.02))
