"""MobileNetV2 — the port of ``ddw_tpu.models.mobilenet_v2``.

The same architecture (Sandler et al. 2018: inverted residuals, linear
bottlenecks, ReLU6, widths rounded to multiples of 8) with the transfer head
GAP -> Dropout -> Dense, in eval and training mode (``module.train()``).
Activations are NHWC at every public
function, as in ``ddw_tpu``. Submodules carry flax's names
(``backbone.InvertedResidual_3.ConvBN_1.BatchNorm_0``, ``head``...), so
:mod:`ddw_tpu_torch.models.convert` maps a flax variables tree onto the module
mechanically.

Numerics follow the flax module step for step:

- the input is cast to the compute dtype; conv weights (depthwise taps
  included) are cast to it before each conv (flax ``promote_dtype``);
- BatchNorm runs in f32 with ``epsilon=1e-3``: on the running ``mean``/``var``
  in eval mode; in training mode on the batch statistics over ``(B, H, W)``
  with flax's fast variance ``E[x^2] - E[x]^2`` clipped at 0 (biased), and
  the running statistics updated in place as ``m*ra + (1-m)*batch`` with
  ``m = bn_momentum`` (flax's convention; torch's BatchNorm would use the
  unbiased variance and ``1-m``);
- head dropout draws its mask from an explicit ``torch.Generator``
  (``flax.linen.Dropout``'s keep-and-rescale); with ``freeze_base`` the
  backbone runs in eval mode and its features are detached, as
  ``stop_gradient`` does in ``ddw_tpu``;
- ReLU6 output is cast back to the compute dtype; the linear-bottleneck
  output stays f32, so the residual add is f32;
- GAP and the head run in f32;
- stride-2 convs pad with JAX's SAME split (``(0, 1)`` on even inputs).

Stride-1 depthwise layers go through :func:`ddw_tpu_torch.ops.depthwise_conv.
depthwise_conv3x3` when ``dw_impl`` is "pallas" (the CUDA kernel on the card,
the plain version on the CPU) or "pallas_interpret" (the plain version); 1x1
convs, the stem and stride-2 depthwise layers are library convs, as they are
XLA convs in ``ddw_tpu``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ddw_tpu_torch.ops.depthwise_conv import DepthwiseConv3x3, conv2d_same

# (expansion t, out channels c, repeats n, stride s) — Sandler et al. Table 2.
_INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
_DW_IMPLS = ("xla", "pallas", "pallas_interpret")
_BN_EPS = 1e-3  # Keras's value, so converted pretrained weights reproduce


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class Conv(nn.Module):
    """Bias-free convolution with SAME padding; ``weight`` is
    ``[out, in/groups, kh, kw]`` in f32, cast to ``dtype`` for the conv."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x.to(self.dtype), self.weight.to(self.dtype),
                           self.stride, self.groups)


class BatchNorm(nn.Module):
    """flax's BatchNorm in f32 over the last (channel) axis: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``, on the running statistics in eval
    mode and on the batch's in training mode (which also updates the running
    statistics in place, see the module docstring)."""

    def __init__(self, features: int, momentum: float = 0.9):
        super().__init__()
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = ((x * x).mean(dim=axes) - mean * mean).clamp_min(0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + _BN_EPS) * self.scale
        return (x - mean) * mul + self.bias


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla",
                 bn_momentum: float = 0.9):
        super().__init__()
        if dw_impl not in _DW_IMPLS:
            raise ValueError(f"unknown dw_impl {dw_impl!r}")
        self.act, self.dtype = act, dtype
        if groups > 1 and groups == cin and kernel == 3:
            self.Conv_0 = DepthwiseConv3x3(
                cout, stride, dtype,
                impl="xla" if dw_impl == "xla" else "auto",
                interpret=dw_impl == "pallas_interpret")
        else:
            self.Conv_0 = Conv(cin, cout, kernel, stride, groups, dtype)
        self.BatchNorm_0 = BatchNorm(cout, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        if self.act:
            x = x.clamp(0.0, 6.0).to(self.dtype)  # ReLU6
        return x


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla",
                 bn_momentum: float = 0.9):
        super().__init__()
        hidden = in_ch * expand
        bn = bn_momentum
        layers = []
        if expand != 1:
            layers.append(ConvBN(in_ch, hidden, 1, dtype=dtype, bn_momentum=bn))
        layers.append(ConvBN(hidden, hidden, 3, stride, groups=hidden,
                             dtype=dtype, dw_impl=dw_impl, bn_momentum=bn))
        layers.append(ConvBN(hidden, out_ch, 1, act=False, dtype=dtype,
                             bn_momentum=bn))
        for i, layer in enumerate(layers):  # flax's creation-order names
            self.add_module(f"ConvBN_{i}", layer)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.children():
            h = layer(h)
        return h + x if self.residual else h


class MobileNetV2Backbone(nn.Module):
    def __init__(self, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla",
                 bn_momentum: float = 0.9):
        super().__init__()
        self.dtype = dtype
        bn = bn_momentum
        ch = _make_divisible(32 * width_mult)
        self.ConvBN_0 = ConvBN(3, ch, 3, stride=2, dtype=dtype, bn_momentum=bn)
        i = 0
        for t, c, n, s in _INVERTED_RESIDUAL_CFG:
            out_ch = _make_divisible(c * width_mult)
            for j in range(n):
                self.add_module(f"InvertedResidual_{i}", InvertedResidual(
                    ch, out_ch, s if j == 0 else 1, t, dtype, dw_impl, bn))
                ch, i = out_ch, i + 1
        self.out_features = _make_divisible(1280 * max(1.0, width_mult))
        self.ConvBN_1 = ConvBN(ch, self.out_features, 1, dtype=dtype,
                               bn_momentum=bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.children():
            x = layer(x)
        return x


class MobileNetV2(nn.Module):
    """Backbone + transfer head; ``forward`` takes NHWC images and returns
    f32 logits. Dropout is the identity in eval mode; in training mode it
    needs ``dropout_rng``. ``freeze_base`` is Keras's ``base_model.trainable
    = False``: the backbone's BatchNorm stays in inference mode and no
    gradient reaches the backbone (the trainer also excludes it from
    updates, :meth:`frozen_prefixes`)."""

    def __init__(self, num_classes: int = 5, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, dw_impl: str = "xla",
                 dropout: float = 0.5, freeze_base: bool = True,
                 bn_momentum: float = 0.9):
        super().__init__()
        self.dropout, self.freeze_base = dropout, freeze_base
        self.backbone = MobileNetV2Backbone(width_mult, dtype, dw_impl,
                                            bn_momentum)
        self.head = nn.Linear(self.backbone.out_features, num_classes)

    def train(self, mode: bool = True) -> "MobileNetV2":
        super().train(mode)
        self.backbone.train(mode and not self.freeze_base)
        return self

    def forward(self, x: torch.Tensor,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        feats = self.backbone(x)
        if self.freeze_base:
            feats = feats.detach()
        h = feats.float().mean(dim=(1, 2))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, dropout_rng)
        return self.head(h)

    @staticmethod
    def frozen_prefixes(freeze_base: bool) -> tuple[str, ...]:
        """Top-level parameter names the optimizer must not update in
        transfer mode."""
        return ("backbone",) if freeze_base else ()


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


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Training init with flax's rules: conv and dense kernels from
    ``lecun_normal`` (a normal truncated at two standard deviations, scaled
    to variance 1/fan_in), dense bias zero, BatchNorm scale one, bias zero,
    running mean zero and variance one. The numbers differ from flax's for
    the same seed (another generator)."""
    for mod in model.modules():
        if isinstance(mod, (Conv, DepthwiseConv3x3, nn.Linear)):
            w = mod.weight
            if isinstance(mod, Conv):
                fan_in = math.prod(w.shape[1:])
            elif isinstance(mod, DepthwiseConv3x3):
                fan_in = 9
            else:
                fan_in = w.shape[1]
            std = fan_in ** -0.5 / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: conv and dense kernels normal with
    variance 1/fan_in (flax's LeCun scale), BatchNorm scale/bias and running
    statistics drawn around their identity values so that every layer does
    non-trivial work. The numbers differ from flax's for the same seed; tests
    that compare the two packages carry weights across instead."""
    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=generator) * std + mean

    for mod in model.modules():
        if isinstance(mod, (Conv, DepthwiseConv3x3, nn.Linear)):
            w = mod.weight
            if isinstance(mod, Conv):
                fan_in = math.prod(w.shape[1:])
            elif isinstance(mod, DepthwiseConv3x3):
                fan_in = 9
            else:
                fan_in = w.shape[1]
            w.copy_(normal(w.shape, fan_in ** -0.5))
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            c = mod.scale.shape
            mod.scale.copy_(normal(c, 0.1, 1.0))
            mod.bias.copy_(normal(c, 0.1))
            mod.mean.copy_(normal(c, 0.1))
            mod.var.copy_(torch.rand(c, generator=generator) + 0.5)
