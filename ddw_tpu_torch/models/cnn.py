"""SmallCNN — the port of ``ddw_tpu.models.cnn``: a fast from-scratch CNN
for tests and CPU runs (BASELINE.json's "small CNN, flowers JPEG subset, CPU,
1 epoch"), with MobileNetV2's head contract (GAP -> Dropout -> Dense).

Three bias-free 3x3 convs (widths ``width * (1, 2, 4)``, strides 1, 2, 2,
JAX's SAME split through :func:`~ddw_tpu_torch.ops.depthwise_conv.
conv2d_same`), each followed by GroupNorm(8) and ReLU. Submodules carry
flax's names (``backbone_conv{i}``, ``GroupNorm_{i}``, ``head``), so
:mod:`ddw_tpu_torch.models.convert` maps a flax variables tree onto it leaf
for leaf. Numerics follow the flax module: the input and each conv run in
the compute dtype; GroupNorm runs in f32 with flax's ``epsilon=1e-6`` and
fast variance ``E[x^2] - E[x]^2`` clipped at 0 (``torch.nn.GroupNorm`` uses
1e-5 and the two-pass variance); ReLU's output is cast back to the compute
dtype; GAP and the head run in f32. The convs are library convolutions, as
they are XLA convolutions in ``ddw_tpu``: no kernel of this model is a
Pallas kernel there.
"""

from __future__ import annotations

import torch
from torch import nn

from ddw_tpu_torch.models.mobilenet_v2 import Conv, dropout

_GN_EPS = 1e-6  # flax.linen.GroupNorm's default


class GroupNorm(nn.Module):
    """flax's GroupNorm over NHWC in f32: statistics per (image, group) over
    H, W and the group's channels, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``."""

    def __init__(self, features: int, num_groups: int = 8):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{features} channels")
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        b, c = x.shape[0], x.shape[-1]
        g = x.reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g * g).mean(dim=(1, 3), keepdim=True)
               - mean * mean).clamp_min(0.0)
        mean = mean.repeat_interleave(c // self.num_groups, dim=2)
        var = var.repeat_interleave(c // self.num_groups, dim=2)
        mean = mean.reshape(b, 1, 1, c)
        var = var.reshape(b, 1, 1, c)
        mul = torch.rsqrt(var + _GN_EPS) * self.scale
        return (x - mean) * mul + self.bias


class SmallCNN(nn.Module):
    """``forward`` takes NHWC images and returns f32 logits. Dropout is the
    identity in eval mode; in training mode it needs ``dropout_rng``.
    ``freeze_base`` is accepted for the registry's sake: there is no
    pretrained base to freeze."""

    def __init__(self, num_classes: int = 5, width: int = 32,
                 dropout: float = 0.5, freeze_base: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.freeze_base = freeze_base
        cin = 3
        for i, mult in enumerate((1, 2, 4)):
            cout = width * mult
            self.add_module(f"backbone_conv{i}",
                            Conv(cin, cout, 3, 2 if i else 1, dtype=dtype))
            self.add_module(f"GroupNorm_{i}", GroupNorm(cout))
            cin = cout
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(3):
            x = getattr(self, f"backbone_conv{i}")(x)
            x = getattr(self, f"GroupNorm_{i}")(x)
            x = torch.relu(x).to(self.dtype)
        h = x.float().mean(dim=(1, 2))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, dropout_rng)
        return self.head(h)

    @staticmethod
    def frozen_prefixes(freeze_base: bool) -> tuple[str, ...]:
        return ()
