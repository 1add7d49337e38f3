"""ConvNeXt (the V2 block) — the port of ``ddw_tpu.models.convnext``:
variants tiny and small, with the zoo's transfer head.

Patchify stem (4x4 stride-4 conv + LayerNorm), per-stage ``LayerNorm + 2x2
stride-2 conv`` downsampling, blocks of 7x7 depthwise -> LayerNorm -> 4x
pointwise expand -> GELU -> GRN -> project -> residual, and a final
per-position LayerNorm inside the backbone. No BatchNorm, so the model has no
batch statistics. Submodules carry flax's names (``backbone.stem``,
``stem_norm``, ``down{s}_norm``, ``down{s}``, ``stage{s}_block{i}.{dwconv,
LayerNorm_0, expand, grn, project}``, ``final_norm``, ``head``).

Numerics follow the flax module: convs and Dense layers in the compute dtype
with their f32 biases cast to it (flax's default ``use_bias``); LayerNorm in
f32 with epsilon 1e-6 and the fast variance; ``gelu`` the tanh
approximation; GRN in f32, cast back. The stem's LayerNorm output is cast to
the compute dtype, so stage 0's residual stream is in it. The 7x7 depthwise
goes through the library's grouped ``F.conv2d``: the repository's depthwise
kernel is 3x3 only, so ``dw_impl`` is refused by the registry. The
``project`` kernel and the GRN parameters start at zero (flax's initialisers
here), so every block is the identity at initialisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddw_tpu_torch.models.layers import Conv, GRN, dropout
from ddw_tpu_torch.models.lm import DenseGeneral, LayerNorm

# variant -> (blocks per stage, channels per stage)
_CONFIGS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
}


class Block(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dwconv = Conv(features, features, 7, groups=features,
                           dtype=dtype, bias=True)
        self.LayerNorm_0 = LayerNorm(features)
        self.expand = DenseGeneral((features,), (4 * features,), dtype)
        self.grn = GRN(4 * features)
        self.project = DenseGeneral((4 * features,), (features,), dtype)
        self.project.zero_init = True   # flax kernel_init=zeros

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(self.dwconv(x))
        h = F.gelu(self.expand(h), approximate="tanh")
        return x + self.project(self.grn(h))


class ConvNeXtBackbone(nn.Module):
    def __init__(self, variant: str = "tiny", width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if variant not in _CONFIGS:
            raise KeyError(f"unknown convnext variant {variant!r} (have "
                           f"{sorted(_CONFIGS)})")
        self.dtype = dtype
        depths, dims = _CONFIGS[variant]
        dims = [max(8, int(d * width_mult)) for d in dims]
        self.stem = Conv(3, dims[0], 4, 4, dtype=dtype, bias=True)
        self.stem_norm = LayerNorm(dims[0])
        for stage, (n_blocks, feats) in enumerate(zip(depths, dims)):
            if stage > 0:
                self.add_module(f"down{stage}_norm", LayerNorm(dims[stage - 1]))
                self.add_module(f"down{stage}", Conv(
                    dims[stage - 1], feats, 2, 2, dtype=dtype, bias=True))
            for i in range(n_blocks):
                self.add_module(f"stage{stage}_block{i}", Block(feats, dtype))
        self.final_norm = LayerNorm(dims[-1])
        self.out_features = dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_norm(self.stem(x)).to(self.dtype)
        for name, layer in self.named_children():
            if name not in ("stem", "stem_norm"):
                x = layer(x)
        return x  # final_norm ran last: f32


class ConvNeXt(nn.Module):
    """Backbone + transfer head; NHWC images in, f32 logits out."""

    def __init__(self, num_classes: int = 5, variant: str = "tiny",
                 width_mult: float = 1.0, dropout: float = 0.5,
                 freeze_base: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.dropout, self.freeze_base = dtype, dropout, freeze_base
        self.variant, self.width_mult = variant, width_mult
        self.backbone = ConvNeXtBackbone(variant, width_mult, dtype)
        self.head = nn.Linear(self.backbone.out_features, num_classes)

    def forward(self, x: torch.Tensor,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        feats = self.backbone(x.to(self.dtype))
        if self.freeze_base:
            feats = feats.detach()
        h = feats.float().mean(dim=(1, 2))
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, dropout_rng)
        return self.head(h)

    @staticmethod
    def frozen_prefixes(freeze_base: bool) -> tuple[str, ...]:
        return ("backbone",) if freeze_base else ()
