"""ViT — the port of ``ddw_tpu.models.vit``: patch embedding, pre-LN encoder
blocks and the zoo's GAP head.

Submodules carry flax's names (``backbone_patch_embed``, ``pos_embed``,
``backbone_block{i}.{LayerNorm_0, attn.{query, key, value, out},
LayerNorm_1, mlp.{fc1, fc2}}``, ``LayerNorm_0``, ``head``) and the attention
projections keep ``nn.MultiHeadDotProductAttention``'s layout (``query``
``[embed, heads, head_dim]``, ``out`` ``[heads, head_dim, embed]``), so
``ddw_tpu``'s variables map onto the module leaf for leaf
(:mod:`ddw_tpu_torch.models.convert`). ``lora_rank > 0`` puts adapters on
the targeted projections through
:func:`ddw_tpu_torch.models.lora.maybe_lora_dense`.

Numerics follow the flax module: the patch conv, the projections and the
MLP in the compute dtype, LayerNorm and the head in f32, ``gelu`` the tanh
approximation, the residual stream in the compute dtype. Attention is
:func:`ddw_tpu_torch.ops.flash_attention.flash_mha`, non-causal: at the
default geometry (224/16 -> 196 tokens, 4 heads of 48) and the usual batches
its score matrix is under the 256 MiB threshold, so it takes the ``xla``
tier as ``ddw_tpu`` does; with the thresholds at 0 (``DDW_ATTN_XLA_PLAIN_MAX``
/ ``DDW_ATTN_XLA_CKPT_MAX``) it pads to 256 and runs K3 forward and K4/K5
backward with ``k_valid`` 196.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddw_tpu_torch.models.lm import LayerNorm
from ddw_tpu_torch.models.lora import maybe_lora_dense, validate_lora_targets
from ddw_tpu_torch.models.layers import Conv, dropout
from ddw_tpu_torch.ops.flash_attention import flash_mha


class FlashMHA(nn.Module):
    """Self-attention over :func:`flash_mha` with flax's
    ``DenseGeneral`` projections."""

    def __init__(self, hidden: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: float = 16.0,
                 lora_targets: tuple[str, ...] = ("query", "value")):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by heads "
                             f"{num_heads}")
        hd = hidden // num_heads
        lora = dict(rank=lora_rank, alpha=lora_alpha, targets=lora_targets,
                    dtype=dtype)
        for name in ("query", "key", "value"):
            self.add_module(name, maybe_lora_dense(
                (hidden,), (num_heads, hd), name, **lora))
        self.out = maybe_lora_dense((num_heads, hd), (hidden,), "out",
                                    **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, S, H, hd]
        out = flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=False)
        return self.out(out.transpose(1, 2))


class MlpBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: float = 16.0,
                 lora_targets: tuple[str, ...] = ("query", "value")):
        super().__init__()
        lora = dict(rank=lora_rank, alpha=lora_alpha, targets=lora_targets,
                    dtype=dtype)
        self.fc1 = maybe_lora_dense((hidden,), (mlp_dim,), "fc1", **lora)
        self.fc2 = maybe_lora_dense((mlp_dim,), (hidden,), "fc2", **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class EncoderBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16, **lora):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden)
        self.attn = FlashMHA(hidden, num_heads, dtype, **lora)
        self.LayerNorm_1 = LayerNorm(hidden)
        self.mlp = MlpBlock(hidden, mlp_dim, dtype, **lora)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.LayerNorm_0(x))
        return x + self.mlp(self.LayerNorm_1(x))


class ViT(nn.Module):
    """NHWC images in, f32 logits out. ``pos_embed`` is sized for
    ``image_size`` (the flax module sizes it from its first input)."""

    flax_layout = True  # its own pos_embed, leaf for leaf

    def __init__(self, num_classes: int = 5, patch: int = 16,
                 hidden: int = 192, depth: int = 6, num_heads: int = 4,
                 mlp_dim: int = 768, dropout: float = 0.1,
                 freeze_base: bool = False,
                 dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0,
                 lora_alpha: float = 16.0,
                 lora_targets: tuple[str, ...] = ("query", "value"),
                 image_size: tuple[int, int] = (224, 224)):
        super().__init__()
        if lora_rank:
            validate_lora_targets(lora_targets)
        self.dtype, self.dropout, self.freeze_base = dtype, dropout, freeze_base
        self.lora_rank = lora_rank
        self.backbone_patch_embed = Conv(3, hidden, patch, patch, dtype=dtype,
                                         bias=True)
        tokens = -(-image_size[0] // patch) * -(-image_size[1] // patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden))
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha,
                    lora_targets=tuple(lora_targets))
        for i in range(depth):
            self.add_module(f"backbone_block{i}", EncoderBlock(
                hidden, num_heads, mlp_dim, dtype, **lora))
        self.LayerNorm_0 = LayerNorm(hidden)
        self.head = nn.Linear(hidden, num_classes)
        self.depth = depth

    def forward(self, x: torch.Tensor,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        x = self.backbone_patch_embed(x.to(self.dtype))
        b, h, w, c = x.shape
        if h * w != self.pos_embed.shape[1]:
            raise ValueError(f"{h * w} patches, but pos_embed holds "
                             f"{self.pos_embed.shape[1]} (image_size)")
        x = x.reshape(b, h * w, c) + self.pos_embed.to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"backbone_block{i}")(x)
        h = self.LayerNorm_0(x).float().mean(dim=1)
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, dropout_rng)
        return self.head(h)

    @staticmethod
    def frozen_prefixes(freeze_base: bool) -> tuple[str, ...]:
        return ()
