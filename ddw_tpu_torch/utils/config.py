"""The port's copy of ``ddw_tpu.utils.config.ModelCfg``.

A packaged model's ``package.json`` stores ``dataclasses.asdict(model_cfg)``
as the JAX package writes it, so this dataclass carries every field of the
original with the same names and defaults: a package round-trips between the
two packages in both directions. Fields that belong to families or features
not yet ported are kept for that reason and refused by
:func:`ddw_tpu_torch.models.registry.build_model` when set.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelCfg:
    """Model factory config (the reference's MobileNetV2 transfer model:
    frozen base + GAP -> Dropout(0.5) -> Dense(num_classes) head)."""

    name: str = "mobilenet_v2"          # key into ddw_tpu_torch.models.registry
    num_classes: int = 5
    dropout: float = 0.5
    freeze_base: bool = True            # transfer-learning mode (training only)
    width_mult: float = 1.0
    num_heads: int = 0                  # attention heads (ViT); 0 = default
    hidden: int = 0                     # encoder width (ViT); 0 = default
    pretrained_path: str = ""           # optional converted-weights artifact
    allow_frozen_random: bool = False   # training-side freeze guard opt-in
    bn_momentum: float = 0.9            # BatchNorm running-stat momentum
    dtype: str = "bfloat16"             # compute dtype; params stay f32
    stem_s2d: bool = False              # space-to-depth stem (not yet ported)
    dw_impl: str = "xla"                # depthwise 3x3: "xla" library grouped
                                        # conv, "pallas" the CUDA kernel at
                                        # stride 1, "pallas_interpret" its
                                        # plain PyTorch version (tests)
    lora_rank: int = 0                  # LoRA (ViT/LM families only)
    lora_alpha: float = 16.0
    lora_targets: tuple[str, ...] = ("query", "value")
