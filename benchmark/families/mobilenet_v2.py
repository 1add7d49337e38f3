"""MobileNetV2 as the benchmark drives it, for configurations whose
``family`` is ``mobilenet_v2``: the port's model built from the
configuration, the leaves and the rule of their seeded weights, the plain
reference's training steps, the model FLOPs of a step and the least times
of the port's hand kernels in it."""

from __future__ import annotations

import math

import torch

from benchmark.lib import flops
from benchmark.reference import mobilenet_v2 as ref


def build(cfg: dict, mix: dict, device) -> torch.nn.Module:
    """The port's MobileNetV2 with the workshop's head, on ``device``."""
    from ddw_tpu_torch.models.registry import build_model
    from ddw_tpu_torch.utils.config import ModelCfg

    port, size = cfg["port"], cfg["image_size"]
    mcfg = ModelCfg(name="mobilenet_v2", num_classes=cfg["num_classes"],
                    dropout=cfg["dropout"],
                    freeze_base=bool(mix.get("freeze_base", False)),
                    allow_frozen_random=True,
                    width_mult=cfg["width_multiplier"],
                    bn_momentum=cfg["batchnorm_momentum"],
                    dtype=cfg["dtype"], dw_impl=port["dw_impl"],
                    stem_s2d=port["stem_s2d"])
    return build_model(mcfg, (size, size)).to(device)


def specs(cfg: dict) -> tuple[list, list]:
    """(parameters, BatchNorm running statistics): names and shapes."""
    return ref.specs(cfg)


def init(name: str, shape: tuple, z: torch.Tensor) -> torch.Tensor:
    """Convolutions normal with variance 1/fan_in; BatchNorm scale about 1,
    shift, running mean about 0 and running variance about 1; the head
    normal with variance 1/fan_in and no bias."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("Conv_0.weight"):
        fan_in = 9 if len(shape) == 3 else math.prod(shape[1:])
        return z * fan_in ** -0.5
    if leaf == "scale":
        return 1.0 + 0.1 * z
    if leaf in ("bias", "mean") and "BatchNorm" in name:
        return 0.1 * z
    if leaf == "var":
        return torch.exp(0.2 * z)
    if name == "head.weight":
        return z * shape[1] ** -0.5
    if name == "head.bias":
        return 0.0 * z
    raise KeyError(f"no init rule for {name}")


def reference(cfg: dict, mix: dict, p0: dict, batches: list, seed: int,
              prec) -> dict:
    """The plain reference's steps over ``batches`` from ``p0``."""
    params, buffers = ref.specs(cfg)
    return ref.train(cfg, {n: p0[n] for n, _ in params},
                     {n: p0[n] for n, _ in buffers}, batches, seed=seed,
                     lr=mix["learning_rate"],
                     freeze_base=bool(mix["freeze_base"]), prec=prec)


def step_flops(cfg: dict, mix: dict) -> float:
    return flops.mnv2_step_flops(cfg, mix["batch"], bool(mix["freeze_base"]))


def op_bounds(cfg: dict, mix: dict) -> dict:
    """Least seconds of K1 (forward, and as the input gradient when the
    backbone trains) and K2 in one step."""
    shapes = flops.dw_stride1_shapes(cfg, mix["batch"])
    k1 = sum(flops.k1_bound_s(*s, 2) for s in shapes)
    if mix["freeze_base"]:
        return {"k1_dw_fwd": k1}
    return {"k1_dw_fwd": 2 * k1,
            "k2_dw_wgrad": sum(flops.k2_bound_s(*s, 2) for s in shapes)}


def leaf_groups(cfg: dict, mix: dict) -> dict:
    """The depthwise taps ``[3, 3, C]``: K2 alone writes their gradient (at
    stride 1), which moves no other leaf's, and Adam's first step does not
    see its scale."""
    if mix["freeze_base"]:
        return {}
    return {"dw": [n for n, s in ref.specs(cfg)[0] if len(s) == 3]}
