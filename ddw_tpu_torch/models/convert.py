"""Carry weights between ``ddw_tpu``'s flax variables and the port's modules.

A flax variables tree ``{"params": ..., "batch_stats": ...}`` of numpy arrays
(what ``ddw_tpu`` packages hold) maps onto a module whose submodules carry
flax's names, leaf by leaf:

- conv ``kernel`` ``[kh, kw, in, out]`` -> ``weight`` ``[out, in, kh, kw]``;
- depthwise ``kernel`` ``[3, 3, 1, C]`` -> the kernel's ``weight`` ``[3, 3, C]``;
- Dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``, ``bias`` as is;
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats);
- the LM's modules (``flax_layout = True``: ``DenseGeneral`` and its LoRA
  form, ``LayerNorm``, ``Embed``, and ``TransformerLM``'s own ``pos_embed``)
  hold their parameters in flax's layout and names, leaf for leaf.

:func:`to_flax_variables` is the exact inverse. :func:`init_lm_weights` draws
an LM's weights with flax's initialisers from a ``torch.Generator`` (the card
has no JAX to initialise with).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ddw_tpu_torch.models.mobilenet_v2 import BatchNorm, Conv
from ddw_tpu_torch.ops.depthwise_conv import DepthwiseConv3x3


def _leaf_map(mod: nn.Module):
    """``[(collection, flax leaf, tensor, to_torch, to_flax)]`` of a module
    that owns flax leaves, else ``[]``."""
    if getattr(mod, "flax_layout", False):
        return [("params", name, p, None, None)
                for name, p in mod.named_parameters(recurse=False)]
    if isinstance(mod, Conv):
        return [("params", "kernel", mod.weight,
                 lambda a: a.transpose(3, 2, 0, 1),
                 lambda a: a.transpose(2, 3, 1, 0))]
    if isinstance(mod, DepthwiseConv3x3):
        return [("params", "kernel", mod.weight,
                 lambda a: a[:, :, 0, :], lambda a: a[:, :, None, :])]
    if isinstance(mod, nn.Linear):
        return [("params", "kernel", mod.weight, np.transpose, np.transpose),
                ("params", "bias", mod.bias, None, None)]
    if isinstance(mod, BatchNorm):
        return [("params", "scale", mod.scale, None, None),
                ("params", "bias", mod.bias, None, None),
                ("batch_stats", "mean", mod.mean, None, None),
                ("batch_stats", "var", mod.var, None, None)]
    return []


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables: dict) -> nn.Module:
    """Copy a flax variables tree into ``module`` in place (f32 on the
    module's device). Every leaf must be used and every module leaf filled:
    a mismatch in names or shapes raises."""
    want = {}
    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        for coll, leaf, tensor, to_torch, _ in _leaf_map(mod):
            want[(coll, *path, leaf)] = (tensor, to_torch)
    have = {k: v for k, v in _flat(variables)}
    missing, extra = sorted(set(want) - set(have)), sorted(set(have) - set(want))
    if missing or extra:
        raise ValueError(f"flax variables do not match the module: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    for key, (tensor, to_torch) in want.items():
        arr = np.asarray(have[key], np.float32)
        if to_torch is not None:
            arr = to_torch(arr)
        if arr.shape != tuple(tensor.shape):
            raise ValueError(f"{'/'.join(key)}: shape {arr.shape} does not "
                             f"fit {tuple(tensor.shape)}")
        tensor.copy_(torch.tensor(arr))
    return module


@torch.no_grad()
def to_flax_variables(module: nn.Module) -> dict:
    """The module's weights as a flax variables tree of f32 numpy arrays."""
    out: dict = {}
    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        for coll, leaf, tensor, _, to_flax in _leaf_map(mod):
            arr = tensor.detach().float().cpu().numpy()
            if to_flax is not None:
                arr = to_flax(arr)
            node = out.setdefault(coll, {})
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.ascontiguousarray(arr)
    return out


@torch.no_grad()
def init_lm_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw a :class:`~ddw_tpu_torch.models.lm.TransformerLM`'s weights with
    flax's default initialisers, in module order from ``generator`` (a CPU
    generator; the draws are not JAX's bits): ``Embed`` normal with std
    ``1/sqrt(hidden)`` (flax's ``variance_scaling(1, fan_in, normal)`` over
    ``[vocab, hidden]``), ``pos_embed`` normal(0.02), every kernel and
    ``lora_a`` lecun-normal (truncated normal, std ``sqrt(1/fan_in) /
    0.8796``, cut at two of those stds, fan_in the product of the contracted
    dims), biases and ``lora_b`` zeros, LayerNorm scales ones."""
    from ddw_tpu_torch.models.lm import DenseGeneral, Embed, LayerNorm

    def lecun(p: torch.Tensor, fan_in: int) -> None:
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        cpu = torch.empty(p.shape)
        nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        p.copy_(cpu)

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for mod in model.modules():
        if isinstance(mod, Embed):
            normal(mod.embedding, mod.embedding.shape[1] ** -0.5)
        elif isinstance(mod, DenseGeneral):
            fan_in = int(np.prod(mod.in_dims))
            lecun(mod.kernel, fan_in)
            mod.bias.zero_()
            if hasattr(mod, "lora_a"):
                lecun(mod.lora_a, fan_in)
                mod.lora_b.zero_()
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        if isinstance(getattr(mod, "pos_embed", None), nn.Parameter):
            normal(mod.pos_embed, 0.02)
    return model
