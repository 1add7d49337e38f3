"""Carry weights between ``ddw_tpu``'s flax variables and the port's modules.

A flax variables tree ``{"params": ..., "batch_stats": ...}`` of numpy arrays
(what ``ddw_tpu`` packages hold) maps onto a module whose submodules carry
flax's names, leaf by leaf:

- conv ``kernel`` ``[kh, kw, in, out]`` -> ``weight`` ``[out, in, kh, kw]``;
- depthwise ``kernel`` ``[3, 3, 1, C]`` -> the kernel's ``weight`` ``[3, 3, C]``;
- Dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``, ``bias`` as is;
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats).

:func:`to_flax_variables` is the exact inverse.
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
