"""Carry weights between ``ddw_tpu``'s flax variables and the port's modules,
and convert pretrained weights (torchvision or Keras layouts) into them.

A flax variables tree ``{"params": ..., "batch_stats": ...}`` of numpy arrays
(what ``ddw_tpu`` packages hold) maps onto a module whose submodules carry
flax's names, leaf by leaf:

- conv ``kernel`` ``[kh, kw, in, out]`` -> ``weight`` ``[out, in, kh, kw]``,
  and its ``bias`` as is where the conv has one (ConvNeXt, ViT);
- depthwise ``kernel`` ``[3, 3, 1, C]`` -> the kernel's ``weight`` ``[3, 3, C]``;
- Dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``, ``bias`` as is;
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats);
- GroupNorm ``scale``/``bias`` (params; SmallCNN's);
- modules with ``flax_layout = True`` (``DenseGeneral`` and its LoRA form,
  ``LayerNorm``, ``Embed``, ConvNeXt's ``GRN``, and the own ``pos_embed`` of
  ``TransformerLM`` and ``ViT``) hold their parameters in flax's layout and
  names, leaf for leaf.

:func:`to_flax_variables` is the exact inverse. :func:`init_lm_weights` draws
an LM's weights with flax's initialisers from a ``torch.Generator`` (the card
has no JAX to initialise with).

Pretrained weights (the port of the rest of ``ddw_tpu.models.convert``): a
torchvision ``mobilenet_v2`` or ``resnet18/34/50`` state_dict
(:func:`convert_torch_mobilenet_v2`, :func:`convert_torch_resnet`, the depth
from :func:`infer_torch_resnet_depth`) or Keras-applications MobileNetV2
weights (:func:`convert_keras_mobilenet_v2` over :func:`load_keras_weights`)
become the backbone's flax ``{"params", "batch_stats"}`` trees, numpy
throughout:

- conv kernels: torch ``[out, in, kh, kw]`` -> flax ``[kh, kw, in, out]``
  (the same transpose takes depthwise ``[C, 1, kh, kw]`` to ``[kh, kw, 1,
  C]``); Keras kernels are already flax's, its depthwise ``[kh, kw, C, 1]``;
- MobileNetV2's BatchNorm runs with Keras's epsilon 1e-3 and torchvision's
  with 1e-5: the difference is folded exactly into the scale,
  ``scale' = scale * sqrt((var + eps_ours) / (var + eps_src))`` (ResNet's
  epsilon is torch's, so there the fold is the identity);
- padding: the models use JAX's SAME, which pads a stride-2 3x3 on even
  inputs (0, 1) where torch pads (1, 1) — a one-pixel shift, as between
  Keras and torch.

The artifact is the ``.npz`` of :func:`save_pretrained`, flax-layout keys
``params/backbone/...`` and ``batch_stats/backbone/...``, the same file
``ddw_tpu`` writes and reads; :func:`load_pretrained` merges one over a
model's variables (``ModelCfg.pretrained_path`` in the trainers), and
:func:`load_pretrained_module` over a module's weights.

CLI: ``python -m ddw_tpu_torch.models.convert weights.{pt,h5,npz} out.npz``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ddw_tpu_torch.models.cnn import GroupNorm
from ddw_tpu_torch.models.layers import BatchNorm, Conv
from ddw_tpu_torch.ops.depthwise_conv import DepthwiseConv3x3


def _leaf_map(mod: nn.Module):
    """``[(collection, flax leaf, tensor, to_torch, to_flax)]`` of a module
    that owns flax leaves, else ``[]``."""
    if getattr(mod, "flax_layout", False):
        return [("params", name, p, None, None)
                for name, p in mod.named_parameters(recurse=False)]
    if isinstance(mod, Conv):
        conv = [("params", "kernel", mod.weight,
                 lambda a: a.transpose(3, 2, 0, 1),
                 lambda a: a.transpose(2, 3, 1, 0))]
        if mod.bias is not None:
            conv.append(("params", "bias", mod.bias, None, None))
        return conv
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
    if isinstance(mod, GroupNorm):
        return [("params", "scale", mod.scale, None, None),
                ("params", "bias", mod.bias, None, None)]
    return []


def _leaf_dims(mod: nn.Module, leaf: str, ndim: int) -> tuple:
    """``dims[port_dim] = flax_dim`` of a leaf's two layouts (the
    permutation its ``to_torch`` applies; depthwise drops flax's dim 2)."""
    if isinstance(mod, Conv) and leaf == "kernel":
        return (3, 2, 0, 1)
    if isinstance(mod, DepthwiseConv3x3):
        return (0, 1, 3)
    if isinstance(mod, nn.Linear) and leaf == "kernel":
        return (1, 0)
    return tuple(range(ndim))


def flax_leaf_index(module: nn.Module) -> dict:
    """Every leaf of ``module`` by its torch name (parameters and
    BatchNorm buffers): ``(collection, flax path, dims, to_torch,
    to_flax)``, where ``dims[port_dim]`` is the matching dim of the flax
    layout and ``to_torch`` / ``to_flax`` map a whole leaf or a block of it
    between the layouts (``None``: the same). Sharded training and the sharded
    checkpoint split leaves by ``ddw_tpu``'s rule on the flax shape."""
    out = {}
    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        by_tensor = {id(t): n for n, t in
                     list(mod.named_parameters(recurse=False))
                     + list(mod.named_buffers(recurse=False))}
        for coll, leaf, tensor, to_torch, to_flax in _leaf_map(mod):
            tname = (name + "." if name else "") + by_tensor[id(tensor)]
            out[tname] = (coll, path + (leaf,),
                          _leaf_dims(mod, leaf, tensor.dim()), to_torch,
                          to_flax)
    return out


def flax_shape(shape: tuple, to_flax) -> tuple:
    """The flax-layout shape of a port-layout leaf (or block) of ``shape``
    (``to_flax`` from :func:`flax_leaf_index`)."""
    shape = tuple(shape)
    if to_flax is None:
        return shape
    return tuple(to_flax(np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), shape, (0,) * len(shape))).shape)


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
    from ddw_tpu_torch.models.moe import MoEMlp

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
        elif isinstance(mod, MoEMlp):
            # flax's lecun_normal over [E, in, out]: fan_in = in * E (the
            # expert dim counts as receptive field)
            e = mod.num_experts
            lecun(mod.w1, mod.w1.shape[1] * e)
            lecun(mod.w2, mod.w2.shape[1] * e)
            mod.b1.zero_()
            mod.b2.zero_()
        if isinstance(getattr(mod, "pos_embed", None), nn.Parameter):
            normal(mod.pos_embed, 0.02)
    return model


# -- pretrained weights: torchvision / Keras layouts -> flax variables -------

_EPS_FLAX = 1e-3   # MobileNetV2's BatchNorm epsilon (Keras's convention)
_EPS_TORCH = 1e-5  # torchvision's BatchNorm epsilon
_EPS_RESNET = 1e-5  # the port's ResNet epsilon == torch's: the fold is identity
_EPS_KERAS = 1e-3  # Keras's epsilon == MobileNetV2's: the fold is identity


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x,
                      dtype=np.float32)


def _conv(sd: dict, prefix: str) -> np.ndarray:
    return _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)


def _bn(sd: dict, prefix: str, eps_src: float,
        eps_dst: float = _EPS_FLAX) -> tuple[dict, dict]:
    scale = _np(sd[f"{prefix}.weight"])
    bias = _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = scale * np.sqrt((var + eps_dst) / (var + eps_src))
    return {"scale": scale, "bias": bias}, {"mean": mean, "var": var}


def _convbn(sd: dict, conv_prefix: str, bn_prefix: str, eps_src: float,
            eps_dst: float = _EPS_FLAX):
    bn_params, bn_stats = _bn(sd, bn_prefix, eps_src, eps_dst)
    return ({"Conv_0": {"kernel": _conv(sd, conv_prefix)},
             "BatchNorm_0": bn_params}, {"BatchNorm_0": bn_stats})


def _mobilenet_blocks():
    """``(block index, expansion)`` of MobileNetV2's 17 inverted
    residuals, in order."""
    from ddw_tpu_torch.models.mobilenet_v2 import _INVERTED_RESIDUAL_CFG

    block = 0
    for t, _c, n, _s in _INVERTED_RESIDUAL_CFG:
        for _ in range(n):
            yield block, t
            block += 1


def torch_mobilenet_pairs(block: int, t: int) -> list[tuple[str, str]]:
    """torchvision's ``(conv, bn)`` prefixes of inverted residual
    ``block``: depthwise and projection, after the expansion when ``t`` is
    not 1."""
    f = f"features.{block + 1}"
    if t == 1:
        return [(f"{f}.conv.0.0", f"{f}.conv.0.1"), (f"{f}.conv.1",
                                                     f"{f}.conv.2")]
    return [(f"{f}.conv.0.0", f"{f}.conv.0.1"),
            (f"{f}.conv.1.0", f"{f}.conv.1.1"),
            (f"{f}.conv.2", f"{f}.conv.3")]


def keras_mobilenet_stages(block: int, t: int) -> list[tuple[str, str, bool]]:
    """Keras-applications' ``(conv, bn, depthwise)`` layer names of inverted
    residual ``block``."""
    pfx = "expanded_conv" if block == 0 else f"block_{block}"
    stages = [(f"{pfx}_expand", f"{pfx}_expand_BN", False)] if t != 1 else []
    return stages + [(f"{pfx}_depthwise", f"{pfx}_depthwise_BN", True),
                     (f"{pfx}_project", f"{pfx}_project_BN", False)]


def convert_torch_mobilenet_v2(state_dict: dict, eps_src: float = _EPS_TORCH
                               ) -> dict[str, dict]:
    """torchvision-layout state_dict -> ``{"params", "batch_stats"}`` trees
    of the MobileNetV2 backbone (width 1.0, the only one torchvision ships)."""
    params: dict = {}
    stats: dict = {}
    params["ConvBN_0"], stats["ConvBN_0"] = _convbn(
        state_dict, "features.0.0", "features.0.1", eps_src)
    for block, t in _mobilenet_blocks():
        sub_p: dict = {}
        sub_s: dict = {}
        for i, (cp, bp) in enumerate(torch_mobilenet_pairs(block, t)):
            sub_p[f"ConvBN_{i}"], sub_s[f"ConvBN_{i}"] = _convbn(
                state_dict, cp, bp, eps_src)
        params[f"InvertedResidual_{block}"] = sub_p
        stats[f"InvertedResidual_{block}"] = sub_s
    params["ConvBN_1"], stats["ConvBN_1"] = _convbn(
        state_dict, "features.18.0", "features.18.1", eps_src)
    return {"params": params, "batch_stats": stats}


def convert_torch_resnet(state_dict: dict, depth: int = 50,
                         eps_src: float = _EPS_TORCH) -> dict[str, dict]:
    """torchvision-layout ResNet state_dict -> ``{"params", "batch_stats"}``
    trees of the ResNet backbone (width 1.0): stem ``conv1``/``bn1``, blocks
    ``layer{1..4}.{i}.conv{1..3}`` + ``bn{1..3}`` and an optional
    ``downsample.0/.1`` projection. torchvision's Bottleneck strides its 3x3
    as the port's v1.5 block does, so the mapping is positional. The ``fc``
    head is ignored (transfer re-heads)."""
    from ddw_tpu_torch.models.resnet import _CONFIGS

    if depth not in _CONFIGS:
        raise KeyError(f"unsupported resnet depth {depth} (have "
                       f"{sorted(_CONFIGS)})")
    counts, bottleneck = _CONFIGS[depth]

    def cb(conv_prefix, bn_prefix):
        return _convbn(state_dict, conv_prefix, bn_prefix, eps_src,
                       eps_dst=_EPS_RESNET)

    params: dict = {}
    stats: dict = {}
    params["stem"], stats["stem"] = cb("conv1", "bn1")
    n_convs = 3 if bottleneck else 2
    for stage, n_blocks in enumerate(counts):
        for i in range(n_blocks):
            t = f"layer{stage + 1}.{i}"
            sub_p: dict = {}
            sub_s: dict = {}
            for j in range(n_convs):
                sub_p[f"_ConvBN_{j}"], sub_s[f"_ConvBN_{j}"] = cb(
                    f"{t}.conv{j + 1}", f"{t}.bn{j + 1}")
            if f"{t}.downsample.0.weight" in state_dict:
                sub_p["proj"], sub_s["proj"] = cb(
                    f"{t}.downsample.0", f"{t}.downsample.1")
            params[f"stage{stage}_block{i}"] = sub_p
            stats[f"stage{stage}_block{i}"] = sub_s
    return {"params": params, "batch_stats": stats}


def infer_torch_resnet_depth(state_dict: dict) -> int:
    """A torchvision ResNet's depth from its block counts and block type."""
    from ddw_tpu_torch.models.resnet import _CONFIGS

    counts = tuple(
        len({k.split(".")[1] for k in state_dict
             if k.startswith(f"layer{s}.")}) for s in range(1, 5))
    bottleneck = any(".conv3." in k for k in state_dict)
    for depth, (c, b) in _CONFIGS.items():
        if c == counts and b == bottleneck:
            return depth
    raise ValueError(f"unrecognized resnet layout: blocks {counts}, "
                     f"bottleneck={bottleneck}")


def _keras_convbn(w: dict, conv: str, bn: str, eps_src: float,
                  depthwise: bool):
    if depthwise:
        # Keras depthwise_kernel [kh, kw, C, 1] -> flax [kh, kw, 1, C]
        kernel = _np(w[f"{conv}/depthwise_kernel"]).transpose(0, 1, 3, 2)
    else:
        kernel = _np(w[f"{conv}/kernel"])  # [kh, kw, in, out]: flax's already
    scale = _np(w[f"{bn}/gamma"])
    var = _np(w[f"{bn}/moving_variance"])
    scale = scale * np.sqrt((var + _EPS_FLAX) / (var + eps_src))
    return ({"Conv_0": {"kernel": kernel},
             "BatchNorm_0": {"scale": scale, "bias": _np(w[f"{bn}/beta"])}},
            {"BatchNorm_0": {"mean": _np(w[f"{bn}/moving_mean"]),
                             "var": var}})


def convert_keras_mobilenet_v2(weights: dict, eps_src: float = _EPS_KERAS
                               ) -> dict[str, dict]:
    """Keras-applications weights (``"layer/weight"`` -> array, ``:0``
    suffixes stripped by :func:`load_keras_weights`) -> ``{"params",
    "batch_stats"}`` trees of the MobileNetV2 backbone (width 1.0). Layers:
    stem ``Conv1``/``bn_Conv1``; block 0 ``expanded_conv_{depthwise,
    project}``; blocks 1-16 ``block_N_{expand,depthwise,project}``, each with
    a ``..._BN`` twin; top ``Conv_1``/``Conv_1_bn``."""
    params: dict = {}
    stats: dict = {}
    params["ConvBN_0"], stats["ConvBN_0"] = _keras_convbn(
        weights, "Conv1", "bn_Conv1", eps_src, depthwise=False)
    for block, t in _mobilenet_blocks():
        sub_p: dict = {}
        sub_s: dict = {}
        for i, (conv, bn, dw) in enumerate(keras_mobilenet_stages(block, t)):
            sub_p[f"ConvBN_{i}"], sub_s[f"ConvBN_{i}"] = _keras_convbn(
                weights, conv, bn, eps_src, depthwise=dw)
        params[f"InvertedResidual_{block}"] = sub_p
        stats[f"InvertedResidual_{block}"] = sub_s
    params["ConvBN_1"], stats["ConvBN_1"] = _keras_convbn(
        weights, "Conv_1", "Conv_1_bn", eps_src, depthwise=False)
    return {"params": params, "batch_stats": stats}


def load_keras_weights(path: str) -> dict[str, np.ndarray]:
    """A Keras weights file as a flat ``"layer/weight"`` dict. ``.npz``
    keys pass through; ``.h5`` (``save_weights``' ``layer/layer/weight:0``
    or a full model's ``model_weights/...``) needs ``h5py``. ``:0`` suffixes
    are stripped either way."""
    flat: dict[str, np.ndarray] = {}

    def put(parts: list[str], arr: np.ndarray):
        parts = [p for p in parts if p not in ("model_weights", "")]
        # save_weights nests layer/layer/weight: collapse the duplicate
        dedup = [p for i, p in enumerate(parts) if i == 0 or p != parts[i - 1]]
        flat["/".join(dedup[-2:]).removesuffix(":0")] = np.asarray(
            arr, np.float32)

    if path.endswith(".npz"):
        with np.load(path) as z:
            for k in z.files:
                put(k.split("/"), z[k])
        return flat
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path}: reading a Keras .h5 weights file needs h5py, which is "
            f"not importable here; export the weights as an .npz of "
            f"layer/weight arrays instead") from e
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                put(name.split("/"), obj[()])
        f.visititems(visit)
    return flat


def flatten_tree(tree: dict, sep: str = "/") -> dict[str, np.ndarray]:
    """A nested dict as ``{"a/b/leaf": array}`` (flax's ``flatten_dict``
    with ``sep``)."""
    return {sep.join(k): v for k, v in _flat(tree)}


def unflatten_tree(flat: dict, sep: str = "/") -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split(sep)
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def save_pretrained(path: str, backbone_vars: dict,
                    scope: str = "backbone") -> None:
    """Write converted backbone variables as the ``.npz`` artifact that
    ``ModelCfg.pretrained_path`` names, keys fully qualified under
    ``scope``."""
    tree = {"params": {scope: backbone_vars["params"]},
            "batch_stats": {scope: backbone_vars["batch_stats"]}}
    np.savez(path, **{k: np.asarray(v) for k, v in flatten_tree(tree).items()})


def load_pretrained(variables: dict, path: str) -> dict:
    """Merge a pretrained ``.npz`` artifact into a model's flax-layout
    variables. Every artifact entry must match an existing path and shape:
    a mismatch means the architecture and the artifact diverged, which
    raises rather than training from a partial graft."""
    flat = flatten_tree(variables)
    with np.load(path) as loaded:
        for key in loaded.files:
            if key not in flat:
                raise KeyError(f"{path}: artifact key {key!r} not in model "
                               f"variables (architecture/artifact mismatch)")
            have, arr = flat[key], loaded[key]
            if tuple(have.shape) != tuple(arr.shape):
                raise ValueError(f"{path}: shape mismatch at {key!r}: model "
                                 f"{tuple(have.shape)} vs artifact "
                                 f"{arr.shape}")
            flat[key] = arr.astype(np.asarray(have).dtype)
    return unflatten_tree(flat)


def load_pretrained_module(module: nn.Module, path: str) -> nn.Module:
    """:func:`load_pretrained` over ``module``'s own weights, in place: the
    artifact's leaves replace their counterparts, every other leaf (the
    head) keeps its value."""
    return load_flax_variables(
        module, load_pretrained(to_flax_variables(module), path))


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert pretrained MobileNetV2 / ResNet weights into a "
                    "flax-layout .npz artifact")
    ap.add_argument("weights", help="torch state_dict (.pt) or Keras "
                                    "weights (.h5 / .npz of layer/weight "
                                    "arrays)")
    ap.add_argument("out", help="output .npz artifact path")
    args = ap.parse_args(argv)

    if args.weights.endswith((".h5", ".hdf5")):
        converted = convert_keras_mobilenet_v2(load_keras_weights(args.weights))
    elif args.weights.endswith(".npz"):
        w = load_keras_weights(args.weights)
        if not any(k.startswith("Conv1/") for k in w):
            raise SystemExit(f"{args.weights}: no Conv1/* keys — not a "
                             f"Keras MobileNetV2 weights archive")
        converted = convert_keras_mobilenet_v2(w)
    else:
        sd = torch.load(args.weights, map_location="cpu", weights_only=True)
        if "features.0.0.weight" in sd and "features.18.0.weight" in sd:
            # 18 feature stages with the stem and top: mobilenet_v2
            converted = convert_torch_mobilenet_v2(sd)
        elif "conv1.weight" in sd and any(k.startswith("layer1.") for k in sd):
            depth = infer_torch_resnet_depth(sd)
            print(f"detected torchvision resnet{depth}")
            converted = convert_torch_resnet(sd, depth)
        else:
            raise SystemExit(f"{args.weights}: unrecognized state_dict "
                             f"layout (expected torchvision mobilenet_v2 or "
                             f"resnet)")
    save_pretrained(args.out, converted)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
