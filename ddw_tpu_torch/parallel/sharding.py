"""Rule-based parameter sharding and the tensor-parallel train step — the
port of ``ddw_tpu.parallel.sharding``.

Placements are ``ddw_tpu``'s: ordered ``(path regex, PartitionSpec)``
rules, matched against a leaf's flax path (``backbone_block0/attn/query/
kernel``), the spec over the leaf's flax dims. :func:`shardings_for_params`
gives the spec of every leaf of a parameter tree (flax layout, numpy or
shapes) or of a :class:`~ddw_tpu_torch.train.step.TrainState`, keyed by
``ddw_tpu``'s checkpoint path, so the two packages' placements compare leaf
for leaf.

``ddw_tpu`` lets GSPMD insert the tensor-parallel collectives. The port
shards the module itself (:func:`tp_shard_module`): every leaf keeps the
block of its spec that this rank's ``model`` coordinate owns, and the
layers take Megatron's roles from where their kernel is split:

- column-parallel (a split output dim: attention heads of query/key/value,
  ``fc1``): the input passes :func:`~ddw_tpu_torch.parallel.comm.
  copy_to_group` (identity forward, all-reduced gradient);
- row-parallel (a split input dim: ``attn/out``, ``fc2``): the partial
  products are summed over the ``model`` group and the bias added once
  (:func:`~ddw_tpu_torch.parallel.comm.reduce_from_group`);
- a vocab-split embedding looks up its own rows and sums over the group; a
  vocab-split head gathers its logits.

Replicated leaves then see the same activations on every ``model`` rank.
Most see the same gradients too, so the data-parallel mean runs over the
``data`` group only. Two kinds do not, and the module lists them in
``model._tp_grad_sum`` (their gradient on a rank is a partial sum, which
the step sums over the ``model`` group before the optimizer reads it):

- LoRA leaves (``lora_a`` / ``lora_b``), which stay whole, as ``ddw_tpu``
  places them (``P()``), while their layer computes with its block of them
  (:func:`ddw_tpu_torch.models.lora.tp_lora_block`): a column layer B's
  columns of its features and A whole, a row layer A's rows of its input
  and B whole. A rank's dA (column) or dB (row) is then its share of the
  sum, and the other leaf's gradient is nonzero only on the rank's block.
  Keeping the leaves whole costs one small sum a step and keeps every
  placement, checkpoint and ``to_flax`` read of them ``ddw_tpu``'s.
- K/V projections replicated under the GQA fallback: each rank's query
  heads read only their own K/V heads, so the K/V layers take the column
  role's input hook (their input gradient summed) and their leaves'
  gradients are summed.

The step is :func:`ddw_tpu_torch.parallel.zero.make_sharded_state_step`
with these specs (the FSDP x TP step adds a data split on another dim).
"""

from __future__ import annotations

import re
import warnings
from typing import Callable, Sequence

import torch
from torch import nn

from ddw_tpu_torch.parallel import comm
from ddw_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS


class P(tuple):
    """A partition spec: one mesh axis name (or ``None``) per leading dim
    of a leaf's flax layout; trailing dims unlisted are replicated, as in
    ``jax.sharding.PartitionSpec`` (``tuple(jax_spec)`` compares equal)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class PartitionRules:
    """Ordered (regex, PartitionSpec) rules; first match wins, default
    replicated."""

    def __init__(self, rules: Sequence[tuple[str, P]]):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path: str, ndim: int) -> P:
        for pat, spec in self.rules:
            if pat.search(path):
                if len(spec) > ndim:
                    raise ValueError(f"rule {pat.pattern} spec {spec} rank > "
                                     f"param rank {ndim} at {path}")
                return spec
        return P()


VIT_TP_RULES = PartitionRules([
    (r"attn/(query|key|value)/kernel", P(None, MODEL_AXIS, None)),
    (r"attn/(query|key|value)/bias", P(MODEL_AXIS, None)),
    (r"attn/out/kernel", P(MODEL_AXIS, None, None)),
    (r"mlp/fc1/kernel", P(None, MODEL_AXIS)),
    (r"mlp/fc1/bias", P(MODEL_AXIS)),
    (r"mlp/fc2/kernel", P(MODEL_AXIS, None)),
])

LM_TP_RULES = PartitionRules([
    (r"attn/(query|key|value)/kernel", P(None, MODEL_AXIS, None)),
    (r"attn/(query|key|value)/bias", P(MODEL_AXIS, None)),
    (r"attn/out/kernel", P(MODEL_AXIS, None, None)),
    (r"fc1/kernel", P(None, MODEL_AXIS)),
    (r"fc1/bias", P(MODEL_AXIS)),
    (r"fc2/kernel", P(MODEL_AXIS, None)),
    (r"tok_embed/embedding", P(MODEL_AXIS, None)),
    (r"head/kernel", P(None, MODEL_AXIS)),
    (r"head/bias", P(MODEL_AXIS)),
])

# GQA fallback: q stays head-sharded, k/v replicate
LM_TP_RULES_REPLICATED_KV = PartitionRules([
    (r"attn/query/kernel", P(None, MODEL_AXIS, None)),
    (r"attn/query/bias", P(MODEL_AXIS, None)),
    (r"attn/(key|value)/(kernel|bias)", P()),
    (r"attn/out/kernel", P(MODEL_AXIS, None, None)),
    (r"fc1/kernel", P(None, MODEL_AXIS)),
    (r"fc1/bias", P(MODEL_AXIS)),
    (r"fc2/kernel", P(MODEL_AXIS, None)),
    (r"tok_embed/embedding", P(MODEL_AXIS, None)),
    (r"head/kernel", P(None, MODEL_AXIS)),
    (r"head/bias", P(MODEL_AXIS)),
])


def lm_tp_rules_for(num_heads: int, num_kv_heads: int,
                    tp: int) -> tuple[PartitionRules, bool]:
    """``(rules, kv_sharded)`` for a TransformerLM at ``tp``: query heads
    must divide by ``tp``; KV heads that do not fall back to replicated k/v
    with a RuntimeWarning."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    kv_heads = num_kv_heads or num_heads
    if num_heads % tp:
        raise ValueError(
            f"tp {tp} does not divide num_heads {num_heads}: the attention "
            f"head axis is the TP shard axis, so the head count must be a "
            f"multiple of the model-axis size")
    if kv_heads % tp:
        warnings.warn(
            f"num_kv_heads {kv_heads} not divisible by tp {tp} (GQA/MQA): "
            f"replicating k/v params and the KV block pool instead of "
            f"sharding them on the heads axis — correct but forfeits the "
            f"KV-memory split across the mesh slice",
            RuntimeWarning, stacklevel=2)
        return LM_TP_RULES_REPLICATED_KV, False
    return LM_TP_RULES, True


def _mesh_size(mesh, axis) -> int:
    names = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def check_spec_divisibility(key: str, shape: tuple, spec: P, mesh) -> None:
    """Refuse loudly a sharded dim that its mesh axis does not divide (the
    usual trip-wire: GQA's k/v heads below the model-axis size)."""
    for d, axis in enumerate(spec):
        if axis is None or d >= len(shape):
            continue
        n = _mesh_size(mesh, axis)
        if shape[d] % n:
            raise ValueError(
                f"cannot shard {key} dim {d} (size {shape[d]}) over mesh "
                f"axis {axis!r} (size {n}): not divisible. For GQA/MQA "
                f"models either keep num_kv_heads a multiple of the "
                f"model-axis size or override the k/v rules to replicate.")


def _flat_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_paths(v, prefix + (str(k),))
    else:
        yield prefix, tree


def shardings_for_params(tree, mesh, rules: PartitionRules) -> dict:
    """The spec of every leaf, by path: a flax-layout tree (nested dicts of
    arrays) by its ``/``-joined path, or a TrainState by its checkpoint
    path (:func:`ddw_tpu_torch.checkpoint.sharded.state_leaves`;
    optimizer moments mirror their parameter's rule, scalars replicate).
    Raises on a spec its mesh axis does not divide."""
    if isinstance(tree, dict):
        out = {}
        for path, leaf in _flat_paths(tree):
            key = "/".join(path)
            shape = tuple(getattr(leaf, "shape", ()))
            spec = rules.spec_for(key, len(shape))
            check_spec_divisibility(key, shape, spec, mesh)
            out[key] = spec
        return out
    from ddw_tpu_torch.checkpoint.sharded import state_leaves

    out = {}
    for leaf in state_leaves(tree, full=True):
        spec = rules.spec_for(leaf.rule_key, len(leaf.shape))
        check_spec_divisibility(leaf.rule_key, leaf.shape, spec, mesh)
        out[leaf.path] = spec
    return out


def specs_by_name(model: nn.Module, rules: PartitionRules, mesh) -> dict:
    """The spec of every parameter of ``model`` by its torch name (over
    its flax dims, as :func:`tp_shard_module` takes them), from ``rules``
    matched against the flax path; raises on a dim its axis does not
    divide."""
    from ddw_tpu_torch.models.convert import flax_leaf_index, flax_shape

    params = dict(model.named_parameters())
    out = {}
    for name, (_, path, _, _, to_flax) in flax_leaf_index(model).items():
        if name not in params:
            continue
        key = "/".join(path)
        shape = flax_shape(params[name].shape, to_flax)
        spec = rules.spec_for(key, len(shape))
        check_spec_divisibility(key, shape, spec, mesh)
        out[name] = spec
    return out


def decode_cache_shardings(cache: dict, mesh, kv_sharded: bool = True):
    """The spec of every leaf of a paged-decode cache: the KV block pools
    (``kv_block_key`` / ``kv_block_value [n_blocks, block_size, KV, hd]``)
    on the heads axis, everything else replicated; all replicated when
    ``kv_sharded`` is False (the GQA fallback).
    :func:`~ddw_tpu_torch.models.lm.init_paged_cache` sizes a
    tensor-parallel serving pool by it."""
    out = {}
    for path, leaf in _flat_paths(cache):
        key = "/".join(path)
        shape = tuple(getattr(leaf, "shape", ()))
        if kv_sharded and "kv_block_" in key and len(shape) == 4:
            spec = P(None, None, MODEL_AXIS, None)
            check_spec_divisibility(key, shape, spec, mesh)
        else:
            spec = P()
        out[key] = spec
    return out


# -- the tensor-parallel module ------------------------------------------------

def local_block(t: torch.Tensor, spec: P, dims: tuple, mesh,
                coords: dict | None = None) -> torch.Tensor:
    """The block of a port-layout tensor that this rank owns under ``spec``
    (over flax dims; ``dims[port_dim] = flax_dim``): a view. ``coords``
    overrides this rank's coordinate along some axes (the block another
    rank owns)."""
    coords = coords or {}
    for fd, axis in enumerate(spec):
        if axis is None:
            continue
        pd = dims.index(fd)
        names = axis if isinstance(axis, tuple) else (axis,)
        n, idx = 1, 0
        for a in names:
            c = coords[a] if a in coords else mesh.axis_index(a)
            idx = idx * mesh.shape[a] + c
            n *= mesh.shape[a]
        size = t.shape[pd] // n
        t = t.narrow(pd, idx * size, size)
    return t


def _role(mod: nn.Module, leaf: str, spec: P, axis: str, top_head: bool):
    """Megatron's role of a layer whose ``leaf`` carries ``spec``."""
    from ddw_tpu_torch.models.lm import DenseGeneral, Embed

    split = [d for d, a in enumerate(spec) if a == axis]
    if not split or leaf not in ("kernel", "embedding"):
        return None
    if isinstance(mod, Embed):
        return "vocab"
    if isinstance(mod, DenseGeneral):
        if split[0] < len(mod.in_dims):
            return "row"
        return "gather" if top_head else "column"
    raise ValueError(f"no tensor-parallel role for {type(mod).__name__} "
                     f"split on {spec}")


def _install_role(mod: nn.Module, role: str, group, index: int) -> None:
    if role in ("column", "replicated"):
        mod.register_forward_pre_hook(
            lambda m, args: (comm.copy_to_group(args[0], group),)
            + tuple(args[1:]))
    elif role == "gather":
        mod.register_forward_pre_hook(
            lambda m, args: (comm.copy_to_group(args[0], group),)
            + tuple(args[1:]))
        mod.register_forward_hook(
            lambda m, args, out: comm.gather_from_group(out, group, -1))
    elif role == "row":
        def row_out(m, args, out):
            b = m.bias.to(out.dtype)
            return comm.reduce_from_group(out - b, group) + b

        mod.register_forward_hook(row_out)
    else:  # vocab-split embedding: own rows, zeros elsewhere, summed
        rows = mod.embedding.shape[0]
        lo = index * rows

        def pre(m, args):
            tok = args[0].long()
            m._tp_keep = (tok >= lo) & (tok < lo + rows)
            return ((tok - lo).clamp(0, rows - 1),) + tuple(args[1:])

        def post(m, args, out):
            keep = m._tp_keep.unsqueeze(-1)
            return comm.reduce_from_group(out * keep.to(out.dtype), group)

        mod.register_forward_pre_hook(pre)
        mod.register_forward_hook(post)


@torch.no_grad()
def tp_shard_module(model: nn.Module, specs: dict, mesh,
                    axis: str = MODEL_AXIS) -> nn.Module:
    """Shard ``model`` in place over ``axis``: each parameter keeps the
    block of its spec (``specs`` by torch name, over flax dims) that this
    rank owns, and the layers take their Megatron roles (module
    docstring). A split ``DenseGeneral`` records its split in
    ``tp_split``; LoRA leaves stay whole."""
    from ddw_tpu_torch.models.convert import flax_leaf_index

    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return model
    group, index = mesh.group(axis), mesh.axis_index(axis)
    n = mesh.shape[axis]
    idx = flax_leaf_index(model)
    mods = dict(model.named_modules())
    roles = {}
    for name, p in model.named_parameters():
        spec = specs.get(name, P())
        if axis not in spec:
            continue
        only = P(*[a if a == axis else None for a in spec])
        p.data = local_block(p.data, only, idx[name][2], mesh).contiguous()
        mod_name, _, leaf = name.rpartition(".")
        role = _role(mods[mod_name], leaf, spec, axis, mod_name == "head")
        if role is not None:
            roles[mod_name] = role
            if role in ("column", "row"):
                mods[mod_name].tp_split = (spec.index(axis), index, n)
    for mod_name, mod in mods.items():
        # the GQA fallback: query heads split, K/V replicated, so each
        # rank's query heads must know where they start, and the K/V
        # layers' gradients are partial sums
        q = specs.get(f"{mod_name}.query.kernel", P())
        k = specs.get(f"{mod_name}.key.kernel", P())
        if hasattr(mod, "q_head_offset") and axis in q and axis not in k:
            mod.q_head_offset = index * (mod.num_heads // n)
            roles[f"{mod_name}.key"] = roles[f"{mod_name}.value"] = \
                "replicated"
    for mod_name, role in roles.items():
        _install_role(mods[mod_name], role, group, index)
    partial = []
    for name, _ in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        if roles.get(mod_name) == "replicated" or (
                leaf in ("lora_a", "lora_b")
                and mods[mod_name].tp_split is not None):
            partial.append(name)
    model._tp_axis = axis
    model._tp_grad_sum = tuple(partial)
    return model


def make_sharded_train_step(model, tx, mesh, rules: PartitionRules,
                            data_axis: str = DATA_AXIS,
                            grad_accum_steps: int = 1) -> Callable:
    """Tensor+data-parallel train step: parameters and optimizer moments
    sharded by ``rules`` over ``model`` (the module sharded by
    :func:`tp_shard_module` at ``step.place_state(state)``), the batch over
    ``data``. ``step(state, images, labels, seed) -> metrics`` as the DP
    step, each rank passing its data shard's batch (the same batch on every
    ``model`` rank of a replica)."""
    from ddw_tpu_torch.parallel.zero import make_sharded_state_step

    return make_sharded_state_step("tp", model, tx, mesh, data_axis,
                                   grad_accum_steps, rules=rules)
