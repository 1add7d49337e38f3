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

Replicated leaves then see the same activations and gradients on every
``model`` rank, so the data-parallel mean runs over the ``data`` group
only. The step is :func:`ddw_tpu_torch.parallel.zero.make_sharded_state_step`
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


def decode_cache_shardings(cache: dict, mesh, kv_sharded: bool = True):
    """The spec of every leaf of a paged-decode cache: the KV block pools
    (``kv_block_key`` / ``kv_block_value [n_blocks, block_size, KV, hd]``)
    on the heads axis, everything else replicated; all replicated when
    ``kv_sharded`` is False (the GQA fallback). The engine does not take
    it yet: tensor-parallel serving is ``ROADMAP.md`` item 12b."""
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

def local_block(t: torch.Tensor, spec: P, dims: tuple, mesh) -> torch.Tensor:
    """The block of a port-layout tensor that this rank owns under ``spec``
    (over flax dims; ``dims[port_dim] = flax_dim``): a view."""
    for fd, axis in enumerate(spec):
        if axis is None:
            continue
        pd = dims.index(fd)
        names = axis if isinstance(axis, tuple) else (axis,)
        n, idx = 1, 0
        for a in names:
            idx = idx * mesh.shape[a] + mesh.axis_index(a)
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
        if getattr(mod, "lora_a", None) is not None:
            raise ValueError("tensor parallelism does not take LoRA "
                             "adapters")
        if split[0] < len(mod.in_dims):
            return "row"
        return "gather" if top_head else "column"
    raise ValueError(f"no tensor-parallel role for {type(mod).__name__} "
                     f"split on {spec}")


def _install_role(mod: nn.Module, role: str, group, index: int) -> None:
    if role == "column":
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
    docstring)."""
    from ddw_tpu_torch.models.convert import flax_leaf_index

    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return model
    group, index = mesh.group(axis), mesh.axis_index(axis)
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
    for mod_name, role in roles.items():
        _install_role(mods[mod_name], role, group, index)
    model._tp_axis = axis
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
