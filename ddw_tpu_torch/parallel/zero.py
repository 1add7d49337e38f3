"""ZeRO-family sharding over the data axis — the port of
``ddw_tpu.parallel.zero``.

Placement is ``ddw_tpu``'s rule, not PyTorch's FSDP: :func:`_leaf_spec`
splits the largest dimension of a leaf's *flax-layout* shape that the axis
size divides, and replicates a leaf with none (``fully_shard`` always
splits dim 0, which would not match ``ddw_tpu``'s shard boundaries or its
sharded checkpoints). Each port leaf maps to its flax layout through
:func:`ddw_tpu_torch.models.convert.flax_leaf_index`.

``ddw_tpu`` annotates the state and lets GSPMD derive the collectives. The
port runs them in each rank (:func:`make_sharded_state_step`):

- **ZeRO-1** (:func:`make_zero_train_step`): parameters replicated, the
  optimizer moments sharded. Forward and backward on the rank's batch, the
  gradient mean over ``data``, then each rank updates only its slice of
  every parameter with its slice of the moments and the slices are
  all-gathered back into the replicated parameters.
- **ZeRO-3 / FSDP** (:func:`make_fsdp_train_step`): parameters sharded too.
  At rest a rank holds only its block of each divisible leaf (the module's
  tensor is released to an empty one); the step all-gathers the blocks
  into the module, runs forward and backward, keeps its slice of the mean
  gradient, updates its block and releases the gathered weights again.
- **FSDP x TP** (:func:`make_fsdp_tp_train_step`): the tensor-parallel
  split of :mod:`ddw_tpu_torch.parallel.sharding` over ``model``, then the
  FSDP split over ``data`` on the largest still-unsplit dim.

The update is elementwise, so every variant gives the plain DP step's
numbers. Two semantic differences from ``ddw_tpu``'s GSPMD steps, both
those of the port's DP step: BatchNorm normalises over each rank's batch
and the updated statistics are averaged (``ddw_tpu``'s sharded steps
normalise over the global batch), and dropout masks are drawn per data
shard. The equivalence with ``ddw_tpu`` holds for stateless-norm models at
dropout 0, as ``ddw_tpu``'s own equivalence tests pin.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist

from ddw_tpu_torch.parallel.sharding import (P, check_spec_divisibility,
                                             local_block, tp_shard_module)
from ddw_tpu_torch.runtime.collectives import all_gather_axis
from ddw_tpu_torch.runtime.dist import all_reduce_mean_
from ddw_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS


def _leaf_spec(shape: tuple[int, ...], n: int, axis: str,
               exclude: frozenset[int] = frozenset()) -> P:
    """Shard the largest dimension divisible by ``n``; replicate if none.
    ``exclude`` marks dims already owned by another axis (the 2-D path)."""
    best = None
    for d, s in enumerate(shape):
        if d in exclude:
            continue
        if s % n == 0 and s >= n and (best is None or s > shape[best]):
            best = d
    if best is None:
        return P()
    spec = [None] * len(shape)
    spec[best] = axis
    return P(*spec)


def _axes(spec: P) -> set:
    out = set()
    for a in spec:
        if a is not None:
            out.update(a if isinstance(a, tuple) else (a,))
    return out


def _minus(spec: P, drop: P) -> P:
    """``spec`` without the axes of ``drop``."""
    gone = _axes(drop)
    return P(*[None if a in gone else a for a in spec])


class StateLayout:
    """How a placed TrainState lies over ``mesh``: per parameter (torch
    name) the spec of its module tensor during compute (``compute``), at
    rest (``rest``; the FSDP block) and of its optimizer moments
    (``moment``), each over the leaf's flax dims. ``shards`` holds the
    FSDP blocks while the module's tensors are released."""

    def __init__(self, mode: str, mesh, axis: str, model, compute: dict,
                 rest: dict, moment: dict, global_shapes: dict):
        from ddw_tpu_torch.models.convert import flax_leaf_index

        self.mode, self.mesh, self.axis = mode, mesh, axis
        self.compute, self.rest, self.moment = compute, rest, moment
        self.global_shapes = global_shapes
        self.index = flax_leaf_index(model)
        self.shards: dict[str, torch.Tensor] = {}
        self.released = False

    @property
    def fsdp(self) -> bool:
        return self.mode in ("fsdp", "fsdp_tp")

    def dims(self, name: str) -> tuple:
        return self.index[name][2]

    def block(self, t: torch.Tensor, name: str, spec: P) -> torch.Tensor:
        return local_block(t, spec, self.dims(name), self.mesh)

    def _gather(self, t: torch.Tensor, name: str, spec: P) -> torch.Tensor:
        """A block of ``spec`` all-gathered over the data axis back into
        the compute block."""
        for fd, a in enumerate(spec):
            if a == self.axis:
                t = all_gather_axis(t, self.mesh.group(self.axis),
                                    tiled=True, axis=self.dims(name).index(fd))
        return t

    @torch.no_grad()
    def gather(self, model) -> None:
        """FSDP: the module's tensors from the rest blocks."""
        if not (self.fsdp and self.released):
            return
        for n, p in model.named_parameters():
            if n in self.shards:
                p.data = self._gather(self.shards[n], n,
                                      _minus(self.rest[n], self.compute[n]))
        self.released = False

    @torch.no_grad()
    def release(self, model) -> None:
        """FSDP: drop the gathered tensors, keep the rest blocks."""
        if not self.fsdp:
            return
        for n, p in model.named_parameters():
            if n in self.shards:
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.released = True

    def compute_tree(self, tree: dict) -> dict:
        """Moment-spec blocks (e.g. the EMA shadow) gathered to the compute
        layout."""
        return {n: self._gather(t, n, _minus(self.moment[n], self.compute[n]))
                for n, t in tree.items()}

    @torch.no_grad()
    def full_params(self, model) -> dict:
        """Every parameter whole (gathered over the data and model axes),
        by torch name: the collective every rank enters to read the
        state."""
        was_released = self.released
        self.gather(model)
        try:
            out = {}
            for n, p in model.named_parameters():
                t = p.data
                for fd, a in enumerate(self.compute[n]):
                    if a is not None:
                        t = all_gather_axis(t, self.mesh.group(a),
                                            tiled=True,
                                            axis=self.dims(n).index(fd))
                out[n] = t
            return out
        finally:
            if was_released:
                self.release(model)

    def views(self, tensors: dict) -> dict:
        """This rank's moment-spec slice of each compute tensor."""
        return {n: t if t is None else
                self.block(t, n, _minus(self.moment[n], self.compute[n]))
                for n, t in tensors.items()}

    def sq_norm(self, g: dict) -> torch.Tensor:
        """The clipping norm's square over the whole tree: each distinct
        block once (a block held by r ranks weighs 1/r), summed over the
        world."""
        world = int(self.mesh.ranks.size)
        total = None
        for n, t in g.items():
            held = 1
            for a in _axes(self.moment[n]):
                held *= self.mesh.shape[a]
            part = torch.sum(t.float() * t.float()) * (held / world)
            total = part if total is None else total + part
        if world > 1 and dist.is_initialized():
            total = total.clone()
            dist.all_reduce(total)
        return total


def _global_flax_shapes(model) -> dict:
    from ddw_tpu_torch.models.convert import flax_leaf_index, flax_shape

    params = dict(model.named_parameters())
    return {n: flax_shape(params[n].shape, to_flax)
            for n, (_, _, _, _, to_flax) in flax_leaf_index(model).items()
            if n in params}


def _specs(mode: str, model, mesh, axis: str, rules=None):
    """``(compute, rest, moment)`` specs by parameter name."""
    from ddw_tpu_torch.models.convert import flax_leaf_index

    shapes = _global_flax_shapes(model)
    idx = flax_leaf_index(model)
    n = mesh.shape[axis] if axis in mesh.axis_names else 1
    compute, rest, moment = {}, {}, {}
    for name, shape in shapes.items():
        key = "/".join(idx[name][1])
        if rules is not None:
            base = rules.spec_for(key, len(shape))
            check_spec_divisibility(key, shape, base, mesh)
        else:
            base = P()
        if mode == "tp":
            compute[name] = rest[name] = moment[name] = base
            continue
        spec = list(base) + [None] * (len(shape) - len(base))
        taken = frozenset(d for d, a in enumerate(spec) if a is not None)
        for d, a in enumerate(_leaf_spec(shape, n, axis, exclude=taken)):
            if a is not None:
                spec[d] = a
        # ddw_tpu's 2-D specs list every dim; the 1-D rule replicates as P()
        full = (P(*spec) if rules is not None
                or any(a is not None for a in spec) else P())
        compute[name] = base
        moment[name] = full
        rest[name] = base if mode == "zero" else full
    return compute, rest, moment, shapes


def _moment_dicts(opt_state: dict):
    """Every per-parameter dict of an optimizer state (moments, shadow)."""
    for key, val in opt_state.items():
        if isinstance(val, dict) and key == "inner":
            yield from _moment_dicts(val)
        elif isinstance(val, dict):
            yield val


@torch.no_grad()
def place(state, mode: str, mesh, axis: str = DATA_AXIS, rules=None):
    """Shard ``state`` in place for ``mode`` (``zero`` | ``fsdp`` | ``tp``
    | ``fsdp_tp``) and record the :class:`StateLayout`; a no-op on a state
    already placed."""
    if state.layout is not None:
        return state
    model = state.model
    compute, rest, moment, shapes = _specs(mode, model, mesh, axis, rules)
    lay = StateLayout(mode, mesh, axis, model, compute, rest, moment, shapes)
    for d in _moment_dicts(state.opt_state):
        for n in list(d):
            d[n] = lay.block(d[n], n, moment[n]).contiguous().clone()
    if mode in ("tp", "fsdp_tp"):
        tp_shard_module(model, compute, mesh, MODEL_AXIS)
    if lay.fsdp:
        for n, p in model.named_parameters():
            if _axes(_minus(rest[n], compute[n])):
                lay.shards[n] = lay.block(
                    p.data, n, _minus(rest[n], compute[n])).contiguous().clone()
        lay.release(model)
    state.layout = lay
    return state


@contextlib.contextmanager
def gathered(state):
    """The module's full compute tensors for the duration (FSDP gathers
    its blocks and releases them after); a no-op for other layouts."""
    lay = state.layout
    if lay is None or not lay.fsdp:
        yield state
        return
    lay.gather(state.model)
    try:
        yield state
    finally:
        lay.release(state.model)


def _sharded_body(tx, grad_accum_steps: int, state, images, labels,
                  seed: int):
    from ddw_tpu_torch.train.step import (accumulate_grads,
                                          dropout_generator,
                                          forward_and_grads)

    lay = state.layout
    mesh, axis = lay.mesh, lay.axis
    data_g = mesh.group(axis) if axis in mesh.axis_names else None
    shard = mesh.axis_index(axis) if axis in mesh.axis_names else 0
    model = state.model
    with gathered(state):
        if grad_accum_steps > 1:
            loss, acc, bstats, grads = accumulate_grads(
                state, images, labels, seed, shard, grad_accum_steps)
        else:
            loss, acc, bstats, grads = forward_and_grads(
                state, images, labels,
                dropout_generator(seed, shard, state.step))
        all_reduce_mean_([g for g in grads.values() if g is not None],
                         data_g)
        all_reduce_mean_(list(bstats.values()), data_g)
        metrics = torch.stack([loss.float(), acc.float()])
        all_reduce_mean_([metrics], data_g)
        params = {n: p.data for n, p in model.named_parameters()}
        views = lay.views(params)
        tx.update(views, lay.views(grads), state.opt_state, lay.sq_norm)
        for n, p in model.named_parameters():
            sliced = _minus(lay.moment[n], lay.compute[n])
            if not _axes(sliced):
                continue
            if lay.fsdp and n in lay.shards:
                lay.shards[n].copy_(views[n])
            else:   # ZeRO: the updated slices back into every replica
                p.data.copy_(lay._gather(views[n].contiguous(), n, sliced))
    state.step += 1
    return metrics[0], metrics[1]


def make_sharded_state_step(mode: str, model, tx, mesh,
                            axis: str = DATA_AXIS, grad_accum_steps: int = 1,
                            rules=None, chain: bool = False) -> Callable:
    """The shared factory behind the ZeRO-1, FSDP, tensor-parallel and
    FSDP x TP steps. ``step(state, images, labels, seed) -> metrics`` with
    this rank's data shard of the batch (``[K, B, ...]`` and ``[K]``
    metrics when ``chain``); the state is placed at the first call, or by
    ``step.place_state(state)``."""

    def place_state(state):
        return place(state, mode, mesh, axis, rules)

    def step(state, images, labels, seed):
        place_state(state)
        if not chain:
            loss, acc = _sharded_body(tx, grad_accum_steps, state, images,
                                      labels, seed)
            return {"loss": loss, "accuracy": acc}
        out = [_sharded_body(tx, grad_accum_steps, state, images[k],
                             labels[k], seed) for k in range(images.shape[0])]
        return {"loss": torch.stack([l for l, _ in out]),
                "accuracy": torch.stack([a for _, a in out])}

    step.place_state = place_state
    step.mode = mode
    return step


def make_zero_train_step(model, tx, mesh, axis: str = DATA_AXIS,
                         grad_accum_steps: int = 1) -> Callable:
    """DP step with ZeRO-1 sharded optimizer moments."""
    return make_sharded_state_step("zero", model, tx, mesh, axis,
                                   grad_accum_steps)


def make_fsdp_train_step(model, tx, mesh, axis: str = DATA_AXIS,
                         grad_accum_steps: int = 1) -> Callable:
    """DP step with ZeRO-3/FSDP sharded parameters and moments."""
    return make_sharded_state_step("fsdp", model, tx, mesh, axis,
                                   grad_accum_steps)


def make_zero_train_chain(model, tx, mesh, axis: str = DATA_AXIS,
                          grad_accum_steps: int = 1) -> Callable:
    """K ZeRO-1 steps per call over a ``[K, B, ...]`` super-batch."""
    return make_sharded_state_step("zero", model, tx, mesh, axis,
                                   grad_accum_steps, chain=True)


def make_fsdp_train_chain(model, tx, mesh, axis: str = DATA_AXIS,
                          grad_accum_steps: int = 1) -> Callable:
    """K FSDP steps per call over a ``[K, B, ...]`` super-batch."""
    return make_sharded_state_step("fsdp", model, tx, mesh, axis,
                                   grad_accum_steps, chain=True)


def make_fsdp_tp_train_step(model, tx, mesh, rules, axis: str = DATA_AXIS,
                            grad_accum_steps: int = 1) -> Callable:
    """2-D FSDP x TP step over a ``(data, model)`` mesh: the rules' split
    over ``model``, then FSDP over ``axis`` on the largest still-unsplit
    divisible dim of every leaf (``fsdp_tp_state_shardings``)."""
    return make_sharded_state_step("fsdp_tp", model, tx, mesh, axis,
                                   grad_accum_steps, rules=rules)


# -- placements by checkpoint path (``ddw_tpu``'s shardings) -------------------

def _state_specs(state, mode: str, mesh, axis: str, rules=None,
                 clip: bool = False) -> dict:
    from ddw_tpu_torch.checkpoint.sharded import state_leaves

    if state.layout is not None:
        rest, moment = state.layout.rest, state.layout.moment
    else:
        _, rest, moment, _ = _specs(mode, state.model, mesh, axis, rules)
    specs = {"param": rest, "moment": moment}
    return {leaf.path: specs[leaf.kind][leaf.name]
            if leaf.kind in specs else P()
            for leaf in state_leaves(state, full=True, clip=clip)}


def zero_state_shardings(state, mesh, axis: str = DATA_AXIS,
                         clip: bool = False) -> dict:
    """Spec by checkpoint path under ZeRO-1: params, batch stats and
    scalars replicated, optimizer moments by :func:`_leaf_spec`. ``clip``:
    the optimizer clips (its moments' paths move, as optax's chain moves
    them)."""
    return _state_specs(state, "zero", mesh, axis, clip=clip)


def fsdp_state_shardings(state, mesh, axis: str = DATA_AXIS,
                         clip: bool = False) -> dict:
    """Spec by checkpoint path under ZeRO-3/FSDP: params and moments by
    :func:`_leaf_spec`, batch stats and scalars replicated."""
    return _state_specs(state, "fsdp", mesh, axis, clip=clip)


def fsdp_tp_state_shardings(state, mesh, rules, axis: str = DATA_AXIS,
                            clip: bool = False) -> dict:
    """Spec by checkpoint path under FSDP x TP: the rules' split, then
    FSDP on the largest still-unsplit divisible dim."""
    return _state_specs(state, "fsdp_tp", mesh, axis, rules, clip)


def _fraction_sharded(state, mesh, axis: str, kinds: tuple) -> float:
    from ddw_tpu_torch.checkpoint.sharded import state_leaves

    n = mesh.shape[axis]
    total = sharded = 0
    for leaf in state_leaves(state, full=True):
        if leaf.kind not in kinds:
            continue
        size = 1
        for s in leaf.shape:
            size *= s
        total += size
        if _leaf_spec(leaf.shape, n, axis) != P():
            sharded += size
    return sharded / total if total else 0.0


def zero_fraction_sharded(state, mesh, axis: str = DATA_AXIS) -> float:
    """Fraction of optimizer-state elements whose leaves shard."""
    return _fraction_sharded(state, mesh, axis, ("moment", "opt_scalar"))


def fsdp_fraction_sharded(state, mesh, axis: str = DATA_AXIS) -> float:
    """Fraction of parameter elements whose leaves shard."""
    return _fraction_sharded(state, mesh, axis, ("param",))
