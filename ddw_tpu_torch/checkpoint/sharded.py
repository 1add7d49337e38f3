"""Sharded (per-process) checkpointing — the port of
``ddw_tpu.checkpoint.sharded``, on ``ddw_tpu``'s on-disk format.

Every rank writes exactly the blocks it holds (the first replica of each,
so a replicated leaf is written once), in the flax layout, and process 0
writes the index:

    <dir>/step_<N>/
      index.json     # step, metadata, n_processes, proc_bytes, leaf -> shape/dtype
      proc_<i>.bin   # concatenated raw block bytes written by process i
      proc_<i>.json  # block table: leaf path, global start, block shape, byte range
      commit_<i>     # per-process commit marker

Leaves are named by ``ddw_tpu``'s ``keystr`` paths of its ``TrainState``
(``.params['head']['kernel']``, ``.opt_state.inner_state[0].mu[...]``,
``.opt_state.hyperparams['learning_rate']``, ``.step``; the EMA shadow at
``.opt_state.shadow[...]``), with shapes, dtypes and byte order as
``ddw_tpu`` writes them (:func:`state_leaves` maps the port's state onto
them). The format is raw bytes and JSON, so a checkpoint written by either
package restores in the other, and onto another world size: a requested
block is assembled from every saved block that overlaps it.

The commit protocol and the crash-consistency audit are ``ddw_tpu``'s:
process 0 creates ``step_<N>.tmp``; every process writes and fsyncs its
shard file, table and marker; process 0 waits for every marker, records
each shard file's byte count (``proc_bytes``) in ``index.json`` and renames
the directory. A step dir whose files do not match ``proc_bytes`` is
quarantined to ``step_<N>.torn<k>`` and the scan falls back to the previous
good step. :class:`ShardedCheckpointManager` can run the write half on a
background thread (``async_write``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import time
from collections import deque

import numpy as np
import torch

from ddw_tpu_torch.checkpoint.ckpt import (_apply_retention, _list_steps,
                                           _quarantine_step)
from ddw_tpu_torch.models.convert import flax_shape
from ddw_tpu_torch.parallel.sharding import P
from ddw_tpu_torch.runtime.dist import process_topology
from ddw_tpu_torch.runtime.faults import maybe_fault


def _fsync_write(path: str, write_fn, mode: str = "w") -> None:
    with open(path, mode) as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())


def _wait_for(pred, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"sharded checkpoint: timed out waiting for "
                               f"{what}")
        time.sleep(0.05)


# numpy stand-ins for the raw bytes of each dtype name on disk
_RAW = {"bfloat16": np.uint16}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if dtype_name == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


@dataclasses.dataclass
class Leaf:
    """One leaf of a TrainState as ``ddw_tpu`` checkpoints it: its path,
    the rules' match key, its kind (``param``, ``stat``, ``moment``,
    ``opt_scalar``, ``scalar``), the torch name of its parameter, the block
    this rank holds (port layout), its spec and global shape over flax dims
    and the layout maps."""

    path: str
    rule_key: str
    kind: str
    name: str | None
    tensor: torch.Tensor | None
    spec: P
    shape: tuple
    to_torch: object = None
    to_flax: object = None
    dtype: str = "float32"


def _fp(path: tuple) -> str:
    return "".join(f"['{p}']" for p in path)


def state_leaves(state, full: bool = False, clip: bool = False) -> list:
    """The leaves of a port TrainState under ``ddw_tpu``'s paths. With a
    placed state (``state.layout``) each holds this rank's block; ``full``
    leaves the tensors out (shapes and specs only). ``clip``: the optimizer
    clips by global norm (optax's chain moves its moments to
    ``inner_state[1][0]``)."""
    from ddw_tpu_torch.models.convert import flax_leaf_index

    lay = getattr(state, "layout", None)
    model = state.model
    index = flax_leaf_index(model)
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    meta = {}
    out = []

    def shape_of(name, t):
        if lay is not None and name in getattr(lay, "global_shapes", {}):
            return lay.global_shapes[name]
        return flax_shape(t.shape, index[name][4])

    for name, (coll, path, _, to_torch, to_flax) in index.items():
        t = tensors[name]
        kind = "param" if coll == "params" else "stat"
        spec = P()
        held = t.data if kind == "param" else t
        if lay is not None and kind == "param":
            spec = getattr(lay, "rest", {}).get(name, P())
            held = getattr(lay, "shards", {}).get(name, held)
        meta[name] = (path, to_torch, to_flax, shape_of(name, t))
        out.append(Leaf(f".{coll}{_fp(path)}", "/".join((coll,) + path),
                        kind, name, None if full else held, spec,
                        meta[name][3], to_torch, to_flax,
                        _dtype_name(held)))

    def moments(prefix: str, rule: str, key: str, tree: dict):
        for n, t in tree.items():
            path, to_torch, to_flax, shape = meta[n]
            spec = getattr(lay, "moment", {}).get(n, P())
            out.append(Leaf(f"{prefix}.{key}{_fp(path)}",
                            "/".join((rule, key) + path), "moment", n,
                            None if full else t, spec, shape, to_torch,
                            to_flax, _dtype_name(t)))

    def scalar(path: str, t: torch.Tensor, kind: str = "opt_scalar"):
        out.append(Leaf(path, path.strip(".").replace(".", "/"), kind, None,
                        None if full else t, P(), (),
                        dtype=_dtype_name(t)))

    def opt(tree: dict, prefix: str, rule: str):
        if "inner" in tree and "shadow" in tree:
            opt(tree["inner"], prefix + ".inner", rule + "/inner")
            moments(prefix, rule, "shadow", tree["shadow"])
            return
        scalar(prefix + ".count", tree["count"])
        scalar(prefix + ".hyperparams['learning_rate']",
               tree["learning_rate"])
        inner = prefix + ".inner_state" + ("[1][0]" if clip else "[0]")
        irule = rule + ("/inner_state/1/0" if clip else "/inner_state/0")
        if "mu" in tree:
            scalar(inner + ".count", tree["count"])
        for key in ("mu", "nu", "e_g", "e_x", "trace"):
            if key in tree:
                moments(inner, irule, key, tree[key])

    opt(state.opt_state, ".opt_state", "opt_state")
    out.append(Leaf(".step", "step", "scalar", None,
                    None if full else torch.tensor(int(state.step),
                                                   dtype=torch.int32),
                    P(), (), dtype="int32"))
    return out


def _block_start(leaf: Leaf, mesh) -> list[int]:
    start = [0] * len(leaf.shape)
    for fd, axis in enumerate(leaf.spec):
        if axis is None:
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        n, idx = 1, 0
        for a in names:
            idx = idx * mesh.shape[a] + mesh.axis_index(a)
            n *= mesh.shape[a]
        start[fd] = idx * (leaf.shape[fd] // n)
    return start


def _first_replica(leaf: Leaf, lay, pid: int) -> bool:
    if lay is None:
        return pid == 0
    if hasattr(lay, "writes"):      # a pipeline stage's own blocks
        return lay.writes(leaf)
    mesh = lay.mesh
    used = set()
    for a in leaf.spec:
        if a is not None:
            used.update(a if isinstance(a, tuple) else (a,))
    return all(mesh.axis_index(a) == 0 for a in mesh.axis_names
               if a not in used)


class ShardSnapshot:
    """A host copy of everything one process contributes to a sharded
    checkpoint, taken at the chain boundary and written later by
    :func:`write_snapshot` on any thread."""

    __slots__ = ("entries", "leaves_meta", "blobs", "pid", "nproc")

    def __init__(self, entries, leaves_meta, blobs, pid, nproc):
        self.entries = entries
        self.leaves_meta = leaves_meta
        self.blobs = blobs
        self.pid = pid
        self.nproc = nproc


def snapshot_shards(state, clip: bool = False) -> ShardSnapshot:
    """Copy this process's blocks (first replica only) to host memory, in
    the flax layout."""
    pid, nproc = process_topology()
    lay = getattr(state, "layout", None)
    mesh = lay.mesh if lay is not None else None
    entries, leaves_meta, blobs = [], {}, []
    offset = 0
    for leaf in state_leaves(state, clip=clip):
        leaves_meta[leaf.path] = {"shape": list(leaf.shape),
                                  "dtype": leaf.dtype}
        if not _first_replica(leaf, lay, pid):
            continue
        data = _to_numpy(leaf.tensor)
        if leaf.to_flax is not None:
            data = leaf.to_flax(data)
        raw = np.ascontiguousarray(data).tobytes()
        entries.append({"leaf": leaf.path,
                        "start": _block_start(leaf, mesh) if mesh else
                        [0] * len(leaf.shape),
                        "shape": list(data.shape), "offset": offset,
                        "nbytes": len(raw)})
        blobs.append(raw)
        offset += len(raw)
    return ShardSnapshot(entries, leaves_meta, blobs, pid, nproc)


def write_snapshot(ckpt_dir: str, snap: ShardSnapshot, step: int,
                   metadata: dict | None = None, keep: int = 3,
                   timeout_s: float = 300.0) -> str:
    """The disk half of the collective save: one process's snapshot
    through the whole commit protocol. Pure host work."""
    pid, nproc = snap.pid, snap.nproc
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    maybe_fault("ckpt_async", step=step, ckpt_dir=ckpt_dir)
    if pid == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    else:
        _wait_for(lambda: os.path.isdir(tmp), timeout_s,
                  f"writer to create {tmp}")
    bin_partial = os.path.join(tmp, f"proc_{pid}.bin.partial")
    with open(bin_partial, "wb") as f:
        for raw in snap.blobs:
            f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(bin_partial, os.path.join(tmp, f"proc_{pid}.bin"))
    _fsync_write(os.path.join(tmp, f"proc_{pid}.json.partial"),
                 lambda f: json.dump({"entries": snap.entries}, f))
    os.replace(os.path.join(tmp, f"proc_{pid}.json.partial"),
               os.path.join(tmp, f"proc_{pid}.json"))
    _fsync_write(os.path.join(tmp, f"commit_{pid}"), lambda f: f.write("ok"))
    if pid == 0:
        _wait_for(
            lambda: all(os.path.exists(os.path.join(tmp, f"commit_{i}"))
                        for i in range(nproc)),
            timeout_s, f"all {nproc} commit markers in {tmp}")
        proc_bytes = {
            str(i): os.path.getsize(os.path.join(tmp, f"proc_{i}.bin"))
            for i in range(nproc)}
        _fsync_write(
            os.path.join(tmp, "index.json"),
            lambda f: json.dump({"step": step, "created_unix": time.time(),
                                 "n_processes": nproc,
                                 "proc_bytes": proc_bytes,
                                 "metadata": metadata or {},
                                 "leaves": snap.leaves_meta}, f, indent=2))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _apply_retention(ckpt_dir, keep)
    else:
        _wait_for(lambda: os.path.isdir(final), timeout_s,
                  f"writer to commit {final}")
    return final


def save_sharded(ckpt_dir: str, state, step: int,
                 metadata: dict | None = None, keep: int = 3,
                 timeout_s: float = 300.0, clip: bool = False) -> str:
    """Collective save: every process calls it with the same ``step``.
    Returns the final path once it is committed."""
    return write_snapshot(ckpt_dir, snapshot_shards(state, clip), step,
                          metadata, keep, timeout_s)


class _ShardReader:
    """Assembles any block of one leaf from its saved blocks, reading only
    the byte ranges that overlap the request."""

    def __init__(self, dirp: str, shards: list[dict], shape, dtype: str):
        self.dirp, self.shards = dirp, shards
        self.shape, self.dtype = tuple(shape), dtype
        self.np_dtype = np.dtype(_RAW.get(dtype, dtype))
        self._files: dict[str, object] = {}

    def _file(self, name: str):
        f = self._files.get(name)
        if f is None:
            f = self._files[name] = open(os.path.join(self.dirp, name), "rb")
        return f

    def read(self, index) -> np.ndarray:
        req = [sl.indices(d)[:2] for sl, d in zip(index, self.shape)]
        out_shape = [stop - start for start, stop in req]
        out = np.empty(out_shape, self.np_dtype)
        filled = 0
        for e in self.shards:
            inter = []
            for (rs, re_), ss, sdim in zip(req, e["start"], e["shape"]):
                lo, hi = max(rs, ss), min(re_, ss + sdim)
                if lo >= hi:
                    inter = None
                    break
                inter.append((lo, hi, ss, rs))
            if inter is None and self.shape:
                continue
            f = self._file(e["file"])
            f.seek(e["offset"])
            src = np.frombuffer(f.read(e["nbytes"]), self.np_dtype).reshape(
                e["shape"])
            if not self.shape:
                return src.reshape(())
            src_sl = tuple(slice(lo - ss, hi - ss) for lo, hi, ss, _ in inter)
            dst_sl = tuple(slice(lo - rs, hi - rs) for lo, hi, _, rs in inter)
            out[dst_sl] = src[src_sl]
            filled += int(np.prod([hi - lo for lo, hi, _, _ in inter]))
        if filled != int(np.prod(out_shape)):
            raise ValueError(
                f"saved shards cover only {filled}/{int(np.prod(out_shape))} "
                f"elements of the requested slice — incomplete checkpoint?")
        return out

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


def _sharded_step_complete(ckpt_dir: str, step: int) -> bool:
    """A step dir is usable iff ``index.json`` parses and every process's
    shard file and table are there, each shard file of the size recorded
    in ``proc_bytes``."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
    except (OSError, ValueError):
        return False
    nproc = index.get("n_processes")
    if not isinstance(nproc, int) or nproc < 1:
        return False
    proc_bytes = index.get("proc_bytes") or {}
    for i in range(nproc):
        binp = os.path.join(d, f"proc_{i}.bin")
        if not (os.path.isfile(binp)
                and os.path.isfile(os.path.join(d, f"proc_{i}.json"))):
            return False
        expect = proc_bytes.get(str(i))
        if expect is not None and os.path.getsize(binp) != expect:
            return False
    return True


def latest_complete_step(ckpt_dir: str) -> int | None:
    """Newest complete step; torn dirs on the way are quarantined (by
    process 0 only)."""
    for s in sorted(_list_steps(ckpt_dir), reverse=True):
        if _sharded_step_complete(ckpt_dir, s):
            return s
        if process_topology()[0] == 0:
            _quarantine_step(ckpt_dir, s)
    return None


@torch.no_grad()
def restore_sharded(ckpt_dir: str, target, step: int | None = None,
                    clip: bool = False):
    """Restore into ``target`` (a port TrainState, placed or not) in place:
    each rank reads only the blocks its layout holds. Returns ``(state,
    step)``, or ``(target, None)`` when no checkpoint exists. With
    ``step=None`` torn dirs are quarantined and the newest complete step is
    used; a named torn step raises."""
    if step is None:
        step = latest_complete_step(ckpt_dir)
        if step is None:
            return target, None
    elif not _sharded_step_complete(ckpt_dir, step):
        quarantined = (_quarantine_step(ckpt_dir, step)
                       if process_topology()[0] == 0 else None)
        raise FileNotFoundError(
            f"sharded checkpoint step {step} in {ckpt_dir} is missing or torn"
            + (f" (quarantined to {quarantined})" if quarantined else "")
            + "; pass step=None to fall back to the newest good checkpoint")
    dirp = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(dirp, "index.json")) as f:
        index = json.load(f)
    by_leaf: dict[str, list[dict]] = {}
    for i in range(index["n_processes"]):
        with open(os.path.join(dirp, f"proc_{i}.json")) as f:
            for e in json.load(f)["entries"]:
                e["file"] = f"proc_{i}.bin"
                by_leaf.setdefault(e["leaf"], []).append(e)
    lay = getattr(target, "layout", None)
    mesh = lay.mesh if lay is not None else None
    readers = []
    try:
        for leaf in state_leaves(target, clip=clip):
            meta = index["leaves"].get(leaf.path)
            if meta is None:
                raise KeyError(f"checkpoint has no leaf {leaf.path!r}")
            shape = tuple(meta["shape"])
            if shape != tuple(leaf.shape):
                raise ValueError(f"{leaf.path}: target shape {leaf.shape} "
                                 f"!= saved {shape}")
            reader = _ShardReader(dirp, by_leaf.get(leaf.path, []), shape,
                                  meta["dtype"])
            readers.append(reader)
            start = _block_start(leaf, mesh) if mesh else [0] * len(shape)
            held = flax_shape(leaf.tensor.shape, leaf.to_flax)
            block = _to_port(leaf, reader.read(tuple(
                slice(s, s + n) for s, n in zip(start, held))),
                meta["dtype"])
            if leaf.kind == "scalar":
                target.step = int(block)
            else:
                leaf.tensor.copy_(block.to(leaf.tensor.dtype))
    finally:
        for r in readers:
            r.close()
    return target, step


def _to_port(leaf: Leaf, arr: np.ndarray, dtype: str) -> torch.Tensor:
    if leaf.to_torch is not None:
        arr = leaf.to_torch(arr)
    return _from_numpy(np.asarray(arr), dtype)


def read_metadata(ckpt_dir: str, step: int | None = None) -> dict | None:
    if step is None:
        step = latest_complete_step(ckpt_dir)
        if step is None:
            return None
    with open(os.path.join(ckpt_dir, f"step_{step:010d}", "index.json")) as f:
        return json.load(f)


class ShardedCheckpointManager:
    """Directory and retention binding for the sharded format, with
    :class:`~ddw_tpu_torch.checkpoint.ckpt.CheckpointManager`'s surface.
    Save is collective; restore reads only the local blocks.
    ``async_write=True`` snapshots the blocks to host at :meth:`save` and
    runs the commit protocol on a per-process background writer, at most
    ``max_inflight`` steps outstanding; a writer's error surfaces at the
    next ``save`` / ``wait``."""

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 async_write: bool = False, max_inflight: int = 1,
                 clip: bool = False):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.ckpt_dir, self.keep, self.clip = ckpt_dir, keep, clip
        self.max_inflight = max_inflight
        self._pending: deque = deque()
        self._executor = None
        if async_write:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sharded-ckpt-writer")

    def _reap(self, max_left: int) -> None:
        while self._pending and (self._pending[0].done()
                                 or len(self._pending) > max_left):
            self._pending.popleft().result()

    def save(self, state, step: int, metadata: dict | None = None) -> str:
        if self._executor is None:
            return save_sharded(self.ckpt_dir, state, step, metadata,
                                self.keep, clip=self.clip)
        self._reap(self.max_inflight - 1)
        snap = snapshot_shards(state, self.clip)
        self._pending.append(self._executor.submit(
            write_snapshot, self.ckpt_dir, snap, step,
            copy.deepcopy(metadata), self.keep))
        return os.path.join(self.ckpt_dir, f"step_{step:010d}")

    def wait(self) -> None:
        self._reap(0)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def restore(self, target, step: int | None = None):
        self.wait()
        return restore_sharded(self.ckpt_dir, target, step, self.clip)

    def latest_step(self) -> int | None:
        self.wait()
        return latest_complete_step(self.ckpt_dir)

    def read_metadata(self, step: int | None = None) -> dict | None:
        self.wait()
        meta = read_metadata(self.ckpt_dir, step)
        return meta["metadata"] if meta else None
