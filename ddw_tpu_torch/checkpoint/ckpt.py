"""Step-indexed checkpoint / resume — the port of ``ddw_tpu.checkpoint.ckpt``.

The directory protocol is ``ddw_tpu``'s: ``<dir>/step_<N:010d>/`` holds
``state.msgpack`` and a ``metadata.json`` sidecar recording ``state_bytes``;
both are written into ``step_<N>.tmp``, fsynced, and published with one
``os.replace``; torn step directories are quarantined and restore falls back
to the newest good step; a retention policy keeps the newest K; only rank 0
writes; an async writer overlaps the write with training, at most
``max_inflight`` writes outstanding.

The state file is a msgpack map (``serving/_msgpack.py``, flax's encoding):

- ``params`` and ``batch_stats`` in flax layout (``models.convert``), so a
  checkpoint's weights go straight into ``save_packaged_model`` and read
  like ``ddw_tpu``'s;
- ``opt_state``, the port's optimizer state by parameter name (bf16 moments
  stored as f32, which is exact, and cast back on restore);
- ``step``.

``save_checkpoint`` takes a :class:`ddw_tpu_torch.train.step.TrainState` or
an already host-side tree (nested dicts of numpy arrays); restore into a
``TrainState`` loads it in place, restore with a dict target returns the
stored tree.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from ddw_tpu_torch.models.convert import load_flax_variables, to_flax_variables
from ddw_tpu_torch.runtime.dist import process_topology
from ddw_tpu_torch.serving import _msgpack


def _is_writer() -> bool:
    return process_topology()[0] == 0


def _to_host(tree):
    if isinstance(tree, dict):
        return {str(k): _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return tree


def state_to_host(state) -> dict:
    """A consistent host snapshot of a TrainState (or a host tree as is)."""
    if isinstance(state, dict):
        return state
    v = to_flax_variables(state.model)
    return {"params": v.get("params", {}),
            "batch_stats": v.get("batch_stats", {}),
            "opt_state": _to_host(state.opt_state),
            "step": int(state.step)}


@torch.no_grad()
def _copy_into(target: dict, tree: dict, path: str = "") -> None:
    if set(target) != set(tree):
        raise ValueError(f"checkpoint opt_state{path} does not match the "
                         f"optimizer: {sorted(set(target) ^ set(tree))[:5]}")
    for k, t in target.items():
        if isinstance(t, dict):
            _copy_into(t, tree[k], f"{path}/{k}")
        else:
            arr = np.asarray(tree[k])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"opt_state{path}/{k}: shape {arr.shape} "
                                 f"does not fit {tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr.copy()))


def _load_into(target, tree: dict):
    load_flax_variables(target.model, {"params": tree["params"],
                                       "batch_stats": tree["batch_stats"]})
    _copy_into(target.opt_state, tree["opt_state"])
    target.step = int(tree["step"])
    return target


def _write_host_state(ckpt_dir: str, host_state, step: int,
                      metadata: dict | None, keep: int) -> str:
    """The pure host-side write: serialize + atomic rename + retention.
    Runs on the caller's thread (sync mode) or the manager's writer thread
    (async mode) — takes only host arrays, never device handles.

    Crash-consistency discipline: every file lands
    fully inside the ``.tmp`` staging dir and is fsynced before the single
    ``os.replace`` publishes the step — a kill at any instant leaves either
    no ``step_N`` dir or a complete one. The metadata sidecar records the
    exact serialized byte count so readers can *detect* a torn dir (however
    produced — non-atomic writers, partial copies, filesystem loss) and
    quarantine it rather than poisoning resume."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    blob = _msgpack.packb(host_state)
    with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    meta = {"step": step, "created_unix": time.time(),
            "state_bytes": len(blob), **(metadata or {})}
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _apply_retention(ckpt_dir, keep)
    return final


def save_checkpoint(ckpt_dir: str, state, step: int, metadata: dict | None = None, keep: int = 3) -> str | None:
    """Write ``state`` at ``step``; rank-0 only (no-op elsewhere). Atomic via
    tmp-dir + rename. Returns the checkpoint path on the writer, None elsewhere."""
    if not _is_writer():
        return None
    return _write_host_state(ckpt_dir, state_to_host(state), step, metadata,
                             keep)


def _apply_retention(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[len("step_"):]))
            except ValueError:
                pass  # also skips quarantined "step_N.torn<k>" dirs
    return out


def _step_dir_complete(ckpt_dir: str, step: int) -> bool:
    """Torn-write detector: a step dir is usable iff both files are present,
    the metadata parses, and (when the writer recorded it) the state file's
    size matches the serialized byte count. Atomically-published dirs always
    pass; partial dirs from non-atomic writers, kills mid-copy, or filesystem
    loss fail."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    state_path = os.path.join(d, "state.msgpack")
    meta_path = os.path.join(d, "metadata.json")
    if not (os.path.isfile(state_path) and os.path.isfile(meta_path)):
        return False
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except Exception:
        return False
    expect = meta.get("state_bytes")
    if expect is not None and os.path.getsize(state_path) != expect:
        return False
    return True


def _quarantine_step(ckpt_dir: str, step: int) -> str | None:
    """Move a torn ``step_N`` dir aside (``step_N.torn<k>``) so it stops
    shadowing older good checkpoints; kept for forensics, invisible to
    ``_list_steps``. Concurrent quarantines of the same dir race benignly —
    one rename wins, the loser's OSError is swallowed."""
    src = os.path.join(ckpt_dir, f"step_{step:010d}")
    for k in range(100):
        dst = f"{src}.torn{k}"
        if os.path.exists(dst):
            continue
        try:
            os.replace(src, dst)
            return dst
        except OSError:
            return None
    return None


def latest_step(ckpt_dir: str) -> int | None:
    """Newest *complete* step. Torn step dirs encountered on the way are
    quarantined — a kill mid-write (or a torn copy) must never poison resume;
    the scan falls back to the previous good step."""
    for s in sorted(_list_steps(ckpt_dir), reverse=True):
        if _step_dir_complete(ckpt_dir, s):
            return s
        _quarantine_step(ckpt_dir, s)
    return None


def restore_checkpoint(ckpt_dir: str, target, step: int | None = None):
    """Restore into ``target`` (a TrainState, loaded in place; a dict target
    gets the stored tree). Every rank reads the same file — identical
    restore replaces the rank-0 broadcast. Returns
    (state, step) or (target, None) when no checkpoint exists. With
    ``step=None`` torn step dirs are quarantined and the newest good step is
    used; an explicitly requested torn step raises (the caller named a
    checkpoint that does not usably exist)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return target, None
    elif not _step_dir_complete(ckpt_dir, step):
        quarantined = _quarantine_step(ckpt_dir, step)
        raise FileNotFoundError(
            f"checkpoint step {step} in {ckpt_dir} is missing or torn"
            + (f" (quarantined to {quarantined})" if quarantined else "")
            + "; pass step=None to fall back to the newest good checkpoint")
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "state.msgpack")
    with open(path, "rb") as f:
        tree = _msgpack.unpackb(f.read())
    if isinstance(target, dict):
        return tree, step
    return _load_into(target, tree), step


class CheckpointManager:
    """Convenience wrapper binding a directory + retention policy.

    ``async_write=True``: ``save`` fetches the state to host
    synchronously (a consistent snapshot — training may donate/overwrite the
    device buffers immediately after), then serializes + writes on a single
    background thread, so msgpack encoding and disk IO overlap the next
    epoch's compute instead of stalling the train loop. ``max_inflight``
    bounds the write queue: a ``save`` blocks only while MORE than that many
    writes are outstanding (depth 1 = join-previous-before-new, the
    strictest cadence; the trainers default to 2 so one slow fsync never
    stalls a chain boundary, see ``TrainCfg.async_checkpoint_inflight``).
    Writes retire in submission order on the single writer thread, so
    retention and ``latest_step`` stay coherent. Deferred background errors
    are never swallowed: every ``save`` first reaps finished writes and
    re-raises the oldest failure, and every read-side method (plus
    :meth:`wait`, which the trainers call before returning) drains the
    queue fully.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 async_write: bool = False, max_inflight: int = 1):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = max_inflight
        self._executor = None
        from collections import deque

        self._pending = deque()
        if async_write and _is_writer():
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")

    def _reap(self, max_left: int) -> None:
        """Retire finished writes (surfacing any deferred error at THIS
        boundary) and block until at most ``max_left`` remain in flight."""
        while self._pending and (self._pending[0].done()
                                 or len(self._pending) > max_left):
            self._pending.popleft().result()

    def save(self, state, step: int, metadata: dict | None = None):
        if self._executor is None:
            return save_checkpoint(self.ckpt_dir, state, step, metadata, self.keep)
        # Surface finished writes' errors now; block only past the bound.
        self._reap(self.max_inflight - 1)
        host_state = state_to_host(state)  # snapshot before buffers mutate
        # Deep-copy metadata too: the caller may reuse/mutate its dict before
        # the writer thread serializes it.
        import copy

        self._pending.append(self._executor.submit(
            _write_host_state, self.ckpt_dir, host_state, step,
            copy.deepcopy(metadata), self.keep))
        return os.path.join(self.ckpt_dir, f"step_{step:010d}")

    def wait(self) -> None:
        """Block until every in-flight async write is durable on disk;
        re-raises the oldest background write error."""
        self._reap(0)

    def close(self) -> None:
        """Join the in-flight writes and release the writer thread. The
        manager stays usable — subsequent saves fall back to synchronous
        writes. A deferred write error still surfaces (after the thread is
        released)."""
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def restore(self, target, step: int | None = None):
        self.wait()
        return restore_checkpoint(self.ckpt_dir, target, step)

    def latest_step(self):
        self.wait()
        return latest_step(self.ckpt_dir)

    def read_metadata(self, step: int | None = None) -> dict | None:
        """The JSON metadata sidecar saved with a checkpoint (epoch, metrics,
        and the host-side callback counters a true resume needs)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        path = os.path.join(self.ckpt_dir, f"step_{step:010d}", "metadata.json")
        with open(path) as f:
            return json.load(f)


class BestCheckpointKeeper:
    """Keep the single best-``val_loss`` checkpoint under ``<dir>/best``.

    The main checkpoint stream is a resume mechanism with a newest-K
    retention policy — an old best would be pruned. Model *selection* (the
    reference picks its production model by best metric,
    ``01_hyperopt_single_machine_model.py:253-262``) therefore lives in its
    own single-slot directory: whenever an epoch's ``val_loss`` beats every
    previous one (including across resumes — the slot's own metadata seeds
    the bar), the state is saved there with the epoch's metrics.

    ``make_manager(dir)`` builds the underlying manager.
    """

    def __init__(self, ckpt_dir: str, make_manager=None):
        make_manager = make_manager or (
            lambda d: CheckpointManager(d, keep=1))
        self._mgr = make_manager(os.path.join(ckpt_dir, "best"))
        # The slot is indexed by its own monotonic counter, NOT the train
        # step: retention prunes by step order, and a new best written at a
        # LOWER train step than a stale slot (fresh run into an old dir)
        # would otherwise be the one deleted. The true train step rides in
        # metadata.
        self._slot = self._mgr.latest_step() or 0
        meta = self._mgr.read_metadata() if self._slot else None
        self.best_val_loss = ((meta or {}).get("metrics") or {}).get(
            "val_loss", float("inf"))

    def maybe_save(self, state, step: int, metrics: dict,
                   extra_metadata: dict | None = None) -> bool:
        """Save iff this epoch's val_loss is a strict new best; returns
        whether it saved. NaN never qualifies (and never poisons the bar —
        ``not (nan < x)`` keeps refusing)."""
        if not (metrics["val_loss"] < self.best_val_loss):
            return False
        self.best_val_loss = metrics["val_loss"]
        self._slot += 1
        self._mgr.save(state, self._slot,
                       metadata={**(extra_metadata or {}),
                                 "train_step": int(step),
                                 "metrics": dict(metrics)})
        return True

    def restore(self, target):
        """Restore the best slot into ``target``; returns ``(state, slot)``
        (the training step is in ``read_metadata()['train_step']``)."""
        return self._mgr.restore(target)

    def read_metadata(self):
        return self._mgr.read_metadata()

    def close(self) -> None:
        self._mgr.close()
