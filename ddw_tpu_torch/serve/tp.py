"""Tensor-parallel serving across rank processes (port-only; ``ddw_tpu``
runs it in one process under GSPMD, ``ddw_tpu/serve/blocks.py:192-240``).

``ddw_tpu`` serves a ``tp``-wide replica from one process that drives ``tp``
devices: the paged programs compile under a model-axis mesh and XLA inserts
the collectives. The port runs one process per device, so a ``tp``-wide
replica is ``tp`` rank processes joined by the replica's ``model`` group:

- **rank 0 schedules.** Admission, the block allocator, the prefix cache,
  copy-on-write, preemption, picks and streams are host logic of the engine
  on rank 0, blind to the mesh, as in ``ddw_tpu``.
- **ranks 1..tp-1 follow.** Every device program of a tensor-parallel
  :class:`~ddw_tpu_torch.serve.blocks.BlockPool` is one *dispatch*: rank 0
  broadcasts a small header over the group, the op and its host arguments
  (rows' block tables, depths, suffixes, temperatures, per-row seeds), then
  runs its shard; each follower receives the header and runs the same
  program on its shard (:func:`follow`). The model's collectives (the
  row-parallel sums, the vocab gather) pair up inside the program.
- **every rank picks.** The head's logits are gathered, so every rank holds
  the same bytes, and the per-row generators are seeded from the header's
  seeds: a decode chain of ``steps_per_tick`` steps needs no broadcast per
  step (``ddw_tpu``'s "sampling folds see byte-identical logits on every
  shard").

Messages, each a pickled tuple broadcast from group rank 0 (the group is
the replica's own, on this host):

- ``("build", pool_id, spec)``: a new pool — the model's constructor
  arguments and the pool's geometry; then rank 0 sends each follower its
  shard of every weight, point to point (:func:`send_tensors`), so no file
  is needed;
- ``("pool", pool_id, op, args)``: one device program of that pool;
- ``("close",)``: the follower leaves :func:`follow`; both sides then end
  the group together (:func:`_end_group`) and the follower exits.

:class:`TPGroup` is the replica-private group an engine builds for
``EngineCfg(tp=N)`` without a mesh: a gloo group over its own
``TCPStore`` on a port it binds itself (never the default group, so two
such engines share a process, and one runs inside a launcher rank), and
``N - 1`` follower processes, ``python -m ddw_tpu_torch.serve.tp``. A
follower exits on ``close``, when a receive from rank 0 fails, and when
its parent dies (``PR_SET_PDEATHSIG``), so a SIGKILLed replica leaves no
process holding the card. A follower that dies fails rank 0's next
dispatch with :class:`TPGroupFailed`: the engine goes ``failed`` and every
future resolves with ``ReplicaFailed``.

The header and the shards travel in host memory (gloo); the model's
collectives take CUDA tensors as they are. The model group must be gloo.
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import datetime
import gc
import itertools
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import weakref

import torch
import torch.distributed as dist

from ddw_tpu_torch.runtime.faults import ServeCrash
from ddw_tpu_torch.runtime.mesh import MODEL_AXIS, Mesh

_READY = "ddw_tp/ready/{}"
GROUP_TIMEOUT_S = 300.0     # bounds every collective of a replica's group
START_TIMEOUT_S = 180.0     # a follower's spawn to its joining the group
# a follower waits for rank 0's next header as long as both live: an idle
# replica sends nothing, and a dead rank 0 ends the wait with an error
_HEADER_WAIT = datetime.timedelta(days=365)
_POOL_IDS = itertools.count(1)
_BROKEN: "weakref.WeakSet" = weakref.WeakSet()   # groups out of step
_OWNERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#                                       group -> weakref to its TPGroup


class TPGroupFailed(ServeCrash):
    """A tensor-parallel dispatch could not complete: a follower died, or
    a rank left the group out of step. Terminal for the replica (the ranks
    no longer agree on which program runs next): the engine fails every
    future with ``ReplicaFailed``; a restart builds new followers."""

    serve_kind = "tp_group"


def next_pool_id() -> int:
    return next(_POOL_IDS)


def mark_broken(group) -> None:
    """A dispatch over ``group`` failed part way: no later one may run."""
    _BROKEN.add(group)


def check_group(group) -> None:
    """Raise :class:`TPGroupFailed` when ``group`` failed a dispatch
    earlier, or when a follower its :class:`TPGroup` started has exited."""
    if group in _BROKEN:
        raise TPGroupFailed("the tensor-parallel group failed an earlier "
                            "dispatch; the replica must be restarted")
    ref = _OWNERS.get(group)
    owner = ref() if ref is not None else None
    if owner is not None:
        owner.check_alive()


def _bcast_opts(timeout: datetime.timedelta | None = None):
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    opts.rootTensor = 0
    if timeout is not None:
        opts.timeout = timeout
    return opts


def send_header(group, msg) -> None:
    """Group rank 0: broadcast ``msg`` (pickled) to the followers."""
    data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    group.broadcast([torch.tensor([len(data)], dtype=torch.int64)],
                    _bcast_opts()).wait()
    group.broadcast([torch.frombuffer(bytearray(data), dtype=torch.uint8)],
                    _bcast_opts()).wait()


def recv_header(group):
    """A follower: the next message rank 0 broadcast (waits as long as
    rank 0 lives)."""
    n = torch.zeros(1, dtype=torch.int64)
    group.broadcast([n], _bcast_opts(_HEADER_WAIT)).wait()
    buf = torch.empty(int(n.item()), dtype=torch.uint8)
    group.broadcast([buf], _bcast_opts()).wait()
    return pickle.loads(buf.numpy().tobytes())


def send_tensors(group, dst: int, tensors) -> None:
    """Send ``tensors`` to group rank ``dst`` as one host buffer (their raw
    bytes, in order)."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
            for t in tensors if t.numel()]
    if flat:
        group.send([torch.cat(flat)], dst, 0).wait()


def recv_tensors(group, src: int, like) -> list[torch.Tensor]:
    """Receive what :func:`send_tensors` sent, as host tensors of the
    shapes and dtypes of ``like``."""
    sizes = [t.numel() * t.element_size() for t in like]
    buf = torch.empty(sum(sizes), dtype=torch.uint8)
    if buf.numel():
        group.recv([buf], src, 0).wait()
    out, off = [], 0
    for t, n in zip(like, sizes):
        out.append(buf[off:off + n].view(t.dtype).reshape(t.shape))
        off += n
    return out


def follow(mesh: Mesh, device) -> int:
    """A follower's loop over ``mesh``'s model group: build the pools rank
    0 builds, run every program rank 0 dispatches, return 0 on ``close``
    (1 when rank 0 is gone)."""
    from ddw_tpu_torch.serve.blocks import BlockPool

    group = mesh.group(MODEL_AXIS)
    device = torch.device(device)
    pools: dict[int, BlockPool] = {}
    with torch.no_grad():
        while True:
            try:
                msg = recv_header(group)
            except RuntimeError as e:
                print(f"ddw-tp-follower: rank 0 is gone ({e})",
                      file=sys.stderr, flush=True)
                return 1
            if msg[0] == "close":
                return 0
            if msg[0] == "build":
                _, pool_id, spec = msg
                pools[pool_id] = BlockPool.build_follower(spec, mesh, device)
                continue
            _, pool_id, op, args = msg
            pools[pool_id].run_program(op, args)
            if op == "close":
                del pools[pool_id]


def _end_group(pg, handshake: bool) -> None:
    """End ``pg``'s work before this process exits: with ``handshake`` (the
    ``close`` header went through), a barrier both sides reach, so neither
    rank tears down a connection the other still reads; then ``shutdown()``.
    A process that exits while a ``ProcessGroupGloo`` is still busy or alive
    can die in gloo's own teardown ("terminate called without an active
    exception"), after a clean close too. A follower then drops its last
    references to the group and its store while the interpreter is whole;
    on rank 0 the engine's mesh keeps the shut-down group."""
    if handshake:
        try:
            pg.barrier().wait()
        except RuntimeError:
            pass            # the other side died: its exit code says so
    pg.shutdown()


def _follower_log_tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _shutdown(procs: dict, grace_s: float) -> None:
    """Stop follower processes: wait ``grace_s`` for a clean exit, then
    kill the rest and reap them."""
    deadline = time.monotonic() + grace_s
    for p in procs.values():
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class TPGroup:
    """A replica-private ``tp``-wide model group: rank 0 is this process,
    ranks ``1..tp-1`` are follower processes it starts.

    ``device`` is rank 0's: followers go to ``cuda:r % device_count`` when
    it is a card, to the CPU only when it is the CPU; each takes this
    process's intra-op thread count. A follower that fails to start fails
    the construction with its log's path and tail. The follower logs go to
    ``log_dir``, else to a directory of their own that :meth:`close`
    removes once every follower has exited cleanly. ``start_s`` holds each
    follower's seconds from its spawn to joining the group."""

    def __init__(self, tp: int, device, log_dir: str | None = None):
        self.tp = tp
        self.device = torch.device(device)
        # port 0: the store binds a free port itself, so no other process
        # can take it between the choice and the bind
        host = "127.0.0.1"
        self.store = dist.TCPStore(
            host, 0, tp, True,
            timeout=datetime.timedelta(seconds=START_TIMEOUT_S),
            wait_for_workers=False)
        port = self.store.port
        self._own_log_dir = log_dir is None
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="ddw-tp-")
        self.procs: dict[int, subprocess.Popen] = {}
        self.log_paths: dict[int, str] = {}
        self.start_s: dict[int, float] = {}
        self._finalizer = weakref.finalize(self, _shutdown, self.procs, 5.0)
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        try:
            for r in range(1, tp):
                cmd = [sys.executable, "-m", "ddw_tpu_torch.serve.tp",
                       "--store", f"{host}:{port}", "--rank", str(r),
                       "--world", str(tp), "--device", self.device.type,
                       "--threads", str(torch.get_num_threads()),
                       "--parent-pid", str(os.getpid())]
                self.log_paths[r] = os.path.join(self.log_dir,
                                                 f"follower{r}.log")
                self.procs[r] = self._spawn(r, cmd, env)
            self._await_ready()
            self.pg = dist.ProcessGroupGloo(
                self.store, 0, tp,
                datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        except BaseException:
            self._finalizer()
            raise
        self.mesh = Mesh.over_group(self.pg, MODEL_AXIS)
        _OWNERS[self.pg] = weakref.ref(self)

    @property
    def broken(self) -> bool:
        return self.pg in _BROKEN

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self.procs.values()]

    def _spawn(self, r: int, cmd: list, env: dict) -> subprocess.Popen:
        """Start follower ``r`` from a thread that lives as long as the
        follower: the parent-death signal fires when the spawning THREAD
        ends, so it must not be a caller's short-lived one."""
        box: dict = {}
        started = threading.Event()

        def keeper():
            try:
                with open(self.log_paths[r], "wb") as log:
                    box["proc"] = subprocess.Popen(
                        cmd, stdin=subprocess.DEVNULL, stdout=log,
                        stderr=subprocess.STDOUT, env=env)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                box["error"] = e
                return
            finally:
                started.set()
            box["proc"].wait()

        threading.Thread(target=keeper, name=f"ddw-tp-follower{r}",
                         daemon=True).start()
        started.wait()
        if "error" in box:
            raise box["error"]
        return box["proc"]

    def _await_ready(self) -> None:
        waiting = set(self.procs)
        t0 = time.monotonic()
        deadline = t0 + START_TIMEOUT_S
        while waiting:
            for r in sorted(waiting):
                if self.store.check([_READY.format(r)]):
                    waiting.discard(r)
                    self.start_s[r] = time.monotonic() - t0
                elif self.procs[r].poll() is not None:
                    raise RuntimeError(
                        f"tensor-parallel follower rank {r} exited with code "
                        f"{self.procs[r].returncode} during startup; its log "
                        f"is {self.log_paths[r]}:\n"
                        f"{_follower_log_tail(self.log_paths[r])}")
            if waiting and time.monotonic() > deadline:
                r = min(waiting)
                raise RuntimeError(
                    f"tensor-parallel follower rank {r} did not join within "
                    f"{START_TIMEOUT_S} s; its log is {self.log_paths[r]}:\n"
                    f"{_follower_log_tail(self.log_paths[r])}")
            if waiting:
                time.sleep(0.02)

    def check_alive(self) -> None:
        """Raise :class:`TPGroupFailed` naming the first follower that has
        exited (and mark the group broken)."""
        for r, p in self.procs.items():
            if p.poll() is not None:
                mark_broken(self.pg)
                raise TPGroupFailed(
                    f"tensor-parallel follower rank {r} (pid {p.pid}) exited "
                    f"with code {p.returncode}; its log is "
                    f"{self.log_paths[r]}")

    @property
    def exit_codes(self) -> dict[int, int | None]:
        """Each follower's exit code by rank (None while it runs)."""
        return {r: p.poll() for r, p in self.procs.items()}

    def close(self, grace_s: float = 10.0) -> None:
        """Send ``close`` (when the group is sound) and end the group with
        the followers (:func:`_end_group`), wait for them to exit, kill what
        is left; remove the group's own log directory when every follower
        exited cleanly (a failure keeps the logs its error names).
        Idempotent."""
        if not self._finalizer.alive:
            return
        closed = False
        if not self.broken and all(p.poll() is None
                                   for p in self.procs.values()):
            try:
                send_header(self.pg, ("close",))
                closed = True
            except RuntimeError:
                pass
        self._finalizer.detach()
        if closed:
            # a broken group may still run a wedged thread's collective:
            # only a clean close ends it here
            _end_group(self.pg, handshake=True)
        _shutdown(self.procs, grace_s)
        mark_broken(self.pg)
        if self._own_log_dir and all(p.returncode == 0
                                     for p in self.procs.values()):
            shutil.rmtree(self.log_dir, ignore_errors=True)


def _die_with_parent(parent_pid: int) -> None:
    """Ask the kernel to SIGKILL this process when its parent dies
    (Linux; elsewhere the failed receive from rank 0 still ends it)."""
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        libc.prctl(1, signal.SIGKILL)           # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if parent_pid and os.getppid() != parent_pid:
        os._exit(1)                             # the parent is already gone


def main(argv=None) -> int:
    """``python -m ddw_tpu_torch.serve.tp --store HOST:PORT --rank R
    --world N --device cuda|cpu``: join the replica's group as rank ``R``
    and follow rank 0 until it closes the group."""
    p = argparse.ArgumentParser(prog="ddw-tp-follower")
    p.add_argument("--store", required=True, help="rank 0's TCPStore")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (rank r on cuda:r %% device_count) or 'cpu'")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--parent-pid", type=int, default=0)
    args = p.parse_args(argv)
    _die_with_parent(args.parent_pid)
    if args.threads > 0:
        torch.set_num_threads(args.threads)
    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("follower asked for a card and found none "
                               "(device='cpu' runs it on the CPU)")
        device = torch.device("cuda",
                              args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    host, port = args.store.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), args.world, False,
                          timeout=timeout)
    store.set(_READY.format(args.rank), "1")
    pg = dist.ProcessGroupGloo(store, args.rank, args.world, timeout)
    code = follow(Mesh.over_group(pg, MODEL_AXIS), device)
    # follow's pools are gone with it: the group and its store are this
    # frame's to end and free (rank 0 meets the barrier after ``close``)
    _end_group(pg, handshake=code == 0)
    del pg, store
    gc.collect()
    return code


if __name__ == "__main__":
    sys.exit(main())
