"""Pluggable spawn transports — WHERE a :class:`ProcessReplica` child runs.

One gateway fronting replicas on other machines needs exactly three things
from the machine a child spawns on: the checkpoint directory must exist
there before the child boots (**stage**), the worker process must start
there with the right argv/env and its output captured (**popen**), and the
parent must read the child's port-file handshake from there
(**read_file**). This module makes that triple a duck type so
:class:`~ddw_tpu_torch.deploy.ProcessReplica` never knows whether its child is
local or remote:

- :class:`LocalExecTransport` — the default and the TESTABLE driver: plain
  ``subprocess.Popen`` on this box. With a ``staging_root`` it genuinely
  copies the checkpoint dir into a digest-keyed staging area first (skipped
  when the staged copy is already current), so the full remote code path —
  stage, spawn from the staged dir, handshake through the transport — runs
  end-to-end in CI with no second machine.
- :class:`SSHTransport` — the production shape: ``scp -r`` the checkpoint
  into the remote staging root, launch the worker through ``ssh`` with a
  whitelisted env prefix (``DDW_*``: ``ddw_tpu`` also forwards ``JAX_*`` /
  ``XLA_*``, platform pins this package does not read; the child's device
  travels as ``--device``), and ``ssh ... cat`` the port
  file. The child binds ``0.0.0.0`` and the parent connects to the spawn
  host. Process control rides the SSH session: killing the local client
  closes the channel and sshd tears down the remote process group, so
  ``stop()``/``force_fail()`` keep their local semantics. Structured but
  necessarily exercised only by the local driver in CI.

The contract every driver honors (ProcessReplica's assumptions):

==============  ============================================================
``remote``       bool — True when the child runs on another machine (the
                 parent then connects to the spawn host, the child binds
                 all interfaces)
``stage(d)``     make directory ``d`` available on the target host; returns
                 the path valid THERE (may be ``d`` itself on a shared or
                 local filesystem). Idempotent and cheap when already
                 staged — it runs before EVERY (re)spawn.
``popen(...)``   start the worker; returns a ``subprocess.Popen`` whose
                 lifetime tracks the child's (waiting on it observes the
                 child's death; signalling it ends the child)
``read_file(p)`` the port-file handshake read; raises ``OSError`` (or
                 ``FileNotFoundError``) while the file does not exist yet
``probe(...)``   host liveness check (bounded by ``timeout_s``): True when
                 the target machine is reachable. The elastic launcher's
                 permanent-loss verdict uses it to distinguish a crashed
                 rank (respawn) from a lost host (shrink).
==============  ============================================================

The port of ``ddw_tpu.deploy.transport``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import hashlib
import os
import posixpath
import shlex
import shutil
import subprocess

__all__ = ["LocalExecTransport", "SSHTransport", "transport_for"]

# env vars forwarded to a remote child — the gang launcher's whitelist
# discipline: config (fault specs among it) crosses the wire, secrets do not
ENV_FORWARD_PREFIXES = ("DDW_",)

_LOCAL_HOSTS = (None, "", "local", "localhost", "127.0.0.1", "::1")


def _dir_digest(src_dir: str) -> str:
    """Cheap content fingerprint of a checkpoint dir: sha1 over the sorted
    (relpath, size, mtime_ns) manifest. Re-staging is skipped while it
    matches — a hash of the bytes themselves would re-read gigabytes of
    weights on every spawn for nothing."""
    h = hashlib.sha1()
    for root, dirs, files in sorted(os.walk(src_dir)):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            rel = os.path.relpath(path, src_dir)
            h.update(f"{rel}\0{st.st_size}\0{st.st_mtime_ns}\n".encode())
    return h.hexdigest()[:16]


class LocalExecTransport:
    """Spawn on this machine. Without a ``staging_root`` the checkpoint is
    used in place (shared-filesystem semantics); with one, ``stage`` copies
    it into ``<staging_root>/<basename>-<digest>/`` exactly as a remote
    driver would ship it — the one-box drill for the full remote path."""

    remote = False
    name = "local"

    def __init__(self, staging_root: str | None = None):
        self.staging_root = staging_root
        self.stages = 0             # directories actually copied
        self.stage_hits = 0         # stage calls satisfied by a current copy

    def stage(self, src_dir: str) -> str:
        if not src_dir or self.staging_root is None:
            return src_dir
        digest = _dir_digest(src_dir)
        dst = os.path.join(self.staging_root,
                           f"{os.path.basename(os.path.normpath(src_dir))}"
                           f"-{digest}")
        if os.path.isdir(dst):
            self.stage_hits += 1
            return dst
        tmp = f"{dst}.staging.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(self.staging_root, exist_ok=True)
        shutil.copytree(src_dir, tmp)
        try:
            # atomic publication: a parallel sibling staging the same digest
            # must never observe a half-copied checkpoint
            os.replace(tmp, dst)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # a sibling won the race
        self.stages += 1
        return dst

    def popen(self, cmd, env: dict, log_path: str) -> subprocess.Popen:
        with open(log_path, "ab") as log:
            return subprocess.Popen(cmd, env=env, stdout=log, stderr=log)

    def read_file(self, path: str) -> str:
        with open(path) as f:
            return f.read()

    def probe(self, timeout_s: float = 5.0) -> bool:
        """Host liveness: this machine is running this code."""
        return True

    def describe(self) -> dict:
        return {"driver": self.name, "staging_root": self.staging_root,
                "stages": self.stages, "stage_hits": self.stage_hits}


class SSHTransport:
    """Spawn on ``host`` over SSH. The worker module must be importable by
    ``python`` on the remote (same-image fleet assumption — the gang
    launcher's); checkpoints are shipped with ``scp -r`` into
    ``staging_root`` keyed by content digest, so respawns and same-digest
    siblings reuse the copy."""

    remote = True
    name = "ssh"

    def __init__(self, host: str, user: str | None = None,
                 python: str = "python3",
                 staging_root: str = "/tmp/ddw-staging",
                 ssh=("ssh", "-o", "BatchMode=yes"),
                 scp=("scp", "-q", "-r"), connect_timeout_s: float = 20.0):
        self.host = host
        self.user = user
        self.python = python
        self.staging_root = staging_root
        self.ssh = tuple(ssh)
        self.scp = tuple(scp)
        self.connect_timeout_s = connect_timeout_s
        self.stages = 0
        self.stage_hits = 0

    def _target(self) -> str:
        return f"{self.user}@{self.host}" if self.user else self.host

    def _run(self, argv, timeout_s: float | None = None
             ) -> subprocess.CompletedProcess:
        return subprocess.run(
            argv, capture_output=True,
            timeout=timeout_s or self.connect_timeout_s)

    def stage(self, src_dir: str) -> str:
        if not src_dir:
            return src_dir
        digest = _dir_digest(src_dir)
        base = os.path.basename(os.path.normpath(src_dir))
        dst = posixpath.join(self.staging_root, f"{base}-{digest}")
        probe = self._run(list(self.ssh) + [self._target(),
                                            f"test -d {shlex.quote(dst)}"])
        if probe.returncode == 0:
            self.stage_hits += 1
            return dst
        mk = self._run(list(self.ssh) + [
            self._target(), f"mkdir -p {shlex.quote(self.staging_root)}"])
        if mk.returncode != 0:
            raise OSError(f"ssh mkdir on {self._target()} failed: "
                          f"{mk.stderr.decode(errors='replace')[-500:]}")
        # ship into a tmp name, mv into place: a parallel sibling staging
        # the same digest must never observe a half-copied checkpoint
        tmp = f"{dst}.staging.{os.getpid()}"
        cp = self._run(list(self.scp) + [src_dir, f"{self._target()}:{tmp}"],
                       timeout_s=max(self.connect_timeout_s, 600.0))
        if cp.returncode != 0:
            raise OSError(f"scp to {self._target()} failed: "
                          f"{cp.stderr.decode(errors='replace')[-500:]}")
        self._run(list(self.ssh) + [
            self._target(),
            f"mv -T {shlex.quote(tmp)} {shlex.quote(dst)} 2>/dev/null "
            f"|| rm -rf {shlex.quote(tmp)}"])
        self.stages += 1
        return dst

    def popen(self, cmd, env: dict, log_path: str) -> subprocess.Popen:
        # cmd[0] is the PARENT's sys.executable — replace it with the
        # remote interpreter; forward only the whitelisted env prefixes
        argv = [self.python] + list(cmd[1:])
        pairs = [f"{k}={shlex.quote(v)}" for k, v in sorted(env.items())
                 if k.startswith(ENV_FORWARD_PREFIXES)]
        remote_cmd = " ".join(
            ["exec", "env"] + pairs + [shlex.quote(a) for a in argv])
        with open(log_path, "ab") as log:
            # the SSH session IS the process handle: the channel's death
            # (local SIGTERM/SIGKILL on this Popen) tears down the remote
            # process group via sshd, so the parent's signal discipline
            # keeps working unchanged
            return subprocess.Popen(list(self.ssh) + [self._target(),
                                                      remote_cmd],
                                    stdout=log, stderr=log)

    def read_file(self, path: str) -> str:
        out = self._run(list(self.ssh) + [self._target(),
                                          f"cat {shlex.quote(path)}"])
        if out.returncode != 0:
            raise FileNotFoundError(path)
        return out.stdout.decode()

    def probe(self, timeout_s: float = 5.0) -> bool:
        """Host liveness: can an SSH session still reach the box? The
        elastic launcher's permanent-loss verdict calls this before choosing
        shrink over respawn — an unreachable host means its rank is gone for
        good, not merely crashed."""
        try:
            out = self._run(list(self.ssh) + [self._target(), "true"],
                            timeout_s=timeout_s)
        except (OSError, subprocess.SubprocessError):
            return False
        return out.returncode == 0

    def describe(self) -> dict:
        return {"driver": self.name, "host": self._target(),
                "staging_root": self.staging_root, "stages": self.stages,
                "stage_hits": self.stage_hits}


def transport_for(host: str | None = None,
                  staging_root: str | None = None, **kw):
    """The driver for ``host``: local machines (None/localhost forms) get
    :class:`LocalExecTransport`, anything else :class:`SSHTransport`.
    ``kw`` passes through to the SSH driver."""
    if host in _LOCAL_HOSTS:
        return LocalExecTransport(staging_root=staging_root)
    if staging_root is not None:
        kw.setdefault("staging_root", staging_root)
    return SSHTransport(host, **kw)
