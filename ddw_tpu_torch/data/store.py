"""Sharded binary-record table store — the port's copy of
``ddw_tpu.data.store`` with the pure-Python DDWS framing only.

A table is a directory of fixed-schema shard files plus a JSON manifest;
versions are append-only ``vNNNN`` subdirectories with a ``latest`` pointer.
Shards written here read back in ``ddw_tpu`` and the reverse: the format is
the same byte for byte.

Shard file format (little-endian):
    magic ``DDWS`` | u32 format_version | u32 nrecords
    then per record: u32 path_len, path, u32 content_len, content,
                     u32 label_len, label, i32 label_idx   (label_idx -1 = unlabeled)

Several processes that share the store's filesystem write per-worker part
tables stamped with a run token (:meth:`TableStore.run_token`); the
coordinator waits for every part of this run (:meth:`TableStore.await_parts`)
and commits one table whose shards are the parts' files
(:meth:`TableStore.merge_shards`). Not yet ported: the native C++ codec.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import struct
import time
from typing import Iterable, Iterator

_MAGIC = b"DDWS"
_FORMAT_VERSION = 1


@dataclasses.dataclass
class RecordSchema:
    """Fixed schema shared by bronze (label empty, label_idx -1) and silver
    tables."""

    fields: tuple[str, ...] = ("path", "content", "label", "label_idx")


@dataclasses.dataclass
class Record:
    path: str
    content: bytes
    label: str = ""
    label_idx: int = -1


def _write_shard(path: str, records: list[Record]) -> dict:
    h = hashlib.sha256()
    with open(path, "wb") as f:
        head = _MAGIC + struct.pack("<II", _FORMAT_VERSION, len(records))
        f.write(head)
        h.update(head)
        for r in records:
            pb, lb = r.path.encode(), r.label.encode()
            buf = (
                struct.pack("<I", len(pb)) + pb
                + struct.pack("<I", len(r.content)) + r.content
                + struct.pack("<I", len(lb)) + lb
                + struct.pack("<i", r.label_idx)
            )
            f.write(buf)
            h.update(buf)
    return {
        "file": os.path.basename(path),
        "num_records": len(records),
        "bytes": os.path.getsize(path),
        "sha256": h.hexdigest(),
    }


def read_shard(path: str) -> Iterator[Record]:
    """Stream the records of one shard file."""
    yield from _walk_shard(path, full=True)


def read_shard_contents(path: str) -> Iterator[tuple[bytes, int]]:
    """Loader hot path: ``(content, label_idx)`` only, no path/label
    decoding."""
    yield from _walk_shard(path, full=False)


def _walk_shard(path: str, full: bool):
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != _MAGIC:
            raise ValueError(f"{path}: bad magic {head[:4]!r}")
        fmt, n = struct.unpack("<II", head[4:])
        if fmt != _FORMAT_VERSION:
            raise ValueError(f"{path}: unsupported format version {fmt}")
        for _ in range(n):
            (plen,) = struct.unpack("<I", f.read(4))
            p = f.read(plen).decode() if full else f.seek(plen, 1)
            (clen,) = struct.unpack("<I", f.read(4))
            content = f.read(clen)
            (llen,) = struct.unpack("<I", f.read(4))
            label = f.read(llen).decode() if full else f.seek(llen, 1)
            (idx,) = struct.unpack("<i", f.read(4))
            yield Record(p, content, label, idx) if full else (content, idx)


class Table:
    """One immutable version of a table: manifest + shard files."""

    def __init__(self, version_dir: str):
        self.version_dir = version_dir
        with open(os.path.join(version_dir, "manifest.json")) as f:
            self.manifest = json.load(f)

    @property
    def shard_paths(self) -> list[str]:
        return [os.path.join(self.version_dir, "shards", s["file"])
                for s in self.manifest["shards"]]

    @property
    def meta(self) -> dict:
        return self.manifest.get("meta", {})

    @property
    def num_records(self) -> int:
        return self.manifest["num_records"]

    def iter_records(self) -> Iterator[Record]:
        for sp in self.shard_paths:
            yield from read_shard(sp)

    def take(self, n: int) -> list[Record]:
        """The first ``n`` records."""
        out = []
        for r in self.iter_records():
            out.append(r)
            if len(out) >= n:
                break
        return out


class TableWriter:
    """Incremental single-writer handle for one new table version; the
    version becomes visible (manifest + ``latest`` pointer) at :meth:`close`."""

    def __init__(self, store: "TableStore", name: str, shard_size: int = 256,
                 meta: dict | None = None):
        self.store = store
        self.name = name
        self.shard_size = shard_size
        self.meta = meta or {}
        tdir = store._table_dir(name)
        os.makedirs(tdir, exist_ok=True)
        existing = sorted(d for d in os.listdir(tdir) if d.startswith("v"))
        self.vnum = 1 + (int(existing[-1][1:]) if existing else 0)
        self.vdir = os.path.join(tdir, f"v{self.vnum:04d}")
        self.shards_dir = os.path.join(self.vdir, "shards")
        os.makedirs(self.shards_dir)
        self._buf: list[Record] = []
        self._shard_metas: list[dict] = []
        self._total = 0
        self._closed = False

    def append(self, rec: Record) -> None:
        self._buf.append(rec)
        if len(self._buf) >= self.shard_size:
            self._flush()

    def extend(self, records: Iterable[Record]) -> None:
        for rec in records:
            self.append(rec)

    def _flush(self) -> None:
        if not self._buf:
            return
        path = os.path.join(self.shards_dir,
                            f"shard-{len(self._shard_metas):05d}.ddws")
        self._shard_metas.append(_write_shard(path, self._buf))
        self._total += len(self._buf)
        self._buf = []

    def add_shard_file(self, src_path: str, shard_meta: dict) -> None:
        """Adopt an existing shard file verbatim (hardlink, else a copy):
        the building block of :meth:`TableStore.merge_shards`.
        ``shard_meta`` is the source manifest's entry; its checksum carries
        over because the bytes do. Buffered appends are flushed first, so
        shard numbers stay in write order."""
        self._flush()
        fn = f"shard-{len(self._shard_metas):05d}.ddws"
        dst = os.path.join(self.shards_dir, fn)
        try:
            os.link(src_path, dst)
        except OSError:
            shutil.copy2(src_path, dst)
        self._shard_metas.append({**shard_meta, "file": fn})
        self._total += shard_meta["num_records"]

    def close(self) -> Table:
        if self._closed:
            return Table(self.vdir)
        self._flush()
        manifest = {
            "name": self.name,
            "version": self.vnum,
            "schema": list(RecordSchema().fields),
            "num_records": self._total,
            "shards": self._shard_metas,
            "created_unix": time.time(),
            "meta": self.meta,
        }
        with open(os.path.join(self.vdir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        tdir = self.store._table_dir(self.name)
        # Atomic-enough latest pointer (single-writer discipline).
        with open(os.path.join(tdir, "latest.tmp"), "w") as f:
            f.write(f"v{self.vnum:04d}")
        os.replace(os.path.join(tdir, "latest.tmp"),
                   os.path.join(tdir, "latest"))
        self._closed = True
        return Table(self.vdir)

    def __enter__(self) -> "TableWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()


class TableStore:
    """Versioned table namespace rooted at a directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _table_dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    def writer(self, name: str, shard_size: int = 256,
               meta: dict | None = None) -> TableWriter:
        return TableWriter(self, name, shard_size, meta)

    def write(self, name: str, records: Iterable[Record],
              shard_size: int = 256, meta: dict | None = None) -> Table:
        """Write a new version of table ``name`` (append-only versioning)."""
        w = TableWriter(self, name, shard_size, meta)
        w.extend(records)
        return w.close()

    def table(self, name: str, version: int | None = None) -> Table:
        """Open a table; the latest version by default."""
        tdir = self._table_dir(name)
        if version is None:
            with open(os.path.join(tdir, "latest")) as f:
                vstr = f.read().strip()
        else:
            vstr = f"v{version:04d}"
        return Table(os.path.join(tdir, vstr))

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self._table_dir(name), "latest"))

    @staticmethod
    def run_token(*components) -> str:
        """Deterministic 16-hex run token from the run's inputs (the same
        derivation as ``ddw_tpu``, so both packages stamp equal tokens):
        every worker of a part/merge flow derives it alone, and
        :meth:`await_parts` checks it."""
        h = hashlib.sha256()
        for c in components:
            h.update(repr(c).encode())
            h.update(b"\x00")
        return h.hexdigest()[:16]

    def await_parts(self, part_names: list[str], run_id: str,
                    timeout_s: float = 300.0, abort=None) -> list[Table]:
        """Wait (bounded) until every part table's latest version carries
        ``meta.run_id == run_id``; return those versions.

        Existence alone is not enough: an earlier run's version exists too,
        and merging it while a slower worker still writes this run's part
        would mix runs. The returned tables are the versions that passed the
        check (re-opening ``latest`` later could see a newer commit).
        ``abort``, a zero-argument callable polled each round, ends the wait
        with ``RuntimeError`` when it returns a reason string (a coordinator
        whose worker died fails at once instead of sleeping out the
        timeout)."""
        deadline = time.monotonic() + timeout_s
        good: dict[str, Table] = {}
        while True:
            pending = []
            for n in part_names:
                if n in good:
                    continue
                if not self.exists(n):
                    pending.append(n)
                    continue
                t = self.table(n)
                if t.meta.get("run_id") == run_id:
                    good[n] = t
                else:
                    pending.append(f"{n} (stale run_id)")
            if not pending:
                return [good[n] for n in part_names]
            if abort is not None:
                reason = abort()
                if reason:
                    raise RuntimeError(
                        f"await_parts aborted for run {run_id!r}: {reason} "
                        f"(still pending: {pending})")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"parts never appeared for run {run_id!r}: {pending}")
            time.sleep(0.2)

    def merge_shards(self, name: str, parts: list[Table],
                     meta: dict | None = None) -> Table:
        """A new version of ``name`` whose shards are the parts' shard files
        (hardlinked where the filesystem allows, else copied), in part
        order: the manifests concatenate, no record is re-encoded."""
        w = TableWriter(self, name, meta=meta)
        for t in parts:
            for sm, sp in zip(t.manifest["shards"], t.shard_paths):
                w.add_shard_file(sp, sm)
        return w.close()
