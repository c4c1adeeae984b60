"""The master's metadata store: inodes, directory entries, block meta.

Own copy of ``curvine_tpu/master/store.py``, two stores behind one
surface:

- ``MemMetaStore`` (:43-215): everything in dicts, made durable by the
  journal and its snapshots; its transaction surface is a no-op.
- ``KvMetaStore`` (:253-598), the reference's default: every inode,
  directory entry and block record is a record of the log-structured KV
  store (``common/kvstore.py``, or the native engine of
  ``common/kvnative.py``), so the namespace can outgrow RAM; hot inodes
  sit in a bounded LRU cache, directory entries are keys of their own,
  and a restart reads the applied seq and replays only the journal's
  tail.

Both carry the mount table's and the job manager's records, the EC
stripe records and the workers' decommission intents. The KV records
and their keys are the reference's byte for byte (ids big-endian, so
numeric order is byte order; values packed with ``rpc/wirepack.py``,
byte-equal to ``msgpack``), so either package's master opens the
other's directory:

  b"i" + id(8)                 the inode record (``_enc_inode``)
  b"c" + parent id(8) + name   the child's id (8 bytes)
  b"b" + block id(8)           [len, inode id, replicas]
  b"m" + cv path, b"J" + job id, b"E" + block id(8), b"D" + worker id(8)
                               a mount, a job, a stripe, an intent
  b"M" + name                  the counters: next_id, next_block_id,
                               applied_seq, inode_count, block_count

A mutation writes into a pending overlay; ``commit_applied(seq)`` lands
it and the new ``applied_seq`` as one atomic KV batch. Under group
commit ``stage_entry`` moves each applied entry's writes into a staged
overlay, and the group lands as one batch. ``KvMetaStore.frozen()``
(beyond the reference) cuts the records a snapshot reads: one engine
cursor a prefix, opened on the event loop at a cost bounded by the
memtable, and a read-only ``FrozenKv`` with the same read surface over
them, drained and decoded off the loop (a raft leader's snapshot, in a
forked child: ROADMAP §C, C10). ``fresh`` and ``adopt`` (both stores) let a raft follower
build the state it installs off the loop and swap it in. Left out: the
two-phase transaction records (``tx_*``, :464-492) of the sharded
namespace."""

from __future__ import annotations

import logging
import os
import shutil
import struct
from collections import OrderedDict

from curvine_tpu_torch.common.conf import META_ENGINES
from curvine_tpu_torch.common.kvstore import KvStore
from curvine_tpu_torch.common.types import FileType, StoragePolicy
from curvine_tpu_torch.rpc import wirepack

log = logging.getLogger(__name__)

_U64 = struct.Struct(">Q")


class MemMetaStore:
    kind = "mem"

    def __init__(self) -> None:
        self.inodes: dict[int, object] = {}
        self.children: dict[int, dict[str, int]] = {}
        self.blocks: dict[int, tuple[int, int, int]] = {}
        self.counters: dict[str, int] = {}
        self.mounts_tbl: dict[str, dict] = {}
        self.jobs_tbl: dict[str, dict] = {}
        self.deco_tbl: set[int] = set()
        self.ec_tbl: dict[int, dict] = {}

    # inodes
    def get(self, inode_id: int):
        return self.inodes.get(inode_id)

    def put(self, inode, new: bool = False) -> None:
        self.inodes[inode.id] = inode

    def remove(self, inode_id: int) -> None:
        self.inodes.pop(inode_id, None)
        self.children.pop(inode_id, None)

    def iter_inodes(self):
        return iter(list(self.inodes.values()))

    def inode_count(self) -> int:
        return len(self.inodes)

    # directory entries
    def child_get(self, parent_id: int, name: str) -> int | None:
        return self.children.get(parent_id, {}).get(name)

    def child_put(self, parent_id: int, name: str, child_id: int) -> None:
        self.children.setdefault(parent_id, {})[name] = child_id

    def child_remove(self, parent_id: int, name: str) -> None:
        self.children.get(parent_id, {}).pop(name, None)

    def children_of(self, parent_id: int) -> list[tuple[str, int]]:
        return sorted(self.children.get(parent_id, {}).items())

    def iter_children_all(self):
        for pid, entries in list(self.children.items()):
            for name, cid in entries.items():
                yield pid, name, cid

    # durable block meta: (len, inode_id, replicas)
    def block_get(self, block_id: int) -> tuple[int, int, int] | None:
        return self.blocks.get(block_id)

    def block_put(self, block_id: int, length: int, inode_id: int,
                  replicas: int) -> None:
        self.blocks[block_id] = (length, inode_id, replicas)

    def block_remove(self, block_id: int) -> None:
        self.blocks.pop(block_id, None)

    def iter_blocks(self):
        return iter(list(self.blocks.items()))

    def block_count(self) -> int:
        return len(self.blocks)

    # mount table records
    def mount_put(self, cv_path: str, wire: dict) -> None:
        self.mounts_tbl[cv_path] = wire

    def mount_remove(self, cv_path: str) -> None:
        self.mounts_tbl.pop(cv_path, None)

    def iter_mounts(self):
        return iter(list(self.mounts_tbl.values()))

    # job records (journaled, so a restart resumes interrupted jobs)
    def job_put(self, job_id: str, wire: dict) -> None:
        self.jobs_tbl[job_id] = wire

    def job_remove(self, job_id: str) -> None:
        self.jobs_tbl.pop(job_id, None)

    def iter_jobs(self):
        return iter(list(self.jobs_tbl.values()))

    # EC stripe records: logical block id -> {"profile", "cell_size",
    # "block_len", "cells", "state"}
    def ec_put(self, block_id: int, wire: dict) -> None:
        self.ec_tbl[block_id] = wire

    def ec_get(self, block_id: int) -> dict | None:
        return self.ec_tbl.get(block_id)

    def ec_remove(self, block_id: int) -> None:
        self.ec_tbl.pop(block_id, None)

    def iter_ec(self):
        return iter(list(self.ec_tbl.items()))

    # worker decommission intents
    def deco_put(self, worker_id: int) -> None:
        self.deco_tbl.add(worker_id)

    def deco_remove(self, worker_id: int) -> None:
        self.deco_tbl.discard(worker_id)

    def iter_deco(self):
        return iter(sorted(self.deco_tbl))

    # counters
    def get_counter(self, name: str, default: int = 0) -> int:
        return self.counters.get(name, default)

    def set_counter(self, name: str, value: int) -> None:
        self.counters[name] = value

    def bump_counter(self, name: str, delta: int, default: int = 0) -> int:
        """Add ``delta`` and return the value before."""
        cur = self.counters.get(name, default)
        self.counters[name] = cur + delta
        return cur

    # the transaction surface (no-ops in RAM)
    def commit_applied(self, seq: int) -> None:
        self.counters["applied_seq"] = seq

    def commit_runtime(self) -> None:
        pass

    def rollback(self) -> None:
        pass

    def stage_entry(self) -> None:
        pass

    def rollback_group(self) -> None:
        pass

    def flush(self) -> None:
        pass

    def clear(self) -> None:
        self.inodes.clear()
        self.children.clear()
        self.blocks.clear()
        self.counters.clear()
        self.mounts_tbl.clear()
        self.jobs_tbl.clear()
        self.deco_tbl.clear()
        self.ec_tbl.clear()

    _TABLES = ("inodes", "children", "blocks", "counters", "mounts_tbl",
               "jobs_tbl", "deco_tbl", "ec_tbl")

    def fresh(self) -> "MemMetaStore":
        """An empty store, for a state built off the loop (``adopt``)."""
        return MemMetaStore()

    def adopt(self, other: "MemMetaStore") -> None:
        """Take ``other``'s tables as this store's (a raft follower's
        install, built on a thread)."""
        for name in self._TABLES:
            setattr(self, name, getattr(other, name))

    def close(self) -> None:
        pass


def _pack(obj) -> bytes:
    return wirepack.packb(obj, use_bin_type=True)


def _unpack(raw: bytes):
    return wirepack.unpackb(raw, raw=False, strict_map_key=False)


def _enc_inode(node) -> bytes:
    # the positional record (the reference's v2); the leading None tags
    # it (the older records are maps)
    return _pack([
        None, node.id, node.name, int(node.file_type), node.parent_id,
        node.mtime, node.atime, node.owner, node.group, node.mode,
        node.x_attr, node.storage_policy.to_wire(), node.nlink, node.len,
        node.block_size, node.replicas, node.blocks, node.is_complete,
        node.target, node.children_num, node.client_name,
    ])


def _dec_inode(raw: bytes):
    from curvine_tpu_torch.master.inode import Inode
    d = _unpack(raw)
    if isinstance(d, dict):             # the older map record
        return Inode(
            id=d["id"], name=d["n"], file_type=FileType(d["ft"]),
            parent_id=d["p"], mtime=d["mt"], atime=d["at"], owner=d["o"],
            group=d["g"], mode=d["md"], x_attr=d["x"] or {},
            storage_policy=StoragePolicy.from_wire(d["sp"]), nlink=d["nl"],
            len=d["ln"], block_size=d["bs"], replicas=d["rp"],
            blocks=list(d["bl"]), is_complete=d["dn"], target=d.get("tg"),
            children_num=d.get("cn", 0), client_name=d.get("cl", ""))
    (_tag, iid, name, ft, pid, mt, at, owner, group, mode, x, spw, nl, ln,
     bs, rp, bl, dn, tg, cn, cl) = d
    return Inode(
        id=iid, name=name, file_type=FileType(ft), parent_id=pid, mtime=mt,
        atime=at, owner=owner, group=group, mode=mode, x_attr=x or {},
        storage_policy=StoragePolicy.from_wire(spw), nlink=nl, len=ln,
        block_size=bs, replicas=rp, blocks=list(bl), is_complete=dn,
        target=tg, children_num=cn, client_name=cl)


def open_kv(kv_dir: str, engine: str = "auto", fsync: bool = False,
            memtable_max_bytes: int = 8 << 20):
    """The KV engine ``engine`` names over ``kv_dir``: ``"native"`` (the
    native engine; raises when its library cannot be built, never falls
    back), ``"python"``, or ``"auto"`` (the native engine when its
    library builds and loads, else the Python engine, with a warning).
    Both write the same files, so the choice can change between
    restarts."""
    if engine not in META_ENGINES:
        raise ValueError(f"meta_engine {engine!r}: the port takes "
                         f"{list(META_ENGINES)}")
    if engine != "python":
        from curvine_tpu_torch.common import kvnative
        if engine == "native" or kvnative.available():
            return kvnative.NativeKvStore(
                kv_dir, fsync=fsync, memtable_max_bytes=memtable_max_bytes)
        log.warning("meta_engine \"auto\": the native KV engine did not "
                    "build or load; the master's store runs on the Python "
                    "engine (the same files, slower)")
    return KvStore(kv_dir, fsync=fsync, memtable_max_bytes=memtable_max_bytes)


class KvMetaStore:
    """The KV-backed store: a bounded LRU inode cache and a pending
    overlay, committed atomically with the applied seq."""

    kind = "kv"

    def __init__(self, kv_dir: str, cache_inodes: int = 65_536,
                 fsync: bool = False, memtable_max_bytes: int = 8 << 20,
                 engine: str = "auto"):
        self.kv_dir = kv_dir
        self._fsync = fsync
        self._memtable_max = memtable_max_bytes
        self.kv = open_kv(kv_dir, engine, fsync, memtable_max_bytes)
        # the engine in use: "native" or "python"
        self.engine = self.kv.kind
        self.cache_max = cache_inodes
        self._cache: OrderedDict[int, object] = OrderedDict()
        # (parent_id, name) -> child id or None: misses are cached too,
        # since create and exists probe missing names again and again
        self._child_cache: OrderedDict[tuple[int, str], int | None] = \
            OrderedDict()
        self._child_cache_max = 4 * cache_inodes
        self._pending: dict[bytes, bytes | None] = {}
        # the group's overlay: stage_entry moves a finished entry's
        # pending writes here, and commit_applied lands the whole group
        # as one write batch; rollback (one failed apply) keeps it
        self._staged: dict[bytes, bytes | None] = {}
        self._counters: dict[str, int] = {}        # write-back cache
        # the inode records' bytes pending since the last landing
        # (``land_pending``)
        self._pending_bytes = 0

    # ---- keys ----
    @staticmethod
    def _ik(inode_id: int) -> bytes:
        return b"i" + _U64.pack(inode_id)

    @staticmethod
    def _ck(parent_id: int, name: str = "") -> bytes:
        return b"c" + _U64.pack(parent_id) + name.encode()

    @staticmethod
    def _bk(block_id: int) -> bytes:
        return b"b" + _U64.pack(block_id)

    def _read(self, key: bytes) -> bytes | None:
        if key in self._pending:
            return self._pending[key]
        if key in self._staged:
            return self._staged[key]
        return self.kv.get(key)

    # ---- inodes ----
    def get(self, inode_id: int):
        node = self._cache.get(inode_id)
        if node is not None:
            self._cache.move_to_end(inode_id)
            return node
        raw = self._read(self._ik(inode_id))
        if raw is None:
            return None
        node = _dec_inode(raw)
        self._cache_put(node)
        return node

    def _cache_put(self, node) -> None:
        self._cache[node.id] = node
        self._cache.move_to_end(node.id)
        while len(self._cache) > self.cache_max:
            self._cache.popitem(last=False)

    def put(self, inode, new: bool = False) -> None:
        raw = self._pending[self._ik(inode.id)] = _enc_inode(inode)
        self._pending_bytes += len(raw)
        self._cache_put(inode)
        if new:
            self.bump_counter("inode_count", 1)

    def remove(self, inode_id: int) -> None:
        self._pending[self._ik(inode_id)] = None
        self._cache.pop(inode_id, None)
        self.bump_counter("inode_count", -1)

    def iter_inodes(self):
        # the overlays are committed with each entry; callers iterate
        # between entries
        for _k, raw in self.kv.scan(prefix=b"i"):
            yield _dec_inode(raw)

    def inode_count(self) -> int:
        return self.get_counter("inode_count")

    # ---- directory entries ----
    def child_get(self, parent_id: int, name: str) -> int | None:
        key = (parent_id, name)
        if key in self._child_cache:
            self._child_cache.move_to_end(key)
            return self._child_cache[key]
        raw = self._read(self._ck(parent_id, name))
        cid = _U64.unpack(raw)[0] if raw else None
        self._child_cache[key] = cid
        while len(self._child_cache) > self._child_cache_max:
            self._child_cache.popitem(last=False)
        return cid

    def child_put(self, parent_id: int, name: str, child_id: int) -> None:
        self._pending[self._ck(parent_id, name)] = _U64.pack(child_id)
        self._child_cache[(parent_id, name)] = child_id

    def child_remove(self, parent_id: int, name: str) -> None:
        self._pending[self._ck(parent_id, name)] = None
        self._child_cache[(parent_id, name)] = None

    def children_of(self, parent_id: int) -> list[tuple[str, int]]:
        prefix = self._ck(parent_id)
        out = {}
        for k, raw in self.kv.scan(prefix=prefix):
            out[k[len(prefix):].decode()] = _U64.unpack(raw)[0]
        for overlay in (self._staged, self._pending):
            for k, raw in overlay.items():
                if k.startswith(prefix):
                    name = k[len(prefix):].decode()
                    if raw is None:
                        out.pop(name, None)
                    else:
                        out[name] = _U64.unpack(raw)[0]
        return sorted(out.items())

    def iter_children_all(self):
        for k, raw in self.kv.scan(prefix=b"c"):
            yield (_U64.unpack(k[1:9])[0], k[9:].decode(),
                   _U64.unpack(raw)[0])

    # ---- durable block meta ----
    def block_get(self, block_id: int) -> tuple[int, int, int] | None:
        raw = self._read(self._bk(block_id))
        if raw is None:
            return None
        length, inode_id, replicas = _unpack(raw)
        return length, inode_id, replicas

    def block_put(self, block_id: int, length: int, inode_id: int,
                  replicas: int) -> None:
        if self._read(self._bk(block_id)) is None:
            self.bump_counter("block_count", 1)
        self._pending[self._bk(block_id)] = _pack(
            [length, inode_id, replicas])

    def block_remove(self, block_id: int) -> None:
        if self._read(self._bk(block_id)) is not None:
            self.bump_counter("block_count", -1)
        self._pending[self._bk(block_id)] = None

    def iter_blocks(self):
        for k, raw in self.kv.scan(prefix=b"b"):
            length, inode_id, replicas = _unpack(raw)
            yield _U64.unpack(k[1:])[0], (length, inode_id, replicas)

    def block_count(self) -> int:
        return self.get_counter("block_count")

    # ---- mount table records ----
    def mount_put(self, cv_path: str, wire: dict) -> None:
        self._pending[b"m" + cv_path.encode()] = _pack(wire)

    def mount_remove(self, cv_path: str) -> None:
        self._pending[b"m" + cv_path.encode()] = None

    def iter_mounts(self):
        for _k, raw in self.kv.scan(prefix=b"m"):
            yield _unpack(raw)

    # ---- job records ----
    def job_put(self, job_id: str, wire: dict) -> None:
        self._pending[b"J" + job_id.encode()] = _pack(wire)

    def job_remove(self, job_id: str) -> None:
        self._pending[b"J" + job_id.encode()] = None

    def iter_jobs(self):
        for _k, raw in self.kv.scan(prefix=b"J"):
            yield _unpack(raw)

    # ---- EC stripe records ----
    def ec_put(self, block_id: int, wire: dict) -> None:
        self._pending[b"E" + _U64.pack(block_id)] = _pack(wire)

    def ec_get(self, block_id: int) -> dict | None:
        raw = self._read(b"E" + _U64.pack(block_id))
        return None if raw is None else _unpack(raw)

    def ec_remove(self, block_id: int) -> None:
        self._pending[b"E" + _U64.pack(block_id)] = None

    def iter_ec(self):
        for k, raw in self.kv.scan(prefix=b"E"):
            yield _U64.unpack(k[1:])[0], _unpack(raw)

    # ---- worker decommission intents ----
    def deco_put(self, worker_id: int) -> None:
        self._pending[b"D" + _U64.pack(worker_id)] = b"1"

    def deco_remove(self, worker_id: int) -> None:
        self._pending[b"D" + _U64.pack(worker_id)] = None

    def iter_deco(self):
        for k, _raw in self.kv.scan(prefix=b"D"):
            yield _U64.unpack(k[1:])[0]

    # ---- counters ----
    def get_counter(self, name: str, default: int = 0) -> int:
        if name in self._counters:
            return self._counters[name]
        raw = self._read(b"M" + name.encode())
        val = _unpack(raw) if raw is not None else default
        self._counters[name] = val
        return val

    def set_counter(self, name: str, value: int) -> None:
        self._counters[name] = value
        self._pending[b"M" + name.encode()] = _pack(value)

    def bump_counter(self, name: str, delta: int, default: int = 0) -> int:
        """Add ``delta`` and return the value before."""
        cur = self._counters.get(name)
        if cur is None:
            cur = self.get_counter(name, default)
        self._counters[name] = new = cur + delta
        self._pending[b"M" + name.encode()] = _pack(new)
        return cur

    # ---- transactions ----
    def stage_entry(self) -> None:
        """Move this entry's pending writes into the group's overlay; a
        later entry's rollback leaves them."""
        if self._pending:
            self._staged.update(self._pending)
            self._pending.clear()

    def commit_applied(self, seq: int) -> None:
        """Land the staged and pending writes and ``applied_seq = seq``
        as one atomic write batch: a replay after a crash resumes at
        seq + 1."""
        self.set_counter("applied_seq", seq)
        if self._pending:
            self._staged.update(self._pending)
            self._pending.clear()
        self.kv.write_batch(list(self._staged.items()))
        self._staged.clear()
        self._pending_bytes = 0

    def land_pending(self, limit: int = 8 << 20) -> None:
        """Land the pending writes once their inode records pass
        ``limit`` bytes, without moving ``applied_seq``: a store filled
        off the loop (``fresh``) is written in batches of about that
        size, none of which holds the interpreter's lock for long."""
        if self._pending_bytes >= limit:
            self.commit_runtime()

    def commit_runtime(self) -> None:
        """Land the pending writes without moving ``applied_seq`` (a
        block report's length bumps: durable, not journaled). Inside an
        open group they join the group instead, so that runtime state
        never lands ahead of an unflushed journal group."""
        self._pending_bytes = 0
        if not self._pending:
            return
        if self._staged:
            self._staged.update(self._pending)
            self._pending.clear()
            return
        self.kv.write_batch(list(self._pending.items()))
        self._pending.clear()

    def rollback(self) -> None:
        """Drop a failed apply's pending writes, and the whole inode
        cache: the apply may have changed cached inodes before it
        raised. The group's staged writes stay (``_read`` sees them).
        A caller must not keep an ``Inode`` across a rollback."""
        self._pending.clear()
        self._cache.clear()
        self._child_cache.clear()
        self._counters.clear()

    def rollback_group(self) -> None:
        """Drop the whole open group, staged and pending: its journal
        entries were never written."""
        self._pending.clear()
        self._staged.clear()
        self._cache.clear()
        self._child_cache.clear()
        self._counters.clear()

    def flush(self) -> None:
        self.kv.flush()

    def clear(self) -> None:
        self.kv.clear()
        self._cache.clear()
        self._child_cache.clear()
        self._pending.clear()
        self._staged.clear()
        self._counters.clear()

    def close(self) -> None:
        self.kv.close()

    def fresh(self) -> "KvMetaStore":
        """An empty store of this engine and these settings in
        ``<kv_dir>.install`` (an earlier one there removed): a raft
        follower builds the state it installs there, off the loop, and
        hands the closed store to ``adopt``."""
        path = self.kv_dir.rstrip("/") + ".install"
        shutil.rmtree(path, ignore_errors=True)
        return KvMetaStore(path, cache_inodes=1024, fsync=self._fsync,
                           memtable_max_bytes=self._memtable_max,
                           engine=self.engine)

    def adopt(self, built: "KvMetaStore") -> None:
        """Take the closed store ``built`` (``fresh``, filled and committed
        on a thread) as this one: the old engine's files are dropped, the
        built directory is renamed into place and reopened, and the caches
        and overlays are cleared. Its cost is the reopen (each segment's
        footer and sparse index), not the records."""
        self.kv.clear()
        self.kv.close()
        old = self.kv_dir.rstrip("/") + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(self.kv_dir, old)
        os.replace(built.kv_dir, self.kv_dir)
        shutil.rmtree(old, ignore_errors=True)
        self.kv = open_kv(self.kv_dir, self.engine, self._fsync,
                          self._memtable_max)
        self._cache.clear()
        self._child_cache.clear()
        self._pending.clear()
        self._staged.clear()
        self._counters.clear()

    def frozen(self) -> "FrozenKv":
        """A read-only cut of the records a snapshot reads, taken between
        entries: one engine cursor a prefix (``KvStore.scan``: the
        memtable's items under the prefix copied, the segment files
        opened) and the two counters. It copies no segment record, so
        its cost is bounded by the memtable, not by the namespace;
        another thread or a forked child drains it while this store goes
        on writing, flushing and compacting."""
        cursors = {p: self.kv.scan(prefix=p) for p in FrozenKv.PREFIXES}
        # the counters this store has cached; the others are read from a
        # cursor by the drainer (a point read here could go down every
        # segment)
        counters = {name: self._counters[name]
                    for name in FrozenKv.COUNTERS if name in self._counters}
        if len(counters) < len(FrozenKv.COUNTERS):
            cursors[b"M"] = self.kv.scan(prefix=b"M")
        return FrozenKv(cursors, counters)


class FrozenKv:
    """``KvMetaStore.frozen()``'s cut: its read surface over the cursors,
    each drained once, its records decoded as they are read."""

    PREFIXES = (b"i", b"c", b"b", b"J", b"E")
    COUNTERS = ("next_id", "next_block_id")

    def __init__(self, cursors: dict, counters: dict):
        self._cursors = cursors
        self._counters = counters
        self.kv = self

    def scan(self, prefix: bytes):
        return self._cursors.pop(prefix)

    def get_counter(self, name: str, default: int = 0) -> int:
        counters = self._cursors.pop(b"M", None)
        if counters is not None:
            for k, raw in counters:
                name_k = k[1:].decode()
                if name_k in self.COUNTERS:
                    self._counters.setdefault(name_k, _unpack(raw))
        v = self._counters.get(name)
        return default if v is None else v

    iter_inodes = KvMetaStore.iter_inodes
    iter_children_all = KvMetaStore.iter_children_all
    iter_blocks = KvMetaStore.iter_blocks
    iter_jobs = KvMetaStore.iter_jobs
    iter_ec = KvMetaStore.iter_ec
