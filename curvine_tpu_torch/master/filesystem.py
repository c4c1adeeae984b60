"""MasterFilesystem: the namespace and the block management core.

A carve of ``curvine_tpu/master/filesystem.py``. Every mutation is
journaled before it is applied (``_log``, :166-214) and applied by an
``_apply_<op>`` (:374-382), so a restart reaches the same state by
replay. Two durability modes, chosen by the store (``master/store.py``):

- ``MemMetaStore``: the namespace in RAM; a restart loads the newest
  snapshot and replays the journal after it (``recover``,
  ``checkpoint``, ``_snapshot_state`` and ``_load_snapshot``,
  :112-162, :274-372).
- ``KvMetaStore``, the reference's default: each entry's effects and
  its seq land as one atomic KV batch (staged under group commit, the
  group's batch landing with its journal flush), so a restart opens the
  store and replays only the journal's tail past ``applied_seq``, a
  batch every 4,096 entries; when the store is behind the newest
  snapshot (a mem store's journal reopened on KV) the snapshot is loaded
  wholesale first. A failed apply rolls its writes back
  (``store.rollback``). A checkpoint flushes the store's memtable and
  drops the journal segments it covers (``gc_covered``): no snapshot.
  ``recovery`` holds the last recovery's figures (inodes, blocks,
  ``applied_seq``, the tail entries replayed).

The entries, snapshots and KV records are the reference's, field for
field, and either package's master reopens the other's journal and
metadata directory.

Served: ``mkdir``, ``create_file`` (with the caller's ``block_size`` and
``storage_policy``), ``exists``, ``file_status``,
``list_status``, ``rename``, ``delete`` (with ``_free_blocks`` and the
pending deletes the next heartbeat hands each worker), ``add_block``
(with ``commit_blocks``, ``exclude_workers`` and ``abandon_block``),
``complete_file`` and ``get_block_locations``; and the worker plane:
``worker_heartbeat`` (``delete_blocks``, ``report_now``, and
``draining`` to a DECOMMISSIONING worker, which then refuses new write
streams, :1205-1227), ``worker_block_report`` (a DECOMMISSIONED
worker's report is ignored: its copies were dropped at the drain's end,
:1232-1236), ``recover_stale_leases``, ``check_lost_workers`` (which
hands each newly lost worker's blocks to ``on_worker_lost``, the
replication manager's hook, :1288-1298) and ``master_info`` (the
serving workers, LIVE and draining, as the live list; the LOST and the
DECOMMISSIONED as the lost list, :1300-1314). ``get_block_locations``
lists the LIVE and the DECOMMISSIONING replicas (:1168, :1197): a
draining worker serves reads until the drain ends. The decommission
intent is journaled (``decommission_worker``, ``worker_deco``,
:395-410) and kept in the snapshot's ``deco`` section. The placement
policy is built with the conf's ICI mesh shape, and ``add_block``
passes the client's ``ici_coords`` to it (:49-60, :1053-1067). Every
write op is refused under a read-only mount (``_mount_write_guard``,
:1316-1341; recursive delete and rename also when a read-only mount
lies under the path); a create whose storage policy carries
``ufs_mtime`` is a cache-warming load, which passes.

``set_attr`` (:779-813) stores SET_ATTR's fields: owner, group, mode,
replicas, the TTL fields (stored; the TTL scanner that acts on them is
not ported), atime, mtime, xattrs and the ``ec`` storage class, whose
profile ``ECProfile.parse`` validates before it is journaled.

Erasure-coded stripes (:78-114, :420-512): a striped block keeps its
durable record, and its bytes live in k + m cell blocks, each a block of
its own with its checksum and its holder. ``ec_plan`` journals the
cells' ids before a byte is written (``_apply_ec_plan`` takes them from
``tree.alloc_block_id()``, the counter ``alloc_block`` uses, so a replay
gives the same ids, and frees a previous attempt's cells); the planned
cells are in the block table, so a worker's report of one is no orphan.
``ec_commit`` (EC_COMMIT_STRIPE) journals ``ec_put`` at the stripe's
first commit, registers the cells' holders and retires the block's
replicas (``retire_stripe_replicas``: runtime only, the deletes ride the
heartbeats; the replication scan re-runs it until no replica is left).
Beyond the reference, whose block reports race both (ROADMAP §C, C7), a
full report does not drop a cell located on its worker since that
worker's previous full report (by the stripe's commit or by the worker's
incremental report of a rebuilt cell): the report may have been built
before the cell landed, and the next one drops it if it is gone. Nor
does a report locate again a replica that the retire queued for
deletion: it is deleted again, until a full report no longer lists it.
``ec_stripes`` and ``ec_cells`` are the runtime index of the store's
stripe records, rebuilt after recovery and a snapshot's load.
``get_block_locations`` gives each committed stripe's block its ``ec``
descriptor (``_ec_descriptor``, :1180-1200: the cells' LIVE and
DECOMMISSIONING holders); ``_free_blocks`` frees a stripe's cells with
the block (:733-744).

The port applies the journal ops ``mkdir``, ``create``, ``delete``,
``rename``, ``alloc_block``, ``commit_blocks``, ``complete``,
``set_attr``, ``ec_plan``, ``ec_put``, the raft leader's ``noop``, the
raft membership's ``raft_conf`` (:383-392: recorded as ``raft_conf``,
which ``master/ha.py`` adopts), ``job_put``, ``job_del`` and
``worker_deco`` (:405-420), and, once the server's ``MountManager``
(``master/mount.py``) has attached its hooks, ``mount_add``,
``mount_remove`` and ``mount_update``; a snapshot's ``jobs``, ``ec``,
``mounts``, ``deco`` and ``raft_conf`` sections are saved and loaded.
Any other op (the reference's ``set_incomplete``, ``symlink``, ``link``,
``resize``, ``free``, ``tx_*``) stops recovery with
``UnportedJournalOp``, which names it: skipping it would drop state
silently.

The raft hooks (:166-271): ``_log`` calls ``on_mutation`` (the leader's
``RaftLite.on_mutation``) with each journaled entry's seq and term, also
when its apply fails, so that the followers' seqs stay contiguous (they
fail the same way and skip it). A follower journals a leader's batch
with one flush and applies it in order (``apply_replicated_batch``: an
entry whose apply fails is rolled back alone, and the KV batch commits
under the tail's seq); a snapshot install replaces the whole state, then
drops the log and writes the snapshot: ``build_install`` builds the new
state into a fresh store and stages the snapshot file (off the loop,
beyond the reference's ``install_snapshot``), ``adopt_install`` swaps
them in. ``check_lost_workers(act=False)``
keeps the LOST bookkeeping of a follower without its repair. Left out:
the two-phase transactions of the sharded namespace and the audit log
(ROADMAP §A items 3-4)."""

from __future__ import annotations

import logging
import time

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.ec import ECProfile
from curvine_tpu_torch.common.journal import GroupCommitter, Journal
from curvine_tpu_torch.common.types import (CommitBlock, ExtendedBlock,
                                            FileBlocks, FileStatus, FileType,
                                            LocatedBlock, MasterInfo,
                                            MountInfo,
                                            SetAttrOpts, StoragePolicy,
                                            StorageType, TtlAction,
                                            WorkerInfo, WorkerState, now_ms)
from curvine_tpu_torch.master.block_map import BlockMap
from curvine_tpu_torch.master.inode import ROOT_ID, Inode, InodeTree
from curvine_tpu_torch.master.placement import create_policy
from curvine_tpu_torch.master.store import KvMetaStore, MemMetaStore
from curvine_tpu_torch.master.worker_map import WorkerMap

log = logging.getLogger(__name__)

# the default storage policy in wire form (copied into each entry: journal
# args never share mutable state)
_DEFAULT_POLICY_WIRE = StoragePolicy().to_wire()
# a KV recovery commits its tail replay a batch every this many entries
REPLAY_BATCH = 4096


class UnportedJournalOp(RuntimeError):
    """A journal entry or snapshot section that the port's master does
    not apply. Not a ``CurvineError``: recovery skips those (an op that
    failed when it was first applied fails the same way on replay), and
    must stop on this one."""


class MasterFilesystem:
    def __init__(self, journal: Journal | None = None,
                 placement: str = "local", lost_timeout_ms: int = 30_000,
                 snapshot_interval: int = 100_000,
                 ici_mesh_shape: list[int] | None = None,
                 store: MemMetaStore | KvMetaStore | None = None):
        self.store = store if store is not None else MemMetaStore()
        self.tree = InodeTree(self.store)
        self.blocks = BlockMap(self.store)
        self.workers = WorkerMap(lost_timeout_ms=lost_timeout_ms)
        self.journal = journal
        self.snapshot_interval = snapshot_interval
        self._entries_since_snapshot = 0
        self.policy = create_policy(placement,
                                    mesh_shape=ici_mesh_shape or None)
        # worker_id -> block ids to delete (handed out by its heartbeat)
        self.pending_deletes: dict[int, set[int]] = {}
        # worker_id -> cells located on it since its last full report (by
        # a stripe's commit or its own incremental report): that report
        # may have been built before the cell landed, so it keeps them
        self._fresh_cells: dict[int, set[int]] = {}
        # worker_id -> stripe blocks whose replica on it was retired and
        # which no full report of it has shown gone yet: a report still
        # listing one does not locate it again, and deletes it again
        self._retired: dict[int, set[int]] = {}
        # inode ids of files open for writing; None until the first lease
        # recovery after a start builds it by one scan (a snapshot install
        # sets it from the snapshot)
        self.open_files: set[int] | None = None
        # set by MasterServer: _log then journals unflushed and the RPC
        # handler awaits committer.sync() before it replies
        self.committer: GroupCommitter | None = None
        # set by MasterServer: the replication manager's on_worker_lost
        self.on_worker_lost = None
        # set by MasterServer: the mount table (master/mount.py)
        self.mounts = None
        # set by MasterServer under raft: RaftLite.on_mutation
        self.on_mutation = None
        # the active raft membership config, as the last raft_conf entry
        # or snapshot set it (RaftLite adopts it)
        self.raft_conf: dict | None = None
        # the runtime index of the store's stripe records: logical block
        # id -> stripe, and cell block id -> (logical block id, index)
        self.ec_stripes: dict[int, dict] = {}
        self.ec_cells: dict[int, tuple[int, int]] = {}
        # the last recover()'s figures: inodes, blocks, applied_seq (the
        # journal's seq on the mem store), tail entries replayed
        self.recovery: dict = {}
        self._started = time.monotonic()

    @property
    def _kv(self) -> bool:
        return self.store.kind == "kv"

    # ==================== journal plumbing ====================

    def _rebuild_ec_index(self) -> None:
        self.ec_stripes = {}
        self.ec_cells = {}
        for bid, stripe in self.store.iter_ec():
            self._ec_index(bid, stripe)

    def _ec_index(self, block_id: int, stripe: dict) -> None:
        old = self.ec_stripes.get(block_id)
        if old is not None:
            for cid in old.get("cells", []):
                self.ec_cells.pop(cid, None)
        self.ec_stripes[block_id] = stripe
        for idx, cid in enumerate(stripe.get("cells", [])):
            self.ec_cells[cid] = (block_id, idx)

    def recover(self) -> None:
        if self.journal is None:
            self._rebuild_ec_index()
            return
        snap, entries = self.journal.recover()
        if self._kv:
            self._recover_kv(snap, entries)
            return
        if snap is not None:
            self._load_snapshot(snap)
        for _seq, op, args, _term in entries:
            try:
                self._apply(op, args)
            except err.CurvineError as e:
                log.warning("journal replay: %s(%s) -> %s", op, args, e)
        if snap is not None or entries:
            log.info("recovered namespace: %d inodes, %d blocks, seq=%d",
                     self.tree.count(), self.blocks.count(), self.journal.seq)
        self.recovery = {"inodes": self.tree.count(),
                         "blocks": self.blocks.count(),
                         "applied_seq": self.journal.seq,
                         "replayed": len(entries)}
        self._rebuild_ec_index()

    def _recover_kv(self, snap: dict | None, entries: list) -> None:
        """Resume at the store's ``applied_seq``: load the newest
        snapshot wholesale when the store is behind it, then replay the
        journal's tail past both (of ``entries``, as ``Journal.recover``
        returns them, those at or below the store's ``applied_seq`` are
        skipped), committing a batch every REPLAY_BATCH entries."""
        applied = self.store.get_counter("applied_seq", 0)
        snap_seq = self.journal.last_snapshot_seq
        if snap is not None and applied < snap_seq:
            self._load_snapshot(snap)
            applied = snap_seq
            self.store.commit_applied(applied)
        if self.mounts is not None:
            # the table as the store holds it, before the tail's mount
            # entries act on it
            self.mounts.load_from_store()
        replayed = 0
        tail_seq = applied
        for seq, op, args, _term in entries:
            if seq <= applied:
                continue
            try:
                self._apply(op, args)
                self.store.stage_entry()
            except err.CurvineError as e:
                self.store.rollback()
                log.warning("journal replay: %s(%s) -> %s", op, args, e)
            tail_seq = seq
            replayed += 1
            if replayed % REPLAY_BATCH == 0:
                self.store.commit_applied(tail_seq)
        if tail_seq > applied:
            self.store.commit_applied(tail_seq)
        self.journal.seq = max(self.journal.seq, applied)
        self.recovery = {"inodes": self.tree.count(),
                         "blocks": self.blocks.count(),
                         "applied_seq": self.store.get_counter("applied_seq"),
                         "replayed": replayed}
        log.info("kv recovery: %d inodes, %d blocks, applied_seq=%d, "
                 "replayed %d tail entries", self.recovery["inodes"],
                 self.recovery["blocks"], self.recovery["applied_seq"],
                 replayed)
        self._rebuild_ec_index()

    def _log(self, op: str, args: dict):
        """Journal, then apply: a failed append never leaves the state
        ahead of the log. With a committer the append is unflushed, the
        entry's KV writes are staged, and the committer flushes the group
        and lands its KV batch; validate, journal and apply are one
        synchronous stretch on the loop, so later ops see the state at
        once. Without one, the KV writes land with the entry."""
        grouped = self.committer is not None and self.committer.accepting
        seq = None
        if self.journal is not None:
            seq = self.journal.append(op, args, flush=not grouped)
        try:
            result = self._apply(op, args)
        except BaseException:
            if self._kv:
                # the failed apply's writes go; its seq is still applied
                self.store.rollback()
                if seq is not None and not grouped:
                    self.store.commit_applied(seq)
            if grouped:
                self.committer.note()
            if seq is not None and self.on_mutation is not None:
                self.on_mutation(seq, op, args, self.journal.last_term)
            raise
        if self._kv:
            if grouped:
                self.store.stage_entry()
            else:
                self.store.commit_applied(
                    seq if seq is not None
                    else self.store.get_counter("applied_seq", 0))
        if grouped:
            self.committer.note()
        if seq is not None:
            if self.on_mutation is not None:
                self.on_mutation(seq, op, args, self.journal.last_term)
            self._entries_since_snapshot += 1
            if self._entries_since_snapshot >= self.snapshot_interval:
                self.checkpoint()
        return result

    def apply_replicated_batch(
            self, entries: list[tuple[int, str, dict, int]]) -> None:
        """A follower's apply of a leader's batch: journal the whole batch
        with one flush, apply it in order, then land the group's KV writes
        as one batch under the tail's seq. An entry whose apply fails (the
        leader's failed the same way) is rolled back alone. A cancellation
        marks nothing applied: the journal holds the batch, and a restart
        replays it."""
        assert self.journal is not None
        if not entries:
            return
        self.journal.append_batch([(op, args, term)
                                   for _seq, op, args, term in entries])
        try:
            for _seq, op, args, _term in entries:
                try:
                    self._apply(op, args)
                    if self._kv:
                        self.store.stage_entry()
                except Exception as e:
                    if self._kv:
                        self.store.rollback()
                    lvl = (log.warning if isinstance(e, err.CurvineError)
                           else log.error)
                    lvl("follower apply %s failed: %s", op, e)
        except BaseException:
            if self._kv:
                self.store.rollback_group()
            raise
        if self._kv:
            self.store.commit_applied(entries[-1][0])

    def build_install(self, state: dict, seq: int, last_term: int):
        """A snapshot install (a raft catch-up or a divergence's heal)
        replaces the whole state, then drops the log, whose entries may
        be of a superseded history, and writes the snapshot. This is the
        part of it that may run on a worker thread while the loop goes
        on: the new state built into a fresh store (``store.fresh()``: on
        the KV store a new directory, its batch committed under ``seq``
        and flushed), the journal's snapshot file staged, and the files
        open for writing listed. It reads nothing of this filesystem but
        the store's settings. Returns what ``adopt_install`` swaps in."""
        self._check_snapshot(state)
        built = self.store.fresh()
        # a KV store lands its batch in parts (the RAM store has none)
        self._fill_store(built, state,
                         land=built.land_pending if self._kv else None)
        if self._kv:
            built.commit_applied(seq)
            built.close()
        staged = None
        if self.journal is not None:
            staged = self.journal.stage_snapshot(state, seq, last_term)
        # the files open for writing, which the lease recovery would
        # otherwise find by a scan of every inode on the loop
        open_files = {d["id"] for d in state["inodes"]
                      if d["ft"] != int(FileType.DIR) and not d["done"]}
        return built, staged, open_files

    def adopt_install(self, built, state: dict, seq: int,
                      last_term: int) -> None:
        """The swap, on the loop, in the order a crash may stop at any
        step of: the log dropped (a restart then recovers the old state,
        consistent, at its applied seq), the staged snapshot put in place
        (a KV store behind it loads it whole), the built store adopted;
        then the runtime tables the snapshot carries (decommission
        intents, mounts, the stripe index, the raft config) and the
        journal's seq and term."""
        store, staged, open_files = built
        if self.journal is not None:
            self.journal.reset_log()
            self.journal.place_snapshot(staged)
        self.store.adopt(store)
        self.open_files = open_files
        self._adopt_tables(state)
        if self.journal is not None:
            self.journal.seq = seq
            self.journal.last_term = last_term
            self.journal.note_term(seq, last_term)

    def flush_group(self) -> None:
        """Commit any open journal group inline."""
        if self.committer is not None:
            self.committer.flush_sync()

    def checkpoint(self) -> None:
        if self.journal is None:
            return
        self.flush_group()
        if self._kv:
            # the store is the checkpoint: flush its memtable and drop the
            # journal segments it covers; no snapshot is written
            self.store.flush()
            self.journal.gc_covered(self.store.get_counter("applied_seq", 0))
        else:
            self.journal.write_snapshot(self._snapshot_state())
        self._entries_since_snapshot = 0

    def _snapshot_state(self) -> dict:
        """The whole namespace, as the reference's mem-store snapshot."""
        return self.build_snapshot(self.snapshot_cut())

    def snapshot_cut(self):
        """A consistent cut of what a snapshot holds, taken between
        entries on the loop; ``build_snapshot`` turns it into the state.
        On the KV store it is one engine cursor a prefix
        (``store.frozen()``, a cost bounded by the memtable), drained and
        decoded off the loop (a raft leader's snapshot, in a forked
        child: ROADMAP §C, C10); on the mem store the cut is the state
        itself."""
        self.flush_group()
        extra = {"deco": sorted(self.workers.deco_ids)}
        if self.mounts is not None:
            extra["mounts"] = self.mounts.snapshot_state()
        if self.raft_conf is not None:
            extra["raft_conf"] = self.raft_conf
        if self._kv:
            return self.store.frozen(), extra
        return self._state_of(self.store, extra)

    def build_snapshot(self, cut) -> dict:
        """The state of a ``snapshot_cut``."""
        if isinstance(cut, dict):
            return cut
        return self._state_of(*cut)

    @staticmethod
    def _state_of(store, extra: dict) -> dict:
        ch_map: dict[int, dict[str, int]] = {}
        for pid, name, cid in store.iter_children_all():
            ch_map.setdefault(pid, {})[name] = cid
        inodes = []
        for node in store.iter_inodes():
            inodes.append({
                "id": node.id, "name": node.name, "ft": int(node.file_type),
                "pid": node.parent_id, "mtime": node.mtime, "atime": node.atime,
                "owner": node.owner, "group": node.group, "mode": node.mode,
                "xattr": node.x_attr, "sp": node.storage_policy.to_wire(),
                "nlink": node.nlink, "len": node.len, "bs": node.block_size,
                "rep": node.replicas, "blocks": node.blocks,
                "done": node.is_complete, "target": node.target,
                "dir": node.is_dir,
                # explicit entries: a hard-linked inode has a second
                # (parent, name) that (pid, name) cannot carry
                "ch": ch_map.get(node.id, {}) if node.is_dir else None,
            })
        blocks = [(bid, length, iid, rep)
                  for bid, (length, iid, rep) in store.iter_blocks()]
        state = {"next_id": store.get_counter("next_id", ROOT_ID + 1),
                 "next_block_id": store.get_counter("next_block_id", 1),
                 "inodes": inodes, "blocks": blocks,
                 "jobs": list(store.iter_jobs()),
                 "ec": [[bid, stripe] for bid, stripe in store.iter_ec()]}
        state.update(extra)
        return state

    def _load_snapshot(self, snap: dict) -> None:
        self._check_snapshot(snap)
        self.store.clear()
        self.open_files = None       # rebuilt lazily from the new state
        self._fill_store(self.store, snap)
        self._adopt_tables(snap)

    def _check_snapshot(self, snap: dict) -> None:
        if snap.get("mounts") and self.mounts is None:
            raise UnportedJournalOp(
                "the snapshot holds ['mounts'], which the master applies "
                "only with a MountManager attached")

    @staticmethod
    def _fill_store(store, snap: dict, land=None) -> None:
        """Write a snapshot's records into ``store`` (pending, not
        committed; ``land``, when given, is called after each inode and
        may land what is pending). Touches nothing but ``store``, so a
        raft follower runs it on a thread into a fresh store."""
        have_entries = any(d.get("ch") is not None for d in snap["inodes"])
        for d in snap["inodes"]:
            ch = d.get("ch") if have_entries else None
            node = Inode(
                id=d["id"], name=d["name"], file_type=FileType(d["ft"]),
                parent_id=d["pid"], mtime=d["mtime"], atime=d["atime"],
                owner=d["owner"], group=d["group"], mode=d["mode"],
                x_attr=d["xattr"] or {},
                storage_policy=StoragePolicy.from_wire(d["sp"]),
                nlink=d["nlink"], len=d["len"], block_size=d["bs"],
                replicas=d["rep"], blocks=list(d["blocks"]),
                is_complete=d["done"], target=d.get("target"),
                children_num=len(ch) if ch is not None else 0)
            store.put(node, new=True)
            if ch is not None:
                for name, cid in ch.items():
                    store.child_put(node.id, str(name), cid)
            if land is not None:
                land()
        if not have_entries:
            # an older snapshot: the entries come from (parent_id, name)
            counts: dict[int, int] = {}
            for d in snap["inodes"]:
                if d["pid"]:
                    store.child_put(d["pid"], d["name"], d["id"])
                    counts[d["pid"]] = counts.get(d["pid"], 0) + 1
            for pid, n in counts.items():
                parent = store.get(pid)
                if parent is not None:
                    parent.children_num = n
                    store.put(parent)
        store.set_counter("next_id", snap["next_id"])
        store.set_counter("next_block_id", snap["next_block_id"])
        for bid, blen, iid, rep in snap["blocks"]:
            store.block_put(bid, blen, iid, rep)
        for wire in snap.get("jobs", []):
            store.job_put(wire["job_id"], wire)
        for bid, stripe in snap.get("ec", []):
            store.ec_put(bid, stripe)
        for wid in snap.get("deco", []):
            store.deco_put(wid)
        for m in snap.get("mounts") or []:
            store.mount_put(m["cv_path"], MountInfo.from_wire(m).to_wire())

    def _adopt_tables(self, snap: dict) -> None:
        """The runtime tables of a snapshot whose records are in the
        store: the stripe index, the decommission intents, the mount
        table and the raft config."""
        self._rebuild_ec_index()
        self.workers.deco_ids = set(snap.get("deco", []))
        if self.mounts is not None and "mounts" in snap:
            self.mounts.load_snapshot_state(snap["mounts"])
        if snap.get("raft_conf") is not None:
            self.raft_conf = snap["raft_conf"]

    def _apply(self, op: str, args: dict):
        fn = getattr(self, f"_apply_{op}", None)
        if fn is None:
            raise UnportedJournalOp(
                f"journal op {op!r} is not applied by the port's master "
                f"(ROADMAP A3d); args {args}")
        return fn(**args)

    def _apply_noop(self) -> None:
        """A raft leader's term-opening entry."""

    def _apply_raft_conf(self, ver: int = 0, voters: dict | None = None,
                         learners: dict | None = None,
                         action: str | None = None,
                         target: int | None = None) -> None:
        """A raft membership entry: recorded, so that snapshots and replay
        carry it; ``RaftLite`` adopts it."""
        self.raft_conf = {"ver": ver, "voters": dict(voters or {}),
                          "learners": dict(learners or {}),
                          "action": action, "target": target}

    def decommission_worker(self, worker_id: int, on: bool = True) -> None:
        """The journaled decommission intent (off: recommission). A
        worker re-registers by its heartbeats, so the intent cannot live
        in the worker map alone. Recommission takes an absent worker
        too: an intent for a worker long gone must be clearable."""
        if on:
            self.workers.get(worker_id)      # raises WorkerNotFound
        self._log("worker_deco", dict(worker_id=worker_id, on=on))

    def _apply_worker_deco(self, worker_id: int, on: bool) -> None:
        if on:
            self.store.deco_put(worker_id)
            self.workers.decommission(worker_id)
        else:
            self.store.deco_remove(worker_id)
            self.workers.recommission(worker_id)

    def _apply_job_put(self, job: dict) -> None:
        """A job's record, for its resume after a restart."""
        self.store.job_put(job["job_id"], job)

    def _apply_job_del(self, job_id: str) -> None:
        self.store.job_remove(job_id)

    # ==================== erasure-coded stripes ====================

    def ec_plan(self, block_id: int, profile: str, k: int, m: int,
                cell_size: int) -> list[int]:
        """Journal a stripe's cells for ``block_id`` before any cell is
        written; returns their block ids."""
        if self.store.block_get(block_id) is None:
            raise err.InvalidArgument(f"ec_plan: unknown block {block_id}")
        stripe = self.ec_stripes.get(block_id)
        if stripe is not None and stripe.get("state") == "committed":
            raise err.InvalidArgument(
                f"ec_plan: block {block_id} already striped")
        return self._log("ec_plan", dict(
            block_id=block_id, profile=profile, n_cells=k + m,
            cell_size=cell_size))

    def _apply_ec_plan(self, block_id: int, profile: str, n_cells: int,
                       cell_size: int) -> list[int]:
        durable = self.store.block_get(block_id)
        if durable is None:
            raise err.InvalidArgument(f"ec_plan: unknown block {block_id}")
        blen, inode_id, _rep = durable
        # a re-plan (a job resumed after a crash) frees the previous
        # attempt's cells: abandoned ids never stay in the block table
        old = self.ec_stripes.get(block_id)
        if old is not None and old.get("state") != "committed":
            for cid in old.get("cells", []):
                meta = self.blocks.remove_block(cid)
                if meta:
                    for wid in meta.locs:
                        self.pending_deletes.setdefault(wid, set()).add(cid)
        # the ids come from alloc_block's counter, inside the apply, so
        # a replay of either package's journal gives the same ids
        cells = [self.tree.alloc_block_id() for _ in range(n_cells)]
        for cid in cells:
            self.store.block_put(cid, cell_size, inode_id, 1)
        stripe = {"profile": profile, "cell_size": cell_size,
                  "block_len": blen, "cells": cells, "state": "planned"}
        self.store.ec_put(block_id, stripe)
        self._ec_index(block_id, stripe)
        return cells

    def ec_commit(self, block_id: int, cell_locs: list[list[int]]) -> None:
        """EC_COMMIT_STRIPE: every cell is written. ``cell_locs`` is
        [[cell_id, worker_id, storage_type], ...]."""
        stripe = self.ec_stripes.get(block_id)
        if stripe is None:
            raise err.InvalidArgument(
                f"ec_commit: no planned stripe for block {block_id}")
        known = set(stripe.get("cells", []))
        for cid, _wid, _st in cell_locs:
            if cid not in known:
                raise err.InvalidArgument(
                    f"ec_commit: cell {cid} not in stripe {block_id}")
        if stripe.get("state") != "committed":
            self._log("ec_put", dict(block_id=block_id))
        # the cells' holders are runtime state (rebuilt by reports)
        for cid, wid, st in cell_locs:
            self.blocks.add_replica(cid, wid, StorageType(st))
            self._fresh_cells.setdefault(wid, set()).add(cid)
        self.retire_stripe_replicas(block_id)

    def _apply_ec_put(self, block_id: int) -> None:
        stripe = self.store.ec_get(block_id)
        if stripe is None:
            raise err.InvalidArgument(
                f"ec_put: no planned stripe for block {block_id}")
        stripe = dict(stripe)
        stripe["state"] = "committed"
        self.store.ec_put(block_id, stripe)
        self._ec_index(block_id, stripe)

    def retire_stripe_replicas(self, block_id: int) -> None:
        """Drop a committed stripe's replicated copies (runtime only: the
        deletes ride the holders' heartbeats). The replication scan runs
        this again until no location is left, so a crash between
        ``ec_put`` and the deletes strands no replica."""
        meta = self.blocks.get(block_id)
        if meta is None:
            return
        for wid in list(meta.locs):
            self.blocks.remove_replica(block_id, wid)
            self.pending_deletes.setdefault(wid, set()).add(block_id)
            self._retired.setdefault(wid, set()).add(block_id)

    def _ec_descriptor(self, block_id: int) -> dict | None:
        """A committed stripe's descriptor for a located block: each
        cell's id and its serving holders' addresses (wire form). None
        for a replicated block and for a stripe still being converted
        (its replicas serve)."""
        stripe = self.ec_stripes.get(block_id)
        if stripe is None or stripe.get("state") != "committed":
            return None
        cells = []
        for idx, cid in enumerate(stripe["cells"]):
            clocs = []
            for wid in self.blocks.locs.get(cid, {}):
                w = self.workers.workers.get(wid)
                if w is not None and w.state in (
                        WorkerState.LIVE, WorkerState.DECOMMISSIONING):
                    clocs.append(w.address.to_wire())
            cells.append({"index": idx, "block_id": cid, "locs": clocs})
        return {"profile": stripe["profile"],
                "cell_size": stripe["cell_size"],
                "block_len": stripe["block_len"], "cells": cells}

    # ==================== namespace ops ====================

    def mkdir(self, path: str, create_parent: bool = True, mode: int = 0o755,
              owner: str = "root", group: str = "root",
              x_attr: dict | None = None) -> FileStatus:
        self._mount_write_guard(path)
        node = self.tree.resolve(path)
        if node is not None:
            if node.is_dir:
                return node.to_status(path)
            raise err.FileAlreadyExists(f"{path} exists and is a file")
        self.tree.check_parent_dirs(path)
        parent, _ = self.tree.resolve_parent(path)
        if parent is None and not create_parent:
            raise err.FileNotFound(f"parent of {path} not found")
        return self._log("mkdir", dict(path=path, create_parent=create_parent,
                                       mode=mode, owner=owner, group=group,
                                       x_attr=x_attr or {}))

    def _apply_mkdir(self, path: str, create_parent: bool, mode: int,
                     owner: str, group: str, x_attr: dict) -> FileStatus:
        node, _ = self.tree.mkdirs(path, mode=mode, owner=owner, group=group,
                                   create_parent=create_parent, x_attr=x_attr)
        return node.to_status(path)

    def create_file(self, path: str, overwrite: bool = False,
                    create_parent: bool = True, replicas: int = 1,
                    block_size: int = 64 * 1024 * 1024, mode: int = 0o644,
                    owner: str = "root", group: str = "root",
                    client_name: str = "", x_attr: dict | None = None,
                    storage_policy: dict | None = None,
                    file_type: int = int(FileType.FILE)) -> FileStatus:
        # a cache-warming load carries the ufs_mtime it saw; such creates
        # pass a read-only mount
        caching = bool((storage_policy or {}).get("ufs_mtime"))
        self._mount_write_guard(path, caching=caching)
        parent, _name, existing = self.tree.walk_parent(path)
        if existing is not None:
            if existing.is_dir:
                raise err.IsADirectory(path)
            if not overwrite:
                raise err.FileAlreadyExists(path)
        if parent is None and not create_parent:
            raise err.FileNotFound(f"parent of {path} not found")
        return self._log("create", dict(
            path=path, overwrite=overwrite, create_parent=create_parent,
            replicas=replicas, block_size=block_size, mode=mode,
            owner=owner, group=group, client_name=client_name,
            x_attr=x_attr or {},
            storage_policy=storage_policy or dict(_DEFAULT_POLICY_WIRE),
            file_type=file_type))

    def _apply_create(self, path: str, overwrite: bool, create_parent: bool,
                      replicas: int, block_size: int, mode: int, owner: str,
                      group: str, client_name: str, x_attr: dict,
                      storage_policy: dict, file_type: int) -> FileStatus:
        parent, name, existing = self.tree.walk_parent(path)
        if existing is not None:
            self._delete_inode(existing, recursive=False, parent=parent,
                               name=name)
        if parent is None:
            parent, _ = self.tree.mkdirs("/".join(path.split("/")[:-1]) or "/")
        if not parent.is_dir:
            raise err.NotADirectory(self.tree.path_of(parent))
        ts = now_ms()
        node = Inode(id=self.tree._alloc_id(), name=name,
                     file_type=FileType(file_type), parent_id=parent.id,
                     mtime=ts, atime=ts, owner=owner, group=group,
                     mode=mode, x_attr=dict(x_attr),
                     storage_policy=StoragePolicy.from_wire(storage_policy),
                     replicas=replicas, block_size=block_size,
                     is_complete=False, client_name=client_name)
        self.tree.add_child(parent, node)
        if self.open_files is not None:
            self.open_files.add(node.id)
        return node.to_status(path)

    def exists(self, path: str) -> bool:
        return self.tree.resolve(path) is not None

    def file_status(self, path: str) -> FileStatus:
        node = self.tree.resolve(path)
        if node is None:
            raise err.FileNotFound(path)
        return node.to_status(path)

    def list_status(self, path: str) -> list[FileStatus]:
        node = self.tree.resolve(path)
        if node is None:
            raise err.FileNotFound(path)
        if not node.is_dir:
            return [node.to_status(path)]
        base = path.rstrip("/")
        return [child.to_status(f"{base}/{name}")
                for name, child in self.tree.children(node)]

    def set_attr(self, path: str, opts: SetAttrOpts) -> None:
        self._mount_write_guard(path)
        if self.tree.resolve(path) is None:
            raise err.FileNotFound(path)
        if opts.ec:
            ECProfile.parse(opts.ec)          # validated before journaling
        self._log("set_attr", dict(path=path, opts=opts.to_wire()))

    def _apply_set_attr(self, path: str, opts: dict) -> None:
        node = self.tree.resolve(path)
        if node is None:
            raise err.FileNotFound(path)
        o = SetAttrOpts.from_wire(opts)
        if o.replicas is not None:
            node.replicas = o.replicas
        if o.owner is not None:
            node.owner = o.owner
        if o.group is not None:
            node.group = o.group
        if o.mode is not None:
            node.mode = o.mode
        if o.ttl_ms is not None:
            node.storage_policy.ttl_ms = o.ttl_ms
        if o.ttl_action is not None:
            node.storage_policy.ttl_action = TtlAction(o.ttl_action)
        if o.atime is not None:
            node.atime = o.atime
        if o.mtime is not None:
            node.mtime = o.mtime
        if o.ec is not None:
            node.storage_policy.ec = o.ec
        node.x_attr.update(o.add_x_attr)
        for k in o.remove_x_attr:
            node.x_attr.pop(k, None)
        self.tree.save(node)

    def rename(self, src: str, dst: str) -> bool:
        self._mount_write_guard(src, subtree=True)
        self._mount_write_guard(dst)
        s = self.tree.resolve(src)
        if s is None:
            raise err.FileNotFound(src)
        if src == "/" or dst.startswith(src.rstrip("/") + "/"):
            raise err.InvalidArgument(f"cannot rename {src} into itself")
        d = self.tree.resolve(dst)
        if d is not None:
            if d.is_dir and d.children_num:
                raise err.DirNotEmpty(dst)
            if d.is_dir != s.is_dir:
                raise (err.IsADirectory if d.is_dir else err.NotADirectory)(dst)
        self.tree.check_parent_dirs(dst)
        return self._log("rename", dict(src=src, dst=dst))

    def _apply_rename(self, src: str, dst: str) -> bool:
        s = self.tree.resolve(src)
        if s is None:
            raise err.FileNotFound(src)
        d = self.tree.resolve(dst)
        if d is not None:
            p, n = self.tree.resolve_parent(dst)
            self._delete_inode(d, recursive=False, parent=p, name=n)
        new_parent, new_name = self.tree.resolve_parent(dst)
        if new_parent is None or not new_parent.is_dir:
            raise err.FileNotFound(f"parent of {dst} not found")
        # move the directory entry (the path's tail, which for a hard
        # link can differ from s.name)
        old_parent, old_name = self.tree.resolve_parent(src)
        self.store.child_remove(old_parent.id, old_name)
        old_parent.children_num = max(0, old_parent.children_num - 1)
        old_parent.mtime = now_ms()
        self.tree.save(old_parent)
        s.name = new_name
        new_parent = self.tree.get(new_parent.id)
        s.parent_id = new_parent.id
        self.tree.save(s)
        self.store.child_put(new_parent.id, new_name, s.id)
        new_parent.children_num += 1
        new_parent.mtime = now_ms()
        self.tree.save(new_parent)
        return True

    def delete(self, path: str, recursive: bool = False) -> None:
        self._mount_write_guard(path, subtree=recursive)
        node = self.tree.resolve(path)
        if node is None:
            raise err.FileNotFound(path)
        if node.is_dir and node.children_num and not recursive:
            raise err.DirNotEmpty(path)
        if node.id == ROOT_ID:
            raise err.InvalidArgument("cannot delete root")
        self._log("delete", dict(path=path, recursive=recursive))

    def _apply_delete(self, path: str, recursive: bool) -> None:
        node = self.tree.resolve(path)
        if node is None:
            raise err.FileNotFound(path)
        parent, name = self.tree.resolve_parent(path)
        self._delete_inode(node, recursive, parent=parent, name=name)

    def _delete_inode(self, node: Inode, recursive: bool,
                      parent: Inode | None = None,
                      name: str | None = None) -> None:
        """``name`` is the directory entry removed (for a hard-linked
        inode it can differ from ``node.name``)."""
        if node.is_dir and node.children_num:
            if not recursive:
                raise err.DirNotEmpty(self.tree.path_of(node))
            for child_name, child in self.tree.children(node):
                self._delete_inode(child, recursive=True,
                                   parent=node, name=child_name)
        if parent is None:
            parent = self.tree.get(node.parent_id)
        if parent is not None:
            removed = self.tree.remove_child(parent, name or node.name)
            if removed is not None and removed.nlink <= 0:
                self._free_blocks(removed)
                if self.open_files is not None:
                    self.open_files.discard(removed.id)

    def _free_blocks(self, node: Inode) -> None:
        """Drop the node's blocks, a stripe's cells with its block; each
        holder deletes its copy at its next heartbeat. The inode is not
        saved (it left the store)."""
        for bid in node.blocks:
            stripe = self.ec_stripes.pop(bid, None)
            if stripe is not None:
                for cid in stripe.get("cells", []):
                    self.ec_cells.pop(cid, None)
                    cmeta = self.blocks.remove_block(cid)
                    if cmeta:
                        for wid in cmeta.locs:
                            self.pending_deletes.setdefault(
                                wid, set()).add(cid)
                self.store.ec_remove(bid)
            meta = self.blocks.remove_block(bid)
            if meta:
                for wid in meta.locs:
                    self.pending_deletes.setdefault(wid, set()).add(bid)
        node.blocks = []

    # ==================== block ops ====================

    def add_block(self, path: str, client_host: str = "",
                  exclude_workers: list[int] | None = None,
                  commit_blocks: list[CommitBlock] | None = None,
                  ici_coords: list[int] | None = None,
                  storage_type: StorageType = StorageType.MEM,
                  abandon_block: int | None = None) -> LocatedBlock:
        node = self._file_or_raise(path)
        if node.is_complete:
            raise err.LeaseConflict(f"{path} is not open for writing")
        self._commit(node, commit_blocks)
        try:
            chosen = self.policy.choose(
                self.workers.live_workers(), max(1, node.replicas),
                client_host=client_host, exclude=set(exclude_workers or []),
                needed=node.block_size, ici_coords=ici_coords, min_count=1)
        except err.NoAvailableWorker:
            self._await_workers()
            raise
        args = dict(inode_id=node.id)
        # abandonBlock: a writer retrying a failed block open drops its
        # previous allocation in the same entry, if it is the trailing,
        # never-committed block
        if abandon_block is not None and node.blocks \
                and node.blocks[-1] == abandon_block:
            meta = self.blocks.get(abandon_block)
            if meta is None or meta.len == 0:
                args["abandon"] = abandon_block
        block_id = self._log("alloc_block", args)
        block = ExtendedBlock(id=block_id, len=0, storage_type=storage_type,
                              file_type=node.file_type)
        node = self.tree.get(node.id)
        off = sum(meta.len for b in node.blocks[:-1]
                  if (meta := self.blocks.get(b)) is not None)
        return LocatedBlock(block=block, offset=off,
                            locs=[w.address for w in chosen],
                            storage_types=[storage_type] * len(chosen))

    def _await_workers(self) -> None:
        """Beyond the reference: a restarted master (its recovery found
        applied entries) that no worker has reached since it started (the
        worker map is runtime state) answers a placement that finds no
        worker with the retryable IN_PROGRESS, until the lost timeout has
        passed since its start; the reference answers NO_AVAILABLE_WORKER,
        which fails the writer. A worker's heartbeat back-off stops at
        half the lost timeout (``WorkerServer.heartbeat_once``), so a
        worker alive through the outage, however long, reaches the master
        inside that window. A fresh master answers as the reference does.
        ROADMAP §C, C9."""
        waited = time.monotonic() - self._started
        if self.recovery.get("applied_seq") and not self.workers.workers \
                and waited * 1000 < self.workers.lost_timeout_ms:
            raise err.CurvineError(
                f"no worker has reached this master since its restart "
                f"{waited:.1f}s ago", code=err.ErrorCode.IN_PROGRESS)

    def _apply_alloc_block(self, inode_id: int,
                           abandon: int | None = None) -> int:
        node = self._inode_or_raise(inode_id)
        if abandon is not None and node.blocks \
                and node.blocks[-1] == abandon:
            node.blocks.pop()
            self.blocks.remove_block(abandon)
        block_id = self.tree.alloc_block_id()
        node.blocks.append(block_id)
        node.mtime = now_ms()      # the writer's liveness, for lease recovery
        self.tree.save(node)
        # a placeholder: a report of this block in flight is no orphan
        if self.store.block_get(block_id) is None:
            self.store.block_put(block_id, 0, inode_id, node.replicas)
        return block_id

    def complete_file(self, path: str, length: int,
                      commit_blocks: list[CommitBlock] | None = None,
                      only_flush: bool = False) -> bool:
        node = self._file_or_raise(path)
        self._commit(node, commit_blocks)
        if not only_flush:
            self._log("complete", dict(path=path, length=length))
        return True

    def _apply_complete(self, path: str, length: int) -> None:
        node = self._file_or_raise(path)
        node.len = length
        node.is_complete = True
        node.mtime = now_ms()
        node.client_name = ""
        self.tree.save(node)
        if self.open_files is not None:
            self.open_files.discard(node.id)

    def _commit(self, node: Inode, commit_blocks: list[CommitBlock] | None
                ) -> None:
        """Journal the blocks' lengths (durable), then register their
        replicas (runtime, rebuilt from reports after a restart)."""
        if not commit_blocks:
            return
        self._log("commit_blocks", dict(
            inode_id=node.id,
            commits=[[cb.block_id, cb.block_len] for cb in commit_blocks]))
        for cb in commit_blocks:
            for wid in cb.worker_ids:
                self.blocks.add_replica(cb.block_id, wid, cb.storage_type)

    def _apply_commit_blocks(self, inode_id: int, commits: list) -> None:
        node = self.tree.get(inode_id)
        replicas = node.replicas if node is not None else 1
        for bid, blen in commits:
            durable = self.store.block_get(bid)
            if durable is None:
                self.store.block_put(bid, blen, inode_id, replicas)
            else:
                old_len, iid, rep = durable
                self.store.block_put(bid, max(old_len, blen),
                                     iid or inode_id, rep)

    def get_block_locations(self, path: str) -> FileBlocks:
        node = self._file_or_raise(path)
        out = []
        off = 0
        for bid in node.blocks:
            meta = self.blocks.get(bid)
            if meta is None:
                continue
            locs, sts = [], []
            for wid, loc in meta.locs.items():
                w = self.workers.workers.get(wid)
                # a draining worker's replicas serve until the drain ends
                if w is not None and w.state in (
                        WorkerState.LIVE, WorkerState.DECOMMISSIONING):
                    locs.append(w.address)
                    sts.append(loc.storage_type)
            out.append(LocatedBlock(
                block=ExtendedBlock(id=bid, len=meta.len,
                                    storage_type=sts[0] if sts
                                    else StorageType.MEM,
                                    file_type=node.file_type),
                offset=off, locs=locs, storage_types=sts,
                ec=self._ec_descriptor(bid)))
            off += meta.len
        return FileBlocks(status=node.to_status(path), block_locs=out)

    # ==================== worker plane ====================

    def worker_heartbeat(self, info_wire: dict) -> dict:
        info = WorkerInfo.from_wire(info_wire)
        w = self.workers.heartbeat(info.address, info.storages,
                                   info.ici_coords)
        wid = info.address.worker_id
        cmds = {"delete_blocks": list(self.pending_deletes.pop(wid, set()))}
        if w.state in (WorkerState.LIVE, WorkerState.DECOMMISSIONING) \
                and not self.workers.has_current_report(wid):
            # no full report since the worker (re)registered, or since
            # this master started: ask for one now, reads need locations
            cmds["report_now"] = True
        if w.state == WorkerState.DECOMMISSIONING:
            # the worker refuses new write streams (in-flight ones end),
            # so no fresh upload races the drain
            cmds["draining"] = True
        return cmds

    def worker_block_report(self, worker_id: int, held: dict,
                            storage_types: dict,
                            incremental: bool = False) -> dict:
        w = self.workers.workers.get(worker_id)
        if w is not None and w.state == WorkerState.DECOMMISSIONED:
            # its copies were dropped from the block map when the drain
            # ended: a report must not make them count again
            return {"delete_blocks": []}
        held = {int(k): int(v) for k, v in held.items()}
        storage_types = {int(k): int(v) for k, v in storage_types.items()}
        # a report built before a retired replica's delete lists it
        # still: it is deleted again, not located again
        retired = self._retired.get(worker_id, set())
        again = sorted(retired & held.keys())
        for bid in again:
            del held[bid]
        if incremental:
            self._fresh_cells.setdefault(worker_id, set()).update(
                b for b in held if b in self.ec_cells)
            keep: set[int] = set()
        else:
            if again:
                self._retired[worker_id] = set(again)
            else:
                self._retired.pop(worker_id, None)
            keep = self._fresh_cells.pop(worker_id, set())
        orphans = self.blocks.apply_report(worker_id, held, storage_types,
                                           incremental=incremental,
                                           keep=keep)
        if not incremental:
            self.workers.mark_reported(worker_id)
        # a report's length bumps are durable but not journaled: they
        # land now, not with some later entry's batch
        self.store.commit_runtime()
        return {"delete_blocks": orphans + again}

    def recover_stale_leases(self, lease_timeout_ms: int = 300_000) -> int:
        """Finish the files abandoned mid-write (a dead client, no
        complete): complete one at its committed length, or delete it
        when nothing was committed."""
        deadline = now_ms() - lease_timeout_ms
        recovered = 0
        if self.open_files is None:
            self.open_files = {n.id for n in self.tree.iter_files()
                               if not n.is_complete}
        for inode_id in list(self.open_files):
            node = self.tree.get(inode_id)
            if node is None or node.is_dir or node.is_complete:
                self.open_files.discard(inode_id)
                continue
            if node.mtime >= deadline:
                continue
            path = self.tree.path_of(node)
            committed = sum(m.len for b in node.blocks
                            if (m := self.blocks.get(b)) is not None)
            try:
                if committed > 0:
                    self._log("complete", dict(path=path, length=committed))
                    log.warning("lease recovery: completed %s at %d bytes",
                                path, committed)
                else:
                    self._log("delete", dict(path=path, recursive=False))
                    log.warning("lease recovery: removed empty stale %s",
                                path)
                recovered += 1
            except err.CurvineError as e:
                log.warning("lease recovery of %s failed: %s", path, e)
        return recovered

    def check_lost_workers(self, act: bool = True) -> list[WorkerInfo]:
        """Mark the workers whose heartbeat expired LOST and drop their
        replicas (every node: reads filter locations on a worker's state),
        and with ``act`` hand the blocks they held to ``on_worker_lost``
        (a raft follower starts no repair)."""
        newly_lost = self.workers.check_lost()
        for w in newly_lost:
            affected = self.blocks.worker_lost(w.address.worker_id)
            if act and affected and self.on_worker_lost:
                self.on_worker_lost(w, affected)
        return newly_lost

    def master_info(self, addr: str = "") -> MasterInfo:
        cap, avail = self.workers.capacity()
        return MasterInfo(
            active_master=addr, inode_num=self.tree.count(),
            block_num=self.blocks.count(), capacity=cap, available=avail,
            fs_used=cap - avail,
            # draining workers still serve and report: they are listed
            # live (their state says the rest); drained ones ride the
            # lost list, the safe-to-remove signal
            live_workers=self.workers.serving_workers(),
            lost_workers=(self.workers.lost_workers()
                          + self.workers.retired_workers()))

    # ==================== helpers ====================

    def _mount_write_guard(self, path: str, caching: bool = False,
                           subtree: bool = False) -> None:
        """A write under a read-only mount is refused, here on the master
        so every client meets it. A cache-warming load passes (its create
        carries ``ufs_mtime``: a marker the client sets, not an
        authorisation). ``subtree`` ops (a recursive delete, a rename of
        an ancestor) are refused when a read-only mount lies anywhere
        under the path too."""
        if self.mounts is None or caching:
            return
        m = self.mounts.get_mount(path)
        if m is not None and m.access_mode == "r":
            raise err.Unsupported(
                f"write on read-only mount {m.cv_path}: {path}")
        if subtree:
            prefix = path.rstrip("/") + "/"
            for info in self.mounts.table():
                if info.access_mode == "r" and \
                        info.cv_path.startswith(prefix):
                    raise err.Unsupported(
                        f"{path} contains read-only mount {info.cv_path}")

    def _file_or_raise(self, path: str) -> Inode:
        node = self.tree.resolve(path)
        if node is None:
            raise err.FileNotFound(path)
        if node.is_dir:
            raise err.IsADirectory(path)
        return node

    def _inode_or_raise(self, inode_id: int) -> Inode:
        node = self.tree.get(inode_id)
        if node is None:
            raise err.FileNotFound(f"inode {inode_id}")
        return node
