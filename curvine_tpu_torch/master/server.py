"""The master's RPC server: codes → ``MasterFilesystem``.

A carve of ``curvine_tpu/master/server.py``. The namespace has one
writer: every handler runs on the server's event loop, so mutations are
serialised without locks. Every request's path fields are normalised
first (``_norm_req``, :486-495: ``.`` and ``..`` resolved, a path out
of the root refused). A mutation (``_h``, :497-534) is deduplicated by
the client's ``(client_id, call_id)`` in the retry cache, and its reply
leaves only after the group commit has flushed its journal entry (and
landed its KV batch). The metadata store is built as the reference
builds it (:52-57): on ``meta_store = "kv"`` a ``KvMetaStore`` in
``meta_dir`` (``<journal_dir>-meta`` when empty) on ``meta_engine``,
on ``"mem"`` the mem store; ``stop()`` closes it (the KV store flushes
its memtable).

Served: MKDIR, DELETE, CREATE_FILE, OPEN_FILE, FILE_STATUS, LIST_STATUS
and EXISTS (each falling back to the mount's UFS for a path the cache
does not hold, :672-764: LIST_STATUS merges the cached entries over the
UFS entries and sorts them by name), RENAME, ADD_BLOCK (with the
client's ``ici_coords`` for the ``ici`` placement), COMPLETE_FILE,
GET_BLOCK_LOCATIONS, GET_MASTER_INFO and META_BATCH (mkdir, create and
delete items, each failing alone, :1142-1163), SET_ATTR (:989-996:
owner, group, mode, replicas, TTL fields, times, xattrs and the ``ec``
storage class, journaled by ``set_attr``; the TTL fields are stored,
and nothing acts on them yet); the mount table (MOUNT,
UNMOUNT, UPDATE_MOUNT, GET_MOUNT_TABLE, GET_MOUNT_INFO;
``master/mount.py``) and the job manager (SUBMIT_JOB, GET_JOB_STATUS,
CANCEL_JOB, PREFETCH_WINDOW, and REPORT_TASK from the workers;
``master/jobs.py``), :1293-1355, MOUNT, UNMOUNT, UPDATE_MOUNT,
SUBMIT_JOB, CANCEL_JOB and PREFETCH_WINDOW deduplicated as mutations;
and the worker plane: WORKER_HEARTBEAT (its ``hbm_blocks``
handed to the replication manager as device-path hints, :1193-1196, its
``evac_blocks`` to its evacuations, its ``metrics`` summed into the
``bytes.read`` and ``bytes.written`` gauges), WORKER_BLOCK_REPORT,
REQUEST_REPLACEMENT_WORKER (:1212-1215), REPORT_BLOCK_REPLICATION_RESULT
(:1275-1280), REPORT_UNDER_REPLICATED_BLOCKS (:1230-1273): verdicts
noted, a replica reported with its ``worker_id`` evacuated (flagged, it
stops counting and is retired once the block is back at its count), a
report without one enqueued (a client's lost stripe cells behind a
degraded read, counted as ``ec.degraded_reads``), and ``confirm_live``
answered; EC_COMMIT_STRIPE (:1282-1290): a converting worker's cells
registered and the stripe committed (``ec.stripes_committed``); and
DECOMMISSION_WORKER (:1217-1229): the superuser's journaled intent, on
or off, answered with the worker's state (-1 for a worker the master
has not seen). At start the mount table is rebuilt from the store after
the journal's recovery, and the store's decommission intents are put
back into the worker map (:202-205). The replication manager
(``master/replication.py``, :100-103, :258-259: the re-replication
queue, its scan and the decommission drain) and the job manager's
dispatch (which recovers the journaled jobs first, :260) run on the
``ScheduledExecutor`` beside the periodic ``heartbeat-check`` (lost
workers, whose blocks it re-replicates) and ``lease-recovery`` ticks;
``stop()`` cancels them and closes their connections. Every request is
timed into the ``rpc.<code name>`` histograms of ``metrics``; the
``replication.*`` counters are summed there too.

Raft HA (:152-168, :213-214, :314-315): with ``raft_peers`` set the
master runs ``master/ha.py``'s ``RaftLite`` (node ``raft_node_id``, the
peers' addresses in node order), which serves RAFT_VOTE through
RAFT_STATUS. Every mutation is refused NOT_LEADER on a follower, with the
leader's address and the members as hints (:511-512), and its reply
waits for its entry's commit on a quorum after the group's flush
(``_commit_barrier``, :598-610). The periodic duties that act on the
namespace run on the leader only (:218-290): the replication queue and
scan, job dispatch, lease recovery and a lost worker's repair; the LOST
bookkeeping itself runs on every node. REPORT_UNDER_REPLICATED_BLOCKS
answers NOT_LEADER on a follower, so that the worker turns to the leader
(:1229-1234). Beyond the reference (ROADMAP §C, C12), a follower's answer
to a block report names no orphan: the worker deletes what any master
names, and a follower that lags the leader, or a wiped one installing a
snapshot, would name the blocks written since. Beyond the reference
too (C16), GET_BLOCK_LOCATIONS on a follower that cannot locate a
replicated block while a serving worker has yet to report to it (since
it started, or installed a snapshot) answers NOT_LEADER, counted in
``raft.reads_to_leader``: the client reads through the leader.
RAFT_MEMBER_CHANGE (a
mutation: its answer comes once the config entry commits) and
RAFT_TRANSFER (:403-410, :971-987) answer UNSUPPORTED on a master
without raft.

Tracing (:133-149, :1066-1115): the master's ``Tracer``
(``obs/trace.py``, from the ``[obs]`` table) is its RPC server's
``obs`` and the replication manager's, which roots a trace at each
dispatch. METRICS_REPORT takes a client's counter deltas into
``metrics`` as ``client.<name>`` (the ``--metrics-out`` dump's counters
carry them) and its finished spans into the store; GET_SPANS answers
the store's spans of one trace, and with ``collect`` merges every
serving worker's (GET_SPANS to each, within
``obs/trace.py::COLLECT_TIMEOUT_MS``: ``collect_trace``). Neither
checks the caller, as in the reference.

Every other request but a worker's must come from the superuser
(``acl.SuperuserGate``). Every other code the reference's master
registers (:340-410, ``rpc/codes.py::MASTER_REFUSED``) is answered
UNSUPPORTED by name: locks, quotas, shards, batches other
than META_BATCH, links, appends and health. Read leases and the fast
metadata port are not served: a read's reply carries no ``lease`` token and
``master_info`` no ``fast_addr``, so a client caches nothing (ROADMAP
A3d)."""

from __future__ import annotations

import asyncio
import inspect
import logging

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import MASTER_FIXED, ClusterConf
from curvine_tpu_torch.common.executor import ScheduledExecutor
from curvine_tpu_torch.common.journal import GroupCommitter, Journal
from curvine_tpu_torch.common.metrics import MetricsRegistry
from curvine_tpu_torch.common.path import norm_path
from curvine_tpu_torch.common.types import CommitBlock, SetAttrOpts
from curvine_tpu_torch.master.acl import SuperuserGate
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.master.ha import RaftLite
from curvine_tpu_torch.master.jobs import JobManager
from curvine_tpu_torch.master.mount import MountManager
from curvine_tpu_torch.master.replication import ReplicationManager
from curvine_tpu_torch.master.retry_cache import RetryCache
from curvine_tpu_torch.master.store import KvMetaStore
from curvine_tpu_torch.obs.trace import COLLECT_TIMEOUT_MS, Tracer
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import MASTER_REFUSED, RpcCode
from curvine_tpu_torch.rpc.frame import Message, pack, unpack
from curvine_tpu_torch.rpc.server import RpcServer, ServerConn

log = logging.getLogger(__name__)

LEASE_RECOVERY_S = 30.0


class MasterServer:
    def __init__(self, conf: ClusterConf | None = None):
        self.conf = conf or ClusterConf()
        mc = self.conf.master
        j = Journal(mc.journal_dir, fsync=mc.journal_fsync)
        store = None
        if mc.meta_store == "kv":
            store = KvMetaStore(
                mc.meta_dir or mc.journal_dir.rstrip("/") + "-meta",
                fsync=mc.journal_fsync,
                cache_inodes=MASTER_FIXED["meta_cache_inodes"],
                engine=mc.meta_engine)
        self.fs = MasterFilesystem(
            journal=j, placement=mc.block_placement_policy,
            lost_timeout_ms=mc.worker_lost_timeout_ms,
            snapshot_interval=mc.snapshot_interval_entries,
            ici_mesh_shape=mc.ici_mesh_shape or None, store=store)
        self.metrics = MetricsRegistry("master")
        self.fs.committer = GroupCommitter(
            j, self.fs.store, window_ms=mc.journal_group_commit_ms,
            max_entries=mc.journal_group_max)
        self.acl = SuperuserGate(mc.superuser, mc.supergroup)
        self.retry_cache = RetryCache(mc.retry_cache_size,
                                      mc.retry_cache_ttl_ms)
        self.replication = ReplicationManager(
            self.fs, pull_budget_ms=mc.replication_pull_budget_ms,
            metrics=self.metrics)
        self.fs.on_worker_lost = self.replication.on_worker_lost
        self.mounts = MountManager(self.fs)
        self.fs.mounts = self.mounts
        self.jobs = JobManager(self.fs, self.mounts, self.conf.ec)
        self.rpc = RpcServer(mc.hostname, mc.rpc_port, "master",
                             rpc_conf=self.conf.rpc)
        self.rpc.metrics = self.metrics
        # a server span per dispatch; the store also holds the spans the
        # clients push, so one GET_SPANS collect sees both sides
        self.tracer = Tracer.from_conf("master", self.conf.obs,
                                       metrics=self.metrics)
        self.rpc.obs = self.tracer
        self.replication.tracer = self.tracer
        # the collect's GET_SPANS to the workers, each within its timeout
        self._obs_pool = ConnectionPool(
            size=1, timeout_ms=COLLECT_TIMEOUT_MS,
            rpc_conf=self.conf.rpc)
        self.executor = ScheduledExecutor("master")
        # worker_id -> its last heartbeat's byte counters
        self._worker_counters: dict[int, dict] = {}
        self.raft: RaftLite | None = None
        if mc.raft_peers:
            peers = {i + 1: addr for i, addr in enumerate(mc.raft_peers)
                     if i + 1 != mc.raft_node_id}
            if 0 < mc.raft_node_id <= len(mc.raft_peers):
                self_addr = mc.raft_peers[mc.raft_node_id - 1]
            else:
                self_addr = f"{mc.hostname}:{mc.rpc_port}"
            self.raft = RaftLite(
                mc.raft_node_id, peers, self.fs, self.rpc,
                self_addr=self_addr, learner=mc.raft_learner,
                promote_lag=MASTER_FIXED["raft_promote_lag"],
                snapshot_chunk_bytes=(
                    MASTER_FIXED["raft_snapshot_chunk_mb"] * 1024 * 1024),
                transfer_timeout_s=(
                    MASTER_FIXED["raft_transfer_timeout_ms"] / 1000),
                metrics=self.metrics)
            self.fs.on_mutation = self.raft.on_mutation
        self._register_handlers()

    @property
    def addr(self) -> str:
        return self.rpc.addr

    async def start(self) -> None:
        self.fs.recover()
        self.mounts.load_from_store()
        # the durable decommission intents
        self.fs.workers.deco_ids |= set(self.fs.store.iter_deco())
        await self.rpc.start()
        if self.raft is not None:
            await self.raft.start()
        # a follower acting on replicated state would append entries of
        # its own: every duty that acts is gated on leadership
        gate = self._is_leader
        self.executor.submit_periodic(
            "heartbeat-check", self._heartbeat_tick,
            self.conf.master.heartbeat_check_ms / 1000)
        self.executor.submit_periodic("lease-recovery",
                                      self._lease_recovery_tick,
                                      LEASE_RECOVERY_S)
        self.executor.submit("replication",
                             self.replication.run(leader_gate=gate))
        self.executor.submit("jobs", self.jobs.run(leader_gate=gate))
        log.info("master started at %s", self.addr)

    def _is_leader(self) -> bool:
        return self.raft is None or self.raft.is_leader

    def _lease_recovery_tick(self) -> None:
        if self._is_leader():
            self.fs.recover_stale_leases()

    def _heartbeat_tick(self) -> None:
        # the LOST bookkeeping runs on every node (reads filter their
        # locations on it); the repair it starts, on the leader only
        self.fs.check_lost_workers(act=self._is_leader())
        self._prune_worker_counters()

    def _prune_worker_counters(self) -> None:
        """Sum the serving workers' byte counters into the gauges (a
        draining worker still serves and reports); a lost or drained
        worker's last counters leave them."""
        live = {w.address.worker_id
                for w in self.fs.workers.serving_workers()}
        self._worker_counters = {k: v for k, v in
                                 self._worker_counters.items() if k in live}
        for name in ("bytes.read", "bytes.written"):
            self.metrics.gauge(name, sum(
                c.get(name, 0) for c in self._worker_counters.values()))

    async def stop(self) -> None:
        if self.raft is not None:
            await self.raft.stop()
        await self.executor.stop()
        await self.replication.close()
        await self._obs_pool.close()
        await self.jobs.close()
        await self.rpc.stop()
        try:
            self.fs.flush_group()   # the open journal group, if any
        except Exception as e:  # noqa: BLE001 — a committer already broken
            log.warning("final group flush failed: %s", e)
        self.fs.journal.close()
        self.fs.store.close()

    # ---------------- handlers ----------------

    def _register_handlers(self) -> None:
        r = self.rpc.register
        C = RpcCode
        r(C.MKDIR, self._h(self._mkdir, mutate=True))
        r(C.DELETE, self._h(self._delete, mutate=True))
        r(C.CREATE_FILE, self._h(self._create_file, mutate=True))
        r(C.OPEN_FILE, self._h(self._get_block_locations))
        r(C.FILE_STATUS, self._h(self._file_status))
        r(C.LIST_STATUS, self._h(self._list_status))
        r(C.EXISTS, self._h(self._exists))
        r(C.RENAME, self._h(self._rename, mutate=True))
        r(C.SET_ATTR, self._h(self._set_attr, mutate=True))
        r(C.ADD_BLOCK, self._h(self._add_block, mutate=True))
        r(C.COMPLETE_FILE, self._h(self._complete_file, mutate=True))
        r(C.GET_BLOCK_LOCATIONS, self._h(self._get_block_locations))
        r(C.GET_MASTER_INFO, self._h(self._master_info))
        r(C.META_BATCH, self._h(self._meta_batch, mutate=True))
        r(C.WORKER_HEARTBEAT, self._h(self._worker_heartbeat))
        r(C.WORKER_BLOCK_REPORT, self._h(self._worker_block_report))
        r(C.REPORT_UNDER_REPLICATED_BLOCKS,
          self._h(self._report_under_replicated))
        r(C.REQUEST_REPLACEMENT_WORKER, self._h(self._replacement_worker))
        r(C.REPORT_BLOCK_REPLICATION_RESULT,
          self._h(self._replication_result))
        r(C.DECOMMISSION_WORKER, self._h(self._decommission_worker,
                                         mutate=True))
        r(C.EC_COMMIT_STRIPE, self._h(self._ec_commit_stripe, mutate=True))
        r(C.MOUNT, self._h(self._mount, mutate=True))
        r(C.UNMOUNT, self._h(self._umount, mutate=True))
        r(C.UPDATE_MOUNT, self._h(self._update_mount, mutate=True))
        r(C.GET_MOUNT_TABLE, self._h(self._mount_table))
        r(C.GET_MOUNT_INFO, self._h(self._mount_info))
        r(C.SUBMIT_JOB, self._h(self._submit_job, mutate=True))
        r(C.GET_JOB_STATUS, self._h(self._job_status))
        r(C.CANCEL_JOB, self._h(self._cancel_job, mutate=True))
        r(C.PREFETCH_WINDOW, self._h(self._prefetch_window, mutate=True))
        r(C.REPORT_TASK, self._h(self._report_task))
        # raft's admin calls; RaftLite registers RAFT_VOTE..RAFT_STATUS
        r(C.RAFT_MEMBER_CHANGE, self._h(self._raft_member_change,
                                        mutate=True))
        r(C.RAFT_TRANSFER, self._h(self._raft_transfer))
        r(C.METRICS_REPORT, self._h(self._metrics_report))
        r(C.GET_SPANS, self._h(self._get_spans))
        for code in MASTER_REFUSED:
            r(code, self._not_ported)

    async def _not_ported(self, msg: Message, conn: ServerConn):
        raise err.Unsupported(f"{RpcCode(msg.code).name} is not served by "
                              f"the port's master (ROADMAP A3d)")

    _PATH_KEYS = ("path", "src", "dst", "cv_path")

    @classmethod
    def _norm_req(cls, req: dict) -> dict:
        """Normalise every path field, in batch items too."""
        for k in cls._PATH_KEYS:
            v = req.get(k)
            if isinstance(v, str):
                req[k] = norm_path(v)
        for sub in req.get("requests") or []:
            if isinstance(sub, dict):
                cls._norm_req(sub)
        return req

    def _h(self, fn, mutate: bool = False):
        async def call(req):
            rep = fn(req)
            if inspect.isawaitable(rep):
                rep = await rep
            return rep

        async def handler(msg: Message, conn: ServerConn):
            req = self._norm_req(unpack(msg.data) or {})
            if not mutate:
                return {}, pack(await call(req))
            if self.raft is not None:
                self.raft.check_leader()
            key = (req.get("client_id"), req.get("call_id"))
            dedup = key[0] is not None and key[1] is not None
            if dedup:
                cached = self.retry_cache.get(key)
                if cached is not None:
                    return {}, cached
            rep = await call(req)
            # acked only after the group holding the entry has flushed,
            # and under raft once the entry is on a quorum
            await self.fs.committer.sync()
            await self._commit_barrier(msg.deadline)
            data = pack(rep)
            if dedup:
                self.retry_cache.put(key, data)
            return {}, data
        return handler

    async def _commit_barrier(self, deadline=None) -> None:
        """Raft's commit rule: the reply waits until the journal's head
        is on a quorum, within the caller's deadline."""
        if self.raft is not None:
            await self.raft.wait_committed(self.fs.journal.seq,
                                           deadline=deadline)

    def _raft_member_change(self, q):
        """Journal one membership change (add, promote or remove); the
        mutation's commit barrier makes the answer mean committed."""
        if self.raft is None:
            raise err.Unsupported("raft is not enabled on this master")
        return self.raft.propose_member_change(
            q.get("action", ""), q.get("node_id", 0), q.get("addr", ""))

    async def _raft_transfer(self, q):
        """Drain the log to the target voter, then RAFT_TIMEOUT_NOW."""
        if self.raft is None:
            raise err.Unsupported("raft is not enabled on this master")
        target = await self.raft.transfer_leadership(q.get("target"))
        return {"target": target}

    # --- namespace ---
    def _mkdir(self, q):
        ctx = self.acl.check(q)
        st = self.fs.mkdir(q["path"], create_parent=q.get("create_parent", True),
                           mode=q.get("mode", 0o755),
                           owner=q.get("owner") or ctx.user,
                           group=q.get("group") or (ctx.groups[0] if ctx.groups
                                                    else ctx.user),
                           x_attr=q.get("x_attr"))
        return {"status": st.to_wire()}

    def _delete(self, q):
        self.acl.check(q)
        self.fs.delete(q["path"], recursive=q.get("recursive", False))
        return {}

    def _create_file(self, q):
        ctx = self.acl.check(q)
        st = self.fs.create_file(
            q["path"], overwrite=q.get("overwrite", False),
            create_parent=q.get("create_parent", True),
            replicas=q.get("replicas", 1),
            block_size=q.get("block_size", self.conf.client.block_size),
            mode=q.get("mode", 0o644), owner=q.get("owner") or ctx.user,
            group=q.get("group") or (ctx.groups[0] if ctx.groups
                                     else ctx.user),
            client_name=q.get("client_name", ""),
            x_attr=q.get("x_attr"), storage_policy=q.get("storage_policy"),
            file_type=q.get("file_type", 1))
        return {"status": st.to_wire()}

    async def _file_status(self, q):
        self.acl.check(q)
        try:
            return {"status": self.fs.file_status(q["path"]).to_wire()}
        except err.FileNotFound:
            st = await self.mounts.ufs_status(q["path"])
            if st is None:
                raise
            return {"status": st.to_wire()}

    async def _list_status(self, q):
        """The cached entries merged over the mount's UFS listing: UFS
        objects show before they are ever cached."""
        self.acl.check(q)
        return {"statuses": [s.to_wire() for s in
                             await self.mounts.list_merged(q["path"])]}

    async def _exists(self, q):
        self.acl.check(q)
        if self.fs.exists(q["path"]):
            return {"exists": True}
        return {"exists": await self.mounts.ufs_status(q["path"])
                is not None}

    def _rename(self, q):
        self.acl.check(q)
        return {"result": self.fs.rename(q["src"], q["dst"])}

    def _set_attr(self, q):
        """The reference's ``check_set_attr`` passes the superuser; the
        gate refuses every other caller, as for every op."""
        self.acl.check(q)
        self.fs.set_attr(q["path"], SetAttrOpts.from_wire(q.get("opts", {})))
        return {}

    def _add_block(self, q):
        self.acl.check(q)
        lb = self.fs.add_block(
            q["path"], client_host=q.get("client_host", ""),
            exclude_workers=q.get("exclude_workers"),
            commit_blocks=[CommitBlock.from_wire(c)
                           for c in q.get("commit_blocks", [])],
            ici_coords=q.get("ici_coords"),
            abandon_block=q.get("abandon_block"))
        return {"block": lb.to_wire()}

    def _complete_file(self, q):
        self.acl.check(q)
        ok = self.fs.complete_file(
            q["path"], q.get("len", 0),
            commit_blocks=[CommitBlock.from_wire(c)
                           for c in q.get("commit_blocks", [])],
            only_flush=q.get("only_flush", False))
        return {"result": ok}

    def _get_block_locations(self, q):
        self.acl.check(q)
        fb = self.fs.get_block_locations(q["path"])
        if self.raft is not None and not self._is_leader() \
                and self.fs.reports_pending(fb):
            # beyond the reference (ROADMAP §C, C16): a follower that
            # cannot locate a block while workers have yet to report to it
            # (since it started, or installed a snapshot) hands the read to
            # the leader; the reference answers no location, and the
            # reader fails
            self.metrics.inc("raft.reads_to_leader")
            self.raft.check_leader()
        return {"file_blocks": fb.to_wire()}

    def _master_info(self, q):
        return {"info": self.fs.master_info(self.addr).to_wire()}

    def _meta_batch(self, q):
        """mkdir, create and delete items in one round trip; an item's
        error comes back as {"error", "error_code"} in its place. The
        batch's identity is stamped onto every item."""
        ops = {"mkdir": self._mkdir, "create": self._create_file,
               "delete": self._delete}
        ident = {k: q[k] for k in ("user", "groups", "client_name",
                                   "client_id") if k in q}
        out = []
        for r in q["requests"]:
            r = {**r, **ident}
            fn = ops.get(r.get("op"))
            try:
                if fn is None:
                    raise err.InvalidArgument(
                        f"meta_batch: unknown op {r.get('op')!r}")
                out.append(fn(r))
            except err.CurvineError as e:
                out.append({"error": str(e), "error_code": int(e.code)})
        return {"responses": out}

    # --- worker plane ---
    def _worker_heartbeat(self, q):
        cmds = self.fs.worker_heartbeat(q["info"])
        self.metrics.gauge("workers.live",
                           len(self.fs.workers.live_workers()))
        wid = q["info"]["address"]["worker_id"]
        evac = q.get("evac_blocks")
        if evac:
            # the worker repeats the set every beat until it drains
            self.replication.enqueue_evacuation(wid, [int(b) for b in evac])
        # the tier-0's advertisement, refreshed (or cleared) every beat
        self.replication.note_hbm_blocks(
            wid, [int(b) for b in q.get("hbm_blocks") or []])
        wm = q.get("metrics")
        if wm:
            self._worker_counters[wid] = wm
            self._prune_worker_counters()
        return cmds

    def _worker_block_report(self, q):
        kept = self.fs.report_kept
        rep = self.fs.worker_block_report(
            q["worker_id"], q.get("blocks", {}), q.get("storage_types", {}),
            incremental=q.get("incremental", False))
        if self.fs.report_kept > kept:
            self.metrics.inc("blocks.report_kept", self.fs.report_kept - kept)
        if not self._is_leader():
            # a follower may lag the leader, or hold nothing while a
            # snapshot installs: a block it does not know is no orphan to
            # it, and the worker obeys every master (ROADMAP §C, C12)
            rep["delete_blocks"] = []
        return rep

    def _replacement_worker(self, q):
        w = self.replication.replacement_worker(
            q["block_id"], set(q.get("exclude_workers", [])))
        return {"worker": w.address.to_wire()}

    def _decommission_worker(self, q):
        """Decommission (``on``) or recommission a worker: a journaled
        intent, the superuser's only."""
        self.acl.check(q)
        self.fs.decommission_worker(q["worker_id"], on=q.get("on", True))
        w = self.fs.workers.workers.get(q["worker_id"])
        return {"state": int(w.state) if w is not None else -1}

    def _report_under_replicated(self, q):
        """Corrupt or lost replicas, from a worker (with its
        ``worker_id``) or a client. A worker's replica is flagged, never
        deleted at once: it stops counting, stays as the last-resort
        source, and is retired once the block is back at its count. A
        follower answers NOT_LEADER: the worker turns to the leader, whose
        repair queue is the one that runs."""
        if not self._is_leader():
            raise err.NotLeader("repair reports go to the leader")
        wid = q.get("worker_id")
        bids = [int(b) for b in q.get("block_ids", [])]
        verdicts = q.get("verdicts")
        if verdicts:
            self.replication.note_verdicts(
                {int(k): v for k, v in verdicts.items()})
        if wid is not None:
            self.replication.enqueue_evacuation(wid, bids)
        else:
            # a client's lost stripe cells, behind a degraded read (no
            # worker to name: the holder is gone)
            lost = sum(1 for b in bids if b in self.fs.ec_cells)
            if lost:
                self.metrics.inc("ec.degraded_reads", lost)
            self.replication.enqueue(bids)
        self.metrics.inc("blocks.reported_corrupt", len(bids))
        out = {"success": True}
        # a writer about to commit a block on fewer replicas asks which
        # of them this master still holds LIVE
        confirm = q.get("confirm_live")
        if confirm is not None:
            live = {w.address.worker_id
                    for w in self.fs.workers.live_workers()}
            out["live"] = [w for w in confirm if w in live]
        return out

    def _replication_result(self, q):
        self.replication.on_result(q["block_id"], q["worker_id"],
                                   q.get("success", False),
                                   q.get("message", ""),
                                   via=q.get("via", ""))
        return {}

    def _ec_commit_stripe(self, q):
        """A converting worker wrote every cell: the stripe is journaled
        (at its first commit) and its cells' locations registered; the
        block's replicas then retire, copy first and delete last."""
        cells = [[int(c["block_id"]), int(c["worker_id"]),
                  int(c.get("storage_type", 1))] for c in q.get("cells", [])]
        self.fs.ec_commit(q["block_id"], cells)
        self.metrics.inc("ec.stripes_committed")
        return {"success": True}

    # --- mounts ---
    def _mount(self, q):
        self.acl.check(q)
        info = self.mounts.mount(q["cv_path"], q["ufs_path"],
                                 properties=q.get("properties"),
                                 auto_cache=q.get("auto_cache", False),
                                 write_type=q.get("write_type", 0),
                                 ttl_ms=q.get("ttl_ms", 0),
                                 ttl_action=q.get("ttl_action", 0),
                                 storage_type=q.get("storage_type", ""),
                                 block_size=q.get("block_size", 0),
                                 replicas=q.get("replicas", 0),
                                 access_mode=q.get("access_mode", "rw"))
        return {"mount": info.to_wire()}

    def _umount(self, q):
        self.acl.check(q)
        self.mounts.umount(q["cv_path"])
        return {}

    def _update_mount(self, q):
        self.acl.check(q)
        info = self.mounts.update(q["cv_path"], properties=q.get("properties"),
                                  auto_cache=q.get("auto_cache"),
                                  ttl_ms=q.get("ttl_ms"),
                                  ttl_action=q.get("ttl_action"),
                                  access_mode=q.get("access_mode"))
        return {"mount": info.to_wire()}

    def _mount_table(self, q):
        self.acl.check(q)
        return {"mounts": [m.to_wire() for m in self.mounts.table()]}

    def _mount_info(self, q):
        self.acl.check(q)
        m = self.mounts.get_mount(q["path"])
        return {"mount": m.to_wire() if m else None}

    # --- jobs ---
    def _submit_job(self, q):
        self.acl.check(q)
        job = self.jobs.submit(q.get("kind", "load"), q["path"],
                               recursive=q.get("recursive", True),
                               replicas=q.get("replicas", 1))
        return {"job_id": job.job_id}

    def _prefetch_window(self, q):
        """A reader's cursor in the (seed, epoch) order of ``path``'s
        shards: the job manager keeps a rolling window warm ahead."""
        self.acl.check(q)
        job = self.jobs.advise_prefetch(
            q["path"], cursor=int(q.get("cursor", 0)),
            window=int(q.get("window", 8)), epoch=int(q.get("epoch", 0)),
            seed=int(q.get("seed", 0)))
        return {"job_id": job.job_id, "state": int(job.state),
                "cursor": job.cursor, "window": job.window,
                "planned": getattr(job, "_next", 0),
                "total": job.total_files}

    def _job_status(self, q):
        self.acl.check(q)
        return {"job": self.jobs.status(q["job_id"]).to_wire()}

    def _cancel_job(self, q):
        self.acl.check(q)
        self.jobs.cancel(q["job_id"])
        return {}

    # --- the observability plane ---
    def _metrics_report(self, q):
        """A client's counter deltas, summed into this master's registry
        as ``client.<name>``, and its finished spans, kept in the store
        so that a trace's assembly sees the client's side."""
        for name, value in (q.get("counters") or {}).items():
            self.metrics.inc(f"client.{name}", value)
        spans = q.get("spans")
        if spans:
            self.tracer.ingest(spans)
        return {}

    def _get_spans(self, q):
        """One trace's spans in this master's store; with ``collect`` the
        serving workers' too (``collect_trace``)."""
        tid = str(q.get("trace_id", ""))
        if q.get("collect"):
            return self.collect_trace(tid)
        return {"spans": self.tracer.spans_for(tid)}

    async def collect_trace(self, trace_id: str) -> dict:
        """This master's spans of a trace (the clients' pushed ones
        among them) and every serving worker's, by GET_SPANS to each; a
        slow or dead worker costs the collect's timeout, never the
        answer."""
        spans = list(self.tracer.spans_for(trace_id))
        timeout = COLLECT_TIMEOUT_MS / 1000.0
        payload = pack({"trace_id": trace_id})

        async def fetch(w):
            a = w.address
            conn = await self._obs_pool.get(
                f"{a.ip_addr or a.hostname}:{a.rpc_port}")
            rep = await conn.call(RpcCode.GET_SPANS, data=payload)
            return (unpack(rep.data) or {}).get("spans", [])

        workers = self.fs.workers.serving_workers()
        if workers:
            results = await asyncio.wait_for(
                asyncio.gather(*(fetch(w) for w in workers),
                               return_exceptions=True),
                timeout + 1.0)
            for r in results:
                if isinstance(r, list):
                    spans.extend(r)
                else:
                    log.debug("span collect from a worker failed: %s", r)
        return {"spans": spans}

    def _report_task(self, q):
        """A worker's report of one task (the worker plane: no user)."""
        self.jobs.report_task(q["task"])
        return {}
