"""Master HA: raft between masters, with a membership lifecycle.

Own copy of ``curvine_tpu/master/ha.py``, whole, on the port's codec
(``rpc/wirepack.py``, byte-equal to ``msgpack``) and RPC layer. The hard
state file, the ``raft_conf`` entries, the RPC bodies and the snapshot
blob are the reference's, byte for byte, so a port master and a JAX
master serve in one group. ``RaftLite``:

- the hard state (term, ``voted_for`` and the adopted config), fsync'd
  and written with ``os.replace`` before a vote or a step up takes
  effect (:153-180); the config there is the path by which membership
  survives a restart on the KV store, which neither replays a compacted
  ``raft_conf`` entry nor writes a snapshot;
- prevote, then election, votes tallied as they land (:408-532); the
  term-opening ``noop`` (:549-554);
- commit after a majority of voters, of an entry of the current term
  (``wait_committed`` with its deadline; :560-627);
- the per-member replicate loop: heartbeats, batches of up to 256
  entries capped at 8 MiB, a failed batch requeued in seq order, and a
  snapshot install when the predecessor's term has left the journal's
  window (:644-709);
- the chunked, resumable snapshot install with its whole-blob CRC, and
  the skip of a stale one (:711-762, :907-981);
- membership: learners, their promotion once their lag is at most
  ``promote_lag``, one change in flight at a time, removal, and the
  ``raft_conf`` entries that take effect when appended (:182-340);
- leader transfer: drain the target, then RAFT_TIMEOUT_NOW (:764-811,
  :983-998); RAFT_STATUS on any node (:1000-1027); ``check_leader`` with
  ``leader_hint`` and ``members`` (:1029-1045); the ``raft.*`` counters
  and the role gauge (:340-356).

Where the port differs (ROADMAP §C, C10): the leader builds and packs
the snapshot, and takes its CRC, on a worker thread, not on its event
loop, which takes only a consistent cut (``fs.snapshot_cut``: on the KV
store its records, copied raw); and while the pack runs it keeps
sending the member heartbeats, which its replicate loop, waiting on the
snapshot, does not. The reference does all of it on the loop and sends
the member nothing meanwhile; the port's codec is Python, and where
masters share one event loop (the CPU tests) a large namespace's build
and pack held the heartbeats past the followers' least election
timeout, so that a follower's prevote found a grant and a needless
election followed (with two members to catch up, elections followed
each other, each leader's noop making the next snapshot). The cut
still copies every record on the loop, so its stall grows with the
namespace. The longest stall of the loop while a snapshot is cut
and sent is kept in the gauge ``raft.snapshot_loop_stall_ms``, the
cut's seconds in ``raft.snapshot_build_s`` and the build and pack's in
``raft.snapshot_pack_s``.

A member's calls carry as their head the last entry sent to it, not the
journal's head (C14): in the reference an entry appended while a call is
on its way makes the member answer behind, and it is sent a whole
snapshot.

A prevote refused from a later term takes that term (C13): in the
reference a node whose log is longer but whose term is older asks every
prevote for a term the other voter already holds, and is refused for
ever, while the other, its log shorter, is refused too.

A sole voter elects itself (C11): the reference counts votes only as the
peers' answers land, so a group of one voter never had a leader.

The leader applies an entry before it replicates it (the reference's
design: applies are deterministic, and a deposed leader's extra entries
are healed by a snapshot install from the new leader)."""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
import zlib

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.rpc import wirepack
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.deadline import Deadline
from curvine_tpu_torch.rpc.frame import Message, pack, unpack
from curvine_tpu_torch.rpc.server import RpcServer, ServerConn

log = logging.getLogger(__name__)

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

_ROLE_GAUGE = {FOLLOWER: 0, CANDIDATE: 1, LEADER: 2}
# soft byte cap of one RAFT_APPEND batch: entries with fat args (xattrs)
# must never push a frame past MAX_FRAME
_BATCH_SOFT_BYTES = 8 * 1024 * 1024
# the period of the loop-stall probe while a snapshot is sent
_STALL_TICK_S = 0.005


def _rough_size(obj) -> int:
    """A cheap estimate of an entry's wire size, for the batch cap."""
    if isinstance(obj, (bytes, bytearray, memoryview, str)):
        return len(obj)
    if isinstance(obj, dict):
        return 8 + sum(_rough_size(k) + _rough_size(v)
                       for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return 8 + sum(_rough_size(v) for v in obj)
    return 8


def _unpack_blob(data) -> dict:
    return wirepack.unpackb(bytes(data), raw=False, strict_map_key=False)


async def _call(conn, code: RpcCode, body: bytes, timeout_s: float):
    """One raft RPC with its own timeout (the reference's ``timeout=``)."""
    return await conn.call(code, data=body, deadline=Deadline(timeout_s))


class _LoopStall:
    """The longest stall of the running event loop while it is armed: a
    task that sleeps ``_STALL_TICK_S`` and notes how late it woke."""

    def __init__(self):
        self.max_s = 0.0
        self._task: asyncio.Task | None = None

    async def _probe(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            t = loop.time()
            await asyncio.sleep(_STALL_TICK_S)
            self.max_s = max(self.max_s, loop.time() - t - _STALL_TICK_S)

    async def __aenter__(self) -> "_LoopStall":
        self._task = asyncio.ensure_future(self._probe())
        await asyncio.sleep(0)          # the probe takes its first time
        return self

    async def __aexit__(self, *exc) -> None:
        self._task.cancel()
        await asyncio.gather(self._task, return_exceptions=True)


class RaftLite:
    def __init__(self, node_id: int, peers: dict[int, str], fs,
                 rpc: RpcServer, election_timeout_ms: tuple[int, int] =
                 (600, 1200), heartbeat_ms: int = 150,
                 state_dir: str | None = None,
                 commit_timeout_s: float = 10.0,
                 self_addr: str = "",
                 learner: bool = False,
                 promote_lag: int = 64,
                 snapshot_chunk_bytes: int = 4 * 1024 * 1024,
                 transfer_timeout_s: float = 5.0,
                 metrics=None):
        self.node_id = node_id
        self.fs = fs
        self.rpc = rpc
        self.role = FOLLOWER
        self.term = 0
        self.voted_for: int | None = None
        self.leader_id: int | None = None
        self.election_timeout = election_timeout_ms
        self.heartbeat_ms = heartbeat_ms
        self.commit_timeout_s = commit_timeout_s
        self.promote_lag = promote_lag
        self.snapshot_chunk_bytes = max(64 * 1024, snapshot_chunk_bytes)
        self.transfer_timeout_s = transfer_timeout_s
        self.metrics = metrics
        self.pool = ConnectionPool(size=1, timeout_ms=2_000)
        # membership: the boot config, superseded by a journaled
        # raft_conf entry once one exists; voters include self, `peers`
        # (the argument) does not
        if learner:
            self.voters: dict[int, str] = dict(peers)
            self.learners: dict[int, str] = {node_id: self_addr}
        else:
            self.voters = dict(peers)
            self.voters[node_id] = self_addr
            self.learners = {}
        self.conf_ver = 0
        self.removed = False
        # seq of the config entry in flight; a second change is refused
        # until it commits (the single-server-change rule)
        self._conf_seq: int | None = None
        self._transferring = False
        self._last_heard = 0.0
        self._bg: list[asyncio.Task] = []
        # the leader's per-member replication loops, torn down when it
        # steps down or the config changes
        self._repl_tasks: list[asyncio.Task] = []
        self._repl_queues: dict[int, asyncio.Queue] = {}
        # commit tracking (leader): member id -> highest acked seq
        self.match: dict[int, int] = {}
        self.commit_seq = 0
        self._commit_waiters: list[tuple[int, asyncio.Future]] = []
        # the chunked snapshot being received (follower)
        self._snap_rx: dict | None = None
        # the last adopted config, kept in the hard state file
        self._hs_conf: dict | None = None
        self._state_path = os.path.join(
            state_dir or (fs.journal.dir if fs.journal else "."),
            "raft_hard_state")
        self._load_hard_state()
        rpc.register(RpcCode.RAFT_VOTE, self._h_vote)
        rpc.register(RpcCode.RAFT_PREVOTE, self._h_prevote)
        rpc.register(RpcCode.RAFT_APPEND, self._h_append)
        rpc.register(RpcCode.RAFT_SNAPSHOT, self._h_snapshot)
        rpc.register(RpcCode.RAFT_SNAPSHOT_CHUNK, self._h_snapshot_chunk)
        rpc.register(RpcCode.RAFT_TIMEOUT_NOW, self._h_timeout_now)
        rpc.register(RpcCode.RAFT_STATUS, self._h_status)

    # ---------------- hard state ----------------

    def _load_hard_state(self) -> None:
        try:
            with open(self._state_path, "rb") as f:
                d = _unpack_blob(f.read())
            self.term = d.get("term", 0)
            self.voted_for = d.get("voted_for")
            self._hs_conf = d.get("conf")
        except (FileNotFoundError, ValueError, wirepack.UnpackException):
            pass
        if self.fs.journal is not None:
            self.fs.journal.term = self.term

    def _save_hard_state(self) -> None:
        """Fsync'd before a vote or a step up takes effect: a restarted
        node must never vote twice in one term or go back in term."""
        tmp = self._state_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(pack({"term": self.term, "voted_for": self.voted_for,
                          "conf": self._hs_conf}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path)
        if self.fs.journal is not None:
            self.fs.journal.term = self.term

    # ---------------- membership ----------------

    @property
    def peers(self) -> dict[int, str]:
        """Every member, voter or learner, but self: the replication
        targets of the live config."""
        out = dict(self.voters)
        out.update(self.learners)
        out.pop(self.node_id, None)
        return out

    def _voter_peers(self) -> dict[int, str]:
        return {pid: a for pid, a in self.voters.items()
                if pid != self.node_id}

    def _addr_of(self, nid: int | None) -> str:
        if nid is None:
            return ""
        return self.voters.get(nid) or self.learners.get(nid) or ""

    def _adopt_config(self, cfg: dict | None) -> None:
        """Make a journaled ``raft_conf`` the active config: when the
        leader appends one, when a follower applies one, after a snapshot
        install, and at start from the hard state and the recovered
        ``fs.raft_conf``. It takes effect when appended, not committed."""
        if not cfg:
            return
        ver = int(cfg.get("ver", 0))
        if ver < self.conf_ver:
            return
        self.conf_ver = ver
        self.voters = {int(k): v for k, v in (cfg.get("voters") or {}).items()}
        self.learners = {int(k): v
                         for k, v in (cfg.get("learners") or {}).items()}
        self._hs_conf = {"ver": ver,
                         "voters": {str(k): v
                                    for k, v in self.voters.items()},
                         "learners": {str(k): v
                                      for k, v in self.learners.items()}}
        self._save_hard_state()
        if self.node_id not in self.voters and \
                self.node_id not in self.learners:
            if not self.removed:
                log.info("node %d: removed from the cluster config (ver %d)",
                         self.node_id, ver)
            self.removed = True
            if self.role == LEADER:
                self._step_down(self.term)
            self.role = FOLLOWER
        else:
            self.removed = False
        if self.role == LEADER:
            self._reconcile_replication()
            self._advance_commit()

    def _reconcile_replication(self) -> None:
        """Leader: a replication loop for each new member; a removed
        member's loop is unhooked a few heartbeats later, so that the
        entry that removes it still reaches it."""
        targets = self.peers
        for pid, addr in targets.items():
            if pid not in self._repl_queues:
                self._repl_queues[pid] = asyncio.Queue()
                self.match.setdefault(pid, 0)
                self._repl_tasks.append(asyncio.ensure_future(
                    self._replicate_loop(pid, addr, self.last_seq())))
        for pid in list(self._repl_queues):
            if pid not in targets:
                self._repl_tasks.append(asyncio.ensure_future(
                    self._retire_member(pid, self._repl_queues[pid])))
        self._repl_tasks = [t for t in self._repl_tasks if not t.done()]

    async def _retire_member(self, pid: int, q: asyncio.Queue) -> None:
        await asyncio.sleep(self.heartbeat_ms * 4 / 1000)
        if self._repl_queues.get(pid) is q and pid not in self.peers:
            self._repl_queues.pop(pid, None)
            self.match.pop(pid, None)

    def propose_member_change(self, action: str, target_id: int,
                              addr: str = "") -> dict:
        """Leader only: journal one config change (``add``, ``promote``
        or ``remove``). A proposal while the previous config entry is
        uncommitted is refused with the retryable IN_PROGRESS."""
        self.check_leader()
        if self._conf_seq is not None and self._conf_seq > self.commit_seq:
            raise err.CurvineError(
                "a membership change is already in flight "
                f"(seq {self._conf_seq} > commit {self.commit_seq})",
                code=err.ErrorCode.IN_PROGRESS)
        action = str(action).lower()
        target_id = int(target_id)
        voters, learners = dict(self.voters), dict(self.learners)
        if action in ("add", "add_learner"):
            if not addr:
                raise err.InvalidArgument(
                    "add requires the new node's host:port")
            if target_id in voters or target_id in learners:
                raise err.InvalidArgument(
                    f"node {target_id} is already a member")
            learners[target_id] = addr
            action = "add_learner"
        elif action == "promote":
            if target_id not in learners:
                raise err.InvalidArgument(
                    f"node {target_id} is not a learner")
            voters[target_id] = learners.pop(target_id)
        elif action == "remove":
            if target_id == self.node_id:
                raise err.InvalidArgument(
                    "cannot remove the leader; transfer leadership first")
            if target_id in voters:
                voters.pop(target_id)
            elif target_id in learners:
                learners.pop(target_id)
            else:
                raise err.InvalidArgument(
                    f"node {target_id} is not a member")
        else:
            raise err.InvalidArgument(
                f"unknown membership action {action!r}")
        args = {"ver": self.conf_ver + 1,
                "voters": {str(k): v for k, v in voters.items()},
                "learners": {str(k): v for k, v in learners.items()},
                "action": action, "target": target_id}
        log.info("node %d: proposing %s of node %d (conf ver %d -> %d)",
                 self.node_id, action, target_id, self.conf_ver,
                 args["ver"])
        self.fs._log("raft_conf", args)
        self._conf_seq = self.last_seq()
        if self.metrics is not None:
            self.metrics.inc("raft.member_changes")
        return args

    async def _membership_loop(self) -> None:
        """The metrics tick, and a learner's promotion once its match lag
        is at most ``promote_lag``."""
        while True:
            await asyncio.sleep(max(self.heartbeat_ms * 2, 40) / 1000)
            self._metrics_tick()
            if (self.role != LEADER or not self.learners
                    or self._transferring):
                continue
            if self._conf_seq is not None and \
                    self._conf_seq > self.commit_seq:
                continue
            for pid in sorted(self.learners):
                m = self.match.get(pid, 0)
                if m > 0 and self.last_seq() - m <= self.promote_lag:
                    try:
                        self.propose_member_change("promote", pid)
                    except err.CurvineError as e:
                        log.debug("auto-promote of %d refused: %s", pid, e)
                    break

    def _metrics_tick(self) -> None:
        m = self.metrics
        if m is None:
            return
        m.gauge("raft.role", _ROLE_GAUGE.get(self.role, 0))
        m.gauge("raft.term", self.term)
        m.gauge("raft.commit_seq", self.commit_seq)
        m.gauge("raft.conf_ver", self.conf_ver)
        m.gauge("raft.voters", len(self.voters))
        m.gauge("raft.learners", len(self.learners))
        if self.role == LEADER:
            last = self.last_seq()
            for pid, mseq in self.match.items():
                m.gauge(f"raft.match_lag.{pid}", max(0, last - mseq))

    # ---------------- lifecycle ----------------

    @property
    def is_leader(self) -> bool:
        return self.role == LEADER

    @property
    def quorum(self) -> int:
        return len(self.voters) // 2 + 1

    def last_seq(self) -> int:
        return self.fs.journal.seq if self.fs.journal else 0

    def last_term(self) -> int:
        return self.fs.journal.last_term if self.fs.journal else 0

    async def start(self) -> None:
        self._touch()
        # a config from the hard state or from the recovered journal
        # supersedes the boot config; the newest version wins
        self._adopt_config(self._hs_conf)
        self._adopt_config(getattr(self.fs, "raft_conf", None))
        self._bg.append(asyncio.ensure_future(self._election_loop()))
        self._bg.append(asyncio.ensure_future(self._membership_loop()))

    async def stop(self) -> None:
        # demote before cancelling: asyncio.wait_for swallows a cancel
        # that races its inner future (bpo-37658), and a replicate loop
        # on a hot queue meets that race; the role flip ends the
        # `while self.role == LEADER` loops all the same
        self.role = FOLLOWER
        tasks = list(self._bg) + list(self._repl_tasks)
        self._bg.clear()
        self._repl_tasks.clear()
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._fail_waiters(err.NotLeader("shutting down"))
        await self.pool.close()

    def _touch(self) -> None:
        self._last_heard = asyncio.get_event_loop().time()

    # ---------------- election ----------------

    async def _election_loop(self) -> None:
        while True:
            timeout = random.uniform(*self.election_timeout) / 1000
            await asyncio.sleep(timeout / 4)
            if self.role == LEADER:
                continue
            if self.removed or self.node_id not in self.voters:
                continue        # learners and removed nodes never elect
            now = asyncio.get_event_loop().time()
            if now - self._last_heard < timeout:
                continue
            await self._run_election()

    async def _run_prevote(self) -> bool:
        """Ask the voters whether they would vote for term + 1, without
        raising our term: a partitioned node keeps its term, and rejoins
        as a follower instead of deposing a healthy leader."""
        term = self.term + 1

        async def ask(addr: str) -> bool:
            try:
                conn = await self.pool.get(addr)
                rep = await _call(conn, RpcCode.RAFT_PREVOTE, pack({
                    "term": term, "candidate": self.node_id,
                    "last_seq": self.last_seq(),
                    "last_term": self.last_term()}), 1.0)
                body = unpack(rep.data) or {}
                if body.get("term", 0) > self.term:
                    # a refusal from a later term: take it, so that the
                    # next prevote asks past it (C13)
                    self._step_down(body["term"])
                return bool(body.get("granted"))
            except Exception:  # noqa: BLE001 — an unreachable voter: no
                return False

        votes = 1
        tasks = [asyncio.ensure_future(ask(addr))
                 for addr in self._voter_peers().values()]
        try:
            for fut in asyncio.as_completed(tasks):
                if await fut:
                    votes += 1
                if votes >= self.quorum:
                    return True
        finally:
            for t in tasks:
                t.cancel()
        return votes >= self.quorum

    async def _run_election(self, force: bool = False) -> None:
        if self.removed or self.node_id not in self.voters:
            return
        # TIMEOUT_NOW skips the prevote: the live leader asked for this
        if (not force and self._voter_peers()
                and not await self._run_prevote()):
            log.debug("node %d: pre-vote failed (term %d stays)",
                      self.node_id, self.term)
            return
        self.role = CANDIDATE
        self.term += 1
        self.voted_for = self.node_id
        self._save_hard_state()
        self.leader_id = None
        votes = 1
        if self.metrics is not None:
            self.metrics.inc("raft.elections")
        log.info("node %d: starting election term %d (last=%d/t%d)",
                 self.node_id, self.term, self.last_seq(), self.last_term())

        async def ask(pid: int, addr: str) -> bool:
            try:
                conn = await self.pool.get(addr)
                rep = await _call(conn, RpcCode.RAFT_VOTE, pack({
                    "term": self.term, "candidate": self.node_id,
                    "last_seq": self.last_seq(),
                    "last_term": self.last_term()}), 1.0)
                body = unpack(rep.data) or {}
                if body.get("term", 0) > self.term:
                    self._step_down(body["term"])
                return bool(body.get("granted"))
            except Exception:  # noqa: BLE001 — an unreachable voter: no
                return False

        if votes >= self.quorum:
            # a sole voter is its own quorum (ROADMAP §C, C11: the
            # reference tallies only inside the loop over the peers'
            # answers, so a one-voter group never elects)
            await self._become_leader()
            return
        # votes are tallied as they land: a slow or dead peer must not
        # hold back a quorum's win
        term_at_start = self.term
        tasks = [asyncio.ensure_future(ask(pid, addr))
                 for pid, addr in self._voter_peers().items()]
        try:
            for fut in asyncio.as_completed(tasks):
                granted = await fut
                if self.role != CANDIDATE or self.term != term_at_start:
                    return
                if granted:
                    votes += 1
                if votes >= self.quorum:
                    await self._become_leader()
                    return
        finally:
            for t in tasks:
                t.cancel()
        if self.role == CANDIDATE:
            self.role = FOLLOWER
            self._touch()

    def _step_down(self, term: int) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._save_hard_state()
        if self.role == LEADER:
            log.info("node %d: stepping down in term %d", self.node_id, term)
            for t in self._repl_tasks:
                t.cancel()
            self._repl_tasks.clear()
            self._repl_queues = {}
            self.match = {}
            self._conf_seq = None
            self._fail_waiters(err.NotLeader("deposed"))
        self.role = FOLLOWER
        self._touch()

    async def _become_leader(self) -> None:
        log.info("node %d: leader for term %d (voters=%s learners=%s)",
                 self.node_id, self.term, sorted(self.voters),
                 sorted(self.learners))
        self.role = LEADER
        self.leader_id = self.node_id
        self._conf_seq = None
        for t in self._repl_tasks:
            t.cancel()
        self._repl_tasks = []
        targets = self.peers
        self._repl_queues = {pid: asyncio.Queue() for pid in targets}
        self.match = {pid: 0 for pid in targets}
        self.commit_seq = self.last_seq() if not targets else 0
        for pid, addr in targets.items():
            self._repl_tasks.append(asyncio.ensure_future(
                self._replicate_loop(pid, addr, self.last_seq())))
        if targets and self.fs.journal is not None:
            # the term-opening entry: one of this term that can commit by
            # counting, which commits every earlier entry under it
            try:
                self.fs._log("noop", {})
            except err.CurvineError:
                pass

    # ---------------- commit tracking (leader) ----------------

    def _advance_commit(self) -> None:
        # voters only: a learner's ack never moves the commit point
        acked = sorted([self.last_seq()] +
                       [self.match.get(pid, 0)
                        for pid in self._voter_peers()],
                       reverse=True)
        new_commit = acked[min(self.quorum, len(acked)) - 1]
        # only an entry of the current term commits by counting (raft's
        # figure 8); the term-opening noop makes one reachable at once
        if new_commit > self.commit_seq:
            t = (self.fs.journal.term_of(new_commit)
                 if self.fs.journal else self.term)
            if t != self.term:
                return
            self.commit_seq = new_commit
            still = []
            for seq, fut in self._commit_waiters:
                if fut.done():
                    continue        # a waiter that timed out: pruned
                if seq <= self.commit_seq:
                    fut.set_result(True)
                else:
                    still.append((seq, fut))
            self._commit_waiters = still

    def _fail_waiters(self, exc: Exception) -> None:
        for _seq, fut in self._commit_waiters:
            if not fut.done():
                fut.set_exception(exc)
        self._commit_waiters = []

    async def wait_committed(self, seq: int | None = None,
                             deadline=None) -> None:
        """Wait until ``seq`` (the journal's head by default) is on a
        quorum: a client's ack then means durable on a majority. The
        caller's deadline caps the wait below ``commit_timeout_s``."""
        if not self.peers:
            return
        if self.role != LEADER:
            raise err.NotLeader(f"node {self.node_id} is {self.role}")
        seq = self.last_seq() if seq is None else seq
        if seq <= self.commit_seq:
            return
        fut = asyncio.get_event_loop().create_future()
        waiter = (seq, fut)
        self._commit_waiters.append(waiter)
        try:
            await asyncio.wait_for(fut, (deadline.cap(self.commit_timeout_s)
                                         if deadline is not None
                                         else self.commit_timeout_s))
        except asyncio.TimeoutError:
            raise err.RpcTimeout(
                f"seq {seq} not committed on a quorum within "
                f"{self.commit_timeout_s:.1f}s") from None
        finally:
            # a waiter that timed out or was cancelled leaves the list
            try:
                self._commit_waiters.remove(waiter)
            except ValueError:
                pass                # already released by _advance_commit

    # ---------------- replication (leader) ----------------

    def on_mutation(self, seq: int, op: str, args: dict,
                    term: int = 0) -> None:
        """``MasterFilesystem._log``'s hook, after an entry's journal and
        apply."""
        if self.role != LEADER:
            return
        for q in self._repl_queues.values():
            q.put_nowait((seq, op, args, term))
        if op == "raft_conf":
            # effective when appended (queued above, so that every member,
            # one being removed too, receives it)
            self._adopt_config(args)
        if len(self.voters) <= 1:
            self._advance_commit()      # a sole voter is its own quorum

    async def _replicate_loop(self, pid: int, addr: str,
                              handed: int) -> None:
        """One member's heartbeats, entry stream and catch-up. Ends when
        this node steps down or the member leaves the config.

        ``handed`` is the last seq the member should hold: the journal's
        head when its queue was made (later entries are queued), then the
        last entry sent to it, or a snapshot's seq. A call's head
        (``leader_seq``) is that, not the journal's head: an entry queued
        but not yet sent would make the member answer behind and ask for
        a whole snapshot (ROADMAP §C, C14)."""
        q = self._repl_queues.get(pid)
        if q is None:
            return
        while self.role == LEADER and self._repl_queues.get(pid) is q:
            batch: list = []
            try:
                entry = await asyncio.wait_for(
                    q.get(), self.heartbeat_ms / 1000)
                batch.append(entry)
                size = _rough_size(entry)
                while (not q.empty() and len(batch) < 256
                       and size < _BATCH_SOFT_BYTES):
                    nxt = q.get_nowait()
                    batch.append(nxt)
                    size += _rough_size(nxt)
            except asyncio.TimeoutError:
                pass          # a heartbeat
            if self.role != LEADER or self._repl_queues.get(pid) is not q:
                return
            try:
                conn = await self.pool.get(addr)
                prev_seq = batch[0][0] - 1 if batch else handed
                lead = max(handed, batch[-1][0]) if batch else handed
                term_of = (self.fs.journal.term_of if self.fs.journal
                           else lambda _seq: 0)
                prev_term, lead_term = term_of(prev_seq), term_of(lead)
                if prev_term is None or lead_term is None:
                    # a term left the window: log matching cannot be
                    # shown, so a snapshot catches the member up
                    handed = max(handed,
                                 await self._send_snapshot(pid, addr))
                    for entry in batch:
                        q.put_nowait(entry)
                    continue
                rep = await _call(conn, RpcCode.RAFT_APPEND, pack({
                    "term": self.term, "leader": self.node_id,
                    "entries": [[s, o, a, t] for s, o, a, t in batch],
                    "prev_seq": prev_seq, "prev_term": prev_term,
                    "leader_seq": lead,
                    "leader_last_term": lead_term}), 2.0)
                body = unpack(rep.data) or {}
                if body.get("term", 0) > self.term:
                    self._step_down(body["term"])
                    return
                handed = lead
                if body.get("need_snapshot"):
                    # a divergent or lagging log: its applied seq must not
                    # count toward commit
                    handed = max(handed,
                                 await self._send_snapshot(pid, addr))
                elif pid in self.match:
                    self.match[pid] = max(self.match.get(pid, 0),
                                          body.get("applied_seq", 0))
                    self._advance_commit()
            except Exception as e:  # noqa: BLE001 — retried
                log.debug("replicate to %d failed: %s", pid, e)
                # requeue in seq order ahead of what came meanwhile: a
                # batch at the tail would start past the member's head
                # and turn a blip into a snapshot install
                pending = list(batch)
                while not q.empty():
                    pending.append(q.get_nowait())
                pending.sort(key=lambda entry: entry[0])
                for entry in pending:
                    q.put_nowait(entry)
                await asyncio.sleep(0.2)

    def _pack_snapshot(self, cut) -> tuple[bytes, int]:
        """The state of a cut, packed, and the blob's CRC (on a worker
        thread)."""
        blob = pack({"state": self.fs.build_snapshot(cut)})
        return blob, zlib.crc32(blob)

    async def _send_snapshot(self, pid: int, addr: str) -> int:
        """The chunked snapshot install: the state streams as bounded
        RAFT_SNAPSHOT_CHUNK frames, resumable (the member answers how
        many chunks it holds), with a whole-blob CRC checked before the
        install. Returns the snapshot's seq (0 when this node stepped
        down meanwhile). A consistent cut of the state is taken on the loop, with
        the seq and term that go with it; the state's build, the pack and
        the CRC run on a worker thread, so the loop keeps beating."""
        conn = await self.pool.get(addr)
        async with _LoopStall() as stall:
            t0 = time.perf_counter()
            cut = self.fs.snapshot_cut()
            seq, lterm = self.last_seq(), self.last_term()
            t1 = time.perf_counter()
            packing = asyncio.ensure_future(
                asyncio.to_thread(self._pack_snapshot, cut))
            while not (await asyncio.wait(
                    {packing}, timeout=self.heartbeat_ms / 1000))[0]:
                # the member hears nothing else from this leader meanwhile
                if not await self._beat(conn):
                    packing.cancel()
                    await asyncio.gather(packing, return_exceptions=True)
                    return 0
            blob, crc = packing.result()
            t2 = time.perf_counter()
            del cut
            csize = self.snapshot_chunk_bytes
            total = max(1, (len(blob) + csize - 1) // csize)
            # a deterministic stream id: a retransmit after a blip resumes
            # the same stream instead of starting again from chunk 0
            sid = f"{self.node_id}.{self.term}.{seq}"
            i, applied, stalls = 0, 0, 0
            while i < total:
                rep = await _call(conn, RpcCode.RAFT_SNAPSHOT_CHUNK, pack({
                    "term": self.term, "leader": self.node_id, "sid": sid,
                    "seq": seq, "last_term": lterm, "idx": i,
                    "total": total, "crc": crc,
                    "data": blob[i * csize:(i + 1) * csize]}), 10.0)
                body = unpack(rep.data) or {}
                if body.get("term", 0) > self.term:
                    self._step_down(body["term"])
                    return 0
                if self.metrics is not None:
                    self.metrics.inc("raft.snapshot_chunks_sent")
                have = int(body.get("have", i + 1))
                applied = max(applied, int(body.get("applied_seq", 0)))
                if have <= i:
                    # the member restarted the stream (a CRC mismatch, a
                    # new stream); bounded, so a broken peer cannot spin
                    stalls += 1
                    if stalls > 3:
                        raise err.AbnormalData(
                            f"snapshot stream to node {pid} not progressing "
                            f"(chunk {i}, follower has {have})")
                    i = max(0, have)
                    continue
                i = have
        if self.metrics is not None:
            self.metrics.gauge("raft.snapshot_build_s", t1 - t0)
            self.metrics.gauge("raft.snapshot_pack_s", t2 - t1)
            prev = self.metrics.gauges.get("raft.snapshot_loop_stall_ms", 0)
            self.metrics.gauge("raft.snapshot_loop_stall_ms",
                               max(prev, stall.max_s * 1000))
        if pid in self.match:
            self.match[pid] = max(self.match.get(pid, 0), applied)
            self._advance_commit()
        log.info("snapshot (seq=%d, %d chunk(s), %.1f MiB) sent to %s",
                 seq, total, len(blob) / 1048576, addr)
        return seq

    async def _beat(self, conn) -> bool:
        """An empty RAFT_APPEND to a member whose snapshot is being
        packed: it resets the member's election timer (its answer asks
        for the snapshot again, which is on its way). False once this
        node has stepped down."""
        try:
            rep = await _call(conn, RpcCode.RAFT_APPEND, pack({
                "term": self.term, "leader": self.node_id, "entries": [],
                "prev_seq": self.last_seq(), "prev_term": self.last_term(),
                "leader_seq": self.last_seq(),
                "leader_last_term": self.last_term()}), 2.0)
        except err.CurvineError as e:
            log.debug("heartbeat during a snapshot's pack failed: %s", e)
            return self.role == LEADER
        body = unpack(rep.data) or {}
        if body.get("term", 0) > self.term:
            self._step_down(body["term"])
        return self.role == LEADER

    # ---------------- leader transfer ----------------

    async def transfer_leadership(self, target: int | None = None) -> int:
        """Hand leadership over: pause new writes, drain the log to the
        target voter, then RAFT_TIMEOUT_NOW, so that it elects at once."""
        self.check_leader()
        candidates = self._voter_peers()
        if not candidates:
            raise err.InvalidArgument("no other voter to transfer to")
        if target is None:
            target = max(candidates,
                         key=lambda pid: self.match.get(pid, 0))
        target = int(target)
        if target not in candidates:
            raise err.InvalidArgument(
                f"node {target} is not a transferable voter")
        addr = candidates[target]
        loop = asyncio.get_event_loop()
        give_up = loop.time() + self.transfer_timeout_s
        log.info("node %d: transferring leadership to %d (%s)",
                 self.node_id, target, addr)
        self._transferring = True
        try:
            while self.match.get(target, 0) < self.last_seq():
                if self.role != LEADER:
                    raise err.NotLeader("deposed during transfer")
                if loop.time() > give_up:
                    raise err.RpcTimeout(
                        f"transfer: node {target} did not catch up within "
                        f"{self.transfer_timeout_s:.1f}s")
                await asyncio.sleep(0.01)
            conn = await self.pool.get(addr)
            await _call(conn, RpcCode.RAFT_TIMEOUT_NOW, pack({
                "term": self.term, "leader": self.node_id,
                "target": target}), 2.0)
            while self.role == LEADER:
                if loop.time() > give_up:
                    raise err.RpcTimeout(
                        f"transfer: node {target} did not take over within "
                        f"{self.transfer_timeout_s:.1f}s")
                await asyncio.sleep(0.01)
        finally:
            self._transferring = False
        if self.metrics is not None:
            self.metrics.inc("raft.leader_transfers")
        return target

    # ---------------- handlers (follower) ----------------

    async def _h_vote(self, msg: Message, conn: ServerConn):
        q = unpack(msg.data) or {}
        term, candidate = q["term"], q["candidate"]
        cand_log = (q.get("last_term", 0), q["last_seq"])
        if term > self.term:
            self._step_down(term)
        granted = (term >= self.term
                   and candidate in self.voters   # removed or learner: no
                   and self.voted_for in (None, candidate)
                   and cand_log >= (self.last_term(), self.last_seq()))
        if granted:
            self.voted_for = candidate
            self._save_hard_state()       # fsync before the vote leaves
            self._touch()
        return {}, pack({"granted": granted, "term": self.term})

    async def _h_prevote(self, msg: Message, conn: ServerConn):
        """Granted if we would vote for the candidate at that term and
        have not heard from a live leader within the least election
        timeout. Stateless: no term, no vote, no timer moves."""
        q = unpack(msg.data) or {}
        cand_log = (q.get("last_term", 0), q.get("last_seq", 0))
        now = asyncio.get_event_loop().time()
        heard_recently = (now - self._last_heard) < \
            (self.election_timeout[0] / 1000)
        granted = (self.role != LEADER          # a live leader never grants
                   and not heard_recently
                   and q.get("candidate") in self.voters
                   and q.get("term", 0) > self.term
                   and cand_log >= (self.last_term(), self.last_seq()))
        return {}, pack({"granted": granted, "term": self.term})

    async def _h_append(self, msg: Message, conn: ServerConn):
        q = unpack(msg.data) or {}
        term = q["term"]
        if term < self.term:
            return {}, pack({"term": self.term, "applied_seq": self.last_seq()})
        if term > self.term or self.role != FOLLOWER:
            self._step_down(term)
        self.leader_id = q["leader"]
        self._touch()
        need_snapshot = False
        entries = q.get("entries", [])
        if entries:
            # log matching: our entry at prev_seq must carry prev_term; a
            # deposed leader's divergent history fails this and heals by
            # a snapshot install
            prev_seq = q.get("prev_seq", entries[0][0] - 1)
            if prev_seq <= self.last_seq():
                ours = (self.fs.journal.term_of(prev_seq)
                        if self.fs.journal else 0)
                if ours is None or ours != q.get("prev_term", 0):
                    need_snapshot = True
        # the contiguous run of new entries, journaled and applied as one
        # batch (one flush a call: the follower's group commit)
        batch: list[tuple[int, str, dict, int]] = []
        nxt = self.last_seq() + 1
        for rec in ([] if need_snapshot else entries):
            seq, op, args = rec[0], rec[1], rec[2]
            eterm = rec[3] if len(rec) > 3 else 0
            if seq < nxt:
                continue                      # already here
            if seq != nxt:
                need_snapshot = True          # a gap: ask for catch-up
                batch = []
                break
            batch.append((seq, op, args, eterm))
            nxt += 1
        if batch:
            self.fs.apply_replicated_batch(batch)
            for _seq, op, cargs, _eterm in batch:
                if op == "raft_conf":
                    # effective when appended, on followers too: how a
                    # removed node learns to stand down and a promoted
                    # learner that it may elect
                    self._adopt_config(cargs)
        # the same head seq must mean the same head term; a follower that
        # diverged takes a snapshot install, which replaces its state
        if not need_snapshot:
            if q.get("leader_seq", 0) > self.last_seq():
                need_snapshot = True
            elif self.last_seq() > q.get("leader_seq", 0):
                need_snapshot = True          # entries the leader lacks
            elif (q.get("leader_seq", 0) == self.last_seq()
                  and q.get("leader_last_term", 0) != self.last_term()):
                need_snapshot = True
        return {}, pack({"term": self.term, "applied_seq": self.last_seq(),
                         "need_snapshot": need_snapshot})

    def _snapshot_is_stale(self, snap_term: int, snap_seq: int) -> bool:
        """Our log is at or past the snapshot's point: a late retransmit
        or a duplicate is acknowledged without replacing newer state."""
        return (self.last_term(), self.last_seq()) >= (snap_term, snap_seq)

    async def _h_snapshot(self, msg: Message, conn: ServerConn):
        """The monolithic install (older leaders); a leader of either
        package sends RAFT_SNAPSHOT_CHUNK streams."""
        q = _unpack_blob(msg.data)
        if q["term"] < self.term:
            return {}, pack({"term": self.term})
        self._touch()
        if self._snapshot_is_stale(q.get("last_term", 0), q["seq"]):
            return {}, pack({"term": self.term,
                             "applied_seq": self.last_seq(),
                             "skipped": True})
        self.fs.install_snapshot(q["state"], q["seq"],
                                 q.get("last_term", 0))
        self._adopt_config(getattr(self.fs, "raft_conf", None))
        if self.metrics is not None:
            self.metrics.inc("raft.snapshot_installs")
        log.info("node %d: installed snapshot at seq %d", self.node_id,
                 q["seq"])
        return {}, pack({"term": self.term, "applied_seq": self.last_seq()})

    async def _h_snapshot_chunk(self, msg: Message, conn: ServerConn):
        """One piece of a snapshot stream. Answers ``have`` (the chunks
        held) so that the leader resumes or rewinds; the last chunk's CRC
        check and install follow. A stale stream is acknowledged whole
        without an install."""
        q = _unpack_blob(msg.data)
        if q["term"] < self.term:
            return {}, pack({"term": self.term, "have": 0,
                             "applied_seq": self.last_seq()})
        if q["term"] > self.term or self.role not in (FOLLOWER,):
            self._step_down(q["term"])
        self.leader_id = q["leader"]
        self._touch()
        total = int(q["total"])
        if self._snapshot_is_stale(q.get("last_term", 0), q["seq"]):
            self._snap_rx = None
            return {}, pack({"term": self.term, "have": total,
                             "applied_seq": self.last_seq(),
                             "skipped": True})
        rx = self._snap_rx
        if rx is None or rx["sid"] != q["sid"]:
            rx = self._snap_rx = {"sid": q["sid"], "parts": [],
                                  "total": total}
        idx = int(q["idx"])
        if idx == len(rx["parts"]):
            rx["parts"].append(bytes(q["data"]))
        have = len(rx["parts"])
        if have < rx["total"]:
            return {}, pack({"term": self.term, "have": have,
                             "applied_seq": self.last_seq()})
        blob = b"".join(rx["parts"])
        self._snap_rx = None
        if zlib.crc32(blob) != q.get("crc", 0):
            log.warning("node %d: snapshot stream %s failed CRC, "
                        "restarting", self.node_id, q["sid"])
            return {}, pack({"term": self.term, "have": 0,
                             "applied_seq": self.last_seq()})
        body = _unpack_blob(blob)
        self.fs.install_snapshot(body["state"], q["seq"],
                                 q.get("last_term", 0))
        self._adopt_config(getattr(self.fs, "raft_conf", None))
        if self.metrics is not None:
            self.metrics.inc("raft.snapshot_installs")
        log.info("node %d: installed chunked snapshot at seq %d "
                 "(%d chunks, %.1f MiB)", self.node_id, q["seq"], have,
                 len(blob) / 1048576)
        return {}, pack({"term": self.term, "have": have,
                         "applied_seq": self.last_seq()})

    async def _h_timeout_now(self, msg: Message, conn: ServerConn):
        """The leader transfer's trigger: elect at once, without the
        prevote (the live leader asked to be deposed)."""
        q = unpack(msg.data) or {}
        accepted = (q.get("term", 0) >= self.term
                    and self.node_id in self.voters
                    and not self.removed
                    and self.role != LEADER)
        if accepted:
            self._touch()
            if self.metrics is not None:
                self.metrics.inc("raft.timeout_now")
            self._bg = [t for t in self._bg if not t.done()]
            self._bg.append(asyncio.ensure_future(
                self._run_election(force=True)))
        return {}, pack({"accepted": accepted, "term": self.term})

    async def _h_status(self, msg: Message, conn: ServerConn):
        """RAFT_STATUS: any node answers, followers too."""
        return {}, pack(self.status())

    def status(self) -> dict:
        inflight = (self._conf_seq is not None
                    and self._conf_seq > self.commit_seq)
        return {
            "node_id": self.node_id,
            "role": self.role,
            "term": self.term,
            "leader_id": self.leader_id,
            "leader_addr": self._addr_of(self.leader_id),
            "commit_seq": self.commit_seq,
            "last_seq": self.last_seq(),
            "conf_ver": self.conf_ver,
            "voters": {str(k): self.voters[k] for k in sorted(self.voters)},
            "learners": {str(k): self.learners[k]
                         for k in sorted(self.learners)},
            "match": ({str(k): v for k, v in sorted(self.match.items())}
                      if self.role == LEADER else {}),
            "removed": self.removed,
            "transferring": self._transferring,
            "inflight_change": bool(inflight),
        }

    # ---------------- client gate ----------------

    def check_leader(self) -> None:
        if self.role == LEADER and not self._transferring:
            return
        if self.role == LEADER:
            e = err.NotLeader(
                f"node {self.node_id}: leadership transfer in progress")
        else:
            e = err.NotLeader(
                f"node {self.node_id} is {self.role}; "
                f"leader is {self.leader_id}")
            hint = self._addr_of(self.leader_id)
            if hint:
                e.leader_hint = hint
        members = [a for a in self.voters.values() if a]
        if members:
            e.members = members
        raise e
