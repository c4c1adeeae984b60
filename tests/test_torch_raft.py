"""Raft HA on the port's masters (``curvine_tpu_torch/master/ha.py``).

Mirrors 14 of the 15 tests of ``tests/test_raft.py`` on
``PortRaftCluster`` (``tests/torch_cluster.py``): election and
replication, failover, snapshot catch-up, a leader killed under a write
storm with no acknowledged write lost, prevote against a partitioned node
and through a real failover, the hard state across a restart and
mid-election, workers that heartbeat every master, the membership
lifecycle (learners, promotion, transfer, removal), a chunked snapshot
install of a namespace larger than a frame, a stale install skipped,
elections under dropped messages, and commit waiters that do not leak.
``test_followers_do_not_act_on_ttl`` is left out (the port has no TTL
scanner); in its place ``test_followers_do_not_act_on_replication_jobs_
or_repair`` holds the other duties' gate. Beyond the mirrors: a newly
elected leader places blocks at once (the C9 wait is a restart's only),
membership survives a KV restart through the hard state, a cluster file
with ``raft_peers`` starts three masters in their own processes, and the
faults found while porting (ROADMAP §C): the leader keeps beating while
it packs a large snapshot (C10), a sole voter elects itself (C11), a
follower's block report names no orphan (C12), a prevote refused from a
later term takes that term (C13), and an entry appended while a call is
on its way costs no snapshot (C14).

Every wait is on a condition with a timeout, never a sleep and then an
assert: the suite runs on six loaded workers."""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import (JobInfo, JobState, SetAttrOpts,
                                            TaskInfo)
from curvine_tpu_torch.master import filesystem as port_fs
from curvine_tpu_torch.master import ha
from curvine_tpu_torch.master.ha import LEADER, RaftLite
from curvine_tpu_torch.rpc.client import Connection
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import MAX_FRAME, Message, pack, unpack

from torch_cluster import MB, Partition, PortRaftCluster

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


async def _until(cond, timeout: float = 15.0, tick: float = 0.02):
    async def wait():
        while not cond():
            await asyncio.sleep(tick)
    await asyncio.wait_for(wait(), timeout)


async def test_election_and_replication(tmp_path):
    async with PortRaftCluster(tmp_path) as cl:
        await cl.wait_leader()
        c = cl.client()
        await c.meta.mkdir("/ha/x")
        st = await c.meta.create_file("/ha/f.bin", block_size=MB)
        assert st.path == "/ha/f.bin"
        await _until(lambda: all(
            m.fs.tree.resolve("/ha/x") is not None
            and m.fs.tree.resolve("/ha/f.bin") is not None
            for m in cl.live()))


async def test_leader_failover(tmp_path):
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        c = cl.client()
        await c.meta.mkdir("/pre/fail")
        await _until(lambda: all(m.fs.tree.resolve("/pre/fail")
                                 for m in cl.live()))
        await cl.kill(leader.raft.node_id)
        new_leader = await cl.wait_leader()
        assert new_leader is not leader
        assert new_leader.fs.tree.resolve("/pre/fail") is not None
        await c.meta.mkdir("/post/fail")
        assert await c.meta.exists("/post/fail")


async def test_snapshot_catch_up(tmp_path):
    """A follower that missed entries while its raft was stopped catches
    up (by a snapshot when it is behind the window)."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        follower = next(m for m in cl.live() if m is not leader)
        await follower.raft.stop()
        c = cl.client(master_addrs=[leader.addr])
        for i in range(20):
            await c.meta.mkdir(f"/snap/d{i}")
        await follower.raft.start()
        await _until(lambda: follower.fs.tree.resolve("/snap/d19")
                     is not None)
        assert follower.fs.journal.seq >= leader.fs.journal.seq - 1


async def test_kill_leader_mid_write_storm_no_acked_loss(tmp_path):
    """Every write acknowledged to the client outlives a leader killed
    mid-storm, and the survivors converge."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        c = cl.client(rpc_timeout_ms=3_000)
        acked: list[int] = []

        async def storm():
            i = 0
            while len(acked) < 80 and i < 400:
                try:
                    await c.meta.mkdir(f"/storm/d{i:04d}")
                    acked.append(i)
                except err.CurvineError:
                    pass            # unacknowledged: allowed to be lost
                i += 1

        task = asyncio.ensure_future(storm())
        await _until(lambda: len(acked) >= 15, tick=0.01)
        await cl.kill(leader.raft.node_id)
        await asyncio.wait_for(task, 60)
        survivors = cl.live()
        new_leader = await cl.wait_leader()
        missing = [i for i in acked
                   if new_leader.fs.tree.resolve(f"/storm/d{i:04d}") is None]
        assert not missing, f"acknowledged writes lost: {missing}"
        await _until(lambda: len({m.fs.journal.seq for m in survivors}) == 1)
        names = [sorted(s.path for s in m.fs.list_status("/storm"))
                 for m in survivors]
        assert names[0] == names[1], "divergent followers"


async def test_prevote_partitioned_node_cannot_depose_leader(tmp_path):
    """A node cut off from the quorum fails its prevotes, so its term
    stays; healed, it rejoins as a follower and the leader keeps its role
    and term."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        # a settled group: every node follows the leader in its term
        await _until(lambda: all(m.raft.leader_id == leader.raft.node_id
                                 and m.raft.term == leader.raft.term
                                 for m in cl.live()))
        victim = next(m for m in cl.live() if m is not leader)
        term_before = leader.raft.term
        cut = Partition(victim)
        await victim.raft.pool.close()      # no call in flight gets out
        # many election timeouts (150-300 ms) pass while it is cut off:
        # its election loop must have run its prevote more than once
        elections0 = victim.metrics.counters.get("raft.elections", 0)
        t0 = time.monotonic()
        await _until(lambda: time.monotonic() - t0 > 2.0)
        assert victim.raft.term == term_before, \
            f"partitioned node raised its term {term_before} -> " \
            f"{victim.raft.term} despite the prevote"
        assert victim.metrics.counters.get("raft.elections", 0) == elections0
        assert victim.raft.role != LEADER
        assert leader.raft.role == LEADER
        cut.heal()
        await _until(lambda: victim.raft.leader_id == leader.raft.node_id)
        assert leader.raft.role == LEADER, "healthy leader was deposed"
        assert leader.raft.term == term_before
        assert victim.raft.role != LEADER


async def test_prevote_does_not_block_legitimate_elections(tmp_path):
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        await cl.kill(leader.raft.node_id)
        new_leader = await cl.wait_leader()
        assert new_leader.raft.role == LEADER
        assert new_leader.raft.term > 0


async def test_hard_state_survives_restart(tmp_path):
    """term and voted_for are fsync'd: a fresh RaftLite over the same
    directory reads them back."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        follower = next(m for m in cl.live() if m is not leader)
        term, voted = follower.raft.term, follower.raft.voted_for
        assert term > 0
        reloaded = RaftLite(99, {}, follower.fs, follower.rpc,
                            state_dir=follower.conf.master.journal_dir)
        assert reloaded.term == term
        assert reloaded.voted_for == voted


async def test_followers_do_not_act_on_replication_jobs_or_repair(
        tmp_path, monkeypatch):
    """The duties that act on the namespace run on the leader only: a
    follower neither dispatches a queued repair, nor scans, nor hands a
    lost worker's blocks to repair, nor dispatches a job's task, nor
    recovers a stale lease; the LOST bookkeeping runs everywhere. No
    follower's journal runs ahead of the leader's. (The TTL half of
    the reference's test waits for the port's TTL scanner.)"""
    async with PortRaftCluster(tmp_path, scan_interval_s=0.05,
                               worker_lost_timeout_ms=1_000,
                               heartbeat_check_ms=100) as cl:
        leader = await cl.wait_leader()
        followers = [m for m in cl.live() if m is not leader]
        calls = {id(m): {"dispatch": 0, "scan": 0, "lost": 0, "job": 0}
                 for m in cl.live()}
        for m in cl.live():
            rec = calls[id(m)]

            def spy(name, fn, rec=rec):
                def wrapped(*a, **kw):
                    rec[name] += 1
                    return fn(*a, **kw)
                return wrapped

            async def dispatch(bid, rec=rec):
                rec["dispatch"] += 1
                return True

            async def job(task, rec=rec):
                rec["job"] += 1

            m.replication._dispatch = dispatch
            m.replication._drain_scan = spy("scan",
                                            m.replication._drain_scan)
            m.fs.on_worker_lost = spy("lost", m.fs.on_worker_lost)
            m.jobs._dispatch = job
        w1, w2 = await cl.add_worker(), await cl.add_worker()
        await _until(lambda: all(len(m.fs.workers.live_workers()) == 2
                                 for m in cl.live()))
        c = cl.client(replicas=2)
        await c.write_all("/gate.bin", b"g" * 4096)
        bid = (await c.meta.get_block_locations(
            "/gate.bin")).block_locs[0].block.id
        # every master knows both replicas (by the workers' reports)
        await _until(lambda: all(len(m.fs.blocks.locs.get(bid, {})) == 2
                                 for m in cl.live()))
        for m in cl.live():
            m.replication.enqueue([bid])
            m.jobs.jobs["j"] = JobInfo(job_id="j", kind="load", path="/",
                                       state=JobState.RUNNING)
            m.jobs._pending.put_nowait(TaskInfo(task_id="t", job_id="j"))
        await _until(lambda: calls[id(leader)]["dispatch"] >= 1
                     and calls[id(leader)]["scan"] >= 1)
        # a stale lease: an open file whose writer went away long ago
        await c.meta.create_file("/open.bin")
        await _until(lambda: all(m.fs.tree.resolve("/open.bin")
                                 for m in cl.live()))
        future = port_fs.now_ms() + 10 * 300_000
        monkeypatch.setattr(port_fs, "now_ms", lambda: future)
        seqs = {id(m): m.fs.journal.seq for m in followers}
        for m in followers:
            m._lease_recovery_tick()
            assert m.fs.journal.seq == seqs[id(m)]
        leader._lease_recovery_tick()
        monkeypatch.undo()
        await _until(lambda: not any(m.fs.tree.resolve("/open.bin")
                                     for m in cl.live()))
        # a worker dies: every node marks it LOST, the leader alone
        # hands its blocks to repair
        await w2.stop()
        await _until(lambda: all(
            len(m.fs.workers.lost_workers()) == 1 for m in cl.live()))
        await _until(lambda: calls[id(leader)]["lost"] >= 1)
        await _until(lambda: calls[id(leader)]["job"] >= 1, timeout=5.0)
        for m in followers:
            assert calls[id(m)] == {"dispatch": 0, "scan": 0, "lost": 0,
                                    "job": 0}, calls[id(m)]
        assert max(m.fs.journal.seq for m in cl.live()) == \
            leader.fs.journal.seq
        # a repair report to a follower is refused, so the worker turns
        # to the leader
        conn = await Connection(followers[0].addr).connect()
        try:
            with pytest.raises(err.NotLeader):
                await conn.call(RpcCode.REPORT_UNDER_REPLICATED_BLOCKS,
                                data=pack({"block_ids": [bid]}))
        finally:
            await conn.close()
        assert w1.worker_id in {w.address.worker_id
                                for w in leader.fs.workers.live_workers()}


async def test_new_leader_places_blocks_at_once(tmp_path):
    """The workers heartbeat every master, so a newly elected leader
    knows them: a follower restarted from its journal (the case C9's
    IN_PROGRESS wait is armed for), once elected, places its first block
    at once."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        await cl.add_worker()
        await _until(lambda: all(len(m.fs.workers.live_workers()) == 1
                                 for m in cl.live()))
        c = cl.client()
        await c.write_all("/before.bin", b"b" * 1000)
        nid = next(n for n in cl.masters if n != leader.raft.node_id)
        await _until(lambda: cl.masters[nid].fs.journal.seq ==
                     leader.fs.journal.seq)
        back = await cl.restart(nid)
        assert back.fs.recovery["applied_seq"] > 0
        await _until(lambda: len(back.fs.workers.live_workers()) == 1
                     and back.fs.journal.seq == leader.fs.journal.seq)
        assert await cl.transfer(nid) == nid
        await _until(lambda: back.raft.is_leader)
        c2 = cl.client(master_addrs=[back.addr], conn_retry_max=0)
        await c2.write_all("/after.bin", b"a" * 1000)
        assert await (await c2.open("/after.bin")).read_all() == b"a" * 1000


async def test_workers_heartbeat_all_masters(tmp_path):
    """Every master, followers too, knows the live worker and, by the
    worker's reports, each replica's location."""
    async with PortRaftCluster(tmp_path) as cl:
        await cl.wait_leader()
        await cl.add_worker()
        await _until(lambda: all(len(m.fs.workers.live_workers()) == 1
                                 for m in cl.live()))
        c = cl.client()
        await c.write_all("/ha-data.bin", b"H" * 2048)
        assert await (await c.open("/ha-data.bin")).read_all() == \
            b"H" * 2048

        def all_have_locs():
            ok = 0
            for m in cl.live():
                try:
                    fb = m.fs.get_block_locations("/ha-data.bin")
                except err.CurvineError:
                    continue
                ok += bool(fb.block_locs and fb.block_locs[0].locs)
            return ok == len(cl.live())
        await _until(all_have_locs)


async def test_membership_lifecycle_e2e(tmp_path):
    """3 -> 5 voters through learners (snapshot and log tail, then
    promotion), leadership handed off the first leader, which is then
    removed and stands down by itself; no acknowledged write lost, and
    the removed node's vote refused."""
    async with PortRaftCluster(tmp_path, spares=2) as cl:
        leader = await cl.wait_leader()
        old_leader_id = leader.raft.node_id
        c = cl.client()
        acked: list[int] = []
        stop = {"v": False}

        async def writer():
            i = 0
            while not stop["v"]:
                try:
                    await c.meta.mkdir(f"/life/d{i:04d}")
                    acked.append(i)
                except err.CurvineError:
                    pass
                i += 1
                await asyncio.sleep(0.01)

        wtask = asyncio.ensure_future(writer())
        await _until(lambda: len(acked) >= 10, tick=0.01)
        n4 = await cl.add_learner()
        await cl.wait_promoted(n4)
        n5 = await cl.add_learner()
        await cl.wait_promoted(n5)
        leader = await cl.wait_leader()
        assert len(leader.raft.voters) == 5 and not leader.raft.learners
        new_leader_id = await cl.transfer()
        assert new_leader_id != old_leader_id
        await _until(lambda: cl.leader() is not None
                     and cl.leader().raft.node_id == new_leader_id)
        await cl.remove_node(old_leader_id, stop=False)
        removed = cl.masters[old_leader_id]
        await _until(lambda: removed.raft.removed)
        stop["v"] = True
        await wtask
        leader = await cl.wait_leader(
            among=[m for m in cl.live() if m is not removed])
        assert old_leader_id not in leader.raft.voters
        assert len(leader.raft.voters) == 4
        missing = [i for i in acked
                   if leader.fs.tree.resolve(f"/life/d{i:04d}") is None]
        assert not missing, f"acknowledged writes lost: {missing[:5]}"
        voter = next(m for nid, m in cl.masters.items()
                     if nid != old_leader_id and m.raft.role != LEADER)
        msg = Message(data=pack({"term": voter.raft.term + 1,
                                 "candidate": old_leader_id,
                                 "last_seq": 10**9, "last_term": 10**9}))
        _, rep = await voter.raft._h_vote(msg, None)
        assert not unpack(rep)["granted"], \
            "a voter granted a removed node's vote request"


async def test_chunked_snapshot_install_over_max_frame(tmp_path):
    """A namespace larger than MAX_FRAME still catches a follower up, in
    bounded RAFT_SNAPSHOT_CHUNK frames. The masters share this process's
    event loop, where the 8 MiB entries' codec and the 72 MiB install
    stall every node at once: election timeouts of 1-2 s keep such a
    stall from electing anew (the transfer needs no timeout)."""
    async with PortRaftCluster(tmp_path, election_timeout=(1000, 2000),
                               heartbeat_ms=100) as cl:
        leader = await cl.wait_leader()
        c = cl.client()
        await c.meta.mkdir("/fat")
        victim = next(nid for nid in cl.masters
                      if nid != leader.raft.node_id)
        await cl.kill(victim)
        pad = "x" * (8 * MB)
        for i in range(9):
            await c.meta.create_file(f"/fat/f{i}")
            await c.meta.set_attr(f"/fat/f{i}",
                                  SetAttrOpts(add_x_attr={"pad": pad}))
        blob = pack({"state": leader.fs._snapshot_state()})
        assert len(blob) > MAX_FRAME, len(blob)
        del blob
        # the other follower's fresh replicate loop has nothing queued for
        # the victim: its catch-up must go by the (chunked) snapshot
        new_leader = cl.masters[await cl.transfer()]
        await cl.restart(victim)

        def caught_up():
            m = cl.masters.get(victim)
            node = m.fs.tree.resolve("/fat/f8") if m is not None else None
            return node is not None and \
                len(node.x_attr.get("pad", "")) == 8 * MB
        await _until(caught_up, timeout=60, tick=0.1)
        sent = new_leader.metrics.counters.get("raft.snapshot_chunks_sent", 0)
        installs = cl.masters[victim].metrics.counters.get(
            "raft.snapshot_installs", 0)
        assert sent > 1, f"snapshot was not chunked ({sent} chunk sends)"
        assert installs >= 1, "follower never installed the stream"


async def test_stale_snapshot_install_is_skipped(tmp_path):
    """A snapshot whose point is at or behind the follower's log is
    acknowledged without an install (monolithic and chunked)."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        c = cl.client()
        await c.meta.mkdir("/keep/me")
        follower = next(m for m in cl.live() if m is not leader)
        await _until(lambda: follower.fs.tree.resolve("/keep/me")
                     is not None)
        r = follower.raft
        stale = {"term": r.term, "leader": leader.raft.node_id,
                 "seq": max(0, r.last_seq() - 1),
                 "last_term": r.last_term(), "state": {"bogus": True}}
        _, rep = await r._h_snapshot(Message(data=pack(stale)), None)
        assert unpack(rep).get("skipped")
        assert follower.fs.tree.resolve("/keep/me") is not None
        chunk = dict(stale, sid="9.9.9", idx=0, total=1, crc=0, data=b"x")
        _, rep = await r._h_snapshot_chunk(Message(data=pack(chunk)), None)
        assert unpack(rep).get("skipped")
        assert follower.fs.tree.resolve("/keep/me") is not None


async def test_restart_mid_election_no_double_vote(tmp_path):
    """A node that granted a vote and restarted mid-election refuses
    another candidate in that term, and grants the same one again."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        follower = next(m for m in cl.live() if m is not leader)
        others = [m for m in cl.live() if m is not follower]
        r = follower.raft
        term = r.term + 10
        cand_a, cand_b = (o.raft.node_id for o in others)

        def vote(raft, cand):
            return raft._h_vote(Message(data=pack(
                {"term": term, "candidate": cand,
                 "last_seq": 10**9, "last_term": 10**9})), None)

        _, rep = await vote(r, cand_a)
        assert unpack(rep)["granted"]
        peers = {m.raft.node_id: "" for m in others}
        reloaded = RaftLite(r.node_id, peers, follower.fs, follower.rpc,
                            state_dir=follower.conf.master.journal_dir)
        assert (reloaded.term, reloaded.voted_for) == (term, cand_a)
        _, rep = await vote(reloaded, cand_b)
        assert not unpack(rep)["granted"], \
            "restarted node voted twice in one term"
        _, rep = await vote(reloaded, cand_a)
        assert unpack(rep)["granted"]


async def test_election_under_packet_drop(tmp_path):
    """With 30% of every raft message dropped on all nodes, an election
    still converges and no term has two leaders."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        cuts = [Partition(m, p=0.3, seed=i)
                for i, m in enumerate(cl.live())]
        await cl.kill(leader.raft.node_id)
        survivors = cl.live()
        leaders_by_term: dict[int, set[int]] = {}

        async def sample():
            while True:
                for m in survivors:
                    if m.raft.role == LEADER:
                        leaders_by_term.setdefault(
                            m.raft.term, set()).add(m.raft.node_id)
                await asyncio.sleep(0.01)

        stask = asyncio.ensure_future(sample())
        try:
            await cl.wait_leader(timeout=30)
        finally:
            stask.cancel()
            await asyncio.gather(stask, return_exceptions=True)
        for cut in cuts:
            if cut.m in survivors:
                cut.heal()
        multi = {t: s for t, s in leaders_by_term.items() if len(s) > 1}
        assert not multi, f"terms with two leaders: {multi}"


async def test_commit_waiters_do_not_leak(tmp_path):
    """Released waiters leave the list, and a timed-out one too."""
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        c = cl.client()
        for i in range(10):
            await c.meta.mkdir(f"/wl/d{i}")
        assert leader.raft._commit_waiters == []
        leader.raft.commit_timeout_s = 0.05
        with pytest.raises(err.RpcTimeout):
            await leader.raft.wait_committed(leader.raft.last_seq() + 1000)
        assert leader.raft._commit_waiters == [], "timed-out waiter leaked"


async def test_follower_report_deletes_no_block_it_has_not_seen(tmp_path):
    """C12: a worker deletes the orphans any master names in its answer
    to a full block report. A follower that lags the leader (here: its
    appends refused, as while a wiped node waits for its snapshot) names no
    orphan, so the blocks written meanwhile survive its reports. Election
    timeouts of 1-2 s keep the roles fixed on a loaded box."""
    async with PortRaftCluster(tmp_path, election_timeout=(1000, 2000),
                               heartbeat_ms=100) as cl:
        leader = await cl.wait_leader()
        lagging = next(m for m in cl.live() if m is not leader)
        w = await cl.add_worker()
        await _until(lambda: all(len(m.fs.workers.live_workers()) == 1
                                 for m in cl.live()))
        async def held_back(msg, conn):
            raise err.CurvineError("appends held back")

        lagging.rpc.register(RpcCode.RAFT_APPEND, held_back)
        c = cl.client()
        await c.write_all("/new.bin", b"n" * 5000)
        bid = (await c.meta.get_block_locations(
            "/new.bin")).block_locs[0].block.id
        assert lagging.fs.store.block_get(bid) is None
        await w.block_report_once()
        assert w.store.contains(bid), "a lagging follower deleted a block"
        assert await (await c.open("/new.bin")).read_all() == b"n" * 5000
        # the leader still names an orphan; the follower names none
        req = {"worker_id": w.worker_id, "blocks": {999_999: 1}}
        assert leader._worker_block_report(dict(req))["delete_blocks"] == \
            [999_999]
        assert lagging._worker_block_report(dict(req))["delete_blocks"] == []


async def test_prevote_refused_from_a_later_term_takes_it(tmp_path):
    """C13: after the leader's death, survivor A holds a later term (its
    vote request was lost) and B a longer log. A's prevotes fail (B's log
    is longer); B's asked for a term A already holds, and without taking
    A's term from the refusal B asked for it for ever: no leader. B
    takes it and is elected."""
    async with PortRaftCluster(tmp_path, election_timeout=(300, 600),
                               heartbeat_ms=50) as cl:
        leader = await cl.wait_leader()
        a, b = [m for m in cl.live() if m is not leader]

        async def held_back(msg, conn):
            raise err.CurvineError("appends held back")

        a.rpc.register(RpcCode.RAFT_APPEND, held_back)
        c = cl.client(master_addrs=[leader.addr])
        await c.meta.mkdir("/longer")
        await _until(lambda: b.fs.journal.seq == leader.fs.journal.seq)
        assert b.fs.journal.seq > a.fs.journal.seq
        # A's failed election: its term raised, its vote never reached B
        a.raft.term, a.raft.voted_for = b.raft.term + 1, a.raft.node_id
        a.raft._save_hard_state()
        await cl.kill(leader.raft.node_id)
        a.rpc.register(RpcCode.RAFT_APPEND, a.raft._h_append)
        new = await cl.wait_leader(timeout=20)
        assert new is b
        await _until(lambda: a.fs.tree.resolve("/longer") is not None)


async def test_entry_appended_during_a_call_costs_no_snapshot(tmp_path):
    """C14: an entry appended while the leader's call to a member is on
    its way (here: while its connection is fetched) is the next batch's;
    the call's head is what the member was sent, so the member is not
    found behind and is sent no snapshot. Election timeouts of 1-2 s keep
    a loaded box from electing anew (a new term's noop is a divergence
    that a snapshot heals)."""
    async with PortRaftCluster(tmp_path, election_timeout=(1000, 2000),
                               heartbeat_ms=100) as cl:
        leader = await cl.wait_leader()
        f = next(m for m in cl.live() if m is not leader)
        c = cl.client(master_addrs=[leader.addr])
        await c.meta.mkdir("/before")
        await _until(lambda: all(m.fs.journal.seq == leader.fs.journal.seq
                                 for m in cl.live()))
        # a start-up split vote may have cost a snapshot already
        sent0 = leader.metrics.counters.get("raft.snapshot_chunks_sent", 0)
        installs0 = f.metrics.counters.get("raft.snapshot_installs", 0)
        real_get, raced = leader.raft.pool.get, []

        async def get(addr):
            if addr == f.addr and not raced:
                raced.append(leader.fs.mkdir(f"/raced{len(raced)}"))
            return await real_get(addr)

        leader.raft.pool.get = get
        await _until(lambda: f.fs.tree.resolve("/raced0") is not None)
        await asyncio.sleep(0.3)        # the member's next calls
        assert leader.raft.is_leader
        assert leader.metrics.counters.get(
            "raft.snapshot_chunks_sent", 0) == sent0
        assert f.metrics.counters.get("raft.snapshot_installs", 0) == \
            installs0


async def test_sole_voter_elects_itself(tmp_path):
    """C11: a group of one voter elects itself, serves writes (commit by
    its own quorum) and grows by a learner; the reference's tally runs
    only as peers answer, and a sole voter has none."""
    async with PortRaftCluster(tmp_path, n=1, spares=1) as cl:
        leader = await cl.wait_leader()
        assert leader.raft.term == 1 and leader.raft.quorum == 1
        c = cl.client()
        await c.meta.mkdir("/solo")
        n2 = await cl.add_learner()
        await cl.wait_promoted(n2)
        await _until(lambda: cl.masters[n2].fs.tree.resolve("/solo")
                     is not None)


async def test_refresh_masters_takes_the_promoted_member(tmp_path):
    """``FsClient.refresh_masters`` replaces the conf's master list by the
    active config's voters, a promoted learner among them, and keeps the
    master it was talking to active at that master's new index."""
    async with PortRaftCluster(tmp_path, spares=1) as cl:
        await cl.wait_leader()
        n4 = await cl.add_learner()
        await cl.wait_promoted(n4)
        leader = cl.leader()
        want = cl.addrs[leader.raft.node_id - 1]
        meta = cl.client().meta
        meta.masters = list(reversed(cl.addrs[:3]))
        meta._active = meta.masters.index(want)
        got = await meta.refresh_masters()
        assert sorted(got) == sorted(cl.addrs[:4]) == sorted(meta.masters)
        assert meta.masters[meta._active] == want
        await meta.mkdir("/refreshed")
        await _until(lambda: leader.fs.tree.resolve("/refreshed") is not None)


async def test_membership_survives_a_kv_restart(tmp_path):
    """On the KV store a restart neither replays a compacted
    ``raft_conf`` entry nor reads a snapshot: the hard state's config
    brings the grown membership back."""
    async with PortRaftCluster(tmp_path, spares=1) as cl:
        await cl.wait_leader()
        n4 = await cl.add_learner()
        await cl.wait_promoted(n4)
        c = cl.client()
        for i in range(12):
            await c.meta.mkdir(f"/m/d{i}")
        follower = next(nid for nid in cl.masters
                        if nid != cl.leader().raft.node_id and nid != n4)
        m = cl.masters[follower]
        assert m.fs.store.kind == "kv"
        await _until(lambda: m.fs.journal.seq == cl.leader().fs.journal.seq)
        await cl.kill(follower)
        back = await cl.restart(follower)
        # the store had applied every entry: no raft_conf was replayed,
        # and no snapshot holds one; the boot config has three voters
        assert back.fs.recovery["replayed"] == 0
        assert back.fs.raft_conf is None
        assert sorted(back.raft.voters) == [1, 2, 3, n4]
        assert back.raft.conf_ver >= 2


async def test_snapshot_pack_keeps_the_leader_beating(tmp_path,
                                                       monkeypatch):
    """C10: the leader packs a snapshot's blob off its event loop. With
    a pack that takes 1.5 s (a large namespace in the Python codec; the
    followers' election timeout is 150-300 ms here) the leader's loop
    still beats: no follower starts an election and the term stays,
    while the wiped node is caught up by the snapshot."""
    slow = ha.RaftLite._pack_snapshot

    def slow_pack(self, state):
        time.sleep(1.5)
        return slow(self, state)

    monkeypatch.setattr(ha.RaftLite, "_pack_snapshot", slow_pack)
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        c = cl.client()
        for i in range(5):
            await c.meta.mkdir(f"/c10/d{i}")
        victim = next(nid for nid in cl.masters
                      if nid != leader.raft.node_id)
        await cl.kill(victim)
        cl.wipe(victim)
        term = leader.raft.term
        elections = {nid: m.metrics.counters.get("raft.elections", 0)
                     for nid, m in cl.masters.items()}
        back = await cl.restart(victim)
        await _until(lambda: back.fs.tree.resolve("/c10/d4") is not None,
                     timeout=20)
        assert back.metrics.counters.get("raft.snapshot_installs", 0) >= 1
        assert leader.raft.role == LEADER and leader.raft.term == term
        for nid, m in cl.masters.items():
            assert m.metrics.counters.get("raft.elections", 0) == \
                elections.get(nid, 0), f"node {nid} held an election"
        # the leader notes its figures once the last chunk's answer is in
        await _until(lambda: "raft.snapshot_pack_s" in leader.metrics.gauges)
        assert leader.metrics.gauges["raft.snapshot_pack_s"] >= 1.5
        # on the loop the pack would have stalled it 1,500 ms
        assert leader.metrics.gauges["raft.snapshot_loop_stall_ms"] < 1000


async def test_a_follower_hands_reads_to_the_leader_until_its_workers_report(
        tmp_path, monkeypatch):
    """ROADMAP §C, C16. A wiped follower takes the worker's report before
    its snapshot install (every block an orphan to its empty namespace),
    then installs: it knows the file and none of its replicas. The
    install makes it ask the worker for its blocks again, and until they
    come it hands a read it cannot locate to the leader, so a client that
    names that follower alone reads the file's bytes (the reference's
    follower answers no location: the read fails with BlockNotFound).
    Once the worker reports, the follower answers itself."""
    gate = asyncio.Event()
    install = RaftLite._install

    async def gated(self, *a, **kw):
        await gate.wait()
        return await install(self, *a, **kw)

    monkeypatch.setattr(RaftLite, "_install", gated)
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        w = await cl.add_worker()
        w.executor.cancel("block-report")        # forced reports only
        data = os.urandom(300_000)
        await cl.client().write_all("/c16.bin", data)
        victim = next(nid for nid in cl.masters
                      if nid != leader.raft.node_id)
        await cl.kill(victim)
        cl.wipe(victim)
        back = await cl.restart(victim)
        await _until(lambda: back.fs.workers.has_current_report(
            w.worker_id))
        assert back.fs.tree.resolve("/c16.bin") is None
        w._forced_report_at = float("inf")      # no report until asked
        gate.set()
        await _until(lambda: back.fs.tree.resolve("/c16.bin") is not None,
                     timeout=20)
        assert not back.fs.workers.has_current_report(w.worker_id)
        assert back.fs.get_block_locations(
            "/c16.bin").block_locs[0].locs == []
        solo = cl.client(master_addrs=[back.addr])
        assert bytes(await solo.read_all("/c16.bin")) == data
        assert back.metrics.counters.get("raft.reads_to_leader", 0) >= 1
        w._forced_report_at = 0.0
        await _until(lambda: back.fs.get_block_locations(
            "/c16.bin").block_locs[0].locs != [])
        alone = cl.client(master_addrs=[back.addr])
        fb = await alone.meta.get_block_locations("/c16.bin")
        assert [x.worker_id for x in fb.block_locs[0].locs] == [w.worker_id]
        assert alone.meta.masters[alone.meta._active] == back.addr


def test_cluster_file_with_raft_peers_starts_three_masters(tmp_path):
    """A cluster file that sets ``raft_peers`` starts three masters in
    their own processes (``python -m curvine_tpu_torch.master``), which
    elect one leader; their start lines carry the raft status and say no
    JAX module is loaded."""
    import socket
    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    addrs = [f"127.0.0.1:{p}" for p in ports]
    procs = []
    env = dict(os.environ, PYTHONPATH=HERE)
    try:
        for i in range(3):
            f = tmp_path / f"m{i}.toml"
            f.write_text(
                f"[master]\nhostname = \"127.0.0.1\"\nrpc_port = {ports[i]}\n"
                f"journal_dir = \"{tmp_path / f'j{i}'}\"\n"
                f"raft_peers = {json.dumps(addrs)}\nraft_node_id = {i + 1}\n"
                f"[client]\nmaster_addrs = {json.dumps(addrs)}\n")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "curvine_tpu_torch.master", "--conf",
                 str(f)], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, env=env, cwd=str(tmp_path)))
        lines = [json.loads(p.stdout.readline()) for p in procs]
        assert all(ln["jax_free"] for ln in lines)
        assert sorted(ln["raft"]["node_id"] for ln in lines) == [1, 2, 3]

        async def roles():
            out = []
            for a in addrs:
                conn = await Connection(a).connect()
                try:
                    out.append(unpack((await conn.call(
                        RpcCode.RAFT_STATUS, data=pack({}))).data))
                finally:
                    await conn.close()
            return out

        async def one_leader():
            while True:
                st = await roles()
                leaders = [s for s in st if s["role"] == LEADER]
                if len(leaders) == 1 and all(
                        s["leader_id"] == leaders[0]["node_id"] for s in st):
                    return st
                await asyncio.sleep(0.1)

        st = asyncio.run(asyncio.wait_for(one_leader(), 30))
        assert len({s["term"] for s in st}) == 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()
