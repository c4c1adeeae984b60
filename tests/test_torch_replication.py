"""Port parity: blocks kept at their replica count (``master/
replication.py``, the worker's SUBMIT_BLOCK_REPLICATION_JOB), the ``ici``
placement (``master/placement.py``), the writer's replica fan-out
(``client/writer.py``) and the checkpoint's tree distribution
(``gpu/broadcast.py::distribute_checkpoint``) of ``curvine_tpu_torch``,
against the JAX package on the CPU.

Mirrors, from tests/test_ici_plane.py, ``test_topology_distance_fallback_
tiers`` (:61), ``test_ici_policy_fault_domain_spread`` (:88) and
``test_ici_policy_host_fallback_spread`` (:113), each choice equal to the
reference policy's on the same worker lists; the four replication tests
(:316, :345, :369, :394; the last asserts that the source is among the
holders nearest the destination, since two holders can be equally near);
``test_distribute_tree_matches_flat`` (:198), twice: on two gloo ranks
(only rank 0's checkpoint is real, the other's is zeros, so every leaf
is shown to come from rank 0), and in one process against the JAX
package's ``distribute_checkpoint`` on its 8-device CPU mesh, with every
block sourced from a worker's tier-0 on the tree path. From
tests/test_cluster.py ``test_replicated_write`` (:128); from
tests/test_resilience.py ``test_rereplication_after_worker_loss`` (:36)
and ``test_scrub_detects_corruption_and_heals`` (:212), here through the
port's pin verification (the scrub is ROADMAP A3e's); from
tests/test_write_path.py the vectors that need no replay buffer:
``test_mid_chunk_death_survivors_continue`` (:59) at 2 and 3 replicas,
``test_open_death_refused_leg_dropped`` (:127),
``test_finish_death`` (:178) at 2 replicas, and
``test_killed_mid_block_replica_healed`` (:328). A worker dies by its own
``stop()`` and refuses an open by a WRITE_BLOCK handler that raises, as
the port has no fault injector. One parity test hands both packages'
``ReplicationManager._replicate`` the same block map, worker map,
advertisements and flagged replicas over seeded scenarios and asserts
the same submitted job. Bytes compare exactly."""

import asyncio
import contextlib
import copy
import os
import random
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import jax

from curvine_tpu.client import CurvineClient as JaxClient
from curvine_tpu.common import types as jtypes
from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu.master import placement as jplace
from curvine_tpu.master.filesystem import MasterFilesystem as JaxFs
from curvine_tpu.master.replication import ReplicationManager as JaxRm
from curvine_tpu.tpu import broadcast as jb
from curvine_tpu.tpu.mesh import make_mesh as jax_make_mesh
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common import types as ptypes
from curvine_tpu_torch.common.conf import ClusterConf, TierConf
from curvine_tpu_torch.gpu import broadcast as pb
from curvine_tpu_torch.gpu import ici_plane, multihost
from curvine_tpu_torch.gpu.mesh import make_mesh
from curvine_tpu_torch.master import placement as pplace
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.master.replication import ReplicationManager
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.rpc.client import Connection
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.deadline import Deadline
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker.server import WorkerServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = jax.devices("cpu")
KB = 1 << 10
MB = 1 << 20
BLOCK = 256 * KB
SPAWN_TIMEOUT_S = 180


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


# ------------------------------------------------------------- placement

def _workers(mod, specs):
    """WorkerInfo lists of a package's types: (id, host, coords, avail)."""
    return [mod.WorkerInfo(
        address=mod.WorkerAddress(worker_id=i, hostname=host,
                                  rpc_port=1000 + i),
        storages=[mod.StorageInfo(capacity=100, available=avail)],
        ici_coords=list(coords)) for i, host, coords, avail in specs]


def _ids(chosen) -> list[int]:
    return [w.address.worker_id for w in chosen]


def test_topology_distance_fallback_tiers():
    cases = [(([0, 0], "a", [1, 1], "b", [4, 2]), 2),
             (([], "hostA", [1, 1], "hostA"), 0),
             (([], "hostA", [1, 1], "hostB"), pplace.HOST_FAR),
             (([], "", [], ""), pplace.UNKNOWN_FAR)]
    for args, want in cases:
        assert pplace.topology_distance(*args) == want == \
            jplace.topology_distance(*args)
    assert (pplace.HOST_FAR, pplace.UNKNOWN_FAR) == \
        (jplace.HOST_FAR, jplace.UNKNOWN_FAR)
    assert pplace.topology_distance([0, 0], "", [3, 1], "", [4, 2]) < \
        pplace.HOST_FAR


def test_ici_policy_fault_domain_spread():
    shape = [2, 2, 2]
    specs = [(i, f"host{i}", c, 50) for i, c in enumerate(
        (x, y, z) for x in range(2) for y in range(2) for z in range(2))]
    got = pplace.IciPolicy(mesh_shape=shape).choose(
        _workers(ptypes, specs), 3, ici_coords=[0, 0, 0], needed=1)
    want = jplace.IciPolicy(mesh_shape=shape).choose(
        _workers(jtypes, specs), 3, ici_coords=[0, 0, 0], needed=1)
    assert _ids(got) == _ids(want)
    coords = [tuple(w.ici_coords) for w in got]
    assert coords[:2] == [(0, 0, 0), (1, 1, 1)]
    assert len(set(coords)) == 3
    assert len({w.address.hostname for w in got}) == 3
    # and through the factory, with a seeded sweep of writers and counts
    rng = random.Random(0)
    for _ in range(20):
        writer = [rng.randrange(2) for _ in range(3)]
        n = rng.randrange(1, 8)
        p = pplace.create_policy("ici", mesh_shape=shape)
        j = jplace.create_policy("ici", mesh_shape=shape)
        assert _ids(p.choose(_workers(ptypes, specs), n,
                             ici_coords=writer)) == \
            _ids(j.choose(_workers(jtypes, specs), n, ici_coords=writer))


def test_ici_policy_host_fallback_spread():
    specs = [(1, "hostA", [], 50), (2, "hostA", [], 50),
             (3, "hostB", [], 50), (4, "hostC", [], 50)]
    got = pplace.IciPolicy().choose(_workers(ptypes, specs), 3,
                                    client_host="hostA", needed=1)
    want = jplace.IciPolicy().choose(_workers(jtypes, specs), 3,
                                     client_host="hostA", needed=1)
    assert _ids(got) == _ids(want)
    assert got[0].address.hostname == "hostA"
    assert len({w.address.hostname for w in got}) == 3


# ------------------------------------------------------------- the cluster

def _conf(tmp_path, lost_ms: int = 30_000, policy: str = "local"
          ) -> ClusterConf:
    conf = ClusterConf()
    mc = conf.master
    mc.rpc_port = 0
    mc.journal_dir = str(tmp_path / "journal")
    mc.worker_lost_timeout_ms = lost_ms
    mc.heartbeat_check_ms = 100
    mc.block_placement_policy = policy
    conf.client.block_size = BLOCK
    return conf


def _worker_conf(conf: ClusterConf, root: str, coords, hbm: bool,
                 ici: bool) -> ClusterConf:
    wconf = copy.deepcopy(conf)
    wc = wconf.worker
    wc.hostname, wc.rpc_port, wc.heartbeat_ms = "127.0.0.1", 0, 200
    wc.promote_interval_ms = 0
    wc.tiers = [TierConf(storage_type="mem", dir=os.path.join(root, "mem"),
                         capacity=32 * BLOCK)]
    wc.hbm_capacity = 8 * BLOCK if hbm else 0
    wc.ici_coords = list(coords)
    wc.ici_transfer = ici
    return wconf


@contextlib.asynccontextmanager
async def _cluster(tmp_path, n: int, hbm: bool = False, ici: bool = True,
                   lost_ms: int = 30_000, scan_s: float = 0.3,
                   policy: str = "local"):
    """The port's master and ``n`` of its workers (worker i at ICI
    coordinates (i, 0), a tier-0 on ``cpu:i`` with ``hbm``): (master,
    workers, conf). A test stops a worker with ``stop()``; the rest stop
    here."""
    conf = _conf(tmp_path, lost_ms, policy)
    m = MasterServer(conf)
    m.replication.scan_interval_s = scan_s
    await m.start()
    conf.client.master_addrs = [m.addr]
    ws = []
    try:
        for i in range(n):
            w = WorkerServer(
                _worker_conf(conf, str(tmp_path / f"w{i}"), (i, 0), hbm,
                             ici),
                devices=[torch.device("cpu", i)] if hbm else None)
            await w.start()
            ws.append(w)

        async def live():
            while len(m.fs.workers.live_workers()) < n:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(live(), 10)
        yield m, ws, conf
    finally:
        for w in ws:
            if w.rpc._lsock is not None:
                await w.stop()
        await m.stop()


def _client(conf: ClusterConf) -> CurvineClient:
    return CurvineClient(copy.deepcopy(conf))


async def _call(w, code, body: dict) -> dict:
    conn = await Connection(w.addr).connect()
    try:
        rep = await conn.call(code, data=pack(body))
        return rep.header or unpack(rep.data)
    finally:
        await conn.close()


async def _locs(c, path: str) -> list[tuple[int, list[int]]]:
    fb = await c.meta.get_block_locations(path)
    return [(lb.block.id, [loc.worker_id for loc in lb.locs])
            for lb in fb.block_locs]


async def _until(pred, timeout: float = 20.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while True:
        got = await pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"never reached: {what}")
        await asyncio.sleep(0.05)


async def _wait_replicas(c, path: str, n: int):
    async def enough():
        locs = await _locs(c, path)
        return locs if all(len(ids) >= n for _, ids in locs) else None
    return await _until(enough, what=f"{n} replicas of {path}")


def _by_id(ws, wid):
    return next(w for w in ws if w.worker_id == wid)


# ------------------------------------------------------------- writes

async def test_replicated_write(tmp_path):
    async with _cluster(tmp_path, 2) as (m, ws, conf):
        c = _client(conf)
        data = _bytes(MB, 1)
        await c.write_all("/rep", data, replicas=2)
        locs = await _locs(c, "/rep")
        assert len(locs) == 4 and all(len(ids) == 2 for _, ids in locs)
        assert (await c.meta.file_status("/rep")).replicas == 2
        assert bytes(await c.read_all("/rep")) == data
        # two legs a block: no short circuit, both over WRITE_BLOCK
        assert c.counters.get("sc.bytes.written", 0) == 0
        assert c.counters["write.bytes"] == len(data)
        assert all(w.metrics.counters["bytes.written"] == len(data)
                   for w in ws)
        await c.close()


async def test_replicated_write_through_the_conf_and_ici_placement(tmp_path):
    """``client.replicas`` from the conf; the ``ici`` policy puts the
    first replica nearest the writer's ``ici_coords`` and the second the
    farthest from it."""
    async with _cluster(tmp_path, 3, policy="ici") as (m, ws, conf):
        cconf = copy.deepcopy(conf)
        cconf.client.replicas = 2
        cconf.worker.ici_coords = [0, 0]
        c = CurvineClient(cconf)
        data = _bytes(3 * BLOCK, 2)
        await c.write_all("/ici", data)
        want = [ws[0].worker_id, ws[2].worker_id]
        assert [ids for _, ids in await _locs(c, "/ici")] == [want] * 3
        assert bytes(await c.read_all("/ici")) == data
        await c.close()


def _cfg_client(conf: ClusterConf) -> CurvineClient:
    cconf = copy.deepcopy(conf)
    cconf.client.short_circuit = False
    cconf.client.rpc_timeout_ms = 3_000
    return CurvineClient(cconf)


@pytest.mark.parametrize("replicas", [2, 3])
async def test_mid_chunk_death_survivors_continue(replicas, tmp_path):
    async with _cluster(tmp_path, 3) as (m, ws, conf):
        c = _cfg_client(conf)
        data = _bytes(1024 * KB, 30 + replicas)
        w = await c.create("/mid.bin", replicas=replicas)
        await w.write(data[:300 * KB])           # 44 KB into block 2
        victim = w._upload_locs[0].worker_id
        await _by_id(ws, victim).stop()
        await w.write(data[300 * KB:])
        await w.close()
        assert bytes(await c.read_all("/mid.bin")) == data
        assert c.counters.get("write.replica_failover", 0) >= 1
        for bid, ids in (await _locs(c, "/mid.bin"))[1:]:
            assert victim not in ids, (bid, ids)
            assert len(ids) >= 1
        await c.close()


async def test_open_death_refused_leg_dropped(tmp_path):
    async with _cluster(tmp_path, 3) as (m, ws, conf):
        c = _cfg_client(conf)
        data = _bytes(512 * KB, 33)
        w = await c.create("/open.bin", replicas=3)
        await w.write(data[:BLOCK])              # block 1 sealed clean
        victim = ws[0]

        async def refuse(msg, conn):
            raise err.CurvineError("refused at open", code=err.ErrorCode.IO)

        victim.rpc.register(RpcCode.WRITE_BLOCK, refuse)
        try:
            await w.write(data[BLOCK:])          # block 2: a leg refused
            await w.close()
        finally:
            victim.rpc.register(RpcCode.WRITE_BLOCK, victim._write_block)
        assert bytes(await c.read_all("/open.bin")) == data
        assert c.counters.get("write.replica_failover", 0) >= 1
        bid, ids = (await _locs(c, "/open.bin"))[1]
        assert victim.worker_id not in ids and len(ids) == 2, (bid, ids)
        await c.close()


async def test_finish_death(tmp_path):
    """The victim dies after the block's bytes reached it, before the
    finish: a degraded commit on the survivor, counted, reported."""
    async with _cluster(tmp_path, 3) as (m, ws, conf):
        c = _cfg_client(conf)
        data = _bytes(128 * KB, 35)
        reported = []
        real = m.replication.enqueue_evacuation
        m.replication.enqueue_evacuation = lambda wid, bids: (
            reported.append((wid, list(bids))), real(wid, bids))
        w = await c.create("/fin.bin", replicas=2)
        await w.write(data)
        await w._flush_chunk()                   # every byte on both legs
        assert w._block is not None
        victim = w._upload_locs[0].worker_id
        await _by_id(ws, victim).stop()
        await w.close()
        assert bytes(await c.read_all("/fin.bin")) == data
        [(bid, ids)] = await _locs(c, "/fin.bin")
        assert victim not in ids and len(ids) == 1, (bid, ids)
        assert c.counters.get("write.degraded_commits", 0) == 1
        assert (victim, [bid]) in reported
        await c.close()


async def test_finish_death_below_min_replicas_raises(tmp_path):
    """With the replay buffer off, a block that falls below
    ``write_min_replicas`` raises and the open block is dropped: here one
    leg of two dies at the finish, with a floor of two."""
    async with _cluster(tmp_path, 3) as (m, ws, conf):
        cconf = copy.deepcopy(conf)
        cconf.client.short_circuit = False
        cconf.client.write_min_replicas = 2
        cconf.client.write_replay_buffer = False
        c = CurvineClient(cconf)
        w = await c.create("/low.bin", replicas=2)
        await w.write(_bytes(64 * KB, 36))
        await w._flush_chunk()
        victim = w._upload_locs[0].worker_id
        await _by_id(ws, victim).stop()
        with pytest.raises(err.CurvineError):
            await w.close()
        await w.abort()
        assert not (await c.meta.file_status("/low.bin")).is_complete
        await c.close()


async def test_finish_death_below_min_replicas_replayed(tmp_path):
    """One leg of two dies at the finish, with a floor of two: the seal
    abandons the block, re-places it on two live workers and replays it
    (the reference's recovery); ``close`` succeeds."""
    async with _cluster(tmp_path, 3) as (m, ws, conf):
        cconf = copy.deepcopy(conf)
        cconf.client.short_circuit = False
        cconf.client.write_min_replicas = 2
        c = CurvineClient(cconf)
        data = _bytes(64 * KB, 36)
        w = await c.create("/low.bin", replicas=2)
        await w.write(data)
        await w._flush_chunk()
        victim = w._upload_locs[0].worker_id
        await _by_id(ws, victim).stop()
        await w.close()
        assert bytes(await c.read_all("/low.bin")) == data
        [(bid, ids)] = await _locs(c, "/low.bin")
        live = {x.worker_id for x in ws if x.worker_id != victim}
        assert len(ids) == 2 and set(ids) == live, (bid, ids)
        assert c.counters["write.block_replay_bytes"] == len(data)
        await c.close()


# ------------------------------------------------------------- healing

async def test_rereplication_after_worker_loss(tmp_path):
    async with _cluster(tmp_path, 3, lost_ms=2_000) as (m, ws, conf):
        c = _client(conf)
        data = _bytes(BLOCK, 3)
        await c.write_all("/rep", data, replicas=2)
        holders = {wid for _, ids in await _locs(c, "/rep") for wid in ids}
        assert len(holders) == 2
        victim = next(w for w in ws if w.worker_id in holders)
        await victim.stop()

        async def lost():
            return m.fs.workers.lost_workers()
        await _until(lost, 10, "the holder lost")

        async def healed():
            locs = await _locs(c, "/rep")
            return all(len(ids) >= 2 and victim.worker_id not in ids
                       for _, ids in locs)
        await _until(healed, 20, "two live replicas again")
        assert bytes(await c.read_all("/rep")) == data
        assert m.metrics.counters["replication.replicates"] >= 1
        await c.close()


async def test_scrub_detects_corruption_and_heals(tmp_path):
    """A replica whose media copy was flipped is refused by its worker's
    pin verification (the port's promote cycle) and reported; the master
    evacuates it (copy first), re-replicates from the clean holder,
    retires the corrupt copy and its worker deletes it; the reader never
    sees corrupt bytes."""
    async with _cluster(tmp_path, 3, hbm=True) as (m, ws, conf):
        c = _client(conf)
        data = _bytes(BLOCK, 4)
        await c.write_all("/scrub_heal", data, replicas=2)
        [(bid, ids)] = await _locs(c, "/scrub_heal")
        victim = _by_id(ws, ids[0])
        path = victim.store.get(bid, touch=False).path
        with open(path, "r+b") as f:
            f.seek(4096)
            b = f.read(1)
            f.seek(4096)
            f.write(bytes([b[0] ^ 0x40]))
        assert await victim._autopin_block(bid) == 0
        assert victim.metrics.counters["blocks.corrupt"] == 1
        assert victim.metrics.counters["blocks.corrupt_reported"] == 1
        assert not victim.hbm_holds(bid)

        async def deleted():
            return not victim.store.contains(bid)
        await _until(deleted, 10, "the corrupt copy deleted")

        async def healed():
            [(_, now)] = await _locs(c, "/scrub_heal")
            return victim.worker_id not in now and len(now) >= 2
        await _until(healed, 20, "two clean replicas")
        assert bytes(await c.read_all("/scrub_heal")) == data
        assert m.metrics.counters["replication.evacuates"] == 1
        assert not m.replication._evac
        await c.close()


async def test_killed_mid_block_replica_healed(tmp_path):
    async with _cluster(tmp_path, 4, lost_ms=2_000) as (m, ws, conf):
        c = _cfg_client(conf)
        data = _bytes(1024 * KB, 39)
        w = await c.create("/heal.bin", replicas=3)
        await w.write(data[:300 * KB])
        victim = w._upload_locs[0].worker_id
        await _by_id(ws, victim).stop()
        await w.write(data[300 * KB:])
        await w.close()
        assert bytes(await c.read_all("/heal.bin")) == data
        live = {wk.worker_id for wk in ws if wk.worker_id != victim}

        async def healed():
            locs = await _locs(c, "/heal.bin")
            return all(len(set(ids) & live) >= 3 for _, ids in locs)
        await _until(healed, 30, "three live copies of every block")
        assert bytes(await c.read_all("/heal.bin")) == data
        await c.close()


# ------------------------------------------------- the device path

async def _write_and_pin(m, ws, conf, path: str, data: bytes):
    """A single-replica block pinned into its holder's tier-0, the
    master told by a heartbeat: (block id, source, destination)."""
    c = _client(conf)
    await c.write_all(path, data)
    [(bid, [src_wid])] = await _locs(c, path)
    await c.close()
    src = _by_id(ws, src_wid)
    dst = next(w for w in ws if w.worker_id != src_wid)
    rep = await _call(src, RpcCode.HBM_PIN, {"block_id": bid})
    assert rep["len"] == len(data)
    await src.heartbeat_once()
    assert bid in m.replication._hbm_blocks.get(src_wid, set())
    return bid, src, dst


async def test_replication_peer_hbm_pull_zero_tcp(tmp_path):
    async with _cluster(tmp_path, 2, hbm=True) as (m, ws, conf):
        data = _bytes(BLOCK, 5)
        bid, src, dst = await _write_and_pin(m, ws, conf, "/ici/hot", data)
        src_reads = src.metrics.counters.get("bytes.read", 0)
        m.fs.blocks.desired[bid] = 2
        m.replication.enqueue([bid])
        c = _client(conf)
        await _wait_replicas(c, "/ici/hot", 2)
        assert dst.metrics.counters.get("ici.peer_pulls", 0) == 1
        assert dst.metrics.counters.get("ici.tcp_fallbacks", 0) == 0
        assert src.metrics.counters.get("bytes.read", 0) == src_reads
        mcount = m.metrics.counters
        assert mcount.get("replication.ici_hinted", 0) >= 1
        assert mcount.get("replication.ici_transfers", 0) >= 1
        assert dst.store.contains(bid)
        assert dst.store.get(bid, touch=False).crc32c == \
            src.store.get(bid, touch=False).crc32c
        assert bytes(await c.read_all("/ici/hot")) == data
        await c.close()


async def test_replication_falls_back_to_tcp_on_dead_peer(tmp_path):
    async with _cluster(tmp_path, 2, hbm=True) as (m, ws, conf):
        data = _bytes(128 * KB, 6)
        bid, src, dst = await _write_and_pin(m, ws, conf, "/ici/fb", data)
        # the peer leaves the device domain after it advertised: the
        # hint is stale, the race the fallback covers
        ici_plane.unregister_endpoint(src.worker_id)
        c = _client(conf)
        try:
            m.fs.blocks.desired[bid] = 2
            m.replication.enqueue([bid])
            await _wait_replicas(c, "/ici/fb", 2)
        finally:
            ici_plane.register_endpoint(
                src.worker_id, types.SimpleNamespace(get=src.hbm_get),
                src.conf.worker.ici_coords)
        assert dst.metrics.counters.get("ici.peer_pulls", 0) == 0
        assert dst.metrics.counters.get("ici.tcp_fallbacks", 0) == 1
        assert src.metrics.counters["bytes.read"] == len(data)
        assert m.metrics.counters.get("replication.ici_transfers", 0) == 0
        assert bytes(await c.read_all("/ici/fb")) == data
        await c.close()


async def test_replication_with_ici_disabled(tmp_path):
    async with _cluster(tmp_path, 2, hbm=True, ici=False) as (m, ws, conf):
        c = _client(conf)
        data = _bytes(128 * KB, 7)
        await c.write_all("/ici/off", data)
        [(bid, [src_wid])] = await _locs(c, "/ici/off")
        dst = next(w for w in ws if w.worker_id != src_wid)
        assert not m.replication._hbm_blocks.get(src_wid)
        assert ici_plane.lookup_endpoint(src_wid) is None
        m.fs.blocks.desired[bid] = 2
        m.replication.enqueue([bid])
        await _wait_replicas(c, "/ici/off", 2)
        assert dst.metrics.counters.get("ici.peer_pulls", 0) == 0
        assert dst.metrics.counters.get("ici.tcp_fallbacks", 0) == 0
        assert bytes(await c.read_all("/ici/off")) == data
        await c.close()


async def test_replication_prefers_ici_near_source(tmp_path):
    async with _cluster(tmp_path, 3, hbm=True, scan_s=60) as (m, ws, conf):
        rm = m.replication
        c = _client(conf)
        await c.write_all("/ici/near", _bytes(64 * KB, 8), replicas=2)
        [(bid, holders)] = await _locs(c, "/ici/near")
        await c.close()
        (dst_wid,) = {w.worker_id for w in ws} - set(holders)
        submitted = {}

        class _Conn:
            async def call(self, code, data=b"", deadline=None):
                assert code == RpcCode.SUBMIT_BLOCK_REPLICATION_JOB
                assert 0 < deadline.remaining_ms() <= rm.pull_budget_ms
                submitted.update(unpack(data))

        class _Pool:
            async def get(self, addr):
                return _Conn()

            async def close(self):
                pass

        rm.pool = _Pool()
        m.fs.blocks.desired[bid] = 3
        assert await rm._replicate(bid)
        assert submitted["block_id"] == bid
        by_id = m.fs.workers.workers
        hops = {wid: pplace.ici_hops(list(by_id[wid].ici_coords),
                                     list(by_id[dst_wid].ici_coords))
                for wid in holders}
        nearest = {wid for wid, h in hops.items() if h == min(hops.values())}
        assert submitted["source"]["worker_id"] in nearest
        assert "ici" not in submitted       # no holder pinned the block


# ------------------------------------------- the manager against the JAX one

class _Capture:
    def __init__(self):
        self.jobs = []

    async def get(self, addr):
        outer = self

        class Conn:
            async def call(self, code, data=b"", deadline=None, **kw):
                outer.jobs.append((addr, int(code), unpack(data)
                                   if not isinstance(data, dict) else data))
        return Conn()

    async def close(self):
        pass


def _worker_wire(wid: int, coords, avail: int) -> dict:
    return {"address": {"worker_id": wid, "hostname": f"h{wid % 3}",
                        "ip_addr": "10.0.0.1", "rpc_port": 100 + wid,
                        "web_port": 0},
            "state": 0, "storages": [{
                "storage_type": 1, "dir_id": "d", "capacity": 1 << 30,
                "available": avail, "block_num": 0, "health": "healthy"}],
            "last_heartbeat_ms": 0, "ici_coords": list(coords)}


def _scenario(seed: int) -> dict:
    rng = random.Random(seed)
    n = rng.randrange(3, 7)
    workers = [(w, [rng.randrange(4), rng.randrange(2)],
                rng.randrange(1, 64) << 20) for w in range(1, n + 1)]
    ids = [w for w, _, _ in workers]
    holders = rng.sample(ids, rng.randrange(1, min(4, n)))
    return {"workers": workers, "holders": holders,
            "desired": rng.randrange(1, 5),
            "lost": [w for w in ids if rng.random() < 0.25],
            "draining": [w for w in holders if rng.random() < 0.15],
            "evac": rng.choice(holders + [None, None]),
            "hbm": {w: [7] for w in ids if rng.random() < 0.5},
            "policy": rng.choice(["ici", "load"])}


async def _run_replicate(fs_cls, rm_cls, types_mod, sc: dict):
    fs = fs_cls(journal=None, placement=sc["policy"],
                ici_mesh_shape=[4, 2])
    for wid, coords, avail in sc["workers"]:
        fs.worker_heartbeat(_worker_wire(wid, coords, avail))
    for wid in sc["lost"]:
        fs.workers.workers[wid].state = types_mod.WorkerState.LOST
    for wid in sc["draining"]:
        if fs.workers.workers[wid].state == types_mod.WorkerState.LIVE:
            fs.workers.workers[wid].state = \
                types_mod.WorkerState.DECOMMISSIONING
    fs.store.block_put(7, BLOCK, 1, sc["desired"])
    for wid in sc["holders"]:
        fs.blocks.add_replica(7, wid, types_mod.StorageType.MEM)
    rm = rm_cls(fs)
    rm.pool = _Capture()
    for wid, bids in sc["hbm"].items():
        rm.note_hbm_blocks(wid, bids)
    if sc["evac"] is not None:
        rm._evac[7] = sc["evac"]
    ok = await rm._replicate(7)
    return (ok, rm.pool.jobs, dict(rm._evac),
            {k: sorted(v) for k, v in fs.pending_deletes.items()},
            sorted(fs.blocks.locs.get(7, {})))


@pytest.mark.parametrize("seed", range(24))
async def test_replicate_dispatch_matches_the_reference(seed):
    sc = _scenario(seed)
    got = await _run_replicate(MasterFilesystem, ReplicationManager,
                               ptypes, sc)
    want = await _run_replicate(JaxFs, JaxRm, jtypes, sc)
    assert got == want


async def test_on_result_and_evacuation_match_the_reference():
    """A landed pull retires the flagged copy on the next dispatch; a
    failed one re-enqueues; both packages count the same."""
    sc = {"workers": [(1, [0, 0], 8 << 20), (2, [1, 0], 8 << 20),
                      (3, [2, 0], 8 << 20)],
          "holders": [1, 2], "desired": 2, "lost": [], "draining": [],
          "evac": 2, "hbm": {1: [7]}, "policy": "ici"}
    out = []
    for fs_cls, rm_cls, tm in ((MasterFilesystem, ReplicationManager,
                                ptypes), (JaxFs, JaxRm, jtypes)):
        fs = fs_cls(journal=None, placement="ici")
        for wid, coords, avail in sc["workers"]:
            fs.worker_heartbeat(_worker_wire(wid, coords, avail))
        fs.store.block_put(7, BLOCK, 1, 2)
        for wid in (1, 2):
            fs.blocks.add_replica(7, wid, tm.StorageType.MEM)

        class M:
            counters: dict = {}

            def inc(self, k, v=1):
                self.counters[k] = self.counters.get(k, 0) + v
        metrics = M()
        metrics.counters = {}
        rm = rm_cls(fs, metrics=metrics)
        rm.pool = _Capture()
        rm.note_hbm_blocks(1, [7])
        rm.enqueue_evacuation(2, [7])
        first = await rm._replicate(7)
        fs.blocks.add_replica(7, 3, tm.StorageType.MEM)   # the landing
        rm.on_result(7, 3, True, "", via="ici")
        second = await rm._replicate(7)
        rm.on_result(7, 3, False, "boom")
        out.append((first, second, rm.pool.jobs, dict(rm._evac),
                    {k: sorted(v) for k, v in fs.pending_deletes.items()},
                    sorted(fs.blocks.locs[7]), metrics.counters,
                    sorted(rm._queued)))
    assert out[0] == out[1]
    assert out[0][2][0][2]["ici"] == {"worker_id": 1, "coords": [0, 0]}
    assert out[0][4] == {2: [7]}


# ------------------------------------------------- deadlines and refusals

async def test_deadline_rides_the_header_and_caps_the_wait(tmp_path):
    """The budget stamped by the caller reaches the handler as
    ``msg.deadline``; a wait outliving it fails inside it; a spent budget
    fails before anything is sent."""
    from curvine_tpu_torch.rpc.server import RpcServer
    seen = []

    async def slow(msg, conn):
        seen.append(msg.deadline.remaining_ms())
        await asyncio.sleep(5)
        return {}

    srv = RpcServer("127.0.0.1", 0, "t")
    srv.register(RpcCode.GET_BLOCK_INFO, slow)
    await srv.start()
    conn = await Connection(srv.addr).connect()
    try:
        t = time.monotonic()
        with pytest.raises(err.RpcTimeout):
            await conn.call(RpcCode.GET_BLOCK_INFO,
                            deadline=Deadline.after_ms(300))
        assert time.monotonic() - t < 2.0
        assert 0 < seen[0] <= 300
        with pytest.raises(err.RpcTimeout, match="exhausted"):
            await conn.call(RpcCode.GET_BLOCK_INFO,
                            deadline=Deadline.after_ms(0))
        assert len(seen) == 1
    finally:
        await conn.close()
        await srv.stop()


async def test_pull_from_a_dead_source_fails_the_job(tmp_path):
    """A job naming a source that no longer serves fails, leaves no temp
    block and reports the failure to the master."""
    async with _cluster(tmp_path, 2, scan_s=60) as (m, ws, conf):
        c = _client(conf)
        await c.write_all("/dead", _bytes(64 * KB, 9))
        [(bid, [src_wid])] = await _locs(c, "/dead")
        await c.close()
        src, dst = _by_id(ws, src_wid), next(
            w for w in ws if w.worker_id != src_wid)
        addr = src.address.to_wire()
        await src.stop()
        results = []
        real = m.replication.on_result
        m.replication.on_result = lambda *a, **k: (results.append(a[:3]),
                                                   real(*a, **k))
        rep = await _call(dst, RpcCode.SUBMIT_BLOCK_REPLICATION_JOB,
                          {"block_id": bid, "block_len": 64 * KB,
                           "source": addr})
        assert rep["success"] is False and rep["via"] == ""
        assert not dst.store.contains(bid)
        assert results == [(bid, dst.worker_id, False)]


# ------------------------------------------------- checkpoints on a mesh

def _params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((64, 32)).astype(np.float32),
            "mlp": {"w": rng.standard_normal((32, 128)).astype(np.float32),
                    "b": np.zeros((128,), dtype=np.float32)},
            "big": rng.standard_normal((3 * BLOCK // 4 + 5,)).astype(
                np.float32),
            "step": np.array(17, dtype=np.int32)}


def _leaf_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.to_local() if hasattr(x, "to_local") else x
        return t.detach().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


async def test_distribute_tree_matches_flat_and_jax(tmp_path):
    """On a (1,) gloo mesh of this process: the tree path takes every
    block of the checkpoint (manifest included) from the worker's
    tier-0, reads nothing from the cache's read path, and its leaves
    equal the flat path's, the saved ones' and those of the JAX
    package's ``distribute_checkpoint`` (tree and flat) on its 8-device
    CPU mesh, which reads the same files."""
    params = _params(11)
    async with _cluster(tmp_path, 1, hbm=True) as (m, ws, conf):
        w = ws[0]
        c = _client(conf)
        await pb.save_checkpoint(c, "/ckpt/tree", params)
        names = [s.name for s in await c.meta.list_status("/ckpt/tree")]
        bids = []
        for name in names:
            bids += [b for b, _ in await _locs(c, f"/ckpt/tree/{name}")]
        for bid in bids:
            await _call(w, RpcCode.HBM_PIN, {"block_id": bid})
        assert len(bids) > len(names)        # "big" spans blocks
        multihost.initialize(cpu=True)
        try:
            mesh = make_mesh(axis_names=("x",))
            c.counters.clear()
            tree = await pb.distribute_checkpoint(c, "/ckpt/tree", mesh)
            tree_counters = dict(c.counters)
            flat = await pb.distribute_checkpoint(c, "/ckpt/tree", mesh,
                                                  schedule="flat")
            reps = {str(x.placements) for x in _flat(tree) + _flat(flat)}
        finally:
            multihost.shutdown()
        assert tree_counters["ici.peer_pulls"] == len(bids)
        assert tree_counters.get("ici.tcp_fallbacks", 0) == 0
        assert tree_counters.get("sc.bytes.read", 0) == 0
        assert tree_counters.get("read.zero_copy_bytes", 0) == 0
        assert tree_counters["ici.broadcast_bytes"] == sum(
            np.asarray(x).nbytes for x in _flat(params))
        assert reps == {"(Replicate(),)"}
        jconf = JaxConf()
        jconf.client.master_addrs = list(conf.client.master_addrs)
        jconf.client.block_size = BLOCK
        jc = JaxClient(jconf)
        jmesh = jax_make_mesh(devices=CPUS[:8], axis_names=("x",))
        jtree = await jb.distribute_checkpoint(jc, "/ckpt/tree", jmesh)
        jflat = await jb.distribute_checkpoint(jc, "/ckpt/tree", jmesh,
                                               schedule="flat")
        await jc.close()
        await c.close()
    saved = [np.asarray(x).tobytes() for x in _flat(params)]
    for got in (tree, flat, jtree, jflat):
        assert [_leaf_bytes(x) for x in _flat(got)] == saved
    assert [tuple(x.shape) for x in _flat(tree)] == \
        [tuple(x.shape) for x in _flat(jtree)]
    assert all(len(x.sharding.device_set) == 8 for x in _flat(jtree))


async def test_hbm_source_all_or_nothing(tmp_path):
    """A file with one block outside every tier-0 goes whole by the read
    path: one fallback counted, no peer pull."""
    async with _cluster(tmp_path, 1, hbm=True) as (m, ws, conf):
        c = _client(conf)
        data = _bytes(2 * BLOCK + 3, 12)
        await c.write_all("/two", data)
        bids = [b for b, _ in await _locs(c, "/two")]
        await _call(ws[0], RpcCode.HBM_PIN, {"block_id": bids[0]})
        counters = {}
        assert await pb._hbm_source(c, "/two", counters) is None
        assert counters == {"ici.tcp_fallbacks": 1}
        for bid in bids[1:]:
            await _call(ws[0], RpcCode.HBM_PIN, {"block_id": bid})
        got = await pb._hbm_source(c, "/two", counters)
        assert got.numpy().tobytes() == data
        assert got.data_ptr() != ws[0].hbm_get(bids[0]).data_ptr()
        assert counters == {"ici.tcp_fallbacks": 1, "ici.peer_pulls": 3,
                            "ici.peer_pull_bytes": len(data)}
        await c.close()


# Two gloo ranks; argv is (rank, world, store, work dir). Rank 0 saves the
# real checkpoint, rank 1 one of zeros of the same structure, each into a
# directory of its own through ``PosixClient``.
_RANK = r"""
import asyncio, sys
import numpy as np
import torch
torch.set_num_threads(1)
from curvine_tpu_torch.client.posix import PosixClient
from curvine_tpu_torch.gpu import broadcast as pb, multihost
from curvine_tpu_torch.gpu.mesh import make_mesh

rank, world, store, work = (int(sys.argv[1]), int(sys.argv[2]),
                            sys.argv[3], sys.argv[4])
multihost.initialize(f"file://{store}", world, rank, cpu=True)
inp = dict(np.load(f"{work}/params.npz"))
if rank:
    inp = {k: np.zeros_like(v) for k, v in inp.items()}
params = {"emb": inp["emb"], "mlp": {"w": inp["w"], "b": inp["b"]},
          "big": inp["big"], "step": inp["step"]}

async def run():
    c = PosixClient(f"{work}/cache{rank}")
    await pb.save_checkpoint(c, "/ckpt/tree", params)
    mesh = make_mesh(axis_names=("x",))
    tree = await pb.distribute_checkpoint(c, "/ckpt/tree", mesh)
    flat = await pb.distribute_checkpoint(c, "/ckpt/tree", mesh,
                                          schedule="flat")
    return tree, flat, dict(c.counters) if hasattr(c, "counters") else {}

tree, flat, counters = asyncio.run(run())
out = {}
for tag, t in (("tree", tree), ("flat", flat)):
    leaves = [t["big"], t["emb"], t["mlp"]["b"], t["mlp"]["w"], t["step"]]
    for i, x in enumerate(leaves):
        out[f"{tag}{i}"] = x.to_local().numpy()
        out[f"{tag}{i}_rep"] = np.array(repr(x.placements))
np.savez(f"{work}/rank{rank}.npz", **out)
multihost.shutdown()
print("rank", rank, "ok", flush=True)
"""


def test_distribute_tree_matches_flat_on_gloo_ranks(tmp_path):
    p = _params(13)
    np.savez(tmp_path / "params.npz", emb=p["emb"], w=p["mlp"]["w"],
             b=p["mlp"]["b"], big=p["big"], step=p["step"])
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    world = 2
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True) for r in range(world)]
    try:
        outs = [pr.communicate(timeout=SPAWN_TIMEOUT_S)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0 and f"rank {r} ok" in out, \
            f"rank {r} failed:\n{out[-3000:]}"
    want = [p["big"], p["emb"], p["mlp"]["b"], p["mlp"]["w"], p["step"]]
    for r in range(world):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        for tag in ("tree", "flat"):
            for i, x in enumerate(want):
                assert got[f"{tag}{i}"].tobytes() == x.tobytes()
                assert got[f"{tag}{i}"].shape == x.shape
                assert str(got[f"{tag}{i}_rep"]) == "(Replicate(),)"
