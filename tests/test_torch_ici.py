"""Port parity: the peer-device plane of ``curvine_tpu_torch``
(``gpu/ici_plane.py``, ``master/placement.py::ici_hops`` and the worker's
ICI_TRANSFER landing) against the JAX package, on the CPU, in one
process.

Mirrors, from tests/test_ici_plane.py, ``test_ici_hops_matrix_2x2x2``
and ``test_ici_hops_matrix_4x2`` (:33-60), ``test_broadcast_schedule_
properties`` (:129) and ``test_broadcast_schedule_hop_sorted`` (:145),
each schedule equal to the reference's edge for edge,
``test_endpoint_registry_fetch_and_miss`` (:232) and
``test_hbm_ghost_readmit_cross_chip`` (:254). The reference's
``CPUS[1] in arr2.devices()`` has no counterpart: a CPU tensor's device
carries no index, so the mirror asserts what the port can show, the bytes
and that a fetch asking for another device id returns a copy, not the
tier's tensor.

The worker's side runs on a cluster of the port: its master and two of
its workers, each with a device tier-0 on a CPU device and its own ICI
coordinates. A block written to worker A and pinned there lands on
worker B by ICI_TRANSFER bit for bit, with zero bytes read from A's
block rail, and the master locates it on both; an unknown peer, a stale
``block_len`` and a block A no longer pins each answer ``success:
False`` and count a TCP fallback; ``ici_transfer = false`` answers as
the reference's worker does (worker/server.py:1460-1462); the heartbeat
carries ``hbm_blocks`` and GET_BLOCK_INFO the ``hbm`` offer, with the
reference's keys. Byte comparisons are exact."""

import asyncio
import contextlib
import copy
import math
import os

import numpy as np
import pytest
import torch

import jax

from curvine_tpu.master.placement import ici_hops as jax_ici_hops
from curvine_tpu.tpu import ici_plane as jax_plane
from curvine_tpu.tpu.hbm import HbmExportTable as JaxExportTable
from curvine_tpu.tpu.hbm import HbmTier as JaxHbmTier
from curvine_tpu.tpu.hbm import MultiHbmTier as JaxMultiHbmTier
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common.conf import ClusterConf, TierConf
from curvine_tpu_torch.gpu import ici_plane
from curvine_tpu_torch.gpu.hbm import HbmTier, MultiHbmTier
from curvine_tpu_torch.master.placement import ici_hops
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.rpc.client import Connection
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker.blockfile import crc_update
from curvine_tpu_torch.worker.server import WorkerServer

CPUS = jax.devices("cpu")
MB = 1 << 20
BLOCK = 4 * MB


def _payload(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


# ------------------------------------------------------------------ ici_hops

def test_ici_hops_matrix_2x2x2():
    shape = [2, 2, 2]
    coords = [(x, y, z) for x in range(2) for y in range(2)
              for z in range(2)]
    for a in coords:
        for b in coords:
            want = sum(int(i != j) for i, j in zip(a, b))
            assert ici_hops(list(a), list(b), shape) == want == \
                jax_ici_hops(list(a), list(b), shape)
    assert ici_hops([0, 1, 0], [1, 0, 1], shape) == \
        ici_hops([1, 0, 1], [0, 1, 0], shape) == 3


def test_ici_hops_matrix_4x2():
    shape = [4, 2]
    cases = [([0, 0], [3, 0], shape, 1), ([0, 0], [2, 0], shape, 2),
             ([1, 0], [3, 1], shape, 3), ([0, 0], [3, 0], None, 3),
             ([0, 0], [0, 0, 0], shape, 1 << 16), ([], [1, 1], shape, 1 << 16)]
    for a, b, s, want in cases:
        assert ici_hops(a, b, s) == want == jax_ici_hops(a, b, s)
    coords = [[x, y] for x in range(4) for y in range(2)]
    for a in coords:
        for b in coords:
            assert ici_hops(a, b, shape) == jax_ici_hops(a, b, shape)


# ------------------------------------------------------------------ schedule

def _as_lists(s) -> tuple:
    return (s.root, list(s.order),
            [[tuple(e) for e in r] for r in s.rounds], s.chunk_bytes)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_broadcast_schedule_properties(n):
    s = ici_plane.broadcast_schedule(n)
    assert _as_lists(s) == _as_lists(jax_plane.broadcast_schedule(n))
    assert s.receivers() == set(range(n))
    dsts = [d for r in s.rounds for _, d in r]
    assert len(dsts) == len(set(dsts)) == n - 1
    have = {s.root}
    for r in s.rounds:
        for src, dst in r:
            assert src in have and dst not in have
        have |= {d for _, d in r}
    assert s.depth() == (math.ceil(math.log2(n)) if n > 1 else 0)


def test_broadcast_schedule_hop_sorted():
    shape = (2, 2, 2)
    coords = [(x, y, z) for x in range(2) for y in range(2)
              for z in range(2)]
    s = ici_plane.broadcast_schedule(8, coords=coords, mesh_shape=shape)
    assert _as_lists(s) == _as_lists(jax_plane.broadcast_schedule(
        8, coords=coords, mesh_shape=shape))
    hops = [ici_hops(list(coords[0]), list(coords[i]), list(shape))
            for i in s.order]
    assert hops == sorted(hops)
    (src, dst), = s.rounds[0]
    assert src == 0
    assert ici_hops(list(coords[0]), list(coords[dst]), list(shape)) == 1
    assert s.receivers() == set(range(8))
    # another root walks outward from itself, as the reference's does
    assert _as_lists(ici_plane.broadcast_schedule(
        8, coords=coords, mesh_shape=shape, root=5)) == \
        _as_lists(jax_plane.broadcast_schedule(8, coords=coords,
                                               mesh_shape=shape, root=5))


# ------------------------------------------------------------ the registry

def test_endpoint_registry_fetch_and_miss():
    payload = _payload(1024, 0)
    tier = HbmTier(4 * MB, device=torch.device("cpu", 0))
    tier.put(77, payload)
    jtier = JaxHbmTier(4 * MB, device=CPUS[0])
    jtier.put(77, payload)
    ici_plane.register_endpoint(901, tier, coords=(1, 0))
    jax_plane.register_endpoint(901, jtier, coords=(1, 0))
    try:
        assert ici_plane.lookup_endpoint(901).coords == \
            jax_plane.lookup_endpoint(901).coords == (1, 0)
        arr = ici_plane.fetch_device_block(901, 77)
        jarr = jax_plane.fetch_device_block(901, 77)
        assert arr is tier.get(77)             # the tier's own tensor
        assert arr.numpy().tobytes() == bytes(np.asarray(jarr)) == payload
        # another device of the domain: a copy, never the tier's tensor
        arr2 = ici_plane.fetch_device_block(901, 77,
                                            device=torch.device("cpu", 1))
        jarr2 = jax_plane.fetch_device_block(901, 77, device=CPUS[1])
        assert arr2.data_ptr() != arr.data_ptr()
        assert arr2.numpy().tobytes() == bytes(np.asarray(jarr2)) == payload
        # misses are None, never an error: unknown block, unknown peer
        for fetch in (ici_plane.fetch_device_block,
                      jax_plane.fetch_device_block):
            assert fetch(901, 999) is None
            assert fetch(555, 77) is None
        # a re-register replaces the entry; a dying tier is a miss
        boom = type("Boom", (), {"get": lambda self, b: 1 / 0})()
        ici_plane.register_endpoint(901, boom)
        assert ici_plane.fetch_device_block(901, 77) is None
        assert [e.worker_id for e in ici_plane.endpoints()].count(901) == 1
    finally:
        ici_plane.unregister_endpoint(901)
        jax_plane.unregister_endpoint(901)
    assert ici_plane.fetch_device_block(901, 77) is None
    assert jax_plane.fetch_device_block(901, 77) is None


def test_hbm_ghost_readmit_cross_chip():
    """An eviction ghosts into the tier's shared S3-FIFO ghost queue, so
    a re-admission on another device goes straight to main; a delete the
    master commands does not ghost; the shared export table follows the
    tier. Each step's policy state equals the reference's."""
    def run(tier, devices, data):
        seen = []
        tier.put(1, data, device=devices[0])
        seen.append(1 in tier.policy._small)
        tier.drop(1, evicted=True)
        seen.append(tier.policy.stats()["ghost"])
        tier.put(1, data, device=devices[1])
        seen += [tier.policy.ghost_hits, 1 in tier.policy._main]
        tier.drop(1)
        seen += [tier.policy.stats()["ghost"], 1 in tier.exports]
        return seen

    data = _payload(1024, 1)
    got = run(MultiHbmTier(8 * MB, devices=[torch.device("cpu", i)
                                            for i in range(2)],
                           admission="s3fifo"),
              [torch.device("cpu", 0), torch.device("cpu", 1)], data)
    want = run(JaxMultiHbmTier(8 * MB, devices=CPUS[:2], admission="s3fifo"),
               CPUS[:2], data)
    assert got == want == [True, 1, 1, True, 0, False]


# ------------------------------------------------------------ the worker

def _conf(tmp_path) -> ClusterConf:
    conf = ClusterConf()
    mc = conf.master
    mc.rpc_port = 0
    mc.journal_dir = str(tmp_path / "journal")
    mc.worker_lost_timeout_ms = 30_000
    mc.heartbeat_check_ms = 200
    conf.client.block_size = BLOCK
    return conf


def _worker_conf(conf: ClusterConf, root: str, coords, ici: bool
                 ) -> ClusterConf:
    wconf = copy.deepcopy(conf)
    wc = wconf.worker
    wc.hostname, wc.rpc_port, wc.heartbeat_ms = "127.0.0.1", 0, 200
    wc.promote_interval_ms = 0
    wc.tiers = [TierConf(storage_type="mem", dir=os.path.join(root, "mem"),
                         capacity=8 * BLOCK)]
    wc.hbm_capacity = 4 * BLOCK
    wc.ici_coords = list(coords)
    wc.ici_transfer = ici
    return wconf


@contextlib.asynccontextmanager
async def _cluster(tmp_path, ici: bool = True):
    """The port's master and two of its workers, each with a tier-0 on a
    CPU device: (master, workers, conf)."""
    conf = _conf(tmp_path)
    m = MasterServer(conf)
    await m.start()
    conf.client.master_addrs = [m.addr]
    ws = []
    try:
        for i in range(2):
            w = WorkerServer(_worker_conf(conf, str(tmp_path / f"w{i}"),
                                          (i, 0), ici),
                             devices=[torch.device("cpu", i)])
            await w.start()
            ws.append(w)

        async def live():
            while len(m.fs.workers.live_workers()) < 2:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(live(), 10)
        yield m, ws, conf
    finally:
        for w in ws:
            await w.stop()
        await m.stop()


async def _write_and_pin(conf, ws, path: str, data: bytes):
    """Write a one-block file and pin it into its holder's tier-0 by
    HBM_PIN: (block id, holder, the other worker)."""
    async with CurvineClient(conf) as c:
        await c.write_all(path, data)
        fb = await c.meta.get_block_locations(path)
    lb = fb.block_locs[0]
    bid, wid = lb.block.id, lb.locs[0].worker_id
    a = next(w for w in ws if w.worker_id == wid)
    b = next(w for w in ws if w.worker_id != wid)
    rep = await _call(a, RpcCode.HBM_PIN, {"block_id": bid})
    assert rep["len"] == len(data)
    return bid, a, b


async def _call(w, code, body: dict) -> dict:
    conn = await Connection(w.addr).connect()
    try:
        rep = await conn.call(code, data=pack(body))
        return rep.header or unpack(rep.data)
    finally:
        await conn.close()


async def _locations(conf, path: str) -> list[int]:
    async with CurvineClient(conf) as c:
        fb = await c.meta.get_block_locations(path)
    return sorted(loc.worker_id for loc in fb.block_locs[0].locs)


async def test_ici_transfer_lands_bit_exact(tmp_path):
    data = _payload(3 * MB + 17, 2)
    async with _cluster(tmp_path) as (m, ws, conf):
        bid, a, b = await _write_and_pin(conf, ws, "/ici/blk", data)
        assert {e.worker_id for e in ici_plane.endpoints()} >= \
            {a.worker_id, b.worker_id}
        assert ici_plane.lookup_endpoint(a.worker_id).coords == \
            tuple(a.conf.worker.ici_coords)
        rep = await _call(b, RpcCode.ICI_TRANSFER, {
            "block_id": bid, "source_worker_id": a.worker_id,
            "block_len": len(data)})
        assert rep == {"success": True, "via": "ici"}
        info = b.store.get(bid, touch=False)
        with open(info.path, "rb") as f:
            assert f.read() == data
        assert (info.len, info.crc_algo, info.crc32c) == \
            (len(data), "crc32c", crc_update("crc32c", data))
        assert b.metrics.counters["ici.peer_pulls"] == 1
        assert b.metrics.counters.get("ici.tcp_fallbacks", 0) == 0
        assert a.metrics.counters.get("bytes.read", 0) == 0   # no TCP rail
        assert await _locations(conf, "/ici/blk") == \
            sorted([a.worker_id, b.worker_id])
        # a second transfer finds the block local
        assert await _call(b, RpcCode.ICI_TRANSFER, {
            "block_id": bid, "source_worker_id": a.worker_id}) == \
            {"success": True, "via": "local"}
        # the bytes read back through the client from either worker
        async with CurvineClient(conf) as c:
            assert bytes(await c.read_all("/ici/blk")) == data
        metrics = b._cache_metrics()
        assert metrics["ici.peer_pulls"] == 1
    assert ici_plane.lookup_endpoint(a.worker_id) is None
    assert ici_plane.lookup_endpoint(b.worker_id) is None


async def test_ici_transfer_misses_fall_back(tmp_path):
    data = _payload(MB, 3)
    async with _cluster(tmp_path) as (m, ws, conf):
        bid, a, b = await _write_and_pin(conf, ws, "/ici/miss", data)
        asks = [{"block_id": bid, "source_worker_id": 12345},     # no peer
                {"block_id": bid, "source_worker_id": a.worker_id,
                 "block_len": len(data) + 1}]                     # stale
        for q in asks:
            assert await _call(b, RpcCode.ICI_TRANSFER, q) == \
                {"success": False, "via": ""}
        await _call(a, RpcCode.HBM_UNPIN, {"block_id": bid})
        assert await _call(b, RpcCode.ICI_TRANSFER, {
            "block_id": bid, "source_worker_id": a.worker_id,
            "block_len": len(data)}) == {"success": False, "via": ""}
        assert b.metrics.counters["ici.tcp_fallbacks"] == 3
        assert b.metrics.counters.get("ici.peer_pulls", 0) == 0
        assert not b.store.contains(bid)       # no temp block left
        assert await _locations(conf, "/ici/miss") == [a.worker_id]


async def test_ici_transfer_off_answers_as_the_reference(tmp_path):
    data = _payload(MB, 4)
    async with _cluster(tmp_path, ici=False) as (m, ws, conf):
        bid, a, b = await _write_and_pin(conf, ws, "/ici/off", data)
        assert ici_plane.lookup_endpoint(a.worker_id) is None
        assert await _call(b, RpcCode.ICI_TRANSFER, {
            "block_id": bid, "source_worker_id": a.worker_id}) == \
            {"success": False, "via": "", "message": "ici transfer disabled"}
        assert "hbm_blocks" not in unpack(
            await asyncio.to_thread(a._heartbeat_body))
        assert "hbm" not in await _call(a, RpcCode.GET_BLOCK_INFO,
                                        {"block_id": bid})
        assert b.metrics.counters.get("ici.tcp_fallbacks", 0) == 0


async def test_heartbeat_and_block_info_advertise_the_tier(tmp_path):
    data = _payload(2 * MB, 5)
    async with _cluster(tmp_path) as (m, ws, conf):
        bid, a, b = await _write_and_pin(conf, ws, "/ici/adv", data)
        body = unpack(await asyncio.to_thread(a._heartbeat_body))
        assert body["hbm_blocks"] == [bid]
        assert unpack(await asyncio.to_thread(b._heartbeat_body))[
            "hbm_blocks"] == []
        a.conf.worker.hbm_advertise_max = 0
        assert unpack(await asyncio.to_thread(a._heartbeat_body))[
            "hbm_blocks"] == []
        rep = await _call(a, RpcCode.GET_BLOCK_INFO, {"block_id": bid})
        jtable = JaxExportTable()
        jtable.add(bid, a.hbm.holders(bid)[0],
                   np.frombuffer(data, dtype=np.uint8))
        assert rep["hbm"] == {"worker_id": a.worker_id,
                              "ici_coords": list(a.conf.worker.ici_coords),
                              **jtable.get(bid)}
        assert rep["hbm"]["nbytes"] == len(data)
        # the master took the heartbeat with the advertisement
        await a.heartbeat_once()
        assert m.fs.workers.live_workers()
