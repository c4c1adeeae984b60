"""Port parity: the cache worker of ``curvine_tpu_torch`` (its RPC server,
block store, heartbeat and device tier-0 hooks) against the JAX package,
on the CPU.

The JAX package's master runs alone (``MiniCluster(workers=0,
lost_timeout_ms=30_000)``) and the port's ``WorkerServer`` registers
with it; the JAX client and the port's client write and read through it.
Device tiers are ``torch.device("cpu", i)`` tiers. Mirrors
``test_worker_hbm_pin`` (test_train_e2e.py:67),
``test_worker_advertises_per_chip_hbm`` (test_tpu.py:355),
``test_hbm_autopin_hot_blocks_and_orphan_cleanup`` (test_tpu.py:382),
``test_evict_drops_only_when_no_slower_tier`` and
``test_promote_respects_min_reads_and_decay`` (test_tiering.py:67, 93)
and ``test_store_s3fifo_scan_resistant_lru_not``
(test_cache_admission.py:162); holds ``worker_id_for``, GET_BLOCK_INFO,
``storages()`` and ``report()`` equal to the JAX worker's on the same
blocks, and a block directory written by either package reopening in the
other. Bytes are compared exactly everywhere."""

import asyncio
import contextlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from curvine_tpu.common import errors as jerr
from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu.common.conf import TierConf as JaxTierConf
from curvine_tpu.common.types import StorageType as JaxStorageType
from curvine_tpu.testing import MiniCluster
from curvine_tpu.worker import WorkerServer as JaxWorker
from curvine_tpu.worker import server as jax_server
from curvine_tpu.worker import storage as jax_storage
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common import errors as perr
from curvine_tpu_torch.common.conf import ClusterConf, TierConf
from curvine_tpu_torch.common.types import StorageType
from curvine_tpu_torch.gpu import cuda_ops
from curvine_tpu_torch.rpc.client import Connection
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker import promote as port_promote
from curvine_tpu_torch.worker import server as port_server
from curvine_tpu_torch.worker import storage as port_storage
from curvine_tpu_torch.worker.blockfile import crc_update

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KB = 1024
MiB = 1 << 20
BLOCK = 4 * MiB                  # MiniCluster's block size


def _data(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def _worker_conf(master_addrs, root, hbm: int = 0,
                 tier_bytes: int = 64 * MiB) -> ClusterConf:
    conf = ClusterConf()
    conf.client.master_addrs = list(master_addrs)
    conf.client.block_size = BLOCK
    wc = conf.worker
    wc.hostname, wc.rpc_port, wc.heartbeat_ms = "127.0.0.1", 0, 200
    wc.promote_interval_ms = 0       # the tests run each promote cycle
    wc.tiers = [TierConf(storage_type="mem", dir=os.path.join(root, "mem"),
                         capacity=tier_bytes)]
    wc.hbm_capacity = hbm
    return conf


@contextlib.asynccontextmanager
async def _port_cluster(tmp_path, hbm: int = 0, devices=None, **kw):
    """The JAX package's master alone, and the port's worker registered
    with it: (cluster, worker, the worker's conf)."""
    async with MiniCluster(workers=0, lost_timeout_ms=30_000) as mc:
        conf = _worker_conf(mc.conf.client.master_addrs, str(tmp_path),
                            hbm=hbm, **kw)
        w = port_server.WorkerServer(conf, devices=devices)
        await w.start()
        try:
            await mc.await_workers(1)
            yield mc, w, conf
        finally:
            await w.stop()


def _port_client(conf: ClusterConf, **client) -> CurvineClient:
    c = ClusterConf()
    c.client.master_addrs = list(conf.client.master_addrs)
    c.client.block_size = BLOCK
    for k, v in client.items():
        setattr(c.client, k, v)
    return CurvineClient(c)


def _cpus(n: int) -> list[torch.device]:
    return [torch.device("cpu", i) for i in range(n)]


async def _block_id(client, path: str) -> int:
    fb = await client.meta.get_block_locations(path)
    return fb.block_locs[0].block.id


# ------------------------------------------------ mirrors of the reference

async def test_worker_hbm_pin(tmp_path):
    async with _port_cluster(tmp_path, hbm=64 * MiB,
                             devices=_cpus(1)) as (mc, w, _conf):
        c = mc.client()
        data = _data(MiB, 0)
        await c.write_all("/hbm/blk.bin", data)
        bid = await _block_id(c, "/hbm/blk.bin")
        conn = await c.pool.get(w.addr)
        from curvine_tpu.rpc import RpcCode as JaxCode
        rep = await conn.call(JaxCode.HBM_PIN, data=pack({"block_id": bid}))
        body = rep.header or unpack(rep.data)
        assert body["len"] == len(data) and body["holders"] == [0]
        assert body["hbm"]["blocks"] == 1
        arr = w.hbm.get(bid)
        assert arr is not None and arr.numpy().tobytes() == data
        # the heartbeat advertises the device tier to the master
        await w.heartbeat_once()
        info = await c.meta.master_info()
        assert JaxStorageType.HBM in {s.storage_type for wi in
                                      info.live_workers for s in wi.storages}
        await conn.call(JaxCode.HBM_UNPIN, data=pack({"block_id": bid}))
        assert w.hbm.get(bid) is None


async def test_worker_advertises_per_chip_hbm(tmp_path):
    async with _port_cluster(tmp_path, hbm=1 << 20,
                             devices=_cpus(8)) as (mc, w, _conf):
        hbm = [s for s in w._info().storages
               if s.storage_type == StorageType.HBM]
        assert sorted(s.dir_id for s in hbm) == \
            sorted(f"hbm:{i}" for i in range(8))
        assert all(s.capacity == (1 << 20) // 8 for s in hbm)
        await w.heartbeat_once()
        wi = mc.master.fs.workers.live_workers()[0]
        assert wi.address.worker_id == w.worker_id
        assert sum(1 for s in wi.storages
                   if s.storage_type == JaxStorageType.HBM) == 8


async def test_hbm_autopin_hot_blocks_and_orphan_cleanup(tmp_path):
    async with _port_cluster(tmp_path, hbm=64 * MiB,
                             devices=_cpus(8)) as (mc, w, _conf):
        c = mc.client()
        await c.write_all("/hot.bin", b"H" * 100_000)
        await c.write_all("/cold.bin", b"C" * 100_000)
        for _ in range(4):
            await c.read_all("/hot.bin")        # heat the block
        hot_bid = await _block_id(c, "/hot.bin")
        cold_bid = await _block_id(c, "/cold.bin")
        await w._promote_once()
        assert hot_bid in w.hbm, "the hot block should auto-pin"
        assert cold_bid not in w.hbm, "a cold block must not pin"
        assert w.hbm.get(hot_bid)[:5].numpy().tobytes() == b"HHHHH"
        assert w.metrics.counters["blocks.hbm_pinned"] == 1
        # deleting the file drops the device copy on a later heartbeat
        await c.meta.delete("/hot.bin")

        async def gone():
            while hot_bid in w.hbm:
                await w.heartbeat_once()
                await asyncio.sleep(0.1)
        await asyncio.wait_for(gone(), 10.0)
        assert not w.store.contains(hot_bid)


# --------------------------------------------- both clients, both paths

@pytest.mark.parametrize("writer", ["jax", "jax-write-block", "port-sc",
                                    "port-write-block"])
async def test_writes_read_back_through_both_clients_and_paths(tmp_path,
                                                               writer):
    data = _data(2 * BLOCK + 12345, 7)
    async with _port_cluster(tmp_path) as (mc, w, conf):
        jc = mc.client()
        pcs = {sc: _port_client(conf, short_circuit=sc)
               for sc in (True, False)}
        try:
            if writer.startswith("jax"):
                jc.conf.client.short_circuit = writer == "jax"
                await mc.client().write_all("/x.bin", data)
                jc.conf.client.short_circuit = True
            else:
                pw = pcs[writer == "port-sc"]
                await pw.write_all("/x.bin", data)
                assert pw.counters["write.bytes"] == len(data)
                assert pw.counters.get("sc.bytes.written", 0) == \
                    (len(data) if writer == "port-sc" else 0)
            assert await jc.read_all("/x.bin") == data
            jc.conf.client.short_circuit = False
            assert await mc.client().read_all("/x.bin") == data
            for sc, pc in pcs.items():
                before = dict(pc.counters)
                assert bytes(await pc.read_all("/x.bin")) == data
                key = "sc.bytes.read" if sc else "read.zero_copy_bytes"
                assert pc.counters[key] - before.get(key, 0) == len(data)
            # the worker's blocks carry the crc the writer chained
            fb = await jc.meta.get_block_locations("/x.bin")
            off = 0
            for lb in fb.block_locs:
                info = w.store.get(lb.block.id, touch=False)
                chunk = data[off:off + lb.block.len]
                assert info.crc32c == crc_update(info.crc_algo, chunk)
                off += lb.block.len
        finally:
            for pc in pcs.values():
                await pc.close()


async def test_errors_cross_the_wire_with_the_reference_codes(tmp_path):
    async with _port_cluster(tmp_path) as (mc, w, conf):
        jc = mc.client()
        jconn = await jc.pool.get(w.addr)
        with pytest.raises(jerr.BlockNotFound):
            await jconn.call(RpcCode.GET_BLOCK_INFO,
                             data=pack({"block_id": 987654}))
        pconn = await Connection(w.addr).connect()
        try:
            with pytest.raises(perr.BlockNotFound):
                await pconn.call(RpcCode.GET_BLOCK_INFO,
                                 data=pack({"block_id": 987654}))
            with pytest.raises(perr.Unsupported):       # no device tier
                await pconn.call(RpcCode.HBM_PIN,
                                 data=pack({"block_id": 1}))
            with pytest.raises(perr.CurvineError, match="no handler"):
                await pconn.call(RpcCode.MKDIR, data=pack({}))
            # batched writes, EC conversions and cell rebuilds are served
            rep = await pconn.call(RpcCode.WRITE_BLOCKS_BATCH, data=pack({}))
            assert unpack(rep.data) == {"results": []}
            rep = await pconn.call(RpcCode.SUBMIT_TASK, data=pack({"task": {
                "task_id": "t", "job_id": "j", "path": "/x",
                "kind": "ec_convert"}}))
            assert rep.header == {"accepted": True}
            # a rebuild with no readable sibling answers its failure
            rep = await pconn.call(
                RpcCode.SUBMIT_BLOCK_REPLICATION_JOB, data=pack({
                    "block_id": 5, "ec": {"cell_index": 0,
                                          "profile": "rs-2-1",
                                          "cell_size": 8, "sources": []}}))
            assert rep.header["success"] is False
            assert "0/2 sibling cells" in rep.header["message"]
            # an unknown task kind is still refused by name
            with pytest.raises(perr.Unsupported, match="restore"):
                await pconn.call(RpcCode.SUBMIT_TASK, data=pack({"task": {
                    "task_id": "t", "job_id": "j", "path": "/x",
                    "kind": "restore"}}))
            # the device-path transfer, on by default: no peer is named,
            # so it misses and the caller keeps its TCP rail
            rep = await pconn.call(RpcCode.ICI_TRANSFER,
                                   data=pack({"block_id": 987654}))
            assert rep.header == {"success": False, "via": ""}
            assert w.metrics.counters["ici.tcp_fallbacks"] == 1
            await jc.write_all("/held.bin", b"h" * 10)
            bid = await _block_id(jc, "/held.bin")
            rep = await pconn.call(RpcCode.ICI_TRANSFER,
                                   data=pack({"block_id": bid}))
            assert rep.header == {"success": True, "via": "local"}
        finally:
            await pconn.close()


async def test_uploads_abort_and_refuse_a_bad_crc(tmp_path):
    """WRITE_BLOCK's stream sink: an aborted upload leaves no temp block,
    a crc that does not match the bytes is refused and leaves none, and
    a good one commits with the chained crc."""
    async with _port_cluster(tmp_path) as (mc, w, _conf):
        conn = await Connection(w.addr).connect()
        try:
            data = _data(3 * MiB + 5, 11)

            async def upload(bid, crc, abort=False):
                up = await conn.open_upload(RpcCode.WRITE_BLOCK, header={
                    "block_id": bid, "len_hint": BLOCK, "algo": "crc32c"})
                for off in range(0, len(data), MiB):
                    await up.send_chunk(data[off:off + MiB])
                if abort:
                    await up.abort()
                    return None
                return await up.finish({"crc32": crc, "algo": "crc32c"})

            assert await upload(500, 0, abort=True) is None
            good = crc_update("crc32c", data)
            with pytest.raises(perr.AbnormalData, match="crc mismatch"):
                await upload(501, good ^ 1)
            rep = await upload(502, good)
            assert rep.header == {"block_id": 502, "len": len(data),
                                  "crc32": good, "worker_id": w.worker_id}
            for _ in range(50):                  # the abort is no-reply
                if not w.store.contains(500):
                    break
                await asyncio.sleep(0.02)
            assert not w.store.contains(500) and not w.store.contains(501)
            info = w.store.get(502, touch=False)
            assert (info.len, info.crc32c, info.crc_algo) == \
                (len(data), good, "crc32c")
            tmp = [f for _d, _s, fs in os.walk(tmp_path / "mem")
                   for f in fs if not f.endswith(".blk")]
            assert tmp == []
            # READ_BLOCK with verify: the bytes read and crc32'd on the way
            chunks, eof = [], {}
            async for m in conn.call_stream(RpcCode.READ_BLOCK, header={
                    "block_id": 502, "chunk_size": MiB, "verify": True}):
                chunks.append(bytes(m.data))
                if m.is_eof:
                    eof = m.header
            assert b"".join(chunks) == data
            import zlib
            assert eof == {"crc32": zlib.crc32(data), "len": len(data),
                           "block_crc32": good, "block_crc_algo": "crc32c"}
        finally:
            await conn.close()


async def test_a_draining_worker_refuses_new_writes(tmp_path):
    async with _port_cluster(tmp_path) as (mc, w, _conf):
        jc = mc.client()
        await jc.write_all("/before.bin", b"b" * 1000)
        # the master's decommission reaches the worker on its heartbeat
        mc.master.fs.decommission_worker(w.worker_id)
        await w.heartbeat_once()
        assert w.draining
        conn = await Connection(w.addr).connect()
        try:
            for code in (RpcCode.SC_WRITE_OPEN, RpcCode.WRITE_BLOCK):
                with pytest.raises(perr.WorkerDraining):
                    hdr = {"block_id": 777, "len_hint": 10}
                    if code == RpcCode.SC_WRITE_OPEN:
                        await conn.call(code, data=pack(hdr))
                    else:
                        up = await conn.open_upload(code, header=hdr)
                        await up.finish({})
        finally:
            await conn.close()
        assert await jc.read_all("/before.bin") == b"b" * 1000
        mc.master.fs.decommission_worker(w.worker_id, on=False)
        await w.heartbeat_once()
        assert not w.draining


async def test_heartbeats_back_off_while_no_master_answers(tmp_path):
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()                                  # nothing listens there
    w = port_server.WorkerServer(_worker_conf([dead], str(tmp_path)))
    await w.rpc.start()
    try:
        await w.heartbeat_once()
        assert w._hb_fails == 1 and w._hb_backoff_until > 0
        until = w._hb_backoff_until
        await w.heartbeat_once()               # inside the back-off: no try
        assert (w._hb_fails, w._hb_backoff_until) == (1, until)
        w._hb_backoff_until = 0.0
        await w.heartbeat_once()
        assert w._hb_fails == 2 and w._hb_backoff_until > until
    finally:
        await w.stop()


async def test_heartbeat_back_off_stops_at_half_the_lost_timeout(tmp_path):
    """With the defaults (3 s heartbeats, a 30 s lost timeout) the back-off
    doubles from 6 s and stops at 15 s, where the reference's goes on to
    60 s: a master restarted after an outage of any length waits 30 s
    for its workers, and each of them tries again inside 15 s (ROADMAP
    §C, C9)."""
    import socket
    import time
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()                                  # nothing listens there
    conf = _worker_conf([dead], str(tmp_path))
    conf.worker.heartbeat_ms = 3_000
    assert conf.master.worker_lost_timeout_ms == 30_000
    w = port_server.WorkerServer(conf)
    await w.rpc.start()
    try:
        delays = []
        for _ in range(8):                     # an outage of minutes
            w._hb_backoff_until = 0.0
            await w.heartbeat_once()
            delays.append(round(w._hb_backoff_until - time.monotonic()))
        assert delays == [6, 12, 15, 15, 15, 15, 15, 15]
    finally:
        await w.stop()


async def test_eviction_ghosts_the_device_copy(tmp_path):
    """A block dropped under the mem tier's pressure leaves the tier-0
    as an eviction (ghosted), so a re-pin of it skips probation."""
    async with _port_cluster(tmp_path, hbm=64 * MiB, devices=_cpus(1),
                             tier_bytes=4 * BLOCK) as (mc, w, conf):
        w.executor.cancel("eviction")          # the test runs it once
        pc = _port_client(conf)
        try:
            for i in range(4):                  # the tier at 100% > 95%
                await pc.write_all(f"/e{i}.bin", _data(BLOCK, 20 + i))
            ids = [await _block_id(pc, f"/e{i}.bin") for i in range(4)]
            for bid in ids:
                w.store.touch_reads(bid, 5)
            await w._promote_once()
            assert all(b in w.hbm for b in ids)
            ghosts = w.hbm.policy.stats()
            await w._evict_once()
            gone = [b for b in ids if not w.store.contains(b)]
            assert gone and all(b not in w.hbm for b in gone)
            assert w.metrics.counters["blocks.evicted"] == len(gone)
            assert w.hbm.policy.stats()["evicted"] == \
                ghosts["evicted"] + len(gone)
        finally:
            await pc.close()


# ------------------------------------------------------ reference parity

@pytest.mark.parametrize("host,port", [("127.0.0.1", 0), ("127.0.0.1", 8996),
                                       ("worker-7.example", 40001),
                                       ("10.0.0.3", 65535)])
def test_worker_id_matches_the_reference(host, port):
    assert port_server.worker_id_for(host, port) == \
        jax_server.worker_id_for(host, port)


def _commit(store, bid: int, data: bytes, crc: int | None, algo: str):
    info = store.create_temp(bid, size_hint=len(data))
    with open(info.path, "wb") as f:
        f.write(data)
    store.commit(bid, len(data), checksum=crc, checksum_algo=algo)


_BLOCKS = [(11, _data(3000, 1), "crc32"), (300, _data(1, 2), "crc32c"),
           (4097, b"", "crc32"), (12, _data(70_000, 3), None)]


def _fill(store) -> None:
    for bid, data, algo in _BLOCKS:
        crc = None if algo is None else crc_update(algo, data)
        _commit(store, bid, data, crc, algo or "crc32")


def _wire(storages) -> list[dict]:
    out = []
    for s in storages:
        d = s.to_wire()
        d["dir_id"] = d["dir_id"].split(":")[0]     # the roots differ
        out.append(d)
    return out


async def test_block_info_storages_and_report_match_the_jax_worker(tmp_path):
    async with MiniCluster(workers=0, lost_timeout_ms=30_000) as mc:
        jconf = JaxConf()
        jconf.client.master_addrs = list(mc.conf.client.master_addrs)
        jconf.worker.hostname, jconf.worker.rpc_port = "127.0.0.1", 0
        jconf.worker.heartbeat_ms = 200
        # the fd path's answers are compared: the shm offers name each
        # worker's own side channel (tests/test_torch_shm_parity.py)
        jconf.worker.shm_reads = False
        jconf.worker.tiers = [JaxTierConf(
            storage_type="mem", dir=str(tmp_path / "jax"),
            capacity=64 * MiB)]
        jw = JaxWorker(jconf)
        pconf = _worker_conf(mc.conf.client.master_addrs,
                             str(tmp_path / "port"))
        pconf.worker.shm_reads = False
        pw = port_server.WorkerServer(pconf)
        await jw.start()
        await pw.start()
        try:
            await mc.await_workers(2)
            # the blocks below belong to no file: a periodic report would
            # have the master collect them before they are compared
            for w in (jw, pw):
                w.executor.cancel("block-report")
            _fill(jw.store)
            _fill(pw.store)
            conn = await Connection(jw.addr).connect()
            pconn = await Connection(pw.addr).connect()
            try:
                for bid, _data_, _algo in _BLOCKS:
                    want = (await conn.call(RpcCode.GET_BLOCK_INFO, data=pack(
                        {"block_id": bid}))).header
                    got = (await pconn.call(RpcCode.GET_BLOCK_INFO, data=pack(
                        {"block_id": bid}))).header
                    assert got.pop("path") != want.pop("path")
                    assert got == want
            finally:
                await conn.close()
                await pconn.close()
            assert _wire(pw.store.storages()) == _wire(jw.store.storages())
            assert pw.store.report() == jw.store.report()
            # what the master holds of each after a heartbeat
            for w in (jw, pw):
                await w.heartbeat_once()
            workers = mc.master.fs.workers.workers
            assert _wire(workers[pw.worker_id].storages) == \
                _wire(workers[jw.worker_id].storages)
            # no file owns the blocks: the master answers both reports
            # with the same orphans, and both workers drop them
            for w in (jw, pw):
                await w.block_report_once()
            assert pw.store.report() == jw.store.report() == ({}, {})
        finally:
            await pw.stop()
            await jw.stop()


def _store(package, root):
    if package == "jax":
        mem = jax_storage.TierDir(JaxStorageType.MEM, root, 64 * MiB)
        return jax_storage.BlockStore([mem])
    mem = port_storage.TierDir(StorageType.MEM, root, 64 * MiB)
    return port_storage.BlockStore([mem])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_block_directory_reopens_in_the_other_package(tmp_path, writer,
                                                        reader):
    root = str(tmp_path / "mem")
    _fill(_store(writer, root))
    # a torn write of the writer's last run: both packages discard it
    w = _store(writer, root)
    info = w.create_temp(999, size_hint=10)
    with open(info.path, "wb") as f:
        f.write(b"torn")
    again = _store(writer, root)           # the writer's own reopen
    other = _store(reader, root)
    assert other.report() == again.report()
    assert [s.to_wire() for s in other.storages()] == \
        [s.to_wire() for s in again.storages()]
    assert not other.contains(999)
    for bid, data, _algo in _BLOCKS:
        a, b = other.get(bid, touch=False), again.get(bid, touch=False)
        # the file layout keeps no crc on disk: neither reopen has one
        assert (a.len, a.crc32c, b.crc32c) == (len(data), None, None)
        with open(a.path, "rb") as f:
            assert f.read() == data


# ----------------------------------------------------------- store mirrors

def _pair(tmp_path, make):
    """The same store built by each package: {package: (store, tiers)}."""
    out = {}
    for pkg, mod, st in (("jax", jax_storage, JaxStorageType),
                         ("port", port_storage, StorageType)):
        out[pkg] = make(mod, st, tmp_path / pkg)
    return out


def _put(store, bid, data, hint=None):
    info = store.create_temp(bid, hint=hint, size_hint=len(data))
    with open(info.path, "wb") as f:
        f.write(data)
    return store.commit(bid, len(data))


def test_evict_drops_only_when_no_slower_tier(tmp_path):
    def make(mod, st, root):
        mem = mod.TierDir(st.MEM, str(root / "m"), 4 * KB)
        return mod.BlockStore([mem], high_water=0.9, low_water=0.5)

    held = {}
    for pkg, store in _pair(tmp_path, make).items():
        for bid in range(4):
            _put(store, bid, bytes([bid]) * KB)
        _put(store, 9, b"\x09" * KB)
        held[pkg] = [b for b in range(4) if store.contains(b)]
        assert len(held[pkg]) < 4        # single tier: eviction must drop
        assert store.contains(9)
    assert held["port"] == held["jax"]


def test_promote_respects_min_reads_and_decay(tmp_path):
    def make(mod, st, root):
        mem = mod.TierDir(st.MEM, str(root / "mem"), 4 * KB)
        ssd = mod.TierDir(st.SSD, str(root / "ssd"), 64 * KB)
        return mod.BlockStore([mem, ssd], high_water=0.9, low_water=0.5)

    for pkg, store in _pair(tmp_path, make).items():
        hint = store.tiers[1].storage_type
        _put(store, 1, b"a" * KB, hint=hint)
        store.get(1)
        store.get(1)
        assert store.promote_scan(min_reads=3) == [], pkg
        # the scan halved the heat (2 -> 1); two more reads reach 3
        store.get(1)
        store.get(1)
        assert store.promote_scan(min_reads=3) == [1], pkg
        assert store.get(1, touch=False).tier is store.tiers[0]
        with open(store.get(1, touch=False).path, "rb") as f:
            assert f.read() == b"a" * KB


def test_promote_demotes_dest_cold_blocks_for_space(tmp_path):
    def make(mod, st, root):
        mem = mod.TierDir(st.MEM, str(root / "mem"), 2 * KB)
        ssd = mod.TierDir(st.SSD, str(root / "ssd"), 64 * KB)
        return mod.BlockStore([mem, ssd], high_water=0.9, low_water=0.5)

    for pkg, store in _pair(tmp_path, make).items():
        mem, ssd = (t.storage_type for t in store.tiers)
        _put(store, 1, b"r" * KB, hint=mem)
        _put(store, 2, b"r" * KB, hint=mem)
        _put(store, 3, b"h" * KB, hint=ssd)
        for _ in range(4):
            store.get(3)
        assert store.promote_scan(min_reads=3) == [3], pkg
        assert store.get(3, touch=False).tier.storage_type == mem
        for bid in (1, 2):               # demoted, not dropped
            info = store.get(bid, touch=False)
            with open(info.path, "rb") as f:
                assert f.read() == b"r" * KB


def _scan_ab(mod, st, root, admission, hot_n=4, scan_n=64, touch_every=16):
    mem = mod.TierDir(st.MEM, str(root / f"mem-{admission}"), 16 * KB)
    store = mod.BlockStore([mem], high_water=0.9, low_water=0.5,
                           admission=admission)
    hot = list(range(hot_n))
    for bid in hot:
        _put(store, bid, b"\0" * KB)
    for bid in hot:
        store.get(bid)
    for k in range(scan_n):
        _put(store, 1000 + k, b"\0" * KB)
        if k % touch_every == 0:
            for bid in hot:
                if store.contains(bid):
                    store.get(bid)
    return sum(1 for bid in hot if store.contains(bid)), store


def test_store_s3fifo_scan_resistant_lru_not(tmp_path):
    got = {}
    for pkg, mod, st in (("jax", jax_storage, JaxStorageType),
                         ("port", port_storage, StorageType)):
        s3, s3_store = _scan_ab(mod, st, tmp_path / pkg, "s3fifo")
        lru, _ = _scan_ab(mod, st, tmp_path / pkg, "lru")
        assert s3 == 4, f"{pkg}: s3fifo flushed the hot set ({s3}/4)"
        assert s3 > lru
        stats = s3_store.cache_stats()["total"]
        assert stats["scan_evicted"] > 0
        assert stats["evicted"] >= stats["scan_evicted"]
        got[pkg] = (s3, lru, sorted(s3_store.blocks), stats)
    assert got["port"] == got["jax"]


# ------------------------------------------------ the autopin's failures

async def test_a_corrupt_media_copy_is_refused_counted_and_reported(tmp_path):
    async with _port_cluster(tmp_path, hbm=64 * MiB,
                             devices=_cpus(1)) as (mc, w, conf):
        pc = _port_client(conf)
        try:
            await pc.write_all("/bad.bin", _data(300_000, 5))
            bid = await _block_id(pc, "/bad.bin")
            path = w.store.get(bid, touch=False).path
            with open(path, "r+b") as f:         # one byte, after commit
                f.seek(1234)
                b = f.read(1)
                f.seek(1234)
                f.write(bytes([b[0] ^ 0x20]))
            w.store.touch_reads(bid, 5)
            launches = cuda_ops.block_checksum.launches
            await w._promote_once()
            assert bid not in w.hbm
            assert w.metrics.counters["blocks.corrupt"] == 1
            assert w.metrics.counters["blocks.corrupt_reported"] == 1
            assert "blocks.hbm_pinned" not in w.metrics.counters
            assert cuda_ops.block_checksum.launches == launches
            # the master holds the replica for evacuation
            assert mc.master.replication._evac[bid] == w.worker_id
        finally:
            await pc.close()


async def test_a_diverging_device_copy_is_refused_by_the_device_check(
        tmp_path):
    async with _port_cluster(tmp_path, hbm=64 * MiB,
                             devices=_cpus(1)) as (mc, w, conf):
        c = mc.client()
        await c.write_all("/flip.bin", _data(300_000, 7))
        bid = await _block_id(c, "/flip.bin")
        w.store.touch_reads(bid, 5)
        real_put = w.hbm.put

        def put_flipped(block_id, data, device=None):
            arr = real_put(block_id, data, device)
            arr[4321] ^= 0x01         # the media copy is good, this is not
            return arr
        w.hbm.put = put_flipped
        await w._promote_once()
        assert not w.hbm_holds(bid) and w.hbm.used == 0
        assert w.metrics.counters["blocks.corrupt"] == 1
        assert w.metrics.counters["blocks.corrupt_reported"] == 1
        assert "blocks.hbm_pinned" not in w.metrics.counters
        assert mc.master.replication._evac[bid] == w.worker_id


class _OwnedLock:
    """A lock that knows the thread holding it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.owner = None

    def __enter__(self):
        self._lock.acquire()
        self.owner = threading.get_ident()
        return self

    def __exit__(self, *exc):
        self.owner = None
        self._lock.release()


async def test_a_promotion_holds_the_tier_lock_over_put_and_k1_only(
        tmp_path, monkeypatch):
    """The media crc and the host hash run with the tier's lock free;
    the put and K1 under it. A consumer thread reading the tier through
    the worker's accessors during the cycle sees each block whole or not
    at all (exact bytes)."""
    async with _port_cluster(tmp_path, hbm=64 * MiB,
                             devices=_cpus(2)) as (mc, w, conf):
        c = mc.client()
        blocks = {}
        for i in range(6):
            data = _data(MiB, 20 + i)
            await c.write_all(f"/lock/{i}.bin", data)
            bid = await _block_id(c, f"/lock/{i}.bin")
            blocks[bid] = data
            w.store.touch_reads(bid, 5)
        w._hbm_lock = _OwnedLock()
        held = {"crc": [], "host_hash": [], "k1": []}

        def noting(fn, key):
            def f(*a, **kw):
                held[key].append(w._hbm_lock.owner == threading.get_ident())
                return fn(*a, **kw)
            return f
        for name, key in (("crc_update", "crc"),
                          ("block_checksum_host", "host_hash"),
                          ("block_checksum", "k1")):
            monkeypatch.setattr(port_promote, name,
                                noting(getattr(port_promote, name), key))
        stop = threading.Event()
        bad = []

        def consumer():
            while not stop.is_set():
                for bid, data in blocks.items():
                    t = w.hbm_get(bid)
                    if t is not None and (t.numpy().tobytes() != data
                                          or not w.hbm_holds(bid)):
                        bad.append(bid)
        th = threading.Thread(target=consumer)
        th.start()
        try:
            await w._promote_once()
        finally:
            stop.set()
            th.join(timeout=60)
        assert not th.is_alive() and not bad
        assert all(w.hbm_holds(b) for b in blocks)
        assert w.metrics.counters["blocks.hbm_pinned"] == len(blocks)
        assert held == {"crc": [False] * 6, "host_hash": [False] * 6,
                        "k1": [True] * 6}
        assert w.metrics.gauges["hbm.used"] == 6 * MiB
        assert {w.hbm_get(b).numpy().tobytes() for b in blocks} == \
            set(blocks.values())


async def test_a_block_deleted_mid_pin_leaves_no_device_copy(tmp_path):
    async with _port_cluster(tmp_path, hbm=64 * MiB,
                             devices=_cpus(2)) as (mc, w, conf):
        c = mc.client()
        await c.write_all("/gone.bin", _data(200_000, 6))
        bid = await _block_id(c, "/gone.bin")
        w.store.touch_reads(bid, 5)
        real = w._pin_work

        def pin_then_deleted(block_id, info):
            n = real(block_id, info)
            assert block_id in w.hbm          # the put landed ...
            w.store.delete(block_id)          # ... after the delete's drop
            return n
        w._pin_work = pin_then_deleted
        assert await w._autopin_block(bid) == 0
        assert bid not in w.hbm and w.hbm.used == 0


# ------------------------------------------------------------ no fallback

def test_an_hbm_tier_without_a_cuda_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _worker_conf(["127.0.0.1:1"], str(tmp_path), hbm=MiB)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_server.WorkerServer(conf)
    assert port_server.WorkerServer(conf, devices=_cpus(1)).hbm is not None
    conf.worker.hbm_capacity = 0
    assert port_server.WorkerServer(conf).hbm is None


@pytest.mark.parametrize("table", [
    "[worker]\ndirect_io_engine = \"uring\"",
    "[worker]\ndisk_error_threshold = 5",
    "[qos]\ntenants = [\"a:100\"]",
    "[[worker.tiers]]\nstorage_type = \"ssd\"\ndir = \"d\"\nlayout = \"bdev\"",
    "[[worker.tiers]]\ndir = \"d\"\nqueue_depth = 8",
])
def test_a_file_setting_an_unported_branch_is_refused(tmp_path, table):
    p = tmp_path / "c.toml"
    p.write_text(table + "\n")
    with pytest.raises(ValueError, match="ROADMAP A3c"):
        ClusterConf.load(str(p))


def test_the_cluster_file_loads_its_worker_tables(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text("""
[master]
hostname = "127.0.0.1"
[worker]
hostname = "127.0.0.1"
rpc_port = 18996
heartbeat_ms = 500
hbm_capacity = 4294967296
ici_transfer = false
shm_reads = false
unknown_key = 1
[[worker.tiers]]
storage_type = "mem"
dir = "/tmp/x/mem"
capacity = 1073741824
layout = "file"
[[worker.tiers]]
storage_type = "ssd"
dir = "/tmp/x/ssd"
capacity = 2147483648
[client]
master_addrs = ["127.0.0.1:18995"]
""")
    conf = ClusterConf.load(str(p))
    wc = conf.worker
    assert (wc.rpc_port, wc.heartbeat_ms, wc.hbm_capacity) == \
        (18996, 500, 4 << 30)
    assert [(t.storage_type, t.dir, t.capacity) for t in wc.tiers] == [
        ("mem", "/tmp/x/mem", 1 << 30), ("ssd", "/tmp/x/ssd", 2 << 30)]
    assert conf.client.master_addrs == ["127.0.0.1:18995"]
    # the reference's defaults where the file is silent
    jw = JaxConf().worker
    for k in ("block_report_interval_ms", "io_chunk_size",
              "eviction_high_water", "eviction_low_water",
              "promote_interval_ms", "promote_min_reads", "hbm_export_cap",
              "ici_transfer", "hbm_advertise_max", "cache_admission", "cache_ghost_entries", "cache_small_ratio"):
        assert getattr(ClusterConf().worker, k) == getattr(jw, k), k


async def test_the_worker_command_registers_and_serves_a_jax_client(tmp_path):
    async with MiniCluster(workers=0, lost_timeout_ms=30_000) as mc:
        p = tmp_path / "c.toml"
        p.write_text(f"""
[worker]
hostname = "127.0.0.1"
rpc_port = 0
heartbeat_ms = 200
hbm_capacity = 0
[[worker.tiers]]
storage_type = "mem"
dir = "{tmp_path / 'mem'}"
capacity = {64 * MiB}
[client]
master_addrs = {json.dumps(mc.conf.client.master_addrs)}
""")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "curvine_tpu_torch.worker", "--conf",
            str(p), cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        try:
            line = await asyncio.wait_for(proc.stdout.readline(), 120)
            info = json.loads(line)
            assert info["jax_free"] is True and info["pid"] == proc.pid
            await mc.await_workers(1, timeout=30)
            live = mc.master.fs.workers.live_workers()
            host, port = info["addr"].rsplit(":", 1)
            assert [w.address.worker_id for w in live] == \
                [info["worker_id"]] == \
                [jax_server.worker_id_for(host, int(port))]
            data = _data(BLOCK + 99, 8)
            c = mc.client()
            await c.write_all("/cmd.bin", data)
            assert await c.read_all("/cmd.bin") == data
            c.conf.client.short_circuit = False
            assert await mc.client().read_all("/cmd.bin") == data
        finally:
            proc.terminate()
            assert await asyncio.wait_for(proc.wait(), 60) == 0
            err = await proc.stderr.read()
            assert b"Traceback" not in err, err.decode()


async def test_card_cluster_runs_the_master_alone_for_the_port_worker(
        tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.join(ROOT, "scripts", "card_cluster.py"),
        "--base-dir", str(tmp_path / "cluster"), "--codec", "port",
        "--workers", "0", cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        line = await asyncio.wait_for(proc.stdout.readline(), 300)
        info = json.loads(line)
        conf = _worker_conf([info["master"]], str(tmp_path / "port"))
        async with CurvineClient(conf) as pc:
            st = (await pc.meta.call(RpcCode.GET_MASTER_INFO, {}))["info"]
            assert st["live_workers"] == []
            w = port_server.WorkerServer(conf)
            await w.start()
            try:
                for _ in range(100):
                    st = (await pc.meta.call(RpcCode.GET_MASTER_INFO,
                                             {}))["info"]
                    if st["live_workers"]:
                        break
                    await asyncio.sleep(0.1)
                assert [x["address"]["worker_id"]
                        for x in st["live_workers"]] == [w.worker_id]
                data = _data(BLOCK + 3, 9)
                await pc.write_all("/cc.bin", data)
                assert bytes(await pc.read_all("/cc.bin")) == data
            finally:
                await w.stop()
    finally:
        proc.terminate()
        assert await asyncio.wait_for(proc.wait(), 60) == 0


# ------------------------------------------------------- client read heat

async def test_short_circuit_reads_are_reported_as_heat(tmp_path):
    """The port's reader reports its reads to the JAX worker: heat counts
    the reads (every 512, and the rest at close), not the opens."""
    async with MiniCluster(workers=1, lost_timeout_ms=30_000) as mc:
        jw = mc.workers[0]
        conf = ClusterConf()
        conf.client.master_addrs = list(mc.conf.client.master_addrs)
        conf.client.block_size = BLOCK
        async with CurvineClient(conf) as pc:
            await pc.write_all("/heat.bin", _data(64 * KB, 10))
            bid = await _block_id(pc, "/heat.bin")
            r = await pc.open("/heat.bin")

            async def reads(n: int) -> int:
                for i in range(n):
                    assert len(await r.pread(i * 64, 64)) == 64
                await asyncio.sleep(0.2)      # a flush it started lands
                return jw.store.get(bid, touch=False).heat

            assert await reads(512) == 1 + 512   # the probe, one report
            assert await reads(88) == 1 + 512    # below the batch
            await r.close()                      # the 88 go at close
            assert jw.store.hot_blocks(600) == [(bid, 601, 64 * KB)]
            assert pc.counters["sc.bytes.read"] == 600 * 64


def test_the_launch_count_loses_no_update_across_threads():
    old = sys.getswitchinterval()
    start = cuda_ops.block_checksum.launches
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            cuda_ops._count_launch() for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        launches = cuda_ops.block_checksum.launches
        cuda_ops.block_checksum.launches = start
    assert launches - start == 16 * 2000
