"""The shared-memory read plane across the two packages, on the CPU.

The side channel's frames are the reference's byte for byte
(``curvine_tpu/worker/shm.py``: an 8-byte request, a 16-byte reply with
the fd in SCM_RIGHTS), so each package's reader maps memfds from the
other's worker:

- the port's reader against a JAX-package worker's channel (the
  reference's ``MiniCluster``), on its MEM tier and its warm cache;
- the JAX package's reader against the port's worker, registered with a
  JAX-package master, the same two ways.

The same reads by a client of each package give the same bytes and the
same hit and fallback counts. The channels themselves are crossed too:
each package's ``fetch_block_fd`` against the other's ``ShmChannel``."""

import asyncio
import contextlib
import os

import numpy as np
import pytest

from curvine_tpu.client import CurvineClient as JaxClient
from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu.common.conf import TierConf as JaxTierConf
from curvine_tpu.testing import MiniCluster
from curvine_tpu.worker import shm as jshm
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common.conf import ClusterConf, TierConf
from curvine_tpu_torch.worker import server as port_server
from curvine_tpu_torch.worker import shm as pshm

pytestmark = pytest.mark.skipif(
    not pshm.shm_supported(),
    reason="memfd_create/SCM_RIGHTS not available on this platform")

MB = 1 << 20
KEYS = ("read.shm_hits", "read.shm_warm_hits", "read.shm_fallbacks",
        "read.shm_warm_fallbacks")
# (offset, length) pairs over a file of two blocks and a bit
READS = [(0, 4096), (4096, 4096), (MB - 4096, 4096), (MB, 100),
         (MB + 50, 4000), (100, MB + 3000)]
SIZE = MB + 4096


def _payload(seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, SIZE,
                                                dtype=np.uint8).tobytes()


def _port_client(master_addrs) -> CurvineClient:
    conf = ClusterConf()
    conf.client.master_addrs = list(master_addrs)
    conf.client.block_size = MB
    return CurvineClient(conf)


def _jax_client(master_addrs) -> JaxClient:
    conf = JaxConf()
    conf.client.master_addrs = list(master_addrs)
    conf.client.block_size = MB
    return JaxClient(conf)


async def _reads(client, path: str) -> tuple[list[bytes], dict]:
    """READS through a fresh reader of ``client``: the bytes, and what
    its counters moved by."""
    before = dict(client.counters)
    r = await client.open(path)
    got = [bytes(await r.pread(off, n)) for off, n in READS]
    await r.close()
    return got, {k: client.counters.get(k, 0) - before.get(k, 0)
                 for k in KEYS}


async def _heat(client, path: str, times: int) -> None:
    """Each block of ``path`` read ``times`` times (the heat past the warm
    threshold, reported at the reader's close)."""
    r = await client.open(path)
    for _ in range(times):
        for lb in r.blocks.block_locs:
            await r.pread(lb.offset, 4096)
    await r.close()


def _jax_worker_conf(tmp_path, warm: bool) -> JaxConf:
    conf = JaxConf()
    conf.data_dir = str(tmp_path)
    if warm:
        conf.worker.tiers = [JaxTierConf(
            storage_type="ssd", dir=str(tmp_path / "ssd"),
            capacity=64 * MB)]
        conf.worker.shm_warm_cap_mb = 8
        conf.worker.shm_warm_min_reads = 3
    return conf


@contextlib.asynccontextmanager
async def _port_worker(tmp_path, warm: bool):
    """The JAX package's master alone, and the port's worker (shm on, a
    mem tier, or an SSD tier with a warm cache) registered with it."""
    async with MiniCluster(workers=0, lost_timeout_ms=30_000,
                           block_size=MB) as mc:
        conf = ClusterConf()
        conf.client.master_addrs = list(mc.conf.client.master_addrs)
        conf.client.block_size = MB
        wc = conf.worker
        wc.hostname, wc.rpc_port, wc.heartbeat_ms = "127.0.0.1", 0, 200
        wc.promote_interval_ms = 0
        kind = "ssd" if warm else "mem"
        wc.tiers = [TierConf(storage_type=kind, dir=str(tmp_path / kind),
                             capacity=64 * MB)]
        if warm:
            wc.shm_warm_cap_mb = 8
            wc.shm_warm_min_reads = 3
        w = port_server.WorkerServer(conf)
        await w.start()
        try:
            await mc.await_workers(1)
            yield mc, w
        finally:
            await w.stop()


async def _write(client, path: str, data: bytes, warm: bool) -> None:
    if warm:
        w = await client.create(path, storage_type="ssd")
        await w.write(data)
        await w.close()
    else:
        await client.write_all(path, data)


@pytest.mark.parametrize("warm", [False, True], ids=["mem", "warm"])
async def test_the_port_reader_maps_a_jax_workers_memfds(tmp_path, warm):
    data = _payload(1 + warm)
    async with MiniCluster(workers=1, conf=_jax_worker_conf(tmp_path, warm),
                           base_dir=str(tmp_path), block_size=MB) as mc:
        jc = mc.client()
        await _write(jc, "/x/j.bin", data, warm)
        pc = _port_client(mc.conf.client.master_addrs)
        try:
            if warm:
                await _heat(jc, "/x/j.bin", 4)
            want, jax_counts = await _reads(jc, "/x/j.bin")
            got, port_counts = await _reads(pc, "/x/j.bin")
        finally:
            await pc.close()
        assert got == want == [data[o:o + n] for o, n in READS]
        assert port_counts == jax_counts
        hits = "read.shm_warm_hits" if warm else "read.shm_hits"
        # one hit a block range read: the last read spans both blocks
        assert port_counts[hits] == len(READS) + 1
        grants = "shm.warm_grants" if warm else "shm.grants"
        assert mc.workers[0].metrics.counters.get(grants, 0) >= 2


@pytest.mark.parametrize("warm", [False, True], ids=["mem", "warm"])
async def test_the_jax_reader_maps_the_port_workers_memfds(tmp_path, warm):
    data = _payload(3 + warm)
    async with _port_worker(tmp_path, warm) as (mc, w):
        jc = _jax_client(mc.conf.client.master_addrs)
        pc = _port_client(mc.conf.client.master_addrs)
        try:
            await _write(pc, "/x/p.bin", data, warm)
            if warm:
                # the JAX reader's reports heat the port's worker, and its
                # reply's warm offer reaches the JAX reader
                await _heat(jc, "/x/p.bin", 4)
            want, port_counts = await _reads(pc, "/x/p.bin")
            got, jax_counts = await _reads(jc, "/x/p.bin")
        finally:
            await jc.close()
            await pc.close()
        assert got == want == [data[o:o + n] for o, n in READS]
        assert jax_counts == port_counts
        hits = "read.shm_warm_hits" if warm else "read.shm_hits"
        assert jax_counts[hits] == len(READS) + 1
        grants = "shm.warm_grants" if warm else "shm.grants"
        assert w.metrics.counters.get(grants, 0) >= 2
        assert w.metrics.counters.get("bytes.read", 0) == 0


def test_the_frames_are_the_reference_s():
    assert (pshm._REQ.format, pshm._REQ.size) == \
        (jshm._REQ.format, jshm._REQ.size) == ("<Q", 8)
    assert (pshm._REP.format, pshm._REP.size) == \
        (jshm._REP.format, jshm._REP.size) == ("<b7xQ", 16)
    assert (pshm.OK, pshm.NOT_FOUND, pshm.ERROR) == \
        (jshm.OK, jshm.NOT_FOUND, jshm.ERROR)
    for n in (0, 1, 2**40 + 7):
        assert pshm._REP.pack(pshm.OK, n) == jshm._REP.pack(jshm.OK, n)


@pytest.mark.parametrize("server,client", [(jshm, pshm), (pshm, jshm)],
                         ids=["jax_channel", "port_channel"])
async def test_each_fetch_reads_the_other_channel(tmp_path, server, client):
    data = os.urandom(12_345)
    fd = os.memfd_create("cv-parity")
    os.write(fd, data)

    def grant(block_id: int):
        if block_id != 11:
            raise LookupError(block_id)
        return fd, len(data)

    path = str(tmp_path / "ch.sock")
    ch = server.ShmChannel(path, grant)
    ch.start()
    try:
        got_fd, n = await asyncio.to_thread(client.fetch_block_fd, path, 11)
        assert n == len(data) and os.pread(got_fd, n, 0) == data
        os.close(got_fd)
        with pytest.raises(LookupError):
            await asyncio.to_thread(client.fetch_block_fd, path, 12)
    finally:
        ch.stop()
        os.close(fd)
