"""The shared-memory read plane of the port (``curvine_tpu_torch/worker/
shm.py``, the worker's offer and grant, the reader's mapping), on the
port's own master and workers (``tests/torch_cluster.py``).

Mirrors 13 of the 16 tests of ``tests/test_shm_reads.py``: those at :39,
:70, :92, :123, :160, :186, :211, :240, :328, :381, :405, :438 and
:461. The port's reader has no ``pread_view`` and no ``read_range`` yet
(ROADMAP §A item 2): its ``pread`` (a copy out of the mapping) stands
for ``pread_view``, and its ``mmap_view`` (a read-only view of the
mapping, no copy) for the single-block ``read_range``. The port counts
a mapping's bytes in ``sc.bytes.read`` and keeps ``read.zero_copy_bytes``
for READ_BLOCK's, so those asserts are left out, as are ``_served_by``
and the master's read-plane rollup (the metrics flush). The other three
wait for later items: :269 (``rpc/transport.py``), :512 (the metrics
flush) and :537 (the latency ladder). Beyond the mirrors: the four
fields load from a cluster file as the JAX package's do, and a memfd
handed without its seals is refused and read through the fd path."""

import asyncio
import contextlib
import dataclasses
import fcntl
import gc
import os

import numpy as np
import pytest

from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu_torch.common.conf import ClusterConf, TierConf
from curvine_tpu_torch.worker import shm as wshm

from torch_cluster import MB, PortCluster

pytestmark = pytest.mark.skipif(
    not wshm.shm_supported(),
    reason="memfd_create/SCM_RIGHTS not available on this platform")

SHM_FIELDS = ("shm_reads", "shm_export_cap", "shm_warm_cap_mb",
              "shm_warm_min_reads")


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


@contextlib.asynccontextmanager
async def _cluster(tmp_path, block_size: int = MB, tiers=None, **worker):
    """The port's master and one of its workers (``tiers``, or a mem tier
    of 64 MiB), the worker's conf fields ``worker`` set, blocks of
    ``block_size``: (the cluster, the worker)."""
    async with PortCluster(tmp_path, workers=0) as pc:
        pc.conf.client.block_size = block_size
        for k, v in worker.items():
            setattr(pc.conf.worker, k, v)
        w = await pc.add_worker(tiers=tiers)
        yield pc, w


def _ssd_tiers(tmp_path, with_mem: bool = False) -> list:
    """An SSD tier alone, so that no promotion moves the block from under
    the test; ``with_mem`` adds a MEM tier for the invalidation tests."""
    tiers = []
    if with_mem:
        tiers.append(TierConf(storage_type="mem", dir=str(tmp_path / "mem"),
                              capacity=64 * MB))
    tiers.append(TierConf(storage_type="ssd", dir=str(tmp_path / "ssd"),
                          capacity=64 * MB))
    return tiers


async def _write_ssd(c, path: str, payload: bytes) -> None:
    async with await c.create(path, storage_type="ssd") as w:
        await w.write(payload)


# ---------------- the hit path: no RPC on the data plane ----------------

async def test_shm_read_skips_rpc_data_plane(tmp_path):
    """Co-located MEM-tier reads are served from the sealed memfd's
    mapping: the hit counter moves, the worker's READ_BLOCK does not, and
    ``mmap_view`` gives a read-only view of the mapping."""
    async with _cluster(tmp_path) as (pc, w):
        c = pc.client()
        payload = os.urandom(MB + 4096)
        await c.write_all("/shm/a.bin", payload)
        r = await c.open("/shm/a.bin")
        for off in (0, 4096, MB - 4096, MB, MB + 100):
            got = await r.pread(off, 4096)
            assert bytes(got) == payload[off:off + 4096]
        assert c.counters.get("read.shm_hits", 0) >= 5
        assert w.metrics.counters.get("bytes.read", 0) == 0
        assert w.metrics.counters.get("shm.grants", 0) >= 1
        view = await r.mmap_view(8192, 4096)
        assert isinstance(view, np.ndarray)
        assert not view.flags.writeable
        assert bytes(view) == payload[8192:8192 + 4096]
        del view
        await r.close()


async def test_shm_disabled_capability_negotiation(tmp_path):
    """``shm_reads`` off: GET_BLOCK_INFO offers no shm, and the client
    serves the same bytes through the fd path, with no hit and no
    error."""
    async with _cluster(tmp_path, shm_reads=False) as (pc, w):
        assert w.shm is None
        c = pc.client()
        payload = os.urandom(64 * 1024)
        await c.write_all("/shm/off.bin", payload)
        r = await c.open("/shm/off.bin")
        got = await r.pread(1000, 5000)
        assert bytes(got) == payload[1000:6000]
        assert c.counters.get("read.shm_hits", 0) == 0
        assert not r._shm_sock and not r._shm_maps
        await r.close()


async def test_shm_fetch_failure_falls_back(tmp_path, monkeypatch):
    """A client whose side-channel fetch fails falls back to the fd path:
    the bytes stay right, the fallback is counted, and the block is not
    fetched again from the dead channel."""
    async with _cluster(tmp_path) as (pc, w):
        c = pc.client()
        payload = os.urandom(64 * 1024)
        await c.write_all("/shm/fb.bin", payload)

        def boom(sock_path, block_id, timeout=5.0):
            raise OSError("side channel unavailable")

        monkeypatch.setattr(wshm, "fetch_block_fd", boom)
        r = await c.open("/shm/fb.bin")
        got = await r.pread(0, 4096)
        assert bytes(got) == payload[:4096]
        assert c.counters.get("read.shm_fallbacks", 0) >= 1
        assert c.counters.get("read.shm_hits", 0) == 0
        bid = r.blocks.block_locs[0].block.id
        assert bid not in r._shm_sock
        await r.close()


# ---------------- resource discipline: LRU, leaks, close ----------------

async def test_shm_fd_lru_churn_no_leak(tmp_path):
    """Block turnover far past both caches (the client's map LRU and the
    worker's export LRU) does not grow the process's fd table: every
    eviction closes its memfd."""
    async with _cluster(tmp_path, block_size=64 * 1024,
                        shm_export_cap=4) as (pc, w):
        c = pc.client()
        n_blocks = 16
        payload = os.urandom(n_blocks * 64 * 1024)
        await c.write_all("/shm/churn.bin", payload)
        r = await c.open("/shm/churn.bin")
        r._SC_CACHE_CAP = 4          # shadow the class's bound

        async def churn(rounds: int) -> None:
            for i in range(rounds):
                off = (i % n_blocks) * 64 * 1024
                got = await r.pread(off, 4096)
                assert bytes(got) == payload[off:off + 4096]

        await churn(64)              # reach steady state
        gc.collect()
        base = _fd_count()
        await churn(640)             # 10x turnover across both LRUs
        gc.collect()
        assert _fd_count() <= base + 2, \
            "fd table grew under shm block churn (leaked memfd/mmap)"
        assert len(r._shm_maps) <= r._SC_CACHE_CAP
        assert len(w.shm) <= 4
        assert w.shm.evictions > 0
        await r.close()
        assert not r._shm_maps


async def test_shm_eviction_mid_read_keeps_view_valid(tmp_path):
    """A view handed to the caller outlives its mapping's eviction:
    ``_drop_shm`` tolerates the exported buffer, and the bytes stay right
    until the caller lets the view go."""
    async with _cluster(tmp_path) as (pc, w):
        c = pc.client()
        payload = os.urandom(MB)
        await c.write_all("/shm/evict.bin", payload)
        r = await c.open("/shm/evict.bin")
        view = await r.mmap_view(4096, 8192)
        assert bytes(view) == payload[4096:4096 + 8192]
        bid = r.blocks.block_locs[0].block.id
        assert bid in r._shm_maps
        r._drop_shm(bid)             # a concurrent eviction
        assert bid not in r._shm_maps
        assert bytes(view) == payload[4096:4096 + 8192]
        del view
        gc.collect()
        await r.close()


async def test_close_flushes_pending_sc_reads(tmp_path):
    """``close`` reports the read counts below the 512 batch and leaves
    no flush task and no mapping behind: the worker's promotion scan sees
    short sessions too."""
    async with _cluster(tmp_path) as (pc, w):
        c = pc.client()
        await c.write_all("/shm/heat.bin", os.urandom(MB))
        r = await c.open("/shm/heat.bin")
        bid = r.blocks.block_locs[0].block.id
        for i in range(20):          # well under the 512 threshold
            await r.pread(i * 4096, 4096)
        assert r._sc_reads, "reads were not counted for the flush"
        assert c.counters.get("read.shm_hits", 0) == 20
        h0 = w.store.get(bid, touch=False).heat
        await r.close()
        assert w.store.get(bid, touch=False).heat >= h0 + 20
        assert r._sc_flush_task is None and not r._sc_reads
        assert not r._shm_maps


# ---------------- unit: the exporter and the channel ----------------

async def test_shm_exporter_seals_and_lru(tmp_path):
    """``ShmExporter``: the memfd is sealed immutable, holds the block's
    bytes, and the LRU closes evicted fds."""
    blocks = {}
    for i in range(3):
        p = tmp_path / f"b{i}"
        p.write_bytes(bytes([i]) * 4096)
        blocks[i] = str(p)
    ex = wshm.ShmExporter(cap=2)
    try:
        fd0, n0 = ex.export(0, blocks[0], 4096)
        assert n0 == 4096
        seals = fcntl.fcntl(fd0, fcntl.F_GET_SEALS)
        assert seals & fcntl.F_SEAL_WRITE and seals & fcntl.F_SEAL_SEAL
        assert os.pread(fd0, 4096, 0) == b"\x00" * 4096
        with pytest.raises(OSError):
            os.pwrite(fd0, b"x", 0)          # sealed: immutable
        fd0b, _ = ex.export(0, blocks[0], 4096)
        assert fd0b == fd0 and ex.hits == 1  # a cache hit, the same fd
        ex.export(1, blocks[1], 4096)
        ex.export(2, blocks[2], 4096)        # evicts block 0 (LRU)
        assert len(ex) == 2 and ex.evictions == 1
        with pytest.raises(OSError):
            os.fstat(fd0)                    # the eviction closed it
    finally:
        ex.close()
    assert len(ex) == 0


async def test_shm_channel_fd_handoff(tmp_path):
    """``ShmChannel`` and ``fetch_block_fd``: the SCM_RIGHTS round trip
    dups a usable fd into the receiver; an unknown block raises
    LookupError."""
    data = os.urandom(8192)
    fd = os.memfd_create("cv-test")
    os.write(fd, data)

    def grant(block_id: int):
        if block_id != 7:
            raise LookupError(block_id)
        return fd, len(data)

    path = wshm.channel_path(os.getpid() % 60_000)
    ch = wshm.ShmChannel(path, grant)
    ch.start()
    try:
        got_fd, n = await asyncio.to_thread(wshm.fetch_block_fd, path, 7)
        assert n == len(data)
        assert got_fd != fd                  # a dup, not the original
        assert os.pread(got_fd, n, 0) == data
        os.close(got_fd)
        with pytest.raises(LookupError):
            await asyncio.to_thread(wshm.fetch_block_fd, path, 8)
    finally:
        ch.stop()
        os.close(fd)
    assert not os.path.exists(path)


# ---------------- the warm cache: reads below MEM ----------------

async def test_warm_shm_export_after_heat(tmp_path):
    """An SSD-tier block past ``shm_warm_min_reads`` earns a sealed memfd
    warm copy: a fresh reader's probe sees the ``shm_warm`` offer and
    serves reads from the mapping; the warm counters move, the worker's
    READ_BLOCK does not."""
    async with _cluster(tmp_path, tiers=_ssd_tiers(tmp_path),
                        shm_warm_cap_mb=8, shm_warm_min_reads=3) as (pc, w):
        c = pc.client()
        payload = os.urandom(MB)
        await _write_ssd(c, "/warm/a.bin", payload)
        # heat past the threshold; close flushes the SC_READ_REPORT rail
        r = await c.open("/warm/a.bin")
        bid = r.blocks.block_locs[0].block.id
        for i in range(5):
            await r.pread(i * 4096, 4096)
        await r.close()
        assert w.store.get(bid, touch=False).heat >= 5
        assert c.counters.get("read.shm_warm_hits", 0) == 0

        r2 = await c.open("/warm/a.bin")
        for off in (0, 4096, MB - 4096):
            got = await r2.pread(off, 4096)
            assert bytes(got) == payload[off:off + 4096]
        assert bid in r2._shm_warm
        assert c.counters.get("read.shm_warm_hits", 0) >= 3
        assert c.counters.get("read.shm_hits", 0) == 0
        assert w.metrics.counters.get("bytes.read", 0) == 0
        assert w.metrics.counters.get("shm.warm_grants", 0) >= 1
        assert bid in w.shm_warm
        assert w.shm_warm.stats()["exports"] == 1
        # a view of the same mapping, counted to the warm plane
        view = await r2.mmap_view(8192, 4096)
        assert isinstance(view, np.ndarray)
        assert not view.flags.writeable
        assert bytes(view) == payload[8192:8192 + 4096]
        assert c.counters.get("read.shm_warm_hits", 0) >= 4
        del view
        await r2.close()


async def test_warm_advert_rides_sc_report_reply(tmp_path):
    """The client whose reads made a block hot learns the warm offer from
    the SC_READ_REPORT reply (its probe came before the heat): after a
    flush the same reader maps the warm copy, with no new probe."""
    async with _cluster(tmp_path, tiers=_ssd_tiers(tmp_path),
                        shm_warm_cap_mb=8, shm_warm_min_reads=3) as (pc, w):
        c = pc.client()
        payload = os.urandom(MB)
        await _write_ssd(c, "/warm/b.bin", payload)
        r = await c.open("/warm/b.bin")
        bid = r.blocks.block_locs[0].block.id
        for i in range(6):           # heat accrues here, unflushed
            await r.pread(i * 4096, 4096)
        assert bid not in r._shm_warm
        await r._flush_sc_reads()    # the reply carries the warm offer
        assert bid in r._shm_warm and r._shm_sock.get(bid)
        got = await r.pread(0, 4096)
        assert bytes(got) == payload[:4096]
        assert c.counters.get("read.shm_warm_hits", 0) >= 1
        await r.close()


async def test_warm_copy_invalidated_on_promote(tmp_path):
    """A tier move drops the warm copy (the store's ``on_move``): the
    copy was admitted under the SSD tier's policy. Reads after the
    promotion stay right."""
    async with _cluster(tmp_path, tiers=_ssd_tiers(tmp_path, with_mem=True),
                        shm_warm_cap_mb=8, shm_warm_min_reads=2) as (pc, w):
        c = pc.client()
        payload = os.urandom(MB)
        await _write_ssd(c, "/warm/mv.bin", payload)
        r = await c.open("/warm/mv.bin")
        bid = r.blocks.block_locs[0].block.id
        for i in range(4):
            await r.pread(i * 4096, 4096)
        await r.close()
        r2 = await c.open("/warm/mv.bin")
        await r2.pread(0, 4096)      # maps the warm copy
        assert bid in w.shm_warm
        promoted = w.store.promote_scan(min_reads=0)
        assert bid in promoted
        assert bid not in w.shm_warm
        assert w.shm_warm.stats()["evictions"] == 0
        # the held mapping still serves (sealed pages outlive the fd); a
        # fresh reader reads the MEM tier's block
        got = await r2.pread(4096, 4096)
        assert bytes(got) == payload[4096:8192]
        await r2.close()
        r3 = await c.open("/warm/mv.bin")
        assert bytes(await r3.pread(0, 8192)) == payload[:8192]
        await r3.close()


async def test_warm_copy_invalidated_on_delete(tmp_path):
    """A deleted block leaves the warm cache too (``on_delete``): the
    worker's memfd closes and the entry leaves without a ghost."""
    async with _cluster(tmp_path, tiers=_ssd_tiers(tmp_path),
                        shm_warm_cap_mb=8, shm_warm_min_reads=2) as (pc, w):
        c = pc.client()
        await _write_ssd(c, "/warm/del.bin", os.urandom(MB))
        r = await c.open("/warm/del.bin")
        bid = r.blocks.block_locs[0].block.id
        for i in range(3):
            await r.pread(i * 4096, 4096)
        await r.close()
        r2 = await c.open("/warm/del.bin")
        await r2.pread(0, 4096)
        assert bid in w.shm_warm
        await r2.close()
        w.store.delete(bid)
        assert bid not in w.shm_warm
        assert w.shm_warm.stats()["bytes"] == 0


def test_warm_cache_unit_eviction_and_scan_resistance(tmp_path):
    """``WarmShmCache``: byte-bounded eviction through S3-FIFO (a one-touch
    scan leaves through probation, the re-touched working set stays), a
    caller's dup outlives the eviction, a block larger than the cache is
    refused, and ``invalidate`` is a plain removal."""
    blk = 4096
    paths = {}
    for i in range(12):
        p = tmp_path / f"w{i}"
        p.write_bytes(bytes([i]) * blk)
        paths[i] = str(p)
    cache = wshm.WarmShmCache(cap_bytes=4 * blk, admission="s3fifo")
    try:
        for h in (0, 1):             # the working set, each touched twice
            cache.export(h, paths[h], blk)
            cache.export(h, paths[h], blk)
        assert cache.hits == 2 and cache.exports == 2
        fd_scan, _ = cache.export(2, paths[2], blk)   # one touch
        dup = os.dup(fd_scan)                    # a client's dup
        try:
            for s in range(3, 12):
                cache.export(s, paths[s], blk)
            assert 0 in cache and 1 in cache
            assert 2 not in cache
            assert cache.evictions > 0
            assert cache.policy.scan_evicted > 0
            assert cache.stats()["bytes"] <= 4 * blk
            with pytest.raises(OSError):
                os.fstat(fd_scan)            # the worker's fd is closed
            assert os.pread(dup, blk, 0) == bytes([2]) * blk
        finally:
            os.close(dup)
        with pytest.raises(LookupError):
            cache.export(99, paths[0], 5 * blk)
        ev = cache.evictions
        assert 0 in cache
        cache.invalidate(0)
        assert 0 not in cache and cache.evictions == ev
    finally:
        cache.close()
    assert len(cache) == 0 and cache.stats()["bytes"] == 0


# ---------------- beyond the mirrors ----------------

def test_the_shm_fields_load_as_the_jax_package_loads_them(tmp_path):
    """The four fields are the reference's, at its defaults, and a file's
    second values load alike in both packages."""
    port, jax = ClusterConf().worker, JaxConf().worker
    assert [getattr(port, k) for k in SHM_FIELDS] == \
        [getattr(jax, k) for k in SHM_FIELDS] == [True, 128, 64, 3]
    p = tmp_path / "c.toml"
    p.write_text("[worker]\nshm_reads = false\nshm_export_cap = 4\n"
                 "shm_warm_cap_mb = 8\nshm_warm_min_reads = 2\n")
    got = dataclasses.asdict(ClusterConf.load(str(p)).worker)
    want = dataclasses.asdict(JaxConf.load(str(p)).worker)
    assert [got[k] for k in SHM_FIELDS] == [want[k] for k in SHM_FIELDS] \
        == [False, 4, 8, 2]


async def test_an_unsealed_memfd_is_refused(tmp_path, monkeypatch):
    """A grant of a memfd that lacks its seals is never mapped: the read
    counts a fallback and is served right by the fd path."""
    async with _cluster(tmp_path) as (pc, w):
        c = pc.client()
        payload = os.urandom(64 * 1024)
        await c.write_all("/shm/unsealed.bin", payload)

        def unsealed(block_id: int):
            info = w.store.get_copy(block_id)
            fd = os.memfd_create("cv-unsealed")
            with open(info.path, "rb") as f:
                os.write(fd, f.read())
            return fd, info.len

        monkeypatch.setattr(w._shm_channel, "grant", unsealed)
        r = await c.open("/shm/unsealed.bin")
        got = await r.pread(0, 4096)
        assert bytes(got) == payload[:4096]
        assert c.counters.get("read.shm_fallbacks", 0) == 1
        assert c.counters.get("read.shm_hits", 0) == 0
        assert not r._shm_maps
        await r.close()
