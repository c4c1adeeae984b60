"""The port reader's read-ahead (``curvine_tpu_torch/client/reader.py``):
the sequential-read detector, the prefetch window of positional reads,
``pread_view``, parallel ``read_range`` and ``chunks``' read-ahead, on the
port's own master and workers (``tests/torch_cluster.py``).

Mirrors 7 of the 10 tests of ``tests/test_read_path.py``: the detector's
four (:19, :27, :39, :49), :57, :84 and :114. The other three, :144,
:183 and :206, read holes, which wait for RESIZE_FILE (ROADMAP §A item
4). Beyond the mirrors: ``chunks`` keeps ``read_ahead`` reads in flight
and cancels them when its consumer stops early, and ``UfsReader``'s
``pread_view``, ``read_range`` and ``chunks`` give ``read_all``'s bytes."""

import asyncio
import os
import random

import numpy as np
import pytest

from curvine_tpu_torch.client.reader import FsReader, ReadDetector
from curvine_tpu_torch.client.ufs_reader import UfsReader
from curvine_tpu_torch.ufs.memory import MemoryUfs

from torch_cluster import MB, PortCluster


# ---------------- the detector ----------------

def test_detector_pure_sequential():
    d = ReadDetector(threshold=3)
    assert d.sequential                     # sequential by default
    for i in range(5):
        d.record_read(i * 100, (i + 1) * 100)
        assert d.sequential


def test_detector_seek_flips_random_then_threshold_restores():
    d = ReadDetector(threshold=3)
    d.record_read(0, 100)
    d.record_seek()
    assert not d.sequential                 # a seek: random at once
    d.record_read(1000, 1100)
    d.record_read(1100, 1200)
    assert not d.sequential                 # below the threshold
    d.record_read(1200, 1300)
    assert d.sequential                     # threshold contiguous reads


def test_detector_single_jump_keeps_pattern_double_jump_flips():
    d = ReadDetector(threshold=3)
    d.record_read(0, 100)
    d.record_read(100, 200)
    d.record_read(500, 600)                 # one jump: unchanged
    assert d.sequential
    d.record_read(900, 1000)                # a second jump in a row
    assert not d.sequential


def test_detector_disabled_is_inert():
    d = ReadDetector(threshold=1, enabled=False)
    d.record_seek()
    assert d.sequential


# ---------------- on a cluster of the port ----------------

async def test_locate_bisect_and_parallel_range(tmp_path):
    """Positional reads at offsets across a six-block file, and
    ``read_range`` in parallel slices, give the file's bytes."""
    async with PortCluster(tmp_path) as pc:
        pc.conf.client.block_size = MB
        c = pc.client()
        payload = os.urandom(5 * MB + 12345)       # 6 blocks
        await c.write_all("/rp/big.bin", payload)
        r = await c.open("/rp/big.bin")
        for off in (0, MB - 1, MB, 3 * MB + 7, 5 * MB + 12344,
                    5 * MB + 12345, 2 * MB):
            n = 64 * 1024
            got = bytes(await r.pread_view(off, n))
            assert got == payload[off:off + n], f"offset {off}"
        buf = await r.read_range(0, r.len, parallel=4)
        assert bytes(buf) == payload
        buf = await r.read_range(MB // 2, 3 * MB, parallel=3)
        assert bytes(buf) == payload[MB // 2:MB // 2 + 3 * MB]
        await r.close()


async def test_positional_prefetch_remote(tmp_path):
    """Short circuit off (every read remote): a sequential scan in 128 KiB
    positional reads is served from the prefetch window; random reads
    stop it."""
    async with PortCluster(tmp_path) as pc:
        pc.conf.client.block_size = MB
        pc.conf.client.short_circuit = False
        pc.conf.client.read_chunk_size = 256 * 1024
        c = pc.client()
        payload = os.urandom(3 * MB)
        await c.write_all("/rp/seq.bin", payload)
        r = await c.open("/rp/seq.bin")
        step = 128 * 1024
        out = bytearray()
        for off in range(0, len(payload), step):
            out += bytes(await r.pread_view(off, step))
        assert bytes(out) == payload
        assert r.counters.get("pf.bytes.read", 0) > 0, \
            "a sequential scan should be served from the prefetch window"
        assert r.detector.sequential
        for off in (2 * MB, 128, MB + 77, 2 * MB + 999):
            assert bytes(await r.pread_view(off, 64)) == \
                payload[off:off + 64]
        assert not r.detector.sequential
        assert "sc.bytes.read" not in r.counters
        await r.close()
        assert not r._pf and not r._pf_order


async def test_prefetch_correct_after_pattern_flips(tmp_path):
    """Random probes between sequential runs never corrupt a read: the
    window's segments are keyed by their aligned offsets."""
    async with PortCluster(tmp_path) as pc:
        pc.conf.client.block_size = MB
        pc.conf.client.short_circuit = False
        pc.conf.client.read_chunk_size = 128 * 1024
        c = pc.client()
        payload = os.urandom(2 * MB)
        await c.write_all("/rp/mix.bin", payload)
        r = await c.open("/rp/mix.bin")
        rng = random.Random(7)
        pos = 0
        for _ in range(60):
            if rng.random() < 0.7:
                n = 64 * 1024
                assert bytes(await r.pread_view(pos, n)) == \
                    payload[pos:pos + n]
                pos = min(pos + n, len(payload) - 1)
            else:
                off = rng.randrange(0, len(payload) - 4096)
                assert bytes(await r.pread_view(off, 4096)) == \
                    payload[off:off + 4096]
        await r.close()


async def test_cancel_while_waiting_on_a_segment_propagates(tmp_path):
    """A ``pread_view`` cancelled while it awaits a window segment raises
    ``CancelledError``: the caller's cancel is not taken for the
    segment's failure and served by a direct read."""
    async with PortCluster(tmp_path) as pc:
        pc.conf.client.block_size = MB
        pc.conf.client.short_circuit = False
        pc.conf.client.read_chunk_size = 256 * 1024
        c = pc.client()
        payload = os.urandom(2 * MB)
        await c.write_all("/rp/cancel.bin", payload)
        r = await c.open("/rp/cancel.bin")
        gate = asyncio.Event()

        async def held(s, seg_len):
            await gate.wait()              # a segment that never lands
        r._fetch_seg = held
        seg = 256 * 1024
        assert bytes(await r.pread_view(0, seg)) == payload[:seg]
        assert seg in r._pf                # the next segment is in flight
        t = asyncio.ensure_future(r.pread_view(seg, seg))
        await asyncio.sleep(0.05)
        assert not t.done()
        t.cancel()
        with pytest.raises(asyncio.CancelledError):
            await t
        assert "pf.bytes.read" not in r.counters
        # the reader stays usable: the next read takes the direct path
        assert bytes(await r.pread_view(seg, 64)) == payload[seg:seg + 64]
        await r.close()
        assert not r._pf and not r._pf_order


async def test_chunks_reads_ahead_and_cancels_on_early_exit(tmp_path):
    """``chunks`` keeps ``read_ahead`` reads in flight ahead of its
    consumer, gives the file's bytes in order, and cancels the reads
    still in flight when the consumer stops early."""
    async with PortCluster(tmp_path) as pc:
        pc.conf.client.block_size = MB
        pc.conf.client.short_circuit = False
        pc.conf.client.read_ahead_chunks = 3
        c = pc.client()
        payload = os.urandom(10 * 256 * 1024 + 77)
        await c.write_all("/rp/ch.bin", payload)
        r = await c.open("/rp/ch.bin")
        assert r.read_ahead == 3
        started, finished, cancelled = [], [], []
        real = FsReader._pread_bytes
        slow = []

        async def traced(self, offset, n):
            started.append(offset)
            try:
                if slow and offset:
                    await asyncio.sleep(10)     # still in flight at the exit
                out = await real(self, offset, n)
            except asyncio.CancelledError:
                cancelled.append(offset)
                raise
            finished.append(offset)
            return out

        r._pread_bytes = traced.__get__(r)
        got = bytearray()
        ahead = []
        total = -(-len(payload) // (256 * 1024))
        async for chunk in r.chunks(256 * 1024):
            await asyncio.sleep(0)          # the reads just scheduled start
            got += chunk
            # reads started past the chunks consumed so far
            ahead.append(len(started) - -(-len(got) // (256 * 1024)))
        assert bytes(got) == payload and r.pos == len(payload)
        assert ahead == [min(3, total - k - 1) for k in range(total)]

        started.clear()
        finished.clear()
        slow.append(True)
        gen = r.chunks(256 * 1024)
        first = await anext(gen)
        assert bytes(first) == payload[:256 * 1024]
        await asyncio.sleep(0)
        in_flight = set(started) - set(finished)
        assert in_flight == {k * 256 * 1024 for k in (1, 2, 3)}
        await gen.aclose()
        assert set(cancelled) == in_flight, \
            "the reads in flight at the exit were not cancelled"
        await r.close()


async def test_ufs_reader_views_equal_read_all():
    """``UfsReader``'s ``pread_view``, ``read_range`` and ``chunks`` give
    the object's bytes, as ``read_all`` does."""
    ufs = MemoryUfs()
    data = np.random.default_rng(3).integers(0, 256, 3 * MB + 5,
                                             dtype=np.uint8).tobytes()
    async def one():
        yield data

    await ufs.write("mem://b/obj", one())
    r = UfsReader(ufs, "mem://b/obj", len(data), chunk_size=MB)
    whole = await r.read_all()
    assert whole == data
    assert bytes(await r.pread_view(0, len(data))) == whole
    assert bytes(await r.pread_view(MB - 3, 100)) == whole[MB - 3:MB + 97]
    assert bytes(await r.read_range(7, 2 * MB, parallel=4)) == \
        whole[7:7 + 2 * MB]
    got = [bytes(c) async for c in r.chunks()]
    assert b"".join(got) == whole and r.pos == len(data)
    assert [len(c) for c in got] == [MB, MB, MB, 5]
    await r.close()
