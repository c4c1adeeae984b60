"""Port parity: the port client's short-circuit write (SC_WRITE_OPEN,
SC_WRITE_COMMIT, SC_WRITE_ABORT) and its READ_BLOCK into the caller's
buffer (``Connection.call_readinto``), against the JAX package's worker
on the CPU.

Each test starts a one-worker ``MiniCluster`` (``lost_timeout_ms=
30_000``, as ``tests/test_torch_client.py`` does). Bytes the port writes
by short circuit read back equal through the JAX client and the port's;
the counters say which path carried them: ``sc.bytes.written`` and
``write.bytes`` (all bytes), ``sc.write.fallbacks`` (blocks sent over
WRITE_BLOCK with the short circuit on), ``read.zero_copy_bytes``
(READ_BLOCK) and ``sc.bytes.read``."""

import os

import numpy as np
import pytest

from curvine_tpu.common.conf import ClusterConf as JaxConf, TierConf
from curvine_tpu.testing import MiniCluster
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common import errors as perr
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.worker.blockfile import crc_update

MiB = 1 << 20
BLOCK = 4 * MiB                  # MiniCluster's block size


def _cluster(**kw):
    return MiniCluster(workers=1, lost_timeout_ms=30_000, **kw)


def _port_client(mc, **client) -> CurvineClient:
    conf = ClusterConf()
    conf.client.master_addrs = list(mc.conf.client.master_addrs)
    conf.client.block_size = mc.conf.client.block_size
    for k, v in client.items():
        setattr(conf.client, k, v)
    return CurvineClient(conf)


def _data(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


async def _write_in_pieces(pc, path: str, data: bytes) -> None:
    """Writes of uneven sizes, some across a block boundary."""
    async with await pc.create(path, overwrite=True) as w:
        view = memoryview(data)
        for n in (1, MiB + 3, 3 * MiB, len(data)):
            await w.write(view[:n])
            view = view[n:]


async def _blocks(client, path: str):
    fb = await client.meta.get_block_locations(path)
    return [lb.block for lb in fb.block_locs]


@pytest.mark.parametrize("size", [1, BLOCK - 1, BLOCK, 2 * BLOCK + 12345])
async def test_short_circuit_write_reads_back_through_both_clients(size):
    data = _data(size, size)
    async with _cluster() as mc:
        jc = mc.client()
        pc = _port_client(mc)
        try:
            await _write_in_pieces(pc, "/sc/a.bin", data)
            assert pc.counters["sc.bytes.written"] == \
                pc.counters["write.bytes"] == size
            assert "sc.write.fallbacks" not in pc.counters
            assert await jc.read_all("/sc/a.bin") == data
            assert await pc.read_all("/sc/a.bin") == data
            assert pc.counters["sc.bytes.read"] == size
            # the worker keeps the crc the writer chained, and serves it
            store = mc.workers[0].store
            blocks = await _blocks(jc, "/sc/a.bin")
            assert sum(b.len for b in blocks) == size
            off = 0
            for b in blocks:
                info = store.get(b.id, touch=False)
                assert info.crc32c == crc_update(
                    "crc32c", data[off:off + b.len])
                off += b.len
            st = await pc.meta.file_status("/sc/a.bin")
            assert st.len == size and st.is_complete
        finally:
            await pc.close()


async def test_short_circuit_off_writes_over_write_block():
    data = _data(2 * BLOCK + 5, 1)
    async with _cluster() as mc:
        pc = _port_client(mc, short_circuit=False)
        sc = _port_client(mc)
        try:
            await _write_in_pieces(pc, "/sc/rb.bin", data)
            await _write_in_pieces(sc, "/sc/sc.bin", data)
            assert pc.counters["write.bytes"] == len(data)
            assert "sc.bytes.written" not in pc.counters
            assert "sc.write.fallbacks" not in pc.counters
            jc = mc.client()
            assert await jc.read_all("/sc/rb.bin") == data
            assert await jc.read_all("/sc/sc.bin") == data
            # the same blocks either way: lengths and crcs
            store = mc.workers[0].store
            a = await _blocks(jc, "/sc/rb.bin")
            b = await _blocks(jc, "/sc/sc.bin")
            assert [x.len for x in a] == [x.len for x in b]
            assert [store.get(x.id, touch=False).crc32c for x in a] == \
                [store.get(x.id, touch=False).crc32c for x in b]
        finally:
            await pc.close()
            await sc.close()


async def test_a_location_off_this_host_falls_back_and_is_counted():
    data = _data(BLOCK + 7, 2)
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            pc.meta.is_local = lambda loc: False
            await pc.write_all("/sc/far.bin", data)
            assert pc.counters["sc.write.fallbacks"] == 2
            assert "sc.bytes.written" not in pc.counters
            assert pc.counters["write.bytes"] == len(data)
            assert await mc.client().read_all("/sc/far.bin") == data
        finally:
            await pc.close()


async def test_a_refused_grant_falls_back_and_is_counted(tmp_path):
    """A worker whose tier is a bdev file (extents in one backing file)
    refuses SC_WRITE_OPEN; every block then goes over WRITE_BLOCK, and
    reads of its leased extents over READ_BLOCK."""
    conf = JaxConf()
    conf.worker.tiers = [TierConf(storage_type="mem",
                                  dir=str(tmp_path / "bdev.img"),
                                  capacity=64 * MiB, layout="bdev")]
    data = _data(2 * BLOCK + 99, 3)
    async with _cluster(conf=conf) as mc:
        pc = _port_client(mc)
        try:
            await pc.write_all("/sc/bdev.bin", data)
            assert pc.counters["sc.write.fallbacks"] == 3
            assert "sc.bytes.written" not in pc.counters
            assert await mc.client().read_all("/sc/bdev.bin") == data
            assert await pc.read_all("/sc/bdev.bin") == data
            assert pc.counters["read.zero_copy_bytes"] == len(data)
        finally:
            await pc.close()


async def test_abort_leaves_no_block_file():
    data = _data(BLOCK + MiB, 4)
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            w = await pc.create("/sc/ab.bin")
            await w.write(data)              # one block sealed, one open
            bid = w._block.block.id
            temp = w._sc_file.name
            assert os.path.exists(temp)
            store = mc.workers[0].store
            assert store.contains(bid)
            await w.abort()
            assert not os.path.exists(temp)
            assert not store.contains(bid)
            assert w._sc_conn is None and w._sc_file is None
            with pytest.raises(perr.InvalidArgument):
                await w.write(b"x")
            # a later writer of the same client is unaffected
            await pc.write_all("/sc/ab2.bin", data)
            assert await mc.client().read_all("/sc/ab2.bin") == data
        finally:
            await pc.close()


async def test_read_block_lands_in_the_callers_buffer(monkeypatch):
    """READ_BLOCK through ``call_readinto``: whole files and ranges equal,
    counted as ``read.zero_copy_bytes``; a chunk's payload goes into the
    caller's buffer, at most the decoder's buffer's worth of it copied out
    of the connection's receive buffer and the rest received straight
    into it, and none through the decoder's own payload reads; the EOF
    trailer carries the block's crc; a sink shorter than the stream is
    filled to its end."""
    from curvine_tpu_torch.rpc import transport
    taken, copied, direct = [], [], []
    real_read_payload = transport.BulkDecoder.read_payload
    real_take_into = transport.BulkDecoder.take_into
    real_recv_sink = transport.BulkDecoder.recv_sink

    async def read_payload(self, loop, sock, n):
        taken.append(n)
        return await real_read_payload(self, loop, sock, n)

    def take_into(self, dst):
        n = real_take_into(self, dst)
        copied.append((n, len(self._buf)))
        return n

    async def recv_sink(self, loop, sock, view, live=None):
        direct.append(len(view))
        return await real_recv_sink(self, loop, sock, view, live)

    monkeypatch.setattr(transport.BulkDecoder, "read_payload", read_payload)
    monkeypatch.setattr(transport.BulkDecoder, "take_into", take_into)
    monkeypatch.setattr(transport.BulkDecoder, "recv_sink", recv_sink)
    data = _data(2 * BLOCK + 4321, 5)
    async with _cluster() as mc:
        await mc.client().write_all("/rb/x.bin", data)
        pc = _port_client(mc, short_circuit=False)
        try:
            assert await pc.read_all("/rb/x.bin") == data
            # only other replies' small payloads through read_payload; each
            # chunk's buffered copy within the receive buffer, whose size
            # stays the default; most bytes received straight into the sink
            assert not taken or max(taken) < 4096
            assert copied and all(n <= size == transport.RECV_BUFFER_BYTES
                                  for n, size in copied)
            assert sum(n for n, _ in copied) + sum(direct) == len(data)
            assert sum(direct) > 0.8 * len(data)
            r = await pc.open("/rb/x.bin")
            assert await r.pread(BLOCK - 10, 30) == data[BLOCK - 10:BLOCK + 20]
            r.seek(3)
            assert await r.read(5) == data[3:8] and r.pos == 8
            assert await r.pread(len(data) - 2, 100) == data[-2:]
            lb = r.blocks.block_locs[1]
            conn = await pc.pool.get(r._addr(lb.locs[0]))
            for sink_len in (lb.block.len, lb.block.len - 10):
                buf = bytearray(sink_len)
                eof: dict = {}
                got = await conn.call_readinto(
                    RpcCode.READ_BLOCK, memoryview(buf), header={
                        "block_id": lb.block.id, "offset": 0,
                        "len": lb.block.len, "chunk_size": 256 * 1024},
                    eof_header=eof)
                assert got == sink_len
                assert buf == data[BLOCK:BLOCK + sink_len]
                assert eof["block_crc32"] == crc_update(
                    eof["block_crc_algo"], data[BLOCK:2 * BLOCK])
            await r.close()
            assert pc.counters["read.zero_copy_bytes"] == \
                len(data) + 30 + 5 + 2
            assert "sc.bytes.read" not in pc.counters
        finally:
            await pc.close()


async def test_read_block_catches_a_bit_flip():
    data = _data(3 * MiB, 6)
    async with _cluster() as mc:
        pc = _port_client(mc, short_circuit=False)
        try:
            await _port_client(mc).write_all("/rb/c.bin", data)
            r = await pc.open("/rb/c.bin")
            info = mc.workers[0].store.get(r.blocks.block_locs[0].block.id)
            with open(info.path, "r+b") as f:
                f.seek(12345)
                b = f.read(1)
                f.seek(12345)
                f.write(bytes([b[0] ^ 1]))
            with pytest.raises(perr.AbnormalData):
                await r.read_all()
            # the one replica fails, the refreshed locations name it
            # again and it fails again: two mismatches, as the
            # reference's reader counts
            assert pc.counters["read.checksum_mismatch"] == 2
            assert "read.zero_copy_bytes" not in pc.counters
            await r.close()
        finally:
            await pc.close()
