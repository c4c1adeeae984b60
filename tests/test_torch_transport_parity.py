"""The wire transport and the reader's read-ahead across the two
packages, on the CPU.

- The port's ``Connection`` against the JAX package's ``RpcServer``, and
  the JAX package's ``Connection`` against the port's ``RpcServer``: 200
  concurrent small calls sent as coalesced batches, a ``call_readinto``
  of many chunks, and a chunk stream with unary calls between its
  frames on the same connection. Every header and payload comes back
  equal, and the frames themselves are the same bytes in both packages.
- The port's reader against a JAX-package ``MiniCluster`` with the short
  circuit off: ``pread_view`` in sequential steps, ``read_range`` in
  three slices and ``chunks`` give the JAX reader's bytes for the same
  calls, and both serve part of the scan out of their prefetch windows.
- ``ReadDetector`` fed the same seeded reads and seeks as the
  reference's says ``sequential`` alike after each."""

import asyncio
import zlib

import numpy as np

from curvine_tpu.client import CurvineClient as JaxClient
from curvine_tpu.client.reader import ReadDetector as JaxDetector
from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu.common.metrics import MetricsRegistry as JaxMetrics
from curvine_tpu.rpc import RpcServer as JaxServer
from curvine_tpu.rpc import frame as jframe
from curvine_tpu.rpc.client import Connection as JaxConnection
from curvine_tpu.testing import MiniCluster
from curvine_tpu_torch.client.reader import ReadDetector
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.metrics import MetricsRegistry
from curvine_tpu_torch.rpc import frame as pframe
from curvine_tpu_torch.rpc.client import Connection
from curvine_tpu_torch.rpc.server import RpcServer

MB = 1 << 20
ECHO, STREAM = 9_900, 9_901
CALLS = 200


def _bodies(seed: int) -> list[bytes]:
    """The calls' bodies: empty, small, and some past the writers'
    8 KiB inline limit (each its own iovec entry)."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice([0, 17, 600, 4096, 9000, 20_000], CALLS)
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in sizes]


def _chunk(i: int) -> bytes:
    return bytes([i % 251]) * (1000 + 37 * i)


def _register(srv, message_cls, flags) -> None:
    """The same two handlers on either package's server: ECHO answers the
    request's header, length and crc with its body; STREAM sends
    ``n`` CHUNK frames and an EOF whose header carries the total."""
    async def echo(msg, conn):
        return {"hdr": dict(msg.header), "len": len(msg.data),
                "crc": zlib.crc32(bytes(msg.data))}, bytes(msg.data)

    async def stream(msg, conn):
        n = int(msg.header["n"])
        for i in range(n):
            await conn.send(message_cls(
                code=msg.code, req_id=msg.req_id,
                flags=flags.RESPONSE | flags.CHUNK, data=_chunk(i)))
            await asyncio.sleep(0)            # let unary replies in between
        await conn.send(message_cls(
            code=msg.code, req_id=msg.req_id,
            flags=flags.RESPONSE | flags.EOF,
            header={"total": sum(len(_chunk(i)) for i in range(n))}))

    srv.register(ECHO, echo)
    srv.register(STREAM, stream)


async def _coalesced(conn, calls) -> list:
    """``calls`` (coroutine factories) started while the connection's
    writer holds the wire, so that their frames queue and leave in
    batches; their results."""
    async with conn._writer._io_lock:
        tasks = [asyncio.ensure_future(c()) for c in calls]
        await asyncio.sleep(0)
        assert conn._writer.qsize() == len(calls)
    return await asyncio.gather(*tasks)


async def _stream_with_calls(readinto, call, n: int) -> tuple[bytes, dict]:
    """A STREAM of ``n`` chunks into a sink while unary calls run on the
    same connection; the sink's bytes and the EOF's header."""
    total = sum(len(_chunk(i)) for i in range(n))
    sink = bytearray(total)
    eof: dict = {}

    async def storm():
        for i in range(24):
            rep = await call(str(i).encode() * 50)
            assert rep.data == str(i).encode() * 50
    t = asyncio.ensure_future(storm())
    got = await readinto(memoryview(sink), eof)
    await t
    assert got == total
    return bytes(sink), eof


async def test_port_connection_against_jax_server():
    srv = JaxServer("127.0.0.1", 0, "jax")
    srv.metrics = JaxMetrics("jax")
    _register(srv, jframe.Message, jframe.Flags)
    await srv.start()
    m = MetricsRegistry("port")
    conn = await Connection(f"127.0.0.1:{srv.port}", metrics=m).connect()
    try:
        bodies = _bodies(1)
        reps = await _coalesced(conn, [
            (lambda b=b: conn.call(ECHO, data=b)) for b in bodies])
        for b, rep in zip(bodies, reps):
            assert rep.header == {"hdr": {}, "len": len(b),
                                  "crc": zlib.crc32(b)}
            assert bytes(rep.data) == b
        assert m.histograms["rpc.send_batch_frames"].max > 1
        assert srv.metrics.counters["rpc.bytes_recv"] >= \
            sum(len(b) for b in bodies)

        n = 40
        want = b"".join(_chunk(i) for i in range(n))
        sink, eof = await _stream_with_calls(
            lambda v, e: conn.call_readinto(STREAM, v, {"n": n},
                                            eof_header=e),
            lambda d: conn.call(ECHO, data=d), n)
        assert sink == want and eof == {"total": len(want)}
    finally:
        await conn.close()
        await srv.stop()


async def test_jax_connection_against_port_server():
    m = MetricsRegistry("port")
    srv = RpcServer("127.0.0.1", 0, "port")
    srv.metrics = m
    _register(srv, pframe.Message, pframe.Flags)
    await srv.start()
    jm = JaxMetrics("jax")
    conn = await JaxConnection(f"127.0.0.1:{srv.port}",
                               metrics=jm).connect()
    try:
        bodies = _bodies(2)
        headers = [{"i": i, "pad": "x" * (i % 7 * 40)} for i in range(CALLS)]
        reps = await _coalesced(conn, [
            (lambda h=h, b=b: conn.call(ECHO, h, data=b))
            for h, b in zip(headers, bodies)])
        for h, b, rep in zip(headers, bodies, reps):
            assert rep.header == {"hdr": h, "len": len(b),
                                  "crc": zlib.crc32(b)}
            assert bytes(rep.data) == b
        assert jm.histograms["rpc.send_batch_frames"].max > 1
        assert m.counters["rpc.bytes_recv"] >= sum(len(b) for b in bodies)

        n = 40
        want = b"".join(_chunk(i) for i in range(n))
        sink, eof = await _stream_with_calls(
            lambda v, e: conn.call_readinto(STREAM, v, header={"n": n},
                                            eof_header=e),
            lambda d: conn.call(ECHO, {}, data=d), n)
        assert sink == want and eof == {"total": len(want)}
    finally:
        await conn.close()
        await srv.stop()


def test_frames_encode_and_decode_alike():
    """``encode_into`` and ``decode_envelope`` give the same bytes and the
    same envelopes in both packages, at inline limits on either side of
    each payload."""
    rng = np.random.default_rng(5)
    for i in range(40):
        header = {"i": i, "s": "y" * int(rng.integers(0, 300))} \
            if i % 3 else {}
        data = rng.integers(0, 256, int(rng.integers(0, 20_000)),
                            dtype=np.uint8).tobytes()
        kw = dict(code=int(rng.integers(1, 200)), req_id=i, status=i % 2,
                  flags=int(rng.integers(0, 8)), header=header, data=data)
        for inline in (0, 8 * 1024, 64 * 1024):
            outs = []
            for mod in (pframe, jframe):
                out = bytearray()
                big = mod.Message(**kw).encode_into(out, inline)
                outs.append((bytes(out), None if big is None
                             else bytes(big)))
            assert outs[0] == outs[1]
            wire = outs[0][0] + (outs[0][1] or b"")
            for cut in (len(wire), len(wire) - len(data), 3):
                assert pframe.decode_envelope(wire, 0, cut) == \
                    jframe.decode_envelope(wire, 0, cut)


async def test_port_reader_against_jax_cluster(tmp_path):
    conf = JaxConf()
    conf.data_dir = str(tmp_path)
    conf.client.short_circuit = False
    conf.client.read_chunk_size = 256 * 1024
    async with MiniCluster(workers=1, conf=conf, block_size=MB,
                           lost_timeout_ms=30_000) as mc:
        payload = np.random.default_rng(9).integers(
            0, 256, 3 * MB + 12_345, dtype=np.uint8).tobytes()
        jc = mc.client()
        await jc.write_all("/tp/x.bin", payload)
        pconf = ClusterConf()
        pconf.client.master_addrs = list(mc.conf.client.master_addrs)
        pconf.client.block_size = MB
        pconf.client.short_circuit = False
        pconf.client.read_chunk_size = 256 * 1024
        pc = CurvineClient(pconf)
        jx = JaxClient(mc.conf)
        try:
            got = {}
            for name, c in (("port", pc), ("jax", jx)):
                r = await c.open("/tp/x.bin")
                seq = b"".join([bytes(await r.pread_view(off, 128 * 1024))
                                for off in range(0, r.len, 128 * 1024)])
                ranges = [bytes(await r.read_range(off, n, parallel=3))
                          for off, n in ((0, r.len), (MB // 3, 2 * MB + 5),
                                         (MB - 1, 2))]
                chunks = [bytes(x) async for x in r.chunks(300_000)]
                got[name] = (seq, ranges, chunks,
                             r.counters.get("pf.bytes.read", 0),
                             r.counters.get("sc.bytes.read", 0))
                await r.close()
            assert got["port"][:3] == got["jax"][:3]
            seq, ranges, chunks, pf, sc = got["port"]
            assert seq == payload and b"".join(chunks) == payload
            assert ranges[0] == payload
            assert ranges[1] == payload[MB // 3:MB // 3 + 2 * MB + 5]
            assert pf > 0 and got["jax"][3] > 0
            assert sc == 0 and got["jax"][4] == 0
        finally:
            await pc.close()
            await jx.close()


def test_detector_parity_on_seeded_reads():
    rng = np.random.default_rng(11)
    for threshold in (1, 2, 3, 5):
        for enabled in (True, False):
            ref, port = JaxDetector(threshold, enabled), \
                ReadDetector(threshold, enabled)
            pos = 0
            for _ in range(400):
                op = rng.random()
                if op < 0.05:
                    ref.record_seek()
                    port.record_seek()
                else:
                    if op < 0.6:
                        start = pos                     # contiguous
                    else:
                        start = int(rng.integers(0, 1 << 20))
                    n = int(rng.integers(1, 65_536))
                    ref.record_read(start, start + n)
                    port.record_read(start, start + n)
                    pos = start + n
                assert port.sequential == ref.sequential
                assert (port.seq_count, port.last_pos) == \
                    (ref.seq_count, ref.last_pos)
