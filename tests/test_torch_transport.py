"""The port's wire transport (``curvine_tpu_torch/rpc/transport.py``,
``frame.encode_into`` and ``frame.decode_envelope``) and the RPC client
and server on it, on the CPU.

Mirrors 15 of the 21 tests of ``tests/test_transport.py``: those at :56,
:76, :96, :113, :149, :176, :205, :222, :255, :291, :348, :382, :408,
:529 and :596 (the port has no receive ring, so the sink's bytes are
exact on ``sock_recv_into``); and ``tests/test_shm_reads.py:269``
(``alloc_aligned`` and the registered pool). Four wait for the io_uring
``RingRecv``, which comes with the worker's direct IO (ROADMAP §A item
3): :449, :472, :507 and :580. The two of :626 and :631 test
``rpc/loops.py``'s uvloop fallback, which the port does not have: it
runs stock asyncio, and a conf that sets ``rpc.uvloop = true`` is
refused (below). Beyond the mirrors: a ``send_file`` item keeps its FIFO
place behind the frames queued before it and a file shorter than its
frame breaks the connection, the pool hands no region to two of 16
threads at once, a writer's break is counted in its registry (apart
when a server's client left), a sink whose caller left mid-payload
takes none of the payload's late bytes and its connection stays usable,
and the ``[rpc]`` table loads as the JAX
package's does, each of its fixed keys refused at another value.

The port's ``Connection.call`` sends a request's body as its data (the
header carries only a deadline), so the echo server here answers the
body's map as its header."""

import asyncio
import dataclasses
import gc
import mmap
import socket
import threading

import pytest

from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu_torch.common.conf import (CLIENT_FIXED, RING_FIXED,
                                           RPC_FIXED, ClusterConf, RpcConf)
from curvine_tpu_torch.common.errors import (ConnectError, CurvineError,
                                             RpcTimeout)
from curvine_tpu_torch.common.metrics import MetricsRegistry
from curvine_tpu_torch.rpc import transport as transport_mod
from curvine_tpu_torch.rpc.client import Connection
from curvine_tpu_torch.rpc.frame import (ENVELOPE_MAX, FIXED, FIXED_LEN,
                                         LEN_PREFIX, MAX_FRAME, VERSION,
                                         Flags, Message, decode_envelope,
                                         pack, unpack)
from curvine_tpu_torch.rpc.server import RpcServer
from curvine_tpu_torch.rpc.transport import (BulkDecoder, CoalescedWriter,
                                             vectored_sendall)

MB = 1024 * 1024


def _frame_bytes(msg: Message) -> bytes:
    return b"".join(bytes(b) for b in msg.encode())


def _nb_socketpair():
    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(False)
    return a, b


async def _drain(loop, sock, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        got = await loop.sock_recv(sock, n - len(out))
        if not got:
            break
        out += got
    return bytes(out)


# ---------------------------------------------------------------- frame


def test_encode_into_matches_encode():
    cases = [
        Message(code=7, req_id=1),
        Message(code=7, req_id=2, header={"p": "/a", "n": 3}),
        Message(code=7, req_id=3, header={"x": 1}, data=b"tiny"),
        Message(code=7, req_id=4, data=b"z" * 100_000),
    ]
    for msg in cases:
        ref = _frame_bytes(msg)
        out = bytearray()
        big = msg.encode_into(out, inline_max=4096)
        flat = bytes(out) + (bytes(big) if big is not None else b"")
        assert flat == ref
        # a payload over inline_max is not copied into the head
        if len(msg.data) > 4096:
            assert big is not None and bytes(big) == bytes(msg.data)
        else:
            assert big is None


def test_decode_envelope_every_split_point():
    """None, never a raise and nothing consumed, at every truncation of a
    valid frame; then the exact envelope."""
    msg = Message(code=9, req_id=42, status=0, flags=Flags.RESPONSE,
                  header={"k": "v", "n": 7}, data=b"payload-bytes")
    wire = _frame_bytes(msg)
    payload_off = len(wire) - len(msg.data)
    buf = bytearray()
    for i in range(payload_off):
        assert decode_envelope(buf, 0, len(buf)) is None, f"split at {i}"
        buf.append(wire[i])
    env = decode_envelope(buf, 0, len(buf))
    assert env is not None
    end, code, req_id, status, flags, header, data_len = env
    assert (code, req_id, status, flags) == (9, 42, 0, Flags.RESPONSE)
    assert header == {"k": "v", "n": 7}
    assert data_len == len(msg.data)
    assert end == payload_off


def test_decode_envelope_rejects_bad_frames():
    # a total past MAX_FRAME, refused from the prefix alone
    bad = LEN_PREFIX.pack(MAX_FRAME + 1) + b"\x00" * ENVELOPE_MAX
    with pytest.raises(CurvineError):
        decode_envelope(bad, 0, len(bad))
    with pytest.raises(CurvineError):
        decode_envelope(bad[:4], 0, 4)
    # shorter than the fixed block
    short = LEN_PREFIX.pack(FIXED_LEN - 1) + b"\x00" * ENVELOPE_MAX
    with pytest.raises(CurvineError):
        decode_envelope(short, 0, len(short))
    # a header length past the frame's total
    hdr_overrun = bytearray(LEN_PREFIX.pack(FIXED_LEN) + bytes(FIXED_LEN))
    hdr_overrun[4] = 1                       # version
    hdr_overrun[-1] = 200                    # header_len past total
    with pytest.raises(CurvineError):
        decode_envelope(hdr_overrun, 0, len(hdr_overrun))


async def test_bulk_decoder_byte_at_a_time():
    """The peer sends one byte a send: every frame reassembled."""
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    try:
        msgs = [Message(code=3, req_id=i, header={"i": i},
                        data=bytes([i]) * (i * 7)) for i in range(1, 6)]
        wire = b"".join(_frame_bytes(m) for m in msgs)

        async def dribble():
            for i in range(len(wire)):
                await loop.sock_sendall(a, wire[i:i + 1])

        send = asyncio.ensure_future(dribble())
        dec = BulkDecoder(size=64 * 1024)
        got = []
        while len(got) < len(msgs):
            env = dec.try_next()
            if env is None:
                await dec.fill(loop, b)
                continue
            code, req_id, status, flags, header, data_len = env
            data = bytes(await dec.read_payload(loop, b, data_len))
            got.append((req_id, header, data))
        await send
        for m, (req_id, header, data) in zip(msgs, got):
            assert req_id == m.req_id
            assert header == m.header
            assert data == bytes(m.data)
        assert dec.bytes_recv == len(wire)
    finally:
        a.close()
        b.close()


async def test_bulk_decoder_max_frame_mid_batch():
    """A hostile length after good frames in one receive: the good ones
    decode, the bad one raises."""
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    try:
        good = _frame_bytes(Message(code=1, req_id=1, header={"ok": 1}))
        evil = LEN_PREFIX.pack(MAX_FRAME + 1) + b"\x00" * FIXED_LEN
        await loop.sock_sendall(a, good + good + evil)
        dec = BulkDecoder(size=64 * 1024)
        seen = 0
        with pytest.raises(CurvineError):
            while True:
                env = dec.try_next()
                if env is None:
                    await dec.fill(loop, b)
                    continue
                *_, data_len = env
                await dec.read_payload(loop, b, data_len)
                seen += 1
        assert seen == 2
    finally:
        a.close()
        b.close()


async def test_read_payload_transient_past_retain_cap(monkeypatch):
    """A payload past RECV_RETAIN_MAX goes through a transient buffer;
    one below it grows the decoder's buffer and stays."""
    monkeypatch.setattr(transport_mod, "RECV_RETAIN_MAX", 20 * 1024)
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    try:
        dec = BulkDecoder(size=16 * 1024)
        big = bytes(range(256)) * 128           # 32 KiB, past the cap
        send = asyncio.ensure_future(loop.sock_sendall(a, big))
        view = await dec.read_payload(loop, b, len(big))
        await send
        assert bytes(view) == big
        assert len(dec._buf) < len(big)         # the buffer did not grow
        mid = b"m" * (18 * 1024)                # past the buffer, below cap
        send = asyncio.ensure_future(loop.sock_sendall(a, mid))
        view = await dec.read_payload(loop, b, len(mid))
        await send
        assert bytes(view) == mid
        assert len(dec._buf) >= len(mid)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------- send path


async def test_vectored_sendall_many_buffers(monkeypatch):
    """More buffers than one iovec takes: the bytes arrive whole across
    the system calls."""
    monkeypatch.setattr(transport_mod, "_IOV_CAP", 4)
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    try:
        bufs = [bytes([i]) * (i * 997 + 1) for i in range(20)]
        want = b"".join(bufs)
        recv = asyncio.ensure_future(_drain(loop, b, len(want)))
        await vectored_sendall(loop, a, list(bufs))
        assert await recv == want
    finally:
        a.close()
        b.close()


async def test_writer_coalesces_batch_and_metrics():
    """Sends queued while the wire is busy leave as one vectored batch:
    ``rpc.send_batch_frames`` sees it, ``rpc.bytes_sent`` equals the
    wire's bytes and the queue gauge returns to 0."""
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    m = MetricsRegistry("test")
    w = CoalescedWriter(a, loop, metrics=m, name="t")
    try:
        msgs = [Message(code=5, req_id=i, header={"i": i}) for i in range(8)]
        want = b"".join(_frame_bytes(msg) for msg in msgs)
        # the held lock sends every frame down the queue path
        async with w._io_lock:
            sends = [asyncio.ensure_future(w.send(msg)) for msg in msgs]
            await asyncio.sleep(0)
            assert w.qsize() == len(msgs)
        recv = asyncio.ensure_future(_drain(loop, b, len(want)))
        await asyncio.gather(*sends)
        assert await recv == want
        h = m.histograms["rpc.send_batch_frames"]
        assert h.max >= 2, "no multi-frame batch was coalesced"
        assert m.counters["rpc.bytes_sent"] == len(want)
        assert w.bytes_sent == len(want)
        assert m.gauges["rpc.send_queue_depth"] == 0
        assert "curvine_test_rpc_send_queue_depth" in m.prometheus_text()
    finally:
        await w.aclose()
        a.close()
        b.close()


async def test_queued_cancel_severs_at_frame_boundary():
    """A cancelled send still queued is dropped whole before any byte
    leaves: the stream parses and the writer is not broken."""
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    w = CoalescedWriter(a, loop, name="t")
    try:
        m1 = Message(code=5, req_id=1, header={"n": 1})
        m2 = Message(code=5, req_id=2, header={"n": 2})
        m3 = Message(code=5, req_id=3, header={"n": 3})
        async with w._io_lock:
            t1 = asyncio.ensure_future(w.send(m1))
            t2 = asyncio.ensure_future(w.send(m2))
            await asyncio.sleep(0)
            assert w.qsize() == 2
            t2.cancel()
            await asyncio.sleep(0)
        await t1
        with pytest.raises(asyncio.CancelledError):
            await t2
        assert w.broken is None, "a queued cancel must not break it"
        await w.send(m3)
        want = _frame_bytes(m1) + _frame_bytes(m3)
        assert await _drain(loop, b, len(want)) == want
        dec = BulkDecoder()
        dec._buf[:len(want)] = want
        dec._limit = len(want)
        assert dec.try_next()[1] == 1
        assert dec.try_next()[1] == 3
    finally:
        await w.aclose()
        a.close()
        b.close()


async def test_inline_cancel_mid_write_poisons():
    """A cancel during an inline write may leave part of a frame on the
    wire: the writer breaks, calls on_broken and refuses later sends."""
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8 * 1024)
    broken = []
    w = CoalescedWriter(a, loop, inline_max=64 * MB,
                        on_broken=broken.append, name="t")
    try:
        big = Message(code=5, req_id=1, data=b"x" * (8 * MB))
        t = asyncio.ensure_future(w.send(big))
        for _ in range(20):
            await asyncio.sleep(0)
        assert not t.done()
        t.cancel()
        with pytest.raises(asyncio.CancelledError):
            await t
        assert isinstance(w.broken, ConnectError)
        assert broken, "on_broken did not fire"
        with pytest.raises(ConnectError):
            await w.send(Message(code=5, req_id=2))
    finally:
        await w.aclose()
        a.close()
        b.close()


async def test_send_file_keeps_fifo_and_a_short_file_breaks(tmp_path):
    """A sendfile item leaves behind the frames queued before it and ahead
    of those after; a file shorter than its frame breaks the writer."""
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    w = CoalescedWriter(a, loop, name="t")
    path = tmp_path / "blk"
    body = bytes(range(256)) * 64
    path.write_bytes(body)
    try:
        m1 = Message(code=5, req_id=1, header={"n": 1})
        m2 = Message(code=5, req_id=2, flags=Flags.EOF)
        head = LEN_PREFIX.pack(FIXED_LEN + 1000) + FIXED.pack(
            VERSION, 5, 9, 0, Flags.RESPONSE | Flags.CHUNK, 0)
        with open(path, "rb") as f:
            async with w._io_lock:
                t1 = asyncio.ensure_future(w.send(m1))
                tf = asyncio.ensure_future(w.send_file(head, f, 100, 1000))
                t2 = asyncio.ensure_future(w.send(m2))
                await asyncio.sleep(0)
                assert w.qsize() == 3
            want = _frame_bytes(m1) + head + body[100:1100] + _frame_bytes(m2)
            recv = asyncio.ensure_future(_drain(loop, b, len(want)))
            await t1
            assert await tf == 1000
            await t2
            assert await recv == want
            short = LEN_PREFIX.pack(FIXED_LEN + 8192) + FIXED.pack(
                VERSION, 5, 10, 0, Flags.RESPONSE | Flags.CHUNK, 0)
            with pytest.raises(CurvineError):
                await w.send_file(short, f, len(body) - 10, 8192)
        assert w.broken is not None
        with pytest.raises(ConnectError):
            await w.send(Message(code=5, req_id=3))
    finally:
        await w.aclose()
        a.close()
        b.close()


# ------------------------------------------------------- end to end


async def _echo_server(metrics=None):
    srv = RpcServer("127.0.0.1", 0, "test")
    srv.metrics = metrics

    async def echo(msg, conn):
        return (unpack(msg.data) or {}), bytes(msg.data)
    srv.register(9_900, echo)

    async def stream(msg, conn):
        # CHUNK frames and an EOF, several to one receive
        n = int(msg.header.get("chunks", 4))
        for i in range(n):
            await conn.send(Message(
                code=msg.code, req_id=msg.req_id,
                flags=Flags.RESPONSE | Flags.CHUNK,
                data=bytes([i]) * 1024))
        await conn.send(Message(code=msg.code, req_id=msg.req_id,
                                flags=Flags.RESPONSE | Flags.EOF))
        return None
    srv.register(9_901, stream)
    await srv.start()
    return srv


async def test_interleaved_chunk_sink_and_control_frames():
    """A sink's CHUNK stream and unary replies on one connection: the
    payloads land in the sink, the replies keep resolving."""
    m = MetricsRegistry("test")
    srv = await _echo_server(metrics=m)
    conn = await Connection(f"127.0.0.1:{srv.port}", metrics=m).connect()
    try:
        chunks = 6
        sink = bytearray(chunks * 1024)

        async def unary_storm():
            for i in range(32):
                rep = await conn.call(9_900, data=pack({"i": i,
                                                        "d": "d" * 64}))
                assert rep.header["i"] == i
        storm = asyncio.ensure_future(unary_storm())
        got = await conn.call_readinto(9_901, memoryview(sink),
                                       header={"chunks": chunks})
        await storm
        assert got == chunks * 1024
        for i in range(chunks):
            assert sink[i * 1024:(i + 1) * 1024] == bytes([i]) * 1024
        assert m.counters["rpc.bytes_sent"] > 0
        assert m.counters["rpc.bytes_recv"] > 0
        text = m.prometheus_text()
        assert "curvine_test_rpc_bytes_sent" in text
        assert "curvine_test_rpc_bytes_recv" in text
        assert "curvine_test_rpc_send_batch_frames_count" in text
    finally:
        await conn.close()
        await srv.stop()


async def test_connection_survives_queued_cancel_end_to_end():
    """A call cancelled with its frame queued leaves the connection
    usable for the calls after it."""
    srv = await _echo_server()
    conn = await Connection(f"127.0.0.1:{srv.port}").connect()
    try:
        burst = [asyncio.ensure_future(conn.call(9_900, data=pack({"i": i})))
                 for i in range(16)]
        victim = asyncio.ensure_future(conn.call(9_900, data=pack({"v": 1})))
        await asyncio.sleep(0)
        victim.cancel()
        try:
            await victim
        except asyncio.CancelledError:
            pass
        await asyncio.gather(*burst)
        assert not conn.closed
        rep = await conn.call(9_900, data=pack({"after": True}))
        assert rep.header["after"] is True
    finally:
        await conn.close()
        await srv.stop()


async def test_server_rejects_oversized_frame_mid_stream():
    """Good frames, then a giant length: the server closes that
    connection, and serves the next client."""
    srv = await _echo_server()
    loop = asyncio.get_running_loop()
    sock = socket.socket()
    sock.setblocking(False)
    try:
        await loop.sock_connect(sock, ("127.0.0.1", srv.port))
        good = _frame_bytes(Message(code=9_900, req_id=1,
                                    data=pack({"a": 1})))
        evil = LEN_PREFIX.pack(MAX_FRAME + 4096) + b"\x00" * FIXED_LEN
        await loop.sock_sendall(sock, good + evil)
        while True:
            got = await asyncio.wait_for(loop.sock_recv(sock, 65536), 5)
            if not got:
                break                     # EOF: the server closed on us
        conn = await Connection(f"127.0.0.1:{srv.port}").connect()
        try:
            rep = await conn.call(9_900, data=pack({"alive": 1}))
            assert rep.header["alive"] == 1
        finally:
            await conn.close()
    finally:
        sock.close()
        await srv.stop()


# ------------------------------------------------ registered receive


def test_registered_pool_pinned_accounting_and_double_release():
    """``pinned`` is the checked-out bytes, cleared once by release or
    collection, ``retained`` the parked bytes, and a double release
    never parks a region twice."""
    pool = transport_mod.RegisteredBuffers(max_bytes=2 * MB,
                                           min_size=64 * 1024, max_size=MB)
    cls = 128 * 1024                        # the class of 100,000
    a = pool.acquire(100_000)
    assert pool.pinned == cls and pool.retained == 0
    pool.release(a)
    assert pool.pinned == 0 and pool.retained == cls
    pool.release(a)                         # a double release: nothing
    assert pool.pinned == 0 and pool.retained == cls
    b = pool.acquire(100_000)
    c = pool.acquire(100_000)
    assert b.ctypes.data != c.ctypes.data, \
        "a double release handed one region to two acquirers"
    assert pool.pinned == 2 * cls
    pool.release(b)
    pool.release(c)
    assert pool.pinned == 0
    # a buffer that escaped: its collection unpins, it never comes back
    d = pool.acquire(100_000)
    retained = pool.retained
    assert pool.pinned == cls
    del d
    gc.collect()
    assert pool.pinned == 0 and pool.retained == retained
    e = pool.acquire(100_000)
    pool.release(e)
    del e
    gc.collect()
    assert pool.pinned == 0
    st = pool.stats()
    assert set(st) == {"registered_bytes", "pinned_bytes", "acquired",
                       "reused", "ring_registered", "fixed_ops",
                       "fixed_bytes"}
    assert st["registered_bytes"] == pool.retained
    assert st["pinned_bytes"] == 0
    assert (st["ring_registered"], st["fixed_ops"], st["fixed_bytes"]) \
        == (0, 0, 0)
    assert pool.ring() is None and not pool.ring_registered()
    pool.drain()
    assert pool.retained == 0


def test_registered_pool_under_threads():
    """The pool serves loops on several threads (the workers of one
    process): under a short switch interval, 16 threads acquiring and
    releasing never hold one region at once, and the accounting ends
    balanced."""
    import sys
    import threading
    pool = transport_mod.RegisteredBuffers(max_bytes=MB, min_size=64 * 1024,
                                           max_size=MB)
    held: dict[int, int] = {}
    clash: list = []
    guard = threading.Lock()

    def work(k: int) -> None:
        for i in range(300):
            arr = pool.acquire(64 * 1024 * (1 + (k + i) % 3))
            addr = arr.ctypes.data
            with guard:
                if addr in held:
                    clash.append((k, held[addr]))
                held[addr] = k
            arr[:8] = k
            with guard:
                del held[addr]
            pool.release(arr)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not clash, f"one region held by two threads: {clash[:3]}"
    assert pool.pinned == 0 and 0 < pool.retained <= MB
    assert pool.acquired == 16 * 300
    pool.drain()


def test_alloc_aligned_and_registered_pool():
    """``alloc_aligned`` gives page-aligned mmap-backed arrays; the pool
    recycles them under its byte cap (tests/test_shm_reads.py:269)."""
    arr = transport_mod.alloc_aligned(300_000)
    assert len(arr) == 300_000
    assert arr.ctypes.data % mmap.PAGESIZE == 0
    pool = transport_mod.RegisteredBuffers(max_bytes=2 * MB,
                                           min_size=64 * 1024, max_size=MB)
    a = pool.acquire(100_000)
    assert len(a) == 100_000 and a.ctypes.data % mmap.PAGESIZE == 0
    pool.release(a)
    b = pool.acquire(90_000)                 # the same class
    assert pool.reused == 1
    pool.release(b)
    big = pool.acquire(4 * MB)               # past max_size: never pooled
    assert len(big) == 4 * MB
    held, retained = pool.acquired, pool.retained
    pool.release(big)
    assert pool.acquired == held and pool.retained == retained
    extras = [pool.acquire(MB) for _ in range(4)]
    for e in extras:
        pool.release(e)
    assert pool.retained <= 2 * MB
    pool.drain()


def test_a_view_collected_inside_the_pool_lock_does_not_deadlock():
    """A checked-out view in a reference cycle is freed by the collector
    in whichever thread runs it, perhaps one that holds the pool's lock
    (the pool is the process's, shared by workers and clients on other
    threads): its unpin must not wait for that lock, and the view's bytes
    stop counting as pinned."""
    pool = transport_mod.RegisteredBuffers(max_bytes=MB,
                                           min_size=64 * 1024, max_size=MB)
    cycle = [pool.acquire(100_000)]
    cycle.append(cycle)
    assert pool.pinned == 128 * 1024
    del cycle

    def collect_under_the_lock():
        with pool._lock:
            gc.collect()

    t = threading.Thread(target=collect_under_the_lock, daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive(), "the unpin waited for the pool's own lock"
    assert pool.pinned == 0 and pool.stats()["pinned_bytes"] == 0


async def test_large_sink_payload_end_to_end():
    """A multi-chunk sink stream on a connection with an ``[rpc]`` table:
    the bytes are exact (the port's sink always takes sock_recv_into)."""
    srv = await _echo_server()
    conn = await Connection(f"127.0.0.1:{srv.port}",
                            rpc_conf=RpcConf()).connect()
    try:
        chunks = 8
        sink = bytearray(chunks * 1024)
        got = await conn.call_readinto(9_901, memoryview(sink),
                                       header={"chunks": chunks})
        assert got == chunks * 1024
        for i in range(chunks):
            assert sink[i * 1024:(i + 1) * 1024] == bytes([i]) * 1024
    finally:
        await conn.close()
        await srv.stop()


async def test_a_sink_left_mid_payload_takes_no_late_bytes():
    """A server sends a chunk's header and half its payload, then stalls:
    the ``call_readinto`` times out and its caller hands the buffer on.
    When the server resumes, the rest of the frame must not land in that
    buffer; it is dropped, and the connection serves the next call."""
    resume = asyncio.Event()
    n = 64 * 1024

    async def request(reader) -> int:
        total = LEN_PREFIX.unpack(await reader.readexactly(LEN_PREFIX.size))
        return FIXED.unpack_from(await reader.readexactly(total[0]))[2]

    def frames(req_id: int, fill: bytes) -> tuple[bytes, bytes]:
        return (_frame_bytes(Message(code=9_901, req_id=req_id,
                                     flags=Flags.RESPONSE | Flags.CHUNK,
                                     data=fill * n)),
                _frame_bytes(Message(code=9_901, req_id=req_id,
                                     flags=Flags.RESPONSE | Flags.EOF)))

    async def serve(reader, writer):
        try:
            chunk, eof = frames(await request(reader), b"\x11")
            writer.write(chunk[:len(chunk) - n // 2])
            await writer.drain()
            await resume.wait()
            writer.write(chunk[len(chunk) - n // 2:] + eof)
            writer.write(b"".join(frames(await request(reader), b"\x33")))
            await writer.drain()
            await reader.read()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    srv = await asyncio.start_server(serve, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    conn = await Connection(f"127.0.0.1:{port}", timeout_ms=300).connect()
    try:
        sink = bytearray(n)
        with pytest.raises(RpcTimeout):
            await conn.call_readinto(9_901, memoryview(sink), header={})
        assert sink[:n // 2] == b"\x11" * (n // 2)
        sink[:] = b"\x22" * n          # the buffer's next owner
        resume.set()
        await asyncio.sleep(0.2)
        assert sink == b"\x22" * n
        assert not conn.closed
        again = bytearray(n)
        assert await conn.call_readinto(9_901, memoryview(again),
                                        header={}) == n
        assert again == b"\x33" * n
    finally:
        resume.set()
        await conn.close()
        srv.close()
        await srv.wait_closed()


# ---------------------------------------------------------- breaks


async def test_writer_break_counts_in_its_registry():
    """A writer that breaks counts ``rpc.writer_breaks`` once in its
    registry, however many sends fail after."""
    loop = asyncio.get_running_loop()
    a, b = _nb_socketpair()
    m = MetricsRegistry("t")
    w = CoalescedWriter(a, loop, metrics=m)
    b.close()
    with pytest.raises((OSError, ConnectError)):
        for _ in range(64):
            await w.send(Message(code=1, req_id=1, data=b"x" * 65536))
    with pytest.raises(ConnectError):
        await w.send(Message(code=1, req_id=2))
    assert w.broken is not None
    assert m.counters["rpc.writer_breaks"] == 1
    await w.aclose()
    a.close()


async def test_server_writer_break_counts_peer_gone():
    """A server's writer that breaks because its client left counts
    ``rpc.writer_breaks`` and ``rpc.writer_breaks_peer_gone``: the
    master's ``--metrics-out`` dump carries both."""
    srv = RpcServer("127.0.0.1", 0)
    srv.metrics = MetricsRegistry("srv")
    gone = asyncio.Event()

    async def big(msg, conn):
        await gone.wait()
        for _ in range(256):
            await conn.send(Message(code=msg.code, req_id=msg.req_id,
                                    flags=Flags.RESPONSE | Flags.CHUNK,
                                    data=b"y" * 65536))

    srv.register(4_401, big)
    await srv.start()
    loop = asyncio.get_running_loop()
    sock = socket.create_connection(("127.0.0.1", srv.port))
    sock.setblocking(False)
    try:
        for part in Message(code=4_401, req_id=1).encode():
            await loop.sock_sendall(sock, bytes(part))
        await asyncio.sleep(0.05)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        b"\x01\x00\x00\x00\x00\x00\x00\x00")
        sock.close()                      # a reset: the client left
        gone.set()
        for _ in range(200):
            if srv.metrics.counters.get("rpc.writer_breaks"):
                break
            await asyncio.sleep(0.01)
        c = srv.metrics.counters
        assert c.get("rpc.writer_breaks") == 1
        assert c.get("rpc.writer_breaks_peer_gone") == 1
    finally:
        await srv.stop()


# ---------------------------------------------------------- conf


def test_rpc_table_loads_as_the_references(tmp_path):
    """The ``[rpc]`` table's field and its fixed keys are the JAX
    package's fields at their defaults, apart from the ring (no ring);
    the client's fixed keys are its defaults; the transport's constants
    are those values."""
    jax = {f.name: getattr(JaxConf().rpc, f.name)
           for f in dataclasses.fields(JaxConf().rpc)}
    port = dataclasses.asdict(ClusterConf().rpc)
    assert set(jax) == set(port) | set(RPC_FIXED) | set(RING_FIXED)
    assert {k: jax[k] for k in {**port, **RPC_FIXED}} == {**port, **RPC_FIXED}
    assert RING_FIXED == {"recv_ring": False,
                          "recv_ring_min": jax["recv_ring_min"]}
    jc = JaxConf().client
    assert {k: getattr(jc, k) for k in CLIENT_FIXED} == CLIENT_FIXED
    assert (transport_mod.SEND_COALESCE_BYTES, transport_mod.SEND_INLINE_MAX,
            transport_mod.RECV_BUFFER_BYTES, transport_mod._ALIGNED_MIN,
            transport_mod.RegisteredBuffers().max_bytes) == (
        RPC_FIXED["send_coalesce_bytes"], RPC_FIXED["send_inline_max"],
        RPC_FIXED["recv_buffer_bytes"], RPC_FIXED["recv_aligned_min"],
        RPC_FIXED["recv_registered_bytes"])
    p = tmp_path / "c.toml"
    p.write_text("[rpc]\nsend_coalesce_frames = 1\nrecv_aligned_min = "
                 f"{256 * 1024}\nrecv_ring = false\nuvloop = false\n"
                 "[client]\nread_ahead_chunks = 7\n"
                 "sequential_read_threshold = 3\n")
    conf = ClusterConf.load(str(p))
    assert conf.rpc.send_coalesce_frames == 1
    assert conf.client.read_ahead_chunks == 7


@pytest.mark.parametrize("section, key, val", [
    ("rpc", "recv_ring", "true"), ("rpc", "recv_ring_min", "4096"),
    ("rpc", "uvloop", "true"), ("rpc", "send_coalesce_bytes", "4096"),
    ("rpc", "send_inline_max", "1"), ("rpc", "recv_buffer_bytes", "4096"),
    ("rpc", "recv_registered_bytes", "0"), ("rpc", "recv_aligned_min", "1"),
    ("client", "enable_smart_prefetch", "false"),
    ("client", "sequential_read_threshold", "2")])
def test_fixed_keys_are_refused(tmp_path, section, key, val):
    """A file that sets a fixed key to another value is refused, naming
    the key; the ring's refusal names the item that brings the ring."""
    p = tmp_path / "c.toml"
    p.write_text(f"[{section}]\n{key} = {val}\n")
    match = "item 3" if key.startswith("recv_ring") else f"{section}.{key}"
    with pytest.raises(ValueError, match=match):
        ClusterConf.load(str(p))
