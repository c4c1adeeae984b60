"""RPC client: connection, response routing, pool and retry policy.

Own copy of ``curvine_tpu/rpc/client.py:47-533`` over plain ``asyncio``
socket calls (``sock_recv_into``, ``sock_sendall``). One connection
multiplexes concurrent requests by ``req_id``; a read loop routes each
response frame, a streamed response's CHUNK frames and its EOF, to its
waiter; an upload streams CHUNK frames and an EOF and awaits the ack.
``call_readinto`` (:314-346) registers the caller's buffer as the
request's sink: the read loop receives each chunk's payload straight
into it, and only the EOF (its trailer merged into ``eof_header``) or an
error reaches the waiter.

Left out (ROADMAP A3b, speed work for later): the transport's
``CoalescedWriter`` (frames are written one ``sock_sendall`` at a time
under a lock), ``BulkDecoder``'s many-frames-per-recv decoding (one
buffered reader instead), the io_uring ``RingRecv`` and the
``RegisteredBuffers`` pool; and the deadline, trace and tenant headers,
the client fault hook and the server-push receiver."""

from __future__ import annotations

import asyncio
import itertools
import logging
import random
import socket
from dataclasses import dataclass
from typing import Any, AsyncIterator

from curvine_tpu_torch.common.errors import (ConnectError, CurvineError,
                                             ErrorCode, RpcTimeout)
from curvine_tpu_torch.rpc.frame import (ENVELOPE_MAX, STATUS_ERROR, Flags,
                                         Message, decode_header,
                                         parse_envelope)

log = logging.getLogger(__name__)

_req_ids = itertools.count(1)
RECV_BUFFER_BYTES = 256 * 1024


class _Recv:
    """Buffered reads off one socket: small reads come out of one
    reusable buffer, large ones land in the caller's memory."""

    def __init__(self, loop: asyncio.AbstractEventLoop, sock: socket.socket,
                 size: int = RECV_BUFFER_BYTES):
        self.loop, self.sock = loop, sock
        self.buf = bytearray(size)
        self.pos = self.limit = 0

    async def _fill(self) -> None:
        got = await self.loop.sock_recv_into(
            self.sock, memoryview(self.buf)[self.limit:])
        if got == 0:
            raise ConnectionResetError("peer closed")
        self.limit += got

    async def exactly(self, n: int) -> bytes | bytearray:
        """The next ``n`` bytes of the stream."""
        if n > len(self.buf):
            out = bytearray(n)
            await self.into(memoryview(out))
            return out
        if self.pos + n > len(self.buf):        # no room behind pos
            rem = self.limit - self.pos
            self.buf[:rem] = self.buf[self.pos:self.limit]
            self.pos, self.limit = 0, rem
        while self.limit - self.pos < n:
            await self._fill()
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        if self.pos == self.limit:
            self.pos = self.limit = 0
        return out

    async def into(self, dst: memoryview) -> None:
        """Fill ``dst`` with the next ``len(dst)`` bytes: what is buffered
        first, the rest received into ``dst`` itself."""
        k = min(len(dst), self.limit - self.pos)
        dst[:k] = self.buf[self.pos:self.pos + k]
        self.pos += k
        if self.pos == self.limit:
            self.pos = self.limit = 0
        while k < len(dst):
            got = await self.loop.sock_recv_into(self.sock, dst[k:])
            if got == 0:
                raise ConnectionResetError("peer closed")
            k += got


@dataclass
class _Sink:
    """The caller's buffer of a ``call_readinto``: chunk payloads land in
    ``view`` at ``filled``."""

    view: memoryview
    filled: int = 0


class Connection:
    """One TCP connection; multiplexes concurrent requests by req_id."""

    def __init__(self, addr: str, timeout_ms: int = 30_000):
        self.addr = addr
        self.timeout = timeout_ms / 1000
        self._sock: socket.socket | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._waiters: dict[int, asyncio.Queue] = {}
        self._sinks: dict[int, _Sink] = {}
        self._reader_task: asyncio.Task | None = None
        self._send_lock = asyncio.Lock()
        self.closed = False

    async def connect(self) -> "Connection":
        host, port = self.addr.rsplit(":", 1)
        self._loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            await asyncio.wait_for(
                self._loop.sock_connect(sock, (host, int(port))),
                self.timeout)
        except (OSError, asyncio.TimeoutError) as e:
            sock.close()
            raise ConnectError(f"connect {self.addr}: {e}") from e
        self._sock = sock
        self._reader_task = asyncio.ensure_future(self._read_loop())
        return self

    # ---------------- receive ----------------

    async def _read_loop(self) -> None:
        rx = _Recv(self._loop, self._sock)
        try:
            while True:
                code, req_id, status, flags, hdr_len, data_len = \
                    parse_envelope(await rx.exactly(ENVELOPE_MAX))
                header = decode_header(await rx.exactly(hdr_len)) \
                    if hdr_len else {}
                sink = self._sinks.get(req_id)
                data = b""
                if sink is not None and status == 0 and \
                        sink.filled + data_len <= len(sink.view):
                    # the payload goes straight into the caller's buffer;
                    # a chunk frame then has nothing left to deliver
                    await rx.into(sink.view[sink.filled:
                                            sink.filled + data_len])
                    sink.filled += data_len
                    if flags & Flags.CHUNK:
                        continue
                elif data_len:
                    data = await rx.exactly(data_len)
                q = self._waiters.get(req_id)
                if q is None:
                    log.debug("drop frame without a waiter: req_id=%d code"
                              "=%d", req_id, code)
                else:
                    q.put_nowait(Message(code=code, req_id=req_id,
                                         status=status, flags=flags,
                                         header=header, data=data))
        except (ConnectionResetError, OSError):
            pass
        except Exception:
            log.exception("connection %s read loop", self.addr)
        finally:
            self.closed = True
            if self._sock is not None:
                self._sock.close()
            err = Message(status=STATUS_ERROR, flags=Flags.RESPONSE
                          | Flags.EOF,
                          header={"error_code": int(ErrorCode.CONNECT),
                                  "error": f"connection {self.addr} closed"})
            for q in self._waiters.values():
                q.put_nowait(err)

    async def close(self) -> None:
        self.closed = True
        if self._reader_task is not None:
            self._reader_task.cancel()
            await asyncio.gather(self._reader_task, return_exceptions=True)
            self._reader_task = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    # ---------------- send ----------------

    async def send(self, msg: Message) -> None:
        if self.closed or self._sock is None:
            raise ConnectError(f"connection {self.addr} is closed")
        sock = self._sock
        async with self._send_lock:
            try:
                for buf in msg.encode():
                    await self._loop.sock_sendall(sock, buf)
            except BaseException as e:
                # a frame may be half on the wire: the stream cannot be
                # used again, so the read loop fails every waiter out
                self.closed = True
                sock.close()
                if isinstance(e, OSError):
                    raise ConnectError(f"send to {self.addr}: {e}") from e
                raise

    def register(self, req_id: int) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._waiters[req_id] = q
        return q

    def unregister(self, req_id: int) -> None:
        self._waiters.pop(req_id, None)
        self._sinks.pop(req_id, None)

    async def _next(self, q: asyncio.Queue, code: int) -> Message:
        try:
            rep: Message = await asyncio.wait_for(q.get(), self.timeout)
        except asyncio.TimeoutError as e:
            raise RpcTimeout(f"rpc {code} to {self.addr} timed out") from e
        return rep.check()

    # ---------------- request patterns ----------------

    async def call(self, code: int, data: bytes | memoryview = b""
                   ) -> Message:
        """Unary request (its body in ``data``) → single response."""
        req_id = next(_req_ids)
        q = self.register(req_id)
        try:
            await self.send(Message(code=int(code), req_id=req_id,
                                    data=data))
            return await self._next(q, code)
        finally:
            self.unregister(req_id)

    async def call_stream(self, code: int, header: dict
                          ) -> AsyncIterator[Message]:
        """Unary request → stream of chunk frames ending with EOF."""
        req_id = next(_req_ids)
        q = self.register(req_id)
        try:
            await self.send(Message(code=int(code), req_id=req_id,
                                    header=dict(header)))
            while True:
                rep = await self._next(q, code)
                yield rep
                if rep.is_eof:
                    return
        finally:
            self.unregister(req_id)

    async def call_readinto(self, code: int, sink: memoryview,
                            header: dict,
                            eof_header: dict | None = None) -> int:
        """Unary request → a stream whose chunk payloads are received
        straight into ``sink``; returns the bytes filled. The EOF frame's
        header (the server's trailer, e.g. the block's commit-time crc)
        is merged into ``eof_header`` when given. A payload that would
        overrun ``sink`` is delivered as a frame and copied in up to its
        end."""
        req_id = next(_req_ids)
        q = self.register(req_id)
        state = self._sinks[req_id] = _Sink(view=sink)
        try:
            await self.send(Message(code=int(code), req_id=req_id,
                                    header=dict(header)))
            while True:
                rep = await self._next(q, code)
                if len(rep.data):
                    n = min(len(rep.data), len(sink) - state.filled)
                    sink[state.filled:state.filled + n] = rep.data[:n]
                    state.filled += n
                if rep.is_eof:
                    if eof_header is not None and rep.header:
                        eof_header.update(rep.header)
                    return state.filled
        finally:
            self.unregister(req_id)

    class _UploadStream:
        """Chunked upload for one req_id; ends with EOF, then awaits the
        ack."""

        def __init__(self, conn: "Connection", code: int, req_id: int,
                     q: asyncio.Queue):
            self.conn, self.code, self.req_id, self.q = conn, code, req_id, q

        async def send_chunk(self, data, header: dict | None = None) -> None:
            # before EOF the server sends only an error (a refused open,
            # a failed write): raise it now, not after the whole block
            if not self.q.empty():
                self.q.get_nowait().check()
            await self.conn.send(Message(code=self.code, req_id=self.req_id,
                                         flags=Flags.CHUNK,
                                         header=header or {}, data=data))

        async def finish(self, header: dict | None = None) -> Message:
            try:
                await self.conn.send(Message(
                    code=self.code, req_id=self.req_id, flags=Flags.EOF,
                    header=header or {}))
                return await self.conn._next(self.q, self.code)
            finally:
                self.conn.unregister(self.req_id)

        async def abort(self) -> None:
            """Tell the server to drop the stream's temp state (an EOF
            flagged ``abort``), then stop listening. A dead connection
            just unregisters."""
            try:
                await self.conn.send(Message(
                    code=self.code, req_id=self.req_id, flags=Flags.EOF,
                    header={"abort": True}))
            except CurvineError:
                pass
            finally:
                self.conn.unregister(self.req_id)

    async def open_upload(self, code: int, header: dict
                          ) -> "Connection._UploadStream":
        """Start a chunked upload: request frame, then CHUNK*, EOF → ack."""
        req_id = next(_req_ids)
        q = self.register(req_id)
        try:
            await self.send(Message(code=int(code), req_id=req_id,
                                    header=dict(header)))
        except BaseException:
            self.unregister(req_id)
            raise
        return Connection._UploadStream(self, int(code), req_id, q)


class ConnectionPool:
    """Per-address pool with lazy dialing and eviction of broken
    connections; at ``size`` connections an address is served round
    robin."""

    def __init__(self, size: int = 4, timeout_ms: int = 30_000):
        self.size = size
        self.timeout_ms = timeout_ms
        self._conns: dict[str, list[Connection]] = {}
        self._rr: dict[str, int] = {}
        self._lock = asyncio.Lock()

    async def get(self, addr: str) -> Connection:
        async with self._lock:
            conns = self._conns.setdefault(addr, [])
            conns[:] = [c for c in conns if not c.closed]
            if len(conns) >= self.size:
                i = self._rr[addr] = (self._rr.get(addr, -1) + 1) % len(conns)
                return conns[i]
        # dial outside the lock: a slow connect must not stall the others
        conn = await self._dial(addr)
        try:
            async with self._lock:
                conns = self._conns.setdefault(addr, [])
                if len(conns) < self.size:
                    conns.append(conn)
                return conn
        except asyncio.CancelledError:
            await conn.close()
            raise

    async def _dial(self, addr: str, attempts: int = 3) -> Connection:
        last: ConnectError | None = None
        for i in range(attempts):
            try:
                return await Connection(addr, self.timeout_ms).connect()
            except ConnectError as e:
                last = e
                await asyncio.sleep(0.05 * (2 ** i))
        raise last

    async def close(self) -> None:
        async with self._lock:
            for conns in self._conns.values():
                for c in conns:
                    await c.close()
            self._conns.clear()


class RetryPolicy:
    """Exponential backoff with jitter on retryable errors; a server's
    ``retry_after_ms`` hint wins over the backoff."""

    def __init__(self, max_retries: int = 3, base_ms: int = 100,
                 max_ms: int = 5_000):
        self.max_retries = max_retries
        self.base_ms = base_ms
        self.max_ms = max_ms

    async def run(self, fn, *args, **kwargs) -> Any:
        attempt = 0
        while True:
            try:
                return await fn(*args, **kwargs)
            except CurvineError as e:
                if not e.retryable or attempt >= self.max_retries:
                    raise
                if e.retry_after_ms is not None:
                    delay = e.retry_after_ms * (1 + random.random() / 4) \
                        / 1000
                else:
                    delay = min(self.max_ms, self.base_ms * 2 ** attempt)
                    delay = delay * (0.5 + random.random() / 2) / 1000
                log.debug("retry %d after %.3fs: %s", attempt + 1, delay, e)
                await asyncio.sleep(delay)
                attempt += 1
