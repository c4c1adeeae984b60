"""RPC client: connection, response routing, pool and retry policy.

Own copy of ``curvine_tpu/rpc/client.py:47-533`` over plain ``asyncio``
socket calls, on the wire transport of ``rpc/transport.py``
(:47-235, :314-348): a connection's sends go through its
``CoalescedWriter`` (the frames of concurrent requests leave in vectored
batches; a cancelled send whose frame is still queued is dropped whole
and the connection stays usable), and its read loop decodes many frames
a receive through its ``BulkDecoder``. One connection multiplexes
concurrent requests by ``req_id``; the read loop routes each response
frame, a streamed response's CHUNK frames and its EOF, to its waiter; an
upload streams CHUNK frames and an EOF and awaits the ack.
``call_readinto`` (:314-346) registers the caller's buffer as the
request's sink: the read loop copies what the decoder has buffered of
each chunk's payload into it and receives the rest straight into it
(``BulkDecoder.recv_sink``), and only the EOF (its trailer merged into
``eof_header``) or an error reaches the waiter. A writer that broke
mid-frame closes the connection (``_on_send_broken``), and the read loop
fails every waiter out. A ``call_readinto`` that leaves (a timeout, a
cancel) unregisters its sink, and the read loop checks the sink before
each receive into the caller's buffer: the rest of a frame it was
receiving there, should a stalled server resume, goes to the decoder's
buffer and is dropped, never into a buffer the caller has handed on,
and the connection stays usable. ``Connection`` and ``ConnectionPool``
take the ``[rpc]`` table (``rpc_conf``: the writer's frames a send) and
a ``metrics`` registry for the transport's counters.

``call``, ``call_stream`` and ``call_readinto`` take a ``deadline``
(``rpc/deadline.py``), as the reference's do (:238-346): its remaining
budget is stamped into the request header, and each wait for a reply is
capped by it. Every request that carries no trace context gets the
ambient one (``obs/trace.py::current_ctx``, :247-252), so the server's
span links to the span the request was made under. ``RetryPolicy.run``
takes a ``deadline`` too, and never sleeps past it (:495-530).
Left out: the io_uring ``RingRecv`` (the transport's note), the tenant
header, the client fault hook and the server-push receiver."""

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
from curvine_tpu_torch.obs.trace import TRACE_KEY, current_ctx
from curvine_tpu_torch.rpc.deadline import Deadline
from curvine_tpu_torch.rpc.frame import STATUS_ERROR, Flags, Message
from curvine_tpu_torch.rpc.transport import (BulkDecoder, CoalescedWriter,
                                             writer_for)

log = logging.getLogger(__name__)

_req_ids = itertools.count(1)


@dataclass
class _Sink:
    """The caller's buffer of a ``call_readinto``: chunk payloads land in
    ``view`` at ``filled``."""

    view: memoryview
    filled: int = 0


class Connection:
    """One TCP connection; multiplexes concurrent requests by req_id."""

    def __init__(self, addr: str, timeout_ms: int = 30_000, rpc_conf=None,
                 metrics=None):
        self.addr = addr
        self.timeout = timeout_ms / 1000
        self.rpc_conf = rpc_conf
        self.metrics = metrics
        self._sock: socket.socket | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._waiters: dict[int, asyncio.Queue] = {}
        self._sinks: dict[int, _Sink] = {}
        self._reader_task: asyncio.Task | None = None
        self._writer: CoalescedWriter | None = None
        self._dec: BulkDecoder | None = None
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
        self._writer = writer_for(sock, self._loop, self.rpc_conf,
                                  self.metrics, self._on_send_broken,
                                  f"client {self.addr}")
        self._dec = BulkDecoder(metrics=self.metrics)
        self._reader_task = asyncio.ensure_future(self._read_loop())
        return self

    def _on_send_broken(self, exc: BaseException) -> None:
        # part of a frame may be on the wire: the stream cannot be used
        # again, so the pool must not hand it out, and closing the socket
        # makes the read loop fail every waiter out
        self.closed = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    # ---------------- receive ----------------

    async def _read_loop(self) -> None:
        dec, loop, sock = self._dec, self._loop, self._sock
        try:
            while True:
                env = dec.try_next()
                if env is None:
                    await dec.fill(loop, sock)
                    continue
                code, req_id, status, flags, header, data_len = env
                sink = self._sinks.get(req_id)
                data = b""
                if sink is not None and status == 0 and \
                        sink.filled + data_len <= len(sink.view):
                    # the buffered part of the payload is copied into the
                    # caller's buffer, the rest received straight into it;
                    # a chunk frame then has nothing left to deliver
                    if data_len:
                        dst = sink.view[sink.filled:sink.filled + data_len]
                        got = dec.take_into(dst)
                        if got < data_len:
                            await dec.recv_sink(
                                loop, sock, dst[got:],
                                lambda: self._sinks.get(req_id) is sink)
                        sink.filled += data_len
                    if flags & Flags.CHUNK:
                        continue
                elif data_len:
                    data = bytes(await dec.read_payload(loop, sock,
                                                        data_len))
                q = self._waiters.get(req_id)
                if q is None:
                    log.debug("drop frame without a waiter: req_id=%d code"
                              "=%d", req_id, code)
                else:
                    q.put_nowait(Message(code=code, req_id=req_id,
                                         status=status, flags=flags,
                                         header=header, data=data))
        except (ConnectionResetError, OSError, asyncio.CancelledError):
            pass
        except Exception:
            log.exception("connection %s read loop", self.addr)
        finally:
            self.closed = True
            # every broken connection ends here: take the writer down
            # with it, or its task waits for ever
            if self._writer is not None:
                self._writer.close()
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
        if self._writer is not None:
            await self._writer.aclose()
        if self._reader_task is not None:
            self._reader_task.cancel()
            await asyncio.gather(self._reader_task, return_exceptions=True)
            self._reader_task = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    # ---------------- send ----------------

    async def send(self, msg: Message) -> None:
        if self.closed or self._writer is None:
            raise ConnectError(f"connection {self.addr} is closed")
        try:
            await self._writer.send(msg)
        except ConnectError:
            self.closed = True
            raise
        except (OSError, RuntimeError) as e:
            # the writer broke, and closed the connection through
            # _on_send_broken; a cancel passes through untouched: a
            # queued frame was dropped whole, an inline one broke it
            self.closed = True
            raise ConnectError(f"send to {self.addr}: {e}") from e

    def register(self, req_id: int) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._waiters[req_id] = q
        return q

    def unregister(self, req_id: int) -> None:
        self._waiters.pop(req_id, None)
        self._sinks.pop(req_id, None)

    async def _next(self, q: asyncio.Queue, code: int,
                    deadline: Deadline | None = None) -> Message:
        wait = deadline.cap(self.timeout) if deadline is not None \
            else self.timeout
        try:
            rep: Message = await asyncio.wait_for(q.get(), wait)
        except asyncio.TimeoutError as e:
            raise RpcTimeout(f"rpc {code} to {self.addr} timed out") from e
        return rep.check()

    # ---------------- request patterns ----------------

    @staticmethod
    def _stamped(code: int, header: dict | None,
                 deadline: Deadline | None = None) -> dict:
        """The request header with the deadline's remaining budget and
        the ambient trace context; a spent budget raises before anything
        is sent."""
        header = dict(header or {})
        if deadline is not None:
            deadline.check(f"rpc {code}")
            deadline.stamp(header)
        ctx = current_ctx()
        if ctx is not None and TRACE_KEY not in header:
            ctx.stamp(header)
        return header

    async def call(self, code: int, data: bytes | memoryview = b"",
                   deadline: Deadline | None = None) -> Message:
        """Unary request (its body in ``data``) → single response."""
        req_id = next(_req_ids)
        q = self.register(req_id)
        try:
            await self.send(Message(code=int(code), req_id=req_id,
                                    header=self._stamped(code, None,
                                                         deadline),
                                    data=data))
            return await self._next(q, code, deadline)
        finally:
            self.unregister(req_id)

    async def call_stream(self, code: int, header: dict,
                          deadline: Deadline | None = None
                          ) -> AsyncIterator[Message]:
        """Unary request → stream of chunk frames ending with EOF."""
        req_id = next(_req_ids)
        q = self.register(req_id)
        try:
            await self.send(Message(code=int(code), req_id=req_id,
                                    header=self._stamped(code, header,
                                                         deadline)))
            while True:
                rep = await self._next(q, code, deadline)
                yield rep
                if rep.is_eof:
                    return
        finally:
            self.unregister(req_id)

    async def call_readinto(self, code: int, sink: memoryview,
                            header: dict,
                            eof_header: dict | None = None,
                            deadline: Deadline | None = None) -> int:
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
                                    header=self._stamped(code, header,
                                                         deadline)))
            while True:
                rep = await self._next(q, code, deadline)
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
                                    header=self._stamped(code, header)))
        except BaseException:
            self.unregister(req_id)
            raise
        return Connection._UploadStream(self, int(code), req_id, q)


class ConnectionPool:
    """Per-address pool with lazy dialing and eviction of broken
    connections; at ``size`` connections an address is served round
    robin."""

    def __init__(self, size: int = 4, timeout_ms: int = 30_000,
                 rpc_conf=None, metrics=None):
        self.size = size
        self.timeout_ms = timeout_ms
        self.rpc_conf = rpc_conf
        self.metrics = metrics
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
                conns[:] = [c for c in conns if not c.closed]
                if len(conns) < self.size:
                    conns.append(conn)
                    return conn
                # others filled the pool meanwhile: a connection outside
                # it would never be closed, and its read loop, cancelled
                # when the event loop ends, would keep the caller's frames
                i = self._rr[addr] = (self._rr.get(addr, -1) + 1) % len(conns)
                spare, conn = conn, conns[i]
        except asyncio.CancelledError:
            await conn.close()
            raise
        await spare.close()
        return conn

    async def _dial(self, addr: str, attempts: int = 3) -> Connection:
        last: ConnectError | None = None
        for i in range(attempts):
            try:
                return await Connection(addr, self.timeout_ms,
                                        self.rpc_conf, self.metrics).connect()
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
    ``retry_after_ms`` hint wins over the backoff. With a ``deadline``
    the policy never sleeps past the budget: when the next backoff would
    cross it, the last error is raised at once."""

    def __init__(self, max_retries: int = 3, base_ms: int = 100,
                 max_ms: int = 5_000):
        self.max_retries = max_retries
        self.base_ms = base_ms
        self.max_ms = max_ms

    async def run(self, fn, *args, deadline: Deadline | None = None,
                  **kwargs) -> Any:
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
                if deadline is not None and delay >= deadline.remaining():
                    raise            # the sleep would outlive the budget
                log.debug("retry %d after %.3fs: %s", attempt + 1, delay, e)
                await asyncio.sleep(delay)
                attempt += 1
