"""RPC server: accept loop, handler registry, streaming support.

Own copy of ``curvine_tpu/rpc/server.py:44-453`` (``ServerConn``,
``RpcServer``) on the port's framing (``rpc/frame.py``) and codec
(``rpc/wirepack.py``). Handlers are registered per ``RpcCode``. A
handler may:

* return a ``(header, data)`` tuple, a dict (the header) or bytes (the
  data) → one response frame, flagged EOF;
* call ``conn.send`` or ``conn.send_chunk_from_file`` itself for a
  streamed response and return None after its EOF frame;
* consume an inbound chunk stream through ``conn.set_stream_sink``: an
  async callback run inline in the connection's receive loop, once per
  CHUNK or EOF frame of its request id. Chunks that arrive before the
  sink is set wait in a bounded queue and are replayed into it.

A handler's exception goes back to the caller as an error frame with the
reference's error code (``frame.error_for``), so the JAX client and the
port's client re-raise the same ``CurvineError``. Each dispatch is timed
into the ``rpc.<code name>`` histogram of ``metrics`` when one is set.

Left out: the transport's ``CoalescedWriter`` (each frame is written by
``sock_sendall`` under a per-connection lock, a file chunk by
``sock_sendfile``) and ``BulkDecoder`` (frames are read through the
client's buffered reader, ``rpc.client._Recv``), QoS admission, the
fault hook, the watchdog, deadlines and tracing."""

from __future__ import annotations

import asyncio
import logging
import socket
import time
from typing import Awaitable, Callable

from curvine_tpu_torch.common.errors import CurvineError
from curvine_tpu_torch.rpc.client import _Recv
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import (ENVELOPE_MAX, FIXED, FIXED_LEN,
                                         LEN_PREFIX, VERSION, Flags, Message,
                                         decode_header, error_for,
                                         parse_envelope, response_for)

log = logging.getLogger(__name__)

STREAM_QUEUE = 256       # chunk frames queued per request before its sink

Handler = Callable[[Message, "ServerConn"], Awaitable[object]]
# async fn(header: dict, view: memoryview, is_eof: bool) -> None
StreamSink = Callable[[dict, memoryview, bool], Awaitable[None]]


class ServerConn:
    """One accepted connection: a single receive loop, sends serialised
    by a lock."""

    def __init__(self, sock: socket.socket, loop: asyncio.AbstractEventLoop):
        self.sock = sock
        self.loop = loop
        try:
            self.peer = sock.getpeername()
        except OSError:
            self.peer = None
        self._streams: dict[int, asyncio.Queue] = {}
        self._sinks: dict[int, StreamSink] = {}
        self._send_lock = asyncio.Lock()
        self.closed = False

    # -------- inbound streams --------

    def open_stream(self, req_id: int) -> asyncio.Queue:
        q = self._streams.get(req_id)
        if q is None:
            q = self._streams[req_id] = asyncio.Queue(maxsize=STREAM_QUEUE)
        return q

    def close_stream(self, req_id: int) -> None:
        self._streams.pop(req_id, None)
        self._sinks.pop(req_id, None)

    def set_stream_sink(self, req_id: int, sink: StreamSink) -> None:
        """Consume the request's chunk frames with ``sink``; chunks that
        raced ahead of it (queued) are replayed into it first."""
        self._sinks[req_id] = sink
        q = self._streams.get(req_id)
        if q is not None and not q.empty():
            asyncio.ensure_future(self._drain_queue_into_sink(req_id))

    async def _drain_queue_into_sink(self, req_id: int) -> None:
        q = self._streams.get(req_id)
        sink = self._sinks.get(req_id)
        while q is not None and sink is not None and not q.empty():
            m = q.get_nowait()
            try:
                await sink(m.header, memoryview(m.data), m.is_eof)
            except Exception:
                log.exception("stream sink (drain)")
                self.close_stream(req_id)
                return
            sink = self._sinks.get(req_id)

    # -------- sends --------

    def _broken(self) -> None:
        # a frame may be half on the wire: the stream cannot be used again
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass

    async def send(self, msg: Message) -> None:
        if self.closed:
            raise CurvineError("connection closed")
        async with self._send_lock:
            try:
                for buf in msg.encode():
                    await self.loop.sock_sendall(self.sock, buf)
            except BaseException:
                self._broken()
                raise

    async def send_chunk_from_file(self, code: int, req_id: int, f,
                                   offset: int, count: int) -> int:
        """A chunk frame whose payload goes from the block file straight
        to the socket (``sendfile``: the bytes never enter this process).
        Returns the bytes sent; a file shorter than ``count`` breaks the
        connection (its frame is cut short) and raises."""
        if self.closed:
            raise CurvineError("connection closed")
        prefix = LEN_PREFIX.pack(FIXED_LEN + count) + FIXED.pack(
            VERSION, code, req_id, 0, Flags.RESPONSE | Flags.CHUNK, 0)
        async with self._send_lock:
            try:
                await self.loop.sock_sendall(self.sock, prefix)
                sent = await self.loop.sock_sendfile(self.sock, f, offset,
                                                     count)
            except BaseException:
                self._broken()
                raise
            if sent != count:
                self._broken()
                raise CurvineError(f"sendfile sent {sent} of {count} bytes")
        return sent


class RpcServer:
    def __init__(self, host: str, port: int, name: str = "rpc"):
        self.host = host
        self.port = port
        self.name = name
        self._handlers: dict[int, Handler] = {}
        self._lsock: socket.socket | None = None
        self._accept_task: asyncio.Task | None = None
        self._conns: set[ServerConn] = set()
        self._conn_tasks: set[asyncio.Task] = set()
        # optional MetricsRegistry: per-code dispatch latency histograms
        self.metrics = None

    def register(self, code: int, handler: Handler) -> None:
        self._handlers[int(code)] = handler

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(128)
        sock.setblocking(False)
        self._lsock = sock
        if self.port == 0:
            self.port = sock.getsockname()[1]
        self._accept_task = asyncio.ensure_future(self._accept_loop(loop))
        log.info("%s server listening on %s:%d", self.name, self.host,
                 self.port)

    async def stop(self) -> None:
        accept = self._accept_task
        if accept is not None:
            accept.cancel()
            self._accept_task = None
        if self._lsock is not None:
            self._lsock.close()
            self._lsock = None
        for conn in list(self._conns):
            conn._broken()
        tasks = list(self._conn_tasks)
        for t in tasks:
            t.cancel()
        # await the teardown: a dispatch resuming after stop() returns
        # would touch state its caller is about to release
        for t in ([accept] if accept is not None else []) + tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._conns.clear()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def _accept_loop(self, loop) -> None:
        while True:
            try:
                sock, _ = await loop.sock_accept(self._lsock)
            except (asyncio.CancelledError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = ServerConn(sock, loop)
            self._conns.add(conn)
            t = asyncio.ensure_future(self._conn_loop(conn))
            self._conn_tasks.add(t)
            t.add_done_callback(self._conn_tasks.discard)

    async def _conn_loop(self, conn: ServerConn) -> None:
        rx = _Recv(conn.loop, conn.sock)
        pending: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    code, req_id, status, flags, hdr_len, data_len = \
                        parse_envelope(await rx.exactly(ENVELOPE_MAX))
                    header = decode_header(await rx.exactly(hdr_len)) \
                        if hdr_len else {}
                    data = await rx.exactly(data_len) if data_len else b""
                except (ConnectionResetError, OSError):
                    break
                except CurvineError as e:          # hostile bytes
                    log.warning("%s: malformed frame from %s: %s",
                                self.name, conn.peer, e)
                    break
                msg = Message(code=code, req_id=req_id, status=status,
                              flags=flags, header=header, data=data)
                is_chunk = bool(flags & (Flags.CHUNK | Flags.EOF)) and \
                    not (flags & Flags.RESPONSE)
                if is_chunk and req_id in conn._sinks:
                    if req_id in conn._streams:
                        await conn._drain_queue_into_sink(req_id)
                    sink = conn._sinks.get(req_id)
                    if sink is None:       # the sink failed in the drain
                        continue
                    try:
                        await sink(header, memoryview(data),
                                   bool(flags & Flags.EOF))
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        log.exception("%s stream sink", self.name)
                        conn.close_stream(req_id)
                    continue
                if is_chunk:
                    # never block the receive loop on a stream no handler
                    # consumes: shed the oldest chunk, and a real upload
                    # fails its length or crc check at EOF
                    q = conn.open_stream(req_id)
                    if q.full():
                        q.get_nowait()
                    q.put_nowait(msg)
                    continue
                t = asyncio.ensure_future(self._dispatch(msg, conn))
                pending.add(t)
                t.add_done_callback(pending.discard)
        finally:
            conn.closed = True
            self._conns.discard(conn)
            for t in pending:
                t.cancel()
            for t in list(pending):
                try:
                    await t
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            try:
                conn.sock.close()
            except OSError:
                pass

    async def _dispatch(self, msg: Message, conn: ServerConn) -> None:
        handler = self._handlers.get(msg.code)
        t0 = time.perf_counter()
        try:
            if handler is None:
                raise CurvineError(f"no handler for code {msg.code}")
            result = await handler(msg, conn)
            if result is None:
                return              # the handler streamed its own response
            if isinstance(result, tuple):
                header, data = result
            elif isinstance(result, (bytes, bytearray, memoryview)):
                header, data = {}, result
            else:
                header, data = result, b""
            await conn.send(response_for(msg, header=header, data=data,
                                         flags=Flags.RESPONSE | Flags.EOF))
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — every error crosses the wire
            if not isinstance(e, CurvineError):
                log.exception("%s handler error code=%s", self.name,
                              msg.code)
            try:
                await conn.send(error_for(msg, e))
            except Exception:  # noqa: BLE001 — the connection died
                pass
        finally:
            if self.metrics is not None:
                self.metrics.observe(f"rpc.{_code_name(msg.code)}",
                                     time.perf_counter() - t0)


def _code_name(code: int) -> str:
    try:
        return RpcCode(code).name.lower()
    except ValueError:
        return f"code_{code}"
