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
into the ``rpc.<code name>`` histogram of ``metrics`` when one is set,
and the send of its reply, a part of it, into ``rpc.reply_send``.

A connection runs on the wire transport (``rpc/transport.py``; :44-132,
:244, :360): its receive loop decodes many frames a receive through its
``BulkDecoder``, its sends go through its ``CoalescedWriter``, and a file
chunk (``send_chunk_from_file``) is the writer's ``send_file``, so a
READ_BLOCK's ``sendfile`` chunks and its EOF keep their order behind the
frames already queued. A frame longer than ``MAX_FRAME``, or otherwise
malformed, closes its connection and no other. ``stop`` awaits every
writer's close. The server's ``rpc_conf`` (the ``[rpc]`` table) gives
every connection's writer its frames a send; its ``metrics`` registry gets the
writers' ``rpc.send_batch_frames``, ``rpc.bytes_sent``,
``rpc.writer_breaks`` (``rpc.writer_breaks_peer_gone`` of them where the
client had left) and ``rpc.send_queue_depth`` (the frames queued over
all its connections) and the decoders' ``rpc.bytes_recv``.

A request's deadline budget (``rpc/deadline.py``) is restarted on this
process's clock at dispatch and handed to the handler as
``msg.deadline`` (:393-399); a request whose budget is spent fails at
once. ``fault_hook``, when set, is awaited between two checks of the
budget (:152, :393-407) as ``hook(server name, msg)``: it may sleep or raise,
and a False answer drops the request unanswered (the caller's wait runs
out as if the frame were lost); tests use it as a spy and as a wedged
worker. With ``obs`` (a ``Tracer``, ``obs/trace.py``) set, each dispatch
is a server span named after its code, parented on the request's trace
context (``msg.trace``) and ambient for the handler's own downstream
calls; it ends in error on an exception or a cancel (:157-159,
:380-391, :423-443).
Left out: QoS admission and the watchdog."""

from __future__ import annotations

import asyncio
import logging
import socket
import time
from typing import Awaitable, Callable

from curvine_tpu_torch.common.errors import CurvineError
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.deadline import Deadline
from curvine_tpu_torch.rpc.frame import (FIXED, FIXED_LEN, LEN_PREFIX,
                                         VERSION, Flags, Message, error_for,
                                         response_for)
from curvine_tpu_torch.rpc.transport import BulkDecoder, writer_for

log = logging.getLogger(__name__)

STREAM_QUEUE = 256       # chunk frames queued per request before its sink

Handler = Callable[[Message, "ServerConn"], Awaitable[object]]
# async fn(header: dict, view: memoryview, is_eof: bool) -> None
StreamSink = Callable[[dict, memoryview, bool], Awaitable[None]]


class ServerConn:
    """One accepted connection: a single receive loop over its decoder,
    sends through its writer."""

    def __init__(self, sock: socket.socket, loop: asyncio.AbstractEventLoop,
                 rpc_conf=None, metrics=None, depth_cell: dict | None = None):
        self.sock = sock
        self.loop = loop
        try:
            self.peer = sock.getpeername()
        except OSError:
            self.peer = None
        self._streams: dict[int, asyncio.Queue] = {}
        self._sinks: dict[int, StreamSink] = {}
        self._writer = writer_for(sock, loop, rpc_conf, metrics,
                                  self._on_send_broken, "server", depth_cell)
        self._dec = BulkDecoder(metrics=metrics)
        self.metrics = metrics
        self.closed = False

    def _on_send_broken(self, exc: BaseException) -> None:
        # part of a frame may be on the wire: closing the socket ends the
        # receive loop, which tears the connection down. A client that
        # left mid-reply is counted apart from the writer's other breaks
        if self.metrics is not None and isinstance(
                exc, (ConnectionResetError, BrokenPipeError)):
            self.metrics.inc("rpc.writer_breaks_peer_gone")
        self._broken()

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
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass

    async def send(self, msg: Message) -> None:
        if self.closed:
            raise CurvineError("connection closed")
        await self._writer.send(msg)

    async def send_chunk_from_file(self, code: int, req_id: int, f,
                                   offset: int, count: int) -> int:
        """A chunk frame whose payload goes from the block file straight
        to the socket (``sendfile``: the bytes never enter this process),
        queued on the writer behind the frames before it. Returns the
        bytes sent; a file shorter than ``count`` breaks the connection
        (its frame is cut short) and raises."""
        if self.closed:
            raise CurvineError("connection closed")
        prefix = LEN_PREFIX.pack(FIXED_LEN + count) + FIXED.pack(
            VERSION, code, req_id, 0, Flags.RESPONSE | Flags.CHUNK, 0)
        return await self._writer.send_file(prefix, f, offset, count)


class RpcServer:
    def __init__(self, host: str, port: int, name: str = "rpc",
                 rpc_conf=None):
        self.host = host
        self.port = port
        self.name = name
        self.rpc_conf = rpc_conf
        # shared by every connection's writer: rpc.send_queue_depth is the
        # frames queued over all of them
        self._sendq_depth: dict = {"n": 0}
        self._handlers: dict[int, Handler] = {}
        self._lsock: socket.socket | None = None
        self._accept_task: asyncio.Task | None = None
        self._conns: set[ServerConn] = set()
        self._conn_tasks: set[asyncio.Task] = set()
        # optional MetricsRegistry: per-code dispatch latency histograms
        self.metrics = None
        # optional async hook(server name, msg) -> bool, awaited per
        # request: it may sleep or raise; False drops the request
        self.fault_hook = None
        # optional Tracer: a server span per dispatch
        self.obs = None

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
        conns = list(self._conns)
        for conn in conns:
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
        for conn in conns:
            await conn._writer.aclose()
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
            conn = ServerConn(sock, loop, rpc_conf=self.rpc_conf,
                              metrics=self.metrics,
                              depth_cell=self._sendq_depth)
            self._conns.add(conn)
            t = asyncio.ensure_future(self._conn_loop(conn))
            self._conn_tasks.add(t)
            t.add_done_callback(self._conn_tasks.discard)

    async def _conn_loop(self, conn: ServerConn) -> None:
        dec = conn._dec
        pending: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    env = dec.try_next()
                    if env is None:
                        # every frame already buffered was taken above
                        # without touching the socket again
                        await dec.fill(conn.loop, conn.sock)
                        continue
                except (ConnectionResetError, OSError):
                    break
                except CurvineError as e:          # hostile bytes
                    log.warning("%s: malformed frame from %s: %s",
                                self.name, conn.peer, e)
                    break
                code, req_id, status, flags, header, data_len = env
                is_chunk = bool(flags & (Flags.CHUNK | Flags.EOF)) and \
                    not (flags & Flags.RESPONSE)
                if is_chunk and req_id in conn._sinks:
                    if req_id in conn._streams:
                        await conn._drain_queue_into_sink(req_id)
                    try:
                        # a view into the decoder's buffer, valid until
                        # its next call: the sink consumes it inline
                        view = await dec.read_payload(conn.loop, conn.sock,
                                                      data_len)
                    except (ConnectionResetError, OSError):
                        break
                    sink = conn._sinks.get(req_id)
                    if sink is None:       # the sink failed in the drain
                        continue
                    try:
                        await sink(header, view, bool(flags & Flags.EOF))
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        log.exception("%s stream sink", self.name)
                        conn.close_stream(req_id)
                    continue
                data = b""
                if data_len:
                    try:
                        data = bytes(await dec.read_payload(
                            conn.loop, conn.sock, data_len))
                    except (ConnectionResetError, OSError):
                        break
                msg = Message(code=code, req_id=req_id, status=status,
                              flags=flags, header=header, data=data)
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
            await conn._writer.aclose()
            try:
                conn.sock.close()
            except OSError:
                pass

    async def _dispatch(self, msg: Message, conn: ServerConn) -> None:
        handler = self._handlers.get(msg.code)
        name = _code_name(msg.code)
        # the caller's span rides the header as the deadline does; the
        # dispatch's span is ambient for the handler's own calls
        msg.trace = msg.trace_ctx()
        span = None
        if self.obs is not None:
            span = self.obs.span(name, parent=msg.trace)
            span.__enter__()
        t0 = time.perf_counter()
        try:
            msg.deadline = Deadline.from_header(msg.header)
            if msg.deadline is not None:
                msg.deadline.check(f"{self.name} {name}")
            if self.fault_hook is not None:
                if not await self.fault_hook(self.name, msg):
                    return          # dropped: no answer
                if msg.deadline is not None:
                    # the budget may have run out behind the hook: the
                    # caller gave up, so the work would be dead
                    msg.deadline.check(f"{self.name} {name}")
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
            t1 = time.perf_counter()
            await conn.send(response_for(msg, header=header, data=data,
                                         flags=Flags.RESPONSE | Flags.EOF))
            if self.metrics is not None:
                self.metrics.observe("rpc.reply_send",
                                     time.perf_counter() - t1)
        except asyncio.CancelledError:
            if span is not None:
                span.error("cancelled")
            raise
        except Exception as e:  # noqa: BLE001 — every error crosses the wire
            if span is not None:
                span.error(e)
            if not isinstance(e, CurvineError):
                log.exception("%s handler error code=%s", self.name,
                              msg.code)
            try:
                await conn.send(error_for(msg, e))
            except Exception:  # noqa: BLE001 — the connection died
                pass
        finally:
            if span is not None:
                span.__exit__(None, None, None)
            if self.metrics is not None:
                self.metrics.observe(f"rpc.{name}",
                                     time.perf_counter() - t0)


def _code_name(code: int) -> str:
    try:
        return RpcCode(code).name.lower()
    except ValueError:
        return f"code_{code}"
