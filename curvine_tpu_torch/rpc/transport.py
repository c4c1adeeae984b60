"""The wire transport under the RPC client and server: a coalesced writer
and a bulk frame decoder for each connection, and the registered receive
pool.

Own copy of ``curvine_tpu/rpc/transport.py`` (:1-906) on the port's
framing (``rpc/frame.py``). The frames on the wire are the same bytes
either way: coalescing changes how many frames leave in one system call,
not what they are.

Send side, ``CoalescedWriter`` (:508-791): each connection owns one
writer. A frame sent while nothing is queued and no batch is being
written goes out inline, at once. Otherwise it is queued, and the
writer's task drains the queue: every frame queued within one turn of
the event loop leaves in one vectored ``sendmsg`` (bounded by
``SEND_COALESCE_BYTES`` and ``rpc.send_coalesce_frames``), small frames
flattened into one buffer, a payload above ``SEND_INLINE_MAX`` kept as
its own iovec entry, uncopied. A ``send_file`` item (a READ_BLOCK chunk
by ``sendfile``) runs alone, in FIFO order behind the frames queued
before it, and a file shorter than its frame breaks the connection.

Cancellation: a caller cancelled while its frame is still queued has it
dropped whole, before any of its bytes reach the wire, and the
connection stays usable; a frame the writer already took is written out
whole. A cancel during an inline write, or the writer failing mid-batch,
may leave part of a frame on the wire: the writer is then broken
(``broken``), refuses every later send, and calls ``on_broken``, whose
owner closes the socket.

Receive side, ``BulkDecoder`` (:794-906): one reusable, grow-only buffer
a connection; one ``sock_recv_into`` usually lands many frames, whose
envelopes are decoded back to back (``frame.decode_envelope``) with no
further system call. A payload that is not all buffered is completed by
exact reads: into the caller's view for a sink (``recv_sink``, the
zero-copy block read, checked before each receive: once the sink's
owner has left, the rest goes to the decoder's buffer, ``recv_while``),
into the decoder's buffer up to
``RECV_RETAIN_MAX``, and into a transient buffer past it, so that one
giant frame does not keep its size for the connection's life.

``RegisteredBuffers`` and ``recv_pool`` (:258-440): page-aligned,
mmap-backed receive buffers by power-of-two size class, reused up to a
byte cap (32 MiB, the reference's ``recv_registered_bytes``); the reader's prefetch segments
cycle through the process-wide pool, and ``alloc_aligned`` (:74-82)
gives the aligned destinations its ``pread_view`` and ``read_range``
return. "Pinned" counts the bytes checked out to callers, not memory
locked for the device (the feed stages through ``PinnedStager``). The
pool takes a lock: the workers of one process run on loops of their own
threads.

Left out: ``RingRecv`` (:108-255), the io_uring registered receive,
which is built on the worker's io engine's ``UringRing``; it waits for
the worker's direct IO (ROADMAP §A item 3). ``ring()`` answers None,
``ring_registered()`` False, and ``stats()`` keeps the reference's seven
keys, ``fixed_ops`` and ``fixed_bytes`` at 0."""

from __future__ import annotations

import asyncio
import logging
import mmap
import socket
import threading
import weakref
from collections import deque

import numpy as np

from curvine_tpu_torch.common.errors import ConnectError, CurvineError
from curvine_tpu_torch.rpc.frame import Message, decode_envelope

log = logging.getLogger(__name__)

SEND_COALESCE_BYTES = 256 * 1024
SEND_COALESCE_FRAMES = 128
SEND_INLINE_MAX = 8 * 1024
RECV_BUFFER_BYTES = 256 * 1024
# a payload longer than the receive buffer grows it up to this size;
# past it the payload goes through a transient buffer
RECV_RETAIN_MAX = 8 * 1024 * 1024
# iovec entries a sendmsg (Linux's IOV_MAX is 1024)
_IOV_CAP = 512

_ALIGNED_MIN = 256 * 1024           # reads this large get aligned buffers
_REGISTERED_MIN = 64 * 1024         # the pool's smallest size class
_REGISTERED_MAX = 8 * 1024 * 1024   # and its largest


def alloc_aligned(n: int) -> np.ndarray:
    """A page-aligned uint8 array of length ``n`` over an anonymous mmap,
    freed with its last view."""
    if n <= 0:
        return np.empty(0, dtype=np.uint8)
    return np.frombuffer(mmap.mmap(-1, n), dtype=np.uint8, count=n)


class RegisteredBuffers:
    """A bounded pool of page-aligned mmap regions by power-of-two size
    class. ``acquire(n)`` gives a uint8 view of length ``n`` on a region;
    ``release(view)`` parks the region for reuse while the pool holds at
    most ``max_bytes``. Only the reader's own segments are released; a
    buffer that reaches a caller is collected with its last view.

    ``retained`` counts the parked bytes, ``pinned`` the bytes checked
    out. Each checkout has one token, cleared once by whichever of
    ``release`` and the view's collection comes first, so a view a
    caller keeps is never counted twice; a double release is a no-op
    (parking a region twice would hand it to two acquirers)."""

    def __init__(self, max_bytes: int = 32 * 1024 * 1024,
                 min_size: int = _REGISTERED_MIN,
                 max_size: int = _REGISTERED_MAX):
        self.min_size = min_size
        self.max_size = max_size
        self.max_bytes = max(0, max_bytes)
        self.retained = 0
        self.pinned = 0
        self.acquired = 0
        self.reused = 0
        self._free: dict[int, list[mmap.mmap]] = {}
        self._resident: set[int] = set()     # id(region) of parked ones
        self._out: dict[int, list] = {}      # id(region) -> its token
        # reentrant: a view in a reference cycle is finalized by whichever
        # thread runs the collector, which may be one inside this lock
        self._lock = threading.RLock()

    def _cls(self, n: int) -> int:
        size = self.min_size
        while size < n:
            size *= 2
        return size

    def _unpin(self, token: list, key: int) -> None:
        with self._lock:
            if token[0]:
                self.pinned -= token[0]
                token[0] = 0
            # a region released and acquired again carries a newer token
            if self._out.get(key) is token:
                del self._out[key]

    def acquire(self, n: int) -> np.ndarray:
        """A uint8 view of length ``n`` on an aligned region (its
        ``.base`` chain ends at the region, which ``release`` finds)."""
        if n <= 0:
            return np.empty(0, dtype=np.uint8)
        if n > self.max_size:
            return alloc_aligned(n)          # never pooled
        size = self._cls(n)
        with self._lock:
            free = self._free.get(size)
            mm = free.pop() if free else None
            if mm is not None:
                self.retained -= size
                self._resident.discard(id(mm))
                self.reused += 1
        if mm is None:
            mm = mmap.mmap(-1, size)
        token = [size]
        with self._lock:
            self.acquired += 1
            self.pinned += size
            self._out[id(mm)] = token
        arr = np.frombuffer(mm, dtype=np.uint8, count=size)[:n]
        # a view that reaches a caller and is never released unpins when
        # it is collected (views keep their base alive, so only then)
        weakref.finalize(arr, self._unpin, token, id(mm))
        return arr

    def release(self, arr) -> None:
        """Park an ``acquire``d view's region for reuse; a no-op for any
        other buffer and for a second release."""
        base = getattr(arr, "base", None)
        while base is not None and not isinstance(base, mmap.mmap):
            # numpy's chain of views ends in a memoryview of the region
            base = base.obj if isinstance(base, memoryview) \
                else getattr(base, "base", None)
        if not isinstance(base, mmap.mmap):
            return
        size = len(base)
        if size < self.min_size or size > self.max_size:
            return
        with self._lock:
            if id(base) in self._resident:
                return
            token = self._out.pop(id(base), None)
            if token is not None and token[0]:
                self.pinned -= token[0]
                token[0] = 0
            if self.retained + size <= self.max_bytes:
                self._free.setdefault(size, []).append(base)
                self._resident.add(id(base))
                self.retained += size

    def ring(self) -> None:
        """The io_uring registered receive: not in the port (ROADMAP §A
        item 3), so every sink payload takes ``sock_recv_into``."""
        return None

    def ring_registered(self) -> bool:
        return False

    def stats(self) -> dict:
        """The pool's gauges and counters; the worker exports them as
        ``rpc.recv_<key>``."""
        return {"registered_bytes": self.retained,
                "pinned_bytes": self.pinned,
                "acquired": self.acquired,
                "reused": self.reused,
                "ring_registered": 0,
                "fixed_ops": 0,
                "fixed_bytes": 0}

    def drain(self) -> None:
        """Return every parked region to the system."""
        with self._lock:
            regions = [mm for lst in self._free.values() for mm in lst]
            self._free.clear()
            self._resident.clear()
            self.retained = 0
        for mm in regions:
            try:
                mm.close()
            except BufferError:
                pass                         # a live view keeps it


_recv_pool: RegisteredBuffers | None = None
_recv_pool_lock = threading.Lock()


def recv_pool() -> RegisteredBuffers:
    """The process's registered receive pool."""
    global _recv_pool
    with _recv_pool_lock:
        if _recv_pool is None:
            _recv_pool = RegisteredBuffers()
        return _recv_pool


async def recv_exact(loop: asyncio.AbstractEventLoop, sock: socket.socket,
                     view: memoryview) -> None:
    """Fill ``view`` from the socket; a peer's close raises
    ``ConnectionResetError``."""
    off, n = 0, len(view)
    while off < n:
        got = await loop.sock_recv_into(sock, view[off:])
        if got == 0:
            raise ConnectionResetError("peer closed")
        off += got


async def recv_while(loop: asyncio.AbstractEventLoop, sock: socket.socket,
                     view: memoryview, live) -> int:
    """Fill ``view`` from the socket while ``live()`` holds, checked
    before each receive, so that no byte lands in ``view`` once its owner
    has left (a pending ``sock_recv_into`` would write into it whenever
    the peer sent); returns the bytes received into it. A peer's close
    raises ``ConnectionResetError``."""
    off, n = 0, len(view)
    while off < n and live():
        try:
            got = sock.recv_into(view[off:])
        except (BlockingIOError, InterruptedError):
            await _wait_readable(loop, sock)
            continue
        if got == 0:
            raise ConnectionResetError("peer closed")
        off += got
    return off


async def _wait_readable(loop: asyncio.AbstractEventLoop,
                         sock: socket.socket) -> None:
    fut = loop.create_future()
    fd = sock.fileno()

    def ready() -> None:
        if not fut.done():
            fut.set_result(None)

    loop.add_reader(fd, ready)
    try:
        await fut
    finally:
        loop.remove_reader(fd)


async def _wait_writable(loop: asyncio.AbstractEventLoop,
                         sock: socket.socket) -> None:
    fut = loop.create_future()
    fd = sock.fileno()

    def ready() -> None:
        if not fut.done():
            fut.set_result(None)

    loop.add_writer(fd, ready)
    try:
        await fut
    finally:
        loop.remove_writer(fd)


async def vectored_sendall(loop: asyncio.AbstractEventLoop,
                           sock: socket.socket, bufs: list) -> None:
    """Every buffer of ``bufs`` on the wire, one non-blocking ``sendmsg``
    a window of writability (asyncio has no ``sock_sendmsg``, so the wait
    is ``add_writer``'s); a loop without ``add_writer`` finishes with
    ``sock_sendall``s."""
    if not hasattr(sock, "sendmsg"):
        for b in bufs:
            await loop.sock_sendall(sock, b)
        return
    idx, off, n = 0, 0, len(bufs)
    while idx < n:
        iov = [memoryview(bufs[idx])[off:]]
        iov.extend(bufs[idx + 1:idx + _IOV_CAP])
        try:
            sent = sock.sendmsg(iov)
        except (BlockingIOError, InterruptedError):
            sent = 0
        while sent > 0 and idx < n:
            rem = len(bufs[idx]) - off
            if sent >= rem:
                sent -= rem
                idx += 1
                off = 0
            else:
                off += sent
                sent = 0
        if idx < n:
            try:
                await _wait_writable(loop, sock)
            except NotImplementedError:
                for i in range(idx, n):
                    b = memoryview(bufs[i])[off:] if i == idx else bufs[i]
                    off = 0
                    await loop.sock_sendall(sock, b)
                return


class _SendItem:
    __slots__ = ("head", "big", "size", "fut", "file", "offset", "count")

    def __init__(self, head, big, size, fut, file=None, offset=0, count=0):
        self.head = head      # the envelope, with a small payload inlined
        self.big = big        # a large payload, sent uncopied
        self.size = size
        self.fut = fut
        self.file = file      # a sendfile item runs alone, in FIFO order
        self.offset = offset
        self.count = count


class CoalescedWriter:
    """One connection's writer; the module docstring has its batching and
    cancellation contract. ``metrics`` gets ``rpc.send_batch_frames`` (a
    histogram of frames a send), ``rpc.bytes_sent``, ``rpc.writer_breaks``
    (once, at the first break) and the gauge ``rpc.send_queue_depth``,
    counted in ``depth_cell``, which a server shares across its
    connections."""

    def __init__(self, sock: socket.socket, loop: asyncio.AbstractEventLoop,
                 *, max_bytes: int = SEND_COALESCE_BYTES,
                 max_frames: int = SEND_COALESCE_FRAMES,
                 inline_max: int = SEND_INLINE_MAX, metrics=None,
                 depth_cell: dict | None = None, on_broken=None,
                 name: str = "rpc"):
        self.sock = sock
        self.loop = loop
        self.max_bytes = max(1, max_bytes)
        self.max_frames = max(1, max_frames)
        self.inline_max = inline_max
        self.metrics = metrics
        self._depth = depth_cell if depth_cell is not None else {"n": 0}
        self.on_broken = on_broken
        self.name = name
        self._q: deque[_SendItem] = deque()
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        # the wire, between the writer's batches and an inline send;
        # never held across an idle wait
        self._io_lock = asyncio.Lock()
        self.broken: BaseException | None = None
        self.closed = False
        self.bytes_sent = 0

    def qsize(self) -> int:
        return len(self._q)

    def _refuse_if_down(self) -> None:
        if self.closed:
            raise ConnectError(f"{self.name}: connection closed")
        if self.broken is not None:
            raise ConnectError(f"{self.name}: connection broken: "
                               f"{self.broken}")

    # -------- producers --------

    def _enqueue(self, item: _SendItem) -> None:
        self._refuse_if_down()
        self._q.append(item)
        self._bump(1)
        self._wake.set()
        if self._task is None:
            self._task = self.loop.create_task(self._run())

    async def _await_item(self, item: _SendItem):
        try:
            return await item.fut
        except asyncio.CancelledError:
            # a frame still queued is dropped before any byte of it
            # leaves; one the writer took is written out whole: the
            # stream stays whole either way
            try:
                self._q.remove(item)
                self._bump(-1)
            except ValueError:
                pass
            raise

    async def send(self, msg: Message) -> None:
        if not self._q and not self._io_lock.locked():
            # nothing queued, no batch on the wire: write inline. The
            # check and the lock's acquire have no await between them,
            # so no batch can interleave
            self._refuse_if_down()
            await self._send_inline(msg)
            return
        head = bytearray()
        big = msg.encode_into(head, self.inline_max)
        item = _SendItem(head, big, len(head) + (len(big) if big is not None
                                                 else 0),
                         self.loop.create_future())
        self._enqueue(item)
        await self._await_item(item)

    async def _send_inline(self, msg: Message) -> None:
        head = bytearray()
        big = msg.encode_into(head, self.inline_max)
        nbytes = len(head) + (len(big) if big is not None else 0)
        async with self._io_lock:
            try:
                await self.loop.sock_sendall(self.sock, head)
                if big is not None:
                    await self.loop.sock_sendall(self.sock, big)
            except asyncio.CancelledError:
                # part of the frame may be on the wire
                self._break(ConnectError(
                    f"{self.name}: send cancelled mid-frame"))
                raise
            except Exception as e:  # noqa: BLE001 — a socket error
                self._break(e)
                raise
        self.bytes_sent += nbytes
        if self.metrics is not None:
            self.metrics.observe("rpc.send_batch_frames", 1)
            self.metrics.inc("rpc.bytes_sent", nbytes)

    def _break(self, exc: BaseException) -> None:
        if self.broken is None:
            self.broken = exc
            if self.metrics is not None:
                self.metrics.inc("rpc.writer_breaks")
        self._abort(exc)
        if self.on_broken is not None:
            try:
                self.on_broken(exc)
            except Exception:  # noqa: BLE001
                log.exception("%s: on_broken", self.name)

    async def send_file(self, head: bytes, f, offset: int,
                        count: int) -> int:
        """Queue a frame whose envelope is ``head`` and whose payload is
        ``count`` bytes of ``f`` at ``offset``, sent by ``sendfile``;
        returns the payload bytes sent."""
        item = _SendItem(head, None, len(head) + count,
                         self.loop.create_future(), file=f, offset=offset,
                         count=count)
        self._enqueue(item)
        return await self._await_item(item)

    # -------- the writer's task --------

    def _bump(self, d: int) -> None:
        self._depth["n"] += d
        if self.metrics is not None:
            self.metrics.gauge("rpc.send_queue_depth", self._depth["n"])

    async def _run(self) -> None:
        try:
            while True:
                if not self._q:
                    self._wake.clear()
                    await self._wake.wait()
                    # the coalescing window: every producer already
                    # runnable in this turn enqueues before the batch is cut
                    await asyncio.sleep(0)
                batch: list[_SendItem] = []
                fitem: _SendItem | None = None
                nbytes = 0
                while self._q and len(batch) < self.max_frames \
                        and nbytes < self.max_bytes:
                    item = self._q[0]
                    if item.fut.cancelled():
                        self._q.popleft()
                        self._bump(-1)
                        continue
                    if item.file is not None:
                        if batch:
                            break         # the frames queued first go first
                        self._q.popleft()
                        self._bump(-1)
                        fitem = item
                        break
                    self._q.popleft()
                    self._bump(-1)
                    batch.append(item)
                    nbytes += item.size
                if fitem is not None:
                    await self._write_file(fitem)
                elif batch:
                    await self._write_batch(batch, nbytes)
        except asyncio.CancelledError:
            self._abort(ConnectError(f"{self.name}: connection closed"))
            raise
        except Exception as e:  # noqa: BLE001 — a socket error breaks it
            self._break(e)

    async def _write_batch(self, batch: list[_SendItem], nbytes: int) -> None:
        # runs of small frames flattened into one buffer each; a large
        # payload stays an iovec entry of its own
        parts: list = []
        cur = bytearray()
        for it in batch:
            cur += it.head
            if it.big is not None:
                if cur:
                    parts.append(cur)
                parts.append(it.big)
                cur = bytearray()
        if cur:
            parts.append(cur)
        try:
            async with self._io_lock:
                if len(parts) == 1:
                    await self.loop.sock_sendall(self.sock, parts[0])
                else:
                    await vectored_sendall(self.loop, self.sock, parts)
        except BaseException as e:
            self._resolve(batch, e)
            raise
        self.bytes_sent += nbytes
        if self.metrics is not None:
            self.metrics.observe("rpc.send_batch_frames", len(batch))
            self.metrics.inc("rpc.bytes_sent", nbytes)
        self._resolve(batch, None)

    async def _write_file(self, item: _SendItem) -> None:
        try:
            async with self._io_lock:
                await self.loop.sock_sendall(self.sock, item.head)
                item.file.seek(item.offset)
                sent = await self.loop.sock_sendfile(
                    self.sock, item.file, item.offset, item.count,
                    fallback=True)
                if sent != item.count:
                    # the frame on the wire is cut short
                    raise CurvineError(f"sendfile sent {sent} of "
                                       f"{item.count} bytes")
        except BaseException as e:
            self._resolve([item], e)
            raise
        self.bytes_sent += len(item.head) + sent
        if self.metrics is not None:
            self.metrics.inc("rpc.bytes_sent", len(item.head) + sent)
        if not item.fut.done():
            item.fut.set_result(sent)

    @staticmethod
    def _resolve(batch: list[_SendItem], exc: BaseException | None) -> None:
        for it in batch:
            if it.fut.done():
                continue
            if exc is None:
                it.fut.set_result(None)
            elif isinstance(exc, asyncio.CancelledError):
                it.fut.cancel()
            else:
                it.fut.set_exception(exc)

    def _abort(self, exc: BaseException) -> None:
        if isinstance(exc, asyncio.CancelledError):
            exc = ConnectError(f"{self.name}: connection closed")
        while self._q:
            it = self._q.popleft()
            self._bump(-1)
            if not it.fut.done():
                it.fut.set_exception(exc)

    # -------- teardown --------

    def close(self) -> None:
        self.closed = True
        if self._task is not None:
            self._task.cancel()

    async def aclose(self) -> None:
        self.close()
        t, self._task = self._task, None
        if t is not None:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._abort(ConnectError(f"{self.name}: connection closed"))


class BulkDecoder:
    """Frames decoded out of one reusable receive buffer; ``metrics``
    gets ``rpc.bytes_recv``."""

    def __init__(self, size: int = RECV_BUFFER_BYTES, metrics=None):
        self._buf = bytearray(max(size, 16 * 1024))
        self._pos = 0
        self._limit = 0
        self.metrics = metrics
        self.bytes_recv = 0

    def pending(self) -> int:
        return self._limit - self._pos

    def _compact(self) -> None:
        rem = self._limit - self._pos
        if rem:
            self._buf[:rem] = self._buf[self._pos:self._limit]
        self._pos, self._limit = 0, rem

    def _grow(self, need: int) -> None:
        buf = bytearray(max(need, 2 * len(self._buf)))
        rem = self._limit - self._pos
        buf[:rem] = self._buf[self._pos:self._limit]
        self._buf, self._pos, self._limit = buf, 0, rem

    def _account(self, got: int) -> None:
        self.bytes_recv += got
        if self.metrics is not None:
            self.metrics.inc("rpc.bytes_recv", got)

    async def fill(self, loop: asyncio.AbstractEventLoop,
                   sock: socket.socket) -> int:
        """One receive into the buffer's tail (often many frames); a
        peer's close raises ``ConnectionResetError``."""
        if self._pos == self._limit:
            self._pos = self._limit = 0
        elif self._limit == len(self._buf):
            self._compact()
            if self._limit == len(self._buf):
                # one envelope larger than the buffer (a giant header)
                self._grow(2 * len(self._buf))
        got = await loop.sock_recv_into(sock,
                                        memoryview(self._buf)[self._limit:])
        if got == 0:
            raise ConnectionResetError("peer closed")
        self._limit += got
        self._account(got)
        return got

    def try_next(self) -> tuple[int, int, int, int, dict, int] | None:
        """The next frame's ``(code, req_id, status, flags, header,
        data_len)``, its envelope consumed and its payload left unread;
        None until the envelope is buffered (then ``fill``). A malformed
        frame raises ``CurvineError``."""
        env = decode_envelope(self._buf, self._pos, self._limit)
        if env is None:
            return None
        self._pos = env[0]
        return env[1:]

    def take_into(self, dst: memoryview) -> int:
        """Copy up to ``len(dst)`` buffered payload bytes into ``dst``,
        consuming them; returns how many."""
        n = min(self.pending(), len(dst))
        if n:
            dst[:n] = self._buf[self._pos:self._pos + n]
            self._pos += n
        return n

    async def recv_sink(self, loop, sock, view: memoryview,
                        live=None) -> bool:
        """The rest of a sink payload, received straight into ``view``,
        past the buffer. With ``live``, checked before each receive
        (``recv_while``), the payload's rest goes to the buffer and is
        dropped once ``live()`` is false: the sink's owner left and may
        have handed ``view`` on. Returns whether ``view`` was filled."""
        if live is None:
            await recv_exact(loop, sock, view)
            self._account(len(view))
            return True
        got = await recv_while(loop, sock, view, live)
        self._account(got)
        if got < len(view):
            await self.read_payload(loop, sock, len(view) - got)
            return False
        return True

    async def read_payload(self, loop, sock, n: int) -> memoryview:
        """A view of the next ``n`` payload bytes, valid until the next
        call: no system call when they are buffered, else exact reads into
        the grow-only buffer, or into a transient one past
        ``RECV_RETAIN_MAX``."""
        if self.pending() >= n:
            v = memoryview(self._buf)[self._pos:self._pos + n]
            self._pos += n
            return v
        if n > len(self._buf) and n > RECV_RETAIN_MAX:
            mv = memoryview(bytearray(n))
            got = self.take_into(mv)
            await self.recv_sink(loop, sock, mv[got:])
            return mv
        if n > len(self._buf):
            self._grow(n)
        elif self._pos:
            self._compact()
        rem = self._limit                   # the payload's buffered part
        await self.recv_sink(loop, sock, memoryview(self._buf)[rem:n])
        # the payload is consumed: the next fill starts at 0, and the
        # view stays valid until then
        self._pos = self._limit = 0
        return memoryview(self._buf)[:n]


def writer_for(sock: socket.socket, loop: asyncio.AbstractEventLoop,
               rpc_conf, metrics, on_broken, name: str,
               depth_cell: dict | None = None) -> CoalescedWriter:
    """A connection's writer, its frames a send from the ``[rpc]`` table
    (the default when None)."""
    return CoalescedWriter(
        sock, loop,
        max_frames=getattr(rpc_conf, "send_coalesce_frames",
                           SEND_COALESCE_FRAMES),
        metrics=metrics, depth_cell=depth_cell, on_broken=on_broken,
        name=name)
