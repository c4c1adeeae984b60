"""Shared-memory block export: sealed memfds handed over SCM_RIGHTS.

Own copy of ``curvine_tpu/worker/shm.py``, the worker's half of the
shared-memory read plane, the reference's default same-host read path.
The worker keeps a bounded cache of sealed memfd copies of its MEM-tier
file-layout blocks (``ShmExporter``, :67-158) and, for read-hot blocks of
the tiers below it, a byte-bounded warm cache (``WarmShmCache``,
:160-287, on the port's ``common/cache.py::make_policy``). A co-located
client that saw the ``shm`` and ``shm_sock`` flags on its GET_BLOCK_INFO
probe connects to the unix side channel (``ShmChannel``, :289-402),
sends the block id, and receives the fd in SCM_RIGHTS ancillary data
(``fetch_block_fd``, :404-); every read of the block is then a slice of
its mapping, with no RPC.

The seals (F_SEAL_SHRINK, GROW, WRITE and SEAL) make the handed fd
immutable: the bytes a client mapped never change under it, and an
eviction on the worker closes only the worker's fd; the client's dup
keeps the pages (the unlink semantics the fd short circuit relies on).

asyncio cannot carry SCM_RIGHTS, so the side channel is a small
blocking AF_UNIX listener on a daemon thread. A request is one 8-byte
frame (the block id, little-endian u64) and a reply one 16-byte frame
(an i8 status, 7 pad bytes, the block's length as a u64), byte for byte
the reference's, so either package's client reads from the other's
worker."""

from __future__ import annotations

import array
import fcntl
import logging
import os
import socket
import struct
import tempfile
import threading
import time

from curvine_tpu_torch.common.cache import make_policy

log = logging.getLogger(__name__)

# request: little-endian u64 block id.  reply: i8 status + 7 pad bytes
# + u64 block length; status 0 carries the fd in SCM_RIGHTS ancillary.
_REQ = struct.Struct("<Q")
_REP = struct.Struct("<b7xQ")
OK = 0
NOT_FOUND = 1
ERROR = 2

_SENDFILE_CHUNK = 8 * 1024 * 1024


def shm_supported() -> bool:
    """memfd_create + unix-socket fd passing: Linux, py3.8+."""
    return hasattr(os, "memfd_create") and hasattr(socket, "SCM_RIGHTS")


def channel_path(port: int) -> str:
    """Side-channel socket path: short (AF_UNIX caps sun_path at ~108
    bytes, so the worker's data dir — often a deep tmp path in tests —
    is not usable), unique per process+port."""
    return os.path.join(tempfile.gettempdir(),
                        f"cv-shm-{os.getpid()}-{port}.sock")


def _seal(fd: int) -> None:
    seals = (fcntl.F_SEAL_SHRINK | fcntl.F_SEAL_GROW
             | fcntl.F_SEAL_WRITE | fcntl.F_SEAL_SEAL)
    fcntl.fcntl(fd, fcntl.F_ADD_SEALS, seals)


class ShmExporter:
    """Bounded LRU of sealed-memfd block copies.

    ``export`` returns a worker-owned fd for a committed MEM-tier block:
    a memfd the block file's bytes were sendfile'd into, then sealed.
    Eviction (LRU past ``cap``) and ``invalidate`` (block deleted) close
    the worker's fd only — dups already handed to clients stay valid.
    Thread-safe: called from the side-channel thread and the event
    loop."""

    def __init__(self, cap: int = 128):
        self.cap = max(1, cap)
        self._lock = threading.Lock()
        # block_id -> (memfd, length); dict order is the LRU order
        self._fds: dict[int, tuple[int, int]] = {}
        self.exports = 0        # memfd copies materialized
        self.hits = 0           # grants served from the cache
        self.evictions = 0

    def export(self, block_id: int, path: str, length: int) -> tuple[int, int]:
        """(memfd, length) for the block file at ``path``; cached."""
        with self._lock:
            ent = self._fds.pop(block_id, None)
            if ent is not None:
                self._fds[block_id] = ent       # refresh LRU position
                self.hits += 1
                return ent
        fd = self._copy_to_memfd(block_id, path, length)
        with self._lock:
            ent = self._fds.pop(block_id, None)
            if ent is not None:
                # raced with another grant: keep the first copy
                self._fds[block_id] = ent
                self.hits += 1
                self._close(fd)
                return ent
            while len(self._fds) >= self.cap:
                old_fd, _n = self._fds.pop(next(iter(self._fds)))
                self._close(old_fd)
                self.evictions += 1
            self._fds[block_id] = (fd, length)
            self.exports += 1
            return fd, length

    @staticmethod
    def _copy_to_memfd(block_id: int, path: str, length: int) -> int:
        src = os.open(path, os.O_RDONLY)
        try:
            fd = os.memfd_create(f"cv-blk-{block_id}",
                                 os.MFD_CLOEXEC | os.MFD_ALLOW_SEALING)
            try:
                os.ftruncate(fd, length)
                off = 0
                while off < length:
                    n = os.sendfile(fd, src, off,
                                    min(_SENDFILE_CHUNK, length - off))
                    if n == 0:
                        raise OSError(
                            f"short copy of block {block_id}: "
                            f"{off}/{length}")
                    off += n
                _seal(fd)
            except OSError:
                os.close(fd)
                raise
            return fd
        finally:
            os.close(src)

    @staticmethod
    def _close(fd: int) -> None:
        try:
            os.close(fd)
        except OSError:
            pass

    def invalidate(self, block_id: int) -> None:
        with self._lock:
            ent = self._fds.pop(block_id, None)
        if ent is not None:
            self._close(ent[0])

    def __len__(self) -> int:
        with self._lock:
            return len(self._fds)

    def close(self) -> None:
        with self._lock:
            fds, self._fds = list(self._fds.values()), {}
        for fd, _n in fds:
            self._close(fd)


class WarmShmCache:
    """Byte-bounded warm cache of sealed-memfd copies for blocks BELOW
    the MEM tier.

    A read-hot SSD/HDD block (heat over ``worker.shm_warm_min_reads``,
    accumulated through the SC_READ_REPORT rail) gets its bytes copied
    once into a sealed memfd; from then on co-located clients serve it
    exactly like a MEM export — zero RPCs, zero syscalls per read. The
    cache is bounded in BYTES (``worker.shm_warm_cap_mb``) because warm
    copies are anonymous memory the MEM tier doesn't account for, and
    eviction runs through the same admission policy family as the MEM
    tier (S3-FIFO by default): a one-touch scan that sneaks a copy in
    leaves through the probationary queue without displacing the warm
    working set. Eviction and invalidation close the WORKER's fd only —
    client-held dups and mappings stay valid (unlink semantics), same
    contract as ShmExporter."""

    def __init__(self, cap_bytes: int, admission: str = "s3fifo",
                 ghost_entries: int = 1024):
        self.cap_bytes = max(0, cap_bytes)
        self.policy = make_policy(admission, ghost_entries=ghost_entries)
        self._lock = threading.Lock()
        # block_id -> (memfd, length); insertion order only (the policy
        # owns the eviction order, not this dict)
        self._fds: dict[int, tuple[int, int]] = {}
        self._atime: dict[int, float] = {}
        self.bytes = 0
        self.exports = 0        # warm copies materialized
        self.hits = 0           # grants served from the cache
        self.evictions = 0

    def export(self, block_id: int, path: str, length: int) -> tuple[int, int]:
        """(memfd, length) for the block file at ``path``; copies once,
        then serves from the cache. Raises LookupError for blocks larger
        than the whole cache (never worth evicting everything for)."""
        with self._lock:
            ent = self._fds.get(block_id)
            if ent is not None:
                self.hits += 1
                self._atime[block_id] = time.time()
                self.policy.hits += 1
                self.policy.on_access(block_id)
                return ent
        if length > self.cap_bytes:
            raise LookupError(
                f"block {block_id} ({length}B) exceeds warm cache")
        fd = ShmExporter._copy_to_memfd(block_id, path, length)
        with self._lock:
            ent = self._fds.get(block_id)
            if ent is not None:
                # raced with another grant: keep the first copy
                self.hits += 1
                self._close(fd)
                return ent
            self._evict_locked(length)
            self._fds[block_id] = (fd, length)
            self._atime[block_id] = time.time()
            self.bytes += length
            self.policy.on_admit(block_id, length)
            self.exports += 1
            return fd, length

    def _evict_locked(self, need: int) -> None:
        """Make room for ``need`` bytes, closing victims in policy
        order (S3-FIFO: probationary one-touch copies first)."""
        if self.bytes + need <= self.cap_bytes:
            return
        order = iter(self.policy.victim_order(
            [(k, self._atime.get(k, 0.0)) for k in self._fds]))
        while self.bytes + need > self.cap_bytes and self._fds:
            victim = next(order, None)
            if victim is None or victim not in self._fds:
                if victim is None:          # policy ran dry: FIFO rest
                    victim = next(iter(self._fds))
                else:
                    continue
            fd, n = self._fds.pop(victim)
            self._atime.pop(victim, None)
            self._close(fd)
            self.bytes -= n
            self.policy.on_remove(victim, evicted=True)
            self.evictions += 1

    def invalidate(self, block_id: int) -> None:
        """Block deleted or moved tiers: drop the warm copy (a plain
        removal, not an eviction — no ghost entry, the block is gone)."""
        with self._lock:
            ent = self._fds.pop(block_id, None)
            if ent is not None:
                self._atime.pop(block_id, None)
                self.bytes -= ent[1]
                self.policy.on_remove(block_id, evicted=False)
        if ent is not None:
            self._close(ent[0])

    @staticmethod
    def _close(fd: int) -> None:
        try:
            os.close(fd)
        except OSError:
            pass

    def __contains__(self, block_id: int) -> bool:
        with self._lock:
            return block_id in self._fds

    def __len__(self) -> int:
        with self._lock:
            return len(self._fds)

    def stats(self) -> dict:
        with self._lock:
            out = {"entries": len(self._fds), "bytes": self.bytes,
                   "exports": self.exports, "hits": self.hits,
                   "evictions": self.evictions}
        out.update({f"policy_{k}": v for k, v in self.policy.stats().items()})
        return out

    def close(self) -> None:
        with self._lock:
            fds, self._fds = list(self._fds.values()), {}
            self._atime.clear()
            self.bytes = 0
        for fd, _n in fds:
            self._close(fd)


class ShmChannel:
    """AF_UNIX SCM_RIGHTS side channel serving block fds.

    ``grant(block_id) -> (fd, length)`` is the server's policy hook
    (resolve the block, check the tier, export through the
    ShmExporter); it runs on the channel's threads, so it must only
    touch thread-safe state (BlockStore and ShmExporter both take their
    own locks)."""

    def __init__(self, path: str, grant):
        self.path = path
        self.grant = grant
        self._srv: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def start(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(self.path)
            srv.listen(64)
        except OSError:
            srv.close()
            raise
        self._srv = srv
        self._thread = threading.Thread(
            target=self._accept_loop, name="shm-channel", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                break                    # listener closed (stop)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        """One client connection: fixed-size request/reply frames until
        EOF (clients typically fetch one fd per connection)."""
        with conn:
            conn.settimeout(5.0)
            while not self._stop.is_set():
                try:
                    req = self._recv_exact(conn, _REQ.size)
                except OSError:
                    return
                if req is None:
                    return               # clean EOF
                (block_id,) = _REQ.unpack(req)
                try:
                    fd, length = self.grant(block_id)
                except LookupError:
                    self._reply(conn, NOT_FOUND, 0, None)
                    continue
                except Exception as e:  # noqa: BLE001 — keep serving
                    log.debug("shm grant for %d failed: %s", block_id, e)
                    self._reply(conn, ERROR, 0, None)
                    continue
                if not self._reply(conn, OK, length, fd):
                    return

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            got = conn.recv(n - len(buf))
            if not got:
                return None if not buf else buf
            buf += got
        return buf

    @staticmethod
    def _reply(conn: socket.socket, status: int, length: int,
               fd: int | None) -> bool:
        anc = []
        if fd is not None:
            anc = [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                    array.array("i", [fd]))]
        try:
            conn.sendmsg([_REP.pack(status, length)], anc)
            return True
        except OSError:
            return False

    def stop(self) -> None:
        self._stop.set()
        srv, self._srv = self._srv, None
        if srv is not None:
            # close() alone does NOT wake a thread blocked in accept()
            # on Linux; shutdown() forces accept to return so the join
            # below is immediate instead of eating its timeout
            try:
                srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                srv.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)


def fetch_block_fd(sock_path: str, block_id: int,
                   timeout: float = 5.0) -> tuple[int, int]:
    """Client half: connect to the worker's side channel, request one
    block, return (fd, length). Blocking — run under asyncio.to_thread.
    Raises LookupError when the worker no longer serves the block and
    OSError on channel trouble (both are clean fallbacks to the socket
    read path)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(sock_path)
        s.sendall(_REQ.pack(block_id))
        data, anc, _flags, _addr = s.recvmsg(
            _REP.size, socket.CMSG_SPACE(array.array("i").itemsize))
        if len(data) < _REP.size:
            raise ConnectionResetError("shm channel closed mid-reply")
        status, length = _REP.unpack(data)
        fds = array.array("i")
        for level, ctype, cdata in anc:
            if level == socket.SOL_SOCKET and ctype == socket.SCM_RIGHTS:
                fds.frombytes(cdata[:len(cdata)
                                    - (len(cdata) % fds.itemsize)])
        if status == NOT_FOUND:
            for fd in fds:
                os.close(fd)
            raise LookupError(f"block {block_id} not shm-served")
        if status != OK or not fds:
            for fd in fds:
                os.close(fd)
            raise OSError(f"shm grant failed (status {status})")
        fd = fds[0]
        for extra in list(fds)[1:]:
            os.close(extra)
        return fd, length
