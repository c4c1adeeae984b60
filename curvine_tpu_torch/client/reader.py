"""File reader: short-circuit reads of co-located blocks, READ_BLOCK
otherwise.

Own copy of the parts of ``curvine_tpu/client/reader.py`` that the cache
feed reads through:

- locating a block (``_locate``, :191-215) and choosing its replica,
  local first (``_pick_loc``, :217-225);
- the short-circuit probe: GET_BLOCK_INFO to the worker that holds the
  block on this host, which answers with the block file's path and its
  commit-time crc (``_local_path``, ``_fd_for``, ``_local_fd``; :301-365,
  :949-985);
- ``mmap_view`` (:987-1025): one preadv of a co-located block range into
  a fresh buffer, the whole block verified against its crc when
  ``verify`` is set (``_sc_verify_ok``, :538; crc32c through the port's
  ``csrc/crc32c.cc``), None when the range is not short-circuit readable;
- ``read``, ``read_all`` and ``pread`` (:605-646) over the positional
  core ``_read_into`` (:665-738): one buffer for the whole range, each
  block range landing in it once, by a preadv from the local block file
  or by READ_BLOCK received straight into it (``_readinto_remote``,
  :905-950, over ``Connection.call_readinto``) from each replica in
  turn; a whole block is verified against the crc its EOF frame carries.
  They return that buffer, a ``bytearray``.

A block that fails its crc is reported to the master (fire-and-forget) and
read from the next replica. The counters ``sc.bytes.read`` and
``read.zero_copy_bytes`` (the reference's names) say which path served
the bytes.

Short-circuit reads bypass the worker, so their heat is reported back
(``_note_sc_read``, ``_flush_sc_reads``; :138-143, :565-600, :1330-1333):
per-block read counts, sent in SC_READ_REPORT to the worker that granted
the block every 512 reads and on ``close``. The worker's promotion scan
then counts reads, not opens. The reply's shared-memory warm-cache offer
is ignored.

Left out (ROADMAP A3b): the shared-memory side channel (a worker's offer
is ignored and the fd path taken), erasure-coded reads and holes (a file
resized past its last block) (both raise ``NotImplementedError``),
short-circuit reads of a bdev tier's leased extents (its blocks are read
through READ_BLOCK), the location refresh after every replica failed
(the read raises), the sequential prefetch window, parallel
``read_range``, ``pread_view``, ``chunks``, the worker circuit breaker,
deadlines and tracing."""

from __future__ import annotations

import asyncio
import bisect
import logging
import os

import numpy as np

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import FileBlocks, LocatedBlock
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker.blockfile import crc_update, supported

log = logging.getLogger(__name__)


def _block_crc(algo: str, data) -> int | None:
    """``data``'s checksum with the block's commit-time algorithm; None
    for an algorithm this client does not know (not verified)."""
    return crc_update(algo, data) if supported(algo) else None


class FsReader:
    # cap of the short-circuit probe cache (negative answers included):
    # entries are dropped oldest first, so a block that moved is probed
    # again in time even if no read fails
    _SC_CACHE_CAP = 256

    def __init__(self, fs_client, path: str, file_blocks: FileBlocks,
                 pool: ConnectionPool, chunk_size: int = 4 * 1024 * 1024,
                 short_circuit: bool = True, counters: dict | None = None,
                 verify: bool = True):
        self.fs = fs_client
        self.path = path
        self.blocks = file_blocks
        self.pool = pool
        self.chunk_size = chunk_size
        self.short_circuit = short_circuit
        self.verify = verify
        self.counters = counters if counters is not None else {}
        self.pos = 0
        self.len = file_blocks.status.len
        self._block_offs = [lb.offset for lb in file_blocks.block_locs]
        self._last_block_idx = 0
        # block id -> the block file's path on this host, or None
        self._local_paths: dict[int, str | None] = {}
        # block id -> (fd, the path it was opened for)
        self._local_fds: dict[int, tuple[int, str]] = {}
        # block id -> (crc, algo) from GET_BLOCK_INFO
        self._block_crc: dict[int, tuple[int, str]] = {}
        # short-circuit reads per block since the last report, and the
        # address of the worker that granted each block
        self._sc_reads: dict[int, int] = {}
        self._sc_addr: dict[int, str] = {}
        self._sc_pending = 0
        self._sc_flush_task: asyncio.Task | None = None
        self._tasks: set[asyncio.Task] = set()

    def _count(self, key: str, n: int) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    # ---------------- positioning ----------------

    def seek(self, pos: int) -> None:
        if pos < 0 or pos > self.len:
            raise err.InvalidArgument(f"seek {pos} out of [0, {self.len}]")
        self.pos = pos

    def _locate(self, offset: int) -> tuple[LocatedBlock, int] | None:
        locs = self.blocks.block_locs
        if not locs:
            return None
        i = self._last_block_idx     # sequential reads: this block or next
        if i < len(locs) and locs[i].offset <= offset:
            if offset < locs[i].offset + locs[i].block.len:
                return locs[i], offset - locs[i].offset
            if i + 1 < len(locs) and offset < (locs[i + 1].offset
                                               + locs[i + 1].block.len):
                self._last_block_idx = i + 1
                return locs[i + 1], offset - locs[i + 1].offset
        i = bisect.bisect_right(self._block_offs, offset) - 1
        if i < 0:
            return None
        lb = locs[i]
        if offset >= lb.offset + lb.block.len:
            return None
        self._last_block_idx = i
        return lb, offset - lb.offset

    def _pick_loc(self, lb: LocatedBlock):
        if not lb.locs:
            raise err.BlockNotFound(
                f"block {lb.block.id} has no live locations")
        host = self.fs.client_host
        for loc in lb.locs:
            if host and host in (loc.hostname, loc.ip_addr):
                return loc
        return lb.locs[0]

    @staticmethod
    def _addr(loc) -> str:
        return f"{loc.ip_addr or loc.hostname}:{loc.rpc_port}"

    @staticmethod
    def _check_not_ec(lb: LocatedBlock) -> None:
        if lb.ec is not None and not lb.locs:
            raise NotImplementedError(
                f"block {lb.block.id} is erasure-coded: the port reads no "
                f"stripe cells yet (ROADMAP A3)")

    # ---------------- short circuit ----------------

    def _close_fd(self, bid: int) -> None:
        cached = self._local_fds.pop(bid, None)
        if cached is not None:
            os.close(cached[0])

    def _drop_local(self, bid: int) -> None:
        """Forget a block's short-circuit handles: the probe went stale
        (the block moved, shrank or left the worker)."""
        self._local_paths.pop(bid, None)
        self._close_fd(bid)

    async def _local_path(self, lb: LocatedBlock) -> str | None:
        """The path of a co-located block's file (cached), from the
        worker's GET_BLOCK_INFO answer; None when the block is not on
        this host, short circuit is off, or the block is an extent of a
        bdev tier's file (leased; read through READ_BLOCK)."""
        bid = lb.block.id
        if bid in self._local_paths:
            return self._local_paths[bid]
        path = None
        if self.short_circuit and lb.locs:
            loc = self._pick_loc(lb)
            if self.fs.is_local(loc):
                try:
                    addr = self._addr(loc)
                    conn = await self.pool.get(addr)
                    rep = await conn.call(RpcCode.GET_BLOCK_INFO,
                                          data=pack({"block_id": bid}))
                    info = rep.header or unpack(rep.data) or {}
                    if info.get("crc32") is not None:
                        self._block_crc[bid] = (
                            info["crc32"], info.get("crc_algo", "crc32"))
                    p = info.get("path")
                    if p and os.path.exists(p) and not info.get("offset") \
                            and not info.get("lease_ms"):
                        path = p
                        self._sc_addr[bid] = addr
                except err.CurvineError as e:
                    log.debug("short-circuit probe of block %d failed: %s",
                              bid, e)
        while len(self._local_paths) >= self._SC_CACHE_CAP:
            self._drop_local(next(iter(self._local_paths)))
        self._local_paths[bid] = path
        return path

    def _fd_for(self, bid: int, path: str) -> int | None:
        """The block file's fd, opened once per path; None when the file
        went away since the probe (the caller reads remotely)."""
        cached = self._local_fds.get(bid)
        if cached is not None:
            if cached[1] == path:
                return cached[0]
            self._close_fd(bid)
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            self._drop_local(bid)
            return None
        self._local_fds[bid] = (fd, path)
        return fd

    async def _local_fd(self, lb: LocatedBlock) -> int | None:
        path = await self._local_path(lb)
        return None if path is None else self._fd_for(lb.block.id, path)

    def _flag_corrupt(self, lb: LocatedBlock, loc) -> None:
        """Count a replica that failed its crc and tell the master, so
        the bad copy is retired and re-replicated from a good one."""
        self._count("read.checksum_mismatch", 1)
        log.warning("block %d from %s failed checksum verification",
                    lb.block.id, self._addr(loc))

        async def report():
            try:
                await self.fs.call(RpcCode.REPORT_UNDER_REPLICATED_BLOCKS,
                                   {"block_ids": [lb.block.id],
                                    "worker_id": loc.worker_id})
            except err.CurvineError as e:
                log.debug("corrupt-replica report failed: %s", e)
        t = asyncio.ensure_future(report())
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    # ---------------- short-circuit read accounting ----------------

    def _note_sc_read(self, block_id: int, nbytes: int) -> None:
        self._count("sc.bytes.read", nbytes)
        self._sc_reads[block_id] = self._sc_reads.get(block_id, 0) + 1
        self._sc_pending += 1
        if self._sc_pending >= 512 and (self._sc_flush_task is None
                                        or self._sc_flush_task.done()):
            self._sc_flush_task = asyncio.ensure_future(
                self._flush_sc_reads())

    async def _flush_sc_reads(self) -> None:
        """Report the per-block short-circuit read counts to the workers
        that granted the blocks (heat only: a failed report is logged)."""
        reads, self._sc_reads = self._sc_reads, {}
        self._sc_pending = 0
        by_addr: dict[str, dict[int, int]] = {}
        for bid, n in reads.items():
            addr = self._sc_addr.get(bid)
            if addr is not None:
                by_addr.setdefault(addr, {})[bid] = n
        for addr, block_reads in by_addr.items():
            try:
                conn = await self.pool.get(addr)
                await conn.call(RpcCode.SC_READ_REPORT,
                                data=pack({"block_reads": block_reads}))
            except err.CurvineError as e:
                log.debug("sc read report to %s failed: %s", addr, e)

    def _sc_verify_ok(self, lb: LocatedBlock, data) -> bool:
        """A whole block read through the short circuit against its
        commit-time crc. On a mismatch the replica is reported and the
        block's local handles dropped (and marked not local), so this
        read and the next go to READ_BLOCK."""
        ent = self._block_crc.get(lb.block.id)
        if ent is None:
            return True
        want, algo = ent
        got = _block_crc(algo, data)
        if got is None or got == want:
            return True
        self._flag_corrupt(lb, self._pick_loc(lb))
        self._drop_local(lb.block.id)
        self._local_paths[lb.block.id] = None
        return False

    async def mmap_view(self, offset: int, n: int) -> np.ndarray | None:
        """``n`` bytes at ``offset`` of a co-located block as a fresh
        uint8 array: one preadv from the block file (the page cache, or
        the tmpfs of a mem tier). None when the range spans blocks, is
        not on this host, or fails its crc (the caller then reads
        through ``read_all``)."""
        located = self._locate(offset)
        if located is None:
            return None
        lb, block_off = located
        self._check_not_ec(lb)
        if block_off + n > lb.block.len:
            return None
        fd = await self._local_fd(lb)
        if fd is None:
            return None
        buf = np.empty(n, dtype=np.uint8)
        got = os.preadv(fd, [memoryview(buf)], block_off)
        if got != n:
            self._drop_local(lb.block.id)
            return None
        if self.verify and block_off == 0 and n == lb.block.len \
                and not self._sc_verify_ok(lb, buf):
            return None
        self._note_sc_read(lb.block.id, n)
        return buf

    # ---------------- reads ----------------

    async def read(self, n: int = -1) -> bytearray:
        """Up to ``n`` bytes from the cursor (the rest of the file when
        negative), in one buffer each block range is read into; the
        cursor moves past them."""
        n = self.len - self.pos if n < 0 else min(n, self.len - self.pos)
        out = await self._read_into_new(self.pos, n)
        self.pos += len(out)
        return out

    async def read_all(self) -> bytearray:
        self.seek(0)
        return await self.read(self.len)

    async def pread(self, offset: int, n: int) -> bytearray:
        """``n`` bytes at ``offset``, the cursor left where it is."""
        return await self._read_into_new(
            offset, max(0, min(n, self.len - offset)))

    async def _read_into_new(self, offset: int, n: int) -> bytearray:
        out = bytearray(n)
        view = memoryview(out)
        try:
            got = await self._read_into(offset, view)
        finally:
            view.release()        # the bytearray cannot shrink while viewed
        if got < n:
            del out[got:]
        return out

    async def _read_into(self, offset: int, out: memoryview) -> int:
        """Fill ``out`` from ``offset``, block range by block range; each
        lands in ``out`` once: a preadv from the block file when the block
        is on this host, else READ_BLOCK received straight into ``out``
        (``_readinto_remote``). Returns the bytes filled (short at the end
        of the file or where a worker served none). A whole block is held
        to its crc on either path (:665-738)."""
        filled = 0
        while filled < len(out):
            pos = offset + filled
            located = self._locate(pos)
            if located is None:
                if pos < self.len:
                    raise NotImplementedError(
                        f"{self.path}: hole at {pos} (the file was resized "
                        f"past its last block); the port reads no holes "
                        f"yet (ROADMAP A3b)")
                break
            lb, block_off = located
            self._check_not_ec(lb)
            seg = out[filled:filled + min(len(out) - filled,
                                          lb.block.len - block_off)]
            fd = await self._local_fd(lb)
            if fd is not None:
                got = os.preadv(fd, [seg], block_off)
                if self.verify and block_off == 0 \
                        and got == lb.block.len \
                        and not self._sc_verify_ok(lb, seg):
                    fd = None             # bad local bytes: read remotely
                elif got < len(seg):
                    self._drop_local(lb.block.id)   # the probe went stale
                    fd = None
                else:
                    self._note_sc_read(lb.block.id, got)
            if fd is None:
                got = await self._readinto_remote(lb, block_off, seg)
                if got <= 0:
                    break
            filled += got
        return filled

    async def _readinto_remote(self, lb: LocatedBlock, block_off: int,
                               sink: memoryview) -> int:
        """READ_BLOCK of ``len(sink)`` bytes at ``block_off`` of the block,
        streamed in ``chunk_size`` frames straight into ``sink``
        (``Connection.call_readinto``), from each replica in turn, local
        first; a whole block is held to the crc on the EOF frame
        (:905-950). Each attempt fills ``sink`` from its start."""
        last: Exception | None = None
        first = self._pick_loc(lb)
        for loc in [first] + [x for x in lb.locs if x is not first]:
            try:
                eof: dict = {}
                conn = await self.pool.get(self._addr(loc))
                got = await conn.call_readinto(
                    RpcCode.READ_BLOCK, sink, header={
                        "block_id": lb.block.id, "offset": block_off,
                        "len": len(sink), "chunk_size": self.chunk_size},
                    eof_header=eof)
                if self.verify and block_off == 0 \
                        and got == lb.block.len \
                        and eof.get("block_crc32") is not None:
                    have = _block_crc(eof.get("block_crc_algo", ""),
                                      sink[:got])
                    if have is not None and have != eof["block_crc32"]:
                        self._flag_corrupt(lb, loc)
                        raise err.AbnormalData(
                            f"block {lb.block.id} from {self._addr(loc)} "
                            f"failed checksum verification")
                self._count("read.zero_copy_bytes", got)
                return got
            except err.CurvineError as e:
                log.warning("read block %d from %s failed (%s), trying "
                            "the next replica", lb.block.id,
                            self._addr(loc), e)
                last = e
        raise last or err.BlockNotFound(f"block {lb.block.id} unreadable")

    async def close(self) -> None:
        # drain the flush in flight, then report what is left below the
        # batch of 512: no read count is dropped at close
        t, self._sc_flush_task = self._sc_flush_task, None
        if t is not None:
            await asyncio.gather(t, return_exceptions=True)
        if self._sc_reads:
            await self._flush_sc_reads()
        for fd, _path in self._local_fds.values():
            os.close(fd)
        self._local_fds.clear()
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
