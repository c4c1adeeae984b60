"""File reader: short-circuit reads of co-located blocks, READ_BLOCK
otherwise.

Own copy of the parts of ``curvine_tpu/client/reader.py`` that the cache
feed reads through:

- locating a block (``_locate``, :191-215) and ordering its replicas:
  local first (``_pick_loc``, :217-225), then by the client's circuit
  breakers (``_failover_locs``, :228-236; ``client/health.py``), whose
  open ones go last but are never dropped;
- the short-circuit probe: GET_BLOCK_INFO to the worker that holds the
  block on this host, which answers with the block file's path and its
  commit-time crc (``_local_path``, ``_fd_for``, ``_local_fd``; :301-365,
  :949-985);
- ``mmap_view`` (:987-1025): one preadv of a co-located block range into
  a fresh buffer, the whole block verified against its crc when
  ``verify`` is set (``_sc_verify_ok``, :538; crc32c through the port's
  ``csrc/crc32c.cc``), None when the range is not short-circuit readable;
- ``chunks`` (:1264-1303), the whole file in sequential chunks with
  ``read_ahead`` chunks read ahead of the consumer (``_pread_bytes``,
  each a task; an early exit cancels those in flight);
- ``read``, ``read_all`` and ``pread`` (:605-646) over the positional
  core ``_read_into`` (:665-738): one buffer for the whole range, each
  block range landing in it once, by a preadv from the local block file
  or by READ_BLOCK received straight into it (``_readinto_remote``,
  :905-950, over ``Connection.call_readinto``) from each replica in
  turn; a whole block is verified against the crc its EOF frame carries.
  Each attempt reports its outcome to the breakers, ``ok`` or ``fail``
  with the location's ``worker_id`` (:936-945). They return that
  buffer, a ``bytearray``;
- ``pread_view`` (:644-663), the positional read into a numpy buffer
  (``_alloc_out``, :507-516: page-aligned, mmap-backed from 256 KiB
  up, the reference's ``recv_aligned_min``,
  ``rpc/transport.py::alloc_aligned``),
  served from the prefetch window where it holds the range, and
  ``read_range`` (:740-802), the same into one buffer cut into
  ``parallel`` contiguous chunk-aligned slices read concurrently; a
  range of one block served by shm is the mapping's read-only view
  instead, with no copy (``_shm_view``);
- the sequential prefetch window (:804-899): ``ReadDetector`` (:42-80),
  fed by ``pread_view``'s positional reads and by seeks, says whether the
  stream is sequential; while it is, ``_prefetch_topup`` keeps the next
  ``read_ahead`` chunk-aligned segments (``_seg_start``) of remote
  blocks in flight (``_fetch_seg``: READ_BLOCK into a buffer of the
  transport's registered receive pool, ``recv_pool()``), at most
  2·``read_ahead`` + 2 of them, and ``_pf_read_into`` serves a read out
  of them (``pf.bytes.read``), a consumed segment's buffer going back to
  the pool. A striped block, a co-located one and one not probed yet are
  never prefetched: the window stops there until a direct read has
  probed it. ``close`` cancels and awaits every segment in flight.

An erasure-coded block (``_ec_active``: its stripe committed and its
replicas retired) is read through its cells (``_read_ec``,
:1054-1097): intact, each covered data cell's range lands in the buffer
by READ_BLOCK (``_read_cell``: a cell is a block of its own, read with
the same failover, breakers and crc check); when a covering cell has no
holder that the breakers let by (``_cell_live``), or a read of one
fails, the same range of any k cells is read and decoded by the port's
codec (``_read_ec_degraded``, :1099-1144; ``read.ec_degraded``), and
the lost cells are reported to the master, fire-and-forget, so their
rebuild starts at once. Cells are never read by the short circuit, and
``mmap_view`` answers None for a striped block (the reference's probe
skips stripes, :316): the caller reads through ``read_all``.

A block that fails its crc is reported to the master (fire-and-forget) and
read from the next replica. When every replica of a block range has
failed, the reader asks the master once for the file's locations again
and tries the refreshed replicas of the same range, raising the last
error when they fail too (``_refresh_and_read``, :1213-1231); the
refreshed locations serve the rest of the file. The counters ``sc.bytes.read`` and
``read.zero_copy_bytes`` (the reference's names) say which path served
the bytes.

The shared-memory plane (:161-168, :288-298, :351-358, :397-502), the
reference's default same-host path: a probe answered with ``shm`` and
``shm_sock`` records the worker's side channel, and the block's first
read fetches its sealed memfd there (``worker/shm.py::fetch_block_fd``,
on a thread), checks its seals and length, maps it read only and
verifies the whole block once against its commit crc (``_shm_map``).
Every read of the block is then a copy out of the mapping
(``_shm_read_into``, before the fd path in ``_read_into``), and
``mmap_view`` returns a read-only view of it with no copy
(``_shm_view``). A failed fetch, a missing seal or a bad crc counts
``read.shm_fallbacks`` and the fd path serves the block; hits count
``read.shm_hits``, and a warm-cache block (``shm_warm`` on the probe, or
named on an SC_READ_REPORT reply) counts ``read.shm_warm_hits`` and
``read.shm_warm_fallbacks`` instead. Its bytes count in
``sc.bytes.read``; ``read.zero_copy_bytes`` keeps the port's meaning,
READ_BLOCK's bytes (the reference counts a mapping's views there too).
A mapping is dropped with the
block's other handles (``_drop_shm``); a view a caller holds keeps it
alive. ``fetch_split`` sums the seconds of the probe, the map (the
fetch and map, or the block file's open) and the copy (out of the
mapping, or the preadv).

Short-circuit reads bypass the worker, so their heat is reported back
(``_note_sc_read``, ``_flush_sc_reads``; :138-143, :565-600, :1330-1333):
per-block read counts, sent in SC_READ_REPORT to the worker that granted
the block every 512 reads and on ``close``. The worker's promotion scan
then counts reads, not opens. The short circuit probes the first replica of the breaker's
order that is on this host, and skips a holder whose breaker is open
(as the reference's cell reads do, :1035-1045): its block is then read
through READ_BLOCK from the next replica, and probed again once the
breaker lets it by.

Deadlines (:258-266, :605-800, :901-947, :1048-1075): a read's budget
is its ``deadline_ms`` argument, else the reader's ``op_deadline_ms``
(the conf's), else none. ``read``, ``read_all``, ``pread``,
``pread_view`` and ``read_range`` take it. Each replica attempt of
``_readinto_remote`` checks the budget first and gets
``remaining / replicas_left`` of it (``Deadline.sub``), so a wedged
worker costs a share of the budget before the next replica is tried; a
hop that runs out raises ``RpcTimeout``, which the breakers count as a
failure, and the refresh runs only while the budget lasts. The port's
own paths, where they part from the reference's, are marked so:

- the refresh's replicas are tried as the first pass's are, each with
  its share of the remaining budget (the reference gives each the whole
  remainder, with no span);
- a stripe (``_read_ec``): the cells of the intact pass are read in
  parallel under half the remaining budget, and the degraded pass, under
  the rest, tries the cells that failed it last (the reference gives the
  intact pass the whole budget and tries the cells in their order: a
  wedged cell holder, whose cell has no other replica, would spend all
  of it);
- the prefetch window (beyond the reference, whose segments carry no
  budget and whose consumer waits without one, so that a wedged worker
  stalls a windowed read for a whole ``rpc_timeout_ms``): each segment's
  fetch gets a budget of its own, the size of the budget of the read
  that scheduled it, and a read waits for a segment no longer than its
  remaining budget's share for one of two tries (``Deadline.sub(2)``),
  then reads the range itself within the rest;
- as in the reference, the short-circuit probe (GET_BLOCK_INFO to a
  worker on this host), the shm fetch (a side channel on this host) and
  ``chunks`` carry no budget.

Tracing (:238-242), with ``tracer`` set (the client's,
``obs/trace.py``): ``read``, ``pread``, ``pread_view`` and
``read_range`` are spans, and so is every replica attempt of a block
(``read_block``) or of a stripe cell (``read_cell``): a failed replica
is a span in error, not a gap.

Left out (ROADMAP A3b): holes (a file resized past its last
block; they raise ``NotImplementedError`` until RESIZE_FILE, ROADMAP §A
item 4) and short-circuit reads of a bdev tier's leased extents (its
blocks are read through READ_BLOCK)."""

from __future__ import annotations

import asyncio
import bisect
import contextlib
import fcntl
import logging
import mmap
import os
import time

import numpy as np

from curvine_tpu_torch.client.health import OPEN
from curvine_tpu_torch.common import ec as eclib
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import (ExtendedBlock, FileBlocks,
                                            LocatedBlock, WorkerAddress)
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc import transport
from curvine_tpu_torch.rpc.deadline import Deadline
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker import shm as wshm
from curvine_tpu_torch.worker.blockfile import crc_update, supported

log = logging.getLogger(__name__)


# the seals a worker's memfd must carry before a client maps it: its
# bytes can then never change or shrink under the mapping
_SHM_SEALS = fcntl.F_SEAL_SHRINK | fcntl.F_SEAL_GROW | fcntl.F_SEAL_WRITE
# a mapping's pages are faulted in by the map call, in one pass: page by
# page on first touch costs several times more on a virtual machine
_SHM_MAP_FLAGS = mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)


def _block_crc(algo: str, data) -> int | None:
    """``data``'s checksum with the block's commit-time algorithm; None
    for an algorithm this client does not know (not verified)."""
    return crc_update(algo, data) if supported(algo) else None


class ReadDetector:
    """Whether a reader's positional reads run sequentially, which drives
    the prefetch window. Sequential by default; ``threshold`` contiguous
    reads confirm it. One isolated jump keeps the pattern, a second jump
    in a row makes it random, and a seek makes it random at once."""

    def __init__(self, threshold: int = 3, enabled: bool = True):
        self.enabled = enabled
        self.threshold = max(1, threshold)
        self.last_pos = -1
        self.seq_count = 0
        self.sequential = True

    def record_seek(self) -> None:
        if not self.enabled:
            return
        self.seq_count = 0
        self.last_pos = -1
        self.sequential = False

    def record_read(self, start: int, end: int) -> None:
        if not self.enabled:
            return
        if self.last_pos < 0 or start == self.last_pos:
            self.seq_count += 1
            if self.seq_count >= self.threshold:
                self.sequential = True
        else:
            if self.seq_count == 0:
                self.sequential = False     # the second jump in a row
            self.seq_count = 0
        self.last_pos = end


class FsReader:
    # cap of the short-circuit probe cache (negative answers included):
    # entries are dropped oldest first, so a block that moved is probed
    # again in time even if no read fails
    _SC_CACHE_CAP = 256

    def __init__(self, fs_client, path: str, file_blocks: FileBlocks,
                 pool: ConnectionPool, chunk_size: int = 4 * 1024 * 1024,
                 short_circuit: bool = True, read_ahead: int = 2,
                 counters: dict | None = None, health=None,
                 verify: bool = True, op_deadline_ms: int = 0,
                 tracer=None):
        self.fs = fs_client
        # the budget of a read that names none (0: no budget)
        self.op_deadline_ms = op_deadline_ms
        # the client's Tracer (None: untraced)
        self.tracer = tracer
        self.path = path
        self.blocks = file_blocks
        self.pool = pool
        self.chunk_size = chunk_size
        self.short_circuit = short_circuit
        self.verify = verify
        self.counters = counters if counters is not None else {}
        # the client's shared WorkerHealth board (None: no breakers)
        self.health = health
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
        # location of the worker that granted each block
        self._sc_reads: dict[int, int] = {}
        self._sc_loc: dict[int, object] = {}
        self._sc_pending = 0
        self._sc_flush_task: asyncio.Task | None = None
        self._tasks: set[asyncio.Task] = set()
        # the shared-memory plane: block id -> the worker's side channel
        # for blocks it offered, block id -> (memfd, mapping) once
        # fetched (verified once, bounded with the probe cache), and the
        # blocks whose offer is the warm cache's (counted apart)
        self._shm_sock: dict[int, str] = {}
        self._shm_maps: dict[int, tuple[int, mmap.mmap]] = {}
        self._shm_warm: set[int] = set()
        # seconds of this reader's block fetches, by part: the probe
        # (GET_BLOCK_INFO), the map (the shm fd's fetch, seal check, map
        # and verify, or the block file's open) and the copy (out of the
        # mapping, or the preadv); the feed reports them
        self.fetch_split = {"probe": 0.0, "map": 0.0, "copy": 0.0}
        # the prefetch window of positional reads: while the detector
        # says sequential, the next read_ahead segments of remote blocks;
        # segment offset -> its task, then its buffer
        self.read_ahead = read_ahead
        self.detector = ReadDetector()
        self._pf: dict[int, object] = {}
        self._pf_order: list[int] = []
        # the budget of the read that last topped the window up, in ms
        # (None: op_deadline_ms), which the segments it scheduled take
        self._pf_budget_ms = None
        # the queue depth a direct-IO worker advertises, which read_range
        # fans its slices out to; 0 while the port's tiers have no direct
        # IO (TIER_FIXED pins queue_depth to 0, ROADMAP §A item 3)
        self.direct_queue_depth = 0
        # prefetch segments cycle through the registered pool
        self._recv_pool = transport.recv_pool()

    def _count(self, key: str, n: int) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def _span(self, op: str, **attrs):
        """A span of the client's tracer, or a no-op untraced."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(op, attrs=attrs or None)

    def _deadline(self, deadline_ms: int | None) -> Deadline | None:
        """A read's budget: ``deadline_ms``, else ``op_deadline_ms``,
        else None."""
        if deadline_ms is None:
            deadline_ms = self.op_deadline_ms
        return Deadline.after_ms(deadline_ms) if deadline_ms else None

    # ---------------- positioning ----------------

    def seek(self, pos: int) -> None:
        if pos < 0 or pos > self.len:
            raise err.InvalidArgument(f"seek {pos} out of [0, {self.len}]")
        if pos != self.pos:
            self.detector.record_seek()
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

    def _failover_locs(self, lb: LocatedBlock) -> list:
        """The replicas in the order to try them: local first, then by
        the breakers (open ones last, none dropped)."""
        first = self._pick_loc(lb)
        locs = [first] + [x for x in lb.locs if x is not first]
        if self.health is not None:
            locs = self.health.order(locs, key=self._addr)
        return locs

    # ---------------- erasure-coded reads ----------------

    @staticmethod
    def _ec_active(lb: LocatedBlock) -> bool:
        """A committed stripe whose replicas are retired: reads go to
        its cells. While replicas remain (mid-conversion) they serve."""
        return lb.ec is not None and not lb.locs

    def _cell_live(self, cell: dict) -> bool:
        """Whether a cell has a holder the breakers let by: a dead holder
        would cost every read its failure, so a cell behind open breakers
        counts as lost (the breaker half-opens in time, and the intact
        path comes back by itself)."""
        if not cell["locs"]:
            return False
        if self.health is None:
            return True
        return any(self.health.allow(
            f"{a.get('ip_addr') or a.get('hostname')}:{a.get('rpc_port')}")
            for a in cell["locs"])

    async def _read_cell(self, ec: dict, cell: dict, off: int,
                         sink: memoryview,
                         deadline: Deadline | None = None) -> int:
        """``len(sink)`` bytes at ``off`` of one stripe cell, read into
        ``sink`` as a block's are (``_readinto_remote``): failover over
        its holders, the breakers, the budget, a ``read_cell`` span an
        attempt, and the crc of a whole cell."""
        clb = LocatedBlock(
            block=ExtendedBlock(id=cell["block_id"], len=ec["cell_size"]),
            locs=[WorkerAddress.from_wire(a) for a in cell["locs"]])
        if not clb.locs:
            raise err.BlockNotFound(
                f"cell {cell['block_id']} has no live locations")
        return await self._readinto_remote(clb, off, sink, deadline,
                                           op="read_cell")

    async def _read_ec(self, lb: LocatedBlock, block_off: int,
                       out: memoryview,
                       deadline: Deadline | None = None) -> int:
        """Fill ``out`` from ``block_off`` of a striped block; returns the
        bytes filled. Data cell j holds the block's bytes [j * cell_size,
        (j + 1) * cell_size): intact, each covered cell's range lands in
        ``out`` with no decode; degraded, the same range of any k cells
        (parity too) decodes just that range (the codec works byte by
        byte). The tail's padding never reaches the caller."""
        ec = lb.ec
        cs = ec["cell_size"]
        n = min(len(out), ec.get("block_len", lb.block.len) - block_off)
        if n <= 0:
            return 0
        a, b = block_off, block_off + n
        spans = [(j, max(a - j * cs, 0), min(b - j * cs, cs))
                 for j in range(a // cs, (b - 1) // cs + 1)]
        cells = ec["cells"]
        failed: set[int] = set()
        if all(self._cell_live(cells[j]) for j, _s, _e in spans):
            # half the budget: the degraded pass is the intact one's
            # failover, and gets the rest
            intact = deadline.sub(2) if deadline is not None else None
            got = await asyncio.gather(
                *(self._read_cell(ec, cells[j], s,
                                  out[j * cs + s - a:j * cs + e - a],
                                  intact)
                  for j, s, e in spans), return_exceptions=True)
            for g in got:
                if isinstance(g, BaseException) \
                        and not isinstance(g, err.CurvineError):
                    raise g
            failed = {cells[j]["block_id"] for g, (j, s, e)
                      in zip(got, spans) if g != e - s}
            if not failed:
                return n
            # a holder died or wedged mid-read: degrade
        await self._read_ec_degraded(ec, spans, a, out, deadline, failed)
        return n

    async def _read_ec_degraded(self, ec: dict, spans: list, a: int,
                                out: memoryview,
                                deadline: Deadline | None = None,
                                failed=frozenset()) -> None:
        prof = eclib.ECProfile.parse(ec["profile"])
        cs = ec["cell_size"]
        cells = ec["cells"]
        lo = min(s for _j, s, _e in spans)
        hi = max(e for _j, _s, e in spans)
        slots: list[np.ndarray | None] = [None] * (prof.k + prof.m)
        lost: list[int] = []
        got = 0
        # the cells the intact pass failed on are tried last (a wedged
        # holder would spend the rest of the budget again), and reported
        # lost when k others serve
        order = sorted(enumerate(cells),
                       key=lambda ic: ic[1]["block_id"] in failed)
        for idx, cell in order:
            if got >= prof.k:
                if cell["block_id"] in failed:
                    lost.append(cell["block_id"])
                continue
            if not self._cell_live(cell):
                lost.append(cell["block_id"])
                continue
            buf = np.empty(hi - lo, dtype=np.uint8)
            try:
                n = await self._read_cell(ec, cell, lo, memoryview(buf),
                                          deadline)
            except err.CurvineError:
                lost.append(cell["block_id"])
                continue
            if n != hi - lo:
                lost.append(cell["block_id"])
                continue
            slots[idx] = buf
            got += 1
        if got < prof.k:
            raise err.BlockNotFound(
                f"block {cells[0]['block_id']}: only {got}/{prof.k} stripe "
                f"cells readable: the stripe is lost")
        data_cells = await asyncio.to_thread(eclib.decode, prof, slots)
        self._count("read.ec_degraded", 1)
        if lost:
            # tell the master which cells are gone, so that their rebuild
            # starts now and not at its next scan
            async def report(ids=tuple(lost)):
                try:
                    await self.fs.call(RpcCode.REPORT_UNDER_REPLICATED_BLOCKS,
                                       {"block_ids": list(ids)})
                except err.CurvineError as e:
                    log.debug("lost-cell report failed: %s", e)
            t = asyncio.ensure_future(report())
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)
        for j, s, e in spans:
            out[j * cs + s - a:j * cs + e - a] = data_cells[j][s - lo:e - lo]

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
        self._drop_shm(bid)

    def _drop_shm(self, bid: int) -> None:
        """Close a block's mapping and memfd, and forget its offer. A view
        a caller still holds keeps the mapping open past this
        (BufferError: the mmap lives until the last view goes), so an
        eviction never takes pages from under a read."""
        self._shm_sock.pop(bid, None)
        self._shm_warm.discard(bid)
        ent = self._shm_maps.pop(bid, None)
        if ent is not None:
            fd, mm = ent
            try:
                mm.close()
            except BufferError:
                pass
            os.close(fd)

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
            loc = next((x for x in self._failover_locs(lb)
                        if self.fs.is_local(x)), None)
            if loc is not None and self.health is not None \
                    and self.health.state(self._addr(loc)) == OPEN:
                return None      # not cached: probed again once it heals
            if loc is not None:
                t0 = time.perf_counter()
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
                        self._sc_loc[bid] = loc
                        if info.get("shm") and info.get("shm_sock"):
                            # the worker offers the sealed memfd: the
                            # next read fetches and maps it (it wins over
                            # the fd path)
                            self._shm_sock[bid] = info["shm_sock"]
                            if info.get("shm_warm"):
                                self._shm_warm.add(bid)
                except err.CurvineError as e:
                    log.debug("short-circuit probe of block %d failed: %s",
                              bid, e)
                self.fetch_split["probe"] += time.perf_counter() - t0
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
        t0 = time.perf_counter()
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            self._drop_local(bid)
            return None
        finally:
            self.fetch_split["map"] += time.perf_counter() - t0
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

    # ---------------- the shared-memory plane ----------------

    def _shm_hit(self, bid: int) -> None:
        """One read served by a mapping, counted to its plane: the warm
        cache's (a block below the MEM tier) apart from the MEM
        exports'."""
        self._count("read.shm_warm_hits" if bid in self._shm_warm
                    else "read.shm_hits", 1)

    def _shm_fallback(self, bid: int) -> None:
        self._count("read.shm_warm_fallbacks" if bid in self._shm_warm
                    else "read.shm_fallbacks", 1)

    async def _shm_map(self, lb: LocatedBlock) -> mmap.mmap | None:
        """The block's mapping, made at its first read: the memfd fetched
        over the worker's side channel (a blocking socket on a thread:
        asyncio cannot carry SCM_RIGHTS), its seals checked, mapped read
        only, and the whole block verified once against its commit crc;
        every later read is a memory access. None: the caller takes the
        fd path (a failed fetch is counted, and the block's offer
        dropped, so it is not fetched again)."""
        bid = lb.block.id
        ent = self._shm_maps.get(bid)
        if ent is not None:
            return ent[1]
        if not self.short_circuit or not lb.locs:
            return None
        if bid not in self._local_paths:
            await self._local_path(lb)      # the probe learns the offer
        spath = self._shm_sock.get(bid)
        if spath is None:
            return None
        t0 = time.perf_counter()
        try:
            return await self._shm_fetch_map(lb, spath)
        finally:
            self.fetch_split["map"] += time.perf_counter() - t0

    async def _shm_fetch_map(self, lb: LocatedBlock, spath: str):
        bid = lb.block.id
        try:
            fd, length = await asyncio.to_thread(wshm.fetch_block_fd,
                                                 spath, bid)
        except (LookupError, OSError, ValueError) as e:
            log.debug("shm fetch of block %d failed: %s", bid, e)
            self._shm_fallback(bid)
            self._shm_sock.pop(bid, None)
            return None
        other = self._shm_maps.get(bid)
        if other is not None:
            os.close(fd)                    # a concurrent fetch won
            return other[1]
        try:
            sealed = fcntl.fcntl(fd, fcntl.F_GET_SEALS) & _SHM_SEALS \
                == _SHM_SEALS
            mm = (mmap.mmap(fd, length, flags=_SHM_MAP_FLAGS,
                            prot=mmap.PROT_READ)
                  if sealed and length == lb.block.len and length > 0
                  else None)
        except (OSError, ValueError):
            mm = None
        if mm is None:
            os.close(fd)
            self._shm_fallback(bid)
            self._shm_sock.pop(bid, None)
            return None
        warm = bid in self._shm_warm
        if self.verify and not self._sc_verify_ok(lb, memoryview(mm)):
            # flagged and the block's handles dropped; read elsewhere
            try:
                mm.close()
            except BufferError:
                pass
            os.close(fd)
            self._count("read.shm_warm_fallbacks" if warm
                        else "read.shm_fallbacks", 1)
            return None
        self._shm_maps[bid] = (fd, mm)
        return mm

    async def _shm_read_into(self, lb: LocatedBlock, block_off: int,
                             out: memoryview) -> int:
        """Fill ``out`` from the block's mapping (one copy, no RPC, no
        syscall); 0 when the block is not served by shm."""
        mm = await self._shm_map(lb)
        if mm is None:
            return 0
        t0 = time.perf_counter()
        n = len(out)
        out[:n] = np.frombuffer(mm, dtype=np.uint8, count=n,
                                offset=block_off)
        self.fetch_split["copy"] += time.perf_counter() - t0
        self._note_sc_read(lb.block.id, n)
        self._shm_hit(lb.block.id)
        return n

    async def _shm_view(self, offset: int, n: int) -> np.ndarray | None:
        """A read-only uint8 view of a single block's range in its
        mapping, with no copy; None when the range spans blocks or the
        block is not served by shm."""
        if n <= 0:
            return None
        located = self._locate(offset)
        if located is None:
            return None
        lb, block_off = located
        if self._ec_active(lb) or block_off + n > lb.block.len:
            return None
        mm = await self._shm_map(lb)
        if mm is None:
            return None
        t0 = time.perf_counter()
        view = np.frombuffer(mm, dtype=np.uint8, count=n, offset=block_off)
        self.fetch_split["copy"] += time.perf_counter() - t0
        self._note_sc_read(lb.block.id, n)
        self._shm_hit(lb.block.id)
        return view

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
            loc = self._sc_loc.get(bid)
            if loc is not None:
                by_addr.setdefault(self._addr(loc), {})[bid] = n
        for addr, block_reads in by_addr.items():
            try:
                conn = await self.pool.get(addr)
                rep = await conn.call(RpcCode.SC_READ_REPORT,
                                      data=pack({"block_reads": block_reads}))
                # the reply names the blocks whose heat just made them
                # warm-servable: this reader probed them before the heat,
                # and maps the warm copy at its next read
                hdr = rep.header if isinstance(rep.header, dict) else {}
                for bid, sock in (hdr.get("shm_warm") or {}).items():
                    self._shm_sock[int(bid)] = sock
                    self._shm_warm.add(int(bid))
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
        self._flag_corrupt(lb, self._sc_loc[lb.block.id])
        self._drop_local(lb.block.id)
        self._local_paths[lb.block.id] = None
        return False

    async def mmap_view(self, offset: int, n: int) -> np.ndarray | None:
        """``n`` bytes at ``offset`` of a co-located block as a fresh
        uint8 array: one preadv from the block file (the page cache, or
        the tmpfs of a mem tier). None when the range spans blocks, is
        not on this host, is striped, or fails its crc (the caller then
        reads through ``read_all``). A block the worker serves by shm
        gives a read-only view of its mapping instead, with no copy."""
        view = await self._shm_view(offset, n)
        if view is not None:
            return view
        located = self._locate(offset)
        if located is None:
            return None
        lb, block_off = located
        if self._ec_active(lb) or block_off + n > lb.block.len:
            return None
        fd = await self._local_fd(lb)
        if fd is None:
            return None
        t0 = time.perf_counter()
        buf = np.empty(n, dtype=np.uint8)
        got = os.preadv(fd, [memoryview(buf)], block_off)
        ok = got == n and not (
            self.verify and block_off == 0 and n == lb.block.len
            and not self._sc_verify_ok(lb, buf))
        self.fetch_split["copy"] += time.perf_counter() - t0
        if got != n:
            self._drop_local(lb.block.id)
        if not ok:
            return None
        self._note_sc_read(lb.block.id, n)
        return buf

    # ---------------- reads ----------------

    async def read(self, n: int = -1, deadline_ms=None) -> bytearray:
        """Up to ``n`` bytes from the cursor (the rest of the file when
        negative), in one buffer each block range is read into; the
        cursor moves past them."""
        n = self.len - self.pos if n < 0 else min(n, self.len - self.pos)
        dl = self._deadline(deadline_ms)
        with self._span("read", path=self.path, n=n):
            out = await self._read_into_new(self.pos, n, dl)
        self.pos += len(out)
        return out

    async def read_all(self, deadline_ms=None) -> bytearray:
        self.seek(0)
        return await self.read(self.len, deadline_ms=deadline_ms)

    async def pread(self, offset: int, n: int,
                    deadline_ms=None) -> bytearray:
        """``n`` bytes at ``offset``, the cursor left where it is."""
        n = max(0, min(n, self.len - offset))
        dl = self._deadline(deadline_ms)
        with self._span("pread", path=self.path, offset=offset, n=n):
            return await self._read_into_new(offset, n, dl)

    async def pread_view(self, offset: int, n: int,
                         deadline_ms=None) -> np.ndarray:
        """``n`` bytes at ``offset`` as a uint8 array (``_alloc_out``), the
        cursor left where it is: co-located ranges land in it by preadv
        or a copy out of the mapping, remote ones by READ_BLOCK or out of
        the prefetch window when it holds them. The read feeds the
        detector, and tops the window up; the segments it schedules get
        a budget of its budget's size."""
        n = max(0, min(n, self.len - offset))
        out = self._alloc_out(n)
        dl = self._deadline(deadline_ms)
        with self._span("pread_view", path=self.path, offset=offset, n=n):
            filled = await self._read_into(offset, memoryview(out),
                                           use_prefetch=True, deadline=dl)
        self.detector.record_read(offset, offset + filled)
        self._prefetch_topup(offset + filled, deadline_ms)
        return out[:filled]

    async def read_range(self, offset: int, n: int, parallel: int = 1,
                         deadline_ms=None) -> np.ndarray:
        """``n`` bytes at ``offset`` as a uint8 array, read by ``parallel``
        concurrent readers of contiguous chunk-aligned slices (each its
        own READ_BLOCK streams over the pool's connections), all under
        one budget. A range of one block served by shm is the mapping's
        read-only view, with no copy."""
        n = max(0, min(n, self.len - offset))
        if n == 0:
            return np.empty(0, dtype=np.uint8)
        dl = self._deadline(deadline_ms)
        with self._span("read_range", path=self.path, offset=offset, n=n,
                        parallel=parallel):
            view = await self._shm_view(offset, n)
            if view is not None:
                return view
            return await self._read_range(offset, n, parallel,
                                          self._alloc_out(n), dl)

    async def _read_range(self, offset: int, n: int, parallel: int,
                          out: np.ndarray,
                          deadline: Deadline | None = None) -> np.ndarray:
        qd = self.direct_queue_depth
        if qd > 0:
            # a direct-IO worker: fan out to keep its submission ring
            # full, and never past its depth. Dead while TIER_FIXED pins
            # every tier's queue_depth to 0 (no direct IO in the port)
            if parallel <= 1 and n >= 4 * self.chunk_size:
                parallel = min(qd, max(1, n // (4 * self.chunk_size)))
            elif parallel > 1:
                parallel = min(parallel, qd)
        if parallel <= 1 or n < 4 * self.chunk_size:
            got = await self._read_into(offset, memoryview(out),
                                        use_prefetch=True, deadline=deadline)
            return out[:got]
        # contiguous slices, chunk-aligned so that no stream cuts a chunk
        per = -(-n // parallel)
        per = max(self.chunk_size,
                  (per // self.chunk_size) * self.chunk_size or per)
        bounds = [(s, min(s + per, n)) for s in range(0, n, per)]
        got = await asyncio.gather(
            *(self._read_into(offset + s, memoryview(out[s:e]),
                              deadline=deadline)
              for s, e in bounds))
        # a short slice truncates the result there
        total = 0
        for (s, e), g in zip(bounds, got):
            total = s + g
            if g < e - s:
                break
        return out[:total]

    def _alloc_out(self, n: int) -> np.ndarray:
        """A read's buffer for the caller: page-aligned and mmap-backed
        from ``transport._ALIGNED_MIN`` up, else on the heap."""
        if n >= transport._ALIGNED_MIN:
            return transport.alloc_aligned(n)
        return np.empty(n, dtype=np.uint8)

    async def chunks(self, chunk_size: int | None = None,
                     read_ahead: int | None = None):
        """The whole file as a stream of sequential chunks of
        ``chunk_size`` (the reader's when None), with the next
        ``read_ahead`` (the reader's when None, at least 1) read while
        the consumer works on the current one; the export's source. The
        reads still in flight when the consumer stops are cancelled."""
        chunk_size = chunk_size or self.chunk_size
        read_ahead = self.read_ahead if read_ahead is None else read_ahead
        self.seek(0)
        pending: list[asyncio.Task] = []
        offset = 0

        def schedule() -> None:
            nonlocal offset
            while len(pending) < max(1, read_ahead) and offset < self.len:
                n = min(chunk_size, self.len - offset)
                pending.append(asyncio.ensure_future(
                    self._pread_bytes(offset, n)))
                offset += n

        try:
            schedule()
            while pending:
                data = await pending.pop(0)
                schedule()
                if not data:
                    break
                self.pos += len(data)
                yield data
        finally:
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)

    async def _pread_bytes(self, offset: int, n: int) -> bytearray:
        return await self._read_into_new(offset, n)

    async def _read_into_new(self, offset: int, n: int,
                             deadline: Deadline | None = None) -> bytearray:
        out = bytearray(n)
        view = memoryview(out)
        try:
            got = await self._read_into(offset, view, deadline=deadline)
        finally:
            view.release()        # the bytearray cannot shrink while viewed
        if got < n:
            del out[got:]
        return out

    async def _read_into(self, offset: int, out: memoryview, *,
                         use_prefetch: bool = False,
                         deadline: Deadline | None = None) -> int:
        """Fill ``out`` from ``offset``, block range by block range; each
        lands in ``out`` once: out of the prefetch window when
        ``use_prefetch`` and it holds the range, a preadv from the block
        file when the block is on this host, else READ_BLOCK received
        straight into ``out`` (``_readinto_remote``). Returns the bytes
        filled (short at the end of the file or where a worker served
        none). A whole block is held to its crc on either path
        (:665-738)."""
        filled = 0
        while filled < len(out):
            pos = offset + filled
            if use_prefetch:
                got = await self._pf_read_into(pos, out[filled:], deadline)
                if got > 0:
                    filled += got
                    continue
            located = self._locate(pos)
            if located is None:
                if pos < self.len:
                    raise NotImplementedError(
                        f"{self.path}: hole at {pos} (the file was resized "
                        f"past its last block); the port reads no holes "
                        f"yet (ROADMAP A3b)")
                break
            lb, block_off = located
            seg = out[filled:filled + min(len(out) - filled,
                                          lb.block.len - block_off)]
            if self._ec_active(lb):
                got = await self._read_ec(lb, block_off, seg, deadline)
                if got <= 0:
                    break
                filled += got
                continue
            # the mapping first: no RPC, and no syscall once it is made
            got = await self._shm_read_into(lb, block_off, seg)
            if got > 0:
                filled += got
                continue
            fd = await self._local_fd(lb)
            if fd is not None:
                t0 = time.perf_counter()
                got = os.preadv(fd, [seg], block_off)
                self.fetch_split["copy"] += time.perf_counter() - t0
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
                try:
                    got = await self._readinto_remote(lb, block_off, seg,
                                                      deadline)
                except err.CurvineError as e:
                    got = await self._refresh_and_read(pos, seg, e,
                                                       deadline)
                if got <= 0:
                    break
            filled += got
        return filled

    # ---------------- the sequential prefetch window ----------------

    def _seg_start(self, off: int) -> int:
        """The start of the prefetch segment that covers ``off``: chunk-
        aligned within its block (a segment is one READ_BLOCK stream and
        never spans blocks); -1 past the blocks."""
        located = self._locate(off)
        if located is None:
            return -1
        lb, block_off = located
        return lb.offset + (block_off // self.chunk_size) * self.chunk_size

    def _prefetch_topup(self, from_off: int,
                        deadline_ms: int | None = None) -> None:
        """While the stream is sequential, keep the next ``read_ahead``
        segments from ``from_off`` in flight, and drop the oldest past
        2·``read_ahead`` + 2. Only remote blocks: a co-located block's
        read is one preadv or a copy out of its mapping, which a prefetch
        would only copy once more. Each segment's fetch gets a budget of
        ``deadline_ms`` (as a read's: ``_deadline``), from its start."""
        if not self.detector.enabled or not self.detector.sequential \
                or self.read_ahead <= 0:
            return
        self._pf_budget_ms = deadline_ms
        off = from_off
        scheduled = 0
        while scheduled < self.read_ahead and off < self.len:
            s = self._seg_start(off)
            if s < 0:
                return
            lb, block_off = self._locate(s)
            if self._ec_active(lb):
                # a stripe's read fans out over its cells itself; a
                # prefetched segment would read them twice
                return
            if self._local_paths.get(lb.block.id, "?") is not None:
                return              # co-located, or not probed yet
            seg_len = min(self.chunk_size - block_off % self.chunk_size,
                          lb.offset + lb.block.len - s, self.len - s)
            if s not in self._pf:
                self._pf[s] = asyncio.ensure_future(
                    self._fetch_seg(s, seg_len))
                self._pf_order.append(s)
            off = s + seg_len
            scheduled += 1
        while len(self._pf_order) > 2 * self.read_ahead + 2:
            ent = self._pf.pop(self._pf_order.pop(0), None)
            if isinstance(ent, asyncio.Task):
                ent.cancel()
            elif ent is not None:
                self._recv_pool.release(ent)

    async def _fetch_seg(self, s: int, seg_len: int) -> np.ndarray:
        """One segment read by READ_BLOCK into a buffer of the registered
        pool (consumed by a copy, then given back), within a budget of
        the scheduling read's size from its start."""
        deadline = self._deadline(self._pf_budget_ms)
        located = self._locate(s)
        if located is None:
            raise err.BlockNotFound(f"prefetch segment at {s}")
        lb, block_off = located
        buf = self._recv_pool.acquire(seg_len)
        got = await self._readinto_remote(lb, block_off, memoryview(buf),
                                          deadline)
        return buf[:got]

    async def _pf_read_into(self, off: int, out: memoryview,
                            deadline: Deadline | None = None) -> int:
        """A read at ``off`` served out of the prefetch window; 0 when the
        window does not hold it, or its segment is not in within half the
        read's remaining ``deadline`` (the caller reads it directly, within
        the other half)."""
        if not self._pf:
            return 0
        s = self._seg_start(off)
        ent = self._pf.get(s)
        if ent is None:
            return 0
        if isinstance(ent, asyncio.Task):
            try:
                if deadline is None:
                    buf = await ent
                else:
                    buf = await asyncio.wait_for(
                        asyncio.shield(ent), deadline.sub(2).remaining())
            except asyncio.TimeoutError:
                return 0                    # left in flight for later
            except asyncio.CancelledError:
                if asyncio.current_task().cancelling():
                    raise                   # the caller's own cancel
                self._pf.pop(s, None)       # the segment's: read directly
                return 0
            except (err.CurvineError, OSError):
                self._pf.pop(s, None)
                return 0
            self._pf[s] = buf
        else:
            buf = ent
        rel = off - s
        if rel >= len(buf):
            self._pf.pop(s, None)
            return 0
        n = min(len(out), len(buf) - rel)
        out[:n] = buf[rel:rel + n]
        self._count("pf.bytes.read", n)
        if rel + n >= len(buf):
            # consumed: its buffer goes back to the pool
            self._pf.pop(s, None)
            if s in self._pf_order:
                self._pf_order.remove(s)
            self._recv_pool.release(buf)
        return n

    async def _readinto_remote(self, lb: LocatedBlock, block_off: int,
                               sink: memoryview,
                               deadline: Deadline | None = None,
                               op: str = "read_block") -> int:
        """READ_BLOCK of ``len(sink)`` bytes at ``block_off`` of the block,
        streamed in ``chunk_size`` frames straight into ``sink``
        (``Connection.call_readinto``), from each replica in turn, local
        first; a whole block is held to the crc on the EOF frame
        (:905-950). Each attempt checks ``deadline`` first and gets its
        share of it (``remaining / replicas_left``), is an ``op`` span,
        fills ``sink`` from its start and reports its outcome to the
        breakers."""
        locs = self._failover_locs(lb)
        last: Exception | None = None
        for i, loc in enumerate(locs):
            addr = self._addr(loc)
            hop = None
            if deadline is not None:
                deadline.check(f"read block {lb.block.id}")
                hop = deadline.sub(len(locs) - i)
            try:
                eof: dict = {}
                with self._span(op, addr=addr, block=lb.block.id):
                    conn = await self.pool.get(addr)
                    got = await conn.call_readinto(
                        RpcCode.READ_BLOCK, sink, header={
                            "block_id": lb.block.id, "offset": block_off,
                            "len": len(sink),
                            "chunk_size": self.chunk_size},
                        eof_header=eof, deadline=hop)
                if self.verify and block_off == 0 \
                        and got == lb.block.len \
                        and eof.get("block_crc32") is not None:
                    have = _block_crc(eof.get("block_crc_algo", ""),
                                      sink[:got])
                    if have is not None and have != eof["block_crc32"]:
                        self._flag_corrupt(lb, loc)
                        raise err.AbnormalData(
                            f"block {lb.block.id} from {addr} failed "
                            f"checksum verification")
                if self.health is not None:
                    self.health.ok(addr)
                self._count("read.zero_copy_bytes", got)
                return got
            except err.CurvineError as e:
                if self.health is not None:
                    self.health.fail(addr, worker_id=loc.worker_id)
                log.warning("read block %d from %s failed (%s), trying "
                            "the next replica", lb.block.id, addr, e)
                last = e
        raise last or err.BlockNotFound(f"block {lb.block.id} unreadable")

    async def _refresh_and_read(self, pos: int, seg: memoryview,
                                cause: err.CurvineError,
                                deadline: Deadline | None = None) -> int:
        """Every replica of the range at ``pos`` failed with ``cause``:
        the file's locations asked for once more, and the range read
        from the refreshed replicas; ``cause`` (or the refreshed
        replicas' last error) is raised when that fails too, or at once
        when the budget is spent."""
        if deadline is not None and deadline.expired:
            raise cause
        self.blocks = await self.fs.get_block_locations(self.path,
                                                        deadline=deadline)
        self._block_offs = [lb.offset for lb in self.blocks.block_locs]
        self._last_block_idx = 0
        located = self._locate(pos)
        if located is None or not located[0].locs:
            raise cause
        lb, block_off = located
        try:
            return await self._readinto_remote(
                lb, block_off, seg[:lb.block.len - block_off], deadline)
        except err.CurvineError as e:
            raise e from cause

    async def close(self) -> None:
        # the prefetch window: cancel and await every segment in flight,
        # so that none outlives the reader; parked buffers go back
        tasks = [e for e in self._pf.values() if isinstance(e, asyncio.Task)]
        for ent in self._pf.values():
            if isinstance(ent, asyncio.Task):
                ent.cancel()
            else:
                self._recv_pool.release(ent)
        self._pf.clear()
        self._pf_order.clear()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
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
        for bid in list(self._shm_maps):
            self._drop_shm(bid)
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
