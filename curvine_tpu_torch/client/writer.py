"""File writer: one upload leg per replica, the short-circuit write of a
co-located single-replica block, and recovery from a worker's death.

Own copy of ``curvine_tpu/client/writer.py`` (:45-686). ``write`` cuts
the caller's bytes into ``chunk_size`` chunks (whole chunks go out of
the caller's buffer uncopied, a partial one is held until it fills),
``_next_block`` asks the master for a block (the sealed blocks' commits
ride on that call; the writer's ``ici_coords`` steer the ``ici``
placement; a retryable refusal is retried until a 90 s deadline,
abandoning the refused block and excluding the workers this stream saw
fail and those behind the client's open breakers), ``_open_block``
opens one WRITE_BLOCK upload leg per location on the writer's
``storage_type`` (:427-463), ``_send_chunk`` chains the block's crc32c
(the port's ``csrc/crc32c.cc``) and sends each chunk to every leg at
once (:197-270), ``_seal_block`` and ``_finish_block`` end
every leg with the crc and keep the commit of the legs that acked
(:507-611), and ``close`` completes the file at the master.

Recovery (:91-97, :271-403; HDFS pipeline recovery): the replay buffer
keeps every byte of the open block, appended before each send, until
the block seals. A leg that fails mid-block is dropped
(``_drop_replicas``): its upload is aborted, the failure counted
(``write.replica_failover``) and reported to the master for healing
(``_report_lost_replica``, :136-150, REPORT_UNDER_REPLICATED_BLOCKS with
its worker id), and the block streams on while at least
``min_replicas`` legs survive. Below that, when the one leg of a
block fails (the short circuit's write on an ``OSError`` of the
worker's media, or its SC_WRITE_COMMIT), and when a seal's finish
leaves too few live legs, ``_recover_block`` abandons the block, asks
for a new one away from the failed workers (``_next_block`` with the
block to abandon and a 90 s deadline, inside which a cluster with no
placeable worker is waited out) and replays the buffer into it in
``chunk_size`` pieces (``write.block_replay_bytes``), re-placing again
on a further failure until the deadline; the caller's write never sees
the death. ``_seal_block`` makes three attempts. A leg that fails its
finish while enough survive leaves a degraded commit on the survivors
(``write.degraded_commits``), after the master confirms they are live.
With ``replay_buffer`` off, a block that loses its last leg (or falls
below ``min_replicas``) raises the failure, and ``abort`` drops the open
block. ``hflush`` (:620-641) recovers the open block first when it has
fewer live legs than ``min(min_replicas, len(locs))``, then journals the
sealed blocks' commits at the master (COMPLETE_FILE with ``only_flush``)
and leaves the file open; ``flush`` sends the partial chunk.

The short circuit (:437-438, :464-488, :539-552): when
``short_circuit`` is on and a block of one replica is placed on a worker
on this host, the worker grants a temp block file (SC_WRITE_OPEN, which
answers with its path), the writer writes the caller's bytes straight
into it (no socket, no chunking, one crc pass) and commits it with its
length and crc (SC_WRITE_COMMIT); ``abort`` sends SC_WRITE_ABORT, which
drops the temp file. A worker that refuses the grant (a bdev tier, a
draining worker) or a location off this host sends the block over
WRITE_BLOCK, and the counter ``sc.write.fallbacks`` counts such blocks.
Bytes written by short circuit count as ``sc.bytes.written`` (the
reference's name), all bytes sent (replays included) as ``write.bytes``.

The circuit breaker (:119-125, :364-390, :454-459): the client's shared
``WorkerHealth`` board (``client/health.py``) hears of every leg lost
mid-block and every refused or acked open, with the worker's id, and
ADD_BLOCK excludes the workers behind open breakers beside this
stream's own failures; when that exclusion leaves placement nothing
(NO_AVAILABLE_WORKER) the request goes again without it: an open
breaker beats no worker.

Tracing (:52-57, :111-130, :444, :647), with ``tracer`` set (the
client's, ``obs/trace.py``): each WRITE_BLOCK open is a
``write_attempt`` span (a refused open leaves a span in error, not a
gap), a leg lost mid-block leaves one more ``write_attempt`` span in
error, and ``close``'s seal and completion are a ``write_commit``
span; the uploads' requests join whatever trace the caller opened."""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import MB
from curvine_tpu_torch.common.types import (CommitBlock, LocatedBlock,
                                            StorageType)
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker.blockfile import ALGO_CRC32C, crc_update

log = logging.getLogger(__name__)

OPEN_DEADLINE_S = 90.0

# the failures of one upload leg that dropping it absorbs: transport and
# worker errors, media errors, timeouts; anything else propagates
_UPLOAD_EXC = (err.CurvineError, OSError, asyncio.TimeoutError)


class FsWriter:
    def __init__(self, fs_client, path: str, pool: ConnectionPool,
                 block_size: int, chunk_size: int = 4 * MB,
                 storage_type: StorageType = StorageType.MEM,
                 short_circuit: bool = True, counters: dict | None = None,
                 ici_coords: list[int] | None = None,
                 replay_buffer: bool = True, min_replicas: int = 1,
                 health=None, tracer=None):
        # the client's Tracer (None: untraced)
        self.tracer = tracer
        self.fs = fs_client
        self.path = path
        self.pool = pool
        self.block_size = block_size
        self.chunk_size = chunk_size
        self.storage_type = storage_type
        self.short_circuit = short_circuit
        self.counters = counters if counters is not None else {}
        self.ici_coords = ici_coords
        self.min_replicas = max(1, min_replicas)
        # the client's shared WorkerHealth board (None: no breakers)
        self.health = health
        self.pos = 0
        self._buf = bytearray()
        self._block: LocatedBlock | None = None
        # one upload per live leg and its location, in lockstep (legs are
        # dropped mid-block, so block.locs no longer lines up)
        self._uploads: list = []
        self._upload_locs: list = []
        # the open block's short-circuit grant: its temp file, the
        # connection that granted it and the worker's id
        self._sc_file = None
        self._sc_conn = None
        self._sc_worker_id: int | None = None
        self._block_written = 0
        self._block_crc = 0
        self._crc_algo = ALGO_CRC32C
        self._commits: list[CommitBlock] = []
        self._closed = False
        # every byte of the open block until it seals (None: off), and
        # whether a replay of it is being sent
        self._replay: bytearray | None = bytearray() if replay_buffer \
            else None
        self._recovering = False
        # workers this stream saw fail: kept out of its later placements
        self._failed_workers: set[int] = set()
        # reports of lost legs in flight, awaited at close
        self._reports: set[asyncio.Task] = set()

    @staticmethod
    def _addr(loc) -> str:
        return f"{loc.ip_addr or loc.hostname}:{loc.rpc_port}"

    def _count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def _span(self, op: str, **attrs):
        """A span of the client's tracer, or a no-op untraced."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(op, attrs=attrs or None)

    def _note_leg_failed(self, loc, worker_id: int, cause) -> None:
        if self.health is not None:
            self.health.fail(self._addr(loc), worker_id=worker_id)
        self._failed_workers.add(worker_id)
        self._count("write.replica_failover")
        if self.tracer is not None:
            # the lost leg is an attempt in error in the trace, not a gap
            bid = self._block.block.id if self._block is not None else 0
            self.tracer.span("write_attempt", attrs={
                "addr": self._addr(loc), "block": bid}).error(cause).finish()
        log.warning("write %s: replica %s (worker %d) lost mid-block: %s",
                    self.path, self._addr(loc), worker_id, cause)

    def _note_sc_failed(self, cause) -> None:
        """The short-circuit leg of the open block failed."""
        if self._block.locs:
            loc = self._block.locs[0]
            self._note_leg_failed(loc, self._sc_worker_id or loc.worker_id,
                                  cause)

    def _report_lost_replica(self, block_id: int, worker_id: int) -> None:
        """Tell the master, in the background, that the block lost its
        replica on ``worker_id``, so it re-replicates the block once the
        commit lands."""
        async def report():
            try:
                await self.fs.call(
                    RpcCode.REPORT_UNDER_REPLICATED_BLOCKS,
                    {"block_ids": [block_id], "worker_id": worker_id})
            except Exception as e:  # noqa: BLE001 — the scan heals it too
                log.debug("under-replication report failed: %s", e)
        t = asyncio.ensure_future(report())
        self._reports.add(t)
        t.add_done_callback(self._reports.discard)

    async def write(self, data) -> int:
        if self._closed:
            raise err.InvalidArgument("writer is closed")
        view = memoryview(data).cast("B")
        total = len(view)
        while len(view):
            if self._block is None:
                await self._next_block()
            room = self.block_size - self._block_written - len(self._buf)
            if self._sc_file is not None and not self._buf:
                # short circuit: the crc and the file write stream, so
                # the caller's buffer goes straight through, unchunked
                take = min(room, len(view))
                await self._send_chunk(view[:take])
                view = view[take:]
            elif self._buf:
                # top the partial chunk up to one chunk, then send it
                take = min(room, len(view), self.chunk_size - len(self._buf))
                self._buf += view[:take]
                view = view[take:]
                if len(self._buf) >= self.chunk_size or take == room:
                    await self._flush_chunk()
            else:
                # whole chunks straight out of the caller's buffer
                take = min(room, len(view))
                sendable = view[:take]
                while len(sendable) >= self.chunk_size:
                    await self._send_chunk(sendable[:self.chunk_size])
                    sendable = sendable[self.chunk_size:]
                if len(sendable):
                    if self._block_written + len(sendable) == \
                            self.block_size:
                        await self._send_chunk(sendable)
                    else:
                        self._buf += sendable
                view = view[take:]
            if self._block_written + len(self._buf) >= self.block_size:
                await self._seal_block()
        self.pos += total
        return total

    async def _send_chunk(self, chunk) -> None:
        if self._replay is not None and not self._recovering:
            # kept before the send: a chunk that fails is part of what a
            # recovery replays
            self._replay += chunk
        crc = crc_update(self._crc_algo, chunk, self._block_crc)
        if self._sc_file is not None:
            try:
                self._sc_file.write(chunk)
            except OSError as e:
                # the worker's media failed (EIO, ENOSPC): the one leg is
                # gone, and the recovery replays this chunk too
                self._note_sc_failed(e)
                await self._recover_block(e)
                return
            self._block_crc = crc
            self._block_written += len(chunk)
            self._count("sc.bytes.written", len(chunk))
            self._count("write.bytes", len(chunk))
            return
        self._block_crc = crc
        if len(self._uploads) == 1:
            try:
                await self._uploads[0].send_chunk(chunk)
                results: list = [None]
            except _UPLOAD_EXC as e:
                results = [e]
        else:
            # every leg at once, each with its own result: a failed leg
            # is dropped without sinking the others
            results = await asyncio.gather(
                *(up.send_chunk(chunk) for up in self._uploads),
                return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException) and \
                    not isinstance(r, _UPLOAD_EXC):
                raise r
        failed = [i for i, r in enumerate(results)
                  if isinstance(r, BaseException)]
        if failed and not await self._drop_replicas(failed,
                                                    results[failed[0]]):
            return              # recovered: the replay sent this chunk
        self._block_written += len(chunk)
        self._count("write.bytes", len(chunk))

    async def _drop_replicas(self, failed: list[int], cause) -> bool:
        """Drop the legs that failed mid-chunk (each aborted, counted and
        reported to the master). True when at least ``min_replicas``
        survive and stream on; else the block is recovered (False)."""
        bid = self._block.block.id
        for i in failed:
            loc = self._upload_locs[i]
            self._note_leg_failed(loc, loc.worker_id, cause)
            try:
                await self._uploads[i].abort()
            except (err.CurvineError, OSError):
                pass
            self._report_lost_replica(bid, loc.worker_id)
        keep = [i for i in range(len(self._uploads)) if i not in set(failed)]
        self._uploads = [self._uploads[i] for i in keep]
        self._upload_locs = [self._upload_locs[i] for i in keep]
        if len(self._uploads) >= self.min_replicas:
            log.info("write %s: continuing block %d on %d surviving "
                     "replica(s)", self.path, bid, len(self._uploads))
            return True
        await self._recover_block(cause)
        return False

    async def _recover_block(self, cause) -> None:
        """Abandon the open block, ask for another away from the workers
        that failed, and replay the buffer into it; the stream is then
        where the caller left it. A further failure re-places again until
        the 90 s deadline. With the buffer off (or a failure inside a
        replay) ``cause`` is raised."""
        if self._recovering or self._replay is None:
            raise cause
        loop = asyncio.get_running_loop()
        deadline = loop.time() + OPEN_DEADLINE_S
        replay = bytes(self._replay)
        log.warning("write %s: block lost its legs (%s); abandoning it and "
                    "replaying %d bytes", self.path, cause, len(replay))
        while True:
            abandon = self._block.block.id if self._block is not None \
                else None
            await self._abort_upload()
            self._block = None
            await self._next_block(abandon=abandon, deadline=deadline)
            try:
                self._recovering = True
                try:
                    view = memoryview(replay)
                    for off in range(0, len(replay), self.chunk_size):
                        await self._send_chunk(
                            view[off:off + self.chunk_size])
                finally:
                    self._recovering = False
                self._count("write.block_replay_bytes", len(replay))
                log.info("write %s: block re-placed as %d, %d bytes "
                         "replayed", self.path, self._block.block.id,
                         len(replay))
                return
            except _UPLOAD_EXC as e:
                # the new block failed too (its workers are now excluded)
                if loop.time() >= deadline:
                    raise
                cause = e

    async def _flush_chunk(self) -> None:
        if not self._buf:
            return
        chunk = memoryview(self._buf)
        try:
            await self._send_chunk(chunk)
        finally:
            chunk.release()       # the bytearray cannot shrink while viewed
        self._buf.clear()

    async def _next_block(self, abandon: int | None = None,
                          deadline: float | None = None) -> None:
        """Allocate and open the next block. A retryable refusal (a
        worker's CapacityPending while space clears after a restart, a
        worker that cannot be reached) backs off and asks again,
        abandoning the refused block and excluding the workers this
        stream saw fail and those behind open breakers, until the
        deadline; the commits ride only the first request. Exclusions
        that leave no worker are dropped. A
        recovery passes the block to abandon and its own deadline, and
        then NO_AVAILABLE_WORKER is waited out too: the caller's bytes
        sit in the replay buffer."""
        loop = asyncio.get_running_loop()
        commits, self._commits = self._commits, []
        recovering = deadline is not None
        if deadline is None:
            deadline = loop.time() + OPEN_DEADLINE_S
        delay = 0.4
        use_exclude = True
        while True:
            excl = set(self._failed_workers)
            if self.health is not None:
                excl |= self.health.open_worker_ids()
            exclude = sorted(excl) if use_exclude else []
            try:
                self._block = await self.fs.add_block(
                    self.path, commit_blocks=commits,
                    exclude_workers=exclude or None,
                    ici_coords=self.ici_coords, abandon_block=abandon)
                commits = []
                await self._open_block()
                return
            except err.CurvineError as e:
                await self._abort_upload()
                if self._block is not None:
                    abandon = self._block.block.id
                    self._block = None
                if exclude and e.code == err.ErrorCode.NO_AVAILABLE_WORKER:
                    use_exclude = False
                    continue
                retryable = e.retryable or (
                    recovering
                    and e.code == err.ErrorCode.NO_AVAILABLE_WORKER)
                if not retryable or loop.time() >= deadline:
                    raise
                sleep = delay * (0.5 + random.random() / 2)
                log.debug("block open retry in %.2fs: %s", sleep, e)
                await asyncio.sleep(sleep)
                delay = min(delay * 2, 10.0)

    async def _open_block(self) -> None:
        locs = self._block.locs
        if not locs:
            raise err.NoAvailableWorker(f"no locations for {self.path}")
        self._block_written = 0
        self._block_crc = 0
        self._uploads = []
        self._upload_locs = []
        if self.short_circuit and len(locs) == 1:
            if await self._try_short_circuit(locs[0]):
                return
            self._count("sc.write.fallbacks")
        for loc in locs:
            addr = self._addr(loc)
            try:
                # a span an attempt: a refused open is a span in error
                with self._span("write_attempt", addr=addr,
                                block=self._block.block.id):
                    conn = await self.pool.get(addr)
                    up = await conn.open_upload(RpcCode.WRITE_BLOCK, header={
                        "block_id": self._block.block.id,
                        "storage_type": int(self.storage_type),
                        "algo": self._crc_algo,
                        "len_hint": self.block_size})
            except err.CurvineError:
                # the next placement leaves this worker out, and so do
                # the next files' once its breaker opens
                self._failed_workers.add(loc.worker_id)
                if self.health is not None:
                    self.health.fail(addr, worker_id=loc.worker_id)
                raise
            if self.health is not None:
                self.health.ok(addr)
            self._uploads.append(up)
            self._upload_locs.append(loc)

    async def _try_short_circuit(self, loc) -> bool:
        """A temp-file grant for the open block from its worker when the
        worker is on this host, and the file opened for writing; False
        (the block goes over WRITE_BLOCK) when the worker is elsewhere or
        refuses."""
        if not self.fs.is_local(loc):
            return False
        try:
            conn = await self.pool.get(self._addr(loc))
            rep = await conn.call(RpcCode.SC_WRITE_OPEN, data=pack({
                "block_id": self._block.block.id,
                "storage_type": int(self.storage_type),
                "len_hint": self.block_size}))
            body = unpack(rep.data) or {}
            path = body.get("path")
            if not path:
                return False
            self._sc_conn = conn
            self._sc_file = open(path, "wb")
            self._sc_worker_id = body.get("worker_id", loc.worker_id)
            return True
        except (err.CurvineError, OSError) as e:
            log.debug("short-circuit write of block %d refused: %s",
                      self._block.block.id, e)
            await self._abort_upload()
            return False

    async def _abort_upload(self) -> None:
        """Drop the open block's streams: the short-circuit grant (the
        worker deletes its temp file) or every WRITE_BLOCK upload."""
        if self._sc_file is not None:
            self._sc_file.close()
            self._sc_file = None
        if self._sc_conn is not None:
            conn, self._sc_conn = self._sc_conn, None
            try:
                await conn.call(RpcCode.SC_WRITE_ABORT, data=pack(
                    {"block_id": self._block.block.id}))
            except err.CurvineError as e:
                log.debug("short-circuit abort of block %d: %s",
                          self._block.block.id, e)
        for up in self._uploads:
            try:
                await up.abort()
            except (err.CurvineError, OSError):
                pass        # one dead leg must not skip the others
        self._uploads = []
        self._upload_locs = []

    async def _seal_block(self) -> None:
        if self._block is None:
            return
        await self._flush_chunk()
        for attempt in range(3):
            try:
                worker_ids = await self._finish_block()
                break
            except _UPLOAD_EXC as e:
                # the finish or the commit lost the block's legs: the
                # buffer holds all of it now; with it off, e is raised
                if attempt == 2:
                    raise
                await self._recover_block(e)
        self._commits.append(CommitBlock(
            block_id=self._block.block.id, block_len=self._block_written,
            worker_ids=worker_ids, storage_type=self.storage_type))
        self._block = None
        self._uploads = []
        self._upload_locs = []
        if self._replay is not None:
            self._replay = bytearray()      # sealed: nothing to replay

    async def _finish_block(self) -> list[int]:
        """End the block with its crc: SC_WRITE_COMMIT of the temp file
        with its length, or every leg's EOF at once. Returns the worker
        ids the commit lists: those whose finish was acked and that the
        master still holds live. A leg lost at its finish leaves a
        degraded commit on at least ``min_replicas`` survivors, and is
        reported; fewer raise, for the seal to recover the block."""
        if self._sc_file is not None:
            self._sc_file.close()
            self._sc_file = None
            try:
                rep = await self._sc_conn.call(
                    RpcCode.SC_WRITE_COMMIT, data=pack({
                        "block_id": self._block.block.id,
                        "len": self._block_written,
                        "crc32": self._block_crc, "algo": self._crc_algo}))
            except _UPLOAD_EXC as e:
                self._note_sc_failed(e)
                raise
            self._sc_conn = None
            return [(unpack(rep.data) or {}).get("worker_id",
                                                 self._sc_worker_id)]
        acks = await asyncio.gather(
            *(up.finish(header={"crc32": self._block_crc,
                                "algo": self._crc_algo})
              for up in self._uploads),
            return_exceptions=True)
        survivors: list[tuple[int, object]] = []
        lost: list = []
        cause = None
        for ack, loc in zip(acks, self._upload_locs):
            if isinstance(ack, BaseException):
                if not isinstance(ack, _UPLOAD_EXC):
                    raise ack
                lost.append(loc)
                cause = cause or ack
            else:
                survivors.append((ack.header.get("worker_id",
                                                 loc.worker_id), loc))
        if not lost:
            return [wid for wid, _ in survivors]
        for loc in lost:
            self._note_leg_failed(loc, loc.worker_id, cause)
        if survivors:
            # a survivor may have died between its ack and this commit:
            # the master confirms which it still holds live, on the
            # report that flags the lost replica
            bid = self._block.block.id
            try:
                resp = await self.fs.call(
                    RpcCode.REPORT_UNDER_REPLICATED_BLOCKS,
                    {"block_ids": [bid], "worker_id": lost[0].worker_id,
                     "confirm_live": [wid for wid, _ in survivors]})
                live = set(resp.get("live", ()))
            except Exception as e:  # noqa: BLE001 — the commit then fails
                log.debug("degraded-commit liveness check failed: %s", e)
                live = {wid for wid, _ in survivors}
            for wid, loc in survivors:
                if wid not in live:
                    self._note_leg_failed(loc, wid, cause)
            survivors = [x for x in survivors if x[0] in live]
            for loc in lost[1:]:
                self._report_lost_replica(bid, loc.worker_id)
        worker_ids = [wid for wid, _ in survivors]
        if len(worker_ids) < self.min_replicas:
            raise cause
        self._count("write.degraded_commits")
        log.warning("write %s: degraded commit of block %d on %d/%d "
                    "replicas", self.path, self._block.block.id,
                    len(worker_ids), len(worker_ids) + len(lost))
        return worker_ids

    async def flush(self) -> None:
        """Send the partial chunk to the open block's legs."""
        await self._flush_chunk()

    async def hflush(self) -> None:
        """A durable flush: the partial chunk sent, the open block back at
        ``min(min_replicas, len(locs))`` live legs (recovered first when
        fewer remain), and the sealed blocks' commits journaled at the
        master (COMPLETE_FILE with ``only_flush``); the file stays open
        for more writes."""
        await self._flush_chunk()
        if self._block is not None and self._sc_file is None \
                and len(self._uploads) < min(self.min_replicas,
                                             len(self._block.locs)):
            await self._recover_block(
                err.ConnectError("hflush below min replicas"))
        if self._commits:
            commits, self._commits = self._commits, []
            await self.fs.complete_file(self.path, self.pos,
                                        commit_blocks=commits,
                                        only_flush=True)

    async def close(self) -> None:
        if self._closed:
            return
        with self._span("write_commit", path=self.path, bytes=self.pos):
            await self._seal_block()
            commits, self._commits = self._commits, []
            await self.fs.complete_file(self.path, self.pos,
                                        commit_blocks=commits)
        self._closed = True
        await asyncio.gather(*self._reports, return_exceptions=True)

    async def abort(self) -> None:
        await self._abort_upload()
        self._closed = True
        await asyncio.gather(*self._reports, return_exceptions=True)

    async def __aenter__(self) -> "FsWriter":
        return self

    async def __aexit__(self, et, ev, tb) -> None:
        if et is None:
            await self.close()
        else:
            await self.abort()
