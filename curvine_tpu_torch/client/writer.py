"""File writer: one upload leg per replica, the short-circuit write of a
co-located single-replica block.

Own copy of ``curvine_tpu/client/writer.py`` (:152-678) without its
replay buffer. ``write`` cuts the caller's bytes into chunks (whole
chunks go out of the caller's buffer uncopied, a partial one is held
until it fills), ``_next_block`` asks the master for a block (the sealed
blocks' commits ride on that call; the writer's ``ici_coords`` steer the
``ici`` placement; a retryable refusal is retried for up to 90 s,
abandoning the refused block and excluding the workers this stream saw
fail), ``_open_block`` opens one WRITE_BLOCK upload leg per location
(:427-463), ``_send_chunk`` chains the block's crc32c (the port's
``csrc/crc32c.cc``) and sends each chunk to every leg at once (:197-270),
``_seal_block`` and ``_finish_block`` end every leg with the crc and
keep the commit of the legs that acked (:492-611), and ``close``
completes the file at the master.

A leg that fails mid-block is dropped (``_drop_replicas``, :271-296):
its upload is aborted, the failure counted (``write.replica_failover``)
and reported to the master for healing (``_report_lost_replica``,
:136-150, REPORT_UNDER_REPLICATED_BLOCKS with its worker id), and the
block streams on while at least ``min_replicas`` legs survive. A leg
that fails its finish leaves a degraded commit on the survivors
(``write.degraded_commits``), after the master confirms they are live.
Below ``min_replicas``, and when the one leg of a single-replica block
fails, the port raises: the reference's replay buffer and re-placement
of the block (:297-403) are ROADMAP A3e's, and ``abort`` drops the open
block.

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
reference's name), all bytes as ``write.bytes``. Also left out:
``hflush``, the circuit breaker (the workers this stream saw fail stand
in for its exclusions) and tracing."""

from __future__ import annotations

import asyncio
import logging
import random

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import WRITE_CHUNK_SIZE
from curvine_tpu_torch.common.types import (CommitBlock, LocatedBlock,
                                            StorageType)
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker.blockfile import ALGO_CRC32C, crc_update

log = logging.getLogger(__name__)

OPEN_DEADLINE_S = 90.0

# the failures of one upload leg that dropping it absorbs: transport and
# worker errors, timeouts; anything else propagates
_UPLOAD_EXC = (err.CurvineError, OSError, asyncio.TimeoutError)


class FsWriter:
    def __init__(self, fs_client, path: str, pool: ConnectionPool,
                 block_size: int, chunk_size: int = WRITE_CHUNK_SIZE,
                 short_circuit: bool = True, counters: dict | None = None,
                 ici_coords: list[int] | None = None,
                 min_replicas: int = 1):
        self.fs = fs_client
        self.path = path
        self.pool = pool
        self.block_size = block_size
        self.chunk_size = chunk_size
        self.short_circuit = short_circuit
        self.counters = counters if counters is not None else {}
        self.ici_coords = ici_coords
        self.min_replicas = max(1, min_replicas)
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
        # workers this stream saw fail: kept out of its later placements
        self._failed_workers: set[int] = set()
        # reports of lost legs in flight, awaited at close
        self._reports: set[asyncio.Task] = set()

    @staticmethod
    def _addr(loc) -> str:
        return f"{loc.ip_addr or loc.hostname}:{loc.rpc_port}"

    def _count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def _note_leg_failed(self, loc, worker_id: int, cause) -> None:
        self._failed_workers.add(worker_id)
        self._count("write.replica_failover")
        log.warning("write %s: replica %s (worker %d) lost mid-block: %s",
                    self.path, self._addr(loc), worker_id, cause)

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
        crc = crc_update(self._crc_algo, chunk, self._block_crc)
        if self._sc_file is not None:
            # an OSError here (EIO, ENOSPC on the worker's media) fails
            # the write: the reference re-places and replays the block
            self._sc_file.write(chunk)
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
        if failed:
            await self._drop_replicas(failed, results[failed[0]])
        self._block_written += len(chunk)
        self._count("write.bytes", len(chunk))

    async def _drop_replicas(self, failed: list[int], cause) -> None:
        """Drop the legs that failed mid-chunk (each aborted, counted and
        reported to the master) and stream on while at least
        ``min_replicas`` survive; below that, raise ``cause``."""
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
        if len(self._uploads) < self.min_replicas:
            # the reference re-places the block and replays it from its
            # replay buffer (ROADMAP A3e)
            raise cause
        log.info("write %s: continuing block %d on %d surviving "
                 "replica(s)", self.path, bid, len(self._uploads))

    async def _flush_chunk(self) -> None:
        if not self._buf:
            return
        chunk = memoryview(self._buf)
        try:
            await self._send_chunk(chunk)
        finally:
            chunk.release()       # the bytearray cannot shrink while viewed
        self._buf.clear()

    async def _next_block(self) -> None:
        """Allocate and open the next block. A retryable refusal (a
        worker's CapacityPending while space clears after a restart, a
        worker that cannot be reached) backs off and asks again,
        abandoning the refused block and excluding the workers this
        stream saw fail, until the deadline; the commits ride only the
        first request. Exclusions that leave no worker are dropped."""
        loop = asyncio.get_running_loop()
        commits, self._commits = self._commits, []
        deadline = loop.time() + OPEN_DEADLINE_S
        abandon = None
        delay = 0.4
        use_exclude = True
        while True:
            exclude = sorted(self._failed_workers) if use_exclude else []
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
                if not e.retryable or loop.time() >= deadline:
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
            try:
                conn = await self.pool.get(self._addr(loc))
                up = await conn.open_upload(RpcCode.WRITE_BLOCK, header={
                    "block_id": self._block.block.id,
                    "storage_type": int(StorageType.MEM),
                    "algo": self._crc_algo, "len_hint": self.block_size})
            except err.CurvineError:
                # the next placement leaves this worker out
                self._failed_workers.add(loc.worker_id)
                raise
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
                "storage_type": int(StorageType.MEM),
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
        worker_ids = await self._finish_block()
        self._commits.append(CommitBlock(
            block_id=self._block.block.id, block_len=self._block_written,
            worker_ids=worker_ids, storage_type=StorageType.MEM))
        self._block = None
        self._uploads = []
        self._upload_locs = []

    async def _finish_block(self) -> list[int]:
        """End the block with its crc: SC_WRITE_COMMIT of the temp file
        with its length, or every leg's EOF at once. Returns the worker
        ids the commit lists: those whose finish was acked and that the
        master still holds live. A leg lost at its finish leaves a
        degraded commit on at least ``min_replicas`` survivors, and is
        reported; fewer raise."""
        if self._sc_file is not None:
            self._sc_file.close()
            self._sc_file = None
            rep = await self._sc_conn.call(
                RpcCode.SC_WRITE_COMMIT, data=pack({
                    "block_id": self._block.block.id,
                    "len": self._block_written,
                    "crc32": self._block_crc, "algo": self._crc_algo}))
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

    async def close(self) -> None:
        if self._closed:
            return
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
