"""File writer: the short-circuit write of a co-located block, WRITE_BLOCK
streams otherwise.

Own copy of the path of ``curvine_tpu/client/writer.py`` (:152-678) that
a write of one replica takes: ``write`` cuts the caller's bytes into
chunks (whole chunks go out of the caller's buffer uncopied, a partial
one is held until it fills), ``_next_block`` asks the master for a block
(the sealed blocks' commits ride on that call, and a retryable refusal
is retried for up to 90 s, abandoning the refused block),
``_open_block`` opens the block, ``_send_chunk`` writes a chunk and
chains the block's crc32c (the port's ``csrc/crc32c.cc``),
``_seal_block`` and ``_finish_block`` end it with the crc and keep the
commit, and ``close`` completes the file at the master. Files have one
replica on the mem tier (``common/conf.py``), so a block has one
location: a block placed on more raises.

The short circuit (:437-438, :464-488, :539-552): when
``short_circuit`` is on and the block's worker is on this host, the
worker grants a temp block file (SC_WRITE_OPEN, which answers with its
path), the writer writes the caller's bytes straight into it (no socket,
no chunking, one crc pass) and commits it with its length and crc
(SC_WRITE_COMMIT); ``abort`` sends SC_WRITE_ABORT, which drops the temp
file. A worker that refuses the grant (a bdev tier, a draining worker)
or a location off this host sends the block over WRITE_BLOCK, and the
counter ``sc.write.fallbacks`` counts such blocks. Bytes written by short
circuit count as ``sc.bytes.written`` (the reference's name), all bytes
as ``write.bytes``.

Left out (ROADMAP A3b): writes of more than one replica and their
recovery (:271-403: the fan-out legs, the replay buffer, dropping a
failed leg, re-placing a lost block). Where the reference abandons a
block whose short-circuit write hit an ``OSError`` and replays it, or
re-places a block whose upload failed, the port raises: a failed block
fails the write, and ``abort`` drops the open block. Also left out:
``hflush``, the circuit breaker and tracing."""

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


class FsWriter:
    def __init__(self, fs_client, path: str, pool: ConnectionPool,
                 block_size: int, chunk_size: int = WRITE_CHUNK_SIZE,
                 short_circuit: bool = True, counters: dict | None = None):
        self.fs = fs_client
        self.path = path
        self.pool = pool
        self.block_size = block_size
        self.chunk_size = chunk_size
        self.short_circuit = short_circuit
        self.counters = counters if counters is not None else {}
        self.pos = 0
        self._buf = bytearray()
        self._block: LocatedBlock | None = None
        self._upload = None
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

    @staticmethod
    def _addr(loc) -> str:
        return f"{loc.ip_addr or loc.hostname}:{loc.rpc_port}"

    def _count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

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
        self._block_crc = crc_update(self._crc_algo, chunk, self._block_crc)
        if self._sc_file is not None:
            # an OSError here (EIO, ENOSPC on the worker's media) fails
            # the write: the reference re-places and replays the block
            self._sc_file.write(chunk)
            self._count("sc.bytes.written", len(chunk))
        else:
            await self._upload.send_chunk(chunk)
        self._block_written += len(chunk)
        self._count("write.bytes", len(chunk))

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
        worker's CapacityPending while space clears after a restart)
        backs off and asks again, abandoning the refused block, until the
        deadline; the commits ride only the first request."""
        loop = asyncio.get_running_loop()
        commits, self._commits = self._commits, []
        deadline = loop.time() + OPEN_DEADLINE_S
        abandon = None
        delay = 0.4
        while True:
            try:
                self._block = await self.fs.add_block(
                    self.path, commit_blocks=commits, abandon_block=abandon)
                commits = []
                await self._open_block()
                return
            except err.CurvineError as e:
                await self._abort_upload()
                if self._block is not None:
                    abandon = self._block.block.id
                    self._block = None
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
        if len(locs) != 1:
            raise NotImplementedError(
                f"block {self._block.block.id} placed on {len(locs)} "
                f"workers: the port writes one replica (ROADMAP A3b)")
        self._block_written = 0
        self._block_crc = 0
        if self.short_circuit:
            if await self._try_short_circuit(locs[0]):
                return
            self._count("sc.write.fallbacks")
        conn = await self.pool.get(self._addr(locs[0]))
        self._upload = await conn.open_upload(RpcCode.WRITE_BLOCK, header={
            "block_id": self._block.block.id,
            "storage_type": int(StorageType.MEM),
            "algo": self._crc_algo, "len_hint": self.block_size})

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
        """Drop the open block's stream: the short-circuit grant (the
        worker deletes its temp file) or the WRITE_BLOCK upload."""
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
        if self._upload is not None:
            await self._upload.abort()
            self._upload = None

    async def _seal_block(self) -> None:
        if self._block is None:
            return
        await self._flush_chunk()
        worker_id = await self._finish_block()
        self._commits.append(CommitBlock(
            block_id=self._block.block.id, block_len=self._block_written,
            worker_ids=[worker_id], storage_type=StorageType.MEM))
        self._block = None
        self._upload = None

    async def _finish_block(self) -> int:
        """End the block with its crc: SC_WRITE_COMMIT of the temp file
        with its length, or the upload's EOF. The worker's answer names
        the worker id the commit lists."""
        if self._sc_file is not None:
            self._sc_file.close()
            self._sc_file = None
            rep = await self._sc_conn.call(
                RpcCode.SC_WRITE_COMMIT, data=pack({
                    "block_id": self._block.block.id,
                    "len": self._block_written,
                    "crc32": self._block_crc, "algo": self._crc_algo}))
            self._sc_conn = None
            return (unpack(rep.data) or {}).get("worker_id",
                                                self._sc_worker_id)
        ack = await self._upload.finish(header={"crc32": self._block_crc,
                                                "algo": self._crc_algo})
        return ack.header.get("worker_id", self._block.locs[0].worker_id)

    async def close(self) -> None:
        if self._closed:
            return
        await self._seal_block()
        commits, self._commits = self._commits, []
        await self.fs.complete_file(self.path, self.pos,
                                    commit_blocks=commits)
        self._closed = True

    async def abort(self) -> None:
        await self._abort_upload()
        self._closed = True

    async def __aenter__(self) -> "FsWriter":
        return self

    async def __aexit__(self, et, ev, tb) -> None:
        if et is None:
            await self.close()
        else:
            await self.abort()
