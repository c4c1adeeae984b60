"""The port's cache client.

Own copy of the parts of ``curvine_tpu/client/unified.py`` (:28-72,
:134-201, :398-406) that the cache feed and its writer call:
``CurvineClient`` with ``meta`` (the ``FsClient``), ``create``, ``open``,
``write_all``, ``read_all`` and ``advise`` (the master's rolling
prefetch window), over one connection pool to the workers. The readers
and writers it opens share ``counters``: ``sc.bytes.read`` and
``sc.bytes.written`` (short circuit), ``read.zero_copy_bytes``
(READ_BLOCK into the caller's buffer), ``write.bytes`` (all bytes
written), ``sc.write.fallbacks`` (blocks that went over WRITE_BLOCK with
the short circuit on) and ``advise.rpcs``.

Left out (ROADMAP A3): the worker circuit breaker, the metadata cache,
tracing, the metrics flush to the master, tenants, appends, batched
small-file writes, and the UFS side (fallback reads through a mount,
loads, exports, write-through): ``read_all`` reads cached files only and
raises for a file that is not complete or has a block with no live
location."""

from __future__ import annotations

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.client.fs_client import FsClient
from curvine_tpu_torch.client.reader import FsReader
from curvine_tpu_torch.client.writer import FsWriter
from curvine_tpu_torch.rpc.client import ConnectionPool


class CurvineClient:
    def __init__(self, conf: ClusterConf | None = None):
        self.conf = conf or ClusterConf()
        cc = self.conf.client
        self.meta = FsClient(self.conf)
        self.pool = ConnectionPool(size=cc.conn_pool_size,
                                   timeout_ms=cc.rpc_timeout_ms)
        self.counters: dict[str, int] = {}

    async def close(self) -> None:
        await self.meta.close()
        await self.pool.close()

    async def __aenter__(self) -> "CurvineClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def create(self, path: str, overwrite: bool = False) -> FsWriter:
        """A new file, its block size from the client's conf: one
        replica, on the mem tier."""
        cc = self.conf.client
        await self.meta.create_file(path, overwrite=overwrite)
        return FsWriter(self.meta, path, self.pool,
                        block_size=cc.block_size,
                        short_circuit=cc.short_circuit,
                        counters=self.counters)

    async def open(self, path: str) -> FsReader:
        return self._reader(path, await self.meta.get_block_locations(path))

    def _reader(self, path: str, fb) -> FsReader:
        cc = self.conf.client
        return FsReader(self.meta, path, fb, self.pool,
                        chunk_size=cc.read_chunk_size,
                        short_circuit=cc.short_circuit,
                        counters=self.counters, verify=cc.read_verify)

    async def write_all(self, path: str, data) -> None:
        async with await self.create(path, overwrite=True) as w:
            await w.write(data)

    async def read_all(self, path: str) -> bytes:
        """The whole of a cached file."""
        fb = await self.meta.get_block_locations(path)
        if not fb.status.is_complete:
            raise err.Uncompleted(f"{path} is still being written")
        missing = [lb.block.id for lb in fb.block_locs
                   if not lb.locs and lb.ec is None]
        if missing:
            raise err.BlockNotFound(f"{path}: blocks {missing} have no live "
                                    f"location (UFS fallback is not ported)")
        r = self._reader(path, fb)
        try:
            return await r.read_all()
        finally:
            await r.close()

    async def advise(self, path: str, cursor: int = 0, window: int = 8,
                     epoch: int = 0, seed: int = 0) -> dict:
        """Tell the master the reader of ``path``'s shards is at index
        ``cursor`` of the (seed, epoch) order; it keeps the next
        ``window`` shards warm."""
        self.counters["advise.rpcs"] = self.counters.get("advise.rpcs", 0) + 1
        return await self.meta.prefetch_window(path, cursor=cursor,
                                               window=window, epoch=epoch,
                                               seed=seed)
