"""Token-shard feed for PyTorch training loops on the card.

Port of ``curvine_tpu/tpu/loader.py``. The batching is the JAX
package's: a deterministic per-epoch shard order, tokens carried across
shard boundaries, and ``drop_remainder``. Shards are raw little-endian
token arrays, one file per shard. With a ``mesh``, the feeds deliver
DTensors laid out by ``model.batch_spec``: the batch over ``data``, the
sequence over ``seq`` where the mesh has it (loader.py:190-193).

Two sources feed the same batching:

- ``CacheShardSource`` (:24-133) reads the shards out of the cache
  through the port's ``CurvineClient``: ``mmap_view`` where the block is
  on this host (a read-only view of the worker's sealed memfd when it
  offers the shared-memory plane, which the staging ring then copies to
  the card; else one preadv, the fd short circuit), ``read_all``
  (READ_BLOCK) otherwise; ``fetch_split`` splits ``cache_fetch`` into
  the probe, the map and the copy; with ``prefetch=True`` it advises the master's rolling
  prefetch window as its cursor moves, fire-and-forget, and advises the
  next epoch's head near the end of each epoch.
  ``write_token_shards`` (:135-166) writes shards through the client
  after one META_BATCH warm-up, and ``GpuTrainFeed`` (:169-199) is
  ``TpuTrainFeed``.
- ``ShardSource`` reads shard files under a POSIX directory, such as the
  cache's FUSE mount, mapped read-only; ``write_posix_shards`` and
  ``PosixTrainFeed`` are its writer and feed."""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import AsyncIterator

import numpy as np

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.epoch import epoch_shard_order
from curvine_tpu_torch.gpu.ingest import AsyncDevicePrefetcher
from curvine_tpu_torch.gpu.model import batch_spec
from curvine_tpu_torch.obs.profiler import StepProfiler
from curvine_tpu_torch.worker.blockfile import map_block

__all__ = ["CacheShardSource", "GpuTrainFeed", "write_token_shards",
           "ShardSource", "PosixTrainFeed", "write_posix_shards"]

log = logging.getLogger(__name__)


class _Batcher:
    """The batching both sources share: [batch, seq_len] slices of the
    shards' tokens in shard order, a shard's tail carried into the next,
    and the epoch's last partial batch zero-padded unless
    ``drop_remainder``."""

    def __init__(self, batch: int, seq_len: int, dtype, shuffle_seed,
                 drop_remainder: bool, profiler, epoch: int):
        self.batch = batch
        self.seq_len = seq_len
        self.dtype = np.dtype(dtype)
        self.shuffle_seed = shuffle_seed
        self.drop_remainder = drop_remainder
        # optional StepProfiler (obs/profiler.py): cache_fetch + decode
        # stage timings per shard
        self.profiler = profiler
        self.epoch = int(epoch)

    async def _fetch(self, shard) -> tuple[np.ndarray, int, object]:
        """A shard's tokens, its size in bytes, and what to close after."""
        raise NotImplementedError

    async def _order(self) -> list:
        raise NotImplementedError

    def _on_shard(self, idx: int, n_shards: int) -> None:
        """Called before shard ``idx`` of the epoch is fetched."""

    async def _epoch_done(self) -> None:
        """Called when the epoch's shards are drained."""

    async def batches(self) -> AsyncIterator[np.ndarray]:
        tokens_per_batch = self.batch * self.seq_len
        carry = np.empty(0, dtype=self.dtype)
        order = await self._order()
        for idx, shard in enumerate(order):
            self._on_shard(idx, len(order))
            t0 = time.perf_counter()
            data, size, closer = await self._fetch(shard)
            if self.profiler is not None:
                self.profiler.record("cache_fetch", time.perf_counter() - t0,
                                     size)
            t0 = time.perf_counter()
            if carry.size:
                data = np.concatenate([carry, data])
                carry = np.empty(0, dtype=self.dtype)
            if self.profiler is not None:
                self.profiler.record("decode", time.perf_counter() - t0)
            usable = (data.size // tokens_per_batch) * tokens_per_batch
            for off in range(0, usable, tokens_per_batch):
                yield data[off:off + tokens_per_batch].reshape(
                    self.batch, self.seq_len)
            rest = data[usable:]
            if rest.size:
                carry = rest.copy()     # own it; the shard's buffer goes
            if closer is not None:
                await closer.close()
        await self._epoch_done()
        # epoch drained: subsequent batches() calls replay the next epoch
        self.epoch += 1
        if carry.size and not self.drop_remainder:
            pad = tokens_per_batch - carry.size
            yield np.pad(carry, (0, pad)).reshape(self.batch, self.seq_len)


class CacheShardSource(_Batcher):
    """Async stream of [batch, seq_len] token batches out of the shards
    under ``path`` in the cache. Shard order is a deterministic per-epoch
    permutation of the sorted listing, seeded by (shuffle_seed, epoch)."""

    def __init__(self, client, path: str, batch: int, seq_len: int,
                 dtype=np.int32, shuffle_seed: int | None = None,
                 drop_remainder: bool = True, profiler=None, epoch: int = 0,
                 prefetch: bool = False, prefetch_window: int = 8):
        super().__init__(batch, seq_len, dtype, shuffle_seed,
                         drop_remainder, profiler, epoch)
        self.client = client
        self.path = path
        self.prefetch = prefetch
        self.prefetch_window = int(prefetch_window)
        self._advise_tasks: set[asyncio.Task] = set()
        self._advised_next_epoch = False
        # cache_fetch split, seconds summed over the shards fetched: the
        # probe (GET_BLOCK_INFO), the map (a shm memfd's fetch, seal
        # check, map and verify at a block's first read, or the block
        # file's open) and the copy (out of the mapping, the preadv, or
        # READ_BLOCK's stream when the block is not on this host)
        self.fetch_split = {"probe": 0.0, "map": 0.0, "copy": 0.0}

    async def shards(self, epoch: int | None = None) -> list[str]:
        statuses = await self.client.meta.list_status(self.path)
        files = sorted(s.path for s in statuses if not s.is_dir)
        return epoch_shard_order(files, self.shuffle_seed,
                                 self.epoch if epoch is None else epoch)

    async def next_epoch_order(self) -> list[str]:
        """The shard order the next epoch will use."""
        return await self.shards(epoch=self.epoch + 1)

    async def _advise(self, cursor: int, epoch: int) -> None:
        try:
            await self.client.advise(
                self.path, cursor=cursor, window=self.prefetch_window,
                epoch=epoch, seed=self.shuffle_seed or 0)
        except err.CurvineError as e:   # advisory: never fails the read
            log.debug("prefetch advise failed: %s", e)

    def _advise_bg(self, cursor: int, epoch: int | None = None) -> None:
        """Advise without waiting: the window RPC must stay out of the
        read path (``input_wait`` is what it exists to shrink)."""
        if not self.prefetch:
            return
        t = asyncio.ensure_future(self._advise(
            cursor, self.epoch if epoch is None else epoch))
        self._advise_tasks.add(t)
        t.add_done_callback(self._advise_tasks.discard)

    async def _order(self) -> list[str]:
        self._advised_next_epoch = False
        return await self.shards()

    def _on_shard(self, idx: int, n_shards: int) -> None:
        self._advise_bg(idx)
        if not self._advised_next_epoch \
                and idx >= n_shards - self.prefetch_window:
            # the epoch's tail: start warming the next epoch's head
            self._advise_bg(0, epoch=self.epoch + 1)
            self._advised_next_epoch = True

    async def _fetch(self, shard: str):
        reader = await self.client.open(shard)
        n_bytes = reader.len // self.dtype.itemsize * self.dtype.itemsize
        view = await reader.mmap_view(0, n_bytes)
        if view is None:
            split = reader.fetch_split
            t0, before = time.perf_counter(), sum(split.values())
            view = np.frombuffer(await reader.read_all(),
                                 dtype=np.uint8)[:n_bytes]
            # what the parts did not count: READ_BLOCK's stream
            split["copy"] += max(0.0, time.perf_counter() - t0
                                 - (sum(split.values()) - before))
        for part, sec in reader.fetch_split.items():
            self.fetch_split[part] += sec
        return view.view(self.dtype), reader.len, reader

    async def _epoch_done(self) -> None:
        if self._advise_tasks:
            await asyncio.gather(*list(self._advise_tasks),
                                 return_exceptions=True)


async def write_token_shards(client, path: str, tokens: np.ndarray,
                             shard_tokens: int, dtype=np.int32) -> list[str]:
    """Split a token stream into shard files ``shard-%05d.bin`` under
    ``path`` in the cache. The warm-up is one META_BATCH: the mkdir and
    the deletion of stale shards of an earlier run, which would otherwise
    leak into the token flow."""
    tokens = np.asarray(tokens).astype(dtype, copy=False)
    base = path.rstrip("/")
    n_shards = (tokens.size + shard_tokens - 1) // shard_tokens
    keep = {f"{base}/shard-{i:05d}.bin" for i in range(n_shards)}
    warmup = [{"op": "mkdir", "path": path, "create_parent": True}]
    try:
        stale = [s.path for s in await client.meta.list_status(path)
                 if not s.is_dir and s.path not in keep]
        warmup += [{"op": "delete", "path": p} for p in sorted(stale)]
    except err.FileNotFound:
        pass
    for r in await client.meta.meta_batch(warmup):
        if "error" in r:
            raise err.CurvineError.from_wire(r.get("error_code", 0),
                                             r["error"])
    out = []
    for i, off in enumerate(range(0, tokens.size, shard_tokens)):
        p = f"{base}/shard-{i:05d}.bin"
        await client.write_all(p, tokens[off:off + shard_tokens])
        out.append(p)
    return out


class ShardSource(_Batcher):
    """Async stream of [batch, seq_len] token batches out of the shard
    files directly under ``root``, mapped read-only (the counterpart of
    the client's short circuit). Shard order is a deterministic per-epoch
    permutation of the sorted listing, seeded by (shuffle_seed, epoch)."""

    def __init__(self, root: str, batch: int, seq_len: int, dtype=np.int32,
                 shuffle_seed: int | None = None, drop_remainder: bool = True,
                 profiler=None, epoch: int = 0):
        super().__init__(batch, seq_len, dtype, shuffle_seed,
                         drop_remainder, profiler, epoch)
        self.root = root

    def shards(self, epoch: int | None = None) -> list[str]:
        files = [e.path for e in os.scandir(self.root) if e.is_file()]
        return epoch_shard_order(files, self.shuffle_seed,
                                 self.epoch if epoch is None else epoch)

    async def _order(self) -> list[str]:
        return self.shards()

    async def _fetch(self, shard: str):
        size = os.path.getsize(shard)
        n_bytes = size // self.dtype.itemsize * self.dtype.itemsize
        return map_block(shard, 0, n_bytes).view(self.dtype), size, None


def write_posix_shards(root: str, tokens: np.ndarray, shard_tokens: int,
                       dtype=np.int32) -> list[str]:
    """Split a token stream into shard files ``shard-%05d.bin`` under
    ``root`` (created if missing); stale higher-numbered shards from an
    earlier run are removed so they cannot leak into the token flow."""
    tokens = np.asarray(tokens).astype(dtype, copy=False)
    os.makedirs(root, exist_ok=True)
    n_shards = (tokens.size + shard_tokens - 1) // shard_tokens
    keep = {f"shard-{i:05d}.bin" for i in range(n_shards)}
    for e in os.scandir(root):
        if e.is_file() and e.name not in keep:
            os.unlink(e.path)
    out = []
    for i, off in enumerate(range(0, tokens.size, shard_tokens)):
        p = os.path.join(root, f"shard-{i:05d}.bin")
        tokens[off:off + shard_tokens].tofile(p)
        out.append(p)
    return out


class _Feed:
    """A batch source → AsyncDevicePrefetcher: the source → device →
    step pipeline, on one device or, with ``mesh``, as this rank's part
    of batches laid out by ``batch_spec(mesh)``. One StepProfiler threads
    it: cache_fetch and decode from the source, host_to_hbm, compute_wait
    and input_wait from the prefetcher; ``feed.profiler.summary()``
    answers "where did the step go". ``make_source`` builds the source
    around that profiler."""

    def __init__(self, make_source, depth: int, device, profiler, mesh):
        self.profiler = profiler if profiler is not None else StepProfiler()
        self.source = make_source(self.profiler)
        self.prefetcher = AsyncDevicePrefetcher(
            self.source.batches(), depth=depth, device=device,
            profiler=self.profiler, mesh=mesh,
            spec=None if mesh is None else batch_spec(mesh))

    def __aiter__(self):
        return self.prefetcher


class GpuTrainFeed(_Feed):
    """The feed over ``CacheShardSource``: shards under ``path`` of the
    cache, read through ``client``."""

    def __init__(self, client, path: str, batch: int, seq_len: int,
                 depth: int = 2, dtype=np.int32, profiler=None,
                 shuffle_seed: int | None = None, prefetch: bool = False,
                 prefetch_window: int = 8, device=None, mesh=None):
        super().__init__(lambda prof: CacheShardSource(
            client, path, batch, seq_len, dtype, shuffle_seed=shuffle_seed,
            profiler=prof, prefetch=prefetch,
            prefetch_window=prefetch_window), depth, device, profiler, mesh)


class PosixTrainFeed(_Feed):
    """The feed over ``ShardSource``: shard files under ``root``."""

    def __init__(self, root: str, batch: int, seq_len: int, depth: int = 2,
                 dtype=np.int32, profiler=None,
                 shuffle_seed: int | None = None, device=None, mesh=None):
        super().__init__(lambda prof: ShardSource(
            root, batch, seq_len, dtype, shuffle_seed=shuffle_seed,
            profiler=prof), depth, device, profiler, mesh)
