"""Token-shard feed for PyTorch training loops on the card.

Port of ``curvine_tpu/tpu/loader.py`` (``CacheShardSource.batches`` at
:83-133 and ``TpuTrainFeed`` at :169-199). The batching is the JAX
package's: a deterministic per-epoch shard order, tokens carried across
shard boundaries, and ``drop_remainder``. Shards are raw little-endian
token arrays, one file per shard.

The port has no RPC client yet, so the bytes come from shard files under
a POSIX directory — the cache's FUSE mount, or any local copy — mapped
read-only with mmap (the counterpart of the client's short-circuit
``mmap_view``). The client-backed source and the prefetch ``advise``
calls come with the client slice."""

from __future__ import annotations

import os
import time
from typing import AsyncIterator

import numpy as np

from curvine_tpu_torch.common.epoch import epoch_shard_order
from curvine_tpu_torch.gpu.ingest import AsyncDevicePrefetcher
from curvine_tpu_torch.obs.profiler import StepProfiler
from curvine_tpu_torch.worker.blockfile import map_block

__all__ = ["ShardSource", "GpuTrainFeed", "write_token_shards"]


class ShardSource:
    """Async stream of [batch, seq_len] token batches out of the shard
    files directly under ``root``. Shard order is a deterministic
    per-epoch permutation of the sorted listing, seeded by
    (shuffle_seed, epoch)."""

    def __init__(self, root: str, batch: int, seq_len: int, dtype=np.int32,
                 shuffle_seed: int | None = None, drop_remainder: bool = True,
                 profiler=None, epoch: int = 0):
        self.root = root
        self.batch = batch
        self.seq_len = seq_len
        self.dtype = np.dtype(dtype)
        self.shuffle_seed = shuffle_seed
        self.drop_remainder = drop_remainder
        # optional StepProfiler (obs/profiler.py): cache_fetch + decode
        # stage timings per shard
        self.profiler = profiler
        self.epoch = int(epoch)

    def shards(self, epoch: int | None = None) -> list[str]:
        files = [e.path for e in os.scandir(self.root) if e.is_file()]
        return epoch_shard_order(files, self.shuffle_seed,
                                 self.epoch if epoch is None else epoch)

    async def batches(self) -> AsyncIterator[np.ndarray]:
        tokens_per_batch = self.batch * self.seq_len
        carry = np.empty(0, dtype=self.dtype)
        for shard in self.shards():
            t0 = time.perf_counter()
            size = os.path.getsize(shard)
            n_bytes = size // self.dtype.itemsize * self.dtype.itemsize
            data = map_block(shard, 0, n_bytes).view(self.dtype)
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
                carry = rest.copy()     # own it; the mapping goes with data
        # epoch drained: subsequent batches() calls replay the next epoch
        self.epoch += 1
        if carry.size and not self.drop_remainder:
            pad = tokens_per_batch - carry.size
            yield np.pad(carry, (0, pad)).reshape(self.batch, self.seq_len)


def write_token_shards(root: str, tokens: np.ndarray, shard_tokens: int,
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


class GpuTrainFeed:
    """ShardSource → AsyncDevicePrefetcher: the cache → device → step
    pipeline on one device. One StepProfiler threads it: cache_fetch and
    decode from the source, host_to_hbm, compute_wait and input_wait
    from the prefetcher; ``feed.profiler.summary()`` answers "where did
    the step go"."""

    def __init__(self, root: str, batch: int, seq_len: int, depth: int = 2,
                 dtype=np.int32, profiler=None,
                 shuffle_seed: int | None = None, device=None):
        self.profiler = profiler if profiler is not None else StepProfiler()
        self.source = ShardSource(root, batch, seq_len, dtype,
                                  shuffle_seed=shuffle_seed,
                                  profiler=self.profiler)
        self.prefetcher = AsyncDevicePrefetcher(
            self.source.batches(), depth=depth, device=device,
            profiler=self.profiler)

    def __aiter__(self):
        return self.prefetcher
