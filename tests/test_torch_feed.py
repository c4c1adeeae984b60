"""Port parity: the prefetchers and shard feed of ``curvine_tpu_torch``
(on the CPU) against the JAX package's ``tpu/ingest.py`` and
``tpu/loader.py`` on the same batches; mirrors
``test_device_prefetcher_sync``, ``test_async_prefetcher_background_producer``
and ``test_cache_feed_to_device``."""

import asyncio

import numpy as np
import pytest

import jax

import torch

from curvine_tpu.obs.profiler import StepProfiler as JaxProfiler
from curvine_tpu.testing import MiniCluster
from curvine_tpu.tpu import ingest as jax_ingest
from curvine_tpu.tpu import loader as jax_loader
from curvine_tpu_torch.gpu import ingest, loader
from curvine_tpu_torch.obs.profiler import STAGES, StepProfiler

CPU = torch.device("cpu")
CPUS = jax.devices("cpu")


def _batches(n=7, shape=(3, 5)):
    rng = np.random.default_rng(0)
    return [rng.integers(-1000, 1000, shape, dtype=np.int32)
            for _ in range(n)]


def _stage_counts(prof) -> dict:
    return {k: v["count"] for k, v in prof.snapshot()["stages"].items()}


def test_device_prefetcher_parity():
    batches = _batches()
    p_ref, p_port = JaxProfiler(), StepProfiler()
    ref = list(jax_ingest.DevicePrefetcher(iter(batches), mesh=None,
                                           depth=3, device=CPUS[0],
                                           profiler=p_ref))
    got = list(ingest.DevicePrefetcher(iter(batches), depth=3, device=CPU,
                                       profiler=p_port))
    assert len(got) == len(ref) == len(batches)
    for g, r, b in zip(got, ref, batches):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(r))
        assert np.array_equal(g.numpy(), b)
    assert _stage_counts(p_port) == _stage_counts(p_ref) == {
        "host_to_hbm": len(batches)}
    assert STAGES == ("cache_fetch", "decode", "host_to_hbm", "compute_wait",
                      "input_wait")


async def _drain(pf):
    out = []
    async for b in pf:
        out.append(np.asarray(b) if not isinstance(b, torch.Tensor)
                   else b.numpy())
    return out


async def test_async_prefetcher_parity_and_stage_names():
    batches = _batches(9)

    async def source():
        for b in batches:
            await asyncio.sleep(0)
            yield b

    p_ref, p_port = JaxProfiler(), StepProfiler()
    ref = await _drain(jax_ingest.AsyncDevicePrefetcher(
        source(), mesh=None, depth=2, device=CPUS[0], profiler=p_ref))
    got = await _drain(ingest.AsyncDevicePrefetcher(
        source(), depth=2, device=CPU, profiler=p_port))
    assert len(got) == len(ref) == len(batches)
    assert all(np.array_equal(g, r) for g, r in zip(got, ref))
    assert _stage_counts(p_port) == _stage_counts(p_ref)
    assert set(_stage_counts(p_port)) == {"host_to_hbm", "compute_wait",
                                          "input_wait"}
    assert p_port.steps == p_ref.steps == len(batches)


async def test_async_prefetcher_producer_window_and_sticky_error():
    """The producer fills the window while the consumer computes; a
    source error surfaces at the consumer and stays; aclose is clean —
    the same on both packages."""
    for make in (lambda s: jax_ingest.AsyncDevicePrefetcher(
                     s, mesh=None, depth=2),
                 lambda s: ingest.AsyncDevicePrefetcher(s, depth=2,
                                                        device=CPU)):
        fetched = []

        async def source():
            for i in range(5):
                fetched.append(i)
                yield np.full((2, 2), i, dtype=np.int32)

        pf = make(source())
        first = await pf.__anext__()
        assert int(np.asarray(first)[0, 0]) == 0
        await asyncio.sleep(0.05)
        assert len(fetched) >= 3       # 1 consumed + depth in flight
        rest = await _drain(pf)
        assert [int(b[0, 0]) for b in rest] == [1, 2, 3, 4]
        with pytest.raises(StopAsyncIteration):
            await pf.__anext__()

        async def bad():
            yield np.zeros((1,), np.int32)
            raise RuntimeError("shard gone")

        pf2 = make(bad())
        await pf2.__anext__()
        for _ in range(2):             # sticky, not a clean exhaustion
            with pytest.raises(RuntimeError, match="shard gone"):
                await pf2.__anext__()

        async def slow():
            yield np.zeros((1,), np.int32)
            await asyncio.sleep(60)
            yield np.zeros((1,), np.int32)

        pf3 = make(slow())
        await pf3.__anext__()
        await asyncio.wait_for(pf3.aclose(), 5)


@pytest.mark.parametrize("seed,drop", [(None, True), (3, True), (3, False)])
async def test_shard_source_matches_cache_shard_source(tmp_path, seed, drop):
    tokens = np.arange(4096, dtype=np.int32) * 7 - 5
    async with MiniCluster(workers=1) as mc:
        c = mc.client()
        shards = await jax_loader.write_token_shards(c, "/ds/train", tokens,
                                                     shard_tokens=1000)
        src = jax_loader.CacheShardSource(c, "/ds/train", batch=4,
                                          seq_len=128, shuffle_seed=seed,
                                          drop_remainder=drop)
        ref = [b.copy() async for b in src.batches()]
    local = loader.write_posix_shards(str(tmp_path), tokens, 1000)
    assert [p.rsplit("/", 1)[1] for p in local] == \
        [p.rsplit("/", 1)[1] for p in shards]
    port = loader.ShardSource(str(tmp_path), batch=4, seq_len=128,
                              shuffle_seed=seed, drop_remainder=drop)
    got = [b.copy() async for b in port.batches()]
    assert len(got) == len(ref) > 0
    assert all(np.array_equal(g, r) for g, r in zip(got, ref))
    assert port.epoch == src.epoch == 1


async def test_gpu_train_feed_equals_host_batches(tmp_path):
    tokens = np.random.default_rng(2).integers(0, 50257, 5000,
                                               dtype=np.int32)
    loader.write_posix_shards(str(tmp_path), tokens, 1000)
    host = [b.copy() async for b in loader.ShardSource(
        str(tmp_path), batch=4, seq_len=128).batches()]
    assert sum(b.size for b in host) == 5000 - 5000 % 512
    feed = loader.PosixTrainFeed(str(tmp_path), batch=4, seq_len=128,
                               depth=2, device=CPU)
    dev = [b async for b in feed]
    assert len(dev) == len(host)
    assert all(isinstance(d, torch.Tensor) and d.shape == (4, 128)
               for d in dev)
    assert all(np.array_equal(d.numpy(), h) for d, h in zip(dev, host))
    fr = feed.profiler.summary()["fractions"]
    assert {"cache_fetch", "decode", "host_to_hbm", "compute_wait",
            "input_wait"} <= set(fr)
