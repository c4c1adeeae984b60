"""Host→device ingest: prefetchers that keep batches in flight on the card.

Port of ``curvine_tpu/tpu/ingest.py`` (``put_sharded``,
``DevicePrefetcher``, ``AsyncDevicePrefetcher``). Where the JAX package
calls ``jax.device_put`` and lets the runtime overlap the copy, the port
does it by hand:

* each host batch is copied into the next buffer of a ring of pinned
  staging buffers (``PinnedStager``, which the device tier-0 uses too),
  once that buffer's last copy has finished (an event per buffer gates
  its reuse); the source, often a read-only mmap view, is never wrapped
  as a tensor;
* the host→device copy runs on a side stream with ``non_blocking=True``,
  so it overlaps the consumer's compute on the current stream;
* a delivered tensor makes the consumer's stream wait for its copy's
  event, and is ``record_stream``-ed to that stream so the caching
  allocator does not hand its memory out while the consumer still uses it.

At most ``depth + 1`` batches are resident on the device, as in the JAX
prefetchers. On a CPU device the batch is copied into a fresh tensor.

With a ``mesh`` (``gpu/mesh.py``), a delivered batch is a DTensor laid
out by ``spec``: each rank copies the part it holds, which at world size
1 is the whole batch, and the parts form the global tensor
(``DTensor.from_local``, the counterpart of
``jax.make_array_from_process_local_data``)."""

from __future__ import annotations

import asyncio
import collections
import time
from typing import AsyncIterator, Iterator

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from curvine_tpu_torch.device import default_device
from curvine_tpu_torch.gpu.mesh import P, mesh_device, placements

__all__ = ["PinnedStager", "DeviceCopier", "DevicePrefetcher",
           "AsyncDevicePrefetcher", "put_sharded"]

STAGE_CHUNK = 16 << 20      # bytes per pinned staging buffer
STAGE_SLOTS = 4             # buffers in the ring


class PinnedStager:
    """Host→device copies through a ring of pinned staging buffers.

    ``copy_in(dst, src)`` copies host bytes ``src`` (any uint8 array,
    read-only mmap views included) into the CUDA tensor ``dst`` on the
    current stream, chunk by chunk: each chunk is copied into the next
    pinned buffer once that buffer's previous DMA has finished (its
    event), then DMA'd with ``non_blocking=True``. Returns without
    waiting for the last DMA; work queued later on the same stream sees
    the bytes. Buffers are allocated at first use."""

    def __init__(self, device: torch.device):
        self.device = device
        self.chunk = STAGE_CHUNK
        self.slots = STAGE_SLOTS
        self._bufs: list[torch.Tensor] = []
        self._events: list[torch.cuda.Event] = []
        self._next = 0

    def _slot(self) -> tuple[torch.Tensor, torch.cuda.Event]:
        if not self._bufs:
            self._bufs = [torch.empty(self.chunk, dtype=torch.uint8,
                                      pin_memory=True)
                          for _ in range(self.slots)]
            self._events = [torch.cuda.Event() for _ in range(self.slots)]
        k = self._next
        self._next = (k + 1) % self.slots
        self._events[k].synchronize()       # its last DMA has finished
        return self._bufs[k], self._events[k]

    def copy_in(self, dst: torch.Tensor, src: np.ndarray) -> None:
        stream = torch.cuda.current_stream(self.device)
        n = src.size
        for off in range(0, n, self.chunk):
            k = min(self.chunk, n - off)
            buf, ev = self._slot()
            np.copyto(buf.numpy()[:k], src[off:off + k])
            dst[off:off + k].copy_(buf[:k], non_blocking=True)
            ev.record(stream)


class DeviceCopier:
    """Host batch → device tensor through the pinned staging ring on a
    side stream (see the module docstring). ``transfer`` enqueues the
    copy and returns ``(tensor, event)``; ``deliver`` hands the tensor to
    the current stream, as a DTensor on ``mesh`` laid out by ``spec``
    (default ``P(first axis)``) where a mesh is given: the batch is then
    this rank's part, and the device the mesh's."""

    def __init__(self, device=None, mesh=None, spec=None):
        if mesh is not None:
            if device is not None and torch.device(device) != \
                    mesh_device(mesh):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh_device(mesh)}")
            device = mesh_device(mesh)
            spec = spec if spec is not None else P(mesh.mesh_dim_names[0])
            self.placements = placements(mesh, spec)
        self.mesh = mesh
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.stager = PinnedStager(self.device) if self.cuda else None

    def transfer(self, batch: np.ndarray):
        batch = np.ascontiguousarray(batch)
        if not self.cuda:
            return torch.from_numpy(batch.copy()), None
        dtype = torch.from_numpy(np.empty(0, batch.dtype)).dtype
        with torch.cuda.stream(self.stream):
            out = torch.empty(batch.shape, dtype=dtype, device=self.device)
            self.stager.copy_in(out.view(-1).view(torch.uint8),
                                batch.reshape(-1).view(np.uint8))
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return out, ev

    def deliver(self, item) -> torch.Tensor:
        out, ev = item
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            out.record_stream(cur)
        if self.mesh is not None:
            return DTensor.from_local(out, self.mesh, self.placements,
                                      run_check=False)
        return out

    def timed_transfer(self, batch: np.ndarray, profiler):
        """``transfer``, timed as the ``host_to_hbm`` stage."""
        t0 = time.perf_counter()
        item = self.transfer(batch)
        if profiler is not None:
            profiler.record("host_to_hbm", time.perf_counter() - t0,
                            batch.nbytes)
        return item


def put_sharded(batch: np.ndarray, mesh, spec: P | None = None):
    """Place a host batch as a global DTensor sharded over the mesh
    (``spec`` default ``P(first axis)``): each rank passes its local
    part, the whole batch at world size 1. Copied through the pinned
    ring, on the current stream's terms."""
    copier = DeviceCopier(mesh=mesh, spec=spec)
    return copier.deliver(copier.transfer(batch))


class DevicePrefetcher:
    """Wraps a host-batch iterator; keeps ``depth`` batches in flight on
    the device so the consumer never waits on the host→device copy. With
    a ``mesh``, each batch is this rank's part of a DTensor laid out by
    ``spec`` (``put_sharded``)."""

    def __init__(self, host_batches: Iterator[np.ndarray], depth: int = 2,
                 device=None, profiler=None, mesh=None,
                 spec: P | None = None):
        self.src = iter(host_batches)
        self.depth = max(1, depth)
        self.copier = DeviceCopier(device, mesh, spec)
        self.device = self.copier.device
        # optional StepProfiler (obs/profiler.py): host→device dispatch time
        self.profiler = profiler
        self._queue: collections.deque = collections.deque()

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        while len(self._queue) < self.depth:
            try:
                self._queue.append(self.copier.timed_transfer(
                    next(self.src), self.profiler))
            except StopIteration:
                break
        if not self._queue:
            raise StopIteration
        return self.copier.deliver(self._queue.popleft())


class AsyncDevicePrefetcher:
    """Async variant for cache-backed sources.

    A background PRODUCER task keeps ``depth`` batches in flight: the host
    fetch and host→device copy of batch k+1 overlap the consumer's
    compute on batch k. Errors from the source surface at the consumer
    and stay sticky. ``mesh`` and ``spec`` as in ``DevicePrefetcher``."""

    def __init__(self, host_batches: AsyncIterator[np.ndarray],
                 depth: int = 2, device=None, profiler=None, mesh=None,
                 spec: P | None = None):
        self.src = host_batches
        self.depth = max(1, depth)
        self.copier = DeviceCopier(device, mesh, spec)
        self.device = self.copier.device
        # optional StepProfiler (obs/profiler.py): attributes each step
        # to host→device transfer, compute_wait (producer blocked on a
        # full queue — the MODEL is the bottleneck) and input_wait
        # (consumer blocked on an empty queue — the DATA PIPELINE is)
        self.profiler = profiler
        # maxsize bounds device memory: at most depth+1 batches resident
        # (depth queued, plus the one the blocked producer transferred
        # before put()) — size depth with that +1 in the memory budget
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=self.depth)
        self._producer: asyncio.Task | None = None
        self._error: BaseException | None = None
        self._finished = False

    async def _produce(self) -> None:
        try:
            async for batch in self.src:
                item = self.copier.timed_transfer(batch, self.profiler)
                t0 = time.perf_counter()
                await self._queue.put(item)
                if self.profiler is not None:
                    # blocked put = the device queue is full = the step
                    # function is the pipeline's long pole
                    self.profiler.record("compute_wait",
                                         time.perf_counter() - t0)
        except asyncio.CancelledError:
            # aclose() initiated this — nobody waits for a notification,
            # and putting into a possibly-FULL queue would deadlock
            raise
        except Exception as e:
            await self._queue.put(e)     # surface at the consumer
            return
        await self._queue.put(_DONE)

    def __aiter__(self):
        return self

    async def __anext__(self) -> torch.Tensor:
        if self._error is not None:
            # sticky: restarting the producer on the dead generator would
            # report a clean StopAsyncIteration and mask the failure
            raise self._error
        if self._finished:
            raise StopAsyncIteration
        if self._producer is None:
            self._producer = asyncio.ensure_future(self._produce())
        if self.profiler is not None:
            t0 = time.perf_counter()
            item = await self._queue.get()
            # blocked get = the queue ran dry = the data pipeline is the
            # pipeline's long pole
            self.profiler.record("input_wait", time.perf_counter() - t0)
        else:
            item = await self._queue.get()
        if item is _DONE:
            self._finished = True
            raise StopAsyncIteration
        if isinstance(item, BaseException):
            self._error = item
            raise item
        if self.profiler is not None:
            self.profiler.step_done()
        return self.copier.deliver(item)

    async def aclose(self) -> None:
        if self._producer is not None:
            self._producer.cancel()
            try:
                await self._producer
            except (Exception, asyncio.CancelledError):
                pass
            self._producer = None


_DONE = object()
