"""The peer-device plane: a worker's device tier-0, addressable by peers.

Port of ``curvine_tpu/tpu/ici_plane.py``. Three pieces:

- **Endpoint registry and the device-path pull.** A participant of the
  device domain (a worker, or a loader embedded in the same process)
  registers an ``IciEndpoint``: its worker id, an object whose
  ``get(block_id)`` returns a pinned block as a device tensor, and its
  position in the ICI mesh. ``fetch_device_block`` returns a peer's
  pinned tensor, or a copy of it on another device (a device-to-device
  copy; between two CUDA devices CUDA routes it over NVLink or PCIe).
  Anything outside the domain misses the registry, and the caller falls
  back to its TCP pull: a miss is ``None``, never an error.
- **The broadcast schedule.** ``broadcast_schedule`` plans a binomial
  tree over the participants, in order of torus hops from the root
  (``master/placement.py::ici_hops``).
- **The broadcast rail.** ``broadcast_bytes`` puts a byte payload on
  every rank of a mesh as a pipeline of bounded chunks, each a
  replicated DTensor whose bytes come from rank 0 (a broadcast over the
  group); ``flat_replicate`` is the one-transfer baseline. On a world of
  one process, each chunk is a host-to-device copy.

The registry is process-wide, under a lock: a worker and a peer that
share this process share it."""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from curvine_tpu_torch.master.placement import ici_hops

__all__ = ["DEFAULT_CHUNK_BYTES", "IciEndpoint", "register_endpoint",
           "unregister_endpoint", "lookup_endpoint", "endpoints",
           "to_device", "fetch_device_block", "BroadcastSchedule",
           "broadcast_schedule", "ReplicatedBytes", "broadcast_bytes",
           "flat_replicate"]

log = logging.getLogger(__name__)

# the broadcast rail's chunk: large enough to amortise a launch, small
# enough to stay in the allocator's cached blocks
DEFAULT_CHUNK_BYTES = 8 << 20


# ------------------------------------------------------------------ registry

@dataclass
class IciEndpoint:
    """One participant of the device domain: its worker id, its tier
    (anything with ``get(block_id) -> tensor | None``) and its position
    in the ICI mesh."""

    worker_id: int
    hbm: object
    coords: tuple[int, ...] = ()


_lock = threading.Lock()
_endpoints: dict[int, IciEndpoint] = {}


def register_endpoint(worker_id: int, hbm, coords=()) -> IciEndpoint:
    """Join the device domain. A re-register replaces the old entry: a
    restarted worker's stale tier must not serve."""
    ep = IciEndpoint(worker_id=int(worker_id), hbm=hbm,
                     coords=tuple(coords or ()))
    with _lock:
        _endpoints[ep.worker_id] = ep
    return ep


def unregister_endpoint(worker_id: int) -> None:
    with _lock:
        _endpoints.pop(int(worker_id), None)


def lookup_endpoint(worker_id: int) -> IciEndpoint | None:
    with _lock:
        return _endpoints.get(int(worker_id))


def endpoints() -> list[IciEndpoint]:
    with _lock:
        return list(_endpoints.values())


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` itself where ``device`` is its device, else a copy on
    ``device``, made on the calling thread's current stream. A CPU
    tensor's device carries no index, so ``cpu:1`` asked of it gives a
    copy too."""
    device = torch.device(device)
    if device == t.device:
        return t
    out = torch.empty_like(t, device=device)
    out.copy_(t)
    return out


def fetch_device_block(src_worker_id: int, block_id: int,
                       device=None) -> torch.Tensor | None:
    """A peer's pinned block over the device path: the tensor its tier
    holds, or a copy on ``device`` when that differs. ``None`` when the
    peer is outside this device domain, no longer holds the block, or its
    tier fails: the caller falls back to the TCP pull. Never raises for
    "not reachable this way"."""
    ep = lookup_endpoint(src_worker_id)
    if ep is None or ep.hbm is None:
        return None
    try:
        arr = ep.hbm.get(block_id)
    except Exception as e:      # noqa: BLE001 — a dying tier is a miss
        log.debug("ici fetch of block %d from worker %d failed: %s",
                  block_id, src_worker_id, e)
        return None
    if arr is None:
        return None
    return arr if device is None else to_device(arr, device)


# ------------------------------------------------------------------ schedule

@dataclass
class BroadcastSchedule:
    """One broadcast's plan: the participant that reads from the cache
    (``root``) and the fan-out rounds after it. ``rounds`` lists
    (src, dst) edges over participant indices; a round only uses sources
    that hold the data already (the root, or an earlier round's
    destinations)."""

    root: int
    order: list[int]
    rounds: list[list[tuple[int, int]]]
    chunk_bytes: int = DEFAULT_CHUNK_BYTES

    def receivers(self) -> set[int]:
        out = {self.root}
        for r in self.rounds:
            for _, dst in r:
                out.add(dst)
        return out

    def depth(self) -> int:
        return len(self.rounds)


def broadcast_schedule(n: int, coords: list[tuple[int, ...]] | None = None,
                       mesh_shape: tuple[int, ...] | None = None,
                       root: int = 0,
                       chunk_bytes: int = DEFAULT_CHUNK_BYTES
                       ) -> BroadcastSchedule:
    """A binomial tree over ``n`` participants, log2 deep. With
    ``coords`` the order walks outward from the root by torus hops (ties
    by index), so each doubling round reaches the nearest participants
    not yet covered; without, the order is the index order."""
    if n <= 0:
        raise ValueError("broadcast needs at least one participant")
    idxs = [i for i in range(n) if i != root]
    if coords:
        shape = list(mesh_shape) if mesh_shape else None
        idxs.sort(key=lambda i: (ici_hops(list(coords[root]),
                                          list(coords[i]), shape), i))
    order = [root] + idxs
    rounds: list[list[tuple[int, int]]] = []
    have = 1                      # the prefix of ``order`` holding the data
    while have < n:
        edges = [(order[k], order[have + k])
                 for k in range(min(have, n - have))]
        rounds.append(edges)
        have += len(edges)
    return BroadcastSchedule(root=root, order=order, rounds=rounds,
                             chunk_bytes=chunk_bytes)


# ------------------------------------------------------------------ rail

@dataclass
class ReplicatedBytes:
    """A byte payload on every rank of a mesh, as the rail's chunks:
    uint8 DTensors replicated over the mesh. ``np()`` gives the host
    bytes, equal to the source's."""

    length: int
    chunks: list = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        return self.length

    def np(self) -> np.ndarray:
        if not self.chunks:
            return np.empty(0, dtype=np.uint8)
        return np.concatenate([c.to_local().cpu().numpy()
                               for c in self.chunks])[:self.length]


def _host_bytes(data) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data)
    return arr.reshape(-1).view(np.uint8)


def _replicate(piece: np.ndarray, mesh):
    """``piece`` as a DTensor replicated over ``mesh``, its bytes rank
    0's."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from curvine_tpu_torch.gpu.mesh import mesh_device
    host = np.ascontiguousarray(piece)
    if not host.flags.writeable:        # torch takes writable memory only
        host = host.copy()
    t = torch.from_numpy(host).to(mesh_device(mesh))
    return distribute_tensor(t, mesh, [Replicate()] * mesh.ndim,
                             src_data_rank=0)


def _sync(mesh) -> None:
    if mesh.device_type == "cuda":
        torch.cuda.synchronize()


def broadcast_bytes(data, mesh, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                    counters: dict | None = None) -> ReplicatedBytes:
    """Host bytes onto every rank of ``mesh`` as chunks of
    ``chunk_bytes``, each replicated from rank 0; every rank calls it.
    Bit-exact: ``result.np() == bytes(data)``. ``counters`` gains
    ``ici.broadcast_bytes`` and ``ici.broadcast_ms``."""
    arr = _host_bytes(data)
    t0 = time.perf_counter()
    chunk_bytes = max(1, int(chunk_bytes))
    out = ReplicatedBytes(length=arr.nbytes)
    for off in range(0, max(arr.nbytes, 1), chunk_bytes):
        piece = arr[off:off + chunk_bytes]
        if piece.nbytes == 0 and off:
            break
        out.chunks.append(_replicate(piece, mesh))
    _sync(mesh)
    if counters is not None:
        counters["ici.broadcast_bytes"] = \
            counters.get("ici.broadcast_bytes", 0) + arr.nbytes
        counters["ici.broadcast_ms"] = counters.get("ici.broadcast_ms", 0) \
            + int((time.perf_counter() - t0) * 1000)
    return out


def flat_replicate(data, mesh):
    """The baseline: the whole payload in one replicated transfer, a
    uint8 DTensor."""
    out = _replicate(_host_bytes(data), mesh)
    _sync(mesh)
    return out
