"""Block replicas moved between the ranks of a mesh.

Port of ``curvine_tpu/tpu/ici_transfer.py``, over ``gpu/mesh.py``'s
``DeviceMesh`` (NCCL between CUDA devices, gloo between CPU processes): a
block is a 1-d uint8 tensor; scattered, it is a DTensor split over one
mesh axis (``Shard(0)``), each rank holding 1/N of the bytes; gathered,
it is replicated. Where the reference's XLA routes ``device_put`` and
resharding over ICI, these are DTensor redistributions and, for
``ring_shift``, point-to-point sends; ``verify_scattered``'s per-shard
sums are a torch reduction on each rank, as the reference's are a jitted
XLA sum (no Pallas). Every rank of the mesh calls each function."""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from curvine_tpu_torch.gpu.ici_plane import to_device
from curvine_tpu_torch.gpu.mesh import (P, mesh_device, placements,
                                        send_recv)

__all__ = ["replicate_to_devices", "scatter_block", "gather_block",
           "broadcast_block", "ring_shift", "reshard_stripes",
           "verify_scattered"]


def replicate_to_devices(arr: torch.Tensor, devices: list
                         ) -> list[torch.Tensor]:
    """A device block on each of ``devices``: ``arr`` itself on its own
    device, a device-to-device copy on the others (never through the
    host)."""
    return [to_device(arr, d) for d in devices]


def _axis(mesh, axis: str | None) -> str:
    return axis or mesh.mesh_dim_names[0]


def scatter_block(arr, mesh, axis: str | None = None) -> DTensor:
    """A host block spread over ``axis``: zero-padded to a multiple of
    the axis's size, each rank along it holding 1/N of the bytes. Rank
    0's bytes are the ones scattered (the host reads the block once)."""
    axis = _axis(mesh, axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    pad = (-t.numel()) % n
    if pad:
        t = torch.cat([t.reshape(-1), t.new_zeros(pad)])
    return distribute_tensor(t.to(mesh_device(mesh)), mesh,
                             placements(mesh, P(axis)), src_data_rank=0)


def gather_block(sharded: DTensor, mesh) -> DTensor:
    """A scattered block replicated again: an all-gather."""
    return sharded.redistribute(mesh, [Replicate()] * mesh.ndim)


def broadcast_block(host_block, mesh) -> DTensor:
    """Host bytes onto every rank: a scatter (each rank receives 1/N over
    the host link), then an all-gather between the devices."""
    return gather_block(scatter_block(host_block, mesh), mesh)


def _split_over(sharded: DTensor, mesh) -> str | None:
    """The mesh axis the block's dim 0 is split over, or None."""
    for name, p in zip(mesh.mesh_dim_names, sharded.placements):
        if p == Shard(0):
            return name
    return None


def ring_shift(sharded: DTensor, mesh, axis: str | None = None,
               steps: int = 1) -> DTensor:
    """Each rank's shard sent ``steps`` ranks ahead along ``axis`` (a
    ring) and the one ``steps`` behind received: shard k of the result is
    shard (k - steps) mod N of the input. A shift by a multiple of N (on
    a one-rank axis, every shift) is a local copy: no send to self."""
    axis = _axis(mesh, axis)
    want = placements(mesh, P(axis))
    if list(sharded.placements) != want:
        sharded = sharded.redistribute(mesh, want)
    out = send_recv(sharded.to_local(), mesh.get_group(axis), steps)
    return DTensor.from_local(out, mesh, want, run_check=False)


def reshard_stripes(sharded: DTensor, mesh, from_axis: str,
                    to_axis: str) -> DTensor:
    """A block's striping moved from ``from_axis`` to ``to_axis`` between
    the devices. ``from_axis`` is checked against the input's own
    layout: a block not striped over it raises ``ValueError``."""
    got = _split_over(sharded, mesh)
    if got != from_axis:
        raise ValueError(f"input striped over {got!r}, not "
                         f"from_axis={from_axis!r}")
    return sharded.redistribute(mesh, placements(mesh, P(to_axis)))


def verify_scattered(sharded: DTensor, mesh,
                     axis: str | None = None) -> np.ndarray:
    """Each shard's byte sum mod 2^32, computed on the rank that holds
    it, gathered as [N] uint32 (one per shard along ``axis``): the
    integrity probe of a scattered replica, to hold against the host's
    ``bytes.astype(np.uint32).sum(dtype=np.uint32)`` of each shard."""
    axis = _axis(mesh, axis)
    want = placements(mesh, P(axis))
    if list(sharded.placements) != want:
        sharded = sharded.redistribute(mesh, want)
    s = sharded.to_local().to(torch.int64).sum().remainder(1 << 32)
    sums = DTensor.from_local(s.reshape(1), mesh, want, run_check=False)
    return sums.full_tensor().cpu().numpy().astype(np.uint32)
