"""Multi-process glue: the process group every mesh spans.

Port of ``curvine_tpu/tpu/multihost.py``. Where JAX's distributed runtime
connects one process a host, ``torch.distributed`` connects one process
a device: ``initialize`` makes the default process group (NCCL between
CUDA devices, gloo between CPU processes, where the caller asks for the
CPU), ``pod_mesh`` the mesh over all of its ranks. Each rank feeds from
its local worker and passes its local part of a batch
(``gpu/ingest.py::put_sharded``). Nothing here tells a rank of a
cluster: the caller gives the rendezvous, the world size and the rank,
or nothing, for a world of this process alone (the counterpart of
JAX's implicit single-process runtime)."""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from curvine_tpu_torch.device import default_device
from curvine_tpu_torch.gpu.mesh import make_mesh

__all__ = ["initialize", "shutdown", "pod_mesh", "local_ici_coords",
           "worker_conf_for_pod"]

TIMEOUT_S = 300         # a rendezvous or collective that waits longer fails


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, cpu: bool = False) -> None:
    """Make the default process group of this rank.

    ``coordinator`` (else ``CURVINE_COORDINATOR``) is ``host:port``, a
    TCP rendezvous, or an ``init_method`` URL such as ``file:///path``
    (a file store, which needs no port); ``num_processes`` and
    ``process_id`` are the world size and this rank. With none of them,
    the world is this process alone (an in-process store). The group is
    NCCL on this rank's CUDA device (``rank % device_count``, made
    current), or gloo when ``cpu=True``; without CUDA and without
    ``cpu=True`` it raises, and a CUDA run whose NCCL group cannot be
    made raises too: it never carries on with gloo or on the CPU."""
    if dist.is_initialized():
        raise RuntimeError("the process group is initialized already; "
                           "call shutdown() first")
    coordinator = coordinator or os.environ.get("CURVINE_COORDINATOR")
    if coordinator is None and num_processes is None:
        world, rank = 1, 0
    elif coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process group needs coordinator, "
                         "num_processes and process_id")
    else:
        world, rank = int(num_processes), int(process_id)
    kw = {"world_size": world, "rank": rank,
          "timeout": datetime.timedelta(seconds=TIMEOUT_S)}
    if coordinator is None:
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = coordinator if "://" in coordinator \
            else f"tcp://{coordinator}"
    if cpu:
        dist.init_process_group("gloo", **kw)
        return
    default_device()                    # raises without CUDA
    if not dist.is_nccl_available():
        raise RuntimeError("this torch build has no NCCL: a CUDA process "
                           "group cannot be made")
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", device_id=device, **kw)
    if dist.get_backend() != "nccl":
        backend = dist.get_backend()
        dist.destroy_process_group()
        raise RuntimeError(f"asked for NCCL, got {backend}")


def shutdown() -> None:
    """Destroy the default process group (``jax.distributed.shutdown``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def pod_mesh(axis_names=("data", "model"), shape=None):
    """Mesh over every rank of the process group."""
    return make_mesh(axis_names=axis_names, shape=shape)


def local_ici_coords() -> list[int]:
    """Torus coordinates of this host's first chip, what the co-located
    worker advertises as ``WorkerInfo.ici_coords``: none on a GPU, as on
    a JAX CPU device, which has no ``coords``."""
    return []


def worker_conf_for_pod(conf) -> None:
    """Stamp pod-derived placement info onto a WorkerConf in place."""
    conf.worker.ici_coords = local_ici_coords()
