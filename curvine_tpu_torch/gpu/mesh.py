"""Device mesh and ICI topology helpers.

Port of ``curvine_tpu/tpu/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group that ``gpu/multihost.py::initialize`` made, one device a
rank; tensors on it are DTensors. The axes are the reference's:

  data  — batch (DP): gradients all-reduced over this axis
  model — hidden/heads (TP): matmul-sharded, activations all-gathered
  seq   — sequence (SP): ring attention (``gpu/attention.py``)
  ep    — experts of the MoE FFN
  pp    — pipeline stages (``gpu/pipeline.py``)

A partition spec is written as in JAX, ``P(None, "model")``: for each
tensor dim, the mesh axis it is split over, or None. ``placements``
turns it into DTensor placements, one per mesh axis: ``Shard(dim)`` on
the axis a dim names, ``Replicate()`` on the others. ``shard_map`` (the
counterpart of ``shard_map_compat``) runs a function on each rank's
local shards, through ``local_map``; inside it, ``ppermute`` (the
counterpart of ``jax.lax.ppermute`` with the ring permutation
``(i, (i + 1) % n)``) shifts a local tensor along a mesh axis, with its
gradient shifted back."""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = ["P", "placements", "tree_map", "shard_map", "ppermute",
           "send_recv", "factor_mesh", "make_mesh", "mesh_device",
           "replicated", "batch_sharding", "IciTopology"]


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart:
    per tensor dim, the name of the mesh axis it is split over, or None.
    Trailing dims it does not name are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


def placements(mesh: DeviceMesh, spec: P) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh axis.
    An axis the mesh lacks, or one named twice, raises ``ValueError``, as
    a ``NamedSharding`` does."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if not isinstance(axis, str) or axis not in names:
            raise ValueError(f"spec {spec!r}: {axis!r} is not an axis of "
                             f"the mesh {names}")
        i = names.index(axis)
        if out[i] != Replicate():
            raise ValueError(f"spec {spec!r} names {axis!r} twice")
        out[i] = Shard(dim)
    return out


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over dicts, lists and tuples, a spec ``P`` being
    a leaf: the structure is ``tree``'s, and each of ``rest`` is read at
    the same positions."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def shard_map(fn, mesh: DeviceMesh, in_specs, out_specs):
    """``fn`` over each rank's local shards: its DTensor arguments, laid
    out as ``in_specs`` say (a layout that differs raises; nothing is
    moved), are passed as local tensors, and its result, laid out as
    ``out_specs`` says, comes back as a DTensor. Gradients flow through,
    with the same layouts."""
    return local_map(fn, out_placements=placements(mesh, out_specs),
                     in_placements=tuple(placements(mesh, s)
                                         for s in in_specs),
                     device_mesh=mesh)


def send_recv(local: torch.Tensor, group, steps: int) -> torch.Tensor:
    """``local`` sent ``steps`` ranks ahead on ``group`` (a ring) and the
    tensor of the rank ``steps`` behind received, as a new tensor. A
    shift by a multiple of the group's size (every shift on a one-rank
    group) is a local copy: no send to self. Every rank of the group
    calls it."""
    n = dist.get_world_size(group)
    if steps % n == 0:
        return local.clone()
    k = dist.get_rank(group)
    local = local.contiguous()
    out = torch.empty_like(local)
    ops = [dist.P2POp(dist.isend, local,
                      dist.get_global_rank(group, (k + steps) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (k - steps) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """``send_recv`` with a gradient: the backward shifts the incoming
    gradient the other way (the transpose of a permutation)."""

    @staticmethod
    def forward(ctx, x, group, steps):
        ctx.group, ctx.steps = group, steps
        return send_recv(x, group, steps)

    @staticmethod
    def backward(ctx, grad):
        return send_recv(grad, ctx.group, -ctx.steps), None, None


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             steps: int = 1) -> torch.Tensor:
    """This rank's local tensor ``x`` (inside ``shard_map``) sent
    ``steps`` ranks ahead along ``axis`` and the one ``steps`` behind
    received: ``jax.lax.ppermute(x, axis, [(i, (i + steps) % n)])``.
    Differentiable: the gradient goes back ``steps`` ranks behind. Every
    rank of the axis calls it at the same point of its program, forward
    and backward; the autograd engine runs the backward's shifts in one
    order on every rank when the ranks' graphs have one structure, so a
    caller builds the same graph on every rank and selects values with
    masks, not with branches on its rank (``gpu/pipeline.py``)."""
    return _Shift.apply(x, mesh.get_group(axis), steps)


def factor_mesh(n: int, axes: int = 2) -> tuple[int, ...]:
    """Balanced near-square factorization of n devices into `axes` dims,
    larger factor first (data axis gets the larger share)."""
    if axes == 1:
        return (n,)
    best = (n, 1)
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            best = (n // d, d)
    if axes == 2:
        return best
    rest = factor_mesh(best[1], axes - 1)
    return (best[0], *rest)


def make_mesh(devices=None, axis_names: tuple[str, ...] = ("data", "model"),
              shape: tuple[int, ...] | None = None) -> DeviceMesh:
    """A mesh over ``devices``, the global ranks it spans (every rank of
    the process group when None), in row-major order over ``shape``
    (``factor_mesh`` of their count when None). Its device type is the
    group's: ``cuda`` over NCCL, ``cpu`` over gloo. Every rank of the
    group calls it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "curvine_tpu_torch.gpu.multihost.initialize() "
                           "first")
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    n = len(ranks)
    if shape is None:
        shape = factor_mesh(n, len(axis_names))
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicated(mesh: DeviceMesh) -> list:
    return placements(mesh, P())


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> list:
    """Shard the leading (batch) dim over `axis`."""
    return placements(mesh, P(axis))


class IciTopology:
    """Model of a TPU pod's ICI torus used for placement decisions.

    Hosts own contiguous sub-blocks of chips; workers co-located with a
    host inherit its coordinates (WorkerInfo.ici_coords). The master's
    ``ici`` placement policy uses ``hops`` as its distance metric."""

    def __init__(self, mesh_shape: tuple[int, ...],
                 chips_per_host: int = 4):
        self.mesh_shape = tuple(mesh_shape)
        self.chips_per_host = chips_per_host

    def num_chips(self) -> int:
        return math.prod(self.mesh_shape)

    def num_hosts(self) -> int:
        return max(1, self.num_chips() // self.chips_per_host)

    def coords_of(self, chip_index: int) -> tuple[int, ...]:
        coords = []
        rest = chip_index
        for dim in reversed(self.mesh_shape):
            coords.append(rest % dim)
            rest //= dim
        return tuple(reversed(coords))

    def host_of(self, chip_index: int) -> int:
        return chip_index // self.chips_per_host

    def host_coords(self, host_index: int) -> tuple[int, ...]:
        return self.coords_of(host_index * self.chips_per_host)

    def hops(self, a: tuple[int, ...], b: tuple[int, ...]) -> int:
        total = 0
        for i, (x, y) in enumerate(zip(a, b)):
            d = abs(x - y)
            dim = self.mesh_shape[i]
            total += min(d, dim - d)   # torus wraparound
        return total
