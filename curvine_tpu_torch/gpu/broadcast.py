"""Model checkpoints on one device, a parameter tree saved through the
cache and loaded back onto the card, and parameters placed on a mesh.

Port of the one-device part of ``curvine_tpu/tpu/broadcast.py``:
``_tree_skeleton`` and ``_tree_build`` (:30-64), ``save_checkpoint``
(:67-90), ``_load_manifest`` (:93-127), ``load_checkpoint`` (:130-157),
``_read_all`` (:160-165) and ``distribute_checkpoint_to_device``
(:316-321). The client is the caller's: it needs ``open`` (a reader with
``len``, ``mmap_view`` and ``read_all``), ``write_all`` and
``meta.mkdir``, which the port's ``CurvineClient`` offers.

The format is the reference's, byte for byte: ``<path>/manifest.json``
is ``json.dumps({"tensors": [{"name", "dtype", "shape"}], "tree":
skeleton})`` and each leaf is one raw file ``<path>/t#####.bin`` of its
bytes in C order, so a checkpoint either package writes, the other loads
bit for bit. dtype names are numpy's (``"bfloat16"`` is ml_dtypes' name,
which the JAX package writes); the port maps them to torch dtypes and
moves the bytes through uint8 views, never through numpy's dtypes, which
lack bfloat16. A name outside the map raises, never guessed.

Loads run every tensor's fetch concurrently; each tensor's bytes (one
preadv of a co-located block, else ``read_all``) are handed to the
placer as soon as they land: ``gpu/ingest.py::DeviceCopier`` stages them
through its pinned ring on a side stream and returns at once, so the
cache reads overlap the host→device copies, and the end of the load makes
the current stream wait on every copy (``deliver``, the counterpart of
``jax.block_until_ready``). Without a device the placer is the CPU's
copier, whose tensors own their memory.

Not ported: the legacy pickled treedef. A manifest without the JSON tree
is refused as the reference refuses it; with ``allow_pickle=True`` the
side file holds a pickled JAX treedef, which only JAX can rebuild, and
the port, which never imports JAX, raises. ``save_checkpoint`` of a tree
the skeleton cannot encode raises the skeleton's ``TypeError`` where the
reference falls back to that pickle.

``broadcast_params`` (:171-181) places a parameter tree onto a
``gpu/mesh.py`` mesh, each leaf a DTensor. ``distribute_checkpoint``
(:292-314) places a whole checkpoint on a mesh, each leaf replicated
(or laid out by ``spec_tree``, through ``broadcast_params``), by one of
two schedules with equal bytes:

- ``"tree"`` (``_distribute_tree``, :224-289): a ``broadcast_schedule``
  over the mesh's ranks, the tensors' reads started largest first (LPT),
  and each file's bytes sourced from the tier-0 of a worker in this
  process's device domain (``_hbm_source``, :183-221) when every block
  of the file is there, all or nothing per file, else from the cache's
  read path; counted as ``ici.peer_pulls`` and ``ici.peer_pull_bytes``
  (blocks and bytes taken from a tier-0), ``ici.tcp_fallbacks`` (files
  that went by the read path) and ``ici.broadcast_bytes``/``_ms``.
  Where the reference hands back a host view of the peer's block, the
  port keeps it on the device: the blocks are joined by a copy on the
  mesh's device, with no host round trip. The manifest is sourced the
  same way. The leaves are placed in LPT order, the same on every rank,
  since each placement is a collective;
- ``"flat"``: ``load_checkpoint`` through a ``DeviceCopier`` onto the
  mesh's device, then ``broadcast_params``, the A/B baseline."""

from __future__ import annotations

import asyncio
import json
import logging
import math
import time

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from curvine_tpu_torch.device import default_device
from curvine_tpu_torch.gpu import ici_plane
from curvine_tpu_torch.gpu.ingest import DeviceCopier
from curvine_tpu_torch.gpu.mesh import mesh_device, placements, tree_map

log = logging.getLogger(__name__)

__all__ = ["save_checkpoint", "load_checkpoint",
           "distribute_checkpoint_to_device", "broadcast_params",
           "distribute_checkpoint"]

# numpy's dtype names (the manifest's) and the torch dtypes they carry
_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
for _name in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _name):
        _DTYPES[_name] = getattr(torch, _name)
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def _tree_skeleton(tree):
    """JSON-safe structure encoding of a tree of dicts, lists, tuples and
    None; leaves become indices into the flat tensor list. Returns
    (skeleton, leaves). Dict keys iterate sorted, ``jax.tree.flatten``'s
    order. Raises TypeError on a dict with a key that is not a str."""
    leaves: list = []

    def enc(node):
        if isinstance(node, dict):
            if not all(isinstance(k, str) for k in node):
                raise TypeError("non-string dict key")
            return {"k": "dict",
                    "v": {k: enc(node[k]) for k in sorted(node)}}
        if isinstance(node, (list, tuple)):
            return {"k": "list" if isinstance(node, list) else "tuple",
                    "v": [enc(c) for c in node]}
        if node is None:
            return {"k": "none"}
        leaves.append(node)
        return {"k": "leaf", "i": len(leaves) - 1}

    return enc(tree), leaves


def _tree_build(skel, leaves):
    k = skel["k"]
    if k == "dict":
        return {key: _tree_build(c, leaves) for key, c in skel["v"].items()}
    if k == "list":
        return [_tree_build(c, leaves) for c in skel["v"]]
    if k == "tuple":
        return tuple(_tree_build(c, leaves) for c in skel["v"])
    if k == "none":
        return None
    return leaves[skel["i"]]


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype "
                         f"here (known: {sorted(_DTYPES)})") from None


def _leaf_bytes(leaf) -> tuple[dict, np.ndarray]:
    """A leaf's manifest entry (without its name) and its bytes as a
    uint8 array. A leaf that is not a tensor goes through
    ``np.asarray``, as the reference's does."""
    t = leaf if isinstance(leaf, torch.Tensor) else \
        torch.from_numpy(np.asarray(leaf))
    if t.dtype not in _NAMES:
        raise ValueError(f"no checkpoint dtype name for {t.dtype}")
    raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return ({"dtype": _NAMES[t.dtype], "shape": list(t.shape)},
            raw.numpy())


def _typed(raw: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """A uint8 tensor's bytes as ``dtype`` in ``shape`` (a view)."""
    if raw.numel() == 0:         # an empty numpy array comes with stride 0
        return torch.empty(shape, dtype=dtype, device=raw.device)
    return raw.view(dtype).reshape(shape)


async def save_checkpoint(client, path: str, params) -> None:
    """Write a tree of tensors as ``manifest.json`` and one raw file per
    leaf, the tree JSON-encoded inside the manifest."""
    skel, flat = _tree_skeleton(params)
    tensors = []
    await client.meta.mkdir(path)
    for i, leaf in enumerate(flat):
        entry, raw = _leaf_bytes(leaf)
        name = f"t{i:05d}.bin"
        tensors.append({"name": name, **entry})
        await client.write_all(f"{path}/{name}", raw)
    await client.write_all(f"{path}/manifest.json", json.dumps(
        {"tensors": tensors, "tree": skel}).encode())


async def _load_manifest(client, path: str, allow_pickle: bool = False,
                         data=None):
    """A checkpoint's tensor list and tree skeleton, from ``data`` (the
    manifest's bytes) when given. A manifest without the JSON tree needs
    the legacy pickled treedef: refused unless ``allow_pickle``
    (unpickling runs arbitrary code), and then refused all the same,
    since only JAX rebuilds that treedef."""
    if data is None:
        data = await _read_all(client, f"{path}/manifest.json")
    raw = json.loads(bytes(data))
    if isinstance(raw, list):
        manifest, skel = raw, None
    else:
        manifest, skel = raw["tensors"], raw.get("tree")
    if skel is None:
        if not allow_pickle:
            raise ValueError(
                f"checkpoint {path!r} carries only a legacy pickled "
                f"treedef, which this reader does not load by default "
                f"(unpickling runs arbitrary code). Pass "
                f"allow_pickle=True if you trust the writer, or re-save "
                f"the checkpoint with save_checkpoint() to get the safe "
                f"JSON tree encoding.")
        raise NotImplementedError(
            f"checkpoint {path!r} keeps its tree as a pickled JAX treedef "
            f"(treedef.pkl), which only JAX can rebuild; the PyTorch port "
            f"never imports JAX. Re-save it with save_checkpoint() of "
            f"either package to get the JSON tree encoding.")
    return manifest, skel


async def load_checkpoint(client, path: str, placer=None,
                          allow_pickle: bool = False):
    """The tree of tensors saved at ``path``. ``placer`` (a
    ``DeviceCopier``) takes each tensor's bytes as soon as they land and
    ``deliver``s them once all are placed; None places them on the CPU,
    in tensors that own their memory."""
    manifest, skel = await _load_manifest(client, path, allow_pickle)
    placer = placer if placer is not None else DeviceCopier("cpu")

    async def load_one(t):
        dtype = _torch_dtype(t["dtype"])
        want = math.prod(t["shape"]) * dtype.itemsize
        reader = await client.open(f"{path}/{t['name']}")
        try:
            view = await reader.mmap_view(0, reader.len)
            if view is None:
                view = np.frombuffer(await reader.read_all(), dtype=np.uint8)
        finally:
            await reader.close()
        if view.nbytes != want:
            raise ValueError(f"{path}/{t['name']}: {view.nbytes} bytes, "
                             f"{t['shape']} {t['dtype']} needs {want}")
        return placer.transfer(view), dtype, t["shape"]

    placed = await asyncio.gather(*(load_one(t) for t in manifest))
    flat = [_typed(placer.deliver(item), dtype, shape)
            for item, dtype, shape in placed]
    return _tree_build(skel, flat)


async def _read_all(client, path: str):
    reader = await client.open(path)
    try:
        return await reader.read_all()
    finally:
        await reader.close()


async def distribute_checkpoint_to_device(client, path: str, device=None):
    """A whole checkpoint onto one device, its cache reads overlapping its
    host→device copies. ``device`` None is ``default_device()``: the
    card, or an error without one; the CPU only when asked for."""
    device = default_device() if device is None else torch.device(device)
    return await load_checkpoint(client, path, placer=DeviceCopier(device))


def broadcast_params(params, mesh, spec_tree=None):
    """Place params onto the mesh, each leaf a DTensor on its device.
    spec_tree=None → fully replicated (classic model distribution);
    otherwise each leaf lands laid out by its spec (a ``gpu/mesh.py::P``
    in a tree of the same structure), never whole on a rank that holds a
    shard. Every rank of the mesh calls it; rank 0's values are the ones
    placed. A leaf that requires grad stays one, as a new leaf."""
    def place(x, spec):
        return distribute_tensor(x.detach(), mesh, placements(mesh, spec)
                                 ).requires_grad_(x.requires_grad)

    if spec_tree is None:
        return tree_map(lambda x: place(x, ()), params)
    return tree_map(place, params, spec_tree)


def _count(counters: dict | None, key: str, n) -> None:
    if counters is not None:
        counters[key] = counters.get(key, 0) + n


async def _hbm_source(client, path: str, counters: dict | None = None,
                      device=None) -> torch.Tensor | None:
    """A cached file's bytes from the tier-0 of a worker in this
    process's device domain, as a new uint8 tensor on ``device`` (the
    tier's own device when None): every block of the file or None, never
    a file half from the device and half from the read path, which would
    wait on the slow half anyway. None counts one ``ici.tcp_fallbacks``;
    the caller then reads the file."""
    if not ici_plane.endpoints():
        return None
    try:
        fb = await client.meta.get_block_locations(path)
    except Exception:            # noqa: BLE001 — any miss: the read path
        return None
    if not fb.block_locs:
        return None
    parts = []
    for lb in fb.block_locs:
        got = None
        for loc in lb.locs:
            t = ici_plane.fetch_device_block(loc.worker_id, lb.block.id,
                                             device=device)
            if t is not None and t.nbytes == lb.block.len:
                got = t.reshape(-1).view(torch.uint8)
                break
        if got is None:
            _count(counters, "ici.tcp_fallbacks", 1)
            return None
        if got.device.type == "cuda":
            # the tier may drop its tensor while the join below is queued
            got.record_stream(torch.cuda.current_stream(got.device))
        parts.append(got)
    _count(counters, "ici.peer_pulls", len(parts))
    _count(counters, "ici.peer_pull_bytes", sum(p.nbytes for p in parts))
    # a new tensor: the tier keeps its own
    return torch.cat(parts)


async def _distribute_tree(client, path: str, mesh,
                           allow_pickle: bool = False):
    """The checkpoint at ``path`` replicated over ``mesh`` by the
    topology schedule (see the module docstring); bit for bit the flat
    path's result."""
    counters = getattr(client, "counters", None)
    device = mesh_device(mesh)
    sched = ici_plane.broadcast_schedule(mesh.size())
    log.debug("broadcast schedule for %s: %d ranks, depth %d", path,
              mesh.size(), sched.depth())
    t0 = time.perf_counter()
    raw = await _hbm_source(client, f"{path}/manifest.json", counters,
                            device)
    manifest, skel = await _load_manifest(
        client, path, allow_pickle,
        data=None if raw is None else raw.cpu().numpy().tobytes())
    copier = DeviceCopier(device)

    def size_of(t) -> int:
        return math.prod(t["shape"]) * _torch_dtype(t["dtype"]).itemsize

    async def fetch(t):
        name = f"{path}/{t['name']}"
        got = await _hbm_source(client, name, counters, device)
        if got is not None:
            return got, None
        reader = await client.open(name)
        try:
            view = await reader.mmap_view(0, reader.len)
            if view is None:
                view = np.frombuffer(await reader.read_all(), dtype=np.uint8)
            return None, copier.transfer(view)
        finally:
            await reader.close()

    lpt = sorted(range(len(manifest)), key=lambda i: -size_of(manifest[i]))
    tasks = {i: asyncio.ensure_future(fetch(manifest[i])) for i in lpt}
    rep = placements(mesh, ())
    flat: list = [None] * len(manifest)
    try:
        for i in lpt:
            t = manifest[i]
            got, item = await tasks[i]
            raw = got if got is not None else copier.deliver(item)
            if raw.nbytes != size_of(t):
                raise ValueError(f"{path}/{t['name']}: {raw.nbytes} bytes, "
                                 f"{t['shape']} {t['dtype']} needs "
                                 f"{size_of(t)}")
            flat[i] = distribute_tensor(
                _typed(raw, _torch_dtype(t["dtype"]), t["shape"]), mesh,
                rep, src_data_rank=0)
    finally:
        for task in tasks.values():
            task.cancel()
        await asyncio.gather(*tasks.values(), return_exceptions=True)
    if mesh.device_type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    _count(counters, "ici.broadcast_bytes", sum(map(size_of, manifest)))
    _count(counters, "ici.broadcast_ms",
           int((time.perf_counter() - t0) * 1000))
    return _tree_build(skel, flat)


async def distribute_checkpoint(client, path: str, mesh, spec_tree=None,
                                schedule: str = "tree",
                                allow_pickle: bool = False):
    """The checkpoint at ``path`` on ``mesh``, each leaf a DTensor:
    replicated when ``spec_tree`` is None, by the ``"tree"`` schedule
    (the topology-scheduled path) or ``"flat"`` (``load_checkpoint`` then
    ``broadcast_params``, kept for A/B); else laid out by ``spec_tree``.
    Every rank of the mesh calls it; rank 0's bytes are the ones placed.
    The two schedules give equal bytes."""
    if schedule not in ("tree", "flat"):
        raise ValueError(f"schedule {schedule!r}: \"tree\" or \"flat\"")
    if spec_tree is None and schedule == "tree":
        return await _distribute_tree(client, path, mesh,
                                      allow_pickle=allow_pickle)
    host = await load_checkpoint(client, path,
                                 placer=DeviceCopier(mesh_device(mesh)),
                                 allow_pickle=allow_pickle)
    return broadcast_params(host, mesh, spec_tree)
