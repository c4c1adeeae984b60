"""Model checkpoints on one device: a parameter tree saved through the
cache and loaded back onto the card.

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
reference falls back to that pickle. ``broadcast_params``,
``distribute_checkpoint`` and its schedules need the mesh and the peer
plane (ROADMAP A8, A9b, A10)."""

from __future__ import annotations

import asyncio
import json
import math

import numpy as np
import torch

from curvine_tpu_torch.device import default_device
from curvine_tpu_torch.gpu.ingest import DeviceCopier

__all__ = ["save_checkpoint", "load_checkpoint",
           "distribute_checkpoint_to_device"]

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


async def _load_manifest(client, path: str, allow_pickle: bool = False):
    """A checkpoint's tensor list and tree skeleton. A manifest without
    the JSON tree needs the legacy pickled treedef: refused unless
    ``allow_pickle`` (unpickling runs arbitrary code), and then refused
    all the same, since only JAX rebuilds that treedef."""
    raw = json.loads(await _read_all(client, f"{path}/manifest.json"))
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
