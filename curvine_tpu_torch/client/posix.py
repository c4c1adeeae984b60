"""A client over a directory: the cache's POSIX view, for the vector path.

The JAX package's ``VectorTable`` takes a ``CurvineClient`` and calls four
things of it: ``open(path)`` (a reader with ``len``, ``read_all()`` and
``mmap_view()``), ``write_all(path, data)``, ``meta.mkdir(path)`` and
``meta.delete(path)``. ``PosixClient`` offers exactly those calls over a
root directory, such as the cache's FUSE mount, and the port's
``VectorTable`` takes either this client, the port's ``CurvineClient``
or any object with the same calls.

The files go through the port's ``file://`` under-filesystem
(``ufs/local.py::LocalUfs``) and are read through its ``UfsReader``
(``client/ufs_reader.py``), whose ``mmap_view`` returns None, so readers
fall back to ``read_all``. A missing file raises ``FileNotFound`` (wire
code 2), as the cache's client does."""

from __future__ import annotations

import asyncio
import os

from curvine_tpu_torch.client.ufs_reader import UfsReader
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.ufs.local import LocalUfs, _fs_path

__all__ = ["PosixClient"]


class _Meta:
    def __init__(self, client: "PosixClient"):
        self._client = client

    async def mkdir(self, path: str) -> None:
        await self._client.ufs.mkdir(self._client.uri(path))

    async def delete(self, path: str) -> None:
        await self._client.ufs.delete(self._client.uri(path))


class PosixClient:
    """``open``, ``write_all``, ``meta.mkdir`` and ``meta.delete`` over the
    directory ``root``: the cache path ``/a/b`` is the file
    ``<root>/a/b``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.ufs = LocalUfs()
        self.meta = _Meta(self)

    def uri(self, path: str) -> str:
        rel = os.path.normpath("/" + path.lstrip("/")).lstrip("/")
        return "file://" + os.path.join(self.root, rel)

    async def open(self, path: str) -> UfsReader:
        uri = self.uri(path)
        try:
            st = await asyncio.to_thread(os.stat, _fs_path(uri))
        except FileNotFoundError as e:
            raise err.FileNotFound(path) from e
        return UfsReader(self.ufs, uri, st.st_size)

    async def write_all(self, path: str, data: bytes) -> None:
        async def one():
            yield bytes(data)
        await self.ufs.write(self.uri(path), one())
