"""A client over a directory: the cache's POSIX view, for the vector path.

The JAX package's ``VectorTable`` takes a ``CurvineClient`` and calls four
things of it: ``open(path)`` (a reader with ``len``, ``read_all()`` and
``mmap_view()``), ``write_all(path, data)``, ``meta.mkdir(path)`` and
``meta.delete(path)``. The port has no RPC client yet (ROADMAP A3), so
``PosixClient`` offers exactly those calls over a root directory, such as
the cache's FUSE mount, and the port's ``VectorTable`` takes either this
client or any object with the same calls.

``LocalUfs`` and ``UfsReader`` are own copies of
``curvine_tpu/ufs/local.py::LocalUfs`` (read, write, mkdir, delete) and
``curvine_tpu/client/ufs_reader.py::UfsReader``; ``mmap_view`` returns
None, as the original's does, so readers fall back to ``read_all``. A
missing file raises ``FileNotFound`` (wire code 2), as the cache's client
does."""

from __future__ import annotations

import asyncio
import os
import shutil

from curvine_tpu_torch.common import errors as err

__all__ = ["PosixClient", "LocalUfs", "UfsReader"]


def _fs_path(uri: str) -> str:
    # file:///a/b -> /a/b (curvine_tpu/ufs/local.py::_fs_path over
    # ufs/base.py::split_uri)
    if "://" not in uri:
        return uri
    rest = uri.split("://", 1)[1]
    authority, key = rest.split("/", 1) if "/" in rest else (rest, "")
    return "/" + key if not authority else f"/{authority}/{key}"


class LocalUfs:
    """file:// store over the local filesystem."""

    async def read(self, uri: str, offset: int = 0, length: int = -1,
                   chunk_size: int = 1024 * 1024):
        p = _fs_path(uri)
        try:
            f = await asyncio.to_thread(open, p, "rb")
        except FileNotFoundError as e:
            raise err.FileNotFound(uri) from e
        try:
            if offset:
                f.seek(offset)
            remaining = length if length >= 0 else None
            while True:
                n = chunk_size if remaining is None else min(chunk_size,
                                                             remaining)
                if n == 0:
                    break
                chunk = await asyncio.to_thread(f.read, n)
                if not chunk:
                    break
                if remaining is not None:
                    remaining -= len(chunk)
                yield chunk
        finally:
            f.close()

    async def write(self, uri: str, chunks) -> int:
        p = _fs_path(uri)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        total = 0
        tmp = p + ".curvine-tmp"
        f = await asyncio.to_thread(open, tmp, "wb")
        try:
            async for chunk in chunks:
                await asyncio.to_thread(f.write, chunk)
                total += len(chunk)
        finally:
            f.close()
        os.replace(tmp, p)
        return total

    async def delete(self, uri: str) -> None:
        p = _fs_path(uri)
        try:
            if os.path.isdir(p):
                await asyncio.to_thread(shutil.rmtree, p)
            else:
                await asyncio.to_thread(os.unlink, p)
        except FileNotFoundError:
            pass

    async def mkdir(self, uri: str) -> None:
        await asyncio.to_thread(os.makedirs, _fs_path(uri), exist_ok=True)


class UfsReader:
    """Reader over one object of a store (FsReader-compatible surface)."""

    def __init__(self, ufs, uri: str, length: int):
        self.ufs = ufs
        self.uri = uri
        self.len = length
        self.pos = 0

    def seek(self, pos: int) -> None:
        self.pos = max(0, min(pos, self.len))

    async def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.len - self.pos
        data = await self.pread(self.pos, n)
        self.pos += len(data)
        return data

    async def read_all(self) -> bytes:
        self.seek(0)
        return await self.read(self.len)

    async def pread(self, offset: int, n: int) -> bytes:
        n = max(0, min(n, self.len - offset))
        if n == 0:
            return b""
        out = bytearray()
        async for chunk in self.ufs.read(self.uri, offset=offset, length=n):
            out += chunk
        return bytes(out)

    async def mmap_view(self, offset: int, n: int):
        return None      # no local block files to map

    async def close(self) -> None:
        pass             # holds no handle between reads


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
