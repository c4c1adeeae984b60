"""Reader over an uncached UFS object, with ``FsReader``'s surface.

Own copy of ``curvine_tpu/client/ufs_reader.py``: the unified open of a
file that exists under a mount but has no cached blocks, and
``PosixClient``'s reader; ranged reads go straight to the under-store.
``mmap_view`` returns None (no local block file to map), so a caller
falls back to ``read_all``. ``pread_view`` and ``read_range`` (:46-52)
give ``pread``'s bytes as a uint8 array (an object streams in order, so
``parallel`` changes nothing), and ``chunks`` (:57-61) streams the object
in chunks of ``chunk_size``."""

from __future__ import annotations

import numpy as np


class UfsReader:
    def __init__(self, ufs, uri: str, length: int,
                 chunk_size: int = 4 * 1024 * 1024):
        self.ufs = ufs
        self.uri = uri
        self.len = length
        self.chunk_size = chunk_size
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

    async def pread_view(self, offset: int, n: int) -> np.ndarray:
        return np.frombuffer(await self.pread(offset, n), dtype=np.uint8)

    async def read_range(self, offset: int, n: int,
                         parallel: int = 1) -> np.ndarray:
        return await self.pread_view(offset, n)

    async def mmap_view(self, offset: int, n: int):
        return None      # no local block file to map

    async def chunks(self, chunk_size: int | None = None):
        chunk_size = chunk_size or self.chunk_size
        self.seek(0)
        async for chunk in self.ufs.read(self.uri, chunk_size=chunk_size):
            self.pos += len(chunk)
            yield chunk

    async def close(self) -> None:
        return None      # holds no handle between reads
