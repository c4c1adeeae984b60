"""file:// UFS over the local filesystem.

Own copy of ``curvine_tpu/ufs/local.py``: stat, list, walk, read in
chunks, write through a temp file renamed into place, delete (a
directory recursively), mkdir and rename. Every blocking call runs on a
thread."""

from __future__ import annotations

import asyncio
import os
import shutil
import stat as stat_mod

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.ufs.base import (Ufs, UfsStatus, register_scheme,
                                        split_uri)


def _fs_path(uri: str) -> str:
    _, authority, key = split_uri(uri)
    # file:///a/b → authority "", key "a/b"
    return "/" + key if not authority else f"/{authority}/{key}"


class LocalUfs(Ufs):
    scheme = "file"

    async def stat(self, uri: str) -> UfsStatus | None:
        p = _fs_path(uri)
        try:
            st = await asyncio.to_thread(os.stat, p)
        except FileNotFoundError:
            return None
        return UfsStatus(path=f"file://{p}", is_dir=stat_mod.S_ISDIR(
            st.st_mode), len=st.st_size, mtime=int(st.st_mtime * 1000))

    async def list(self, uri: str) -> list[UfsStatus]:
        p = _fs_path(uri)
        out = []
        try:
            names = await asyncio.to_thread(os.listdir, p)
        except FileNotFoundError as e:
            raise err.FileNotFound(uri) from e
        except NotADirectoryError as e:
            raise err.NotADirectory(uri) from e
        for name in sorted(names):
            st = await self.stat(f"file://{p.rstrip('/')}/{name}")
            if st is not None:
                out.append(st)
        return out

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

    async def rename(self, src: str, dst: str) -> None:
        await asyncio.to_thread(os.replace, _fs_path(src), _fs_path(dst))


register_scheme("file", LocalUfs)
