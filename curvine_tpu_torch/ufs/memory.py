"""mem:// in-process object store.

Own copy of ``curvine_tpu/ufs/memory.py``: an S3-like test double (a flat
key space, directories only as key prefixes). Its buckets belong to the
process, so a master, workers and a test in one process share them; a
master in a process of its own sees none of the caller's, and such a
cluster mounts ``file://`` instead. ``reset`` empties every bucket."""

from __future__ import annotations

import time

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.ufs.base import (Ufs, UfsStatus, register_scheme,
                                        split_uri)

# bucket -> {key -> (bytes, mtime_ms)}
_BUCKETS: dict[str, dict[str, tuple[bytes, int]]] = {}


def reset() -> None:
    _BUCKETS.clear()


class MemoryUfs(Ufs):
    scheme = "mem"

    @staticmethod
    def _bucket(uri: str) -> tuple[dict, str]:
        _, bucket, key = split_uri(uri)
        return _BUCKETS.setdefault(bucket, {}), key.rstrip("/")

    async def stat(self, uri: str) -> UfsStatus | None:
        b, key = self._bucket(uri)
        if key in b:
            data, mtime = b[key]
            return UfsStatus(path=uri.rstrip("/"), len=len(data), mtime=mtime)
        if not key:  # the bucket's root is a directory
            return UfsStatus(path=uri.rstrip("/"), is_dir=True)
        prefix = key + "/"
        if any(k.startswith(prefix) for k in b):
            return UfsStatus(path=uri.rstrip("/"), is_dir=True)
        return None

    async def list(self, uri: str) -> list[UfsStatus]:
        b, key = self._bucket(uri)
        _, bucket, _ = split_uri(uri)
        prefix = key + "/" if key else ""
        names: dict[str, UfsStatus] = {}
        for k, (data, mtime) in sorted(b.items()):
            if not k.startswith(prefix):
                continue
            rest = k[len(prefix):]
            head = rest.split("/", 1)[0]
            full = f"mem://{bucket}/{prefix}{head}"
            if "/" in rest:
                names.setdefault(head, UfsStatus(path=full, is_dir=True))
            else:
                names[head] = UfsStatus(path=full, len=len(data), mtime=mtime)
        return list(names.values())

    async def read(self, uri: str, offset: int = 0, length: int = -1,
                   chunk_size: int = 1024 * 1024):
        b, key = self._bucket(uri)
        if key not in b:
            raise err.FileNotFound(uri)
        data = b[key][0]
        end = len(data) if length < 0 else min(len(data), offset + length)
        for i in range(offset, end, chunk_size):
            yield data[i:min(i + chunk_size, end)]

    async def write(self, uri: str, chunks) -> int:
        b, key = self._bucket(uri)
        buf = bytearray()
        async for chunk in chunks:
            buf += chunk
        b[key] = (bytes(buf), int(time.time() * 1000))
        return len(buf)

    async def delete(self, uri: str) -> None:
        b, key = self._bucket(uri)
        if key in b:
            del b[key]
            return
        prefix = key + "/"
        for k in [k for k in b if k.startswith(prefix)]:
            del b[k]


register_scheme("mem", MemoryUfs)
