"""Under-filesystem (UFS) abstraction.

Own copy of ``curvine_tpu/ufs/base.py``: a ``Ufs`` exposes object-store
semantics (stat, list, walk, read, write, delete, mkdir, rename) on full
URIs (``scheme://authority/key``); ``split_uri`` cuts a URI into those
three parts; backends register their scheme (``register_scheme``) and
``create_ufs`` builds the backend of a URI's scheme.

The port registers ``file://`` (``ufs/local.py``) and ``mem://``
(``ufs/memory.py``). The reference's s3, hdfs, gcs, oss, azblob, cos and
oss-hdfs backends speak HTTP through ``aiohttp`` and need a network;
they are not ported yet (ROADMAP A3e), and ``create_ufs`` refuses their
schemes by name with ``UfsError``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import AsyncIterator, Callable

from curvine_tpu_torch.common import errors as err

# the reference's schemes whose backends the port does not have yet
UNPORTED_SCHEMES = ("s3", "hdfs", "gs", "gcs", "oss", "azblob", "cos",
                    "oss-hdfs")


@dataclass
class UfsStatus:
    path: str            # the full uri
    is_dir: bool = False
    len: int = 0
    mtime: int = 0


class Ufs:
    scheme = ""

    def __init__(self, properties: dict | None = None):
        self.properties = properties or {}

    async def stat(self, uri: str) -> UfsStatus | None:
        raise NotImplementedError

    async def list(self, uri: str) -> list[UfsStatus]:
        raise NotImplementedError

    async def walk(self, uri: str, recursive: bool = True
                   ) -> AsyncIterator[UfsStatus]:
        for st in await self.list(uri):
            yield st
            if st.is_dir and recursive:
                async for sub in self.walk(st.path, recursive=True):
                    yield sub

    async def read(self, uri: str, offset: int = 0, length: int = -1,
                   chunk_size: int = 1024 * 1024) -> AsyncIterator[bytes]:
        raise NotImplementedError
        yield b""  # pragma: no cover

    async def read_all(self, uri: str) -> bytes:
        out = bytearray()
        async for chunk in self.read(uri):
            out += chunk
        return bytes(out)

    async def write(self, uri: str, chunks) -> int:
        """The whole object from an async iterator of bytes; returns its
        length."""
        raise NotImplementedError

    async def write_all(self, uri: str, data: bytes) -> int:
        async def one():
            yield data
        return await self.write(uri, one())

    async def delete(self, uri: str) -> None:
        raise NotImplementedError

    async def mkdir(self, uri: str) -> None:
        """Object stores have no real directories: a no-op."""
        return None

    async def rename(self, src: str, dst: str) -> None:
        # object-store semantics: copy, then delete (no atomic rename)
        data = await self.read_all(src)
        await self.write_all(dst, data)
        await self.delete(src)


_SCHEMES: dict[str, Callable[..., Ufs]] = {}


def register_scheme(scheme: str, factory: Callable[..., Ufs]) -> None:
    _SCHEMES[scheme] = factory


def split_uri(uri: str) -> tuple[str, str, str]:
    """uri → (scheme, authority, key path)."""
    if "://" not in uri:
        return "file", "", uri
    scheme, rest = uri.split("://", 1)
    if "/" in rest:
        authority, key = rest.split("/", 1)
    else:
        authority, key = rest, ""
    return scheme, authority, key


def create_ufs(uri: str, properties: dict | None = None) -> Ufs:
    """The backend of ``uri``'s scheme (registered when the ``ufs``
    package is imported, which importing this module does first)."""
    scheme, _, _ = split_uri(uri)
    factory = _SCHEMES.get(scheme)
    if factory is None:
        if scheme in UNPORTED_SCHEMES:
            raise err.UfsError(f"{scheme} is not ported (ROADMAP A3e): the "
                               f"port serves {sorted(_SCHEMES)}")
        raise err.UfsError(f"no UFS backend for scheme {scheme!r}; "
                           f"registered: {sorted(_SCHEMES)}")
    return factory(properties=properties)
