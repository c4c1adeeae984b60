"""Blocks in the worker's on-disk layout, and their media checksums.

The port has no worker of its own yet; it reads the block files that the
JAX package's worker lays out (``curvine_tpu/worker/storage.py:24,
161-164``): ``<tier root>/<block_id % 256:02x>/<block_id>.blk``. A block
of a bdev tier is an extent ``(offset, length)`` of the tier's one
backing file, so every reader takes an offset.

``crc_update`` is the port's own copy of
``curvine_tpu/common/checksum.py:26-34``: ``crc32`` is zlib's, and
``crc32c`` (Castagnoli) goes through the port's own host routine
``csrc/crc32c.cc`` (SSE4.2 where the CPU has it), built with the host C++
compiler at first use (``gpu/_build.py``). A failed build raises
``KernelBuildError`` when crc32c is asked for. ``crc32c_table`` is the
plain table version (as ``curvine_tpu/common/native.py:163-181``), the
reference the built routine is tested against."""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
import zlib

import numpy as np

from curvine_tpu_torch.gpu import _build

__all__ = ["ALGO_CRC32", "ALGO_CRC32C", "SUBDIRS", "block_path",
           "map_block", "crc_update", "crc32c_table", "supported"]

SUBDIRS = 256
ALGO_CRC32 = "crc32"
ALGO_CRC32C = "crc32c"

_crc_lock = threading.Lock()
_crc_lib: ctypes.CDLL | None = None
_table: list[int] | None = None


def block_path(root: str, block_id: int, suffix: str = ".blk") -> str:
    """Path of a committed block file under a tier root."""
    return os.path.join(root, f"{block_id % SUBDIRS:02x}",
                        f"{block_id}{suffix}")


def map_block(path: str, offset: int = 0, length: int | None = None
              ) -> np.ndarray:
    """Read-only uint8 view of ``length`` bytes at ``offset`` of ``path``
    (to the end of the file when ``length`` is None), backed by a shared
    mmap: no copy, and the pages are the page cache's (or tmpfs's). The
    mapping lives as long as the view."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if length is None:
            length = size - offset
        if offset < 0 or length < 0 or offset + length > size:
            raise ValueError(f"{path}: range {offset}+{length} outside "
                             f"the file's {size} bytes")
        if length == 0:
            return np.empty(0, dtype=np.uint8)
        start = offset - offset % mmap.ALLOCATIONGRANULARITY
        mm = mmap.mmap(f.fileno(), length + (offset - start),
                       access=mmap.ACCESS_READ, offset=start)
    view = np.frombuffer(mm, dtype=np.uint8)
    return view[offset - start:]


def _crc32c_lib() -> ctypes.CDLL:
    """The built ``csrc/crc32c.cc``, its tables filled once."""
    global _crc_lib
    with _crc_lock:
        if _crc_lib is None:
            lib = _build.load("crc32c")
            lib.cv_crc32c_init.argtypes = []
            lib.cv_crc32c_init.restype = None
            lib.cv_crc32c_hw.argtypes = []
            lib.cv_crc32c_hw.restype = ctypes.c_int
            lib.cv_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_uint32]
            lib.cv_crc32c.restype = ctypes.c_uint32
            lib.cv_crc32c_init()
            _crc_lib = lib
        return _crc_lib


def crc32c_table(data, seed: int = 0) -> int:
    """Plain crc32c, one table lookup a byte: the reference for the built
    routine."""
    global _table
    if _table is None:
        t = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            t.append(crc)
        _table = t
    crc = seed ^ 0xFFFFFFFF
    for b in bytes(data):
        crc = _table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc_update(algo: str, data, crc: int = 0) -> int:
    """One streaming step of ``algo`` over ``data``, chained from ``crc``."""
    if algo == ALGO_CRC32C:
        lib = _crc32c_lib()
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.asarray(data)
        arr = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        return lib.cv_crc32c(arr.ctypes.data, arr.nbytes, crc)
    return zlib.crc32(data, crc)


def supported(algo: str | None) -> bool:
    return algo in (ALGO_CRC32, ALGO_CRC32C)
