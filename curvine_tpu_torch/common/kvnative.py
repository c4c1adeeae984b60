"""The native engine of the master's KV metadata store, bound with ctypes.

Own copy of ``curvine_tpu/common/kvnative.py``: ``NativeKvStore`` over
the port's ``csrc/kv_engine.cc``, which ``gpu/_build.py`` compiles with
the host C++ compiler at first use into ``curvine_tpu_torch/build/``
(the reference runs ``make -C csrc``). The C interface and its ctypes
signatures are the reference's (:56-90). The surface and the on-disk
format are those of the Python engine (``common/kvstore.py``), so either
engine opens the other's directory and the choice can change between
restarts. A write batch is packed here with the port's codec
(``rpc/wirepack.py``, byte-equal to ``msgpack``) and journaled by the
engine verbatim, so the WAL's bytes are the Python engine's.

``available()`` says whether the library builds and loads; it never
raises. ``load()`` raises ``KernelBuildError`` with the compiler's output
when it does not."""

from __future__ import annotations

import ctypes
import logging
import os
import struct

from curvine_tpu_torch.rpc import wirepack

log = logging.getLogger(__name__)

_u8p = ctypes.POINTER(ctypes.c_uint8)
_lib = None


def load() -> ctypes.CDLL:
    """The engine's library, built at first use, with its signatures."""
    global _lib
    if _lib is not None:
        return _lib
    from curvine_tpu_torch.gpu import _build
    lib = _build.load("kv_engine")
    lib.kv_errmsg.restype = ctypes.c_char_p
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
                            ctypes.c_int]
    lib.kv_write_batch.restype = ctypes.c_int
    lib.kv_write_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint32]
    lib.kv_get.restype = ctypes.c_int
    lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.POINTER(_u8p),
                           ctypes.POINTER(ctypes.c_uint32)]
    lib.kv_free.argtypes = [ctypes.c_void_p]
    for name in ("kv_flush", "kv_compact", "kv_clear"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.kv_close.argtypes = [ctypes.c_void_p]
    lib.kv_scan_open.restype = ctypes.c_void_p
    lib.kv_scan_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32, ctypes.c_char_p,
                                 ctypes.c_uint32]
    lib.kv_scan_close.argtypes = [ctypes.c_void_p]
    lib.kv_scan_mem_items.restype = ctypes.c_uint64
    lib.kv_scan_mem_items.argtypes = [ctypes.c_void_p]
    lib.kv_scan_many.restype = ctypes.c_int64
    lib.kv_scan_many.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32]
    lib.kv_segment_count.restype = ctypes.c_uint64
    lib.kv_segment_count.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the engine's library builds and loads here."""
    try:
        load()
    except Exception as e:  # noqa: BLE001 — no compiler, or a failed build
        log.debug("native kv engine unavailable: %s", e)
        return False
    return True


class NativeKvStore:
    """The Python engine's ``KvStore`` surface over the native engine."""

    kind = "native"

    def __init__(self, kv_dir: str, memtable_max_bytes: int = 8 << 20,
                 compact_threshold: int = 8, fsync: bool = False):
        self._lib = load()
        self.dir = kv_dir
        os.makedirs(kv_dir, exist_ok=True)
        self._h = self._lib.kv_open(kv_dir.encode(), 1 if fsync else 0,
                                    memtable_max_bytes, compact_threshold)
        if not self._h:
            raise RuntimeError(f"kv_open: {self._err()}")

    def _err(self) -> str:
        return self._lib.kv_errmsg().decode(errors="replace")

    def _check(self, rc: int) -> None:
        if rc < 0:
            raise RuntimeError(f"kv: {self._err()}")

    # ---- writes ----

    def write_batch(self, items) -> None:
        items = list(items)
        if not items:
            return
        payload = wirepack.packb(items, use_bin_type=True)
        self._check(self._lib.kv_write_batch(self._h, payload, len(payload)))

    def put(self, key: bytes, value: bytes) -> None:
        self.write_batch([(key, value)])

    def delete(self, key: bytes) -> None:
        self.write_batch([(key, None)])

    # ---- reads ----

    def get(self, key: bytes) -> bytes | None:
        out = _u8p()
        n = ctypes.c_uint32()
        rc = self._lib.kv_get(self._h, key, len(key), ctypes.byref(out),
                              ctypes.byref(n))
        self._check(rc)
        if rc == 0:
            return None
        try:
            return ctypes.string_at(out, n.value)
        finally:
            self._lib.kv_free(out)

    def scan(self, prefix: bytes = b"", start: bytes | None = None):
        """An iterator of (key, value) in key order for keys with
        ``prefix``, from ``start``. A cursor: the engine copies the
        memtable's items under the prefix and opens every segment's file
        when it is made (``kv_scan_open``), so it may be drained later, on
        another thread, while this store takes writes, flushes and
        compacts."""
        it = self._lib.kv_scan_open(self._h, prefix, len(prefix),
                                    start or b"", len(start) if start else 0)
        if not it:
            raise RuntimeError(f"kv_scan: {self._err()}")
        return _Cursor(self._lib, it)


    # ---- maintenance ----

    def flush(self) -> None:
        self._check(self._lib.kv_flush(self._h))

    def compact(self) -> None:
        self._check(self._lib.kv_compact(self._h))

    def clear(self) -> None:
        self._check(self._lib.kv_clear(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None

    @property
    def segment_count(self) -> int:
        return int(self._lib.kv_segment_count(self._h))


class _Cursor:
    """An open ``kv_scan_open`` iterator, read a buffer of records at a
    time: one FFI call fills the buffer (a call an item costs more than
    the Python engine's whole scan). The engine's iterator holds copies
    and its own file handles, so it outlives the store's later writes
    and may be drained on any one thread; it is freed when exhausted or
    dropped."""

    _SCAN_BUF = 1 << 20
    _U32X2 = struct.Struct("<II")

    def __init__(self, lib, it):
        self._lib = lib
        self._it = it
        self._bufsize = self._SCAN_BUF
        self._buf = None            # made at the first fill, by the drainer
        self._data = b""
        self._off = 0

    def __iter__(self):
        return self

    def __next__(self) -> tuple[bytes, bytes]:
        if self._off >= len(self._data):
            self._fill()
        data, off = self._data, self._off
        kl, vl = self._U32X2.unpack_from(data, off)
        off += 8
        self._off = off + kl + vl
        return data[off:off + kl], data[off + kl:off + kl + vl]

    def _fill(self) -> None:
        if self._it is None:
            raise StopIteration
        if self._buf is None:
            self._buf = ctypes.create_string_buffer(self._bufsize)
        while True:
            n = self._lib.kv_scan_many(self._it, self._buf, self._bufsize)
            if n < -1:
                # one record larger than the buffer: grow and retry
                self._bufsize = -n
                self._buf = ctypes.create_string_buffer(self._bufsize)
                continue
            break
        if n <= 0:
            self.close()
            if n < 0:
                raise RuntimeError(
                    f"kv: {self._lib.kv_errmsg().decode(errors='replace')}")
            raise StopIteration
        self._data = ctypes.string_at(self._buf, n)   # one copy of n bytes
        self._off = 0

    @property
    def mem_items(self) -> int:
        """The memtable items the engine copied into this cursor when it
        was opened (0 once it is exhausted)."""
        return 0 if self._it is None else int(
            self._lib.kv_scan_mem_items(self._it))

    def close(self) -> None:
        it, self._it = self._it, None
        if it is not None:
            self._lib.kv_scan_close(it)

    def __del__(self):
        self.close()
