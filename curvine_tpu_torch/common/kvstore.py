"""Log-structured KV store: WAL, memtable, sorted segments, compaction.

Own copy of ``curvine_tpu/common/kvstore.py``, the Python engine of the
master's KV metadata store (the reference's stand-in for RocksDB), on
the port's codec (``rpc/wirepack.py``, byte-equal to ``msgpack``) where
the reference uses ``msgpack`` (:80, :227, :253, :321). The on-disk
bytes are the reference's, so either package, and either engine
(``common/kvnative.py`` over ``csrc/kv_engine.cc``), opens the other's
directory.

On-disk layout under ``dir/``:
  wal-<gen>.log    CRC-framed batches ``[(key, value|None), ...]``
                   (None = tombstone), replayed into the memtable on
                   open; a torn or corrupt tail is truncated at its
                   first bad frame.
  seg-<gen>.sst    an immutable sorted run, written to a temporary file
                   and renamed: ``[klen u32][vlen i32][key][value]``
                   entries in key order (vlen -1 = tombstone), then the
                   trailer ``[sparse_index, bloom_bytes]`` (an index
                   entry every SPARSE-th key; a bloom filter of about
                   10 bits a key, double-hashed, so a point miss skips
                   the segment), then the footer
                   ``[index_off u64][count u64] MAGIC``.

A read checks the memtable, then the segments newest first (a bisect of
the sparse index and a short forward scan). ``flush()`` turns the
memtable into a new segment and drops the WAL; past
``compact_threshold`` segments the newest ones of comparable size are
merged (size-tiered), and a merge that covers every segment drops the
tombstones. ``scan`` yields a prefix in key order, the memtable
shadowing the segments."""

from __future__ import annotations

import heapq
import logging
import os
import struct
import zlib

from curvine_tpu_torch.rpc import wirepack

log = logging.getLogger(__name__)

_WAL_HDR = struct.Struct(">II")          # payload len, crc32
_ENT_HDR = struct.Struct(">Ii")          # klen, vlen (-1 = tombstone)
_FOOTER = struct.Struct(">QQ")           # index offset, entry count
MAGIC = b"CVSST02\0"
SPARSE = 64                              # index every Nth entry
_BLOOM_BITS_PER_KEY = 10
_BLOOM_K = 4


def _bloom_hashes(key: bytes, nbits: int):
    h1 = zlib.crc32(key)
    h2 = zlib.crc32(key, 0x9E3779B9) | 1
    return [(h1 + i * h2) % nbits for i in range(_BLOOM_K)]


def _bloom_maybe(bloom: bytes, key: bytes) -> bool:
    nbits = len(bloom) * 8
    if nbits == 0:
        return True
    return all(bloom[b >> 3] & (1 << (b & 7))
               for b in _bloom_hashes(key, nbits))


class Segment:
    """One immutable sorted run. Holds the sparse index in memory
    (~count/SPARSE keys); entry data is read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < _FOOTER.size + len(MAGIC):
                raise ValueError(f"{path}: truncated segment")
            f.seek(size - _FOOTER.size - len(MAGIC))
            tail = f.read(_FOOTER.size + len(MAGIC))
            if tail[_FOOTER.size:] != MAGIC:
                raise ValueError(f"{path}: bad segment magic")
            self.index_off, self.count = _FOOTER.unpack(tail[:_FOOTER.size])
            f.seek(self.index_off)
            blob = f.read(size - _FOOTER.size - len(MAGIC) - self.index_off)
            raw_index, self.bloom = wirepack.unpackb(blob, raw=True)
            self.index: list[tuple[bytes, int]] = [
                (k, off) for k, off in raw_index]
        self._fh = open(path, "rb")

    def close(self) -> None:
        self._fh.close()

    def get(self, key: bytes):
        """Returns value bytes, None (tombstone) or ``_MISS``."""
        if not self.index or not _bloom_maybe(self.bloom, key):
            return _MISS
        # greatest index key <= key
        lo, hi = 0, len(self.index)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.index[mid][0] <= key:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0:
            return _MISS
        off = self.index[lo - 1][1]
        self._fh.seek(off)
        for _ in range(SPARSE):
            if self._fh.tell() >= self.index_off:
                return _MISS
            hdr = self._fh.read(_ENT_HDR.size)
            if len(hdr) < _ENT_HDR.size:
                return _MISS
            klen, vlen = _ENT_HDR.unpack(hdr)
            k = self._fh.read(klen)
            if k == key:
                return None if vlen < 0 else self._fh.read(vlen)
            if k > key:
                return _MISS
            if vlen > 0:
                self._fh.seek(vlen, os.SEEK_CUR)
        return _MISS

    def iter_from(self, start: bytes = b""):
        """Yields (key, value|None) with key >= start, in order."""
        off = 0
        if start and self.index:
            lo, hi = 0, len(self.index)
            while lo < hi:
                mid = (lo + hi) // 2
                if self.index[mid][0] <= start:
                    lo = mid + 1
                else:
                    hi = mid
            if lo > 0:
                off = self.index[lo - 1][1]
        with open(self.path, "rb") as f:
            f.seek(off)
            while f.tell() < self.index_off:
                hdr = f.read(_ENT_HDR.size)
                if len(hdr) < _ENT_HDR.size:
                    return
                klen, vlen = _ENT_HDR.unpack(hdr)
                k = f.read(klen)
                v = None if vlen < 0 else f.read(max(0, vlen))
                if k >= start:
                    yield k, v


class _Miss:
    __slots__ = ()


_MISS = _Miss()


def _merge_runs(segments, drop_tombs: bool, start: bytes = b""):
    """Ordered (key, value) across `segments` (oldest→newest); the newest
    occurrence of a key wins."""
    def source(seg, rank):
        # rank must be bound eagerly (a genexp in the comprehension
        # would close over the loop variable and give every source
        # the same final rank, breaking newest-wins)
        return ((k, rank, v) for k, v in seg.iter_from(start))

    # newer segments get lower rank so heapq pops them first
    sources = [source(seg, rank)
               for rank, seg in enumerate(reversed(segments))]
    last = None
    for k, _rank, v in heapq.merge(*sources):
        if k == last:
            continue
        last = k
        if v is None and drop_tombs:
            continue
        yield k, v


class KvStore:
    kind = "python"

    def __init__(self, kv_dir: str, memtable_max_bytes: int = 8 << 20,
                 compact_threshold: int = 8, fsync: bool = False):
        self.dir = kv_dir
        self.memtable_max = memtable_max_bytes
        self.compact_threshold = compact_threshold
        self.fsync = fsync
        os.makedirs(self.dir, exist_ok=True)
        self.mem: dict[bytes, bytes | None] = {}
        self._mem_bytes = 0
        self._gen = 0
        self._wal = None
        self.segments: list[Segment] = []      # oldest → newest
        self._open()

    # ---------- open / recovery ----------

    def _open(self) -> None:
        segs, wals = [], []
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                os.unlink(os.path.join(self.dir, name))
                continue
            if name.startswith("seg-") and name.endswith(".sst"):
                segs.append((int(name[4:-4]), name))
            elif name.startswith("wal-") and name.endswith(".log"):
                wals.append((int(name[4:-4]), name))
        for gen, name in sorted(segs):
            try:
                self.segments.append(Segment(os.path.join(self.dir, name)))
                self._gen = max(self._gen, gen)
            except ValueError as e:
                log.warning("kvstore: dropping bad segment %s (%s)", name, e)
                os.unlink(os.path.join(self.dir, name))
        for gen, name in sorted(wals):
            self._gen = max(self._gen, gen)
            self._replay_wal(os.path.join(self.dir, name))
        self._wal_paths = [os.path.join(self.dir, n) for _, n in sorted(wals)]

    def _replay_wal(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _WAL_HDR.size <= len(data):
            length, crc = _WAL_HDR.unpack_from(data, off)
            start, end = off + _WAL_HDR.size, off + _WAL_HDR.size + length
            if end > len(data) or zlib.crc32(data[start:end]) != crc:
                log.warning("kvstore wal %s: torn tail at %d, truncating",
                            path, off)
                with open(path, "ab") as f:
                    f.truncate(off)
                break
            for k, v in wirepack.unpackb(data[start:end], raw=True):
                self._mem_put(k, v)
            off = end

    # ---------- writes ----------

    def _mem_put(self, key: bytes, value: bytes | None) -> None:
        new_sz = len(key) + (len(value) if value else 0) + 32
        old = self.mem.get(key, _MISS)
        if old is _MISS:
            self._mem_bytes += new_sz
        else:
            self._mem_bytes += new_sz - (
                len(key) + (len(old) if old else 0) + 32)
        self.mem[key] = value

    def put(self, key: bytes, value: bytes) -> None:
        self.write_batch([(key, value)])

    def delete(self, key: bytes) -> None:
        self.write_batch([(key, None)])

    def write_batch(self, items: list[tuple[bytes, bytes | None]]) -> None:
        """Atomic: one CRC-framed WAL record; recovery applies all or none."""
        if not items:
            return
        payload = wirepack.packb(items, use_bin_type=True)
        fh = self._wal_fh()
        fh.write(_WAL_HDR.pack(len(payload), zlib.crc32(payload)) + payload)
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())
        for k, v in items:
            self._mem_put(k, v)
        if self._mem_bytes >= self.memtable_max:
            self.flush()

    def _wal_fh(self):
        if self._wal is None:
            self._gen += 1
            path = os.path.join(self.dir, f"wal-{self._gen:012d}.log")
            self._wal = open(path, "ab")
            self._wal_paths.append(path)
        return self._wal

    # ---------- flush / compaction ----------

    def flush(self) -> None:
        """Memtable → new segment; WAL dropped; compact when due."""
        if self.mem:
            self._gen += 1
            path = os.path.join(self.dir, f"seg-{self._gen:012d}.sst")
            self._write_segment(path, sorted(self.mem.items()))
            self.segments.append(Segment(path))
            self.mem.clear()
            self._mem_bytes = 0
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        for p in self._wal_paths:
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
        self._wal_paths = []
        if len(self.segments) > self.compact_threshold:
            self._compact_tiered()

    def _write_segment(self, path: str, items) -> None:
        """``items`` is any iterable of sorted (key, value|None) — large
        compactions stream through without materializing the run."""
        import array
        tmp = path + ".tmp"
        index: list[tuple[bytes, int]] = []
        h1s, h2s = array.array("I"), array.array("I")   # bloom prehashes
        with open(tmp, "wb") as f:
            n = 0
            for k, v in items:
                if n % SPARSE == 0:
                    index.append((k, f.tell()))
                h1s.append(zlib.crc32(k))
                h2s.append(zlib.crc32(k, 0x9E3779B9) | 1)
                if v is None:
                    f.write(_ENT_HDR.pack(len(k), -1) + k)
                else:
                    f.write(_ENT_HDR.pack(len(k), len(v)) + k + v)
                n += 1
            index_off = f.tell()
            nbits = (max(64, n * _BLOOM_BITS_PER_KEY) + 7) // 8 * 8
            bits = bytearray(nbits // 8)
            for h1, h2 in zip(h1s, h2s):
                for i in range(_BLOOM_K):
                    b = (h1 + i * h2) % nbits
                    bits[b >> 3] |= 1 << (b & 7)
            f.write(wirepack.packb([[[k, o] for k, o in index], bytes(bits)],
                                  use_bin_type=True))
            f.write(_FOOTER.pack(index_off, n) + MAGIC)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def compact(self) -> None:
        """FULL compaction: merge every segment into one run, dropping
        tombstones (explicit admin/maintenance op). Auto-compaction from
        flush() uses the size-tiered policy instead."""
        if len(self.segments) <= 1:
            return
        self._gen += 1
        path = os.path.join(self.dir, f"seg-{self._gen:012d}.sst")
        self._write_segment(path, self._merged_segments(drop_tombs=True))
        old = self.segments
        self.segments = [Segment(path)]
        for seg in old:
            seg.close()
            os.unlink(seg.path)

    def _compact_tiered(self) -> None:
        """Size-tiered compaction: merge the NEWEST suffix of segments
        whose sizes are comparable (each next-older segment joins while
        it is ≤ 2× the accumulated suffix size). Fresh small flushes fold
        together cheaply while a big old run is left alone — write
        amplification stays logarithmic instead of O(total) per merge.
        Tombstones drop only when the merge covers EVERY segment (a
        partial merge's tombstone may still shadow keys in older runs)."""
        if len(self.segments) <= 1:
            return
        sizes = [os.path.getsize(s.path) for s in self.segments]
        start = len(self.segments) - 1
        acc = sizes[start]
        while start > 0 and sizes[start - 1] <= 2 * acc:
            start -= 1
            acc += sizes[start]
        if start == len(self.segments) - 1:
            start -= 1                     # always merge at least two
        victims = self.segments[start:]
        full = start == 0
        self._gen += 1
        path = os.path.join(self.dir, f"seg-{self._gen:012d}.sst")
        self._write_segment(
            path, _merge_runs(victims, drop_tombs=full))
        self.segments = self.segments[:start] + [Segment(path)]
        for seg in victims:
            seg.close()
            os.unlink(seg.path)

    def _merged_segments(self, drop_tombs: bool, start: bytes = b""):
        """Ordered (key, value) across ALL segments; newest wins."""
        yield from _merge_runs(self.segments, drop_tombs, start)

    # ---------- reads ----------

    def get(self, key: bytes) -> bytes | None:
        if key in self.mem:
            return self.mem[key]
        for seg in reversed(self.segments):
            v = seg.get(key)
            if v is not _MISS:
                return v
        return None

    def scan(self, prefix: bytes = b"", start: bytes | None = None):
        """Yields (key, value) in key order for keys with ``prefix``.
        Memtable shadows segments; tombstones are skipped."""
        lo = start if start is not None else prefix
        mem_items = iter(sorted(
            (k, v) for k, v in self.mem.items() if k >= lo))
        seg_iter = self._merged_segments(drop_tombs=False, start=lo)

        def merged():
            a = next(mem_items, None)
            b = next(seg_iter, None)
            while a is not None or b is not None:
                if b is None or (a is not None and a[0] <= b[0]):
                    if b is not None and a[0] == b[0]:
                        b = next(seg_iter, None)
                    yield a
                    a = next(mem_items, None)
                else:
                    yield b
                    b = next(seg_iter, None)

        for k, v in merged():
            if prefix and not k.startswith(prefix):
                break
            if v is not None:
                yield k, v

    # ---------- misc ----------

    def clear(self) -> None:
        """Drop everything (snapshot install path)."""
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        for seg in self.segments:
            seg.close()
            os.unlink(seg.path)
        self.segments = []
        for p in self._wal_paths:
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
        self._wal_paths = []
        self.mem.clear()
        self._mem_bytes = 0

    @property
    def segment_count(self) -> int:
        return len(self.segments)

    def close(self) -> None:
        self.flush()
        for seg in self.segments:
            seg.close()
