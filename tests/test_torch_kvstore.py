"""Port parity: the master's KV metadata store of ``curvine_tpu_torch``
(``common/kvstore.py``, ``common/kvnative.py`` over the port's
``csrc/kv_engine.cc``, ``master/store.py::KvMetaStore``) against the JAX
package's, on the CPU.

Mirrors 14 of the 15 tests of ``tests/test_kvstore.py`` (the Python
engine, and ``MasterFilesystem`` on ``KvMetaStore``, the big namespace
at its 200,000 default; ``test_kv_meta_hard_links`` waits for LINK), the
8 of ``tests/test_kvnative.py`` against the port's native engine, built
by the host compiler, and the two KV group-commit tests of
``tests/test_common.py``. Holds a directory written by each of the four
engines (the JAX package's Python and native engines, the port's two)
opened by the other three with equal scans, the four writing the same
bytes, and the port's codec byte-equal to ``msgpack`` on the WAL batch
and the segment trailer (hypothesis)."""

import asyncio
import os
import random
import resource
import struct
import time
import zlib

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import curvine_tpu.common.kvnative as jax_kvnative
import curvine_tpu.common.kvstore as jax_kvstore
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common import kvnative
from curvine_tpu_torch.common.journal import GroupCommitter, Journal
from curvine_tpu_torch.common.kvstore import KvStore
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.master.store import KvMetaStore
from curvine_tpu_torch.rpc import wirepack


# ---------------- KvStore (tests/test_kvstore.py) ----------------

def test_kv_basic_roundtrip(tmp_path):
    kv = KvStore(str(tmp_path))
    kv.put(b"a", b"1")
    kv.put(b"b", b"2")
    assert kv.get(b"a") == b"1"
    kv.delete(b"a")
    assert kv.get(b"a") is None
    assert kv.get(b"missing") is None
    kv.close()


def test_kv_wal_recovery(tmp_path):
    kv = KvStore(str(tmp_path))
    kv.write_batch([(b"k%d" % i, b"v%d" % i) for i in range(100)])
    del kv                      # no flush: the data is in the WAL only
    kv2 = KvStore(str(tmp_path))
    assert kv2.get(b"k42") == b"v42"
    kv2.close()


def test_kv_torn_wal_tail_truncated(tmp_path):
    kv = KvStore(str(tmp_path))
    kv.put(b"good", b"yes")
    wal = kv._wal_paths[-1]
    kv._wal.flush()
    del kv
    with open(wal, "ab") as f:
        f.write(b"\x00\x00\x00\x10garbage")   # a torn record
    kv2 = KvStore(str(tmp_path))
    assert kv2.get(b"good") == b"yes"
    kv2.close()


def test_kv_flush_segments_and_reopen(tmp_path):
    kv = KvStore(str(tmp_path))
    for i in range(500):
        kv.put(b"key%04d" % i, b"val%d" % i)
    kv.flush()
    assert len(kv.segments) == 1
    assert kv.get(b"key0123") == b"val123"
    # an overwrite and a tombstone in a second run
    kv.put(b"key0123", b"NEW")
    kv.delete(b"key0001")
    kv.flush()
    assert kv.get(b"key0123") == b"NEW"
    assert kv.get(b"key0001") is None
    kv.close()
    kv2 = KvStore(str(tmp_path))
    assert kv2.get(b"key0123") == b"NEW"
    assert kv2.get(b"key0001") is None
    kv2.close()


def test_kv_newest_wins_across_many_segments(tmp_path):
    """A merge of segments takes the newest version of a key."""
    kv = KvStore(str(tmp_path), compact_threshold=100)
    for ver in range(12):
        kv.put(b"counter", b"%04d" % ver)
        kv.put(b"pad%d" % ver, b"x")
        kv.flush()
    assert len(kv.segments) == 12
    assert kv.get(b"counter") == b"0011"
    kv.compact()
    assert len(kv.segments) == 1
    assert kv.get(b"counter") == b"0011"
    kv.close()
    kv2 = KvStore(str(tmp_path))
    assert kv2.get(b"counter") == b"0011"
    kv2.close()


def test_kv_compaction_drops_tombstones(tmp_path):
    kv = KvStore(str(tmp_path), compact_threshold=2)
    for i in range(100):
        kv.put(b"k%03d" % i, b"v")
    kv.flush()
    for i in range(0, 100, 2):
        kv.delete(b"k%03d" % i)
    kv.flush()
    kv.compact()
    assert len(kv.segments) == 1
    assert kv.get(b"k000") is None
    assert kv.get(b"k001") == b"v"
    assert len(list(kv.scan(prefix=b"k"))) == 50
    kv.close()


def test_kv_scan_prefix_and_shadowing(tmp_path):
    kv = KvStore(str(tmp_path))
    kv.put(b"c/1/a", b"ida")
    kv.put(b"c/1/b", b"idb")
    kv.put(b"c/2/a", b"other")
    kv.flush()
    kv.put(b"c/1/b", b"idb2")     # the memtable shadows the segment
    kv.delete(b"c/1/a")           # a memtable tombstone hides it
    assert dict(kv.scan(prefix=b"c/1/")) == {b"c/1/b": b"idb2"}
    kv.close()


def test_kv_no_bloom_false_negatives(tmp_path):
    kv = KvStore(str(tmp_path))
    keys = [b"K:%d" % (i * 7919) for i in range(2000)]
    for k in keys:
        kv.put(k, k[::-1])
    kv.flush()
    for k in keys:
        assert kv.get(k) == k[::-1]
    kv.close()


def test_kv_write_batch_atomic_on_crash(tmp_path):
    kv = KvStore(str(tmp_path))
    kv.write_batch([(b"a", b"1"), (b"b", b"2")])
    wal = kv._wal_paths[-1]
    kv._wal.flush()
    size = os.path.getsize(wal)
    kv.write_batch([(b"a", b"999"), (b"c", b"3")])
    kv._wal.flush()
    del kv
    # a crash cuts the second record: all or nothing
    with open(wal, "ab") as f:
        f.truncate(size + 5)
    kv2 = KvStore(str(tmp_path))
    assert kv2.get(b"a") == b"1"
    assert kv2.get(b"c") is None
    kv2.close()


# ------------- MasterFilesystem on KvMetaStore (tests/test_kvstore.py) ----

def _kv_fs(base, **kw):
    store = KvMetaStore(str(base / "meta"), **kw)
    fs = MasterFilesystem(journal=Journal(str(base / "journal")), store=store)
    fs.recover()
    return fs, store


def test_kv_meta_crud_and_restart(tmp_path):
    fs, store = _kv_fs(tmp_path)
    fs.mkdir("/a/b")
    fs.create_file("/a/b/f1")
    fs.complete_file("/a/b/f1", 10)
    fs.rename("/a/b/f1", "/a/b/f2")
    fs.create_file("/a/b/gone")
    fs.delete("/a/b/gone")
    store.close()
    fs.journal.close()

    fs2, store2 = _kv_fs(tmp_path)
    assert fs2.exists("/a/b/f2")
    assert not fs2.exists("/a/b/f1")
    assert not fs2.exists("/a/b/gone")
    assert fs2.file_status("/a/b/f2").len == 10
    assert [s.name for s in fs2.list_status("/a/b")] == ["f2"]
    store2.close()


def test_kv_meta_restart_skips_applied_entries(tmp_path):
    """A cold start resumes at the store's applied_seq and replays only
    the journal's tail."""
    fs, store = _kv_fs(tmp_path)
    for i in range(50):
        fs.create_file(f"/f{i}")
    applied = store.get_counter("applied_seq")
    assert applied == fs.journal.seq
    store.close()
    fs.journal.close()

    fs2, store2 = _kv_fs(tmp_path)
    assert store2.get_counter("applied_seq") == applied
    assert fs2.recovery["replayed"] == 0
    assert fs2.journal.seq == applied        # new writes continue the seq
    fs2.create_file("/after-restart")
    assert fs2.journal.seq == applied + 1
    store2.close()


def test_kv_meta_failed_apply_keeps_seq_contiguous(tmp_path):
    fs, store = _kv_fs(tmp_path)
    fs.create_file("/plainfile")
    seq_before = fs.journal.seq
    with pytest.raises(err.NotADirectory):
        fs.create_file("/plainfile/child")    # the parent is a file
    # checked before journaling: no seq consumed
    assert fs.journal.seq == seq_before
    fs.create_file("/next")
    assert fs.journal.seq == seq_before + 1
    store.close()


def test_kv_meta_big_namespace_bounded_rss(tmp_path):
    """A namespace far past the inode cache: RSS stays bounded, and a
    restart replays the tail only (N from CURVINE_BIG_NS, 200,000 by
    default, as the reference's test)."""
    n_files = int(os.environ.get("CURVINE_BIG_NS", "200000"))
    per_dir = 1000
    store = KvMetaStore(str(tmp_path / "meta"), cache_inodes=4096,
                        memtable_max_bytes=8 << 20)
    fs = MasterFilesystem(journal=Journal(str(tmp_path / "journal")),
                          store=store, snapshot_interval=100_000)
    fs.recover()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for d in range(n_files // per_dir):
        fs.mkdir(f"/big/d{d:05d}")
        for i in range(per_dir):
            fs.create_file(f"/big/d{d:05d}/f{i:03d}")
    rss_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
              - rss0) / 1024
    assert fs.tree.count() == n_files + n_files // per_dir + 2
    # a dict of Inodes would take ~1 KB a file; the bounded cache and
    # the LSM keep it to the memtable and the caches
    assert rss_mb < 120, f"RSS grew {rss_mb:.0f} MB: namespace not bounded"
    fs.checkpoint()
    store.close()
    fs.journal.close()

    t0 = time.time()
    store2 = KvMetaStore(str(tmp_path / "meta"), cache_inodes=4096)
    fs2 = MasterFilesystem(journal=Journal(str(tmp_path / "journal")),
                           store=store2)
    fs2.recover()
    restart_s = time.time() - t0
    assert restart_s < 5.0, f"restart took {restart_s:.1f}s: not the tail"
    assert fs2.tree.count() == n_files + n_files // per_dir + 2
    mid = (n_files // per_dir) // 2
    assert fs2.file_status(f"/big/d{mid:05d}/f123").name == "f123"
    assert len(fs2.list_status(f"/big/d{mid:05d}")) == per_dir
    store2.close()


def test_kv_meta_delete_leaves_no_orphans(tmp_path):
    """_free_blocks does not save the inode the delete removed (it would
    come back as a durable orphan that lease recovery acts on)."""
    fs, store = _kv_fs(tmp_path)
    fs.create_file("/f")
    fs.complete_file("/f", 3)
    fs.delete("/f")
    for _ in range(3):              # overwrite-creates
        fs.create_file("/g", overwrite=True)
    fs.complete_file("/g", 1)
    ids = sorted(n.id for n in store.iter_inodes())
    live = {fs.tree.root.id, fs.tree.resolve("/g").id}
    assert set(ids) == live, f"orphan inode records: {set(ids) - live}"
    assert fs.tree.count() == len(live)
    store.close()


# ------------- the native engine (tests/test_kvnative.py) ----------------

def _fill(store, n=2000, salt=b""):
    batch = []
    for i in range(n):
        batch.append((b"k%06d%s" % (i, salt), b"v-%d-" % i + b"x" * (i % 97)))
        if len(batch) == 100:
            store.write_batch(batch)
            batch = []
    if batch:
        store.write_batch(batch)


def test_native_basic_ops(tmp_path):
    kv = kvnative.NativeKvStore(str(tmp_path / "kv"))
    kv.put(b"a", b"1")
    kv.put(b"b", b"2")
    kv.delete(b"a")
    assert kv.get(b"a") is None
    assert kv.get(b"b") == b"2"
    assert kv.get(b"nope") is None
    kv.flush()
    assert kv.get(b"b") == b"2"        # from the segment now
    assert kv.get(b"a") is None        # the tombstone in the segment
    kv.put(b"b", b"3")                 # the memtable shadows the segment
    assert kv.get(b"b") == b"3"
    assert list(kv.scan()) == [(b"b", b"3")]
    kv.close()


def test_python_writes_native_reads(tmp_path):
    d = str(tmp_path / "kv")
    py = KvStore(d)
    _fill(py, 3000)
    py.delete(b"k000042")
    py.flush()                          # a segment written by Python
    py.put(b"late", b"wal-only")        # left in the Python WAL
    py._wal.flush()
    # no close: a crash with a segment and a live WAL on disk
    nat = kvnative.NativeKvStore(d)
    assert nat.get(b"k000001") == b"v-1-" + b"x"
    assert nat.get(b"k000042") is None              # the tombstone
    assert nat.get(b"late") == b"wal-only"          # the WAL replayed
    got = list(nat.scan(prefix=b"k00001"))
    assert [k for k, _ in got] == [b"k%06d" % i for i in range(10, 20)]
    nat.close()


def test_native_writes_python_reads(tmp_path):
    d = str(tmp_path / "kv")
    nat = kvnative.NativeKvStore(d)
    _fill(nat, 3000)
    nat.delete(b"k000007")
    nat.flush()                         # a segment written by C++
    nat.put(b"tail", b"in-wal")
    nat.flush()
    nat.put(b"tail2", b"wal-2")
    del nat                             # no close: the WAL remains
    py = KvStore(d)
    assert py.get(b"k000001") == b"v-1-" + b"x"
    assert py.get(b"k000007") is None
    assert py.get(b"tail") == b"in-wal"
    assert py.get(b"tail2") == b"wal-2"
    keys = [k for k, _ in py.scan(prefix=b"k00002")]
    assert keys == [b"k%06d" % i for i in range(20, 30)]
    py.close()


def test_native_torn_wal_truncated(tmp_path):
    d = str(tmp_path / "kv")
    nat = kvnative.NativeKvStore(d)
    nat.put(b"good", b"1")
    del nat                             # leaves the WAL
    wal = [f for f in os.listdir(d) if f.startswith("wal-")][0]
    path = os.path.join(d, wal)
    good_size = os.path.getsize(path)
    with open(path, "ab") as f:         # a torn frame: half a payload
        payload = b"\x93"
        f.write(struct.pack(">II", 100, zlib.crc32(payload)) + payload)
    nat2 = kvnative.NativeKvStore(d)
    assert nat2.get(b"good") == b"1"
    nat2.close()
    # the torn tail was truncated away, as the Python engine does
    assert not os.path.exists(path) or os.path.getsize(path) <= good_size


def test_native_compaction_and_restart(tmp_path):
    d = str(tmp_path / "kv")
    nat = kvnative.NativeKvStore(d, memtable_max_bytes=64 << 10,
                                 compact_threshold=3)
    _fill(nat, 8000)                    # flushes and tiered compactions
    for i in range(0, 8000, 7):
        nat.delete(b"k%06d" % i)
    nat.flush()
    assert nat.segment_count <= 4
    nat.compact()
    assert nat.segment_count == 1
    assert nat.get(b"k000007") is None
    assert nat.get(b"k000008") == b"v-8-" + b"x" * 8
    nat.close()

    py = KvStore(d)                     # the compacted directory
    assert py.get(b"k000014") is None
    assert py.get(b"k000015") == b"v-15-" + b"x" * 15
    n_py = sum(1 for _ in py.scan(prefix=b"k"))
    py.close()
    nat2 = kvnative.NativeKvStore(d)
    n_nat = sum(1 for _ in nat2.scan(prefix=b"k"))
    nat2.close()
    assert n_py == n_nat == 8000 - len(range(0, 8000, 7))


def test_native_scan_semantics_match_python(tmp_path):
    """The same ops on both engines give the same scans (shadowing,
    tombstones, prefix bounds, start offsets)."""
    rng = random.Random(3)
    ops = []
    for i in range(500):
        k = b"p%03d" % rng.randrange(120)
        ops.append((k, None) if rng.random() < 0.25 else (k, b"val%d" % i))

    def drive(store):
        for j in range(0, len(ops), 37):
            store.write_batch(ops[j:j + 37])
            if j == 222:
                store.flush()
        return (list(store.scan(prefix=b"p0")),
                list(store.scan(prefix=b"p", start=b"p05")))

    py = KvStore(str(tmp_path / "py"))
    nat = kvnative.NativeKvStore(str(tmp_path / "nat"))
    assert drive(py) == drive(nat)
    py.close()
    nat.close()


def test_native_scan_grows_for_huge_values(tmp_path):
    """A record larger than the scan buffer streams."""
    nat = kvnative.NativeKvStore(str(tmp_path / "kv"))
    big = b"B" * (3 * 1024 * 1024)        # 3x the 1 MiB scan buffer
    nat.put(b"big", big)
    nat.put(b"sml", b"s")
    nat.flush()
    got = dict(nat.scan())
    assert got[b"big"] == big and got[b"sml"] == b"s"
    nat.close()


def test_native_array32_index_roundtrip(tmp_path):
    """A sparse index past 65,535 entries (4.3M keys at SPARSE 64) keeps
    its msgpack array32 count: a segment written by C++, read back by
    both engines."""
    n = 4_300_000
    nat = kvnative.NativeKvStore(str(tmp_path / "kv"),
                                 memtable_max_bytes=1 << 31)
    step = 200_000
    for lo in range(0, n, step):
        nat.write_batch([(b"k%07d" % i, b"") for i in range(lo, lo + step)])
    nat.flush()
    assert nat.segment_count == 1
    assert nat.get(b"k0000000") == b""
    assert nat.get(b"k%07d" % (n - 1)) == b""
    nat.close()

    nat2 = kvnative.NativeKvStore(str(tmp_path / "kv"))
    assert nat2.get(b"k4200000") == b""    # past the 65,535-entry mark
    assert nat2.get(b"k%07d" % (n - 1)) == b""
    nat2.close()
    py = KvStore(str(tmp_path / "kv"))
    assert py.get(b"k4200007") == b""
    assert py.get(b"k%07d" % (n - 1)) == b""
    py.close()


# ------------- group commit on KV (tests/test_common.py:373-435) ---------

def _kv_fs_python(tmp_path):
    j = Journal(str(tmp_path / "j"))
    fs = MasterFilesystem(journal=j, store=KvMetaStore(str(tmp_path / "kv"),
                                                       engine="python"))
    fs.recover()
    return fs, j


async def test_group_committer_coalesces(tmp_path):
    """Concurrent mutations awaiting the group barrier land in fewer
    journal flushes than ops, and all of them survive a reopen."""
    fs, j = _kv_fs_python(tmp_path)
    fs.committer = GroupCommitter(j, fs.store, window_ms=0.0)

    async def one(i: int):
        fs.mkdir(f"/g{i}")
        await fs.committer.sync()

    await asyncio.gather(*(one(i) for i in range(64)))
    assert fs.committer.entries == 64
    assert fs.committer.groups < 64
    j.close()
    fs.store.close()

    fs2, _ = _kv_fs_python(tmp_path)
    for i in range(64):
        assert fs2.exists(f"/g{i}")


async def test_group_rollback_keeps_earlier_entries(tmp_path):
    """A failed apply in the middle of a group keeps the group's earlier
    staged entries."""
    fs, j = _kv_fs_python(tmp_path)
    fs.committer = GroupCommitter(j, fs.store, window_ms=0.0)
    fs.mkdir("/ok1")
    with pytest.raises(err.CurvineError):
        fs.create_file("/missing/parent/f", create_parent=False)
    fs.mkdir("/ok2")
    await fs.committer.sync()
    assert fs.exists("/ok1") and fs.exists("/ok2")
    j.close()
    fs.store.close()
    fs2, _ = _kv_fs_python(tmp_path)
    assert fs2.exists("/ok1") and fs2.exists("/ok2")
    assert not fs2.exists("/missing")


# ------------- four engines, one format -------------------------------

ENGINES = {
    "jax-python": lambda d, **kw: jax_kvstore.KvStore(d, **kw),
    "jax-native": lambda d, **kw: jax_kvnative.NativeKvStore(d, **kw),
    "port-python": lambda d, **kw: KvStore(d, **kw),
    "port-native": lambda d, **kw: kvnative.NativeKvStore(d, **kw),
}


def _engine_ops(store) -> None:
    """Batches with overwrites and tombstones through two flushes and a
    tiered compaction (memtable 16 KiB, threshold 2), leaving a WAL tail
    that the next open replays."""
    rng = random.Random(11)
    for b in range(40):
        batch = []
        for _ in range(25):
            k = b"%c%04d" % (rng.choice(b"ibcM"), rng.randrange(300))
            batch.append((k, None) if rng.random() < 0.2
                         else (k, bytes(rng.randrange(256)
                                        for _ in range(rng.randrange(40)))))
        store.write_batch(batch)
        if b in (13, 27):
            store.flush()


def _scans(store) -> list:
    return [list(store.scan()), list(store.scan(prefix=b"c")),
            list(store.scan(prefix=b"i", start=b"i0150")),
            [store.get(b"%c%04d" % (c, i)) for c in b"ibcM"
             for i in range(0, 300, 7)]]


@pytest.mark.parametrize("writer,reader", [
    (w, r) for w in sorted(ENGINES) for r in sorted(ENGINES) if w != r])
def test_each_engine_opens_the_others_directory(tmp_path, writer, reader):
    """A directory written by one engine (left open: a segment, a
    compacted run and a WAL tail on disk) opens in each of the other
    three with the writer's scans; the reader's own write reads back in
    the writer."""
    if "jax-native" in (writer, reader):
        assert jax_kvnative.available(), "the JAX package's engine did " \
            "not build"
    d = str(tmp_path / "kv")
    w = ENGINES[writer](d, memtable_max_bytes=16 << 10, compact_threshold=2)
    _engine_ops(w)
    want = _scans(w)
    del w                           # no close: the WAL tail stays
    r = ENGINES[reader](d)
    assert _scans(r) == want
    r.put(b"i9999", b"from the reader")
    r.close()
    w2 = ENGINES[writer](d)
    assert w2.get(b"i9999") == b"from the reader"
    assert len(want[0]) > 50
    w2.close()


def test_four_engines_write_the_same_bytes(tmp_path):
    """The same ops give the same files, byte for byte, in each engine:
    WAL frames, segments and their trailers."""
    files = {}
    for name, make in ENGINES.items():
        d = tmp_path / name
        s = make(str(d), memtable_max_bytes=16 << 10, compact_threshold=2)
        _engine_ops(s)
        del s
        files[name] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    first = files["jax-python"]
    assert any(f.startswith("seg-") for f in first) and \
        any(f.startswith("wal-") for f in first)
    for name, got in files.items():
        assert got == first, name


# ------------- the codec on the KV store's shapes ---------------------

_keys = st.binary(min_size=0, max_size=300)
_values = st.one_of(st.none(), st.binary(min_size=0, max_size=70_000))


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(_keys, _values), max_size=40))
def test_wirepack_wal_batch_equals_msgpack(items):
    """A WAL batch, ``[(key, value|None), ...]``, packs to msgpack's
    bytes and reads back as msgpack reads it."""
    want = msgpack.packb(items, use_bin_type=True)
    assert wirepack.packb(items, use_bin_type=True) == want
    assert wirepack.unpackb(want, raw=True) == \
        msgpack.unpackb(want, raw=True)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(_keys, st.integers(0, (1 << 64) - 1)),
                max_size=20),
       st.integers(0, 70_000), st.sampled_from([0, 15, 16, 65_535, 65_536]))
def test_wirepack_segment_trailer_equals_msgpack(index, nbits, pad):
    """A segment's trailer, ``[[[key, offset], ...], bloom]``, at index
    lengths around the fixarray, array16 and array32 edges."""
    index = [[k, o] for k, o in index] + [[b"k", i] for i in range(pad)]
    blob = [index, bytes(nbits // 8)]
    want = msgpack.packb(blob, use_bin_type=True)
    assert wirepack.packb(blob, use_bin_type=True) == want
    assert wirepack.unpackb(want, raw=True) == \
        msgpack.unpackb(want, raw=True)
