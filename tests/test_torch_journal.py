"""Port parity: the master's journal, snapshots, group commit and retry
cache (``curvine_tpu_torch/common/journal.py``,
``curvine_tpu_torch/master/retry_cache.py``) against the JAX package's,
on the CPU.

Mirrors ``test_journal_replay``, ``test_journal_torn_tail``,
``test_journal_snapshot_interval``, the three
``test_journal_append_batch_*`` tests,
``test_journal_unflushed_append_then_sync``, ``test_retry_cache_dedup``
and ``test_retry_cache_end_to_end`` (tests/test_common.py); holds the
port's frames byte for byte against the reference's on entries that
carry nested maps, bytes and large ints, and each package's segments and
snapshots reopening in the other."""

import asyncio
import os
import struct
import time

import numpy as np
import pytest

from curvine_tpu.common.journal import Journal as JaxJournal
from curvine_tpu.master.retry_cache import RetryCache as JaxRetryCache
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.journal import GroupCommitter, Journal
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.master.retry_cache import RetryCache
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.client.fs_client import FsClient
from curvine_tpu_torch.rpc.codes import RpcCode

# entries of the kinds the master writes, and what its snapshots hold
ENTRIES = [
    ("mkdir", {"path": "/a/b", "create_parent": True, "mode": 0o755,
               "owner": "root", "group": "root", "x_attr": {"k": b"\x00v"}}),
    ("create", {"path": "/a/b/f", "overwrite": False, "create_parent": True,
                "replicas": 1, "block_size": 64 << 20, "mode": 0o644,
                "owner": "root", "group": "root", "client_name": "c" * 32,
                "x_attr": {}, "storage_policy": {
                    "storage_type": 4, "ttl_ms": 0, "ttl_action": 0,
                    "ufs_mtime": 0, "state": 1, "ec": ""},
                "file_type": 1}),
    ("alloc_block", {"inode_id": 3}),
    ("alloc_block", {"inode_id": 3, "abandon": 2 ** 63 - 1}),
    ("commit_blocks", {"inode_id": 3,
                       "commits": [[1, 2 ** 40 + 7], [2, 0]]}),
    ("complete", {"path": "/a/b/f", "length": 2 ** 32 + 1}),
    ("rename", {"src": "/a/b/f", "dst": "/a/g"}),
    ("delete", {"path": "/a", "recursive": True}),
    ("noop", {}),
]
SNAPSHOT = {"next_id": 7, "next_block_id": 2 ** 33, "inodes": [
    {"id": 1, "name": "", "ft": 0, "pid": 0, "mtime": 1_700_000_000_123,
     "atime": -1, "owner": "root", "group": "root", "mode": 0o755,
     "xattr": {"u": "été", "b": b"\xff" * 300}, "sp": {},
     "nlink": 1, "len": 0, "bs": 1 << 26, "rep": 1, "blocks": [],
     "done": True, "target": None, "dir": True, "ch": {"x": 2}}],
    "blocks": [[5, 2 ** 36, 2, 1]], "jobs": [], "ec": [], "deco": []}


def _segment_frames(path):
    """(offset, frame length) of each frame of a segment."""
    data = open(path, "rb").read()
    out, off = [], 0
    while off + 8 <= len(data):
        n, _crc = struct.unpack_from(">II", data, off)
        out.append((off, 8 + n))
        off += 8 + n
    return out


def _only_segment(j):
    segs = [f for f in os.listdir(j.dir) if f.startswith("edits-")]
    assert len(segs) == 1
    return os.path.join(j.dir, segs[0])


# ------------------------------------------------ mirrors of the reference

def test_journal_replay(tmp_path):
    j = Journal(str(tmp_path / "j"))
    for i in range(10):
        j.append("op", {"i": i})
    j.close()

    j2 = Journal(str(tmp_path / "j"))
    snap, entries = j2.recover()
    assert snap is None
    assert [a["i"] for _, _, a, _ in entries] == list(range(10))
    assert j2.seq == 10
    j2.append("op", {"i": 10})
    j2.write_snapshot({"state": "s11"})
    j2.append("op", {"i": 11})
    j2.close()

    j3 = Journal(str(tmp_path / "j"))
    snap, entries = j3.recover()
    assert snap == {"state": "s11"}
    assert [a["i"] for _, _, a, _ in entries] == [11]


def test_journal_torn_tail(tmp_path):
    j = Journal(str(tmp_path / "j"))
    j.append("op", {"i": 0})
    j.append("op", {"i": 1})
    j.close()
    full = _only_segment(j)
    with open(full, "ab") as f:
        f.truncate(os.path.getsize(full) - 3)
    j2 = Journal(str(tmp_path / "j"))
    _, entries = j2.recover()
    assert [a["i"] for _, _, a, _ in entries] == [0]


def test_journal_snapshot_interval(tmp_path):
    """A checkpoint every N entries; the covered segments go."""
    fs = MasterFilesystem(journal=Journal(str(tmp_path)),
                          snapshot_interval=10)
    for i in range(25):
        fs.mkdir(f"/snapdir/d{i}")
    names = os.listdir(tmp_path)
    assert any(n.startswith("snapshot-") for n in names)
    fs2 = MasterFilesystem(journal=Journal(str(tmp_path)))
    fs2.recover()
    for i in range(25):
        assert fs2.tree.resolve(f"/snapdir/d{i}") is not None


def test_journal_append_batch_roundtrip(tmp_path):
    j = Journal(str(tmp_path / "j"))
    j.append("op", {"i": 0})
    seqs = j.append_batch([("op", {"i": 1}), ("op", {"i": 2}),
                           ("op", {"i": 3})])
    assert seqs == [2, 3, 4]
    assert j.seq == 4
    j.append("op", {"i": 4})
    j.close()
    j2 = Journal(str(tmp_path / "j"))
    _, entries = j2.recover()
    assert [a["i"] for _, _, a, _ in entries] == [0, 1, 2, 3, 4]
    assert j2.seq == 5


def test_journal_append_batch_torn_mid_batch(tmp_path):
    """A tear inside a batch replays its whole entries only, and the
    journal appends again right where the tear was cut."""
    j = Journal(str(tmp_path / "j"))
    j.append_batch([("op", {"i": i}) for i in range(4)])
    j.close()
    full = _only_segment(j)
    frames = _segment_frames(full)
    assert len(frames) == 4
    with open(full, "ab") as f:
        f.truncate(frames[2][0] + 5)
    j2 = Journal(str(tmp_path / "j"))
    _, entries = j2.recover()
    assert [a["i"] for _, _, a, _ in entries] == [0, 1]
    assert j2.seq == 2
    j2.append("op", {"i": 99})
    j2.close()
    j3 = Journal(str(tmp_path / "j"))
    _, entries = j3.recover()
    assert [a["i"] for _, _, a, _ in entries] == [0, 1, 99]
    assert j3.seq == 3


def test_journal_append_batch_bad_crc_mid_batch(tmp_path):
    """A corrupt frame inside a batch truncates there: the entries after
    it, of the same batch, are dropped."""
    j = Journal(str(tmp_path / "j"))
    j.append_batch([("op", {"i": i}) for i in range(5)])
    j.close()
    full = _only_segment(j)
    off, flen = _segment_frames(full)[2]
    with open(full, "r+b") as f:
        f.seek(off + flen - 1)
        b = f.read(1)
        f.seek(off + flen - 1)
        f.write(bytes([b[0] ^ 0xFF]))
    j2 = Journal(str(tmp_path / "j"))
    _, entries = j2.recover()
    assert [a["i"] for _, _, a, _ in entries] == [0, 1]
    assert j2.seq == 2


def test_journal_unflushed_append_then_sync(tmp_path):
    j = Journal(str(tmp_path / "j"))
    j.append("op", {"i": 0}, flush=False)
    j.append("op", {"i": 1}, flush=False)
    j.sync()
    j.close()
    j2 = Journal(str(tmp_path / "j"))
    _, entries = j2.recover()
    assert [a["i"] for _, _, a, _ in entries] == [0, 1]


@pytest.mark.parametrize("cls", [RetryCache, JaxRetryCache],
                         ids=["port", "jax"])
def test_retry_cache_dedup(cls):
    """A retried mutation's key gives its first reply; least recently
    used out first; entries expire after the ttl."""
    rc = cls(capacity=3, ttl_ms=10_000)
    rc.put(("c1", 1), b"resp1")
    assert rc.get(("c1", 1)) == b"resp1"
    assert rc.get(("c1", 2)) is None
    rc.put(("c1", 2), b"r2")
    rc.put(("c1", 3), b"r3")
    rc.get(("c1", 1))               # touch 1: the oldest is now 2
    rc.put(("c1", 4), b"r4")
    assert rc.get(("c1", 2)) is None
    assert rc.get(("c1", 1)) == b"resp1"
    rc2 = cls(ttl_ms=0)
    rc2.put(("x", 1), b"v")
    time.sleep(0.01)
    assert rc2.get(("x", 1)) is None


async def test_retry_cache_end_to_end(tmp_path):
    """The same (client_id, call_id) mutation twice: the first reply
    again, applied once, and the journal holds one entry."""
    conf = ClusterConf()
    conf.master.rpc_port = 0
    conf.master.journal_dir = str(tmp_path / "journal")
    m = MasterServer(conf)
    await m.start()
    try:
        conf.client.master_addrs = [m.addr]
        c = FsClient(conf)
        req = {"path": "/dedup", "create_parent": True,
               "client_id": c.client_id, "call_id": 424242}
        rep1 = await c.call(RpcCode.MKDIR, dict(req))
        inodes, seq = m.fs.tree.count(), m.fs.journal.seq
        rep2 = await c.call(RpcCode.MKDIR, dict(req))    # the retry
        assert rep1 == rep2
        assert m.fs.tree.count() == inodes and m.fs.journal.seq == seq
        await c.close()
    finally:
        await m.stop()


# ------------------------------------------------------------ parity

def test_frames_and_snapshots_byte_equal_to_the_reference(tmp_path):
    """The same entries and snapshot give the same files in both
    packages: nested maps, bytes, large and negative ints, non-ASCII."""
    pj, jj = Journal(str(tmp_path / "p")), JaxJournal(str(tmp_path / "j"))
    for op, args in ENTRIES:
        assert pj.append(op, args) == jj.append(op, args)
    assert pj.append_batch(ENTRIES[:3]) == jj.append_batch(ENTRIES[:3])
    pj.write_snapshot(SNAPSHOT)
    jj.write_snapshot(SNAPSHOT)
    pj.append(*ENTRIES[0], flush=False)
    jj.append(*ENTRIES[0], flush=False)
    pj.close()
    jj.close()
    assert sorted(os.listdir(pj.dir)) == sorted(os.listdir(jj.dir))
    for name in os.listdir(pj.dir):
        with open(os.path.join(pj.dir, name), "rb") as a, \
                open(os.path.join(jj.dir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_reopens_in_the_other_package(tmp_path, writer):
    """Segments and a snapshot written by one package recover in the
    other to the same state, entries and seq; a torn tail is cut the
    same way."""
    w_cls, r_cls = (Journal, JaxJournal) if writer == "port" \
        else (JaxJournal, Journal)
    rng = np.random.default_rng(7)
    w = w_cls(str(tmp_path / "j"))
    for i, k in enumerate(rng.integers(0, len(ENTRIES), 40)):
        w.append(*ENTRIES[k])
        if i == 15:
            w.write_snapshot(SNAPSHOT)
    w.close()
    seg = sorted(f for f in os.listdir(w.dir) if f.startswith("edits-"))[-1]
    full = os.path.join(w.dir, seg)
    with open(full, "ab") as f:
        f.truncate(os.path.getsize(full) - 2)
    got = r_cls(str(tmp_path / "j")).recover()
    w2 = w_cls(str(tmp_path / "j"))
    ref = w2.recover()
    assert got == ref
    assert got[0] == SNAPSHOT and len(got[1]) == 40 - 16 - 1
    assert [e[0] for e in got[1]] == list(range(17, 40))


async def test_group_committer_coalesces(tmp_path):
    """Concurrent mutations that await the group barrier share journal
    flushes, and all of them reopen."""
    j = Journal(str(tmp_path / "j"))
    fs = MasterFilesystem(journal=j)
    fs.committer = GroupCommitter(j, window_ms=1.0)
    syncs = []
    real = j.sync

    def counting_sync():
        syncs.append(1)
        real()
    j.sync = counting_sync

    async def one(i):
        fs.mkdir(f"/g/d{i}")
        await fs.committer.sync()

    await asyncio.gather(*(one(i) for i in range(64)))
    assert fs.committer.entries == 64
    assert len(syncs) < 64
    j.close()
    fs2 = MasterFilesystem(journal=Journal(str(tmp_path / "j")))
    fs2.recover()
    assert len(fs2.list_status("/g")) == 64
