"""The raft snapshot cut and install off the masters' event loops
(``curvine_tpu_torch/master/ha.py``, ``master/store.py``, the engines of
``common/kvstore.py`` and ``csrc/kv_engine.cc``; ROADMAP §C, C10).

- A leader's cut (``MasterFilesystem.snapshot_cut``, on the KV store
  ``KvMetaStore.frozen()``) opens one engine cursor a prefix: its time on
  the loop is held against the namespace's size, 20,000 and 200,000
  inodes, on each engine (the large namespace's records are opaque
  bytes: a cut reads none of them). The small cut's drain on a thread,
  while writes, a flush and a full compaction run on the store, still
  gives the state at the cut: the JAX package's ``_snapshot_state`` over
  a copy of the directory taken at the cut.
- The leader packs in a forked child: a pack that holds the
  interpreter's lock for 0.8 s stalls no loop and starts no election.
- A group on the RAM store installs a chunked snapshot too.
- A follower whose install is slow (its unpack made to take 1.5 s, past
  the 150-300 ms election timeout) keeps answering the leader's beats:
  no election, the term stays, and its loop's longest stall is kept in
  ``raft.install_loop_stall_ms``.
- The native ``kv_scan_open`` copies no memtable item past its prefix.
"""

import asyncio
import os
import shutil
import struct
import threading
import time

import pytest

from curvine_tpu.master.filesystem import MasterFilesystem as JaxFs
from curvine_tpu.master.store import KvMetaStore as JaxKvMetaStore
from curvine_tpu_torch.common import kvnative
from curvine_tpu_torch.common.kvstore import KvStore
from curvine_tpu_torch.common.types import FileType, SetAttrOpts
from curvine_tpu_torch.master import ha
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.master.ha import LEADER
from curvine_tpu_torch.master.inode import ROOT_ID, Inode
from curvine_tpu_torch.master.store import KvMetaStore

from torch_cluster import PortRaftCluster

ENGINES = ["python"] + (["native"] if kvnative.available() else [])
PER_DIR = 1_000


def _fill(fs: MasterFilesystem, n: int, start: int = 0) -> None:
    """``n`` files in directories of PER_DIR, written as the store's
    records (an inode, its entry, a block), committed a batch a
    directory."""
    store = fs.store
    next_id = store.get_counter("next_id", ROOT_ID + 1)
    for d in range(start // PER_DIR, (start + n) // PER_DIR):
        did = next_id
        next_id += 1
        store.put(Inode(id=did, name=f"d{d}", file_type=FileType.DIR,
                        parent_id=ROOT_ID, mtime=1, atime=1,
                        children_num=PER_DIR), new=True)
        store.child_put(ROOT_ID, f"d{d}", did)
        for i in range(PER_DIR):
            fid = next_id
            next_id += 1
            store.put(Inode(id=fid, name=f"f{i}", file_type=FileType.FILE,
                            parent_id=did, mtime=2, atime=2, len=7,
                            blocks=[fid], is_complete=True), new=True)
            store.child_put(did, f"f{i}", fid)
            store.block_put(fid, 7, fid, 1)
        store.set_counter("next_id", next_id)
        store.commit_applied(store.get_counter("applied_seq", 0) + 1)
    store.flush()


def _fill_raw(fs: MasterFilesystem, n: int) -> None:
    """``n`` files' worth of records (an inode, an entry and a block a
    file) under the store's prefixes, as opaque bytes: a cut reads none
    of them, so their number, not their content, is what it could grow
    with. Written through the engine a batch of 30,000 records."""
    batch = []
    for i in range(n):
        k = struct.pack(">Q", 1_000 + i)
        batch += [(b"i" + k, b"\x00" * 80), (b"c" + k + b"f", k),
                  (b"b" + k, b"\x00" * 8)]
        if len(batch) >= 30_000:
            fs.store.kv.write_batch(batch)
            batch = []
    fs.store.kv.write_batch(batch)
    fs.store.flush()


def _cut_ms(fs: MasterFilesystem) -> float:
    """The least of five cuts' times on the calling thread, in ms."""
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        fs.snapshot_cut()
        best = min(best, time.perf_counter() - t)
    return best * 1e3


@pytest.mark.parametrize("engine", ENGINES)
def test_the_cut_does_not_grow_with_the_namespace_and_drains_the_cut(
        tmp_path, engine):
    small = MasterFilesystem(store=KvMetaStore(
        str(tmp_path / "small"), engine=engine))
    _fill(small, 20_000)
    big = MasterFilesystem(store=KvMetaStore(
        str(tmp_path / "big"), engine=engine))
    _fill_raw(big, 200_000)
    small_ms, big_ms = _cut_ms(small), _cut_ms(big)
    # a copy of every record would cost 10x the small cut
    assert big_ms < 2 * small_ms + 2.0, (small_ms, big_ms)
    big.store.close()

    # the state at the cut, by the JAX package, from a copy of the
    # directory taken there
    shutil.copytree(tmp_path / "small", tmp_path / "at_cut")
    cut = small.snapshot_cut()
    # writes, a flush and a full compaction while a thread drains the cut
    got = {}
    drain = threading.Thread(target=lambda: got.update(
        state=small.build_snapshot(cut)))
    drain.start()
    _fill(small, 3_000, start=20_000)
    small.store.remove(ROOT_ID + 2)          # d0/f0 gone after the cut
    small.store.commit_applied(small.store.get_counter("applied_seq") + 1)
    small.store.flush()
    small.store.kv.compact()
    drain.join(120)
    assert not drain.is_alive()
    want = JaxFs(store=JaxKvMetaStore(str(tmp_path / "at_cut"),
                                      engine="python"))._snapshot_state()
    state = got["state"]
    assert len(state["inodes"]) == 1 + 20 + 20_000
    for key in ("next_id", "next_block_id", "inodes", "blocks", "jobs",
                "ec"):
        assert state[key] == want[key], key
    small.store.close()


async def test_a_slow_install_keeps_the_follower_answering_beats(
        tmp_path, monkeypatch):
    """The follower's install runs on a thread: with its unpack made to
    take 1.5 s (a large namespace in the Python codec; the election
    timeout is 150-300 ms here) it answers the leader's beats, starts no
    election, and the term stays."""
    real = ha.RaftLite._state_of_blob

    def slow(parts, crc):
        time.sleep(1.5)
        return real(parts, crc)

    monkeypatch.setattr(ha.RaftLite, "_state_of_blob", staticmethod(slow))
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        c = cl.client()
        for i in range(5):
            await c.meta.mkdir(f"/install/d{i}")
        victim = next(nid for nid in cl.masters
                      if nid != leader.raft.node_id)
        await cl.kill(victim)
        cl.wipe(victim)
        term = leader.raft.term
        elections = {nid: m.metrics.counters.get("raft.elections", 0)
                     for nid, m in cl.masters.items()}
        back = await cl.restart(victim)

        async def installed():
            while back.fs.tree.resolve("/install/d4") is None:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(installed(), 20)
        assert back.metrics.counters.get("raft.snapshot_installs", 0) >= 1
        assert back.raft.term == term and back.raft.role != LEADER
        assert leader.raft.role == LEADER and leader.raft.term == term
        for nid, m in cl.masters.items():
            assert m.metrics.counters.get("raft.elections", 0) == \
                elections.get(nid, 0), f"node {nid} held an election"
        g = back.metrics.gauges
        assert g["raft.install_build_s"] >= 1.5

        async def noted():
            while "raft.install_loop_stall_ms" not in g:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(noted(), 5)
        # on the loop the unpack would have stalled it 1,500 ms
        assert g["raft.install_loop_stall_ms"] < 1000
        # the install took the group's later writes too
        await c.meta.mkdir("/install/after")

        async def caught_up():
            while back.fs.tree.resolve("/install/after") is None:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(caught_up(), 20)


def _gil_bound_n(seconds: float) -> int:
    """The ``n`` for which ``sum(range(n))``, one C call that never
    lets the interpreter's lock go, takes about ``seconds`` here."""
    n = 2_000_000
    t = time.perf_counter()
    sum(range(n))
    return int(n * seconds / max(time.perf_counter() - t, 1e-6))


async def test_a_pack_holding_the_interpreter_lock_stalls_no_loop(
        tmp_path, monkeypatch):
    """The leader packs in a forked child: a pack that holds the
    interpreter's lock for 0.8 s in one call (past the 150-300 ms
    election timeout) stalls no master's loop, so no follower starts an
    election and the term stays. On a thread of the leader's process the
    masters' loops would wait the whole call."""
    real = ha.RaftLite._pack_snapshot
    n = _gil_bound_n(0.8)

    def gil_bound(self, cut):
        sum(range(n))
        return real(self, cut)

    monkeypatch.setattr(ha.RaftLite, "_pack_snapshot", gil_bound)
    async with PortRaftCluster(tmp_path) as cl:
        leader = await cl.wait_leader()
        c = cl.client()
        for i in range(5):
            await c.meta.mkdir(f"/gil/d{i}")
        victim = next(nid for nid in cl.masters
                      if nid != leader.raft.node_id)
        await cl.kill(victim)
        cl.wipe(victim)
        term = leader.raft.term
        elections = {nid: m.metrics.counters.get("raft.elections", 0)
                     for nid, m in cl.masters.items()}
        back = await cl.restart(victim)

        async def installed():
            while back.fs.tree.resolve("/gil/d4") is None:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(installed(), 20)
        assert leader.raft.role == LEADER and leader.raft.term == term
        for nid, m in cl.masters.items():
            assert m.metrics.counters.get("raft.elections", 0) == \
                elections.get(nid, 0), f"node {nid} held an election"
        g = leader.metrics.gauges

        async def noted():
            while "raft.snapshot_pack_s" not in g:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(noted(), 5)
        # the child held the lock about 0.8 s (calibrated in this one)
        assert g["raft.snapshot_pack_s"] >= 0.5
        assert g["raft.snapshot_loop_stall_ms"] < 300


async def test_a_chunked_install_on_the_mem_store(tmp_path):
    """A group on ``meta_store = "mem"`` catches a wiped follower up by a
    chunked snapshot built off the loop into a fresh RAM store, which
    lands nothing in parts."""
    async with PortRaftCluster(tmp_path, meta_store="mem") as cl:
        leader = await cl.wait_leader()
        c = cl.client()
        for i in range(6):
            await c.meta.mkdir(f"/mem/d{i}")
            await c.meta.create_file(f"/mem/d{i}/f")
        victim = next(nid for nid in cl.masters
                      if nid != leader.raft.node_id)
        await cl.kill(victim)
        cl.wipe(victim)
        await c.meta.mkdir("/mem/last")
        leader.raft.snapshot_chunk_bytes = 64 * 1024
        pad = "x" * (256 * 1024)
        await c.meta.set_attr("/mem/d0/f", SetAttrOpts(add_x_attr={
            "pad": pad}))
        back = await cl.restart(victim)

        async def installed():
            while back.fs.tree.resolve("/mem/last") is None:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(installed(), 20)
        assert back.metrics.counters.get("raft.snapshot_installs", 0) >= 1
        assert leader.metrics.counters.get(
            "raft.snapshot_chunks_sent", 0) > 1
        assert back.fs.tree.resolve("/mem/d0/f").x_attr["pad"] == pad
        assert {n.name for n in back.fs.list_status("/mem")} == {
            f"d{i}" for i in range(6)} | {"last"}


@pytest.mark.skipif(not kvnative.available(),
                    reason="the native KV engine does not build here")
def test_native_scan_open_copies_no_memtable_item_past_its_prefix(tmp_path):
    kv = kvnative.NativeKvStore(str(tmp_path / "kv"),
                                memtable_max_bytes=1 << 30)
    keys = {p: [p + struct.pack(">Q", i) for i in range(n)]
            for p, n in ((b"a", 100), (b"b", 7), (b"c", 1_000))}
    kv.write_batch([(k, b"v") for ks in keys.values() for k in ks])
    for prefix, n in ((b"a", 100), (b"b", 7), (b"c", 1_000)):
        cur = kv.scan(prefix=prefix)
        assert cur.mem_items == n, prefix
        assert [k for k, _v in cur] == keys[prefix]
    cur = kv.scan(prefix=b"b", start=b"b" + struct.pack(">Q", 3))
    assert cur.mem_items == 4
    assert len(list(cur)) == 4
    assert kv.scan(prefix=b"").mem_items == 1_107
    kv.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_a_cursor_reads_its_segments_after_a_compaction_unlinks_them(
        tmp_path, engine):
    """A cursor made before a flush and a full compaction reads the
    records as they were when it was made, on either engine."""
    kv = (kvnative.NativeKvStore if engine == "native" else KvStore)(
        str(tmp_path / "kv"), memtable_max_bytes=1 << 30)
    kv.write_batch([(b"a%05d" % i, b"x" * 300) for i in range(1_000)])
    kv.flush()
    kv.write_batch([(b"a%05d" % i, b"z") for i in range(500, 1_500)])
    kv.flush()
    kv.write_batch([(b"a%05d" % i, b"w") for i in range(1_400, 1_600)])
    cur = kv.scan(prefix=b"a")
    kv.write_batch([(b"a00001", None), (b"a00002", b"q")])
    kv.flush()
    kv.compact()
    assert kv.segment_count == 1
    got = dict(cur)
    assert len(got) == 1_600
    assert got[b"a00001"] == got[b"a00002"] == b"x" * 300
    assert sum(v == b"z" for v in got.values()) == 900
    assert sum(v == b"w" for v in got.values()) == 200
    now = dict(kv.scan(prefix=b"a"))
    assert b"a00001" not in now and now[b"a00002"] == b"q"
    kv.close()
