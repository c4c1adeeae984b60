"""Port parity: the cache master of ``curvine_tpu_torch`` (its namespace,
block map, worker plane, journal and RPC server) against the JAX
package's, on the CPU.

Mirrors ``test_mkdir_idempotent_and_nested``,
``test_create_over_dir_rejected``, ``test_delete_recursive_frees_blocks``,
``test_journal_append_failure_keeps_state_consistent`` and
``test_master_handler_normalizes_paths`` (tests/test_namespace.py), and
``test_fs_crud``, ``test_write_read_roundtrip``, ``test_multi_block_file``,
``test_overwrite_and_delete_file``, ``test_master_info_and_capacity``,
``test_journal_restart_recovery`` and
``test_add_block_abandon_no_ghost_blocks`` (tests/test_cluster.py) on the
port's master, worker and client. Holds one seeded op sequence equal in
both packages' ``MasterFilesystem`` (replies, listings, locations,
worker commands, snapshots, and the journal's bytes, with only mtime and
atime masked), each package's journal and snapshots reopening in the
other, a journal op or snapshot section the port does not apply refused
by name, the JAX package's worker and client writing and reading through
the port's master, the port's master, worker and client in subprocesses
that load no module of JAX or of the JAX package, each refused code,
each fixed conf field and a non-superuser refused by name, each
placement policy set in the conf picking the workers its rule names,
worker loss and lease recovery on an injected clock, and METRICS_REPORT
and GET_SPANS served since they left ``MASTER_REFUSED``."""

import asyncio
import copy
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from curvine_tpu.client import CurvineClient as JaxClient
from curvine_tpu.common import errors as jerr
from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu.common.conf import TierConf as JaxTierConf
from curvine_tpu.common.journal import Journal as JaxJournal
from curvine_tpu.common.types import CommitBlock as JaxCommitBlock
from curvine_tpu.master import filesystem as jax_fs_mod
from curvine_tpu.master import inode as jax_inode
from curvine_tpu.master import worker_map as jax_worker_map
from curvine_tpu.master.filesystem import MasterFilesystem as JaxFs
from curvine_tpu.master.store import MemMetaStore as JaxMemStore
from curvine_tpu.worker import WorkerServer as JaxWorker
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import MASTER_FIXED, ClusterConf
from curvine_tpu_torch.common.journal import Journal
from curvine_tpu_torch.common.types import (CommitBlock, StorageInfo,
                                            StorageType, WorkerAddress,
                                            WorkerState)
from curvine_tpu_torch.master import filesystem as port_fs
from curvine_tpu_torch.master import inode as port_inode
from curvine_tpu_torch.master import worker_map as port_worker_map
from curvine_tpu_torch.master.filesystem import (MasterFilesystem,
                                                 UnportedJournalOp)
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.rpc.client import Connection
from curvine_tpu_torch.rpc.codes import MASTER_REFUSED, RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker.server import WorkerServer
from torch_cluster import (BLOCK, MB, _await_live, _client, _cluster,
                           _master_conf, _worker_conf)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WID = 7


def _worker_wire(wid: int = WID, avail: int = 1 << 30) -> dict:
    return {"address": {"worker_id": wid, "hostname": "h",
                        "ip_addr": "10.0.0.1", "rpc_port": 1, "web_port": 0},
            "state": 0, "storages": [{
                "storage_type": 0, "dir_id": "d", "capacity": 1 << 30,
                "available": avail, "block_num": 0, "health": "healthy"}],
            "last_heartbeat_ms": 0, "ici_coords": []}


# ------------------------------------------------ namespace (no RPC)

@pytest.fixture
def fs():
    return MasterFilesystem(journal=None)


def _alloc_and_commit(fs, path, b_len):
    if not fs.workers.workers:
        fs.workers.heartbeat(
            WorkerAddress(worker_id=WID, hostname="h", rpc_port=1),
            [StorageInfo(capacity=1 << 30, available=1 << 30)])
    lb = fs.add_block(path)
    fs._commit(fs.tree.resolve(path), [CommitBlock(
        block_id=lb.block.id, block_len=b_len, worker_ids=[WID],
        storage_type=StorageType.MEM)])
    return fs.get_block_locations(path).block_locs[-1]


def test_mkdir_idempotent_and_nested(fs):
    st1 = fs.mkdir("/a/b/c")
    st2 = fs.mkdir("/a/b/c")
    assert st1.id == st2.id
    assert fs.file_status("/a").children_num == 1
    with pytest.raises(err.FileNotFound):
        fs.mkdir("/x/y", create_parent=False)


def test_create_over_dir_rejected(fs):
    fs.mkdir("/d")
    with pytest.raises(err.IsADirectory):
        fs.create_file("/d")
    fs.create_file("/d/f")
    with pytest.raises(err.FileAlreadyExists):
        fs.mkdir("/d/f")


def test_delete_recursive_frees_blocks(fs):
    fs.create_file("/t/a")
    lb = _alloc_and_commit(fs, "/t/a", b_len=10)
    fs.complete_file("/t/a", 10)
    fs.delete("/t", recursive=True)
    assert fs.blocks.count() == 0
    assert lb.locs[0].worker_id in fs.pending_deletes
    # the holder is told at its next heartbeat, once
    cmds = fs.worker_heartbeat(_worker_wire())
    assert cmds["delete_blocks"] == [lb.block.id]
    assert fs.worker_heartbeat(_worker_wire())["delete_blocks"] == []


def test_journal_append_failure_keeps_state_consistent(tmp_path):
    """Journal first: when the append fails, nothing is applied."""
    j = Journal(str(tmp_path / "j"))
    fsj = MasterFilesystem(journal=j)

    def boom(op, args, **kw):
        raise OSError(28, "No space left on device")
    j.append = boom
    with pytest.raises(OSError):
        fsj.mkdir("/will-not-exist")
    assert not fsj.exists("/will-not-exist")


def test_master_handler_normalizes_paths():
    q = MasterServer._norm_req(
        {"path": "/a/./b/../c", "requests": [{"path": "/x//y/"}]})
    assert q["path"] == "/a/c"
    assert q["requests"][0]["path"] == "/x/y"
    with pytest.raises(err.InvalidPath):
        MasterServer._norm_req({"path": "/../etc"})


# ------------------------------------------------ the cluster, mirrors

async def test_fs_crud(tmp_path):
    async with _cluster(tmp_path) as (m, _ws, conf):
        async with _client(conf) as c:
            await c.meta.mkdir("/a/b/c")
            assert await c.meta.exists("/a/b/c")
            st = await c.meta.file_status("/a/b")
            assert st.is_dir
            assert [s.name for s in await c.meta.list_status("/a")] == ["b"]
            await c.meta.rename("/a/b", "/a/z")
            assert await c.meta.exists("/a/z/c")
            assert not await c.meta.exists("/a/b")
            with pytest.raises(err.DirNotEmpty):
                await c.meta.delete("/a")
            await c.meta.delete("/a", recursive=True)
            assert not await c.meta.exists("/a")
            with pytest.raises(err.FileNotFound):
                await c.meta.file_status("/nope")


async def test_write_read_roundtrip(tmp_path):
    async with _cluster(tmp_path) as (m, _ws, conf):
        async with _client(conf) as c:
            data = os.urandom(3 * MB)
            await c.write_all("/f1", data)
            st = await c.meta.file_status("/f1")
            assert st.len == len(data) and st.is_complete
            r = await c.open("/f1")
            assert await r.read_all() == data
            assert await r.pread(100, 1000) == data[100:1100]
            await r.close()


async def test_multi_block_file(tmp_path):
    async with _cluster(tmp_path) as (m, _ws, conf):
        conf.client.block_size = 1 * MB
        async with _client(conf) as c:
            data = os.urandom(3 * MB + 12345)        # 4 blocks
            await c.write_all("/big", data)
            fb = await c.meta.get_block_locations("/big")
            assert len(fb.block_locs) == 4
            assert sum(b.block.len for b in fb.block_locs) == len(data)
            r = await c.open("/big")
            assert await r.read_all() == data
            assert await r.pread(MB - 10, 20) == data[MB - 10:MB + 10]
            await r.close()


async def test_overwrite_and_delete_file(tmp_path):
    async with _cluster(tmp_path) as (m, _ws, conf):
        async with _client(conf) as c:
            await c.write_all("/x", b"one")
            with pytest.raises(err.FileAlreadyExists):
                await c.meta.create_file("/x")
            await c.write_all("/x", b"two-longer")
            assert await c.read_all("/x") == b"two-longer"
            await c.meta.delete("/x")
            assert not await c.meta.exists("/x")


async def test_master_info_and_capacity(tmp_path):
    async with _cluster(tmp_path, workers=2) as (m, _ws, conf):
        async with _client(conf) as c:
            info = await c.meta.master_info()
            assert len(info.live_workers) == 2
            assert info.capacity > 0 and info.fast_addr == ""
            await c.write_all("/cap", os.urandom(1 * MB))
            info = await c.meta.master_info()
            assert info.block_num >= 1


async def test_journal_restart_recovery(tmp_path):
    async with _cluster(tmp_path) as (m, ws, conf):
        async with _client(conf) as c:
            await c.meta.mkdir("/keep/me")
            data = os.urandom(1 * MB)
            await c.write_all("/keep/f", data)
        await m.stop()
        m2 = MasterServer(conf)
        await m2.start()
        try:
            await _await_live(m2, 1)
            async with _client(conf) as c2:
                assert await c2.meta.exists("/keep/me")
                st = await c2.meta.file_status("/keep/f")
                assert st.len == len(data)
                # the locations come back with the worker's report
                await ws[0].block_report_once()
                assert await c2.read_all("/keep/f") == data
        finally:
            await m2.stop()


async def test_add_block_abandon_no_ghost_blocks(tmp_path):
    """A writer's retry abandons its previous, never-committed block:
    the inode gathers no zero-length ghosts."""
    async with _cluster(tmp_path) as (m, _ws, conf):
        async with _client(conf) as c:
            w = await c.create("/gb/f.bin")
            fs = m.fs
            wid = fs.workers.live_workers()[0].address.worker_id
            b1 = fs.add_block("/gb/f.bin").block.id
            b2 = fs.add_block("/gb/f.bin", abandon_block=b1).block.id
            assert fs.tree.resolve("/gb/f.bin").blocks == [b2]
            assert fs.blocks.get(b1) is None
            # a committed block (len > 0) is never abandoned
            fs.add_block("/gb/f.bin", commit_blocks=[CommitBlock(
                block_id=b2, block_len=7, worker_ids=[wid])],
                abandon_block=b2)
            node = fs.tree.resolve("/gb/f.bin")
            assert b2 in node.blocks and len(node.blocks) == 2
            await w.abort()


# ------------------------------------------------ parity with the reference

def _masked(v):
    """``v`` with every mtime and atime set to 0, and types compared by
    their wire values."""
    if isinstance(v, dict):
        return {k: 0 if k in ("mtime", "atime") else _masked(x)
                for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_masked(x) for x in v]
    if hasattr(v, "to_wire"):
        return _masked(v.to_wire())
    return v


def _one_clock(monkeypatch) -> None:
    """Both packages' master modules read one counter as ``now_ms``,
    stepping by 1 ms at each call. On the wall clock, a worker's
    registration and its full report could fall in one millisecond in
    one package (``report_ms > return_ms`` false: it is asked for a
    report) and in two in the other, whatever the ops."""
    tick = iter(range(1, 1 << 62))

    def now_ms() -> int:
        return next(tick)

    for mod in (jax_worker_map, jax_fs_mod, jax_inode, port_worker_map,
                port_fs, port_inode):
        monkeypatch.setattr(mod, "now_ms", now_ms)


class _Both:
    """One op on both packages' filesystems: the same reply (masked) or
    the same error code. Both read one clock (``_one_clock``)."""

    def __init__(self, root, monkeypatch):
        _one_clock(monkeypatch)
        self.jax = JaxFs(journal=JaxJournal(str(root / "jax")),
                         store=JaxMemStore())
        self.port = MasterFilesystem(journal=Journal(str(root / "port")))

    def __call__(self, name: str, *args, commit=None, **kw):
        out = []
        for fs, cb in ((self.jax, JaxCommitBlock), (self.port, CommitBlock)):
            kws = dict(kw)
            if commit is not None:
                kws["commit_blocks"] = [cb(block_id=b, block_len=n,
                                           worker_ids=[WID])
                                        for b, n in commit]
            try:
                out.append(("ok", _masked(getattr(fs, name)(*args, **kws))))
            except (jerr.CurvineError, err.CurvineError) as e:
                out.append(("error", int(e.code)))
        assert out[0] == out[1], (name, args, kw, out)
        return out[1]


def _walk(fs, path="/"):
    out = [_masked(fs.list_status(path))]
    for st in fs.list_status(path):
        out.append(_masked(fs.get_block_locations(st.path)) if not st.is_dir
                   else _walk(fs, st.path))
    return out


def _drive(both: _Both, seed: int, n_ops: int) -> None:
    """A seeded sequence of the ops the port's master serves."""
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c"]
    both("worker_heartbeat", _worker_wire())
    open_files: dict[str, int | None] = {}      # path -> its last block
    for i in range(n_ops):
        k = rng.integers(0, 8)
        d = "/" + "/".join(rng.choice(names, rng.integers(1, 3)))
        f = f"{d}/f{rng.integers(0, 3)}"
        if k == 0:
            both("mkdir", d, create_parent=bool(rng.integers(0, 4)))
        elif k == 1:
            r = both("create_file", f, overwrite=bool(rng.integers(0, 2)),
                     block_size=BLOCK, client_name="c1")
            if r[0] == "ok":
                open_files[f] = None
        elif k in (2, 3) and open_files:
            f = sorted(open_files)[rng.integers(0, len(open_files))]
            last = open_files[f]
            commit = [(last, int(rng.integers(1, BLOCK)))] if last else None
            if k == 2:
                r = both("add_block", f, client_host="h", commit=commit,
                         abandon_block=last if rng.integers(0, 4) == 0
                         else None)
                if r[0] == "ok":
                    open_files[f] = r[1]["block"]["id"]
            else:
                both("complete_file", f, int(rng.integers(0, 4 * BLOCK)),
                     commit=commit)
                open_files.pop(f)
        elif k == 4:
            src = d if rng.integers(0, 2) else f
            dst = "/" + "/".join(rng.choice(names, rng.integers(1, 3))) + "x"
            both("rename", src, dst)
            open_files = {p: b for p, b in open_files.items()
                          if not p.startswith(src)}
        elif k == 5:
            both("delete", d if rng.integers(0, 2) else f,
                 recursive=bool(rng.integers(0, 2)))
        elif k == 6:
            held = {b: BLOCK for b in range(1, 2 + i // 4)}
            both("worker_block_report", WID, held, {},
                 incremental=bool(rng.integers(0, 2)))
        else:
            both("worker_heartbeat", _worker_wire())
        if i == n_ops // 2:
            both.jax.checkpoint()
            both.port.checkpoint()


def _namespace(fs) -> dict:
    return {"snapshot": _masked(fs._snapshot_state()), "walk": _walk(fs),
            "pending": {w: sorted(b) for w, b in fs.pending_deletes.items()},
            "locs": {b: sorted(locs) for b, locs in fs.blocks.locs.items()}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_ops_equal_in_both_packages(tmp_path, monkeypatch, seed):
    both = _Both(tmp_path, monkeypatch)
    _drive(both, seed, 120)
    assert _namespace(both.jax) == _namespace(both.port)
    # the journals are the same bytes, file for file (no entry carries a
    # time)
    both.jax.journal.close()
    both.port.journal.close()
    jdir, pdir = both.jax.journal.dir, both.port.journal.dir
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for name in os.listdir(jdir):
        if name.startswith("edits-"):
            assert open(os.path.join(jdir, name), "rb").read() == \
                open(os.path.join(pdir, name), "rb").read(), name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_and_snapshot_reopen_in_the_other_package(tmp_path,
                                                         monkeypatch, writer):
    """A journal and snapshot directory written by either package's
    master recovers in the other to the namespace its own package
    recovers (replica locations, and block lengths that only a worker's
    report raised, are runtime state: they come back with the reports)."""
    both = _Both(tmp_path, monkeypatch)
    _drive(both, 5, 120)
    wrote = both.jax if writer == "jax" else both.port
    wrote.journal.close()
    jdir = wrote.journal.dir
    same = (JaxFs(journal=JaxJournal(jdir), store=JaxMemStore())
            if writer == "jax" else
            MasterFilesystem(journal=Journal(jdir)))
    other = (MasterFilesystem(journal=Journal(jdir)) if writer == "jax"
             else JaxFs(journal=JaxJournal(jdir), store=JaxMemStore()))
    same.recover()
    other.recover()
    got = _namespace(other)
    assert got == _namespace(same)
    assert got["locs"] == {} and got["pending"] == {}
    assert _paths(other) == _paths(wrote) and len(_paths(other)) > 3


def _paths(fs, path="/") -> list[str]:
    out = []
    for st in fs.list_status(path):
        out.append(st.path)
        if st.is_dir:
            out += _paths(fs, st.path)
    return out


@pytest.mark.parametrize("op", ["symlink", "link", "resize", "free",
                                "set_incomplete"])
def test_journal_op_the_port_does_not_apply_is_refused(tmp_path, op):
    fs = JaxFs(journal=JaxJournal(str(tmp_path / "j")), store=JaxMemStore())
    fs.create_file("/f")
    fs.complete_file("/f", 0)
    {"symlink": lambda: fs.symlink("/f", "/l"),
     "link": lambda: fs.link("/f", "/h"),
     "resize": lambda: fs.resize_file("/f", 5),
     "free": lambda: fs.free("/f"),
     "set_incomplete": lambda: fs.append_file("/f")}[op]()
    fs.journal.close()
    port = MasterFilesystem(journal=Journal(str(tmp_path / "j")))
    with pytest.raises(UnportedJournalOp, match=f"journal op '{op}'"):
        port.recover()


def test_journal_op_set_attr_is_applied(tmp_path):
    """SET_ATTR's journal op, once refused, is applied: a JAX master's
    set_attr entries reopen in the port's master to the same status."""
    from curvine_tpu.common.types import SetAttrOpts
    fs = JaxFs(journal=JaxJournal(str(tmp_path / "j")), store=JaxMemStore())
    fs.create_file("/f")
    fs.complete_file("/f", 0)
    fs.set_attr("/f", SetAttrOpts(mode=0o600, owner="u", replicas=3,
                                  add_x_attr={"k": b"v"}, ec="rs-2-1"))
    fs.set_attr("/f", SetAttrOpts(group="g", remove_x_attr=["k"]))
    want = _masked(fs.file_status("/f"))
    fs.journal.close()
    port = MasterFilesystem(journal=Journal(str(tmp_path / "j")))
    port.recover()
    got = _masked(port.file_status("/f"))
    assert got == want
    assert (got["mode"], got["owner"], got["group"], got["replicas"],
            got["x_attr"], got["storage_policy"]["ec"]) == \
        (0o600, "u", "g", 3, {}, "rs-2-1")


def test_raft_conf_snapshot_and_entries_are_applied(tmp_path):
    """The raft config, once refused, is applied since the port has raft
    (``master/ha.py``): a JAX master's snapshot with a ``raft_conf``
    section, and its journaled ``raft_conf`` entries after it, reopen in
    the port's master to the same config, which the port's next snapshot
    carries as the JAX package's does."""
    fs = JaxFs(journal=JaxJournal(str(tmp_path / "j")), store=JaxMemStore())
    fs.mkdir("/d")
    fs._log("raft_conf", {"ver": 1, "voters": {"1": "a:1", "2": "b:2"},
                          "learners": {}, "action": "add", "target": 2})
    fs.checkpoint()
    fs._log("raft_conf", {"ver": 2, "voters": {"1": "a:1", "2": "b:2"},
                          "learners": {"3": "c:3"},
                          "action": "add_learner", "target": 3})
    want = fs._snapshot_state()["raft_conf"]
    fs.journal.close()
    port = MasterFilesystem(journal=Journal(str(tmp_path / "j")))
    port.recover()
    assert port.raft_conf == want and want["ver"] == 2
    assert port._snapshot_state()["raft_conf"] == want


@pytest.mark.parametrize("key", ["jobs", "mounts", "deco", "ec"])
def test_snapshot_section_of_mounts_and_jobs_is_applied(tmp_path, key):
    """The sections the port's master now applies: a JAX master's
    snapshot with real mount or job records, or decommission intents,
    reopens in the port's master (its ``MountManager`` attached, as the
    server attaches it) with the same records, and the port's next
    snapshot carries them as the JAX package's does; without a mount
    table a mounts section is refused."""
    from curvine_tpu.common.types import JobInfo as JaxJob
    from curvine_tpu.common.types import JobState as JaxJobState
    from curvine_tpu.master.mount import MountManager as JaxMounts
    from curvine_tpu_torch.master.mount import MountManager
    fs = JaxFs(journal=JaxJournal(str(tmp_path / "j")), store=JaxMemStore())
    fs.mounts = JaxMounts(fs)
    if key == "mounts":
        fs.mounts.mount("/m", "file:///data/m", access_mode="r", replicas=2,
                        ttl_ms=500, ttl_action=1, properties={"k": "v"})
        fs.mounts.mount("/n", "mem://bkt")
    elif key == "deco":
        for wid in (9, 7):
            fs._log("worker_deco", {"worker_id": wid, "on": True})
    elif key == "ec":
        fs.create_file("/f")
        iid = fs.tree.resolve("/f").id
        for _ in range(2):
            bid = fs._log("alloc_block", {"inode_id": iid})
            fs._log("commit_blocks", {"inode_id": iid,
                                      "commits": [[bid, 1000]]})
            fs.ec_plan(bid, "rs-2-1", 2, 1, 500)
            fs.ec_commit(bid, [])
    else:
        for i, state in enumerate((JaxJobState.RUNNING,
                                   JaxJobState.COMPLETED)):
            fs._log("job_put", {"job": JaxJob(
                job_id=f"j{i}", kind="prefetch", path="/ds", state=state,
                create_ms=10 + i, cursor=3, window=2, epoch=1, seed=9,
                total_files=6).to_wire()})
    fs.checkpoint()
    want = _masked(fs._snapshot_state()[key])
    fs.journal.close()
    port = MasterFilesystem(journal=Journal(str(tmp_path / "j")))
    port.mounts = MountManager(port)
    port.recover()
    got = _masked(port._snapshot_state()[key])
    assert got == want and len(got) == 2
    if key == "mounts":
        assert [m.cv_path for m in port.mounts.table()] == ["/m", "/n"]
        assert port.mounts.resolve("/m/a/b") == (
            port.mounts.get_mount("/m"), "file:///data/m/a/b")
        bare = MasterFilesystem(journal=Journal(str(tmp_path / "j")))
        with pytest.raises(UnportedJournalOp, match="mounts"):
            bare.recover()
    elif key == "deco":
        assert port.workers.deco_ids == {7, 9}
        assert list(port.store.iter_deco()) == [7, 9]
    elif key == "ec":
        assert port.ec_stripes == fs.ec_stripes
        assert port.ec_cells == fs.ec_cells and len(port.ec_cells) == 6
    else:
        assert sorted(w["job_id"] for w in port.store.iter_jobs()) == \
            ["j0", "j1"]


async def test_jax_worker_and_client_through_the_port_master(tmp_path):
    """The JAX package's worker registers with the port's master, its
    client writes and reads through them and caches no metadata (no
    lease token); the port's client reads the same bytes."""
    async with _cluster(tmp_path, workers=0) as (m, _ws, conf):
        jconf = JaxConf()
        jconf.client.master_addrs = [m.addr]
        jconf.client.block_size = BLOCK
        wc = copy.deepcopy(jconf)
        wc.worker.hostname, wc.worker.rpc_port = "127.0.0.1", 0
        wc.worker.heartbeat_ms = 200
        wc.worker.tiers = [JaxTierConf(storage_type="mem",
                                       dir=str(tmp_path / "jw"),
                                       capacity=64 * MB)]
        jw = JaxWorker(wc)
        await jw.start()
        try:
            await _await_live(m, 1)
            jc = JaxClient(copy.deepcopy(jconf))
            data = os.urandom(2 * BLOCK + 99)
            await jc.meta.mkdir("/jx/d")
            await jc.write_all("/jx/f", data)
            assert await (await jc.open("/jx/f")).read_all() == data
            assert [s.name for s in await jc.meta.list_status("/jx")] == \
                ["d", "f"]
            assert (await jc.meta.file_status("/jx/f")).len == len(data)
            assert await jc.meta.exists("/jx/d")
            with pytest.raises(jerr.FileNotFound):
                await jc.meta.file_status("/jx/nope")
            if jc.meta.cache is not None:
                assert len(jc.meta.cache) == 0
            info = await jc.meta.master_info()
            assert [w.address.worker_id for w in info.live_workers] == \
                [jw.worker_id] and not info.fast_addr
            async with _client(conf) as c:
                assert await c.read_all("/jx/f") == data
            await jc.meta.delete("/jx", recursive=True)
            await jc.close()
        finally:
            await jw.stop()


_CLIENT = r"""
import asyncio, json, os, sys
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.master.__main__ import jax_free

async def main():
    conf = ClusterConf.load(sys.argv[1])
    data = os.urandom(3 * 1024 * 1024 + 5)
    async with CurvineClient(conf) as c:
        for _ in range(100):
            if (await c.meta.master_info()).live_workers:
                break
            await asyncio.sleep(0.1)
        await c.write_all("/sub/f", data)
        same = await c.read_all("/sub/f") == data
    print(json.dumps({"same": same, "jax_free": jax_free()}))

asyncio.run(main())
"""


def test_port_cluster_in_subprocesses_loads_no_jax(tmp_path):
    """``python -m curvine_tpu_torch.master`` and ``.worker`` and a
    client, each its own process, serve a write and a read, and none
    loads a module of JAX or of the JAX package."""
    mconf = tmp_path / "master.toml"
    mconf.write_text(f"""
[master]
hostname = "127.0.0.1"
rpc_port = 0
journal_dir = "{tmp_path / 'journal'}"
worker_lost_timeout_ms = 30000
""")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []

    def start(mod: str, conf) -> dict:
        p = subprocess.Popen(
            [sys.executable, "-m", f"curvine_tpu_torch.{mod}", "--conf",
             str(conf)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        procs.append(p)
        return json.loads(p.stdout.readline())

    try:
        line = start("master", mconf)
        assert line["jax_free"] is True and line["pid"] == procs[0].pid
        conf = tmp_path / "cluster.toml"
        conf.write_text(f"""
[worker]
hostname = "127.0.0.1"
rpc_port = 0
heartbeat_ms = 200
promote_interval_ms = 0
[[worker.tiers]]
storage_type = "mem"
dir = "{tmp_path / 'mem'}"
capacity = 67108864
[client]
master_addrs = ["{line['addr']}"]
block_size = 1048576
""")
        start("worker", conf)
        out = subprocess.run([sys.executable, "-c", _CLIENT, str(conf)],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1]) == {
            "same": True, "jax_free": True}
        for p in reversed(procs):
            p.terminate()
            assert p.wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                p.wait(timeout=60)
            p.stdout.close()


@pytest.mark.parametrize("code", MASTER_REFUSED, ids=lambda c: c.name)
async def test_refused_code_answers_unsupported_by_name(tmp_path, code):
    async with _cluster(tmp_path, workers=0) as (m, _ws, conf):
        conn = await Connection(m.addr).connect()
        try:
            with pytest.raises(err.Unsupported, match=code.name):
                await conn.call(code, data=pack({"path": "/x"}))
        finally:
            await conn.close()


@pytest.mark.parametrize("code", [RpcCode.SET_ATTR,
                                  RpcCode.EC_COMMIT_STRIPE],
                         ids=lambda c: c.name)
async def test_attr_and_stripe_code_is_served(tmp_path, code):
    """SET_ATTR and EC_COMMIT_STRIPE left MASTER_REFUSED: each gets a
    real answer, journaled, and a bad request its error."""
    assert code not in MASTER_REFUSED
    async with _cluster(tmp_path, workers=0) as (m, _ws, conf):
        c = _client(conf)
        call = c.meta.call
        try:
            await c.meta.create_file("/f")
            if code == RpcCode.SET_ATTR:
                assert await call(code, {"path": "/f", "opts": {
                    "mode": 0o600, "ec": "rs-2-1"}}, mutate=True) == {}
                st = m.fs.file_status("/f")
                assert (st.mode, st.storage_policy.ec) == (0o600, "rs-2-1")
                with pytest.raises(err.InvalidArgument, match="rs-2"):
                    await call(code, {"path": "/f", "opts": {"ec": "rs-2"}},
                               mutate=True)
                with pytest.raises(err.FileNotFound):
                    await call(code, {"path": "/g", "opts": {}}, mutate=True)
            else:
                iid = m.fs.tree.resolve("/f").id
                bid = m.fs._log("alloc_block", {"inode_id": iid})
                m.fs._log("commit_blocks", {"inode_id": iid,
                                            "commits": [[bid, 100]]})
                cells = m.fs.ec_plan(bid, "rs-2-1", 2, 1, 50)
                with pytest.raises(err.InvalidArgument, match="not in"):
                    await call(code, {"block_id": bid, "cells": [
                        {"block_id": 999_999, "worker_id": 7}]}, mutate=True)
                rep = await call(code, {"block_id": bid, "cells": [
                    {"block_id": cid, "worker_id": 7, "storage_type": 1}
                    for cid in cells]}, mutate=True)
                assert rep == {"success": True}
                assert m.fs.ec_stripes[bid]["state"] == "committed"
                assert set(m.fs.blocks.locs[cells[0]]) == {7}
                assert m.metrics.counters["ec.stripes_committed"] == 1
        finally:
            await c.close()


@pytest.mark.parametrize("code", [RpcCode.METRICS_REPORT,
                                  RpcCode.GET_SPANS], ids=lambda c: c.name)
async def test_metrics_and_spans_code_is_served(tmp_path, code):
    """METRICS_REPORT and GET_SPANS left MASTER_REFUSED: on a raw
    connection a report's counters land as ``client.<name>`` and its
    spans in the master's store, and GET_SPANS answers them (with
    ``collect``, the worker's spans too)."""
    assert code not in MASTER_REFUSED
    async with _cluster(tmp_path, workers=1) as (m, ws, conf):
        span = {"trace_id": "t1", "span_id": 5, "parent": 0,
                "component": "client", "op": "read", "start": 1.0,
                "dur": 0.5, "status": "ok", "attrs": {}}
        ws[0].tracer.store.append({**span, "span_id": 7, "parent": 5,
                                   "component": "worker"})
        conn = await Connection(m.addr).connect()
        try:
            if code == RpcCode.METRICS_REPORT:
                for _ in range(2):
                    rep = unpack((await conn.call(code, data=pack({
                        "counters": {"read.zero_copy_bytes": 4096},
                        "spans": [span]}))).data)
                    assert rep == {}
                assert m.metrics.counters["client.read.zero_copy_bytes"] \
                    == 8192
                assert m.tracer.spans_for("t1") == [span, span]
            else:
                m.tracer.ingest([span])
                rep = unpack((await conn.call(code, data=pack({
                    "trace_id": "t1"}))).data)
                assert rep == {"spans": [span]}
                rep = unpack((await conn.call(code, data=pack({
                    "trace_id": "t1", "collect": True}))).data)
                assert sorted(s["span_id"] for s in rep["spans"]) == [5, 7]
                rep = unpack((await conn.call(code, data=pack({
                    "trace_id": "none", "collect": True}))).data)
                assert rep == {"spans": []}
        finally:
            await conn.close()


async def test_decommission_code_is_served(tmp_path):
    """DECOMMISSION_WORKER left MASTER_REFUSED: on a raw connection it
    answers the worker's state, journals the intent, and names an unknown
    worker WorkerNotFound."""
    assert RpcCode.DECOMMISSION_WORKER not in MASTER_REFUSED
    async with _cluster(tmp_path, workers=1) as (m, ws, conf):
        wid = ws[0].worker_id
        conn = await Connection(m.addr).connect()
        try:
            rep = unpack((await conn.call(
                RpcCode.DECOMMISSION_WORKER,
                data=pack({"worker_id": wid}))).data)
            assert rep == {"state": int(WorkerState.DECOMMISSIONING)}
            assert list(m.fs.store.iter_deco()) == [wid]
            rep = unpack((await conn.call(
                RpcCode.DECOMMISSION_WORKER,
                data=pack({"worker_id": wid, "on": False}))).data)
            assert rep == {"state": int(WorkerState.LIVE)}
            assert list(m.fs.store.iter_deco()) == []
            with pytest.raises(err.WorkerNotFound):
                await conn.call(RpcCode.DECOMMISSION_WORKER,
                                data=pack({"worker_id": 999_999}))
        finally:
            await conn.close()


MOUNT_AND_JOB_CODES = (
    RpcCode.MOUNT, RpcCode.UNMOUNT, RpcCode.UPDATE_MOUNT,
    RpcCode.GET_MOUNT_TABLE, RpcCode.GET_MOUNT_INFO, RpcCode.SUBMIT_JOB,
    RpcCode.GET_JOB_STATUS, RpcCode.CANCEL_JOB, RpcCode.PREFETCH_WINDOW,
    RpcCode.REPORT_TASK)


@pytest.mark.parametrize("code", MOUNT_AND_JOB_CODES, ids=lambda c: c.name)
async def test_mount_and_job_code_is_served(tmp_path, code):
    """The ten codes taken out of MASTER_REFUSED each get a real answer
    from the port's master (the mount table, the job manager)."""
    from curvine_tpu_torch.common.types import JobState, TaskInfo
    ufs = tmp_path / "u"
    ufs.mkdir()
    (ufs / "a.bin").write_bytes(b"a" * 10)
    async with _cluster(tmp_path, workers=0) as (m, _ws, conf):
        c = _client(conf)
        call = c.meta.call
        try:
            if code != RpcCode.MOUNT:
                await c.meta.mount("/m", f"file://{ufs}")
            if code == RpcCode.MOUNT:
                rep = await call(code, {"cv_path": "/m",
                                        "ufs_path": f"file://{ufs}/",
                                        "access_mode": "r"}, mutate=True)
                assert rep["mount"]["ufs_path"] == f"file://{ufs}"
                assert [x.cv_path for x in m.mounts.table()] == ["/m"]
                assert m.fs.file_status("/m").is_dir
            elif code == RpcCode.UNMOUNT:
                assert await call(code, {"cv_path": "/m"}, mutate=True) == {}
                assert m.mounts.table() == []
                with pytest.raises(err.MountNotFound):
                    await call(code, {"cv_path": "/m"}, mutate=True)
            elif code == RpcCode.UPDATE_MOUNT:
                rep = await call(code, {"cv_path": "/m", "access_mode": "r",
                                        "auto_cache": True}, mutate=True)
                assert (rep["mount"]["access_mode"],
                        rep["mount"]["auto_cache"]) == ("r", True)
            elif code == RpcCode.GET_MOUNT_TABLE:
                rep = await call(code, {})
                assert [x["cv_path"] for x in rep["mounts"]] == ["/m"]
            elif code == RpcCode.GET_MOUNT_INFO:
                rep = await call(code, {"path": "/m/a.bin"})
                assert rep["mount"]["cv_path"] == "/m"
                assert (await call(code, {"path": "/x"}))["mount"] is None
            elif code == RpcCode.SUBMIT_JOB:
                rep = await call(code, {"kind": "load", "path": "/m"},
                                 mutate=True)
                assert m.jobs.jobs[rep["job_id"]].kind == "load"
                rep = await call(code, {"kind": "ec_convert", "path": "/m"},
                                 mutate=True)
                assert m.jobs.jobs[rep["job_id"]].kind == "ec_convert"
                with pytest.raises(err.Unsupported, match="restore"):
                    await call(code, {"kind": "restore", "path": "/m"},
                               mutate=True)
            elif code == RpcCode.GET_JOB_STATUS:
                jid = await c.meta.submit_load("/m")
                rep = await call(code, {"job_id": jid})
                assert (rep["job"]["job_id"], rep["job"]["kind"]) == \
                    (jid, "load")
                with pytest.raises(err.JobNotFound):
                    await call(code, {"job_id": "nope"})
            elif code == RpcCode.CANCEL_JOB:
                jid = await c.meta.submit_load("/m")
                assert await call(code, {"job_id": jid}, mutate=True) == {}
                assert m.jobs.jobs[jid].state == JobState.CANCELLED
            elif code == RpcCode.PREFETCH_WINDOW:
                rep = await call(code, {"path": "/m", "window": 2},
                                 mutate=True)
                assert m.jobs._prefetch[("/m", 0)] == rep["job_id"]
                assert (rep["cursor"], rep["window"]) == (0, 2)
            else:
                job = m.jobs.submit("load", "/m")
                for _ in range(200):
                    if job.tasks:
                        break
                    await asyncio.sleep(0.01)
                t = job.tasks[0]
                done = TaskInfo(task_id=t.task_id, job_id=job.job_id,
                                path=t.path, state=JobState.COMPLETED,
                                loaded_len=10)
                assert await call(code, {"task": done.to_wire()}) == {}
                assert job.state == JobState.COMPLETED
                done.job_id = "nope"
                with pytest.raises(err.JobNotFound):
                    await call(code, {"task": done.to_wire()})
        finally:
            await c.close()


@pytest.mark.parametrize("code", [RpcCode.REQUEST_REPLACEMENT_WORKER,
                                  RpcCode.REPORT_BLOCK_REPLICATION_RESULT],
                         ids=lambda c: c.name)
async def test_replication_code_is_served(tmp_path, code):
    """The two codes taken out of MASTER_REFUSED are served: a
    replacement worker off the block's holders, and a pull's result
    handed to the replication manager."""
    async with _cluster(tmp_path, workers=2) as (m, ws, conf):
        c = _client(conf)
        await c.write_all("/r.bin", b"r" * 100)
        fb = await c.meta.get_block_locations("/r.bin")
        await c.close()
        bid, holder = fb.block_locs[0].block.id, fb.block_locs[0].locs[0]
        other = next(w.worker_id for w in ws
                     if w.worker_id != holder.worker_id)
        conn = await Connection(m.addr).connect()
        try:
            if code == RpcCode.REQUEST_REPLACEMENT_WORKER:
                rep = unpack((await conn.call(code, data=pack(
                    {"block_id": bid}))).data)
                assert rep["worker"]["worker_id"] == other
                with pytest.raises(err.NoAvailableWorker):
                    await conn.call(code, data=pack(
                        {"block_id": bid, "exclude_workers": [other]}))
            else:
                rep = await conn.call(code, data=pack({
                    "block_id": bid, "worker_id": other, "success": True,
                    "via": "ici"}))
                assert unpack(rep.data) == {}
                assert m.metrics.counters["replication.ici_transfers"] == 1
                await conn.call(code, data=pack({
                    "block_id": bid, "worker_id": other, "success": False,
                    "message": "boom"}))
        finally:
            await conn.close()


@pytest.mark.parametrize("key", sorted(MASTER_FIXED) + [
    "meta_store", "meta_engine", "block_placement_policy"])
def test_fixed_master_field_is_refused(tmp_path, key):
    other = {"meta_store": "rocks", "meta_engine": "rocksdb",
             "block_placement_policy": "nearest"}.get(key)
    if other is None:
        v = MASTER_FIXED[key]
        other = (not v if isinstance(v, bool) else ["x"] if isinstance(v, list)
                 else v + 1 if isinstance(v, int) else v + "x")
    f = tmp_path / "c.toml"
    f.write_text(f"[master]\n{key} = {json.dumps(other)}\n")
    with pytest.raises(ValueError, match=f"master.{key}"):
        ClusterConf.load(str(f))
    if key == "meta_store":
        # both of the reference's stores load; "kv" is the default
        for store in ("kv", "mem"):
            f.write_text(f"[master]\nmeta_store = \"{store}\"\n")
            assert ClusterConf.load(str(f)).master.meta_store == store
        assert ClusterConf().master.meta_store == "kv"
    f.write_text(f"[master]\nrpc_port = 1234\nsuperuser = \"alice\"\n"
                 f"worker_lost_timeout_ms = 5\n")
    mc = ClusterConf.load(str(f)).master
    assert (mc.rpc_port, mc.superuser, mc.worker_lost_timeout_ms) == \
        (1234, "alice", 5)


RAFT_FIELDS = [("raft_peers", ["127.0.0.1:1", "127.0.0.1:2"]),
               ("raft_node_id", 2), ("raft_learner", True)]


@pytest.mark.parametrize("key,value", RAFT_FIELDS,
                         ids=[k for k, _ in RAFT_FIELDS])
def test_raft_master_field_is_honoured(tmp_path, key, value):
    """A node's own raft settings are fields: each loads from the cluster
    file (the reference's defaults otherwise) and reaches the master's
    ``RaftLite``, whose tuning knobs are ``MASTER_FIXED``'s values; with
    no ``raft_peers`` the master runs without raft."""
    assert key not in MASTER_FIXED
    f = tmp_path / "c.toml"
    peers = value if key == "raft_peers" else ["127.0.0.1:1", "127.0.0.1:2",
                                               "127.0.0.1:3"]
    f.write_text(f"[master]\njournal_dir = \"{tmp_path / 'journal'}\"\n"
                 f"raft_peers = {json.dumps(peers)}\n"
                 + (f"{key} = {json.dumps(value)}\n"
                    if key != "raft_peers" else ""))
    conf = ClusterConf.load(str(f))
    assert getattr(conf.master, key) == value
    defaults = ClusterConf().master
    assert (defaults.raft_peers, defaults.raft_node_id,
            defaults.raft_learner) == ([], 1, False)
    m = MasterServer(conf)
    try:
        r = m.raft
        me = conf.master.raft_node_id
        got = {"raft_peers": sorted([*r.peers.values(), r._addr_of(me)]),
               "raft_node_id": r.node_id,
               "raft_learner": me in r.learners}[key]
        assert got == (sorted(value) if key == "raft_peers" else value)
        assert (r.promote_lag, r.snapshot_chunk_bytes >> 20,
                r.transfer_timeout_s * 1000) == (
            MASTER_FIXED["raft_promote_lag"],
            MASTER_FIXED["raft_snapshot_chunk_mb"],
            MASTER_FIXED["raft_transfer_timeout_ms"]) == (64, 4, 5_000)
        assert m.fs.on_mutation == r.on_mutation
    finally:
        m.fs.journal.close()
        m.fs.store.close()
    single = MasterServer(_master_conf(tmp_path / "one"))
    try:
        assert single.raft is None and single.fs.on_mutation is None
    finally:
        single.fs.journal.close()
        single.fs.store.close()


@pytest.mark.parametrize("code", [RpcCode.RAFT_MEMBER_CHANGE,
                                  RpcCode.RAFT_TRANSFER],
                         ids=lambda c: c.name)
async def test_raft_admin_code_is_served(tmp_path, code):
    """RAFT_MEMBER_CHANGE and RAFT_TRANSFER left MASTER_REFUSED: a
    master without raft answers that raft is not enabled (as the
    reference's does); a one-node raft master journals a membership
    change and refuses a transfer with no other voter."""
    assert code not in MASTER_REFUSED
    req = ({"action": "add", "node_id": 2, "addr": "127.0.0.1:2"}
           if code == RpcCode.RAFT_MEMBER_CHANGE else {"target": None})
    async with _cluster(tmp_path / "one", workers=0) as (m, _ws, conf):
        c = _client(conf)
        try:
            with pytest.raises(err.Unsupported, match="raft is not enabled"):
                await c.meta.call(code, req, mutate=True)
        finally:
            await c.close()
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    conf = _master_conf(tmp_path / "raft", rpc_port=port,
                        raft_peers=[f"127.0.0.1:{port}"])
    m = MasterServer(conf)
    await m.start()
    try:
        async def elected():
            while not m.raft.is_leader:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(elected(), 15)
        conf.client.master_addrs = [m.addr]
        c = _client(conf)
        try:
            if code == RpcCode.RAFT_MEMBER_CHANGE:
                rep = await c.meta.raft_member_change(
                    "add", 2, "127.0.0.1:2")
                assert (rep["ver"], rep["learners"]) == \
                    (1, {"2": "127.0.0.1:2"})
                assert m.fs.raft_conf["action"] == "add_learner"
                assert m.raft.learners == {2: "127.0.0.1:2"}
            else:
                with pytest.raises(err.InvalidArgument,
                                   match="no other voter"):
                    await c.meta.raft_transfer()
            st = await c.meta.raft_status()
            assert (st["role"], st["node_id"]) == ("leader", 1)
        finally:
            await c.close()
    finally:
        await m.stop()


@pytest.mark.parametrize("key,value", [("replication_pull_budget_ms", 1234),
                                       ("ici_mesh_shape", [4, 2])])
def test_replication_master_field_is_honoured(tmp_path, key, value):
    """The fields taken out of MASTER_FIXED load and reach the master:
    the replication manager's pull budget, the placement's torus."""
    f = tmp_path / "c.toml"
    f.write_text(f"[master]\njournal_dir = \"{tmp_path / 'journal'}\"\n"
                 f"block_placement_policy = \"ici\"\n"
                 f"{key} = {json.dumps(value)}\n")
    conf = ClusterConf.load(str(f))
    assert getattr(conf.master, key) == value
    m = MasterServer(conf)
    try:
        got = {"replication_pull_budget_ms": m.replication.pull_budget_ms,
               "ici_mesh_shape": m.fs.policy.mesh_shape}[key]
        assert got == value and m.fs.policy.name == "ici"
        if key == "ici_mesh_shape":     # the 4-axis wraps: 0 -> 3 is 1 hop
            a, b = _worker_wire(1), _worker_wire(2)
            a["ici_coords"], b["ici_coords"] = [0, 0], [3, 0]
            m.fs.worker_heartbeat(a)
            m.fs.worker_heartbeat(b)
            ws = m.fs.workers.workers
            assert m.fs.policy.worker_distance(ws[1], ws[2]) == 1
    finally:
        m.fs.journal.close()


# worker id -> (hostname, capacity, available): worker 1 is the least
# loaded (all of its GiB free), worker 2 has the most bytes free (half of
# its TiB), worker 3 sits on the client's host
PLACEMENT_WORKERS = {1: ("h1", 1 << 30, 1 << 30),
                     2: ("h2", 1 << 40, 1 << 39),
                     3: ("h3", 4 << 30, 2 << 30)}


@pytest.mark.parametrize("policy", ["local", "random", "robin", "weighted",
                                    "load", "ici"])
def test_placement_policy_chosen_through_the_conf(tmp_path, policy):
    """Each ``block_placement_policy`` the port takes, set in the TOML
    file, picks the workers its rule names for 30 one-replica blocks."""
    f = tmp_path / "c.toml"
    f.write_text(f"[master]\njournal_dir = \"{tmp_path / 'journal'}\"\n"
                 f"block_placement_policy = \"{policy}\"\n")
    m = MasterServer(ClusterConf.load(str(f)))
    try:
        for wid, (host, cap, avail) in PLACEMENT_WORKERS.items():
            w = _worker_wire(wid, avail)
            w["address"]["hostname"] = host
            w["storages"][0]["capacity"] = cap
            m.fs.worker_heartbeat(w)
        random.seed(0)
        picks = []
        for i in range(30):
            m.fs.create_file(f"/f{i}")
            lb = m.fs.add_block(f"/f{i}", client_host="h3")
            picks.append([a.worker_id for a in lb.locs])
    finally:
        m.fs.journal.close()
    assert all(len(p) == 1 for p in picks)
    picks = [p[0] for p in picks]
    if policy in ("local", "ici"):    # ici: the writer's host is nearest
        assert set(picks) == {3}
    elif policy == "random":
        assert set(picks) == {1, 2, 3}
    elif policy == "robin":
        assert picks == [1, 2, 3] * 10
    elif policy == "weighted":       # 512 GiB of 515 GiB free: worker 2
        assert picks.count(2) >= 27 and set(picks) <= {1, 2, 3}
    else:                            # load: the largest free share
        assert set(picks) == {1}


async def test_only_the_superuser_is_served(tmp_path):
    async with _cluster(tmp_path, workers=0) as (m, _ws, conf):
        c = _client(conf)
        req = {"path": "/p", "create_parent": True}
        c.meta.user, c.meta.groups = "alice", ["alice"]
        for code in (RpcCode.MKDIR, RpcCode.FILE_STATUS, RpcCode.EXISTS,
                     RpcCode.LIST_STATUS, RpcCode.GET_BLOCK_LOCATIONS):
            with pytest.raises(err.PermissionDenied, match="alice"):
                await c.meta.call(code, req, mutate=True)
        rep = await c.meta.meta_batch([{"op": "mkdir", "path": "/p"}])
        assert rep[0]["error_code"] == int(err.ErrorCode.PERMISSION_DENIED)
        assert not m.fs.exists("/p")
        c.meta.groups = ["alice", "supergroup"]      # the supergroup passes
        await c.meta.mkdir("/p")
        c.meta.user, c.meta.groups = "", []          # no user: root
        assert await c.meta.exists("/p")
        await c.close()


# ------------------------------------------------ worker plane

def test_worker_loss_and_return_on_an_injected_clock(monkeypatch):
    now = [1_000_000]
    monkeypatch.setattr(port_worker_map, "now_ms", lambda: now[0])
    fs = MasterFilesystem(journal=None, lost_timeout_ms=30_000)
    fs.create_file("/f")
    lb = _alloc_and_commit(fs, "/f", 10)
    assert fs.worker_block_report(WID, {lb.block.id: 10}, {}) == {
        "delete_blocks": []}
    now[0] += 30_000
    assert fs.check_lost_workers() == []
    now[0] += 1
    lost = fs.check_lost_workers()
    assert [w.address.worker_id for w in lost] == [WID]
    assert fs.workers.workers[WID].state == WorkerState.LOST
    assert fs.get_block_locations("/f").block_locs[0].locs == []
    assert fs.master_info().lost_workers[0].address.worker_id == WID
    now[0] += 1
    cmds = fs.worker_heartbeat(_worker_wire())
    assert fs.workers.workers[WID].state == WorkerState.LIVE
    assert cmds["report_now"] is True
    now[0] += 1
    fs.worker_block_report(WID, {lb.block.id: 10, 999: 1}, {})
    assert "report_now" not in fs.worker_heartbeat(_worker_wire())
    assert len(fs.get_block_locations("/f").block_locs[0].locs) == 1


@pytest.mark.parametrize("via", ["commit", "incremental"])
def test_full_report_built_before_a_replica_landed_keeps_it(via):
    """A worker's full report built before a block landed on it, applied
    after the block was located there (by the client's commit or by the
    worker's incremental report), keeps the block's location: the
    reference drops it, and the block then has no live location until
    the worker's next full report (ROADMAP §C, C15). The next full
    report is built after the landing: without the block, it drops it."""
    fs = MasterFilesystem(journal=None)
    fs.create_file("/f", block_size=BLOCK)
    first = _alloc_and_commit(fs, "/f", 10).block.id
    fs.worker_block_report(WID, {first: 10}, {})
    before = {first: 10}                 # built now, applied below
    bid = fs.add_block("/f").block.id
    if via == "commit":
        fs._commit(fs.tree.resolve("/f"), [CommitBlock(
            block_id=bid, block_len=10, worker_ids=[WID],
            storage_type=StorageType.MEM)])
    else:
        fs._commit(fs.tree.resolve("/f"), [CommitBlock(
            block_id=bid, block_len=10, worker_ids=[],
            storage_type=StorageType.MEM)])
        fs.worker_block_report(WID, {bid: 10}, {}, incremental=True)
    assert fs.worker_block_report(WID, before, {}) == {"delete_blocks": []}
    locs = [lb.locs for lb in fs.get_block_locations("/f").block_locs]
    assert [[a.worker_id for a in x] for x in locs] == [[WID], [WID]]
    assert fs.report_kept == 1
    fs.worker_block_report(WID, before, {})
    assert fs.report_kept == 1
    locs = [lb.locs for lb in fs.get_block_locations("/f").block_locs]
    assert [[a.worker_id for a in x] for x in locs] == [[WID], []]


def test_stale_leases_recovered_on_an_injected_clock(monkeypatch):
    now = [5_000_000]
    monkeypatch.setattr(port_fs, "now_ms", lambda: now[0])
    fs = MasterFilesystem(journal=None)
    fs.create_file("/empty")
    fs.create_file("/partial")
    _alloc_and_commit(fs, "/partial", 77)
    now[0] += 300_000
    assert fs.recover_stale_leases() == 0
    now[0] += 1
    assert fs.recover_stale_leases() == 2
    assert not fs.exists("/empty")
    st = fs.file_status("/partial")
    assert st.is_complete and st.len == 77


async def test_heartbeat_fields_and_corrupt_reports(tmp_path):
    async with _cluster(tmp_path, workers=0) as (m, _ws, conf):
        # what the replication manager is handed (unknown blocks leave
        # its evacuations at once, so the calls are recorded)
        evacuated = []
        real = m.replication.enqueue_evacuation
        m.replication.enqueue_evacuation = lambda wid, bids: (
            evacuated.append((wid, list(bids))), real(wid, bids))
        conn = await Connection(m.addr).connect()
        try:
            rep = await conn.call(RpcCode.WORKER_HEARTBEAT, data=pack({
                "info": _worker_wire(), "hbm_blocks": [1, 2],
                "evac_blocks": [3], "metrics": {"bytes.read": 5,
                                                "bytes.written": 6}}))
            assert unpack(rep.data) == {"delete_blocks": [],
                                        "report_now": True}
            assert m.metrics.gauges["bytes.written"] == 6
            rep = await conn.call(RpcCode.REPORT_UNDER_REPLICATED_BLOCKS,
                                  data=pack({"worker_id": WID,
                                             "block_ids": [11, 12],
                                             "confirm_live": [WID, 8]}))
            assert unpack(rep.data) == {"success": True, "live": [WID]}
            # the heartbeat's tier-0 advertisement and the reported
            # replicas are the replication manager's soft state
            assert m.replication._hbm_blocks == {WID: {1, 2}}
            assert evacuated == [(WID, [3]), (WID, [11, 12])]
            assert m.metrics.counters["blocks.reported_corrupt"] == 2
        finally:
            await conn.close()
