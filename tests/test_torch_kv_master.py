"""Port parity: the port's master on the KV metadata store against the
JAX package's, on the CPU.

Holds one seeded op sequence (mkdir, create, rename, delete, add_block,
complete, set_attr, ec_plan and ec_put, job_put and job_del, worker_deco)
through both packages' ``MasterFilesystem`` on ``KvMetaStore`` giving
byte-equal scans of their KV directories and byte-equal journals, on
each engine; either package's journal and metadata directory reopening
in the other to the same namespace; a mem store's journal and snapshot
reopening on KV (the snapshot loaded wholesale, the tail replayed); a
journal ahead of its store (a crash between the journal's flush and the
store's batch) replayed from ``applied_seq`` to the scans of a run with
no crash, mount entries in that tail included; ``meta_engine =
"native"`` never falling back to the Python engine, ``"auto"`` falling
back with a warning; and the master's start line and ``--metrics-out``
dump naming the store, its engine and the recovery's figures."""

import asyncio
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from curvine_tpu.common.journal import Journal as JaxJournal
from curvine_tpu.master import filesystem as jax_fs_mod
from curvine_tpu.master import inode as jax_inode
from curvine_tpu.master import worker_map as jax_worker_map
from curvine_tpu.master.filesystem import MasterFilesystem as JaxFs
from curvine_tpu.master.store import KvMetaStore as JaxKvStore
from curvine_tpu_torch.common import kvnative
from curvine_tpu_torch.common.journal import GroupCommitter, Journal
from curvine_tpu_torch.common.types import SetAttrOpts
from curvine_tpu_torch.gpu import _build
from curvine_tpu_torch.master import filesystem as port_fs
from curvine_tpu_torch.master import inode as port_inode
from curvine_tpu_torch.master import worker_map as port_worker_map
from curvine_tpu_torch.master.__main__ import stats
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.master.mount import MountManager
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.master.store import KvMetaStore, MemMetaStore
from test_torch_master import (WID, _Both, _drive, _namespace, _paths,
                               _worker_wire)
from torch_cluster import BLOCK, PortCluster, _master_conf

ENGINES = ["python", "native"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW_MS = 1_700_000_000_000


def _fixed_clock(monkeypatch) -> None:
    """Both packages' master modules read one fixed time: the inode
    records in the KV store carry their mtime and atime, so both
    packages must stamp the same value, however often each reads the
    clock."""
    for mod in (jax_worker_map, jax_fs_mod, jax_inode, port_worker_map,
                port_fs, port_inode):
        monkeypatch.setattr(mod, "now_ms", lambda: NOW_MS)


def _jax_kv(root, name: str, engine: str):
    fs = JaxFs(journal=JaxJournal(str(root / name)),
               store=JaxKvStore(str(root / f"{name}-meta"), engine=engine))
    fs.recover()
    return fs


def _port_kv(root, name: str, engine: str, mounts: bool = False):
    fs = MasterFilesystem(journal=Journal(str(root / name)),
                          store=KvMetaStore(str(root / f"{name}-meta"),
                                            engine=engine))
    if mounts:
        fs.mounts = MountManager(fs)
    fs.recover()
    return fs


class _BothKv(_Both):
    """``_Both`` with each package's master on its own KV store."""

    def __init__(self, root, monkeypatch, engine: str):
        _fixed_clock(monkeypatch)
        self.jax = _jax_kv(root, "jax", engine)
        self.port = _port_kv(root, "port", engine)


def _scan(fs) -> list:
    return list(fs.store.kv.scan())


def _drive_kv(both: _Both, seed: int, between=lambda: None) -> None:
    """``_drive``'s namespace and block ops (worker reports included),
    then (after ``between()``) SET_ATTR, stripes planned and committed,
    job records and decommission intents, a striped file deleted, and a
    checkpoint."""
    _drive(both, seed, 80)
    between()
    rng = np.random.default_rng(seed)
    paths = _paths(both.port)
    for p in [paths[int(i)] for i in rng.integers(0, len(paths), 4)]:
        both("set_attr", p, SetAttrOpts(
            mode=int(rng.integers(0, 0o777)), owner="u", replicas=2,
            add_x_attr={"k": b"v"}, ttl_ms=5, ttl_action=1))
    for f in ("/ec/a", "/ec/b"):
        both("create_file", f, block_size=BLOCK, client_name="c1")
        blocks, last = [], None
        for _ in range(2):
            commit = [(last, BLOCK)] if last else None
            last = both("add_block", f, client_host="h",
                        commit=commit)[1]["block"]["id"]
            blocks.append(last)
        both("complete_file", f, 2 * BLOCK, commit=[(last, BLOCK)])
        both("set_attr", f, SetAttrOpts(ec="rs-2-1"))
        for bid in blocks:
            cells = both("ec_plan", bid, "rs-2-1", 2, 1, BLOCK // 2)[1]
            both("ec_commit", bid, [[c, WID, 0] for c in cells])
    for i in range(3):
        both("_log", "job_put", {"job": {
            "job_id": f"j{i}", "kind": "load", "path": "/ec", "state": i,
            "cursor": int(rng.integers(0, 9))}})
    both("_log", "job_del", {"job_id": "j1"})
    both("decommission_worker", WID, True)
    both("decommission_worker", 99, True)       # unknown: refused
    both("decommission_worker", 98, False)      # an absent worker's clear
    both("worker_heartbeat", _worker_wire())
    both("delete", "/ec/b")
    both("rename", "/ec", "/ec2")
    both.jax.checkpoint()
    both.port.checkpoint()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("engine", ENGINES)
def test_seeded_ops_scan_equal_on_kv(tmp_path, monkeypatch, engine, seed):
    """The two masters' KV directories scan byte-equal after the seeded
    ops, the journals are the same bytes, and every kind of record is
    there."""
    both = _BothKv(tmp_path, monkeypatch, engine)
    _drive_kv(both, seed)
    assert _namespace(both.jax) == _namespace(both.port)
    got = _scan(both.port)
    assert _scan(both.jax) == got
    kinds = {k[:1] for k, _v in got}
    assert kinds >= {b"i", b"c", b"b", b"M", b"E", b"J", b"D"}, kinds
    assert both.port.store.get_counter("applied_seq") == \
        both.port.journal.seq == both.jax.journal.seq
    assert both.port.tree.count() == sum(k[:1] == b"i" for k, _v in got)
    for fs in (both.jax, both.port):
        fs.journal.close()
        fs.store.close()
    jdir, pdir = both.jax.journal.dir, both.port.journal.dir
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for name in os.listdir(jdir):
        assert open(os.path.join(jdir, name), "rb").read() == \
            open(os.path.join(pdir, name), "rb").read(), name


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_and_meta_dir_reopen_in_the_other_package(
        tmp_path, monkeypatch, writer, engine):
    """A journal and KV directory written by either package's master
    reopen in the other to the namespace and the scans its own package
    reopens them to (replica locations are runtime state)."""
    both = _BothKv(tmp_path, monkeypatch, engine)
    _drive_kv(both, 3)
    wrote = both.jax if writer == "jax" else both.port
    want_paths = _paths(wrote)
    wrote.journal.close()
    wrote.store.close()
    opened = {}
    for pkg in ("jax", "port"):
        fs = (_jax_kv if pkg == "jax" else _port_kv)(tmp_path, writer,
                                                     engine)
        opened[pkg] = (_namespace(fs), _scan(fs), _paths(fs))
        fs.journal.close()
        fs.store.close()
    assert opened["jax"] == opened["port"]
    assert opened["port"][2] == want_paths and len(want_paths) > 3
    assert opened["port"][0]["locs"] == {}


def test_mem_store_journal_migrates_to_kv(tmp_path):
    """A master on the mem store with a snapshot and a tail after it,
    restarted on KV: the snapshot is loaded wholesale, the tail replayed,
    the namespace the mem store's own restart gives; a second KV restart
    replays nothing."""
    jdir = str(tmp_path / "j")
    fs = MasterFilesystem(journal=Journal(jdir))
    for i in range(30):
        fs.create_file(f"/d{i % 3}/f{i}")
        fs.complete_file(f"/d{i % 3}/f{i}", i)
        if i == 19:
            fs.checkpoint()
    fs.delete("/d1", recursive=True)
    fs.rename("/d2", "/e")
    fs.journal.close()
    seq = fs.journal.seq

    mem = MasterFilesystem(journal=Journal(jdir))
    mem.recover()
    want = _namespace(mem)
    mem.journal.close()

    kv = MasterFilesystem(journal=Journal(jdir),
                          store=KvMetaStore(str(tmp_path / "meta")))
    kv.recover()
    assert _namespace(kv) == want
    assert kv.store.get_counter("applied_seq") == seq
    assert kv.recovery["replayed"] == seq - kv.journal.last_snapshot_seq > 0
    assert kv.tree.count() == mem.tree.count() == len(list(
        kv.store.iter_inodes()))
    kv.create_file("/after")
    kv.journal.close()
    kv.store.close()
    again = MasterFilesystem(journal=Journal(jdir),
                             store=KvMetaStore(str(tmp_path / "meta")))
    again.recover()
    assert again.recovery["replayed"] == 0
    assert again.exists("/after") and again.exists("/e/f29")
    again.store.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_crash_with_journal_ahead_of_store_replays_the_tail(
        tmp_path, monkeypatch, engine):
    """The seeded ops on a port master under group commit whose KV
    batches stop landing after the block reports (the journal flushed,
    the process gone before the store's batch): the restart replays the
    tail from ``applied_seq`` to the scans of the same ops with no
    crash."""
    both = _BothKv(tmp_path, monkeypatch, engine)
    _drive_kv(both, 4)
    want = _scan(both.port)
    seq = both.port.journal.seq

    crashed = _port_kv(tmp_path, "crash", engine)
    crashed.committer = GroupCommitter(crashed.journal, crashed.store)
    land = crashed.store.commit_applied
    landing = [True]
    crashed.store.commit_applied = \
        lambda s: land(s) if landing[0] else None
    rerun = _Both.__new__(_Both)
    rerun.jax, rerun.port = _jax_kv(tmp_path, "jax-again", engine), crashed
    _drive_kv(rerun, 4, between=lambda: landing.__setitem__(0, False))
    cut = crashed.store.get_counter("applied_seq")
    assert crashed.journal.seq == seq and 0 < cut < seq
    del crashed                      # no close: the store's tail is lost
    back = _port_kv(tmp_path, "crash", engine)
    assert back.recovery["applied_seq"] == seq
    assert back.recovery["replayed"] == seq - cut
    assert _scan(back) == want
    assert _paths(back) == _paths(both.port)
    back.store.close()


def test_mount_entries_in_the_replayed_tail(tmp_path):
    """A tail past ``applied_seq`` holding ``mount_update`` and
    ``mount_add`` entries (the journal flushed, the store's batch lost):
    the restart applies them to the table the store holds, with the
    mount ids of a run with no crash (ROADMAP §C, C8)."""
    fs = _port_kv(tmp_path, "m", "native", mounts=True)
    fs.mounts.mount("/m", "file:///data/m")
    fs.journal.append("mount_update", dict(
        cv_path="/m", properties={"k": "v"}, auto_cache=None, ttl_ms=None,
        ttl_action=None, access_mode="r"))
    fs.journal.append("mount_add", dict(
        cv_path="/n", ufs_path="file:///data/n", properties={},
        auto_cache=False, write_type=0, ttl_ms=0, ttl_action=0,
        storage_type="", block_size=0, replicas=0, access_mode="rw"))
    fs.journal.close()
    del fs                           # the tail never reached the store
    back = _port_kv(tmp_path, "m", "native", mounts=True)
    assert back.recovery["replayed"] == 2
    m, n = back.mounts.get_mount("/m"), back.mounts.get_mount("/n")
    assert (m.access_mode, m.properties, m.mount_id) == ("r", {"k": "v"}, 1)
    assert (n.ufs_path, n.mount_id) == ("file:///data/n", 2)
    back.store.close()


def test_native_engine_never_falls_back(tmp_path, monkeypatch, caplog):
    """``meta_engine = "native"`` raises when the engine's library does
    not build; ``"auto"`` then takes the Python engine, with a warning;
    ``"python"`` never builds it; any other name is refused."""
    def no_compiler(name):
        raise _build.KernelBuildError("no host C++ compiler")
    monkeypatch.setattr(kvnative, "_lib", None)
    monkeypatch.setattr(_build, "load", no_compiler)
    with pytest.raises(_build.KernelBuildError, match="no host C"):
        KvMetaStore(str(tmp_path / "a"), engine="native")
    with caplog.at_level(logging.WARNING):
        store = KvMetaStore(str(tmp_path / "b"), engine="auto")
    assert store.engine == "python"
    assert any("Python engine" in r.message for r in caplog.records)
    store.close()
    assert KvMetaStore(str(tmp_path / "c"), engine="python").engine == \
        "python"
    with pytest.raises(ValueError, match="rocksdb"):
        KvMetaStore(str(tmp_path / "d"), engine="rocksdb")


async def test_master_reports_its_store_and_recovery(tmp_path):
    """The server builds the store from the conf (``<journal_dir>-meta``
    by default) and its start line's and dump's figures name it: kind,
    engine, segments, and the recovery's inodes, blocks, applied_seq and
    replayed entries; on ``"mem"`` the mem store."""
    conf = _master_conf(tmp_path, meta_engine="native")
    m = MasterServer(conf)
    await m.start()
    m.fs.mkdir("/a/b")
    await m.stop()
    first = stats(m)
    assert os.path.isdir(str(tmp_path / "journal") + "-meta")
    m2 = MasterServer(conf)
    await m2.start()
    assert m2.fs.exists("/a/b")
    await m2.stop()
    st = stats(m2)
    assert st["store"]["kind"] == "kv" and st["store"]["engine"] == "native"
    assert st["store"]["segments"] >= 1 == first["store"]["segments"]
    assert st["recovery"] == {"inodes": 3, "blocks": 0,
                              "applied_seq": first["journal_seq"],
                              "replayed": 0}
    conf.master.meta_store = "mem"
    conf.master.journal_dir = str(tmp_path / "mem-journal")
    m3 = MasterServer(conf)
    assert isinstance(m3.fs.store, MemMetaStore)
    assert stats(m3)["store"] == {"kind": "mem"}


def test_recovery_replays_only_the_entries_past_applied_seq(tmp_path,
                                                            monkeypatch):
    """A KV master whose store stopped landing its batches at entry 250
    of 300, over several journal segments: the restart reads the whole
    journal, as the reference does, replays the 50 entries past the
    store's ``applied_seq`` and skips the rest, to the namespace of all
    300."""
    from curvine_tpu_torch.common import journal as jmod
    monkeypatch.setattr(jmod, "SEGMENT_MAX", 2048)
    fs = _port_kv(tmp_path, "j", "python")
    land = fs.store.commit_applied
    fs.store.commit_applied = lambda s: land(s) if s <= 250 else None
    for i in range(300):
        fs.mkdir(f"/d{i}")
    assert fs.journal.seq == 300
    assert fs.store.get_counter("applied_seq") == 250
    fs.journal.close()
    del fs                           # the store's last 50 never landed
    assert len(os.listdir(tmp_path / "j")) > 2
    back = _port_kv(tmp_path, "j", "python")
    assert back.recovery["replayed"] == 50
    assert back.recovery["applied_seq"] == back.journal.seq == 300
    assert sorted(_paths(back)) == sorted(f"/d{i}" for i in range(300))
    back.store.close()


def test_restarted_master_waits_for_its_workers(tmp_path, monkeypatch):
    """A fresh master answers a placement with no worker
    NO_AVAILABLE_WORKER, as the reference does; a restarted one (its
    recovery found applied entries) that no worker has reached since its
    start answers IN_PROGRESS (retryable) until the lost timeout has
    passed since its start, and NO_AVAILABLE_WORKER after it, or while
    the only worker it knows is not live (ROADMAP §C, C9)."""
    from curvine_tpu.common import errors as jerr
    from curvine_tpu_torch.common import errors as err
    jfs = JaxFs(journal=None)
    fs = _port_kv(tmp_path, "r", "python")
    for f in (jfs, fs):
        f.create_file("/f")
    with pytest.raises(jerr.NoAvailableWorker):
        jfs.add_block("/f")
    with pytest.raises(err.NoAvailableWorker):
        fs.add_block("/f")
    fs.journal.close()
    fs.store.close()
    fs = _port_kv(tmp_path, "r", "python")
    assert fs.recovery["applied_seq"] > 0
    with pytest.raises(err.CurvineError) as e:
        fs.add_block("/f")
    assert e.value.code == err.ErrorCode.IN_PROGRESS and e.value.retryable
    fs._started -= fs.workers.lost_timeout_ms / 1000
    with pytest.raises(err.NoAvailableWorker):
        fs.add_block("/f")
    fs._started = port_fs.time.monotonic()
    fs.worker_heartbeat(_worker_wire())
    fs.decommission_worker(WID)
    with pytest.raises(err.NoAvailableWorker):
        fs.add_block("/f")
    fs.store.close()


async def test_writer_carried_through_an_outage_past_the_lost_timeout(
        tmp_path):
    """The master stops for 4.5 s, past its 2 s lost timeout, while its
    worker's heartbeats fail and back off from 1 s: uncapped, the worker
    would try again about 0.5, 2, 4 and 8 s after the stop, the last
    past the restarted master's 2 s wait for its workers (4.5 to 6.5 s).
    Capped at half the lost timeout, the worker tries each second and
    reaches the restarted master in time, and a writer that comes at
    once sees no error (ROADMAP §C, C9)."""
    async with PortCluster(tmp_path, workers=1,
                           worker_lost_timeout_ms=2_000) as pc:
        pc.workers[0].conf.worker.heartbeat_ms = 500
        pc.conf.client.conn_retry_max = 8
        c = pc.client()
        await c.write_all("/a", b"a" * 1000)
        await pc.master.stop()
        await asyncio.sleep(4.5)
        pc.master = MasterServer(pc.conf)
        await pc.master.start()
        await c.write_all("/b", b"b" * 1000)
        assert await c.read_all("/b") == b"b" * 1000
        assert await c.read_all("/a") == b"a" * 1000


_WRITERS = r"""
import asyncio, json, os, signal, subprocess, sys, time
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.conf import TierConf
from curvine_tpu_torch.worker.server import WorkerServer

conf_path, pid = sys.argv[1], int(sys.argv[2])
MB = 1 << 20


def small(i):
    return i.to_bytes(4, "little") * 1024


async def main():
    conf = ClusterConf.load(conf_path)
    w = WorkerServer(conf)
    await w.start()
    c1, c2 = CurvineClient(conf), CurvineClient(conf)
    for _ in range(100):
        if (await c1.meta.master_info()).live_workers:
            break
        await asyncio.sleep(0.1)
    acked, done, kill = [], asyncio.Event(), {}

    async def small_writer():
        i = 0
        while not done.is_set():
            if i % 8 == 0:
                await c2.meta.mkdir(f"/small/d{i // 8}")
            await c2.write_all(f"/small/d{i // 8}/f{i}", small(i))
            acked.append(i)
            i += 1
            await asyncio.sleep(0.01)

    task = asyncio.create_task(small_writer())
    try:
        for s in range(6):
            await c1.write_all(f"/train/s{s}", bytes([s]) * MB)
            if s == 2:
                kill["acked"] = len(acked)
                os.kill(pid, signal.SIGKILL)
                print(json.dumps({"killed": True}), flush=True)
                # the test starts the master again; wait for its word
                sys.stdin.readline()
    finally:
        done.set()
        await task
    out = {"acked": acked, "before": kill["acked"], "lens": {}, "same": []}
    for i in acked:
        st = await c1.meta.file_status(f"/small/d{i // 8}/f{i}")
        out["lens"][i] = [st.len, st.is_complete]
    for i in acked[:kill["acked"]]:
        out["same"].append(await c1.read_all(f"/small/d{i // 8}/f{i}")
                           == small(i))
    for s in range(6):
        out["same"].append(await c1.read_all(f"/train/s{s}")
                           == bytes([s]) * MB)
    await c1.close()
    await c2.close()
    await w.stop()
    print(json.dumps(out), flush=True)

asyncio.run(main())
"""


def test_master_killed_under_running_writers(tmp_path):
    """Phase kv (b) of ``chip_smoke.py`` at a small size: the master in
    its own process (KV, the native engine) gets SIGKILL under two
    writers (one-block files and 4 KiB files) and is started again on
    its journal and KV directory; no writer sees an error (the clients'
    retries and the restarted master's wait for its workers), and every
    acknowledged create and complete is there, with its bytes."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    conf = tmp_path / "cluster.toml"

    def write_conf(port: int) -> None:
        conf.write_text(f"""
[master]
hostname = "127.0.0.1"
rpc_port = {port}
journal_dir = "{tmp_path / 'journal'}"
meta_engine = "native"
[worker]
hostname = "127.0.0.1"
rpc_port = 0
heartbeat_ms = 500
promote_interval_ms = 0
[[worker.tiers]]
storage_type = "mem"
dir = "{tmp_path / 'mem'}"
capacity = 67108864
[client]
master_addrs = ["127.0.0.1:{port}"]
block_size = 1048576
conn_retry_max = 8
""")

    def start_master():
        p = subprocess.Popen(
            [sys.executable, "-m", "curvine_tpu_torch.master", "--conf",
             str(conf)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        return p, json.loads(p.stdout.readline())

    write_conf(0)
    procs = []
    m, line = start_master()
    procs.append(m)
    write_conf(int(line["addr"].rsplit(":", 1)[1]))
    writers = subprocess.Popen(
        [sys.executable, "-c", _WRITERS, str(conf), str(m.pid)], cwd=ROOT,
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    procs.append(writers)
    try:
        assert json.loads(writers.stdout.readline()) == {"killed": True}
        m.wait(timeout=60)
        m2, again = start_master()
        procs.append(m2)
        writers.stdin.write("go\n")
        writers.stdin.flush()
        out, errs = writers.communicate(timeout=240)
        assert writers.returncode == 0, errs[-3000:]
        res = json.loads(out.splitlines()[-1])
        assert res["before"] > 0 and len(res["acked"]) > res["before"]
        assert all(v == [4096, True] for v in res["lens"].values())
        assert all(res["same"]) and len(res["same"]) == res["before"] + 6
        assert again["store"]["engine"] == "native"
        assert again["recovery"]["applied_seq"] == again["journal_seq"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
