"""Raft parity: the port's raft (``curvine_tpu_torch/master/ha.py``, the
journal's term bookkeeping, the filesystem's raft hooks) against the JAX
package's, on the CPU.

Holds journals whose entries carry terms byte-equal in both packages and
each package's ``Journal.recover`` reading the other's; ``term_of`` over
its window and ``reset_log`` alike over the same seeded appends; the
hard state files byte-equal and read by either package; one seeded op
sequence on one fixed clock through a three-node JAX raft group and a
three-node port group, with the same journals, namespaces and KV scans
on every node; and mixed groups: a port master following a JAX leader,
caught up by the log stream and by a chunked snapshot install, and a JAX
master following a port leader, likewise.

In a group node 1 alone runs elections (the others' ``_run_election``
does nothing), so that it leads term 1 and both groups' logs hold the
same entries at the same seqs; entries go by batches, with no
heartbeat meanwhile (``HEARTBEAT_MS``)."""

import asyncio
import os
import shutil
import socket

import numpy as np
import pytest

from curvine_tpu.common import errors as jerr
from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu.common.journal import Journal as JaxJournal
from curvine_tpu.common.types import CommitBlock as JaxCommitBlock
from curvine_tpu.common.types import SetAttrOpts as JaxSetAttrOpts
from curvine_tpu.master import filesystem as jax_fs_mod
from curvine_tpu.master import inode as jax_inode
from curvine_tpu.master import worker_map as jax_worker_map
from curvine_tpu.master.ha import RaftLite as JaxRaft
from curvine_tpu.master.server import MasterServer as JaxMaster
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.journal import Journal
from curvine_tpu_torch.common.types import CommitBlock, SetAttrOpts
from curvine_tpu_torch.master import filesystem as port_fs
from curvine_tpu_torch.master import inode as port_inode
from curvine_tpu_torch.master import worker_map as port_worker_map
from curvine_tpu_torch.master.ha import RaftLite
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.rpc import wirepack
from test_torch_master import WID, _worker_wire

BLOCK = 1 << 20
NOW_MS = 1_700_000_000_000
# a group's heartbeat: longer than a test, so that no heartbeat is on its
# way while a leader appends a burst of entries. A JAX leader's heartbeat
# then finds its member behind and sends it a whole snapshot (ROADMAP
# §C, C14, the reference's share), which would change that member's
# journal and the open files' writers in its KV records
HEARTBEAT_MS = 30_000


def _fixed_clock(monkeypatch) -> None:
    """Both packages' master modules read one fixed time: KV inode
    records carry mtime and atime."""
    for mod in (jax_worker_map, jax_fs_mod, jax_inode, port_worker_map,
                port_fs, port_inode):
        monkeypatch.setattr(mod, "now_ms", lambda: NOW_MS)


def _seeded_entries(seed: int, n: int) -> list[tuple[str, dict, int]]:
    """(op, args, term) with terms that never go down."""
    rng = np.random.default_rng(seed)
    out, term = [], 1
    for i in range(n):
        if rng.integers(0, 50) == 0:
            term += int(rng.integers(1, 3))
        op = ["mkdir", "noop", "raft_conf", "create"][int(rng.integers(0, 4))]
        args = ({} if op == "noop" else
                {"ver": i, "voters": {"1": "a:1", "2": "b:2"},
                 "learners": {}, "action": "promote", "target": 2}
                if op == "raft_conf" else
                {"path": f"/d{i}", "pad": b"x" * int(rng.integers(0, 64))})
        out.append((op, args, term))
    return out


def _write(j, entries, batch_every: int = 7) -> None:
    """Single appends and batches (``append_batch`` with each entry's
    own term), alternating."""
    i = 0
    while i < len(entries):
        if (i // batch_every) % 2:
            j.append_batch(entries[i:i + batch_every])
            i += batch_every
        else:
            op, args, term = entries[i]
            j.append(op, args, term=term, flush=(i % 3 == 0))
            i += 1
    j.sync()


def _files(d: str) -> dict[str, bytes]:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed", [0, 1])
def test_journal_with_terms_byte_equal_and_read_by_the_other(tmp_path,
                                                            seed):
    entries = _seeded_entries(seed, 300)
    jj, pj = JaxJournal(str(tmp_path / "jax")), Journal(str(tmp_path / "port"))
    for j in (jj, pj):
        j.term = 1
        _write(j, entries)
        j.close()
    assert _files(jj.dir) == _files(pj.dir)
    for mine, other in ((JaxJournal, pj.dir), (Journal, jj.dir)):
        j = mine(other)
        snap, got = j.recover()
        assert snap is None
        assert [(op, args, t) for _s, op, args, t in got] == \
            [(op, args, t) for op, args, t in entries]
        assert (j.seq, j.last_term) == (len(entries), entries[-1][2])
        assert [j.term_of(s) for s in range(len(entries) + 2)] == \
            [0] + [t for _o, _a, t in entries] + [None]


@pytest.mark.parametrize("seed", [0, 1])
def test_term_window_and_reset_log_alike(tmp_path, seed):
    """Over 20,000 appends the window of terms is pruned to the same
    seqs in both; ``reset_log`` drops every segment and term in both,
    and the appends after it are the same bytes."""
    rng = np.random.default_rng(seed)
    terms = np.cumsum(rng.integers(0, 2, 20_000) * (rng.random(20_000)
                                                     < 0.01)) + 1
    js = [JaxJournal(str(tmp_path / "jax")), Journal(str(tmp_path / "port"))]
    for j in js:
        for i, t in enumerate(terms):
            j.append("noop", {}, term=int(t), flush=False)
            if i == 9_000:
                j.append_batch([("noop", {}, int(t))] * 3)
        j.sync()
    probe = list(range(0, 20_010, 37)) + [20_002, 20_003, 20_004]
    assert [js[0].term_of(s) for s in probe] == \
        [js[1].term_of(s) for s in probe]
    assert js[1].term_of(1) is None and js[1].term_of(20_003) is not None
    assert len(js[0]._terms) == len(js[1]._terms)
    for j in js:
        j.reset_log()
        j.seq, j.last_term = 50_000, 9
        j.note_term(50_000, 9)
        j.append("mkdir", {"path": "/after"}, term=9)
        j.close()
    assert [j.term_of(s) for s in (20_003, 50_000, 50_001)
            for j in js] == [None, None, 9, 9, 9, 9]
    assert _files(js[0].dir) == _files(js[1].dir)
    assert len(_files(js[1].dir)) == 1      # the segments before went


class _Rpc:
    def register(self, code, handler) -> None:
        pass


class _Fs:
    journal = None
    raft_conf = None


@pytest.mark.parametrize("learner", [False, True])
def test_hard_state_files_byte_equal_and_read_by_the_other(tmp_path,
                                                          learner):
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    cfg = {"ver": 3, "voters": {"1": "h:1", "2": "h:2", "4": "h:4"},
           "learners": {"5": "h:5"} if learner else {}}
    nodes = []
    for cls, k in ((JaxRaft, "jax"), (RaftLite, "port")):
        r = cls(2, {1: "h:1"}, _Fs(), _Rpc(), state_dir=str(dirs[k]),
                self_addr="h:2", learner=learner)
        r.term, r.voted_for = 7, 4
        r._adopt_config(cfg)
        nodes.append(r)
    hs = {k: (d / "raft_hard_state").read_bytes() for k, d in dirs.items()}
    assert hs["jax"] == hs["port"]
    for cls, k in ((JaxRaft, "port"), (RaftLite, "jax")):
        r = cls(2, {}, _Fs(), _Rpc(), state_dir=str(dirs[k]))
        assert (r.term, r.voted_for, r._hs_conf) == \
            (7, 4, nodes[0]._hs_conf)
        r._adopt_config(r._hs_conf)
        assert sorted(r.voters) == [1, 2, 4]
        assert sorted(r.learners) == ([5] if learner else [])


# ------------------------------------------------------------ groups

async def _never(*_a, **_k) -> None:
    return None


def _ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class _Group:
    """Three raft masters of the given packages ("jax" or "port") in this
    process; node 1 alone runs elections. A port taken meanwhile by
    another process (EADDRINUSE) starts the group again on fresh ports
    and directories."""

    def __init__(self, root, kinds: list[str]):
        self.base = root
        self.kinds = kinds
        self.nodes: dict[int, object] = {}

    def conf(self, nid: int):
        conf = (JaxConf if self.kinds[nid - 1] == "jax" else ClusterConf)()
        mc = conf.master
        mc.hostname = "127.0.0.1"
        mc.rpc_port = int(self.addrs[nid - 1].rsplit(":", 1)[1])
        mc.journal_dir = str(self.root / f"j{nid}")
        mc.raft_peers = list(self.addrs)
        mc.raft_node_id = nid
        mc.worker_lost_timeout_ms = 600_000
        if self.kinds[nid - 1] == "jax":
            mc.fast_meta = False
        conf.client.master_addrs = list(self.addrs)
        return conf

    async def start_node(self, nid: int):
        cls = JaxMaster if self.kinds[nid - 1] == "jax" else MasterServer
        m = cls(self.conf(nid))
        m.raft.election_timeout = (150, 300)
        m.raft.heartbeat_ms = HEARTBEAT_MS
        if nid != 1:
            m.raft._run_election = _never
        await m.start()
        self.nodes[nid] = m
        return m

    async def __aenter__(self) -> "_Group":
        import errno
        for attempt in range(3):
            self.root = self.base / f"a{attempt}"
            self.addrs = [f"127.0.0.1:{p}" for p in _ports(len(self.kinds))]
            try:
                for nid in range(1, len(self.kinds) + 1):
                    await self.start_node(nid)
                break
            except OSError as e:
                for m in self.nodes.values():
                    await m.stop()
                self.nodes.clear()
                if e.errno != errno.EADDRINUSE or attempt == 2:
                    raise
        leader = self.nodes[1]
        await _until(lambda: leader.raft.is_leader and all(
            m.raft.leader_id == 1 for m in self.nodes.values()))
        return self

    async def __aexit__(self, *exc) -> None:
        for m in self.nodes.values():
            await m.stop()

    async def stop_node(self, nid: int, wipe: bool = False) -> None:
        await self.nodes.pop(nid).stop()
        if wipe:
            d = str(self.root / f"j{nid}")
            shutil.rmtree(d)
            shutil.rmtree(d + "-meta")

    async def caught_up(self) -> None:
        head = self.nodes[1].fs.journal.seq
        await _until(lambda: all(m.fs.journal.seq == head
                                 for m in self.nodes.values()))


async def _until(cond, timeout: float = 20.0):
    async def wait():
        while not cond():
            await asyncio.sleep(0.02)
    await asyncio.wait_for(wait(), timeout)


def _drive(fs, seed: int, n: int, jax: bool) -> list:
    """A seeded sequence of namespace and block ops on a leader's
    filesystem (its entries replicate); each op's outcome (its error
    code, or ok) is returned."""
    rng = np.random.default_rng(seed)
    errs = jerr if jax else err
    cb, attrs = ((JaxCommitBlock, JaxSetAttrOpts) if jax
                 else (CommitBlock, SetAttrOpts))
    fs.worker_heartbeat(_worker_wire())
    out, open_files = [], {}
    names = ["a", "b", "c"]
    for _ in range(n):
        k = int(rng.integers(0, 7))
        d = "/" + "/".join(rng.choice(names, rng.integers(1, 3)))
        f = f"{d}/f{rng.integers(0, 3)}"
        try:
            if k == 0:
                fs.mkdir(d)
            elif k == 1:
                fs.create_file(f, overwrite=bool(rng.integers(0, 2)),
                               block_size=BLOCK, client_name="c1")
                open_files[f] = None
            elif k in (2, 3) and open_files:
                f = sorted(open_files)[int(rng.integers(0, len(open_files)))]
                last = open_files[f]
                commit = ([cb(block_id=last, block_len=int(rng.integers(
                    1, BLOCK)), worker_ids=[WID])] if last else None)
                if k == 2:
                    open_files[f] = fs.add_block(
                        f, client_host="h", commit_blocks=commit).block.id
                else:
                    open_files.pop(f)
                    fs.complete_file(f, int(rng.integers(0, 4 * BLOCK)),
                                     commit_blocks=commit)
            elif k == 4:
                fs.rename(d if rng.integers(0, 2) else f,
                          "/" + "/".join(rng.choice(names, 2)) + "x")
            elif k == 5:
                fs.delete(d if rng.integers(0, 2) else f,
                          recursive=bool(rng.integers(0, 2)))
            else:
                fs.set_attr(f, attrs(mode=int(rng.integers(0, 0o777)),
                                     add_x_attr={"k": b"v" * int(
                                         rng.integers(0, 9))}))
            out.append("ok")
        except errs.CurvineError as e:
            out.append(int(e.code))
    return out


def _state(m) -> dict:
    return m.fs._snapshot_state()


def _scan(m, writer: bool = True) -> list:
    """The KV store's records; without ``writer``, each inode record's
    last field (the open file's ``client_name``) blanked."""
    m.fs.flush_group()
    out = list(m.fs.store.kv.scan())
    if not writer:
        out = [(k, v) if not k.startswith(b"i") else
               (k, wirepack.packb(wirepack.unpackb(v)[:-1] + [""]))
               for k, v in out]
    return out


def _edits(m) -> dict[str, bytes]:
    m.fs.journal.sync()
    return {k: v for k, v in _files(m.fs.journal.dir).items()
            if k.startswith("edits-")}


@pytest.mark.parametrize("seed", [0, 1])
async def test_seeded_ops_equal_in_jax_and_port_raft_groups(
        tmp_path, monkeypatch, seed):
    _fixed_clock(monkeypatch)
    async with _Group(tmp_path / "jax", ["jax"] * 3) as jg, \
            _Group(tmp_path / "port", ["port"] * 3) as pg:
        outs = [_drive(g.nodes[1].fs, seed, 150, jax=(g is jg))
                for g in (jg, pg)]
        assert outs[0] == outs[1]
        await jg.caught_up()
        await pg.caught_up()
        states = [_state(g.nodes[n]) for g in (jg, pg) for n in (1, 2, 3)]
        assert all(s == states[0] for s in states)
        assert len(states[0]["inodes"]) > 5
        for n in (1, 2, 3):
            assert _scan(jg.nodes[n]) == _scan(pg.nodes[n]), n
            assert _edits(jg.nodes[n]) == _edits(pg.nodes[n]), n
        for g in (jg, pg):
            assert [g.nodes[n].raft.term for n in (1, 2, 3)] == [1, 1, 1]


@pytest.mark.parametrize("leader_kind", ["jax", "port"])
async def test_mixed_group_follower_caught_up_by_log_and_snapshot(
        tmp_path, monkeypatch, leader_kind):
    """Node 3, of the other package, follows node 1's lead: by the log
    stream, then, wiped, by a chunked snapshot install (64 KiB chunks),
    then by the log again; it ends with node 2's state and KV scan."""
    _fixed_clock(monkeypatch)
    other = "port" if leader_kind == "jax" else "jax"
    async with _Group(tmp_path, [leader_kind, leader_kind, other]) as g:
        lead = g.nodes[1]
        jax = leader_kind == "jax"
        _drive(lead.fs, 3, 100, jax=jax)
        await g.caught_up()
        assert _state(g.nodes[3]) == _state(g.nodes[2])
        assert _scan(g.nodes[3]) == _scan(g.nodes[2])
        assert _edits(g.nodes[3]) == _edits(g.nodes[2])
        await g.stop_node(3, wipe=True)
        lead.raft.snapshot_chunk_bytes = 64 * 1024
        _drive(lead.fs, 4, 60, jax=jax)
        opts = (JaxSetAttrOpts if jax else SetAttrOpts)(
            add_x_attr={"pad": "p" * (300 * 1024)})
        lead.fs.mkdir("/pad")
        lead.fs.set_attr("/pad", opts)
        back = await g.start_node(3)
        await g.caught_up()
        await _until(lambda: lead.metrics.counters.get(
            "raft.snapshot_chunks_sent", 0) >= 5)
        assert back.metrics.counters.get("raft.snapshot_installs") == 1
        _drive(lead.fs, 5, 40, jax=jax)
        await g.caught_up()
        assert _state(back) == _state(g.nodes[2]) == _state(lead)
        assert len(back.fs.tree.resolve("/pad").x_attr["pad"]) == 300 * 1024
        # a snapshot carries no open file's writer (client_name), in
        # either package: the installed node has it blank
        assert _scan(back, writer=False) == _scan(g.nodes[2], writer=False)
        assert back.raft.term == lead.raft.term == 1
