"""Port parity: erasure coding in ``curvine_tpu_torch`` (the codec,
``common/ec.py`` over ``csrc/gf256.cc``; the master's stripes, its
``ec_convert`` job and the replication manager's retire and reconstruct
kinds; the worker's conversion, cell rebuild and WRITE_BLOCKS_BATCH; the
reader's striped reads), against the JAX package on the CPU.

Mirrors the 13 tests of tests/test_ec.py with their parameters: the 11
codec tests on the port's codec (the two native-path ones on the port's
``gf256.cc``, built here with the host compiler; crc32c is the port's),
and the two cluster tests on the port's own cluster
(``tests/torch_cluster.py::PortCluster``; a worker dies by its own
``stop()``). The reference's intact test also reads one range with
``pread_view``, which the port's reader does not have (ROADMAP §A item
6); the mirror reads that range with ``pread``.

Holds the codec equal to the JAX package's bit for bit (generator,
parity, and decode and reconstruct under every erasure pattern of up to
m cells), one seeded layout converted on a ``MiniCluster`` and on a
``PortCluster`` to the same stripes, cells and reads (intact, degraded,
healed), each package's journal and snapshot with stripes reopening in
the other, and a cell on a decommissioned worker rebuilt by decode in
both. Codec results are integers: compared bit for bit, no tolerance."""

import asyncio
import itertools
import os
import random

import numpy as np
import pytest

from curvine_tpu.common import ec as jax_ec
from curvine_tpu.common.journal import Journal as JaxJournal
from curvine_tpu.common.types import JobState as JaxJobState
from curvine_tpu.common.types import SetAttrOpts as JaxSetAttrOpts
from curvine_tpu.master.filesystem import MasterFilesystem as JaxFs
from curvine_tpu.master.store import MemMetaStore as JaxMemStore
from curvine_tpu.testing import MiniCluster
from curvine_tpu_torch.common import ec
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.journal import Journal
from curvine_tpu_torch.common.types import (CommitBlock, JobState,
                                            SetAttrOpts, StorageInfo,
                                            StorageType, WorkerAddress,
                                            WorkerState)
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.rpc.client import Connection
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack
from curvine_tpu_torch.worker.blockfile import crc_update
from torch_cluster import MB, PortCluster

PROFILES = ["rs-4-2", "rs-6-3"]
KiB = 1 << 10


def _crc32c(data) -> int:
    return crc_update("crc32c", bytes(data))


def _block(n: int, seed: int = 7) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _stripe(profile: ec.ECProfile, data: bytes, use_native=True):
    cells, cs = ec.split(data, profile.k)
    parity = ec.encode(profile, cells, use_native=use_native)
    return list(cells) + list(parity), cs


# ---------------- field algebra ----------------

def _gf_mul_ref(a: int, b: int) -> int:
    """Shift-and-add multiply, no tables."""
    p = 0
    while b:
        if b & 1:
            p ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= ec.GF_POLY
    return p


def test_gf_tables_match_reference():
    for a in range(0, 256, 7):
        for b in range(0, 256, 5):
            assert ec.gf_mul(a, b) == _gf_mul_ref(a, b)
            assert ec._MUL[a, b] == _gf_mul_ref(a, b)


def test_gf_inverse():
    for a in range(1, 256):
        assert ec.gf_mul(a, ec.gf_inv(a)) == 1
    with pytest.raises(ZeroDivisionError):
        ec.gf_inv(0)


def test_matinv_roundtrip():
    rng = np.random.default_rng(3)
    for _ in range(5):
        n = 5
        mat = rng.integers(0, 256, size=(n, n), dtype=np.uint8)
        try:
            inv = ec.gf_matinv(mat)
        except ec.ECDecodeError:
            continue                       # a singular random draw
        prod = np.zeros((n, n), dtype=np.uint8)
        for i in range(n):
            for j in range(n):
                acc = 0
                for t in range(n):
                    acc ^= ec.gf_mul(int(mat[i, t]), int(inv[t, j]))
                prod[i, j] = acc
        assert np.array_equal(prod, np.eye(n, dtype=np.uint8))


def test_profile_parse():
    p = ec.ECProfile.parse("rs-6-3")
    assert (p.k, p.m, p.name) == (6, 3, "rs-6-3")
    assert ec.ECProfile.parse("rs-6-3") is p        # cached
    for bad in ("rs-6", "xor-2-1", "rs-0-3", "rs-6-0", "rs-200-100",
                "rs-a-b"):
        with pytest.raises(err.InvalidArgument):
            ec.ECProfile.parse(bad)


# ---------------- the erasure round-trip matrix ----------------

@pytest.mark.parametrize("name", PROFILES)
def test_roundtrip_every_erasure_pattern(name):
    profile = ec.ECProfile.parse(name)
    k, m = profile.k, profile.m
    data = _block(k * 257 + 13)              # ragged on purpose
    stripe, _cs = _stripe(profile, data)
    for nlost in range(m + 1):
        for lost in itertools.combinations(range(k + m), nlost):
            got = [None if i in lost else stripe[i]
                   for i in range(k + m)]
            decoded = ec.decode(profile, got)
            assert ec.join(decoded, len(data)) == data, \
                f"{name} failed at erasure pattern {lost}"


@pytest.mark.parametrize("name", PROFILES)
def test_decode_refuses_m_plus_1_losses(name):
    profile = ec.ECProfile.parse(name)
    k, m = profile.k, profile.m
    stripe, _ = _stripe(profile, _block(k * 64))
    got = [None if i <= m else stripe[i] for i in range(k + m)]
    assert sum(c is None for c in got) == m + 1
    with pytest.raises(ec.ECDecodeError):
        ec.decode(profile, got)


@pytest.mark.parametrize("blen", [1, 5, 64, 6 * 100, 6 * 100 + 1,
                                  6 * 100 - 1, 4096 + 3])
def test_ragged_tail_lengths(blen):
    profile = ec.ECProfile.parse("rs-6-3")
    data = _block(blen, seed=blen)
    stripe, cs = _stripe(profile, data)
    assert all(len(c) == cs for c in stripe)
    # the tail data cell and one parity cell lost
    got = list(stripe)
    got[profile.k - 1] = None
    got[profile.k + 1] = None
    decoded = ec.decode(profile, got)
    assert ec.join(decoded, blen) == data


def test_subrange_decode_is_positionwise():
    """A degraded read of a byte range decodes that range only."""
    profile = ec.ECProfile.parse("rs-4-2")
    data = _block(4 * 1024)
    stripe, _cs = _stripe(profile, data)
    a, b = 100, 300
    got = [None if i == 2 else stripe[i][a:b] for i in range(6)]
    decoded = ec.decode(profile, got)
    assert bytes(decoded[2]) == bytes(stripe[2][a:b])


# ---------------- reconstruction (the healing path) ----------------

@pytest.mark.parametrize("name", PROFILES)
def test_reconstruct_checksum_verified(name):
    profile = ec.ECProfile.parse(name)
    k, m = profile.k, profile.m
    stripe, _ = _stripe(profile, _block(k * 333 + 7))
    want_crc = [_crc32c(c) for c in stripe]
    # one data cell and one parity cell rebuilt from the other k+m-2
    lost = [1, k + m - 1]
    got = [None if i in lost else stripe[i] for i in range(k + m)]
    rebuilt = ec.reconstruct(profile, got, lost)
    for t in lost:
        assert bytes(rebuilt[t]) == bytes(stripe[t])
        assert _crc32c(rebuilt[t]) == want_crc[t]


# ---------------- native against the table ----------------

def test_native_and_numpy_paths_bit_exact():
    profile = ec.ECProfile.parse("rs-6-3")
    data = _block(6 * 4096 + 77, seed=11)
    cells, _ = ec.split(data, profile.k)
    p_py = ec.encode(profile, cells, use_native=False)
    p_nat = ec.encode(profile, cells, use_native=True)
    for a, b in zip(p_py, p_nat):
        assert np.array_equal(a, b)
    stripe = list(cells) + list(p_py)
    got = [None, stripe[1], None, stripe[3], stripe[4], None,
           stripe[6], stripe[7], stripe[8]]
    d_py = ec.decode(profile, got, use_native=False)
    d_nat = ec.decode(profile, got, use_native=True)
    for a, b in zip(d_py, d_nat):
        assert np.array_equal(a, b)


def test_native_kernel_matches_table():
    """The port's ``gf256.cc`` (built here with the host compiler)
    against the table, a length with a ragged SSSE3 tail."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, size=4099, dtype=np.uint8)
    for coef in (0, 1, 2, 0x53, 0xFF):
        dst = rng.integers(0, 256, size=4099, dtype=np.uint8)
        want = dst ^ ec._MUL[coef][src] if coef else dst.copy()
        ec.gf_mul_xor_native(dst, src, coef)
        assert np.array_equal(dst, want)


# ---------------- parity of the codec with the JAX package ----------------

@pytest.mark.parametrize("name", ["rs-2-1", "rs-4-2", "rs-6-3"])
def test_codec_matches_the_reference(name):
    """For seeded blocks (ragged lengths included): the generator, the
    parity cells, and decode and reconstruct under every erasure pattern
    of up to m cells equal the JAX package's, bit for bit."""
    port, ref = ec.ECProfile.parse(name), jax_ec.ECProfile.parse(name)
    assert np.array_equal(port.gen, ref.gen)
    k, m = port.k, port.m
    for blen in (1, k * 64, k * 97 + 5):
        data = _block(blen, seed=blen + k)
        cells, cs = ec.split(data, k)
        jcells, jcs = jax_ec.split(data, k)
        assert cs == jcs == port.cell_size(blen) == ref.cell_size(blen)
        stripe = cells + ec.encode(port, cells)
        jstripe = list(jcells) + jax_ec.encode(ref, jcells,
                                               use_native=False)
        assert all(np.array_equal(a, b) for a, b in zip(stripe, jstripe))
        for nlost in range(1, m + 1):
            for lost in itertools.combinations(range(k + m), nlost):
                got = [None if i in lost else stripe[i]
                       for i in range(k + m)]
                dec = ec.decode(port, got)
                jdec = jax_ec.decode(ref, got, use_native=False)
                assert all(np.array_equal(a, b) for a, b in zip(dec, jdec))
                reb = ec.reconstruct(port, got, list(lost))
                jreb = jax_ec.reconstruct(ref, got, list(lost),
                                          use_native=False)
                assert sorted(reb) == sorted(jreb) == list(lost)
                for t in lost:
                    assert np.array_equal(reb[t], jreb[t])
                    assert np.array_equal(reb[t], stripe[t])


# ---------------- the cluster: convert, intact and degraded reads ----------

async def _wait_for(pred, timeout=15.0, interval=0.05, what="condition"):
    async def loop():
        while True:
            got = await pred()
            if got:
                return got
            await asyncio.sleep(interval)
    try:
        return await asyncio.wait_for(loop(), timeout)
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


# each package's (SetAttrOpts, JobState)
_PORT = (SetAttrOpts, JobState)
_JAX = (JaxSetAttrOpts, JaxJobState)


async def _settle(pkg) -> None:
    """On the JAX package's cluster, wait out the workers' first periodic
    full block report (1 s after a start). In the reference a report
    built before a cell lands and applied after the stripe's commit drops
    the cell's location (the next scan then rebuilds the cell), which
    would turn an intact read degraded (ROADMAP §C, C7). The port's
    master keeps such a cell, so its cluster waits for nothing."""
    if pkg is _JAX:
        await asyncio.sleep(1.5)


async def _convert(c, paths, profile="rs-2-1", job_path=None, pkg=_PORT):
    """Mark each file, convert (one job over ``job_path``, else one a
    file), and wait until every block's stripe commits (``lb.ec``) and
    its replicas retire (no ``locs``). ``pkg`` is the client's
    package's (SetAttrOpts, JobState)."""
    opts, state = pkg
    for p in paths:
        await c.meta.set_attr(p, opts(ec=profile))
    jobs = [await c.meta.submit_job("ec_convert", p)
            for p in ([job_path] if job_path else paths)]

    async def done():
        states = []
        for j in jobs:
            job = await c.meta.job_status(j)
            assert job.state != state.FAILED, job.message
            states.append(job.state == state.COMPLETED)
        return all(states)
    await _wait_for(done, what="ec_convert jobs")

    async def striped():
        for p in paths:
            fb = await c.meta.get_block_locations(p)
            if not fb.block_locs or not all(
                    lb.ec is not None and not lb.locs
                    for lb in fb.block_locs):
                return False
        return True
    await _wait_for(striped, what="stripes committed, replicas retired")


async def test_convert_and_intact_read(tmp_path):
    """A replicated file of three blocks (a ragged tail) marked rs-2-1,
    converted by the job, read back bit for bit with no decode."""
    async with PortCluster(tmp_path, workers=3) as pc:
        pc.conf.client.block_size = MB
        c = pc.client()
        payload = os.urandom(2 * MB + 12345)
        await c.write_all("/ec/data.bin", payload)
        await _convert(c, ["/ec/data.bin"])
        fb = await c.meta.get_block_locations("/ec/data.bin")
        for lb in fb.block_locs:
            assert lb.ec["profile"] == "rs-2-1"
            assert len(lb.ec["cells"]) == 3
            for cell in lb.ec["cells"]:
                assert cell["locs"], "every cell must have a live holder"
        r = await c.open("/ec/data.bin")
        assert await r.read_all() == payload
        assert r.counters.get("read.ec_degraded", 0) == 0
        # positional reads across cell boundaries stay exact
        for off in (0, MB - 3, MB // 2 + 7, 2 * MB + 12000):
            assert await r.pread(off, 4096) == payload[off:off + 4096]
        # the reference reads this range with pread_view (not ported)
        assert await r.pread(17, 100_000) == payload[17:17 + 100_000]
        # the feed's probe: a striped block has no mmap view
        assert await r.mmap_view(0, 4096) is None
        await r.close()


async def test_degraded_read_and_reconstruction(tmp_path):
    """The holder of a data cell stopped: reads decode from the k
    survivors (``read.ec_degraded``), the master rebuilds the lost cell
    on a live worker, and reads after the heal are intact again."""
    async with PortCluster(tmp_path, workers=3,
                           worker_lost_timeout_ms=1_000) as pc:
        pc.conf.client.block_size = MB
        c = pc.client()
        payload = os.urandom(MB + 4097)
        await c.write_all("/ec/deg.bin", payload)
        await _convert(c, ["/ec/deg.bin"])
        fb = await c.meta.get_block_locations("/ec/deg.bin")
        victim_wid = fb.block_locs[0].ec["cells"][0]["locs"][0]["worker_id"]
        victim = next(w for w in pc.workers if w.worker_id == victim_wid)
        await victim.stop()
        r = await c.open("/ec/deg.bin")
        assert await r.read_all() == payload
        assert r.counters.get("read.ec_degraded", 0) > 0
        await r.close()

        async def healed():
            fb2 = await c.meta.get_block_locations("/ec/deg.bin")
            return all(
                all(any(a["worker_id"] != victim_wid for a in cell["locs"])
                    for cell in lb.ec["cells"])
                for lb in fb2.block_locs)
        await _wait_for(healed, timeout=30.0, what="cell reconstruction")
        counters = pc.master.metrics.counters
        assert counters.get("replication.reconstructs", 0) > 0
        assert counters.get("ec.degraded_reads", 0) > 0
        # the counters are the client's: the delta is held
        before = c.counters.get("read.ec_degraded", 0)
        r2 = await c.open("/ec/deg.bin")
        assert await r2.read_all() == payload
        assert c.counters.get("read.ec_degraded", 0) == before
        await r2.close()


# ---------------- parity of the cluster with the JAX package ----------------

async def _read_cell(addr: dict, block_id: int) -> bytes:
    """One cell by READ_BLOCK from its holder, over a connection of the
    port's (either package's worker answers it)."""
    conn = await Connection(
        f"{addr.get('ip_addr') or addr['hostname']}:{addr['rpc_port']}"
    ).connect()
    try:
        out = bytearray()
        async for m in conn.call_stream(RpcCode.READ_BLOCK,
                                        header={"block_id": block_id}):
            out += m.data
        return bytes(out)
    finally:
        await conn.close()


async def _ec_layout(c, files, workers, stop, pkg) -> dict:
    """Write ``files``, convert them at rs-2-1 (one job over /ec), and
    return what both packages must agree on: each block's stripe (profile,
    cell size, length, cells), each cell's bytes by READ_BLOCK, the reads
    intact, after one cell holder's stop (``stop(worker)``), and healed."""
    await _settle(pkg)
    for path, data in files:
        await c.write_all(path, data, replicas=2)
    await _convert(c, [p for p, _ in files], job_path="/ec", pkg=pkg)
    stripes, cell_bytes = [], []
    for path, _ in files:
        fb = await c.meta.get_block_locations(path)
        for lb in fb.block_locs:
            e = lb.ec
            stripes.append((path, e["profile"], e["cell_size"],
                            e["block_len"], len(e["cells"])))
            holders = [cl["locs"][0]["worker_id"] for cl in e["cells"]]
            assert len(set(holders)) == 3      # three distinct workers
            for cl in e["cells"]:
                cell_bytes.append(await _read_cell(cl["locs"][0],
                                                   cl["block_id"]))
    intact = [bytes(await c.read_all(p)) == d for p, d in files]
    fb = await c.meta.get_block_locations(files[0][0])
    victim = fb.block_locs[0].ec["cells"][0]["locs"][0]["worker_id"]
    await stop(next(w for w in workers if w.worker_id == victim))
    degraded = [bytes(await c.read_all(p)) == d for p, d in files]

    async def healed():
        for p, _ in files:
            fb = await c.meta.get_block_locations(p)
            if not all(any(a["worker_id"] != victim for a in cl["locs"])
                       for lb in fb.block_locs for cl in lb.ec["cells"]):
                return False
        return True
    await _wait_for(healed, timeout=30.0, what="cells rebuilt")
    after = [bytes(await c.read_all(p)) == d for p, d in files]
    return dict(stripes=stripes, cell_bytes=cell_bytes, intact=intact,
                degraded=degraded, healed=after,
                ec_degraded=c.counters.get("read.ec_degraded", 0) > 0)


@pytest.mark.parametrize("seed", [0, 1])
async def test_cluster_matches_the_reference(tmp_path, seed):
    """One seeded layout, four workers and files of one to three blocks
    at two replicas, converted at rs-2-1 on both packages' clusters: the
    same stripes, the same cell bytes, and the files read back equal
    intact, with one cell holder stopped, and once every cell is live
    again."""
    rng = random.Random(seed)
    block = 64 * KiB
    files = [(f"/ec/f{i}.bin",
              rng.randbytes(rng.randint(0, 2) * block
                            + rng.randint(1, block)))
             for i in range(3)]

    async def stop(w):
        await w.stop()

    async with MiniCluster(workers=4, base_dir=str(tmp_path / "jax"),
                           block_size=block, lost_timeout_ms=1_000) as mc:
        ref = await _ec_layout(mc.client(), files, mc.workers, stop, _JAX)
    async with PortCluster(tmp_path / "port", workers=4,
                           worker_lost_timeout_ms=1_000) as pc:
        pc.conf.client.block_size = block
        port = await _ec_layout(pc.client(), files, pc.workers, stop,
                                _PORT)
    assert port == ref
    assert all(port["intact"] + port["degraded"] + port["healed"])
    assert port["ec_degraded"]


# ---------------- journals and snapshots, both ways ----------------

def _ec_ops(fs, opts_cls, checkpoint: bool) -> None:
    """A file's attributes set and its two blocks planned as stripes: the
    first re-planned (the first attempt's cells freed) and committed, the
    second left planned; with ``checkpoint`` a snapshot is written after
    the commit, so its ``ec`` section and the journal's tail both count."""
    fs.mkdir("/d")
    fs.create_file("/d/f", replicas=2)
    iid = fs.tree.resolve("/d/f").id
    bids = []
    for n in (1000, 777):
        bid = fs._log("alloc_block", {"inode_id": iid})
        fs._log("commit_blocks", {"inode_id": iid, "commits": [[bid, n]]})
        bids.append(bid)
    fs.complete_file("/d/f", 1777)
    fs.set_attr("/d/f", opts_cls(ec="rs-2-1", owner="u", group="g",
                                 mode=0o640, ttl_ms=5000, ttl_action=1,
                                 atime=11, mtime=12,
                                 add_x_attr={"a": b"1", "b": b"2"}))
    fs.set_attr("/d", opts_cls(mode=0o700, ec="rs-6-3"))
    fs.ec_plan(bids[0], "rs-2-1", 2, 1, 500)
    fs.ec_plan(bids[0], "rs-2-1", 2, 1, 500)
    fs.ec_commit(bids[0], [])
    if checkpoint:
        fs.checkpoint()
    fs.set_attr("/d/f", opts_cls(remove_x_attr=["b"], replicas=3))
    fs.ec_plan(bids[1], "rs-2-1", 2, 1, 389)


def _ec_state(fs) -> dict:
    """The stripes, the cell index, the snapshot's ``ec`` section, the
    block table, and the two inodes' statuses (the directory's times
    masked: its entries' applies stamp them at replay)."""
    d = fs.file_status("/d").to_wire()
    d["mtime"] = d["atime"] = 0
    return {"stripes": fs.ec_stripes, "cells": fs.ec_cells,
            "snapshot_ec": fs._snapshot_state()["ec"],
            "blocks": sorted(fs.store.iter_blocks()),
            "status": [d, fs.file_status("/d/f").to_wire()]}


@pytest.mark.parametrize("snapshot", [False, True],
                         ids=["journal", "snapshot"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stripes_reopen_in_the_other_package(tmp_path, writer, snapshot):
    """``set_attr``, ``ec_plan`` and ``ec_put`` written by one package's
    master (all in the journal, or a snapshot's ``ec`` section and a
    journal tail) reopen in the other's to the same stripes, cell index,
    block table and attributes as in the writer's own package."""
    jdir = str(tmp_path / "j")

    def jax_fs():
        return JaxFs(journal=JaxJournal(jdir), store=JaxMemStore())

    def port_fs():
        return MasterFilesystem(journal=Journal(jdir))

    wrote = jax_fs() if writer == "jax" else port_fs()
    _ec_ops(wrote, JaxSetAttrOpts if writer == "jax" else SetAttrOpts,
            snapshot)
    want = _ec_state(wrote)
    wrote.journal.close()
    assert len(want["cells"]) == 6 and len(want["stripes"]) == 2
    assert [s["state"] for s in want["stripes"].values()] == \
        ["committed", "planned"]
    f = want["status"][1]
    assert (f["owner"], f["group"], f["mode"], f["replicas"], f["atime"],
            f["mtime"], f["x_attr"], f["storage_policy"]["ttl_ms"],
            f["storage_policy"]["ttl_action"], f["storage_policy"]["ec"]) \
        == ("u", "g", 0o640, 3, 11, 12, {"a": b"1"}, 5000, 1, "rs-2-1")
    for make in (jax_fs, port_fs):
        fs = make()
        fs.recover()
        got = _ec_state(fs)
        fs.journal.close()
        assert got == want, make.__name__


# ---------------- further cases ----------------

async def test_delete_frees_the_cells(tmp_path):
    """Deleting a striped file frees its block and its cells in the
    master at once, and in the workers' stores at their heartbeats."""
    async with PortCluster(tmp_path, workers=3) as pc:
        pc.conf.client.block_size = 256 * KiB
        c = pc.client()
        await c.write_all("/ec/x.bin", os.urandom(600 * KiB), replicas=2)
        await _convert(c, ["/ec/x.bin"])
        fs = pc.master.fs
        ids = set(fs.ec_cells) | set(fs.ec_stripes)
        assert len(fs.ec_stripes) == 3 and len(fs.ec_cells) == 9
        await c.meta.delete("/ec/x.bin")
        assert fs.ec_stripes == {} and fs.ec_cells == {}
        assert not any(fs.store.block_get(b) for b in ids)
        assert list(fs.store.iter_ec()) == []

        async def freed():
            return not any(w.store.contains(b)
                           for w in pc.workers for b in ids)
        await _wait_for(freed, timeout=5.0, what="stores freed")


async def test_planned_cell_in_a_block_report_is_no_orphan(tmp_path):
    """Cells are registered at ``ec_plan``, before a byte is written: a
    worker's full report carrying a planned cell keeps it (and locates
    it), where a block no file owns is deleted."""
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        await c.write_all("/p.bin", b"p" * 1000)
        fs, w = pc.master.fs, pc.workers[0]
        bid = fs.tree.resolve("/p.bin").blocks[0]
        cells = fs.ec_plan(bid, "rs-2-1", 2, 1, 500)
        orphan = max(cells) + 1000
        for b in (cells[0], orphan):
            info = w.store.create_temp(b, size_hint=500)
            with open(info.path, "wb") as f:
                f.write(b"c" * 500)
            w.store.commit(b, 500)
        await w.block_report_once()
        for _ in range(3):
            await w.heartbeat_once()
        assert w.store.contains(cells[0]) and not w.store.contains(orphan)
        assert set(fs.blocks.locs[cells[0]]) == {w.worker_id}
        assert fs.ec_stripes[bid]["state"] == "planned"


def _striped_master():
    """An in-memory master with workers 1-4 and one file's block at two
    replicas on workers 1 and 2, planned as an rs-2-1 stripe; returns the
    master, the block id and the cell ids."""
    fs = MasterFilesystem(journal=None)
    for wid in (1, 2, 3, 4):
        fs.workers.heartbeat(
            WorkerAddress(worker_id=wid, hostname="h", rpc_port=wid),
            [StorageInfo(capacity=1 << 30, available=1 << 30)])
    fs.create_file("/f", replicas=2)
    bid = fs.add_block("/f").block.id
    fs._commit(fs.tree.resolve("/f"), [CommitBlock(
        block_id=bid, block_len=1000, worker_ids=[1, 2],
        storage_type=StorageType.MEM)])
    return fs, bid, fs.ec_plan(bid, "rs-2-1", 2, 1, 500)


def _holders(fs, cell_id: int) -> set[int]:
    return set(fs.blocks.locs.get(cell_id, {}))


def test_full_report_built_before_a_cell_landed_keeps_it():
    """A worker's full report built before a cell landed on it and
    applied after the stripe's commit (or after the worker's incremental
    report of a rebuilt cell) keeps the cell's location: the stripe stays
    intact and nothing is rebuilt. The worker's next full report is
    built after the cell landed; without it, the cell is dropped."""
    fs, bid, cells = _striped_master()
    fs.ec_commit(bid, [[cells[0], 3, 0], [cells[1], 4, 0],
                       [cells[2], 1, 0]])
    assert fs.worker_block_report(3, {}, {}) == {"delete_blocks": []}
    assert _holders(fs, cells[0]) == {3}
    lb = fs.get_block_locations("/f").block_locs[0]
    assert all(cl["locs"] for cl in lb.ec["cells"])
    fs.worker_block_report(3, {}, {})
    assert _holders(fs, cells[0]) == set()
    # a rebuilt cell, located by its new holder's incremental report
    fs.worker_block_report(2, {cells[0]: 500}, {}, incremental=True)
    fs.worker_block_report(2, {}, {})
    assert _holders(fs, cells[0]) == {2}
    fs.worker_block_report(2, {cells[0]: 500}, {})
    fs.worker_block_report(2, {cells[0]: 500}, {})
    assert _holders(fs, cells[0]) == {2}


def test_report_listing_a_retired_replica_deletes_it_again():
    """A block report built before a retired replica's delete still lists
    it: the master does not locate it again (the stripe's cells serve)
    and tells the worker to delete it again, until a full report no
    longer lists it."""
    fs, bid, cells = _striped_master()
    fs.ec_commit(bid, [[cells[0], 3, 0], [cells[1], 4, 0],
                       [cells[2], 1, 0]])
    assert fs.blocks.locs[bid] == {}
    assert fs.worker_block_report(1, {bid: 1000, cells[2]: 500}, {}) == {
        "delete_blocks": [bid]}
    assert fs.worker_block_report(
        2, {bid: 1000}, {}, incremental=True) == {"delete_blocks": [bid]}
    assert fs.worker_block_report(2, {bid: 1000}, {}) == {
        "delete_blocks": [bid]}
    lb = fs.get_block_locations("/f").block_locs[0]
    assert lb.locs == [] and lb.ec is not None
    assert _holders(fs, cells[2]) == {1}
    # gone from worker 1's next full report: nothing more to delete
    assert fs.worker_block_report(1, {cells[2]: 500}, {}) == {
        "delete_blocks": []}
    assert fs.get_block_locations("/f").block_locs[0].locs == []


@pytest.mark.parametrize("key,value", [("enabled", "false"),
                                       ("profile", '"rs-4-2"'),
                                       ("sweep_interval_s", "60.0")])
def test_ec_conf_key_nothing_reads_is_refused(tmp_path, key, value):
    """Of the ``[ec]`` table only ``convert_cold_s`` is read (by the
    convert job's planner); the other keys load only at the reference's
    defaults, and any other value is refused by name."""
    p = tmp_path / "c.toml"
    p.write_text(f"[ec]\n{key} = {value}\n")
    with pytest.raises(ValueError, match=f"ec.{key} = "):
        ClusterConf.load(str(p))
    p.write_text('[ec]\nenabled = true\nprofile = "rs-6-3"\n'
                 'sweep_interval_s = 0.0\nconvert_cold_s = 30\n')
    assert ClusterConf.load(str(p)).ec.convert_cold_s == 30


async def _drained_rebuild(c, master, pkg) -> dict:
    """One block converted at rs-2-1 over four workers; the holder of
    cell 0 decommissioned and drained: the cell is rebuilt by decode."""
    data = b"".join(bytes([i]) * 1000 for i in range(50))
    await _settle(pkg)
    await c.write_all("/ec/d.bin", data, replicas=2)
    await _convert(c, ["/ec/d.bin"], pkg=pkg)
    fb = await c.meta.get_block_locations("/ec/d.bin")
    victim = fb.block_locs[0].ec["cells"][0]["locs"][0]["worker_id"]
    await c.meta.decommission_worker(victim)

    async def drained():
        master().replication._drain_scan()
        return int(master().fs.workers.workers[victim].state) == int(
            WorkerState.DECOMMISSIONED)
    await _wait_for(drained, timeout=15.0, interval=0.1, what="the drain")
    fb = await c.meta.get_block_locations("/ec/d.bin")
    counters = master().metrics.counters
    return dict(
        on_victim=any(a["worker_id"] == victim for lb in fb.block_locs
                      for cl in lb.ec["cells"] for a in cl["locs"]),
        cells_live=[len(cl["locs"]) for lb in fb.block_locs
                    for cl in lb.ec["cells"]],
        rebuilt=counters.get("replication.reconstructs", 0) > 0,
        copied=counters.get("replication.replicates", 0),
        read=bytes(await c.read_all("/ec/d.bin")) == data)


async def test_cell_on_a_decommissioned_worker_is_rebuilt(tmp_path):
    """A decommission drains a cell by decode, not by copy (``_classify``
    sends a cell to ``_reconstruct`` whichever way it was queued), in
    both packages: the worker flips to DECOMMISSIONED, no cell is located
    on it, and the file reads back."""
    async with MiniCluster(workers=4, base_dir=str(tmp_path / "jax"),
                           block_size=64 * KiB,
                           lost_timeout_ms=30_000) as mc:
        ref = await _drained_rebuild(mc.client(), lambda: mc.master, _JAX)
    async with PortCluster(tmp_path / "port", workers=4) as pc:
        pc.conf.client.block_size = 64 * KiB
        port = await _drained_rebuild(pc.client(), lambda: pc.master,
                                      _PORT)
    assert port == ref
    assert port == dict(on_victim=False, cells_live=[1, 1, 1], rebuilt=True,
                        copied=0, read=True)


async def test_write_blocks_batch_commits_the_senders_checksum(tmp_path):
    """WRITE_BLOCKS_BATCH commits each block with the checksum its sender
    computed, checked first: a block whose bytes do not match is refused
    and leaves nothing in the store."""
    async with PortCluster(tmp_path, workers=1) as pc:
        w = pc.workers[0]
        a, b = os.urandom(3000), os.urandom(17)
        conn = await Connection(w.addr).connect()
        try:
            rep = await conn.call(RpcCode.WRITE_BLOCKS_BATCH, data=pack({
                "blocks": [
                    {"block_id": 9001, "data": a, "crc32": _crc32c(a),
                     "algo": "crc32c"},
                    {"block_id": 9002, "data": b,
                     "crc32": crc_update("crc32", b), "algo": "crc32"}]}))
            res = unpack(rep.data)["results"]
            assert [(r["block_id"], r["len"], r["worker_id"]) for r in res] \
                == [(9001, 3000, w.worker_id), (9002, 17, w.worker_id)]
            ia, ib = w.store.get(9001), w.store.get(9002)
            assert (ia.crc32c, ia.crc_algo) == (_crc32c(a), "crc32c")
            assert (ib.crc32c, ib.crc_algo) == (crc_update("crc32", b),
                                                "crc32")
            with open(ia.path, "rb") as f:
                assert f.read() == a
            with pytest.raises(err.AbnormalData, match="9003"):
                await conn.call(RpcCode.WRITE_BLOCKS_BATCH, data=pack({
                    "blocks": [{"block_id": 9003, "data": a,
                                "crc32": _crc32c(a) ^ 1,
                                "algo": "crc32c"}]}))
            assert not w.store.contains(9003)
        finally:
            await conn.close()


def test_an_odd_sized_cell_pins_against_the_plain_version(tmp_path):
    """rs-6-3 at a 64 MiB block gives cells of 11,184,811 bytes, not a
    multiple of 4: such a cell's pin is verified on the CPU by K1's plain
    version (the padded words) against the host hash."""
    import torch
    from curvine_tpu_torch.gpu.cuda_ops import (block_checksum,
                                                block_checksum_host)
    from curvine_tpu_torch.gpu.hbm import HbmTier
    from curvine_tpu_torch.worker.promote import promote_block
    n = ec.ECProfile.parse("rs-6-3").cell_size(64 * MB)
    assert n == 11_184_811 and n % 4
    cell = np.random.default_rng(3).integers(0, 256, n, dtype=np.uint8)
    path = tmp_path / "cell.blk"
    cell.tofile(path)
    tier = HbmTier(16 * MB, device=torch.device("cpu"))
    assert promote_block(tier, 77, str(path), crc=_crc32c(cell),
                         crc_algo="crc32c") == n
    got = tier.get(77)
    assert torch.equal(got.reshape(-1).view(torch.uint8),
                       torch.from_numpy(cell))
    assert block_checksum(got.reshape(-1).view(torch.uint8)) == \
        block_checksum_host(cell)
