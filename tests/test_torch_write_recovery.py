"""Port parity: the client's write recovery (``client/writer.py``: the
replay buffer, whole-block recovery, ``hflush``), the six client fields
(``common/conf.py``, ``client/fs_client.py``, ``client/unified.py``) and
the reader's location refresh (``client/reader.py``) of
``curvine_tpu_torch``, against the JAX package on the CPU.

Mirrors, from tests/test_write_path.py, the vectors that need the replay
buffer, each with that file's ``write_chunk_size`` of 64 KB set through
the conf: ``test_mid_chunk_death_last_replica_replayed`` (:83),
``test_replay_disabled_surfaces_the_loss`` (:105),
``test_open_death_dead_workers_replaced`` (:153), ``test_finish_death``
(:178) at one replica, ``test_sc_eio_mid_write_recovers`` (:226),
``test_sc_commit_death_replayed`` (:249),
``test_zero_live_workers_recovery_waits`` (:271) and
``test_hflush_acks_only_durable_bytes`` (:302). They run against the
port's own cluster (``tests/torch_cluster.py::PortCluster``); a worker
dies by its own ``stop()`` and refuses a call by a handler that raises,
as the port has no fault injector. The parity cases kill the open
block's first leg at seeded points (block, offset, replicas 1-3, short
circuit on and off) under both packages' clients and clusters and
compare the file's bytes, its block lengths, where its blocks are and
the writer's counters. Bytes compare exactly."""

import asyncio
import copy
import getpass
import random
import time

import numpy as np
import pytest

from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu.common.conf import TierConf as JaxTier
from curvine_tpu.common.types import StorageType as JaxStorageType
from curvine_tpu.testing import MiniCluster
from curvine_tpu_torch.client.fs_client import _os_groups, _os_user
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import TierConf
from curvine_tpu_torch.common.types import StorageType
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.ufs import memory as memufs
from torch_cluster import PortCluster

KB = 1 << 10
MB = 1 << 20
BLOCK = 256 * KB
LOST_MS = 2_000
COUNTERS = ("write.block_replay_bytes", "write.replica_failover",
            "write.degraded_commits")


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _cfg(mc, sc: bool = False, **client):
    """A client of ``mc`` configured as tests/test_write_path.py's
    ``_cfg``: several chunks a block, so that deaths land mid-block."""
    cc = mc.conf.client
    cc.short_circuit = sc
    cc.write_chunk_size = 64 * KB
    cc.rpc_timeout_ms = 3_000
    cc.conn_retry_max = 2
    cc.conn_retry_base_ms = 50
    for k, v in client.items():
        setattr(cc, k, v)
    return mc.client()


def _by_id(mc, worker_id):
    return next(w for w in mc.workers if w.worker_id == worker_id)


async def _locs(c, path):
    fb = await c.meta.get_block_locations(path)
    return [(lb.block.id, [x.worker_id for x in lb.locs])
            for lb in fb.block_locs]


async def _lens(c, path):
    fb = await c.meta.get_block_locations(path)
    return [lb.block.len for lb in fb.block_locs]


# ------------------------------------------------------------ the vectors

async def test_mid_chunk_death_last_replica_replayed(tmp_path):
    async with PortCluster(tmp_path, 3) as mc:
        c = _cfg(mc)
        data = _bytes(768 * KB, 32)
        w = await c.create("/rp.bin", replicas=1, block_size=BLOCK)
        await w.write(data[:100 * KB])           # mid block 1: nothing
        #                                          sealed yet
        victim = w._upload_locs[0].worker_id
        await _by_id(mc, victim).stop()
        await w.write(data[100 * KB:])
        await w.close()
        assert bytes(await c.read_all("/rp.bin")) == data
        assert c.counters.get("write.block_replay_bytes", 0) > 0
        for bid, ids in await _locs(c, "/rp.bin"):
            assert victim not in ids, (bid, ids)


async def test_replay_disabled_surfaces_the_loss(tmp_path):
    async with PortCluster(tmp_path, 3) as mc:
        c = _cfg(mc, write_replay_buffer=False)
        w = await c.create("/noreplay.bin", replicas=1, block_size=BLOCK)
        await w.write(b"x" * (100 * KB))
        victim = w._upload_locs[0].worker_id
        await _by_id(mc, victim).stop()
        with pytest.raises((err.CurvineError, OSError)):
            await w.write(b"y" * (300 * KB))
            await w.close()
        await w.abort()
        assert "write.block_replay_bytes" not in c.counters


async def test_open_death_dead_workers_replaced(tmp_path):
    async with PortCluster(tmp_path, 3) as mc:
        c = _cfg(mc)
        survivor = mc.workers[2].worker_id
        await mc.workers[0].stop()
        await mc.workers[1].stop()
        data = _bytes(300 * KB, 34)
        w = await c.create("/dead.bin", replicas=1, block_size=BLOCK)
        await w.write(data)
        await w.close()
        assert bytes(await c.read_all("/dead.bin")) == data
        for bid, ids in await _locs(c, "/dead.bin"):
            assert ids == [survivor], (bid, ids)


async def test_finish_death(tmp_path):
    """One replica: the victim dies after every chunk reached it, before
    the finish; the seal recovers the whole block elsewhere."""
    async with PortCluster(tmp_path, 3) as mc:
        c = _cfg(mc)
        data = _bytes(128 * KB, 35)
        w = await c.create("/fin.bin", replicas=1, block_size=BLOCK)
        await w.write(data)                      # streamed, block open
        assert w._block is not None
        victim = w._upload_locs[0].worker_id
        await _by_id(mc, victim).stop()
        await w.close()                          # the finish hits it
        assert bytes(await c.read_all("/fin.bin")) == data
        [(bid, ids)] = await _locs(c, "/fin.bin")
        assert victim not in ids, (bid, ids)
        assert c.counters["write.block_replay_bytes"] == len(data)


class _EIOOnce:
    """A file whose next write fails with EIO: the worker's media."""

    def __init__(self, f):
        self._f = f
        self.fired = False

    def write(self, b):
        if not self.fired:
            self.fired = True
            raise OSError(5, "Input/output error")
        return self._f.write(b)

    def close(self):
        self._f.close()


async def test_sc_eio_mid_write_recovers(tmp_path):
    async with PortCluster(tmp_path, 2) as mc:
        c = _cfg(mc, sc=True)
        data = _bytes(400 * KB, 36)
        w = await c.create("/eio.bin", replicas=1, block_size=BLOCK)
        await w.write(data[:64 * KB])
        assert w._sc_file is not None, "short circuit did not engage"
        victim = w._sc_worker_id
        w._sc_file = _EIOOnce(w._sc_file)
        await w.write(data[64 * KB:])
        await w.close()
        assert bytes(await c.read_all("/eio.bin")) == data
        assert c.counters.get("write.replica_failover", 0) >= 1
        assert c.counters.get("write.block_replay_bytes", 0) > 0
        bid, ids = (await _locs(c, "/eio.bin"))[0]
        assert victim not in ids, (bid, ids)


async def test_sc_commit_death_replayed(tmp_path):
    """SC_WRITE_COMMIT refused once on a one-worker cluster: recovery
    drops the exclusion (the failed worker is the only one), replays,
    and the second commit lands."""
    async with PortCluster(tmp_path, 1) as mc:
        c = _cfg(mc, sc=True)
        wk = mc.workers[0]
        hits = []

        async def refuse_once(msg, conn):
            if not hits:
                hits.append(msg)
                raise err.CurvineError("commit refused",
                                       code=err.ErrorCode.IO)
            return await wk._sc_write_commit(msg, conn)

        wk.rpc.register(RpcCode.SC_WRITE_COMMIT, refuse_once)
        data = _bytes(BLOCK, 37)
        await c.write_all("/scc.bin", data, replicas=1)
        assert len(hits) == 1
        assert bytes(await c.read_all("/scc.bin")) == data
        assert c.counters["write.block_replay_bytes"] == len(data)
        assert c.counters["sc.bytes.written"] == 2 * len(data)


async def test_zero_live_workers_recovery_waits(tmp_path):
    """The last replica lost while no worker is placeable: the recovery
    asks again inside its 90 s deadline and completes once a worker
    comes back, past the lost timeout."""
    async with PortCluster(tmp_path, 1,
                           worker_lost_timeout_ms=LOST_MS) as mc:
        c = _cfg(mc)
        data = _bytes(512 * KB, 40)
        w = await c.create("/zero.bin", replicas=1, block_size=BLOCK)
        await w.write(data[:100 * KB])
        await mc.workers[0].stop()

        async def revive():
            await asyncio.sleep(3.5)
            await mc.add_worker()

        reviver = asyncio.create_task(revive())
        await w.write(data[100 * KB:])
        await w.close()
        await reviver
        assert bytes(await c.read_all("/zero.bin")) == data
        assert c.counters.get("write.block_replay_bytes", 0) > 0


async def test_hflush_acks_only_durable_bytes(tmp_path):
    """An hflush that raced a replica loss recovers before it acks; the
    sealed blocks' commits are journaled and seen by another client while
    the file stays open."""
    async with PortCluster(tmp_path, 3) as mc:
        c = _cfg(mc, write_min_replicas=2)
        data = _bytes(2 * BLOCK + 200 * KB, 38)
        w = await c.create("/hf.bin", replicas=2, block_size=BLOCK)
        await w.write(data[:2 * BLOCK + 96 * KB])
        victim = w._upload_locs[0].worker_id
        await _by_id(mc, victim).stop()
        await w.write(data[2 * BLOCK + 96 * KB:])
        await w.hflush()
        assert len(w._uploads) >= 2, "hflush acked below write_min_replicas"
        other = mc.client()
        fb = await other.meta.get_block_locations("/hf.bin")
        assert not fb.status.is_complete
        assert [lb.block.len for lb in fb.block_locs][:2] == [BLOCK] * 2
        await w.close()
        assert bytes(await c.read_all("/hf.bin")) == data
        for bid, ids in (await _locs(c, "/hf.bin"))[2:]:
            assert victim not in ids and len(ids) == 2, (bid, ids)


async def test_hflush_journals_sealed_commits(tmp_path):
    """``hflush`` right after a seal sends the pending commit with
    ``only_flush``: the block is committed and the file not complete."""
    async with PortCluster(tmp_path, 1) as mc:
        c = _cfg(mc, sc=True)
        calls = []
        real = c.meta.complete_file

        async def complete_file(path, length, commit_blocks=None,
                                only_flush=False):
            calls.append((length, len(commit_blocks or []), only_flush))
            return await real(path, length, commit_blocks=commit_blocks,
                              only_flush=only_flush)

        c.meta.complete_file = complete_file
        data = _bytes(2 * BLOCK, 41)
        w = await c.create("/hj.bin", replicas=1, block_size=BLOCK)
        await w.write(data)                      # both blocks sealed
        await w.hflush()
        assert calls == [(2 * BLOCK, 1, True)]
        fb = await mc.client().meta.get_block_locations("/hj.bin")
        assert not fb.status.is_complete
        assert [lb.block.len for lb in fb.block_locs] == [BLOCK] * 2
        await w.close()
        assert calls[-1] == (2 * BLOCK, 0, False)
        assert bytes(await c.read_all("/hj.bin")) == data


# ------------------------------------------------ parity with the reference

def _kill_points(n: int = 8, seed: int = 15) -> list[tuple]:
    """(replicas, short circuit, block, offset) of the seeded kills; an
    offset of None makes ``block`` the file's last, partial block and
    kills after every byte is sent, before the close. One replica is
    killed in the first block only (an earlier sealed block on the
    victim would have no other copy)."""
    rng = random.Random(seed)
    out = [(1, True, 0, None), (2, False, 2, None)]
    while len(out) < n:
        replicas = rng.choice((1, 2, 3))
        sc = rng.random() < 0.5
        block = 0 if replicas == 1 else rng.randrange(3)
        out.append((replicas, sc, block, rng.randrange(1, BLOCK)))
    return out


async def _kill_run(mc, c, kill, data, by_id):
    """Write ``data`` to /p.bin under ``c``, killing the open block's
    first leg at ``kill``; returns (bytes read back, block lengths,
    blocks on the victim after the kill, counters)."""
    replicas, sc, block, offset = kill
    w = await c.create("/p.bin", replicas=replicas, block_size=BLOCK)
    at = block * BLOCK + (len(data) % BLOCK if offset is None else offset)
    await w.write(data[:at])
    await w.flush()
    victim = w._sc_worker_id if w._sc_file is not None \
        else w._upload_locs[0].worker_id
    await by_id(victim).stop()
    await w.write(data[at:])
    await w.close()
    locs = await _locs(c, "/p.bin")
    on_victim = [i for i, (_, ids) in enumerate(locs)
                 if i >= block and victim in ids]
    return (bytes(await c.read_all("/p.bin")), await _lens(c, "/p.bin"),
            on_victim, {k: c.counters.get(k, 0) for k in COUNTERS})


@pytest.mark.parametrize("kill", _kill_points(),
                         ids=lambda k: "r{}-{}-b{}-{}".format(
                             k[0], "sc" if k[1] else "ws", k[2], k[3]))
async def test_recovery_equal_in_both_packages(kill, tmp_path):
    last = kill[2] if kill[3] is None else 3
    data = _bytes(last * BLOCK + 100 * KB, kill[3] or 7)
    async with MiniCluster(workers=4, base_dir=str(tmp_path / "jax"),
                           lost_timeout_ms=30_000) as jmc:
        jc = _cfg(jmc, sc=kill[1])
        jax = await _kill_run(jmc, jc, kill, data,
                              lambda wid: _by_id(jmc, wid))
    async with PortCluster(tmp_path / "port", 4) as pmc:
        pc = _cfg(pmc, sc=kill[1])
        port = await _kill_run(pmc, pc, kill, data,
                               lambda wid: _by_id(pmc, wid))
    assert port[0] == jax[0] == data
    assert port[1] == jax[1] == [BLOCK] * last + [100 * KB]
    assert port[2] == jax[2] == []
    assert port[3] == jax[3]
    assert port[3]["write.replica_failover"] >= 1


# ------------------------------------------------------------- the refresh

async def _refresh_case(c, workers, stop, heal, add_worker):
    """A two-replica file's reader opened, the block healed onto a third
    worker (when ``heal``), both original holders stopped; returns the
    read (or the error) and the GET_BLOCK_LOCATIONS calls after the
    open."""
    data = _bytes(BLOCK, 50)
    await c.write_all("/two.bin", data, replicas=2)
    [(bid, holders)] = await _locs(c, "/two.bin")
    r = await c.open("/two.bin")
    calls = []
    real = c.meta.get_block_locations

    async def get_block_locations(path, *a, **kw):
        calls.append(path)
        return await real(path, *a, **kw)

    if heal:
        third = await add_worker()
        await stop(holders[0])
        deadline = time.monotonic() + 20
        while sorted((await _locs(c, "/two.bin"))[0][1]) != \
                sorted([holders[1], third.worker_id]):
            assert time.monotonic() < deadline, "never healed"
            await asyncio.sleep(0.05)
        await stop(holders[1])
    else:
        await stop(holders[0])
        await stop(holders[1])
    c.meta.get_block_locations = get_block_locations
    try:
        got = bytes(await r.read_all())
    except Exception as e:  # noqa: BLE001 — compared by the caller
        got = e
    return got, data, calls


@pytest.mark.parametrize("heal", [True, False])
async def test_reader_refreshes_locations_once(heal, tmp_path):
    async with PortCluster(tmp_path / "port", 2,
                           worker_lost_timeout_ms=3_000) as pmc:
        pc = _cfg(pmc)
        port = await _refresh_case(
            pc, pmc.workers, lambda wid: _by_id(pmc, wid).stop(), heal,
            pmc.add_worker)
    async with MiniCluster(workers=2, base_dir=str(tmp_path / "jax"),
                           lost_timeout_ms=3_000) as jmc:
        jmc.master.replication.scan_interval_s = 0.3
        jc = _cfg(jmc)
        jax = await _refresh_case(
            jc, jmc.workers, lambda wid: _by_id(jmc, wid).stop(), heal,
            jmc.add_worker)
    for got, data, calls in (port, jax):
        assert calls == ["/two.bin"]
        if heal:
            assert got == data
        else:
            assert isinstance(got, Exception), got
    assert isinstance(port[0], err.CurvineError) or heal


# ------------------------------------------------------------- the fields

async def test_storage_type_lands_in_the_ssd_tier_in_both_packages(
        tmp_path):
    tiers = [("mem", 64 * MB), ("ssd", 64 * MB)]
    jconf = JaxConf()
    jconf.worker.tiers = [JaxTier(storage_type=t, dir=str(
        tmp_path / "jax" / t), capacity=n) for t, n in tiers]
    data = _bytes(BLOCK + 5, 60)
    async with MiniCluster(workers=1, base_dir=str(tmp_path / "jax"),
                           conf=jconf, lost_timeout_ms=30_000) as jmc:
        jc = _cfg(jmc, storage_type="ssd")
        await jc.write_all("/ssd.bin", data, block_size=BLOCK)
        jtypes = [jmc.workers[0].store.get(bid, touch=False)
                  .tier.storage_type for bid, _ in await _locs(jc,
                                                               "/ssd.bin")]
        assert bytes(await jc.read_all("/ssd.bin")) == data
    async with PortCluster(tmp_path / "port", 0) as pmc:
        wk = await pmc.add_worker(tiers=[TierConf(
            storage_type=t, dir=str(tmp_path / "port" / t), capacity=n)
            for t, n in tiers])
        pc = _cfg(pmc, storage_type="ssd")
        await pc.write_all("/ssd.bin", data, block_size=BLOCK)
        ptypes = [wk.store.get(bid, touch=False).tier.storage_type
                  for bid, _ in await _locs(pc, "/ssd.bin")]
        assert bytes(await pc.read_all("/ssd.bin")) == data
        # a create's own storage_type wins over the conf's
        w = await pc.create("/mem.bin", storage_type="mem")
        await w.write(data)
        await w.close()
        [(bid, _)] = await _locs(pc, "/mem.bin")
        assert wk.store.get(bid, touch=False).tier.storage_type == \
            StorageType.MEM
    assert ptypes == [StorageType.SSD] * 2
    assert [int(t) for t in jtypes] == [int(JaxStorageType.SSD)] * 2


async def test_load_from_ufs_under_an_ssd_mount_writes_the_ssd_tier(
        tmp_path):
    memufs.reset()
    async with PortCluster(tmp_path, 0) as pmc:
        wk = await pmc.add_worker(tiers=[
            TierConf(storage_type=t, dir=str(tmp_path / t),
                     capacity=64 * MB) for t in ("mem", "ssd")])
        c = pmc.client()
        data = _bytes(3 * MB, 61)
        from curvine_tpu_torch.ufs.base import create_ufs
        await create_ufs("mem://t").write_all("mem://t/a.bin", data)
        await c.meta.mount("/ssd", "mem://t", storage_type="ssd")
        await c.meta.mount("/plain", "mem://t")
        assert await c.load_from_ufs("/ssd/a.bin") == len(data)
        assert await c.load_from_ufs("/plain/a.bin") == len(data)
        got = {}
        for p in ("/ssd/a.bin", "/plain/a.bin"):
            got[p] = {wk.store.get(bid, touch=False).tier.storage_type
                      for bid, _ in await _locs(c, p)}
            assert bytes(await c.read_all(p)) == data
        assert got == {"/ssd/a.bin": {StorageType.SSD},
                       "/plain/a.bin": {StorageType.MEM}}
    memufs.reset()


async def test_user_and_groups_reach_the_master(tmp_path):
    async with PortCluster(tmp_path, 1) as pmc:
        seen = []
        real = pmc.master.acl.check

        def check(q):
            seen.append((q.get("user"), q.get("groups")))
            return real(q)

        pmc.master.acl.check = check
        c = _cfg(pmc, user="alice", groups=["supergroup", "ml"])
        await c.write_all("/u.bin", b"abc")
        assert bytes(await c.read_all("/u.bin")) == b"abc"
        await c.meta.delete("/u.bin")
        assert len(seen) >= 5
        assert set(map(str, seen)) == {str(("alice", ["supergroup",
                                                      "ml"]))}
        # an empty user and groups: the OS user and that user's groups,
        # as the reference's client sends them
        cc = copy.deepcopy(pmc.conf)
        cc.client.user, cc.client.groups = "", []
        from curvine_tpu.client.fs_client import FsClient as JaxFsClient
        from curvine_tpu_torch.client.fs_client import FsClient
        jconf = JaxConf()
        port_meta, jax_meta = FsClient(cc), JaxFsClient(jconf)
        try:
            assert port_meta.user == jax_meta.user == getpass.getuser() \
                == _os_user()
            assert port_meta.groups == jax_meta.groups == \
                _os_groups(_os_user())
        finally:
            await port_meta.close()
            await jax_meta.close()


async def test_conn_retry_sets_the_retry_policy(tmp_path):
    from curvine_tpu.client.fs_client import FsClient as JaxFsClient
    from curvine_tpu_torch.client.fs_client import FsClient
    from curvine_tpu_torch.common.conf import ClusterConf
    pconf, jconf = ClusterConf(), JaxConf()
    for conf in (pconf, jconf):
        conf.client.conn_retry_max = 6
        conf.client.conn_retry_base_ms = 25
        conf.client.master_addrs = ["127.0.0.1:1"]   # nothing listens
    port, jax = FsClient(pconf), JaxFsClient(jconf)
    try:
        for m in (port, jax):
            assert (m.retry.max_retries, m.retry.base_ms) == (6, 25)
        # six retries of a refused connect: at least the backoff's floor
        # of 25 ms x (1 + 2 + ... + 32) / 2 before the error
        t = time.monotonic()
        with pytest.raises(err.CurvineError):
            await port.file_status("/x")
        assert time.monotonic() - t >= 0.025 * 63 / 2
    finally:
        await port.close()
        await jax.close()
