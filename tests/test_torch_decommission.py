"""Port parity: worker decommission and the drain (``master/worker_map.py``,
``master/store.py``, ``master/filesystem.py``, ``master/server.py``,
``master/replication.py::_drain_scan``, ``client/fs_client.py::
decommission_worker``) of ``curvine_tpu_torch``, against the JAX package
on the CPU.

Mirrors the 8 tests of tests/test_decommission.py against the port's
own cluster (``tests/torch_cluster.py::PortCluster``): the drain and its
end, the purged locations, the intent across a master restart, the
superuser check, the unknown worker, the drain when the count cannot be
met, the drain waiting for a report after a return from LOST, and the
draining worker refusing new writes. The scan is driven by
``replication._drain_scan()``, as the reference's ``_drain_until``
drives it. The parity cases run one seeded layout on a ``MiniCluster``
and on a ``PortCluster`` (three workers, files at 1-3 replicas, one
worker drained), replay one seeded sequence of heartbeats, intents and
loss checks through both packages' ``WorkerMap``, and reopen each
package's journal and snapshot with the other's master."""

import asyncio
import random
import time

import pytest

from curvine_tpu.common.journal import Journal as JaxJournal
from curvine_tpu.common.types import WorkerAddress as JaxAddress
from curvine_tpu.common.types import WorkerState as JaxState
from curvine_tpu.master import worker_map as jax_worker_map
from curvine_tpu.master.filesystem import MasterFilesystem as JaxFs
from curvine_tpu.master.store import MemMetaStore as JaxMemStore
from curvine_tpu.testing import MiniCluster
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.journal import Journal
from curvine_tpu_torch.common.types import (StorageType, WorkerAddress,
                                            WorkerState)
from curvine_tpu_torch.master import worker_map as port_worker_map
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack
from torch_cluster import PortCluster

KiB = 1 << 10


async def _drain_until(master, wid, state, timeout=15.0):
    async def wait():
        while True:
            master.replication._drain_scan()
            w = master.fs.workers.workers.get(wid)
            if w is not None and w.state == state:
                return w
            await asyncio.sleep(0.1)
    return await asyncio.wait_for(wait(), timeout)


def _ids(fb) -> set[int]:
    return {x.worker_id for lb in fb.block_locs for x in lb.locs}


async def test_decommission_drains_then_completes(tmp_path):
    async with PortCluster(tmp_path, workers=2) as pc:
        c = pc.client()
        payload = b"d" * (256 * KiB)
        await c.write_all("/deco/f.bin", payload)
        fb = await c.meta.get_block_locations("/deco/f.bin")
        holder = fb.block_locs[0].locs[0].worker_id
        other = next(w.worker_id for w in pc.workers
                     if w.worker_id != holder)

        state = await c.meta.decommission_worker(holder)
        assert state == int(WorkerState.DECOMMISSIONING)
        # the draining worker's replica still serves reads
        assert bytes(await c.read_all("/deco/f.bin")) == payload
        # placement skips it: new files land on the other worker only
        for i in range(4):
            await c.write_all(f"/deco/n{i}.bin", b"x" * KiB)
            fb2 = await c.meta.get_block_locations(f"/deco/n{i}.bin")
            assert _ids(fb2) == {other}

        # the drain copies its block and ends
        await _drain_until(pc.master, holder, WorkerState.DECOMMISSIONED)
        fb3 = await c.meta.get_block_locations("/deco/f.bin")
        assert _ids(fb3) == {other}
        assert bytes(await c.read_all("/deco/f.bin")) == payload

        # recommission: LIVE, placeable again
        state = await c.meta.decommission_worker(holder, on=False)
        assert state == int(WorkerState.LIVE)
        assert holder in {w.address.worker_id
                          for w in pc.master.fs.workers.live_workers()}


async def test_drained_worker_locations_purged(tmp_path):
    """After the drain the worker's block-map entries are gone, and its
    block reports do not bring them back."""
    async with PortCluster(tmp_path, workers=2) as pc:
        c = pc.client()
        await c.write_all("/purge/f.bin", b"p" * 8192)
        fb = await c.meta.get_block_locations("/purge/f.bin")
        bid = fb.block_locs[0].block.id
        holder = fb.block_locs[0].locs[0].worker_id
        await c.meta.decommission_worker(holder)
        await _drain_until(pc.master, holder, WorkerState.DECOMMISSIONED)
        bm = pc.master.fs.blocks
        assert holder not in bm.locs.get(bid, {})
        assert bid not in bm.worker_blocks.get(holder, set())
        # a full report from the drained worker does not re-add it
        pc.master.fs.worker_block_report(holder, {bid: 8192}, {bid: 1})
        assert holder not in bm.locs.get(bid, {})
        # ... nor does the worker's own
        worker = next(w for w in pc.workers if w.worker_id == holder)
        await worker.block_report_once()
        assert holder not in bm.locs.get(bid, {})
        assert bytes(await c.read_all("/purge/f.bin")) == b"p" * 8192


async def test_decommission_intent_survives_restart(tmp_path):
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        await c.write_all("/deco2/f.bin", b"y" * 4096)
        fb = await c.meta.get_block_locations("/deco2/f.bin")
        wid = fb.block_locs[0].locs[0].worker_id
        await c.meta.decommission_worker(wid)
        await pc.restart_master()
        # the worker registers again by its heartbeat; the journaled
        # intent keeps it DECOMMISSIONING, not LIVE
        w = pc.master.fs.workers.workers[wid]
        assert wid in pc.master.fs.workers.deco_ids
        assert w.state == WorkerState.DECOMMISSIONING
        assert list(pc.master.fs.store.iter_deco()) == [wid]
        worker = pc.workers[0]

        async def flagged():
            while not worker.draining:
                await asyncio.sleep(0.05)
        await asyncio.wait_for(flagged(), 10.0)


async def test_decommission_requires_superuser(tmp_path):
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        wid = pc.workers[0].worker_id
        c.meta.user, c.meta.groups = "mallory", ["mallory"]
        with pytest.raises(err.PermissionDenied):
            await c.meta.decommission_worker(wid)
        assert pc.master.fs.workers.deco_ids == set()


async def test_decommission_unknown_worker(tmp_path):
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        with pytest.raises(err.WorkerNotFound):
            await c.meta.decommission_worker(999_999)
        # an intent for a worker long gone can always be cleared
        assert await c.meta.decommission_worker(999_999, on=False) == -1


async def test_drain_completes_when_replica_count_unreachable(tmp_path):
    """Two workers, two replicas: draining one can never restore the
    count (no LIVE non-holder). The drain ends all the same, as the
    other replica keeps the block readable."""
    async with PortCluster(tmp_path, workers=2) as pc:
        c = pc.client()
        payload = b"c" * (64 * KiB)
        await c.write_all("/capped.bin", payload, replicas=2)
        fb = await c.meta.get_block_locations("/capped.bin")
        assert len(fb.block_locs[0].locs) == 2
        victim = fb.block_locs[0].locs[0].worker_id

        await c.meta.decommission_worker(victim)
        await _drain_until(pc.master, victim, WorkerState.DECOMMISSIONED,
                           timeout=10.0)
        assert bytes(await c.read_all("/capped.bin")) == payload
        # the drained worker stays listed, as safe to remove
        info = await c.meta.master_info()
        drained = [x for x in info.lost_workers
                   if x.state == WorkerState.DECOMMISSIONED]
        assert [x.address.worker_id for x in drained] == [victim]
        assert victim not in {x.address.worker_id
                              for x in info.live_workers}


async def test_drain_waits_for_block_report_after_lost_return(tmp_path):
    """A draining worker that goes LOST (its block-map entries dropped)
    and comes back does not flip DECOMMISSIONED before a full block
    report has rebuilt the master's view of what it holds."""
    async with PortCluster(tmp_path, workers=2) as pc:
        c = pc.client()
        payload = b"L" * (64 * KiB)
        await c.write_all("/lostret.bin", payload)
        fb = await c.meta.get_block_locations("/lostret.bin")
        victim = fb.block_locs[0].locs[0].worker_id
        worker = next(w for w in pc.workers if w.worker_id == victim)
        await c.meta.decommission_worker(victim)
        # the report the master asks for on the return would race the
        # scans below: hold the worker's forced reports off meanwhile
        worker._forced_report_at = time.monotonic() + 3600

        # a partition: LOST drops the worker's block-map entries
        wmap = pc.master.fs.workers
        wmap.workers[victim].state = WorkerState.LOST
        pc.master.fs.blocks.worker_lost(victim)

        async def back():
            while wmap.workers[victim].state != WorkerState.DECOMMISSIONING:
                await asyncio.sleep(0.05)
        await asyncio.wait_for(back(), 5.0)
        for _ in range(5):
            pc.master.replication._drain_scan()
            await asyncio.sleep(0.05)
        assert wmap.workers[victim].state == WorkerState.DECOMMISSIONING

        # a full report gives the view back; the drain can then end
        await worker.block_report_once()
        await _drain_until(pc.master, victim, WorkerState.DECOMMISSIONED)
        assert bytes(await c.read_all("/lostret.bin")) == payload


async def test_draining_worker_refuses_new_writes(tmp_path):
    """A draining worker refuses new write streams with the retryable
    DRAINING code (the flag rides the heartbeat's reply): WRITE_BLOCK and
    SC_WRITE_OPEN both, while a whole write places elsewhere."""
    async with PortCluster(tmp_path, workers=2) as pc:
        pc.conf.client.short_circuit = False
        c = pc.client()
        victim = pc.workers[0]
        await c.meta.decommission_worker(victim.worker_id)

        async def flagged(want: bool):
            while victim.draining != want:
                await asyncio.sleep(0.05)
        await asyncio.wait_for(flagged(True), 10.0)

        conn = await c.pool.get(victim.addr)
        up = await conn.open_upload(RpcCode.WRITE_BLOCK, header={
            "block_id": 999_999, "storage_type": int(StorageType.MEM),
            "algo": "crc32c", "len_hint": 1024})
        with pytest.raises(err.WorkerDraining) as ei:
            await up.finish(header={"crc32": 0, "algo": "crc32c"})
        assert ei.value.retryable
        conn = await c.pool.get(victim.addr)
        with pytest.raises(err.WorkerDraining):
            await conn.call(RpcCode.SC_WRITE_OPEN, data=pack({
                "block_id": 999_998, "storage_type": int(StorageType.MEM),
                "len_hint": 1024}))

        await c.write_all("/drain/new.bin", b"z" * 2048, replicas=1)
        fb = await c.meta.get_block_locations("/drain/new.bin")
        assert victim.worker_id not in _ids(fb)

        await c.meta.decommission_worker(victim.worker_id, on=False)
        await asyncio.wait_for(flagged(False), 10.0)


def test_lost_while_draining_then_back_is_draining_again(monkeypatch):
    """``check_lost`` covers a DECOMMISSIONING worker (its replicas are
    gone, not draining), and its return leaves it DECOMMISSIONING."""
    now = [1_000_000]
    monkeypatch.setattr(port_worker_map, "now_ms", lambda: now[0])
    wm = port_worker_map.WorkerMap(lost_timeout_ms=3_000)
    addr = WorkerAddress(worker_id=4, hostname="h", rpc_port=1)
    wm.heartbeat(addr, [])
    wm.decommission(4)
    now[0] += 3_001
    assert [w.address.worker_id for w in wm.check_lost()] == [4]
    assert wm.workers[4].state == WorkerState.LOST
    assert wm.heartbeat(addr, []).state == WorkerState.DECOMMISSIONING
    assert not wm.has_current_report(4)


@pytest.mark.parametrize("seed", range(4))
def test_worker_map_matches_the_reference(monkeypatch, seed):
    """One seeded sequence of heartbeats, reports, intents on and off,
    clock steps and loss checks through both packages' ``WorkerMap``:
    the same states, intents, serving, draining and retired workers, and
    report views after every step."""
    rng = random.Random(seed)
    now = [1_000_000]
    monkeypatch.setattr(port_worker_map, "now_ms", lambda: now[0])
    monkeypatch.setattr(jax_worker_map, "now_ms", lambda: now[0])
    ref = jax_worker_map.WorkerMap(lost_timeout_ms=2_000)
    port = port_worker_map.WorkerMap(lost_timeout_ms=2_000)
    ids = [11, 12, 13, 14]

    def view(m):
        return ({k: int(w.state) for k, w in m.workers.items()},
                sorted(m.deco_ids),
                sorted(w.address.worker_id for w in m.serving_workers()),
                sorted(w.address.worker_id
                       for w in m.decommissioning_workers()),
                sorted(w.address.worker_id for w in m.retired_workers()),
                [m.has_current_report(i) for i in ids])

    for _ in range(300):
        wid = rng.choice(ids)
        op = rng.random()
        if op < 0.35:
            ref.heartbeat(JaxAddress(worker_id=wid, hostname="h",
                                     rpc_port=wid), [])
            port.heartbeat(WorkerAddress(worker_id=wid, hostname="h",
                                         rpc_port=wid), [])
        elif op < 0.45:
            ref.mark_reported(wid)
            port.mark_reported(wid)
        elif op < 0.55:
            ref.decommission(wid)
            port.decommission(wid)
        elif op < 0.62:
            ref.recommission(wid)
            port.recommission(wid)
        elif op < 0.68:
            # the drain's flip, as _drain_scan makes it
            for m, st in ((ref, JaxState.DECOMMISSIONED),
                          (port, WorkerState.DECOMMISSIONED)):
                w = m.workers.get(wid)
                if w is not None and int(w.state) == int(
                        WorkerState.DECOMMISSIONING):
                    w.state = st
        elif op < 0.85:
            now[0] += rng.choice([1, 400, 1_500, 2_500])
        else:
            assert sorted(w.address.worker_id for w in port.check_lost()) \
                == sorted(w.address.worker_id for w in ref.check_lost())
        assert view(port) == view(ref)


@pytest.mark.parametrize("snapshot", [False, True], ids=["journal",
                                                         "snapshot"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_deco_intent_reopens_in_the_other_package(tmp_path, writer,
                                                  snapshot):
    """Intents on and off, one of them for a worker never seen, written
    by one package's master (all in the journal, or the first two in a
    snapshot and the rest after it) and reopened by the other's: the same
    ``deco_ids`` and store table."""
    jdir = str(tmp_path / "j")
    if writer == "jax":
        fs = JaxFs(journal=JaxJournal(jdir), store=JaxMemStore())
        addr = JaxAddress
    else:
        fs = MasterFilesystem(journal=Journal(jdir))
        addr = WorkerAddress
    for wid in (3, 5, 8):
        fs.workers.heartbeat(addr(worker_id=wid, hostname="h",
                                  rpc_port=wid), [])
    fs.decommission_worker(3)
    fs.decommission_worker(5)
    if snapshot:
        fs.checkpoint()
    fs.decommission_worker(8)
    fs.decommission_worker(5, on=False)
    fs.decommission_worker(11, on=False)
    want = sorted(fs.workers.deco_ids)
    assert want == [3, 8]
    fs.journal.close()
    if writer == "jax":
        other = MasterFilesystem(journal=Journal(jdir))
    else:
        other = JaxFs(journal=JaxJournal(jdir), store=JaxMemStore())
    other.recover()
    assert sorted(other.workers.deco_ids) == want
    assert list(other.store.iter_deco()) == want
    assert other._snapshot_state()["deco"] == want
    other.journal.close()


@pytest.mark.parametrize("seed", [0, 1])
async def test_drain_matches_the_reference(tmp_path, seed):
    """One seeded layout, three workers and six files of one to three
    blocks at one to three replicas, on both packages' clusters; one
    worker (by its index) drained. Both end with the same worker states,
    every block at its count on LIVE workers (at the two LIVE workers
    where the count is three), no location on the drained worker, and
    the same bytes read back."""
    rng = random.Random(seed)
    block = 64 * KiB
    files = [(f"/par/f{i}.bin", rng.randint(1, 3),
              rng.randbytes(rng.randint(0, 2) * block
                            + rng.randint(1, block)))
             for i in range(6)]
    victim_idx = rng.randrange(3)

    async def run(cluster, client, workers, master):
        c = client()
        for path, rep, data in files:
            await c.write_all(path, data, replicas=rep)
        wids = [w.worker_id for w in workers]
        victim = wids[victim_idx]
        assert await c.meta.decommission_worker(victim) == \
            int(WorkerState.DECOMMISSIONING)
        await _drain_until(master(), victim, WorkerState.DECOMMISSIONED)
        states = [int(master().fs.workers.workers[w].state) for w in wids]
        counts, back = [], []
        for path, rep, data in files:
            fb = await c.meta.get_block_locations(path)
            assert victim not in _ids(fb)
            counts.append([len(lb.locs) for lb in fb.block_locs])
            back.append(bytes(await c.read_all(path)) == data)
        return states, counts, back

    async with MiniCluster(workers=3, base_dir=str(tmp_path / "jax"),
                           block_size=block,
                           lost_timeout_ms=30_000) as mc:
        ref = await run(mc, mc.client, mc.workers, lambda: mc.master)
    async with PortCluster(tmp_path / "port", workers=3) as pc:
        pc.conf.client.block_size = block
        port = await run(pc, pc.client, pc.workers, lambda: pc.master)
    assert port == ref
    states, counts, back = port
    assert sorted(states) == [int(WorkerState.LIVE)] * 2 + [
        int(WorkerState.DECOMMISSIONED)]
    assert counts == [[min(rep, 2)] * len(c)
                      for (_, rep, _), c in zip(files, counts)]
    assert all(back)
