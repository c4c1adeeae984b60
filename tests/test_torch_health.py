"""Port parity: the client's circuit breakers (``client/health.py``, the
reader's order and reports in ``client/reader.py``, the writer's
exclusions in ``client/writer.py``, the shared board of
``client/unified.py``) of ``curvine_tpu_torch``, against the JAX package
on the CPU.

Mirrors the four breaker tests of tests/test_storm.py (:371-461):
``test_breaker_state_machine`` and ``test_breaker_decay_and_order`` on
the port's ``WorkerHealth`` with an injected clock,
``test_reader_skips_open_circuit_worker`` and
``test_writer_placement_excludes_open_breakers``. They run against the
port's own cluster (``tests/torch_cluster.py::PortCluster``); the port
has no fault injector, so a wedged worker is a READ_BLOCK handler that
raises and a dead one is stopped by its own ``stop()``. The parity case
drives both packages' boards with one seeded sequence of outcomes,
admissions and clock steps and compares every answer."""

import random

import pytest

from curvine_tpu.client import health as jax_health
from curvine_tpu_torch.client import health as port_health
from curvine_tpu_torch.client.health import (CLOSED, HALF_OPEN, OPEN,
                                             WorkerHealth)
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.rpc.codes import RpcCode
from torch_cluster import PortCluster

KiB = 1 << 10


def test_breaker_state_machine():
    now = [0.0]
    h = WorkerHealth(fail_threshold=3, open_s=5.0, decay_s=30.0,
                     clock=lambda: now[0])
    a = "w1:9000"
    assert h.state(a) == CLOSED and h.allow(a)
    h.fail(a, worker_id=11)
    h.fail(a, worker_id=11)
    assert h.state(a) == CLOSED            # under the threshold
    h.fail(a, worker_id=11)
    assert h.state(a) == OPEN
    assert not h.allow(a)
    assert h.open_worker_ids() == {11}
    # the open window lapses: half-open admits exactly one probe
    now[0] += 5.0
    assert h.state(a) == HALF_OPEN
    assert h.allow(a)
    assert not h.allow(a)
    # a failed probe opens it again at once
    h.fail(a)
    assert h.state(a) == OPEN
    now[0] += 5.0
    assert h.allow(a)                      # the next probe window
    h.ok(a)                                # a good probe closes it
    assert h.state(a) == CLOSED
    assert h.open_worker_ids() == set()


def test_breaker_decay_and_order():
    now = [0.0]
    h = WorkerHealth(fail_threshold=2, open_s=5.0, decay_s=10.0,
                     clock=lambda: now[0])
    h.fail("a")
    now[0] += 11.0                         # a quiet spell forgives
    h.fail("a")
    assert h.state("a") != OPEN
    h.fail("a")
    assert h.state("a") == OPEN
    # the open one goes last, nothing is dropped
    assert h.order(["a", "b", "c"]) == ["b", "c", "a"]
    # a stale half-open permit lapses instead of wedging the breaker
    now[0] += 5.0
    assert h.allow("a")
    now[0] += 5.0
    assert h.allow("a")
    assert h.snapshot()["a"]["trips"] == 1


@pytest.mark.parametrize("seed", range(6))
def test_breaker_matches_the_reference_step_for_step(seed):
    """One seeded sequence of ``ok``, ``fail`` (with and without a worker
    id), ``allow`` and clock steps through both packages' boards: the
    same ``state``, ``allow``, ``order``, ``open_worker_ids`` and
    ``snapshot`` after every step."""
    rng = random.Random(seed)
    now = [0.0]
    kw = dict(fail_threshold=rng.randint(1, 4), open_s=rng.choice([1, 5]),
              decay_s=rng.choice([3, 30]), clock=lambda: now[0])
    ref, port = jax_health.WorkerHealth(**kw), port_health.WorkerHealth(**kw)
    addrs = [f"10.0.0.{i}:8997" for i in range(4)]
    for _ in range(400):
        op = rng.random()
        addr = rng.choice(addrs)
        if op < 0.35:
            wid = rng.choice([None, addrs.index(addr) + 1])
            ref.fail(addr, worker_id=wid)
            port.fail(addr, worker_id=wid)
        elif op < 0.5:
            ref.ok(addr)
            port.ok(addr)
        elif op < 0.7:
            assert port.allow(addr) == ref.allow(addr)
        else:
            now[0] += rng.choice([0.25, 0.5, 1.0, 2.5, 6.0])
        assert port.state(addr) == ref.state(addr)
        shuffled = rng.sample(addrs, len(addrs))
        assert port.order(shuffled) == ref.order(shuffled)
        assert port.open_worker_ids() == ref.open_worker_ids()
        assert port.snapshot() == ref.snapshot()
    assert (port_health.CLOSED, port_health.OPEN, port_health.HALF_OPEN) \
        == (jax_health.CLOSED, jax_health.OPEN, jax_health.HALF_OPEN)


async def test_reader_skips_open_circuit_worker(tmp_path):
    """Once the breaker of a wedged replica opens, the next read tries
    the healthy replica first: the wedged worker is not asked again."""
    async with PortCluster(tmp_path, workers=2) as pc:
        pc.conf.client.short_circuit = False
        pc.conf.client.breaker_fail_threshold = 1
        pc.conf.client.breaker_open_ms = 60_000
        c = pc.client()
        data = bytes(random.Random(1).randbytes(256 * KiB))
        await c.write_all("/cb.bin", data, replicas=2)
        fb = await c.meta.get_block_locations("/cb.bin")
        first = fb.block_locs[0].locs[0]
        victim = next(w for w in pc.workers if w.worker_id == first.worker_id)
        hits = []

        async def wedged(msg, conn):
            hits.append(msg.code)
            raise err.CurvineError("wedged", code=err.ErrorCode.IO)

        victim.rpc.register(RpcCode.READ_BLOCK, wedged)
        # read 1 pays the wedged replica once and opens its breaker
        r = await c.open("/cb.bin")
        try:
            assert bytes(await r.read_all()) == data
        finally:
            await r.close()
        assert c.health.open_worker_ids() == {victim.worker_id}
        assert len(hits) == 1
        # read 2: the healthy replica first, the wedged one not asked
        r = await c.open("/cb.bin")
        try:
            assert bytes(await r.read_all()) == data
        finally:
            await r.close()
        assert len(hits) == 1


async def test_writer_placement_excludes_open_breakers(tmp_path):
    """ADD_BLOCK steers around the workers behind open breakers, and
    relaxes the exclusion rather than failing when every one is open."""
    async with PortCluster(tmp_path, workers=2) as pc:
        pc.conf.client.short_circuit = False
        c = pc.client()
        w0, w1 = pc.workers
        for _ in range(3):
            c.health.fail(w0.addr, worker_id=w0.worker_id)
        assert c.health.open_worker_ids() == {w0.worker_id}
        for i in range(3):
            await c.write_all(f"/place{i}.bin", b"x" * KiB, replicas=1)
            fb = await c.meta.get_block_locations(f"/place{i}.bin")
            placed = {x.worker_id for lb in fb.block_locs for x in lb.locs}
            assert placed == {w1.worker_id}, \
                "placement landed on the open-circuit worker"
        # every breaker open: the exclusion relaxes, the write lands
        for _ in range(3):
            c.health.fail(w1.addr, worker_id=w1.worker_id)
        assert len(c.health.open_worker_ids()) == 2
        await c.write_all("/place9.bin", b"y" * KiB, replicas=1)
        assert bytes(await c.read_all("/place9.bin")) == b"y" * KiB


async def test_short_circuit_skips_open_circuit_holder(tmp_path):
    """The short circuit probes the first replica of the breaker's order
    on this host: with the first holder's breaker open, the block is
    read from the other holder's file, and the first is not probed."""
    async with PortCluster(tmp_path, workers=2) as pc:
        c = pc.client()
        data = bytes(random.Random(2).randbytes(96 * KiB))
        await c.write_all("/sc.bin", data, replicas=2)
        fb = await c.meta.get_block_locations("/sc.bin")
        first, second = fb.block_locs[0].locs
        probed = []
        for w in pc.workers:
            real = w.rpc._handlers[int(RpcCode.GET_BLOCK_INFO)]

            def probe(real=real, wid=w.worker_id):
                async def handler(msg, conn):
                    probed.append(wid)
                    return await real(msg, conn)
                return handler
            w.rpc.register(RpcCode.GET_BLOCK_INFO, probe())
        for _ in range(3):
            c.health.fail(f"{first.ip_addr or first.hostname}:"
                          f"{first.rpc_port}", worker_id=first.worker_id)
        r = await c.open("/sc.bin")
        try:
            assert bytes(await r.read_all()) == data
        finally:
            await r.close()
        assert probed == [second.worker_id]
        assert c.counters.get("sc.bytes.read") == len(data)


async def test_dead_worker_leaves_placement_after_the_threshold(tmp_path):
    """A stopped worker that the master still lists: each new file's
    open placed on it fails and feeds the shared board, so after
    ``breaker_fail_threshold`` such opens its breaker is open and the
    client's later files are never placed on it; every write lands."""
    async with PortCluster(tmp_path, workers=2) as pc:
        pc.conf.client.short_circuit = False
        c = pc.client()
        dead, alive = pc.workers
        await dead.stop()
        placed = []
        real = c.meta.add_block

        async def add_block(path, *a, **kw):
            lb = await real(path, *a, **kw)
            placed.append([x.worker_id for x in lb.locs])
            return lb
        c.meta.add_block = add_block
        i = 0
        # the placement is random: write until three opens met the dead
        # worker, which opens its breaker
        while dead.worker_id not in c.health.open_worker_ids() and i < 60:
            await c.write_all(f"/d{i}.bin", b"z" * KiB, replicas=1)
            i += 1
        assert sum(dead.worker_id in ids for ids in placed) == 3
        n = len(placed)
        for j in range(i, i + 6):
            await c.write_all(f"/d{j}.bin", b"z" * KiB, replicas=1)
        assert len(placed) == n + 6
        assert all(ids == [alive.worker_id] for ids in placed[n:])
        for j in range(i + 6):
            fb = await c.meta.get_block_locations(f"/d{j}.bin")
            assert [x.worker_id for lb in fb.block_locs
                    for x in lb.locs] == [alive.worker_id]
