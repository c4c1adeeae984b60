"""Deadline budgets on the port (``curvine_tpu_torch/rpc/deadline.py``,
the reader's ``op_deadline_ms`` and ``deadline_ms``), on the port's own
master and workers (``tests/torch_cluster.py``).

Mirrors the deadline tests of ``tests/test_storm.py``: :254 (the
primitives), :275 (a degraded read bounded by its budget: one replica's
worker drops READ_BLOCK and GET_BLOCK_INFO through its ``fault_hook``),
:311 (the server refuses a spent budget and does not apply the
mutation), :330 (the header rides the wire), :349 (the retry policy
never sleeps past the budget) and :424-459 (the reader skips an
open-circuit worker after one wedged hop). Beyond them, the same
degraded read through ``pread_view``'s prefetch window, through
``read_range``'s parallel slices and through a stripe's cells: each
ends inside its budget and 0.5 s, and takes more than 0.3 s, so the
wedge was paid; and a window segment that never comes in leaves the
read half its budget to serve the range itself."""

import asyncio
import os
import time

import pytest

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import JobState, SetAttrOpts
from curvine_tpu_torch.rpc.client import RetryPolicy
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.deadline import DEADLINE_KEY, Deadline

from torch_cluster import MB, PortCluster

BUDGET_MS = 2_000
SLACK_S = 0.5


def test_deadline_primitives():
    dl = Deadline(1.0)
    assert not dl.expired
    assert 0.9 < dl.remaining() <= 1.0
    assert dl.cap(30.0) <= 1.0
    assert dl.cap(0.5) == 0.5
    hop = dl.sub(2)              # two replicas left: half the budget each
    assert hop.remaining() <= dl.remaining() / 2 + 0.01
    back = Deadline.from_header(dl.stamp({}))
    assert back is not None and abs(back.remaining() - dl.remaining()) < 0.05
    assert Deadline.from_header({}) is None
    assert Deadline.from_header(None) is None
    expired = Deadline(0.0)
    assert expired.expired
    with pytest.raises(err.RpcTimeout):
        expired.check("op")


def _dropping(*codes):
    """A worker's ``fault_hook`` that drops ``codes`` unanswered: a
    wedged host, not a dead one (its socket still takes the request)."""
    async def hook(server_name, msg):
        return msg.code not in {int(c) for c in codes}
    return hook


async def _wedge_first_pick(pc, c, path: str, *codes):
    """Wedge the worker of the reader's first pick of ``path``'s first
    block; returns it."""
    fb = await c.meta.get_block_locations(path)
    first = fb.block_locs[0].locs[0]
    victim = next(w for w in pc.workers if w.worker_id == first.worker_id)
    victim.rpc.fault_hook = _dropping(*codes)
    return victim


def _bounded(elapsed: float, what: str) -> None:
    assert elapsed < BUDGET_MS / 1000 + SLACK_S, \
        f"{what} took {elapsed:.2f}s (budget 2s + 0.5s)"
    assert elapsed > 0.3, f"{what} took {elapsed:.3f}s: no wedged hop"


async def test_degraded_read_bounded_by_deadline(tmp_path):
    """With the first pick's worker wedged, a read with a 2 s budget
    fails over to the other replica inside budget + 0.5 s, not after the
    30 s RPC timeout, and paid its wedged hop (about 1 s) first."""
    async with PortCluster(tmp_path, workers=2) as pc:
        pc.conf.client.short_circuit = False
        c = pc.client()
        data = os.urandom(MB)
        await c.write_all("/deg.bin", data, replicas=2)
        await _wedge_first_pick(pc, c, "/deg.bin", RpcCode.READ_BLOCK,
                                RpcCode.GET_BLOCK_INFO)
        c2 = pc.client()                  # cold breakers: pays the hop
        t0 = time.monotonic()
        r = await c2.open("/deg.bin")
        try:
            got = await r.read_all(deadline_ms=BUDGET_MS)
        finally:
            await r.close()
        _bounded(time.monotonic() - t0, "the degraded read")
        assert bytes(got) == data


async def test_server_fast_fails_exhausted_budget(tmp_path):
    """A mutation whose budget runs out behind the master's (delaying)
    fault hook is refused, and its handler never runs."""
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()

        async def delay(server_name, msg):
            if msg.code == int(RpcCode.MKDIR):
                await asyncio.sleep(0.4)
            return True

        pc.master.rpc.fault_hook = delay
        with pytest.raises(err.RpcTimeout):
            await c.meta.call(RpcCode.MKDIR, {"path": "/dead"},
                              mutate=True, deadline=Deadline.after_ms(150))
        await asyncio.sleep(0.6)          # past the delay
        pc.master.rpc.fault_hook = None
        assert not await c.meta.exists("/dead")


async def test_deadline_header_rides_the_wire(tmp_path):
    async with PortCluster(tmp_path, workers=1) as pc:
        seen = {}

        async def spy(server_name, msg):
            if msg.code == int(RpcCode.EXISTS):
                seen["budget"] = msg.header.get(DEADLINE_KEY)
            return True

        pc.master.rpc.fault_hook = spy
        c = pc.client()
        await c.meta.call(RpcCode.EXISTS, {"path": "/"},
                          deadline=Deadline.after_ms(5_000))
        pc.master.rpc.fault_hook = None
        assert seen.get("budget") is not None
        assert 0 < seen["budget"] <= 5_000


async def test_retry_policy_never_sleeps_past_budget():
    policy = RetryPolicy(max_retries=10, base_ms=400, max_ms=400)
    calls = []

    async def flaky():
        calls.append(1)
        raise err.RpcTimeout("nope")

    t0 = time.monotonic()
    with pytest.raises(err.RpcTimeout):
        await policy.run(flaky, deadline=Deadline(0.25))
    # the bare policy would sleep about 4 s over its 10 retries
    assert time.monotonic() - t0 < 0.7
    assert len(calls) <= 3


async def test_reader_skips_open_circuit_worker(tmp_path):
    """One wedged hop opens the breaker (threshold 1); the next read
    tries the healthy replica first and pays nothing."""
    async with PortCluster(tmp_path, workers=2) as pc:
        pc.conf.client.short_circuit = False
        pc.conf.client.breaker_fail_threshold = 1
        pc.conf.client.breaker_open_ms = 60_000
        c = pc.client()
        data = os.urandom(256 * 1024)
        await c.write_all("/cb.bin", data, replicas=2)
        await _wedge_first_pick(pc, c, "/cb.bin", RpcCode.READ_BLOCK)
        r = await c.open("/cb.bin")
        try:
            assert bytes(await r.read_all(deadline_ms=BUDGET_MS)) == data
        finally:
            await r.close()
        assert c.health.open_worker_ids(), "the breaker did not open"
        t0 = time.monotonic()
        r = await c.open("/cb.bin")
        try:
            assert bytes(await r.read_all(deadline_ms=BUDGET_MS)) == data
        finally:
            await r.close()
        assert time.monotonic() - t0 < 0.5, \
            "the open-circuit worker was still tried first"


async def test_degraded_pread_view_through_the_window(tmp_path):
    """Sequential ``pread_view`` reads under the conf's 2 s
    ``op_deadline_ms``, the first pick wedged: each read ends inside its
    budget, the window's segments (each with a budget of its own) fail
    over too and serve part of the scan, and the bytes are the file's."""
    async with PortCluster(tmp_path, workers=2) as pc:
        pc.conf.client.block_size = MB
        pc.conf.client.short_circuit = False
        pc.conf.client.read_chunk_size = 256 * 1024
        pc.conf.client.op_deadline_ms = BUDGET_MS
        c = pc.client()
        data = os.urandom(MB)
        await c.write_all("/win.bin", data, replicas=2)
        await _wedge_first_pick(pc, c, "/win.bin", RpcCode.READ_BLOCK)
        c2 = pc.client()
        r = await c2.open("/win.bin")
        step, got, times = 128 * 1024, bytearray(), []
        try:
            for off in range(0, MB, step):
                t0 = time.monotonic()
                got += bytes(await r.pread_view(off, step))
                times.append(time.monotonic() - t0)
        finally:
            await r.close()
        assert bytes(got) == data
        _bounded(max(times), "a windowed read")
        assert all(t < BUDGET_MS / 1000 + SLACK_S for t in times)
        assert c2.counters.get("pf.bytes.read", 0) > 0


async def test_a_stuck_segment_leaves_the_read_half_its_budget(tmp_path):
    """A window segment that never comes in holds a ``pread_view`` for
    half its remaining budget; the read then serves the range itself,
    within the other half."""
    async with PortCluster(tmp_path, workers=1) as pc:
        pc.conf.client.short_circuit = False
        c = pc.client()
        data = os.urandom(256 * 1024)
        await c.write_all("/stuck.bin", data)
        r = await c.open("/stuck.bin")
        try:
            r._pf[0] = asyncio.ensure_future(asyncio.Event().wait())
            r._pf_order.append(0)
            t0 = time.monotonic()
            got = await r.pread_view(0, 64 * 1024, deadline_ms=1_000)
            elapsed = time.monotonic() - t0
        finally:
            await r.close()
        assert bytes(got) == data[:64 * 1024]
        assert 0.4 < elapsed < 1.0, f"the read took {elapsed:.3f}s"


async def test_degraded_read_range_in_parallel_slices(tmp_path):
    """``read_range`` in 4 parallel slices under one 2 s budget, the
    first pick wedged: every slice fails over inside the budget."""
    async with PortCluster(tmp_path, workers=2) as pc:
        pc.conf.client.block_size = MB
        pc.conf.client.short_circuit = False
        pc.conf.client.read_chunk_size = 64 * 1024
        c = pc.client()
        data = os.urandom(MB)
        await c.write_all("/rr.bin", data, replicas=2)
        await _wedge_first_pick(pc, c, "/rr.bin", RpcCode.READ_BLOCK)
        c2 = pc.client()
        r = await c2.open("/rr.bin")
        t0 = time.monotonic()
        try:
            got = await r.read_range(0, MB, parallel=4,
                                     deadline_ms=BUDGET_MS)
        finally:
            await r.close()
        _bounded(time.monotonic() - t0, "the parallel read_range")
        assert got.tobytes() == data


async def _stripe(c, path: str) -> None:
    """Convert ``path`` to rs-2-1 and wait until its stripes commit and
    its replicas retire."""
    await c.meta.set_attr(path, SetAttrOpts(ec="rs-2-1"))
    job = await c.meta.submit_job("ec_convert", path)

    async def striped():
        while True:
            st = await c.meta.job_status(job)
            assert st.state != JobState.FAILED, st.message
            fb = await c.meta.get_block_locations(path)
            if st.state == JobState.COMPLETED and all(
                    lb.ec is not None and not lb.locs
                    for lb in fb.block_locs):
                return
            await asyncio.sleep(0.05)
    await asyncio.wait_for(striped(), 15.0)


async def test_degraded_stripe_read_through_its_cells(tmp_path):
    """A stripe whose data cell 0 sits on a wedged worker: the intact
    pass waits half the budget for it, then the degraded pass decodes the
    range from the other two cells inside the rest."""
    async with PortCluster(tmp_path, workers=3) as pc:
        pc.conf.client.block_size = MB
        pc.conf.client.short_circuit = False
        c = pc.client()
        data = os.urandom(MB)
        await c.write_all("/ec/w.bin", data)
        await _stripe(c, "/ec/w.bin")
        fb = await c.meta.get_block_locations("/ec/w.bin")
        holder = fb.block_locs[0].ec["cells"][0]["locs"][0]["worker_id"]
        victim = next(w for w in pc.workers if w.worker_id == holder)
        victim.rpc.fault_hook = _dropping(RpcCode.READ_BLOCK)
        c2 = pc.client()
        r = await c2.open("/ec/w.bin")
        t0 = time.monotonic()
        try:
            got = await r.read_all(deadline_ms=BUDGET_MS)
        finally:
            await r.close()
        _bounded(time.monotonic() - t0, "the degraded stripe read")
        assert bytes(got) == data
        assert c2.counters.get("read.ec_degraded", 0) == 1
