"""The port's tracing plane (``curvine_tpu_torch/obs/trace.py``) and the
client's metrics flush, on the port's own master and workers
(``tests/torch_cluster.py``).

Mirrors the tracing tests of ``tests/test_obs.py``: :29, :44, :57, :92
and :112 (the primitives), :233 without its web-server half (the web
server waits for ROADMAP §A item 4: the tree is assembled from the
client's ``get_trace``), :304 (the port master's ``fault_hook`` is the
spy) and :338 (a traced write and the replication fan-out). The flush:
``tests/test_shm_reads.py:513-528`` (the read counters reach the
master's ``client.*`` counters; the port counts a mapping's bytes in
``sc.bytes.read`` and READ_BLOCK's in ``read.zero_copy_bytes``, so the
latter is read with the short circuit off), and beyond it that a flush
sends deltas only, that spans go back into the ring while the master is
away, and that ``close`` flushes. Last, the chip script's breaker watch
(``chip_smoke.watch_breaker``), which splits phase ``trace``'s wedged
hops at the breaker's own transitions."""

import asyncio
import os

import pytest

from curvine_tpu_torch.client.health import WorkerHealth
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.metrics import MetricsRegistry
from curvine_tpu_torch.obs.trace import (TRACE_KEY, SpanCtx, SpanStore,
                                         Tracer, assemble_tree, current_ctx,
                                         render_tree)
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import unpack

from chip_smoke import trace_tree_faults, watch_breaker
from torch_cluster import MB, PortCluster

KB = 1024


# ---------------- primitives ----------------

def test_span_ctx_wire_roundtrip():
    ctx = SpanCtx("ab12cd34ef56ab78", 0x1234, True)
    hdr = ctx.stamp({})
    assert TRACE_KEY in hdr
    back = SpanCtx.from_header(hdr)
    assert (back.trace_id, back.span_id, back.sampled) == \
        (ctx.trace_id, ctx.span_id, True)
    # absent and hostile headers are not traces
    assert SpanCtx.from_header({}) is None
    assert SpanCtx.from_header(None) is None
    assert SpanCtx.from_header({TRACE_KEY: "garbage"}) is None
    assert SpanCtx.from_header({TRACE_KEY: [1]}) is None


def test_span_store_is_a_bounded_ring():
    store = SpanStore(capacity=16)
    for i in range(100):
        store.append({"trace_id": f"t{i}", "span_id": i})
    assert len(store) == 16
    assert store.appended == 100
    assert store.for_trace("t0") == []          # fell off the head
    assert store.for_trace("t99")
    drained = store.drain(max_n=1000)
    assert len(drained) == 16 and len(store) == 0


def test_tracer_sampling_and_backstops():
    m = MetricsRegistry("t")
    tr = Tracer("client", sample_rate=0.0, slow_op_ms=10_000, metrics=m)
    with tr.span("op_ok"):                      # unsampled, ok, fast
        pass
    assert len(tr.store) == 0
    assert m.counters["trace.spans_dropped"] == 1
    with pytest.raises(ValueError):             # unsampled, in error: kept
        with tr.span("op_err"):
            raise ValueError("boom")
    spans = list(tr.store.drain())
    assert len(spans) == 1 and spans[0]["status"] == "error"
    assert "boom" in spans[0]["attrs"]["error"]
    slow = Tracer("client", sample_rate=0.0, slow_op_ms=0)
    slow.slow_s = 1e-9                          # unsampled, slow: kept
    with slow.span("op_slow"):
        pass
    assert len(slow.store) == 1
    full = Tracer("client", sample_rate=1.0)
    with full.span("op"):
        pass
    assert len(full.store) == 1
    off = Tracer("client", sample_rate=1.0, enabled=False)
    with off.span("op") as sp:
        assert sp.ctx is None
        assert current_ctx() is None
    assert len(off.store) == 0


def test_ambient_context_nesting_and_inheritance():
    tr = Tracer("client", sample_rate=1.0)
    assert current_ctx() is None
    with tr.start_trace("root", sampled=True) as root:
        assert current_ctx() is root.ctx
        with tr.span("child") as child:
            assert child.ctx.trace_id == root.ctx.trace_id
            assert child.parent_id == root.ctx.span_id
            assert current_ctx() is child.ctx
        assert current_ctx() is root.ctx
    assert current_ctx() is None
    spans = tr.store.for_trace(root.ctx.trace_id)
    assert {s["op"] for s in spans} == {"root", "child"}
    # a parent from the wire wins over the ambient context
    wire = SpanCtx("feedfeedfeedfeed", 77, True)
    with tr.span("server_side", parent=wire) as sp:
        assert sp.ctx.trace_id == "feedfeedfeedfeed"
        assert sp.parent_id == 77


def test_assemble_and_render_tree():
    spans = [
        {"trace_id": "t", "span_id": 1, "parent": 0, "component": "client",
         "op": "read", "start": 1.0, "dur": 0.5, "status": "ok",
         "attrs": {}},
        {"trace_id": "t", "span_id": 2, "parent": 1, "component": "worker",
         "op": "read_block", "start": 1.1, "dur": 0.3, "status": "ok",
         "attrs": {}},
        # its parent was never collected: one more root
        {"trace_id": "t", "span_id": 9, "parent": 404, "component": "x",
         "op": "stray", "start": 0.5, "dur": 0.1, "status": "ok",
         "attrs": {}},
    ]
    roots = assemble_tree(spans)
    assert len(roots) == 2
    main = next(r for r in roots if r["span_id"] == 1)
    assert [c["span_id"] for c in main["children"]] == [2]
    text = render_tree(roots, "t")
    assert "client:read" in text and "worker:read_block" in text
    assert "3 spans" in text


# ---------------- the trace across client, master and worker ----------------

async def test_trace_e2e_cached_read(tmp_path):
    """One traced read of a cached file assembles, by ``get_trace`` (the
    master's GET_SPANS collect), into one tree of at least 4 spans across
    client, master and worker, each linked to its parent and inside its
    interval."""
    async with PortCluster(tmp_path, workers=1) as pc:
        pc.conf.client.short_circuit = False      # the worker's RPC leg
        c = pc.client()
        await c.write_all("/obs/a.bin", b"t" * (256 * KB))
        with c.tracer.start_trace("e2e_read", sampled=True) as root:
            r = await c.open("/obs/a.bin")
            try:
                data = await r.read_all()
            finally:
                await r.close()
        assert data == b"t" * (256 * KB)
        spans = await c.get_trace(root.ctx.trace_id)
        assert trace_tree_faults(spans, "e2e_read") == []
        ops = {(s["component"], s["op"]) for s in spans}
        assert {("client", "open"), ("client", "read"),
                ("client", "read_block"), ("master", "get_block_locations"),
                ("worker", "read_block")} <= ops
        text = render_tree(assemble_tree(spans), root.ctx.trace_id)
        assert f"({len(spans)} spans, 3 components)" in text


async def test_trace_header_rides_the_wire(tmp_path):
    """The trace context is stamped under an active span and seen by the
    server's dispatch; without a root, the meta call heads its own trace
    and its unsampled flag rides the header all the same."""
    async with PortCluster(tmp_path, workers=1) as pc:
        seen = {}

        async def spy(server_name, msg):
            if TRACE_KEY in msg.header:
                seen[msg.code] = list(msg.header[TRACE_KEY])
            return True

        pc.master.rpc.fault_hook = spy
        c = pc.client()
        with c.tracer.start_trace("wire", sampled=True) as root:
            await c.meta.call(RpcCode.EXISTS, {"path": "/"})
        got = seen.get(int(RpcCode.EXISTS))
        assert got is not None, "the trace context never crossed the wire"
        assert got[0] == root.ctx.trace_id and got[2] == 1
        seen.clear()
        c.tracer.sample_rate = 0.0
        await c.meta.call(RpcCode.EXISTS, {"path": "/"})
        got = seen.get(int(RpcCode.EXISTS))
        assert got is not None and got[2] == 0
        pc.master.rpc.fault_hook = None


async def test_traced_write_and_replication_fanout(tmp_path):
    """A traced write links the client to the worker's
    ``write_block_stream``; the master's replication roots a trace of its
    own that reaches the destination worker."""
    async with PortCluster(tmp_path, workers=2) as pc:
        c = pc.client()
        c.tracer.sample_rate = 1.0
        c.conf.client.short_circuit = False
        with c.tracer.start_trace("e2e_write", sampled=True) as root:
            await c.write_all("/obsw/w.bin", os.urandom(64 * KB),
                              replicas=1)
        spans = await c.get_trace(root.ctx.trace_id)
        ops = {(s["component"], s["op"]) for s in spans}
        assert ("worker", "write_block_stream") in ops
        assert ("master", "complete_file") in ops
        assert ("client", "write_attempt") in ops
        assert ("client", "write_commit") in ops

        m = pc.master
        m.replication.tracer.sample_rate = 1.0
        fb = await c.meta.get_block_locations("/obsw/w.bin")
        bid = fb.block_locs[0].block.id
        m.fs.blocks.desired[bid] = 2
        assert await m.replication._replicate(bid)
        tid = m.replication.tracer.last_trace_id
        assert tid is not None
        await asyncio.sleep(0.2)             # the workers' spans end
        spans = (await m.collect_trace(tid))["spans"]
        ops = {(s["component"], s["op"]) for s in spans}
        assert ("master", "replicate_block") in ops
        assert ("worker", "submit_block_replication_job") in ops


# ---------------- the metrics flush ----------------

async def test_read_counters_reach_the_master(tmp_path):
    """The reader's ``read.shm_*`` and ``read.zero_copy_bytes`` counters
    ride METRICS_REPORT into the master's ``client.*`` counters."""
    async with PortCluster(tmp_path, workers=1) as pc:
        pc.conf.client.block_size = MB
        c = pc.client()
        await c.write_all("/shm/obs.bin", os.urandom(MB))
        r = await c.open("/shm/obs.bin")
        await r.pread_view(0, 4096)
        await r.read_range(4096, 4096)        # the mapping's view
        await r.close()
        await c.flush_metrics()
        m = pc.master.metrics.as_dict()
        assert m.get("client.read.shm_hits", 0) >= 2
        assert m.get("client.sc.bytes.read", 0) >= 8192
        c.conf.client.short_circuit = False
        r = await c.open("/shm/obs.bin")
        await r.pread_view(0, 4096)
        await r.close()
        await c.flush_metrics()
        m = pc.master.metrics.as_dict()
        assert m.get("client.read.zero_copy_bytes", 0) >= 4096
        assert m["client.read.zero_copy_bytes"] == \
            c.counters["read.zero_copy_bytes"]


async def test_flush_sends_deltas_only(tmp_path):
    """Each METRICS_REPORT carries the counters that moved since the last
    flush, by how much; a flush with nothing new sends nothing."""
    async with PortCluster(tmp_path, workers=1) as pc:
        sent = []

        async def spy(server_name, msg):
            if msg.code == int(RpcCode.METRICS_REPORT):
                sent.append((unpack(msg.data) or {}).get("counters"))
            return True

        pc.master.rpc.fault_hook = spy
        c = pc.client()
        c.counters.update({"a": 5, "b": 7})
        await c.flush_metrics()
        c.counters["a"] = 8
        await c.flush_metrics()
        await c.flush_metrics()                # nothing moved
        pc.master.rpc.fault_hook = None
        assert sent == [{"a": 5, "b": 7}, {"a": 3}]
        counters = pc.master.metrics.counters
        assert (counters["client.a"], counters["client.b"]) == (8, 7)


async def test_spans_go_back_to_the_ring_while_the_master_is_away(tmp_path):
    """A flush that cannot reach the master raises and puts the spans
    back into the client's ring; the next flush, with the master back,
    delivers them and the counters' whole delta."""
    async with PortCluster(tmp_path, workers=0) as pc:
        c = pc.client()
        c.meta.retry.max_retries = 0
        c.meta.masters = ["127.0.0.1:1"]        # nothing listens there
        with c.tracer.start_trace("kept", sampled=True) as root:
            pass
        c.counters["x"] = 3
        with pytest.raises(err.CurvineError):
            await c.flush_metrics()
        assert [s["op"] for s in c.tracer.store.for_trace(
            root.ctx.trace_id)] == ["kept"]
        assert "client.x" not in pc.master.metrics.counters
        c.meta.masters = [pc.master.addr]
        await c.flush_metrics()
        assert len(c.tracer.store) == 0
        assert [s["op"] for s in pc.master.tracer.spans_for(
            root.ctx.trace_id)] == ["kept"]
        assert pc.master.metrics.counters["client.x"] == 3


async def test_close_flushes_and_open_starts_the_periodic_flush(tmp_path):
    """The first ``open`` starts the 5 s flush task; ``close`` stops it
    and flushes what is left."""
    async with PortCluster(tmp_path, workers=1) as pc:
        pc.conf.client.short_circuit = False
        w = pc.client()
        await w.write_all("/f.bin", os.urandom(64 * KB))
        await w.close()
        c = pc.client()
        assert c._metrics_task is None
        r = await c.open("/f.bin")
        assert c._metrics_task is not None and not c._metrics_task.done()
        await r.read_all()
        await r.close()
        c.counters["at.close"] = 1           # no 5 s period has passed
        task = c._metrics_task
        await c.close()
        assert task.cancelled() and c._metrics_task is None
        counters = pc.master.metrics.counters
        assert counters["client.at.close"] == 1
        assert counters["client.read.zero_copy_bytes"] == 64 * KB
        assert counters["client.write.bytes"] == 64 * KB


async def test_periodic_flush_belongs_to_no_trace(tmp_path):
    """The 5 s flush task started by an ``open`` under a trace runs in a
    context of its own (ROADMAP §C, C17): the reference's inherits the
    open's trace, and its reports land in it long after it ended."""
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        await c.write_all("/t.bin", b"x" * KB)
        c2 = pc.client()
        with c2.tracer.start_trace("root", sampled=True):
            r = await c2.open("/t.bin")
            await r.close()
        ctx = c2._metrics_task.get_context()
        assert all(v is None for k, v in ctx.items()
                   if k.name == "curvine_trace_ctx")


async def test_concurrent_flushes_send_each_delta_once(tmp_path):
    """Flushes run one at a time (ROADMAP §C, C18): two at once, or the
    periodic one beside ``get_trace``'s, would both send one delta."""
    async with PortCluster(tmp_path, workers=1) as pc:
        c = pc.client()
        c.counters["n"] = 11
        await asyncio.gather(c.flush_metrics(), c.flush_metrics(),
                             c.get_trace("none"))
        c.counters["n"] = 12
        await asyncio.gather(c.flush_metrics(), c.flush_metrics())
        assert pc.master.metrics.counters["client.n"] == 12


def test_breaker_watch_records_trips_and_half_open_probes():
    """``watch_breaker`` logs the watched address's trip to OPEN, the
    probe its HALF_OPEN breaker lets by and the trip after that probe
    fails, and nothing of another address."""
    now = [0.0]
    h = WorkerHealth(fail_threshold=3, open_s=5.0, clock=lambda: now[0])
    marks: dict = {}
    watch_breaker(h, "b:1", marks)
    for _ in range(3):
        assert h.order(["b:1", "a:1"]) == ["b:1", "a:1"]
        h.fail("b:1", worker_id=2)
        h.fail("a:1")
    assert len(marks["opens"]) == 1 and marks["half_opens"] == []
    assert h.order(["b:1", "a:1"]) == ["b:1", "a:1"]  # both open: kept
    now[0] = 5.0
    assert h.allow("b:1") and not h.allow("b:1")    # one probe a window
    assert len(marks["half_opens"]) == 1
    h.fail("b:1", worker_id=2)                       # the probe wedged
    assert len(marks["opens"]) == 2
    assert marks["opens"][0] <= marks["half_opens"][0] <= marks["opens"][1]
    now[0] = 10.0
    assert h.allow("b:1")
    h.ok("b:1")
    assert len(marks["opens"]) == 2 and len(marks["half_opens"]) == 2
