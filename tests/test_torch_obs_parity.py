"""The port's tracing plane and deadline conf held against the JAX
package's, on the CPU.

- The same span lists, made from a numpy seed, assemble into the same
  trees and render to the same text in both packages.
- A ``SpanCtx`` stamped by either package parses in the other.
- A JAX ``CurvineClient``'s traced read against a cluster of the port,
  and the port's client's traced read against a JAX ``MiniCluster``,
  each assemble into one tree with the client's spans from one package
  and the master's and worker's from the other.
- The ``[obs]`` table and ``op_deadline_ms`` default, and load from a
  cluster file, as the JAX package's do; ``[obs]``'s fixed keys are the
  JAX package's defaults, and another value is refused."""

import dataclasses

import numpy as np
import pytest

from curvine_tpu.client import CurvineClient as JaxClient
from curvine_tpu.common.conf import ClusterConf as JaxConf
from curvine_tpu.obs import trace as jtrace
from curvine_tpu.testing import MiniCluster
from curvine_tpu_torch.common.conf import OBS_FIXED, ClusterConf
from curvine_tpu_torch.obs import trace as ptrace

from chip_smoke import trace_tree_faults
from torch_cluster import MB, PortCluster, _client

KB = 1024
COMPONENTS = ("client", "master", "worker")
OPS = ("read", "read_block", "open", "get_block_locations", "write")


def _spans(seed: int, n: int = 40) -> list[dict]:
    """``n`` spans of one trace: parents among the earlier spans, some
    orphans (a parent never collected), equal start times among them
    (the sort's ties), and attrs."""
    rng = np.random.default_rng(seed)
    ids = [int(x) | 1 for x in rng.integers(1, 2 ** 47, n)]
    out = []
    for i, sid in enumerate(ids):
        k = int(rng.integers(0, 4))
        parent = 0 if i == 0 else (
            int(rng.integers(2 ** 47, 2 ** 48)) if k == 0
            else ids[int(rng.integers(0, i))])
        out.append({
            "trace_id": "00ff00ff00ff00ff", "span_id": sid,
            "parent": parent,
            "component": COMPONENTS[int(rng.integers(0, 3))],
            "op": OPS[int(rng.integers(0, len(OPS)))],
            "start": float(rng.integers(0, 20)) / 8,
            "dur": float(rng.random()),
            "status": "error" if rng.random() < 0.2 else "ok",
            "attrs": ({"block": int(rng.integers(0, 99))}
                      if rng.random() < 0.5 else {})})
    order = rng.permutation(n)
    return [out[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_spans_give_the_same_tree_and_text(seed):
    spans = _spans(seed)
    mine = ptrace.assemble_tree([dict(s) for s in spans])
    ref = jtrace.assemble_tree([dict(s) for s in spans])
    assert mine == ref
    assert len(mine) > 1                       # orphans became roots
    assert ptrace.render_tree(mine, "00ff00ff00ff00ff") == \
        jtrace.render_tree(ref, "00ff00ff00ff00ff")


@pytest.mark.parametrize("stamped_by", ["port", "jax"])
def test_span_ctx_crosses_the_packages(stamped_by):
    make, parse = (ptrace.SpanCtx, jtrace.SpanCtx) if stamped_by == "port" \
        else (jtrace.SpanCtx, ptrace.SpanCtx)
    for sampled in (True, False):
        hdr = make("0123456789abcdef", 0xabcdef123, sampled).stamp({})
        assert ptrace.TRACE_KEY == jtrace.TRACE_KEY and \
            list(hdr) == [jtrace.TRACE_KEY]
        back = parse.from_header(hdr)
        assert (back.trace_id, back.span_id, back.sampled) == \
            ("0123456789abcdef", 0xabcdef123, sampled)
    assert parse.from_header({ptrace.TRACE_KEY: ["x", "not an int"]}) \
        is None


async def _traced_read(c, path: str, payload: bytes
                       ) -> tuple[list[dict], str]:
    """One read of ``path`` under a sampled root, then its spans by the
    master's collect."""
    with c.tracer.start_trace("e2e_read", sampled=True) as root:
        r = await c.open(path)
        try:
            assert bytes(await r.read_all()) == payload
        finally:
            await r.close()
    return await c.get_trace(root.ctx.trace_id), root.ctx.trace_id


async def test_jax_client_traced_read_against_a_port_cluster(tmp_path):
    async with PortCluster(tmp_path, workers=1) as pc:
        pc.conf.client.short_circuit = False
        payload = b"j" * (256 * KB)
        w = pc.client()
        await w.write_all("/obs/p.bin", payload)
        jconf = JaxConf()
        jconf.client.master_addrs = [pc.master.addr]
        jconf.client.short_circuit = False
        jconf.client.fast_meta = False
        jconf.client.block_size = 4 * MB
        c = JaxClient(jconf)
        try:
            spans, tid = await _traced_read(c, "/obs/p.bin", payload)
        finally:
            await c.close()
        assert trace_tree_faults(spans, "e2e_read") == []
        # the master's and the worker's spans are the port's, the
        # client's came from the JAX client through METRICS_REPORT
        port_ids = {s["span_id"] for s in pc.master.tracer.spans_for(tid)
                    if s["component"] == "master"}
        port_ids |= {s["span_id"] for s in
                     pc.workers[0].tracer.spans_for(tid)}
        assert {s["span_id"] for s in spans
                if s["component"] != "client"} == port_ids
        assert isinstance(c.tracer, jtrace.Tracer)
        assert {s["op"] for s in spans if s["component"] == "client"} >= \
            {"e2e_read", "open", "read_block"}


async def test_port_client_traced_read_against_a_jax_cluster(tmp_path):
    mc = MiniCluster(workers=1, base_dir=str(tmp_path))
    mc.conf.obs.trace_sample_rate = 1.0
    await mc.start()
    try:
        payload = b"p" * (256 * KB)
        await mc.client().write_all("/obs/j.bin", payload)
        conf = ClusterConf()
        conf.client.master_addrs = [mc.master.rpc.addr]
        conf.client.short_circuit = False
        c = _client(conf)
        try:
            spans, tid = await _traced_read(c, "/obs/j.bin", payload)
        finally:
            await c.close()
        assert trace_tree_faults(spans, "e2e_read") == []
        assert isinstance(c.tracer, ptrace.Tracer)
        jax_ids = {s["span_id"] for s in mc.master.tracer.spans_for(tid)
                   if s["component"] == "master"}
        jax_ids |= {s["span_id"] for w in mc.workers
                    for s in w.tracer.spans_for(tid)}
        assert {s["span_id"] for s in spans
                if s["component"] != "client"} == jax_ids
        assert {s["op"] for s in spans if s["component"] == "client"} >= \
            {"e2e_read", "open", "read", "read_block"}
    finally:
        await mc.stop()


def test_obs_and_deadline_conf_match_the_reference(tmp_path):
    """The ``[obs]`` table's field and its fixed keys are the JAX
    package's fields at their defaults, and the tracer's constants are
    those values; a file that turns tracing off and restates the fixed
    keys loads in both packages."""
    jax = dataclasses.asdict(JaxConf().obs)
    port = dataclasses.asdict(ClusterConf().obs)
    assert set(jax) == set(port) | set(OBS_FIXED)
    assert {k: jax[k] for k in {**port, **OBS_FIXED}} == {**port, **OBS_FIXED}
    t = ptrace.Tracer("client")
    assert (t.sample_rate, t.slow_s * 1000, t.store.capacity,
            ptrace.COLLECT_TIMEOUT_MS) == (
        OBS_FIXED["trace_sample_rate"], OBS_FIXED["slow_op_ms"],
        OBS_FIXED["span_store_size"], OBS_FIXED["trace_collect_timeout_ms"])
    assert ClusterConf().client.op_deadline_ms == \
        JaxConf().client.op_deadline_ms == 0
    p = tmp_path / "cluster.toml"
    p.write_text("""[client]
op_deadline_ms = 2000
[obs]
enabled = false
trace_sample_rate = 0.01
slow_op_ms = 1000
span_store_size = 8192
trace_collect_timeout_ms = 2000
""")
    mine, ref = ClusterConf.load(str(p)), JaxConf.load(str(p))
    assert mine.obs.enabled is ref.obs.enabled is False
    assert ptrace.Tracer.from_conf("client", mine.obs).enabled is False
    assert mine.client.op_deadline_ms == ref.client.op_deadline_ms == 2000


@pytest.mark.parametrize("key, val", [
    ("trace_sample_rate", "0.5"), ("slow_op_ms", "250"),
    ("span_store_size", "64"), ("trace_collect_timeout_ms", "700")])
def test_fixed_obs_keys_are_refused(tmp_path, key, val):
    """A file that sets one of ``[obs]``'s fixed keys to another value is
    refused, naming the key; the JAX package takes it."""
    p = tmp_path / "cluster.toml"
    p.write_text(f"[obs]\n{key} = {val}\n")
    with pytest.raises(ValueError, match=f"obs.{key}"):
        ClusterConf.load(str(p))
    assert str(getattr(JaxConf.load(str(p)).obs, key)) == val
