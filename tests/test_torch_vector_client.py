"""Port parity: the port's ``VectorTable`` over the port's own cache client
(``CurvineClient``) against ``curvine_tpu.vector`` over the JAX client,
on the CPU, in one one-worker ``MiniCluster`` (``lost_timeout_ms=
30_000``).

Mirrors the ``PosixClient`` cases of ``tests/test_torch_vector.py``
(:553-609) with the cache's client in the stand-in's place: the table's
files are the JAX table's byte for byte, knn and take agree, delete and
compact drop a row group file (``meta.delete`` of one file, not
recursive). Tolerances are ``tests/test_torch_vector.py``'s: ids equal,
cosine scores to 1e-5 absolute."""

import numpy as np
import pytest

import jax

import torch

from curvine_tpu.testing import MiniCluster
from curvine_tpu.vector import VectorTable as JaxTable
from curvine_tpu_torch.client.unified import CurvineClient
from curvine_tpu_torch.common import errors as perr
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.vector import VectorTable

CPU = jax.devices("cpu")[0]
PCPU = torch.device("cpu")
FILES = ("schema.json", "rg-00000.vec", "rg-00001.vec", "deletes.bin")


def _cluster():
    return MiniCluster(workers=1, lost_timeout_ms=30_000)


def _port_client(mc, **client) -> CurvineClient:
    conf = ClusterConf()
    conf.client.master_addrs = list(mc.conf.client.master_addrs)
    conf.client.block_size = mc.conf.client.block_size
    for k, v in client.items():
        setattr(conf.client, k, v)
    return CurvineClient(conf)


def clustered(rng, n_clusters=6, per=20, dim=16, spread=0.3):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    return np.concatenate([
        c + spread * rng.normal(size=(per, dim)).astype(np.float32)
        for c in centers]).astype(np.float32)


async def _table(cls, c, path, vecs):
    t = await cls.create(c, path, vecs.shape[1])
    half = vecs.shape[0] // 2          # two row groups
    await t.append(vecs[:half])
    await t.append(vecs[half:])
    return t


def _same(port, ref):
    (pi, ps), (ri, rs) = port, ref
    np.testing.assert_array_equal(pi, ri)
    assert pi.dtype == ri.dtype and ps.dtype == rs.dtype
    np.testing.assert_allclose(ps, rs, rtol=0.0, atol=1e-5)


async def _read(client, path):
    r = await client.open(path)
    try:
        return await r.read_all()
    finally:
        await r.close()


async def test_port_client_writes_the_jax_tables_bytes():
    """A table written through the port's client is byte for byte the
    table the JAX package writes through its own, reads back, and
    answers knn and take as the JAX table does."""
    rng = np.random.default_rng(17)
    vecs = clustered(rng)
    async with _cluster() as mc:
        c = mc.client()
        pc = _port_client(mc)
        try:
            pt = await _table(VectorTable, pc, "/vec/port", vecs)
            await pt.delete([3, 50])
            jt = await _table(JaxTable, c, "/vec/jax", vecs)
            await jt.delete([3, 50])
            for name in FILES:
                want = await c.read_all(f"/vec/jax/{name}")
                assert await c.read_all(f"/vec/port/{name}") == want
                assert await _read(pc, f"/vec/port/{name}") == want
            assert pc.counters["sc.bytes.written"] == \
                pc.counters["write.bytes"]
            t2 = await VectorTable.open(pc, "/vec/port")
            assert await t2.count() == vecs.shape[0] - 2
            q = vecs[[0, 60, 100]]
            _same(await t2.knn(q, k=5, device=PCPU),
                  await jt.knn(q, k=5, device=CPU))
            got, _ = await t2.take([0, 1, 119])
            np.testing.assert_array_equal(got, vecs[[0, 1, 119]])
            with pytest.raises(perr.FileNotFound):
                await pc.open("/vec/port/nothing")
            # a co-located one-block file is short-circuit readable
            reader = await pc.open("/vec/port/schema.json")
            view = await reader.mmap_view(0, reader.len)
            assert view.tobytes() == await c.read_all("/vec/jax/schema.json")
            await reader.close()
            await pc.meta.delete("/vec/port", recursive=True)
            with pytest.raises(perr.FileNotFound):
                await pc.meta.file_status("/vec/port/schema.json")
        finally:
            await pc.close()


async def test_compact_through_the_port_client():
    """Compaction deletes a whole row group's file through the port's
    ``meta.delete`` (one file, not recursive)."""
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(30, 8)).astype(np.float32)
    async with _cluster() as mc:
        pc = _port_client(mc)
        try:
            t = await _table(VectorTable, pc, "/vec/compact", vecs)
            await t.delete(list(range(15)))       # the whole first group
            assert await t.compact() == 15
            assert t.row_groups == 1
            with pytest.raises(perr.FileNotFound):
                await pc.meta.file_status("/vec/compact/rg-00001.vec")
            got, _ = await t.take([0, 14])
            np.testing.assert_array_equal(got, vecs[[15, 29]])
            t2 = await VectorTable.open(pc, "/vec/compact")
            assert await t2.count() == 15
            jt = await JaxTable.open(mc.client(), "/vec/compact")
            assert await jt.count() == 15
            jgot, _ = await jt.take([0, 14])
            np.testing.assert_array_equal(jgot, got)
        finally:
            await pc.close()


@pytest.mark.parametrize("short_circuit", [True, False])
async def test_jax_index_searched_through_the_port_client(short_circuit):
    """A table and IVF-PQ index the JAX package wrote, opened through the
    port's client (by short circuit, or by READ_BLOCK with it off): the
    port's search answers as JAX's."""
    rng = np.random.default_rng(7)
    vecs = clustered(rng, n_clusters=24, per=80, dim=64)
    async with _cluster() as mc:
        c = mc.client()
        pc = _port_client(mc, short_circuit=short_circuit)
        try:
            jt = await _table(JaxTable, c, "/vec/pq", vecs)
            await jt.create_index(nlist=16, metric="cosine", device=CPU,
                                  pq_m=16)
            pt = await VectorTable.open(pc, "/vec/pq")
            q = vecs[rng.choice(vecs.shape[0], 16, replace=False)]
            kw = dict(k=10, metric="cosine", nprobe=8, rerank=100)
            _same(await pt.knn(q, device=PCPU, **kw),
                  await jt.knn(q, device=CPU, **kw))
            assert (await pt._fresh_index("cosine")).pq is not None
            got, _ = await pt.take([5, 700])
            np.testing.assert_array_equal(got, vecs[[5, 700]])
            path = "sc.bytes.read" if short_circuit else \
                "read.zero_copy_bytes"
            other = "read.zero_copy_bytes" if short_circuit else \
                "sc.bytes.read"
            assert pc.counters[path] > 0 and other not in pc.counters
        finally:
            await pc.close()
