"""Port parity: the vector path of ``curvine_tpu_torch`` (VectorTable, the
IVF-flat / IVF-PQ index with K2's ADC scan, AnnServer, the POSIX client)
against ``curvine_tpu.vector`` on the CPU.

Tables and indexes are written by the JAX package through a MiniCluster's
``CurvineClient`` and read by the port's ``VectorTable`` through the same
client: the index file carries the JAX build into the port, so the search
tests compare searches, not builds. The port's own build is held against
JAX's on well-separated clusters.

Tolerances: ids are equal. Cosine scores agree to 1e-5 absolute (they are
at most 1). An l2 score is -(|q|^2 - 2 q.x + |x|^2), a difference of terms
near 70 at dim 64 where one float32 ulp is 8e-6, and both frameworks sum
the same products in another order: l2 scores agree to 1e-4 absolute, the
JAX package's own tolerance between its l2 paths (test_vector_index.py:137,
test_vector_pq.py:217), plus 1e-6 relative for tables whose scores are in
the hundreds (a few ulps there)."""

import asyncio
import json
import logging

import numpy as np
import pytest

import jax

import torch

from curvine_tpu.testing import MiniCluster
from curvine_tpu.vector import AnnServer as JaxServer
from curvine_tpu.vector import VectorTable as JaxTable
from curvine_tpu.vector.index import IvfIndex as JaxIndex
from curvine_tpu_torch.client.posix import PosixClient
from curvine_tpu_torch.common import errors as perr
from curvine_tpu_torch.gpu import pq as pq_ops
from curvine_tpu_torch.vector import AnnServer, IvfIndex, PqCodebook, \
    VectorTable
from curvine_tpu_torch.vector import index as pindex

CPU = jax.devices("cpu")[0]
PCPU = torch.device("cpu")


def clustered(rng, n_clusters=24, per=80, dim=64, spread=0.3):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    vecs = np.concatenate([
        c + spread * rng.normal(size=(per, dim)).astype(np.float32)
        for c in centers])
    return vecs.astype(np.float32)


def skewed(rng, dim=32):
    """One dominant cluster (600 rows) + 4 small ones (50 each): the
    percentile cap falls below the longest list -> spill lists."""
    centers = rng.normal(size=(5, dim)).astype(np.float32) * 4.0
    sizes = [600, 50, 50, 50, 50]
    vecs = np.concatenate([
        centers[i] + 0.3 * rng.normal(size=(n, dim)).astype(np.float32)
        for i, n in enumerate(sizes)])
    return vecs.astype(np.float32)


async def _jax_table(c, path, vecs):
    t = await JaxTable.create(c, path, vecs.shape[1])
    # two row groups so the dense-id mapping crosses a group boundary
    half = vecs.shape[0] // 2
    await t.append(vecs[:half])
    await t.append(vecs[half:])
    return t


async def _port_table(c, path, vecs):
    t = await VectorTable.create(c, path, vecs.shape[1])
    half = vecs.shape[0] // 2
    await t.append(vecs[:half])
    await t.append(vecs[half:])
    return t


def _same(port, ref, metric="cosine"):
    (pi, ps), (ri, rs) = port, ref
    np.testing.assert_array_equal(pi, ri)
    assert pi.dtype == ri.dtype and ps.dtype == rs.dtype
    if metric == "cosine":
        np.testing.assert_allclose(ps, rs, rtol=0.0, atol=1e-5)
    else:
        np.testing.assert_allclose(ps, rs, rtol=1e-6, atol=1e-4)


def _cluster():
    """A one-worker MiniCluster whose master waits the production default
    (30 s, common/conf.py:50) before it declares the worker lost: the JAX
    reference compiles its search on the event loop that also carries the
    cluster's heartbeats, and under a loaded test run a compile outlasts
    MiniCluster's 2 s failover-test setting."""
    return MiniCluster(workers=1, lost_timeout_ms=30_000)


def _recall(ann_ids, exact_ids, k=10):
    return np.mean([
        len(set(map(int, a)) & set(map(int, b))) / k
        for a, b in zip(ann_ids, exact_ids)])


# ---------------- search parity: JAX-written table and index ----------------


@pytest.mark.parametrize("metric", ["cosine", "l2"])
async def test_pq_search_matches_jax(metric):
    """PQ search (K2's plain version on CPU tensors) against JAX's
    Pallas-kernel path (interpret mode) and its default gather path."""
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(7)
        vecs = clustered(rng)
        jt = await _jax_table(c, "/vec/pq", vecs)
        await jt.create_index(nlist=16, metric=metric, device=CPU, pq_m=16)
        pt = await VectorTable.open(c, "/vec/pq")
        q = vecs[rng.choice(vecs.shape[0], 16, replace=False)] \
            + 0.01 * rng.normal(size=(16, 64)).astype(np.float32)
        for nprobe, rerank, k in ((8, 100, 10), (3, 40, 10), (1, 12, 30)):
            kw = dict(k=k, metric=metric, nprobe=nprobe, rerank=rerank)
            got = await pt.knn(q, device=PCPU, **kw)
            assert (await pt._fresh_index(metric)).pq is not None
            _same(got, await jt.knn(q, device=CPU, pallas=True, **kw),
                  metric)
            _same(got, await jt.knn(q, device=CPU, **kw), metric)
        assert pt.stale_fallbacks == 0


@pytest.mark.parametrize("metric", ["cosine", "l2"])
async def test_flat_search_matches_jax(metric):
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(11)
        vecs = clustered(rng, n_clusters=8, per=40, dim=16, spread=0.05)
        jt = await _jax_table(c, "/vec/flat", vecs)
        await jt.create_index(nlist=8, metric=metric, device=CPU)
        pt = await VectorTable.open(c, "/vec/flat")
        q = vecs[rng.choice(vecs.shape[0], 20, replace=False)] \
            + 0.01 * rng.normal(size=(20, 16)).astype(np.float32)
        for nprobe in (1, 3, 8):
            kw = dict(k=10, metric=metric, nprobe=nprobe)
            _same(await pt.knn(q, device=PCPU, **kw),
                  await jt.knn(q, device=CPU, **kw), metric)
        # the PQ path on a flat index is refused by both
        with pytest.raises(perr.InvalidArgument, match="no PQ"):
            await pt.knn(q, metric=metric, device=PCPU, use_pq=True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
async def test_exact_scan_matches_jax(dtype):
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(21)
        vecs = clustered(rng, n_clusters=8, per=40, dim=32)
        jt = await _jax_table(c, "/vec/scan", vecs)
        pt = await VectorTable.open(c, "/vec/scan")
        q = rng.normal(size=(9, 32)).astype(np.float32)
        for metric in ("cosine", "l2"):
            for k in (1, 10):
                kw = dict(k=k, metric=metric, use_index=False, dtype=dtype)
                _same(await pt.knn(q, device=PCPU, **kw),
                      await jt.knn(q, device=CPU, **kw), metric)
        v, ids = await pt._device_vectors("cosine", PCPU, dtype)
        assert v.dtype == (torch.bfloat16 if dtype == "bf16"
                           else torch.float32)
        assert v.shape == (vecs.shape[0] + 1, 32) and int(ids[-1]) == -1
        assert not v[-1].any()                        # the sentinel row


async def test_full_probe_equals_exact_on_both_paths():
    """Probing every list (spills included) reproduces the exact scan:
    ids, and scores to the stated tolerance; the PQ path too when its
    re-rank covers every candidate."""
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(9)
        vecs = skewed(rng)
        jt = await _jax_table(c, "/vec/full", vecs)
        pt = await VectorTable.open(c, "/vec/full")
        q = rng.normal(size=(6, vecs.shape[1])).astype(np.float32)
        for metric in ("cosine", "l2"):
            idx = await jt.create_index(nlist=5, metric=metric, device=CPU,
                                        cap_pct=50.0, pq_m=8, pq_ksub=64)
            assert idx.nlist_total > idx.nlist or metric == "l2"
            exact = await pt.knn(q, k=7, metric=metric, device=PCPU,
                                 use_index=False)
            width = idx.nlist_total * idx.lists.shape[1]
            for use_pq in (False, True):
                got = await pt.knn(q, k=7, metric=metric, device=PCPU,
                                   nprobe=idx.nlist_total, use_pq=use_pq,
                                   rerank=width)
                _same(got, exact, metric)
                _same(got, await jt.knn(
                    q, k=7, metric=metric, device=CPU,
                    nprobe=idx.nlist_total, use_pq=use_pq, rerank=width),
                    metric)


async def test_ties_keep_the_lower_index_first():
    """Exact ties: zero rows score exactly 0 for cosine, and padding and
    the sentinel score -inf. ``jax.lax.top_k`` puts the lower index first;
    so must the port, on every path, with k past the live rows."""
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(5)
        vecs = clustered(rng, n_clusters=4, per=20, dim=16)
        vecs[[3, 17, 18, 40, 71]] = 0.0
        jt = await _jax_table(c, "/vec/ties", vecs)
        pt = await VectorTable.open(c, "/vec/ties")
        q = rng.normal(size=(4, 16)).astype(np.float32)
        n = vecs.shape[0]
        kw = dict(k=n + 5, use_index=False)
        got = await pt.knn(q, device=PCPU, **kw)
        _same(got, await jt.knn(q, device=CPU, **kw))
        assert got[0].shape == (4, n + 1)              # the sentinel too
        assert np.all(got[0][:, -1] == -1)
        zeros = got[0][got[1] == 0.0].reshape(4, 5)
        assert np.all(np.diff(zeros, axis=1) > 0)      # in index order
        idx = await jt.create_index(nlist=4, device=CPU, pq_m=4, pq_ksub=16)
        for use_pq in (False, True):
            kw = dict(k=40, nprobe=1, use_pq=use_pq, rerank=40)
            _same(await pt.knn(q, device=PCPU, **kw),
                  await jt.knn(q, device=CPU, **kw))
        kw = dict(k=n, nprobe=idx.nlist_total, rerank=10 ** 6)
        _same(await pt.knn(q, device=PCPU, **kw),
              await jt.knn(q, device=CPU, **kw))


def test_topk_orders_like_jax():
    rng = np.random.default_rng(0)
    s = rng.integers(-3, 3, size=(5, 64)).astype(np.float32)
    s[0, ::3] = -np.inf
    s[1] = -np.inf
    s[2, 5], s[2, 9] = -0.0, 0.0
    for k in (1, 7, 64):
        ref_s, ref_i = jax.lax.top_k(s, k)
        got_s, got_i = pindex._topk(torch.from_numpy(s), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


# ---------------- index behaviour on the port ----------------


async def test_capped_spill_layout_covers_every_row():
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(5)
        vecs = skewed(rng)
        t = await _port_table(c, "/vec/spill", vecs)
        idx = await t.create_index(nlist=5, metric="cosine", device=PCPU,
                                   cap_pct=50.0)
        assert idx.nlist_total > idx.nlist
        assert idx.lists.shape[1] < vecs.shape[0]   # actually capped
        members = idx.lists[idx.lists >= 0]
        assert sorted(members.tolist()) == list(range(vecs.shape[0]))
        prim = idx.centroids[:idx.nlist]
        for r in range(idx.nlist, idx.nlist_total):
            assert np.any(np.all(idx.centroids[r] == prim, axis=1))
        q = vecs[rng.choice(vecs.shape[0], 16, replace=False)]
        e_ids, _ = await t.knn(q, k=10, device=PCPU, use_index=False)
        a_ids, _ = await t.knn(q, k=10, device=PCPU,
                               nprobe=idx.nlist_total - 2)
        assert _recall(a_ids, e_ids) >= 0.9


async def test_stale_fallback_logged_once_and_counted(caplog):
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(29)
        vecs = clustered(rng, n_clusters=4, per=30, dim=16)
        t = await _port_table(c, "/vec/stalelog", vecs)
        await t.create_index(nlist=4, device=PCPU)
        await t.append(vecs[:2])                          # -> stale
        with caplog.at_level(logging.WARNING,
                             logger="curvine_tpu_torch.vector.table"):
            await t.knn(vecs[0], k=1, device=PCPU)
            await t.knn(vecs[1], k=1, device=PCPU)
        warns = [r for r in caplog.records if "stale" in r.message]
        assert len(warns) == 1                            # warned ONCE
        assert t.stale_fallbacks == 2                     # counted ALWAYS
        await t.knn(vecs[0], k=1, device=PCPU, use_index=False)
        assert t.stale_fallbacks == 2


async def test_pq_stale_append_delete_reindex():
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(23)
        vecs = clustered(rng, n_clusters=8, per=40, dim=32)
        t = await _port_table(c, "/vec/pqstale", vecs)
        await t.create_index(nlist=8, device=PCPU, pq_m=8)
        assert await t._fresh_index("cosine") is not None
        extra = rng.normal(size=(4, vecs.shape[1])).astype(np.float32)
        await t.append(extra)
        assert await t._fresh_index("cosine") is None     # stale
        ids, _ = await t.knn(extra[2], k=1, device=PCPU)  # exact fallback
        assert ids[0, 0] == vecs.shape[0] + 2
        assert t.stale_fallbacks == 1
        await t.delete([int(ids[0, 0])])
        await t.create_index(nlist=8, device=PCPU, pq_m=8)
        assert await t._fresh_index("cosine") is not None
        ids2, _ = await t.knn(extra[2], k=5, device=PCPU, nprobe=8,
                              rerank=60)
        assert vecs.shape[0] + 2 not in set(ids2[0].tolist())
        assert t.stale_fallbacks == 1                     # fresh again
        # the JAX package reads the port's delete vector and index alike
        jt = await JaxTable.open(c, "/vec/pqstale")
        assert await jt._fresh_index("cosine") is not None
        _same(await t.knn(extra, k=5, device=PCPU, nprobe=8, rerank=60),
              await jt.knn(extra, k=5, device=CPU, nprobe=8, rerank=60))


async def test_pq_persists_and_reloads():
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(19)
        vecs = clustered(rng, n_clusters=8, per=40, dim=32)
        t = await _port_table(c, "/vec/pqpersist", vecs)
        await t.create_index(nlist=8, device=PCPU, pq_m=8)
        t2 = await VectorTable.open(c, "/vec/pqpersist")
        idx = await t2._fresh_index("cosine")
        assert idx is not None and idx.pq is not None
        assert idx.codes.shape == (vecs.shape[0], 8)
        ids, _ = await t2.knn(vecs[5], k=1, device=PCPU, nprobe=4,
                              rerank=60)
        assert ids[0, 0] == 5
        assert await t2._fresh_index("l2") is None


def test_index_bytes_equal_both_ways_and_format_1_loads():
    rng = np.random.default_rng(11)
    vecs = skewed(rng)
    ids = np.arange(vecs.shape[0], dtype=np.int32)
    jidx = JaxIndex.build(vecs, ids, nlist=5, built_at={"v": 1}, iters=8,
                          device=CPU, cap_pct=50.0, pq_m=8, pq_ksub=64)
    pidx = IvfIndex.build(vecs, ids, nlist=5, built_at={"v": 1}, iters=8,
                          device=PCPU, cap_pct=50.0, pq_m=8, pq_ksub=64)
    for raw in (jidx.to_bytes(), pidx.to_bytes()):
        assert IvfIndex.from_bytes(raw).to_bytes() == raw
        assert JaxIndex.from_bytes(raw).to_bytes() == raw
    # format 1: no nlist_total / pq keys (index.py:517-518)
    flat = JaxIndex.build(vecs, ids, nlist=5, built_at={"v": 2}, iters=8,
                          device=CPU, cap_pct=100.0)
    assert flat.nlist_total == flat.nlist
    meta = json.dumps({"fmt": 1, "nlist": 5, "dim": vecs.shape[1],
                       "list_cap": int(flat.lists.shape[1]),
                       "built_at": {"v": 2}}).encode()
    raw = b"".join([np.int64(len(meta)).tobytes(), meta,
                    flat.centroids.astype(np.float32).tobytes(),
                    flat.lists.astype(np.int32).tobytes()])
    p1, j1 = IvfIndex.from_bytes(raw), JaxIndex.from_bytes(raw)
    assert p1.pq is None and p1.nlist_total == 5
    np.testing.assert_array_equal(p1.lists, j1.lists)
    np.testing.assert_array_equal(p1.centroids, j1.centroids)
    assert p1.to_bytes() == j1.to_bytes()


@pytest.mark.parametrize("metric", ["cosine", "l2"])
async def test_port_build_matches_jax_build(metric):
    """On well-separated clusters no assignment is near a tie, so the
    builds agree: the same lists and spill owners and codes; centroids
    and codebooks to 1e-5 (sums of up to 300 rows in another order); the
    l2 norms to 1e-5 relative."""
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(3)
        vecs = clustered(rng, n_clusters=12, per=50, dim=32, spread=0.1)
        jt = await _jax_table(c, "/vec/build", vecs)
        pt = await VectorTable.open(c, "/vec/build")
        kw = dict(nlist=12, metric=metric, iters=6, cap_pct=90.0, pq_m=8,
                  pq_ksub=32, pq_iters=6)
        j = await jt.create_index(device=CPU, **kw)
        p = await pt.create_index(device=PCPU, **kw)
        assert p.built_at == j.built_at and p.nlist == j.nlist
        np.testing.assert_array_equal(p.lists, j.lists)
        np.testing.assert_allclose(p.centroids, j.centroids, atol=1e-5)
        # a spill row's centroid is its owner's: same owners
        same = np.abs(p.centroids[:, None] - j.centroids[None]).max(2) < 1e-5
        assert np.array_equal(same, same.T) and same.diagonal().all()
        np.testing.assert_allclose(p.pq.codebooks, j.pq.codebooks,
                                   atol=1e-5)
        np.testing.assert_array_equal(p.codes, j.codes)
        np.testing.assert_allclose(p.norms, j.norms, rtol=1e-5)


def test_pq_roundtrip_error_bound_and_chunking():
    rng = np.random.default_rng(3)
    vecs = clustered(rng)
    pq = PqCodebook.train(vecs, m=16, ksub=256, iters=8, device=PCPU)
    assert (pq.m, pq.ksub, pq.dsub) == (16, 256, 4)
    codes = pq.encode(vecs, device=PCPU)
    assert codes.shape == (vecs.shape[0], 16) and codes.dtype == np.uint8
    recon = pq.decode(codes)
    rel = np.mean(np.sum((vecs - recon) ** 2, axis=1)) \
        / np.mean(np.sum(vecs ** 2, axis=1))
    assert rel < 0.05, f"relative reconstruction error {rel}"
    np.testing.assert_array_equal(codes, pq.encode(vecs, device=PCPU,
                                                   chunk=257))
    with pytest.raises(perr.InvalidArgument):
        PqCodebook.train(rng.normal(size=(64, 30)).astype(np.float32),
                         m=8, device=PCPU)


async def test_search_issues_one_adc_call_a_chunk_through_the_hook():
    """``IvfIndex.search`` counts its ADC stages and takes the ADC
    function as a hook; K2's plain version passed in gives the same
    result as the default."""
    async with _cluster() as mc:
        c = mc.client()
        rng = np.random.default_rng(37)
        vecs = clustered(rng, n_clusters=4, per=30, dim=16)
        t = await _port_table(c, "/vec/hook", vecs)
        idx = await t.create_index(nlist=4, device=PCPU, pq_m=4, pq_ksub=32)
        v, ids = await t._device_vectors("cosine", PCPU)
        q = vecs[:40]
        seen = []

        def adc(lut, codes, pre_offset):
            seen.append(lut.shape[0])
            return pq_ops.pq_lut_scan_plain(lut, codes, pre_offset)

        idx.adc_calls = 0
        a = idx.search(q, v, ids, 5, "cosine", 4, rerank=40)
        b = idx.search(q, v, ids, 5, "cosine", 4, rerank=40, adc=adc)
        assert idx.adc_calls == 2 and seen == [40]
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------- AnnServer ----------------


async def test_ann_server_microbatch_and_bulk_match_jax():
    """Concurrent queries coalesce into one batch; the bulk path equals a
    direct knn; both equal the JAX server's on the same table and index
    (the slice as a whole)."""
    rng = np.random.default_rng(7)
    async with _cluster() as mc:
        c = mc.client()
        vecs = rng.normal(size=(2000, 32)).astype(np.float32)
        jt = await JaxTable.create(c, "/vec/serve", 32)
        await jt.append(vecs)
        await jt.create_index(nlist=32, metric="cosine", iters=4,
                              device=CPU, pq_m=8)
        table = await VectorTable.open(c, "/vec/serve")
        srv = await AnnServer(table, k=10, metric="cosine", nprobe=16,
                              rerank=100, max_batch=64, max_wait_ms=5.0,
                              device=PCPU).start()
        jsrv = await JaxServer(jt, k=10, metric="cosine", nprobe=16,
                               rerank=100, max_batch=64, max_wait_ms=5.0,
                               device=CPU, warm_all=False).start()
        try:
            qids = [3, 77, 1500, 42]
            results = await asyncio.gather(
                *(srv.query(vecs[i]) for i in qids))
            for qid, (ids, scores) in zip(qids, results):
                assert ids.shape == (10,)
                assert int(ids[0]) == qid          # self is nearest
                assert scores[0] >= scores[-1]
            st = srv.stats()
            assert st["queries"] == 4 and st["batches"] >= 1
            assert 0.0 < st["batch_occupancy"] <= 1.0
            assert st["config"]["nprobe"] == 16
            assert st["config"]["rerank"] == 100
            assert st["stale_fallbacks"] == 0
            queries = vecs[100:164]
            got = await srv.query_many(queries, batch=16, depth=2)
            direct = await table.knn(queries, k=10, device=PCPU, nprobe=16,
                                     rerank=100)
            _same(got, direct)
            _same(got, await jsrv.query_many(queries, batch=16, depth=2))
            jres = await asyncio.gather(*(jsrv.query(vecs[i]) for i in qids))
            for (pi, ps), (ji, js) in zip(results, jres):
                _same((pi, ps), (ji, js))
            exact_i, _ = await table.knn(queries, k=10, device=PCPU,
                                         use_index=False)
            assert _recall(got[0], exact_i) >= 0.9
        finally:
            await srv.stop()
            await jsrv.stop()


async def test_ann_server_restart_skips_rewarm():
    async with _cluster() as mc:
        c = mc.client()
        table = await VectorTable.create(c, "/vec/rewarm", 8)
        await table.append(np.eye(8, dtype=np.float32))
        srv = await AnnServer(table, k=2, max_batch=8, use_index=False,
                              device=PCPU).start()
        warmed = set(srv._warmed)
        assert warmed == {1, 2, 4, 8}
        ids, _ = await srv.query(np.eye(8, dtype=np.float32)[1])
        assert int(ids[0]) == 1
        await srv.stop()
        with pytest.raises(perr.InvalidArgument):
            await srv.query(np.eye(8, dtype=np.float32)[1])
        await srv.start()                        # restart
        assert srv._warmed == warmed             # nothing re-warmed
        ids, _ = await srv.query(np.eye(8, dtype=np.float32)[2])
        assert int(ids[0]) == 2
        await srv.stop()


async def test_ann_server_error_propagates():
    async with _cluster() as mc:
        c = mc.client()
        table = await VectorTable.create(c, "/vec/err", 8)
        await table.append(np.eye(8, dtype=np.float32))
        srv = await AnnServer(table, k=2, max_batch=4, use_index=False,
                              device=PCPU).start()
        try:
            with pytest.raises(perr.InvalidArgument):
                await srv.query(np.zeros(5, dtype=np.float32))  # wrong dim
            ids, _ = await srv.query(np.eye(8, dtype=np.float32)[1])
            assert int(ids[0]) == 1                 # server still serves
            # a batch that fails on the device fails its waiters, and
            # the server serves on
            real = table.knn

            async def broken(*a, **kw):
                raise RuntimeError("device fault")
            table.knn = broken
            with pytest.raises(RuntimeError, match="device fault"):
                await srv.query(np.eye(8, dtype=np.float32)[2])
            table.knn = real
            ids, _ = await srv.query(np.eye(8, dtype=np.float32)[3])
            assert int(ids[0]) == 3
        finally:
            await srv.stop()


async def test_ann_server_stop_rejects_waiters():
    async with _cluster() as mc:
        c = mc.client()
        table = await VectorTable.create(c, "/vec/stop", 8)
        await table.append(np.eye(8, dtype=np.float32))
        srv = await AnnServer(table, k=2, max_batch=64, max_wait_ms=5_000,
                              use_index=False, device=PCPU).start()
        q = asyncio.ensure_future(srv.query(np.ones(8, dtype=np.float32)))
        await asyncio.sleep(0.05)
        await srv.stop()
        with pytest.raises(Exception, match="stopped"):
            await asyncio.wait_for(q, timeout=2.0)


# ---------------- the POSIX client ----------------


async def test_posix_client_writes_the_jax_tables_bytes(tmp_path):
    """A table written through the POSIX client is byte for byte the
    table the JAX package writes through the cache, and reads back."""
    rng = np.random.default_rng(17)
    vecs = clustered(rng, n_clusters=6, per=20, dim=16)
    pc = PosixClient(str(tmp_path))
    pt = await _port_table(pc, "/vec/posix", vecs)
    await pt.delete([3, 50])
    async with _cluster() as mc:
        c = mc.client()
        jt = await _jax_table(c, "/vec/posix", vecs)
        await jt.delete([3, 50])
        for name in ("schema.json", "rg-00000.vec", "rg-00001.vec",
                     "deletes.bin"):
            want = await (await c.open(f"/vec/posix/{name}")).read_all()
            assert (tmp_path / "vec" / "posix" / name).read_bytes() == want
            assert await (await pc.open(f"/vec/posix/{name}")
                          ).read_all() == want
        t2 = await VectorTable.open(pc, "/vec/posix")
        assert await t2.count() == vecs.shape[0] - 2
        q = vecs[[0, 60, 100]]
        _same(await t2.knn(q, k=5, device=PCPU),
              await jt.knn(q, k=5, device=CPU))
        got, _ = await t2.take([0, 1, 119])
        np.testing.assert_array_equal(got, vecs[[0, 1, 119]])
    with pytest.raises(perr.FileNotFound):
        await pc.open("/vec/posix/nothing")
    reader = await pc.open("/vec/posix/schema.json")
    assert await reader.mmap_view(0, reader.len) is None
    await pc.meta.delete("/vec/posix")
    assert not (tmp_path / "vec" / "posix").exists()


async def test_compact_through_the_posix_client(tmp_path):
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(30, 8)).astype(np.float32)
    pc = PosixClient(str(tmp_path))
    t = await _port_table(pc, "/vec/compact", vecs)
    await t.delete(list(range(15)))              # the whole first group
    assert await t.compact() == 15
    assert t.row_groups == 1 and not (
        tmp_path / "vec" / "compact" / "rg-00001.vec").exists()
    got, _ = await t.take([0, 14])
    np.testing.assert_array_equal(got, vecs[[15, 29]])


def test_vector_entry_points_need_cuda_unless_the_cpu_is_asked_for(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs = np.eye(8, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IvfIndex.build(vecs, np.arange(8, dtype=np.int32), 2, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PqCodebook.train(vecs, m=2)

    async def run():
        t = await VectorTable.create(PosixClient(str(tmp_path)), "/t", 8)
        await t.append(vecs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await t.knn(vecs[0])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await t.create_index(nlist=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await AnnServer(t).start()
        ids, _ = await t.knn(vecs[1], k=1, device="cpu")
        assert int(ids[0, 0]) == 1
    asyncio.run(run())
