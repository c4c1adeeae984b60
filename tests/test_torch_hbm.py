"""Port parity: the device tier-0 of ``curvine_tpu_torch`` (on the CPU)
against the JAX package's ``tpu/hbm.py`` (on CPU devices). The same
put/get/drop sequences must give equal stats, eviction order, export
snapshots and exported gauges; mirrors ``test_hbm_tier``,
``test_hbm_export_metrics``, ``test_multi_hbm_tier_placement_and_replicas``,
``test_hbm_scan_does_not_spill_hot`` and
``test_hbm_lru_fallback_spills_oldest``."""

import numpy as np
import pytest

import jax

import torch

from curvine_tpu.common.metrics import MetricsRegistry as JaxRegistry
from curvine_tpu.tpu import hbm as jax_hbm
from curvine_tpu_torch.common.metrics import MetricsRegistry
from curvine_tpu_torch.gpu import hbm

KB = 1024
MB = 1024 * 1024
CPUS = jax.devices("cpu")


def _torch_cpus(devs):
    return [torch.device("cpu", d.id) for d in devs]


def _data(bid: int, n: int) -> np.ndarray:
    return np.random.default_rng(bid).integers(0, 256, n, dtype=np.uint8)


def _host(arr) -> np.ndarray:
    return arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def _apply(tier, op):
    """Run one op; return what it observed, in a framework-free form."""
    kind, *a = op
    if kind == "put":
        bid, n = a
        return _host(tier.put(bid, _data(bid, n))).tobytes() == \
            _data(bid, n).tobytes()
    if kind == "put_bytes":
        bid, n = a
        tier.put(bid, b"\0" * n)
        return None
    if kind == "get":
        arr = tier.get(a[0])
        return None if arr is None else _host(arr).tobytes()
    if kind == "drop":
        tier.drop(a[0], evicted=a[1])
        return None
    if kind == "put_on":                       # MultiHbmTier only
        bid, n, did = a
        tier.put(bid, _data(bid, n), device=did)
        return None
    if kind == "put_rep":
        bid, n, k = a
        return len(tier.put_replicated(bid, _data(bid, n), k=k))
    if kind == "get_on":
        arr = tier.get(a[0], device=a[1])
        return None if arr is None else _host(arr).tobytes()
    raise AssertionError(kind)


def _trace(tier, ops, ids):
    """Per op: its result and the set of resident ids (eviction order)."""
    out = []
    for op in ops:
        res = _apply(tier, op)
        out.append((res, sorted(b for b in ids if b in tier)))
    return out


def _random_ops(seed: int, n_ops: int = 120, ids: int = 24):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        bid = int(rng.integers(0, ids))
        if r < 0.55:
            ops.append(("put", bid, int(rng.integers(1, 5)) * KB))
        elif r < 0.9:
            ops.append(("get", bid))
        else:
            ops.append(("drop", bid, bool(rng.integers(0, 2))))
    return ops


@pytest.mark.parametrize("admission", ["lru", "s3fifo"])
def test_tier_parity_on_random_sequences(admission):
    ops = _random_ops(7 if admission == "lru" else 11)
    ref = jax_hbm.HbmTier(16 * KB, device=CPUS[0], admission=admission,
                          ghost_entries=8)
    port = hbm.HbmTier(16 * KB, device=torch.device("cpu"),
                       admission=admission, ghost_entries=8)
    assert _trace(port, ops, range(24)) == _trace(ref, ops, range(24))
    assert port.stats() == ref.stats()
    assert port.policy.stats() == ref.policy.stats()
    assert port.stats()["spills"] > 0


@pytest.mark.parametrize("admission", ["lru", "s3fifo"])
def test_tier_parity_hbm_tier(admission):
    """``test_hbm_tier``'s sequence, with the LRU eviction of block 2."""
    ops = [("put", 1, 4 * MB), ("put", 2, 4 * MB), ("get", 1),
           ("put", 3, 4 * MB), ("get", 2), ("get", 3)]
    ref = jax_hbm.HbmTier(10 * MB, device=CPUS[0], admission=admission)
    port = hbm.HbmTier(10 * MB, device=torch.device("cpu"),
                       admission=admission)
    got = _trace(port, ops, range(4))
    assert got == _trace(ref, ops, range(4))
    assert port.stats() == ref.stats()
    if admission == "lru":
        assert got[3][1] == [1, 3] and port.stats()["spills"] == 1
    assert port.used == sum(t.nbytes for t in port._blocks.values())


def test_tier_parity_scan_does_not_spill_hot():
    ops = [("put_bytes", b, KB) for b in range(4)] + \
        [("get", b) for b in range(4)] + \
        [("put_bytes", 100 + k, KB) for k in range(16)]
    ref = jax_hbm.HbmTier(8 * KB, device=CPUS[0], admission="s3fifo")
    port = hbm.HbmTier(8 * KB, device=torch.device("cpu"),
                       admission="s3fifo")
    ids = list(range(4)) + list(range(100, 116))
    assert _trace(port, ops, ids) == _trace(ref, ops, ids)
    assert all(b in port for b in range(4))
    assert port.stats() == ref.stats() and port.stats()["scan_evicted"] > 0


def test_tier_parity_lru_fallback_spills_oldest():
    ops = [("put_bytes", b, KB) for b in range(4)] + [("get", 0),
                                                     ("put_bytes", 9, KB)]
    ref = jax_hbm.HbmTier(4 * KB, device=CPUS[0], admission="lru")
    port = hbm.HbmTier(4 * KB, device=torch.device("cpu"), admission="lru")
    ids = [0, 1, 2, 3, 9]
    assert _trace(port, ops, ids) == _trace(ref, ops, ids)
    assert 0 in port and 1 not in port


@pytest.mark.parametrize("admission", ["lru", "s3fifo"])
def test_export_metrics_parity(admission):
    ops = [("put", 1, MB), ("get", 1), ("get", 99), ("put", 2, MB),
           ("put", 3, 2 * MB)]
    ref = jax_hbm.HbmTier(2 * MB, device=CPUS[0], admission=admission)
    port = hbm.HbmTier(2 * MB, device=torch.device("cpu"),
                       admission=admission)
    _trace(ref, ops, [1, 2, 3])
    _trace(port, ops, [1, 2, 3])
    m_ref, m_port = JaxRegistry("worker"), MetricsRegistry("worker")
    jax_hbm.export_metrics(ref, m_ref)
    hbm.export_metrics(port, m_port)
    assert m_port.snapshot() == m_ref.snapshot()
    assert m_port.prometheus_text() == m_ref.prometheus_text()
    g = m_port.snapshot()["gauges"]
    assert g["hbm.used"] == 2 * MB and g["hbm.occupancy"] == 1.0


@pytest.mark.parametrize("admission", ["lru", "s3fifo"])
def test_multi_tier_parity_placement_and_replicas(admission):
    """``test_multi_hbm_tier_placement_and_replicas`` on both tiers: four
    devices with explicit ids, balanced placement, replica spread, local
    reads, per-device eviction, one shared export table and policy."""
    devs = CPUS[:4]
    ref = jax_hbm.MultiHbmTier(1_200_000, devices=devs, admission=admission,
                               export_cap=6)
    port = hbm.MultiHbmTier(1_200_000, devices=_torch_cpus(devs),
                            admission=admission, export_cap=6)
    ops = [("put", b, 100_000) for b in range(8)] + [
        ("drop", 0, False), ("put_rep", 100, 1000, 3),
        ("get_on", 100, devs[1].id), ("get_on", 100, devs[0].id),
        ("put_on", 999, 250_000, devs[0].id), ("get", 999), ("get", 1),
        ("drop", 999, True), ("put_on", 999, 250_000, devs[2].id),
        ("get", 12345)]
    ids = list(range(8)) + [100, 999, 12345]
    assert _trace(port, ops, ids) == _trace(ref, ops, ids)
    assert port.per_device_stats() == ref.per_device_stats()
    assert port.stats() == ref.stats()
    for b in ids:
        assert port.holders(b) == ref.holders(b)
    assert port.exports.snapshot() == ref.exports.snapshot()
    assert port.exports.snapshot(limit=2) == ref.exports.snapshot(limit=2)
    assert port.exports.evictions == ref.exports.evictions > 0
    assert all(e["dtype"] == "uint8" for e in port.exports.snapshot())
    m_ref, m_port = JaxRegistry("worker"), MetricsRegistry("worker")
    jax_hbm.export_metrics(ref, m_ref)
    hbm.export_metrics(port, m_port)
    assert m_port.snapshot() == m_ref.snapshot()


def test_multi_tier_rejects_foreign_device_and_oversize():
    port = hbm.MultiHbmTier(2 * MB, devices=_torch_cpus(CPUS[:2]))
    with pytest.raises(ValueError, match="not part of the HBM tier"):
        port.put(1, np.zeros(10, dtype=np.uint8), device=7)
    with pytest.raises(ValueError, match="per-chip share"):
        port.put(2, np.zeros(2 * MB, dtype=np.uint8))
    ro = np.zeros(100, dtype=np.uint8)
    ro.setflags(write=False)                 # an mmap view is read-only
    assert port.put(3, ro).numpy().tobytes() == ro.tobytes()
