"""Block placement policies.

Own copy of ``curvine_tpu/master/placement.py``: ``local`` (the default:
the client's host first, then random), ``random``, ``robin``,
``weighted`` (by available bytes) and ``load`` (least loaded first), and
``choose``'s pool rules: workers with room first, all of them under
capacity pressure, fewer than asked when the caller takes
``min_count``; and ``ici_hops``, the torus hop distance (:147-160), which
``gpu/ici_plane.py::broadcast_schedule`` orders its tree by. Left out:
``ici``, the torus-distance policy, which waits for replication over the
device path (ROADMAP A10b); the conf refuses it."""

from __future__ import annotations

import random

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import WorkerInfo


class PlacementPolicy:
    name = "base"

    def choose(self, workers: list[WorkerInfo], count: int,
               client_host: str = "", exclude: set[int] | None = None,
               needed: int = 0, min_count: int | None = None,
               ) -> list[WorkerInfo]:
        exclude = exclude or set()
        pool = [w for w in workers
                if w.address.worker_id not in exclude and w.available > needed]
        if len(pool) < 1 or len(pool) < count:
            pool_all = [w for w in workers
                        if w.address.worker_id not in exclude]
            if len(pool_all) >= count and count > 0:
                pool = pool_all  # capacity pressure: eviction makes room
        if len(pool) < count:
            # degraded placement: place on what is alive when the caller
            # takes fewer
            if min_count is not None and len(pool) >= max(1, min_count):
                count = len(pool)
            else:
                raise err.NoAvailableWorker(
                    f"need {count} workers, have {len(pool)} eligible")
        return self._pick(pool, count, client_host)

    def _pick(self, pool, count, client_host):
        raise NotImplementedError


class RandomPolicy(PlacementPolicy):
    name = "random"

    def _pick(self, pool, count, client_host):
        return random.sample(pool, count)


class RobinPolicy(PlacementPolicy):
    name = "robin"

    def __init__(self) -> None:
        self._next = 0

    def _pick(self, pool, count, client_host):
        pool = sorted(pool, key=lambda w: w.address.worker_id)
        out = [pool[(self._next + i) % len(pool)] for i in range(count)]
        self._next = (self._next + count) % max(1, len(pool))
        return out


class LocalPolicy(PlacementPolicy):
    """The worker on the client's host first, then random."""

    name = "local"

    def _pick(self, pool, count, client_host):
        local = [w for w in pool
                 if client_host and client_host in
                 (w.address.hostname, w.address.ip_addr)]
        rest = [w for w in pool if w not in local]
        random.shuffle(rest)
        return (local + rest)[:count]


class WeightedPolicy(PlacementPolicy):
    """Chosen with probability proportional to available bytes."""

    name = "weighted"

    def _pick(self, pool, count, client_host):
        out: list[WorkerInfo] = []
        candidates = list(pool)
        for _ in range(count):
            weights = [max(1, w.available) for w in candidates]
            chosen = random.choices(candidates, weights=weights, k=1)[0]
            out.append(chosen)
            candidates.remove(chosen)
        return out


class LoadBasedPolicy(PlacementPolicy):
    """Least loaded first (the largest available share)."""

    name = "load"

    def _pick(self, pool, count, client_host):
        def load(w: WorkerInfo) -> float:
            return 1.0 - w.available / max(1, w.capacity)
        return sorted(pool, key=load)[:count]


_POLICIES = {p.name: p for p in (RandomPolicy, RobinPolicy, LocalPolicy,
                                 WeightedPolicy, LoadBasedPolicy)}


def ici_hops(a: list[int], b: list[int], mesh_shape: list[int] | None = None
             ) -> int:
    """Torus hop distance between two ICI coordinates: per axis, the
    shorter way round where ``mesh_shape`` gives the axis, else the plain
    difference. Unknown or mismatched coordinates are very far (1 << 16),
    so known-near workers win."""
    if not a or not b or len(a) != len(b):
        return 1 << 16
    total = 0
    for i, (x, y) in enumerate(zip(a, b)):
        d = abs(x - y)
        if mesh_shape and i < len(mesh_shape) and mesh_shape[i] > 0:
            d = min(d, mesh_shape[i] - d)
        total += d
    return total


def create_policy(name: str) -> PlacementPolicy:
    cls = _POLICIES.get(name)
    if cls is None:
        raise err.InvalidArgument(f"unknown placement policy {name!r}; the "
                                  f"port has {sorted(_POLICIES)}")
    return cls()
