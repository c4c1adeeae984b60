"""Block placement policies.

Own copy of ``curvine_tpu/master/placement.py``: ``local`` (the default:
the client's host first, then random), ``random``, ``robin``,
``weighted`` (by available bytes), ``load`` (least loaded first) and
``ici`` (``IciPolicy``, :163-201: the first replica nearest the writer,
the others spread by max-min distance); ``choose``'s pool rules (:54-79):
workers with room first, all of them under capacity pressure, fewer than
asked when the caller takes ``min_count``; the distance every policy and
the replication manager share, ``topology_distance`` (:17-35: torus hops
where both sides carry ICI coordinates, else the host labels, else
``UNKNOWN_FAR``) behind the pluggable ``distance_fn`` and
``worker_distance`` (:41-52); ``ici_hops``, the torus hop distance
(:147-160), which ``gpu/ici_plane.py::broadcast_schedule`` orders its
tree by; and ``create_policy`` (:204-210)."""

from __future__ import annotations

import random

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import WorkerInfo

# the host-label fallback's tiers: the same host is free, another host
# far, and nothing known farther still; the order is what matters
HOST_FAR = 1 << 8
UNKNOWN_FAR = 1 << 16


def topology_distance(a_coords, a_host, b_coords, b_host,
                      mesh_shape=None) -> int:
    """Torus hops when both sides carry ICI coordinates of one rank,
    else 0 on the same host and ``HOST_FAR`` on another, else
    ``UNKNOWN_FAR``."""
    if a_coords and b_coords and len(a_coords) == len(b_coords):
        return ici_hops(list(a_coords), list(b_coords), mesh_shape)
    if a_host and b_host:
        return 0 if a_host == b_host else HOST_FAR
    return UNKNOWN_FAR


class PlacementPolicy:
    name = "base"

    def __init__(self, mesh_shape: list[int] | None = None,
                 distance_fn=None):
        # distance_fn(a_coords, a_host, b_coords, b_host) -> int; the
        # default closes over the torus shape
        self.mesh_shape = mesh_shape
        self.distance_fn = distance_fn or (
            lambda ac, ah, bc, bh: topology_distance(
                ac, ah, bc, bh, self.mesh_shape))

    def worker_distance(self, a: WorkerInfo, b: WorkerInfo) -> int:
        return self.distance_fn(a.ici_coords, a.address.hostname,
                                b.ici_coords, b.address.hostname)

    def choose(self, workers: list[WorkerInfo], count: int,
               client_host: str = "", exclude: set[int] | None = None,
               needed: int = 0, ici_coords: list[int] | None = None,
               min_count: int | None = None,
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
        return self._pick(pool, count, client_host, ici_coords)

    def _pick(self, pool, count, client_host, ici_coords):
        raise NotImplementedError


class RandomPolicy(PlacementPolicy):
    name = "random"

    def _pick(self, pool, count, client_host, ici_coords):
        return random.sample(pool, count)


class RobinPolicy(PlacementPolicy):
    name = "robin"

    def __init__(self, mesh_shape: list[int] | None = None,
                 distance_fn=None) -> None:
        super().__init__(mesh_shape, distance_fn)
        self._next = 0

    def _pick(self, pool, count, client_host, ici_coords):
        pool = sorted(pool, key=lambda w: w.address.worker_id)
        out = [pool[(self._next + i) % len(pool)] for i in range(count)]
        self._next = (self._next + count) % max(1, len(pool))
        return out


class LocalPolicy(PlacementPolicy):
    """The worker on the client's host first, then random."""

    name = "local"

    def _pick(self, pool, count, client_host, ici_coords):
        local = [w for w in pool
                 if client_host and client_host in
                 (w.address.hostname, w.address.ip_addr)]
        rest = [w for w in pool if w not in local]
        random.shuffle(rest)
        return (local + rest)[:count]


class WeightedPolicy(PlacementPolicy):
    """Chosen with probability proportional to available bytes."""

    name = "weighted"

    def _pick(self, pool, count, client_host, ici_coords):
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

    def _pick(self, pool, count, client_host, ici_coords):
        def load(w: WorkerInfo) -> float:
            return 1.0 - w.available / max(1, w.capacity)
        return sorted(pool, key=load)[:count]


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


class IciPolicy(PlacementPolicy):
    """The first replica nearest the writer (its reads stay on short
    links), then each further replica the one farthest from those chosen
    (the largest least distance), so replicas spread over fault domains;
    ties go to an unused host, then nearness to the writer, then free
    bytes."""

    name = "ici"

    def _pick(self, pool, count, client_host, ici_coords):
        to_writer = lambda w: self.distance_fn(          # noqa: E731
            ici_coords or [], client_host,
            w.ici_coords, w.address.hostname)
        ranked = sorted(pool, key=lambda w: (to_writer(w), -w.available))
        out: list[WorkerInfo] = [ranked[0]]
        while len(out) < count:
            chosen_hosts = {o.address.hostname for o in out}

            def spread_key(w):
                dmin = min(self.worker_distance(w, o) for o in out)
                return (-dmin,
                        0 if w.address.hostname not in chosen_hosts else 1,
                        to_writer(w), -w.available)

            out.append(min((w for w in ranked if w not in out),
                           key=spread_key))
        return out


_POLICIES = {p.name: p for p in (RandomPolicy, RobinPolicy, LocalPolicy,
                                 WeightedPolicy, LoadBasedPolicy, IciPolicy)}


def create_policy(name: str, mesh_shape: list[int] | None = None,
                  distance_fn=None) -> PlacementPolicy:
    cls = _POLICIES.get(name)
    if cls is None:
        raise err.InvalidArgument(f"unknown placement policy {name!r}; "
                                  f"have {sorted(_POLICIES)}")
    return cls(mesh_shape=mesh_shape, distance_fn=distance_fn)
