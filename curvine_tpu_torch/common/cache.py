"""Ghost-cache admission policies for the device tier-0.

Port of ``curvine_tpu/common/cache.py`` (its own copy: the port imports
nothing of the JAX package). Under pure LRU, one cold backfill scan
through the device tier in ``gpu/hbm.py`` writes 2x the tier's size
once, and every one-touch scan block displaces a multi-touch training
working-set block. S3-FIFO (Yang et al., SOSP'23) fixes
exactly that mix with three structures:

* a **small** probationary FIFO (~10% of capacity by bytes) where every
  first-seen block lands;
* a **main** FIFO holding the working set, protected by CLOCK-style
  second chances;
* a **ghost** queue of recently-evicted block ids (ids only, no bytes):
  a readmitted ghost skips probation and goes straight to main.

One-touch scan blocks enter small, are never touched again, and leave
through the small queue without ever displacing main. A block evicted
by mistake comes back through the ghost and is immediately protected.

The policy object is *advisory*: it orders eviction victims and tracks
membership, but the owning store remains the source of truth for what
is resident (pins, leases, and tier moves are invisible to the policy).
``victim_order`` therefore takes the store's eligible set and returns a
preference order over it — unknown ids (recovered from disk before the
policy existed) are treated as probationary.

``LruPolicy`` preserves the historical behavior byte-for-byte (victims
ordered by atime ascending) so ``admission="lru"`` is an exact fallback.
"""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["CachePolicy", "LruPolicy", "S3FifoPolicy", "make_policy"]

# freq is capped so a once-hot block cannot ride second chances forever
# after the workload moves on (the S3-FIFO paper uses 3)
_FREQ_CAP = 3


class CachePolicy:
    """Shared counters + the interface both stores drive.

    hits/misses are accounted by the owner (it knows what a lookup is);
    admits/ghost_hits/evictions are accounted here."""

    name = "none"

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self.admits = 0
        self.ghost_hits = 0      # readmission of a recently-evicted id
        self.evicted = 0         # removals under cache pressure
        self.scan_evicted = 0    # one-touch probationary evictions
        # admission "rejects": blocks that entered and left the
        # probationary region without ever protecting themselves — the
        # S3-FIFO equivalent of refusing a scan block admission to the
        # working set (same counter as scan_evicted, reported as such)

    # -- membership hooks (caller holds its own lock) --
    def on_admit(self, key: int, size: int = 0) -> None:
        self.admits += 1

    def on_access(self, key: int) -> None:
        pass

    def on_remove(self, key: int, evicted: bool = False) -> None:
        if evicted:
            self.evicted += 1

    # -- eviction planning --
    def victim_order(self, entries: list[tuple[int, float]]) -> list[int]:
        """``entries`` is the owner's eligible set as (key, atime).
        Returns every key, ordered most-evictable first."""
        raise NotImplementedError

    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "admits": self.admits, "ghost_hits": self.ghost_hits,
                "evicted": self.evicted,
                "scan_evicted": self.scan_evicted}


class LruPolicy(CachePolicy):
    """Byte-compatible fallback: victims by atime ascending, exactly the
    historical ``sorted(..., key=lambda b: b.atime)`` order."""

    name = "lru"

    def victim_order(self, entries: list[tuple[int, float]]) -> list[int]:
        return [k for k, _ in sorted(entries, key=lambda e: e[1])]


class S3FifoPolicy(CachePolicy):
    name = "s3fifo"

    def __init__(self, ghost_entries: int = 8192,
                 small_ratio: float = 0.1) -> None:
        super().__init__()
        self.ghost_entries = max(1, int(ghost_entries))
        self.small_ratio = small_ratio
        # OrderedDicts: FIFO order is insertion order; values are sizes
        self._small: OrderedDict[int, int] = OrderedDict()
        self._main: OrderedDict[int, int] = OrderedDict()
        self._ghost: OrderedDict[int, None] = OrderedDict()
        self._freq: dict[int, int] = {}

    # -- membership --
    def on_admit(self, key: int, size: int = 0) -> None:
        self.admits += 1
        self._freq[key] = 0
        if key in self._ghost:
            # evicted recently and wanted again: skip probation
            del self._ghost[key]
            self.ghost_hits += 1
            self._small.pop(key, None)
            self._main[key] = size
            self._main.move_to_end(key)
            return
        if key in self._main:       # re-create of a tracked id
            self._main[key] = size
            return
        self._small[key] = size
        self._small.move_to_end(key)

    def on_access(self, key: int) -> None:
        if key in self._small or key in self._main:
            f = self._freq.get(key, 0)
            if f < _FREQ_CAP:
                self._freq[key] = f + 1
        else:
            # untracked but resident (recovered before the policy
            # attached, or moved in from another tier): start probation
            self._small[key] = 0
            self._freq[key] = 1

    def on_remove(self, key: int, evicted: bool = False) -> None:
        from_small = self._small.pop(key, None) is not None
        self._main.pop(key, None)
        self._freq.pop(key, None)
        if evicted:
            self.evicted += 1
            if from_small:
                self.scan_evicted += 1
            self._ghost[key] = None
            self._ghost.move_to_end(key)
            while len(self._ghost) > self.ghost_entries:
                self._ghost.popitem(last=False)

    # -- planning --
    def victim_order(self, entries: list[tuple[int, float]]) -> list[int]:
        eligible = {k: at for k, at in entries}
        order: list[int] = []
        seen: set[int] = set()
        # 1. drain small FIFO-first: one-touch blocks are the victims;
        #    touched blocks earn promotion to main instead (this lazy
        #    promotion IS the S3-FIFO admission filter)
        for key in list(self._small):
            if self._freq.get(key, 0) >= 1:
                size = self._small.pop(key)
                self._main[key] = size
                self._main.move_to_end(key)
                self._freq[key] = 0
                continue
            if key in eligible:
                order.append(key)
                seen.add(key)
        # 2. main FIFO with second chances: a touched block re-queues at
        #    the tail with freq-1; cold blocks fall out in FIFO order
        for key in list(self._main):
            if self._freq.get(key, 0) > 0:
                self._freq[key] -= 1
                self._main.move_to_end(key)
                continue
            if key in eligible:
                order.append(key)
                seen.add(key)
        # 3. ids the policy has never seen (restart recovery): treat as
        #    probationary, oldest first, ahead of the protected main set
        #    but after known scan blocks
        unknown = sorted((k for k in eligible if k not in seen
                          and k not in self._small and k not in self._main),
                         key=lambda k: eligible[k])
        if unknown:
            n_small = len([k for k in order if k in self._small])
            order = order[:n_small] + unknown + order[n_small:]
        return order

    def stats(self) -> dict[str, int]:
        out = super().stats()
        out["small"] = len(self._small)
        out["main"] = len(self._main)
        out["ghost"] = len(self._ghost)
        return out


def make_policy(admission: str, ghost_entries: int = 8192,
                small_ratio: float = 0.1) -> CachePolicy:
    if admission == "s3fifo":
        return S3FifoPolicy(ghost_entries=ghost_entries,
                            small_ratio=small_ratio)
    if admission in ("lru", "", None):
        return LruPolicy()
    raise ValueError(f"unknown cache admission policy {admission!r}")
