"""Deterministic per-epoch shard ordering.

Port of ``curvine_tpu/common/epoch.py`` (its own copy).

The one fact that makes training input prefetchable: given (seed,
epoch), the shard order for *any* epoch — including the next one — is a
pure function of the sorted shard list. The SDK loaders, the master's
rolling prefetch-window planner, and the tests all call this one
function, so a master recovering a prefetch job recomputes the exact
order the client is reading instead of persisting (or re-walking) the
file list.
"""

from __future__ import annotations

__all__ = ["epoch_shard_order"]


def epoch_shard_order(shards, seed: int | None = None,
                      epoch: int = 0) -> list[str]:
    """Shard order for ``epoch``: a seeded permutation of the *sorted*
    shard list (sorting first makes the order independent of listing
    order). ``seed is None`` means no shuffle — every epoch reads in
    lexical order."""
    ordered = sorted(shards)
    if seed is None:
        return ordered
    import numpy as np
    rng = np.random.default_rng((int(seed) & 0x7FFFFFFF, int(epoch)))
    return [ordered[i] for i in rng.permutation(len(ordered))]
