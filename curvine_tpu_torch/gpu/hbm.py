"""Device tier-0: a block cache resident in the card's memory.

Port of ``curvine_tpu/tpu/hbm.py:20-313`` (``HbmExportTable``,
``HbmTier``, ``MultiHbmTier``, ``export_metrics``). Hot blocks live in
device memory as 1-D uint8 tensors, so a consumer's input fetch is a
device slice instead of a host→device copy. Capacity is accounted
explicitly; the admission policy (LRU or S3-FIFO) picks victims, and
spilling is dropping the device copy (the host tier keeps the file).

What differs from the JAX tier:

* ``jax.device_put`` becomes an explicit copy on the current stream
  through the pinned staging ring of ``gpu/ingest.py`` (``PinnedStager``):
  the host bytes, often a read-only mmap view, are never wrapped as a
  tensor, and the host copy of one chunk overlaps the DMA of the one
  before.
* ``arr.delete()`` becomes dropping the tier's reference. ``used`` is
  the tier's own byte count: the caching allocator keeps freed memory
  reserved, so its statistics do not say what the tier holds.
* A device id is the CUDA index; a CPU tier (the tests) takes
  ``torch.device("cpu", i)`` for an explicit id.
* Export entries keep the dtype string ``"uint8"`` so heartbeat payloads
  match the JAX tier's."""

from __future__ import annotations

import logging
import time
from collections import OrderedDict

import numpy as np
import torch

from curvine_tpu_torch.common.cache import make_policy
from curvine_tpu_torch.device import default_device, device_id, local_devices
from curvine_tpu_torch.gpu.ingest import PinnedStager

log = logging.getLogger(__name__)

__all__ = ["HbmExportTable", "HbmTier", "MultiHbmTier", "export_metrics"]


class HbmExportTable:
    """Peer-addressable view of the device tier: block_id → device buffer
    descriptor, advertised in heartbeats so a peer can source the
    replica device-to-device instead of re-pulling bytes over TCP.

    Bounded LRU: the advertisement is capability metadata, not
    ownership — dropping an entry only stops advertising; the tier
    still holds the block."""

    def __init__(self, cap: int = 128):
        self.cap = max(1, int(cap))
        self._entries: OrderedDict[int, dict] = OrderedDict()
        self.exports = 0        # lifetime advertisements
        self.evictions = 0      # LRU pressure on the table itself

    def add(self, block_id: int, device_id: int, arr: torch.Tensor) -> None:
        e = {"device_id": int(device_id),
             "shape": list(arr.shape),
             "dtype": str(arr.dtype).removeprefix("torch."),
             "nbytes": int(arr.nbytes)}
        if block_id in self._entries:
            self._entries.pop(block_id)
        elif len(self._entries) >= self.cap:
            self._entries.popitem(last=False)
            self.evictions += 1
        self._entries[block_id] = e
        self.exports += 1

    def remove(self, block_id: int) -> None:
        self._entries.pop(block_id, None)

    def get(self, block_id: int) -> dict | None:
        e = self._entries.get(block_id)
        if e is not None:
            self._entries.move_to_end(block_id)
        return e

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self, limit: int | None = None) -> list[dict]:
        """Most-recently-exported first, bounded — the heartbeat payload."""
        out = []
        for bid in reversed(self._entries):
            if limit is not None and len(out) >= limit:
                break
            out.append({"block_id": bid, **self._entries[bid]})
        return out


def _as_uint8(data) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data)
    arr = arr.reshape(-1)
    return arr if arr.dtype == np.uint8 else arr.view(np.uint8)


class HbmTier:
    def __init__(self, capacity_bytes: int, device=None,
                 admission: str = "lru", ghost_entries: int = 2048,
                 exports: HbmExportTable | None = None, policy=None):
        self.capacity = capacity_bytes
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.device_id = device_id(self.device)
        self.used = 0
        self._blocks: dict[int, torch.Tensor] = {}
        self._atime: dict[int, float] = {}
        self.hits = 0
        self.misses = 0
        self.spills = 0
        # peer-addressable advertisement (shared across devices under
        # MultiHbmTier); None → tier is private, nothing advertised
        self.exports = exports
        # ghost-cache admission (common/cache.py): an autopin sweep over a
        # cold scan must not spill the hot training blocks. An injected
        # shared policy (MultiHbmTier) lets a block evicted on one device
        # re-admit straight to main on ANY device.
        self.policy = policy if policy is not None else \
            make_policy(admission, ghost_entries=ghost_entries)
        self.stager = PinnedStager(self.device) \
            if self.device.type == "cuda" else None

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._blocks

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        out = torch.empty(arr.size, dtype=torch.uint8, device=self.device)
        if self.device.type == "cpu":
            out.numpy()[:] = arr
        else:
            self.stager.copy_in(out, arr)
        return out

    def put(self, block_id: int, data) -> torch.Tensor:
        """Pin a block (bytes / numpy view) into device memory. The copy
        is queued on the current stream; the returned tensor is ready for
        any work queued after it there."""
        if block_id in self._blocks:
            self._atime[block_id] = time.monotonic()
            self.policy.on_access(block_id)
            return self._blocks[block_id]
        arr = _as_uint8(data)
        need = arr.nbytes
        if need > self.capacity:
            raise ValueError(f"block of {need}B exceeds HBM tier capacity")
        self._evict_for(need)
        dev_arr = self._to_device(arr)
        self._blocks[block_id] = dev_arr
        self._atime[block_id] = time.monotonic()
        self.used += need
        self.policy.on_admit(block_id, need)
        if self.exports is not None:
            self.exports.add(block_id, self.device_id, dev_arr)
        return dev_arr

    def get(self, block_id: int) -> torch.Tensor | None:
        arr = self._blocks.get(block_id)
        if arr is None:
            self.misses += 1
            self.policy.misses += 1
            return None
        self.hits += 1
        self.policy.hits += 1
        self._atime[block_id] = time.monotonic()
        self.policy.on_access(block_id)
        return arr

    def drop(self, block_id: int, evicted: bool = False) -> None:
        arr = self._blocks.pop(block_id, None)
        self._atime.pop(block_id, None)
        if arr is not None:
            self.policy.on_remove(block_id, evicted=evicted)
            if self.exports is not None:
                self.exports.remove(block_id)
            self.used -= arr.nbytes

    def _evict_for(self, need: int) -> None:
        while self.used + need > self.capacity and self._blocks:
            order = self.policy.victim_order(list(self._atime.items()))
            victim = order[0] if order else min(self._atime,
                                                key=self._atime.get)
            log.debug("hbm tier evicting block %d", victim)
            self.spills += 1
            self.drop(victim, evicted=True)

    def stats(self) -> dict:
        ps = self.policy.stats()
        return {"capacity": self.capacity, "used": self.used,
                "blocks": len(self._blocks), "hits": self.hits,
                "misses": self.misses, "spills": self.spills,
                "ghost_hits": ps.get("ghost_hits", 0),
                "scan_evicted": ps.get("scan_evicted", 0)}


class MultiHbmTier:
    """Device tier-0 across all local devices: one HbmTier per device
    with its own capacity accounting; placement picks the least-used
    device (or an explicit target), and hot blocks can be spread as
    replicas so every consumer reads its own device's copy.

    ``capacity_bytes`` is the TOTAL budget, split evenly across the
    devices, so the advertised capacity does not multiply by the device
    count."""

    def __init__(self, capacity_bytes: int, devices=None,
                 admission: str = "lru", ghost_entries: int = 2048,
                 export_cap: int = 128):
        devices = list(devices) if devices is not None else local_devices()
        if not devices:
            raise ValueError("no local devices for the HBM tier")
        per_chip = max(1, capacity_bytes // len(devices))
        # ONE admission policy and ONE export table across all devices:
        # a block evicted on device A and re-broadcast onto device B is
        # the same hot block — it re-admits straight to main — and peers
        # address the worker's tier as a whole, not a device
        self.policy = make_policy(admission, ghost_entries=ghost_entries)
        self.exports = HbmExportTable(cap=export_cap)
        self.devices = [torch.device(d) for d in devices]
        self.tiers: dict[int, HbmTier] = {}
        for d in self.devices:
            t = HbmTier(per_chip, device=d, exports=self.exports,
                        policy=self.policy)
            self.tiers[t.device_id] = t

    # ---- capacity (per device, for heartbeat advertisement) ----
    @property
    def capacity(self) -> int:
        return sum(t.capacity for t in self.tiers.values())

    @property
    def used(self) -> int:
        return sum(t.used for t in self.tiers.values())

    def per_device_stats(self) -> list[dict]:
        return [{"device_id": did, **t.stats()}
                for did, t in sorted(self.tiers.items())]

    # ---- placement ----
    def _pick(self) -> HbmTier:
        return min(self.tiers.values(), key=lambda t: t.used)

    def _tier_of(self, device) -> HbmTier:
        did = device_id(device)
        t = self.tiers.get(did)
        if t is None:
            raise ValueError(f"device {did} is not part of the HBM tier")
        return t

    def put(self, block_id: int, data, device=None) -> torch.Tensor:
        """Pin on one device: the consumer's device when given, else the
        least-used one (capacity-balanced placement)."""
        for t in self.tiers.values():         # already resident somewhere?
            if block_id in t:
                if device is None or device_id(device) == t.device_id:
                    return t.get(block_id)
        t = self._tier_of(device) if device is not None else self._pick()
        try:
            return t.put(block_id, data)
        except ValueError as e:
            raise ValueError(
                f"{e} (per-chip share: {t.capacity}B = total hbm_capacity "
                f"/ {len(self.tiers)} chips — raise worker.hbm_capacity "
                f"or use a smaller block_size)") from e

    def put_replicated(self, block_id: int, data, k: int | None = None
                       ) -> list[torch.Tensor]:
        """Spread a hot block as replicas across k devices (all by
        default), least-used first."""
        targets = sorted(self.tiers.values(), key=lambda t: t.used)
        targets = targets[:k if k is not None else len(targets)]
        return [t.put(block_id, data) for t in targets]

    def get(self, block_id: int, device=None) -> torch.Tensor | None:
        """Prefer the copy on ``device``; fall back to any device
        holding it."""
        if device is not None:
            t = self.tiers.get(device_id(device))
            if t is not None and block_id in t:
                return t.get(block_id)
        for t in self.tiers.values():
            if block_id in t:
                return t.get(block_id)
        return None

    def holders(self, block_id: int) -> list[int]:
        return [did for did, t in sorted(self.tiers.items())
                if block_id in t]

    def drop(self, block_id: int, evicted: bool = False) -> None:
        """``evicted=True`` marks a capacity drop: the shared ghost queue
        remembers the block so a re-broadcast re-admits straight to main.
        Deletes stay evicted=False — a deleted block must NOT enjoy fast
        re-admission."""
        for t in self.tiers.values():
            t.drop(block_id, evicted=evicted)

    def __contains__(self, block_id: int) -> bool:
        return any(block_id in t for t in self.tiers.values())

    def stats(self) -> dict:
        # policy counters come off the ONE shared policy — per-tier sums
        # would multiply-count it by the device count
        ps = self.policy.stats()
        agg = {"capacity": self.capacity, "used": self.used,
               "devices": len(self.tiers),
               "blocks": len({b for t in self.tiers.values()
                              for b in t._blocks}),
               "hits": sum(t.hits for t in self.tiers.values()),
               "misses": sum(t.misses for t in self.tiers.values()),
               "spills": sum(t.spills for t in self.tiers.values()),
               "ghost_hits": ps.get("ghost_hits", 0),
               "scan_evicted": ps.get("scan_evicted", 0),
               "exports": len(self.exports),
               "export_adds": self.exports.exports}
        agg["per_device"] = self.per_device_stats()
        return agg


def export_metrics(tier, registry, prefix: str = "hbm") -> None:
    """Surface HbmTier/MultiHbmTier counters on a MetricsRegistry:
    hits, misses, spills, occupancy."""
    st = tier.stats()
    registry.gauge(f"{prefix}.hits", st.get("hits", 0))
    registry.gauge(f"{prefix}.misses", st.get("misses", 0))
    registry.gauge(f"{prefix}.spills", st.get("spills", 0))
    registry.gauge(f"{prefix}.ghost_hits", st.get("ghost_hits", 0))
    registry.gauge(f"{prefix}.scan_evicted", st.get("scan_evicted", 0))
    registry.gauge(f"{prefix}.used", st["used"])
    registry.gauge(f"{prefix}.capacity", st["capacity"])
    registry.gauge(f"{prefix}.occupancy",
                   st["used"] / st["capacity"] if st["capacity"] else 0.0)
