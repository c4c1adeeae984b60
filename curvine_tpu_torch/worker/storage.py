"""Tiered block storage of the port's worker, file layout.

A carve of ``curvine_tpu/worker/storage.py``: ``BlockInfo`` (:28-57),
``TierDir`` (:140-184) and ``BlockStore`` (:435-1422). Tiers are ordered
fastest first (MEM, SSD, HDD); a block is created on the fastest tier
with room (its hint first), cold blocks spill down under pressure
(``trim``, ``maybe_evict``) and are dropped only where no slower tier has
room, and blocks read ``promote_min_reads`` times since the last scan
move up (``promote_scan``, which halves every block's heat). Victims are
ordered by the tier's admission policy (the port's ``common/cache.py``:
S3-FIFO on the MEM tier when asked for, LRU below it). Block files live
in hashed subdirectories, ``<root>/<id % 256:02x>/<id>.blk``, a temp file
``.tmp`` beside them renamed on commit, so a directory written by the
JAX package's worker reopens here (``_load_existing``) and the reverse.
As in the reference, the file layout keeps no commit crc on disk: a
reopened block has none until it is written again.

Not ported: ``BdevTier`` (:185-434; a ``layout = "bdev"`` tier is refused
by ``common/conf.py``), the direct-IO engine, the scrub, the disk health
state machine with its probes and quarantine (``DiskHealth`` :59-138:
every dir reports ``healthy``), the fault hook and tenant quotas.

The shared-memory export hooks are the reference's (:468-479, :856-860,
:1050-1054): ``on_delete`` fires when a block leaves the store and
``on_move`` when it changes tiers, each under the store's lock, so the
worker's sealed-memfd copies of it are dropped (``worker/shm.py``)."""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from dataclasses import dataclass, field

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.cache import LruPolicy, make_policy
from curvine_tpu_torch.common.types import BlockState, StorageInfo, StorageType
from curvine_tpu_torch.worker.blockfile import (ALGO_CRC32C, SUBDIRS,
                                                crc_update, map_block)

log = logging.getLogger(__name__)

HEALTHY = "healthy"


@dataclass
class BlockInfo:
    block_id: int
    tier: "TierDir"
    len: int = 0
    state: BlockState = BlockState.TEMP
    atime: float = field(default_factory=time.time)
    crc32c: int | None = None     # content checksum recorded at commit
    crc_algo: str = "crc32c"      # crc32 (wire/zlib) or crc32c
    offset: int = 0               # always 0: the file layout only
    heat: int = 0                 # reads since the last promotion scan

    @property
    def path(self) -> str:
        suffix = ".tmp" if self.state == BlockState.TEMP else ".blk"
        return self.tier.block_path(self.block_id, suffix)


class TierDir:
    def __init__(self, storage_type: StorageType, root: str, capacity: int,
                 dir_id: str = ""):
        self.storage_type = storage_type
        self.root = root
        self.capacity = capacity
        self.used = 0
        self.dir_id = dir_id or f"{storage_type.name.lower()}:{root}"
        # BlockStore.__init__ replaces it per worker.cache_admission
        self.policy = LruPolicy()
        os.makedirs(root, exist_ok=True)

    def block_path(self, block_id: int, suffix: str = ".blk") -> str:
        sub = os.path.join(self.root, f"{block_id % SUBDIRS:02x}")
        os.makedirs(sub, exist_ok=True)
        return os.path.join(sub, f"{block_id}{suffix}")

    @property
    def available(self) -> int:
        return max(0, self.capacity - self.used)

    def info(self, block_num: int = 0) -> StorageInfo:
        return StorageInfo(storage_type=self.storage_type, dir_id=self.dir_id,
                           capacity=self.capacity, available=self.available,
                           block_num=block_num, health=HEALTHY)


class BlockStore:
    """Thread-safe tiered store (handlers run on the event loop, file IO
    in worker threads)."""

    def __init__(self, tiers: list[TierDir], high_water: float = 0.95,
                 low_water: float = 0.80, admission: str = "lru",
                 ghost_entries: int = 8192, small_ratio: float = 0.1):
        if not tiers:
            raise err.InvalidArgument("worker needs at least one tier")
        self.tiers = sorted(tiers, key=lambda t: int(t.storage_type))
        # ghost-cache admission guards the MEM-and-faster tiers (the ones
        # a backfill scan can flush); slower tiers keep plain LRU
        self.admission = admission
        for t in self.tiers:
            kind = admission if int(t.storage_type) <= int(StorageType.MEM) \
                else "lru"
            t.policy = make_policy(kind, ghost_entries=ghost_entries,
                                   small_ratio=small_ratio)
        self.miss_total = 0           # lookups of blocks we don't hold
        self.blocks: dict[int, BlockInfo] = {}
        self.high_water = high_water
        self.low_water = low_water
        self._lock = threading.Lock()
        # block ids mid-tier-move (the copy runs lock-free; _move_block)
        self._moving: set[int] = set()
        # active in-process readers per block (READ_BLOCK streams, the
        # device autopin): a pinned block is never moved or evicted
        self._read_pins: dict[int, int] = {}
        # dropped = data left the cache; demoted/promoted = moved tiers
        self.dropped_total = 0
        self.demoted_total = 0
        self.promoted_total = 0
        # called with a block id when the block is removed, and when it
        # moves tiers, under the lock: the callee must not re-enter the
        # store (the worker's shm exports drop their copies)
        self.on_delete = None
        self.on_move = None
        self._load_existing()

    def _load_existing(self) -> None:
        """Rebuild the index from disk (a worker restart, or a directory
        the other package's worker wrote)."""
        for tier in self.tiers:
            for sub in os.listdir(tier.root):
                subdir = os.path.join(tier.root, sub)
                if not os.path.isdir(subdir):
                    continue
                for name in os.listdir(subdir):
                    full = os.path.join(subdir, name)
                    if name.endswith((".tmp", ".mov")):
                        os.unlink(full)  # torn write/move from a prior run
                        continue
                    if not name.endswith(".blk"):
                        continue
                    bid = int(name[:-4])
                    size = os.path.getsize(full)
                    self.blocks[bid] = BlockInfo(block_id=bid, tier=tier,
                                                 len=size,
                                                 state=BlockState.COMMITTED)
                    tier.used += size
        if self.blocks:
            log.info("block store recovered %d blocks", len(self.blocks))

    # ---------- lifecycle ----------

    def pick_tier(self, hint: StorageType | None, size_hint: int) -> TierDir:
        """The preferred tier first, then any tier fastest first with
        room; under pressure, evict on each in that order."""
        ordered = list(self.tiers)
        if hint is not None:
            ordered = ([t for t in ordered if t.storage_type == hint]
                       + [t for t in ordered if t.storage_type != hint])
        for tier in ordered:
            if tier.available >= size_hint:
                return tier
        for tier in ordered:
            self._evict_locked(tier, size_hint)
            if tier.available >= size_hint:
                return tier
        tried = ", ".join(f"{t.dir_id}={t.available}" for t in ordered)
        raise err.CapacityExceeded(
            f"need {size_hint}B, all tiers tried after eviction: {tried}")

    def create_temp(self, block_id: int, hint: StorageType | None = None,
                    size_hint: int = 0) -> BlockInfo:
        with self._lock:
            if block_id in self._moving:
                raise err.FileAlreadyExists(
                    f"block {block_id} busy (tier move in flight)")
            if block_id in self.blocks:
                old = self.blocks[block_id]
                if old.state == BlockState.COMMITTED:
                    raise err.FileAlreadyExists(f"block {block_id} committed")
                self._remove_locked(old)
            tier = self.pick_tier(hint, size_hint)
            info = BlockInfo(block_id=block_id, tier=tier)
            self.blocks[block_id] = info
            return info

    def commit(self, block_id: int, length: int,
               checksum: int | None = None,
               checksum_algo: str = "crc32") -> BlockInfo:
        """``checksum`` is the streaming checksum the write path already
        computed; absent, the file's crc32c is computed here."""
        with self._lock:
            info = self._get_locked(block_id)
            if info.state == BlockState.COMMITTED:
                return info
            tmp = info.path
            info.state = BlockState.COMMITTED
            info.len = length
            os.replace(tmp, info.path)
            info.tier.used += length
        if checksum is None:
            # file IO outside the lock; fields published under it
            checksum = crc_update(ALGO_CRC32C,
                                  map_block(info.path, 0, length))
            checksum_algo = ALGO_CRC32C
        with self._lock:
            info.crc32c = checksum
            info.crc_algo = checksum_algo
            info.tier.policy.on_admit(block_id, length)
        return info

    def verify(self, block_id: int) -> bool:
        """Re-checksum a committed block against its commit-time value (a
        block without one passes)."""
        info = self.get(block_id, touch=False)
        if info.state != BlockState.COMMITTED or info.crc32c is None:
            return True
        try:
            data = map_block(info.path, 0, info.len)
        except (FileNotFoundError, ValueError):
            return False                     # gone or truncated
        return crc_update(info.crc_algo, data) == info.crc32c

    def get(self, block_id: int, touch: bool = True) -> BlockInfo:
        with self._lock:
            info = self._get_locked(block_id)
            if touch:
                self._touch_locked(info, 1)
            return info

    def get_copy(self, block_id: int) -> BlockInfo:
        """A copy of the block's entry, taken under the lock, for a reader
        on another thread (the shm side channel) that must see one
        consistent tier, state and length; no heat is touched."""
        with self._lock:
            return dataclasses.replace(self._get_locked(block_id))

    @staticmethod
    def _touch_locked(info: BlockInfo, reads: int) -> None:
        info.atime = time.time()
        info.heat += reads
        info.tier.policy.hits += reads
        info.tier.policy.on_access(info.block_id)

    def touch_reads(self, block_id: int, reads: int) -> None:
        """Account reads that bypassed ``get()``: short-circuit clients
        probe once per open and report their reads (SC_READ_REPORT), so
        heat follows the traffic and promotion targets the hot blocks."""
        with self._lock:
            info = self.blocks.get(block_id)
            if info is not None and reads > 0:
                self._touch_locked(info, reads)

    def pin_read(self, block_id: int, touch: bool = True) -> BlockInfo:
        """Look a block up and take a read pin on it, atomically; pair
        with ``unpin_read()``. A pinned block is never moved or evicted,
        so a reader's (path, offset) stays valid."""
        with self._lock:
            info = self._get_locked(block_id)
            if touch:
                self._touch_locked(info, 1)
            self._read_pins[block_id] = self._read_pins.get(block_id, 0) + 1
            return info

    def unpin_read(self, block_id: int) -> None:
        with self._lock:
            n = self._read_pins.get(block_id, 0) - 1
            if n <= 0:
                self._read_pins.pop(block_id, None)
            else:
                self._read_pins[block_id] = n

    def grant_sc(self, block_id: int) -> tuple[BlockInfo, int]:
        """Short-circuit grant: the block, touched once, and its lease in
        ms (0: a file-layout block needs none, unlink keeps an open fd
        valid)."""
        with self._lock:
            info = self._get_locked(block_id)
            self._touch_locked(info, 1)
            return info, 0

    def contains(self, block_id: int) -> bool:
        return block_id in self.blocks

    def delete(self, block_id: int) -> None:
        with self._lock:
            info = self.blocks.get(block_id)
            if info is not None:
                self._remove_locked(info)

    def _remove_locked(self, info: BlockInfo, evicted: bool = False) -> None:
        # `evicted`: removal under cache pressure, which ghosts the id so
        # a near-future re-admission skips probation; deletes never ghost
        info.tier.policy.on_remove(info.block_id, evicted=evicted)
        if self.on_delete is not None:
            try:
                self.on_delete(info.block_id)
            except Exception:  # noqa: BLE001 — the removal must proceed
                log.exception("on_delete of block %d", info.block_id)
        try:
            os.unlink(info.path)
        except FileNotFoundError:
            pass
        except OSError as e:
            # drop the index entry anyway: GET_BLOCK_INFO must stop
            # serving the block
            log.warning("unlink of %s failed: %s", info.path, e)
        if info.state == BlockState.COMMITTED:
            info.tier.used -= info.len
        self.blocks.pop(info.block_id, None)

    def _get_locked(self, block_id: int) -> BlockInfo:
        info = self.blocks.get(block_id)
        if info is None:
            self.miss_total += 1
            raise err.BlockNotFound(f"block {block_id}")
        return info

    # ---------- tier movement ----------

    def _move_block(self, block_id: int, dest: TierDir) -> bool:
        """Move a committed block's bytes to ``dest`` and swap its index
        entry; False (the block left where it is) when ``dest`` lacks
        room or the block changed underneath. Space is reserved under the
        lock, the copy runs without it, and the swap revalidates under
        it: a block deleted, evicted or read-pinned mid-copy discards the
        new copy. A reader holding the old file keeps a whole view
        (unlink semantics)."""
        with self._lock:
            info = self.blocks.get(block_id)
            if info is None or info.state != BlockState.COMMITTED \
                    or info.tier is dest or block_id in self._moving \
                    or self._read_pins.get(block_id):
                return False
            src_path, src_tier, length = info.path, info.tier, info.len
            if dest.available < length:
                return False
            dest.used += length            # reservation
            self._moving.add(block_id)
        mov = dest.block_path(block_id, ".mov")
        try:
            with open(src_path, "rb") as sf, open(mov, "wb") as df:
                left = length
                while left > 0:
                    chunk = sf.read(min(4 << 20, left))
                    if not chunk:
                        raise err.AbnormalData(
                            f"block {block_id} truncated on "
                            f"{src_tier.dir_id}")
                    df.write(chunk)
                    left -= len(chunk)
            os.replace(mov, dest.block_path(block_id, ".blk"))
        except (OSError, err.CurvineError) as e:
            log.warning("move block %d %s -> %s failed: %s", block_id,
                        src_tier.dir_id, dest.dir_id, e)
            try:
                os.unlink(mov)
            except OSError:
                pass
            with self._lock:
                dest.used -= length
                self._moving.discard(block_id)
            return False
        with self._lock:
            self._moving.discard(block_id)
            info = self.blocks.get(block_id)
            if info is None or info.state != BlockState.COMMITTED \
                    or info.tier is not src_tier or info.len != length \
                    or self._read_pins.get(block_id):
                dest.used -= length          # ours is the stale copy
                try:
                    os.unlink(dest.block_path(block_id, ".blk"))
                except OSError:
                    pass
                return False
            try:
                os.unlink(src_path)
            except FileNotFoundError:
                pass
            src_tier.used -= length
            # a demotion is an eviction from the fast tier's viewpoint
            # (ghost-eligible); a promotion is not
            demoting = int(dest.storage_type) > int(src_tier.storage_type)
            src_tier.policy.on_remove(block_id, evicted=demoting)
            dest.policy.on_admit(block_id, length)
            if self.on_move is not None:
                try:
                    self.on_move(block_id)
                except Exception:  # noqa: BLE001 — the move must land
                    log.exception("on_move of block %d", block_id)
            info.tier = dest
            return True

    def _move_candidates_locked(self, tier: TierDir, need: int,
                                demote: bool) -> tuple[list, int, int]:
        """Under the lock: policy-ordered victims on ``tier`` until
        ``need`` (or the low-water trim target) fits, each to demote
        (its destination) or drop (None). Returns (plan, target_free,
        projected free bytes once the plan ran)."""
        target_free = max(need, int(tier.capacity * (1 - self.low_water)))
        eligible = [b for b in self.blocks.values()
                    if b.tier is tier and b.state == BlockState.COMMITTED
                    and b.block_id not in self._moving
                    and not self._read_pins.get(b.block_id)]
        order = tier.policy.victim_order(
            [(b.block_id, b.atime) for b in eligible])
        by_id = {b.block_id: b for b in eligible}
        plan: list[tuple[int, TierDir | None]] = []
        freed = tier.available
        for k in order:
            if freed >= target_free:
                break
            b = by_id.get(k)
            if b is None:
                continue
            plan.append((b.block_id, self._slower_tier_for(tier, b.len)
                         if demote else None))
            freed += b.len
        return plan, target_free, freed

    def cache_stats(self) -> dict[str, dict[str, int]]:
        """Per-tier-dir admission and hit counters, and their sum."""
        with self._lock:
            out: dict[str, dict[str, int]] = {}
            total: dict[str, int] = {}
            for t in self.tiers:
                s = t.policy.stats()
                out[t.dir_id] = s
                for k, v in s.items():
                    if k in ("small", "main", "ghost"):
                        continue
                    total[k] = total.get(k, 0) + v
            total["misses"] = total.get("misses", 0) + self.miss_total
            out["total"] = total
            return out

    def _slower_tier_for(self, tier: TierDir, size: int) -> TierDir | None:
        """The next tier strictly slower than ``tier`` with room."""
        for t in self.tiers:
            if int(t.storage_type) > int(tier.storage_type) \
                    and t.available >= size:
                return t
        return None

    # ---------- eviction / demotion ----------

    def _evict_locked(self, tier: TierDir, need: int) -> list[int]:
        """Drop-only trim for the create path (the lock held): every tier
        is full, so there is nowhere to demote to. A plan that cannot
        reach ``need`` is not run: dropping blocks without making room
        for the write that asked is pure cache loss."""
        plan, _target, projected = self._move_candidates_locked(
            tier, need, demote=False)
        if projected < need:
            return []
        evicted = []
        for bid, _dest in plan:
            info = self.blocks.get(bid)
            if info is None:
                continue
            self._remove_locked(info, evicted=True)
            evicted.append(bid)
            self.dropped_total += 1
        if evicted:
            log.info("evicted %d blocks from %s", len(evicted), tier.dir_id)
        return evicted

    def trim(self, tier: TierDir, need: int,
             demote: bool = True) -> list[int]:
        """Trim committed blocks from ``tier`` in policy order until
        ``need`` fits or the low-water mark is reached: each spills down
        to the next slower tier with room, and is dropped only where none
        can take it. Returns the ids no longer on ``tier``."""
        removed, demoted = [], 0
        for _attempt in range(2):      # one retry if planned moves failed
            with self._lock:
                plan, target, _projected = self._move_candidates_locked(
                    tier, need, demote)
            if not plan:
                break
            progress = False
            for bid, dest in plan:
                with self._lock:
                    if tier.available >= target:
                        break
                if dest is not None and self._move_block(bid, dest):
                    removed.append(bid)
                    demoted += 1
                    progress = True
                    continue
                if demote:
                    # the planned destination filled up (the plan shares
                    # one availability snapshot) or the copy failed:
                    # replan against live availability
                    with self._lock:
                        info = self.blocks.get(bid)
                        dest2 = (self._slower_tier_for(tier, info.len)
                                 if info is not None
                                 and info.tier is tier else None)
                    if dest2 is not None:
                        if dest2 is not dest and \
                                self._move_block(bid, dest2):
                            removed.append(bid)
                            demoted += 1
                            progress = True
                        # a destination exists but the copy failed: never
                        # drop a healthy block over that
                        continue
                with self._lock:
                    info = self.blocks.get(bid)
                    if info is not None and info.tier is tier \
                            and info.state == BlockState.COMMITTED \
                            and bid not in self._moving \
                            and not self._read_pins.get(bid):
                        self._remove_locked(info, evicted=True)
                        removed.append(bid)
                        self.dropped_total += 1
                        progress = True
            with self._lock:
                if tier.available >= target:
                    break
            if not progress:
                break
        if removed:
            with self._lock:
                self.demoted_total += demoted
            log.info("trimmed %d blocks from %s (%d demoted, %d dropped)",
                     len(removed), tier.dir_id, demoted,
                     len(removed) - demoted)
        return removed

    def maybe_evict(self) -> list[int]:
        """Background check: trim every tier above its high-water mark."""
        out = []
        for tier in self.tiers:
            with self._lock:
                over = tier.capacity \
                    and tier.used > tier.capacity * self.high_water
            if over:
                out.extend(self.trim(tier, 0))
        return out

    def hot_blocks(self, min_reads: int,
                   max_len: int | None = None) -> list[tuple[int, int, int]]:
        """Committed blocks with heat >= ``min_reads``, hottest first, as
        (block_id, heat, len): the promotion predicate of both the host
        tiers' scan and the device tier-0's autopin."""
        with self._lock:
            return sorted(
                ((b.block_id, b.heat, b.len)
                 for b in self.blocks.values()
                 if b.state == BlockState.COMMITTED
                 and b.heat >= min_reads
                 and (max_len is None or b.len <= max_len)),
                key=lambda t: t[1], reverse=True)

    # ---------- promotion ----------

    def promote_scan(self, min_reads: int = 3,
                     max_bytes: int = 256 << 20) -> list[int]:
        """Blocks on slower tiers read >= ``min_reads`` times since the
        last scan move to the fastest tier, hottest first, up to
        ``max_bytes``; the move may demote the destination's coldest
        blocks to make room. Every block's heat then halves, so a
        once-hot block cools off."""
        with self._lock:
            fastest = self.tiers[0]
            hot = [(b.block_id, b.len) for b in sorted(
                (b for b in self.blocks.values()
                 if b.state == BlockState.COMMITTED and b.tier is not fastest
                 and b.heat >= min_reads),
                key=lambda b: b.heat, reverse=True)]
        promoted: list[int] = []
        budget = max_bytes
        for bid, blen in hot:
            if blen > budget or blen > fastest.capacity:
                continue
            if blen > fastest.available:
                self.trim(fastest, blen, demote=True)
                if blen > fastest.available:
                    continue
            if self._move_block(bid, fastest):
                promoted.append(bid)
                budget -= blen
        with self._lock:
            for b in self.blocks.values():
                b.heat //= 2
            self.promoted_total += len(promoted)
        if promoted:
            log.info("promoted %d hot blocks to %s", len(promoted),
                     fastest.dir_id)
        return promoted

    # ---------- reporting ----------

    def storages(self) -> list[StorageInfo]:
        counts: dict[str, int] = {}
        for b in list(self.blocks.values()):
            counts[b.tier.dir_id] = counts.get(b.tier.dir_id, 0) + 1
        return [t.info(counts.get(t.dir_id, 0)) for t in self.tiers]

    def report(self) -> tuple[dict[int, int], dict[int, int]]:
        """(block_id → len, block_id → storage_type) of committed
        blocks."""
        held, types = {}, {}
        with self._lock:
            for b in self.blocks.values():
                if b.state == BlockState.COMMITTED:
                    held[b.block_id] = b.len
                    types[b.block_id] = int(b.tier.storage_type)
        return held, types
