"""Block → replica map.

Own copy of ``curvine_tpu/master/block_map.py``: a block's durable meta
(length, owning inode, desired replicas) lives in the store; its replica
locations are runtime state, rebuilt from the workers' block reports
after a restart. ``apply_report`` takes a worker's report and returns
the blocks no file owns (orphans, for the worker to delete);
``worker_lost`` drops a lost worker's replicas. The replication manager
reads the desired-replica cache (``desired``, :49-61, :91-106: set at
``commit`` and at each block report, else read once from the store by
``desired_of``), so its scan runs on memory, and ``under_replicated``
(:98-106): the located blocks with fewer replicas than desired."""

from __future__ import annotations

from dataclasses import dataclass, field

from curvine_tpu_torch.common.types import BlockLocation, StorageType
from curvine_tpu_torch.master.store import MemMetaStore


@dataclass
class BlockMeta:
    block_id: int
    len: int = 0
    inode_id: int = 0
    replicas: int = 1              # desired
    locs: dict = field(default_factory=dict)   # worker_id -> BlockLocation


class BlockMap:
    def __init__(self, store: MemMetaStore | None = None) -> None:
        self.store = store if store is not None else MemMetaStore()
        # runtime replica locations: block_id -> {worker_id: BlockLocation}
        self.locs: dict[int, dict[int, BlockLocation]] = {}
        # worker_id -> its block ids (for loss handling)
        self.worker_blocks: dict[int, set[int]] = {}
        # block_id -> desired replicas, so the under-replication scan
        # reads no store
        self.desired: dict[int, int] = {}

    def get(self, block_id: int) -> BlockMeta | None:
        durable = self.store.block_get(block_id)
        if durable is None:
            return None
        length, inode_id, replicas = durable
        return BlockMeta(block_id=block_id, len=length, inode_id=inode_id,
                         replicas=replicas,
                         locs=self.locs.get(block_id, {}))

    def commit(self, block_id: int, length: int, worker_id: int,
               storage_type: StorageType, inode_id: int = 0,
               replicas: int = 1) -> None:
        durable = self.store.block_get(block_id)
        if durable is None:
            self.store.block_put(block_id, length, inode_id, replicas)
            self.desired[block_id] = replicas
        else:
            old_len, old_iid, old_rep = durable
            self.store.block_put(block_id, max(old_len, length),
                                 inode_id or old_iid, old_rep)
            self.desired[block_id] = old_rep
        self.add_replica(block_id, worker_id, storage_type)

    def add_replica(self, block_id: int, worker_id: int,
                    storage_type: StorageType) -> None:
        self.locs.setdefault(block_id, {})[worker_id] = BlockLocation(
            worker_id=worker_id, storage_type=storage_type)
        self.worker_blocks.setdefault(worker_id, set()).add(block_id)

    def remove_block(self, block_id: int) -> BlockMeta | None:
        meta = self.get(block_id)
        if meta is None:
            return None
        self.store.block_remove(block_id)
        self.desired.pop(block_id, None)
        for wid in self.locs.pop(block_id, {}):
            self.worker_blocks.get(wid, set()).discard(block_id)
        return meta

    def remove_replica(self, block_id: int, worker_id: int) -> None:
        self.locs.get(block_id, {}).pop(worker_id, None)
        self.worker_blocks.get(worker_id, set()).discard(block_id)

    def worker_lost(self, worker_id: int) -> list[int]:
        """Drop every replica on a lost worker; returns their blocks."""
        affected = list(self.worker_blocks.pop(worker_id, set()))
        for bid in affected:
            self.locs.get(bid, {}).pop(worker_id, None)
        return affected

    def desired_of(self, block_id: int) -> int:
        d = self.desired.get(block_id)
        if d is None:
            durable = self.store.block_get(block_id)
            d = self.desired[block_id] = durable[2] if durable else 1
        return d

    def under_replicated(self) -> list[BlockMeta]:
        out = []
        for bid, locs in self.locs.items():
            if not locs:
                continue
            if len(locs) < self.desired_of(bid):
                meta = self.get(bid)
                if meta is not None:
                    out.append(meta)
        return out

    def apply_report(self, worker_id: int, held: dict[int, int],
                     storage_types: dict[int, int],
                     incremental: bool = False,
                     keep: set[int] = frozenset()) -> list[int]:
        """A worker's block report, {block_id: len}. Returns the blocks
        it holds that the master does not know (orphans). A full report
        also retires the replicas the worker no longer holds, but for
        those in ``keep`` (located after the report may have been
        built)."""
        known = self.worker_blocks.setdefault(worker_id, set())
        orphans = []
        for bid, length in held.items():
            durable = self.store.block_get(bid)
            if durable is None:
                orphans.append(bid)
                continue
            old_len, iid, rep = durable
            self.desired[bid] = rep
            if length > old_len:
                self.store.block_put(bid, length, iid, rep)
            st = StorageType(storage_types.get(bid, int(StorageType.MEM)))
            self.add_replica(bid, worker_id, st)
        if not incremental:
            for bid in list(known - set(held) - keep):
                self.remove_replica(bid, worker_id)
        return orphans

    def count(self) -> int:
        return self.store.block_count()
