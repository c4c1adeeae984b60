"""Block → replica map.

Own copy of ``curvine_tpu/master/block_map.py``: a block's durable meta
(length, owning inode, desired replicas) lives in the store; its replica
locations are runtime state, rebuilt from the workers' block reports
after a restart. ``apply_report`` takes a worker's report and returns
the blocks no file owns (orphans, for the worker to delete);
``worker_lost`` drops a lost worker's replicas. Left out: the desired-
replica cache and ``under_replicated`` of the replication manager, which
is not ported (ROADMAP A3d)."""

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

    def get(self, block_id: int) -> BlockMeta | None:
        durable = self.store.block_get(block_id)
        if durable is None:
            return None
        length, inode_id, replicas = durable
        return BlockMeta(block_id=block_id, len=length, inode_id=inode_id,
                         replicas=replicas,
                         locs=self.locs.get(block_id, {}))

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

    def apply_report(self, worker_id: int, held: dict[int, int],
                     storage_types: dict[int, int],
                     incremental: bool = False) -> list[int]:
        """A worker's block report, {block_id: len}. Returns the blocks
        it holds that the master does not know (orphans). A full report
        also retires the replicas the worker no longer holds."""
        known = self.worker_blocks.setdefault(worker_id, set())
        orphans = []
        for bid, length in held.items():
            durable = self.store.block_get(bid)
            if durable is None:
                orphans.append(bid)
                continue
            old_len, iid, rep = durable
            if length > old_len:
                self.store.block_put(bid, length, iid, rep)
            st = StorageType(storage_types.get(bid, int(StorageType.MEM)))
            self.add_replica(bid, worker_id, st)
        if not incremental:
            for bid in list(known - set(held)):
                self.remove_replica(bid, worker_id)
        return orphans

    def count(self) -> int:
        return self.store.block_count()
