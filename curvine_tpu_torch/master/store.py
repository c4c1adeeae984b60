"""The master's metadata store: inodes, directory entries, block meta.

Own copy of ``MemMetaStore`` (``curvine_tpu/master/store.py:43-250``):
everything in dicts, made durable by the journal and its snapshots, with
the mount table's and the job manager's records (:112-130), the EC
stripe records (:131-143) and the workers' decommission intents
(:160-168). Left out: ``KvMetaStore`` and its KV engine
(``common/kvstore.py``, ``kvnative``; ROADMAP A3d), and the two-phase
transaction table of the sharded namespace the port's master does not
have; the store's KV transaction surface (``commit_applied``,
``stage_entry``, ``rollback``), a no-op in RAM, goes with them."""

from __future__ import annotations


class MemMetaStore:
    kind = "mem"

    def __init__(self) -> None:
        self.inodes: dict[int, object] = {}
        self.children: dict[int, dict[str, int]] = {}
        self.blocks: dict[int, tuple[int, int, int]] = {}
        self.counters: dict[str, int] = {}
        self.mounts_tbl: dict[str, dict] = {}
        self.jobs_tbl: dict[str, dict] = {}
        self.deco_tbl: set[int] = set()
        self.ec_tbl: dict[int, dict] = {}

    # inodes
    def get(self, inode_id: int):
        return self.inodes.get(inode_id)

    def put(self, inode) -> None:
        self.inodes[inode.id] = inode

    def remove(self, inode_id: int) -> None:
        self.inodes.pop(inode_id, None)
        self.children.pop(inode_id, None)

    def iter_inodes(self):
        return iter(list(self.inodes.values()))

    def inode_count(self) -> int:
        return len(self.inodes)

    # directory entries
    def child_get(self, parent_id: int, name: str) -> int | None:
        return self.children.get(parent_id, {}).get(name)

    def child_put(self, parent_id: int, name: str, child_id: int) -> None:
        self.children.setdefault(parent_id, {})[name] = child_id

    def child_remove(self, parent_id: int, name: str) -> None:
        self.children.get(parent_id, {}).pop(name, None)

    def children_of(self, parent_id: int) -> list[tuple[str, int]]:
        return sorted(self.children.get(parent_id, {}).items())

    def iter_children_all(self):
        for pid, entries in list(self.children.items()):
            for name, cid in entries.items():
                yield pid, name, cid

    # durable block meta: (len, inode_id, replicas)
    def block_get(self, block_id: int) -> tuple[int, int, int] | None:
        return self.blocks.get(block_id)

    def block_put(self, block_id: int, length: int, inode_id: int,
                  replicas: int) -> None:
        self.blocks[block_id] = (length, inode_id, replicas)

    def block_remove(self, block_id: int) -> None:
        self.blocks.pop(block_id, None)

    def iter_blocks(self):
        return iter(list(self.blocks.items()))

    def block_count(self) -> int:
        return len(self.blocks)

    # mount table records
    def mount_put(self, cv_path: str, wire: dict) -> None:
        self.mounts_tbl[cv_path] = wire

    def mount_remove(self, cv_path: str) -> None:
        self.mounts_tbl.pop(cv_path, None)

    def iter_mounts(self):
        return iter(list(self.mounts_tbl.values()))

    # job records (journaled, so a restart resumes interrupted jobs)
    def job_put(self, job_id: str, wire: dict) -> None:
        self.jobs_tbl[job_id] = wire

    def job_remove(self, job_id: str) -> None:
        self.jobs_tbl.pop(job_id, None)

    def iter_jobs(self):
        return iter(list(self.jobs_tbl.values()))

    # EC stripe records: logical block id -> {"profile", "cell_size",
    # "block_len", "cells", "state"}
    def ec_put(self, block_id: int, wire: dict) -> None:
        self.ec_tbl[block_id] = wire

    def ec_get(self, block_id: int) -> dict | None:
        return self.ec_tbl.get(block_id)

    def ec_remove(self, block_id: int) -> None:
        self.ec_tbl.pop(block_id, None)

    def iter_ec(self):
        return iter(list(self.ec_tbl.items()))

    # worker decommission intents
    def deco_put(self, worker_id: int) -> None:
        self.deco_tbl.add(worker_id)

    def deco_remove(self, worker_id: int) -> None:
        self.deco_tbl.discard(worker_id)

    def iter_deco(self):
        return iter(sorted(self.deco_tbl))

    # counters
    def get_counter(self, name: str, default: int = 0) -> int:
        return self.counters.get(name, default)

    def set_counter(self, name: str, value: int) -> None:
        self.counters[name] = value

    def bump_counter(self, name: str, delta: int, default: int = 0) -> int:
        """Add ``delta`` and return the value before."""
        cur = self.counters.get(name, default)
        self.counters[name] = cur + delta
        return cur

    def clear(self) -> None:
        self.inodes.clear()
        self.children.clear()
        self.blocks.clear()
        self.counters.clear()
        self.mounts_tbl.clear()
        self.jobs_tbl.clear()
        self.deco_tbl.clear()
        self.ec_tbl.clear()
