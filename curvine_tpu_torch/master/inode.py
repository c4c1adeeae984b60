"""The namespace's inode tree over the metadata store.

Own copy of ``curvine_tpu/master/inode.py``: ``Inode`` and ``InodeTree``
with the reference's id counters (:91-99: ``next_id`` from 2, the root
being 1, and ``next_block_id`` from 1), so that the same ops give the
same ids, and the same journal, in both packages; path walks
(``resolve``, ``resolve_parent``, ``walk_parent``,
``check_parent_dirs``), ``path_of``, ``mkdirs`` and the entry
mutations. A new inode is put with ``new=True`` (:84, :204-235), which
counts it in the KV store's ``inode_count``, so ``count()`` reads that
counter and no scan. Left out: the striped ids of the sharded namespace
and ``add_entry`` (hard links; LINK is refused)."""

from __future__ import annotations

from dataclasses import dataclass, field

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import (FileStatus, FileType,
                                            StoragePolicy, now_ms)
from curvine_tpu_torch.master.store import MemMetaStore

ROOT_ID = 1


@dataclass
class Inode:
    id: int = 0
    name: str = ""
    file_type: FileType = FileType.FILE
    parent_id: int = 0
    mtime: int = 0
    atime: int = 0
    owner: str = "root"
    group: str = "root"
    mode: int = 0o755
    x_attr: dict = field(default_factory=dict)
    storage_policy: StoragePolicy = field(default_factory=StoragePolicy)
    nlink: int = 1
    children_num: int = 0                 # dirs: live entry count
    # file fields
    len: int = 0
    block_size: int = 64 * 1024 * 1024
    replicas: int = 1
    blocks: list[int] = field(default_factory=list)
    is_complete: bool = True
    client_name: str = ""
    # symlink
    target: str | None = None

    @property
    def is_dir(self) -> bool:
        return self.file_type == FileType.DIR

    def to_status(self, path: str) -> FileStatus:
        # the name is the path's tail (the directory entry's name)
        entry_name = path.rstrip("/").rsplit("/", 1)[-1] if path else self.name
        return FileStatus(
            id=self.id, path=path, name=entry_name, is_dir=self.is_dir,
            mtime=self.mtime, atime=self.atime,
            children_num=self.children_num,
            is_complete=self.is_complete, len=self.len, replicas=self.replicas,
            block_size=self.block_size, file_type=self.file_type,
            x_attr=dict(self.x_attr), storage_policy=self.storage_policy,
            owner=self.owner, group=self.group, mode=self.mode,
            target=self.target, nlink=self.nlink,
        )


class InodeTree:
    """Path resolution and mutations over a ``MemMetaStore`` or a
    ``KvMetaStore``. One writer (the master's event loop); every mutation
    writes through to the store."""

    def __init__(self, store: MemMetaStore | None = None) -> None:
        self.store = store if store is not None else MemMetaStore()
        if self.store.get(ROOT_ID) is None:
            ts = now_ms()
            self.store.put(Inode(id=ROOT_ID, name="", file_type=FileType.DIR,
                                 parent_id=0, mtime=ts, atime=ts), new=True)
            self.store.set_counter("next_id", ROOT_ID + 1)
            if self.store.kind == "kv":
                # a fresh KV store: the root lands before any entry
                self.store.commit_applied(
                    self.store.get_counter("applied_seq", 0))

    # -- id allocation (journaled through the replay's determinism) --
    def _alloc_id(self) -> int:
        return self.store.bump_counter("next_id", 1, ROOT_ID + 1)

    def alloc_block_id(self) -> int:
        return self.store.bump_counter("next_block_id", 1, 1)

    @property
    def root(self) -> Inode:
        return self.store.get(ROOT_ID)

    def get(self, inode_id: int) -> Inode | None:
        return self.store.get(inode_id)

    def save(self, inode: Inode) -> None:
        self.store.put(inode)

    # -- path resolution --
    def resolve(self, path: str) -> Inode | None:
        node = self.root
        for comp in _components(path):
            if not node.is_dir:
                return None
            cid = self.store.child_get(node.id, comp)
            if cid is None:
                return None
            node = self.store.get(cid)
            if node is None:
                return None
        return node

    def resolve_parent(self, path: str) -> tuple[Inode | None, str]:
        comps = _components(path)
        if not comps:
            return None, ""
        node = self.root
        for comp in comps[:-1]:
            if not node.is_dir:
                return None, comps[-1]
            cid = self.store.child_get(node.id, comp)
            if cid is None:
                return None, comps[-1]
            node = self.store.get(cid)
        return node, comps[-1]

    def walk_parent(self, path: str) -> tuple[Inode | None, str, Inode | None]:
        """One walk: (parent, name, the inode at ``path`` or None).
        ``parent`` is None when a component above is missing; one that
        is a file raises NotADirectory."""
        comps = _components(path)
        if not comps:
            return None, "", self.root
        node = self.root
        for i, comp in enumerate(comps[:-1]):
            cid = self.store.child_get(node.id, comp)
            if cid is None:
                return None, comps[-1], None
            node = self.store.get(cid)
            if node is None:
                return None, comps[-1], None
            if not node.is_dir:
                raise err.NotADirectory(f"/{'/'.join(comps[:i + 1])} is a file")
        cid = self.store.child_get(node.id, comps[-1])
        existing = self.store.get(cid) if cid is not None else None
        return node, comps[-1], existing

    def check_parent_dirs(self, path: str) -> None:
        """Raise NotADirectory if a component above ``path`` is a file:
        checked before the entry is journaled."""
        comps = _components(path)
        node = self.root
        for i, comp in enumerate(comps[:-1]):
            cid = self.store.child_get(node.id, comp)
            if cid is None:
                return
            node = self.store.get(cid)
            if node is None:
                return
            if not node.is_dir:
                raise err.NotADirectory(f"/{'/'.join(comps[:i + 1])} is a file")

    def path_of(self, inode: Inode) -> str:
        parts: list[str] = []
        node = inode
        while node.id != ROOT_ID:
            parts.append(node.name)
            node = self.store.get(node.parent_id)
            if node is None:
                break
        return "/" + "/".join(reversed(parts))

    def child(self, parent: Inode, name: str) -> Inode | None:
        cid = self.store.child_get(parent.id, name)
        return self.store.get(cid) if cid is not None else None

    def children(self, parent: Inode) -> list[tuple[str, Inode]]:
        out = []
        for name, cid in self.store.children_of(parent.id):
            node = self.store.get(cid)
            if node is not None:
                out.append((name, node))
        return out

    # -- mutations (journaled ops only) --
    def add_child(self, parent: Inode, inode: Inode) -> None:
        self.store.put(inode, new=True)
        self.store.child_put(parent.id, inode.name, inode.id)
        parent.children_num += 1
        parent.mtime = inode.mtime
        self.store.put(parent)

    def remove_child(self, parent: Inode, name: str) -> Inode | None:
        cid = self.store.child_get(parent.id, name)
        if cid is None:
            return None
        self.store.child_remove(parent.id, name)
        parent.children_num = max(0, parent.children_num - 1)
        parent.mtime = now_ms()
        self.store.put(parent)
        node = self.store.get(cid)
        if node is None:
            return None
        # a hard-linked inode (from a reference snapshot) outlives one
        # of its names
        node.nlink -= 1
        if node.nlink <= 0:
            self.store.remove(cid)
        else:
            self.store.put(node)
        return node

    def mkdirs(self, path: str, mode: int = 0o755, owner: str = "root",
               group: str = "root", create_parent: bool = True,
               x_attr: dict | None = None) -> tuple[Inode, bool]:
        """Returns (the directory, whether one was created)."""
        node = self.root
        comps = _components(path)
        if not comps:
            return node, False
        created = False
        for i, comp in enumerate(comps):
            existing = self.child(node, comp)
            if existing is not None:
                if not existing.is_dir:
                    raise err.NotADirectory(
                        f"{'/'.join(comps[:i + 1])} is a file")
                node = existing
                continue
            if i < len(comps) - 1 and not create_parent:
                raise err.FileNotFound(
                    f"parent /{'/'.join(comps[:i + 1])} not found")
            child = Inode(id=self._alloc_id(), name=comp,
                          file_type=FileType.DIR, parent_id=node.id,
                          mtime=now_ms(), atime=now_ms(),
                          owner=owner, group=group, mode=mode,
                          x_attr=dict(x_attr or {}) if i == len(comps) - 1
                          else {})
            self.add_child(node, child)
            node = child
            created = True
        return node, created

    def count(self) -> int:
        return self.store.inode_count()

    def iter_files(self):
        for node in self.store.iter_inodes():
            if node.file_type != FileType.DIR:
                yield node


def _components(path: str) -> list[str]:
    path = path.strip("/")
    return path.split("/") if path else []
