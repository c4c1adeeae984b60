"""The UFS mount table.

Own copy of ``curvine_tpu/master/mount.py``. A mount binds a subtree of
the cache's namespace to a UFS URI: ``/mnt/data/a/b`` ↔
``file:///data/a/b``. Mutations go through the master filesystem's
journal (the ops ``mount_add``, ``mount_remove`` and ``mount_update``,
each checked before it is journaled: a bad value raises before the
append, never in the apply), so the table survives a restart; the
journal and snapshot forms are the reference's, field for field. Nested
mounts are refused. ``get_mount`` takes the deepest mount covering a
path, ``resolve`` and ``reverse`` map paths both ways, and
``ufs_status`` and ``ufs_list`` synthesise ``FileStatus`` entries
(``StorageState.UFS``, not cached) for objects under a mount; a UFS
outage gives None or ``[]``, never a namespace error. ``list_merged``
lays the cached entries over them, as LIST_STATUS answers (the
reference merges in its server, :742-755)."""

from __future__ import annotations

import itertools

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import (FileStatus, MountInfo,
                                            StoragePolicy, StorageState,
                                            StorageType, TtlAction,
                                            WriteType)
from curvine_tpu_torch.ufs.base import create_ufs


def _check_ttl_action(v: int) -> None:
    """Validate before journaling: a bad value must raise InvalidArgument
    ahead of the append, not ValueError in the apply."""
    try:
        TtlAction(v)
    except ValueError:
        raise err.InvalidArgument(f"ttl_action {v!r}") from None


class MountManager:
    def __init__(self, fs):
        self.fs = fs
        self._mounts: dict[str, MountInfo] = {}   # cv_path -> info
        self._ids = itertools.count(1)
        # the journal's apply ops live on the master filesystem
        fs._apply_mount_add = self._apply_add
        fs._apply_mount_remove = self._apply_remove
        fs._apply_mount_update = self._apply_update

    # ---------- mutations (journaled through fs._log) ----------

    def mount(self, cv_path: str, ufs_path: str, properties: dict | None = None,
              auto_cache: bool = False, write_type: int = 0,
              ttl_ms: int = 0, ttl_action: int = 0, storage_type: str = "",
              block_size: int = 0, replicas: int = 0,
              access_mode: str = "rw") -> MountInfo:
        cv_path = cv_path.rstrip("/") or "/"
        if cv_path in self._mounts:
            raise err.FileAlreadyExists(f"mount point {cv_path} exists")
        if access_mode not in ("rw", "r"):
            raise err.InvalidArgument(f"access_mode {access_mode!r}")
        _check_ttl_action(ttl_action)
        for existing in self._mounts:
            if cv_path.startswith(existing + "/") or \
                    existing.startswith(cv_path + "/"):
                raise err.InvalidArgument(
                    f"nested mounts: {cv_path} vs {existing}")
        self.fs.mkdir(cv_path, create_parent=True)
        return self.fs._log("mount_add", dict(
            cv_path=cv_path, ufs_path=ufs_path.rstrip("/"),
            properties=properties or {}, auto_cache=auto_cache,
            write_type=write_type, ttl_ms=ttl_ms, ttl_action=ttl_action,
            storage_type=storage_type, block_size=block_size,
            replicas=replicas, access_mode=access_mode))

    def _apply_add(self, cv_path: str, ufs_path: str, properties: dict,
                   auto_cache: bool, write_type: int, ttl_ms: int = 0,
                   ttl_action: int = 0, storage_type: str = "",
                   block_size: int = 0, replicas: int = 0,
                   access_mode: str = "rw") -> MountInfo:
        info = MountInfo(mount_id=next(self._ids), cv_path=cv_path,
                         ufs_path=ufs_path, properties=properties,
                         auto_cache=auto_cache,
                         write_type=WriteType(write_type),
                         ttl_ms=ttl_ms, ttl_action=TtlAction(ttl_action),
                         storage_type=storage_type, block_size=block_size,
                         replicas=replicas, access_mode=access_mode)
        self._mounts[cv_path] = info
        self.fs.store.mount_put(cv_path, info.to_wire())
        return info

    def umount(self, cv_path: str) -> None:
        cv_path = cv_path.rstrip("/") or "/"
        if cv_path not in self._mounts:
            raise err.MountNotFound(cv_path)
        self.fs._log("mount_remove", dict(cv_path=cv_path))

    def _apply_remove(self, cv_path: str) -> None:
        self._mounts.pop(cv_path, None)
        self.fs.store.mount_remove(cv_path)

    def update(self, cv_path: str, properties: dict | None = None,
               auto_cache: bool | None = None, ttl_ms: int | None = None,
               ttl_action: int | None = None,
               access_mode: str | None = None) -> MountInfo:
        cv_path = cv_path.rstrip("/") or "/"
        if cv_path not in self._mounts:
            raise err.MountNotFound(cv_path)
        if access_mode is not None and access_mode not in ("rw", "r"):
            raise err.InvalidArgument(f"access_mode {access_mode!r}")
        if ttl_action is not None:
            _check_ttl_action(ttl_action)
        return self.fs._log("mount_update", dict(
            cv_path=cv_path, properties=properties, auto_cache=auto_cache,
            ttl_ms=ttl_ms, ttl_action=ttl_action, access_mode=access_mode))

    def _apply_update(self, cv_path: str, properties: dict | None,
                      auto_cache: bool | None, ttl_ms: int | None = None,
                      ttl_action: int | None = None,
                      access_mode: str | None = None) -> MountInfo:
        info = self._mounts[cv_path]
        if properties is not None:
            info.properties.update(properties)
        if auto_cache is not None:
            info.auto_cache = auto_cache
        if ttl_ms is not None:
            info.ttl_ms = ttl_ms
        if ttl_action is not None:
            info.ttl_action = TtlAction(ttl_action)
        if access_mode is not None:
            info.access_mode = access_mode
        self.fs.store.mount_put(cv_path, info.to_wire())
        return info

    def load_from_store(self) -> None:
        """Rebuild the table from the store's records (the reference's KV
        cold start skips applied entries, so it reloads them here; on the
        mem store it finds what the replay put there)."""
        top = 0
        for wire in self.fs.store.iter_mounts():
            info = MountInfo.from_wire(wire)
            self._mounts[info.cv_path] = info
            top = max(top, info.mount_id)
        if top:
            self._ids = itertools.count(top + 1)

    # ---------- resolution ----------

    def table(self) -> list[MountInfo]:
        return sorted(self._mounts.values(), key=lambda m: m.cv_path)

    def get_mount(self, path: str) -> MountInfo | None:
        """The deepest mount whose cv_path is a prefix of ``path``."""
        best = None
        for cv, info in self._mounts.items():
            if path == cv or path.startswith(cv + "/") or cv == "/":
                if best is None or len(cv) > len(best.cv_path):
                    best = info
        return best

    def resolve(self, path: str) -> tuple[MountInfo, str]:
        """cv path → (mount, full ufs uri)."""
        info = self.get_mount(path)
        if info is None:
            raise err.MountNotFound(f"no mount covers {path}")
        return info, info.ufs_uri(path)

    def reverse(self, ufs_uri: str) -> tuple[MountInfo, str]:
        """ufs uri → (mount, cv path)."""
        for info in self._mounts.values():
            if ufs_uri == info.ufs_path or \
                    ufs_uri.startswith(info.ufs_path + "/"):
                rel = ufs_uri[len(info.ufs_path):]
                return info, (info.cv_path + rel) or "/"
        raise err.MountNotFound(f"no mount covers {ufs_uri}")

    # ---------- UFS metadata passthrough ----------

    def _ufs_for(self, path: str):
        info = self.get_mount(path)
        if info is None:
            return None, None, None
        return info, create_ufs(info.ufs_path, properties=info.properties), \
            info.ufs_uri(path)

    @staticmethod
    def _synth_status(cv_path: str, ufs_st) -> FileStatus:
        """A UFS object as a FileStatus (state UFS, not cached)."""
        return FileStatus(
            id=0, path=cv_path, name=cv_path.rsplit("/", 1)[-1],
            is_dir=ufs_st.is_dir, mtime=ufs_st.mtime, atime=ufs_st.mtime,
            is_complete=True, len=ufs_st.len,
            storage_policy=StoragePolicy(storage_type=StorageType.UFS,
                                         state=StorageState.UFS))

    async def ufs_status(self, path: str) -> FileStatus | None:
        """The FileStatus of an uncached object under a mount, or None. A
        mount of a scheme the port does not serve raises ``UfsError``."""
        info, ufs, uri = self._ufs_for(path)
        if info is None:
            return None
        try:
            st = await ufs.stat(uri)
        except Exception:  # noqa: BLE001 — a UFS outage is no namespace error
            return None
        return self._synth_status(path, st) if st is not None else None

    async def ufs_list(self, path: str) -> list[FileStatus]:
        """The children of a mounted directory, as synthesised entries."""
        info, ufs, uri = self._ufs_for(path)
        if info is None:
            return []
        try:
            entries = await ufs.list(uri)
        except Exception:  # noqa: BLE001
            return []
        out = []
        for st in entries:
            name = st.path.rstrip("/").rsplit("/", 1)[-1]
            cv = f"{path.rstrip('/')}/{name}" if path != "/" else f"/{name}"
            out.append(self._synth_status(cv, st))
        return out

    async def list_merged(self, path: str) -> list[FileStatus]:
        """The cached entries of ``path`` merged over its mount's UFS
        entries and sorted by name (LIST_STATUS's answer); FileNotFound
        when neither the cache nor the UFS holds ``path``."""
        try:
            cached = self.fs.list_status(path)
        except err.FileNotFound:
            if await self.ufs_status(path) is None:
                raise
            cached = []
        merged = {s.name: s for s in await self.ufs_list(path)}
        merged.update({s.name: s for s in cached})
        return [merged[k] for k in sorted(merged)]

    # ---------- snapshot ----------

    def snapshot_state(self) -> list[dict]:
        return [m.to_wire() for m in self._mounts.values()]

    def load_snapshot_state(self, state: list[dict]) -> None:
        """The table of a snapshot whose mount records the filesystem
        already wrote into the store (``_fill_store``)."""
        self._mounts = {m["cv_path"]: MountInfo.from_wire(m) for m in state}
        if self._mounts:
            top = max(m.mount_id for m in self._mounts.values())
            self._ids = itertools.count(top + 1)
