"""The wire types the port's cache client, worker and master decode and
send.

Own copy of ``curvine_tpu/common/types.py:16-331``, field for field and
with the same defaults: ``now_ms``, ``FileStatus`` (with its
``StoragePolicy``), ``WorkerAddress``, ``StorageInfo`` and ``WorkerInfo``
(the worker's heartbeat body, as the JAX master's heartbeat handler
decodes it), ``ExtendedBlock``, ``BlockLocation``, ``LocatedBlock``,
``FileBlocks``, ``CommitBlock`` and ``MasterInfo`` (GET_MASTER_INFO's
reply), ``MountInfo``, ``TaskInfo`` and ``JobInfo`` (:333-400, the mount
table's and the job manager's records, journaled), ``SetAttrOpts``
(:400-416, SET_ATTR's body, journaled by ``set_attr``), and the enums their
fields hold (``BlockState``, ``WorkerState``, ``WriteType`` and
``JobState`` among them). Each round-trips through
a plain dict (``to_wire`` / ``from_wire``); a field missing from the dict
keeps its default, so a peer that adds fields stays readable. Left out:
the lock and attribute types."""

from __future__ import annotations

import dataclasses
import enum
import time
from dataclasses import dataclass, field
from typing import Any


def now_ms() -> int:
    return int(time.time() * 1000)


class StorageType(enum.IntEnum):
    HBM = -1
    MEM = 0
    SSD = 1
    HDD = 2
    UFS = 3
    DISK = 4


class TtlAction(enum.IntEnum):
    NONE = 0
    DELETE = 1
    FREE = 2


class WriteType(enum.IntEnum):
    CACHE = 0       # the cache only
    FS = 1          # through to the UFS (not ported: ROADMAP A3e)


class FileType(enum.IntEnum):
    DIR = 0
    FILE = 1
    LINK = 2
    STREAM = 3
    AGG = 4
    OBJECT = 5


class StorageState(enum.IntEnum):
    CV = 1
    UFS = 2
    BOTH = 3


class BlockState(enum.IntEnum):
    TEMP = 0        # being written
    COMMITTED = 1


class WorkerState(enum.IntEnum):
    LIVE = 0
    LOST = 1
    DECOMMISSIONING = 2
    DECOMMISSIONED = 3


class JobState(enum.IntEnum):
    PENDING = 0
    RUNNING = 1
    COMPLETED = 2
    FAILED = 3
    CANCELLED = 4


def _to_wire(v: Any) -> Any:
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _to_wire(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (list, tuple)):
        return [_to_wire(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_wire(x) for k, x in v.items()}
    return v


class Wire:
    """Mixin: dataclass ↔ dict of wire values."""

    # field name -> its type where it is an enum or a nested wire type;
    # a one-element tuple marks a list of that type
    _nested: dict = {}

    def to_wire(self) -> dict:
        return _to_wire(self)

    @classmethod
    def from_wire(cls, d: dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            t = cls._nested.get(f.name)
            if t is not None and v is not None:
                if isinstance(t, tuple):
                    v = [_decode(t[0], x) for x in v]
                else:
                    v = _decode(t, v)
            kwargs[f.name] = v
        return cls(**kwargs)


def _decode(t, v):
    return t(v) if issubclass(t, enum.Enum) else t.from_wire(v)


@dataclass
class StoragePolicy(Wire):
    storage_type: StorageType = StorageType.DISK
    ttl_ms: int = 0
    ttl_action: TtlAction = TtlAction.NONE
    ufs_mtime: int = 0
    state: StorageState = StorageState.CV
    ec: str = ""

    _nested = {"storage_type": StorageType, "ttl_action": TtlAction,
               "state": StorageState}


@dataclass
class FileStatus(Wire):
    id: int = 0
    path: str = ""
    name: str = ""
    is_dir: bool = False
    mtime: int = 0
    atime: int = 0
    children_num: int = 0
    is_complete: bool = False
    len: int = 0
    replicas: int = 1
    block_size: int = 64 * 1024 * 1024
    file_type: FileType = FileType.FILE
    x_attr: dict = field(default_factory=dict)
    storage_policy: StoragePolicy = field(default_factory=StoragePolicy)
    owner: str = ""
    group: str = ""
    mode: int = 0o644
    target: str | None = None
    nlink: int = 1

    _nested = {"file_type": FileType, "storage_policy": StoragePolicy}


@dataclass(frozen=True)
class WorkerAddress(Wire):
    worker_id: int = 0
    hostname: str = ""
    ip_addr: str = ""
    rpc_port: int = 0
    web_port: int = 0


@dataclass
class StorageInfo(Wire):
    """Capacity of one worker dir (or one device of the tier-0)."""

    storage_type: StorageType = StorageType.MEM
    dir_id: str = ""
    capacity: int = 0
    available: int = 0
    block_num: int = 0
    health: str = "healthy"

    _nested = {"storage_type": StorageType}


@dataclass
class WorkerInfo(Wire):
    address: WorkerAddress = field(default_factory=WorkerAddress)
    state: WorkerState = WorkerState.LIVE
    storages: list[StorageInfo] = field(default_factory=list)
    last_heartbeat_ms: int = 0
    ici_coords: list[int] = field(default_factory=list)

    _nested = {"address": WorkerAddress, "state": WorkerState,
               "storages": (StorageInfo,)}

    @property
    def capacity(self) -> int:
        return sum(s.capacity for s in self.storages)

    @property
    def available(self) -> int:
        return sum(s.available for s in self.storages)


@dataclass(frozen=True)
class ExtendedBlock(Wire):
    id: int = 0
    len: int = 0
    storage_type: StorageType = StorageType.DISK
    file_type: FileType = FileType.FILE

    _nested = {"storage_type": StorageType, "file_type": FileType}


@dataclass
class BlockLocation(Wire):
    worker_id: int = 0
    storage_type: StorageType = StorageType.MEM

    _nested = {"storage_type": StorageType}


@dataclass
class LocatedBlock(Wire):
    block: ExtendedBlock = field(default_factory=ExtendedBlock)
    offset: int = 0
    locs: list[WorkerAddress] = field(default_factory=list)
    storage_types: list[StorageType] = field(default_factory=list)
    # erasure-coded stripe descriptor; None for a replicated block
    ec: dict | None = None

    _nested = {"block": ExtendedBlock, "locs": (WorkerAddress,),
               "storage_types": (StorageType,)}


@dataclass
class FileBlocks(Wire):
    status: FileStatus = field(default_factory=FileStatus)
    block_locs: list[LocatedBlock] = field(default_factory=list)

    _nested = {"status": FileStatus, "block_locs": (LocatedBlock,)}


@dataclass
class CommitBlock(Wire):
    block_id: int = 0
    block_len: int = 0
    worker_ids: list[int] = field(default_factory=list)
    storage_type: StorageType = StorageType.MEM

    _nested = {"storage_type": StorageType}


@dataclass
class MasterInfo(Wire):
    active_master: str = ""
    # the native metadata read plane's address; the port's master serves
    # none and leaves it empty
    fast_addr: str = ""
    journal_nodes: list[str] = field(default_factory=list)
    inode_num: int = 0
    block_num: int = 0
    capacity: int = 0
    available: int = 0
    fs_used: int = 0
    live_workers: list[WorkerInfo] = field(default_factory=list)
    lost_workers: list[WorkerInfo] = field(default_factory=list)

    _nested = {"live_workers": (WorkerInfo,), "lost_workers": (WorkerInfo,)}


@dataclass
class MountInfo(Wire):
    """A cache subtree bound to a UFS URI, with its caching policy: the
    TTL given to cached copies, the storage, block size and replica
    defaults of loads (0 or "" for the client's), and the access mode
    (``"r"`` refuses user mutations under the mount; cache-warming loads
    pass)."""

    mount_id: int = 0
    cv_path: str = ""
    ufs_path: str = ""
    properties: dict = field(default_factory=dict)
    auto_cache: bool = False
    write_type: WriteType = WriteType.CACHE
    ttl_ms: int = 0
    ttl_action: TtlAction = TtlAction.NONE
    storage_type: str = ""
    block_size: int = 0
    replicas: int = 0
    access_mode: str = "rw"

    _nested = {"write_type": WriteType, "ttl_action": TtlAction}

    def ufs_uri(self, path: str) -> str:
        """The UFS URI of ``path``, a cache path under this mount."""
        rel = path[len(self.cv_path):] if self.cv_path != "/" else path
        return self.ufs_path + rel


@dataclass
class TaskInfo(Wire):
    task_id: str = ""
    job_id: str = ""
    worker_id: int = 0
    path: str = ""
    # load (UFS to cache), export (cache to UFS), prefetch, ec_convert
    kind: str = "load"
    state: JobState = JobState.PENDING
    message: str = ""
    total_len: int = 0
    loaded_len: int = 0
    attempts: int = 0
    # a kind's own plan (ec_convert's stripes); never journaled
    payload: dict = field(default_factory=dict)

    _nested = {"state": JobState}


@dataclass
class JobInfo(Wire):
    job_id: str = ""
    kind: str = "load"
    path: str = ""
    state: JobState = JobState.PENDING
    message: str = ""
    create_ms: int = 0
    finish_ms: int = 0
    tasks: list[TaskInfo] = field(default_factory=list)
    # planning parameters, journaled so a restarted master re-plans
    recursive: bool = True
    replicas: int = 1
    # a prefetch window's bounds and the (seed, epoch) its shard order
    # is computed from; never the file list
    cursor: int = 0
    window: int = 0
    epoch: int = 0
    seed: int = 0
    total_files: int = 0

    _nested = {"state": JobState, "tasks": (TaskInfo,)}


@dataclass
class SetAttrOpts(Wire):
    """SET_ATTR's fields; None (or empty) leaves a field as it is."""

    replicas: int | None = None
    owner: str | None = None
    group: str | None = None
    mode: int | None = None
    ttl_ms: int | None = None
    ttl_action: int | None = None
    add_x_attr: dict = field(default_factory=dict)
    remove_x_attr: list[str] = field(default_factory=list)
    atime: int | None = None
    mtime: int | None = None
    # the EC storage class: "" back to replicated, "rs-<k>-<m>" marks
    # the file for the ec_convert job
    ec: str | None = None
