"""Metadata RPC client.

Own copy of ``curvine_tpu/client/fs_client.py``: ``FsClient.call`` with
its retry and NOT_LEADER redirect (:121-170) and the namespace and block
calls the cache client's read path and the loader's writes need (:211-410,
:584): ``mkdir``, ``create_file`` (with ``block_size`` and
``storage_policy``), ``exists``, ``file_status``, ``list_status``,
``rename``, ``set_attr`` (:345), ``delete``, ``meta_batch``,
``add_block``, ``complete_file``,
``get_block_locations``, ``master_info``, ``prefetch_window`` and
``decommission_worker`` (:517-524, which answers the worker's state);
and the mount and job calls (:533-603): ``mount``, ``umount``,
``update_mount``, ``mount_table``, ``get_mount_info``, ``submit_job``,
``submit_load``, ``submit_export``, ``job_status`` and ``cancel_job``;
and the raft membership plane (:439-470): ``raft_status`` (any master
answers), ``refresh_masters`` (the master list from the active raft
config), ``raft_member_change`` and ``raft_transfer``.
Every mutation carries
(client_id, call_id) for the master's retry cache, and every request the
conf's ``user`` and ``groups`` for the master's ACL checks (empty, the
OS user and that user's groups; :80-81). Retryable errors are retried
with the conf's ``conn_retry_max`` and ``conn_retry_base_ms``
(:74-75); ``call`` takes a ``deadline`` (``rpc/deadline.py``), which
rides each attempt's header and which the retry policy never sleeps
past (:121-150). ``complete_file`` takes ``only_flush``: the writer's
``hflush`` journals its sealed blocks' commits without completing the
file. With ``tracer`` set (the client's, ``obs/trace.py``), each call
but METRICS_REPORT and GET_SPANS (``_UNTRACED``: telemetry about
telemetry) is a ``meta.<code>`` span, whose context the connection
stamps into the request (:58, :121-150); ``report_metrics`` (:510-515)
sends counters and spans to the master (METRICS_REPORT).

Left out (ROADMAP A3): the metadata lease cache and its invalidation
pushes, the native fast metadata port (every call goes to the master's
RPC port, which answers them all), and the other calls (locks,
links)."""

from __future__ import annotations

import itertools
import socket
import uuid

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.types import (CommitBlock, FileBlocks,
                                            FileStatus, JobInfo, LocatedBlock,
                                            MasterInfo, MountInfo,
                                            SetAttrOpts)
from curvine_tpu_torch.rpc.client import (Connection, ConnectionPool,
                                          RetryPolicy)
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack

# the calls whose spans would be telemetry about telemetry
_UNTRACED = frozenset({RpcCode.METRICS_REPORT, RpcCode.GET_SPANS})


def _os_user() -> str:
    import getpass
    try:
        return getpass.getuser()
    except (KeyError, OSError):
        return "root"


def _os_groups(user: str) -> list[str]:
    """The user's primary group first (the master gives a new file the
    first group), then its supplementary groups."""
    import grp
    import os
    import pwd
    try:
        gid = pwd.getpwnam(user).pw_gid
        gids = [gid] + [g for g in os.getgrouplist(user, gid) if g != gid]
    except (KeyError, OSError):
        return []
    names = []
    for g in gids:
        try:
            names.append(grp.getgrgid(g).gr_name)
        except KeyError:
            continue
    return names


class FsClient:
    def __init__(self, conf: ClusterConf | None = None):
        self.conf = conf or ClusterConf()
        # the client's Tracer (set by CurvineClient): a span a call
        self.tracer = None
        cc = self.conf.client
        self.masters = list(cc.master_addrs)
        self._active = 0
        self.pool = ConnectionPool(size=cc.conn_pool_size,
                                   timeout_ms=cc.rpc_timeout_ms,
                                   rpc_conf=self.conf.rpc)
        self.retry = RetryPolicy(max_retries=cc.conn_retry_max,
                                 base_ms=cc.conn_retry_base_ms)
        self.client_id = uuid.uuid4().hex
        self._call_ids = itertools.count(1)
        self.client_host = socket.gethostname()
        self.user = cc.user or _os_user()
        self.groups = list(cc.groups) or _os_groups(self.user)

    async def close(self) -> None:
        await self.pool.close()

    def is_local(self, loc) -> bool:
        """A worker location on this host (its hostname or ip is this
        client's host, or it is the loopback): the short circuit's test,
        for reads and writes alike."""
        return self.client_host in (loc.hostname, loc.ip_addr) or \
            loc.ip_addr in ("127.0.0.1", "localhost")

    async def _conn(self) -> Connection:
        return await self.pool.get(self.masters[self._active])

    async def call(self, code: RpcCode, req: dict, mutate: bool = False,
                   deadline=None) -> dict:
        """One request to the active master, retried on retryable errors
        within ``deadline`` (a ``Deadline``, or None); NOT_LEADER and
        CONNECT move to the next master first."""
        req = dict(req)
        req.setdefault("user", self.user)
        req.setdefault("groups", self.groups)
        if mutate:
            req["client_id"] = self.client_id
            req["call_id"] = next(self._call_ids)

        async def once() -> dict:
            try:
                rep = await (await self._conn()).call(
                    code, data=pack(req), deadline=deadline)
                return unpack(rep.data) or {}
            except err.CurvineError as e:
                if e.code in (err.ErrorCode.NOT_LEADER,
                              err.ErrorCode.CONNECT):
                    self._note_leader_hint(e)
                raise

        if self.tracer is not None and code not in _UNTRACED:
            with self.tracer.span(f"meta.{RpcCode(code).name.lower()}"):
                return await self.retry.run(once, deadline=deadline)
        return await self.retry.run(once, deadline=deadline)

    def _note_leader_hint(self, e: err.CurvineError) -> None:
        """Adopt the member list a NOT_LEADER error carries and jump to
        the hinted leader; with no hint, rotate to the next master."""
        if e.members:
            cur = self.masters[self._active] if self.masters else None
            self.masters = list(e.members)
            self._active = (self.masters.index(cur) if cur in self.masters
                            else self._active % len(self.masters))
        if e.leader_hint:
            if e.leader_hint not in self.masters:
                self.masters.append(e.leader_hint)
            self._active = self.masters.index(e.leader_hint)
            return
        self._active = (self._active + 1) % len(self.masters)

    # ---------------- namespace ----------------

    async def mkdir(self, path: str) -> FileStatus:
        """``path`` and any missing parents."""
        rep = await self.call(RpcCode.MKDIR, {
            "path": path, "create_parent": True}, mutate=True)
        return FileStatus.from_wire(rep["status"])

    async def create_file(self, path: str, overwrite: bool = False,
                          replicas: int | None = None,
                          block_size: int | None = None,
                          storage_policy: dict | None = None) -> FileStatus:
        """A new file of ``replicas`` replicas and blocks of
        ``block_size`` (the conf's when None); ``storage_policy`` in wire
        form, the master's default when None."""
        cc = self.conf.client
        req = {"path": path, "overwrite": overwrite,
               "replicas": cc.replicas if replicas is None else replicas,
               "block_size": block_size or cc.block_size,
               "client_name": self.client_id}
        if storage_policy:
            req["storage_policy"] = storage_policy
        rep = await self.call(RpcCode.CREATE_FILE, req, mutate=True)
        return FileStatus.from_wire(rep["status"])

    async def exists(self, path: str) -> bool:
        return (await self.call(RpcCode.EXISTS, {"path": path}))["exists"]

    async def file_status(self, path: str) -> FileStatus:
        rep = await self.call(RpcCode.FILE_STATUS, {"path": path})
        return FileStatus.from_wire(rep["status"])

    async def list_status(self, path: str) -> list[FileStatus]:
        rep = await self.call(RpcCode.LIST_STATUS, {"path": path})
        return [FileStatus.from_wire(s) for s in rep["statuses"]]

    async def rename(self, src: str, dst: str) -> bool:
        rep = await self.call(RpcCode.RENAME, {"src": src, "dst": dst},
                              mutate=True)
        return rep["result"]

    async def master_info(self) -> MasterInfo:
        rep = await self.call(RpcCode.GET_MASTER_INFO, {})
        return MasterInfo.from_wire(rep["info"])

    async def delete(self, path: str, recursive: bool = False) -> None:
        await self.call(RpcCode.DELETE,
                        {"path": path, "recursive": recursive}, mutate=True)

    async def meta_batch(self, requests: list[dict]) -> list[dict]:
        """Metadata mutations in one round trip. Each request is
        ``{"op": "mkdir"|"create"|"delete", "path": ..., ...}``; the
        replies are positional, a failed item as ``{"error",
        "error_code"}`` instead of an exception."""
        reqs = []
        for r in requests:
            r = dict(r)
            if r.get("op") == "create":
                r.setdefault("replicas", self.conf.client.replicas)
                r.setdefault("block_size", self.conf.client.block_size)
                r.setdefault("client_name", self.client_id)
            reqs.append(r)
        rep = await self.call(RpcCode.META_BATCH, {"requests": reqs},
                              mutate=True)
        return rep["responses"]

    async def set_attr(self, path: str, opts: SetAttrOpts) -> None:
        """Owner, group, mode, replicas, TTL fields, times, xattrs or the
        ``ec`` storage class of ``path``; a None field stays as it is."""
        await self.call(RpcCode.SET_ATTR,
                        {"path": path, "opts": opts.to_wire()}, mutate=True)

    # ---------------- blocks ----------------

    async def add_block(self, path: str,
                        commit_blocks: list[CommitBlock] | None = None,
                        exclude_workers: list[int] | None = None,
                        ici_coords: list[int] | None = None,
                        abandon_block: int | None = None) -> LocatedBlock:
        rep = await self.call(RpcCode.ADD_BLOCK, {
            "path": path, "client_host": self.client_host,
            "commit_blocks": [c.to_wire() for c in commit_blocks or []],
            "exclude_workers": exclude_workers or [],
            "ici_coords": ici_coords or [],
            "abandon_block": abandon_block}, mutate=True)
        return LocatedBlock.from_wire(rep["block"])

    async def complete_file(self, path: str, length: int,
                            commit_blocks: list[CommitBlock] | None = None,
                            only_flush: bool = False) -> bool:
        """Commit ``commit_blocks`` and complete the file at ``length``;
        with ``only_flush`` the commits are journaled and the file stays
        open for writing."""
        rep = await self.call(RpcCode.COMPLETE_FILE, {
            "path": path, "len": length,
            "commit_blocks": [c.to_wire() for c in commit_blocks or []],
            "client_name": self.client_id, "only_flush": only_flush},
            mutate=True)
        return rep["result"]

    async def get_block_locations(self, path: str,
                                  deadline=None) -> FileBlocks:
        rep = await self.call(RpcCode.GET_BLOCK_LOCATIONS, {"path": path},
                              deadline=deadline)
        return FileBlocks.from_wire(rep["file_blocks"])

    async def report_metrics(self, counters: dict,
                             spans: list[dict] | None = None) -> None:
        """Counter deltas and finished spans to the master."""
        req: dict = {"counters": counters}
        if spans:
            req["spans"] = spans
        await self.call(RpcCode.METRICS_REPORT, req)

    async def decommission_worker(self, worker_id: int,
                                  on: bool = True) -> int:
        """Drain a worker (no new blocks; its replicas copied to LIVE
        workers; DECOMMISSIONED once drained) or, with ``on`` False,
        put it back to LIVE; returns its state (``WorkerState``)."""
        rep = await self.call(RpcCode.DECOMMISSION_WORKER,
                              {"worker_id": worker_id, "on": on},
                              mutate=True)
        return rep["state"]

    async def prefetch_window(self, path: str, cursor: int = 0,
                              window: int = 8, epoch: int = 0,
                              seed: int = 0) -> dict:
        """Tell the master where the read cursor is in the deterministic
        (seed, epoch) shard order of ``path``; it keeps ``window`` shards
        warm ahead of it."""
        return await self.call(RpcCode.PREFETCH_WINDOW, {
            "path": path, "cursor": int(cursor), "window": int(window),
            "epoch": int(epoch), "seed": int(seed)}, mutate=True)

    # ---------------- mounts and jobs ----------------

    async def mount(self, cv_path: str, ufs_path: str,
                    properties: dict | None = None, auto_cache: bool = False,
                    write_type: int = 0, ttl_ms: int = 0, ttl_action: int = 0,
                    storage_type: str = "", block_size: int = 0,
                    replicas: int = 0, access_mode: str = "rw") -> MountInfo:
        rep = await self.call(RpcCode.MOUNT, {
            "cv_path": cv_path, "ufs_path": ufs_path,
            "properties": properties or {}, "auto_cache": auto_cache,
            "write_type": write_type, "ttl_ms": ttl_ms,
            "ttl_action": ttl_action, "storage_type": storage_type,
            "block_size": block_size, "replicas": replicas,
            "access_mode": access_mode}, mutate=True)
        return MountInfo.from_wire(rep["mount"])

    async def umount(self, cv_path: str) -> None:
        await self.call(RpcCode.UNMOUNT, {"cv_path": cv_path}, mutate=True)

    async def update_mount(self, cv_path: str,
                           properties: dict | None = None,
                           auto_cache: bool | None = None,
                           ttl_ms: int | None = None,
                           ttl_action: int | None = None,
                           access_mode: str | None = None) -> MountInfo:
        rep = await self.call(RpcCode.UPDATE_MOUNT, {
            "cv_path": cv_path, "properties": properties,
            "auto_cache": auto_cache, "ttl_ms": ttl_ms,
            "ttl_action": ttl_action, "access_mode": access_mode},
            mutate=True)
        return MountInfo.from_wire(rep["mount"])

    async def mount_table(self) -> list[MountInfo]:
        rep = await self.call(RpcCode.GET_MOUNT_TABLE, {})
        return [MountInfo.from_wire(m) for m in rep["mounts"]]

    async def get_mount_info(self, path: str) -> MountInfo | None:
        rep = await self.call(RpcCode.GET_MOUNT_INFO, {"path": path})
        return MountInfo.from_wire(rep["mount"]) if rep.get("mount") else None

    async def submit_job(self, kind: str, path: str, recursive: bool = True,
                         replicas: int = 1) -> str:
        rep = await self.call(RpcCode.SUBMIT_JOB, {
            "kind": kind, "path": path, "recursive": recursive,
            "replicas": replicas}, mutate=True)
        return rep["job_id"]

    async def submit_load(self, path: str, recursive: bool = True,
                          replicas: int = 1) -> str:
        return await self.submit_job("load", path, recursive, replicas)

    async def submit_export(self, path: str, recursive: bool = True) -> str:
        return await self.submit_job("export", path, recursive)

    async def job_status(self, job_id: str) -> JobInfo:
        rep = await self.call(RpcCode.GET_JOB_STATUS, {"job_id": job_id})
        return JobInfo.from_wire(rep["job"])

    async def cancel_job(self, job_id: str) -> None:
        await self.call(RpcCode.CANCEL_JOB, {"job_id": job_id}, mutate=True)

    # ---------------- raft membership plane ----------------

    async def raft_status(self) -> dict:
        """RAFT_STATUS of the master this client points at: any node
        answers (role, term, leader, voters and learners, match lag)."""
        return await self.call(RpcCode.RAFT_STATUS, {})

    async def refresh_masters(self) -> list[str]:
        """Take the master list from the cluster's active raft config (a
        node added since the conf was written is not in it)."""
        st = await self.raft_status()
        members = [a for a in (st.get("voters") or {}).values() if a]
        if members:
            cur = (self.masters[self._active]
                   if self._active < len(self.masters) else None)
            self.masters = members
            self._active = (members.index(cur) if cur in members else 0)
        return list(self.masters)

    async def raft_member_change(self, action: str, node_id: int,
                                 addr: str = "") -> dict:
        """Add, promote or remove a member, on the leader; the answer
        comes once the config entry is committed on a quorum."""
        return await self.call(RpcCode.RAFT_MEMBER_CHANGE,
                               {"action": action, "node_id": node_id,
                                "addr": addr}, mutate=True)

    async def raft_transfer(self, target: int | None = None) -> int:
        """Hand leadership over; returns the new leader's node id."""
        rep = await self.call(RpcCode.RAFT_TRANSFER, {"target": target})
        return rep.get("target", 0)
