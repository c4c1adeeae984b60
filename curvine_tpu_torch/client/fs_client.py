"""Metadata RPC client.

Own copy of ``curvine_tpu/client/fs_client.py``: ``FsClient.call`` with
its retry and NOT_LEADER redirect (:121-170) and the namespace and block
calls the cache client's read path and the loader's writes need (:211-410,
:584): ``mkdir``, ``create_file``, ``file_status``, ``list_status``,
``delete``, ``meta_batch``, ``add_block``, ``complete_file``,
``get_block_locations`` and ``prefetch_window``. Every mutation carries
(client_id, call_id) for the master's retry cache, and every request the
OS user and its groups for the master's ACL checks.

Left out (ROADMAP A3): the metadata lease cache and its invalidation
pushes, the native fast metadata port (every call goes to the master's
RPC port, which answers them all), tracing, and the other calls (mounts,
jobs, locks, raft membership, renames, attributes)."""

from __future__ import annotations

import itertools
import socket
import uuid

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import REPLICAS, ClusterConf
from curvine_tpu_torch.common.types import (CommitBlock, FileBlocks,
                                            FileStatus, LocatedBlock)
from curvine_tpu_torch.rpc.client import (Connection, ConnectionPool,
                                          RetryPolicy)
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack, unpack


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
        cc = self.conf.client
        self.masters = list(cc.master_addrs)
        self._active = 0
        self.pool = ConnectionPool(size=cc.conn_pool_size,
                                   timeout_ms=cc.rpc_timeout_ms)
        self.retry = RetryPolicy()
        self.client_id = uuid.uuid4().hex
        self._call_ids = itertools.count(1)
        self.client_host = socket.gethostname()
        self.user = _os_user()
        self.groups = _os_groups(self.user)

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

    async def call(self, code: RpcCode, req: dict,
                   mutate: bool = False) -> dict:
        """One request to the active master, retried on retryable errors;
        NOT_LEADER and CONNECT move to the next master first."""
        req = dict(req)
        req.setdefault("user", self.user)
        req.setdefault("groups", self.groups)
        if mutate:
            req["client_id"] = self.client_id
            req["call_id"] = next(self._call_ids)

        async def once() -> dict:
            try:
                rep = await (await self._conn()).call(code, data=pack(req))
                return unpack(rep.data) or {}
            except err.CurvineError as e:
                if e.code in (err.ErrorCode.NOT_LEADER,
                              err.ErrorCode.CONNECT):
                    self._note_leader_hint(e)
                raise

        return await self.retry.run(once)

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

    async def create_file(self, path: str, overwrite: bool = False
                          ) -> FileStatus:
        cc = self.conf.client
        rep = await self.call(RpcCode.CREATE_FILE, {
            "path": path, "overwrite": overwrite, "replicas": REPLICAS,
            "block_size": cc.block_size, "client_name": self.client_id},
            mutate=True)
        return FileStatus.from_wire(rep["status"])

    async def file_status(self, path: str) -> FileStatus:
        rep = await self.call(RpcCode.FILE_STATUS, {"path": path})
        return FileStatus.from_wire(rep["status"])

    async def list_status(self, path: str) -> list[FileStatus]:
        rep = await self.call(RpcCode.LIST_STATUS, {"path": path})
        return [FileStatus.from_wire(s) for s in rep["statuses"]]

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
                r.setdefault("replicas", REPLICAS)
                r.setdefault("block_size", self.conf.client.block_size)
                r.setdefault("client_name", self.client_id)
            reqs.append(r)
        rep = await self.call(RpcCode.META_BATCH, {"requests": reqs},
                              mutate=True)
        return rep["responses"]

    # ---------------- blocks ----------------

    async def add_block(self, path: str,
                        commit_blocks: list[CommitBlock] | None = None,
                        abandon_block: int | None = None) -> LocatedBlock:
        rep = await self.call(RpcCode.ADD_BLOCK, {
            "path": path, "client_host": self.client_host,
            "commit_blocks": [c.to_wire() for c in commit_blocks or []],
            "exclude_workers": [], "ici_coords": [],
            "abandon_block": abandon_block}, mutate=True)
        return LocatedBlock.from_wire(rep["block"])

    async def complete_file(self, path: str, length: int,
                            commit_blocks: list[CommitBlock] | None = None
                            ) -> bool:
        rep = await self.call(RpcCode.COMPLETE_FILE, {
            "path": path, "len": length,
            "commit_blocks": [c.to_wire() for c in commit_blocks or []],
            "client_name": self.client_id, "only_flush": False},
            mutate=True)
        return rep["result"]

    async def get_block_locations(self, path: str) -> FileBlocks:
        rep = await self.call(RpcCode.GET_BLOCK_LOCATIONS, {"path": path})
        return FileBlocks.from_wire(rep["file_blocks"])

    async def prefetch_window(self, path: str, cursor: int = 0,
                              window: int = 8, epoch: int = 0,
                              seed: int = 0) -> dict:
        """Tell the master where the read cursor is in the deterministic
        (seed, epoch) shard order of ``path``; it keeps ``window`` shards
        warm ahead of it."""
        return await self.call(RpcCode.PREFETCH_WINDOW, {
            "path": path, "cursor": int(cursor), "window": int(window),
            "epoch": int(epoch), "seed": int(seed)}, mutate=True)
