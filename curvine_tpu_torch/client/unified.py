"""The port's cache client, with the UFS behind its mounts.

Own copy of the parts of ``curvine_tpu/client/unified.py`` (:28-72,
:134-201, :261-434) that the cache feed, its writer and the master's
tasks call: ``CurvineClient`` with ``meta`` (the ``FsClient``),
``create``, ``open``, ``write_all``, ``read_all`` (the reference's
``unified_read``) and ``advise`` (the master's rolling prefetch window),
over one connection pool to the workers; and the UFS side:
``unified_open``, ``load_from_ufs`` (the worker side of a load task),
``prefetch`` (of a prefetch task) and ``export_to_ufs`` (of an export
task). ``create`` and ``write_all`` take ``replicas`` (:137-158), and the
writer fans each block out to that many workers; ``create`` also takes
``block_size``, ``storage_type`` (a tier's name, the conf's when None;
``_TIERS``, :24-25) and ``storage_policy``, and hands the writer the
conf's ``write_chunk_size``, ``write_replay_buffer`` and
``write_min_replicas``. The readers and writers it opens share one
``WorkerHealth`` board (``client/health.py``, :37-47, built when the
conf's ``breaker_enabled`` is on, with its threshold, open and decay
times): a reader tries the workers behind open breakers last, and a
writer's ADD_BLOCK excludes them. They share ``counters`` too:
``sc.bytes.read`` and ``sc.bytes.written`` (short circuit),
``read.zero_copy_bytes`` (READ_BLOCK into the caller's buffer),
``write.bytes`` (all bytes written), ``sc.write.fallbacks`` (blocks
that went over WRITE_BLOCK with the short circuit on),
``write.replica_failover`` (legs dropped), ``write.degraded_commits``,
``write.block_replay_bytes`` (bytes replayed into re-placed blocks) and
``advise.rpcs``.

The observability plane (:48-52, :73-122): the client's ``tracer``
(``obs/trace.py``, from the ``[obs]`` table) is shared with ``meta``
and with every reader and writer it opens; ``open``, ``write_all``
(``write``) and ``read_all`` (``read``) are spans, and the UFS legs
``ufs_read`` and ``ufs_load`` (:177, :196, :272, :284, :363). Each
reader gets the conf's ``op_deadline_ms``. ``flush_metrics`` sends the
counters' deltas since the last flush (from a snapshot: increments that
land during the call wait for the next) and the finished spans to the
master (METRICS_REPORT, which files them as ``client.<name>``); the
spans go back into the ring when the master is away. A flush runs every
5 s from the first ``create`` or ``open`` (a task started then, since a
client may be built outside a loop), and at ``close``. Beyond the
reference, flushes run one at a time, and ``close`` lets a periodic
report in flight end before its own: two flushes at once, or a report
cut off after the master took it, would count a delta twice.
``get_trace`` flushes, then asks the master for a trace's spans from
itself and every worker (GET_SPANS with ``collect``).

``read_all`` reads a cached file (complete, every block located) through
the cache; any other file under a mount comes from the UFS through it,
and is cached when the mount's ``auto_cache`` is set. A file under no
mount keeps the cache's error (``FileNotFound``, ``Uncompleted``, or
``BlockNotFound`` for a block with no live location), where the
reference raises ``MountNotFound``. A load creates the cached copy with
the UFS object's mtime in its storage policy (at least 1: the mark of a
cache-warming create, which a read-only mount lets through), the
mount's ``ttl_ms`` and ``ttl_action`` (kept in the policy; the TTL
scanner is not ported, ``MASTER_FIXED``), and the mount's ``replicas``,
``block_size`` and ``storage_type`` where it sets them.

Left out (ROADMAP A3e): the ``FallbackReader`` (a cached read that goes
on from the UFS after every replica is lost mid-stream; ``unified_open``
returns the cache's reader), ``write_through`` (``WriteType.FS``), the
metadata cache, tenants, appends, batched small-file writes and
``content_summary``."""

from __future__ import annotations

import asyncio
import contextvars
import logging

from curvine_tpu_torch.client.fs_client import FsClient
from curvine_tpu_torch.client.health import WorkerHealth
from curvine_tpu_torch.client.reader import FsReader
from curvine_tpu_torch.client.ufs_reader import UfsReader
from curvine_tpu_torch.client.writer import FsWriter
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.types import (FileBlocks, StoragePolicy,
                                            StorageState, StorageType,
                                            TtlAction)
from curvine_tpu_torch.obs.trace import Tracer
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.ufs.base import create_ufs

log = logging.getLogger(__name__)

_TIERS = {"hbm": StorageType.HBM, "mem": StorageType.MEM,
          "ssd": StorageType.SSD, "hdd": StorageType.HDD}


def _located(fb: FileBlocks) -> bool:
    """Every block of the file has a live location, and the file is not
    one whose cached copy was freed (state UFS)."""
    if fb.status.storage_policy.state == StorageState.UFS:
        return False
    return all(lb.locs or lb.ec is not None for lb in fb.block_locs)


def _uncached(path: str, fb: FileBlocks) -> err.CurvineError | None:
    """Why ``fb``'s file cannot be read from the cache, or None."""
    if not fb.status.is_complete:
        return err.Uncompleted(f"{path} is still being written")
    if fb.status.len and not _located(fb):
        missing = [lb.block.id for lb in fb.block_locs
                   if not lb.locs and lb.ec is None]
        return err.BlockNotFound(f"{path}: blocks {missing} have no live "
                                 f"location")
    return None


class CurvineClient:
    def __init__(self, conf: ClusterConf | None = None):
        self.conf = conf or ClusterConf()
        cc = self.conf.client
        self.meta = FsClient(self.conf)
        self.pool = ConnectionPool(size=cc.conn_pool_size,
                                   timeout_ms=cc.rpc_timeout_ms,
                                   rpc_conf=self.conf.rpc)
        self.counters: dict[str, int] = {}
        # per-worker circuit breakers, shared by every reader and writer
        # of this client: a dead worker is learned once
        self.health = None
        if cc.breaker_enabled:
            self.health = WorkerHealth(
                fail_threshold=cc.breaker_fail_threshold,
                open_s=cc.breaker_open_ms / 1000.0,
                decay_s=cc.breaker_decay_ms / 1000.0)
        # the tracing front end, shared with meta, readers and writers
        self.tracer = Tracer.from_conf("client", self.conf.obs)
        self.meta.tracer = self.tracer
        # the counters as the master last took them, and the periodic
        # flush's task (started by the first create or open)
        self._reported: dict[str, int] = {}
        self._metrics_task: asyncio.Task | None = None
        # the periodic flush's report in flight, and the lock that puts
        # flushes in turn: two at once would both send one delta
        self._flushing: asyncio.Future | None = None
        self._flush_lock = asyncio.Lock()

    async def close(self) -> None:
        if self._metrics_task is not None:
            self._metrics_task.cancel()
            await asyncio.gather(self._metrics_task, return_exceptions=True)
            self._metrics_task = None
        if self._flushing is not None:
            await asyncio.gather(self._flushing, return_exceptions=True)
        try:
            await self.flush_metrics()
        except Exception as e:  # noqa: BLE001 — the master may be away
            log.debug("metrics flush at close failed: %s", e)
        await self.meta.close()
        await self.pool.close()

    def _ensure_metrics_task(self) -> None:
        """The flush every 5 s, so that a long job's counters reach the
        master as they grow; started from an async entry point, in a
        context of its own: a flush belongs to no caller's trace (the
        reference's task inherits the trace of the ``open`` that started
        it, and its reports land in that trace long after it ended)."""
        if self._metrics_task is not None:
            return

        async def loop():
            while True:
                await asyncio.sleep(5.0)
                # shielded: a close that cancels the loop waits for the
                # report in flight rather than cutting it off, which could
                # leave the master holding a delta the client resends
                self._flushing = asyncio.ensure_future(self.flush_metrics())
                try:
                    await asyncio.shield(self._flushing)
                except Exception as e:  # noqa: BLE001 — retried next time
                    log.debug("metrics flush failed: %s", e)

        self._metrics_task = asyncio.get_running_loop().create_task(
            loop(), context=contextvars.Context())

    async def flush_metrics(self) -> None:
        """The counters' deltas since the last flush, and the finished
        spans, to the master; the spans go back into the ring on a
        failure, for the next flush. Flushes run one at a time."""
        async with self._flush_lock:
            await self._flush()

    async def _flush(self) -> None:
        snap = dict(self.counters)
        delta = {k: v - self._reported.get(k, 0) for k, v in snap.items()
                 if v != self._reported.get(k, 0)}
        spans = self.tracer.drain()
        if delta or spans:
            try:
                await self.meta.report_metrics(delta, spans=spans)
            except BaseException:
                self.tracer.ingest(spans)
                raise
            self._reported = snap

    async def get_trace(self, trace_id: str) -> list[dict]:
        """Every collected span of one trace: this client's finished
        spans flushed to the master, then the master's merge of its own
        store and every worker's (GET_SPANS with ``collect``)."""
        try:
            await self.flush_metrics()
        except err.CurvineError:
            pass                        # the collect may still answer
        rep = await self.meta.call(RpcCode.GET_SPANS,
                                   {"trace_id": trace_id, "collect": True})
        return rep.get("spans", [])

    async def __aenter__(self) -> "CurvineClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def create(self, path: str, overwrite: bool = False,
                     replicas: int | None = None,
                     block_size: int | None = None,
                     storage_type: str | None = None,
                     storage_policy: dict | None = None) -> FsWriter:
        """A new file of ``replicas`` replicas and blocks of
        ``block_size`` on the tier ``storage_type`` (each the conf's when
        None; an unknown tier is mem), with ``storage_policy`` (wire
        form; the master's default when None); the writer places blocks
        near the conf's ``worker.ici_coords``."""
        cc = self.conf.client
        block_size = block_size or cc.block_size
        self._ensure_metrics_task()
        await self.meta.create_file(path, overwrite=overwrite,
                                    replicas=replicas, block_size=block_size,
                                    storage_policy=storage_policy)
        return FsWriter(self.meta, path, self.pool,
                        block_size=block_size,
                        chunk_size=cc.write_chunk_size,
                        storage_type=_TIERS.get(storage_type
                                                or cc.storage_type,
                                                StorageType.MEM),
                        short_circuit=cc.short_circuit,
                        counters=self.counters, health=self.health,
                        ici_coords=list(self.conf.worker.ici_coords) or None,
                        replay_buffer=cc.write_replay_buffer,
                        min_replicas=cc.write_min_replicas,
                        tracer=self.tracer)

    async def open(self, path: str) -> FsReader:
        self._ensure_metrics_task()
        with self.tracer.span("open", attrs={"path": path}):
            fb = await self.meta.get_block_locations(path)
        return self._reader(path, fb)

    def _reader(self, path: str, fb) -> FsReader:
        cc = self.conf.client
        return FsReader(self.meta, path, fb, self.pool,
                        chunk_size=cc.read_chunk_size,
                        short_circuit=cc.short_circuit,
                        read_ahead=cc.read_ahead_chunks,
                        counters=self.counters,
                        health=self.health, verify=cc.read_verify,
                        op_deadline_ms=cc.op_deadline_ms,
                        tracer=self.tracer)

    async def write_all(self, path: str, data, **kw) -> None:
        # one span over the create, the uploads and the completion: every
        # call under it joins the trace through the ambient context
        with self.tracer.span("write", attrs={"path": path,
                                              "bytes": len(data)}):
            async with await self.create(path, overwrite=True, **kw) as w:
                await w.write(data)

    async def read_all(self, path: str) -> bytes:
        """The whole file: from the cache when it is cached there, else
        through its mount from the UFS."""
        with self.tracer.span("read", attrs={"path": path}) as sp:
            try:
                fb = await self.meta.get_block_locations(path)
            except err.FileNotFound as e:
                why = e
            else:
                why = _uncached(path, fb)
                if why is None:
                    r = self._reader(path, fb)
                    try:
                        return await r.read_all()
                    finally:
                        await r.close()
            # the UFS leg, a span of its own: a miss's trace shows where
            # its time went
            with self.tracer.span("ufs_read", attrs={"path": path}):
                mount = await self.meta.get_mount_info(path)
                if mount is None:
                    raise why
                mount, ufs, uri = self._ufs_of(mount, path)
                data = await ufs.read_all(uri)
            sp.set_attr("ufs_fallback", True)
            if mount.auto_cache:
                try:
                    await self.write_all(path, data)
                except err.CurvineError as e:
                    log.debug("auto-cache of %s failed: %s", path, e)
            return data

    async def advise(self, path: str, cursor: int = 0, window: int = 8,
                     epoch: int = 0, seed: int = 0) -> dict:
        """Tell the master the reader of ``path``'s shards is at index
        ``cursor`` of the (seed, epoch) order; it keeps the next
        ``window`` shards warm."""
        self.counters["advise.rpcs"] = self.counters.get("advise.rpcs", 0) + 1
        return await self.meta.prefetch_window(path, cursor=cursor,
                                               window=window, epoch=epoch,
                                               seed=seed)

    # ---------------- the UFS side ----------------

    @staticmethod
    def _ufs_of(mount, path: str):
        return mount, create_ufs(mount.ufs_path,
                                 properties=mount.properties), \
            mount.ufs_uri(path)

    async def _ufs_for(self, path: str):
        """(mount, its UFS, the object's uri) of ``path``."""
        mount = await self.meta.get_mount_info(path)
        if mount is None:
            raise err.MountNotFound(f"no mount covers {path}")
        return self._ufs_of(mount, path)

    async def unified_open(self, path: str):
        """A reader of ``path``: the cache's where its blocks are
        located, else a ``UfsReader`` streaming the mounted object."""
        st = await self.meta.file_status(path)
        try:
            fb = await self.meta.get_block_locations(path)
        except err.FileNotFound:
            fb = None           # a UFS object only: no inode yet
        if fb is not None and (st.len == 0 or _located(fb)):
            return self._reader(path, fb)
        _mount, ufs, uri = await self._ufs_for(path)
        return UfsReader(ufs, uri, st.len)

    async def load_from_ufs(self, path: str,
                            replicas: int | None = None) -> int:
        """Warm one file, UFS to cache (the worker side of a load task),
        under the mount's caching policy; returns the bytes loaded."""
        with self.tracer.span("ufs_load", attrs={"path": path}):
            return await self._load_from_ufs(path, replicas)

    async def _load_from_ufs(self, path: str, replicas: int | None) -> int:
        mount, ufs, uri = await self._ufs_for(path)
        st = await ufs.stat(uri)
        if st is None:
            raise err.FileNotFound(uri)
        sp = StoragePolicy(
            # at least 1: a UFS that reports mtime 0 still marks this
            # create as a cache-warming load (the read-only exemption)
            ufs_mtime=max(int(st.mtime or 0), 1),
            ttl_ms=mount.ttl_ms or 0,
            ttl_action=TtlAction(int(mount.ttl_action or 0)))
        w = await self.create(
            path, overwrite=True,
            replicas=replicas if replicas is not None
            else (mount.replicas or None),
            block_size=mount.block_size or None,
            storage_type=mount.storage_type or None,
            storage_policy=sp.to_wire())
        total = 0
        try:
            async for chunk in ufs.read(uri):
                await w.write(chunk)
                total += len(chunk)
            await w.close()
        except Exception:
            await w.abort()
            raise
        return total

    async def prefetch(self, path: str) -> int:
        """Warm one file ahead of a read cursor (the worker side of a
        prefetch task): a cached file costs one metadata probe; an
        uncached file under a mount loads from the UFS. Advisory: a file
        under no mount is skipped (0), never an error."""
        try:
            fb = await self.meta.get_block_locations(path)
            if _uncached(path, fb) is None:
                return 0               # already warm
        except err.FileNotFound:
            pass
        try:
            return await self.load_from_ufs(path)
        except err.MountNotFound:
            return 0

    async def export_to_ufs(self, path: str) -> int:
        """Write one cached file out to its mounted UFS location (the
        worker side of an export task); returns its length."""
        _mount, ufs, uri = await self._ufs_for(path)
        r = await self.open(path)
        try:
            return await ufs.write(uri, r.chunks())
        finally:
            await r.close()
