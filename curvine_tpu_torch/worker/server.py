"""The cache worker: block handlers, heartbeat, and the device tier-0.

A carve of ``curvine_tpu/worker/server.py``:

- ``worker_id_for`` (:47-48), the same id as the reference's;
- ``WorkerServer.__init__`` (:102-229): the tiers, the block store and
  the metrics, and the device tier-0, a ``MultiHbmTier`` of
  ``hbm_capacity`` bytes on ``device.local_devices()`` or on the devices
  the caller passes (CPU devices in the tests);
- ``start``/``stop`` (:241-311) with the heartbeat, block report,
  eviction and promote duties on a ``ScheduledExecutor``; with a tier-0
  and ``ici_transfer`` on, the worker joins the device domain at start
  (``gpu/ici_plane.py::register_endpoint``, its ``ici_coords``) and
  leaves it at stop;
- ``_info`` (:354-376), one HBM ``StorageInfo`` per device
  (``hbm:<id>``), and ``_cache_metrics`` (:378-419), the tier, HBM and
  ``ici.*`` keys and the registered receive pool's ``rpc.recv_*``
  (``rpc/transport.py::recv_pool().stats()``, :412-418); the server and
  the pools to the master and the peers take the ``[rpc]`` table;
- ``heartbeat_once`` (:421-531): ``export_metrics`` of the tier-0 and
  its exports advertised (``hbm_blocks``, the ``hbm_advertise_max`` most
  recent), the master's ``delete_blocks`` applied to the store and the
  tier-0,
  ``report_now``, ``draining``, and the back-off when no master answers;
  ``block_report_once`` (:533-554), ``_evict_once`` (:556-574);
- ``_promote_once`` (:576-613): the heat snapshot taken before the host
  scan halves it, at most 256 MiB pinned per cycle;
- ``_autopin_block`` (:615-676) through the port's ``promote_block``:
  under a read pin, the media crc, the put, and the hand-written K1
  kernel (``gpu/cuda_ops.py::block_checksum``) on the device copy against
  the host hash. A corrupt copy is dropped, counted as
  ``blocks.corrupt`` and reported to the master
  (REPORT_UNDER_REPLICATED_BLOCKS; ``blocks.corrupt_reported`` counts the
  reports the master took); a block deleted mid-pin is dropped again;
- the handlers (:752-768): WRITE_BLOCK (:776-925), READ_BLOCK
  (:962-1102, the file path: ``sendfile``, or ``preadv`` with a crc when
  the reader asks to ``verify``), DELETE_BLOCK, GET_BLOCK_INFO (with the
  commit crc, the shm offer and, for a block the tier-0 exports, the
  ``hbm`` offer: worker id, ICI coordinates and the export entry),
  SC_WRITE_OPEN, _COMMIT and _ABORT, SC_READ_REPORT (heat, and the warm
  advert on its reply), HBM_PIN and HBM_UNPIN; WRITE_BLOCKS_BATCH (:1103-1136): small blocks in one
  request, each committed with the checksum its sender computed
  (``crc32`` and ``algo``), which this worker checks first: a block
  whose bytes do not match it is refused (the reference commits it
  unchecked); and ICI_TRANSFER with ``_ici_land`` (:1412-1475): the
  block fetched from the named peer's tier-0 in this process, copied to
  the host, its length checked, then crc32c'd, written, committed and
  reported to the master like a TCP pull (``ici.peer_pulls``); a miss
  answers ``success: False`` and counts ``ici.tcp_fallbacks``, and the
  caller keeps its TCP rail;
- SUBMIT_TASK (:1514-1550): a load, export or prefetch task of the
  master's job manager runs in the background under ``_task_sem``
  (``task_parallelism`` at once) through a client of the port's own
  (``client/unified.py``: ``load_from_ufs``, ``export_to_ufs``,
  ``prefetch``), closed when the task ends, and is reported back with
  this worker's id (REPORT_TASK through ``_leader_call``); an
  ``ec_convert`` task (``_run_ec_convert_task``, :1552-1690) converts its
  blocks stripe by stripe (``_convert_one_stripe``): the block pulled
  whole from one of its holders and checked against its commit crc
  (``_pull_any``, ``_pull_verified``), split and encoded by the port's
  codec (``common/ec.py``, through ``csrc/gf256.cc``), the cells landed
  on their planned workers (``_place_cells``: this worker's own through
  ``_write_local_cell``, a peer's by WRITE_BLOCKS_BATCH with the
  sender's crc32c) and the stripe committed on the master
  (EC_COMMIT_STRIPE, ``_commit_stripe``); one failed stripe fails the
  task, and the stripes committed before it stay converted;
- SUBMIT_BLOCK_REPLICATION_JOB (``_replicate_block``, :1276-1410): a job
  with ``ec`` rebuilds a stripe's cell (:1282-1310, ``_reconstruct_cell``,
  :1692-1724): k sibling cells pulled and checked, the cell decoded (or
  re-encoded, for a parity cell), written under a fresh crc32c,
  committed and reported to the master. Otherwise the block
  lands over the device path first (``_ici_land``) when the master's job
  carries the ``ici`` hint and ``ici_transfer`` is on; otherwise, or on a
  miss (one ``ici.tcp_fallbacks``), it is pulled by a READ_BLOCK stream
  from the source under the job's deadline (``msg.deadline``) into a
  temp block, each chunk crc32c'd and written (``_append``), the stream
  held to the job's ``block_len`` (the file layout's counterpart of the
  reference's extent cap), and its crc checked against the source's EOF
  ``block_crc32``: a mismatch fails the job, so a corrupt source never
  spreads. Then the commit, an incremental block report, and
  REPORT_BLOCK_REPLICATION_RESULT with ``via`` (``"ici"`` or ``""``).

Where the reference falls back, this worker does not: an HBM tier asked
for on a machine without a CUDA device (and no devices passed) raises,
and a K1 kernel that cannot build or launch fails the promotion (and the
promote cycle) instead of skipping the device check.

Threads and the card: a pin's file read, host hashes, copy and K1 launch
run on a thread (``asyncio.to_thread``), with each CUDA device of the
tier on the worker's own pin stream. The tier's state is under one lock,
taken on a thread, never on the event loop: a promotion holds it over
the put and K1 only (the media crc and the host hash run outside it),
and K1's result read ends the pin, so a tensor a consumer can see is
whole. In-process consumers, on any thread, take tensors with
``hbm_get`` (a consumer on another stream that keeps a tensor past a
drop calls ``record_stream``); the device domain reaches the tier through
``hbm_get`` too, so a peer's fetch never races a promotion or a drop, and
a landing copies the block to the host before it lets the tensor go.

The shared-memory read plane (:140-165, :276-303, :402-411,
:1171-1274), on by default as in the reference (``shm_reads``): an
``ShmExporter`` of sealed memfd copies of MEM-tier blocks, a
``WarmShmCache`` for read-hot blocks of the tiers below it
(``shm_warm_cap_mb``, ``shm_warm_min_reads``), both dropped by the
store's ``on_delete`` and ``on_move`` hooks, and the SCM_RIGHTS side
channel (``worker/shm.py``), started after the RPC port and stopped
before it. GET_BLOCK_INFO offers ``shm`` and ``shm_sock`` for a
committed MEM-tier block (``_shm_servable``), with ``shm_warm`` for a
warm-servable one (``_shm_warm_servable``); the channel's thread grants
through ``_shm_grant`` (``shm.grants``, ``shm.warm_grants``) on a copy
of the block's entry taken under the store's lock; the warm cache's
stats are the ``cache.shm_warm.*`` metrics.

Tracing (:174-179, :768-774, :790-913): the worker's ``Tracer``
(``obs/trace.py``, from the ``[obs]`` table) is its RPC server's
``obs``, so each dispatch is a server span under the caller's; GET_SPANS
answers this worker's spans of one trace (the master's collect); and a
WRITE_BLOCK stream is one ``write_block_stream`` span from the request
to its EOF commit, its abort or its error (the dispatch's span ends when
the handler returns, before the chunks).

Not ported (ROADMAP A3c): the bdev layout and direct IO (refused by the
conf), scrub and the disk health machinery (every dir reports healthy),
QoS and the web server."""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import threading
import time
import types
import zlib

import numpy as np
import torch

from curvine_tpu_torch.common import ec
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.executor import ScheduledExecutor
from curvine_tpu_torch.common.metrics import MetricsRegistry
from curvine_tpu_torch.common.types import (BlockState, JobState,
                                            StorageInfo, StorageType,
                                            TaskInfo, WorkerAddress,
                                            WorkerInfo, now_ms)
from curvine_tpu_torch.gpu import ici_plane
from curvine_tpu_torch.gpu.hbm import MultiHbmTier, export_metrics
from curvine_tpu_torch.obs.trace import Tracer
from curvine_tpu_torch.rpc.client import Connection, ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import (Flags, Message, error_for, pack,
                                         response_for, unpack)
from curvine_tpu_torch.rpc.server import RpcServer, ServerConn
from curvine_tpu_torch.rpc.transport import recv_pool
from curvine_tpu_torch.worker.blockfile import (ALGO_CRC32C, crc_update,
                                                map_block, supported)
from curvine_tpu_torch.worker.promote import promote_block
from curvine_tpu_torch.worker.shm import (ShmChannel, ShmExporter,
                                          WarmShmCache, channel_path,
                                          shm_supported)
from curvine_tpu_torch.worker.storage import BlockStore, TierDir

log = logging.getLogger(__name__)

_TIER_NAMES = {"hbm": StorageType.HBM, "mem": StorageType.MEM,
               "ssd": StorageType.SSD, "hdd": StorageType.HDD}
PIN_BUDGET = 256 << 20          # device bytes pinned per promote cycle
# the cells of one WRITE_BLOCKS_BATCH request, in bytes: a request is one
# frame, at most rpc/frame.py's MAX_FRAME (64 MiB and 1 KiB); a larger
# cell goes alone
BATCH_BYTES = 32 << 20


def worker_id_for(hostname: str, port: int) -> int:
    return zlib.crc32(f"{hostname}:{port}".encode()) & 0x7FFFFFFF


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device block's bytes in new host memory. A copy into pageable
    memory returns when it is done, so the tier may drop the tensor after
    it; a CPU tier's tensor is copied too, so that the landing owns its
    bytes."""
    flat = t.detach().reshape(-1).view(torch.uint8)
    return flat.numpy().copy() if flat.device.type == "cpu" \
        else flat.cpu().numpy()


def _write_file(path: str, buf: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(memoryview(buf))


def _append(f, data) -> None:
    """One pulled chunk onto the temp block's file."""
    f.write(data)


def _integrity_header(info) -> dict:
    """The commit-time checksum riding every READ_BLOCK EOF frame."""
    if info.crc32c is None:
        return {}
    return {"block_crc32": info.crc32c, "block_crc_algo": info.crc_algo}


class WorkerServer:
    def __init__(self, conf: ClusterConf | None = None, devices=None):
        self.conf = conf or ClusterConf()
        wc = self.conf.worker
        self.rpc = RpcServer(wc.hostname, wc.rpc_port, "worker",
                             rpc_conf=self.conf.rpc)
        tiers = [TierDir(_TIER_NAMES.get(t.storage_type, StorageType.MEM),
                         t.dir, t.capacity) for t in wc.tiers]
        self.store = BlockStore(tiers, wc.eviction_high_water,
                                wc.eviction_low_water,
                                admission=wc.cache_admission,
                                ghost_entries=wc.cache_ghost_entries,
                                small_ratio=wc.cache_small_ratio)
        self.metrics = MetricsRegistry("worker")
        self.rpc.metrics = self.metrics
        # a server span per dispatch, and the spans GET_SPANS answers
        self.tracer = Tracer.from_conf("worker", self.conf.obs,
                                       metrics=self.metrics)
        self.rpc.obs = self.tracer
        # the shared-memory read plane (worker/shm.py): sealed-memfd
        # copies of MEM-tier blocks, and a warm cache of read-hot blocks
        # below it, handed to co-located clients over the side channel,
        # which start() opens (its path names the final port); a block
        # deleted or moved drops its copies
        self.shm: ShmExporter | None = None
        self.shm_warm: WarmShmCache | None = None
        self._shm_channel: ShmChannel | None = None
        if wc.shm_reads and shm_supported():
            self.shm = ShmExporter(cap=wc.shm_export_cap)
            if wc.shm_warm_cap_mb > 0:
                self.shm_warm = WarmShmCache(
                    cap_bytes=wc.shm_warm_cap_mb << 20,
                    admission=wc.cache_admission,
                    ghost_entries=wc.cache_ghost_entries)
            self.store.on_delete = self._shm_invalidate
            self.store.on_move = self._shm_invalidate
        self.master_pool = ConnectionPool(
            size=2, timeout_ms=self.conf.client.rpc_timeout_ms,
            rpc_conf=self.conf.rpc)
        # streams of replication pulls from peer workers
        self.peer_pool = ConnectionPool(
            size=2, timeout_ms=self.conf.client.rpc_timeout_ms,
            rpc_conf=self.conf.rpc)
        self.worker_id = 0             # worker_id_for(host, port) at start
        self.chunk_size = wc.io_chunk_size
        # the device tier-0, one tier per device; no CUDA device and no
        # devices passed raises (local_devices), never a silent skip
        self.hbm: MultiHbmTier | None = None
        if wc.hbm_capacity > 0:
            self.hbm = MultiHbmTier(wc.hbm_capacity, devices=devices,
                                    admission=wc.cache_admission,
                                    ghost_entries=wc.cache_ghost_entries,
                                    export_cap=wc.hbm_export_cap)
        self._hbm_lock = threading.Lock()
        # one pin stream per CUDA device of the tier, made here so that
        # pin threads only read the map
        self._pin_streams: dict[int, torch.cuda.Stream] = {
            d.index: torch.cuda.Stream(d) for d in
            (self.hbm.devices if self.hbm is not None else ())
            if d.type == "cuda"}
        self._bg: list[asyncio.Task] = []
        self.executor = ScheduledExecutor("worker")
        self._leader_idx = 0
        # heartbeat failure back-off
        self._hb_fails = 0
        self._hb_backoff_until = 0.0
        # rate limit of master-requested full block reports (report_now)
        self._forced_report_at = 0.0
        # decommission drain: new write streams are refused (retryable)
        self.draining = False
        # the master's load, export and prefetch tasks running at once
        self._task_sem = asyncio.Semaphore(wc.task_parallelism)
        self._register_handlers()

    @property
    def address(self) -> WorkerAddress:
        return WorkerAddress(
            worker_id=self.worker_id, hostname=self.conf.worker.hostname,
            ip_addr=self.conf.worker.hostname, rpc_port=self.rpc.port,
            web_port=self.conf.worker.web_port)

    @property
    def addr(self) -> str:
        return self.rpc.addr

    async def start(self) -> None:
        await self.rpc.start()
        self.worker_id = worker_id_for(self.conf.worker.hostname,
                                       self.rpc.port)
        wc = self.conf.worker
        if self.hbm is not None and wc.ici_transfer:
            # join the device domain: peers in this process pull pinned
            # blocks from the tier-0, through its lock (hbm_get)
            ici_plane.register_endpoint(
                self.worker_id, types.SimpleNamespace(get=self.hbm_get),
                wc.ici_coords)
        self.executor.submit_periodic("heartbeat", self.heartbeat_once,
                                      wc.heartbeat_ms / 1000,
                                      initial_delay_s=0.0)
        # the first full report right after the first heartbeat: the
        # master distrusts its view of this worker's blocks until then
        self.executor.submit_periodic("block-report", self.block_report_once,
                                      wc.block_report_interval_ms / 1000,
                                      initial_delay_s=1.0)
        self.executor.submit_periodic("eviction", self._evict_once, 1.0)
        if wc.promote_interval_ms > 0 and (len(self.store.tiers) > 1
                                           or self.hbm is not None):
            self.executor.submit_periodic("promote", self._promote_once,
                                          wc.promote_interval_ms / 1000)
        if self.shm is not None:
            ch = ShmChannel(channel_path(self.rpc.port), self._shm_grant)
            try:
                ch.start()
                self._shm_channel = ch
            except OSError as e:
                # no unix sockets here: the probe offers no shm, and
                # clients read through the fd path
                log.warning("shm side channel disabled: %s", e)
                self.shm = None
        log.info("worker %d started at %s", self.worker_id, self.addr)

    async def stop(self) -> None:
        if self.hbm is not None:
            ici_plane.unregister_endpoint(self.worker_id)
        await self.executor.stop()
        for t in self._bg:
            t.cancel()
        await asyncio.gather(*self._bg, return_exceptions=True)
        self._bg.clear()
        if self._shm_channel is not None:
            await asyncio.to_thread(self._shm_channel.stop)
            self._shm_channel = None
        if self.shm is not None:
            self.shm.close()
        if self.shm_warm is not None:
            self.shm_warm.close()
        await self.rpc.stop()
        await self.master_pool.close()
        await self.peer_pool.close()

    # ---------------- the device tier-0 ----------------

    def hbm_get(self, block_id: int) -> torch.Tensor | None:
        """A pinned block as a device tensor (no host copy), or None: the
        in-process consumer's accessor, safe on any thread."""
        with self._hbm_lock:
            return self.hbm.get(block_id)

    def hbm_holds(self, block_id: int) -> bool:
        """Whether the tier holds ``block_id``, without touching its
        heat; safe on any thread."""
        with self._hbm_lock:
            return block_id in self.hbm

    @contextlib.contextmanager
    def _on_pin_streams(self):
        """For each CUDA device of the tier, the worker's pin stream
        current on that device (this thread only)."""
        with contextlib.ExitStack() as stack:
            for s in self._pin_streams.values():
                stack.enter_context(torch.cuda.stream(s))
            yield

    def _hbm_drop(self, block_ids, evicted: bool = False) -> None:
        with self._hbm_lock:
            for bid in block_ids:
                self.hbm.drop(bid, evicted=evicted)
            self.metrics.gauge("hbm.used", self.hbm.used)

    def _pin_work(self, block_id: int, info) -> int:
        with self._on_pin_streams():
            n = promote_block(self.hbm, block_id, info.path, info.offset,
                              info.len, crc=info.crc32c,
                              crc_algo=info.crc_algo, lock=self._hbm_lock)
        with self._hbm_lock:
            self.metrics.gauge("hbm.used", self.hbm.used)
        return n

    def _pin_candidates(self, min_reads: int) -> list[tuple[int, int, int]]:
        """The hot blocks not yet in the tier, hottest first; a device's
        share bounds what can ever pin."""
        per_device = min(t.capacity for t in self.hbm.tiers.values())
        hot = self.store.hot_blocks(min_reads, max_len=per_device)
        with self._hbm_lock:
            return [t for t in hot if t[0] not in self.hbm]

    # ---------------- master plane ----------------

    async def _leader_call(self, code, data) -> Message:
        """Call the leader, rotating through master_addrs on NOT_LEADER
        or a failed connect."""
        addrs = self.conf.client.master_addrs
        last: Exception | None = None
        for i in range(len(addrs)):
            idx = (self._leader_idx + i) % len(addrs)
            try:
                conn = await self.master_pool.get(addrs[idx])
                rep = await conn.call(code, data=data)
                self._leader_idx = idx
                return rep
            except err.CurvineError as e:
                if e.code not in (err.ErrorCode.NOT_LEADER,
                                  err.ErrorCode.CONNECT):
                    raise
                last = e
        raise last or err.NotLeader("no reachable master")

    async def _bounded_master_call(self, addr: str, code, payload: bytes,
                                   connect_s: float, call_s: float
                                   ) -> Message:
        """The deadline covers the dial and the call; a call cut off
        mid-send poisons its connection, which is closed."""
        conn: Connection = await asyncio.wait_for(self.master_pool.get(addr),
                                                  connect_s)
        try:
            return await asyncio.wait_for(conn.call(code, data=payload),
                                          call_s)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            await conn.close()
            raise

    def _info(self) -> WorkerInfo:
        storages = self.store.storages()
        if self.hbm is not None:
            with self._hbm_lock:
                per_device = self.hbm.per_device_stats()
            # one HBM StorageInfo per device: the master sees per-device
            # capacity, not one opaque pool
            storages[:0] = [StorageInfo(
                storage_type=StorageType.HBM,
                dir_id=f"hbm:{s['device_id']}", capacity=s["capacity"],
                available=s["capacity"] - s["used"], block_num=s["blocks"])
                for s in per_device]
        return WorkerInfo(address=self.address, storages=storages,
                          last_heartbeat_ms=now_ms(),
                          ici_coords=list(self.conf.worker.ici_coords))

    def _cache_metrics(self) -> dict[str, float]:
        """Flattened ``cache.<tier>.<stat>`` counters: each storage
        type's admission policy stats (summed over its dirs) and the
        device tier-0's."""
        out: dict[str, float] = {}
        for t in self.store.tiers:
            pre = f"cache.{t.storage_type.name.lower()}."
            for k, v in t.policy.stats().items():
                if k in ("small", "main", "ghost"):
                    continue
                out[pre + k] = out.get(pre + k, 0) + v
        out["cache.store.misses"] = self.store.miss_total
        if self.hbm is not None:
            with self._hbm_lock:
                st = self.hbm.stats()
            for k in ("hits", "misses", "spills", "ghost_hits",
                      "scan_evicted"):
                out[f"cache.hbm.{k}"] = st.get(k, 0)
            # the device plane: the exports, and device-path landings
            # against misses left to the TCP rail
            out["ici.hbm_exports"] = st.get("exports", 0)
            for k in ("ici.peer_pulls", "ici.tcp_fallbacks"):
                out[k] = self.metrics.counters.get(k, 0)
        # the registered receive pool: parked bytes, checked-out bytes and
        # its counters (the ring's keys stay 0: the port has no ring)
        for k, v in recv_pool().stats().items():
            out[f"rpc.recv_{k}"] = v
        if self.shm_warm is not None:
            # the warm cache's occupancy and admission beside the tiers'
            for k, v in self.shm_warm.stats().items():
                if k in ("entries", "bytes", "exports", "hits",
                         "evictions"):
                    out[f"cache.shm_warm.{k}"] = v
                elif k in ("policy_admits", "policy_ghost_hits",
                           "policy_scan_evicted"):
                    out[f"cache.shm_warm.{k[len('policy_'):]}"] = v
        return out

    def _heartbeat_body(self) -> bytes:
        if self.hbm is not None:
            with self._hbm_lock:
                export_metrics(self.hbm, self.metrics)
        wm = {"bytes.read": self.metrics.counters.get("bytes.read", 0),
              "bytes.written": self.metrics.counters.get("bytes.written", 0)}
        cm = self._cache_metrics()
        wm.update(cm)
        for name, v in cm.items():
            self.metrics.gauge(name, v)
        body = {"info": self._info().to_wire(), "metrics": wm}
        if self.hbm is not None and self.conf.worker.ici_transfer:
            # the tier-0's most recent exports, re-sent (or cleared) every
            # beat: the master's soft state for device-path hints
            with self._hbm_lock:
                body["hbm_blocks"] = [
                    e["block_id"] for e in self.hbm.exports.snapshot(
                        limit=self.conf.worker.hbm_advertise_max)]
        return pack(body)

    def _apply_deletes(self, block_ids) -> None:
        for bid in block_ids:
            self.store.delete(bid)
        if self.hbm is not None:
            self._hbm_drop(block_ids)

    async def heartbeat_once(self) -> None:
        """Heartbeat every master (followers serve reads too); the
        master's deletes apply to the store and the tier-0. When no
        master answers: one warning, then exponential back-off, the tick
        returning at once until it lapses. The back-off stops at 60 s,
        as the reference's, and (beyond the reference) at half the
        cluster's ``worker_lost_timeout_ms``: a restarted master waits
        that long for its workers before it fails a placement (ROADMAP
        §C, C9), so a worker alive through an outage of any length
        reaches it in time."""
        if time.monotonic() < self._hb_backoff_until:
            return
        # the tier-0's state is read under its lock, on a thread
        payload = await asyncio.to_thread(self._heartbeat_body)
        deletes: set[int] = set()
        report_now = draining = False

        async def beat(addr: str) -> bool:
            nonlocal report_now, draining
            try:
                rep = await self._bounded_master_call(
                    addr, RpcCode.WORKER_HEARTBEAT, payload,
                    connect_s=3.0, call_s=5.0)
                body = unpack(rep.data) or {}
                deletes.update(body.get("delete_blocks", []))
                report_now |= bool(body.get("report_now"))
                draining |= bool(body.get("draining"))
                return True
            except Exception as e:  # noqa: BLE001 — a master down is routine
                log.debug("heartbeat to %s failed: %s", addr, e)
                return False

        oks = await asyncio.gather(*(beat(a)
                                     for a in self.conf.client.master_addrs))
        if not any(oks):
            self._hb_fails += 1
            base = self.conf.worker.heartbeat_ms / 1000.0
            cap = max(base, min(
                60.0, self.conf.master.worker_lost_timeout_ms / 2000.0))
            delay = min(base * (2 ** min(self._hb_fails, 6)), cap)
            self._hb_backoff_until = time.monotonic() + delay
            if self._hb_fails == 1:
                log.warning("no master reachable for heartbeat (%s); backing "
                            "off up to %.1fs",
                            ", ".join(self.conf.client.master_addrs), cap)
            return
        if self._hb_fails:
            log.info("master reachable again after %d failed heartbeats",
                     self._hb_fails)
        self._hb_fails = 0
        self._hb_backoff_until = 0.0
        if draining != self.draining:
            log.info("worker %d %s new write streams (decommission drain)",
                     self.worker_id, "refusing" if draining else "accepting")
            self.draining = draining
        if deletes:
            await asyncio.to_thread(self._apply_deletes, sorted(deletes))
        if report_now and time.monotonic() - self._forced_report_at >= 1.0:
            # in the background: a slow report awaited here would starve
            # the heartbeat and get this worker marked lost
            self._forced_report_at = time.monotonic()
            self._bg = [t for t in self._bg if not t.done()]
            self._bg.append(asyncio.ensure_future(self.block_report_once()))

    async def block_report_once(self) -> None:
        held, types = self.store.report()
        payload = pack({"worker_id": self.worker_id, "blocks": held,
                        "storage_types": types})
        deletes: set[int] = set()

        async def report(addr: str) -> None:
            try:
                rep = await self._bounded_master_call(
                    addr, RpcCode.WORKER_BLOCK_REPORT, payload,
                    connect_s=5.0, call_s=30.0)
                deletes.update((unpack(rep.data) or {}).get(
                    "delete_blocks", []))
            except Exception as e:  # noqa: BLE001
                log.debug("block report to %s failed: %s", addr, e)

        await asyncio.gather(*(report(a)
                               for a in self.conf.client.master_addrs))
        if deletes:
            await asyncio.to_thread(self._apply_deletes, sorted(deletes))

    async def _evict_once(self) -> None:
        dropped0 = self.store.dropped_total
        demoted0 = self.store.demoted_total
        removed = await asyncio.to_thread(self.store.maybe_evict)
        if self.hbm is not None:
            # dropped under pressure (not demoted): ghost the device copy,
            # so a re-pin of the still-hot block skips probation
            gone = [b for b in removed if not self.store.contains(b)]
            if gone:
                await asyncio.to_thread(self._hbm_drop, gone, True)
        if self.store.dropped_total > dropped0:
            self.metrics.inc("blocks.evicted",
                             self.store.dropped_total - dropped0)
        if self.store.demoted_total > demoted0:
            self.metrics.inc("blocks.demoted",
                             self.store.demoted_total - demoted0)

    async def _promote_once(self) -> None:
        """The host tiers' promotion scan and, with a tier-0, the
        auto-pin of the hottest blocks into device memory. The heat
        snapshot is taken before the host scan halves it."""
        wc = self.conf.worker
        hbm_hot: list[tuple[int, int, int]] = []
        if self.hbm is not None:
            hbm_hot = await asyncio.to_thread(self._pin_candidates,
                                              wc.promote_min_reads)
        promoted = await asyncio.to_thread(
            self.store.promote_scan, wc.promote_min_reads)
        if promoted:
            self.metrics.inc("blocks.promoted", len(promoted))
        pinned = 0
        budget = PIN_BUDGET
        for bid, _heat, _blen in hbm_hot:
            if budget <= 0:
                break
            try:
                n = await self._autopin_block(bid)
            except (err.CurvineError, OSError, ValueError) as e:
                # deleted or evicted since the snapshot, or too large for
                # a device: skip it, keep pinning colder ones
                log.debug("hbm autopin of %d skipped: %s", bid, e)
                continue
            if n:
                budget -= n
                pinned += 1
        if pinned:
            self.metrics.inc("blocks.hbm_pinned", pinned)

    async def _autopin_block(self, block_id: int) -> int:
        """Pin one committed block on the least-used device, verified
        (``promote_block``); returns the bytes pinned. The work runs on a
        thread: up to 256 MiB of IO a cycle must not stall the loop."""
        # the read pin holds the block's file in place for the whole pin
        info = self.store.pin_read(block_id, touch=False)
        try:
            if info.state != BlockState.COMMITTED:
                return 0
            try:
                n = await asyncio.to_thread(self._pin_work, block_id, info)
            except err.AbnormalData:
                # the media copy (or the device copy) is bad: promote_block
                # dropped it; count it and hand the replica to the master
                self.metrics.inc("blocks.corrupt")
                try:
                    await self._leader_call(
                        RpcCode.REPORT_UNDER_REPLICATED_BLOCKS,
                        pack({"block_ids": [block_id],
                              "worker_id": self.worker_id}))
                    self.metrics.inc("blocks.corrupt_reported")
                except Exception as e:  # noqa: BLE001 — the next pin retries
                    log.warning("promotion corrupt report failed: %s", e)
                return 0
        finally:
            self.store.unpin_read(block_id)
        if not self.store.contains(block_id):
            # deleted mid-pin: the delete's drop may have run before the
            # put landed; drop again so no device copy is orphaned
            await asyncio.to_thread(self._hbm_drop, [block_id])
            return 0
        return n

    # ---------------- handlers ----------------

    def _register_handlers(self) -> None:
        r = self.rpc.register
        r(RpcCode.WRITE_BLOCK, self._write_block)
        r(RpcCode.READ_BLOCK, self._read_block)
        r(RpcCode.DELETE_BLOCK, self._delete_block)
        r(RpcCode.GET_BLOCK_INFO, self._get_block_info)
        r(RpcCode.SC_WRITE_OPEN, self._sc_write_open)
        r(RpcCode.SC_WRITE_COMMIT, self._sc_write_commit)
        r(RpcCode.SC_WRITE_ABORT, self._sc_write_abort)
        r(RpcCode.SC_READ_REPORT, self._sc_read_report)
        r(RpcCode.HBM_PIN, self._hbm_pin)
        r(RpcCode.HBM_UNPIN, self._hbm_unpin)
        r(RpcCode.ICI_TRANSFER, self._ici_transfer)
        r(RpcCode.SUBMIT_BLOCK_REPLICATION_JOB, self._replicate_block)
        r(RpcCode.SUBMIT_TASK, self._submit_task)
        r(RpcCode.WRITE_BLOCKS_BATCH, self._write_blocks_batch)
        r(RpcCode.GET_SPANS, self._get_spans)

    async def _get_spans(self, msg: Message, conn: ServerConn):
        """This worker's spans of one trace (the master's collect)."""
        q = unpack(msg.data) or {}
        return {}, pack({"spans":
                         self.tracer.spans_for(str(q.get("trace_id", "")))})

    # ---------------- the master's tasks ----------------

    async def _submit_task(self, msg: Message, conn: ServerConn):
        """A load, export, prefetch or ec_convert task, run in the
        background; its result goes back to the master in REPORT_TASK."""
        q = unpack(msg.data) or {}
        task = TaskInfo.from_wire(q["task"])
        if task.kind not in ("load", "export", "prefetch", "ec_convert"):
            raise err.Unsupported(f"SUBMIT_TASK of kind {task.kind!r}")
        run = self._run_ec_convert_task if task.kind == "ec_convert" \
            else self._run_load_task
        # tracked so that stop() cancels a task still running
        self._bg = [t for t in self._bg if not t.done()]
        self._bg.append(asyncio.ensure_future(run(task)))
        return {"accepted": True}

    async def _run_load_task(self, task: TaskInfo) -> None:
        """UFS to cache (load; prefetch when not cached yet) or cache to
        UFS (export), through a client of the port's own, closed when the
        task ends."""
        from curvine_tpu_torch.client.unified import CurvineClient
        async with self._task_sem:
            client = CurvineClient(self.conf)
            try:
                if task.kind == "export":
                    n = await client.export_to_ufs(task.path)
                elif task.kind == "prefetch":
                    n = await client.prefetch(task.path)
                else:
                    n = await client.load_from_ufs(task.path)
                task.state = JobState.COMPLETED
                task.loaded_len = n
            except Exception as e:  # noqa: BLE001 — reported to the master
                task.state = JobState.FAILED
                task.message = str(e)
                log.warning("%s task %s failed: %s", task.kind, task.task_id,
                            e)
            finally:
                await self._report_task(task)
                await client.close()

    async def _report_task(self, task: TaskInfo) -> None:
        task.worker_id = self.worker_id
        try:
            await self._leader_call(RpcCode.REPORT_TASK,
                                    pack({"task": task.to_wire()}))
        except Exception as e:  # noqa: BLE001
            log.warning("task report failed: %s", e)

    # ---------------- erasure coding ----------------

    async def _pull_verified(self, src: WorkerAddress, block_id: int,
                             deadline=None) -> bytes:
        """One whole block (or cell) from a peer into memory, checked
        against the commit crc on its EOF frame. In memory on purpose:
        every caller needs the whole cell for the codec."""
        peer = await self.peer_pool.get(
            f"{src.ip_addr or src.hostname}:{src.rpc_port}")
        chunks: list[bytes] = []
        src_crc = src_algo = None
        async for m in peer.call_stream(
                RpcCode.READ_BLOCK, header={"block_id": block_id},
                deadline=deadline):
            if len(m.data):
                chunks.append(bytes(m.data))
            if m.is_eof:
                h = m.header or {}
                src_crc = h.get("block_crc32")
                src_algo = h.get("block_crc_algo")
        data = b"".join(chunks)
        if src_crc is not None and supported(src_algo):
            if await asyncio.to_thread(crc_update, src_algo, data) != src_crc:
                raise err.AbnormalData(
                    f"pull of block {block_id} from worker "
                    f"{src.worker_id} failed its checksum")
        return data

    async def _pull_any(self, sources: list[dict], block_id: int,
                        deadline=None) -> bytes:
        """The block from the first of ``sources`` that serves it whole."""
        last: Exception | None = None
        for wire in sources:
            try:
                return await self._pull_verified(
                    WorkerAddress.from_wire(wire), block_id,
                    deadline=deadline)
            except Exception as e:  # noqa: BLE001 — the next holder
                last = e
        raise last or err.BlockNotFound(
            f"no servable source for block {block_id}")

    def _write_local_cell(self, cell_id: int, data) -> int:
        """Commit one stripe cell into the local store under a fresh
        crc32c; returns its tier's storage type."""
        buf = np.frombuffer(data, dtype=np.uint8)
        info = self.store.create_temp(cell_id, size_hint=buf.nbytes)
        try:
            crc = crc_update(ALGO_CRC32C, buf)
            _write_file(info.path, buf)
            self.store.commit(cell_id, buf.nbytes, checksum=crc,
                              checksum_algo=ALGO_CRC32C)
        except Exception:
            self.store.delete(cell_id)
            raise
        return int(info.tier.storage_type)

    async def _place_cells(self, placed: dict) -> list[dict]:
        """Land encoded cells on their workers: this worker's commit
        here, a peer's ride WRITE_BLOCKS_BATCH with the crc32c computed
        here, so every cell commits checked. ``placed``: (worker id,
        port) -> (address, [(cell id, bytes), ...]). Returns the cells'
        entries for EC_COMMIT_STRIPE."""
        out = []
        for addr, cells in placed.values():
            if addr.worker_id == self.worker_id:
                for cid, data in cells:
                    st = await asyncio.to_thread(
                        self._write_local_cell, cid, data)
                    out.append({"block_id": cid,
                                "worker_id": self.worker_id,
                                "storage_type": st})
                continue
            peer = await self.peer_pool.get(
                f"{addr.ip_addr or addr.hostname}:{addr.rpc_port}")
            batches: list[list] = [[]]
            size = 0
            for cid, data in cells:
                if batches[-1] and size + len(data) > BATCH_BYTES:
                    batches.append([])
                    size = 0
                batches[-1].append((cid, data))
                size += len(data)
            for batch in batches:
                blocks = []
                for cid, data in batch:
                    crc = await asyncio.to_thread(crc_update, ALGO_CRC32C,
                                                  data)
                    blocks.append({"block_id": cid, "data": data,
                                   "crc32": crc, "algo": ALGO_CRC32C})
                rep = await peer.call(RpcCode.WRITE_BLOCKS_BATCH,
                                      data=pack({"blocks": blocks}))
                for r in (unpack(rep.data) or {}).get("results", []):
                    out.append({"block_id": r["block_id"],
                                "worker_id": r["worker_id"],
                                "storage_type": r.get("storage_type", 1)})
        return out

    async def _commit_stripe(self, block_id: int, entries: list[dict]) -> None:
        """EC_COMMIT_STRIPE: the master switches the block's reads to
        its cells and retires its replicas."""
        await self._leader_call(RpcCode.EC_COMMIT_STRIPE, pack({
            "block_id": block_id, "cells": entries}))

    async def _convert_one_stripe(self, prof: ec.ECProfile,
                                  plan: dict) -> None:
        block_id = plan["block_id"]
        data = await self._pull_any(plan["sources"], block_id)
        if len(data) != plan["block_len"]:
            raise err.AbnormalData(
                f"block {block_id}: pulled {len(data)}B, expected "
                f"{plan['block_len']}B")
        cells, _ = await asyncio.to_thread(ec.split, data, prof.k,
                                           plan["cell_size"])
        parity = await asyncio.to_thread(ec.encode, prof, cells)
        coded = cells + parity
        placed: dict = {}
        for c in plan["cells"]:
            addr = WorkerAddress.from_wire(c["addr"])
            placed.setdefault((addr.worker_id, addr.rpc_port),
                              (addr, []))[1].append(
                (c["block_id"], memoryview(coded[c["index"]])))
        entries = await self._place_cells(placed)
        await self._commit_stripe(block_id, entries)

    async def _run_ec_convert_task(self, task: TaskInfo) -> None:
        """Stripe a file's replicated blocks, one stripe at a time. One
        failed stripe fails the task (a resubmitted job re-plans what is
        left); the stripes committed before it stay converted."""
        async with self._task_sem:
            payload = task.payload or {}
            done = 0
            try:
                prof = ec.ECProfile.parse(payload.get("profile", ""))
                for plan in payload.get("blocks", []):
                    await self._convert_one_stripe(prof, plan)
                    done += 1
                task.state = JobState.COMPLETED
            except Exception as e:  # noqa: BLE001 — reported to the master
                task.state = JobState.FAILED
                task.message = str(e)
                log.warning("ec_convert task %s failed after %d stripes: %s",
                            task.task_id, done, e)
            task.loaded_len = done
            await self._report_task(task)

    async def _reconstruct_cell(self, ecq: dict, cell_id: int) -> None:
        """Rebuild one stripe cell from k sibling cells (decode, or
        re-encode for a parity cell) and commit it here under a fresh
        crc32c."""
        prof = ec.ECProfile.parse(ecq["profile"])
        cell_size = ecq["cell_size"]
        slots: list[bytes | None] = [None] * (prof.k + prof.m)
        got = 0
        for src in ecq["sources"]:
            if got >= prof.k:
                break
            try:
                b = await self._pull_verified(
                    WorkerAddress.from_wire(src["addr"]), src["block_id"])
            except Exception as e:  # noqa: BLE001 — a source died mid-heal
                log.debug("cell source %d unavailable: %s",
                          src["block_id"], e)
                continue
            if len(b) != cell_size:
                continue             # a partial or stale copy: not decoded
            slots[src["index"]] = b
            got += 1
        if got < prof.k:
            raise err.BlockNotFound(
                f"cell {cell_id}: only {got}/{prof.k} sibling cells "
                f"readable")
        idx = ecq["cell_index"]
        rebuilt = await asyncio.to_thread(ec.reconstruct, prof, slots, [idx])
        await asyncio.to_thread(self._write_local_cell, cell_id, rebuilt[idx])

    async def _write_blocks_batch(self, msg: Message, conn: ServerConn):
        """Small blocks in one request, {"blocks": [{block_id,
        storage_type, data, crc32, algo}]}: each is checked against the
        checksum its sender computed, written and committed with it.
        The results ride the reply's data."""
        q = unpack(msg.data) or {}
        results = []
        for b in q.get("blocks", []):
            data = b["data"]
            bid = b["block_id"]
            info = self.store.create_temp(
                bid, StorageType(b.get("storage_type", int(StorageType.MEM))),
                len(data))
            try:
                want = b.get("crc32")
                algo = b.get("algo", "crc32")
                crc = None
                if want is not None and supported(algo):
                    crc = await asyncio.to_thread(crc_update, algo, data)
                    if crc != want:
                        raise err.AbnormalData(
                            f"block {bid} crc mismatch: {crc:#x} != "
                            f"{want:#x}")
                await asyncio.to_thread(_write_file, info.path,
                                        np.frombuffer(data, dtype=np.uint8))
                await asyncio.to_thread(self.store.commit, bid, len(data),
                                        checksum=crc, checksum_algo=algo)
                results.append({"block_id": bid, "len": len(data),
                                "worker_id": self.worker_id,
                                "storage_type": int(info.tier.storage_type)})
            except Exception:
                self.store.delete(bid)
                raise
        self.metrics.inc("bytes.written", sum(r["len"] for r in results))
        return {}, pack({"results": results})

    async def _write_block(self, msg: Message, conn: ServerConn):
        """Chunked upload: the request header {block_id, storage_type,
        len_hint, algo}, then CHUNK frames, then EOF {crc32}. Each chunk
        is hashed and written inline as it arrives, the reference's
        one-core path: nothing awaits between two chunks, so a replay of
        queued chunks and the receive loop cannot interleave them."""
        q = unpack(msg.data) or msg.header
        block_id = q["block_id"]
        if self.draining:
            raise err.WorkerDraining(
                f"worker {self.worker_id} is draining; "
                f"re-place block {block_id}")
        hint = StorageType(q.get("storage_type", int(StorageType.MEM)))
        # the dispatch's span ends when this handler returns, before the
        # chunks: this one, ended by hand, covers the stream
        wspan = self.tracer.span("write_block_stream", parent=msg.trace,
                                 attrs={"block_id": block_id})
        try:
            info = self.store.create_temp(block_id, hint,
                                          q.get("len_hint", 0))
        except Exception as e:
            wspan.error(e).finish()
            raise
        try:
            f = open(info.path, "wb")
        except OSError as e:
            self.store.delete(block_id)
            wspan.error(e).finish()
            raise
        # the commit checksum's algorithm is the client's choice (it
        # streams the same hash for the wire check)
        algo = q.get("algo", "crc32")
        if not supported(algo):
            algo = "crc32"
        state = {"crc": 0, "total": 0}

        def hash_write(data) -> None:
            state["crc"] = crc_update(algo, data, state["crc"])
            f.write(data)

        async def sink(header: dict, view: memoryview, is_eof: bool) -> None:
            try:
                if len(view):
                    state["total"] += len(view)
                    hash_write(view)
                if not is_eof:
                    return
                conn.close_stream(msg.req_id)
                f.close()
                if header.get("abort"):
                    # the client superseded this upload: drop the temp
                    # block now; no ack, the client stopped listening
                    self.store.delete(block_id)
                    wspan.set_attr("aborted", True)
                    wspan.finish()
                    return
                want = header.get("crc32")
                if want is not None and header.get("algo", algo) == algo \
                        and want != state["crc"]:
                    raise err.AbnormalData(
                        f"block {block_id} crc mismatch: "
                        f"{state['crc']:#x} != {want:#x}")
                await asyncio.to_thread(
                    self.store.commit, block_id, state["total"],
                    checksum=state["crc"], checksum_algo=algo)
                self.metrics.inc("bytes.written", state["total"])
                wspan.set_attr("bytes", state["total"])
                wspan.finish()
                await conn.send(response_for(msg, header={
                    "block_id": block_id, "len": state["total"],
                    "crc32": state["crc"], "worker_id": self.worker_id},
                    flags=Flags.RESPONSE | Flags.EOF))
            except Exception as e:  # noqa: BLE001 — surface to the client
                wspan.error(e).finish()
                conn.close_stream(msg.req_id)
                f.close()
                self.store.delete(block_id)
                await conn.send(error_for(msg, e))

        conn.set_stream_sink(msg.req_id, sink)
        return None                # the sink replies at EOF

    async def _sc_write_open(self, msg: Message, conn: ServerConn):
        """Short-circuit write grant: a co-located client writes the temp
        block file itself and commits it with SC_WRITE_COMMIT."""
        q = unpack(msg.data) or {}
        if self.draining:
            raise err.WorkerDraining(
                f"worker {self.worker_id} is draining; "
                f"re-place block {q['block_id']}")
        info = self.store.create_temp(
            q["block_id"], StorageType(q.get("storage_type",
                                             int(StorageType.MEM))),
            q.get("len_hint", 0))
        return {}, pack({"path": info.path, "worker_id": self.worker_id})

    async def _sc_write_commit(self, msg: Message, conn: ServerConn):
        q = unpack(msg.data) or {}
        info = await asyncio.to_thread(
            self.store.commit, q["block_id"], q["len"],
            checksum=q.get("crc32"), checksum_algo=q.get("algo", "crc32"))
        self.metrics.inc("bytes.written", info.len)
        return {}, pack({"block_id": info.block_id, "len": info.len,
                         "worker_id": self.worker_id})

    async def _sc_write_abort(self, msg: Message, conn: ServerConn):
        q = unpack(msg.data) or {}
        self.store.delete(q["block_id"])
        return {}, pack({})

    async def _read_block(self, msg: Message, conn: ServerConn):
        """Streaming download. Request {block_id, offset, len, chunk_size,
        verify}. Chunks leave by ``sendfile`` (the bytes never enter this
        process; the commit crc rides the EOF frame for the client's own
        check), or, when the reader asks to ``verify``, are read into one
        reusable buffer and crc32'd on the way."""
        q = unpack(msg.data) or msg.header
        # the read pin: the block is not moved or evicted under the stream
        info = self.store.pin_read(q["block_id"])
        try:
            offset = q.get("offset", 0)
            length = q.get("len", -1)
            chunk_size = q.get("chunk_size", self.chunk_size)
            end = info.len if length < 0 else min(info.len, offset + length)
            if not q.get("verify", False):
                with open(info.path, "rb") as f:
                    pos = offset
                    while pos < end:
                        pos += await conn.send_chunk_from_file(
                            msg.code, msg.req_id, f, pos,
                            min(chunk_size, end - pos))
                header = {"len": pos - offset}
            else:
                inline_io = info.tier.storage_type <= StorageType.MEM
                buf = np.empty(min(chunk_size, max(1, end - offset)),
                               dtype=np.uint8)
                fd = os.open(info.path, os.O_RDONLY)
                try:
                    crc = 0
                    pos = offset
                    while pos < end:
                        view = memoryview(buf[:min(chunk_size, end - pos)])
                        got = os.preadv(fd, [view], pos) if inline_io else \
                            await asyncio.to_thread(os.preadv, fd, [view],
                                                    pos)
                        if got <= 0:
                            break
                        view = view[:got]
                        crc = zlib.crc32(view, crc)
                        pos += got
                        # sock_sendall returns once the kernel took the
                        # bytes, so the buffer can be reused after it
                        await conn.send(response_for(
                            msg, data=view,
                            flags=Flags.RESPONSE | Flags.CHUNK))
                finally:
                    os.close(fd)
                header = {"crc32": crc, "len": pos - offset}
            header.update(_integrity_header(info))
            await conn.send(response_for(msg, header=header,
                                         flags=Flags.RESPONSE | Flags.EOF))
            self.metrics.inc("bytes.read", pos - offset)
            return None
        finally:
            self.store.unpin_read(q["block_id"])

    async def _delete_block(self, msg: Message, conn: ServerConn):
        q = unpack(msg.data) or {}
        await asyncio.to_thread(self._apply_deletes, [q["block_id"]])
        return {}

    async def _get_block_info(self, msg: Message, conn: ServerConn):
        """The block's length, tier, file path (for a short-circuit
        reader) and commit-time crc."""
        q = unpack(msg.data) or {}
        info, lease_ms = self.store.grant_sc(q["block_id"])
        rep = {"block_id": info.block_id, "len": info.len,
               "storage_type": int(info.tier.storage_type),
               "path": os.path.abspath(info.path),
               "offset": info.offset}
        if lease_ms:
            rep["lease_ms"] = lease_ms
        if info.crc32c is not None:
            rep["crc32"] = info.crc32c
            rep["crc_algo"] = info.crc_algo
        if self._shm_servable(info):
            # the shm offer: a client that knows the plane fetches the
            # sealed memfd over the side channel; others ignore the flags
            rep["shm"] = True
            rep["shm_sock"] = self._shm_channel.path
        elif self._shm_warm_servable(info):
            # a read-hot block below mem, over the same channel; shm_warm
            # lets the client count it to the warm plane
            rep["shm"] = True
            rep["shm_warm"] = True
            rep["shm_sock"] = self._shm_channel.path
        if self.hbm is not None and self.conf.worker.ici_transfer:
            e = await asyncio.to_thread(self._hbm_export, q["block_id"])
            if e is not None:
                # the tier-0 holds it: a consumer in the device domain can
                # take the device tensor from this worker instead of bytes
                rep["hbm"] = {"worker_id": self.worker_id,
                              "ici_coords": list(
                                  self.conf.worker.ici_coords or []),
                              **e}
        return rep

    def _hbm_export(self, block_id: int) -> dict | None:
        with self._hbm_lock:
            return self.hbm.exports.get(block_id)

    async def _sc_read_report(self, msg: Message, conn: ServerConn):
        """A short-circuit client's per-block read counts: the store sees
        only its probe, so heat follows the reads through these. The
        reply names the blocks that have just become warm-servable, with
        the channel's path: the reporting client's probe came before the
        heat, and it maps the warm copy at its next read."""
        q = unpack(msg.data) or {}
        warm: dict[int, str] = {}
        for bid, reads in (q.get("block_reads") or {}).items():
            bid = int(bid)
            self.store.touch_reads(bid, int(reads))
            if self.shm_warm is not None:
                try:
                    info = self.store.get(bid, touch=False)
                except err.CurvineError:
                    continue
                if self._shm_warm_servable(info):
                    warm[bid] = self._shm_channel.path
        return {"shm_warm": warm} if warm else {}

    # ---------------- the shared-memory read plane ----------------

    def _shm_servable(self, info) -> bool:
        """Committed MEM-tier blocks: a disk tier's would double its page
        cache into anonymous memory for no gain (the warm cache takes the
        read-hot ones)."""
        return (self.shm is not None and self._shm_channel is not None
                and info.state == BlockState.COMMITTED
                and info.tier.storage_type == StorageType.MEM)

    def _shm_warm_servable(self, info) -> bool:
        """A committed block below the MEM tier whose heat crossed
        ``shm_warm_min_reads`` and that fits the warm cache."""
        warm = self.shm_warm
        return (warm is not None and self._shm_channel is not None
                and info.state == BlockState.COMMITTED
                and int(info.tier.storage_type) > int(StorageType.MEM)
                and info.heat >= self.conf.worker.shm_warm_min_reads
                and info.len <= warm.cap_bytes)

    def _shm_invalidate(self, block_id: int) -> None:
        """The store's on_delete and on_move hook (under its lock): both
        copies of the block dropped; it must not re-enter the store."""
        if self.shm is not None:
            self.shm.invalidate(block_id)
        if self.shm_warm is not None:
            self.shm_warm.invalidate(block_id)

    def _shm_grant(self, block_id: int) -> tuple[int, int]:
        """The side channel's policy (on its thread): the block looked up
        (a copy of its entry, taken under the store's lock, so that a
        concurrent move cannot tear it), gated by tier, and exported as a
        sealed memfd by the MEM exporter or the warm cache. LookupError
        answers NOT_FOUND, and the client reads through the fd path."""
        try:
            info = self.store.get_copy(block_id)
        except err.CurvineError:
            raise LookupError(f"block {block_id}") from None
        if self._shm_servable(info):
            fd, length = self.shm.export(block_id, info.path, info.len)
            self.metrics.inc("shm.grants")
            return fd, length
        if self._shm_warm_servable(info):
            fd, length = self.shm_warm.export(block_id, info.path,
                                              info.len)
            self.metrics.inc("shm.warm_grants")
            return fd, length
        raise LookupError(f"block {block_id} not shm-servable")

    def _hbm_pin_work(self, block_id: int, info, device_id,
                      replicas: int) -> tuple[int, list[int], dict]:
        buf = np.empty(info.len, dtype=np.uint8)
        fd = os.open(info.path, os.O_RDONLY)
        try:
            os.preadv(fd, [memoryview(buf)], info.offset)
        finally:
            os.close(fd)
        with self._on_pin_streams(), self._hbm_lock:
            if replicas > 1:
                arr = self.hbm.put_replicated(block_id, buf, replicas)[0]
            else:
                arr = self.hbm.put(block_id, buf, device_id)
            for s in self._pin_streams.values():
                s.synchronize()      # whole before a consumer can see it
            self.metrics.gauge("hbm.used", self.hbm.used)
            return int(arr.nbytes), self.hbm.holders(block_id), \
                self.hbm.stats()

    async def _hbm_pin(self, msg: Message, conn: ServerConn):
        """Pin a cached block into the device tier-0; in-process
        consumers then take it as a device tensor (``hbm_get``)."""
        q = unpack(msg.data) or {}
        if self.hbm is None:
            raise err.Unsupported("hbm tier not enabled on this worker")
        block_id = q["block_id"]
        info = self.store.get(block_id)
        nbytes, holders, stats = await asyncio.to_thread(
            self._hbm_pin_work, block_id, info, q.get("device_id"),
            q.get("replicas", 1))
        return {"block_id": block_id, "len": nbytes, "holders": holders,
                "hbm": stats}

    async def _hbm_unpin(self, msg: Message, conn: ServerConn):
        q = unpack(msg.data) or {}
        if self.hbm is not None:
            await asyncio.to_thread(self._hbm_drop, [q["block_id"]])
        return {}

    async def _ici_land(self, block_id: int, hint: dict,
                        block_len: int) -> bool:
        """Land one replica over the device path: the peer's pinned
        tensor fetched through the device domain (``gpu/ici_plane.py``),
        copied to the host, and committed as a TCP pull's bytes are: the
        crc32c of the landed bytes, the write, the commit and an
        incremental block report. False (the peer not reachable this way,
        the block gone from its tier, a length that no longer matches)
        asks for the TCP fallback; only a local landing fault raises."""
        arr = await asyncio.to_thread(ici_plane.fetch_device_block,
                                      int(hint.get("worker_id", -1)),
                                      block_id)
        if arr is None:
            return False
        buf = await asyncio.to_thread(_to_host, arr)
        del arr
        if block_len and buf.nbytes != block_len:
            return False        # the advertisement outlived the block
        info = self.store.create_temp(block_id, size_hint=buf.nbytes)
        crc = await asyncio.to_thread(crc_update, "crc32c", buf)
        await asyncio.to_thread(_write_file, info.path, buf)
        await asyncio.to_thread(self.store.commit, block_id, buf.nbytes,
                                checksum=crc, checksum_algo="crc32c")
        await self._leader_call(RpcCode.WORKER_BLOCK_REPORT, pack({
            "worker_id": self.worker_id,
            "blocks": {block_id: buf.nbytes},
            "storage_types": {block_id: int(info.tier.storage_type)},
            "incremental": True}))
        return True

    async def _ici_transfer(self, msg: Message, conn: ServerConn):
        """ICI_TRANSFER: land ``block_id`` from the tier-0 of the worker
        ``source_worker_id`` over the device path. A miss answers
        ``success: False`` without raising, and the caller keeps its TCP
        rail."""
        q = unpack(msg.data) or {}
        block_id = q["block_id"]
        if self.store.contains(block_id):
            return {"success": True, "via": "local"}
        if not self.conf.worker.ici_transfer:
            return {"success": False, "via": "",
                    "message": "ici transfer disabled"}
        if await self._try_ici_land(block_id, q.get("source_worker_id", -1),
                                    q.get("block_len", 0)):
            return {"success": True, "via": "ici"}
        return {"success": False, "via": ""}

    async def _try_ici_land(self, block_id: int, source_worker_id: int,
                            block_len: int) -> bool:
        """``_ici_land`` from the worker ``source_worker_id``, counted as
        ``ici.peer_pulls`` or, on a miss or a fault (its temp block
        dropped), ``ici.tcp_fallbacks``: the caller's TCP rail takes
        over."""
        landed = False
        try:
            landed = await self._ici_land(
                block_id, {"worker_id": source_worker_id}, block_len)
        except Exception as e:  # noqa: BLE001 — the TCP rail takes over
            log.debug("ici landing of block %d failed: %s", block_id, e)
            self.store.delete(block_id)
        self.metrics.inc("ici.peer_pulls" if landed else "ici.tcp_fallbacks")
        return landed

    async def _replicate_block(self, msg: Message, conn: ServerConn):
        """SUBMIT_BLOCK_REPLICATION_JOB: land a replica of ``block_id``
        here, from the source's tier-0 over the device path when the job
        carries the ``ici`` hint, else (or on a miss) by a READ_BLOCK
        stream from the source; then report the result to the master."""
        q = unpack(msg.data) or {}
        block_id = q["block_id"]
        if q.get("ec") is not None:
            return await self._rebuild_cell(block_id, q["ec"])
        src = WorkerAddress.from_wire(q["source"])
        ok, message, via = True, "", ""
        try:
            ici = q.get("ici")
            if not self.store.contains(block_id) and ici is not None \
                    and self.conf.worker.ici_transfer \
                    and await self._try_ici_land(
                        block_id, ici.get("worker_id", -1),
                        q.get("block_len", 0)):
                via = "ici"
            if not self.store.contains(block_id):
                await self._tcp_pull(block_id, src, q.get("block_len", 0),
                                     msg.deadline)
        except Exception as e:  # noqa: BLE001 — reported to the master
            ok, message = False, str(e)
            self.store.delete(block_id)
        try:
            await self._leader_call(
                RpcCode.REPORT_BLOCK_REPLICATION_RESULT,
                pack({"block_id": block_id, "worker_id": self.worker_id,
                      "success": ok, "message": message, "via": via}))
        except Exception as e:  # noqa: BLE001 — the scan retries
            log.warning("replication result report failed: %s", e)
        return {"success": ok, "message": message, "via": via}

    async def _rebuild_cell(self, cell_id: int, ecq: dict) -> dict:
        """A stripe cell's rebuild job: decoded from its siblings (there
        may be no copy to pull), reported to the master like a pull."""
        ok, message = True, ""
        try:
            if not self.store.contains(cell_id):
                await self._reconstruct_cell(ecq, cell_id)
                info = self.store.get(cell_id, touch=False)
                await self._leader_call(RpcCode.WORKER_BLOCK_REPORT, pack({
                    "worker_id": self.worker_id,
                    "blocks": {cell_id: ecq["cell_size"]},
                    "storage_types": {cell_id: int(info.tier.storage_type)},
                    "incremental": True}))
        except Exception as e:  # noqa: BLE001 — reported to the master
            ok, message = False, str(e)
            self.store.delete(cell_id)
        try:
            await self._leader_call(
                RpcCode.REPORT_BLOCK_REPLICATION_RESULT,
                pack({"block_id": cell_id, "worker_id": self.worker_id,
                      "success": ok, "message": message}))
        except Exception as e:  # noqa: BLE001 — the scan retries
            log.warning("rebuild result report failed: %s", e)
        return {"success": ok, "message": message}

    async def _tcp_pull(self, block_id: int, src: WorkerAddress,
                        block_len: int, deadline) -> None:
        """The block streamed from ``src`` by READ_BLOCK into a temp
        block, crc32c'd as it lands, checked against the source's commit
        crc, committed and reported to the master."""
        peer = await self.peer_pool.get(
            f"{src.ip_addr or src.hostname}:{src.rpc_port}")
        info = self.store.create_temp(block_id, size_hint=block_len)
        total = crc = 0
        src_crc = src_algo = None
        f = await asyncio.to_thread(open, info.path, "wb")
        try:
            async for m in peer.call_stream(
                    RpcCode.READ_BLOCK, header={"block_id": block_id},
                    deadline=deadline):
                if len(m.data):
                    total += len(m.data)
                    if block_len and total > block_len:
                        raise err.CapacityExceeded(
                            f"replica {block_id} exceeds its "
                            f"{block_len}B length")
                    crc = crc_update(ALGO_CRC32C, m.data, crc)
                    await asyncio.to_thread(_append, f, m.data)
                if m.is_eof:
                    h = m.header or {}
                    src_crc = h.get("block_crc32")
                    src_algo = h.get("block_crc_algo")
        finally:
            await asyncio.to_thread(f.close)
        if src_crc is not None:
            got = crc if src_algo == ALGO_CRC32C else (
                crc_update(src_algo, map_block(info.path, 0, total))
                if supported(src_algo) else None)
            if got is not None and got != src_crc:
                # the source's replica (or the wire) is bad: healing must
                # never spread it
                raise err.AbnormalData(
                    f"replica pull of {block_id} checksum mismatch (got "
                    f"{got:#010x} want {src_crc:#010x})")
        await asyncio.to_thread(self.store.commit, block_id, total,
                                checksum=crc, checksum_algo=ALGO_CRC32C)
        await self._leader_call(RpcCode.WORKER_BLOCK_REPORT, pack({
            "worker_id": self.worker_id,
            "blocks": {block_id: total},
            "storage_types": {block_id: int(info.tier.storage_type)},
            "incremental": True}))
