"""The cache worker: block handlers, heartbeat, and the device tier-0.

A carve of ``curvine_tpu/worker/server.py``:

- ``worker_id_for`` (:47-48), the same id as the reference's;
- ``WorkerServer.__init__`` (:102-229): the tiers, the block store and
  the metrics, and the device tier-0, a ``MultiHbmTier`` of
  ``hbm_capacity`` bytes on ``device.local_devices()`` or on the devices
  the caller passes (CPU devices in the tests);
- ``start``/``stop`` (:241-311) with the heartbeat, block report,
  eviction and promote duties on a ``ScheduledExecutor``;
- ``_info`` (:354-376), one HBM ``StorageInfo`` per device
  (``hbm:<id>``), and ``_cache_metrics`` (:378-419), the tier and HBM
  keys;
- ``heartbeat_once`` (:421-531): ``export_metrics`` of the tier-0, the
  master's ``delete_blocks`` applied to the store and the tier-0,
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
  commit crc, never an shm or ``hbm`` offer), SC_WRITE_OPEN, _COMMIT and
  _ABORT, SC_READ_REPORT (heat only), HBM_PIN and HBM_UNPIN; and
  ICI_TRANSFER, which answers as the reference's worker does with
  ``ici_transfer`` off: ``success: False``.

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
drop calls ``record_stream``).

Not ported (ROADMAP A3c): the bdev layout and direct IO (refused by the
conf), the shared-memory channel (never offered), scrub and the disk
health machinery (every dir reports healthy), the master's replication
jobs and its load, prefetch and EC tasks and WRITE_BLOCKS_BATCH (each
refused by name with UNSUPPORTED), QoS, tracing, the web server, and
``_ici_land`` (A10)."""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import threading
import time
import zlib

import numpy as np
import torch

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import ClusterConf
from curvine_tpu_torch.common.executor import ScheduledExecutor
from curvine_tpu_torch.common.metrics import MetricsRegistry
from curvine_tpu_torch.common.types import (BlockState, StorageInfo,
                                            StorageType, WorkerAddress,
                                            WorkerInfo, now_ms)
from curvine_tpu_torch.gpu.hbm import MultiHbmTier, export_metrics
from curvine_tpu_torch.rpc.client import Connection, ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import (Flags, Message, error_for, pack,
                                         response_for, unpack)
from curvine_tpu_torch.rpc.server import RpcServer, ServerConn
from curvine_tpu_torch.worker.blockfile import crc_update, supported
from curvine_tpu_torch.worker.promote import promote_block
from curvine_tpu_torch.worker.storage import BlockStore, TierDir

log = logging.getLogger(__name__)

_TIER_NAMES = {"hbm": StorageType.HBM, "mem": StorageType.MEM,
               "ssd": StorageType.SSD, "hdd": StorageType.HDD}
PIN_BUDGET = 256 << 20          # device bytes pinned per promote cycle


def worker_id_for(hostname: str, port: int) -> int:
    return zlib.crc32(f"{hostname}:{port}".encode()) & 0x7FFFFFFF


def _integrity_header(info) -> dict:
    """The commit-time checksum riding every READ_BLOCK EOF frame."""
    if info.crc32c is None:
        return {}
    return {"block_crc32": info.crc32c, "block_crc_algo": info.crc_algo}


class WorkerServer:
    def __init__(self, conf: ClusterConf | None = None, devices=None):
        self.conf = conf or ClusterConf()
        wc = self.conf.worker
        self.rpc = RpcServer(wc.hostname, wc.rpc_port, "worker")
        tiers = [TierDir(_TIER_NAMES.get(t.storage_type, StorageType.MEM),
                         t.dir, t.capacity) for t in wc.tiers]
        self.store = BlockStore(tiers, wc.eviction_high_water,
                                wc.eviction_low_water,
                                admission=wc.cache_admission,
                                ghost_entries=wc.cache_ghost_entries,
                                small_ratio=wc.cache_small_ratio)
        self.metrics = MetricsRegistry("worker")
        self.rpc.metrics = self.metrics
        self.master_pool = ConnectionPool(
            size=2, timeout_ms=self.conf.client.rpc_timeout_ms)
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
        log.info("worker %d started at %s", self.worker_id, self.addr)

    async def stop(self) -> None:
        await self.executor.stop()
        for t in self._bg:
            t.cancel()
        await asyncio.gather(*self._bg, return_exceptions=True)
        self._bg.clear()
        await self.rpc.stop()
        await self.master_pool.close()

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
        return pack({"info": self._info().to_wire(), "metrics": wm})

    def _apply_deletes(self, block_ids) -> None:
        for bid in block_ids:
            self.store.delete(bid)
        if self.hbm is not None:
            self._hbm_drop(block_ids)

    async def heartbeat_once(self) -> None:
        """Heartbeat every master (followers serve reads too); the
        master's deletes apply to the store and the tier-0. When no
        master answers: one warning, then exponential back-off up to
        60 s, the tick returning at once until it lapses."""
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
            delay = min(base * (2 ** min(self._hb_fails, 6)), 60.0)
            self._hb_backoff_until = time.monotonic() + delay
            if self._hb_fails == 1:
                log.warning("no master reachable for heartbeat (%s); backing "
                            "off up to 60s",
                            ", ".join(self.conf.client.master_addrs))
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
        for code in (RpcCode.SUBMIT_TASK, RpcCode.SUBMIT_BLOCK_REPLICATION_JOB,
                     RpcCode.WRITE_BLOCKS_BATCH):
            r(code, self._not_ported)

    async def _not_ported(self, msg: Message, conn: ServerConn):
        """The master's load, prefetch and EC tasks, its replication
        pulls, and batched small-file writes are refused by name: the
        master marks the task or job failed, a writer sees the error."""
        raise err.Unsupported(f"{RpcCode(msg.code).name} is not ported to "
                              f"this worker (ROADMAP A3c)")

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
        info = self.store.create_temp(block_id, hint, q.get("len_hint", 0))
        try:
            f = open(info.path, "wb")
        except OSError:
            self.store.delete(block_id)
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
                await conn.send(response_for(msg, header={
                    "block_id": block_id, "len": state["total"],
                    "crc32": state["crc"], "worker_id": self.worker_id},
                    flags=Flags.RESPONSE | Flags.EOF))
            except Exception as e:  # noqa: BLE001 — surface to the client
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
        return rep

    async def _sc_read_report(self, msg: Message, conn: ServerConn):
        """A short-circuit client's per-block read counts: the store sees
        only its probe, so heat follows the reads through these."""
        q = unpack(msg.data) or {}
        for bid, reads in (q.get("block_reads") or {}).items():
            self.store.touch_reads(int(bid), int(reads))
        return {}

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

    async def _ici_transfer(self, msg: Message, conn: ServerConn):
        """The device-path pull from a peer's tier-0 waits for ROADMAP
        A10 (``ici_transfer`` is fixed off): a block not held here is
        answered ``success: False``, as the reference answers with the
        option off, and the caller keeps its TCP rail."""
        q = unpack(msg.data) or {}
        if self.store.contains(q["block_id"]):
            return {"success": True, "via": "local"}
        return {"success": False, "via": "",
                "message": "ici transfer disabled"}
