"""Worker registry and liveness.

Own copy of ``curvine_tpu/master/worker_map.py``: a heartbeat registers
a worker (or brings a LOST one back), ``check_lost`` marks those whose
heartbeat is older than ``lost_timeout_ms`` LOST (DECOMMISSIONING ones
too, :90-100), and a worker's view in the block map counts only once a
full block report has come since it registered or came back
(``has_current_report``). The decommission intents (``deco_ids``,
:22-24) survive a re-registration: a heartbeat leaves a worker in them
DECOMMISSIONING or DECOMMISSIONED, never LIVE (:49);
``decommission``, ``recommission``, ``decommissioning_workers``,
``serving_workers`` (LIVE and draining: their replicas serve reads)
and ``retired_workers`` (DECOMMISSIONED) are the reference's
(:102-127)."""

from __future__ import annotations

import logging

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.types import (StorageInfo, WorkerAddress,
                                            WorkerInfo, WorkerState, now_ms)

log = logging.getLogger(__name__)


class WorkerMap:
    def __init__(self, lost_timeout_ms: int = 30_000):
        self.workers: dict[int, WorkerInfo] = {}
        self.lost_timeout_ms = lost_timeout_ms
        # decommission intents: they outlive a re-registration and, as
        # the filesystem journals them, a restart
        self.deco_ids: set[int] = set()
        # per worker: its last block report and its last registration or
        # return from LOST
        self.report_ms: dict[int, int] = {}
        self.return_ms: dict[int, int] = {}

    def heartbeat(self, address: WorkerAddress, storages: list[StorageInfo],
                  ici_coords: list[int] | None = None) -> WorkerInfo:
        info = self.workers.get(address.worker_id)
        if info is None:
            info = WorkerInfo(address=address)
            self.workers[address.worker_id] = info
            self.return_ms[address.worker_id] = now_ms()
            log.info("worker registered: %s", address)
        info.address = address
        info.storages = storages
        info.last_heartbeat_ms = now_ms()
        if ici_coords is not None:
            info.ici_coords = list(ici_coords)
        if info.state == WorkerState.LOST:
            # its replicas were dropped at LOST: nothing it holds counts
            # until its next full report
            self.return_ms[address.worker_id] = now_ms()
        if address.worker_id in self.deco_ids:
            # a heartbeat never brings a draining worker back to LIVE
            if info.state in (WorkerState.LIVE, WorkerState.LOST):
                info.state = WorkerState.DECOMMISSIONING
        elif info.state != WorkerState.LIVE:
            if info.state == WorkerState.LOST:
                log.info("worker %d back alive", address.worker_id)
            info.state = WorkerState.LIVE
        return info

    def mark_reported(self, worker_id: int) -> None:
        self.report_ms[worker_id] = now_ms()

    def forget_reports(self) -> None:
        """Every worker's blocks to be reported again (a snapshot
        install replaced what their reports had located)."""
        self.report_ms.clear()

    def has_current_report(self, worker_id: int) -> bool:
        """A full block report has come since the worker registered,
        came back from LOST or this master installed a snapshot."""
        return self.report_ms.get(worker_id, 0) \
            > self.return_ms.get(worker_id, 0)

    def get(self, worker_id: int) -> WorkerInfo:
        info = self.workers.get(worker_id)
        if info is None:
            raise err.WorkerNotFound(f"worker {worker_id} not registered")
        return info

    def live_workers(self) -> list[WorkerInfo]:
        return [w for w in self.workers.values() if w.state == WorkerState.LIVE]

    def lost_workers(self) -> list[WorkerInfo]:
        return [w for w in self.workers.values() if w.state == WorkerState.LOST]

    def retired_workers(self) -> list[WorkerInfo]:
        """The drained workers: DECOMMISSIONED, safe to remove."""
        return [w for w in self.workers.values()
                if w.state == WorkerState.DECOMMISSIONED]

    def check_lost(self) -> list[WorkerInfo]:
        """Mark the workers whose heartbeat expired; returns those newly
        lost. A draining worker that stops beating is LOST too: its
        replicas are gone, not draining."""
        deadline = now_ms() - self.lost_timeout_ms
        newly_lost = []
        for w in self.workers.values():
            if w.state in (WorkerState.LIVE, WorkerState.DECOMMISSIONING) \
                    and w.last_heartbeat_ms < deadline:
                w.state = WorkerState.LOST
                newly_lost.append(w)
                log.warning("worker %d lost (no heartbeat for %dms)",
                            w.address.worker_id, self.lost_timeout_ms)
        return newly_lost

    def decommission(self, worker_id: int) -> None:
        """No new blocks on the worker; its replicas serve while the
        drain copies them to LIVE workers."""
        self.deco_ids.add(worker_id)
        w = self.workers.get(worker_id)
        if w is not None and w.state == WorkerState.LIVE:
            w.state = WorkerState.DECOMMISSIONING

    def recommission(self, worker_id: int) -> None:
        self.deco_ids.discard(worker_id)
        w = self.workers.get(worker_id)
        if w is not None and w.state in (WorkerState.DECOMMISSIONING,
                                         WorkerState.DECOMMISSIONED):
            w.state = WorkerState.LIVE

    def decommissioning_workers(self) -> list[WorkerInfo]:
        return [w for w in self.workers.values()
                if w.state == WorkerState.DECOMMISSIONING]

    def serving_workers(self) -> list[WorkerInfo]:
        """The workers whose replicas are readable: LIVE and draining."""
        return [w for w in self.workers.values()
                if w.state in (WorkerState.LIVE,
                               WorkerState.DECOMMISSIONING)]

    def capacity(self) -> tuple[int, int]:
        cap = avail = 0
        for w in self.live_workers():
            cap += w.capacity
            avail += w.available
        return cap, avail
