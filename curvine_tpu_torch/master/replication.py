"""Block re-replication: the master keeps every block at its file's
replica count.

Own copy of ``curvine_tpu/master/replication.py``. The master queues
the blocks with fewer live replicas than desired (a lost worker's, found
by the periodic scan, a draining worker's, or reported corrupt), picks a
source holder and a destination worker, and asks the destination to
pull the block (SUBMIT_BLOCK_REPLICATION_JOB, under a budget carried in
the request header: ``rpc/deadline.py``); an erasure-coded stripe's
lost cell is rebuilt instead, by decode, on a destination that pulls k
sibling cells. Ported:

- the soft state, never journaled, that a restarted master relearns from
  the workers' heartbeats and reports: ``note_hbm_blocks`` (:73-81, the
  blocks each worker advertises in its device tier-0, which only ever
  add a hint to a pull) and ``note_verdicts`` (:83-89);
- ``_classify`` (:91-110) with its four kinds: ``retire`` (the block of
  a committed stripe still holds replicas: they are dropped),
  ``reconstruct`` (a stripe's cell, whichever way it was queued: a
  lost holder's, a draining one's or a reported one's; it is rebuilt by
  decode, never copied), ``evacuate`` (a replica flagged on its worker,
  moved off by copy first, delete last) and ``replicate``; and
  ``_dispatch`` (:112-122);
- ``enqueue`` and ``enqueue_evacuation`` (:124-148), ``on_worker_lost``
  and ``replacement_worker`` (:150-161);
- ``run`` with its per-block backoff (:163-193) and ``_scan_loop``
  (:195-209), which runs ``_ec_scan`` (:211-236) before the drain: the
  committed stripes' cells with no LIVE holder or with a verdict (which
  ``under_replicated`` cannot see once a lost holder's location is
  gone), and the stripes whose block still holds replicas;
- ``_live_replicas`` and ``_live_holder`` (:238-254);
- ``_drain_scan`` (:247-298), the decommission drain, run by the scan
  after the under-replication sweep: each block a DECOMMISSIONING worker
  holds needs its count on LIVE workers; once none is short, the worker
  flips to DECOMMISSIONED and its replicas leave the block map. Its
  three guards: no flip before a full block report newer than the
  worker's registration or return from LOST; a block that no LIVE
  non-holder can take counts as satisfied while it keeps one LIVE
  replica; a block with no LIVE replica always holds the flip back;
- ``_replicate`` (:300-405): only LIVE replicas count; the LIVE holders
  serve first, ordered by ``worker_distance`` to the destination, then
  the draining ones, then the flagged copy as the last resort; the
  ``ici`` hint when the source advertises the block in its tier-0; the
  pull budget; and the ``replication.ici_hinted``, ``replicates`` and
  ``evacuates`` counters;
- ``_reconstruct`` (:417-513): nothing while the cell has a LIVE holder
  (a cell on a draining worker has none, so the drain rebuilds it by
  decode); k sources from the siblings' LIVE holders, never a flagged
  copy or one with a verdict; the destination off every holder of the
  stripe, or off the cell's own holders where the cluster is too small;
  the ``replication.reconstructs`` counter; and the ``retire`` path's
  ``replication.retires``;
- ``_retire_evacuated`` and ``on_result`` (:515-540, with
  ``replication.ici_transfers`` for a pull that landed over the device
  path).

The verdicts ``_reconstruct`` and ``_ec_scan`` read are the ones the
master has noted (``note_verdicts``); the port's workers run no scrub,
so nothing sends them one yet. Under raft, ``run(leader_gate)`` gates
the queue and the scan on leadership (:163-198): a follower neither
dispatches a queued block nor scans. With ``tracer`` set (the master's),
each dispatch roots a trace, ``replicate_block`` or ``reconstruct_cell``
(:382, :489), whose context rides the submit's header: the
destination's span, and its pull from the source, join it."""

from __future__ import annotations

import asyncio
import contextlib
import logging

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.ec import ECProfile
from curvine_tpu_torch.common.types import WorkerInfo, WorkerState
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.deadline import Deadline
from curvine_tpu_torch.rpc.frame import pack

log = logging.getLogger(__name__)


class ReplicationManager:
    def __init__(self, fs, scan_interval_s: float = 5.0,
                 pull_budget_ms: int = 20_000, metrics=None):
        self._leader_gate = None
        # the master's Tracer (obs/trace.py): each dispatch roots a trace
        self.tracer = None
        self.fs = fs
        self.metrics = metrics
        self.scan_interval_s = scan_interval_s
        # the budget of one dispatched pull (the submit and the
        # destination's stream from the source), carried in the header
        self.pull_budget_ms = pull_budget_ms
        self.pool = ConnectionPool(size=1)
        self.queue: asyncio.Queue[int] = asyncio.Queue()
        self._inflight: set[int] = set()
        self._queued: set[int] = set()
        # per-block re-enqueue backoff (ms): doubles on each failed
        # dispatch, cleared when one succeeds
        self._backoff_ms: dict[int, int] = {}
        # block_id -> the worker whose replica is flagged (corrupt or on
        # a quarantined dir): it never counts toward the goal and serves
        # a pull only as the last resort; once the block is back at its
        # count elsewhere, the flagged copy is retired
        self._evac: dict[int, int] = {}
        # worker_id -> the blocks it advertises in its tier-0 (a hint for
        # the device path; a stale one costs the destination one fallback)
        self._hbm_blocks: dict[int, set[int]] = {}
        # block_id -> "mismatch" | "truncated", from worker reports
        self._verdicts: dict[int, str] = {}

    def _root(self, op: str, block_id: int, dst):
        """A dispatch's root span (a no-op without a tracer)."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.start_trace(
            op, attrs={"block_id": block_id, "dst": dst.address.worker_id})

    def _inc(self, name: str, v: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, v)

    def note_hbm_blocks(self, worker_id: int, block_ids) -> None:
        """A heartbeat's advertisement of the worker's tier-0 blocks; it
        replaces the previous one whole."""
        if block_ids:
            self._hbm_blocks[int(worker_id)] = {int(b) for b in block_ids}
        else:
            self._hbm_blocks.pop(int(worker_id), None)

    def note_verdicts(self, verdicts: dict[int, str]) -> None:
        for bid, verdict in verdicts.items():
            if self._verdicts.get(bid) != verdict:
                self._inc("replication.verdict.bit_rot"
                          if verdict == "mismatch"
                          else "replication.verdict.truncated")
            self._verdicts[bid] = verdict

    def _classify(self, bid: int) -> str:
        """The kind of work a queued block needs: ``retire`` (a committed
        stripe's block still holds replicas), ``reconstruct`` (a stripe's
        cell: decoded from its siblings, not copied), ``evacuate`` (a
        flagged replica moved off its worker) or ``replicate`` (a copy
        pulled)."""
        stripe = self.fs.ec_stripes.get(bid)
        if stripe is not None and stripe.get("state") == "committed":
            return "retire"
        if bid in self.fs.ec_cells:
            return "reconstruct"
        if bid in self._evac:
            return "evacuate"
        return "replicate"

    async def _dispatch(self, bid: int) -> bool:
        kind = self._classify(bid)
        if kind == "retire":
            meta = self.fs.blocks.get(bid)
            if meta is not None and meta.locs:
                self.fs.retire_stripe_replicas(bid)
                self._inc("replication.retires")
            return True
        if kind == "reconstruct":
            return await self._reconstruct(bid)
        return await self._replicate(bid)   # evacuate shares the pull path

    def enqueue(self, block_ids: list[int]) -> None:
        for bid in block_ids:
            if bid not in self._inflight and bid not in self._queued:
                self._queued.add(bid)
                self.queue.put_nowait(bid)

    def enqueue_evacuation(self, worker_id: int, block_ids: list[int]) -> None:
        """Blocks whose replica on ``worker_id`` must move off it, copy
        first and delete last: the flagged replica stops counting (so the
        block is re-replicated) but stays as a last-resort source (pulls
        are checked end to end, so a bad source fails its job), and is
        retired once the block is back at its count. Idempotent."""
        fresh = []
        for bid in block_ids:
            if self._evac.get(bid) != worker_id:
                self._evac[bid] = worker_id
                fresh.append(bid)
        if fresh:
            log.info("evacuating %d flagged replicas off worker %d",
                     len(fresh), worker_id)
            self.enqueue(fresh)

    def on_worker_lost(self, worker: WorkerInfo, affected: list[int]) -> None:
        log.info("worker %d lost; %d blocks affected",
                 worker.address.worker_id, len(affected))
        self.enqueue(affected)

    def replacement_worker(self, block_id: int, exclude: set[int]
                           ) -> WorkerInfo:
        meta = self.fs.blocks.get(block_id)
        holders = set(meta.locs) if meta else set()
        chosen = self.fs.policy.choose(
            self.fs.workers.live_workers(), 1,
            exclude=exclude | holders, needed=meta.len if meta else 0)
        return chosen[0]

    async def run(self, leader_gate=None) -> None:
        self._leader_gate = leader_gate
        scan = asyncio.ensure_future(self._scan_loop())
        try:
            while True:
                bid = await self.queue.get()
                self._queued.discard(bid)
                if leader_gate is not None and not leader_gate():
                    continue    # a follower dispatches no repair
                try:
                    ok = await self._dispatch(bid)
                except Exception as e:  # noqa: BLE001 — retried later
                    log.warning("repair of block %d failed: %s", bid, e)
                    ok = False
                if ok:
                    self._backoff_ms.pop(bid, None)
                else:
                    self._requeue_later(bid)
        finally:
            scan.cancel()
            await asyncio.gather(scan, return_exceptions=True)

    def _requeue_later(self, bid: int) -> None:
        """A dispatch that could not run re-enqueues after a per-block
        exponential backoff, not in a hot loop."""
        delay = self._backoff_ms.get(bid, 500)
        self._backoff_ms[bid] = min(delay * 2, 30_000)
        asyncio.get_running_loop().call_later(
            delay / 1000, lambda: self.enqueue([bid]))

    async def _scan_loop(self) -> None:
        while True:
            await asyncio.sleep(self.scan_interval_s)
            if self._leader_gate is not None and not self._leader_gate():
                continue
            under = [m.block_id for m in self.fs.blocks.under_replicated()]
            if under:
                log.info("scan: %d under-replicated blocks", len(under))
                self.enqueue(under)
            if self._evac:
                # unresolved evacuations are retried at scan cadence
                self.enqueue(list(self._evac))
            self._ec_scan()
            self._drain_scan()

    def _ec_scan(self) -> None:
        """The stripes' sweep: a cell whose only holder was dropped by
        ``worker_lost`` has no location left, which ``under_replicated``
        skips, so it surfaces here; so do cells with a verdict, and the
        committed stripes whose block still holds replicas (retired)."""
        lost, retire = [], []
        for bid, stripe in self.fs.ec_stripes.items():
            if stripe.get("state") != "committed":
                continue
            meta = self.fs.blocks.get(bid)
            if meta is not None and meta.locs:
                retire.append(bid)
            for cid in stripe["cells"]:
                if self._live_replicas(cid) == 0 or cid in self._verdicts:
                    lost.append(cid)
        if lost:
            log.info("ec scan: %d stripe cells need reconstruction",
                     len(lost))
            self.enqueue(lost)
        if retire:
            self.enqueue(retire)

    def _live_replicas(self, block_id: int) -> int:
        n = 0
        for wid in self.fs.blocks.locs.get(block_id, {}):
            w = self.fs.workers.workers.get(wid)
            if w is not None and w.state == WorkerState.LIVE:
                n += 1
        return n

    def _live_holder(self, block_id: int,
                     exclude_wid: int | None = None) -> WorkerInfo | None:
        for wid in self.fs.blocks.locs.get(block_id, {}):
            if wid == exclude_wid:
                continue
            w = self.fs.workers.workers.get(wid)
            if w is not None and w.state == WorkerState.LIVE:
                return w
        return None

    def _drain_scan(self) -> None:
        """The decommission drain: a DECOMMISSIONING worker's blocks are
        enqueued until each has its count on LIVE workers, then the
        worker flips to DECOMMISSIONED and its replicas are dropped from
        the block map (stale locations would mask a later shortfall). A
        block no LIVE non-holder can take (too few workers) counts as
        satisfied while it keeps one LIVE replica; none LIVE always
        holds the flip back: it would lose the only copy."""
        live_ids = {w.address.worker_id
                    for w in self.fs.workers.live_workers()}
        for w in self.fs.workers.decommissioning_workers():
            wid = w.address.worker_id
            if not self.fs.workers.has_current_report(wid):
                # no full report since it (re)registered or came back:
                # the block map does not know what it holds
                continue
            pending, capped = [], 0
            for bid in self.fs.blocks.worker_blocks.get(wid, set()):
                live = self._live_replicas(bid)
                if live >= self.fs.blocks.desired_of(bid):
                    continue
                holders = set(self.fs.blocks.locs.get(bid, {}))
                if live >= 1 and not (live_ids - holders):
                    capped += 1      # no target could raise the count
                    continue
                pending.append(bid)
            if pending:
                log.info("drain: worker %d has %d blocks to re-replicate",
                         wid, len(pending))
                self.enqueue(pending)
                continue
            w.state = WorkerState.DECOMMISSIONED
            self.fs.blocks.worker_lost(wid)
            if capped:
                log.warning("worker %d drained: DECOMMISSIONED, but %d "
                            "blocks stay under-replicated (too few LIVE "
                            "workers for their counts)", wid, capped)
            else:
                log.info("worker %d fully drained: DECOMMISSIONED", wid)

    async def _replicate(self, block_id: int) -> bool:
        """Dispatch one pull job. True when the block needs nothing more
        from this dispatch (done, at its count, or deleted); False to
        re-enqueue with backoff (no source or target now, or the submit
        failed)."""
        meta = self.fs.blocks.get(block_id)
        if meta is None or not meta.locs:
            self._evac.pop(block_id, None)
            return True
        evac_wid = self._evac.get(block_id)
        if evac_wid is not None and evac_wid not in meta.locs:
            self._evac.pop(block_id, None)   # the flagged copy is gone
            evac_wid = None
        # only LIVE replicas count; LIVE holders serve first, draining
        # ones after, the flagged copy last
        serving = []
        live = 0
        evac_src = None
        for wid in meta.locs:
            w = self.fs.workers.workers.get(wid)
            if w is None:
                continue
            if wid == evac_wid:
                if w.state in (WorkerState.LIVE,
                               WorkerState.DECOMMISSIONING):
                    evac_src = w
                continue
            if w.state == WorkerState.LIVE:
                live += 1
                serving.insert(0, w)
            elif w.state == WorkerState.DECOMMISSIONING:
                serving.append(w)
        if live >= self.fs.blocks.desired_of(block_id):
            if evac_wid is not None:
                self._retire_evacuated(block_id, evac_wid)
            return True
        if evac_src is not None:
            serving.append(evac_src)
        if not serving:
            log.debug("block %d has no servable source (holders lost)",
                      block_id)
            return False
        try:
            dst = self.replacement_worker(block_id, exclude=set())
        except err.CurvineError as e:
            log.debug("no replication target for block %d: %s", block_id, e)
            return False
        # within the LIVE tier, the holder nearest the destination
        if live > 1:
            serving[:live] = sorted(
                serving[:live],
                key=lambda w: self.fs.policy.worker_distance(w, dst))
        src = serving[0]
        # the device-path hint: the source advertises the block in its
        # tier-0; the destination falls back to this same TCP pull
        ici_hint = None
        if block_id in self._hbm_blocks.get(src.address.worker_id, ()):
            ici_hint = {"worker_id": src.address.worker_id,
                        "coords": list(src.ici_coords or [])}
            self._inc("replication.ici_hinted")
        self._inflight.add(block_id)
        try:
            with self._root("replicate_block", block_id, dst):
                conn = await self.pool.get(
                    f"{dst.address.ip_addr or dst.address.hostname}:"
                    f"{dst.address.rpc_port}")
                job = {"block_id": block_id, "block_len": meta.len,
                       "source": src.address.to_wire()}
                if ici_hint is not None:
                    job["ici"] = ici_hint
                await conn.call(
                    RpcCode.SUBMIT_BLOCK_REPLICATION_JOB, data=pack(job),
                    deadline=Deadline.after_ms(self.pull_budget_ms))
        except err.CurvineError as e:
            log.warning("replication submit for block %d to worker %d "
                        "failed: %s", block_id, dst.address.worker_id, e)
            return False
        finally:
            self._inflight.discard(block_id)
        self._inc("replication.evacuates" if evac_wid is not None
                  else "replication.replicates")
        return True

    async def _reconstruct(self, cell_id: int) -> bool:
        """Dispatch one cell's rebuild: the destination pulls k LIVE
        sibling cells (data first) and decodes the cell. True when the
        cell needs nothing more; False to retry with backoff (fewer than
        k live siblings, or no destination)."""
        ref = self.fs.ec_cells.get(cell_id)
        if ref is None:
            return True                          # the stripe was freed
        block_id, cell_index = ref
        stripe = self.fs.ec_stripes.get(block_id)
        if stripe is None or stripe.get("state") != "committed":
            return True                          # still being converted
        evac_wid = self._evac.get(cell_id)
        if evac_wid is not None and \
                evac_wid not in self.fs.blocks.locs.get(cell_id, {}):
            self._evac.pop(cell_id, None)
            evac_wid = None
        # a flagged copy or one with a verdict never counts as healthy:
        # it is rebuilt by decode even while it serves
        suspect = evac_wid is not None or cell_id in self._verdicts
        if not suspect and self._live_holder(cell_id) is not None:
            return True
        if suspect and cell_id not in self._verdicts and self._live_holder(
                cell_id, exclude_wid=evac_wid) is not None:
            # a clean copy exists elsewhere: only the flag is retired
            if evac_wid is not None:
                self._retire_evacuated(cell_id, evac_wid)
            return True
        prof = ECProfile.parse(stripe["profile"])
        sources = []
        for idx, cid in enumerate(stripe["cells"]):
            if cid == cell_id or len(sources) >= prof.k:
                continue
            if cid in self._verdicts:
                continue                 # never decode from rotten bytes
            w = self._live_holder(cid, exclude_wid=self._evac.get(cid))
            if w is None:
                continue
            sources.append({"index": idx, "block_id": cid,
                            "addr": w.address.to_wire()})
        if len(sources) < prof.k:
            log.debug("cell %d of block %d: only %d/%d live sibling "
                      "cells, cannot rebuild yet",
                      cell_id, block_id, len(sources), prof.k)
            return False
        # off every worker that holds a cell of this stripe; on a
        # cluster too small for that, off the cell's own holders only
        exclude = set()
        for cid in stripe["cells"]:
            exclude |= set(self.fs.blocks.locs.get(cid, {}))
        live = self.fs.workers.live_workers()
        try:
            dst = self.fs.policy.choose(live, 1, exclude=exclude,
                                        needed=stripe["cell_size"])[0]
        except err.CurvineError:
            try:
                own = set(self.fs.blocks.locs.get(cell_id, {}))
                dst = self.fs.policy.choose(live, 1, exclude=own,
                                            needed=stripe["cell_size"])[0]
            except err.CurvineError as e:
                log.debug("no rebuild destination for cell %d: %s",
                          cell_id, e)
                return False
        self._inflight.add(cell_id)
        try:
            with self._root("reconstruct_cell", cell_id, dst):
                conn = await self.pool.get(
                    f"{dst.address.ip_addr or dst.address.hostname}:"
                    f"{dst.address.rpc_port}")
                await conn.call(
                    RpcCode.SUBMIT_BLOCK_REPLICATION_JOB, data=pack({
                        "block_id": cell_id,
                        "block_len": stripe["cell_size"],
                        "ec": {"cell_index": cell_index,
                               "profile": stripe["profile"],
                               "cell_size": stripe["cell_size"],
                               "sources": sources}}),
                    deadline=Deadline.after_ms(self.pull_budget_ms))
        except err.CurvineError as e:
            log.warning("rebuild submit for cell %d to worker %d failed: "
                        "%s", cell_id, dst.address.worker_id, e)
            return False
        finally:
            self._inflight.discard(cell_id)
        self._inc("replication.reconstructs")
        return True

    def _retire_evacuated(self, block_id: int, worker_id: int) -> None:
        """The block is at its count off the flagged copy: drop that
        location now; its worker deletes the file at its next
        heartbeat."""
        log.info("block %d evacuated off worker %d", block_id, worker_id)
        self.fs.blocks.remove_replica(block_id, worker_id)
        self.fs.pending_deletes.setdefault(worker_id, set()).add(block_id)
        self._evac.pop(block_id, None)

    def on_result(self, block_id: int, worker_id: int, success: bool,
                  message: str, via: str = "") -> None:
        if success and via == "ici":
            self._inc("replication.ici_transfers")
        if not success:
            log.warning("repair of %d on worker %d failed: %s",
                        block_id, worker_id, message)
            self.enqueue([block_id])
            return
        self._verdicts.pop(block_id, None)
        if block_id in self._evac:
            # the new copy landed: the next dispatch retires the flagged
            # one once the count holds
            self.enqueue([block_id])

    async def close(self) -> None:
        await self.pool.close()
