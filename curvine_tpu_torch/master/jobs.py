"""Cache-warming jobs: load, export and the rolling prefetch window.

Own copy of ``curvine_tpu/master/jobs.py``. A load job lists the UFS
objects under a mounted path and plans one task per file; an export job
plans one task per cached file under a mounted path; a prefetch job
keeps a window of a reader's upcoming shards warm. Tasks go to live
workers round robin (SUBMIT_TASK), which run the transfer and report
each task back (REPORT_TASK → ``report_task``). A job's record is
journaled without its tasks (``job_put``, ``job_del``), so a restarted
master re-plans an interrupted job instead of replaying task lists
(``recover``).

The rolling window (``advise_prefetch``, ``_plan_prefetch``,
``_extend_prefetch``): one job per (path, epoch); an advancing cursor
plans the shards up to ``cursor + window`` of the (seed, epoch) order
(``common/epoch.py``), never one twice; a new epoch retires the path's
windows two epochs back; only the bounds and (seed, epoch) are
journaled, and a recovered window plans from its journaled cursor. A job
whose window has not reached the end of its epoch stays RUNNING with
every task done (``_maybe_finish``); an empty task list during a re-plan
never reads as done.

An ``ec_convert`` job (``_plan_ec_convert``, ``_plan_file_stripes``,
:309-403) walks its path for complete files whose storage policy names
an EC profile (SET_ATTR's ``ec``), older than ``ec.convert_cold_s``, and
plans one task a file: for each block not yet striped, the cells' ids
(journaled by ``fs.ec_plan``), k + m target workers from the placement
policy (round robin when the cluster has fewer) and the block's live
holders as sources; the converting worker pulls, encodes, places the
cells and commits the stripe (``worker/server.py``).

Where the port differs: the prefetch planner lists a
mounted directory's UFS objects beside its cached files, as LIST_STATUS
does, where the reference lists the cached namespace only, so a window
over a mount that nothing has loaded yet plans its objects (the
reference plans none); the dispatch pool is closed at the master's stop
(``close``). ``run(leader_gate)`` is the reference's (:405-425): a
follower dispatches nothing, and a node recovers the journaled jobs
when it starts as leader or is elected."""

from __future__ import annotations

import asyncio
import itertools
import logging
import uuid

from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.conf import ECConf
from curvine_tpu_torch.common.ec import ECProfile
from curvine_tpu_torch.common.epoch import epoch_shard_order
from curvine_tpu_torch.common.types import (JobInfo, JobState, TaskInfo,
                                            WorkerState, now_ms)
from curvine_tpu_torch.rpc.client import ConnectionPool
from curvine_tpu_torch.rpc.codes import RpcCode
from curvine_tpu_torch.rpc.frame import pack
from curvine_tpu_torch.ufs.base import create_ufs

log = logging.getLogger(__name__)

# a dispatch with no live worker is retried this many times, backing off
DISPATCH_ATTEMPTS = 20


class JobManager:
    def __init__(self, fs, mounts, ec_conf: ECConf | None = None):
        self.fs = fs
        self.mounts = mounts
        self.ec_conf = ec_conf or ECConf()
        self.jobs: dict[str, JobInfo] = {}
        self.pool = ConnectionPool(size=1)
        self._pending: asyncio.Queue[TaskInfo] = asyncio.Queue()
        self._rr = itertools.count()
        # (path, epoch) -> the id of its rolling prefetch job; the order
        # and the next index to plan live on the job, in RAM only
        self._prefetch: dict[tuple[str, int], str] = {}

    async def close(self) -> None:
        await self.pool.close()

    def submit(self, kind: str, path: str, recursive: bool = True,
               replicas: int = 1) -> JobInfo:
        if kind not in ("load", "export", "ec_convert"):
            raise err.Unsupported(f"job kind {kind!r}")
        job = JobInfo(job_id=uuid.uuid4().hex[:16], kind=kind, path=path,
                      state=JobState.PENDING, create_ms=now_ms(),
                      recursive=recursive, replicas=replicas)
        self.jobs[job.job_id] = job
        self._persist(job)
        self._plan(job)
        return job

    def _plan(self, job: JobInfo) -> None:
        if job.kind == "load":
            fut = asyncio.ensure_future(
                self._plan_load(job, job.recursive, job.replicas))
        elif job.kind == "ec_convert":
            fut = asyncio.ensure_future(
                self._plan_ec_convert(job, job.recursive))
        elif job.kind == "prefetch":
            fut = asyncio.ensure_future(self._plan_prefetch(job))
        elif job.kind == "export":
            fut = asyncio.ensure_future(self._plan_export(job, job.recursive))
        else:
            # a recovered record of a kind the port does not run
            self._fail(job, f"{job.kind} jobs are not ported to the port's "
                            f"master (ROADMAP A3e)")
            return
        fut.add_done_callback(lambda f: self._plan_done(job, f))

    def _fail(self, job: JobInfo, message: str) -> None:
        job.state = JobState.FAILED
        job.message = message
        job.finish_ms = now_ms()
        self._persist(job)

    # ---------------- the rolling prefetch window ----------------

    def advise_prefetch(self, path: str, cursor: int = 0, window: int = 8,
                        epoch: int = 0, seed: int = 0) -> JobInfo:
        """PREFETCH_WINDOW: the reader of ``path``'s shards is at index
        ``cursor`` of the (seed, epoch) order; keep ``window`` shards
        warm from there. One rolling job per (path, epoch)."""
        window = max(1, int(window))
        cursor = max(0, int(cursor))
        key = (path, int(epoch))
        job = None
        jid = self._prefetch.get(key)
        if jid is not None:
            job = self.jobs.get(jid)
            if job is not None and job.state not in (JobState.PENDING,
                                                     JobState.RUNNING):
                job = None
        if job is None:
            # a new epoch retires the path's windows two epochs back; the
            # boundary pair (the tail of e, the head of e + 1) stays
            for (p, e), oid in list(self._prefetch.items()):
                if p == path and e < int(epoch) - 1:
                    old = self.jobs.get(oid)
                    if old is not None and old.state in (
                            JobState.PENDING, JobState.RUNNING):
                        old.state = JobState.COMPLETED
                        old.finish_ms = now_ms()
                        self._persist(old)
                    del self._prefetch[(p, e)]
            job = JobInfo(job_id=uuid.uuid4().hex[:16], kind="prefetch",
                          path=path, state=JobState.PENDING,
                          create_ms=now_ms(), cursor=cursor, window=window,
                          epoch=int(epoch), seed=int(seed))
            self.jobs[job.job_id] = job
            self._prefetch[key] = job.job_id
            self._persist(job)
            self._plan(job)
            return job
        moved = cursor > job.cursor or window != job.window
        job.cursor = max(job.cursor, cursor)
        job.window = window
        if moved:
            self._persist(job)           # the bounds only
            asyncio.ensure_future(self._extend_prefetch(job))
        return job

    async def _shards(self, path: str) -> list[str]:
        """The files of ``path`` (or the file itself): its cached entries
        over its mount's UFS objects, as LIST_STATUS merges them."""
        try:
            st = self.fs.file_status(path)
        except err.FileNotFound:
            st = await self.mounts.ufs_status(path)
            if st is None:
                raise
        if not st.is_dir:
            return [st.path]
        return [s.path for s in await self.mounts.list_merged(path)
                if not s.is_dir]

    async def _plan_prefetch(self, job: JobInfo) -> None:
        """Compute the epoch order and plan the current window. On
        recovery the job has no tasks and its journaled cursor: only
        [cursor, cursor + window) is planned, never the whole dataset."""
        try:
            shards = await self._shards(job.path)
            order = epoch_shard_order(shards, job.seed or None, job.epoch)
            if job.state not in (JobState.PENDING, JobState.RUNNING):
                return                # cancelled mid-plan: it stays so
            job._order = order                      # RAM only
            job._next = job.cursor                  # the next index to plan
            job.total_files = len(order)
            if not order:
                job.state = JobState.COMPLETED
                job.finish_ms = now_ms()
                self._persist(job)
                return
            job.state = JobState.RUNNING
            await self._extend_prefetch(job)
        except Exception as e:  # noqa: BLE001 — the job fails with it
            log.warning("prefetch job %s planning failed: %s",
                        job.job_id, e)
            self._fail(job, str(e) or type(e).__name__)

    async def _extend_prefetch(self, job: JobInfo) -> None:
        """Queue warm tasks for order[_next, min(cursor + window, total))."""
        order = getattr(job, "_order", None)
        if order is None or job.state not in (JobState.PENDING,
                                              JobState.RUNNING):
            return
        hi = min(job.cursor + job.window, len(order))
        for idx in range(getattr(job, "_next", job.cursor), hi):
            task = TaskInfo(task_id=uuid.uuid4().hex[:16],
                            job_id=job.job_id, path=order[idx],
                            kind="prefetch")
            job.tasks.append(task)
            await self._pending.put(task)
        job._next = max(getattr(job, "_next", job.cursor), hi)
        self._maybe_finish(job)

    def _plan_done(self, job: JobInfo, fut: asyncio.Future) -> None:
        """The backstop for a planner that died outside its own try
        block: without it the job would read PENDING for ever."""
        if fut.cancelled():
            return
        e = fut.exception()
        if e is None or job.state not in (JobState.PENDING,
                                          JobState.RUNNING):
            return
        log.warning("%s job %s planner crashed: %s", job.kind,
                    job.job_id, e)
        self._fail(job, str(e) or type(e).__name__)

    def _persist(self, job: JobInfo) -> None:
        """Journal the job's record without its tasks."""
        wire = job.to_wire()
        wire["tasks"] = []
        try:
            self.fs._log("job_put", {"job": wire})
        except err.CurvineError as e:
            log.warning("persisting job %s failed: %s", job.job_id, e)

    def recover(self) -> int:
        """Resume the journaled jobs: PENDING and RUNNING ones re-plan,
        finished ones stay queryable, and finished ones older than 7 days
        are dropped. Returns the number resumed."""
        resumed = 0
        cutoff = now_ms() - 7 * 24 * 3600 * 1000
        for wire in list(self.fs.store.iter_jobs()):
            job = JobInfo.from_wire(wire)
            if job.state in (JobState.PENDING, JobState.RUNNING):
                # the journaled state is the truth; load and export tasks
                # are idempotent, so a duplicate costs work at most
                job.state = JobState.PENDING
                job.tasks = []
                self.jobs[job.job_id] = job
                if job.kind == "prefetch":
                    # the client's next advise extends this job, planned
                    # from its journaled cursor
                    self._prefetch[(job.path, job.epoch)] = job.job_id
                self._plan(job)
                resumed += 1
                log.info("resuming %s job %s on %s", job.kind,
                         job.job_id, job.path)
            else:
                if job.finish_ms and job.finish_ms < cutoff:
                    try:
                        self.fs._log("job_del", {"job_id": job.job_id})
                    except err.CurvineError:
                        pass
                    self.jobs.pop(job.job_id, None)
                    continue
                self.jobs.setdefault(job.job_id, job)
        return resumed

    async def _plan_export(self, job: JobInfo, recursive: bool) -> None:
        """One export task per cached file under ``job.path``."""
        try:
            self.mounts.resolve(job.path)   # it must be under a mount
            files: list = []

            def walk(path: str) -> None:
                for st in self.fs.list_status(path):
                    if st.is_dir:
                        if recursive:
                            walk(st.path)
                    else:
                        files.append(st)

            st = self.fs.file_status(job.path)
            if st.is_dir:
                walk(job.path)
            else:
                files.append(st)
            if job.state != JobState.PENDING:
                return                # cancelled mid-plan: it stays so
            for f in files:
                task = TaskInfo(task_id=uuid.uuid4().hex[:16],
                                job_id=job.job_id, path=f.path,
                                kind="export", total_len=f.len)
                job.tasks.append(task)
                await self._pending.put(task)
            job.state = JobState.RUNNING if files else JobState.COMPLETED
            if not files:
                job.finish_ms = now_ms()
                self._persist(job)
        except Exception as e:  # noqa: BLE001 — the job fails with it
            log.warning("export job %s planning failed: %s", job.job_id, e)
            self._fail(job, str(e) or type(e).__name__)

    async def _plan_load(self, job: JobInfo, recursive: bool,
                         replicas: int) -> None:
        """One load task per UFS file under ``job.path``."""
        try:
            mount, ufs_uri = self.mounts.resolve(job.path)
            ufs = create_ufs(ufs_uri, properties=mount.properties)
            files = []
            st = await ufs.stat(ufs_uri)
            if st is None:
                raise err.FileNotFound(ufs_uri)
            if st.is_dir:
                async for f in ufs.walk(ufs_uri, recursive=recursive):
                    if not f.is_dir:
                        files.append(f)
            else:
                files.append(st)
            if job.state != JobState.PENDING:
                return                # cancelled mid-plan: it stays so
            for f in files:
                _, cv_path = self.mounts.reverse(f.path)
                task = TaskInfo(task_id=uuid.uuid4().hex[:16],
                                job_id=job.job_id, path=cv_path,
                                total_len=f.len)
                job.tasks.append(task)
                await self._pending.put(task)
            job.state = JobState.RUNNING
            if not files:
                job.state = JobState.COMPLETED
                job.finish_ms = now_ms()
                self._persist(job)
        except Exception as e:  # noqa: BLE001 — the job fails with it
            log.warning("load job %s planning failed: %s", job.job_id, e)
            self._fail(job, str(e) or type(e).__name__)

    async def _plan_ec_convert(self, job: JobInfo, recursive: bool) -> None:
        """One ``ec_convert`` task per complete, cold file under
        ``job.path`` whose storage policy names an EC profile. Blocks
        already striped are skipped, so the job is idempotent and a
        resumed one re-plans only what is left."""
        try:
            cold_ms = self.ec_conf.convert_cold_s * 1000
            files = []

            def walk(path: str) -> None:
                for st in self.fs.list_status(path):
                    if st.is_dir:
                        if recursive:
                            walk(st.path)
                    elif st.is_complete and st.storage_policy.ec:
                        files.append(st)

            st = self.fs.file_status(job.path)
            if st.is_dir:
                walk(job.path)
            elif st.is_complete and st.storage_policy.ec:
                files.append(st)
            if job.state != JobState.PENDING:
                return                # cancelled mid-plan: it stays so
            now = now_ms()
            planned = 0
            for f in files:
                if cold_ms and f.mtime > now - cold_ms:
                    continue          # still warm
                profile = ECProfile.parse(f.storage_policy.ec)
                plans = self._plan_file_stripes(f, profile)
                if not plans:
                    continue
                task = TaskInfo(task_id=uuid.uuid4().hex[:16],
                                job_id=job.job_id, path=f.path,
                                kind="ec_convert", total_len=f.len,
                                payload={"profile": profile.name,
                                         "blocks": plans})
                job.tasks.append(task)
                await self._pending.put(task)
                planned += 1
            job.state = JobState.RUNNING if planned else JobState.COMPLETED
            if not planned:
                job.finish_ms = now_ms()
                self._persist(job)
        except Exception as e:  # noqa: BLE001 — the job fails with it
            log.warning("ec_convert job %s planning failed: %s",
                        job.job_id, e)
            self._fail(job, str(e) or type(e).__name__)

    def _plan_file_stripes(self, f, profile: ECProfile) -> list[dict]:
        """The stripe plans of one file's blocks: journal the cells' ids,
        pick k + m target workers (distinct where the cluster has that
        many; fewer wrap round robin) and list the block's sources."""
        node = self.fs.tree.resolve(f.path)
        if node is None:
            return []
        plans = []
        for bid in node.blocks:
            stripe = self.fs.ec_stripes.get(bid)
            if stripe is not None and stripe.get("state") == "committed":
                continue              # already striped
            meta = self.fs.blocks.get(bid)
            if meta is None or meta.len == 0 or not meta.locs:
                continue              # nothing to stripe, or no source
            k, m = profile.k, profile.m
            cell_size = profile.cell_size(meta.len)
            chosen = self.fs.policy.choose(self.fs.workers.live_workers(),
                                           k + m, needed=cell_size,
                                           min_count=1)
            targets = [chosen[i % len(chosen)] for i in range(k + m)]
            cell_ids = self.fs.ec_plan(bid, profile.name, k, m, cell_size)
            sources = []
            for wid in meta.locs:
                w = self.fs.workers.workers.get(wid)
                if w is not None and w.state in (
                        WorkerState.LIVE, WorkerState.DECOMMISSIONING):
                    sources.append(w.address.to_wire())
            plans.append({
                "block_id": bid, "block_len": meta.len,
                "cell_size": cell_size, "sources": sources,
                "cells": [{"index": i, "block_id": cid,
                           "addr": targets[i].address.to_wire()}
                          for i, cid in enumerate(cell_ids)]})
        return plans

    async def run(self, leader_gate=None) -> None:
        """Dispatch queued tasks while leader; recover the journaled jobs
        at the start and at each election."""
        was_leader = False
        while True:
            is_leader = leader_gate is None or leader_gate()
            if is_leader and not was_leader:
                self.recover()
            was_leader = is_leader
            try:
                task = await asyncio.wait_for(self._pending.get(), 1.0)
            except asyncio.TimeoutError:
                continue              # the gate's next check
            if not is_leader:
                continue
            job = self.jobs.get(task.job_id)
            if job is None or job.state in (JobState.CANCELLED,
                                            JobState.FAILED):
                continue
            try:
                await self._dispatch(task)
            except Exception as e:  # noqa: BLE001
                task.state = JobState.FAILED
                task.message = str(e)
                self._maybe_finish(job)

    async def _dispatch(self, task: TaskInfo) -> None:
        workers = self.fs.workers.live_workers()
        if not workers:
            # right after a (re)start the workers register on their next
            # heartbeat: retry with a back-off before failing
            task.attempts += 1
            if task.attempts <= DISPATCH_ATTEMPTS:
                async def requeue():
                    await asyncio.sleep(min(0.5 * task.attempts, 3.0))
                    await self._pending.put(task)
                asyncio.ensure_future(requeue())
                return
            raise err.NoAvailableWorker("no live workers for load task")
        w = workers[next(self._rr) % len(workers)]
        task.worker_id = w.address.worker_id
        task.state = JobState.RUNNING
        conn = await self.pool.get(
            f"{w.address.ip_addr or w.address.hostname}:{w.address.rpc_port}")
        await conn.call(RpcCode.SUBMIT_TASK,
                        data=pack({"task": task.to_wire()}))

    def report_task(self, task_wire: dict) -> None:
        t = TaskInfo.from_wire(task_wire)
        job = self.jobs.get(t.job_id)
        if job is None:
            raise err.JobNotFound(t.job_id)
        for i, existing in enumerate(job.tasks):
            if existing.task_id == t.task_id:
                job.tasks[i] = t
                break
        self._maybe_finish(job)

    def _maybe_finish(self, job: JobInfo) -> None:
        if job.state not in (JobState.RUNNING, JobState.PENDING):
            return
        if not job.tasks:
            # mid-resume (tasks reset, the re-plan in flight): an empty
            # set is not "every task completed"
            return
        if job.kind == "prefetch" \
                and getattr(job, "_next", 0) < job.total_files:
            # the window has not reached the epoch's end: the job rolls on
            # with every current task done (the next advise extends it)
            return
        states = {t.state for t in job.tasks}
        if states <= {JobState.COMPLETED}:
            job.state = JobState.COMPLETED
            job.finish_ms = now_ms()
            self._persist(job)
        elif JobState.FAILED in states and not (
                states & {JobState.PENDING, JobState.RUNNING}):
            job.state = JobState.FAILED
            job.finish_ms = now_ms()
            job.message = "; ".join(t.message for t in job.tasks
                                    if t.state == JobState.FAILED)[:500]
            self._persist(job)

    def status(self, job_id: str) -> JobInfo:
        job = self.jobs.get(job_id)
        if job is None:
            raise err.JobNotFound(job_id)
        return job

    def cancel(self, job_id: str) -> None:
        job = self.status(job_id)
        if job.state in (JobState.PENDING, JobState.RUNNING):
            job.state = JobState.CANCELLED
            job.finish_ms = now_ms()
            self._persist(job)
