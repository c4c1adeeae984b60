"""Port parity: mounts, the under-store (UFS) and cache-warming jobs of
``curvine_tpu_torch`` against the JAX package's, on the CPU.

Mirrors, on the port's own master and workers in this process,
``test_local_ufs``, ``test_memory_ufs``, ``test_mount_and_unified_read``,
``test_load_job``, ``test_load_job_cancel_and_missing``,
``test_export_job``, ``test_ufs_metadata_passthrough``,
``test_load_job_resumes_after_master_restart``,
``test_read_only_mount_rejects_user_writes``,
``test_mount_storage_defaults_apply_to_loads`` and
``test_mount_guard_review_regressions`` (tests/test_ufs_mount.py; the
TTL reclaim of the last is left out with the TTL scanner), the six tests
of tests/test_jobs.py and the prefetch-window tests of
tests/test_cache_admission.py (:271-360). Holds the port's mount
resolution equal to the JAX package's over a seeded set of tables and
paths, a ``file://`` tree's FILE_STATUS, LIST_STATUS and EXISTS equal
through both packages' masters, either package's journal and snapshot
with mount and job records reopening in the other, and a RUNNING load
job of a JAX master's journal re-planned and run by the port's master.
Schemes and tiers the port does not serve are refused by name."""

import asyncio
import copy
import os

import numpy as np
import pytest

from curvine_tpu.common.epoch import epoch_shard_order
from curvine_tpu.common.journal import Journal as JaxJournal
from curvine_tpu.common.types import JobInfo as JaxJob
from curvine_tpu.common.types import JobState as JaxJobState
from curvine_tpu.master.filesystem import MasterFilesystem as JaxFs
from curvine_tpu.master.jobs import JobManager as JaxJobs
from curvine_tpu.master.mount import MountManager as JaxMounts
from curvine_tpu.master.store import MemMetaStore as JaxMemStore
from curvine_tpu.testing import MiniCluster
from curvine_tpu_torch.common import errors as err
from curvine_tpu_torch.common.journal import Journal
from curvine_tpu_torch.common.types import (JobState, MountInfo,
                                            StorageState, TaskInfo,
                                            TtlAction)
from curvine_tpu_torch.master.filesystem import MasterFilesystem
from curvine_tpu_torch.master.jobs import JobManager
from curvine_tpu_torch.master.mount import MountManager
from curvine_tpu_torch.master.server import MasterServer
from curvine_tpu_torch.ufs import create_ufs
from curvine_tpu_torch.ufs import memory as memufs
from curvine_tpu_torch.worker.server import WorkerServer
from torch_cluster import (PortCluster, _await_live, _client,
                           _master_conf, _worker_conf)


async def _wait_state(c, job_id, *states, timeout=10.0):
    async def wait():
        while True:
            job = await c.meta.job_status(job_id)
            if job.state in states:
                return job
            await asyncio.sleep(0.05)
    return await asyncio.wait_for(wait(), timeout)


async def _wait(cond, timeout=10.0):
    async def w():
        while not cond():
            await asyncio.sleep(0.05)
    await asyncio.wait_for(w(), timeout)


# ------------------------------------------------ tests/test_ufs_mount.py

async def test_local_ufs(tmp_path):
    root = tmp_path / "u"
    root.mkdir()
    (root / "a.txt").write_bytes(b"hello")
    (root / "sub").mkdir()
    (root / "sub" / "b.txt").write_bytes(b"world!")

    ufs = create_ufs(f"file://{root}")
    st = await ufs.stat(f"file://{root}/a.txt")
    assert st.len == 5 and not st.is_dir
    names = {s.path.rsplit("/", 1)[-1] for s in await ufs.list(f"file://{root}")}
    assert names == {"a.txt", "sub"}
    walked = [s.path async for s in ufs.walk(f"file://{root}") if not s.is_dir]
    assert len(walked) == 2
    assert await ufs.read_all(f"file://{root}/sub/b.txt") == b"world!"
    await ufs.write_all(f"file://{root}/c.bin", b"\x00" * 100)
    assert (root / "c.bin").read_bytes() == b"\x00" * 100
    await ufs.rename(f"file://{root}/c.bin", f"file://{root}/d.bin")
    assert (root / "d.bin").read_bytes() == b"\x00" * 100
    await ufs.delete(f"file://{root}/d.bin")
    assert await ufs.stat(f"file://{root}/d.bin") is None
    with pytest.raises(err.FileNotFound):
        await ufs.list(f"file://{root}/nope")


async def test_memory_ufs():
    memufs.reset()
    ufs = create_ufs("mem://bkt")
    await ufs.write_all("mem://bkt/dir/x.bin", b"abc")
    await ufs.write_all("mem://bkt/dir/y.bin", b"defg")
    await ufs.write_all("mem://bkt/top.bin", b"z")
    st = await ufs.stat("mem://bkt/dir")
    assert st.is_dir
    ls = await ufs.list("mem://bkt/dir")
    assert {s.path for s in ls} == {"mem://bkt/dir/x.bin", "mem://bkt/dir/y.bin"}
    ls_root = await ufs.list("mem://bkt")
    assert {s.path for s in ls_root} == {"mem://bkt/dir", "mem://bkt/top.bin"}
    assert await ufs.read_all("mem://bkt/dir/y.bin") == b"defg"
    chunks = [c async for c in ufs.read("mem://bkt/dir/y.bin", offset=1,
                                        length=2)]
    assert b"".join(chunks) == b"ef"


async def test_mount_and_unified_read(tmp_path):
    memufs.reset()
    ufs = create_ufs("mem://data")
    await ufs.write_all("mem://data/train/shard0.bin", b"S0" * 100)

    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.meta.mount("/mnt/data", "mem://data", auto_cache=True)
        table = await c.meta.mount_table()
        assert [m.cv_path for m in table] == ["/mnt/data"]

        # nested mount rejected
        with pytest.raises(err.InvalidArgument):
            await c.meta.mount("/mnt/data/sub", "mem://other")

        # read-through on a cache miss
        got = await c.read_all("/mnt/data/train/shard0.bin")
        assert got == b"S0" * 100
        # auto_cache warmed it: now cached (complete)
        st = await c.meta.file_status("/mnt/data/train/shard0.bin")
        assert st.is_complete and st.len == 200
        assert st.storage_policy.state == StorageState.CV
        # and the cache reads it directly
        assert await (await c.open("/mnt/data/train/shard0.bin")).read_all() \
            == b"S0" * 100

        await c.meta.umount("/mnt/data")
        assert await c.meta.mount_table() == []


async def test_load_job(tmp_path):
    memufs.reset()
    ufs = create_ufs("mem://warm")
    files = {f"mem://warm/ds/f{i}.bin": bytes([i]) * (1000 + i)
             for i in range(5)}
    for uri, data in files.items():
        await ufs.write_all(uri, data)

    async with PortCluster(tmp_path, workers=2) as mc:
        c = mc.client()
        await c.meta.mount("/warm", "mem://warm")
        job_id = await c.meta.submit_load("/warm/ds")
        job = await _wait_state(c, job_id, JobState.COMPLETED,
                                JobState.FAILED, timeout=15)
        assert job.state == JobState.COMPLETED, job.message
        assert len(job.tasks) == 5
        # round robin over the two workers, each task reported by its own
        assert {t.worker_id for t in job.tasks} == \
            {w.worker_id for w in mc.workers}
        assert all(t.state == JobState.COMPLETED for t in job.tasks)
        # every file is now cached
        for i in range(5):
            data = await (await c.open(f"/warm/ds/f{i}.bin")).read_all()
            assert data == bytes([i]) * (1000 + i)


async def test_load_job_cancel_and_missing(tmp_path):
    memufs.reset()
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.meta.mount("/w", "mem://nothing")
        job_id = await c.meta.submit_load("/w/absent")
        job = await _wait_state(c, job_id, JobState.FAILED,
                                JobState.COMPLETED)
        assert job.state == JobState.FAILED
        with pytest.raises(err.JobNotFound):
            await c.meta.job_status("nope")


async def test_export_job(tmp_path):
    """The reverse of a load: cached files written out to the UFS."""
    memufs.reset()
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.meta.mount("/exp", "mem://expbkt")
        await c.write_all("/exp/out/a.bin", b"A" * 500)
        await c.write_all("/exp/out/b.bin", b"B" * 700)
        job_id = await c.meta.submit_export("/exp/out")
        job = await _wait_state(c, job_id, JobState.COMPLETED,
                                JobState.FAILED, timeout=15)
        assert job.state == JobState.COMPLETED, job.message
        ufs = create_ufs("mem://expbkt")
        assert await ufs.read_all("mem://expbkt/out/a.bin") == b"A" * 500
        assert await ufs.read_all("mem://expbkt/out/b.bin") == b"B" * 700


async def test_ufs_metadata_passthrough(tmp_path):
    """ls, stat and read of UFS objects that were never cached."""
    memufs.reset()
    ufs = create_ufs("mem://meta")
    await ufs.write_all("mem://meta/raw/x.bin", b"X" * 300)
    await ufs.write_all("mem://meta/raw/deep/y.bin", b"Y" * 400)

    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.meta.mount("/m", "mem://meta")
        # stat an uncached object
        st = await c.meta.file_status("/m/raw/x.bin")
        assert st.len == 300 and st.is_complete
        assert st.storage_policy.state == StorageState.UFS
        assert await c.meta.exists("/m/raw/deep/y.bin")
        assert not await c.meta.exists("/m/raw/nope.bin")
        # the listing merges cached and UFS entries
        await c.write_all("/m/raw/cached.bin", b"C")
        names = [s.name for s in await c.meta.list_status("/m/raw")]
        assert names == ["cached.bin", "deep", "x.bin"]
        # unified_open streams uncached data from the UFS
        r = await c.unified_open("/m/raw/x.bin")
        assert await r.read_all() == b"X" * 300
        assert await r.pread(10, 5) == b"X" * 5
        # and a cached file through the cache
        r = await c.unified_open("/m/raw/cached.bin")
        assert bytes(await r.read_all()) == b"C"
        await r.close()


async def test_load_job_resumes_after_master_restart(tmp_path):
    """Job records are journaled without their tasks; a restarted master
    re-plans interrupted PENDING and RUNNING jobs."""
    memufs.reset()
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        ufs = create_ufs("mem://resbkt")
        for i in range(6):
            await ufs.write_all(f"mem://resbkt/d/obj{i}.bin", b"R" * 2048)
        await c.meta.mount("/res", "mem://resbkt")
        job = mc.master.jobs.submit("load", "/res/d")
        # restart the master before the job can finish
        await mc.restart_master()
        # the restarted master resumed the job from its journaled record
        await _wait(lambda: (j := mc.master.jobs.jobs.get(job.job_id))
                    is not None and j.state == JobState.COMPLETED, 20)
        # the data got warmed into the cache
        for i in range(6):
            st = await c.meta.file_status(f"/res/d/obj{i}.bin")
            assert st.len == 2048 and st.storage_policy.ufs_mtime >= 1


async def test_read_only_mount_rejects_user_writes(tmp_path):
    """User mutations under a read-only mount are refused on the master;
    cache-warming loads and reads still work."""
    memufs.reset()
    ufs = create_ufs("mem://ro")
    await ufs.write_all("mem://ro/data/f.bin", b"R" * 500)
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.meta.mount("/ro", "mem://ro", access_mode="r")
        # warming the cache under the read-only mount is allowed
        n = await c.load_from_ufs("/ro/data/f.bin")
        assert n == 500
        assert await c.read_all("/ro/data/f.bin") == b"R" * 500
        # ... but user mutations are refused
        with pytest.raises(err.Unsupported):
            await c.write_all("/ro/data/new.bin", b"x")
        with pytest.raises(err.Unsupported):
            await c.meta.mkdir("/ro/newdir")
        with pytest.raises(err.Unsupported):
            await c.meta.delete("/ro/data/f.bin")
        with pytest.raises(err.Unsupported):
            await c.meta.rename("/ro/data/f.bin", "/ro/data/g.bin")
        # a rename out of the mount is a mount write too (its source)
        with pytest.raises(err.Unsupported):
            await c.meta.rename("/ro/data/f.bin", "/elsewhere")
        # outside the mount everything still works
        await c.write_all("/free.bin", b"ok")
        # flipping the mount to rw lifts the guard
        await c.meta.update_mount("/ro", access_mode="rw")
        await c.meta.mkdir("/ro/newdir")
        assert await c.meta.exists("/ro/newdir")


async def test_mount_storage_defaults_apply_to_loads(tmp_path):
    """A mount's replica and block-size defaults govern cached copies."""
    memufs.reset()
    ufs = create_ufs("mem://sd")
    await ufs.write_all("mem://sd/a.bin", b"A" * 100)
    async with PortCluster(tmp_path, workers=2) as mc:
        c = mc.client()
        await c.meta.mount("/sd", "mem://sd", replicas=2,
                           block_size=1024 * 1024)
        await c.load_from_ufs("/sd/a.bin")
        st = await c.meta.file_status("/sd/a.bin")
        assert st.replicas == 2 and st.block_size == 1024 * 1024
        fb = await c.meta.get_block_locations("/sd/a.bin")
        assert len(fb.block_locs[0].locs) == 2


async def test_mount_guard_review_regressions(tmp_path):
    """A subtree write bypass, the wire's enums, validation before the
    journal; the mount's TTL lands in the cached copy's policy (the TTL
    scanner that would act on it is not ported)."""
    memufs.reset()
    ufs = create_ufs("mem://rg")
    await ufs.write_all("mem://rg/f.bin", b"G" * 100)
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        m = await c.meta.mount("/a/ro", "mem://rg", access_mode="r",
                               ttl_ms=500, ttl_action=int(TtlAction.DELETE))
        # the wire's round trip rebuilds the enums
        assert isinstance(m.ttl_action, TtlAction)
        assert isinstance(MountInfo.from_wire(m.to_wire()).ttl_action,
                          TtlAction)
        await c.load_from_ufs("/a/ro/f.bin")
        st = await c.meta.file_status("/a/ro/f.bin")
        assert (st.storage_policy.ttl_ms, st.storage_policy.ttl_action) == \
            (500, TtlAction.DELETE)

        # a recursive delete or a rename of an ancestor must not bypass
        # the read-only guard
        with pytest.raises(err.Unsupported):
            await c.meta.delete("/a", recursive=True)
        with pytest.raises(err.Unsupported):
            await c.meta.rename("/a", "/b")
        assert await c.read_all("/a/ro/f.bin") == b"G" * 100

        # an invalid ttl_action raises InvalidArgument before journaling
        seq = mc.master.fs.journal.seq
        with pytest.raises(err.InvalidArgument):
            await c.meta.mount("/bad", "mem://rg", ttl_ms=5, ttl_action=7)
        assert mc.master.fs.journal.seq == seq
        assert not await c.meta.exists("/bad")


# ------------------------------------------------ tests/test_jobs.py

async def test_planning_failure_surfaces_as_failed(tmp_path):
    """A load of a path under no mount lands FAILED with the why in
    ``message`` and a finish stamp."""
    async with PortCluster(tmp_path, workers=0) as mc:
        c = mc.client()
        job_id = await c.meta.submit_load("/not/mounted/anywhere")
        job = await _wait_state(c, job_id, JobState.FAILED)
        assert job.message
        assert "mount" in job.message.lower() or "not" in job.message.lower()
        assert job.finish_ms > 0
        assert job.to_wire()["message"] == job.message


async def test_export_planning_failure_surfaces(tmp_path):
    async with PortCluster(tmp_path, workers=0) as mc:
        c = mc.client()
        job_id = await c.meta.submit_export("/no/mount/here")
        job = await _wait_state(c, job_id, JobState.FAILED)
        assert job.message and job.finish_ms > 0


async def test_invalid_kind_rejected_at_submit(tmp_path):
    async with PortCluster(tmp_path, workers=0) as mc:
        c = mc.client()
        with pytest.raises(err.Unsupported):
            await c.meta.submit_job("restore", "/whatever")
        # nothing half-registered
        assert mc.master.jobs.jobs == {}
        # an EC conversion is served: over a missing path its planner
        # fails the job with the path's error
        jid = await c.meta.submit_job("ec_convert", "/whatever")
        for _ in range(100):
            job = await c.meta.job_status(jid)
            if job.state == JobState.FAILED:
                break
            await asyncio.sleep(0.02)
        assert (job.kind, job.state) == ("ec_convert", JobState.FAILED)
        assert "/whatever" in job.message


async def test_cancel_races_planner_and_sticks(tmp_path):
    """A cancel between the submit and the planner's run: the job stays
    CANCELLED when the planner's listing finishes."""
    memufs.reset()
    ufs = create_ufs("mem://cxl")
    for i in range(3):
        await ufs.write_all(f"mem://cxl/ds/f{i}", b"x" * 100)
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.meta.mount("/cxl", "mem://cxl")
        job = mc.master.jobs.submit("load", "/cxl/ds")
        mc.master.jobs.cancel(job.job_id)
        assert job.state == JobState.CANCELLED
        await asyncio.sleep(0.3)         # the planner runs, and no-ops
        job2 = await c.meta.job_status(job.job_id)
        assert job2.state == JobState.CANCELLED
        assert job2.tasks == []


async def test_no_available_worker_terminal(tmp_path):
    """With no live worker the dispatch retries with a back-off, then
    fails with NoAvailableWorker once its attempts run out."""
    async with PortCluster(tmp_path, workers=0) as mc:
        jobs = mc.master.jobs
        task = TaskInfo(task_id="t0", job_id="j0", path="/x")
        task.attempts = 20               # the last attempt: no requeue
        with pytest.raises(err.NoAvailableWorker):
            await jobs._dispatch(task)
        task2 = TaskInfo(task_id="t1", job_id="j0", path="/y")
        await jobs._dispatch(task2)      # attempt 1: backs off, no raise
        assert task2.attempts == 1


async def test_planner_crash_outside_try_hits_backstop(tmp_path):
    """A planner that dies before its own try lands FAILED through the
    done-callback backstop, not PENDING for ever."""
    async with PortCluster(tmp_path, workers=0) as mc:
        c = mc.client()
        jobs = mc.master.jobs

        async def bad_plan(job, recursive, replicas):
            raise RuntimeError("planner exploded outside its try")

        jobs._plan_load = bad_plan       # the instance attr shadows it
        job_id = await c.meta.submit_load("/anything")
        job = await _wait_state(c, job_id, JobState.FAILED)
        assert "exploded" in job.message
        assert job.finish_ms > 0


# ------------------------------------ tests/test_cache_admission.py:271-360

async def _seed_shards(c, n=6, size=256):
    for i in range(n):
        await c.write_all(f"/ds/shard-{i:03d}.bin", b"\0" * size)
    return [f"/ds/shard-{i:03d}.bin" for i in range(n)]


async def test_prefetch_window_plans_epoch_order(tmp_path):
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        shards = await _seed_shards(c)
        r = await c.advise("/ds", cursor=0, window=2, epoch=1, seed=42)
        job = mc.master.jobs.jobs[r["job_id"]]
        await _wait(lambda: len(job.tasks) >= 2)
        want = epoch_shard_order(shards, 42, 1)
        assert [t.path for t in job.tasks] == want[:2]
        assert job.total_files == len(shards)
        assert job.state in (JobState.PENDING, JobState.RUNNING)

        # an advancing cursor extends the window; planned shards are
        # never planned again
        await c.advise("/ds", cursor=2, window=2, epoch=1, seed=42)
        await _wait(lambda: len(job.tasks) >= 4)
        assert [t.path for t in job.tasks] == want[:4]

        # rolling: the job does not finish mid-epoch with every queued
        # task done
        await _wait(lambda: all(t.state == JobState.COMPLETED
                                for t in job.tasks), 15.0)
        assert job.state != JobState.COMPLETED
        # the cursor walked to the end: now it completes
        await c.advise("/ds", cursor=len(shards), window=2, epoch=1,
                       seed=42)
        await _wait(lambda: job.state == JobState.COMPLETED, 15.0)


async def test_prefetch_restart_resumes_cursor_not_dataset(tmp_path):
    """Only {cursor, window, epoch, seed} are journaled: a restarted
    master recomputes the order and plans at the cursor, never the
    shards the reader already passed."""
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        shards = await _seed_shards(c)
        r = await c.advise("/ds", cursor=3, window=2, epoch=0, seed=9)
        jid = r["job_id"]
        job = mc.master.jobs.jobs[jid]
        await _wait(lambda: len(job.tasks) >= 2)

        await mc.restart_master()
        jobs2 = mc.master.jobs
        await _wait(lambda: jid in jobs2.jobs
                    and len(jobs2.jobs[jid].tasks) >= 2, 15.0)
        job2 = jobs2.jobs[jid]
        assert job2.cursor == 3 and job2.epoch == 0 and job2.seed == 9
        want = epoch_shard_order(shards, 9, 0)
        assert [t.path for t in job2.tasks] == want[3:5]
        assert jobs2._prefetch[("/ds", 0)] == jid


async def test_prefetch_epoch_rollover_retires_old_windows(tmp_path):
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await _seed_shards(c)
        r0 = await c.advise("/ds", epoch=0)
        r1 = await c.advise("/ds", epoch=1)
        assert r0["job_id"] != r1["job_id"]
        jobs = mc.master.jobs
        # the boundary pair (e, e + 1) stays active together
        assert ("/ds", 0) in jobs._prefetch and ("/ds", 1) in jobs._prefetch
        await c.advise("/ds", epoch=2)
        assert ("/ds", 0) not in jobs._prefetch
        assert jobs.jobs[r0["job_id"]].state == JobState.COMPLETED
        assert ("/ds", 1) in jobs._prefetch


async def test_prefetch_missing_path_fails_with_message(tmp_path):
    async with PortCluster(tmp_path, workers=0) as mc:
        c = mc.client()
        r = await c.advise("/nowhere")
        job = mc.master.jobs.jobs[r["job_id"]]
        await _wait(lambda: job.state == JobState.FAILED)
        assert job.message


async def test_client_prefetch_skips_cached(tmp_path):
    """The worker side of a prefetch task: a cached complete file is a
    no-op, and a path under no mount is advisory (0, not an error)."""
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.write_all("/warm", b"x" * 512)
        assert await c.prefetch("/warm") == 0
        assert await c.prefetch("/warm-missing-no-mount") == 0


async def test_cold_prefetch_window_loads_uncached_objects(tmp_path):
    """A window over a mount that nothing has loaded plans the mount's
    UFS objects (the port lists them beside the cached files) and the
    worker's prefetch tasks load them."""
    root = tmp_path / "u"
    root.mkdir()
    for i in range(4):
        (root / f"s{i}.bin").write_bytes(bytes([i]) * (1000 + i))
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.meta.mount("/next", f"file://{root}", access_mode="r")
        r = await c.advise("/next", cursor=0, window=2)
        job = mc.master.jobs.jobs[r["job_id"]]
        await _wait(lambda: len(job.tasks) == 2 and all(
            t.state == JobState.COMPLETED for t in job.tasks), 15.0)
        assert [t.path for t in job.tasks] == ["/next/s0.bin", "/next/s1.bin"]
        assert [t.loaded_len for t in job.tasks] == [1000, 1001]
        assert job.state == JobState.RUNNING      # 2 of 4: it rolls on
        for i in range(2):
            fb = await c.meta.get_block_locations(f"/next/s{i}.bin")
            assert fb.status.is_complete and fb.block_locs[0].locs
        with pytest.raises(err.FileNotFound):
            await c.meta.get_block_locations("/next/s2.bin")


# ------------------------------------------------ refusals by name

async def test_unported_schemes_and_tiers_are_refused_by_name(tmp_path):
    for scheme in ("s3", "hdfs", "gcs", "oss", "azblob", "cos"):
        with pytest.raises(err.UfsError, match=f"{scheme} is not ported"):
            create_ufs(f"{scheme}://bucket/key")
    memufs.reset()
    await create_ufs("mem://t").write_all("mem://t/a.bin", b"a")
    async with PortCluster(tmp_path, workers=1) as mc:
        c = mc.client()
        await c.meta.mount("/s3", "s3://bucket/data")
        with pytest.raises(err.UfsError, match="s3 is not ported"):
            await c.meta.file_status("/s3/x")
        # a mount's tier is no longer refused: the load asks for ssd and
        # the worker, which has a mem tier only, writes it there
        await c.meta.mount("/ssd", "mem://t", storage_type="ssd")
        assert await c.load_from_ufs("/ssd/a.bin") == 1
        assert await c.read_all("/ssd/a.bin") == b"a"
        job_id = await c.meta.submit_load("/s3")
        job = await _wait_state(c, job_id, JobState.FAILED)
        assert "s3 is not ported" in job.message


# ------------------------------------------------ parity with the reference

def _both_mount_managers(tmp_path):
    jfs = JaxFs(journal=None, store=JaxMemStore())
    jax = JaxMounts(jfs)
    jfs.mounts = jax
    pfs = MasterFilesystem(journal=None)
    port = MountManager(pfs)
    pfs.mounts = port
    return jax, port


def _outcome(fn, *args):
    try:
        v = fn(*args)
    except Exception as e:  # noqa: BLE001 — both packages' errors
        return ("error", int(e.code))
    if isinstance(v, tuple):
        return ("ok", [x.to_wire() if hasattr(x, "to_wire") else x
                       for x in v])
    return ("ok", v.to_wire() if v is not None else None)


@pytest.mark.parametrize("seed", [0, 1])
def test_mount_resolution_equal_in_both_packages(tmp_path, seed):
    """The same mount ops (nested refusals, removals and updates among
    them) in both packages' MountManagers, then equal get_mount, resolve
    and reverse answers for a seeded set of paths and URIs."""
    rng = np.random.default_rng(seed)
    jax, port = _both_mount_managers(tmp_path)
    names = ["a", "b", "c", "d"]

    def rand_path(depth):
        return "/" + "/".join(rng.choice(names, depth))

    for _ in range(12):
        cv = rand_path(int(rng.integers(1, 4)))
        uri = f"file:///u{int(rng.integers(0, 3))}{cv}"
        op = int(rng.integers(0, 5))
        if op <= 2:
            args = ("mount", cv, uri)
            kw = dict(access_mode=str(rng.choice(["r", "rw"])),
                      replicas=int(rng.integers(0, 3)))
        elif op == 3:
            args, kw = ("umount", cv), {}
        else:
            args, kw = ("update", cv), dict(auto_cache=True)
        out = []
        for mm in (jax, port):
            try:
                r = getattr(mm, args[0])(*args[1:], **kw)
                out.append(("ok", r.to_wire() if r is not None else None))
            except Exception as e:  # noqa: BLE001
                out.append(("error", int(e.code)))
        assert out[0] == out[1], (args, kw, out)
    assert [m.to_wire() for m in jax.table()] == \
        [m.to_wire() for m in port.table()]
    assert len(port.table()) >= 2
    for _ in range(60):
        p = rand_path(int(rng.integers(1, 5)))
        u = f"file:///u{int(rng.integers(0, 3))}{p}"
        for fn in ("get_mount", "resolve"):
            assert _outcome(getattr(jax, fn), p) == \
                _outcome(getattr(port, fn), p), (fn, p)
        assert _outcome(jax.reverse, u) == _outcome(port.reverse, u), u


def _both_job_managers(tmp_path):
    """Both packages' JobManagers over in-memory masters with no
    dispatcher running: planned tasks stay queued, so the plans can be
    compared as they stand."""
    jax, port = _both_mount_managers(tmp_path)
    return JaxJobs(jax.fs, jax), JobManager(port.fs, port)


async def _planned(*managers):
    """Wait until every job has left PENDING and every rolling window has
    planned up to its cursor plus its window."""
    def done():
        for mgr in managers:
            for j in mgr.jobs.values():
                if j.state.name == "PENDING":
                    return False
                if j.kind == "prefetch" and j.state.name == "RUNNING" and \
                        getattr(j, "_next", -1) < min(j.cursor + j.window,
                                                      j.total_files):
                    return False
        return True
    await _wait(done)


def _plans(mgr) -> list:
    """Each job's record without its id and times, and its tasks' paths,
    kinds, lengths and states, in submit order."""
    out = []
    for job in mgr.jobs.values():
        w = job.to_wire()
        for k in ("job_id", "create_ms", "finish_ms"):
            w.pop(k)
        w["tasks"] = [(t.path, t.kind, t.total_len, int(t.state))
                      for t in job.tasks]
        out.append(w)
    return out


def _shard_tree(root, rng, n=6):
    """``n`` shards of seeded lengths and a subdirectory of two more."""
    (root / "sub").mkdir(parents=True)
    names = [f"s{i:02d}.bin" for i in range(n)] + ["sub/t0.bin",
                                                    "sub/t1.bin"]
    for name in names:
        (root / name).write_bytes(b"x" * int(rng.integers(1, 300)))
    return names


def _cache(managers, paths):
    for mm in managers:
        for p in paths:
            mm.fs.create_file(p)


@pytest.mark.parametrize("seed", [0, 1])
async def test_job_plans_equal_in_both_packages_over_a_cached_tree(
        tmp_path, seed):
    """A mounted tree whose every object is cached, and a cached tree
    under no mount: the same seeded submit, advise and cancel sequence
    gives equal job records and task plans in both JobManagers (the
    rolling window's epoch rollover among them)."""
    rng = np.random.default_rng(seed)
    root = tmp_path / "u"
    names = _shard_tree(root, rng)
    jjobs, pjobs = _both_job_managers(tmp_path)
    both = (jjobs, pjobs)
    for mgr in both:
        mgr.mounts.mount("/m", f"file://{root}")
    _cache([m.mounts for m in both], [f"/m/{n}" for n in names]
           + [f"/ds/shard-{i:03d}.bin" for i in range(5)])
    try:
        for _ in range(10):
            op = int(rng.integers(0, 4))
            path = str(rng.choice(["/m", "/m/sub", "/ds", "/m/s01.bin"]))
            bounds = dict(cursor=int(rng.integers(0, 8)),
                          window=int(rng.integers(1, 4)),
                          epoch=int(rng.integers(0, 3)),
                          seed=int(rng.integers(0, 3)))
            recursive = bool(rng.integers(0, 2))
            for mgr in both:
                if op == 0:
                    mgr.submit("load", path, recursive=recursive)
                elif op == 1:
                    mgr.submit("export", path, recursive=recursive)
                elif op == 2:
                    mgr.advise_prefetch(path, **bounds)
                else:
                    live = [j for j in mgr.jobs.values()
                            if j.state.name == "RUNNING"]
                    if live:
                        mgr.cancel(live[0].job_id)
            await _planned(*both)
            assert _plans(pjobs) == _plans(jjobs)
        # a later epoch retires /m's earlier windows; the cursor then
        # moves on and extends the window
        for cursor in (0, 3):
            for mgr in both:
                mgr.advise_prefetch("/m", cursor=cursor, window=3, epoch=7,
                                    seed=5)
            await _planned(*both)
        got, want = _plans(pjobs), _plans(jjobs)
        assert got == want
        windows = [j for j in want if j["kind"] == "prefetch"
                   and j["path"] == "/m"]
        assert [t[0] for t in windows[-1]["tasks"]] == epoch_shard_order(
            [f"/m/{n}" for n in names if "/" not in n], 5, 7)
        assert all(j["state"] != int(JaxJobState.RUNNING)
                   for j in windows[:-1])
    finally:
        await pjobs.close()


async def test_job_plans_over_a_partly_cached_mount(tmp_path):
    """A mount of which only some objects are cached: load and export
    plans are equal in both packages; the port's prefetch window plans
    the reference's cached shards plus exactly the mount's UFS-only
    objects, in the epoch order of them all."""
    rng = np.random.default_rng(3)
    root = tmp_path / "u"
    names = [n for n in _shard_tree(root, rng, n=8) if "/" not in n]
    cached = sorted(f"/m/{n}" for n in rng.choice(names, 3, replace=False))
    ufs_only = sorted(set(f"/m/{n}" for n in names) - set(cached))
    jjobs, pjobs = _both_job_managers(tmp_path)
    both = (jjobs, pjobs)
    for mgr in both:
        mgr.mounts.mount("/m", f"file://{root}")
    _cache([m.mounts for m in both], cached)
    try:
        for mgr in both:
            mgr.submit("load", "/m")
            mgr.submit("export", "/m")
            mgr.advise_prefetch("/m", cursor=0, window=16, epoch=2, seed=11)
            mgr.advise_prefetch("/m", cursor=0, window=2, epoch=3, seed=11)
        await _planned(*both)
        got, want = _plans(pjobs), _plans(jjobs)
        assert got[:2] == want[:2]             # load and export
        assert len(got[0]["tasks"]) == len(names) + 2
        assert [t[0] for t in got[1]["tasks"]] == cached
        full_j, full_p = want[2], got[2]
        assert [t[0] for t in full_j["tasks"]] == \
            epoch_shard_order(cached, 11, 2)
        assert [t[0] for t in full_p["tasks"]] == \
            epoch_shard_order(cached + ufs_only, 11, 2)
        assert sorted(t[0] for t in full_p["tasks"]) == \
            sorted(cached + ufs_only)
        assert full_p["total_files"] == full_j["total_files"] + len(ufs_only)
        assert {k: v for k, v in full_p.items()
                if k not in ("tasks", "total_files")} == \
            {k: v for k, v in full_j.items()
             if k not in ("tasks", "total_files")}
        head_p = got[3]
        assert [t[0] for t in head_p["tasks"]] == \
            epoch_shard_order(cached + ufs_only, 11, 3)[:2]
        assert head_p["total_files"] == len(names)
    finally:
        await pjobs.close()


def _tree(root):
    root.mkdir()
    (root / "a.bin").write_bytes(b"a" * 100)
    (root / "sub").mkdir()
    (root / "sub" / "b.bin").write_bytes(b"b" * 200)
    (root / "sub" / "deep").mkdir()
    return root


def _masked(v):
    """``v`` with ids and times masked."""
    if isinstance(v, dict):
        return {k: 0 if k in ("id", "mtime", "atime") else _masked(x)
                for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_masked(x) for x in v]
    if hasattr(v, "to_wire"):
        return _masked(v.to_wire())
    return v


async def test_ufs_metadata_equal_in_both_masters(tmp_path):
    """One ``file://`` tree mounted in the JAX package's master and the
    port's: equal FILE_STATUS, LIST_STATUS and EXISTS answers, before any
    load and over a cached file."""
    root = _tree(tmp_path / "u")
    paths = ["/m", "/m/a.bin", "/m/sub", "/m/sub/b.bin", "/m/sub/deep",
             "/m/nope", "/m/sub/nope.bin"]
    async with MiniCluster(workers=0, lost_timeout_ms=30_000) as jmc:
        jc = jmc.client()
        async with PortCluster(tmp_path / "p", workers=0) as mc:
            pc = mc.client()
            for c in (jc, pc):
                await c.meta.mount("/m", f"file://{root}")
                await c.meta.mkdir("/m/sub/cached")

            async def answers(c):
                out = {}
                for p in paths:
                    for name in ("file_status", "list_status", "exists"):
                        try:
                            out[(p, name)] = _masked(
                                await getattr(c.meta, name)(p))
                        except Exception as e:  # noqa: BLE001
                            out[(p, name)] = ("error", int(e.code))
                return out

            got, want = await answers(pc), await answers(jc)
            assert got == want
            assert got[("/m/a.bin", "file_status")]["storage_policy"][
                "state"] == int(StorageState.UFS)
            assert [s["name"] for s in got[("/m/sub", "list_status")]] == \
                ["b.bin", "cached", "deep"]


def _jax_fs(jdir):
    fs = JaxFs(journal=JaxJournal(jdir), store=JaxMemStore())
    fs.mounts = JaxMounts(fs)
    return fs


def _port_fs(jdir):
    fs = MasterFilesystem(journal=Journal(jdir))
    fs.mounts = MountManager(fs)
    return fs


def _job_wire(i, state, job_cls, state_cls):
    return job_cls(job_id=f"job{i}", kind=("load", "prefetch")[i % 2],
                   path=f"/m/d{i}", state=state_cls(state),
                   create_ms=100 + i, finish_ms=0 if state < 2 else 200 + i,
                   cursor=i, window=4, epoch=i % 3, seed=7,
                   total_files=8).to_wire()


def _records(fs) -> dict:
    return {"mounts": [m.to_wire() for m in fs.mounts.table()],
            "jobs": sorted(fs.store.iter_jobs(), key=lambda w: w["job_id"]),
            "snapshot": _masked({k: fs._snapshot_state()[k]
                                 for k in ("mounts", "jobs")})}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_with_mounts_and_jobs_reopens_in_the_other_package(
        tmp_path, writer):
    """A master's journal with ``mount_add``, ``mount_update``,
    ``mount_remove``, ``job_put`` and ``job_del`` entries on both sides of
    a snapshot that holds both sections reopens in the other package's
    master with the same mount table and job records."""
    from curvine_tpu_torch.common.types import JobInfo
    jdir = str(tmp_path / "j")
    if writer == "jax":
        fs, job_cls, state_cls = _jax_fs(jdir), JaxJob, JaxJobState
    else:
        fs, job_cls, state_cls = _port_fs(jdir), JobInfo, JobState
    fs.mounts.mount("/m", "file:///data/m", access_mode="r", replicas=2)
    fs.mounts.mount("/n", "mem://bkt", ttl_ms=5, ttl_action=2)
    fs.mounts.mount("/o", "file:///data/o")
    for i, st in enumerate((1, 2, 3)):
        fs._log("job_put", {"job": _job_wire(i, st, job_cls, state_cls)})
    fs.checkpoint()
    fs.mounts.update("/n", access_mode="r", properties={"k": "v"})
    fs.mounts.umount("/o")
    fs._log("job_del", {"job_id": "job1"})
    fs._log("job_put", {"job": _job_wire(3, 4, job_cls, state_cls)})
    fs.journal.close()
    want = _records(fs)
    other = _port_fs(jdir) if writer == "jax" else _jax_fs(jdir)
    other.recover()
    got = _records(other)
    assert got == want
    assert [m["cv_path"] for m in got["mounts"]] == ["/m", "/n"]
    assert [j["job_id"] for j in got["jobs"]] == ["job0", "job2", "job3"]


async def test_running_load_job_of_a_jax_journal_is_replanned(tmp_path):
    """A JAX master's journal holding a ``file://`` mount and a RUNNING
    load job: the port's master reopens it, re-plans the job and its
    worker loads every file."""
    root = _tree(tmp_path / "u")
    conf = _master_conf(tmp_path)
    fs = _jax_fs(conf.master.journal_dir)
    fs.mounts.mount("/m", f"file://{root}", access_mode="r")
    fs._log("job_put", {"job": JaxJob(
        job_id="resume1", kind="load", path="/m", state=JaxJobState.RUNNING,
        create_ms=1).to_wire()})
    fs.journal.close()
    m = MasterServer(conf)
    await m.start()
    conf.master.rpc_port = m.rpc.port
    conf.client.master_addrs = [m.addr]
    w = WorkerServer(_worker_conf(conf, str(tmp_path / "w0")))
    try:
        assert [x.cv_path for x in m.mounts.table()] == ["/m"]
        await w.start()
        await _await_live(m, 1)
        await _wait(lambda: m.jobs.jobs["resume1"].state
                    == JobState.COMPLETED, 15.0)
        job = m.jobs.jobs["resume1"]
        assert sorted(t.path for t in job.tasks) == \
            ["/m/a.bin", "/m/sub/b.bin"]
        async with _client(copy.deepcopy(conf)) as c:
            assert bytes(await c.read_all("/m/sub/b.bin")) == b"b" * 200
            fb = await c.meta.get_block_locations("/m/a.bin")
            assert fb.block_locs[0].locs[0].worker_id == w.worker_id
    finally:
        await w.stop()
        await m.stop()
    assert os.listdir(conf.master.journal_dir)
