"""Trace what stalls a port master's event loop while it sends or
installs a raft snapshot.

    mkdir -p out
    PYTHONPATH=scripts/stall_trace STALL_TRACE_DIR=out python3 chip_smoke.py

On ``PYTHONPATH`` this file is imported when each interpreter starts
(``sitecustomize``; one found further on the path is run after it). In a
process that imports ``curvine_tpu_torch.master.ha`` it wraps
``RaftLite._send_snapshot`` and ``RaftLite._install``. While one runs:

- a probe on the loop notes every stall of ``STALL_MS`` or more, with
  the loop thread's CPU time across it;
- a sampler thread takes every thread's stack, each thread's CPU time,
  the process's page faults and context switches and the cgroup's CPU
  throttling every ``TICK_S``;
- the collector's passes are timed (``gc.callbacks``), and the steps of
  the pack and the install marked (``build_snapshot``,
  ``wirepack.packb_buffer``, ``build_install``, ``adopt_install``).

When the call ends, one JSON line goes to
``STALL_TRACE_DIR/stall-<pid>.jsonl``: the marks, the stalls, each with
the samples taken in it (a sampler that could not run for a while shows
as a gap between two samples), the collector's passes and the sampler's
own gaps. Without ``STALL_TRACE_DIR`` nothing is wrapped."""

import asyncio
import collections
import functools
import gc
import importlib.abc
import importlib.machinery
import importlib.util
import json
import os
import resource
import sys
import threading
import time

OUT = os.environ.get("STALL_TRACE_DIR")
TICK_S = 0.005
STALL_MS = 20.0
DEPTH = 8
TARGET = "curvine_tpu_torch.master.ha"
_CGROUP = ("/sys/fs/cgroup/cpu.stat", "/sys/fs/cgroup/cpu/cpu.stat",
           "/sys/fs/cgroup/cpu,cpuacct/cpu.stat")
_PRESSURE = ("/proc/pressure/cpu", "/proc/pressure/memory",
             "/sys/fs/cgroup/cpu.pressure", "/sys/fs/cgroup/memory.pressure")


def _read_kv(path: str) -> dict:
    try:
        with open(path) as f:
            out = {}
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    out[parts[0]] = int(parts[1])
                elif parts and parts[0] in ("some", "full"):
                    tot = [p for p in parts if p.startswith("total=")]
                    if tot:
                        out[parts[0]] = int(tot[0][6:])
            return out
    except (OSError, ValueError):
        return {}


def _system() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"minflt": ru.ru_minflt, "majflt": ru.ru_majflt,
           "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw,
           "cpu_s": ru.ru_utime + ru.ru_stime}
    for p in _CGROUP + _PRESSURE:
        kv = _read_kv(p)
        for k in ("nr_throttled", "throttled_usec", "throttled_time",
                  "some", "full"):
            if k in kv:
                out[f"{p.rsplit('/', 2)[-2]}/{p.rsplit('/', 1)[-1]}:{k}"] \
                    = kv[k]
    return out


def _stack(frame) -> list[str]:
    out = []
    while frame is not None and len(out) < DEPTH:
        code = frame.f_code
        out.append(f"{os.path.basename(code.co_filename)}:{frame.f_lineno} "
                   f"{code.co_name}")
        frame = frame.f_back
    return out


class _Trace:
    def __init__(self, what: str):
        self.what = what
        self.t0 = time.perf_counter()
        self.samples = collections.deque(maxlen=20_000)
        self.stalls: list = []
        self.gc: list = []
        self.marks: list = []
        self._gc_at: dict = {}
        self._stop = threading.Event()
        self._loop_tid = threading.get_ident()
        self._sampler = threading.Thread(target=self._sample, daemon=True,
                                         name="stall-sampler")

    def rel(self, t: float) -> float:
        return round(t - self.t0, 6)

    def mark(self, name: str) -> None:
        self.marks.append((self.rel(time.perf_counter()), name,
                           threading.current_thread().name))

    def _sample(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(TICK_S):
            t = time.perf_counter()
            cpu = {}
            names = {}
            for th in threading.enumerate():
                if th.ident is None or th.ident == me:
                    continue
                names[th.ident] = th.name
                try:
                    cpu[th.name] = round(time.clock_gettime(
                        time.pthread_getcpuclockid(th.ident)), 6)
                except (OSError, AttributeError):
                    pass
            stacks = {names.get(tid, str(tid)): _stack(f)
                      for tid, f in sys._current_frames().items()
                      if tid != me}
            self.samples.append((self.rel(t), stacks, cpu, _system()))

    def _on_gc(self, phase: str, info: dict) -> None:
        t = time.perf_counter()
        if phase == "start":
            self._gc_at[threading.get_ident()] = t
        else:
            t0 = self._gc_at.pop(threading.get_ident(), t)
            self.gc.append(dict(at=self.rel(t0), ms=round((t - t0) * 1e3, 3),
                                gen=info.get("generation"),
                                collected=info.get("collected"),
                                thread=threading.current_thread().name))

    async def _probe(self) -> None:
        while True:
            t = time.perf_counter()
            tc = time.thread_time()
            await asyncio.sleep(TICK_S)
            late = (time.perf_counter() - t - TICK_S) * 1e3
            if late >= STALL_MS:
                self.stalls.append(dict(
                    at=self.rel(t), late_ms=round(late, 3),
                    loop_cpu_ms=round((time.thread_time() - tc) * 1e3, 3)))

    def start(self) -> asyncio.Task:
        gc.callbacks.append(self._on_gc)
        self._sampler.start()
        return asyncio.ensure_future(self._probe())

    def finish(self) -> dict:
        self._stop.set()
        self._sampler.join()
        gc.callbacks.remove(self._on_gc)
        samples = list(self.samples)
        gaps = []
        for a, b in zip(samples, samples[1:]):
            if b[0] - a[0] >= STALL_MS / 1e3:
                gaps.append(dict(from_s=a[0], to_s=b[0], before=a[1],
                                 after=b[1], cpu_before=a[2], cpu_after=b[2],
                                 sys_before=a[3], sys_after=b[3]))
        for st in self.stalls:
            lo, hi = st["at"], st["at"] + (st["late_ms"] / 1e3) + 2 * TICK_S
            inside = [s for s in samples if lo - TICK_S <= s[0] <= hi]
            st["samples"] = [dict(t=s[0], stacks=s[1], cpu=s[2], sys=s[3])
                             for s in inside]
        return dict(pid=os.getpid(), what=self.what,
                    wall_s=self.rel(time.perf_counter()), marks=self.marks,
                    stalls=self.stalls, gc=self.gc, sampler_gaps=gaps,
                    samples=len(samples))


_current: list = []


def _note(name: str) -> None:
    if _current:
        _current[-1].mark(name)


def _marked(fn, name: str, off_loop: bool = False):
    @functools.wraps(fn)
    def run(*a, **kw):
        if off_loop and threading.current_thread() is \
                threading.main_thread():
            return fn(*a, **kw)           # an RPC frame, not the pack
        _note(f"{name}>")
        try:
            return fn(*a, **kw)
        finally:
            _note(f"{name}<")
    return run


def _traced(fn, what: str):
    @functools.wraps(fn)
    async def run(*a, **kw):
        tr = _Trace(what)
        _current.append(tr)
        probe = tr.start()
        try:
            return await fn(*a, **kw)
        finally:
            probe.cancel()
            await asyncio.gather(probe, return_exceptions=True)
            _current.remove(tr)
            rec = tr.finish()
            path = os.path.join(OUT, f"stall-{os.getpid()}.jsonl")
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return run


def _patch(ha) -> None:
    from curvine_tpu_torch.master import filesystem
    from curvine_tpu_torch.rpc import wirepack
    ha.RaftLite._send_snapshot = _traced(ha.RaftLite._send_snapshot, "send")
    ha.RaftLite._install = _traced(ha.RaftLite._install, "install")
    ha.RaftLite._pack_snapshot = _marked(ha.RaftLite._pack_snapshot, "pack")
    fs = filesystem.MasterFilesystem
    for name in ("snapshot_cut", "build_snapshot", "build_install",
                 "adopt_install"):
        setattr(fs, name, _marked(getattr(fs, name), name))
    wirepack.packb_buffer = _marked(wirepack.packb_buffer, "packb_buffer",
                                    off_loop=True)
    ha.RaftLite._state_of_blob = staticmethod(
        _marked(ha.RaftLite._state_of_blob, "state_of_blob"))


class _Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path, target=None):
        if fullname != TARGET:
            return None
        sys.meta_path.remove(self)
        spec = importlib.util.find_spec(fullname)
        loader = spec.loader
        run = loader.exec_module

        def exec_module(module):
            run(module)
            _patch(module)
        loader.exec_module = exec_module
        return spec


def _chain() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    rest = [p for p in sys.path if os.path.abspath(p or ".") != here]
    spec = importlib.machinery.PathFinder.find_spec("sitecustomize", rest)
    if spec is not None and spec.origin != os.path.abspath(__file__):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


if OUT:
    OUT = os.path.abspath(OUT)
    os.makedirs(OUT, exist_ok=True)
    sys.meta_path.insert(0, _Finder())
_chain()
