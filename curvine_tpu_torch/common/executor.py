"""Scheduled executor: named periodic background tasks.

Own copy of ``curvine_tpu/common/executor.py:26-107``
(``ScheduledExecutor``), which the port's worker runs its heartbeat,
block report, eviction and promote duties on: tasks are registered by
name and run at a fixed delay (sleep after each run), a failing tick is
logged and never kills the schedule, and ``stop()`` cancels everything.
Left out: ``submit_delayed``, ``submit``, the fixed-rate schedule, the
tick and error counters and ``names()``, which the worker does not use."""

from __future__ import annotations

import asyncio
import inspect
import logging

log = logging.getLogger(__name__)


class ScheduledExecutor:
    def __init__(self, name: str = "executor"):
        self.name = name
        self._tasks: dict[str, asyncio.Task] = {}

    def submit_periodic(self, name: str, fn, interval_s: float,
                        initial_delay_s: float | None = None) -> None:
        """Run ``fn`` (sync or async) every ``interval_s``, sleeping
        after each run."""
        self.cancel(name)
        self._tasks[name] = asyncio.ensure_future(
            self._periodic(name, fn, interval_s,
                           initial_delay_s if initial_delay_s is not None
                           else interval_s))

    async def _periodic(self, name: str, fn, interval_s: float,
                        initial_delay_s: float) -> None:
        await asyncio.sleep(initial_delay_s)
        while True:
            await self._run(name, fn)
            await asyncio.sleep(interval_s)

    async def _run(self, name: str, fn) -> None:
        try:
            r = fn()
            if inspect.isawaitable(r):
                await r
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("%s: scheduled task %r failed", self.name, name)

    def cancel(self, name: str) -> None:
        t = self._tasks.pop(name, None)
        if t is not None:
            t.cancel()

    async def stop(self) -> None:
        for t in self._tasks.values():
            t.cancel()
        for t in self._tasks.values():
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
