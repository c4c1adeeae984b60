"""The client's per-worker health board: one circuit breaker a worker.

Own copy of ``curvine_tpu/client/health.py``. A wedged or dead worker
would otherwise cost every request its own failure or timeout. After
``fail_threshold`` failures in a row against one worker address the
breaker OPENs: the reader tries the worker's replicas last (``order``;
it still tries them when nothing else is left) and the writer's
ADD_BLOCK excludes it from placement (``open_worker_ids``). After
``open_s`` the breaker is HALF_OPEN and admits one probe a window
(``allow``): a success closes it, a failure opens it again. A failure
count decays after ``decay_s`` without a failure, so old blips never
trip a breaker.

``CurvineClient`` builds one board and shares it with every reader and
writer it opens: a worker that dies mid-job is learned once, not once a
file. The clock is injected (``clock``, ``time.monotonic`` by
default)."""

from __future__ import annotations

import time
from dataclasses import dataclass

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass
class _Breaker:
    failures: int = 0
    state: str = CLOSED
    opened_at: float = 0.0
    last_failure: float = 0.0
    probe_at: float = 0.0        # when the last half-open probe was let by
    worker_id: int | None = None
    trips: int = 0               # CLOSED → OPEN transitions, ever


class WorkerHealth:
    def __init__(self, fail_threshold: int = 3, open_s: float = 5.0,
                 decay_s: float = 30.0, clock=time.monotonic):
        self.fail_threshold = max(1, fail_threshold)
        self.open_s = open_s
        self.decay_s = decay_s
        self._clock = clock
        self._b: dict[str, _Breaker] = {}

    def _get(self, addr: str) -> _Breaker:
        b = self._b.get(addr)
        if b is None:
            b = self._b[addr] = _Breaker()
        return b

    def _refresh(self, b: _Breaker, now: float) -> None:
        if b.failures and b.state == CLOSED \
                and now - b.last_failure >= self.decay_s:
            b.failures = 0           # a quiet spell forgives old failures
        if b.state == OPEN and now - b.opened_at >= self.open_s:
            b.state = HALF_OPEN
            b.probe_at = 0.0

    # ---------------- outcomes ----------------

    def ok(self, addr: str) -> None:
        b = self._b.get(addr)
        if b is not None:
            b.failures = 0
            b.state = CLOSED

    def fail(self, addr: str, worker_id: int | None = None) -> None:
        now = self._clock()
        b = self._get(addr)
        self._refresh(b, now)
        if worker_id is not None:
            b.worker_id = worker_id
        b.last_failure = now
        b.failures += 1
        if b.state == HALF_OPEN or b.failures >= self.fail_threshold:
            if b.state != OPEN:
                b.trips += 1
            b.state = OPEN
            b.opened_at = now

    # ---------------- admission ----------------

    def allow(self, addr: str) -> bool:
        """Whether to try ``addr`` now: CLOSED always; HALF_OPEN once an
        ``open_s`` window (a permit taken by a caller that then never
        probed lapses, so the breaker cannot stay half-open for ever);
        OPEN never: such a worker is the last resort."""
        b = self._b.get(addr)
        if b is None:
            return True
        now = self._clock()
        self._refresh(b, now)
        if b.state == CLOSED:
            return True
        if b.state == HALF_OPEN and now - b.probe_at >= self.open_s:
            b.probe_at = now
            return True
        return False

    def state(self, addr: str) -> str:
        b = self._b.get(addr)
        if b is None:
            return CLOSED
        self._refresh(b, self._clock())
        return b.state

    def order(self, items: list, key=lambda it: it) -> list:
        """``items`` (each keyed to an address by ``key``) with the
        admitted first and the refused last, each group in its order.
        Nothing is dropped: with every breaker open the caller still
        tries them all."""
        allowed, blocked = [], []
        for it in items:
            (allowed if self.allow(key(it)) else blocked).append(it)
        return allowed + blocked

    def open_worker_ids(self) -> set[int]:
        """The worker ids behind OPEN breakers, for ADD_BLOCK's
        ``exclude_workers``."""
        now = self._clock()
        out: set[int] = set()
        for b in self._b.values():
            self._refresh(b, now)
            if b.state == OPEN and b.worker_id is not None:
                out.add(b.worker_id)
        return out

    def snapshot(self) -> dict[str, dict]:
        now = self._clock()
        out = {}
        for addr, b in self._b.items():
            self._refresh(b, now)
            out[addr] = {"state": b.state, "failures": b.failures,
                         "trips": b.trips, "worker_id": b.worker_id}
        return out
