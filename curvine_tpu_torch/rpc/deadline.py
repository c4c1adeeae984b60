"""Deadline budgets carried across RPC hops.

Own copy of ``curvine_tpu/rpc/deadline.py``: a caller's time budget
rides the request header (``DEADLINE_KEY``, the remaining milliseconds,
restamped at each hop), a hop's wait is ``min(its timeout, remaining)``,
or ``remaining / hops_left`` where the caller still has replicas to try
(``sub``), and a server fails a request whose budget is already spent
instead of doing work its caller no longer waits for. The reader gives
each read its ``op_deadline_ms``; the replication manager gives each
pull it dispatches a budget, and the destination's stream from the
source then fails inside it rather than after a whole RPC timeout."""

from __future__ import annotations

import time

from curvine_tpu_torch.common.errors import RpcTimeout

# the header key of the remaining budget in ms (restamped per hop)
DEADLINE_KEY = "deadline_ms"

# the least wait: a wait under a millisecond would time out before the
# event loop even schedules the receive
MIN_WAIT_S = 0.001


class Deadline:
    """A monotonic expiry point; each hop takes its wait from
    ``remaining()``."""

    __slots__ = ("expiry",)

    def __init__(self, budget_s: float):
        self.expiry = time.monotonic() + max(0.0, budget_s)

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(ms / 1000.0)

    @classmethod
    def from_header(cls, header: dict | None) -> "Deadline | None":
        """The budget a peer stamped into a request header, restarted on
        this process's clock (the header carries a duration, so clock
        skew does not matter; the wire's latency eats into the budget,
        the safe side)."""
        if not header:
            return None
        ms = header.get(DEADLINE_KEY)
        if ms is None:
            return None
        return cls.after_ms(float(ms))

    def remaining(self) -> float:
        return max(0.0, self.expiry - time.monotonic())

    def remaining_ms(self) -> int:
        return int(self.remaining() * 1000)

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.expiry

    def cap(self, timeout_s: float | None) -> float:
        """A hop's wait: min(its timeout, the remaining budget)."""
        r = max(self.remaining(), MIN_WAIT_S)
        return r if timeout_s is None else min(timeout_s, r)

    def sub(self, hops_left: int) -> "Deadline":
        """The remaining budget split evenly over ``hops_left`` attempts
        in turn: with N replicas left, a wedged one takes 1/N of what
        remains, and the next is reached inside the budget."""
        return Deadline(self.remaining() / max(1, hops_left))

    def check(self, what: str = "operation") -> None:
        if self.expired:
            raise RpcTimeout(f"{what}: deadline budget exhausted")

    def stamp(self, header: dict) -> dict:
        header[DEADLINE_KEY] = self.remaining_ms()
        return header

    def __repr__(self) -> str:  # pragma: no cover
        return f"Deadline(remaining={self.remaining():.3f}s)"
