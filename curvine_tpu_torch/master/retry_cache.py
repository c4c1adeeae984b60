"""Retry cache: a retried mutation gets its first reply again.

Own copy of ``curvine_tpu/master/retry_cache.py``: keyed by the
client's ``(client_id, call_id)``, it keeps the packed reply for
``ttl_ms`` (at most ``capacity`` entries, least recently used out first),
so a retransmitted mutation is not applied twice."""

from __future__ import annotations

import time
from collections import OrderedDict


class RetryCache:
    def __init__(self, capacity: int = 100_000, ttl_ms: int = 600_000):
        self.capacity = capacity
        self.ttl_ms = ttl_ms
        self._entries: OrderedDict[tuple, tuple[float, object]] = OrderedDict()

    def get(self, key: tuple) -> object | None:
        ent = self._entries.get(key)
        if ent is None:
            return None
        ts, value = ent
        if (time.time() - ts) * 1000 > self.ttl_ms:
            del self._entries[key]
            return None
        self._entries.move_to_end(key)
        return value

    def put(self, key: tuple, value: object) -> None:
        self._entries[key] = (time.time(), value)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
