"""Metrics registry: counters, gauges, histograms; prometheus text format.

Port of ``curvine_tpu/common/metrics.py`` (its own copy): the device
tier's ``export_metrics`` and the ingest ``StepProfiler`` publish here,
under the same names and bucket bounds as the JAX package."""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager

_BUCKETS = [0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
            0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]


class Histogram:
    def __init__(self) -> None:
        self.buckets = [0] * (len(_BUCKETS) + 1)
        self.count = 0
        self.sum = 0.0
        # observations past the last bucket bound (10s): tracked
        # explicitly so slow-op tails are visible instead of silently
        # clamped, with the max observed value anchoring the estimate
        self.overflow = 0
        self.max = 0.0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(_BUCKETS, v)
        self.buckets[i] += 1
        if i == len(_BUCKETS):
            self.overflow += 1
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Approximate quantile, linearly interpolated WITHIN the
        containing bucket (bucket upper bounds alone bias every estimate
        high by up to a full bucket width). The overflow bucket (>10s)
        interpolates toward the max observed value instead of clamping
        to 10.0, so a p99 of genuinely slow ops is not silently capped."""
        if self.count == 0:
            return 0.0
        target = min(max(q, 0.0), 1.0) * self.count
        acc = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if acc + c >= target:
                lo = 0.0 if i == 0 else _BUCKETS[i - 1]
                hi = _BUCKETS[i] if i < len(_BUCKETS) \
                    else max(self.max, _BUCKETS[-1])
                frac = (target - acc) / c
                return lo + (hi - lo) * frac
            acc += c
        return self.max or _BUCKETS[-1]


class MetricsRegistry:
    def __init__(self, component: str):
        self.component = component
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    def inc(self, name: str, v: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + v

    def gauge(self, name: str, v: float) -> None:
        self.gauges[name] = v

    def observe(self, name: str, v: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.observe(v)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def as_dict(self) -> dict[str, float]:
        """Flat counters+gauges snapshot (dashboard JSON feed)."""
        out = dict(self.counters)
        out.update(self.gauges)
        return out

    def prometheus_text(self) -> str:
        lines = []
        pre = f"curvine_{self.component}_"
        esc = lambda n: n.replace(".", "_").replace("-", "_")
        for n, v in sorted(self.counters.items()):
            lines.append(f"# TYPE {pre}{esc(n)} counter")
            lines.append(f"{pre}{esc(n)} {v}")
        for n, v in sorted(self.gauges.items()):
            lines.append(f"# TYPE {pre}{esc(n)} gauge")
            lines.append(f"{pre}{esc(n)} {v}")
        for n, h in sorted(self.histograms.items()):
            name = pre + esc(n)
            lines.append(f"# TYPE {name} histogram")
            acc = 0
            for i, le in enumerate(_BUCKETS):
                acc += h.buckets[i]
                lines.append(f'{name}_bucket{{le="{le}"}} {acc}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{name}_sum {h.sum}")
            lines.append(f"{name}_count {h.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {n: {"count": h.count, "sum": h.sum,
                               "p50": h.quantile(0.5), "p99": h.quantile(0.99),
                               "overflow": h.overflow, "max": h.max}
                           for n, h in self.histograms.items()},
        }
