"""Distributed tracing: the trace context carried across RPC hops, and the
span stores.

Own copy of ``curvine_tpu/obs/trace.py:1-349``. A trace context
``(trace_id, span_id, sampled)`` rides the request header under
``TRACE_KEY``, beside the deadline budget (``rpc/deadline.py``): the
client stamps the ambient context at each request
(``rpc/client.py::Connection``), and ``RpcServer``'s dispatch opens a
server span under it and makes that span ambient for the handler's own
downstream calls. Each process keeps its finished spans in a bounded
ring (``SpanStore``); the master merges its own store, the spans its
clients pushed in METRICS_REPORT and every worker's (GET_SPANS), and
``assemble_tree`` nests them.

Sampling is decided at the root (``SAMPLE_RATE``; children inherit the
flag over the wire), with two backstops that always record: a span that
ended in error, and a span slower than ``SLOW_OP_MS``, which also logs a
slow-op line. These, the store's size and the master's collect timeout
are the reference's ``[obs]`` defaults, constants here
(``common/conf.py::OBS_FIXED``); the table's one field is ``enabled``. A span dict has the reference's keys (``trace_id``,
``span_id``, ``parent``, ``component``, ``op``, ``start``, ``dur``,
``status``, ``attrs``), so that a span of either package assembles in
the other. The ids come from a generator of this module's own, not from
the ``random`` module's shared state."""

from __future__ import annotations

import contextvars
import logging
import random
import time
from collections import deque

log = logging.getLogger(__name__)

# the header field of [trace_id, span_id, sampled]
TRACE_KEY = "trace_ctx"

# the share of new traces sampled at their root
SAMPLE_RATE = 0.01
# a span slower than this logs a slow-op line and is kept
SLOW_OP_MS = 1_000
# the spans a process keeps, newest last
STORE_SIZE = 8192
# the master's wait for the workers' spans when it assembles a trace
COLLECT_TIMEOUT_MS = 2_000

# the ambient span context of the running task (a context variable: two
# concurrent requests never see each other's spans)
_current: contextvars.ContextVar["SpanCtx | None"] = \
    contextvars.ContextVar("curvine_trace_ctx", default=None)

_rng = random.Random()


def current_ctx() -> "SpanCtx | None":
    """The calling task's ambient span context, if any."""
    return _current.get()


def _new_trace_id() -> str:
    return f"{_rng.getrandbits(64):016x}"


def _new_span_id() -> int:
    # 48 bits: unique enough within a trace, small on the wire
    return _rng.getrandbits(48) | 1


class SpanCtx:
    """What crosses the wire: the caller's span, which the callee's span
    names as its parent."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: int, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def stamp(self, header: dict) -> dict:
        header[TRACE_KEY] = [self.trace_id, self.span_id,
                             1 if self.sampled else 0]
        return header

    @classmethod
    def from_header(cls, header: dict | None) -> "SpanCtx | None":
        """The context a request carries; None for none, or for a field
        that is not a trace context (a hostile or foreign header)."""
        if not header:
            return None
        v = header.get(TRACE_KEY)
        if not v:
            return None
        try:
            return cls(str(v[0]), int(v[1]), bool(v[2]))
        except (TypeError, ValueError, IndexError, KeyError):
            return None

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SpanCtx({self.trace_id}, {self.span_id:#x}, "
                f"sampled={self.sampled})")


class SpanStore:
    """A process's bounded ring of finished spans; the oldest fall off
    its head. ``deque.append`` with a maxlen is one atomic step under the
    GIL, so appends from the event loop and from threads need no lock."""

    def __init__(self, capacity: int = STORE_SIZE):
        self.capacity = max(16, int(capacity))
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self.appended = 0

    def append(self, span: dict) -> None:
        self._ring.append(span)
        self.appended += 1

    def extend(self, spans) -> None:
        for s in spans:
            if isinstance(s, dict):
                self.append(s)

    def for_trace(self, trace_id: str) -> list[dict]:
        return [s for s in list(self._ring)
                if s.get("trace_id") == trace_id]

    def drain(self, max_n: int = 512) -> list[dict]:
        """Take up to ``max_n`` of the oldest spans out (a client's ship
        to the master)."""
        out = []
        while len(out) < max_n:
            try:
                out.append(self._ring.popleft())
            except IndexError:
                break
        return out

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    def stats(self) -> dict:
        return {"stored": len(self._ring), "appended": self.appended,
                "capacity": self.capacity}


class Span:
    """One timed operation: a context manager (it makes its context
    ambient, so nested spans and outbound requests link to it), or held
    and ended by ``finish()`` where it starts and ends in different
    tasks (an inbound block stream)."""

    __slots__ = ("tracer", "ctx", "parent_id", "op", "attrs", "start",
                 "_t0", "status", "dur", "_token", "_finished")

    def __init__(self, tracer: "Tracer", ctx: SpanCtx, parent_id: int,
                 op: str, attrs: dict):
        self.tracer = tracer
        self.ctx = ctx
        self.parent_id = parent_id
        self.op = op
        self.attrs = attrs
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.status = "ok"
        self.dur = 0.0
        self._token = None
        self._finished = False

    def set_attr(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def error(self, cause="") -> "Span":
        self.status = "error"
        if cause:
            self.attrs["error"] = str(cause)[:200]
        return self

    def finish(self, status: str | None = None) -> None:
        if self._finished:
            return
        self._finished = True
        if status is not None:
            self.status = status
        self.dur = time.perf_counter() - self._t0
        self.tracer._record(self)

    def __enter__(self) -> "Span":
        self._token = _current.set(self.ctx)
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if et is not None and self.status == "ok":
            self.error(f"{et.__name__}: {ev}")
        self.finish()
        return False


class _NullSpan:
    """The span of a disabled tracer: nothing allocated, nothing kept."""

    __slots__ = ()
    ctx = None
    status = "ok"

    def set_attr(self, key, value):
        return self

    def error(self, cause=""):
        return self

    def finish(self, status=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """A component's tracing front end: the sampling decision, span
    creation, the bounded store and the slow-op backstop."""

    def __init__(self, component: str, sample_rate: float = SAMPLE_RATE,
                 slow_op_ms: int = SLOW_OP_MS, capacity: int = STORE_SIZE,
                 metrics=None, enabled: bool = True):
        self.component = component
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self.slow_s = max(0.0, slow_op_ms / 1000.0)
        self.store = SpanStore(capacity)
        self.metrics = metrics
        self.enabled = enabled
        self.last_trace_id: str | None = None

    @classmethod
    def from_conf(cls, component: str, obs_conf, metrics=None) -> "Tracer":
        """A tracer from the ``[obs]`` table (``common/conf.py::ObsConf``):
        on or off, the rest at the constants."""
        return cls(component, metrics=metrics, enabled=obs_conf.enabled)

    # ---------------- span creation ----------------

    def start_trace(self, op: str, attrs: dict | None = None,
                    sampled: bool | None = None):
        """A new root span, sampled at the rate unless ``sampled`` says."""
        if not self.enabled:
            return NULL_SPAN
        if sampled is None:
            sampled = _rng.random() < self.sample_rate
        ctx = SpanCtx(_new_trace_id(), _new_span_id(), sampled)
        self.last_trace_id = ctx.trace_id
        return Span(self, ctx, 0, op, dict(attrs or {}))

    def span(self, op: str, attrs: dict | None = None, parent=None):
        """A child of ``parent`` (a ``SpanCtx``, such as a request's) or of
        the ambient context; with neither, a new root."""
        if not self.enabled:
            return NULL_SPAN
        p = parent if parent is not None else _current.get()
        if p is None:
            return self.start_trace(op, attrs)
        ctx = SpanCtx(p.trace_id, _new_span_id(), p.sampled)
        return Span(self, ctx, p.span_id, op, dict(attrs or {}))

    # ---------------- record and query ----------------

    def _record(self, span: Span) -> None:
        slow = 0.0 < self.slow_s <= span.dur
        keep = span.ctx.sampled or span.status != "ok" or slow
        if self.metrics is not None:
            self.metrics.inc("trace.spans_recorded" if keep
                             else "trace.spans_dropped")
        if slow:
            log.warning(
                "slow-op component=%s op=%s dur_ms=%.1f status=%s "
                "trace_id=%s span_id=%x attrs=%s",
                self.component, span.op, span.dur * 1000, span.status,
                span.ctx.trace_id, span.ctx.span_id, span.attrs)
        if not keep:
            return
        self.store.append({
            "trace_id": span.ctx.trace_id, "span_id": span.ctx.span_id,
            "parent": span.parent_id, "component": self.component,
            "op": span.op, "start": span.start, "dur": span.dur,
            "status": span.status, "attrs": span.attrs,
        })

    def spans_for(self, trace_id: str) -> list[dict]:
        return self.store.for_trace(trace_id)

    def ingest(self, spans) -> None:
        """Keep spans another process shipped here (a client's push)."""
        self.store.extend(spans)

    def drain(self, max_n: int = 512) -> list[dict]:
        return self.store.drain(max_n)


# ---------------- tree assembly and rendering ----------------

def assemble_tree(spans: list[dict]) -> list[dict]:
    """Nest spans by their parent links, children by start time. A span
    whose parent was not collected (a client span not flushed yet)
    becomes one more root rather than vanishing."""
    nodes = {s["span_id"]: {**s, "children": []} for s in spans
             if "span_id" in s}
    roots: list[dict] = []
    for n in nodes.values():
        parent = nodes.get(n.get("parent"))
        if parent is not None and parent is not n:
            parent["children"].append(n)
        else:
            roots.append(n)

    def _sort(node: dict) -> None:
        node["children"].sort(key=lambda c: c.get("start", 0.0))
        for c in node["children"]:
            _sort(c)

    roots.sort(key=lambda r: r.get("start", 0.0))
    for r in roots:
        _sort(r)
    return roots


def render_tree(roots: list[dict], trace_id: str = "") -> str:
    """The tree as text, one span a line."""
    def count(n: dict) -> int:
        return 1 + sum(count(c) for c in n["children"])

    total = sum(count(r) for r in roots)
    comps = set()

    def walk(n: dict, prefix: str, is_last: bool, top: bool,
             out: list[str]) -> None:
        comps.add(n.get("component", "?"))
        attrs = {k: v for k, v in (n.get("attrs") or {}).items()}
        tail = f"  {attrs}" if attrs else ""
        mark = "" if top else ("└─ " if is_last else "├─ ")
        out.append(f"{prefix}{mark}{n.get('component', '?')}:"
                   f"{n.get('op', '?')} {n.get('dur', 0.0) * 1000:.2f}ms "
                   f"[{n.get('status', '?')}]{tail}")
        child_prefix = prefix if top else \
            prefix + ("   " if is_last else "│  ")
        kids = n["children"]
        for i, c in enumerate(kids):
            walk(c, child_prefix, i == len(kids) - 1, False, out)

    lines: list[str] = []
    for r in roots:
        walk(r, "", True, True, lines)
    head = (f"trace {trace_id or (roots[0]['trace_id'] if roots else '?')}"
            f" ({total} spans, {len(comps)} components)")
    return "\n".join([head] + lines)
