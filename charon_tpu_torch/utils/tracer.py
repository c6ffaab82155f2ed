"""Lightweight tracing: spans with deterministic duty-derived trace IDs; the
port's copy of charon_tpu/utils/tracer.py.

Mirrors the reference's app/tracer (trace.go:27-123) + core/tracing.go:21-39:
every duty gets a trace ID derived deterministically from {slot, type} so all
peers' spans join into one cluster-wide trace. Spans are recorded in-process
(inspectable in tests, dumpable as JSON) rather than exported to Jaeger; the
exporter seam is a callback.

The in-process buffer doubles as the duty flight recorder: spans carry point
*events* (phase markers inside a span), overflow is counted in
`tracer_dropped_spans_total`, and the whole buffer exports as Chrome
trace-event JSON (`to_chrome_trace`/`write_chrome_trace`) loadable in
Perfetto or chrome://tracing — one process row per trace (duty), one thread
row per span name (pipeline step).
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from . import metrics

_current_trace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "charon_trace_id", default=None)
_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "charon_span", default=None)


@dataclass
class SpanEvent:
    """A point-in-time marker inside a span (phase transitions, fences)."""

    name: str
    ts: float
    attrs: dict[str, Any] = field(default_factory=dict)


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    start: float
    end: float = 0.0
    attrs: dict[str, Any] = field(default_factory=dict)
    events: list[SpanEvent] = field(default_factory=list)

    def add_event(self, name: str, **attrs: Any) -> SpanEvent:
        ev = SpanEvent(name, time.time(), dict(attrs))
        self.events.append(ev)
        return ev


_lock = threading.Lock()
_finished: list[Span] = []
_exporter: Callable[[Span], None] | None = None
_DEFAULT_MAX_BUFFER = 10_000
_max_buffer = _DEFAULT_MAX_BUFFER

_dropped_counter = metrics.counter(
    "tracer_dropped_spans_total",
    "Finished spans evicted from the in-process ring buffer")


def set_exporter(exporter: Callable[[Span], None] | None) -> None:
    global _exporter
    _exporter = exporter


def set_max_buffer(size: int) -> None:
    """Resize the finished-span ring buffer (default 10k spans)."""
    global _max_buffer
    if size < 2:
        raise ValueError(f"buffer size must be >= 2, got {size}")
    _max_buffer = int(size)


def rooted_ctx(duty_slot: int, duty_type: str) -> str:
    """Deterministic trace root for a duty (reference core/tracing.go:21):
    identical on every peer, so cluster-wide spans join."""
    h = hashlib.sha256(f"charon/duty/{duty_slot}/{duty_type}".encode()).hexdigest()
    trace_id = h[:32]
    _current_trace.set(trace_id)
    _current_span.set(None)
    _remote_parent.set(None)
    return trace_id


def duty_trace_id(duty_slot: int, duty_type: str) -> str:
    """The trace id `rooted_ctx` would set, without touching the context —
    for consumers that only need to FIND a duty's spans (tracker timelines,
    the /debug/duty endpoint)."""
    h = hashlib.sha256(f"charon/duty/{duty_slot}/{duty_type}".encode()).hexdigest()
    return h[:32]


def current_trace_id() -> str | None:
    """The calling task's trace id, or None outside any trace."""
    return _current_trace.get()


# -- cross-node context carry ------------------------------------------------
#
# Duty traffic aligns across nodes for free (deterministic duty trace ids),
# but parent-span linkage — and ANY alignment for non-duty messages — needs
# the sender's context stamped into the p2p envelope. `current_context()`
# renders the calling task's context as a plain JSON-safe dict the p2p
# adapters drop into their payloads; `attach_context()` on the receive path
# adopts it (tolerating absence: a peer running an older build simply omits
# the key, and duty handlers fall back to `rooted_ctx`). The remote parent
# span id is carried in a dedicated contextvar, so the receiver's next
# `start_span` parents under the sender's span without holding a local Span
# object for it.

_remote_parent: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "charon_remote_parent", default=None)


def current_context() -> dict[str, str] | None:
    """Wire-portable form of the calling task's trace context (or None)."""
    trace_id = _current_trace.get()
    if trace_id is None:
        return None
    ctx: dict[str, str] = {"trace_id": trace_id}
    span = _current_span.get()
    if span is not None:
        ctx["span_id"] = span.span_id
    return ctx


def attach_context(ctx: Any) -> str | None:
    """Adopt a peer's wire context; returns the trace id, or None when the
    envelope carried no usable context (old peer / non-traced sender)."""
    if not isinstance(ctx, dict):
        return None
    trace_id = ctx.get("trace_id")
    if not isinstance(trace_id, str) or not trace_id:
        return None
    _current_trace.set(trace_id)
    _current_span.set(None)
    span_id = ctx.get("span_id")
    _remote_parent.set(span_id if isinstance(span_id, str) and span_id else None)
    return trace_id


@contextmanager
def start_span(name: str, **attrs: Any):
    trace_id = _current_trace.get()
    if trace_id is None:
        trace_id = hashlib.sha256(f"{name}{time.time_ns()}".encode()).hexdigest()[:32]
        _current_trace.set(trace_id)
    parent = _current_span.get()
    parent_id = parent.span_id if parent is not None else _remote_parent.get()
    span_id = hashlib.sha256(
        f"{trace_id}{parent_id}{name}{time.monotonic_ns()}".encode()).hexdigest()[:16]
    span = Span(trace_id, span_id, parent_id, name, time.time(), attrs=dict(attrs))
    token = _current_span.set(span)
    try:
        yield span
    finally:
        span.end = time.time()
        _current_span.reset(token)
        with _lock:
            _finished.append(span)
            if len(_finished) > _max_buffer:
                drop = _max_buffer // 2
                del _finished[:drop]
                _dropped_counter.inc(amount=drop)
        if _exporter is not None:
            _exporter(span)


def event(name: str, **attrs: Any) -> SpanEvent | None:
    """Attach a point event to the currently-open span (no-op outside one)."""
    span = _current_span.get()
    if span is None:
        return None
    return span.add_event(name, **attrs)


def finished_spans() -> list[Span]:
    with _lock:
        return list(_finished)


def spans_for_trace(trace_id: str) -> list[Span]:
    """All finished spans of one trace, in start order."""
    with _lock:
        spans = [s for s in _finished if s.trace_id == trace_id]
    return sorted(spans, key=lambda s: s.start)


def reset_for_testing() -> None:
    global _max_buffer
    with _lock:
        _finished.clear()
    _max_buffer = _DEFAULT_MAX_BUFFER


# Back-compat alias (pre-rename API used throughout older tests).
reset_for_t = reset_for_testing


# -- Chrome trace-event / Perfetto export -----------------------------------
#
# The Chrome trace-event JSON object format ({"traceEvents": [...]}) loads in
# both chrome://tracing and Perfetto. Rows: each trace id becomes a process
# (pid) so one duty's flight is one horizontal band; each span name becomes a
# thread (tid) inside it so pipeline steps stack in wiring order. Complete
# events use ph="X" with microsecond ts/dur; span events export as ph="i"
# thread-scoped instants.


def to_chrome_trace(spans: Iterable[Span] | None = None) -> dict:
    """Render spans as a Chrome trace-event JSON object (dict)."""
    if spans is None:
        spans = finished_spans()
    pids: dict[str, int] = {}
    tids: dict[str, int] = {}
    out: list[dict] = []
    for span in spans:
        pid = pids.setdefault(span.trace_id, len(pids) + 1)
        tid = tids.setdefault(span.name, len(tids) + 1)
        args = {k: str(v) for k, v in span.attrs.items()}
        args["trace_id"] = span.trace_id
        args["span_id"] = span.span_id
        if span.parent_id:
            args["parent_id"] = span.parent_id
        end = span.end if span.end else span.start
        out.append({
            "name": span.name,
            "cat": "charon",
            "ph": "X",
            "ts": span.start * 1e6,
            "dur": max(end - span.start, 0.0) * 1e6,
            "pid": pid,
            "tid": tid,
            "args": args,
        })
        for ev in span.events:
            out.append({
                "name": ev.name,
                "cat": "charon",
                "ph": "i",
                "s": "t",
                "ts": ev.ts * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {k: str(v) for k, v in ev.attrs.items()},
            })
    # Row labels: trace id on the process, span name on the thread.
    for trace_id, pid in pids.items():
        out.append({"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                    "tid": 0, "args": {"name": f"trace {trace_id}"}})
    for name, tid in tids.items():
        for pid in pids.values():
            out.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
                        "tid": tid, "args": {"name": name}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Span] | None = None) -> str:
    """Write one Chrome-trace JSON file (one file per run) and return path."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_chrome_trace(spans), f)
    return path


# -- cluster trace merging ---------------------------------------------------
#
# A ComposeCluster (or a real multi-host mesh) has one span buffer per NODE;
# the /debug/traces endpoint serves each node's buffer as JSON. merge_cluster
# joins them into one Chrome trace with per-node lanes: each node becomes a
# process (pid) so the cluster reads as N horizontal bands, each span name a
# thread (tid) shared across nodes so the same pipeline step lines up
# vertically. Clock alignment rides the deterministic duty trace ids: for
# every trace id two nodes share, the first-span start offsets estimate the
# pairwise clock skew, and each node's timestamps are shifted by the median
# estimate against the reference node (the first lane). Nodes sharing no
# trace with the reference stay unshifted.


def span_from_json(obj: dict) -> Span:
    """Rebuild a Span from its /debug/traces JSON form."""
    span = Span(
        trace_id=str(obj.get("trace_id", "")),
        span_id=str(obj.get("span_id", "")),
        parent_id=obj.get("parent_id") or None,
        name=str(obj.get("name", "")),
        start=float(obj.get("start", 0.0)),
        end=float(obj.get("end") or 0.0),
        attrs=dict(obj.get("attrs") or {}),
    )
    for ev in obj.get("events") or []:
        span.events.append(SpanEvent(str(ev.get("name", "")),
                                     float(ev.get("ts", 0.0)),
                                     dict(ev.get("attrs") or {})))
    return span


def _coerce_spans(spans: Iterable[Span | dict]) -> list[Span]:
    return [s if isinstance(s, Span) else span_from_json(s) for s in spans]


def _skew_to_reference(ref: list[Span], other: list[Span]) -> float:
    """Median offset (seconds) to ADD to `other`'s timestamps so shared
    traces' first spans line up with `ref`'s. 0.0 when nothing is shared."""
    ref_first: dict[str, float] = {}
    for s in ref:
        if s.trace_id not in ref_first or s.start < ref_first[s.trace_id]:
            ref_first[s.trace_id] = s.start
    deltas: list[float] = []
    other_first: dict[str, float] = {}
    for s in other:
        if s.trace_id not in other_first or s.start < other_first[s.trace_id]:
            other_first[s.trace_id] = s.start
    for tid, start in other_first.items():
        if tid in ref_first:
            deltas.append(ref_first[tid] - start)
    if not deltas:
        return 0.0
    deltas.sort()
    return deltas[len(deltas) // 2]


def merge_cluster(node_spans: dict[str, Iterable[Span | dict]],
                  align: bool = True) -> dict:
    """Merge per-node span sets into ONE clock-aligned Chrome trace.

    `node_spans` maps node name -> spans (Span objects or /debug/traces JSON
    dicts). Returns the Chrome trace-event object: pid = node lane (labeled
    with the node name and its applied skew), tid = span name (shared across
    lanes), span/event args carry trace_id so Perfetto can filter one duty
    across all lanes.
    """
    lanes = {name: _coerce_spans(spans) for name, spans in node_spans.items()}
    names = list(lanes)
    offsets = {name: 0.0 for name in names}
    if align and len(names) > 1:
        ref = lanes[names[0]]
        for name in names[1:]:
            offsets[name] = _skew_to_reference(ref, lanes[name])
    tids: dict[str, int] = {}
    out: list[dict] = []
    for pid, name in enumerate(names, start=1):
        off = offsets[name]
        for span in lanes[name]:
            tid = tids.setdefault(span.name, len(tids) + 1)
            args = {k: str(v) for k, v in span.attrs.items()}
            args["trace_id"] = span.trace_id
            args["span_id"] = span.span_id
            args["node"] = name
            if span.parent_id:
                args["parent_id"] = span.parent_id
            end = span.end if span.end else span.start
            out.append({
                "name": span.name,
                "cat": "charon",
                "ph": "X",
                "ts": (span.start + off) * 1e6,
                "dur": max(end - span.start, 0.0) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": args,
            })
            for ev in span.events:
                out.append({
                    "name": ev.name,
                    "cat": "charon",
                    "ph": "i",
                    "s": "t",
                    "ts": (ev.ts + off) * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": {k: str(v) for k, v in ev.attrs.items()},
                })
    for pid, name in enumerate(names, start=1):
        label = name if not offsets[name] else f"{name} (skew {offsets[name] * 1e3:+.1f}ms)"
        out.append({"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                    "tid": 0, "args": {"name": label}})
        for sname, tid in tids.items():
            out.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
                        "tid": tid, "args": {"name": sname}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}
