"""Engine telemetry: span tracing, lifecycle metrics, Perfetto export.

Three pieces, each off by default and costing nothing when off, with the
JAX package's names and behaviour:

  * :class:`Tracer` — a fixed-capacity ring buffer of *spans*.  Code
    brackets a phase with ``with tracer.span("prefill", lanes=4):`` and
    the tracer records (name, start, end, depth, attrs) on the host
    clock.  CUDA launches are asynchronous, so a host timer measures
    *enqueue* time; ``sync=True`` calls the barrier ``sync_fn`` at BOTH
    span edges.  The engine wires ``torch.cuda.synchronize(pool device)``
    there (nothing on the CPU, whose ops finish before they return), so
    a synced span's duration includes the device work it launched.  The
    buffer wraps: the newest ``capacity`` spans survive.

  * :class:`MetricsRegistry` — :class:`Counter` / :class:`Gauge` /
    :class:`Histogram` behind one ``snapshot()``.  Gauges are set values
    or zero-argument callbacks read at snapshot time (how the KV pool's
    occupancy reaches the registry without the pool knowing about it);
    histograms keep raw samples and compute percentiles with
    ``numpy.percentile``, so in-engine TTFT/ITL percentiles equal any
    recomputation from the same timestamps.  A callback reaches its owner
    through a weak reference (:func:`weak_gauge`, :func:`weak_method`), so
    a registry or a tracer that its owner holds makes no reference cycle:
    refcounting frees an engine, its KV pool and its adapter on ``del``.

  * Chrome/Perfetto export — :meth:`Tracer.chrome_events` renders the
    ring as trace-event-format complete events plus instant events for
    lifecycle marks; :func:`validate_chrome_trace` is the schema gate.

Where PyTorch differs from JAX: the JAX tracer may wrap a span in
``jax.profiler.TraceAnnotation``; here every span of a live tracer with
``annotate`` (the default) also opens a
``torch.profiler.record_function(name)`` range, which carries the span's
name only (no attributes), so a ``torch.profiler`` trace nests the CUDA
kernels a dispatch launched under the engine's span.  :data:`NULL_TRACER`
opens nothing.

Span taxonomy: the engine's root span per tick is ``step``; its direct
children are ``schedule``, ``prefill``, ``decode`` and ``verify``; the
adapter's dispatch spans (``dispatch:prefill_paged``,
``dispatch:decode_paged``, ``dispatch:decode_paged_sample``,
``dispatch:verify_paged``, ``dispatch:activation_probe``) and ``emit`` /
``draft`` nest inside their phase.  :func:`phase_breakdown` turns a trace
back into per-phase totals and a coverage ratio (phase time / step time).
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import sys
import time
import weakref
from typing import Callable, Optional

import numpy as np
from torch.profiler import record_function

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "emit_metrics_line",
    "format_metrics_line",
    "phase_breakdown",
    "validate_chrome_trace",
    "weak_gauge",
    "weak_method",
]


def weak_gauge(owner, fn: Callable) -> Callable[[], object]:
    """A gauge callback reading ``fn(owner)`` that holds ``owner`` weakly:
    it reads None once the owner is gone."""
    ref = weakref.ref(owner)

    def read():
        o = ref()
        return None if o is None else fn(o)

    return read


def weak_method(fn: Callable) -> Callable:
    """``fn``, holding its instance weakly when it is a bound method (any
    other callable is returned as it is).  Calling it once the instance is
    gone raises ``ReferenceError``."""
    if not inspect.ismethod(fn):
        return fn
    ref, name = weakref.WeakMethod(fn), fn.__qualname__

    def call(*args, **kwargs):
        m = ref()
        if m is None:
            raise ReferenceError(f"{name}: its owner is gone")
        return m(*args, **kwargs)

    return call


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    """One recorded interval.  ``t0``/``t1`` are tracer-clock seconds;
    ``depth`` is the nesting level at record time (0 = root); instant
    events (lifecycle marks) have ``t1 == t0``."""

    name: str
    t0: float
    t1: float
    depth: int
    attrs: Optional[dict] = None
    instant: bool = False  # lifecycle mark recorded via Tracer.event

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _SpanHandle:
    """Context manager for one live span; records into the ring on exit."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_depth", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._range = None

    def __enter__(self):
        tr = self._tracer
        if tr.sync:
            tr._sync()
        if tr.annotate:
            self._range = record_function(self._name)
            self._range.__enter__()
        self._depth = tr._depth
        tr._depth += 1
        self._t0 = tr.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tracer
        if tr.sync:
            tr._sync()
        t1 = tr.clock()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        tr._depth -= 1
        tr._record(Span(self._name, self._t0, t1, self._depth, self._attrs))
        return False


class _NullSpan:
    """Shared no-op context manager: a disabled tracer's whole cost is one
    method call returning this singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffer span tracer (see module docstring).

    Parameters:
      capacity   — max retained spans; older spans are overwritten.
      sync       — call ``sync_fn`` at span edges so durations include
                   the device work, not just the launches.
      sync_fn    — zero-arg barrier; the engine wires
                   ``torch.cuda.synchronize`` on its pool's device.
      annotate   — open a ``torch.profiler.record_function`` range per
                   span.
      clock      — monotonic seconds; the engine passes its own clock
                   (``Engine.now``) so spans share the arrival epoch.
      tags       — dict merged into every exported event's args.
    """

    enabled = True

    def __init__(
        self,
        capacity: int = 1 << 16,
        *,
        sync: bool = False,
        sync_fn: Optional[Callable[[], None]] = None,
        annotate: bool = True,
        clock: Callable[[], float] = time.perf_counter,
        tags: Optional[dict] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.sync = sync
        self.sync_fn = sync_fn
        self.annotate = annotate
        self.clock = clock
        self.tags = dict(tags or {})
        self._ring: list = [None] * capacity
        self._n = 0  # total spans ever recorded (ring index = _n % capacity)
        self._depth = 0
        self.dropped = 0  # spans overwritten by wraparound

    # ---- recording ------------------------------------------------------

    def span(self, name: str, **attrs) -> _SpanHandle:
        return _SpanHandle(self, name, attrs or None)

    def event(self, name: str, **attrs) -> None:
        """Record an instant event (a lifecycle mark) at the current time."""
        t = self.clock()
        self._record(Span(name, t, t, self._depth, attrs or None, instant=True))

    def _record(self, span: Span) -> None:
        if self._n >= self.capacity:
            self.dropped += 1
        self._ring[self._n % self.capacity] = span
        self._n += 1

    def _sync(self) -> None:
        if self.sync_fn is not None:
            self.sync_fn()

    # ---- reading --------------------------------------------------------

    @property
    def spans(self) -> list:
        """Retained spans, oldest first (wraparound already resolved)."""
        if self._n <= self.capacity:
            return list(self._ring[: self._n])
        i = self._n % self.capacity
        return self._ring[i:] + self._ring[:i]

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def clear(self) -> None:
        self._ring = [None] * self.capacity
        self._n = 0
        self.dropped = 0

    # ---- export ---------------------------------------------------------

    def chrome_events(self) -> list:
        """Trace-event-format events: complete ("X") for spans, instant
        ("i") for zero-duration lifecycle marks.  Timestamps in µs."""
        events = []
        for s in self.spans:
            args = dict(self.tags)
            if s.attrs:
                args.update(s.attrs)
            ev = {
                "name": s.name,
                "cat": "engine",
                "ts": s.t0 * 1e6,
                "pid": 0,
                "tid": 0,
                "args": args,
            }
            if s.instant:
                ev["ph"] = "i"
                ev["s"] = "t"  # instant scope: thread
            else:
                ev["ph"] = "X"
                ev["dur"] = s.dur * 1e6
            events.append(ev)
        return events

    def export_chrome_trace(self, path) -> dict:
        """Write the trace as Chrome/Perfetto trace-event JSON (open in
        https://ui.perfetto.dev); returns the written object."""
        obj = {
            "traceEvents": [
                {  # name the single engine row
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": 0,
                    "args": {"name": "engine"},
                },
                *self.chrome_events(),
            ],
            "displayTimeUnit": "ms",
            "otherData": {
                "tracer": "repro_torch.serve.telemetry",
                "sync": self.sync,
                "dropped_spans": self.dropped,
                **{str(k): str(v) for k, v in self.tags.items()},
            },
        }
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj


class _NullTracer(Tracer):
    """Disabled tracer: ``span()`` hands back one shared no-op context
    manager and nothing is recorded or annotated.  The engine default."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=1, annotate=False)

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def event(self, name: str, **attrs) -> None:
        pass

    def _record(self, span: Span) -> None:  # pragma: no cover - unreachable
        pass


NULL_TRACER = _NullTracer()


# ---------------------------------------------------------------------------
# trace analysis + schema validation
# ---------------------------------------------------------------------------


def phase_breakdown(spans, root: str = "step") -> dict:
    """Aggregate spans into per-phase totals and a coverage ratio.

    A *phase* is any span recorded at ``depth == root_depth + 1`` (the
    engine's ``schedule``/``prefill``/``decode``/``verify``).  Returns::

        {"root_s": total root time, "root_count": n,
         "phases": {name: {"time_s", "count", "share"}},
         "coverage": phase time / root time}
    """
    roots = [s for s in spans if s.name == root]
    root_s = sum(s.dur for s in roots)
    depth = roots[0].depth + 1 if roots else 1
    phases: dict = {}
    for s in spans:
        if s.depth != depth or s.instant or s.name == root:
            continue
        p = phases.setdefault(s.name, {"time_s": 0.0, "count": 0})
        p["time_s"] += s.dur
        p["count"] += 1
    covered = sum(p["time_s"] for p in phases.values())
    for p in phases.values():
        p["share"] = p["time_s"] / root_s if root_s > 0 else 0.0
    return {
        "root_s": root_s,
        "root_count": len(roots),
        "phases": phases,
        "coverage": covered / root_s if root_s > 0 else 0.0,
    }


def validate_chrome_trace(obj) -> int:
    """Validate a trace-event JSON object: the envelope and every event
    (required keys, known phase types, numeric non-negative timestamps,
    ``dur`` exactly on complete events).  Returns the number of
    non-metadata events; raises ``ValueError`` on the first violation."""
    if not isinstance(obj, dict):
        raise ValueError(f"trace must be a JSON object, got {type(obj).__name__}")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace object missing 'traceEvents' list")
    n = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "C", "B", "E"):
            raise ValueError(f"traceEvents[{i}] bad phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"traceEvents[{i}] missing name")
        if ph == "M":
            continue  # metadata events carry no timestamp
        n += 1
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"traceEvents[{i}] bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}] bad dur {dur!r}")
        elif "dur" in ev:
            raise ValueError(f"traceEvents[{i}] ph={ph!r} must not carry dur")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"traceEvents[{i}] bad {key}")
    if n == 0:
        raise ValueError("trace contains no events")
    return n


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def peak(self, v) -> None:
        """Track a high-water mark (e.g. widest prefill batch seen)."""
        if v > self.value:
            self.value = v

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time value: set explicitly or pulled from a zero-argument
    callback at snapshot time (None once a :func:`weak_gauge`'s owner is
    gone)."""

    __slots__ = ("name", "_value", "fn")

    def __init__(self, name: str, fn: Optional[Callable] = None):
        self.name = name
        self._value = 0
        self.fn = fn

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        return self.fn() if self.fn is not None else self._value

    def reset(self) -> None:
        self._value = 0


class Histogram:
    """Raw-sample histogram; percentiles via ``numpy.percentile`` — the
    one latency-percentile implementation, so a consumer recomputing from
    the same samples gets bit-identical answers."""

    __slots__ = ("name", "samples")

    def __init__(self, name: str):
        self.name = name
        self.samples: list = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(np.sum(self.samples)) if self.samples else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """q-th percentile, or None when empty (serializes as JSON null)."""
        if not self.samples:
            return None
        return float(np.percentile(np.asarray(self.samples), q))

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.sum / self.count if self.samples else None,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }

    def reset(self) -> None:
        self.samples = []


class MetricsRegistry:
    """Named counters/gauges/histograms with one ``snapshot()``.

    ``counter``/``gauge``/``histogram`` create-or-return.  ``snapshot()``
    is a flat dict: counters and gauges by name, histograms expanded to
    ``<name>_count`` / ``_mean`` / ``_p50`` / ``_p99``.  ``reset()``
    zeroes counters and set gauges and clears histograms (callback gauges
    keep reading live state)."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str, fn: Optional[Callable] = None) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, fn)
        elif fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def snapshot(self) -> dict:
        out: dict = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, h in self._histograms.items():
            for k, v in h.summary().items():
                out[f"{name}_{k}"] = v
        return out

    def reset(self) -> None:
        for c in self._counters.values():
            c.reset()
        for g in self._gauges.values():
            g.reset()
        for h in self._histograms.values():
            h.reset()


def format_metrics_line(snapshot: dict, *, t: Optional[float] = None,
                        keys: Optional[list] = None) -> str:
    """One-line rendering of a snapshot (``--metrics-every``)."""
    head = f"[metrics t={t:.1f}s]" if t is not None else "[metrics]"
    items = []
    for k in keys if keys is not None else snapshot:
        v = snapshot.get(k)
        if v is None:
            continue
        items.append(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}")
    return " ".join([head, *items])


def emit_metrics_line(snapshot: dict, *, t: Optional[float] = None,
                      keys: Optional[list] = None, file=None) -> None:
    print(format_metrics_line(snapshot, t=t, keys=keys),
          file=file or sys.stderr, flush=True)
