"""Prometheus metrics reporter (the port's copy of
``langstream_tpu/api/metrics.py``).

The serving engines register their ``langstream_serving_*`` and
``langstream_stream_*`` series through a reporter: ``counter``, ``gauge``,
``histogram`` and ``exemplar_histogram`` each return a closure that the
engine calls at its update sites. The full names, HELP strings, buckets
and the ``agent_id`` label are the JAX package's, so one dashboard reads
both packages.

The registry is the stdlib one (the JAX module's fallback registry): it
runs wherever the port runs and needs no ``prometheus_client``.
:func:`render_metrics` always answers a well-formed text exposition
(``text/plain; version=0.0.4``); with no series registered it says so in a
comment, never with an empty body.

**Exemplars.** A histogram registered with :meth:`exemplar_histogram`
keeps one last-wins ``(trace_id, value, ts)`` slot per bucket, written by
``observe(v, trace_id)`` for a traced request with one dict store (no
lock). :func:`render_metrics` appends the recorded slots to their
``_bucket`` lines in OpenMetrics exemplar syntax (``# {trace_id="..."}
<value> <ts>``), so a p99 bucket names a journey that ``tools/journey.py
--trace`` opens. With no slot recorded the body is byte-identical to the
plain format.

**The reporter seam.** The engines build their reporters from
:data:`REPORTER`, read when an engine is built. Standalone it is this
module's :class:`PrometheusMetricsReporter`. A launcher that serves the
port inside the platform's pod points it at the platform's reporter class
(``serve_torch.register``), so the pod's one ``/metrics`` scrape carries
both packages' series under the same names; an engine built before that
keeps this module's registry.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Callable

_metric_lock = threading.Lock()

#: seconds-scale latency buckets (sub-ms hops up to multi-second queue
#: waits: the range the serving TTFT decomposition spans)
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

#: exemplar slots: full metric name -> agent label -> bucket upper bound
#: (``float('inf')`` for +Inf) -> ``(trace_id, value, unix ts)``; written
#: last-wins by the observe closures, read by the renderer
_exemplars: dict[str, dict[str, dict[float, tuple[str, float, float]]]] = {}

_BUCKET_LINE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)_bucket\{(?P<labels>[^}]*)\} "
    r"(?P<value>\S+)$"
)


def _label_value(labels: str, key: str) -> str | None:
    m = re.search(re.escape(key) + r'="([^"]*)"', labels)
    return m.group(1) if m else None


def _have_exemplars() -> bool:
    return any(slots for per_agent in _exemplars.values() for slots in per_agent.values())


def _annotate_exemplars(body: bytes) -> bytes:
    """Append OpenMetrics exemplar comments to the ``_bucket`` lines that
    have a recorded slot; with none recorded the body passes through
    byte-identical."""
    if not _have_exemplars():
        return body
    out: list[str] = []
    for line in body.decode("utf-8").split("\n"):
        m = None if line.startswith("#") else _BUCKET_LINE.match(line)
        if m is not None:
            per_agent = _exemplars.get(m.group("name"))
            if per_agent is not None:
                labels = m.group("labels")
                slots = per_agent.get(_label_value(labels, "agent_id") or "")
                le = _label_value(labels, "le")
                if slots is not None and le is not None:
                    ex = slots.get(float("inf") if le == "+Inf" else float(le))
                    if ex is not None:
                        trace_id, value, ts = ex
                        line = f'{line} # {{trace_id="{trace_id}"}} {value} {ts}'
        out.append(line)
    return "\n".join(out).encode("utf-8")


# ---------------------------------------------------------------------------
# the stdlib registry
# ---------------------------------------------------------------------------


class _Metric:
    """One metric family: label value -> state."""

    def __init__(self, kind: str, help: str, buckets: tuple[float, ...] = ()):
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.series: dict[str, Any] = {}


_registry: dict[str, _Metric] = {}


def _counter(full: str, help: str, label: str) -> Callable[[int], None]:
    with _metric_lock:
        metric = _registry.setdefault(full, _Metric("counter", help))
        metric.series.setdefault(label, 0.0)

    def _inc(n: int = 1) -> None:
        with _metric_lock:
            metric.series[label] += n

    return _inc


def _gauge(full: str, help: str, label: str) -> Callable[[float], None]:
    with _metric_lock:
        metric = _registry.setdefault(full, _Metric("gauge", help))
        metric.series.setdefault(label, 0.0)

    def _set(v: float) -> None:
        with _metric_lock:
            metric.series[label] = float(v)

    return _set


def _histogram(full: str, help: str, label: str,
               buckets: tuple[float, ...]) -> Callable[[float], None]:
    with _metric_lock:
        metric = _registry.setdefault(full, _Metric("histogram", help, buckets))
        # the family's buckets win: a series sized from a caller's other
        # tuple would desync the observe loop
        metric.series.setdefault(
            label, {"count": 0, "sum": 0.0, "buckets": [0] * len(metric.buckets)})

    def _observe(v: float) -> None:
        with _metric_lock:
            state = metric.series[label]
            state["count"] += 1
            state["sum"] += float(v)
            # per-bucket (non-cumulative) counts; the renderer cumulates
            for i, le in enumerate(metric.buckets):
                if v <= le:
                    state["buckets"][i] += 1
                    break

    return _observe


def _render() -> bytes:
    lines: list[str] = []
    with _metric_lock:
        for name in sorted(_registry):
            metric = _registry[name]
            lines.append(f"# HELP {name} {metric.help or name}")
            lines.append(f"# TYPE {name} {metric.kind}")
            for label, state in metric.series.items():
                sel = f'{{agent_id="{label}"}}' if label else ""
                if metric.kind in ("counter", "gauge"):
                    lines.append(f"{name}{sel} {state}")
                    continue
                cumulative = 0
                for le, n in zip(metric.buckets, state["buckets"]):
                    cumulative += n
                    bsel = f'{{agent_id="{label}",le="{le}"}}' if label else f'{{le="{le}"}}'
                    lines.append(f"{name}_bucket{bsel} {cumulative}")
                isel = f'{{agent_id="{label}",le="+Inf"}}' if label else '{le="+Inf"}'
                lines.append(f"{name}_bucket{isel} {state['count']}")
                lines.append(f"{name}_count{sel} {state['count']}")
                lines.append(f"{name}_sum{sel} {state['sum']}")
    return ("\n".join(lines) + "\n").encode()


# ---------------------------------------------------------------------------
# reporter
# ---------------------------------------------------------------------------


class PrometheusMetricsReporter:
    """Series named ``<prefix>_<name>`` (``-`` and ``.`` become ``_``),
    labelled ``agent_id``; the JAX package's reporter over the stdlib
    registry."""

    def __init__(self, prefix: str = "langstream", agent_id: str = ""):
        self.prefix = prefix
        self.agent_id = agent_id

    def with_prefix(self, prefix: str) -> "PrometheusMetricsReporter":
        return PrometheusMetricsReporter(f"{self.prefix}_{prefix}", self.agent_id)

    def _full(self, name: str) -> str:
        return f"{self.prefix}_{name}".replace("-", "_").replace(".", "_")

    def counter(self, name: str, help: str = "") -> Callable[[int], None]:
        return _counter(self._full(name), help, self.agent_id)

    def gauge(self, name: str, help: str = "") -> Callable[[float], None]:
        return _gauge(self._full(name), help, self.agent_id)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] | None = None) -> Callable[[float], None]:
        return _histogram(self._full(name), help, self.agent_id, buckets or LATENCY_BUCKETS)

    def exemplar_histogram(self, name: str, help: str = "",
                           buckets: tuple[float, ...] | None = None) -> Callable[..., None]:
        """A histogram whose observe also takes an optional ``trace_id``:
        ``observe(v)`` is :meth:`histogram`'s, ``observe(v, trace_id)``
        also stamps the value's bucket slot, last wins (one tuple store
        into a dict bounded by the buckets)."""
        full = self._full(name)
        bounds = tuple(buckets or LATENCY_BUCKETS)
        observe = self.histogram(name, help, bounds)
        with _metric_lock:
            slots = _exemplars.setdefault(full, {}).setdefault(self.agent_id, {})

        def _observe(v: float, trace_id: str | None = None) -> None:
            observe(v)
            if trace_id:
                le = next((b for b in bounds if v <= b), float("inf"))
                slots[le] = (str(trace_id), float(v), time.time())

        return _observe


def snapshot() -> dict[tuple[str, str], tuple[str, float]]:
    """``{(series name, agent_id): (kind, value)}`` of this registry: each
    counter and gauge by its value, each histogram by its count (under
    ``<name>_count``). A consistent copy, for deltas across a workload."""
    out: dict[tuple[str, str], tuple[str, float]] = {}
    with _metric_lock:
        for name, metric in _registry.items():
            for label, state in metric.series.items():
                if metric.kind == "histogram":
                    out[(f"{name}_count", label)] = ("histogram", float(state["count"]))
                else:
                    out[(name, label)] = (metric.kind, float(state))
    return out


def render_metrics() -> bytes:
    """Text exposition of every series of this registry, exemplars on their
    buckets. Never empty: with nothing registered, one comment line."""
    body = _render()
    body = body if body.strip() else b"# no metrics registered yet\n"
    return _annotate_exemplars(body)


#: the reporter class the engines build their reporters from, read when an
#: engine is built (see the module docstring)
REPORTER: Callable[..., Any] = PrometheusMetricsReporter
