"""Per-request journey ledger: lifecycle edges and their stitching across
pods (the port's copy of ``langstream_tpu/serving/journey.py``; the same
vocabulary, segment table, bounds and counters, so a journey whose halves
ran in the two packages stitches into one timeline).

The flight recorder answers "what is the ENGINE doing" and the span buffer
(``core/tracing.py``) "where did this request's spans go". This ledger is
the third surface: one append-only event list per request, written at the
engine's lifecycle sites, that a control plane stitches across pods into
one ordered timeline and cuts into named segments (queue, prefill,
transfer, decode admission, first step, decode).

Identity: the journey key is the trace id when the request is traced (the
id that rides the record headers and the KV handoff wire header), else a
fresh id of the same shape
(:func:`~langstream_tpu_torch.core.tracing.fresh_trace_id`); warmup probes
have none.

Event schema, one dict per lifecycle edge::

    {"seq", "t_ms", "m_s", "kind", **detail}

``t_ms`` is a wall-clock anchor, the one stamp comparable across pods,
which is what stitching orders by; ``m_s`` is the in-process monotonic
stamp. Kinds::

    gateway-produce  bounce  submit  admit  preempt  resume
    hydrate-begin  hydrate-done  adapter-hydrate  adapter-hydrate-done
    first-token  export  export-taken  import-received  import
    first-step  first-emit  last-emit  finish  shed  fail  cancelled
    journal-replay  deadline-exceeded  deadline-overrun

Hot-path rule: a write is a GIL-atomic container append plus counter
bumps, with no lock, no I/O and no device sync (the engine records from
its loop and its dispatch thread), and a read is a ``list()`` snapshot.
Bounded two ways: ``LS_TPU_JOURNEY_BUFFER`` journeys (default 1024, FIFO
eviction counted in ``evicted_requests``) and ``LS_TPU_JOURNEY_EVENTS``
events per journey (default 128, oldest first, counted in
``dropped_events``).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict, deque
from typing import Any

#: event kinds that end a journey (used by completeness checks)
TERMINAL_KINDS = ("finish", "shed", "fail", "cancelled")

#: the canonical lifecycle chain (first occurrences must appear in this
#: order once stitched — a violation means cross-pod clock skew moved
#: an edge across a pod boundary, since each pod's own ledger is
#: monotone by construction)
LIFECYCLE_CHAIN = (
    "gateway-produce",
    "submit",
    "admit",
    "first-token",
    "export",
    "export-taken",
    "import-received",
    "import",
    "first-step",
    "first-emit",
    "last-emit",
    "finish",
)

#: canonical segment names, in lifecycle order — the TTFT decomposition
#: vocabulary the bench records and perf_diff track
SEGMENT_ORDER = (
    "ingest",
    "queue",
    "prefix-hydrate",
    "adapter-hydrate",
    "prefill",
    "export",
    "handoff-wait",
    "transfer",
    "decode-admission",
    "first-step",
    "decode",
    "stream",
    "preempted",
)

#: (previous kind, next kind) → segment name. The interval between two
#: consecutive events is labeled by what the request was WAITING ON
#: during it; unknown pairs fall back to an "a->b" label so the timeline
#: still tiles (gap-free by construction) even when the vocabulary
#: grows.
EDGE_SEGMENTS: dict[tuple[str, str], str] = {
    ("gateway-produce", "submit"): "ingest",   # broker + agent hop
    ("bounce", "submit"): "ingest",
    ("gateway-produce", "bounce"): "ingest",
    ("bounce", "bounce"): "ingest",
    ("submit", "admit"): "queue",
    ("submit", "shed"): "queue",
    # tiered prefix store (docs/PREFIX.md): an admission stashed while
    # the hydrator pulls its prompt's T2 blobs into T1 — the interval
    # the warm-start either pays instead of prefill or writes off at
    # the hydrate timeout
    ("submit", "hydrate-begin"): "queue",
    ("hydrate-begin", "hydrate-done"): "prefix-hydrate",
    ("hydrate-done", "admit"): "queue",
    # tiered adapter store (docs/ADAPTERS.md): an admission stashed
    # while the hydrator pulls the request's LoRA factors T2→T1 — the
    # cold-start interval an adapter pays once per replica, or writes
    # off at the hydrate timeout (a cold refusal: no recompute fallback)
    ("submit", "adapter-hydrate"): "queue",
    ("hydrate-done", "adapter-hydrate"): "queue",
    ("adapter-hydrate", "adapter-hydrate-done"): "adapter-hydrate",
    ("adapter-hydrate-done", "admit"): "queue",
    ("adapter-hydrate", "cancelled"): "adapter-hydrate",
    ("admit", "first-token"): "prefill",
    ("first-token", "export"): "export",       # gather + serialize
    ("export", "export-taken"): "handoff-wait",
    ("export-taken", "import-received"): "transfer",
    ("export", "import-received"): "transfer",  # direct import, no pickup
    ("import-received", "import"): "decode-admission",
    ("import", "first-step"): "first-step",
    ("first-step", "finish"): "decode",
    ("first-token", "finish"): "decode",        # combined engine
    ("preempt", "resume"): "preempted",
    ("resume", "admit"): "requeue",
    ("first-token", "preempt"): "decode",
    ("first-step", "preempt"): "decode",
    # a request resumed after a mid-decode preemption re-admits and runs
    # straight to finish (its first-token edge was already recorded):
    # that interval is decode-phase recovery — re-prefill included
    ("admit", "finish"): "decode",
    # streaming chunk delivery (docs/OBSERVABILITY.md Streaming & TBT):
    # first-emit → last-emit is the STREAM segment — the interval the
    # client was actually receiving tokens, the product latency TBT
    # quantifies. The flanking edges are flush-boundary bookkeeping
    # (first token → its chunk's delivery; final chunk → finish) and
    # stay labeled decode so the TTFT decomposition is unchanged.
    ("first-token", "first-emit"): "decode",
    ("first-step", "first-emit"): "decode",
    ("first-emit", "last-emit"): "stream",
    ("last-emit", "finish"): "decode",
    # a one-chunk generation emits first and last in the same flush
    ("first-emit", "finish"): "decode",
    # a disconnect mid-stream cancels between emits: the open stream is
    # what the client abandoned
    ("first-emit", "cancelled"): "stream",
    ("last-emit", "cancelled"): "decode",
}


def classify_edge(prev_kind: str, next_kind: str) -> str:
    """Segment name for the interval between two consecutive events."""
    return EDGE_SEGMENTS.get(
        (prev_kind, next_kind), f"{prev_kind}->{next_kind}"
    )


def segments(events: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """The consecutive-pair decomposition of an ordered event list: one
    entry per inter-event interval, labeled via :func:`classify_edge`.
    The entries TILE the timeline — their ``ms`` sum exactly the last
    event's ``t_ms`` minus the first's — which is what makes the
    acceptance's "segment sum equals end-to-end wall" property hold by
    construction. Pure arithmetic over a snapshot."""
    out: list[dict[str, Any]] = []
    for prev, nxt in zip(events, events[1:]):
        out.append(
            {
                "segment": classify_edge(
                    str(prev.get("kind")), str(nxt.get("kind"))
                ),
                "from": prev.get("kind"),
                "to": nxt.get("kind"),
                "t_ms": prev.get("t_ms"),
                "ms": round(
                    float(nxt.get("t_ms") or 0.0)
                    - float(prev.get("t_ms") or 0.0),
                    3,
                ),
            }
        )
    return out


def stitch(
    journey_id: str, partials: list[list[dict[str, Any]]]
) -> dict[str, Any]:
    """Merge partial per-pod event lists into ONE ordered timeline.

    Events sort by their wall anchor ``t_ms`` (stable, so each pod's
    own order survives ties); the stitched payload carries the merged
    events, the tiling segment decomposition, per-segment totals, and
    structural anomalies — a negative edge (cross-pod clock skew), an
    export with no matching import (a lost or still-in-transit
    handoff), a preempt never resumed. ``complete`` is True when the
    timeline has a ``submit`` and a terminal edge. Pure arithmetic over
    snapshots."""
    tagged: list[tuple[float, int, int, dict[str, Any]]] = []
    for pi, part in enumerate(partials):
        for idx, event in enumerate(part or []):
            if isinstance(event, dict):
                tagged.append(
                    (float(event.get("t_ms") or 0.0), pi, idx, event)
                )
    tagged.sort(key=lambda t: (t[0], t[1], t[2]))
    events = [t[3] for t in tagged]
    segs = segments(events)
    by_segment: dict[str, float] = {}
    for seg in segs:
        by_segment[seg["segment"]] = round(
            by_segment.get(seg["segment"], 0.0) + seg["ms"], 3
        )
    kinds = [str(e.get("kind")) for e in events]
    anomalies: list[str] = []
    # the sort makes every edge non-negative by construction, so clock
    # skew between pods surfaces as lifecycle edges crossing each other
    # instead: the FIRST occurrence of each canonical kind must appear
    # in chain order (each pod's own ledger is monotone; only a skewed
    # merge can invert the chain)
    first_idx: dict[str, int] = {}
    for i, kind in enumerate(kinds):
        first_idx.setdefault(kind, i)
    chain_idx = [first_idx[k] for k in LIFECYCLE_CHAIN if k in first_idx]
    if chain_idx != sorted(chain_idx):
        anomalies.append(
            "lifecycle edges out of canonical order: cross-pod clock "
            "skew reordered the stitched timeline"
        )
    if "export" in kinds and "import" not in kinds:
        anomalies.append(
            "export without matching import: handoff lost or still in "
            "transit"
        )
    terminal = any(k in kinds for k in TERMINAL_KINDS)
    if kinds.count("preempt") > kinds.count("resume") and terminal:
        anomalies.append("preempt without matching resume")
    total_ms = (
        round(
            float(events[-1].get("t_ms") or 0.0)
            - float(events[0].get("t_ms") or 0.0),
            3,
        )
        if events
        else 0.0
    )
    return {
        "journey": journey_id,
        "events": events,
        "segments": segs,
        "by_segment_ms": by_segment,
        "total_ms": total_ms,
        "complete": "submit" in kinds and terminal,
        "anomalies": anomalies,
    }


def _buffer_size() -> int:
    try:
        return max(16, int(os.environ.get("LS_TPU_JOURNEY_BUFFER", "1024")))
    except ValueError:
        return 1024


def _events_cap() -> int:
    try:
        return max(8, int(os.environ.get("LS_TPU_JOURNEY_EVENTS", "128")))
    except ValueError:
        return 128


class JourneyLedger:
    """Bounded per-request event ledger. Writers are the engine loop,
    the dispatch thread, and gateway/runner tasks; readers are the pod
    ``/journey`` endpoints and the control-plane stitcher. The record
    path is GIL-atomic container ops and counter bumps only (no lock, no
    I/O, no device sync); readers snapshot with ``list()`` copies, as
    the flight recorder's do."""

    def __init__(
        self, max_requests: int | None = None, max_events: int | None = None
    ):
        self.max_requests = (
            max_requests if max_requests is not None else _buffer_size()
        )
        self.max_events = (
            max_events if max_events is not None else _events_cap()
        )
        # insertion-ordered: FIFO eviction when the journey cap is hit
        self._entries: "OrderedDict[str, dict[str, Any]]" = OrderedDict()
        self._seq = 0
        self.recorded_events = 0
        self.evicted_requests = 0
        self.dropped_events = 0
        #: another ledger every edge is also recorded into (``None``: none);
        #: ``serve_torch.py`` points it at the JAX package's ledger, so the
        #: pod's ``/journey`` routes list both packages' edges as one
        self.mirror = None

    # -- recording (hot path: appends + counter bumps only) --------------

    def record(self, journey_id: str | None, kind: str, **detail: Any) -> None:
        """Append one lifecycle edge. A falsy journey id records nothing
        (warmup probes, untraced legacy paths)."""
        if not journey_id:
            return
        if self.mirror is not None:
            self.mirror.record(journey_id, kind, **detail)
        entry = self._entries.get(journey_id)
        if entry is None:
            entry = {"events": deque(maxlen=self.max_events), "recorded": 0}
            self._entries[journey_id] = entry
            while len(self._entries) > self.max_requests:
                self._entries.popitem(last=False)
                self.evicted_requests += 1
        events: deque = entry["events"]
        if len(events) >= self.max_events:
            # the deque drops oldest-first on append; account the loss
            self.dropped_events += 1
        self._seq += 1
        events.append(
            {
                "seq": self._seq,
                # wall anchor: the ONE timestamp comparable across pods,
                # which is what cross-pod stitching orders by — durations
                # derived from it are display/stitch math, never engine
                # latency measurement (those stay monotonic)
                "t_ms": round(time.time() * 1000.0, 3),
                "m_s": round(time.monotonic(), 3),
                "kind": kind,
                **detail,
            }
        )
        entry["recorded"] += 1
        self.recorded_events += 1

    # -- reading (snapshots; never block the writers) --------------------

    def events(self, journey_id: str) -> list[dict[str, Any]]:
        """One journey's events, oldest first (empty when unknown)."""
        entry = self._entries.get(journey_id)
        if entry is None:
            return []
        return list(entry["events"])

    def ids(self) -> list[str]:
        return list(self._entries)

    def summaries(self) -> list[dict[str, Any]]:
        """The ``/journey`` index: per journey, event count, retained vs
        recorded, and the first/last edge."""
        out = []
        for journey_id, entry in list(self._entries.items()):
            events = list(entry["events"])
            out.append(
                {
                    "journey": journey_id,
                    "events": len(events),
                    "recorded": entry["recorded"],
                    "first": events[0].get("kind") if events else None,
                    "last": events[-1].get("kind") if events else None,
                    "t_ms": events[0].get("t_ms") if events else None,
                }
            )
        return out

    def stats(self) -> dict[str, Any]:
        return {
            "requests": len(self._entries),
            "max_requests": self.max_requests,
            "max_events": self.max_events,
            "recorded_events": self.recorded_events,
            "evicted_requests": self.evicted_requests,
            "dropped_events": self.dropped_events,
        }

    def clear(self) -> None:
        self._entries.clear()


#: the process-global ledger (one per process, as the span buffer)
JOURNEYS = JourneyLedger()
