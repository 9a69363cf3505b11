"""SLO-triggered incident bundles: the capture plane (the port's copy of
``langstream_tpu/serving/incident.py``; bundle files name for name and key
for key the JAX recorder's, so a directory written by one package is
re-indexed by the other).

The engine's measurement planes (flight ring, journey ledgers,
attribution, streaming TBT digests, burn-rate paging in ``health()``) are
live state: when a page fires, the rings age out before a human arrives.
The moment a breach predicate trips, the engine snapshots the evidence it
already holds into a bounded **incident bundle** on disk.

Triggers (wired in ``serving/engine.py``):

- a health transition out of OK (``health-degraded``/``health-wedged``),
  with the watchdog's reasons as evidence;
- ``shrink-pressure``: the device-memory-pressure reason (repeated pool
  shrinks inside one recovery window);
- ``slo-fast-burn``: an SLO objective's multi-window burn crossed the page
  threshold;
- ``tbt-burn``: a class's streaming time-between-tokens objective paged;
- ``breaker-storm``: at least ``k`` ``breaker-open`` events inside one
  window of the engine's event ring (:func:`breaker_storm`);
- ``adapter-storm``: ONE adapter evicted at least ``k`` times inside one
  hydrate window (:func:`adapter_eviction_storm`): the adapter tiers are
  too small for the live mix.

Capture side: :meth:`IncidentRecorder.should_capture`,
:meth:`IncidentRecorder.submit` and the engine's assembly run inside
``health()``, the finish path and the SLO emit path, next to the engine's
loop, so they are **wait-free**: cooldown stamps and suppression counters
live in plain dicts (GIL-atomic, bounded by the trigger vocabulary), the
bundle is assembled from wait-free sections, and the handoff is a deque
append and an event set (the journal's shape). The writer thread owns all
file I/O and the bundle table; ``list()``/``get()``/``stats()`` read the
table under one uncontended lock from the pod's serving thread.

Durability: one JSON file per bundle, written then renamed
(``incident-<n>-<kind>.json``), bounded to ``max_bundles`` on disk and in
memory; the oldest is evicted loudly (``on_evict``, an ``incident-evict``
flight event). Captures dedup per ``(kind, dedup key)`` under a cooldown,
and suppressed breaches are counted. Bundles on disk at construction are
re-indexed, so a restarted pod still lists its history.

Event-tail dedup: flight events carry a per-recorder ``seq`` and the
recorder keeps a high-water mark, so two bundles seconds apart never
report the same event twice.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

log = logging.getLogger(__name__)

# IncidentRecorder.list() shadows the builtin inside the class body
builtin_list = list

#: capture-trigger kinds (the cooldown/dedup vocabulary — bounds the
#: stamp dicts by construction)
TRIGGER_KINDS = (
    "health-degraded",
    "health-wedged",
    "shrink-pressure",
    "slo-fast-burn",
    "tbt-burn",
    "breaker-storm",
    "adapter-storm",
)

#: trigger kind → the journey segment it indicts: worst-K ledgers are
#: ranked by time spent THERE, so a TBT page surfaces the slowest
#: streamers, not the longest prompts. None ranks by total journey time.
OFFENDING_SEGMENT: dict[str, str | None] = {
    "health-degraded": None,
    "health-wedged": None,
    "shrink-pressure": "decode",
    "slo-fast-burn": "queue",
    "tbt-burn": "stream",
    "breaker-storm": "transfer",
    "adapter-storm": "adapter-hydrate",
}


def breaker_storm(
    events: list[dict[str, Any]],
    now_s: float,
    k: int = 3,
    window_s: float = 30.0,
) -> dict[str, Any] | None:
    """The breaker-storm predicate: ≥ ``k`` ``breaker-open`` events whose
    monotonic stamp falls inside the trailing ``window_s`` of the event
    tail. Returns the evidence dict (count + the opens) or None. Pure
    function over an already-snapshotted tail — wait-free."""
    opens = [
        e
        for e in events
        if e.get("kind") == "breaker-open"
        and e.get("m_s") is not None
        and now_s - e["m_s"] <= window_s
    ]
    if len(opens) < k:
        return None
    return {
        "count": len(opens),
        "window_s": window_s,
        "replicas": sorted(
            {e.get("replica") for e in opens if e.get("replica")}
        ),
        "opens": opens[-k:],
    }


def adapter_eviction_storm(
    events: list[dict[str, Any]],
    now_s: float,
    k: int = 3,
    window_s: float = 30.0,
) -> dict[str, Any] | None:
    """The adapter eviction-storm predicate: ONE adapter evicted ≥ ``k``
    times inside the trailing ``window_s`` (the caller passes the hydrate
    window) of the event tail — thrash, not turnover: distinct adapters
    cycling through T0 rows is the LRU doing its job, the SAME adapter
    bouncing means the tier budgets are undersized for the live mix and
    every bounce re-pays a device load or a T2 hydration. Returns the
    evidence dict (adapter, count + the evictions) or None. Pure
    function over an already-snapshotted tail — wait-free (the adapter
    plane's breach observer)."""
    by_adapter: dict[str, list[dict[str, Any]]] = {}
    for e in events:
        if (
            e.get("kind") == "adapter-evict"
            and e.get("m_s") is not None
            and now_s - e["m_s"] <= window_s
            and e.get("adapter")
        ):
            by_adapter.setdefault(str(e["adapter"]), []).append(e)
    worst: tuple[str, list[dict[str, Any]]] | None = None
    for name, evictions in by_adapter.items():
        if worst is None or len(evictions) > len(worst[1]):
            worst = (name, evictions)
    if worst is None or len(worst[1]) < k:
        return None
    name, evictions = worst
    return {
        "adapter": name,
        "count": len(evictions),
        "window_s": window_s,
        "evictions": evictions[-k:],
    }


def worst_journeys(kind: str, k: int = 3) -> list[dict[str, Any]]:
    """The worst-``k`` journey ledgers ranked by time spent in the
    trigger's offending segment (:data:`OFFENDING_SEGMENT`; total
    journey time when the trigger indicts no one segment). Snapshot
    reads over the bounded global ledger — wait-free by the ledger's
    contract."""
    from langstream_tpu_torch.serving.journey import JOURNEYS, segments

    segment = OFFENDING_SEGMENT.get(kind)
    ranked: list[tuple[float, str, list, list]] = []
    for jid in JOURNEYS.ids():
        events = JOURNEYS.events(jid)
        if not events:
            continue
        segs = segments(events)
        total = sum(s.get("ms", 0.0) for s in segs)
        if segment is None:
            score = total
        else:
            score = sum(
                s.get("ms", 0.0) for s in segs if s.get("segment") == segment
            )
        ranked.append((score, jid, segs, events))
    ranked.sort(key=lambda t: t[0], reverse=True)
    out = []
    for score, jid, segs, events in ranked[:k]:
        out.append(
            {
                "journey": jid,
                "offending_segment": segment,
                "offending_ms": round(score, 3),
                "segments": segs,
                "events": events,
            }
        )
    return out


class IncidentRecorder:
    """Bounded on-disk incident-bundle store with a wait-free capture
    side. One instance per engine (``incident-dir`` config)."""

    def __init__(
        self,
        directory: str,
        max_bundles: int = 32,
        cooldown_s: float = 60.0,
        on_evict: Callable[[str], None] | None = None,
    ):
        self.directory = directory
        self.max_bundles = max(1, int(max_bundles))
        self.cooldown_s = float(cooldown_s)
        self._on_evict = on_evict
        os.makedirs(directory, exist_ok=True)
        # -- observe-side state: GIL-atomic containers, NO lock ----------
        # (a lock in should_capture/submit would put a wait on the
        # health() and finish paths)
        self._last_capture: dict[str, float] = {}
        self.suppressed: dict[str, int] = {}
        self.captured = 0
        #: flight-event seq high-water mark (overlap dedup across bundles)
        self.last_event_seq = 0
        # -- writer-side state: bundle table + counters under one lock ---
        self._lock = threading.Lock()
        self._bundles: "OrderedDict[str, dict[str, Any]]" = OrderedDict()
        self._written = 0
        self._evicted = 0
        self._write_errors = 0
        self._seq = self._load_existing()
        self._pending: deque = deque()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._closed = threading.Event()
        self._writer = threading.Thread(
            target=self._run_writer,
            name="incident-recorder",
            daemon=True,
        )
        self._writer.start()

    # -- construction-time reload (single-threaded) ----------------------

    def _load_existing(self) -> int:
        """Re-index bundles a previous life left on disk (oldest beyond
        the bound deleted loudly), returning the next bundle sequence
        number. Unreadable files are skipped, never fatal."""
        names = sorted(
            n
            for n in os.listdir(self.directory)
            if n.startswith("incident-") and n.endswith(".json")
        )
        seq = 0
        for name in names:
            path = os.path.join(self.directory, name)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    bundle = json.load(fh)
            except (OSError, ValueError) as e:
                log.warning("skipping unreadable incident bundle %s: %s", path, e)
                continue
            bid = bundle.get("id") or name[: -len(".json")]
            self._bundles[bid] = bundle
            try:
                seq = max(seq, int(bid.split("-")[1]))
            except (IndexError, ValueError):
                pass
        while len(self._bundles) > self.max_bundles:
            old_id, _ = self._bundles.popitem(last=False)
            self._evicted += 1
            self._remove_file(old_id)
        return seq

    # -- wait-free capture side ------------------------------------------

    def should_capture(self, kind: str, dedup_key: str | None = None) -> bool:
        """Cooldown/dedup gate, called at the breach site. Wait-free:
        one monotonic read plus GIL-atomic dict ops on a dict whose key
        space is the trigger vocabulary (× per-trigger dedup keys such
        as the SLO objective name) — bounded by construction."""
        if self._closed.is_set():
            return False
        key = kind if dedup_key is None else f"{kind}:{dedup_key}"
        now_s = time.monotonic()
        last = self._last_capture.get(key)
        if last is not None and now_s - last < self.cooldown_s:
            self.suppressed[kind] = self.suppressed.get(kind, 0) + 1
            return False
        self._last_capture[key] = now_s
        return True

    def submit(self, bundle: dict[str, Any]) -> str:
        """Hand an assembled bundle to the writer thread: stamp its id,
        append, wake. Wait-free — the same handoff shape as
        ``journal.admit``."""
        self.captured += 1
        bundle_id = "incident-%06d-%s" % (
            self._seq + self.captured,
            bundle.get("trigger", {}).get("kind", "unknown"),
        )
        bundle["id"] = bundle_id
        self._pending.append(bundle)
        self._idle.clear()
        self._wake.set()
        return bundle_id

    # -- serving-side reads (pod HTTP thread; one uncontended lock) ------

    def list(self) -> list[dict[str, Any]]:
        """Bounded bundle summaries, oldest first — the ``GET
        /incidents`` index payload."""
        with self._lock:
            bundles = builtin_list(self._bundles.values())
        return [
            {
                "id": b.get("id"),
                "kind": b.get("trigger", {}).get("kind"),
                "captured_at_ms": b.get("captured_at_ms"),
                "reasons": b.get("trigger", {}).get("reasons"),
                "journeys": len(b.get("worst_journeys") or ()),
                "events": len(b.get("events") or ()),
            }
            for b in bundles
        ]

    def get(self, bundle_id: str) -> dict[str, Any] | None:
        with self._lock:
            return self._bundles.get(bundle_id)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            live = len(self._bundles)
            written = self._written
            evicted = self._evicted
            write_errors = self._write_errors
        return {
            "dir": self.directory,
            "live": live,
            "captured": self.captured,
            "written": written,
            "evicted": evicted,
            "write_errors": write_errors,
            "suppressed": dict(self.suppressed),
            "pending": len(self._pending),
            "cooldown_s": self.cooldown_s,
            "max_bundles": self.max_bundles,
        }

    # -- writer thread ---------------------------------------------------

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every submitted bundle reached disk (tests, drain)."""
        return self._idle.wait(timeout)

    def close(self, timeout: float = 5.0) -> None:
        if self._closed.is_set():
            return
        self.flush(timeout)
        self._closed.set()
        self._wake.set()
        self._writer.join(timeout)

    def _run_writer(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            try:
                self._drain()
            except OSError as e:
                # disk trouble must never take the engine down: the
                # capture plane degrades loudly, serving continues
                log.error("incident bundle write failed: %s", e)
                self._write_errors += 1
            if not self._pending:
                self._idle.set()
                if self._closed.is_set():
                    return

    def _drain(self) -> None:
        while self._pending:
            bundle = self._pending.popleft()
            bundle_id = bundle["id"]
            path = os.path.join(self.directory, bundle_id + ".json")
            # write-then-rename: a crash mid-write leaves no torn bundle
            tmp = f"{path}.tmp.{os.getpid()}"
            evicted: list[str] = []
            try:
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(bundle, fh, sort_keys=True, default=str)
                    fh.flush()
                os.replace(tmp, path)
            except OSError:
                self._write_errors += 1
                raise
            with self._lock:
                self._bundles[bundle_id] = bundle
                self._written += 1
                while len(self._bundles) > self.max_bundles:
                    old_id, _ = self._bundles.popitem(last=False)
                    self._evicted += 1
                    evicted.append(old_id)
            for old_id in evicted:
                # file removal + callbacks OUTSIDE the lock (the callback
                # appends a flight event)
                self._remove_file(old_id)
                if self._on_evict is not None:
                    self._on_evict(old_id)

    def _remove_file(self, bundle_id: str) -> None:
        try:
            os.remove(os.path.join(self.directory, bundle_id + ".json"))
        except OSError:
            pass
