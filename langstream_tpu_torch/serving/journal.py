"""Crash-requeue request journal: admitted-but-unfinished work on disk
(the port's copy of ``langstream_tpu/serving/journal.py``; the file format
is line for line the JAX package's, so a journal written by one package
replays in the other).

- Every accepted submission is **journaled at admit** (prompt tokens,
  sampling settings, stop strings, QoS identity, deadline: the fields the
  resume path needs to re-run it) and **retired** on every path that
  answers the caller: finish, shed, fail (an explicitly failed request was
  answered, not lost).
- A restarting engine replays the journal's live entries through the
  scheduler's **front-of-class** resume path (``requeue_front``), so
  accepted work survives the process that accepted it.

Durability: appends go through a dedicated writer thread (the admit path
runs on the engine's event loop and the retire path in the loop's hot
methods; neither may touch disk), so a crash can lose the last few
*unflushed* ops. That window is bounded and flushable
(:meth:`RequestJournal.flush`); what is flushed replays.

Format: one JSON line per op (``{"op": "admit", "id": ..., ...}`` /
``{"op": "retire", "id": ...}``), append-only. The file is **bounded**:
when the op count outgrows ``4 × max_entries`` the writer compacts it to
the live entries, and when the live set outgrows ``max_entries`` the
oldest live entry is evicted LOUDLY (``on_evict``, a ``journal-evict``
flight event). Torn trailing lines (a crash mid-append) are skipped on
load, never fatal.

Threads: ``admit``/``retire`` are wait-free handoffs (deque append + event
set) from the event loop or the dispatch thread; the writer thread owns
all file I/O and the live-entry table, which ``depth()``/``stats()`` read
under one lock; the shutdown flag is a ``threading.Event``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import OrderedDict, deque
from typing import Any, Callable

log = logging.getLogger(__name__)

_JOURNAL_FILE = "requests.jsonl"


def request_entry(request) -> dict[str, Any]:
    """The journaled snapshot of one accepted request — the fields the
    replay path needs to rebuild an equivalent ``_Request`` (prompt +
    sampling params + QoS identity; engine-local state like futures and
    slot ids is rebuilt, never persisted)."""
    return {
        "id": request.journey_id,
        "prompt": list(request.prompt_tokens),
        "max-tokens": request.max_tokens,
        "temperature": request.temperature,
        "top-k": request.top_k,
        "top-p": request.top_p,
        "presence-penalty": request.presence_penalty,
        "frequency-penalty": request.frequency_penalty,
        "stop": list(request.stop),
        "tenant": request.tenant,
        "priority": request.priority,
        # end-to-end deadline: absolute epoch seconds, or None. A replayed entry keeps its ORIGINAL budget —
        # the restarted engine's admission gate sheds it loudly if the
        # crash outlived it (an expired replay must not complete
        # silently late)
        "deadline": getattr(request, "deadline", None),
    }


class RequestJournal:
    """Bounded on-disk journal of admitted-but-unfinished submissions.

    One instance per engine. ``pending()`` — the replay surface — reads
    the entries recovered at construction time, in admit order.
    """

    def __init__(
        self,
        directory: str,
        max_entries: int = 4096,
        on_evict: Callable[[str], None] | None = None,
        fingerprint: dict[str, Any] | None = None,
    ):
        self.directory = directory
        self.path = os.path.join(directory, _JOURNAL_FILE)
        self.max_entries = max(1, int(max_entries))
        self._on_evict = on_evict
        # engine-identity stamp (model + tokenizer): entries journaled
        # under a DIFFERENT identity must never replay — their token ids
        # mean nothing to this model, and a "successful" replay would be
        # garbage output (the kvtransfer layout-fingerprint refusal
        # pattern, applied to the journal). The journal dir is
        # engine-private by contract; the stamp protects against the
        # config CHANGING across restarts.
        self._fp = (
            json.dumps(fingerprint, sort_keys=True)
            if fingerprint
            else None
        )
        os.makedirs(directory, exist_ok=True)
        # shared writer-thread/engine-side state: live entries (insertion
        # order = admit order) + cumulative counters, under one lock
        self._lock = threading.Lock()
        self._live: "OrderedDict[str, dict[str, Any]]" = OrderedDict()
        self._appended = 0
        self._retired = 0
        self._evicted = 0
        self._replayed = 0
        self.mismatched = 0
        # _ops_written counts the ops ON DISK (seeded from the file, not
        # the live set — a crash-looping pod journals a few hundred ops
        # per life, and seeding from the small live set would reset the
        # compaction threshold every restart, growing the file without
        # bound in exactly the restart-heavy regime the bound exists for)
        self._all_loaded: list[dict[str, Any]] = []
        self._recovered, self._ops_written = self._load()
        # the live table keeps EVERY loaded entry — including
        # fingerprint-mismatched ones, which are never replayed but
        # still count against the bound and survive compaction until
        # evicted loudly (never silently erased)
        for entry in self._all_loaded:
            self._live[entry["id"]] = entry
        self._ops: deque = deque()
        if self._ops_written > max(256, 4 * self.max_entries):
            # the previous life left an oversized file: compact before
            # the writer starts (single-threaded here)
            self._compact()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._closed = threading.Event()
        self._writer = threading.Thread(
            target=self._run_writer,
            name="request-journal",
            daemon=True,
        )
        self._writer.start()

    # -- load / replay surface ------------------------------------------

    def _load(self) -> tuple[list[dict[str, Any]], int]:
        """Rebuild the live set from the file. Returns ``(replayable
        entries, ops on disk)`` — entries stamped with a DIFFERENT
        engine fingerprint are kept live (they still count against the
        bound and are evicted loudly if orphaned) but never offered for
        replay."""
        if not os.path.exists(self.path):
            return [], 0
        live: "OrderedDict[str, dict[str, Any]]" = OrderedDict()
        ops = 0
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        op = json.loads(line)
                    except ValueError:
                        # torn trailing line: the crash landed mid-append.
                        # Skip — the op it carried was inside the bounded
                        # unflushed window the module docstring documents.
                        continue
                    ops += 1
                    rid = op.get("id")
                    if not rid:
                        continue
                    if op.get("op") == "admit":
                        live[rid] = op
                    elif op.get("op") == "retire":
                        live.pop(rid, None)
        except OSError as e:
            log.error("request journal unreadable at %s: %s", self.path, e)
            return [], 0
        replayable: list[dict[str, Any]] = []
        for entry in live.values():
            stamp = entry.get("fp")
            if (
                self._fp is not None
                and stamp is not None
                and stamp != self._fp
            ):
                # journaled under a different model/tokenizer: its token
                # ids mean nothing here — refuse to replay, loudly
                self.mismatched += 1
                continue
            replayable.append(entry)
        if self.mismatched:
            log.warning(
                "request journal at %s holds %d entr(ies) from a "
                "DIFFERENT engine identity: refusing to replay them "
                "(they age out at the journal bound)",
                self.path, self.mismatched,
            )
        self._all_loaded = list(live.values())
        return replayable, ops

    def pending(self) -> list[dict[str, Any]]:
        """Entries recovered from the previous process, admit order —
        what a restarting engine replays front-of-class (fingerprint-
        mismatched entries are excluded)."""
        return list(self._recovered)

    def note_replayed(self, n: int) -> None:
        with self._lock:
            self._replayed += n

    # -- wait-free record surface ---------------------------------------

    def admit(self, entry: dict[str, Any]) -> None:
        if self._closed.is_set() or not entry.get("id"):
            return
        op = {"op": "admit", **entry}
        if self._fp is not None:
            op["fp"] = self._fp
        self._ops.append(op)
        self._idle.clear()
        self._wake.set()

    def retire(self, rid: str | None) -> None:
        """Idempotent: retiring an id the journal never admitted (or
        already retired) is a no-op — finish/shed/fail paths can all
        retire without coordinating."""
        if self._closed.is_set() or not rid:
            return
        self._ops.append({"op": "retire", "id": rid})
        self._idle.clear()
        self._wake.set()

    def depth(self) -> int:
        """Live entries plus ops not yet applied (a gauge, so the two
        reads need not be atomic with respect to each other)."""
        with self._lock:
            live = len(self._live)
        return live + len(self._ops)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "path": self.path,
                "live": len(self._live),
                "pending_ops": len(self._ops),
                "appended": self._appended,
                "retired": self._retired,
                "evicted": self._evicted,
                "replayed": self._replayed,
                "mismatched": self.mismatched,
                "max_entries": self.max_entries,
            }

    # -- writer thread ---------------------------------------------------

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every queued op reached the file (tests, drain)."""
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
                self._drain_ops()
            except OSError as e:
                # disk trouble must never take the engine down with it:
                # the journal degrades (loss window grows), serving
                # continues, the error is loud in the logs
                log.error("request journal write failed: %s", e)
            if not self._ops:
                self._idle.set()
                if self._closed.is_set():
                    return

    def _drain_ops(self) -> None:
        # apply every queued op to the live table under the lock (dict
        # ops only), collecting the lines to append; ALL file I/O then
        # happens outside the lock, so an engine-side depth()/stats()
        # read can never block behind disk latency. A crash between the
        # two halves loses only the unwritten lines — the same bounded
        # unflushed window the durability model already documents.
        evicted: list[str] = []
        lines: list[str] = []
        with self._lock:
            while self._ops:
                op = self._ops.popleft()
                rid = op["id"]
                if op["op"] == "admit":
                    self._live[rid] = op
                    self._appended += 1
                    while len(self._live) > self.max_entries:
                        evicted_id, _ = self._live.popitem(last=False)
                        self._evicted += 1
                        evicted.append(evicted_id)
                        lines.append(
                            json.dumps({"op": "retire", "id": evicted_id})
                        )
                else:
                    if self._live.pop(rid, None) is None:
                        continue  # unknown/double retire: no-op
                    self._retired += 1
                lines.append(json.dumps(op))
        if lines:
            with open(self.path, "a", encoding="utf-8") as fh:
                for line in lines:
                    fh.write(line + "\n")
                fh.flush()
            self._ops_written += len(lines)
        for evicted_id in evicted:
            # callbacks OUTSIDE the lock (they append flight events)
            if self._on_evict is not None:
                self._on_evict(evicted_id)
        if self._ops_written > max(256, 4 * self.max_entries):
            self._compact()

    def _compact(self) -> None:
        """Rewrite the file down to the live set (write-then-rename so a
        crash mid-compaction leaves the old file intact)."""
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with self._lock:
            entries = list(self._live.values())
        with open(tmp, "w", encoding="utf-8") as fh:
            for entry in entries:
                fh.write(json.dumps(entry) + "\n")
            fh.flush()
        os.replace(tmp, self.path)
        self._ops_written = len(entries)
