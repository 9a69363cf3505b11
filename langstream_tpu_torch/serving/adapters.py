"""Tiered multi-LoRA adapter store: device rows -> host RAM -> object
storage (port of ``langstream_tpu/serving/adapters.py``).

One fleet serves many fine-tunes of one decoder with batched LoRA
(Punica/S-LoRA-style adapter gather): every paged decode/prefill dispatch
carries a stacked per-layer A/B factor buffer of shape ``(layers, n_rows,
in, rank)`` / ``(layers, n_rows, rank, out)`` plus a per-slot row index,
so heterogeneous-adapter batches run as one batch; row 0 is all zeros,
which makes adapter-less slots compute the base model exactly. This module
owns where those factors live when they are NOT on the card:

- **T0, device rows**: ``t0-entries`` resident adapters inside the stacked
  buffer (the engine owns the device copies; this store owns the row map,
  the LRU order and the pin ledger). Rows pinned by in-flight requests are
  never evicted: ``t0_assign`` refuses and admission backpressures, so a
  slot never decodes against weights swapped under it.
- **T1, host RAM**: an LRU byte-budgeted map of adapter factor arrays
  keyed by adapter NAME (a re-published name is a new version; the T2
  fingerprint is what refuses stale layouts).
- **T2, object storage**: the origin tier. Factors serialize through the
  LSKV wire (``serving/kvtransfer.py``) with an adapter fingerprint (base
  model, rank, factor dims, dtype) that a loading replica checks (a
  mismatch is refused AND deleted, never half-loaded). A cold replica
  discovers published adapters by rescan and hydrates them T2 -> T1 -> T0
  on first request. The blobs are byte-compatible with the JAX package's,
  so both packages can share one bucket.

Threading: every loop-side resolve/assign/pin/evict decision is wait-free
(container ops and arithmetic, no locks, no I/O, no device work), because
it runs at the engine loop's safe point on the admission path. The only
blocking work is T2 I/O, on the background hydrator thread (``_io_*``),
which talks to the loop through deques; the loop applies results at its
next safe point. The byte ledgers have one writer (the loop) and sum
exactly; a loss is counted, never silent.

Factor arrays are numpy (``make_lora_arrays``, an install) or CPU tensors
(a hydrated blob whose dtype numpy lacks, such as bf16); both carry
``nbytes`` and both serialize through the wire.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

import numpy as np

import torch

from langstream_tpu_torch.serving.kvtransfer import (
    LayoutMismatch,
    deserialize_handoff,
    serialize_handoff,
)
from langstream_tpu_torch.serving.prefixstore import PrefixStorage, make_prefix_storage

log = logging.getLogger(__name__)

#: blob kind stamped into every T2 header — an adapter blob is neither a
#: prefix block nor a request handoff, and every import path must be
#: able to tell the three apart
BLOB_KIND = "lora-adapter"

#: record header naming the adapter a request wants; the gateway stamps
#: it from QoS tenant config and the router pins adapter→replica
#: affinity on it (beside the prefix-digest pins)
ADAPTER_HEADER = "langstream-adapter"

#: the eight LoRA factor arrays every adapter ships — A/B pairs for the
#: four attention projections (deltas on wq/wk/wv/wo; ffn deltas are a
#: future leg). Shapes (per key, leading ``layers`` axis):
#:   wq_a (L, hidden, rank)    wq_b (L, rank, q_dim)
#:   wk_a (L, hidden, rank)    wk_b (L, rank, kv_dim)
#:   wv_a (L, hidden, rank)    wv_b (L, rank, kv_dim)
#:   wo_a (L, q_dim, rank)     wo_b (L, rank, hidden)
#: The LoRA alpha/rank scale is folded into the B factors at publish
#: time, so application is always plain ``h @ A @ B``.
FACTOR_KEYS = (
    "wq_a", "wq_b", "wk_a", "wk_b",
    "wv_a", "wv_b", "wo_a", "wo_b",
)


def check_adapter_name(name: str) -> str:
    """Adapter names are storage keys and metric labels: short, no
    path/meta characters. Raises ValueError on anything else."""
    if not isinstance(name, str) or not name or len(name) > 120:
        raise ValueError(f"illegal adapter name {name!r}")
    ok = set("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-")
    if not set(name) <= ok:
        raise ValueError(
            f"adapter name {name!r} may only contain [A-Za-z0-9_-]"
        )
    return name


def check_adapter_fingerprint(
    ours: dict[str, Any], theirs: dict[str, Any]
) -> None:
    """Raise :class:`LayoutMismatch` naming every disagreeing key. All
    of OUR keys must match (kvtransfer's check compares a fixed KV
    layout key set; adapter fingerprints carry their own vocabulary —
    base-model, rank, factor dims, dtype)."""
    bad = [k for k in ours if ours.get(k) != theirs.get(k)]
    if bad:
        detail = ", ".join(
            f"{k}: ours={ours.get(k)!r} theirs={theirs.get(k)!r}"
            for k in sorted(bad)
        )
        raise LayoutMismatch(f"adapter fingerprint mismatch ({detail})")


# ---------------------------------------------------------------------------
# spec (the `adapter-store` section of tpu-serving-configuration)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdapterStoreSpec:
    """Frozen, hashable tier policy (rides :class:`ServingConfig`, same
    kebab ``to_dict``/``from_dict`` round-trip and deploy-time
    validation contract as the prefix-store/qos/slo specs)."""

    enabled: bool = True
    # LoRA rank every adapter in this fleet must ship (one stacked
    # device buffer → one rank; mixed-rank fleets deploy per-rank pools)
    rank: int = 8
    # device-resident adapter rows (row 0 is the reserved zeros row for
    # adapter-less slots and is NOT counted here)
    t0_entries: int = 4
    # T1 host-RAM budget (LRU past it; overflow demotes to T2 when one
    # is configured, else evicts — counted, never silent)
    t1_bytes: int = 256 << 20
    # T2 object-storage budget; None = unbudgeted
    t2_bytes: int | None = None
    # T2 backend config as sorted (key, value) pairs so the spec stays
    # hashable; () disables T2. Schema shared with the prefix store
    # (:func:`make_prefix_storage`) — point it at a DIFFERENT path or
    # key-prefix than the prefix tier.
    t2: tuple[tuple[str, str], ...] = ()
    # how long an admission may wait for a T2 hydration before the
    # request is refused cold (unlike a prefix miss there is no
    # recompute fallback — the weights either arrive or the request
    # fails loudly)
    hydrate_timeout_s: float = 5.0
    # hydrator-thread T2 index rescan period (how quickly this replica
    # notices adapters published by others)
    t2_rescan_s: float = 5.0

    def t2_config(self) -> dict[str, str] | None:
        return dict(self.t2) if self.t2 else None

    def to_dict(self) -> dict[str, Any]:
        return {
            "enabled": self.enabled,
            "rank": self.rank,
            "t0-entries": self.t0_entries,
            "t1-bytes": self.t1_bytes,
            "t2-bytes": self.t2_bytes,
            "t2": self.t2_config(),
            "hydrate-timeout-s": self.hydrate_timeout_s,
            "t2-rescan-s": self.t2_rescan_s,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "AdapterStoreSpec | None":
        if d is None:
            return None
        if not isinstance(d, dict):
            raise ValueError("adapter-store section must be a mapping")
        known = {
            "enabled", "rank", "t0-entries", "t0_entries",
            "t1-bytes", "t1_bytes", "t2-bytes", "t2_bytes", "t2",
            "hydrate-timeout-s", "hydrate_timeout_s",
            "t2-rescan-s", "t2_rescan_s",
        }
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown adapter-store keys: {unknown}")
        rank = int(d.get("rank", cls.rank))
        if rank <= 0:
            raise ValueError("adapter-store rank must be > 0")
        t0 = int(d.get("t0-entries", d.get("t0_entries", cls.t0_entries)))
        if t0 <= 0:
            raise ValueError("adapter-store t0-entries must be > 0")
        t1 = int(d.get("t1-bytes", d.get("t1_bytes", cls.t1_bytes)))
        if t1 <= 0:
            raise ValueError("adapter-store t1-bytes must be > 0")
        t2_bytes = d.get("t2-bytes", d.get("t2_bytes"))
        if t2_bytes is not None:
            t2_bytes = int(t2_bytes)
            if t2_bytes < 0:
                raise ValueError("adapter-store t2-bytes must be >= 0")
        t2_cfg = d.get("t2")
        t2: tuple[tuple[str, str], ...] = ()
        if t2_cfg:
            if not isinstance(t2_cfg, dict):
                raise ValueError("adapter-store t2 must be a mapping")
            t2_type = str(t2_cfg.get("type", "local"))
            if t2_type not in ("local", "s3"):
                raise ValueError(
                    f"unknown adapter-store t2 type {t2_type!r} "
                    f"(known: local, s3)"
                )
            t2 = tuple(sorted((str(k), str(v)) for k, v in t2_cfg.items()))
        hydrate = float(
            d.get("hydrate-timeout-s",
                  d.get("hydrate_timeout_s", cls.hydrate_timeout_s))
        )
        rescan = float(
            d.get("t2-rescan-s", d.get("t2_rescan_s", cls.t2_rescan_s))
        )
        if hydrate <= 0 or rescan <= 0:
            raise ValueError(
                "adapter-store hydrate-timeout-s and t2-rescan-s must be > 0"
            )
        enabled = d.get("enabled", True)
        if isinstance(enabled, str):
            enabled = enabled.strip().lower() in ("1", "true", "yes", "on")
        return cls(
            enabled=bool(enabled),
            rank=rank,
            t0_entries=t0,
            t1_bytes=t1,
            t2_bytes=t2_bytes,
            t2=t2,
            hydrate_timeout_s=hydrate,
            t2_rescan_s=rescan,
        )


def validate_application_adapter_store(application) -> None:
    """Deploy-time validation: parse every ``tpu-serving-configuration``
    resource's ``adapter-store`` section so a malformed tier policy
    fails the deploy (HTTP 400) instead of the first request."""
    for name, res in (getattr(application, "resources", None) or {}).items():
        if getattr(res, "type", None) != "tpu-serving-configuration":
            continue
        try:
            AdapterStoreSpec.from_dict(
                (res.configuration or {}).get("adapter-store")
            )
        except ValueError as e:
            raise ValueError(
                f"resource {name!r}: invalid adapter-store section: {e}"
            ) from e


# ---------------------------------------------------------------------------
# the tier store
# ---------------------------------------------------------------------------


class AdapterStore:
    """T0 row map + T1 host-RAM spill + T2 object-storage hydration for
    named LoRA adapters, with exact byte ledgers.

    Single-writer discipline (the prefix store's, verbatim): ALL
    ledger/counter/tier mutations happen on the engine-loop side; the
    hydrator thread only performs storage I/O on job payloads and hands
    results back through ``_results``. Loop-side paths are wait-free and
    the ledgers exactly sum — no second writer to race.

    Conservation invariant (pinned by the property test)::

        t1_bytes + in_transit_bytes + t2_bytes
            == inserted + discovered - evicted

    T0 is a COPY tier — loading a row copies the T1 factors to device
    without moving host bytes, so it has its own resident ledger
    (``len(_t0) × entry_bytes``) outside the conservation equation, and
    its evictions (``t0_evictions``) just free a row.
    """

    #: max fetch/put jobs queued before new demotions evict instead
    #: (backpressure: a dead backend must not grow host memory)
    MAX_PENDING_JOBS = 256

    def __init__(
        self,
        spec: AdapterStoreSpec,
        *,
        fingerprint: dict[str, Any],
        entry_bytes: int,
        clock: Callable[[], float] = time.monotonic,
        fault_injector=None,
    ):
        self.spec = spec
        # the `t2-get` fault seam (serving/faults.py): the engine hands its
        # armed injector down, so a chaos test can drop or delay the
        # hydrator's object-storage fetch (a dropped fetch takes the
        # hydrate-timeout fallback). None in production.
        self._fault_injector = fault_injector
        self.fingerprint = dict(fingerprint)
        # every adapter in a fleet has identical factor shapes (the
        # fingerprint enforces it), so T0 residency is exact arithmetic
        self.entry_bytes = int(entry_bytes)
        self._clock = clock
        # T0: name -> device row (1-based; row 0 is the zeros row).
        # Insertion order = LRU; move_to_end on hit.
        self._t0: "OrderedDict[str, int]" = OrderedDict()
        self._rows_free: list[int] = list(range(spec.t0_entries, 0, -1))
        # name -> in-flight request pin count; pinned rows are never
        # evicted (the refusal the issue's ledger contract names)
        self._pins: dict[str, int] = {}
        # T1: name -> {"arrays": {factor: np}, "nbytes", "pinned_m"}
        self._t1: "OrderedDict[str, dict[str, Any]]" = OrderedDict()
        self.t1_bytes = 0
        # demotions being serialized/PUT on the hydrator (bytes stay
        # accounted until the put confirms — never in two tiers at once)
        self._t2_inflight: dict[str, dict[str, Any]] = {}
        self.in_transit_bytes = 0
        # T2 index: name -> payload bytes (0 = discovered via scan, size
        # unknown until hydrated); insertion order = age for trims
        self._t2_index: "OrderedDict[str, int]" = OrderedDict()
        self.t2_bytes = 0
        self.t2_blob_bytes = 0
        # names with an in-flight T2 fetch (dedup + completion check)
        self._hydrating: dict[str, float] = {}
        # loop-side event feed for the engine's flight recorder
        self._events: deque = deque()
        # monotone counters (conservation terms + tier hit/miss)
        self.inserted_bytes = 0
        self.hydrated_bytes = 0
        self.discovered_bytes = 0
        self.evicted_bytes = 0
        self.t0_hits = 0
        self.t1_hits = 0
        self.t1_misses = 0
        self.t2_hits = 0
        self.loads = 0
        self.installs = 0
        self.demotions_t1_t2 = 0
        self.hydrations = 0
        self.hydrate_failures = 0
        self.fingerprint_refusals = 0
        self.evictions = 0
        self.t0_evictions = 0
        self.eviction_refusals = 0
        self.scans = 0
        # hydrator plumbing: handoff deques + a kick event; the thread
        # starts only when a T2 backend is configured
        self._jobs: deque = deque()
        self._results: deque = deque()
        self._kick = threading.Event()
        self._storage = make_prefix_storage(spec.t2_config())
        self._thread: threading.Thread | None = None
        if self._storage is not None:
            self._jobs.append(("scan",))
            self._thread = threading.Thread(
                target=self._io_loop, name="adapter-hydrator", daemon=True
            )
            self._thread.start()

    # -- wait-free decision paths ----------------------------------------

    def t0_row(self, name: str) -> int | None:
        """Device row for a resident adapter (LRU bump) or None."""
        row = self._t0.get(name)
        if row is None:
            return None
        self._t0.move_to_end(name)
        self.t0_hits += 1
        return row

    def t0_resident(self) -> dict[str, int]:
        """Snapshot of the resident row map (stats/panel surface)."""
        return dict(self._t0)

    def pin(self, name: str) -> None:
        """Count one in-flight request against the adapter's row; a
        pinned row is refused eviction until every pin releases."""
        self._pins[name] = self._pins.get(name, 0) + 1

    def unpin(self, name: str) -> None:
        n = self._pins.get(name, 0) - 1
        if n <= 0:
            self._pins.pop(name, None)
        else:
            self._pins[name] = n

    def pinned(self, name: str) -> int:
        return self._pins.get(name, 0)

    def t0_assign(self, name: str) -> int | None:
        """Pick a device row for ``name``: a free row, else evict the
        LRU unpinned resident. Returns None when every resident row is
        pinned by in-flight requests — the eviction is REFUSED and the
        caller backpressures (admission retries next pass). The engine
        owns the actual device copy; it calls :meth:`note_loaded` after
        the copy lands."""
        row = self._t0.get(name)
        if row is not None:
            self._t0.move_to_end(name)
            return row
        if self._rows_free:
            row = self._rows_free.pop()
        else:
            victim = None
            for resident in self._t0:  # LRU order
                if self._pins.get(resident, 0) == 0:
                    victim = resident
                    break
            if victim is None:
                self.eviction_refusals += 1
                return None
            row = self._t0.pop(victim)
            self.t0_evictions += 1
            self._events.append(
                (
                    "adapter-evict",
                    {
                        "tier": "t0",
                        "adapter": victim,
                        "row": row,
                        "reason": "t0-capacity",
                    },
                )
            )
        self._t0[name] = row
        return row

    def note_loaded(self, name: str, row: int, device_ms: float = 0.0) -> None:
        """Bookkeeping for a completed T1→T0 device copy (the engine
        owns the copy; the store only counts it)."""
        self.loads += 1
        self._events.append(
            ("adapter-load",
             {"adapter": name, "row": row,
              "bytes": self.entry_bytes,
              "device_ms": round(device_ms, 3)})
        )

    def t1_has(self, name: str) -> bool:
        return name in self._t1

    def t2_has(self, name: str) -> bool:
        """Wait-free T2 membership: the in-memory index maintained by
        put confirmations and hydrator rescans — never storage I/O."""
        return name in self._t2_index or name in self._t2_inflight

    def hydrating(self, name: str) -> bool:
        return name in self._hydrating

    def known(self, name: str) -> bool:
        """Is the adapter anywhere in the tier chain? False means a
        request naming it is refused cold (nothing to wait for)."""
        return (
            name in self._t0
            or name in self._t1
            or self.t2_has(name)
            or name in self._hydrating
        )

    def t1_peek(self, name: str) -> dict[str, Any] | None:
        """T1 entry for a device load (LRU bump, NOT removed — T0 is a
        copy tier, so the host bytes stay in T1 under its own budget).
        Counts a hit or a miss; a miss returns None."""
        entry = self._t1.get(name)
        if entry is None:
            self.t1_misses += 1
            return None
        self._t1.move_to_end(name)
        self.t1_hits += 1
        return entry

    def install(self, name: str, arrays: dict[str, np.ndarray]) -> None:
        """Directly insert adapter factors into T1 (local load path:
        tests, bench seeding, a sidecar that fetched out-of-band).
        Overwrites an existing version of the same name."""
        check_adapter_name(name)
        missing = sorted(set(FACTOR_KEYS) - set(arrays))
        if missing:
            raise ValueError(f"adapter {name!r} missing factors {missing}")
        old = self._t1.pop(name, None)
        if old is not None:
            self.t1_bytes -= old["nbytes"]
            self.evicted_bytes += old["nbytes"]
            self.evictions += 1
        self.installs += 1
        self._insert_t1(name, arrays, source="local")

    def _insert_t1(
        self,
        name: str,
        arrays: dict[str, np.ndarray],
        *,
        source: str,
    ) -> None:
        """Insert one installed/hydrated adapter into T1 (loop-side).
        Past the byte budget the LRU tail demotes to T2 (when
        configured) or evicts — counted and evented either way."""
        if name in self._t1:
            return  # already resident (idempotent re-insert)
        nbytes = int(sum(a.nbytes for a in arrays.values()))
        self._t1[name] = {
            "arrays": arrays,
            "nbytes": nbytes,
            # hydrated entries are PINNED against the budget shrink for
            # one hydrate-timeout window: the admission that asked for
            # them loads them to a device row within it, and without
            # the pin a tight T1 budget would evict the hydration
            # before the requeued request saw it (hydrate → evict →
            # re-hydrate livelock). Expired pins shrink normally.
            "pinned_m": self._clock() if source == "t2" else None,
        }
        self.t1_bytes += nbytes
        self.inserted_bytes += nbytes
        self._shrink_t1()

    def _shrink_t1(self) -> None:
        """Eviction decision for the T1 byte budget (wait-free: the LRU
        walk is dict arithmetic; demotion I/O happens later on the
        hydrator)."""
        while self.t1_bytes > self.spec.t1_bytes and self._t1:
            victim = None
            now = self._clock()
            for name, entry in self._t1.items():  # LRU order
                pinned = entry.get("pinned_m")
                if (
                    pinned is not None
                    and now - pinned < self.spec.hydrate_timeout_s
                ):
                    continue
                victim = name
                break
            if victim is None:
                # everything live-pinned by in-flight hydrations: allow
                # the bounded overshoot and let the pins expire
                return
            name = victim
            entry = self._t1.pop(victim)
            self.t1_bytes -= entry["nbytes"]
            if (
                self._storage is not None
                and name not in self._t2_index
                and name not in self._t2_inflight
                and len(self._jobs) < self.MAX_PENDING_JOBS
            ):
                self._t2_inflight[name] = entry
                self.in_transit_bytes += entry["nbytes"]
                self.demotions_t1_t2 += 1
                self._jobs.append(("put", name, entry))
                self._kick.set()
                self._events.append(
                    (
                        "adapter-demote",
                        {
                            "tier": "t1->t2",
                            "adapter": name,
                            "bytes": entry["nbytes"],
                        },
                    )
                )
            else:
                reason = (
                    "already-in-t2"
                    if name in self._t2_index or name in self._t2_inflight
                    else ("t1-budget" if self._storage is None
                          else "hydrator-backlog")
                )
                # a copy already durable in T2 is dropped, not lost
                self.evictions += 1
                self.evicted_bytes += entry["nbytes"]
                self._events.append(
                    (
                        "adapter-evict",
                        {
                            "tier": "t1",
                            "adapter": name,
                            "bytes": entry["nbytes"],
                            "reason": reason,
                        },
                    )
                )

    def request_hydration(self, names: list[str]) -> int:
        """Enqueue T2→T1 fetches for the named adapters (dedup'd,
        backpressured). Returns how many fetches are now pending — 0
        means nothing to wait for."""
        pending = 0
        for name in names:
            if name in self._t1:
                continue
            if name in self._hydrating:
                pending += 1
                continue
            if name not in self._t2_index:
                continue
            if len(self._jobs) >= self.MAX_PENDING_JOBS:
                break
            self._hydrating[name] = self._clock()
            self._jobs.append(("fetch", name))
            pending += 1
        if pending:
            self._kick.set()
        return pending

    def apply_results(self) -> None:
        """Drain the hydrator's result deque and apply ledger moves +
        T1 inserts on the loop side (the single writer). Wait-free:
        container ops and arithmetic over already-fetched payloads."""
        while self._results:
            result = self._results.popleft()
            kind = result[0]
            if kind == "put-done":
                _, name, blob_bytes = result
                entry = self._t2_inflight.pop(name, None)
                if entry is None:
                    continue
                self.in_transit_bytes -= entry["nbytes"]
                self._t2_index[name] = entry["nbytes"]
                self.t2_bytes += entry["nbytes"]
                self.t2_blob_bytes += blob_bytes
                self._trim_t2()
            elif kind == "put-failed":
                _, name, error = result
                entry = self._t2_inflight.pop(name, None)
                if entry is None:
                    continue
                self.in_transit_bytes -= entry["nbytes"]
                self.evictions += 1
                self.evicted_bytes += entry["nbytes"]
                self._events.append(
                    (
                        "adapter-evict",
                        {
                            "tier": "t1->t2",
                            "adapter": name,
                            "bytes": entry["nbytes"],
                            "reason": f"put-failed: {error}"[:120],
                        },
                    )
                )
            elif kind == "fetch-done":
                _, name, arrays, nbytes = result
                self._hydrating.pop(name, None)
                known = self._t2_index.get(name)
                if known == 0:
                    # discovered via scan: size learned at first fetch
                    self._t2_index[name] = nbytes
                    self.t2_bytes += nbytes
                    self.discovered_bytes += nbytes
                self.t2_hits += 1
                self.hydrations += 1
                if name not in self._t1:
                    self.hydrated_bytes += nbytes
                    self._events.append(
                        (
                            "adapter-hydrate",
                            {
                                "stage": "fetched",
                                "adapter": name,
                                "bytes": nbytes,
                            },
                        )
                    )
                    self._insert_t1(name, arrays, source="t2")
            elif kind == "fetch-refused":
                _, name, error = result
                self._hydrating.pop(name, None)
                dropped = self._t2_index.pop(name, None)
                if dropped:
                    self.t2_bytes -= dropped
                    self.evicted_bytes += dropped
                self.fingerprint_refusals += 1
                self.hydrate_failures += 1
                self.evictions += 1
                self._events.append(
                    (
                        "adapter-evict",
                        {
                            "tier": "t2",
                            "adapter": name,
                            "bytes": dropped or 0,
                            "reason": f"fingerprint-refused: {error}"[:160],
                        },
                    )
                )
            elif kind == "fetch-missing":
                _, name = result
                self._hydrating.pop(name, None)
                dropped = self._t2_index.pop(name, None)
                if dropped:
                    self.t2_bytes -= dropped
                    self.evicted_bytes += dropped
                self.hydrate_failures += 1
            elif kind == "scan-done":
                _, keys = result
                self.scans += 1
                for key in keys:
                    if (
                        key not in self._t2_index
                        and key not in self._t2_inflight
                    ):
                        # size unknown until first hydration (0-byte
                        # placeholder keeps the conservation equation
                        # exact: discovered bytes count when learned)
                        self._t2_index[key] = 0
                dead = [
                    k for k, n in self._t2_index.items()
                    if k not in keys and k not in self._hydrating
                ]
                for k in dead:
                    n = self._t2_index.pop(k)
                    if n:
                        self.t2_bytes -= n
                        self.evicted_bytes += n
                        self.evictions += 1

    def _trim_t2(self) -> None:
        """T2 byte-budget decision (wait-free; deletions are hydrator
        jobs). Oldest-first, never an entry being hydrated."""
        if self.spec.t2_bytes is None:
            return
        for name in list(self._t2_index):
            if self.t2_bytes <= self.spec.t2_bytes:
                break
            if name in self._hydrating:
                continue
            nbytes = self._t2_index.pop(name)
            self.t2_bytes -= nbytes
            self.evictions += 1
            self.evicted_bytes += nbytes
            self._jobs.append(("delete", name))
            self._kick.set()
            self._events.append(
                (
                    "adapter-evict",
                    {
                        "tier": "t2",
                        "adapter": name,
                        "bytes": nbytes,
                        "reason": "t2-budget",
                    },
                )
            )

    def drain_events(self) -> list[tuple[str, dict[str, Any]]]:
        """Pop the pending flight-event feed (loop-side emitter)."""
        out = []
        while self._events:
            out.append(self._events.popleft())
        return out

    def ledger(self) -> dict[str, Any]:
        """The exact byte ledger + conservation terms (wait-free)."""
        return {
            "t0_bytes": len(self._t0) * self.entry_bytes,
            "t1_bytes": self.t1_bytes,
            "in_transit_bytes": self.in_transit_bytes,
            "t2_bytes": self.t2_bytes,
            "t2_blob_bytes": self.t2_blob_bytes,
            "inserted_bytes": self.inserted_bytes,
            "hydrated_bytes": self.hydrated_bytes,
            "discovered_bytes": self.discovered_bytes,
            "evicted_bytes": self.evicted_bytes,
        }

    def stats(self) -> dict[str, Any]:
        return {
            "t0": {
                "entries": len(self._t0),
                "budget_entries": self.spec.t0_entries,
                "bytes": len(self._t0) * self.entry_bytes,
                "budget_bytes": self.spec.t0_entries * self.entry_bytes,
                "resident": sorted(self._t0),
                "pinned": {k: v for k, v in sorted(self._pins.items())},
                "hits": self.t0_hits,
                "loads": self.loads,
                "evictions": self.t0_evictions,
                "eviction_refusals": self.eviction_refusals,
            },
            "t1": {
                "entries": len(self._t1),
                "bytes": self.t1_bytes,
                "budget_bytes": self.spec.t1_bytes,
                "hits": self.t1_hits,
                "misses": self.t1_misses,
            },
            "t2": {
                "enabled": self._storage is not None,
                "entries": len(self._t2_index),
                "bytes": self.t2_bytes,
                "blob_bytes": self.t2_blob_bytes,
                "budget_bytes": self.spec.t2_bytes,
                "hits": self.t2_hits,
                "in_transit_bytes": self.in_transit_bytes,
                "pending_jobs": len(self._jobs),
                "scans": self.scans,
            },
            "rank": self.spec.rank,
            "entry_bytes": self.entry_bytes,
            # the thrash-analysis window (engine_top and the
            # adapter-storm predicate, serving/incident.py, count
            # same-adapter evictions inside one hydrate window)
            "hydrate_timeout_s": self.spec.hydrate_timeout_s,
            "installs": self.installs,
            "demotions_t1_t2": self.demotions_t1_t2,
            "hydrations": self.hydrations,
            "hydrating": len(self._hydrating),
            "hydrate_failures": self.hydrate_failures,
            "fingerprint_refusals": self.fingerprint_refusals,
            "evictions": self.evictions,
            "ledger": self.ledger(),
        }

    # -- hydrator thread (T2 I/O, the one blocking path by design) ------

    def _io_loop(self) -> None:
        storage = self._storage
        assert storage is not None
        while True:
            if not self._jobs:
                kicked = self._kick.wait(timeout=self.spec.t2_rescan_s)
                self._kick.clear()
                if not kicked:
                    # periodic rescan: notice adapters OTHER replicas
                    # (or an offline publisher) wrote
                    self._io_scan(storage)
                    continue
            try:
                job = self._jobs.popleft()
            except IndexError:
                continue
            kind = job[0]
            if kind == "stop":
                return
            if kind == "sync":
                job[1].set()
            elif kind == "scan":
                self._io_scan(storage)
            elif kind == "put":
                self._io_put(storage, job[1], job[2])
            elif kind == "fetch":
                self._io_fetch(storage, job[1])
            elif kind == "delete":
                try:
                    storage.delete(job[1])
                except Exception as e:
                    # budget trims are best-effort: the ledger already
                    # dropped the entry and counted the bytes
                    log.debug("adapter T2 delete failed: %s", e)

    def _io_scan(self, storage: PrefixStorage) -> None:
        try:
            keys = storage.list_keys()
        except Exception as e:
            log.debug("adapter T2 scan failed: %s", e)
            return
        self._results.append(("scan-done", keys))

    def _io_put(
        self, storage: PrefixStorage, name: str, entry: dict[str, Any]
    ) -> None:
        try:
            blob = serialize_adapter(
                name, entry["arrays"], self.fingerprint
            )
            storage.put(name, blob)
        except Exception as e:
            self._results.append(("put-failed", name, str(e)))
            return
        self._results.append(("put-done", name, len(blob)))

    def _io_fetch(self, storage: PrefixStorage, name: str) -> None:
        if self._fault_injector is not None:
            action = self._fault_injector.fire("t2-get")
            if action is not None:
                # hydrator thread: a stall or drop never touches the engine
                # loop; a drop reports fetch-missing (the blob "vanished")
                self._events.append(
                    ("fault-injected",
                     {"site": "t2-get", "shape": action.shape, "fire": action.seq})
                )
                if action.shape == "delay-ms":
                    time.sleep(action.hang_ms / 1000.0)
                elif action.shape in ("drop", "error", "oom", "hang"):
                    self._results.append(("fetch-missing", name))
                    return
        try:
            blob = storage.get(name)
        except Exception:
            blob = None
        if blob is None:
            self._results.append(("fetch-missing", name))
            return
        try:
            arrays = deserialize_adapter(blob, name, self.fingerprint)
            nbytes = int(sum(a.nbytes for a in arrays.values()))
        except LayoutMismatch as e:
            # refused AND deleted — a mismatched blob must never be
            # half-loaded, and leaving it would refuse forever
            try:
                storage.delete(name)
            except Exception as delete_error:
                log.debug(
                    "adapter T2 refused-blob delete failed: %s", delete_error
                )
            self._results.append(("fetch-refused", name, str(e)))
            return
        except Exception as e:
            self._results.append(("fetch-refused", name, str(e)))
            return
        self._results.append(("fetch-done", name, arrays, nbytes))

    # -- lifecycle -------------------------------------------------------

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued hydrator job has been processed
        (tests/bench only — never called on the engine loop). Returns
        False on timeout or when no hydrator runs."""
        if self._thread is None:
            return False
        done = threading.Event()
        self._jobs.append(("sync", done))
        self._kick.set()
        return done.wait(timeout_s)

    def close(self) -> None:
        if self._thread is not None:
            self._jobs.append(("stop",))
            self._kick.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._storage is not None:
            self._storage.close()


# ---------------------------------------------------------------------------
# wire helpers (LSKV adapter blobs) + offline publish/merge utilities
# ---------------------------------------------------------------------------


def serialize_adapter(
    name: str,
    arrays: dict[str, np.ndarray],
    fingerprint: dict[str, Any],
) -> bytes:
    """Pack one adapter's factors into the kvtransfer LSKV wire with
    the adapter header (kind, name, fingerprint)."""
    nbytes = int(sum(a.nbytes for a in arrays.values()))
    header = {
        "kind": BLOB_KIND,
        "name": name,
        "fingerprint": dict(fingerprint),
        "payload-bytes": nbytes,
    }
    return serialize_handoff(header, dict(arrays))


def deserialize_adapter(
    blob: bytes, name: str, fingerprint: dict[str, Any]
) -> dict[str, np.ndarray]:
    """Unpack + verify one adapter blob: kind, name-vs-key, fingerprint
    and factor-set checks all raise :class:`LayoutMismatch` (the caller
    refuses AND deletes). Returns contiguous host copies."""
    header, arrays = deserialize_handoff(blob)
    if header.get("kind") != BLOB_KIND:
        raise LayoutMismatch(
            f"not a lora-adapter blob (kind={header.get('kind')!r})"
        )
    if header.get("name") != name:
        raise LayoutMismatch(
            f"blob name {header.get('name')!r} does not match its key {name!r}"
        )
    check_adapter_fingerprint(fingerprint, header.get("fingerprint") or {})
    missing = sorted(set(FACTOR_KEYS) - set(arrays))
    if missing:
        raise LayoutMismatch(f"adapter blob missing factors {missing}")
    # contiguous host copies: frombuffer views over the blob would pin
    # the whole payload per array
    return {k: _host_copy(arrays[k]) for k in FACTOR_KEYS}


def _host_copy(t: torch.Tensor):
    """An owned host copy of one wire array: numpy where numpy has the
    dtype (the JAX package's arrays), else a CPU tensor (bf16)."""
    if t.dtype == torch.bfloat16:
        return t.clone()
    return t.numpy().copy()


def publish_adapter(
    t2_config: dict[str, Any],
    name: str,
    arrays: dict[str, np.ndarray],
    fingerprint: dict[str, Any],
) -> int:
    """Offline publish path (training jobs, tests, bench seeding):
    serialize the factors and PUT them into the T2 origin so replicas
    discover them by rescan. Returns the blob size in bytes."""
    check_adapter_name(name)
    storage = make_prefix_storage(dict(t2_config))
    if storage is None:
        raise ValueError("publish_adapter requires a t2 storage config")
    try:
        blob = serialize_adapter(name, arrays, fingerprint)
        storage.put(name, blob)
    finally:
        storage.close()
    return len(blob)


def make_lora_arrays(
    *,
    layers: int,
    hidden: int,
    heads: int,
    kv_heads: int,
    head_dim: int,
    rank: int,
    seed: int,
    scale: float = 0.02,
    dtype=np.float32,
) -> dict[str, np.ndarray]:
    """Deterministic random LoRA factors for tests/bench (seeded, so a
    cross-replica run can regenerate identical adapters). The alpha/rank
    scale is already folded into the B factors — application is plain
    ``h @ A @ B``."""
    rng = np.random.default_rng(seed)
    q_dim = heads * head_dim
    kv_dim = kv_heads * head_dim

    def _pair(d_in: int, d_out: int, a_key: str, b_key: str):
        a = rng.standard_normal((layers, d_in, rank)) * (1.0 / np.sqrt(d_in))
        b = rng.standard_normal((layers, rank, d_out)) * scale
        return {a_key: a.astype(dtype), b_key: b.astype(dtype)}

    out: dict[str, np.ndarray] = {}
    out.update(_pair(hidden, q_dim, "wq_a", "wq_b"))
    out.update(_pair(hidden, kv_dim, "wk_a", "wk_b"))
    out.update(_pair(hidden, kv_dim, "wv_a", "wv_b"))
    out.update(_pair(q_dim, hidden, "wo_a", "wo_b"))
    return out


def merge_adapter_into_params(params: dict[str, Any], arrays: dict[str, Any]) -> dict[str, Any]:
    """Offline-merged reference weights ``W + A @ B`` for the correctness
    pin: a single-adapter batched run must give (greedy, f32) the tokens
    of the base model with the deltas merged in. ``params`` is a port
    parameter tree with dense (not int8) attention weights; the merged
    tree shares every other leaf."""
    layers = dict(params["layers"])
    for proj in ("wq", "wk", "wv", "wo"):
        w = layers[proj]
        if not isinstance(w, torch.Tensor):
            raise TypeError(f"merge_adapter_into_params needs dense {proj} weights")
        a = torch.as_tensor(arrays[f"{proj}_a"]).to(device=w.device, dtype=w.dtype)
        b = torch.as_tensor(arrays[f"{proj}_b"]).to(device=w.device, dtype=w.dtype)
        layers[proj] = w + torch.einsum("lir,lro->lio", a, b)
    out = dict(params)
    out["layers"] = layers
    return out


class AdapterUnavailable(RuntimeError):
    """A request named an adapter the serving tier chain cannot
    produce — unknown name, hydration timeout, or hydration failure.
    Refused loudly: unlike a prefix miss there is no recompute
    fallback."""
