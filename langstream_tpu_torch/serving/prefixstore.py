"""Tiered prefix-KV store: device pool -> host RAM -> object storage (port
of ``langstream_tpu/serving/prefixstore.py``).

The paged engine's prefix cache shares committed prompt blocks within one
engine's pool; this module extends it into three tiers, so shared
prefixes survive pool pressure and cross replicas:

- **T0, the card**: the content-addressed prefix blocks of the paged pool,
  under a byte budget (``t0-bytes``). Over it the engine *demotes* LRU
  cache-only leaf blocks: their rows are gathered to host (one timed fetch
  on the dispatch thread) and handed to this store.
- **T1, host RAM**: an LRU byte-budgeted (``t1-bytes``) map of demoted
  blocks as host tensors, keyed by the same chained block digests the T0
  cache uses. An admission whose prompt chain extends past its T0 match
  *promotes* T1 entries into freshly allocated pool blocks and prefills
  only the rest.
- **T2, object storage**: T1 overflow serializes through the LSKV wire
  (``serving/kvtransfer.py``: magic, layout fingerprint, digest chain,
  raw rows) into a :class:`PrefixStorage` (local disk, or S3). Another
  replica finds the blob by digest, checks its fingerprint (a mismatch is
  refused AND deleted, never half-installed) and hydrates it into its own
  T1, then T0. The blobs are byte-compatible with the JAX package's, so
  both packages can share one bucket.

Threading: every T0/T1 lookup, promotion take, insertion and eviction
decision is wait-free (container ops and arithmetic, no locks, no I/O, no
device work), because it runs at the engine loop's safe point. The only
blocking work is T2 I/O, on the background hydrator thread (``_io_*``),
which talks to the loop through deques (jobs in, results out); the loop
applies results at its next safe point. The byte ledgers have one writer
(the loop) and always sum exactly: every demotion, promotion, hydration
and eviction moves its bytes between named ledgers and emits a flight
event; a loss is counted, never silent.
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
import logging
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from pathlib import Path
from typing import Any, Callable

from langstream_tpu_torch.serving.kvtransfer import (
    LayoutMismatch,
    check_fingerprint,
    deserialize_handoff,
    serialize_handoff,
)

log = logging.getLogger(__name__)

#: blob kind stamped into every T2 header: a prefix-block blob is NOT a
#: request handoff, and an import path must be able to tell them apart
BLOB_KIND = "prefix-block"


# ---------------------------------------------------------------------------
# spec (the `prefix-store` section of tpu-serving-configuration)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrefixStoreSpec:
    """Frozen, hashable tier policy (rides :class:`ServingConfig`, so it
    follows the same kebab ``to_dict``/``from_dict`` round-trip and
    deploy-time validation contract as qos/slo/autoscale specs)."""

    enabled: bool = True
    # T0 budget over the prefix sub-owner of the paged pool
    # (kv_pool_prefix_bytes); None = unbudgeted, no demotion pressure
    t0_bytes: int | None = None
    # T1 host-RAM budget (LRU eviction past it; overflow demotes to T2
    # when one is configured, else evicts — counted, never silent)
    t1_bytes: int = 256 << 20
    # T2 object-storage budget; None = unbudgeted (storage-side lifecycle
    # rules may still apply)
    t2_bytes: int | None = None
    # T2 backend config as sorted (key, value) pairs so the spec stays
    # hashable; () disables T2 (T1 overflow evicts). See
    # :func:`make_prefix_storage` for the schema.
    t2: tuple[tuple[str, str], ...] = ()
    # how long an admission may wait for a T2 hydration before falling
    # back to cold compute (the request is stashed, not head-blocking)
    hydrate_timeout_s: float = 5.0
    # hydrator-thread T2 index rescan period: how quickly this replica
    # notices blobs OTHER replicas published
    t2_rescan_s: float = 5.0

    def t2_config(self) -> dict[str, str] | None:
        return dict(self.t2) if self.t2 else None

    def to_dict(self) -> dict[str, Any]:
        return {
            "enabled": self.enabled,
            "t0-bytes": self.t0_bytes,
            "t1-bytes": self.t1_bytes,
            "t2-bytes": self.t2_bytes,
            "t2": self.t2_config(),
            "hydrate-timeout-s": self.hydrate_timeout_s,
            "t2-rescan-s": self.t2_rescan_s,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "PrefixStoreSpec | None":
        if d is None:
            return None
        if not isinstance(d, dict):
            raise ValueError("prefix-store section must be a mapping")
        known = {
            "enabled", "t0-bytes", "t0_bytes", "t1-bytes", "t1_bytes",
            "t2-bytes", "t2_bytes", "t2", "hydrate-timeout-s",
            "hydrate_timeout_s", "t2-rescan-s", "t2_rescan_s",
        }
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown prefix-store keys: {unknown}")

        def _opt_bytes(kebab: str, snake: str) -> int | None:
            v = d.get(kebab, d.get(snake))
            if v is None:
                return None
            v = int(v)
            if v < 0:
                raise ValueError(f"prefix-store {kebab} must be >= 0")
            return v

        t1 = int(d.get("t1-bytes", d.get("t1_bytes", cls.t1_bytes)))
        if t1 <= 0:
            raise ValueError("prefix-store t1-bytes must be > 0")
        t2_cfg = d.get("t2")
        t2: tuple[tuple[str, str], ...] = ()
        if t2_cfg:
            if not isinstance(t2_cfg, dict):
                raise ValueError("prefix-store t2 must be a mapping")
            t2_type = str(t2_cfg.get("type", "local"))
            if t2_type not in ("local", "s3"):
                raise ValueError(
                    f"unknown prefix-store t2 type {t2_type!r} "
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
                "prefix-store hydrate-timeout-s and t2-rescan-s must be > 0"
            )
        enabled = d.get("enabled", True)
        if isinstance(enabled, str):
            enabled = enabled.strip().lower() in ("1", "true", "yes", "on")
        return cls(
            enabled=bool(enabled),
            t0_bytes=_opt_bytes("t0-bytes", "t0_bytes"),
            t1_bytes=t1,
            t2_bytes=_opt_bytes("t2-bytes", "t2_bytes"),
            t2=t2,
            hydrate_timeout_s=hydrate,
            t2_rescan_s=rescan,
        )


def validate_application_prefix_store(application) -> None:
    """Deploy-time validation: parse every ``tpu-serving-configuration``
    resource's ``prefix-store`` section so a malformed tier policy fails
    the deploy (HTTP 400) instead of the first request — the same
    contract qos/slo/autoscale validation keeps."""
    for name, res in (getattr(application, "resources", None) or {}).items():
        if getattr(res, "type", None) != "tpu-serving-configuration":
            continue
        try:
            PrefixStoreSpec.from_dict(
                (res.configuration or {}).get("prefix-store")
            )
        except ValueError as e:
            raise ValueError(
                f"resource {name!r}: invalid prefix-store section: {e}"
            ) from e


# ---------------------------------------------------------------------------
# T2 storage backends (modeled on core/codestorage.py)
# ---------------------------------------------------------------------------


class PrefixStorage(abc.ABC):
    """Where T2 prefix-block blobs live. Keys are digest hexes (content
    addresses): immutable blobs, so PUT/GET need no versioning. Every
    method is blocking I/O and runs only on the hydrator thread."""

    @abc.abstractmethod
    def put(self, key: str, blob: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> bytes | None: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def list_keys(self) -> list[str]: ...

    def close(self) -> None: ...


class LocalDiskPrefixStorage(PrefixStorage):
    """Filesystem-backed T2 (shared volume / PV in-cluster, tmpdir in
    tests). One file per block: ``<root>/<digest>.kvp``."""

    SUFFIX = ".kvp"

    def __init__(self, root: Path | str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        if not key or any(c in key for c in "/\\.") or ".." in key:
            raise ValueError(f"illegal prefix-storage key {key!r}")
        return self.root / f"{key}{self.SUFFIX}"

    def put(self, key: str, blob: bytes) -> None:
        # write-then-rename: a reader (another replica on a shared
        # volume) must never see a torn blob. The tmp name is
        # writer-unique — two replicas demoting the SAME digest
        # concurrently each rename their own file (content-addressed,
        # so last-writer-wins is identical bytes); a shared tmp name
        # would make the loser's rename fail and falsely ledger its
        # bytes as evicted
        path = self._path(key)
        tmp = path.with_name(f"{key}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
        tmp.write_bytes(blob)
        tmp.replace(path)

    def get(self, key: str) -> bytes | None:
        try:
            return self._path(key).read_bytes()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        self._path(key).unlink(missing_ok=True)

    def list_keys(self) -> list[str]:
        return sorted(
            p.name[: -len(self.SUFFIX)]
            for p in self.root.glob(f"*{self.SUFFIX}")
        )


class S3PrefixStorage(PrefixStorage):
    """S3/MinIO-backed T2 over the port's SigV4 REST client
    (``serving/s3.py``; no SDK, lazy bucket creation)."""

    def __init__(self, configuration: dict[str, Any]):
        from langstream_tpu_torch.serving.s3 import SyncS3Client

        self.bucket = configuration.get(
            "bucket-name", "langstream-prefix-store"
        )
        self.key_prefix = configuration.get("key-prefix", "prefix-kv")
        region = configuration.get("region", "") or "us-east-1"
        endpoint = (
            configuration.get("endpoint")
            or f"https://s3.{region}.amazonaws.com"
        )
        self.client = SyncS3Client(
            endpoint=endpoint,
            access_key=configuration.get("access-key", ""),
            secret_key=configuration.get("secret-key", ""),
            region=region,
        )
        self._bucket_ready = False

    def _key(self, key: str) -> str:
        return f"{self.key_prefix}/{key}.kvp"

    def put(self, key: str, blob: bytes) -> None:
        if not self._bucket_ready:
            if not self.client.bucket_exists(self.bucket):
                self.client.create_bucket(self.bucket)
            self._bucket_ready = True
        self.client.put_object(self.bucket, self._key(key), blob)

    def get(self, key: str) -> bytes | None:
        try:
            return self.client.get_object(self.bucket, self._key(key))
        except Exception:
            return None

    def delete(self, key: str) -> None:
        self.client.delete_object(self.bucket, self._key(key))

    def list_keys(self) -> list[str]:
        import urllib.parse

        from langstream_tpu_torch.serving.s3 import _parse_list_objects

        out: list[str] = []
        token: str | None = None
        quoted_prefix = urllib.parse.quote(f"{self.key_prefix}/", safe="")
        while True:
            qs = f"?list-type=2&prefix={quoted_prefix}"
            if token:
                qs += "&continuation-token=" + urllib.parse.quote(token, safe="")
            _, body = self.client._request(
                "GET", f"/{self.bucket}{qs}", ok=(200,)
            )
            objects, token = _parse_list_objects(body)
            for obj in objects:
                name = str(obj.get("key") or "").rsplit("/", 1)[-1]
                if name.endswith(".kvp"):
                    out.append(name[: -len(".kvp")])
            if not token:
                return sorted(out)


def make_prefix_storage(
    configuration: dict[str, Any] | None,
) -> PrefixStorage | None:
    """Factory keyed by ``type`` (codestorage's registry shape). None /
    empty config = no T2 tier."""
    if not configuration:
        return None
    storage_type = configuration.get("type", "local")
    if storage_type == "local":
        path = configuration.get("path")
        if not path:
            raise ValueError("local prefix storage requires 'path'")
        return LocalDiskPrefixStorage(path)
    if storage_type == "s3":
        return S3PrefixStorage(configuration)
    raise ValueError(f"unknown prefix storage type {storage_type!r}")


# ---------------------------------------------------------------------------
# the tier store
# ---------------------------------------------------------------------------


class PrefixStore:
    """T1 host-RAM spill + T2 object-storage hydration for prefix
    blocks, with exact byte ledgers.

    Single-writer discipline: ALL ledger/counter/T1 mutations happen on
    the engine-loop side (:meth:`insert_t1` / :meth:`take_t1` /
    :meth:`apply_results`, called at the loop's safe point); the
    hydrator thread only performs storage I/O on job payloads and hands
    results back through ``_results``. That is what makes every read
    path wait-free and the ledgers exactly summing — there is
    no second writer to race.

    Conservation invariant (pinned by the property test)::

        t1_bytes + in_transit_bytes + t2_bytes
            == inserted + discovered - taken - evicted

    where every term is a monotone counter (``inserted`` counts every
    T1 arrival — demotions AND hydrations; ``hydrated_bytes`` is the
    informational hydration subtotal, not a second flow) and
    ``evicted`` covers every byte that left the store, each with a
    recorded reason.
    """

    #: max fetch/put jobs queued before new demotions are evicted
    #: instead (backpressure: a dead backend must not grow host memory)
    MAX_PENDING_JOBS = 256

    def __init__(
        self,
        spec: PrefixStoreSpec,
        *,
        fingerprint: dict[str, Any],
        block_bytes: int,
        rows_per_block: int,
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
        self.block_bytes = int(block_bytes)
        self.rows_per_block = int(rows_per_block)
        self._clock = clock
        # T1: digest hex -> {"parent": hex, "arrays": {name: host tensor},
        # "nbytes"}
        # (insertion order = LRU; move_to_end on hit)
        self._t1: "OrderedDict[str, dict[str, Any]]" = OrderedDict()
        self.t1_bytes = 0
        # demotions being serialized/PUT on the hydrator (bytes stay
        # accounted until the put confirms — never in two tiers at once)
        self._t2_inflight: dict[str, dict[str, Any]] = {}
        self.in_transit_bytes = 0
        # T2 index: digest hex -> payload bytes (0 = discovered via scan,
        # size unknown until hydrated); insertion order = age for budget
        # trims
        self._t2_index: "OrderedDict[str, int]" = OrderedDict()
        self.t2_bytes = 0
        self.t2_blob_bytes = 0
        # digests with an in-flight T2 fetch (dedup + completion check)
        self._hydrating: dict[str, float] = {}
        # loop-side event feed for the engine's flight recorder
        self._events: deque = deque()
        # monotone counters (the conservation-equation terms + hit/miss)
        self.inserted_bytes = 0
        self.taken_bytes = 0
        self.hydrated_bytes = 0
        self.discovered_bytes = 0
        self.evicted_bytes = 0
        self.t1_hits = 0
        self.t1_misses = 0
        self.t2_hits = 0
        self.demotions_t0_t1 = 0
        self.demotions_t1_t2 = 0
        self.promotions = 0
        self.hydrations = 0
        self.hydrate_failures = 0
        self.fingerprint_refusals = 0
        self.evictions = 0
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
                target=self._io_loop, name="prefix-hydrator", daemon=True
            )
            self._thread.start()

    # -- wait-free decision paths ----------------------------------------

    def t1_has(self, digest_hex: str) -> bool:
        return digest_hex in self._t1

    def t2_has(self, digest_hex: str) -> bool:
        """Wait-free T2 membership: the in-memory index maintained by
        put confirmations and hydrator rescans — never storage I/O."""
        return (
            digest_hex in self._t2_index
            or digest_hex in self._t2_inflight
        )

    def hydrating(self, digest_hex: str) -> bool:
        return digest_hex in self._hydrating

    def take_t1(self, digest_hex: str) -> dict[str, Any] | None:
        """Remove-and-return a T1 entry for promotion into T0 (the
        caller scatters its rows into freshly allocated pool blocks).
        Counts a hit or a miss; a miss returns None."""
        entry = self._t1.pop(digest_hex, None)
        if entry is None:
            self.t1_misses += 1
            return None
        self.t1_bytes -= entry["nbytes"]
        self.taken_bytes += entry["nbytes"]
        self.t1_hits += 1
        return entry

    def insert_t1(
        self,
        digest_hex: str,
        parent_hex: str,
        arrays: dict[str, Any],
        *,
        source: str = "t0",
    ) -> None:
        """Insert one demoted/hydrated block into T1 (loop-side). Past
        the byte budget the LRU tail demotes to T2 (when configured) or
        evicts — counted and evented either way."""
        if digest_hex in self._t1:
            return  # already resident (idempotent re-demote)
        nbytes = int(sum(a.nbytes for a in arrays.values()))
        self._t1[digest_hex] = {
            "parent": parent_hex,
            "arrays": arrays,
            "nbytes": nbytes,
            # hydrated entries are PINNED against the budget shrink for
            # one hydrate-timeout window: the admission that asked for
            # them promotes (takes) them within it, and without the pin
            # a tight T1 budget would evict the hydration before the
            # requeued request ever saw it (hydrate → evict → re-hydrate
            # livelock). Expired pins shrink normally — a shed request
            # can never pin host memory for good.
            "pinned_m": self._clock() if source == "t2" else None,
        }
        self.t1_bytes += nbytes
        self.inserted_bytes += nbytes
        if source == "t0":
            self.demotions_t0_t1 += 1
            self._events.append(
                (
                    "prefix-demote",
                    {
                        "tier": "t0->t1",
                        "digest": digest_hex[:16],
                        "bytes": nbytes,
                    },
                )
            )
        self._shrink_t1()

    def _shrink_t1(self) -> None:
        """Eviction decision for the T1 byte budget (wait-free: the LRU
        walk is dict arithmetic; the I/O of a demotion happens later on
        the hydrator)."""
        while self.t1_bytes > self.spec.t1_bytes and self._t1:
            victim = None
            now = self._clock()
            for digest_hex, entry in self._t1.items():  # LRU order
                pinned = entry.get("pinned_m")
                if (
                    pinned is not None
                    and now - pinned < self.spec.hydrate_timeout_s
                ):
                    continue
                victim = digest_hex
                break
            if victim is None:
                # everything live-pinned by in-flight hydrations: allow
                # the bounded overshoot (stash size × block bytes) and
                # let the pins expire
                return
            digest_hex = victim
            entry = self._t1.pop(victim)
            self.t1_bytes -= entry["nbytes"]
            if (
                self._storage is not None
                and digest_hex not in self._t2_index
                and digest_hex not in self._t2_inflight
                and len(self._jobs) < self.MAX_PENDING_JOBS
            ):
                self._t2_inflight[digest_hex] = entry
                self.in_transit_bytes += entry["nbytes"]
                self.demotions_t1_t2 += 1
                self._jobs.append(("put", digest_hex, entry))
                self._kick.set()
                self._events.append(
                    (
                        "prefix-demote",
                        {
                            "tier": "t1->t2",
                            "digest": digest_hex[:16],
                            "bytes": entry["nbytes"],
                        },
                    )
                )
            else:
                reason = (
                    "already-in-t2"
                    if digest_hex in self._t2_index
                    or digest_hex in self._t2_inflight
                    else ("t1-budget" if self._storage is None
                          else "hydrator-backlog")
                )
                # a copy already durable in T2 is dropped, not lost
                self.evictions += 1
                self.evicted_bytes += entry["nbytes"]
                self._events.append(
                    (
                        "prefix-evict",
                        {
                            "tier": "t1",
                            "digest": digest_hex[:16],
                            "bytes": entry["nbytes"],
                            "reason": reason,
                        },
                    )
                )

    def note_promoted(
        self, blocks: int, nbytes: int, device_ms: float = 0.0
    ) -> None:
        """Bookkeeping for a completed T1→T0 promotion (the engine owns
        the scatter; the store only counts it)."""
        self.promotions += 1
        self._events.append(
            ("prefix-promote", {"tier": "t1->t0", "blocks": blocks,
                                "bytes": nbytes,
                                "device_ms": round(device_ms, 3)})
        )

    def request_hydration(self, digest_hexes: list[str]) -> int:
        """Enqueue T2→T1 fetches for the given chain digests (dedup'd,
        backpressured). Returns how many fetches are now pending for
        them — 0 means nothing to wait for."""
        pending = 0
        for digest_hex in digest_hexes:
            if digest_hex in self._t1:
                continue
            if digest_hex in self._hydrating:
                pending += 1
                continue
            if digest_hex not in self._t2_index:
                continue
            if len(self._jobs) >= self.MAX_PENDING_JOBS:
                break
            self._hydrating[digest_hex] = self._clock()
            self._jobs.append(("fetch", digest_hex))
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
                _, digest_hex, blob_bytes = result
                entry = self._t2_inflight.pop(digest_hex, None)
                if entry is None:
                    continue
                self.in_transit_bytes -= entry["nbytes"]
                self._t2_index[digest_hex] = entry["nbytes"]
                self.t2_bytes += entry["nbytes"]
                self.t2_blob_bytes += blob_bytes
                self._trim_t2()
            elif kind == "put-failed":
                _, digest_hex, error = result
                entry = self._t2_inflight.pop(digest_hex, None)
                if entry is None:
                    continue
                self.in_transit_bytes -= entry["nbytes"]
                self.evictions += 1
                self.evicted_bytes += entry["nbytes"]
                self._events.append(
                    (
                        "prefix-evict",
                        {
                            "tier": "t1->t2",
                            "digest": digest_hex[:16],
                            "bytes": entry["nbytes"],
                            "reason": f"put-failed: {error}"[:120],
                        },
                    )
                )
            elif kind == "fetch-done":
                _, digest_hex, parent_hex, arrays, nbytes = result
                self._hydrating.pop(digest_hex, None)
                known = self._t2_index.get(digest_hex)
                if known == 0:
                    # discovered via scan: size learned at first fetch
                    self._t2_index[digest_hex] = nbytes
                    self.t2_bytes += nbytes
                    self.discovered_bytes += nbytes
                self.t2_hits += 1
                self.hydrations += 1
                if digest_hex not in self._t1:
                    # (a racing re-demote may have re-inserted the digest
                    # while the fetch was in flight — the rows are already
                    # resident, so no bytes move)
                    self.hydrated_bytes += nbytes
                    self._events.append(
                        (
                            "prefix-hydrate",
                            {
                                "stage": "fetched",
                                "digest": digest_hex[:16],
                                "bytes": nbytes,
                            },
                        )
                    )
                    self.insert_t1(
                        digest_hex, parent_hex, arrays, source="t2"
                    )
            elif kind == "fetch-refused":
                _, digest_hex, error = result
                self._hydrating.pop(digest_hex, None)
                dropped = self._t2_index.pop(digest_hex, None)
                if dropped:
                    self.t2_bytes -= dropped
                    self.evicted_bytes += dropped
                self.fingerprint_refusals += 1
                self.hydrate_failures += 1
                self.evictions += 1
                self._events.append(
                    (
                        "prefix-evict",
                        {
                            "tier": "t2",
                            "digest": digest_hex[:16],
                            "bytes": dropped or 0,
                            "reason": f"fingerprint-refused: {error}"[:160],
                        },
                    )
                )
            elif kind == "fetch-missing":
                _, digest_hex = result
                self._hydrating.pop(digest_hex, None)
                dropped = self._t2_index.pop(digest_hex, None)
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
        for digest_hex in list(self._t2_index):
            if self.t2_bytes <= self.spec.t2_bytes:
                break
            if digest_hex in self._hydrating:
                continue
            nbytes = self._t2_index.pop(digest_hex)
            self.t2_bytes -= nbytes
            self.evictions += 1
            self.evicted_bytes += nbytes
            self._jobs.append(("delete", digest_hex))
            self._kick.set()
            self._events.append(
                (
                    "prefix-evict",
                    {
                        "tier": "t2",
                        "digest": digest_hex[:16],
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
            "t1_bytes": self.t1_bytes,
            "in_transit_bytes": self.in_transit_bytes,
            "t2_bytes": self.t2_bytes,
            "t2_blob_bytes": self.t2_blob_bytes,
            "inserted_bytes": self.inserted_bytes,
            "taken_bytes": self.taken_bytes,
            "hydrated_bytes": self.hydrated_bytes,
            "discovered_bytes": self.discovered_bytes,
            "evicted_bytes": self.evicted_bytes,
        }

    def stats(self) -> dict[str, Any]:
        return {
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
            "demotions_t0_t1": self.demotions_t0_t1,
            "demotions_t1_t2": self.demotions_t1_t2,
            "promotions": self.promotions,
            "hydrations": self.hydrations,
            "hydrating": len(self._hydrating),
            "hydrate_failures": self.hydrate_failures,
            "fingerprint_refusals": self.fingerprint_refusals,
            "evictions": self.evictions,
            "ledger": self.ledger(),
        }

    # -- hydrator thread (T2 I/O: the only blocking work) ---------------

    def _io_loop(self) -> None:
        storage = self._storage
        assert storage is not None
        while True:
            if not self._jobs:
                kicked = self._kick.wait(timeout=self.spec.t2_rescan_s)
                self._kick.clear()
                if not kicked:
                    # periodic rescan: notice blobs OTHER replicas wrote
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
                    log.debug("prefix T2 delete failed: %s", e)

    def _io_scan(self, storage: PrefixStorage) -> None:
        try:
            keys = storage.list_keys()
        except Exception as e:
            log.debug("prefix T2 scan failed: %s", e)
            return
        self._results.append(("scan-done", keys))

    def _io_put(
        self, storage: PrefixStorage, digest_hex: str, entry: dict[str, Any]
    ) -> None:
        header = {
            "kind": BLOB_KIND,
            "fingerprint": self.fingerprint,
            "digest": digest_hex,
            "parent": entry["parent"],
            "rows": self.rows_per_block,
            "payload-bytes": entry["nbytes"],
        }
        try:
            blob = serialize_handoff(header, entry["arrays"])
            storage.put(digest_hex, blob)
        except Exception as e:
            self._results.append(("put-failed", digest_hex, str(e)))
            return
        self._results.append(("put-done", digest_hex, len(blob)))

    def _io_fetch(self, storage: PrefixStorage, digest_hex: str) -> None:
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
                    self._results.append(("fetch-missing", digest_hex))
                    return
        try:
            blob = storage.get(digest_hex)
        except Exception:
            blob = None
        if blob is None:
            self._results.append(("fetch-missing", digest_hex))
            return
        try:
            header, arrays = deserialize_handoff(blob)
            if header.get("kind") != BLOB_KIND:
                raise LayoutMismatch(
                    f"not a prefix-block blob (kind={header.get('kind')!r})"
                )
            if header.get("digest") != digest_hex:
                raise LayoutMismatch(
                    f"blob digest {header.get('digest')!r} does not match "
                    f"its key {digest_hex!r}"
                )
            check_fingerprint(self.fingerprint, header.get("fingerprint") or {})
            # host copies: the wire's views over the blob would pin the
            # whole payload per array
            arrays = {name: a.clone() for name, a in arrays.items()}
            nbytes = int(sum(a.nbytes for a in arrays.values()))
        except LayoutMismatch as e:
            # refused AND deleted — a mismatched blob must never be
            # half-hydrated, and leaving it would refuse forever
            try:
                storage.delete(digest_hex)
            except Exception as delete_error:
                log.debug(
                    "prefix T2 refused-blob delete failed: %s", delete_error
                )
            self._results.append(("fetch-refused", digest_hex, str(e)))
            return
        except Exception as e:
            self._results.append(("fetch-refused", digest_hex, str(e)))
            return
        self._results.append(
            ("fetch-done", digest_hex, str(header.get("parent") or ""),
             arrays, nbytes)
        )

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
# gateway-side prompt-prefix digest (stamped as a routing header)
# ---------------------------------------------------------------------------

#: record header carrying the chained prompt-prefix digest the gateway
#: stamps; the router pins prefix→replica affinity on it
PREFIX_HEADER = "langstream-prefix-digest"
#: chained-digest chunking over the prompt TEXT (the gateway never
#: tokenizes): two 256-char links ≈ one shared system preamble
PREFIX_STAMP_CHUNK = 256
PREFIX_STAMP_DEPTH = 2


def prefix_digest_for_text(value: Any) -> str | None:
    """Chained blake2b digest of the first ``DEPTH × CHUNK`` characters
    of a prompt value — the same chained construction the T0 cache and
    kvtransfer use over token blocks, applied to text so the gateway
    can stamp it without a tokenizer. Prompts sharing that head (the
    shared-system-prompt shape) stamp the SAME digest; shorter prompts
    stamp nothing (``None``) and route exactly as before."""
    if value is None:
        return None
    text = value if isinstance(value, str) else str(value)
    if len(text) < PREFIX_STAMP_CHUNK * PREFIX_STAMP_DEPTH:
        return None
    prev = b""
    for i in range(PREFIX_STAMP_DEPTH):
        chunk = text[i * PREFIX_STAMP_CHUNK: (i + 1) * PREFIX_STAMP_CHUNK]
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(chunk.encode("utf-8", errors="replace"))
        prev = h.digest()
    return prev.hex()
