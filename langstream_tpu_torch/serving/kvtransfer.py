"""The KV handoff wire and the pool's slot gather/scatter (port of
``langstream_tpu/serving/kvtransfer.py``).

A prefill pool hands a request to a decode pool as one payload::

    b"LSKV" | u32 version | u32 header_len | header JSON | raw arrays

The JSON header carries the layout fingerprint (:data:`FINGERPRINT_KEYS`),
the prompt digest, the generated-token snapshot, the sampling settings and
an array manifest (name, dtype, shape, byte count); the arrays follow as
raw bytes in manifest order (sorted by name): the K and V rows of the
slot's live positions, ``{"k", "v"}`` for bf16/f32 pools and ``{"k.q",
"k.s", "v.q", "v.s"}`` for int8 pools, whose quantized rows travel verbatim
(an export and import round trip is bit-exact). The bytes equal the JAX
package's for the same header and rows, so the two packages read each
other's payloads and T2 prefix blobs.

Host arrays here are CPU ``torch.Tensor`` s (numpy arrays are accepted on
the way in). ``bfloat16`` rows travel as their raw 2-byte words under the
manifest name ``"bfloat16"``: torch reads and writes them, numpy never
sees them, so no ``ml_dtypes`` is needed. An unknown dtype name is a
:class:`LayoutMismatch`.

Device side: :func:`gather_slot` densifies one slot's blocks through
:func:`~langstream_tpu_torch.models.paged.gather_kv`; :func:`fetch_rows`
is the export's ONE device sync (timed, on the engine's dispatch thread);
:func:`scatter_slot` writes imported rows back through
:func:`~langstream_tpu_torch.models.paged.write_rows`. Uploads go through
pinned memory without blocking, as the engine's do. Under a mesh each rank
holds its KV heads: a gather all-gathers the heads over ``tp`` into whole
rows, a scatter broadcasts whole rows from rank 0 and each rank writes its
heads, so payloads and blobs keep the layout above.
"""

from __future__ import annotations

import hashlib
import json
import time
import warnings
from typing import Any

import numpy as np
import torch

from langstream_tpu_torch.core.tracing import TraceContext
from langstream_tpu_torch.models.paged import gather_kv, write_rows

WIRE_MAGIC = b"LSKV"
WIRE_VERSION = 1

#: fingerprint keys that must match exactly between pools: a mismatch on
#: any of them means the raw rows are garbage in the other layout
FINGERPRINT_KEYS = (
    "model",
    "dtype",
    "kv-quantize",
    "kv-block-size",
    "layers",
    "kv-heads",
    "head-dim",
    "max-seq-len",
)

#: manifest dtype names (numpy's spellings, ``bfloat16`` as ml_dtypes
#: spells it) and the torch dtypes that carry them
_WIRE_DTYPES: dict[str, torch.dtype] = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_WIRE_NAMES = {dtype: name for name, dtype in _WIRE_DTYPES.items()}


class LayoutMismatch(ValueError):
    """The payload cannot land in this engine: wrong magic or version, or a
    layout fingerprint that disagrees on any geometry or dtype fact. A
    refusal, never a retry: no decode replica of the same fleet accepts
    it either."""


def trace_context(header: dict[str, Any]) -> TraceContext | None:
    """The handoff header's trace coordinate (None when the header carries
    none, or a malformed one: a bad trace never refuses a handoff the
    layout accepts)."""
    return TraceContext.parse(header.get("trace"))


def journey_id(header: dict[str, Any]) -> str | None:
    """The request-journey key riding the header: the explicit ``journey``
    field, falling back to the trace id."""
    jid = header.get("journey")
    if isinstance(jid, str) and jid:
        return jid
    ctx = trace_context(header)
    return ctx.trace_id if ctx is not None else None


def prompt_digest(tokens) -> str:
    """Content digest of a prompt (blake2b over int64 token bytes): the
    header's identity check and the flight events' request key."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(list(tokens), dtype=np.int64).tobytes())
    return h.hexdigest()


def check_fingerprint(ours: dict[str, Any], theirs: dict[str, Any]) -> None:
    """Raise :class:`LayoutMismatch` naming every disagreeing key."""
    bad = [k for k in FINGERPRINT_KEYS if ours.get(k) != theirs.get(k)]
    if bad:
        detail = ", ".join(
            f"{k}: ours={ours.get(k)!r} theirs={theirs.get(k)!r}" for k in bad
        )
        raise LayoutMismatch(f"KV layout fingerprint mismatch ({detail})")


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def _wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name; an unknown name is a
    :class:`LayoutMismatch` (a refusal), never a raw KeyError."""
    dtype = _WIRE_DTYPES.get(str(name))
    if dtype is None:
        raise LayoutMismatch(f"unknown handoff array dtype {name!r}")
    return dtype


def _host_tensor(array) -> torch.Tensor:
    """A contiguous CPU tensor of ``array`` (a tensor or a numpy array)."""
    if isinstance(array, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(array))
    return array.detach().cpu().contiguous()


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """A view of the tensor's bytes in memory order (bf16 as its raw 2-byte
    words); the payload's one copy happens when the parts are joined."""
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def serialize_handoff(header: dict[str, Any], arrays: dict[str, Any]) -> bytes:
    """Pack header and arrays into the versioned wire format. Array order
    is the manifest order (sorted by name, so the bytes are a pure function
    of the content)."""
    manifest = []
    chunks: list[bytes] = []
    for name in sorted(arrays):
        t = _host_tensor(arrays[name])
        if t.dtype not in _WIRE_NAMES:
            raise LayoutMismatch(f"handoff array {name!r}: unsupported dtype {t.dtype}")
        raw = _raw_bytes(t)
        manifest.append({
            "name": name,
            "dtype": _WIRE_NAMES[t.dtype],
            "shape": list(t.shape),
            "nbytes": raw.nbytes,
        })
        chunks.append(raw)
    full = {**header, "arrays": manifest}
    hjson = json.dumps(full, separators=(",", ":")).encode()
    head = (
        WIRE_MAGIC
        + WIRE_VERSION.to_bytes(4, "little")
        + len(hjson).to_bytes(4, "little")
    )
    return b"".join([head, hjson, *chunks])


def peek_header(data: bytes) -> dict[str, Any]:
    """Parse and return the JSON header only; validates magic and version,
    never touches the array bytes."""
    if len(data) < 12 or data[:4] != WIRE_MAGIC:
        raise LayoutMismatch("not a KV handoff payload (bad magic; expected LSKV)")
    version = int.from_bytes(data[4:8], "little")
    if version != WIRE_VERSION:
        raise LayoutMismatch(
            f"unsupported KV handoff wire version {version} "
            f"(this engine speaks {WIRE_VERSION})"
        )
    hlen = int.from_bytes(data[8:12], "little")
    if len(data) < 12 + hlen:
        raise LayoutMismatch("truncated KV handoff payload (header)")
    try:
        header = json.loads(data[12: 12 + hlen])
    except ValueError as e:
        raise LayoutMismatch(f"malformed KV handoff header: {e}") from e
    if not isinstance(header, dict):
        raise LayoutMismatch("malformed KV handoff header: not an object")
    return header


def deserialize_handoff(
    data: bytes, header: dict[str, Any] | None = None
) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
    """Header and named arrays back from the wire. The arrays are CPU
    tensors viewing ``data`` (read-only: every consumer copies them, to
    the device or into a host tier). A caller that already ran
    :func:`peek_header` passes its result back, so the header parses once."""
    if header is None:
        header = peek_header(data)
    hlen = int.from_bytes(data[8:12], "little")
    offset = 12 + hlen
    arrays: dict[str, torch.Tensor] = {}
    for entry in header.get("arrays") or []:
        try:
            name, nbytes = entry["name"], int(entry["nbytes"])
            shape = [int(n) for n in entry["shape"]]
        except (KeyError, TypeError, ValueError) as e:
            raise LayoutMismatch(f"malformed KV handoff manifest entry: {e}") from e
        dtype = _wire_dtype(entry.get("dtype"))
        if len(data) < offset + nbytes:
            raise LayoutMismatch(f"truncated KV handoff payload (array {name!r})")
        itemsize = torch.empty((), dtype=dtype).element_size()
        if int(np.prod(shape, dtype=np.int64)) * itemsize != nbytes:
            raise LayoutMismatch(
                f"KV handoff array {name!r}: {nbytes} bytes do not hold "
                f"shape {shape} of {entry.get('dtype')}"
            )
        if nbytes == 0:
            arrays[name] = torch.empty(shape, dtype=dtype)
        else:
            with warnings.catch_warnings():
                # bytes are immutable; the views are only ever read
                warnings.simplefilter("ignore", UserWarning)
                flat = torch.frombuffer(data, dtype=torch.uint8, count=nbytes,
                                        offset=offset)
            arrays[name] = flat.view(dtype).reshape(shape)
        offset += nbytes
    return header, arrays


# ---------------------------------------------------------------------------
# gather (export side) and the sanctioned fetch point
# ---------------------------------------------------------------------------


def _pool_device(cache) -> torch.device:
    return (cache["q"] if isinstance(cache, dict) else cache).device


def upload(array, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without syncing the stream: on the card a
    pinned staging copy and an asynchronous copy (the caching host
    allocator keeps the staging block until the copy has run); on the CPU
    a copy."""
    t = _host_tensor(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _each_leaf(tree, fn):
    """``fn(leaf)`` over a pool's or a row payload's leaves (a tensor, or an
    int8 ``{"q", "s"}`` pair)."""
    if isinstance(tree, dict):
        return {name: fn(leaf) for name, leaf in tree.items()}
    return fn(tree)


def gather_slot(cache_k, cache_v, table_row, num_blocks: int, mesh=None,
                split: bool = False, replica: int = 0):
    """Queue the gather of one slot's first ``num_blocks`` K and V blocks.
    Returns device tensors ``(L, 1, num_blocks * bs, ...)`` (int8 pools:
    the ``{"q", "s"}`` pair each); :func:`fetch_rows` syncs and slices.

    Under ``mesh`` every rank that takes part gathers the same blocks.
    ``split``: the pools hold this rank's KV heads (its share of the fused
    head axis, the scales' too), so each rank's rows are all-gathered over
    its ``tp`` group in ``tp`` order, whole rows in the JAX package's
    layout. ``replica``: the dp replica whose rows these are, broadcast
    over ``dp`` from it when it is not the first."""
    device = _pool_device(cache_k)
    tables = upload(np.asarray(table_row, dtype=np.int32)[None, :num_blocks], device)
    rows = (gather_kv(cache_k, tables, num_blocks), gather_kv(cache_v, tables, num_blocks))
    if mesh is None:
        return rows

    def whole(x):
        if split:
            x = mesh.all_gather(x, "tp", x.dim() - 1, tag="kv-tier")
        if replica:
            x = mesh.broadcast(x, "dp", replica, tag="kv-tier")
        return x

    return tuple(_each_leaf(t, whole) for t in rows)


def _leaves(tree, prefix: str) -> dict[str, torch.Tensor]:
    """Manifest names of one cache's gathered rows: ``k`` or ``k.q``/``k.s``."""
    if isinstance(tree, dict):
        return {f"{prefix}.{leaf}": tree[leaf] for leaf in sorted(tree)}
    return {prefix: tree}


def _to_host(named: dict[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], float]:
    """Copy device tensors to host, timed. On the card: into pinned buffers
    without blocking, then ONE event wait; the clock starts before the
    pinned allocations, since an allocation may itself wait for the card.
    On the CPU: contiguous clones."""
    t_dev = time.monotonic()
    if next(iter(named.values())).device.type != "cuda":
        return ({name: t.contiguous().clone() for name, t in named.items()},
                time.monotonic() - t_dev)
    out = {}
    for name, t in named.items():
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        out[name] = host
    event = torch.cuda.Event()
    event.record()
    event.synchronize()
    return out, time.monotonic() - t_dev


def _fetch_rows(gathered_k, gathered_v, rows: int):
    """The export path's ONE device fetch, timed (:func:`_to_host`): the
    slot's live ``rows`` positions of every gathered array. Returns
    ``({name: host tensor (L, rows, ...)}, seconds)``."""
    named = {**_leaves(gathered_k, "k"), **_leaves(gathered_v, "v")}
    return _to_host({name: t[:, 0, :rows] for name, t in named.items()})


def fetch_blocks(gathered_k, gathered_v, num_blocks: int):
    """The demotion's ONE device fetch, timed: ``num_blocks`` gathered
    blocks, reordered block-major on the device so that each block's rows
    land contiguous (and, on the card, pinned) on the host. Returns
    ``([{name: (L, block_size, ...)} per block], seconds)``; each block's
    arrays equal a one-block :func:`fetch_rows`."""
    named = {**_leaves(gathered_k, "k"), **_leaves(gathered_v, "v")}

    def block_major(t):  # (L, 1, n * bs, ...) -> (n, L, bs, ...)
        L, rows = t.shape[0], t.shape[2]
        return t[:, 0].reshape((L, num_blocks, rows // num_blocks) + tuple(t.shape[3:])
                               ).transpose(0, 1)

    host, seconds = _to_host({name: block_major(t) for name, t in named.items()})
    return [{name: h[i] for name, h in host.items()} for i in range(num_blocks)], seconds


#: public spelling of the sanctioned fetch stage
fetch_rows = _fetch_rows


# ---------------------------------------------------------------------------
# scatter (import side)
# ---------------------------------------------------------------------------


#: bytes of one pinned staging piece of an upload (fixed sizes let the
#: caching host allocator reuse its pinned blocks)
_PIECE_BYTES = 4 << 20


def _upload_rows(parts, rows: int, padded: int, device: torch.device) -> torch.Tensor:
    """``(L, 1, padded, ...)`` on ``device``: the first ``rows`` positions
    of ``parts`` (one ``(L, n, ...)`` host array, or a list of them in row
    order, as a promotion passes its blocks) and zeros after. On the card
    each part goes up in pieces of at most ``_PIECE_BYTES`` through pinned
    memory without blocking (a part already pinned and contiguous, as a
    demoted block is, goes up as it is)."""
    parts = [_host_tensor(a) for a in (parts if isinstance(parts, (list, tuple)) else [parts])]
    first = parts[0]
    tail = tuple(first.shape[2:])
    out = torch.zeros((first.shape[0], 1, padded) + tail, dtype=first.dtype, device=device)
    at = 0
    for part in parts:
        n = min(part.shape[1], rows - at)
        if n <= 0:
            break
        if device.type != "cuda":
            out[:, 0, at:at + n] = part[:, :n]
        elif n == part.shape[1] and part.is_pinned() and part.is_contiguous():
            out[:, 0, at:at + n].copy_(part, non_blocking=True)
        else:
            step = max(1, _PIECE_BYTES // max(1, part[:, :1].nbytes))
            for off in range(0, n, step):
                src = part[:, off:min(off + step, n)]
                staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                staged.copy_(src)
                out[:, 0, at + off:at + off + src.shape[1]].copy_(staged, non_blocking=True)
        at += n
    return out


def _rows_tree(arrays: dict[str, Any], prefix: str, rows: int, padded: int,
               device: torch.device):
    """One cache's row payload from the manifest arrays, padded to
    ``padded`` positions (pad rows are masked to the scratch block by
    ``valid``) and uploaded. int8 pools travel as the quantized ``{"q",
    "s"}`` pair and scatter verbatim, bit-exact in transit."""
    if prefix in arrays:
        return _upload_rows(arrays[prefix], rows, padded, device)
    quant = {
        leaf: _upload_rows(arrays[f"{prefix}.{leaf}"], rows, padded, device)
        for leaf in ("q", "s")
        if f"{prefix}.{leaf}" in arrays
    }
    if set(quant) != {"q", "s"}:
        raise LayoutMismatch(
            f"handoff payload missing {prefix!r} rows (have {sorted(arrays)})"
        )
    return quant


def _whole_rows(arrays: dict[str, Any] | None, prefix: str, cache, rows: int,
                padded: int, mesh, heads: tuple[int, int] | None):
    """One cache's padded rows on this rank's device, of this rank's heads.
    Without ``mesh``: :func:`_rows_tree` of ``arrays``. Under ``mesh``, rank
    0 alone passes ``arrays``: it uploads them whole, in the pool's dtypes,
    and broadcasts them to every rank (the others receive into buffers of
    the whole rows' shape); ``heads = (index, count)`` then keeps this
    rank's share of the fused head axis (None: every rank holds every
    head)."""
    device = _pool_device(cache)
    if arrays is not None:
        tree = _rows_tree(arrays, prefix, rows, padded, device)
        if mesh is None:
            return tree
        tree = (tree.to(cache.dtype) if not isinstance(tree, dict)
                else {leaf: tree[leaf].to(cache[leaf].dtype) for leaf in tree})
    else:
        count = 1 if heads is None else heads[1]
        tree = _each_leaf(cache, lambda pool: torch.empty(
            (pool.shape[0], 1, padded, pool.shape[3] * count), dtype=pool.dtype,
            device=device))
    tree = _each_leaf(tree, lambda x: mesh.broadcast(x, tag="kv-tier"))
    if heads is None:
        return tree
    index, count = heads

    def mine(x):
        width = x.shape[-1] // count
        return x.narrow(-1, index * width, width)

    return _each_leaf(tree, mine)


def scatter_slot(cache_k, cache_v, arrays: dict[str, Any] | None, table_row,
                 rows: int, padded_rows: int, mesh=None,
                 heads: tuple[int, int] | None = None):
    """Write an imported slot's rows into the pools (in place) through the
    slot's freshly allocated block-table row. ``arrays`` maps each manifest
    name to an ``(L, rows, ...)`` host array or to a list of them in row
    order. Queued on the stream, no sync (but for a mesh's broadcast);
    returns the (same) pools. Under ``mesh`` every rank calls it, rank 0
    with the whole rows and the others with ``arrays=None``
    (:func:`_whole_rows`)."""
    device = _pool_device(cache_k)
    k_rows = _whole_rows(arrays, "k", cache_k, rows, padded_rows, mesh, heads)
    v_rows = _whole_rows(arrays, "v", cache_v, rows, padded_rows, mesh, heads)
    tables = upload(np.asarray(table_row, dtype=np.int32)[None, :], device)
    starts = upload(np.zeros((1,), dtype=np.int32), device)
    valid = upload((np.arange(padded_rows) < rows)[None, :], device)
    return (
        write_rows(cache_k, k_rows, tables, starts, valid),
        write_rows(cache_v, v_rows, tables, starts, valid),
    )
