"""Paged KV cache (port of ``langstream_tpu/models/paged.py``).

The pool is ``(L, num_blocks, block_size, Kh*D)`` per K and V, plus
``(L, num_blocks, block_size, Kh)`` f32 scales for an int8 pool (a
``{"q", "s"}`` dict) — the JAX package's layout byte for byte, so pools
can move between the two packages. A slot's rows live in the blocks its
block-table row names; block 0 is scratch and never allocated.

Unlike the JAX package's pure functions, :func:`write_rows` updates the
pool in place (PyTorch has no donation; an in-place scatter saves a pool
copy) and returns it. ``BlockManager`` carries the prefix cache (chained
block digests, refcounted sharing, leaf-first LRU eviction).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from langstream_tpu_torch._device import require_device
from langstream_tpu_torch.models.kvquant import quantize_rows


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of the paged pool."""

    block_size: int
    num_blocks: int
    max_blocks_per_slot: int

    @classmethod
    def for_model(
        cls,
        max_seq_len: int,
        slots: int,
        block_size: int = 64,
        hbm_fraction_of_dense: float = 0.5,
        num_blocks: int | None = None,
    ) -> "PagedLayout":
        """Size the pool to ``hbm_fraction_of_dense`` of what the dense
        cache would reserve."""
        max_blocks_per_slot = -(-max_seq_len // block_size)
        if num_blocks is None:
            dense_rows = slots * max_seq_len
            num_blocks = max(
                slots + 1, int(dense_rows * hbm_fraction_of_dense) // block_size
            )
        return cls(
            block_size=block_size,
            num_blocks=num_blocks,
            max_blocks_per_slot=max_blocks_per_slot,
        )


def init_paged_kv_cache(config, layout: PagedLayout, device="cuda"):
    """Pool tensors ``(L, num_blocks, block_size, Kh*D)`` for K and V, on
    the card unless the caller asks for the CPU."""
    device = require_device(device, "init_paged_kv_cache")
    c = config
    shape = (c.layers, layout.num_blocks, layout.block_size,
             c.kv_heads * c.head_dim)
    return (
        torch.zeros(shape, dtype=c.dtype, device=device),
        torch.zeros(shape, dtype=c.dtype, device=device),
    )


def init_paged_kv_cache_int8(config, layout: PagedLayout, device="cuda"):
    """int8 pools: data as :func:`init_paged_kv_cache` plus one f32 scale
    per (block row, kv head), on the card unless the caller asks for the
    CPU."""
    device = require_device(device, "init_paged_kv_cache_int8")
    c = config
    base = (c.layers, layout.num_blocks, layout.block_size)

    def make():
        return {
            "q": torch.zeros(base + (c.kv_heads * c.head_dim,),
                             dtype=torch.int8, device=device),
            "s": torch.zeros(base + (c.kv_heads,), dtype=torch.float32,
                             device=device),
        }

    return make(), make()


def pool_layer(pool, layer: int):
    """One layer's ``(nb, bs, ...)`` view of a pool (either layout)."""
    if isinstance(pool, dict):
        return {"q": pool["q"][layer], "s": pool["s"][layer]}
    return pool[layer]


# ---------------------------------------------------------------------------
# read / write
# ---------------------------------------------------------------------------


def write_rows(
    cache,                      # (L, nb, bs, KhD) tensor, or int8 {"q","s"} pools
    rows,                       # (L, B, T, KhD), or pre-quantized {"q","s"}
    block_tables: torch.Tensor,  # (B, max_blocks) int
    starts: torch.Tensor,       # (B,) first sequence position of rows[:, b]
    valid: torch.Tensor,        # (B, T) bool
):
    """Scatter ``rows`` into the pool at each slot's block-mapped positions,
    in place. Invalid rows go to scratch block 0, so the scatter keeps a
    fixed shape; an int8 pool quantizes the rows here; rows that are
    already quantized (an int8 ``{"q","s"}`` pair) pass through bit for
    bit. Returns the (same) pool."""
    quant = isinstance(cache, dict)
    nb, bs, _ = (cache["q"] if quant else cache).shape[1:]
    rows_data = rows["q"] if isinstance(rows, dict) else rows
    B, T = rows_data.shape[1], rows_data.shape[2]
    device = rows_data.device
    pos = starts.to(torch.long)[:, None] + torch.arange(T, device=device)[None, :]
    block_idx = torch.clamp(pos // bs, 0, block_tables.shape[1] - 1)
    offset = pos % bs
    blocks = torch.gather(block_tables.to(torch.long), 1, block_idx)
    flat = blocks * bs + offset
    flat = torch.where(valid, flat, torch.zeros_like(flat)).reshape(-1)

    def scatter(pool, new_rows):
        L = new_rows.shape[0]
        tail = tuple(pool.shape[3:])
        flat_pool = pool.view((L, nb * bs) + tail)
        flat_pool[:, flat] = new_rows.reshape((L, B * T) + tail).to(pool.dtype)
        return pool

    if not quant:
        return scatter(cache, rows)
    if isinstance(rows, dict):
        scatter(cache["q"], rows["q"])
        scatter(cache["s"], rows["s"])
        return cache
    L = rows.shape[0]
    Kh = cache["s"].shape[3]
    KhD = rows.shape[3]
    qr = quantize_rows(rows.reshape(L, B, T, Kh, KhD // Kh))
    scatter(cache["q"], qr["q"].reshape(L, B, T, KhD))
    scatter(cache["s"], qr["s"])
    return cache


def gather_kv(cache, block_tables: torch.Tensor, num_read_blocks: int):
    """Reference read: densify the first ``num_read_blocks`` blocks of every
    slot → ``(L, B, num_read_blocks*bs, ...)`` (int8 pools gather data and
    scales alike)."""
    tables = block_tables[:, :num_read_blocks].to(torch.long)
    B = tables.shape[0]

    def gather(pool):
        bs = pool.shape[2]
        tail = tuple(pool.shape[3:])
        return pool[:, tables].reshape(
            (pool.shape[0], B, num_read_blocks * bs) + tail
        )

    if isinstance(cache, dict):
        return {name: gather(leaf) for name, leaf in cache.items()}
    return gather(cache)


# ---------------------------------------------------------------------------
# host-side block management
# ---------------------------------------------------------------------------


class BlockManager:
    """Free list + worst-case reservation accounting: admission passes only
    when the request's worst case fits, while physical blocks are handed
    out lazily as generation grows. Block 0 is the scatter scratch target
    for masked writes and is never allocated.

    **Automatic prefix caching**: full blocks of committed prompts are
    content-addressed by a chained digest of their tokens (byte-identical
    to the JAX package's digests). A new request whose prompt starts with a
    cached chain adopts those blocks read-only (refcounted: decode never
    writes below its start position, so sharing is safe) and prefills only
    the suffix. Cache-only blocks (refcount held just by the cache) are
    evicted LRU, leaf first, when the free list runs dry, so caching never
    reduces admissible capacity. The tiered-store hooks and the pool-shrink
    budget of the JAX package's manager are not here (ROADMAP.md Queue 1
    item 9).
    """

    def __init__(self, layout: PagedLayout, slots: int):
        self.layout = layout
        self._free = list(range(layout.num_blocks - 1, 0, -1))  # block 0 reserved
        self._reserved = 0
        # per slot: shared (adopted, refcounted) prefix blocks + owned tail
        self._slot_shared: list[list[int]] = [[] for _ in range(slots)]
        self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
        self._slot_reservation = [0] * slots
        self.tables = np.zeros(
            (slots, layout.max_blocks_per_slot), dtype=np.int32
        )
        # prefix cache: chain digest -> block (insertion order = LRU), block
        # refcounts (slot adoptions + cache membership), the reverse map,
        # and the chain topology (parent digest + child count) so eviction
        # is leaf-first: evicting a chain head would orphan its cached
        # descendants (match_prefix walks from the head and stops at the
        # first miss), pinning blocks that can never match again
        self._prefix: dict[bytes, int] = {}
        self._refs: dict[int, int] = {}
        self._block_digest: dict[int, bytes] = {}
        self._parent: dict[bytes, bytes] = {}
        self._nchildren: dict[bytes, int] = {}

    # -- prefix cache --------------------------------------------------

    def _digests(self, prompt_tokens):
        """Chained blake2b-128 digests over the int64 token bytes, one per
        FULL block of the prompt. Lazy: callers that stop early pay only
        for the digests they walk."""
        bs = self.layout.block_size
        prev = b""
        for i in range(len(prompt_tokens) // bs):
            block = prompt_tokens[i * bs : (i + 1) * bs]
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(np.asarray(block, dtype=np.int64).tobytes())
            prev = h.digest()
            yield prev

    def chain_digests(self, prompt_tokens, limit: int | None = None):
        """The prompt's chained full-block digests as a list, bounded by
        ``limit`` (default ``(len(prompt)-1)//block_size``, the bound of
        :meth:`match_prefix`: at least one token must prefill)."""
        if limit is None:
            limit = (len(prompt_tokens) - 1) // self.layout.block_size
        out: list[bytes] = []
        for i, d in enumerate(self._digests(prompt_tokens)):
            if i >= limit:
                break
            out.append(d)
        return out

    def prefix_has(self, digest: bytes) -> bool:
        """Whether the cache holds a block for this chain digest."""
        return digest in self._prefix

    def match_prefix(self, prompt_tokens, digests=None) -> tuple[list[int], int]:
        """Longest cached chain covering at most ``len(prompt)-1`` tokens.
        Returns ``(blocks, reused_token_count)`` WITHOUT claiming them —
        call :meth:`adopt_prefix` after admission. ``digests`` lets a caller
        that already walked :meth:`chain_digests` skip re-hashing."""
        bs = self.layout.block_size
        limit = (len(prompt_tokens) - 1) // bs
        blocks: list[int] = []
        walk = digests if digests is not None else self._digests(prompt_tokens)
        for i, d in enumerate(walk):
            if i >= limit:
                break
            b = self._prefix.get(d)
            if b is None:
                break
            blocks.append(b)
        return blocks, len(blocks) * bs

    def adopt_prefix(self, slot: int, blocks: list[int]) -> None:
        """Install shared prefix blocks at the head of a slot's table (one
        reference each, and an LRU touch of their digests)."""
        if self._slot_shared[slot] or self._slot_blocks[slot]:
            raise RuntimeError(f"adopt_prefix: slot {slot} already holds blocks")
        for i, b in enumerate(blocks):
            self._refs[b] = self._refs.get(b, 0) + 1
            self.tables[slot, i] = b
            d = self._block_digest.get(b)
            if d is not None and d in self._prefix:
                self._prefix[d] = self._prefix.pop(d)
        self._slot_shared[slot] = list(blocks)

    def register_prefix(self, slot: int, prompt_tokens) -> None:
        """After a committed prefill: publish the slot's full prompt blocks
        into the cache. The first writer of a digest wins; the walk stops
        at a block already published under another digest (deeper links
        would dangle)."""
        table = self._slot_shared[slot] + self._slot_blocks[slot]
        prev = b""
        for i, d in enumerate(self._digests(prompt_tokens)):
            if i >= len(table):
                break
            if d in self._prefix:
                self._prefix[d] = self._prefix.pop(d)  # LRU touch
                prev = d
                continue
            b = table[i]
            if b in self._block_digest:
                break
            self._prefix[d] = b
            self._block_digest[b] = d
            self._refs[b] = self._refs.get(b, 0) + 1
            self._parent[d] = prev
            self._nchildren.setdefault(d, 0)
            if prev:
                self._nchildren[prev] = self._nchildren.get(prev, 0) + 1
            prev = d

    def _evict_one(self) -> bool:
        """Drop the least-recently-used cache-only LEAF block (no cached
        children) to the free list: heads stay until their chains drain."""
        for d, b in list(self._prefix.items()):  # insertion order = LRU
            if self._refs.get(b, 0) != 1:  # a slot still reads it
                continue
            if self._nchildren.get(d, 0) > 0:  # interior: would orphan tail
                continue
            del self._prefix[d]
            del self._block_digest[b]
            parent = self._parent.pop(d, b"")
            self._nchildren.pop(d, None)
            if parent and parent in self._nchildren:
                self._nchildren[parent] -= 1
            self._unref(b)
            return True
        return False

    def prefix_block_count(self) -> int:
        """Blocks currently pinned by the prefix cache."""
        return len(self._prefix)

    # -- refcounted block lifecycle (every live block holds >= 1 ref: its
    # owning/adopting slots and, once published, the cache) --------------

    def _alloc(self) -> int:
        if not self._free and not self._evict_one():
            raise RuntimeError(
                "paged KV pool exhausted despite reservation accounting"
            )
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def _unref(self, b: int) -> None:
        n = self._refs.get(b, 0) - 1
        if n <= 0:
            self._refs.pop(b, None)
            self._free.append(b)
        else:
            self._refs[b] = n

    # -- admission -----------------------------------------------------

    def blocks_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.layout.block_size)

    def fits_ever(self, total_tokens: int) -> bool:
        """Whether a request of this worst-case size could EVER be admitted
        (even into an empty pool)."""
        return self.blocks_needed(total_tokens) <= min(
            self.layout.num_blocks - 1, self.layout.max_blocks_per_slot
        )

    def can_admit(self, total_tokens: int) -> bool:
        need = self.blocks_needed(total_tokens)
        return (
            self._reserved + need <= self.usable_blocks
            and need <= self.layout.max_blocks_per_slot
        )

    @property
    def usable_blocks(self) -> int:
        """The admission budget (block 0 is scratch)."""
        return self.layout.num_blocks - 1

    @property
    def reserved_blocks(self) -> int:
        return self._reserved

    def used_ratio(self) -> float:
        """Admission pressure: the reserved share of the usable pool (the
        flight recorder's ``kv_used``; admission gates on reservations,
        not on allocated blocks)."""
        usable = self.usable_blocks
        return self._reserved / usable if usable > 0 else 1.0

    def admit(self, slot: int, total_tokens: int) -> None:
        need = self.blocks_needed(total_tokens)
        if not self.can_admit(total_tokens):
            raise RuntimeError("paged KV pool exhausted (admission bug)")
        self._slot_reservation[slot] = need
        self._reserved += need

    # -- growth --------------------------------------------------------

    def ensure_capacity(self, slot: int, tokens: int) -> int:
        """Allocate physical blocks after the slot's shared prefix so
        ``tokens`` positions fit, capped at the slot's reservation (rows
        past it are redirected to scratch by the unallocated table
        columns). Returns the blocks allocated."""
        need = self.blocks_needed(tokens)
        if self._slot_reservation[slot]:
            need = min(need, self._slot_reservation[slot])
        shared, owned = self._slot_shared[slot], self._slot_blocks[slot]
        grown = 0
        while len(shared) + len(owned) < need:
            b = self._alloc()
            self.tables[slot, len(shared) + len(owned)] = b
            owned.append(b)
            grown += 1
        return grown

    def release(self, slot: int) -> None:
        """Drop the slot's references: owned blocks return to the free list
        unless the cache published them, shared blocks stay while the cache
        or another slot holds them."""
        for b in self._slot_shared[slot] + self._slot_blocks[slot]:
            self._unref(b)
        self._reserved -= self._slot_reservation[slot]
        self._slot_reservation[slot] = 0
        self._slot_shared[slot] = []
        self._slot_blocks[slot] = []
        self.tables[slot, :] = 0

    # -- stats ---------------------------------------------------------

    def stats(self) -> dict:
        return {
            "num_blocks": self.layout.num_blocks,
            "free_blocks": len(self._free),
            "reserved_blocks": self._reserved,
            # distinct physical blocks: a prefix block adopted by several
            # slots counts once
            "live_blocks": len({
                b
                for shared, owned in zip(self._slot_shared, self._slot_blocks)
                for b in (*shared, *owned)
            }),
            "cached_prefix_blocks": len(self._prefix),
        }
