"""Paged KV cache (port of ``langstream_tpu/models/paged.py``).

The pool is ``(L, num_blocks, block_size, Kh*D)`` per K and V, plus
``(L, num_blocks, block_size, Kh)`` f32 scales for an int8 pool (a
``{"q", "s"}`` dict) — the JAX package's layout byte for byte, so pools
can move between the two packages. A slot's rows live in the blocks its
block-table row names; block 0 is scratch and never allocated.

Unlike the JAX package's pure functions, :func:`write_rows` updates the
pool in place (PyTorch has no donation; an in-place scatter saves a pool
copy) and returns it. The prefix-cache chain methods of ``BlockManager``
come with the prefix-cache slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def init_paged_kv_cache(config, layout: PagedLayout, device="cpu"):
    """Pool tensors ``(L, num_blocks, block_size, Kh*D)`` for K and V."""
    c = config
    shape = (c.layers, layout.num_blocks, layout.block_size,
             c.kv_heads * c.head_dim)
    return (
        torch.zeros(shape, dtype=c.dtype, device=device),
        torch.zeros(shape, dtype=c.dtype, device=device),
    )


def init_paged_kv_cache_int8(config, layout: PagedLayout, device="cpu"):
    """int8 pools: data as :func:`init_paged_kv_cache` plus one f32 scale
    per (block row, kv head)."""
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
    for masked writes and is never allocated."""

    def __init__(self, layout: PagedLayout, slots: int):
        self.layout = layout
        self._free = list(range(layout.num_blocks - 1, 0, -1))  # block 0 reserved
        self._reserved = 0
        self._slot_blocks: list[list[int]] = [[] for _ in range(slots)]
        self._slot_reservation = [0] * slots
        self.tables = np.zeros(
            (slots, layout.max_blocks_per_slot), dtype=np.int32
        )

    def _alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                "paged KV pool exhausted despite reservation accounting"
            )
        return self._free.pop()

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

    def admit(self, slot: int, total_tokens: int) -> None:
        need = self.blocks_needed(total_tokens)
        if not self.can_admit(total_tokens):
            raise RuntimeError("paged KV pool exhausted (admission bug)")
        self._slot_reservation[slot] = need
        self._reserved += need

    # -- growth --------------------------------------------------------

    def ensure_capacity(self, slot: int, tokens: int) -> int:
        """Allocate physical blocks so ``tokens`` positions fit, capped at
        the slot's reservation (rows past it are redirected to scratch by
        the unallocated table columns). Returns the blocks allocated."""
        need = self.blocks_needed(tokens)
        if self._slot_reservation[slot]:
            need = min(need, self._slot_reservation[slot])
        grown = 0
        while len(self._slot_blocks[slot]) < need:
            b = self._alloc()
            self.tables[slot, len(self._slot_blocks[slot])] = b
            self._slot_blocks[slot].append(b)
            grown += 1
        return grown

    def release(self, slot: int) -> None:
        self._free.extend(self._slot_blocks[slot])
        self._reserved -= self._slot_reservation[slot]
        self._slot_reservation[slot] = 0
        self._slot_blocks[slot] = []
        self.tables[slot, :] = 0

    # -- stats ---------------------------------------------------------

    def stats(self) -> dict:
        return {
            "num_blocks": self.layout.num_blocks,
            "free_blocks": len(self._free),
            "reserved_blocks": self._reserved,
            "live_blocks": sum(len(b) for b in self._slot_blocks),
        }
