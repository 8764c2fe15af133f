"""Paged KV cache: block-table indirection over a shared page pool (the
port's counterpart of ``pilottai_tpu/ops/paged.py``).

Each layer owns one page pool ``[K, num_pages, P, H]`` (K-major, so a
page is one contiguous ``[P, H]`` panel per kv head) and slots map
positions to pages through a block table: a slot holding 300 tokens pins
3 pages of 128, not a whole ``max_seq`` row. The last page
(``num_pages - 1``) is the scratch page: dropped writes land there and
unallocated table entries (the sentinel) point at it. It is never handed
out, and it only ever receives finite values.

* **Allocation is host-side** (``PageAllocator``): numpy, refcounted, on
  the device thread. Pages cover prompt + generation budget up front, so
  no mid-decode growth path exists; completion frees them all.
* **The device ops** mirror the dense cache's: batched prompt scatter,
  ring scatter at chunk end, and ``gather_pages``, which only the plain
  version of kernel K3 and the tests use; the decode path reads the
  pools through K3 (``ops/kernels/paged_attention.py``).

With ``quantized=True`` the pools are int8 and ``scales`` holds a
``(k_scale, v_scale)`` pair of ``[K, num_pages, P]`` fp32 pools per layer
(``ops/kvcache.py:quantize_kv``, per token and kv head): the scatters
quantize before they write, kernel K3 reads the int8 pages with their
scales, and the scratch page's scales stay finite.

The pools are made with ``torch.zeros``, never ``torch.empty``: a masked
key still sits beside live ones in a staged page, and ``0 · NaN`` is NaN.
As in ``ops/kvcache.py`` the functions write in place and return the
cache for symmetry with the JAX signatures. Where JAX drops an
out-of-range scatter, these route the row to the scratch page; positions
are clamped with ``min(pos, max_pos)`` before the table lookup, since
torch raises on an out-of-range gather where JAX clamps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilottai_tpu_torch.device import DeviceLike, resolve_device, upload
from pilottai_tpu_torch.ops.kvcache import quantize_kv


@dataclass
class PagedKVCache:
    layers: List[Tuple[torch.Tensor, torch.Tensor]]  # per layer (k, v) [K, num_pages, P, H]
    lengths: torch.Tensor                            # [B] int32 — valid tokens per slot
    # Per layer (k_scale, v_scale) [K, num_pages, P] fp32 when the pools are
    # int8; None for pools in the compute dtype.
    scales: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None

    @property
    def num_pages(self) -> int:
        return self.layers[0][0].shape[1]

    @property
    def page_size(self) -> int:
        return self.layers[0][0].shape[2]

    @property
    def n_slots(self) -> int:
        return self.lengths.shape[0]

    @classmethod
    def create(
        cls, n_layers: int, n_slots: int, num_pages: int, page_size: int,
        n_kv_heads: int, head_dim: int, dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None, quantized: bool = False,
    ) -> "PagedKVCache":
        device = resolve_device(device)
        shape = (n_kv_heads, num_pages, page_size, head_dim)
        store = torch.int8 if quantized else dtype
        layers = [
            (torch.zeros(shape, dtype=store, device=device),
             torch.zeros(shape, dtype=store, device=device))
            for _ in range(n_layers)
        ]
        scales = [
            (torch.zeros(shape[:-1], dtype=torch.float32, device=device),
             torch.zeros(shape[:-1], dtype=torch.float32, device=device))
            for _ in range(n_layers)
        ] if quantized else None
        return cls(layers=layers, lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
                   scales=scales)


class PageAllocator:
    """Host-side free list and block table, refcounted: a slot holds one
    ref on every page of its table, and shared ``prefix_pages`` (mapped
    into several slots' tables) return to the free list only when their
    last ref drops; the prefix index (``engine/page_prefix.py``) pins the
    pages it caches with a ref of its own. Same table and free-list order
    as the JAX allocator, so a scripted sequence gives identical tables on
    both sides."""

    def __init__(self, num_pages: int, page_size: int, n_slots: int,
                 max_pages_per_slot: int) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        self.sentinel = num_pages - 1          # the scratch page; never allocated
        self.free: List[int] = list(range(num_pages - 1))
        self.refs = np.zeros((num_pages,), np.int32)
        self.table = np.full((n_slots, max_pages_per_slot), self.sentinel, np.int32)
        self._held: List[List[int]] = [[] for _ in range(n_slots)]

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def can_allocate(self, n_tokens: int, n_prefix_pages: int = 0) -> bool:
        total = self.pages_needed(n_tokens)
        return max(total - n_prefix_pages, 0) <= len(self.free) and total <= self.table.shape[1]

    def allocate(self, slot: int, n_tokens: int, prefix_pages: Sequence[int] = ()) -> bool:
        """Reserve pages covering ``n_tokens`` for a fresh slot, with the
        shared ``prefix_pages`` at the head of its table. False (and no
        change) when the pool cannot cover it."""
        if not self.can_allocate(n_tokens, len(prefix_pages)):
            return False
        if self._held[slot]:
            raise RuntimeError(f"slot {slot} still holds pages")
        n_new = max(self.pages_needed(n_tokens) - len(prefix_pages), 0)
        held = list(prefix_pages) + [self.free.pop() for _ in range(n_new)]
        for p in held:
            self.refs[p] += 1
        self._held[slot] = held
        self.table[slot, :] = self.sentinel
        self.table[slot, : len(held)] = held
        return True

    def release(self, slot: int) -> None:
        """Drop the slot's refs (a no-op for a slot that holds nothing)."""
        for p in self._held[slot]:
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self.free.append(p)
        self._held[slot] = []
        self.table[slot, :] = self.sentinel

    def pin(self, page: int) -> None:
        """Add a ref that no slot holds (the prefix index's pin). The page
        must be live: pinning a free page is a logic error."""
        if self.refs[page] <= 0:
            raise RuntimeError(f"pin of unreferenced page {page}")
        self.refs[page] += 1

    def unpin(self, page: int) -> None:
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self.free.append(page)

    @property
    def free_pages(self) -> int:
        return len(self.free)


def _scatter_targets(
    table: torch.Tensor,   # [R, max_pages] int32
    pos: torch.Tensor,     # [R, T] absolute positions (long)
    live: torch.Tensor,    # [R, T] bool
    page_size: int,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat ``(page, offset)`` per row and position: dead positions go to
    the scratch page, live ones through the table (they are unique: a
    table row holds distinct pages and rows hold disjoint ones)."""
    max_pos = table.shape[1] * page_size - 1
    blk = torch.clamp(pos, max=max_pos) // page_size
    pages = torch.gather(table.long(), 1, blk)
    pages = torch.where(live, pages, torch.full_like(pages, sentinel))
    return pages.reshape(-1), (pos % page_size).reshape(-1)


def write_prompts_paged(
    cache: PagedKVCache,
    table: torch.Tensor,    # [A, max_pages] int32 — the admitted slots' page rows
    ks: torch.Tensor,       # [L, A, T, K, H] prefill K for every layer
    vs: torch.Tensor,       # [L, A, T, K, H]
    lengths: Sequence[int],  # [A] true lengths; <= 0 marks a padding row
    pos_offset: int = 0,    # absolute position of row 0 (page-aligned)
) -> PagedKVCache:
    """Scatter freshly prefilled prompts (or one prompt segment at
    ``pos_offset``) into their slots' pages. Positions past a row's
    length land on the scratch page."""
    L, A, T, K, H = ks.shape
    dev = ks.device
    idx = torch.arange(T, device=dev)
    lens = upload([int(n) for n in lengths], torch.long, dev)
    live = idx[None, :] < lens[:, None]                          # [A, T]
    pos = (idx + int(pos_offset))[None, :].expand(A, T)
    pages, offs = _scatter_targets(
        table.to(dev), pos, live, cache.page_size, cache.num_pages - 1
    )
    for layer in range(L):
        _scatter(cache, layer, pages, offs, ks[layer].permute(2, 0, 1, 3).reshape(K, A * T, H),
                 vs[layer].permute(2, 0, 1, 3).reshape(K, A * T, H))
    return cache


def _scatter(cache: PagedKVCache, layer: int, pages: torch.Tensor, offs: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Write ``k_new``, ``v_new [K, R, H]`` at the flat ``(pages, offs)``
    of layer ``layer``, quantized first when the pools are int8."""
    kp, vp = cache.layers[layer]
    if cache.scales is not None:
        k_new, k_sc = quantize_kv(k_new)                             # [K, R]
        v_new, v_sc = quantize_kv(v_new)
        ks_p, vs_p = cache.scales[layer]
        ks_p[:, pages, offs] = k_sc
        vs_p[:, pages, offs] = v_sc
    kp[:, pages, offs] = k_new.to(kp.dtype)
    vp[:, pages, offs] = v_new.to(vp.dtype)


def install_lengths(
    cache: PagedKVCache, slots: Sequence[int], lengths: Sequence[int]
) -> PagedKVCache:
    """``lengths[slot] = max(length, 0)``; out-of-range slots are dropped.
    Rows are written in reverse, so the first of two rows naming one slot
    wins, as in the dense ``write_prompts``."""
    for s, n in reversed(list(zip(slots, lengths))):
        if 0 <= int(s) < cache.n_slots:
            cache.lengths[int(s)] = max(int(n), 0)
    return cache


def write_chunk_rows_paged(
    cache: PagedKVCache,
    table: torch.Tensor,               # [B, max_pages] — the chunk's block table
    ring_ks: Sequence[torch.Tensor],   # per layer [B, K, n, H]
    ring_vs: Sequence[torch.Tensor],
    start: torch.Tensor,               # [B] int32 slot length at chunk start
    accepted: torch.Tensor,            # [B] int32 rows actually generated
) -> PagedKVCache:
    """Chunk-end scatter of the decode ring into pages: row j of slot b
    lands at ``start[b] + j`` when ``j < accepted[b]``, the other rows on
    the scratch page (no host sync, unlike a filter of the live rows)."""
    B, K, n, H = ring_ks[0].shape
    j = torch.arange(n, device=start.device)[None, :]
    pos = start.long()[:, None] + j                              # [B, n]
    pages, offs = _scatter_targets(
        table, pos, j < accepted[:, None], cache.page_size, cache.num_pages - 1
    )
    for layer, (rk, rv) in enumerate(zip(ring_ks, ring_vs)):
        _scatter(cache, layer, pages, offs, rk.permute(1, 0, 2, 3).reshape(K, B * n, H),
                 rv.permute(1, 0, 2, 3).reshape(K, B * n, H))
    capacity = table.shape[1] * cache.page_size
    cache.lengths.copy_(torch.clamp(cache.lengths + torch.clamp(accepted, max=n), max=capacity))
    return cache


def gather_pages(
    pool: torch.Tensor,    # [K, num_pages, P, H] (or [K, num_pages, P] scale pools)
    table: torch.Tensor,   # [B, max_pages]
    n_blocks: Optional[int] = None,
) -> torch.Tensor:
    """The first ``n_blocks`` pages of each slot as dense ``[B, K,
    n_blocks·P, H]`` panels (``[B, K, n_blocks·P]`` for scale pools).
    Sentinel entries gather the scratch page, masked at attention time."""
    K, _, P = pool.shape[:3]
    B = table.shape[0]
    n_blocks = table.shape[1] if n_blocks is None else n_blocks
    g = pool[:, table[:, :n_blocks].long()]                      # [K, B, nb, P(, H)]
    g = g.transpose(0, 1)
    return g.reshape((B, K, n_blocks * P) + tuple(pool.shape[3:]))
