"""Slot-based dense KV cache for continuous batching (the port's
counterpart of ``pilottai_tpu/ops/kvcache.py``; int8 panels wait for the
quantization slice).

One ``(k, v)`` pair per layer, each ``[B, K, S, H]``: B serving slots, K
kv heads, S max context, H head dim. K-major panels make each (slot, kv
head) one contiguous ``[S, H]`` span, which the decode kernel reads as
contiguous tiles. ``lengths[b]`` counts valid entries; bytes past it are
masked at attention time, so freeing a slot is one scalar write.

JAX's arrays are immutable and its cache is donated through each
dispatch; here the functions write the tensors in place (saving the
copy) and return the cache for symmetry with the JAX signatures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from pilottai_tpu_torch.device import DeviceLike, resolve_device


@dataclass
class KVCache:
    layers: List[Tuple[torch.Tensor, torch.Tensor]]  # per-layer (k, v) [B, K, S, H]
    lengths: torch.Tensor                            # [B] int32 — valid entries

    @property
    def n_slots(self) -> int:
        return self.layers[0][0].shape[0]

    @property
    def max_len(self) -> int:
        return self.layers[0][0].shape[2]

    @classmethod
    def create(
        cls, n_layers: int, n_slots: int, max_len: int, n_kv_heads: int,
        head_dim: int, dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
    ) -> "KVCache":
        device = resolve_device(device)
        shape = (n_slots, n_kv_heads, max_len, head_dim)
        layers = [
            (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(n_layers)
        ]
        return cls(layers=layers, lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device))


def write_prompts(
    cache: KVCache,
    slots: Sequence[int],    # [A] target slot per admitted prompt (host ints)
    ks: torch.Tensor,        # [L, A, T, K, H] prefill K for every layer
    vs: torch.Tensor,        # [L, A, T, K, H]
    lengths: Sequence[int],  # [A] true prompt lengths; <= 0 marks a padding row
) -> KVCache:
    """Insert a batch of freshly prefilled prompts. T may be padded (the
    rows past ``lengths[a]`` are masked at attention time). As in the JAX
    function, padding rows are routed to the first row's slot and written
    in reverse order, so the live row 0 writes last and wins."""
    A, T = ks.shape[1], ks.shape[2]
    if T > cache.max_len:
        raise ValueError(f"prompt bucket {T} exceeds the cache length {cache.max_len}")
    safe = [int(s) if int(n) > 0 else int(slots[0]) for s, n in zip(slots, lengths)]
    for layer, (k, v) in enumerate(cache.layers):
        k_new = ks[layer].transpose(1, 2).to(k.dtype)   # [A, K, T, H]
        v_new = vs[layer].transpose(1, 2).to(v.dtype)
        for a in reversed(range(A)):
            k[safe[a], :, :T] = k_new[a]
            v[safe[a], :, :T] = v_new[a]
    for a in reversed(range(A)):
        cache.lengths[safe[a]] = max(int(lengths[a]), 0)
    return cache


def write_chunk_rows(
    cache: KVCache,
    ring_ks: Sequence[torch.Tensor],  # per layer [B, K, n, H] chunk ring
    ring_vs: Sequence[torch.Tensor],
    start: torch.Tensor,              # [B] int32 slot length at chunk start
    accepted: torch.Tensor,           # [B] int32 rows actually generated
) -> KVCache:
    """Scatter one decode chunk's ring rows into the cache: row j of slot
    b lands at start[b] + j when j < accepted[b] and that is inside the
    panel; the other rows are dropped (JAX routes them out of bounds).

    No host sync, and no data-dependent shape, so a captured chunk can run
    it: every row of every slot is written, at ``(start + j) mod S``. For
    one slot those n positions are distinct (n <= S), so no two writes
    collide, and a dropped row writes back the bytes it read there."""
    B, K, n, H = ring_ks[0].shape
    S = cache.max_len
    if n > S:
        raise ValueError(f"a chunk of {n} rows does not fit a {S}-key panel")
    j = torch.arange(n, device=start.device)[None, :]
    pos = start.long()[:, None] + j                              # [B, n]
    keep = ((j < accepted[:, None]) & (pos < S))[:, :, None, None]
    pos = pos % S
    b = torch.arange(B, device=start.device)[:, None]
    for (k, v), rk, rv in zip(cache.layers, ring_ks, ring_vs):
        # Advanced indices (b, pos) around the head slice: [B, n, K, H].
        k[b, :, pos] = torch.where(keep, rk.transpose(1, 2).to(k.dtype), k[b, :, pos])
        v[b, :, pos] = torch.where(keep, rv.transpose(1, 2).to(v.dtype), v[b, :, pos])
    cache.lengths.copy_(torch.clamp(cache.lengths + accepted, max=cache.max_len))
    return cache


def free_slots(cache: KVCache, slots: Sequence[int]) -> KVCache:
    """Mark slots empty; the stale K/V bytes stay, masked by lengths."""
    for s in slots:
        if 0 <= int(s) < cache.n_slots:
            cache.lengths[int(s)] = 0   # a fill: no host copy to wait on
    return cache
