"""Slot-based dense KV cache for continuous batching (the port's
counterpart of ``pilottai_tpu/ops/kvcache.py``).

One ``(k, v)`` pair per layer, each ``[B, K, S, H]``: B serving slots, K
kv heads, S max context, H head dim. K-major panels make each (slot, kv
head) one contiguous ``[S, H]`` span, which the decode kernel reads as
contiguous tiles. ``lengths[b]`` counts valid entries; bytes past it are
masked at attention time, so freeing a slot is one scalar write.

With ``quantized=True`` the panels are int8 and ``scales`` holds a
``(k_scale, v_scale)`` pair ``[B, K, S]`` fp32 per layer: symmetric per
token and kv head (``quantize_kv``). Every write quantizes what it
stores, and the readers apply the scales after their dot products
(kernel K2's int8 body, ``engine/decode.py``), so a decode step reads the
int8 bytes and nothing makes a dequantized copy of a panel.

JAX's arrays are immutable and its cache is donated through each
dispatch; here the functions write the tensors in place (saving the
copy) and return the cache for symmetry with the JAX signatures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from pilottai_tpu_torch.device import DeviceLike, resolve_device, upload


# The fp32 reciprocal of 127: XLA compiles the JAX quantizer's division
# of the amax by the constant 127 into a multiplication by it.
_RECIP_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per token and head: ``x [..., H]`` to ``(q int8
    [..., H], scale fp32 [...])``, with scale = max|x| / 127 floored at
    1e-8, q = round(x / scale) (half to even) clipped to ±127.

    The arithmetic is the JAX function's as XLA compiles it under ``jit``,
    which is how the JAX engine's admission and decode chunk run it: the
    division of the amax by 127 becomes a multiplication by the fp32
    reciprocal (``_RECIP_127``), which rounds differently from the
    division in the last bit now and then; the division of x by the scale
    stays a division. Dequantizing and quantizing again gives the same
    bytes, which is what lets the prefix store hold fp32 panels while the
    cache stays int8."""
    xf = x.float()
    s = torch.clamp(torch.linalg.vector_norm(xf, ord=float("inf"), dim=-1) * _RECIP_127,
                    min=1e-8)
    q = torch.div(xf, s[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``quantize_kv``: ``q * scale`` in fp32, rounded once
    to ``dtype``."""
    return (q.float() * scale[..., None].float()).to(dtype)


@dataclass
class KVCache:
    layers: List[Tuple[torch.Tensor, torch.Tensor]]  # per-layer (k, v) [B, K, S, H]
    lengths: torch.Tensor                            # [B] int32 — valid entries
    # Per-layer (k_scale, v_scale) [B, K, S] fp32 when the panels are int8;
    # None for panels in the compute dtype.
    scales: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None

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
        quantized: bool = False,
    ) -> "KVCache":
        device = resolve_device(device)
        shape = (n_slots, n_kv_heads, max_len, head_dim)
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


def write_prompts(
    cache: KVCache,
    slots: Sequence[int],    # [A] target slot per admitted prompt (host ints)
    ks: torch.Tensor,        # [L, A, T, K, H] prefill K for every layer
    vs: torch.Tensor,        # [L, A, T, K, H]
    lengths: Sequence[int],  # [A] true prompt lengths; <= 0 marks a padding row
) -> KVCache:
    """Insert a batch of freshly prefilled prompts. T may be padded (the
    rows past ``lengths[a]`` are masked at attention time). The JAX
    function routes padding rows to the first row's slot and writes the
    live row 0 last, so that it wins; here the padding rows are left out,
    which leaves the same cache, and the live rows are written at once:
    one write per tensor and layer, whatever the group's size."""
    T = ks.shape[2]
    if T > cache.max_len:
        raise ValueError(f"prompt bucket {T} exceeds the cache length {cache.max_len}")
    live = [a for a, n in enumerate(lengths) if int(n) > 0]
    if not live:
        return cache
    dev = cache.lengths.device
    rows = upload(live, torch.long, dev)
    dst = upload([int(slots[a]) for a in live], torch.long, dev)
    for layer, (k, v) in enumerate(cache.layers):
        k_new = ks[layer][rows].transpose(1, 2)         # [n, K, T, H]
        v_new = vs[layer][rows].transpose(1, 2)
        if cache.scales is not None:
            k_new, k_sc = quantize_kv(k_new)
            v_new, v_sc = quantize_kv(v_new)
            ks_p, vs_p = cache.scales[layer]
            ks_p[dst, :, :T] = k_sc
            vs_p[dst, :, :T] = v_sc
        k[dst, :, :T] = k_new.to(k.dtype)
        v[dst, :, :T] = v_new.to(v.dtype)
    cache.lengths[dst] = upload([int(lengths[a]) for a in live], torch.int32, dev)
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
    for layer, ((k, v), rk, rv) in enumerate(zip(cache.layers, ring_ks, ring_vs)):
        if cache.scales is not None:
            rk, k_sc = quantize_kv(rk)                           # [B, K, n]
            rv, v_sc = quantize_kv(rv)
            ks_p, vs_p = cache.scales[layer]
            # Advanced indices (b, pos) around the head slice: [B, n, K].
            ks_p[b, :, pos] = torch.where(keep[..., 0], k_sc.transpose(1, 2), ks_p[b, :, pos])
            vs_p[b, :, pos] = torch.where(keep[..., 0], v_sc.transpose(1, 2), vs_p[b, :, pos])
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


def reset_cache(cache) -> None:
    """Zero a dense or paged cache in place — its panels or pools, their
    int8 scales and the lengths — as a new cache is made: the engine's
    failure-path rebuild keeps every tensor a captured chunk graph reads
    at its address."""
    for pair in cache.layers + (cache.scales or []):
        for t in pair:
            t.zero_()
    cache.lengths.zero_()
