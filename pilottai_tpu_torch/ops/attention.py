"""Plain grouped-query attention and its mask helpers (the port's copy of
``pilottai_tpu/ops/attention.py``). This is the reference the kernels
are held against, not a serving path: prefill attention goes through
``ops/kernels/flash_attention.py``."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0**30  # large negative, safe in bf16 after cast


def dot_product_attention(
    q: torch.Tensor,  # [B, T, N, H]
    k: torch.Tensor,  # [B, S, K, H]
    v: torch.Tensor,  # [B, S, K, H]
    mask: Optional[torch.Tensor] = None,  # [B, T, S] or [B, 1, T, S], True = attend
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Grouped-query attention with fp32 logits and softmax. Returns
    [B, T, N, H] in q's dtype. A fully masked row averages V uniformly,
    as the JAX function does."""
    B, T, N, H = q.shape
    _, S, K, _ = k.shape
    if N % K:
        raise ValueError(f"query heads {N} not divisible by kv heads {K}")
    G = N // K
    scale = scale if scale is not None else H**-0.5
    qg = q.reshape(B, T, K, G, H)
    logits = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    if logit_softcap > 0.0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if mask is not None:
        if mask.dim() == 4:
            mask = mask[:, 0]
        logits = torch.where(mask[:, None, None], logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", weights.float(), v.float())
    return out.reshape(B, T, N, H).to(q.dtype)


def make_attention_mask(
    q_positions: torch.Tensor,  # [B, T] absolute positions of the queries
    kv_length: int,             # S — cache length
    kv_valid: torch.Tensor,     # [B] valid cache entries
    window: int = 0,            # 0 = global
) -> torch.Tensor:
    """True where the query at position p may attend cache slot j: j <= p,
    j < kv_valid and (window == 0 or p - j < window). Returns [B, T, S]."""
    j = torch.arange(kv_length, device=q_positions.device)[None, None, :]
    p = q_positions[:, :, None]
    mask = (j <= p) & (j < kv_valid[:, None, None])
    if window > 0:
        mask &= (p - j) < window
    return mask


def prefill_mask(
    q_positions: torch.Tensor,   # [B, T]
    kv_positions: torch.Tensor,  # [B, S]
    valid: torch.Tensor,         # [B] valid kv length (index bound)
    window: int = 0,
) -> torch.Tensor:
    """The flash-attention mask from absolute positions: kv_pos <= q_pos,
    kv index < valid, and (window <= 0 or q_pos - kv_pos < window).
    Returns [B, T, S]."""
    qp = q_positions[:, :, None]
    kp = kv_positions[:, None, :]
    S = kv_positions.shape[1]
    idx = torch.arange(S, device=kv_positions.device)[None, None, :]
    mask = (kp <= qp) & (idx < valid[:, None, None])
    if window > 0:
        mask &= (qp - kp) < window
    return mask
