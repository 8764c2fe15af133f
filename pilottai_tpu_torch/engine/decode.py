"""Chunked decode and fused admission on the dense KV cache (the port's
counterpart of ``pilottai_tpu/engine/decode.py``; prefix caching,
paging, speculation and the fused greedy epilogue wait for later slices).

The chunk keeps the JAX engine's KV trick: inside a chunk the big
per-layer cache panels are read-only. Each step's fresh K/V goes to a
small per-layer ring ``[B, K, n, H]``; attention reads the cache prefix
through kernel K2 (``ops/kernels/decode_attention.py``) as online-softmax
statistics, attends the ring with plain tensor ops, and merges the two
with ``_merge_stats``; one scatter per layer lands the ring in the cache
at chunk end. JAX's ``lax.while_loop`` becomes a Python loop that stops
early once every slot is done (one device read per step).

Out-of-range slots — admission padding rows — are dropped explicitly:
torch raises where JAX's scatters drop and its gathers clamp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pilottai_tpu_torch.engine.sampling import SamplingState, admit_sampling, sample_core
from pilottai_tpu_torch.models.common import ModelConfig, rms_norm, rope_tables
from pilottai_tpu_torch.models.transformer import (
    _attn_out,
    _embed,
    _mlp,
    _qkv,
    _unembed,
    forward_prefill,
)
from pilottai_tpu_torch.ops.kernels.decode_attention import decode_attention
from pilottai_tpu_torch.ops.kvcache import KVCache, write_chunk_rows, write_prompts

NEG_INF = -2.0**30

# Packed admission metadata in the JAX package's layout (its
# engine/decode.py:93-106), so both engines' admission rows read alike.
# Here the buffers stay numpy: admit_group reads the rows it needs on the
# host and uploads only those.
ADMIT_I32_ROWS = 9
(
    AI_SLOT, AI_TOPK, AI_SEED, AI_EOS, AI_BUDGET, AI_JSON, AI_LEN, AI_SCHEMA, AI_PLEN,
) = range(ADMIT_I32_ROWS)
ADMIT_F32_ROWS = 2
AF_TEMP, AF_TOPP = range(ADMIT_F32_ROWS)


def pack_admit_meta(
    A: int, slots=(), temps=(), topks=(), topps=(), seeds=(), eos=(), jsonm=(),
    budgets=(), lens=(), schema_ids=(), prefix_len: int = 0, pad_slot: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(meta_i32 [9, A], meta_f32 [2, A])``; unspecified rows keep the
    padding defaults (slot ``pad_slot``, temp 0, top_p 1, eos/schema -1)."""
    mi = np.zeros((ADMIT_I32_ROWS, A), np.int32)
    mf = np.zeros((ADMIT_F32_ROWS, A), np.float32)
    mi[AI_SLOT] = pad_slot
    mi[AI_EOS] = -1
    mi[AI_SCHEMA] = -1
    mi[AI_PLEN] = int(prefix_len)
    mf[AF_TOPP] = 1.0
    for row_idx, values in (
        (AI_SLOT, slots), (AI_TOPK, topks), (AI_SEED, seeds), (AI_EOS, eos),
        (AI_BUDGET, budgets), (AI_JSON, jsonm), (AI_LEN, lens), (AI_SCHEMA, schema_ids),
    ):
        for col, v in enumerate(values):
            mi[row_idx, col] = int(v)
    for row_idx, values in ((AF_TEMP, temps), (AF_TOPP, topps)):
        for col, v in enumerate(values):
            mf[row_idx, col] = float(v)
    return mi, mf


@dataclass
class DecodeState:
    """Per-slot generation state living on the device across chunks."""

    tokens: torch.Tensor  # [B] int32 — next input token (last sampled)
    done: torch.Tensor    # [B] bool — finished or empty slot
    budget: torch.Tensor  # [B] int32 — generations still allowed

    @classmethod
    def create(cls, n_slots: int, device: torch.device) -> "DecodeState":
        return cls(
            tokens=torch.zeros((n_slots,), dtype=torch.int32, device=device),
            done=torch.ones((n_slots,), dtype=torch.bool, device=device),
            budget=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        )


def admit_decode(
    state: DecodeState,
    slots: Sequence[int],        # [A]; out-of-range rows dropped
    first_tokens: torch.Tensor,  # [A] int32 sampled from the prefill logits
    budgets: Sequence[int],      # [A] max_new_tokens - 1; <= 0 admits as done
    live: Sequence[bool],        # [A] False rows are padding
) -> DecodeState:
    B = state.tokens.shape[0]
    rows = [i for i, s in enumerate(slots) if live[i] and 0 <= int(s) < B]
    if rows:
        dev = state.tokens.device
        sl = torch.tensor([int(slots[i]) for i in rows], dtype=torch.long, device=dev)
        bud = torch.tensor([int(budgets[i]) for i in rows], dtype=torch.int32, device=dev)
        state.tokens[sl] = first_tokens[torch.tensor(rows, device=dev)]
        state.done[sl] = bud <= 0
        state.budget[sl] = torch.clamp(bud, min=0)
    return state


def release_decode(state: DecodeState, slots: Sequence[int]) -> DecodeState:
    """Host-side completion or cancel: stop decoding these slots."""
    live = [int(s) for s in slots if 0 <= int(s) < state.tokens.shape[0]]
    if live:
        state.done[live] = True
        state.budget[live] = 0
    return state


def _layer_tail(cfg: ModelConfig, lp: Dict[str, Any], x: torch.Tensor,
                attn: torch.Tensor) -> torch.Tensor:
    """Everything after a layer's attention weights: projection,
    residual, MLP, residual."""
    x = x + _attn_out(cfg, lp["attn"], attn)
    h = rms_norm(x, lp["ln2"]["scale"], cfg.rms_eps)
    return x + _mlp(lp, h)


def _ring_stats(
    qg: torch.Tensor,      # [B, K, G, H]
    ring_k: torch.Tensor,  # [B, K, n, H]
    ring_v: torch.Tensor,
    step: int,             # rows 0..step are valid
    scale: float, softcap: float, window: int,
):
    """In-chunk attention over the ring: row j holds chunk-relative offset
    j, so the causal mask is j <= step and the window (step - j) < window.
    Row 0 is always valid, so no row is fully masked."""
    B, K, G, H = qg.shape
    n = ring_k.shape[2]
    s = torch.einsum("bkgh,bknh->bkgn", qg.float(), ring_k.float()) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    j = torch.arange(n, device=qg.device)[None, None, None, :]
    mask = j <= step
    if window > 0:
        mask &= (step - j) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgn,bknh->bkgh", p.to(ring_v.dtype).float(), ring_v.float())
    return acc.reshape(B, K * G, H), m.reshape(B, K * G), l.reshape(B, K * G)


def _merge_stats(acc_a, m_a, l_a, acc_b, m_b, l_b):
    """Unnormalized online-softmax merge over disjoint key sets."""
    m = torch.maximum(m_a, m_b)
    wa = torch.where(m_a > NEG_INF / 2, torch.exp(m_a - m), torch.zeros_like(m))
    wb = torch.where(m_b > NEG_INF / 2, torch.exp(m_b - m), torch.zeros_like(m))
    return acc_a * wa[..., None] + acc_b * wb[..., None], m, l_a * wa + l_b * wb


def _combine_stats(acc_a, m_a, l_a, acc_b, m_b, l_b):
    """Merge two partials and normalize."""
    acc, _, l = _merge_stats(acc_a, m_a, l_a, acc_b, m_b, l_b)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def decode_chunk(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: KVCache,
    dstate: DecodeState,
    sampling: SamplingState,
    n_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache, DecodeState, SamplingState]:
    """Run up to ``n_steps`` decode steps for every slot.

    Returns ``(tokens [n, B], valid [n, B], cache, dstate, sampling)``;
    ``valid[i, b]`` marks tokens actually generated (slot active entering
    step i). Slots flip ``done`` on device at EOS, budget or a full
    context; the loop stops once every slot is done. The cache, decode
    state and sampling state are updated in place."""
    B = dstate.tokens.shape[0]
    dev = dstate.tokens.device
    S = cache.max_len
    start = cache.lengths.clone()          # frozen during the chunk
    prefix_last = start - 1                # max valid prefix key index (-1: empty)
    windows = cfg.window_sizes()
    G = cfg.n_heads // cfg.n_kv_heads
    ring_shape = (B, cfg.n_kv_heads, n_steps, cfg.head_dim)
    cache_dtype = cache.layers[0][0].dtype
    rings = [
        (torch.zeros(ring_shape, dtype=cache_dtype, device=dev),
         torch.zeros(ring_shape, dtype=cache_dtype, device=dev))
        for _ in range(cfg.n_layers)
    ]
    tokens, done, budget = dstate.tokens, dstate.done, dstate.budget
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    out_t = torch.zeros((n_steps, B), dtype=torch.int32, device=dev)
    out_v = torch.zeros((n_steps, B), dtype=torch.bool, device=dev)

    for i in range(n_steps):
        if bool(done.all()):
            break
        active = ~done
        pos = start + offset
        x = _embed(params, tokens[:, None].long())
        sin, cos = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
        for l, lp in enumerate(params["layers"]):
            window = int(windows[l])
            layer_k, layer_v = cache.layers[l]
            rk, rv = rings[l]
            h = rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
            q, k, v = _qkv(cfg, lp["attn"], h, sin, cos)
            rk[:, :, i] = k[:, 0].to(rk.dtype)
            rv[:, :, i] = v[:, 0].to(rv.dtype)
            qf = q[:, 0].contiguous()                          # [B, N, H]
            acc_p, m_p, l_p = decode_attention(
                qf, layer_k, layer_v, prefix_last, q_positions=pos,
                scale=cfg.qscale, softcap=cfg.attn_softcap, window=window,
                return_stats=True,
            )
            acc_c, m_c, l_c = _ring_stats(
                qf.reshape(B, cfg.n_kv_heads, G, cfg.head_dim), rk, rv, i,
                cfg.qscale, cfg.attn_softcap, window,
            )
            attn = _combine_stats(acc_p, m_p, l_p, acc_c, m_c, l_c)
            x = _layer_tail(
                cfg, lp, x, attn.to(x.dtype).reshape(B, 1, cfg.n_heads, cfg.head_dim)
            )
        h = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
        logits = _unembed(cfg, params, h)[:, 0]                 # [B, V] fp32
        sampled, sampling = sample_core(logits, sampling, json_remaining=budget)
        act = active.to(torch.int32)
        budget = budget - act
        hit_eos = (sampling.eos_id >= 0) & (sampled == sampling.eos_id)
        ctx_full = (pos + 1) >= (S - 1)
        done = done | (active & (hit_eos | (budget <= 0) | ctx_full))
        tokens = torch.where(active, sampled, tokens)
        offset = offset + act
        out_t[i] = sampled
        out_v[i] = active

    cache = write_chunk_rows(cache, [r[0] for r in rings], [r[1] for r in rings], start, offset)
    dstate.tokens, dstate.done, dstate.budget = tokens, done, budget
    return out_t, out_v, cache, dstate, sampling


def sample_prefill_tokens(
    logits: torch.Tensor,       # [A, T, V] fp32 prefill logits
    valid: torch.Tensor,        # [A] prompt lengths (last logit at valid - 1)
    slots: Sequence[int],       # [A] slot each prompt was admitted into
    sampling: SamplingState,
    remaining: Optional[torch.Tensor] = None,  # [A] total generation budget
) -> Tuple[torch.Tensor, SamplingState]:
    """Sample each admitted prompt's first token with (and advancing) its
    slot's sampling state. Padding rows (out-of-range slots) read a
    clamped slot and write nothing back."""
    A = logits.shape[0]
    idx = torch.clamp(valid.long() - 1, min=0)
    last = logits[torch.arange(A, device=logits.device), idx]     # [A, V]
    sub = sampling.rows(slots)
    tokens, sub = sample_core(last, sub, json_remaining=remaining)
    B = len(sampling.generators)
    rows = [i for i, s in enumerate(slots) if 0 <= int(s) < B]
    if rows:
        dev = logits.device
        r = torch.tensor(rows, dtype=torch.long, device=dev)
        sl = torch.tensor([int(slots[i]) for i in rows], dtype=torch.long, device=dev)
        sampling.json_state[sl] = sub.json_state[r]
        sampling.json_stack[sl] = sub.json_stack[r]
        sampling.json_depth[sl] = sub.json_depth[r]
    return tokens, sampling


def admit_group(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: KVCache,
    dstate: DecodeState,
    sampling: SamplingState,
    tokens: np.ndarray,    # [A, T] right-padded prompt ids
    meta_i32: np.ndarray,  # [ADMIT_I32_ROWS, A] packed int metadata
    meta_f32: np.ndarray,  # [ADMIT_F32_ROWS, A] packed float metadata
):
    """The whole admission path — prefill forward (kernel K1), batched
    cache write, sampler install, first-token sample, decode-state
    install. Returns ``(cache, dstate, sampling, first_tokens [A])``."""
    dev = dstate.tokens.device
    A, T = tokens.shape
    slots = [int(s) for s in meta_i32[AI_SLOT]]
    lens = [int(n) for n in meta_i32[AI_LEN]]
    budgets = [int(b) for b in meta_i32[AI_BUDGET]]
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(A, T)
    logits, ks, vs = forward_prefill(params, cfg, tok, positions, lens_t)
    cache = write_prompts(cache, slots, ks, vs, lens)
    sampling = admit_sampling(
        sampling, slots, meta_f32[AF_TEMP].tolist(), meta_i32[AI_TOPK].tolist(),
        meta_f32[AF_TOPP].tolist(), meta_i32[AI_SEED].tolist(), meta_i32[AI_EOS].tolist(),
        [bool(j) for j in meta_i32[AI_JSON]],
    )
    remaining = torch.tensor(budgets, dtype=torch.int32, device=dev) + 1
    first, sampling = sample_prefill_tokens(logits, lens_t, slots, sampling, remaining=remaining)
    dstate = admit_decode(dstate, slots, first, budgets, [n > 0 for n in lens])
    return cache, dstate, sampling, first
