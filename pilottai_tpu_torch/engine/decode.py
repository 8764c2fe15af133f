"""Chunked decode and fused admission on the dense or the paged KV cache
(the port's counterpart of ``pilottai_tpu/engine/decode.py``; speculation
waits for a later slice).

The chunk keeps the JAX engine's KV trick: inside a chunk the big
per-layer cache panels are read-only. Each step's fresh K/V goes to a
small per-layer ring ``[B, K, n, H]``, and one scatter per layer lands
the ring in the cache at chunk end. On the dense cache attention reads
the prefix through kernel K2 (``ops/kernels/decode_attention.py``) as
online-softmax statistics, attends the ring with plain tensor ops, and
merges the two with ``_merge_stats``. On the paged cache one launch of
kernel K3 (``ops/kernels/paged_attention.py``) per layer reads the live
pages through the block table with the ring fused in.

``decode_chunk`` is capturable: once it starts it does no host work (no
device read, no data-dependent shape), and every tensor it carries
across chunks is a persistent buffer updated in place, so a CUDA graph of
it (``engine/graphs.py``) reads and writes the live state. Where JAX's
``lax.while_loop`` exits once every slot is done, the chunk runs all its
``n`` steps, with the step index static as in the TPU's compiled chunk;
a step after every slot is done changes nothing that is folded. With
``fused_epilogue`` (every occupied slot greedy and unconstrained, which
the batcher checks per dispatch) the logits projection and the argmax
run as one vocab-tiled reduction (``fused_greedy_epilogue``).

A prompt whose head is cached admits through a tail prefill: on the
dense cache ``admit_group_prefix`` copies a prefix-store entry's panels
into the slots (``engine/prefix_cache.py``), on the paged cache
``admit_group_prefix_paged`` reads the shared chain that is mapped into
the slots' block tables (``engine/page_prefix.py``). Long prompts on the
paged cache admit in segments (chunked prefill): ``extend_prompt_paged``
prefills one segment against the pages already written, and the final
segment admits through ``admit_group_prefix_paged``. Every tail's
attention, prefix and tail together, is one launch of kernel K1 per layer
(``_tail_prefix_attn``).

Out-of-range slots — admission padding rows — are dropped explicitly:
torch raises where JAX's scatters drop and its gathers clamp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pilottai_tpu_torch.device import upload
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
from pilottai_tpu_torch.ops.kernels.flash_attention import flash_attention_with_lse
from pilottai_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
from pilottai_tpu_torch.ops.kvcache import KVCache, write_chunk_rows, write_prompts
from pilottai_tpu_torch.ops.paged import (
    PagedKVCache,
    install_lengths,
    write_chunk_rows_paged,
    write_prompts_paged,
)

AnyCache = Union[KVCache, PagedKVCache]

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
    """Install admitted rows in place (a captured chunk reads this
    storage)."""
    B = state.tokens.shape[0]
    rows = [i for i, s in enumerate(slots) if live[i] and 0 <= int(s) < B]
    if rows:
        dev = state.tokens.device
        sl = upload([int(slots[i]) for i in rows], torch.long, dev)
        bud = upload([int(budgets[i]) for i in rows], torch.int32, dev)
        state.tokens[sl] = first_tokens[upload(rows, torch.long, dev)]
        state.done[sl] = bud <= 0
        state.budget[sl] = torch.clamp(bud, min=0)
    return state


def release_decode(state: DecodeState, slots: Sequence[int]) -> DecodeState:
    """Host-side completion or cancel: stop decoding these slots (fills,
    so nothing waits for the device)."""
    for s in slots:
        if 0 <= int(s) < state.tokens.shape[0]:
            state.done[int(s)] = True
            state.budget[int(s)] = 0
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


def new_rings(cfg: ModelConfig, n_slots: int, n_steps: int, dtype: torch.dtype,
              device: torch.device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer ``(k, v)`` rings ``[B, K, n_steps, H]`` for one chunk."""
    shape = (n_slots, cfg.n_kv_heads, n_steps, cfg.head_dim)
    return [
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.n_layers)
    ]


@dataclass
class ChunkBuffers:
    """What one chunk variant writes besides the state: the rings and the
    per-step outputs. Allocated once per captured graph (a replay writes
    the same storage); the reader copies ``tokens`` and ``valid`` to the
    host before the next replay of the same graph overwrites them."""

    rings: List[Tuple[torch.Tensor, torch.Tensor]]
    tokens: torch.Tensor  # [n, B] int32 — the token sampled at each step
    valid: torch.Tensor   # [n, B] bool — the slot was active entering the step

    @classmethod
    def create(cls, cfg: ModelConfig, n_slots: int, n_steps: int, dtype: torch.dtype,
               device: torch.device) -> "ChunkBuffers":
        return cls(
            rings=new_rings(cfg, n_slots, n_steps, dtype, device),
            tokens=torch.zeros((n_steps, n_slots), dtype=torch.int32, device=device),
            valid=torch.zeros((n_steps, n_slots), dtype=torch.bool, device=device),
        )


# Vocab tile of the fused epilogue, the JAX package's: the [B, tile] fp32
# logits block of one tile is all that exists at a time.
EPILOGUE_VOCAB_TILE = 8192


def _head_tile(params: Dict[str, Any], off: int, end: int) -> torch.Tensor:
    """Columns ``[off, end)`` of the unembedding head ``[E, V]``: the
    untied ``lm_head``, or the transposed tied embedding."""
    if "lm_head" in params:
        return params["lm_head"][:, off:end]
    return params["embed"][off:end].t()


def fused_greedy_epilogue(
    cfg: ModelConfig, params: Dict[str, Any], h: torch.Tensor,
    tile: int = EPILOGUE_VOCAB_TILE,
) -> torch.Tensor:
    """Greedy sampling fused into the logits projection: final-normed
    hidden states ``h [B, T, E]`` to argmax ids ``[B, T]`` int32, equal to
    ``argmax(_unembed(cfg, params, h), -1)``. The JAX function's
    algorithm: the projection runs tile by tile over the vocab with a
    running (max, argmax) carry, so the ``[B, T, V]`` logits never exist;
    tiling splits the output axis, never the contraction, so each logit is
    the same dot product, with ``_unembed``'s operand dtypes; the softcap
    applies per tile; the in-tile argmax takes the first maximum and the
    carry replaces only on a strictly greater one, so ties go to the
    lowest index as ``torch.argmax``'s do."""
    B, T, E = h.shape
    x = h.reshape(B * T, E).float()
    best = torch.full((B * T,), -float("inf"), dtype=torch.float32, device=h.device)
    idx = torch.zeros((B * T,), dtype=torch.int32, device=h.device)
    for off in range(0, cfg.vocab_size, tile):
        end = min(off + tile, cfg.vocab_size)
        logits = x @ _head_tile(params, off, end).float()
        if cfg.logit_softcap > 0.0:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        m = logits.amax(dim=-1)
        better = m > best
        idx = torch.where(better, torch.argmax(logits, dim=-1).to(torch.int32) + off, idx)
        best = torch.where(better, m, best)
    return idx.reshape(B, T)


def decode_step_logits(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: AnyCache,
    tokens: torch.Tensor,       # [B] current token per slot
    pos: torch.Tensor,          # [B] int32 its position
    prefix_last: torch.Tensor,  # [B] last cache key each slot attends (-1: none)
    rings: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    i: int,                     # chunk step: ring rows 0..i attend, row i is written here
    table: Optional[torch.Tensor] = None,  # [B, max_pages] — the paged cache's block table
    n_blocks: Optional[int] = None,        # pages per slot K3 visits (default all)
    fused_epilogue: bool = False,
) -> torch.Tensor:
    """One decode step's forward for every slot: writes this step's K/V
    into ring row ``i`` of each layer and returns the ``[B, V]`` fp32
    logits, or with ``fused_epilogue`` the ``[B]`` int32 greedy ids of
    ``fused_greedy_epilogue`` (the logits never exist). The dense cache
    reads its prefix through K2 and merges the ring; the paged cache makes
    one K3 launch per layer, ring fused. The one step function of the
    eager and the captured chunk alike."""
    B = tokens.shape[0]
    G = cfg.n_heads // cfg.n_kv_heads
    windows = cfg.window_sizes()
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
        qf = q[:, 0].contiguous()                              # [B, N, H]
        if table is not None:
            acc, _, l_sum = paged_decode_attention(
                qf, layer_k, layer_v, table, prefix_last, q_positions=pos,
                n_blocks=n_blocks, scale=cfg.qscale, softcap=cfg.attn_softcap,
                window=window, ring_k=rk, ring_v=rv, ring_step=i,
            )
            attn = acc / torch.clamp(l_sum, min=1e-30)[..., None]
        else:
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
    if fused_epilogue:
        return fused_greedy_epilogue(cfg, params, h)[:, 0]
    return _unembed(cfg, params, h)[:, 0]


def decode_chunk(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: AnyCache,
    dstate: DecodeState,
    sampling: SamplingState,
    n_steps: int,
    table: Optional[torch.Tensor] = None,  # [B, max_pages] int32 — paged cache only
    n_blocks: Optional[int] = None,        # pages per slot K3 visits (default all)
    fused_epilogue: bool = False,          # every occupied slot greedy and unconstrained
    bufs: Optional[ChunkBuffers] = None,   # a captured variant's buffers (default fresh)
) -> Tuple[torch.Tensor, torch.Tensor, AnyCache, DecodeState, SamplingState]:
    """Run ``n_steps`` decode steps for every slot, with no host work:
    capturable as one CUDA graph.

    Returns ``(tokens [n, B], valid [n, B], cache, dstate, sampling)``;
    ``valid[i, b]`` marks tokens actually generated (slot active entering
    step i). Slots flip ``done`` on device at EOS, budget or a full
    context. Every step runs; once every slot is done a step leaves the
    budgets, tokens, lengths and JSON states as they were and marks
    nothing valid, so the result equals an early-exit loop's. The cache,
    decode state and sampling state are updated in place. The paged cache
    reads the block table given (the batcher's static table buffer)."""
    B = dstate.tokens.shape[0]
    dev = dstate.tokens.device
    paged = isinstance(cache, PagedKVCache)
    if paged and table is None:
        raise ValueError("paged decode needs the block table")
    if bufs is None:
        bufs = ChunkBuffers.create(cfg, B, n_steps, cache.layers[0][0].dtype, dev)
    if bufs.tokens.shape != (n_steps, B):
        raise ValueError(f"chunk buffers {tuple(bufs.tokens.shape)} for {n_steps} steps")
    S = table.shape[1] * cache.page_size if paged else cache.max_len
    start = cache.lengths.clone()          # frozen during the chunk
    prefix_last = start - 1                # max valid prefix key index (-1: empty)
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    tokens, done, budget = dstate.tokens, dstate.done, dstate.budget

    for i in range(n_steps):
        active = ~done
        pos = start + offset
        out = decode_step_logits(
            params, cfg, cache, tokens, pos, prefix_last, bufs.rings, i,
            table=table if paged else None, n_blocks=n_blocks,
            fused_epilogue=fused_epilogue,
        )
        if fused_epilogue:
            sampled = out
        else:
            sampled, sampling = sample_core(out, sampling, json_remaining=budget,
                                            json_gate=active.any())
        act = active.to(torch.int32)
        hit_eos = (sampling.eos_id >= 0) & (sampled == sampling.eos_id)
        ctx_full = (pos + 1) >= (S - 1)
        budget.sub_(act)
        done.logical_or_(active & (hit_eos | (budget <= 0) | ctx_full))
        tokens.copy_(torch.where(active, sampled, tokens))
        offset.add_(act)
        bufs.tokens[i].copy_(sampled)
        bufs.valid[i].copy_(active)

    ring_ks, ring_vs = [r[0] for r in bufs.rings], [r[1] for r in bufs.rings]
    if paged:
        cache = write_chunk_rows_paged(cache, table, ring_ks, ring_vs, start, offset)
    else:
        cache = write_chunk_rows(cache, ring_ks, ring_vs, start, offset)
    return bufs.tokens, bufs.valid, cache, dstate, sampling


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
        r = upload(rows, torch.long, dev)
        sl = upload([int(slots[i]) for i in rows], torch.long, dev)
        sampling.json_state[sl] = sub.json_state[r]
        sampling.json_stack[sl] = sub.json_stack[r]
        sampling.json_depth[sl] = sub.json_depth[r]
    return tokens, sampling


def _admit_rows(
    logits: torch.Tensor,   # [A, T, V] prefill (or tail) logits
    dstate: DecodeState,
    sampling: SamplingState,
    meta_i32: np.ndarray,
    meta_f32: np.ndarray,
) -> Tuple[DecodeState, SamplingState, torch.Tensor]:
    """Sampler install, first-token sample and decode-state install for
    the rows of one admission (``AI_LEN`` holds the lengths the logits
    end at)."""
    dev = dstate.tokens.device
    slots = [int(s) for s in meta_i32[AI_SLOT]]
    lens = [int(n) for n in meta_i32[AI_LEN]]
    budgets = [int(b) for b in meta_i32[AI_BUDGET]]
    sampling = admit_sampling(
        sampling, slots, meta_f32[AF_TEMP].tolist(), meta_i32[AI_TOPK].tolist(),
        meta_f32[AF_TOPP].tolist(), meta_i32[AI_SEED].tolist(), meta_i32[AI_EOS].tolist(),
        [bool(j) for j in meta_i32[AI_JSON]],
    )
    remaining = upload(budgets, torch.int32, dev) + 1
    lens_t = upload(lens, torch.int32, dev)
    first, sampling = sample_prefill_tokens(logits, lens_t, slots, sampling, remaining=remaining)
    dstate = admit_decode(dstate, slots, first, budgets, [n > 0 for n in lens])
    return dstate, sampling, first


def admit_group(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: AnyCache,
    dstate: DecodeState,
    sampling: SamplingState,
    tokens: np.ndarray,    # [A, T] right-padded prompt ids
    meta_i32: np.ndarray,  # [ADMIT_I32_ROWS, A] packed int metadata
    meta_f32: np.ndarray,  # [ADMIT_F32_ROWS, A] packed float metadata
    page_rows: Optional[np.ndarray] = None,  # [A, max_pages] — the paged cache's rows
):
    """The whole admission path — prefill forward (kernel K1), batched
    cache write, sampler install, first-token sample, decode-state
    install. Returns ``(cache, dstate, sampling, first_tokens [A])``."""
    dev = dstate.tokens.device
    A, T = tokens.shape
    slots = [int(s) for s in meta_i32[AI_SLOT]]
    lens = [int(n) for n in meta_i32[AI_LEN]]
    tok = upload(tokens, torch.long, dev)
    lens_t = upload(lens, torch.int32, dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(A, T)
    logits, ks, vs = forward_prefill(params, cfg, tok, positions, lens_t)
    if isinstance(cache, PagedKVCache):
        if page_rows is None:
            raise ValueError("paged admission needs the slots' page rows")
        cache = write_prompts_paged(cache, upload(page_rows, torch.int32, dev), ks, vs, lens)
        cache = install_lengths(cache, slots, lens)
    else:
        cache = write_prompts(cache, slots, ks, vs, lens)
    dstate, sampling, first = _admit_rows(logits, dstate, sampling, meta_i32, meta_f32)
    return cache, dstate, sampling, first


# --------------------------------------------------------------------- #
# Prefix-cached admission and chunked prefill
# --------------------------------------------------------------------- #


def _tail_prefix_attn(
    q: torch.Tensor,        # [A, T, N, H] tail queries
    k: torch.Tensor,        # [A, T, K, H] the tail's own keys
    v: torch.Tensor,
    pk: torch.Tensor,       # [K, Pp, H] the cached prefix's keys (Pp >= prefix_len)
    pv: torch.Tensor,
    prefix_len: int,        # true prefix length (a host int); the tail starts there
    valid: torch.Tensor,    # [A] true tail lengths
    scale: float,
    softcap: float,
    window: int,
) -> torch.Tensor:
    """Tail-prefill attention: every tail query attends the whole prefix
    and the tail causally, as one launch of kernel K1 over the key set
    ``prefix[:prefix_len] + tail``. The prefix carries no batch dim (one
    cached prompt serves the whole group), so it is expanded over the A
    rows; kv positions run ``0 .. prefix_len + T - 1``, the queries sit at
    ``prefix_len ..``, ``valid`` is ``prefix_len + valid`` and ``window``
    is K1's own. ``prefix_len`` is a host int, so no pad key enters the
    set. Returns ``[A, T, N, H]`` in q's dtype (the JAX function's fp32
    result, rounded once to the compute dtype by its caller)."""
    A, T, N, H = q.shape
    K = k.shape[2]
    plen = int(prefix_len)
    S = plen + T
    pre_k = pk[:, :plen].transpose(0, 1).to(k.dtype)[None].expand(A, plen, K, H)
    pre_v = pv[:, :plen].transpose(0, 1).to(v.dtype)[None].expand(A, plen, K, H)
    keys = torch.cat([pre_k, k], dim=1)                           # [A, S, K, H]
    vals = torch.cat([pre_v, v], dim=1)
    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None].expand(A, S)
    o, _ = flash_attention_with_lse(
        q, keys, vals, kv_pos[:, plen:], kv_pos, valid.to(torch.int32) + plen, window, scale,
        softcap,
    )
    return o


def _tail_prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    prefix_layer,                # l -> (pk [K, >= prefix_len, H], pv) for layer l
    prefix_len: int,
    tail_tokens: torch.Tensor,   # [A, Tt] right-padded tails
    tail_lens: torch.Tensor,     # [A] int32 (0 = padding row)
):
    """The one tail prefill of every prefix path (the JAX package's
    ``_tail_prefill_core`` and ``_chain_tail_prefill``): the tails attend
    the cached prefix and themselves causally, one layer at a time, each
    layer's prefix fetched by ``prefix_layer`` (the dense entry's panels,
    or the chain's pages gathered for that layer only). Returns ``(logits
    [A, Tt, V], ks [L, A, Tt, K, H], vs)``."""
    A, Tt = tail_tokens.shape
    positions = prefix_len + torch.arange(Tt, dtype=torch.int32, device=tail_tokens.device)
    positions = positions[None].expand(A, Tt)
    x = _embed(params, tail_tokens)
    sin, cos = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    windows = cfg.window_sizes()
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for l, lp in enumerate(params["layers"]):
        pk, pv = prefix_layer(l)
        h = rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
        q, k, v = _qkv(cfg, lp["attn"], h, sin, cos)
        attn = _tail_prefix_attn(
            q, k, v, pk, pv, prefix_len, tail_lens, cfg.qscale, cfg.attn_softcap,
            int(windows[l]),
        )
        x = _layer_tail(cfg, lp, x, attn.to(x.dtype))
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    return _unembed(cfg, params, x), torch.stack(ks), torch.stack(vs)


def _chain_layer(cache: PagedKVCache, chain: torch.Tensor):
    """``prefix_layer`` of a page chain: layer l's chain pages gathered into
    ``[K, len(chain)·P, H]`` panels (a transient copy per layer)."""
    K, _, P, H = cache.layers[0][0].shape
    n = chain.shape[0] * P

    def layer(l: int):
        k_pool, v_pool = cache.layers[l]
        return k_pool[:, chain].reshape(K, n, H), v_pool[:, chain].reshape(K, n, H)

    return layer


def _chain_pages(prefix_pages: np.ndarray, prefix_len: int, page_size: int,
                 device: torch.device) -> torch.Tensor:
    """The chain's true pages (any sentinel padding past ``prefix_len``, as
    the JAX callers pass, dropped) as a device index."""
    return upload(np.asarray(prefix_pages)[: int(prefix_len) // page_size], torch.long, device)


def extend_prompt_paged(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: PagedKVCache,
    prefix_pages: np.ndarray,  # pages already written for this slot (any past prefix_len ignored)
    prefix_len: int,           # page-aligned tokens written
    seg_tokens: np.ndarray,    # [1, Ts] the segment
    seg_lens: Sequence[int],   # [1] its true length
    page_rows: np.ndarray,     # [1, max_pages] the slot's block-table row
) -> PagedKVCache:
    """One chunked-prefill segment of a long prompt: prefill it against
    the KV already written for the slot and scatter its K/V into the
    slot's pages — nothing else. The slot stays decode-inactive until the
    final segment admits through ``admit_group_prefix_paged``."""
    dev = cache.lengths.device
    chain = _chain_pages(prefix_pages, prefix_len, cache.page_size, dev)
    _logits, ks, vs = _tail_prefill(
        params, cfg, _chain_layer(cache, chain), int(prefix_len),
        upload(seg_tokens, torch.long, dev), upload([int(n) for n in seg_lens], torch.int32, dev),
    )
    return write_prompts_paged(cache, upload(page_rows, torch.int32, dev), ks, vs,
                               seg_lens, pos_offset=int(prefix_len))


def admit_group_prefix_paged(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: PagedKVCache,
    dstate: DecodeState,
    sampling: SamplingState,
    prefix_pages: np.ndarray,  # the shared chain's pages in order (any past AI_PLEN ignored)
    tail_tokens: np.ndarray,   # [A, Tt] right-padded prompt tails
    page_rows: np.ndarray,     # [A, max_pages] the slots' block-table rows
    meta_i32: np.ndarray,      # AI_LEN = tail lengths, AI_PLEN = page-aligned prefix length
    meta_f32: np.ndarray,
):
    """Admission of prompts whose first ``AI_PLEN`` tokens already sit in
    the chain's pages, mapped at the head of every row's block table: a
    group of A rows sharing one cached chain (a prefix hit), or the final
    segment of a chunked prefill over its own chain. Nothing is copied:
    the chain is read for the tails' attention, only the tails are
    prefilled and written after it, then the rows are sampled and
    installed as ``admit_group`` does. Returns ``(cache, dstate,
    sampling, first_tokens [A])``."""
    dev = dstate.tokens.device
    slots = [int(s) for s in meta_i32[AI_SLOT]]
    tail_lens = [int(n) for n in meta_i32[AI_LEN]]
    prefix_len = int(meta_i32[AI_PLEN, 0])
    chain = _chain_pages(prefix_pages, prefix_len, cache.page_size, dev)
    logits, ks, vs = _tail_prefill(
        params, cfg, _chain_layer(cache, chain), prefix_len,
        upload(tail_tokens, torch.long, dev), upload(tail_lens, torch.int32, dev),
    )
    cache = write_prompts_paged(cache, upload(page_rows, torch.int32, dev), ks, vs,
                                tail_lens, pos_offset=prefix_len)
    cache = install_lengths(
        cache, slots, [prefix_len + n if n > 0 else 0 for n in tail_lens]
    )
    dstate, sampling, first = _admit_rows(logits, dstate, sampling, meta_i32, meta_f32)
    return cache, dstate, sampling, first


def admit_group_prefix(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: KVCache,
    dstate: DecodeState,
    sampling: SamplingState,
    prefix_ks: torch.Tensor,   # [L, K, P, H] the cached prefix's keys (P >= AI_PLEN)
    prefix_vs: torch.Tensor,
    tail_tokens: np.ndarray,   # [A, Tt] right-padded prompt tails
    meta_i32: np.ndarray,      # AI_LEN = tail lengths, AI_PLEN = true prefix length
    meta_f32: np.ndarray,
):
    """Admission with a cached prefix on the dense cache: copy the entry's
    panels into each slot's ``[0, prefix_len)``, prefill only the tails
    against them and write each tail at ``prefix_len``, then sample and
    install as ``admit_group`` does; an exact repeat is a one-token tail.
    Raises when ``prefix_len + Tt`` passes the panel, which would write a
    tail over its own prefix (the batcher's ``fits`` check makes such an
    entry a miss). Returns ``(cache, dstate, sampling, first_tokens
    [A])``."""
    dev = dstate.tokens.device
    A, Tt = tail_tokens.shape
    tail_lens = [int(n) for n in meta_i32[AI_LEN]]
    prefix_len = int(meta_i32[AI_PLEN, 0])
    if prefix_len + Tt > cache.max_len:
        raise ValueError(f"a {Tt}-token tail at {prefix_len} passes the {cache.max_len}-key "
                         "panel")
    logits, ks, vs = _tail_prefill(
        params, cfg, lambda l: (prefix_ks[l], prefix_vs[l]), prefix_len,
        upload(tail_tokens, torch.long, dev), upload(tail_lens, torch.int32, dev),
    )
    rows = [a for a, s in enumerate(meta_i32[AI_SLOT])
            if tail_lens[a] > 0 and 0 <= int(s) < cache.n_slots]
    if rows:
        sl = upload([int(meta_i32[AI_SLOT, a]) for a in rows], torch.long, dev)
        r = upload(rows, torch.long, dev)
        for l, (kc, vc) in enumerate(cache.layers):
            K, H = kc.shape[1], kc.shape[3]
            kc[sl, :, :prefix_len] = prefix_ks[l][None, :, :prefix_len].to(kc.dtype).expand(
                len(rows), K, prefix_len, H)
            vc[sl, :, :prefix_len] = prefix_vs[l][None, :, :prefix_len].to(vc.dtype).expand(
                len(rows), K, prefix_len, H)
            kc[sl, :, prefix_len:prefix_len + Tt] = ks[l][r].transpose(1, 2).to(kc.dtype)
            vc[sl, :, prefix_len:prefix_len + Tt] = vs[l][r].transpose(1, 2).to(vc.dtype)
        cache.lengths[sl] = upload([prefix_len + tail_lens[a] for a in rows], torch.int32, dev)
    dstate, sampling, first = _admit_rows(logits, dstate, sampling, meta_i32, meta_f32)
    return cache, dstate, sampling, first


def export_prefix(cache: KVCache, slot: int, p_bucket: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's first ``p_bucket`` cache rows as stacked ``[L, K,
    p_bucket, H]`` copies (a prefix-store entry's payload), in the cache
    dtype. Enqueued right after the admission that wrote them, on the same
    stream, so the rows hold exactly the prompt's K/V."""
    ks = torch.stack([k[slot, :, :p_bucket] for k, _ in cache.layers])
    vs = torch.stack([v[slot, :, :p_bucket] for _, v in cache.layers])
    return ks, vs
