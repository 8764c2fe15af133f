"""Chunked decode, speculative decode and fused admission on the dense or
the paged KV cache (the port's counterpart of
``pilottai_tpu/engine/decode.py``).

The chunk keeps the JAX engine's KV trick: inside a chunk the big
per-layer cache panels are read-only. Each step's fresh K/V goes to a
small per-layer ring ``[B, K, n, H]``, and one scatter per layer lands
the ring in the cache at chunk end. On the dense cache attention reads
the prefix through kernel K2 (``ops/kernels/decode_attention.py``) as
online-softmax statistics, attends the ring with plain tensor ops
(``_ragged_stats``), and merges the two with ``_merge_stats``. On the
paged cache one launch of kernel K3 (``ops/kernels/paged_attention.py``)
per layer reads the live pages through the block table with the ring
fused in.

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

``decode_chunk_spec`` is the speculative chunk (``engine_speculate``):
verify blocks of D tokens a slot, drafted from the slot's token history
(``_ngram_drafts``) or by the model's first layers (``_model_drafts``),
checked in one weight pass (``spec_block_forward``: the prefix through
plain products over a bounded dense panel, or one K3 launch a layer with
``q_blocks=D`` on the paged cache, merged with the ring and the block
itself). It is capturable as ``decode_chunk`` is; the rows a block does
not keep are written to a spare row or column that nothing reads, where
JAX's scatters drop them. Every admission installs the slot's history
(``install_history``) when speculation is on.

An int8 cache (``engine_kv_quantize="int8"``) keeps a fp32 scale per
token and kv head beside its panels or pools (``cache.scales``). Its
writes quantize (``ops/kvcache.py``, ``ops/paged.py``) and its reads apply
the scales: the dense decode step and the dense model drafts through K2's
int8 body, the paged ones and the paged verify through K3 with the scale
pools, the dense verify's prefix as plain products over the int8 panel
with the scales applied after them (``_spec_block_attn``), and a page
chain dequantized to the compute dtype as it leaves the pools for a tail
prefill (``_chain_layer``). The rings stay in the compute dtype until the
chunk-end write quantizes them (``ring_dtype``). A dense prefix-store
entry is exported dequantized in fp32 (``export_prefix``) and quantized
again on install, which gives back the same bytes.

Out-of-range slots — admission padding rows — are dropped explicitly:
torch raises where JAX's scatters drop and its gathers clamp.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pilottai_tpu_torch.device import upload
from pilottai_tpu_torch.engine.sampling import SamplingState, admit_sampling, sample_core
from pilottai_tpu_torch.models.common import ModelConfig, matmul_f32, rms_norm, rope_tables
from pilottai_tpu_torch.models.qmatmul import qmatmul
from pilottai_tpu_torch.models.quant import Q4Tensor, QTensor
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
from pilottai_tpu_torch.ops.kvcache import (
    KVCache,
    dequantize_kv,
    quantize_kv,
    write_chunk_rows,
    write_prompts,
)
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


def ring_dtype(cfg: ModelConfig, cache: AnyCache) -> torch.dtype:
    """The rings' dtype: the cache's, or the compute dtype when the cache
    is int8 (the chunk-end write quantizes the ring)."""
    return cfg.dtype if cache.scales is not None else cache.layers[0][0].dtype


def _layer_scales(cache: AnyCache, l: int):
    """Layer ``l``'s ``(k_scale, v_scale)``, or ``(None, None)``."""
    return cache.scales[l] if cache.scales is not None else (None, None)


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


def _head_tile(params: Dict[str, Any], off: int, end: int) -> Any:
    """Columns ``[off, end)`` of the unembedding head ``[E, V]``: the
    untied ``lm_head``, or the transposed tied embedding. A quantized head
    stays quantized (views of its ``q`` and ``s`` columns), so the tile's
    read stays int8- or int4-sized."""
    if "lm_head" in params:
        head = params["lm_head"]
        if isinstance(head, (QTensor, Q4Tensor)):
            return dataclasses.replace(head, q=head.q[:, off:end], s=head.s[:, off:end])
        return head[:, off:end]
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
    the same dot product, with ``_unembed``'s operand dtypes and fp32
    result (``qmatmul``: a dense bf16 tile on the tensor cores on CUDA, no
    fp32 copy of the head; a quantized tile through the quantized
    product's kernel); the softcap
    applies per tile; the in-tile argmax takes the first maximum and the
    carry replaces only on a strictly greater one, so ties go to the
    lowest index as ``torch.argmax``'s do."""
    B, T, E = h.shape
    x = h.reshape(B * T, E)
    best = torch.full((B * T,), -float("inf"), dtype=torch.float32, device=h.device)
    idx = torch.zeros((B * T,), dtype=torch.int32, device=h.device)
    for off in range(0, cfg.vocab_size, tile):
        end = min(off + tile, cfg.vocab_size)
        logits = qmatmul(x, _head_tile(params, off, end), preferred_element_type=torch.float32)
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
    ring_rows = torch.full((B,), i + 1, dtype=torch.int32, device=tokens.device)
    for l, lp in enumerate(params["layers"]):
        window = int(windows[l])
        layer_k, layer_v = cache.layers[l]
        k_sc, v_sc = _layer_scales(cache, l)
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
                window=window, k_scales=k_sc, v_scales=v_sc, ring_k=rk, ring_v=rv,
                ring_step=i,
            )
            attn = acc / torch.clamp(l_sum, min=1e-30)[..., None]
        else:
            acc_p, m_p, l_p = decode_attention(
                qf, layer_k, layer_v, prefix_last, q_positions=pos,
                scale=cfg.qscale, softcap=cfg.attn_softcap, window=window,
                return_stats=True, k_scales=k_sc, v_scales=v_sc,
            )
            # The ring: row j holds the token at pos - i + j; rows 0..i attend.
            acc_c, m_c, l_c = _ragged_stats(
                qf.reshape(B, cfg.n_kv_heads, G, cfg.head_dim), rk, rv, ring_rows, pos - i, pos,
                cfg.qscale, cfg.attn_softcap, window,
            )
            attn = _combine_stats(acc_p, m_p, l_p, acc_c.reshape(acc_p.shape),
                                  m_c.reshape(m_p.shape), l_c.reshape(l_p.shape))
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
        bufs = ChunkBuffers.create(cfg, B, n_steps, ring_dtype(cfg, cache), dev)
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


# --------------------------------------------------------------------- #
# Speculative decoding: verify blocks of D tokens a weight pass
# --------------------------------------------------------------------- #
#
# Decode is bound by the weights' bytes, so a block of D tokens a slot (the
# current token and D - 1 drafts) costs about what one token does, and a
# greedy slot emits its leading run of accepted drafts plus one token of
# its own: ids identical to the plain chunk's, since acceptance compares
# the model's own masked greedy rows with the drafts. Drafts come from the
# slot's own history (``_ngram_drafts``) or, for slots whose n-gram
# acceptance has collapsed, from the model's first layers
# (``_model_drafts``). A sampled slot emits one token a block, drawing
# once, where the plain chunk draws once a step: its stream is the same.


def _ngram_drafts(
    history: torch.Tensor,  # [B, S] token ids by absolute position
    pos: torch.Tensor,      # [B] the current token's position
    cur: torch.Tensor,      # [B] the current token
    n_drafts: int,
) -> torch.Tensor:
    """``n_drafts`` continuation tokens a slot: the latest earlier
    occurrence of the (prev2, prev, cur) 3-gram in the slot's history,
    backing off to the (prev, cur) 2-gram, and what followed it (the 3-gram
    tier tells apart the continuations of pairs JSON repeats, such as
    ``", "``). Only occurrences whose whole continuation is written count
    (``j + n_drafts <= pos``). No match gives zeros, which cost a missed
    block, never a wrong token. ``[B, n_drafts]`` int32."""
    B, S = history.shape
    dev = history.device
    idx = torch.arange(S, device=dev)[None, :]
    prev = torch.gather(history, 1, torch.clamp(pos - 1, min=0).long()[:, None])
    prev2 = torch.gather(history, 1, torch.clamp(pos - 2, min=0).long()[:, None])
    pad = torch.full((B, 2), -1, dtype=history.dtype, device=dev)
    prev_col = torch.cat([pad[:, :1], history[:, :-1]], dim=1)
    prev2_col = torch.cat([pad, history[:, :-2]], dim=1)
    match = (history == cur[:, None]) & (prev_col == prev)
    match &= (idx <= pos[:, None] - n_drafts) & (idx >= 1)
    match3 = match & (prev2_col == prev2) & (idx >= 2) & (pos[:, None] >= 2)
    j2 = torch.argmax(torch.where(match, idx, -1), dim=1)       # the latest match
    j3 = torch.argmax(torch.where(match3, idx, -1), dim=1)
    j = torch.where(match3.any(dim=1), j3, j2)
    dpos = j[:, None] + 1 + torch.arange(n_drafts, device=dev)[None, :]
    drafts = torch.gather(history, 1, torch.clamp(dpos, max=S - 1))
    return torch.where(match.any(dim=1)[:, None], drafts, torch.zeros_like(drafts))


def _masked_stats(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                  v_scale: Optional[torch.Tensor] = None):
    """Online-softmax partials ``(acc, m, l)`` of fp32 logits ``s [..., n]``
    under ``mask`` against values ``v [..., n, H]``: a row with no key has
    ``m = NEG_INF``, ``l = 0`` and ``acc = 0``; p (times ``v_scale [...,
    n]`` when given, after l is taken) is cast to v's dtype before the
    product, whose result is fp32."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(m[..., None] > NEG_INF / 2, torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale
    return matmul_f32(p.to(v.dtype), v), m, l


def _softcapped(s: torch.Tensor, softcap: float) -> torch.Tensor:
    return torch.tanh(s / softcap) * softcap if softcap > 0.0 else s


def _ragged_stats(
    qg: torch.Tensor,     # [B, K, G, H] single-position queries
    ks: torch.Tensor,     # [B, K, N, H]: row r is valid iff r < count[b]
    vs: torch.Tensor,
    count: torch.Tensor,  # [B] valid rows
    pos0: torch.Tensor,   # [B] absolute position of row 0 (the window)
    qpos: torch.Tensor,   # [B] query positions
    scale: float,
    softcap: float,
    window: int,
):
    """Online-softmax partials over a per-slot ragged key buffer (the
    chunk ring, whose valid rows differ by slot under speculation, or a
    model draft's own buffer): ``(acc [B,K,G,H] fp32, m, l [B,K,G])``."""
    N = ks.shape[2]
    s = _softcapped(matmul_f32(qg, ks.transpose(-1, -2)) * scale, softcap)
    r = torch.arange(N, device=qg.device)[None, None, None, :]
    mask = r < count[:, None, None, None]
    if window > 0:
        mask = mask & ((qpos[:, None, None, None] - (pos0[:, None, None, None] + r)) < window)
    return _masked_stats(s, mask, vs)


def _spec_block_attn(
    qg: torch.Tensor,        # [B, K, G, D, H] the block's queries
    layer_k: Optional[torch.Tensor],  # [B, K, Sb, H] bounded prefix panels (None with
    layer_v: Optional[torch.Tensor],  # prefix_stats)
    ring_k: torch.Tensor,    # [B, K, R, H] the chunk ring (row r at position start + r)
    ring_v: torch.Tensor,
    blk_k: torch.Tensor,     # [B, K, D, H] the block's own keys
    blk_v: torch.Tensor,
    last: torch.Tensor,      # [B] the last valid prefix key (-1: none)
    start: torch.Tensor,     # [B] slot length at chunk start
    offset: torch.Tensor,    # [B] valid ring rows
    qpos: torch.Tensor,      # [B, D] absolute query positions
    scale: float,
    softcap: float,
    window: int,
    prefix_stats=None,       # (acc [B, K·G·D, H], m, l [B, K·G·D]): K3's, on the paged cache
    kv_scales=None,          # (k_scale, v_scale [B, K, Sb]): an int8 panel's
) -> torch.Tensor:
    """Attention of a verify block over three sources merged with
    ``_merge_stats``: the prefix (every block query sees the whole valid
    prefix), the in-chunk ring (per-slot valid count) and the block itself
    (causal, ``e <= d``; row d always sees itself). On the dense cache the
    prefix is plain tensor products over a panel bounded at ``Sb`` keys, as
    the JAX package leaves it to XLA (K2 holds at most 8 query rows a kv
    head, a block has G·D); on the paged cache ``prefix_stats`` come from
    one K3 launch with ``q_blocks=D``. Every product takes the operands'
    dtype with an fp32 result (``matmul_f32``); an int8 panel is widened to
    q's dtype, its k scale multiplies the scaled logits before the cap and
    its v scale p before the PV product, as the JAX function applies them.
    Returns ``[B, D, K·G·H]`` fp32."""
    B, K, G, D, H = qg.shape
    dev = qg.device
    q = qg.reshape(B, K, G * D, H)
    qrow = qpos[:, None, None, :].expand(B, 1, G, D).reshape(B, 1, G * D, 1)
    if prefix_stats is not None:
        acc_p, m_p, l_p = (t.reshape(B, K, G * D, *t.shape[2:]) for t in prefix_stats)
    else:
        if kv_scales is not None:
            layer_k, layer_v = layer_k.to(q.dtype), layer_v.to(q.dtype)
        s = matmul_f32(q, layer_k.transpose(-1, -2)) * scale
        if kv_scales is not None:
            s = s * kv_scales[0][:, :, None, :]
        s = _softcapped(s, softcap)
        col = torch.arange(layer_k.shape[2], device=dev)[None, None, None, :]
        mask = col <= last[:, None, None, None]
        if window > 0:
            mask = mask & ((qrow - col) < window)
        acc_p, m_p, l_p = _masked_stats(
            s, mask, layer_v, None if kv_scales is None else kv_scales[1][:, :, None, :])
    # The ring: rows below offset are live; row r sits at start + r.
    s = _softcapped(matmul_f32(q, ring_k.transpose(-1, -2)) * scale, softcap)
    r = torch.arange(ring_k.shape[2], device=dev)[None, None, None, :]
    mask = r < offset[:, None, None, None]
    if window > 0:
        mask = mask & ((qrow - (start[:, None, None, None] + r)) < window)
    acc_r, m_r, l_r = _masked_stats(s, mask, ring_v)
    # The block: row (g, d) sees keys e <= d.
    s = _softcapped(matmul_f32(q, blk_k.transpose(-1, -2)) * scale, softcap)
    e = torch.arange(D, device=dev)[None, None, None, :]
    d = (torch.arange(G * D, device=dev) % D)[None, None, :, None]
    mask = e <= d
    if window > 0:
        mask = mask & ((d - e) < window)
    acc_b, m_b, l_b = _masked_stats(s, mask, blk_v)
    acc, m, l = _merge_stats(acc_p, m_p, l_p, acc_r, m_r, l_r)
    acc, _, l = _merge_stats(acc, m, l, acc_b, m_b, l_b)
    attn = acc / torch.clamp(l, min=1e-30)[..., None]            # [B, K, G·D, H]
    return attn.reshape(B, K, G, D, H).permute(0, 3, 1, 2, 4).reshape(B, D, K * G * H)


def _model_drafts(
    params: Dict[str, Any],
    cfg: ModelConfig,
    draft_layers: int,
    cur: torch.Tensor,       # [B] the current token
    pos: torch.Tensor,       # [B] its position
    cache: AnyCache,
    rings: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    start: torch.Tensor,     # [B] slot length at chunk start
    offset: torch.Tensor,    # [B] valid ring rows
    last: torch.Tensor,      # [B] the last valid prefix key
    draft_bufs: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # per draft layer [B, K, D-1, H]
    table: Optional[torch.Tensor] = None,
    n_blocks: Optional[int] = None,
) -> torch.Tensor:
    """Self-speculative drafts: the target's own first ``draft_layers``
    layers, the final norm and the unembedding run ``D - 1`` single-token
    steps (``D - 1`` is the buffers' width). A draft token attends what the
    verify pass will: the prefix (K2 on the dense cache, K3 with
    ``q_blocks=1`` and no ring on the paged one), the chunk ring and its own
    buffer, into which its K/V is written before it attends (the verify's
    ``e <= d`` includes the token itself), so the layers it runs compute
    the K/V the target does. Returns ``[B, D-1]`` int32."""
    B = cur.shape[0]
    K, H = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // K
    windows = cfg.window_sizes()
    tok = cur
    drafts = []
    for j in range(draft_bufs[0][0].shape[2]):
        qpos = pos + j
        x = _embed(params, tok[:, None].long())
        sin, cos = rope_tables(qpos[:, None], H, cfg.rope_theta)
        count = torch.full((B,), j + 1, dtype=torch.int32, device=cur.device)
        for l in range(draft_layers):
            lp = params["layers"][l]
            window = int(windows[l])
            rk, rv = rings[l]
            bk, bv = draft_bufs[l]
            layer_k, layer_v = cache.layers[l]
            k_sc, v_sc = _layer_scales(cache, l)
            h = rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
            q, k, v = _qkv(cfg, lp["attn"], h, sin, cos)
            bk[:, :, j] = k[:, 0].to(bk.dtype)
            bv[:, :, j] = v[:, 0].to(bv.dtype)
            qf = q[:, 0].contiguous()                              # [B, N, H]
            if table is not None:
                acc_p, m_p, l_p = paged_decode_attention(
                    qf, layer_k, layer_v, table, last, q_positions=qpos, n_blocks=n_blocks,
                    scale=cfg.qscale, softcap=cfg.attn_softcap, window=window,
                    k_scales=k_sc, v_scales=v_sc,
                )
            else:
                acc_p, m_p, l_p = decode_attention(
                    qf, layer_k, layer_v, last, q_positions=qpos, scale=cfg.qscale,
                    softcap=cfg.attn_softcap, window=window, return_stats=True,
                    k_scales=k_sc, v_scales=v_sc,
                )
            qg = qf.reshape(B, K, G, H)
            acc_r, m_r, l_r = _ragged_stats(qg, rk, rv, offset, start, qpos, cfg.qscale,
                                            cfg.attn_softcap, window)
            acc_b, m_b, l_b = _ragged_stats(qg, bk, bv, count, pos, qpos, cfg.qscale,
                                            cfg.attn_softcap, window)
            acc, m, l_sum = _merge_stats(acc_p.reshape(B, K, G, H), m_p.reshape(B, K, G),
                                         l_p.reshape(B, K, G), acc_r, m_r, l_r)
            acc, _, l_sum = _merge_stats(acc, m, l_sum, acc_b, m_b, l_b)
            attn = acc / torch.clamp(l_sum, min=1e-30)[..., None]
            x = _layer_tail(cfg, lp, x, attn.to(x.dtype).reshape(B, 1, cfg.n_heads, H))
        h = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
        tok = torch.argmax(_unembed(cfg, params, h)[:, 0], dim=-1).to(torch.int32)
        drafts.append(tok)
    return torch.stack(drafts, dim=1)


def spec_block_forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: AnyCache,
    blk: torch.Tensor,       # [B, D] the block: the current token, then the drafts
    pvec: torch.Tensor,      # [B, D] their positions
    start: torch.Tensor,     # [B] slot length at chunk start (the prefix ends at start - 1)
    offset: torch.Tensor,    # [B] valid ring rows
    rings: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    Sb: Optional[int] = None,              # dense: keys of the bounded prefix panel
    table: Optional[torch.Tensor] = None,  # paged: the block table
    n_blocks: Optional[int] = None,        # paged: pages K3 visits
):
    """One verify block's forward for every slot, reading the cache and
    the ring and writing neither: the final-normed hidden states ``[B, D,
    E]`` and each layer's ``(k, v)`` of the block ``[B, K, D, H]``. The
    prefix goes through ``_spec_block_attn``: a bounded dense panel, or one
    K3 launch a layer with ``q_blocks=D`` and no ring."""
    B, D = blk.shape
    K, H = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // K
    windows = cfg.window_sizes()
    prefix_last = start - 1
    x = _embed(params, blk.long())
    sin, cos = rope_tables(pvec, H, cfg.rope_theta)
    new_blk = []
    for l, lp in enumerate(params["layers"]):
        window = int(windows[l])
        layer_k, layer_v = cache.layers[l]
        k_sc, v_sc = _layer_scales(cache, l)
        rk, rv = rings[l]
        h = rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
        q, k, v = _qkv(cfg, lp["attn"], h, sin, cos)                # [B, D, heads, H]
        blk_k = k.transpose(1, 2).to(rk.dtype)                      # [B, K, D, H]
        blk_v = v.transpose(1, 2).to(rv.dtype)
        qg = q.transpose(1, 2).reshape(B, K, G, D, H)
        if table is not None:
            stats = paged_decode_attention(
                qg.reshape(B, K * G * D, H).contiguous(), layer_k, layer_v, table, prefix_last,
                q_positions=pvec[:, 0], n_blocks=n_blocks, scale=cfg.qscale,
                softcap=cfg.attn_softcap, window=window, q_blocks=D, k_scales=k_sc,
                v_scales=v_sc,
            )
            attn = _spec_block_attn(qg, None, None, rk, rv, blk_k, blk_v, prefix_last, start,
                                    offset, pvec, cfg.qscale, cfg.attn_softcap, window,
                                    prefix_stats=stats)
        else:
            Sb = layer_k.shape[2] if Sb is None else Sb
            attn = _spec_block_attn(qg, layer_k[:, :, :Sb], layer_v[:, :, :Sb], rk, rv, blk_k,
                                    blk_v, prefix_last, start, offset, pvec, cfg.qscale,
                                    cfg.attn_softcap, window,
                                    kv_scales=None if k_sc is None else (k_sc[:, :, :Sb],
                                                                         v_sc[:, :, :Sb]))
        x = _layer_tail(cfg, lp, x, attn.to(x.dtype).reshape(B, D, cfg.n_heads, H))
        new_blk.append((blk_k, blk_v))
    return rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps), new_blk


@dataclass
class SpecBuffers:
    """What one speculative chunk variant writes besides the state, as
    ``ChunkBuffers`` for the plain chunk. The rings hold ``R = n·D`` rows
    plus one: a row no block keeps is written to row R, which nothing
    reads (torch's scatters have no ``mode="drop"``)."""

    rings: List[Tuple[torch.Tensor, torch.Tensor]]    # per layer [B, K, n·D + 1, H]
    drafts: List[Tuple[torch.Tensor, torch.Tensor]]   # per draft layer [B, K, D - 1, H]
    tokens: torch.Tensor  # [n·D, B] int32, block-major: row i·D + d is block i's row d
    valid: torch.Tensor   # [n·D, B] bool — the row was emitted

    @classmethod
    def create(cls, cfg: ModelConfig, n_slots: int, n_steps: int, draft_len: int,
               draft_layers: int, dtype: torch.dtype, device: torch.device) -> "SpecBuffers":
        R = n_steps * draft_len
        shape = (n_slots, cfg.n_kv_heads, draft_len - 1, cfg.head_dim)
        return cls(
            rings=new_rings(cfg, n_slots, R + 1, dtype, device),
            drafts=[(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))
                    for _ in range(draft_layers)],
            tokens=torch.zeros((R, n_slots), dtype=torch.int32, device=device),
            valid=torch.zeros((R, n_slots), dtype=torch.bool, device=device),
        )


def decode_chunk_spec(
    params: Dict[str, Any],
    cfg: ModelConfig,
    cache: AnyCache,
    dstate: DecodeState,
    sampling: SamplingState,
    history: torch.Tensor,   # [B, W + 1] token ids by position; column W is a sink
    n_steps: int,
    draft_len: int,          # D >= 2: the current token and D - 1 drafts a block
    prefix_bound: Optional[int] = None,   # keys the prefix read covers (default all)
    table: Optional[torch.Tensor] = None,  # [B, max_pages] int32 — paged cache only
    draft_layers: int = 0,   # > 0: the model drafts for the slots of draft_mode
    draft_mode: Optional[torch.Tensor] = None,  # [B] bool
    fused_epilogue: bool = False,
    bufs: Optional[SpecBuffers] = None,
) -> Tuple[torch.Tensor, torch.Tensor, AnyCache, DecodeState, SamplingState, torch.Tensor]:
    """The speculative chunk: ``n_steps`` verify blocks of ``[cur,
    drafts]`` a slot, with no host work (capturable, as ``decode_chunk``).

    Row 0 of each block goes through ``sample_core``, rows 1..D-1 through
    ``fused_verify_rows`` (or, with ``fused_epilogue``, all D rows through
    ``fused_greedy_epilogue``). A greedy slot emits its leading run of
    accepted drafts and one more token, a sampled slot one token; emission
    stops after an EOS, the budget or a full context, terminal included.
    Emitted rows advance the JSON coordinates and land in the history and
    the ring (the terminal or bonus token's K/V comes with the next
    block, as in the plain chunk). Every block runs: once every slot is
    done a block emits nothing and changes no state, so the result equals
    the JAX chunk's early-exit loop. With ``draft_layers``, the slots of
    ``draft_mode`` take the model's drafts (the caller runs this variant
    only when some slot is in that mode; JAX's ``lax.cond`` computes the
    same). The prefix is read through a ``prefix_bound``-key panel on the
    dense cache and through ``ceil(prefix_bound / P)`` pages by K3 on the
    paged cache.

    Returns ``(tokens [n·D, B], valid [n·D, B], cache, dstate, sampling,
    history)``, block-major; the state, the history and the cache are
    updated in place."""
    from pilottai_tpu_torch.engine.sampling import _advance_json, fused_verify_rows

    B = dstate.tokens.shape[0]
    D = int(draft_len)
    if D < 2:
        raise ValueError("draft_len < 2 is the plain decode_chunk")
    dev = dstate.tokens.device
    paged = isinstance(cache, PagedKVCache)
    if paged:
        if table is None:
            raise ValueError("paged decode needs the block table")
        S = table.shape[1] * cache.page_size
    else:
        S = cache.max_len
    Sb = S if prefix_bound is None else max(1, min(int(prefix_bound), S))
    n_blocks = -(-Sb // cache.page_size) if paged else None
    draft_layers = int(draft_layers) if draft_mode is not None else 0
    if bufs is None:
        bufs = SpecBuffers.create(cfg, B, n_steps, D, draft_layers, ring_dtype(cfg, cache), dev)
    R = n_steps * D
    if bufs.tokens.shape != (R, B) or len(bufs.drafts) < draft_layers:
        raise ValueError(f"spec buffers {tuple(bufs.tokens.shape)} for {n_steps} blocks of {D}")
    W = history.shape[1] - 1
    hist = history[:, :W]
    start = cache.lengths.clone()          # frozen during the chunk
    prefix_last = start - 1
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    tokens, done, budget = dstate.tokens, dstate.done, dstate.budget
    bidx = torch.arange(B, device=dev)[:, None]
    jj = torch.arange(D, device=dev)[None, :]

    for i in range(n_steps):
        active = ~done
        pos = start + offset
        drafts = _ngram_drafts(hist, pos, tokens, D - 1)
        if draft_layers:
            mdrafts = _model_drafts(
                params, cfg, draft_layers, tokens, pos, cache, bufs.rings, start, offset,
                prefix_last, bufs.drafts, table=table if paged else None, n_blocks=n_blocks,
            )
            drafts = torch.where(draft_mode[:, None], mdrafts, drafts)
        blk = torch.cat([tokens[:, None], drafts], dim=1)           # [B, D]
        pvec = pos[:, None] + jj
        h, new_blk = spec_block_forward(params, cfg, cache, blk, pvec, start, offset, bufs.rings,
                                        Sb=Sb, table=table if paged else None, n_blocks=n_blocks)
        if fused_epilogue:
            emitted = fused_greedy_epilogue(cfg, params, h)          # [B, D]
        else:
            logits = _unembed(cfg, params, h)                        # [B, D, V]
            before = dataclasses.replace(
                sampling, json_state=sampling.json_state.clone(),
                json_stack=sampling.json_stack.clone(), json_depth=sampling.json_depth.clone(),
            )
            tok0, sampling = sample_core(logits[:, 0], sampling, json_remaining=budget,
                                         json_gate=active.any())
            verify = fused_verify_rows(logits[:, 1:], blk[:, 1:], before, budget)
            emitted = torch.cat([tok0[:, None], verify], dim=1)

        # Leading-match acceptance, greedy slots only.
        match = (emitted[:, : D - 1] == blk[:, 1:]).to(torch.int32)
        accepted = torch.cumprod(match, dim=1).sum(dim=1)
        cand = torch.where(sampling.temperature <= 0.0, accepted + 1, torch.ones_like(accepted))
        # Truncate at EOS, budget or a full context, the terminal row kept.
        eos = sampling.eos_id[:, None]
        term = (((eos >= 0) & (emitted == eos)) | ((pvec + 1) >= (S - 1))
                | ((budget[:, None] - (jj + 1)) <= 0))
        before_term = torch.cat([torch.ones_like(term[:, :1], dtype=torch.int32),
                                 1 - term[:, :-1].to(torch.int32)], dim=1)
        no_term_before = torch.cumprod(before_term, dim=1).bool()
        emit = (jj < cand[:, None]) & no_term_before & active[:, None]
        n_emit = emit.to(torch.int32).sum(dim=1, dtype=torch.int32)
        done.logical_or_(active & (term & emit).any(dim=1))
        budget.sub_(n_emit)
        last_row = torch.clamp(n_emit - 1, min=0).long()[:, None]
        tokens.copy_(torch.where(active, torch.gather(emitted, 1, last_row)[:, 0], tokens))
        if not fused_epilogue:
            # Row 0 advanced inside sample_core; each further emitted row here.
            for j in range(1, D):
                _advance_json(sampling, emitted[:, j], emit[:, j])
        # History: emitted row j lives at pos + 1 + j; the rest go to the sink.
        hpos = pos[:, None] + 1 + jj
        hist_col = torch.where(emit & (hpos < W), hpos, torch.full_like(hpos, W))
        history[bidx, hist_col.long()] = emitted
        # Ring: block rows below n_emit (the current token and the accepted
        # drafts) are in the sequence; the others go to row R.
        rpos = torch.where(jj < n_emit[:, None], offset[:, None] + jj, torch.full_like(jj, R))
        for (rk, rv), (bk, bv) in zip(bufs.rings, new_blk):
            rk[bidx, :, rpos.long()] = bk.transpose(1, 2)
            rv[bidx, :, rpos.long()] = bv.transpose(1, 2)
        offset.add_(n_emit)
        bufs.tokens[i * D:(i + 1) * D].copy_(emitted.t())
        bufs.valid[i * D:(i + 1) * D].copy_(emit.t())

    ring_ks, ring_vs = [r[0] for r in bufs.rings], [r[1] for r in bufs.rings]
    if paged:
        cache = write_chunk_rows_paged(cache, table, ring_ks, ring_vs, start, offset)
    else:
        cache = write_chunk_rows(cache, ring_ks, ring_vs, start, offset)
    return bufs.tokens, bufs.valid, cache, dstate, sampling, history


def install_history(
    history: torch.Tensor,  # [B, W + 1]; column W is a sink
    slots: Sequence[int],   # [A] (out-of-range rows dropped)
    tokens: np.ndarray,     # [A, T] right-padded prompts
    lens: Sequence[int],    # [A] true lengths (0: padding row)
    first: torch.Tensor,    # [A] the prefill-sampled first tokens
) -> torch.Tensor:
    """Admission's history install, in place: each live row wiped, the
    prompt ids at positions ``[0, len)`` and the first generated token at
    ``len``."""
    B, W = history.shape[0], history.shape[1] - 1
    rows = [a for a, s in enumerate(slots) if int(lens[a]) > 0 and 0 <= int(s) < B]
    if not rows:
        return history
    dev = history.device
    sl = upload([int(slots[a]) for a in rows], torch.long, dev)
    n = upload([int(lens[a]) for a in rows], torch.long, dev)
    history[sl] = 0
    T = tokens.shape[1]
    col = torch.arange(T, device=dev)[None, :]
    wcol = torch.where((col < n[:, None]) & (col < W), col, torch.full_like(col, W))
    history[sl[:, None], wcol] = upload(np.asarray(tokens)[rows], torch.int32, dev)
    history[sl, torch.clamp(n, max=W - 1)] = first[upload(rows, torch.long, dev)].to(torch.int32)
    return history


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
    history: Optional[torch.Tensor] = None,  # [B, W + 1] — speculative decoding's history
):
    """The whole admission path — prefill forward (kernel K1), batched
    cache write, sampler install, first-token sample, decode-state
    install, and with ``history`` its install (``install_history``, in
    place). Returns ``(cache, dstate, sampling, first_tokens [A])``."""
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
    if history is not None:
        install_history(history, slots, tokens, lens, first)
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


def _chain_layer(cache: PagedKVCache, chain: torch.Tensor,
                 dtype: Optional[torch.dtype] = None):
    """``prefix_layer`` of a page chain: layer l's chain pages gathered into
    ``[K, len(chain)·P, H]`` panels (a transient copy per layer); int8
    pages are dequantized to ``dtype`` (the compute dtype) on the way out,
    and the pages themselves stay as they are."""
    if cache.scales is not None and dtype is None:
        raise ValueError("an int8 chain needs the compute dtype to dequantize to")
    K, _, P, H = cache.layers[0][0].shape
    n = chain.shape[0] * P

    def layer(l: int):
        k_pool, v_pool = cache.layers[l]
        pk, pv = k_pool[:, chain].reshape(K, n, H), v_pool[:, chain].reshape(K, n, H)
        if cache.scales is not None:
            k_sc, v_sc = cache.scales[l]
            pk = dequantize_kv(pk, k_sc[:, chain].reshape(K, n), dtype)
            pv = dequantize_kv(pv, v_sc[:, chain].reshape(K, n), dtype)
        return pk, pv

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
        params, cfg, _chain_layer(cache, chain, cfg.dtype), int(prefix_len),
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
    history: Optional[torch.Tensor] = None,     # [B, W + 1] — speculative decoding only
    full_tokens: Optional[np.ndarray] = None,   # [A, Tf] the whole prompts, for the history
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
        params, cfg, _chain_layer(cache, chain, cfg.dtype), prefix_len,
        upload(tail_tokens, torch.long, dev), upload(tail_lens, torch.int32, dev),
    )
    cache = write_prompts_paged(cache, upload(page_rows, torch.int32, dev), ks, vs,
                                tail_lens, pos_offset=prefix_len)
    cache = install_lengths(
        cache, slots, [prefix_len + n if n > 0 else 0 for n in tail_lens]
    )
    dstate, sampling, first = _admit_rows(logits, dstate, sampling, meta_i32, meta_f32)
    if history is not None:
        install_history(history, slots, full_tokens,
                        [prefix_len + n if n > 0 else 0 for n in tail_lens], first)
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
    history: Optional[torch.Tensor] = None,     # [B, W + 1] — speculative decoding only
    full_tokens: Optional[np.ndarray] = None,   # [A, Tf] the whole prompts, for the history
):
    """Admission with a cached prefix on the dense cache: copy the entry's
    panels into each slot's ``[0, prefix_len)``, prefill only the tails
    against them and write each tail at ``prefix_len``, then sample and
    install as ``admit_group`` does; an exact repeat is a one-token tail.
    The tails read the entry in the compute dtype. An int8 cache's entry is
    fp32 (``export_prefix``) and is quantized from those fp32 values on
    install, never from a cast, which gives back the exported bytes.
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
        n = len(rows)
        for l, (kc, vc) in enumerate(cache.layers):
            pk, pv = prefix_ks[l][:, :prefix_len], prefix_vs[l][:, :prefix_len]
            tk, tv = ks[l][r].transpose(1, 2), vs[l][r].transpose(1, 2)  # [n, K, Tt, H]
            if cache.scales is not None:
                (pk, pk_s), (pv, pv_s) = quantize_kv(pk), quantize_kv(pv)
                (tk, tk_s), (tv, tv_s) = quantize_kv(tk), quantize_kv(tv)
                ksc, vsc = cache.scales[l]
                ksc[sl, :, :prefix_len] = pk_s[None].expand(n, *pk_s.shape)
                vsc[sl, :, :prefix_len] = pv_s[None].expand(n, *pv_s.shape)
                ksc[sl, :, prefix_len:prefix_len + Tt] = tk_s
                vsc[sl, :, prefix_len:prefix_len + Tt] = tv_s
            kc[sl, :, :prefix_len] = pk[None].to(kc.dtype).expand(n, *pk.shape)
            vc[sl, :, :prefix_len] = pv[None].to(vc.dtype).expand(n, *pv.shape)
            kc[sl, :, prefix_len:prefix_len + Tt] = tk.to(kc.dtype)
            vc[sl, :, prefix_len:prefix_len + Tt] = tv.to(vc.dtype)
        cache.lengths[sl] = upload([prefix_len + tail_lens[a] for a in rows], torch.int32, dev)
    dstate, sampling, first = _admit_rows(logits, dstate, sampling, meta_i32, meta_f32)
    if history is not None:
        install_history(history, [int(x) for x in meta_i32[AI_SLOT]], full_tokens,
                        [prefix_len + n if n > 0 else 0 for n in tail_lens], first)
    return cache, dstate, sampling, first


def export_prefix(cache: KVCache, slot: int, p_bucket: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's first ``p_bucket`` cache rows as stacked ``[L, K,
    p_bucket, H]`` copies (a prefix-store entry's payload): in the cache
    dtype, or dequantized in fp32 when the cache is int8 (a bf16 entry
    would quantize again to slightly different bytes). Enqueued right after
    the admission that wrote them, on the same stream, so the rows hold
    exactly the prompt's K/V."""
    def rows(i: int) -> torch.Tensor:   # i = 0: keys, 1: values
        out = []
        for l, pair in enumerate(cache.layers):
            t = pair[i][slot, :, :p_bucket]
            if cache.scales is not None:
                t = dequantize_kv(t, cache.scales[l][i][slot, :, :p_bucket], torch.float32)
            out.append(t)
        return torch.stack(out)

    return rows(0), rows(1)
