"""Transformer forward: prefill, the single-step decode reference and the
training forward (the port's counterpart of
``pilottai_tpu/models/transformer.py`` for the dense llama trunk).

Full-sequence attention goes through kernel K1 (``ops/kernels/
flash_attention.py``) for every prompt and every training row — no size
gate, no fallback: on a CPU tensor the wrapper runs K1's plain version, on
a CUDA tensor the kernel; in training its backward runs K4 and K5. Every
weight matmul goes through ``models/qmatmul.py:qmatmul``: a plain weight
stays ``torch.matmul``, as the JAX package leaves it to XLA, and an int8
or int4 weight (``models/quant.py``, serving only) takes the quantized
product's kernel.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pilottai_tpu_torch.models.common import (
    ModelConfig,
    apply_rope,
    matmul_f32,
    rms_norm,
    rope_tables,
)
from pilottai_tpu_torch.models.qmatmul import qmatmul
from pilottai_tpu_torch.models.quant import has_quantized, is_quantized
from pilottai_tpu_torch.ops.attention import NEG_INF
from pilottai_tpu_torch.ops.kernels.flash_attention import flash_attention
from pilottai_tpu_torch.ops.kvcache import KVCache


def _mlp(lp: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU."""
    p = lp["mlp"]
    return qmatmul(F.silu(qmatmul(x, p["wg"])) * qmatmul(x, p["wu"]), p["wd"])


def _qkv(
    cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T, _ = x.shape
    q = qmatmul(x, p["wq"]).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = qmatmul(x, p["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = qmatmul(x, p["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _attn_out(cfg: ModelConfig, p: Dict[str, Any], attn: torch.Tensor) -> torch.Tensor:
    B, T = attn.shape[:2]
    return qmatmul(attn.reshape(B, T, cfg.q_dim), p["wo"])


def _embed(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


class LogitsHead(torch.autograd.Function):
    """The logits head ``x @ head`` on bf16 operands with an fp32 result
    (``matmul_f32``), with the backward ``jax.grad`` takes through the JAX
    package's ``dot_general(bf16, bf16, preferred_element_type=f32)``: two
    products of the fp32 cotangent against a bf16 operand, each converted
    to the operand's dtype. The cotangent is rounded to bf16 first, which
    is what XLA's default precision does to such a product on the TPU (one
    bf16 pass), and lets both products run on the tensor cores: the one
    rounding is the only difference from an fp32 cotangent. ``torch.mm``'s
    ``out_dtype`` overload has no derivative of its own, hence this
    Function."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, head)
        return matmul_f32(x, head)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, head = ctx.saved_tensors
        gb = g.to(head.dtype).reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dx = matmul_f32(gb, head.t()).to(x.dtype).reshape(x.shape)
        dhead = matmul_f32(x2.t(), gb).to(head.dtype)
        return dx, dhead


def _tensor_core_head(x: torch.Tensor, head: torch.Tensor) -> bool:
    """The head runs as ``LogitsHead`` on CUDA bf16 operands; elsewhere
    (the CPU, the fp32 paths) it keeps the fp32 form."""
    return x.is_cuda and x.dtype == torch.bfloat16 and head.dtype == torch.bfloat16


def _unembed(cfg: ModelConfig, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """fp32 logits, as the JAX package's ``qmatmul(x, head,
    preferred_element_type=jnp.float32)`` computes them: on CUDA the bf16
    operands go to the tensor cores with an fp32 result (``LogitsHead``),
    with no fp32 copy of the head; on the CPU and on the fp32 paths
    ``x.float() @ head.float()``, which gives the same values (every bf16
    product is exact in fp32) where a bf16 ``torch.matmul`` would round the
    logits to bf16. A quantized ``lm_head`` goes through ``qmatmul`` with an
    fp32 result, as in the JAX package."""
    head = params["lm_head"] if "lm_head" in params else params["embed"].t()
    if is_quantized(head):
        logits = qmatmul(x, head, preferred_element_type=torch.float32)
    elif _tensor_core_head(x, head):
        logits = LogitsHead.apply(x, head)
    else:
        logits = x.float() @ head.float()
    if cfg.logit_softcap > 0.0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _full_seq_block(
    cfg: ModelConfig,
    x: torch.Tensor,
    lp: Dict[str, Any],
    window: int,
    sin: torch.Tensor,
    cos: torch.Tensor,
    positions: torch.Tensor,  # [B, T]
    valid: torch.Tensor,      # [B]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One transformer block over a full sequence. Returns (x, k, v)."""
    h = rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
    q, k, v = _qkv(cfg, lp["attn"], h, sin, cos)
    attn = flash_attention(
        q, k, v, positions, positions, valid, window,
        scale=cfg.qscale, softcap=cfg.attn_softcap,
    )
    x = x + _attn_out(cfg, lp["attn"], attn)
    h = rms_norm(x, lp["ln2"]["scale"], cfg.rms_eps)
    return x + _mlp(lp, h), k, v


def forward_prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,     # [B, T] right-padded
    positions: torch.Tensor,  # [B, T] absolute positions
    valid: torch.Tensor,      # [B] true prompt lengths
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-prompt forward. Returns (logits [B, T, V] fp32, k, v) with k/v
    stacked ``[L, B, T, K, H]`` ready to insert into a ``KVCache``."""
    x = _embed(params, tokens)
    sin, cos = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    windows = cfg.window_sizes()
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for l, lp in enumerate(params["layers"]):
        x, k, v = _full_seq_block(cfg, x, lp, int(windows[l]), sin, cos, positions, valid)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    return _unembed(cfg, params, x), torch.stack(ks), torch.stack(vs)


def forward_decode(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] current token per slot
    cache: KVCache,        # written in place at cache.lengths
    active: torch.Tensor,  # [B] bool
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for every slot: the dense single-step *reference*
    (plain attention over the whole panel), which the chunked
    ``engine/decode.py:decode_chunk`` is tested against. Inactive slots
    run through the matmuls but neither write the cache nor advance."""
    B = tokens.shape[0]
    S = cache.max_len
    positions = cache.lengths.long()
    x = _embed(params, tokens[:, None])
    sin, cos = rope_tables(positions[:, None], cfg.head_dim, cfg.rope_theta)
    windows = cfg.window_sizes()
    G = cfg.n_heads // cfg.n_kv_heads
    live = torch.nonzero(active & (positions < S), as_tuple=True)[0]
    col = torch.arange(S, device=tokens.device)[None, None, None, :]
    pos_b = positions[:, None, None, None]
    for l, lp in enumerate(params["layers"]):
        layer_k, layer_v = cache.layers[l]
        h = rms_norm(x, lp["ln1"]["scale"], cfg.rms_eps)
        q, k_new, v_new = _qkv(cfg, lp["attn"], h, sin, cos)
        layer_k[live, :, positions[live]] = k_new[live, 0].to(layer_k.dtype)
        layer_v[live, :, positions[live]] = v_new[live, 0].to(layer_v.dtype)
        qg = q[:, 0].reshape(B, cfg.n_kv_heads, G, cfg.head_dim)
        s = torch.einsum("bkgh,bksh->bkgs", qg.float(), layer_k.float()) * cfg.qscale
        if cfg.attn_softcap > 0.0:
            s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
        mask = col <= pos_b
        if windows[l] > 0:
            mask &= (pos_b - col) < int(windows[l])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1).to(layer_v.dtype)
        attn = torch.einsum("bkgs,bksh->bkgh", w.float(), layer_v.float()).to(x.dtype)
        x = x + _attn_out(cfg, lp["attn"], attn.reshape(B, 1, cfg.n_heads, cfg.head_dim))
        h = rms_norm(x, lp["ln2"]["scale"], cfg.rms_eps)
        x = x + _mlp(lp, h)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    logits = _unembed(cfg, params, x)[:, 0]
    cache.lengths.copy_(torch.where(active, cache.lengths + 1, cache.lengths))
    return logits, cache


def forward_train(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,     # [B, T] right-padded
    positions: torch.Tensor,  # [B, T]
    valid: torch.Tensor,      # [B] true lengths
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward for training: ``(logits [B, T, V] fp32,
    moe_aux_loss)``, where the aux loss is 0 for the dense trunk.

    With ``remat=True`` each layer runs under ``torch.utils.checkpoint``:
    the backward recomputes the whole block, K1 included, instead of
    keeping T x L activations. The JAX package's policy
    (``dots_with_no_batch_dims_saveable``) also keeps the matmul outputs,
    so the numbers are the same and the memory and the time differ.

    Quantized weights are refused: quantization is for serving, and the
    JAX trainer never sees them."""
    if has_quantized(params):
        raise ValueError("forward_train: the parameters hold quantized (int8 or int4) weights; "
                         "quantization is for serving only, train on the dense weights")
    x = _embed(params, tokens)
    sin, cos = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    windows = cfg.window_sizes()
    for l, lp in enumerate(params["layers"]):
        args = (cfg, x, lp, int(windows[l]), sin, cos, positions, valid)
        if remat:
            x = checkpoint(_train_block, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _train_block(*args)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(cfg, params, x), aux


def _train_block(cfg, x, lp, window, sin, cos, positions, valid) -> torch.Tensor:
    return _full_seq_block(cfg, x, lp, window, sin, cos, positions, valid)[0]
