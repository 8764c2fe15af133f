"""Kernel K2: one-token GQA attention over the dense K-major KV cache.

Replaces ``pilottai_tpu/ops/pallas/decode_attention.py:_decode_kernel``
(entry point ``decode_attention``). In the decode chunk it computes the
per-step read of the cache prefix as online-softmax statistics
``(acc, m, l)`` — what the JAX engine's dense default computes with the
XLA function ``engine/decode.py:_prefix_stats_dense`` and what its
Pallas kernel computes with ``return_stats=True``. The CUDA source is
``csrc/decode_attention.cu``; its header says what bounds it on an H100
(the cache bytes) and what the design does about it.

For a CUDA tensor the wrapper launches the kernel (or raises); for a CPU
tensor it runs ``decode_attention_plain``. The normalized form
(``return_stats=False``) divides the kernel's statistics in the wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pilottai_tpu_torch.ops.attention import NEG_INF

#: Kernel launches since the last reset (``chip_smoke.py`` reads it).
launches = 0

SOURCE = "pilottai_tpu_torch/csrc/decode_attention.cu"
REPLACES = "pilottai_tpu/ops/pallas/decode_attention.py:51"
MAX_GROUP = 8  # query heads per kv head the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    last_valid: torch.Tensor, q_positions: torch.Tensor,
    scale: float, softcap: float = 0.0, window: int = 0,
):
    """Plain PyTorch K2: ``(acc [B,N,H] fp32, m [B,N], l [B,N])``."""
    B, N, H = q.shape
    _, K, S, _ = k_cache.shape
    G = N // K
    qg = q.reshape(B, K, G, H).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, k_cache.float()) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    col = torch.arange(S, device=q.device)[None, None, None, :]
    mask = col <= last_valid.to(q.device)[:, None, None, None]
    if window > 0:
        mask &= (q_positions.to(q.device)[:, None, None, None] - col) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(m[..., None] > NEG_INF / 2, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bksh->bkgh", p.to(v_cache.dtype).float(), v_cache.float())
    return acc.reshape(B, N, H), m.reshape(B, N), l.reshape(B, N)


def decode_attention(
    q: torch.Tensor,            # [B, N, H] current-token queries
    k_cache: torch.Tensor,      # [B, K, S, H] K-major panels
    v_cache: torch.Tensor,      # [B, K, S, H]
    last_valid: torch.Tensor,   # [B] int — keys at s <= last_valid[b] attend (-1: none)
    q_positions: Optional[torch.Tensor] = None,  # [B] for the window; default last_valid
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: int = 0,
    return_stats: bool = False,
):
    """Attend iff s <= last_valid[b] and (window == 0 or q_positions[b] -
    s < window). Returns [B, N, H] in q's dtype, or with
    ``return_stats`` the unnormalized ``(acc fp32, m, l)`` triple."""
    B, N, H = q.shape
    _, K, S, _ = k_cache.shape
    scale = scale if scale is not None else H**-0.5
    if q_positions is None:
        q_positions = last_valid
    if q.device.type == "cpu":
        acc, m, l = decode_attention_plain(
            q, k_cache, v_cache, last_valid, q_positions, scale, softcap, window
        )
    else:
        acc, m, l = _launch(q, k_cache, v_cache, last_valid, q_positions, scale, softcap, window)
    if return_stats:
        return acc, m, l
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _launch(q, k_cache, v_cache, last_valid, q_positions, scale, softcap, window):
    B, N, H = q.shape
    _, K, S, _ = k_cache.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if k_cache.dtype not in _DTYPES or q.dtype != k_cache.dtype or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention: q and the cache must share float32 or bfloat16, "
                        f"got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if (H not in _HEAD_DIMS or k_cache.shape != (B, K, S, H) or v_cache.shape != k_cache.shape
            or N % K or N // K > MAX_GROUP):
        raise ValueError(f"decode_attention: unsupported shapes q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and the cache panels must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: the cache panels must start 16-byte aligned")
    last = last_valid.to(device=q.device, dtype=torch.int32).contiguous()
    qpos = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    if last.shape != (B,) or qpos.shape != (B,):
        raise ValueError("decode_attention: last_valid and q_positions must be [B]")
    acc = torch.empty((B, N, H), device=q.device, dtype=torch.float32)
    m = torch.empty((B, N), device=q.device, dtype=torch.float32)
    l = torch.empty((B, N), device=q.device, dtype=torch.float32)

    from pilottai_tpu_torch.ops.kernels.build import load_library

    lib = _bind(load_library("decode_attention"))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.pt_decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        last.data_ptr(), qpos.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, N, K, S, H, int(window), float(scale), float(softcap), stream,
    )
    if status != 0:
        raise RuntimeError(
            f"decode_attention launch failed: {lib.pt_error_string(status).decode()}"
        )
    global launches
    launches += 1
    return acc, m, l


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.pt_decode_attention
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, P]
        fn.restype = I
        lib.pt_error_string.argtypes = [I]
        lib.pt_error_string.restype = ctypes.c_char_p
    return lib
