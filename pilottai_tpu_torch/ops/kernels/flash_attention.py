"""Kernel K1: causal GQA flash attention, forward.

Replaces ``pilottai_tpu/ops/pallas/flash_attention.py:_flash_kernel``
(via ``_fwd_impl``; entry points ``flash_attention`` and
``flash_attention_with_lse``). The CUDA source is
``csrc/flash_fwd.cu``; its header says what bounds it on an H100 and
what the design does about it.

``flash_attention_with_lse`` is the wrapper: for a CUDA tensor it
launches the kernel (or raises), for a CPU tensor it runs
``flash_attention_plain``, the same function in plain PyTorch. The plain
version materializes the [B, N, T, S] logits and exists to test the
kernel against, not to serve. Unlike the TPU kernel there is no size
floor and no padding to blocks: every prefill goes through the kernel,
which masks its own ragged edges.

One deliberate difference from the TPU kernel: a query row with no
attendable key gives ``o = 0`` and ``lse = NEG_INF`` whatever the tiling
(the TPU kernel does so only when every block of the row was skipped;
otherwise such a row, which no caller reads, holds an average of V).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pilottai_tpu_torch.ops.attention import NEG_INF, prefill_mask

#: Kernel launches since the last reset (``chip_smoke.py`` reads it to show
#: the main path went through the kernel).
launches = 0

SOURCE = "pilottai_tpu_torch/csrc/flash_fwd.cu"
REPLACES = "pilottai_tpu/ops/pallas/flash_attention.py:57"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_positions: torch.Tensor, kv_positions: torch.Tensor, valid: torch.Tensor,
    window: int = 0, scale: Optional[float] = None, softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: returns ``(o [B,T,N,H], lse [B,T,N] fp32)``."""
    B, T, N, H = q.shape
    _, S, K, _ = k.shape
    G = N // K
    scale = scale if scale is not None else H**-0.5
    qg = q.reshape(B, T, K, G, H).float()
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    mask = prefill_mask(q_positions, kv_positions, valid, window)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    live = m > NEG_INF / 2
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype).float(), v.float())
    l_t = l[..., 0].permute(0, 3, 1, 2)[..., None]                    # [B,T,K,G,1]
    o = torch.where(l_t > 0, pv / l_t.clamp_min(1e-30), torch.zeros_like(pv))
    lse = torch.where(
        l > 0, m + torch.log(l.clamp_min(1e-30)), torch.full_like(l, NEG_INF)
    )[..., 0].permute(0, 3, 1, 2).reshape(B, T, N)
    return o.reshape(B, T, N, H).to(q.dtype), lse


def flash_attention_with_lse(
    q: torch.Tensor,             # [B, T, N, H]
    k: torch.Tensor,             # [B, S, K, H]
    v: torch.Tensor,             # [B, S, K, H]
    q_positions: torch.Tensor,   # [B, T] absolute positions
    kv_positions: torch.Tensor,  # [B, S]
    valid: torch.Tensor,         # [B] valid kv length (index bound)
    window: int = 0,             # 0 = global attention
    scale: Optional[float] = None,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal GQA attention: attend iff kv_pos <= q_pos, kv index < valid
    and (window <= 0 or q_pos - kv_pos < window). Returns ``(o
    [B,T,N,H], lse [B,T,N] fp32)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_positions, kv_positions, valid, window, scale, softcap
        )
    B, T, N, H = q.shape
    _, S, K, _ = k.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if H not in _HEAD_DIMS or k.shape != (B, S, K, H) or v.shape != k.shape or N % K:
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must start 16-byte aligned")
    qpos = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    kpos = kv_positions.to(device=q.device, dtype=torch.int32).contiguous()
    val = valid.to(device=q.device, dtype=torch.int32).contiguous()
    if qpos.shape != (B, T) or kpos.shape != (B, S) or val.shape != (B,):
        raise ValueError("flash_attention: positions must be [B,T]/[B,S] and valid [B]")
    scale = scale if scale is not None else H**-0.5
    o = torch.empty_like(q)
    lse = torch.empty((B, N, T), device=q.device, dtype=torch.float32)

    from pilottai_tpu_torch.ops.kernels.build import load_library

    lib = _bind(load_library("flash_fwd"))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.pt_flash_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qpos.data_ptr(), kpos.data_ptr(), val.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, T, S, N, K, H, int(window), float(scale), float(softcap), stream,
    )
    if status != 0:
        raise RuntimeError(f"flash_fwd launch failed: {lib.pt_error_string(status).decode()}")
    global launches
    launches += 1
    return o, lse.transpose(1, 2)


def flash_attention(q, k, v, q_positions, kv_positions, valid, window=0,
                    scale=None, softcap=0.0) -> torch.Tensor:
    """``flash_attention_with_lse`` without the lse: [B, T, N, H]."""
    return flash_attention_with_lse(
        q, k, v, q_positions, kv_positions, valid, window, scale, softcap
    )[0]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.pt_flash_fwd
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, P]
        fn.restype = I
        lib.pt_error_string.argtypes = [I]
        lib.pt_error_string.restype = ctypes.c_char_p
    return lib
