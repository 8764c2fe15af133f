"""Kernel K2: one-token GQA attention over the dense K-major KV cache.

Replaces ``pilottai_tpu/ops/pallas/decode_attention.py:_decode_kernel``
(entry point ``decode_attention``). In the decode chunk it computes the
per-step read of the cache prefix as online-softmax statistics
``(acc, m, l)`` — what the JAX engine's dense default computes with the
XLA function ``engine/decode.py:_prefix_stats_dense`` and what its
Pallas kernel computes with ``return_stats=True``. The CUDA source is
``csrc/decode_attention.cu``; its header says what bounds it on an H100
(the cache bytes, and at a decode step the latency of too few blocks) and
what the design does about it: each (kv head, slot)'s live keys are cut
into ``split_count`` splits by ``split_bounds``, each split a block of its
own, and the last split to finish merges them in split order, all in one
launch. The wrapper allocates the splits' scratch and keeps their arrival
counters.

An int8 cache (``engine_kv_quantize="int8"``) comes with its fp32
``k_scales`` and ``v_scales [B, K, S]``, and the kernel's int8 body computes
exactly ``_prefix_stats_dense`` with ``kv_scales``: each key's scale
multiplies its dot product before the soft-cap, and ``p · v_scale`` is
rounded to q's dtype before the PV product; q may be bf16 or fp32.

For a CUDA tensor the wrapper launches the kernel (or raises); for a CPU
tensor it runs ``decode_attention_plain``. The normalized form
(``return_stats=False``) divides the kernel's statistics in the wrapper.
``decode_attention_split_plain`` is the same function with the kernel's
split-and-merge algebra, for the tests.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from pilottai_tpu_torch.ops.attention import NEG_INF

#: Kernel launches since the last reset (``chip_smoke.py`` reads it).
launches = 0

SOURCE = "pilottai_tpu_torch/csrc/decode_attention.cu"
REPLACES = "pilottai_tpu/ops/pallas/decode_attention.py:51"
MAX_GROUP = 8  # query heads per kv head the kernel takes
TILE = 32  # keys a tile of the kernel's walk: splits are runs of whole tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8_DTYPES = {torch.float32: 2, torch.bfloat16: 3}  # by q's dtype
_HEAD_DIMS = (32, 64, 128)
# Per (device index, stream): the int32 arrival counters of the splits,
# zero between launches (the last split of each (kv head, slot) resets its
# own), and the device's SM count.
_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}
_sm_count: Dict[int, int] = {}


def split_count(B: int, n_kv_heads: int, S: int, n_sm: int) -> int:
    """Splits of each (kv head, slot)'s key range: enough blocks that the
    grid covers the ``n_sm`` SMs about four times, and no more splits than
    a panel of ``S`` keys has tiles. From the shapes alone: the host never
    reads ``last``."""
    return max(1, min(-(-4 * n_sm // (B * n_kv_heads)), -(-S // TILE)))


def split_bounds(last_valid, q_positions, window: int, S: int, n_split: int, z: int):
    """Keys ``[lo, hi]`` of split ``z`` of each slot, as the kernel's
    ``split_range`` computes them on the device: the live range
    ``[max(0, q_pos - window + 1) (0 without a window), min(last, S - 1)]``
    cut into ``n_split`` runs of whole ``TILE``-key tiles, each run as long
    as the longest (the last ones shorter or empty). ``lo > hi`` marks a
    split with no key. Elementwise over tensors of slots."""
    last = torch.as_tensor(last_valid).long()
    qpos = torch.as_tensor(q_positions).long()
    s_end = last.clamp(max=S - 1)
    s_begin = (qpos - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(s_end)
    n_keys = s_end - s_begin + 1
    n_tiles = (n_keys.clamp(min=0) + TILE - 1) // TILE
    per = (n_tiles + n_split - 1) // n_split
    lo = s_begin + z * per * TILE
    hi = torch.minimum(s_end, lo + per * TILE - 1)
    empty = (n_keys <= 0) | (z * per >= n_tiles)
    return torch.where(empty, 0, lo), torch.where(empty, -1, hi)


def _logits(q, k_cache, scale, softcap, k_scales):
    """Scaled (and soft-capped) logits ``[B, K, G, S]`` fp32: for an int8
    cache the key's scale multiplies the scaled dot product before the
    cap, as ``_prefix_stats_dense`` applies it."""
    B, N, H = q.shape
    K = k_cache.shape[1]
    qg = q.reshape(B, K, N // K, H).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, k_cache.float()) * scale
    if k_scales is not None:
        s = s * k_scales[:, :, None, :]
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    return s


def _pv(p, q_dtype, v_cache, v_scales):
    """``acc = Σ p·v`` fp32, p rounded to the cache dtype first; for an
    int8 cache ``p · v_scale`` rounded to q's dtype."""
    if v_scales is not None:
        p = (p * v_scales[:, :, None, :]).to(q_dtype)
    else:
        p = p.to(v_cache.dtype)
    return torch.einsum("bkgs,bksh->bkgh", p.float(), v_cache.float())


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    last_valid: torch.Tensor, q_positions: torch.Tensor,
    scale: float, softcap: float = 0.0, window: int = 0,
    k_scales: Optional[torch.Tensor] = None, v_scales: Optional[torch.Tensor] = None,
):
    """Plain PyTorch K2: ``(acc [B,N,H] fp32, m [B,N], l [B,N])``."""
    B, N, H = q.shape
    _, K, S, _ = k_cache.shape
    s = _logits(q, k_cache, scale, softcap, k_scales)
    col = torch.arange(S, device=q.device)[None, None, None, :]
    mask = col <= last_valid.to(q.device)[:, None, None, None]
    if window > 0:
        mask &= (q_positions.to(q.device)[:, None, None, None] - col) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(m[..., None] > NEG_INF / 2, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = _pv(p, q.dtype, v_cache, v_scales)
    return acc.reshape(B, N, H), m.reshape(B, N), l.reshape(B, N)


def decode_attention_split_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    last_valid: torch.Tensor, q_positions: torch.Tensor,
    scale: float, softcap: float = 0.0, window: int = 0, n_split: int = 1,
    k_scales: Optional[torch.Tensor] = None, v_scales: Optional[torch.Tensor] = None,
):
    """Plain K2 with the kernel's algebra: split ``z`` of ``n_split`` gets
    its own ``(acc, m, l)`` over the keys ``split_bounds`` gives it, and the
    splits are merged in split order with ``m = max m_s`` and weights
    ``exp(m_s - m)`` (0 for a split with no key). Returns what
    ``decode_attention_plain`` returns."""
    B, N, H = q.shape
    _, K, S, _ = k_cache.shape
    s = _logits(q, k_cache, scale, softcap, k_scales)
    col = torch.arange(S, device=q.device)[None, :]
    parts = []
    for z in range(n_split):
        lo, hi = split_bounds(last_valid.to(q.device), q_positions.to(q.device), window, S,
                              n_split, z)
        own = ((col >= lo[:, None]) & (col <= hi[:, None]))[:, None, None, :]
        s_z = torch.where(own, s, torch.full_like(s, NEG_INF))
        m_z = s_z.amax(dim=-1)
        p = torch.where(m_z[..., None] > NEG_INF / 2, torch.exp(s_z - m_z[..., None]),
                        torch.zeros_like(s_z))
        acc_z = _pv(p, q.dtype, v_cache, v_scales)
        parts.append((acc_z, m_z, p.sum(dim=-1)))
    m = torch.stack([m_z for _, m_z, _ in parts]).amax(dim=0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(m)
    for acc_z, m_z, l_z in parts:
        w = torch.where(m_z > NEG_INF / 2, torch.exp(m_z - m), torch.zeros_like(m_z))
        acc = acc + w[..., None] * acc_z
        l = l + w * l_z
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
    k_scales: Optional[torch.Tensor] = None,  # [B, K, S] fp32 — int8 caches only
    v_scales: Optional[torch.Tensor] = None,
):
    """Attend iff s <= last_valid[b] and (window == 0 or q_positions[b] -
    s < window). Returns [B, N, H] in q's dtype, or with
    ``return_stats`` the unnormalized ``(acc fp32, m, l)`` triple."""
    B, N, H = q.shape
    _, K, S, _ = k_cache.shape
    scale = scale if scale is not None else H**-0.5
    if q_positions is None:
        q_positions = last_valid
    int8 = k_cache.dtype == torch.int8
    if (k_scales is None) != (v_scales is None) or (k_scales is None) == int8:
        raise ValueError("decode_attention: an int8 cache needs k_scales and v_scales, and only it")
    if q.device.type == "cpu":
        acc, m, l = decode_attention_plain(
            q, k_cache, v_cache, last_valid, q_positions, scale, softcap, window,
            k_scales, v_scales,
        )
    else:
        acc, m, l = _launch(q, k_cache, v_cache, last_valid, q_positions, scale, softcap, window,
                            k_scales, v_scales)
    if return_stats:
        return acc, m, l
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _launch(q, k_cache, v_cache, last_valid, q_positions, scale, softcap, window,
            k_scales=None, v_scales=None):
    B, N, H = q.shape
    _, K, S, _ = k_cache.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if k_scales is not None:
        if (q.dtype not in _INT8_DTYPES or k_cache.dtype != torch.int8
                or v_cache.dtype != torch.int8):
            raise TypeError(f"decode_attention: an int8 cache takes float32 or bfloat16 q, got "
                            f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
        if (k_scales.shape != (B, K, S) or v_scales.shape != k_scales.shape
                or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32
                or not (k_scales.is_contiguous() and v_scales.is_contiguous())
                or k_scales.device != q.device or v_scales.device != q.device):
            raise ValueError("decode_attention: scales must be contiguous fp32 [B, K, S] on q's "
                             "device")
        code = _INT8_DTYPES[q.dtype]
    elif k_cache.dtype not in _DTYPES or q.dtype != k_cache.dtype or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention: q and the cache must share float32 or bfloat16, "
                        f"got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    else:
        code = _DTYPES[q.dtype]
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
    dev = q.device
    acc = torch.empty((B, N, H), device=dev, dtype=torch.float32)
    m = torch.empty((B, N), device=dev, dtype=torch.float32)
    l = torch.empty((B, N), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    Z = split_count(B, K, S, _sm_count[dev.index])
    part = arrivals = None
    if Z > 1:
        # Each split's acc, m and l; and the arrival counters, zeroed once.
        part = torch.empty(B * K * Z * (N // K) * (H + 2), device=dev, dtype=torch.float32)
        arrivals = _arrivals.get((dev.index, stream))
        if arrivals is None or arrivals.numel() < B * K:
            arrivals = torch.zeros(B * K, device=dev, dtype=torch.int32)
            _arrivals[(dev.index, stream)] = arrivals

    from pilottai_tpu_torch.ops.kernels.build import load_library

    lib = _bind(load_library("decode_attention"))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = lib.pt_decode_attention(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scales),
        ptr(v_scales), last.data_ptr(), qpos.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        ptr(part), ptr(arrivals), B, N, K, S, H, Z, int(window), float(scale), float(softcap),
        stream,
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
        fn.argtypes = [I] + [P] * 12 + [I] * 7 + [F, F, P]
        fn.restype = I
        lib.pt_error_string.argtypes = [I]
        lib.pt_error_string.restype = ctypes.c_char_p
    return lib
