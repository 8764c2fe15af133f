"""Kernels K1 (causal GQA flash attention, forward) and K4, K5 (its
backward).

K1 replaces ``pilottai_tpu/ops/pallas/flash_attention.py:_flash_kernel``
(via ``_fwd_impl``; entry points ``flash_attention`` and
``flash_attention_with_lse``); its CUDA source is ``csrc/flash_fwd.cu``.
K4 replaces ``_bwd_dq_kernel`` (``csrc/flash_bwd_dq.cu``) and K5
``_bwd_dkv_kernel`` (``csrc/flash_bwd_dkv.cu``), which the TPU package
reaches through ``_bwd_impl`` and the ``custom_vjp`` rules; their head_dim
256 instantiations are libraries of their own (``csrc/flash_bwd_dq_h256.cu``,
``csrc/flash_bwd_dkv_h256.cu``), which nvcc builds in parallel with the
others. Each source's header says what bounds it on an H100 and what the
design does about it.

``flash_attention_fwd`` and ``flash_attention_bwd`` are the wrappers: for
CUDA tensors they launch the kernels (or raise), for CPU tensors they run
``flash_attention_plain`` and ``flash_attention_bwd_plain``, the same
functions in plain PyTorch. The plain versions materialize the
[B, N, T, S] logits and exist to test the kernels against, not to serve
or train; ``flash_attention_bwd_tiled_plain`` walks the backward tile by
tile with the kernels' tile rule (``tile_bounds``, ``tile_rule``), for
the CPU tests of that plan. Unlike the TPU kernels there is no size floor and no padding
to blocks (``_pad_to_blocks`` is not carried): every kernel masks its own
ragged edges.

``FlashAttention`` is the ``torch.autograd.Function`` over them, the
counterpart of the TPU package's ``custom_vjp``: its forward is K1 and
saves ``q, k, v, o, lse``; its backward runs K4 and K5. The public
``flash_attention_with_lse`` and ``flash_attention`` go through it only
when autograd needs a gradient, so serving launches K1 alone, as before.

One deliberate difference from the TPU kernel: a query row with no
attendable key gives ``o = 0`` and ``lse = NEG_INF`` whatever the tiling
(the TPU kernel does so only when every block of the row was skipped;
otherwise such a row, which no caller reads, holds an average of V). Its
gradients are 0: p is 0 wherever the row's lse is NEG_INF.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pilottai_tpu_torch.ops.attention import NEG_INF, prefill_mask

#: Kernel launches since the last reset (``chip_smoke.py`` reads them to
#: show the main path went through the kernels): K1, K4 and K5.
launches = 0
launches_dq = 0
launches_dkv = 0

SOURCE = "pilottai_tpu_torch/csrc/flash_fwd.cu"
REPLACES = "pilottai_tpu/ops/pallas/flash_attention.py:57"
SOURCE_DQ = "pilottai_tpu_torch/csrc/flash_bwd_dq.cu"
REPLACES_DQ = "pilottai_tpu/ops/pallas/flash_attention.py:202"
SOURCE_DKV = "pilottai_tpu_torch/csrc/flash_bwd_dkv.cu"
REPLACES_DKV = "pilottai_tpu/ops/pallas/flash_attention.py:274"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)  # K1, K4 and K5


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


def tile_rule(q_lo: int, q_hi: int, k_lo: int, k_hi: int, window: int = 0) -> Tuple[bool, bool]:
    """The kernels' tile test from position bounds alone, as
    ``csrc/hopper.cuh:tile_live`` and ``tile_full`` make it: ``(live,
    full)`` for a (q tile, kv tile) whose real rows' positions span
    ``[q_lo, q_hi]`` and real keys' ``[k_lo, k_hi]``. ``live`` is False
    only when no pair can attend (the kernel skips the tile); ``full`` is
    True only when every pair attends (the kernel masks nothing there,
    provided the tile also lies below ``valid[b]``)."""
    live = k_lo <= q_hi and (window <= 0 or q_lo - k_hi < window)
    full = k_hi <= q_lo and (window <= 0 or q_hi - k_lo < window)
    return live, full


def tile_bounds_test(q_pos, kv_pos, window: int = 0) -> Tuple[bool, bool]:
    """``tile_rule`` on the positions of a tile's real rows and keys.
    Positions need not be monotone: the test is conservative for any
    positions and exact for runs of consecutive ones."""
    return tile_rule(min(q_pos), max(q_pos), min(kv_pos), max(kv_pos), window)


_INT_MAX, _INT_MIN = 2**31 - 1, -(2**31)


def tile_bounds(positions: torch.Tensor, block: int,
                limit: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``tile_bounds_kernel`` (``csrc/hopper.cuh``): the lowest and
    highest position in each tile of ``block`` rows of ``positions
    [B, L]``, over the rows below ``limit[b]`` (``valid``; None = L), as
    two int64 ``[B, ceil(L / block)]``; a tile with no such row gets
    (INT_MAX, INT_MIN), which no tile test calls live. K4 reduces the keys
    this way (with ``valid``), K5 the queries (without)."""
    B, L = positions.shape
    n = -(-L // block)
    pos = torch.nn.functional.pad(positions.long(), (0, n * block - L))
    end = torch.full((B,), L, device=pos.device) if limit is None else limit.long().clamp(max=L)
    real = torch.arange(n * block, device=pos.device)[None] < end[:, None]
    lo = torch.where(real, pos, _INT_MAX).reshape(B, n, block).amin(-1)
    hi = torch.where(real, pos, _INT_MIN).reshape(B, n, block).amax(-1)
    return lo, hi


def check_kernel_shapes(n_heads: int, n_kv_heads: int, head_dim: int,
                        backward: bool = False) -> None:
    """Raise ``ValueError`` for heads the CUDA kernels do not take: K1, and
    K4 and K5 (``backward``, named in the message), take any GQA grouping
    at head_dim 32, 64, 128 or 256."""
    if head_dim not in _HEAD_DIMS or n_kv_heads < 1 or n_heads % n_kv_heads:
        which = "K4 and K5 take" if backward else "K1 takes"
        raise ValueError(f"flash_attention: the CUDA kernel {which} head_dim in {_HEAD_DIMS} "
                         f"and whole query groups; got heads {n_heads}/{n_kv_heads}, "
                         f"head_dim {head_dim}")


def _check(name: str, q, k, v, extra=(), backward=False) -> None:
    """The kernels' common contract; raises on what they do not take."""
    B, T, N, H = q.shape
    _, S, K, _ = k.shape
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    check_kernel_shapes(N, K, H, backward)
    if k.shape != (B, S, K, H) or v.shape != k.shape:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    tensors = (q, k, v, *extra)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor operand must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every tensor operand must start 16-byte aligned")


def _index_args(q, q_positions, kv_positions, valid, S):
    B, T = q.shape[:2]
    qpos = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    kpos = kv_positions.to(device=q.device, dtype=torch.int32).contiguous()
    val = valid.to(device=q.device, dtype=torch.int32).contiguous()
    if qpos.shape != (B, T) or kpos.shape != (B, S) or val.shape != (B,):
        raise ValueError("flash_attention: positions must be [B,T]/[B,S] and valid [B]")
    return qpos, kpos, val


def flash_attention_fwd(
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
    """K1's wrapper, without autograd: ``(o [B,T,N,H], lse [B,T,N] fp32)``.
    For CUDA tensors the lse is a transposed view of the kernel's
    contiguous ``[B, N, T]`` rows."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_positions, kv_positions, valid, window, scale, softcap
        )
    _check("flash_attention", q, k, v)
    B, T, N, H = q.shape
    _, S, K, _ = k.shape
    qpos, kpos, val = _index_args(q, q_positions, kv_positions, valid, S)
    scale = scale if scale is not None else H**-0.5
    o = torch.empty_like(q)
    lse = torch.empty((B, N, T), device=q.device, dtype=torch.float32)
    # The per-(batch row, kv tile) position bounds that K1's first launch
    # writes, in both dtypes: tiles of 32 keys, or 16 in the fp32 body at
    # head_dim 256.
    bounds = torch.empty((B, 2 * -(-S // 16)), device=q.device, dtype=torch.int32)

    from pilottai_tpu_torch.ops.kernels.build import load_library

    lib = _bind(load_library("flash_fwd"), "pt_flash_fwd", 9)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.pt_flash_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qpos.data_ptr(), kpos.data_ptr(), val.data_ptr(), bounds.data_ptr(), o.data_ptr(),
        lse.data_ptr(),
        B, T, S, N, K, H, int(window), float(scale), float(softcap), stream,
    )
    if status != 0:
        raise RuntimeError(f"flash_fwd launch failed: {lib.pt_error_string(status).decode()}")
    global launches
    launches += 1
    return o, lse.transpose(1, 2)


def _delta(o: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """``rowsum(dO * O) - dlse`` in fp32, ``[B, N, T]`` contiguous — computed
    outside the kernels, as ``_bwd_impl`` does (a nonzero lse cotangent
    shifts delta: d lse_i / d s_ij = p_ij)."""
    delta = (do.float() * o.float()).sum(dim=-1)                    # [B, T, N]
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_positions: torch.Tensor, kv_positions: torch.Tensor, valid: torch.Tensor,
    window: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    dlse: Optional[torch.Tensor] = None, scale: Optional[float] = None,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4 and K5: ``(dq in q's dtype, dk fp32, dv fp32)`` for
    the cotangents ``do [B,T,N,H]`` and ``dlse [B,T,N]`` (None = 0) of
    K1's ``(o, lse [B,T,N])``. It rounds where the kernels round: s from
    the input dtype's products, p to v's dtype for dv, ds to k's dtype for
    dq and to q's dtype for dk."""
    B, T, N, H = q.shape
    _, S, K, _ = k.shape
    G = N // K
    scale = scale if scale is not None else H**-0.5
    delta = _delta(o, do, dlse).reshape(B, K, G, T, 1)
    lse = lse.reshape(B, T, K, G).permute(0, 2, 3, 1)[..., None].float()   # [B,K,G,T,1]
    qg = q.reshape(B, T, K, G, H)
    dog = do.reshape(B, T, K, G, H)
    s = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = t * softcap
    mask = prefill_mask(q_positions, kv_positions, valid, window)[:, None, None]
    mask = mask & (lse > NEG_INF / 2)
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    del s
    dv = torch.einsum("bkgts,btkgh->bskh", p.to(v.dtype).float(), dog.to(v.dtype).float())
    dp = torch.einsum("btkgh,bskh->bkgts", dog.float(), v.float())
    ds = p * (dp - delta)
    del p, dp
    if softcap > 0.0:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bkgts,bskh->btkgh", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bkgts,btkgh->bskh", ds.to(q.dtype).float(), qg.float()) * scale
    return dq.reshape(B, T, N, H).to(q.dtype), dk, dv


def flash_attention_bwd_tiled_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_positions: torch.Tensor, kv_positions: torch.Tensor, valid: torch.Tensor,
    window: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    dlse: Optional[torch.Tensor] = None, scale: Optional[float] = None,
    softcap: float = 0.0, block_q: int = 64, block_k: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_attention_bwd_plain`` walked tile by tile as the bf16 K4
    and K5 (and the fp32 K5) walk it, for the tests: each (q tile, kv tile) below ``valid[b]``
    is skipped, taken whole (no pair mask) or masked pair by pair, from the
    bounds ``tile_bounds`` gives and the rule ``tile_rule`` states; a tile
    is taken whole only if it also lies below ``valid[b]``. A row whose lse
    is NEG_INF gets p = 0 in every tile. Same rounding points as the plain
    version."""
    B, T, N, H = q.shape
    _, S, K, _ = k.shape
    G = N // K
    scale = scale if scale is not None else H**-0.5
    delta = _delta(o, do, dlse).reshape(B, K, G, T)
    lse = lse.reshape(B, T, K, G).permute(0, 2, 3, 1).float()          # [B,K,G,T]
    qg = q.reshape(B, T, K, G, H)
    dog = do.reshape(B, T, K, G, H)
    q_lo, q_hi = tile_bounds(q_positions, block_q)
    k_lo, k_hi = tile_bounds(kv_positions, block_k, valid)
    dq = torch.zeros(B, T, K, G, H, device=q.device)
    dk = torch.zeros(B, S, K, H, device=q.device)
    dv = torch.zeros_like(dk)
    for b in range(B):
        kv_end = min(S, int(valid[b]))
        for i in range(-(-T // block_q)):
            t0, t1 = i * block_q, min(T, (i + 1) * block_q)
            qp = q_positions[b, t0:t1, None].long()
            for j in range(-(-kv_end // block_k)):
                j0, j1 = j * block_k, min(kv_end, (j + 1) * block_k)
                live, full = tile_rule(int(q_lo[b, i]), int(q_hi[b, i]), int(k_lo[b, j]),
                                       int(k_hi[b, j]), window)
                if not live:
                    continue
                qt, dot = qg[b, t0:t1].float(), dog[b, t0:t1]
                kt, vt = k[b, j0:j1], v[b, j0:j1]
                s = torch.einsum("tkgh,skh->kgts", qt, kt.float()) * scale
                if softcap > 0.0:
                    th = torch.tanh(s / softcap)
                    s = th * softcap
                lse_t = lse[b, :, :, t0:t1, None]
                ok = lse_t > NEG_INF / 2
                if not (full and (j + 1) * block_k <= kv_end):
                    kp = kv_positions[b, None, j0:j1].long()
                    ok = ok & (kp <= qp) & ((qp - kp < window) if window > 0 else True)
                p = torch.where(ok, torch.exp(s - lse_t), torch.zeros_like(s))
                dp = torch.einsum("tkgh,skh->kgts", dot.float(), vt.float())
                ds = p * (dp - delta[b, :, :, t0:t1, None])
                if softcap > 0.0:
                    ds = ds * (1.0 - th * th)
                dq[b, t0:t1] += torch.einsum("kgts,skh->tkgh", ds.to(k.dtype).float(), kt.float())
                dk[b, j0:j1] += torch.einsum("kgts,tkgh->skh", ds.to(q.dtype).float(), qt)
                dv[b, j0:j1] += torch.einsum("kgts,tkgh->skh", p.to(v.dtype).float(),
                                             dot.to(v.dtype).float())
    return (dq * scale).reshape(B, T, N, H).to(q.dtype), dk * scale, dv


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_positions: torch.Tensor, kv_positions: torch.Tensor, valid: torch.Tensor,
    window: int, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    dlse: Optional[torch.Tensor] = None, scale: Optional[float] = None,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 and K5's wrapper: ``(dq in q's dtype, dk fp32, dv fp32)``, the
    TPU ``_bwd_impl`` before its final cast. ``lse`` is K1's ``[B,T,N]``
    (a view of its ``[B,N,T]`` rows is read in place); ``dlse`` None
    means a zero lse cotangent."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, q_positions, kv_positions, valid, window, o, lse, do, dlse, scale, softcap
        )
    from pilottai_tpu_torch.ops.kernels.build import build_libraries

    H = q.shape[-1]
    # A cold start compiles both at once.
    build_libraries([bwd_library("flash_bwd_dq", H), bwd_library("flash_bwd_dkv", H)])
    ops = bwd_operands(q, k, v, q_positions, kv_positions, valid, window, o, lse, do, dlse,
                       scale, softcap)
    return (flash_bwd_dq(ops), *flash_bwd_dkv(ops))


def bwd_operands(q, k, v, q_positions, kv_positions, valid, window, o, lse, do,
                 dlse=None, scale=None, softcap=0.0) -> dict:
    """What K4 and K5 read, checked and laid out for them: ``do``
    contiguous, lse rows and delta fp32 ``[B, N, T]``, int32 positions,
    and the int32 scratch in which a kernel's first launch puts its tile
    bounds (K4's per kv tile, K5's per q tile; one after the other on the
    stream, so they share it; sized for the smallest tile, K4's 16 keys in
    fp32 at head_dim 256)."""
    do = do.contiguous()
    lse_rows = lse.transpose(1, 2).contiguous()                       # [B, N, T]
    delta = _delta(o, do, dlse)
    _check("flash_attention_bwd", q, k, v, (do, lse_rows, delta), backward=True)
    if do.shape != q.shape or do.dtype != q.dtype or lse_rows.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: do must match q in shape and dtype, and lse "
                         "must be fp32 [B,T,N]")
    B, T = q.shape[:2]
    S = k.shape[1]
    qpos, kpos, val = _index_args(q, q_positions, kv_positions, valid, S)
    bounds = torch.empty((B, 2 * -(-max(T, S) // 16)), device=q.device, dtype=torch.int32)
    return dict(q=q, k=k, v=v, do=do, lse=lse_rows, delta=delta, qpos=qpos, kpos=kpos,
                valid=val, bounds=bounds, window=int(window),
                scale=float(scale if scale is not None else q.shape[-1] ** -0.5),
                softcap=float(softcap))


def bwd_library(name: str, head_dim: int) -> str:
    """The library that holds kernel ``name`` (``flash_bwd_dq`` or
    ``flash_bwd_dkv``) at ``head_dim``: its ``_h256`` build at 256."""
    return f"{name}_h256" if head_dim == 256 else name


def _launch_bwd(name: str, ops: dict, outs) -> None:
    from pilottai_tpu_torch.ops.kernels.build import load_library

    q, k = ops["q"], ops["k"]
    lib = _bind(load_library(bwd_library(name, q.shape[-1])), f"pt_{name}", 10 + len(outs))
    B, T, N, H = q.shape
    _, S, K, _ = k.shape
    ptrs = [ops[key].data_ptr() for key in
            ("q", "k", "v", "do", "lse", "delta", "qpos", "kpos", "valid", "bounds")]
    status = getattr(lib, f"pt_{name}")(
        _DTYPES[q.dtype], *ptrs, *(t.data_ptr() for t in outs), B, T, S, N, K, H,
        ops["window"], ops["scale"], ops["softcap"], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"{name} launch failed: {lib.pt_error_string(status).decode()}")


def flash_bwd_dq(ops: dict) -> torch.Tensor:
    """Launch K4 on ``bwd_operands``: dq in q's dtype."""
    dq = torch.empty_like(ops["q"])
    _launch_bwd("flash_bwd_dq", ops, (dq,))
    global launches_dq
    launches_dq += 1
    return dq


def flash_bwd_dkv(ops: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on ``bwd_operands``: dk and dv in fp32."""
    k = ops["k"]
    dk = torch.empty(k.shape, device=k.device, dtype=torch.float32)
    dv = torch.empty_like(dk)
    _launch_bwd("flash_bwd_dkv", ops, (dk, dv))
    global launches_dkv
    launches_dkv += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward, K4 and K5 backward: the TPU package's ``_flash_lse``
    with its ``custom_vjp`` rules. Differentiable in q, k and v,
    including through the lse."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, valid, window, scale, softcap):
        # Module-level lookups, so a caller may route both directions
        # through the plain versions (chip_smoke.py does, to compare).
        o, lse = flash_attention_fwd(q, k, v, q_positions, kv_positions, valid, window,
                                     scale, softcap)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, valid, o, lse)
        ctx.args = (window, scale, softcap)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, q_positions, kv_positions, valid, o, lse = ctx.saved_tensors
        window, scale, softcap = ctx.args
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(q, k, v, q_positions, kv_positions, valid, window,
                                         o, lse, do, dlse, scale, softcap)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None, None


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
    [B,T,N,H], lse [B,T,N] fp32)``, differentiable in q, k and v (through
    ``FlashAttention``) when autograd asks for it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_positions, kv_positions, valid, window,
                                    scale, softcap)
    return flash_attention_fwd(q, k, v, q_positions, kv_positions, valid, window, scale,
                               softcap)


def flash_attention(q, k, v, q_positions, kv_positions, valid, window=0,
                    scale=None, softcap=0.0) -> torch.Tensor:
    """``flash_attention_with_lse`` without the lse: [B, T, N, H]."""
    return flash_attention_with_lse(
        q, k, v, q_positions, kv_positions, valid, window, scale, softcap
    )[0]


def _bind(lib: ctypes.CDLL, name: str, n_ptrs: int) -> ctypes.CDLL:
    """Set the argument types of ``name``: the dtype code, ``n_ptrs``
    tensor pointers (inputs, the three index arrays, any scratch, outputs),
    the seven sizes and window, scale, softcap and the stream."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I] + [P] * n_ptrs + [I] * 7 + [F, F, P]
        fn.restype = I
        lib.pt_error_string.argtypes = [I]
        lib.pt_error_string.restype = ctypes.c_char_p
    return lib
