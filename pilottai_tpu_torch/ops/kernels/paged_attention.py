"""Kernel K3: ragged paged GQA decode attention through a block table.

Replaces ``pilottai_tpu/ops/pallas/paged_attention.py:_paged_kernel``
(entry point ``paged_decode_attention``). It returns the unnormalized
online-softmax statistics ``(acc, m, l)`` over each slot's live pages and,
when a ring is given, over the decode chunk's in-flight rows too, merged
as ``engine/decode.py:_merge_stats`` merges them. The CUDA source is
``csrc/paged_attention.cu``; its header says what bounds it on an H100
(the live pages' bytes) and what the design does about it: each slot's
page walk is cut into splits of ``split_plan`` that run as blocks of their
own, and a second pass merges the splits' statistics in split order.
The wrapper allocates that pass's scratch. A launch takes at most
``MAX_ROWS`` query rows a kv head; a speculative verify block with more
(G·D > 32) is cut by the wrapper into runs of whole query heads, one
launch each (``split_rows``), each reading the pages again.

For a CUDA tensor the wrapper launches the kernel (or raises); for a CPU
tensor it runs ``paged_decode_attention_plain``: gather the pages, the
same masked softmax, the same ring merge.
``paged_decode_attention_split_plain`` is the same function with the
kernel's split-and-merge algebra, for the tests. The TPU kernel's
``n_strip`` (pages per grid cell) has no counterpart: its results are
identical across strips, and the CUDA kernel has no such grid.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pilottai_tpu_torch.ops.attention import NEG_INF
from pilottai_tpu_torch.ops.paged import gather_pages

#: Kernel launches since the last reset (``chip_smoke.py`` reads it).
launches = 0

SOURCE = "pilottai_tpu_torch/csrc/paged_attention.cu"
REPLACES = "pilottai_tpu/ops/pallas/paged_attention.py:58"
MAX_ROWS = 32  # query rows per kv head one launch takes (N / K, q_blocks included)
KEYS_PER_SPLIT = 256  # keys' worth of page slots one block of the kernel walks
MIN_PAGE = 8  # the smallest page the kernel takes, engine_page_size's floor
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (32, 64, 128)


def check_kernel_shapes(n_heads: int, n_kv_heads: int, head_dim: int, page_size: int,
                        q_blocks: int = 1) -> None:
    """Raise ``ValueError`` for a shape the CUDA kernel does not take. Any
    page size from ``MIN_PAGE`` on is served (``LLMConfig`` holds
    ``engine_page_size`` to the same floor)."""
    G = n_heads // max(n_kv_heads, 1)
    if (head_dim not in _HEAD_DIMS or n_heads % n_kv_heads or G > MAX_ROWS or q_blocks < 1
            or G % q_blocks or page_size < MIN_PAGE):
        raise ValueError(
            f"paged_attention: the CUDA kernel takes head_dim in {_HEAD_DIMS}, at most "
            f"{MAX_ROWS} query rows per kv head and a page size of at least {MIN_PAGE}; got "
            f"heads {n_heads}/{n_kv_heads}, head_dim {head_dim}, page size {page_size}, "
            f"q_blocks {q_blocks}"
        )


def _softmax_stats(s: torch.Tensor, v: torch.Tensor, v_dtype: torch.dtype):
    """``(acc, m, l)`` of masked logits ``s [B,K,G,S]`` over ``v [B,K,S,H]``:
    p is 0 while a row's max is NEG_INF and is cast to ``v_dtype`` before
    the product."""
    m = s.amax(dim=-1)
    p = torch.where(m[..., None] > NEG_INF / 2, torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bksh->bkgh", p.to(v_dtype).float(), v.float())
    return acc, m, l


def _page_stats(q, k_pool, v_pool, table, last_valid, q_positions, n_blocks, scale, softcap,
                window, q_blocks, k_scales, v_scales):
    """``(acc [B,K,G,H], m, l [B,K,G])`` over the first ``n_blocks`` page
    slots of each slot's table row (no ring)."""
    B, N, H = q.shape
    K, num_pages, P, _ = k_pool.shape
    G = N // K
    dev = q.device
    kg = gather_pages(k_pool, table, n_blocks)                    # [B, K, S, H]
    vg = gather_pages(v_pool, table, n_blocks)
    if k_scales is not None:
        kg = kg.float() * gather_pages(k_scales, table, n_blocks)[..., None]
        vg = vg.float() * gather_pages(v_scales, table, n_blocks)[..., None]
        v_dtype = torch.float32
    else:
        v_dtype = v_pool.dtype
    qg = q.reshape(B, K, G, H).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, kg.float()) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    S = n_blocks * P
    col = torch.arange(S, device=dev)
    live_page = (table[:, :n_blocks] != num_pages - 1).repeat_interleave(P, dim=1)  # [B, S]
    mask = (col[None, :] <= last_valid.to(dev)[:, None]) & live_page
    mask = mask[:, None, None, :]
    if window > 0:
        qrow = q_positions.to(dev)[:, None] + torch.arange(G, device=dev) % q_blocks  # [B, G]
        mask = mask & ((qrow[:, None, :, None] - col) < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return _softmax_stats(s, vg, v_dtype)


def _ring_stats(q, ring_k, ring_v, ring_step, scale, softcap, window):
    """The decode chunk's ring rows ``0..ring_step`` as a softmax of their own."""
    B, N, H = q.shape
    K, R = ring_k.shape[1], ring_k.shape[2]
    qg = q.reshape(B, K, N // K, H).float()
    sr = torch.einsum("bkgh,bkrh->bkgr", qg, ring_k.float()) * scale
    if softcap > 0.0:
        sr = torch.tanh(sr / softcap) * softcap
    r = torch.arange(R, device=q.device)
    rmask = r <= ring_step
    if window > 0:
        rmask &= (ring_step - r) < window
    sr = torch.where(rmask, sr, torch.full_like(sr, NEG_INF))
    return _softmax_stats(sr, ring_v, ring_v.dtype)


def _merge_ring(pages, ring):
    """The TPU kernel's merge of the pages' and the ring's statistics."""
    acc, m, l = pages
    acc_r, m_r, l_r = ring
    m_new = torch.maximum(m, m_r)
    wa = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), torch.zeros_like(m))
    wb = torch.where(m_r > NEG_INF / 2, torch.exp(m_r - m_new), torch.zeros_like(m))
    return acc * wa[..., None] + acc_r * wb[..., None], m_new, l * wa + l_r * wb


def paged_decode_attention_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, table: torch.Tensor,
    last_valid: torch.Tensor, q_positions: torch.Tensor, n_blocks: int, scale: float,
    softcap: float = 0.0, window: int = 0, q_blocks: int = 1,
    k_scales: Optional[torch.Tensor] = None, v_scales: Optional[torch.Tensor] = None,
    ring_k: Optional[torch.Tensor] = None, ring_v: Optional[torch.Tensor] = None,
    ring_step: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: ``(acc [B,N,H] fp32, m [B,N], l [B,N])``."""
    B, N, H = q.shape
    table = table.to(q.device)
    stats = _page_stats(q, k_pool, v_pool, table, last_valid, q_positions, n_blocks, scale,
                        softcap, window, q_blocks, k_scales, v_scales)
    if ring_k is not None:
        stats = _merge_ring(stats, _ring_stats(q, ring_k, ring_v, ring_step, scale, softcap,
                                               window))
    acc, m, l = stats
    return acc.reshape(B, N, H), m.reshape(B, N), l.reshape(B, N)


def split_plan(n_blocks: int, page_size: int,
               keys_per_split: int = KEYS_PER_SPLIT) -> Tuple[int, int]:
    """How the kernel cuts each slot's page walk: ``(pages per split,
    splits)``. A split is ``KEYS_PER_SPLIT`` keys' worth of page slots (at
    least one page), so a long slot spreads over many blocks whatever the
    other slots hold; the plan depends on ``n_blocks`` and the page size
    alone, which the host knows without reading ``last``."""
    per = max(1, keys_per_split // page_size)
    return per, -(-n_blocks // per)


def paged_decode_attention_split_plain(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, table: torch.Tensor,
    last_valid: torch.Tensor, q_positions: torch.Tensor, n_blocks: int, scale: float,
    softcap: float = 0.0, window: int = 0, q_blocks: int = 1,
    k_scales: Optional[torch.Tensor] = None, v_scales: Optional[torch.Tensor] = None,
    ring_k: Optional[torch.Tensor] = None, ring_v: Optional[torch.Tensor] = None,
    ring_step: int = 0, keys_per_split: int = KEYS_PER_SPLIT,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K3 with the kernel's algebra: each split of ``split_plan``
    gets its own ``(acc, m, l)`` over its page slots (the other slots
    turned into the sentinel), the splits are merged in split order with
    ``m = max m_s`` and weights ``exp(m_s - m)`` (0 for a split with no
    key), then the ring is merged as in ``paged_decode_attention_plain``."""
    B, N, H = q.shape
    num_pages, P = k_pool.shape[1], k_pool.shape[2]
    table = table.to(q.device)
    per, n_split = split_plan(n_blocks, P, keys_per_split)
    parts = []
    for z in range(n_split):
        own = table[:, :n_blocks].clone()
        own[:, : z * per] = num_pages - 1
        own[:, (z + 1) * per:] = num_pages - 1
        parts.append(_page_stats(q, k_pool, v_pool, own, last_valid, q_positions, n_blocks,
                                 scale, softcap, window, q_blocks, k_scales, v_scales))
    m = torch.stack([m_s for _, m_s, _ in parts]).amax(dim=0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(m)
    for acc_s, m_s, l_s in parts:
        w = torch.where(m_s > NEG_INF / 2, torch.exp(m_s - m), torch.zeros_like(m_s))
        acc = acc + w[..., None] * acc_s
        l = l + w * l_s
    stats = (acc, m, l)
    if ring_k is not None:
        stats = _merge_ring(stats, _ring_stats(q, ring_k, ring_v, ring_step, scale, softcap,
                                               window))
    acc, m, l = stats
    return acc.reshape(B, N, H), m.reshape(B, N), l.reshape(B, N)


def paged_decode_attention(
    q: torch.Tensor,             # [B, N, H]; with q_blocks=D, row head*D + d sits at qpos + d
    k_pool: torch.Tensor,        # [K, num_pages, P, H] bf16, fp32 or int8
    v_pool: torch.Tensor,
    table: torch.Tensor,         # [B, max_pages] int32 (sentinel num_pages - 1)
    last_valid: torch.Tensor,    # [B] keys at s <= last_valid[b] attend (-1: none)
    q_positions: Optional[torch.Tensor] = None,  # [B] for the window; default last_valid
    n_blocks: Optional[int] = None,              # page slots to visit; default all
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: int = 0,
    q_blocks: int = 1,
    k_scales: Optional[torch.Tensor] = None,     # [K, num_pages, P] fp32 — int8 pools
    v_scales: Optional[torch.Tensor] = None,
    ring_k: Optional[torch.Tensor] = None,       # [B, K, R, H] in q's dtype
    ring_v: Optional[torch.Tensor] = None,
    ring_step=None,                              # rows 0..ring_step of the ring attend
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged paged GQA decode attention: the unnormalized ``(acc
    [B,N,H] fp32, m [B,N], l [B,N])`` over each slot's first ``n_blocks``
    pages, plus the in-chunk ring when ``ring_k`` is given."""
    B, N, H = q.shape
    K = k_pool.shape[0]
    max_pages = table.shape[1]
    n_blocks = max_pages if n_blocks is None else int(n_blocks)
    if not 1 <= n_blocks <= max_pages or N % K or (N // K) % q_blocks:
        raise ValueError(f"paged_attention: n_blocks {n_blocks} of {max_pages}, heads {N}/{K}, "
                         f"q_blocks {q_blocks}")
    if (k_scales is None) != (v_scales is None) or (k_scales is None) == (k_pool.dtype == torch.int8):
        raise ValueError("paged_attention: int8 pools need k_scales and v_scales, and only they")
    if ring_k is not None and (ring_v is None or ring_step is None or q_blocks != 1):
        raise ValueError("paged_attention: a ring needs ring_v and ring_step, with q_blocks 1")
    scale = scale if scale is not None else H**-0.5
    if q_positions is None:
        q_positions = last_valid
    step = int(ring_step) if ring_k is not None else 0
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, table, last_valid, q_positions, n_blocks, scale, softcap,
            window, q_blocks, k_scales, v_scales, ring_k, ring_v, step,
        )
    if N // K > MAX_ROWS and ring_k is None:
        return split_rows(
            q, K, q_blocks,
            lambda part: _launch(part, k_pool, v_pool, table, last_valid, q_positions, n_blocks,
                                 scale, softcap, window, q_blocks, k_scales, v_scales, None,
                                 None, 0),
        )
    return _launch(q, k_pool, v_pool, table, last_valid, q_positions, n_blocks, scale,
                   softcap, window, q_blocks, k_scales, v_scales, ring_k, ring_v, step)


def split_rows(q: torch.Tensor, n_kv_heads: int, q_blocks: int, attend):
    """More than ``MAX_ROWS`` query rows a kv head (a verify block of D
    rows for each of G query heads, G·D > 32): the query heads of each kv
    head are cut into runs of at most ``MAX_ROWS // q_blocks`` heads, whole
    heads so that row r of a run still sits at ``q_positions + r %
    q_blocks``; ``attend`` runs on each run's ``[B, K·rows, H]`` queries
    (one launch each, every one reading the pages again) and the partials
    come back in row order. Raises when one head's block alone passes the
    limit."""
    B, N, H = q.shape
    K = n_kv_heads
    heads = N // K // q_blocks
    per = MAX_ROWS // q_blocks
    if per < 1:
        raise ValueError(f"paged_attention: a block of q_blocks={q_blocks} rows passes the "
                         f"kernel's {MAX_ROWS} query rows per kv head")
    qh = q.reshape(B, K, heads, q_blocks, H)
    accs, ms, ls = [], [], []
    for h0 in range(0, heads, per):
        n = min(per, heads - h0)
        acc, m, l = attend(qh[:, :, h0:h0 + n].reshape(B, K * n * q_blocks, H).contiguous())
        accs.append(acc.reshape(B, K, n * q_blocks, H))
        ms.append(m.reshape(B, K, n * q_blocks))
        ls.append(l.reshape(B, K, n * q_blocks))
    return (torch.cat(accs, dim=2).reshape(B, N, H), torch.cat(ms, dim=2).reshape(B, N),
            torch.cat(ls, dim=2).reshape(B, N))


def _launch(q, k_pool, v_pool, table, last_valid, q_positions, n_blocks, scale, softcap,
            window, q_blocks, k_scales, v_scales, ring_k, ring_v, step):
    B, N, H = q.shape
    K, num_pages, P, _ = k_pool.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {dev}")
    if q.dtype not in _Q_DTYPES or k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: q {q.dtype} with pools {k_pool.dtype}/{v_pool.dtype}")
    if k_pool.dtype != torch.int8 and k_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention: a float pool must have q's dtype, got "
                        f"{k_pool.dtype} and {q.dtype}")
    check_kernel_shapes(N, K, H, P, q_blocks)
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != H:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"for q {tuple(q.shape)}")
    tensors = [q, k_pool, v_pool]
    if k_scales is not None:
        if k_scales.dtype != torch.float32 or k_scales.shape != (K, num_pages, P) \
                or v_scales.shape != k_scales.shape or v_scales.dtype != torch.float32:
            raise ValueError("paged_attention: scales must be fp32 [K, num_pages, P]")
        tensors += [k_scales, v_scales]
    R = 0
    if ring_k is not None:
        R = ring_k.shape[2]
        if (ring_k.shape != (B, K, R, H) or ring_v.shape != ring_k.shape
                or ring_k.dtype != q.dtype or ring_v.dtype != q.dtype or not 0 <= step < R):
            raise ValueError(f"paged_attention: ring {tuple(ring_k.shape)} {ring_k.dtype} "
                             f"at step {step} for q {tuple(q.shape)} {q.dtype}")
        tensors += [ring_k, ring_v]
    if not all(t.is_contiguous() and t.device == dev for t in tensors):
        raise ValueError("paged_attention: q, the pools, scales and ring must be contiguous "
                         "on q's device")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("paged_attention: q, the pools and the ring must start 16-byte aligned")
    tbl = table.to(device=dev, dtype=torch.int32).contiguous()
    last = last_valid.to(device=dev, dtype=torch.int32).contiguous()
    qpos = q_positions.to(device=dev, dtype=torch.int32).contiguous()
    if tbl.shape[0] != B or last.shape != (B,) or qpos.shape != (B,):
        raise ValueError("paged_attention: table must be [B, max_pages], last_valid and "
                         "q_positions [B]")
    acc = torch.empty((B, N, H), device=dev, dtype=torch.float32)
    m = torch.empty((B, N), device=dev, dtype=torch.float32)
    l = torch.empty((B, N), device=dev, dtype=torch.float32)
    per, n_split = split_plan(n_blocks, P)
    Z = n_split + (1 if R else 0)
    part_acc = torch.empty((B, K, Z, N // K, H), device=dev, dtype=torch.float32)
    part_ml = torch.empty((2, B, K, Z, N // K), device=dev, dtype=torch.float32)

    from pilottai_tpu_torch.ops.kernels.build import load_library

    lib = _bind(load_library("paged_attention"))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = lib.pt_paged_attention(
        _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), ptr(k_scales), ptr(v_scales), tbl.data_ptr(), last.data_ptr(),
        qpos.data_ptr(), ptr(ring_k), ptr(ring_v), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        part_acc.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
        B, N, K, num_pages, P, H, tbl.shape[1], n_blocks, per, q_blocks, R, step, int(window),
        float(scale), float(softcap), torch.cuda.current_stream(dev).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(
            f"paged_attention launch failed: {lib.pt_error_string(status).decode()}"
        )
    global launches
    launches += 1
    return acc, m, l


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.pt_paged_attention
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, I] + [P] * 16 + [I] * 13 + [F, F, P]
        fn.restype = I
        lib.pt_error_string.argtypes = [I]
        lib.pt_error_string.restype = ctypes.c_char_p
    return lib
