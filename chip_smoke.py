#!/usr/bin/env python3
"""GPU smoke test for ``pilottai_tpu_torch``, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero, and the
result line is printed only when every phase passed):

1. environment — torch and CUDA versions, the card's name and power limit;
2. build — the five hand-written kernels from ``pilottai_tpu_torch/csrc``
   with ``nvcc`` for sm_90a, in parallel;
3. kernels — K1 (flash prefill), K2 (dense decode statistics) and K3
   (paged decode statistics, ring fused) held against their plain PyTorch
   versions at llama3-8b (head_dim 128), llama3-1b (64) and protocol-s (32)
   shapes, in bf16 and fp32, with windows, soft-caps, ragged lengths and
   empty rows; K3 also with a sentinel page inside a table row, the ring at
   its first and last row, ``q_blocks=2``, int8 pools and page sizes 8, 24,
   100 and 512 (off the multiples of 16 and past one split); K4 and K5 (the
   flash backward: dq, and dk with dv) against the plain backward at the
   same three head dims with G = 4 and G = 1, an empty row, T != S with
   offset query positions, a window, a soft-cap and a nonzero lse
   cotangent, each run twice to show bit-identical gradients (limits in
   ``TOL``); then edge cases of the redesigned K1, K3, K4 and K5 (Tq and
   S off the tiles, rows with no key, key positions out of order; K3's
   slots ending mid-page and at a split's end, windows that leave whole
   splits dead, 8 and 32 query rows per kv head, int8 pools at P 16 and
   256; K4/K5 also at G = 1 and 4 and all three head dims; K2's split
   walk: slots ending on a split's last key and the next one's first, a
   window crossing splits, every slot empty, a batch wide enough for one
   split, G = 1 and 8, the golden fp32 step); K1 also at the tail
   prefill's shapes (T tail queries at positions plen.. against plen + T
   keys: 5d's hits, 5b's last segment, 4c's golden hits). K1, K2 and K3
   also run twice and must give the same bits;
4. golden — the committed protocol-s checkpoint in fp32 (TF32 off) served
   through ``LLMHandler.generate_response``, once on the dense cache and
   once paged with chunked prefill, the prefix cache off as on the JAX
   engine that made the golden (4a, 4b); the greedy token ids must equal
   ``assets/protocol_s_golden.json`` and ``protocol_s_paged_golden.json``
   (the JAX engine's), each at the decode pipeline's defaults (chunks as
   CUDA graphs, two in flight, overlapped admission, adaptive chunks, the
   fused greedy epilogue) and again with those knobs off, the paged one
   also at 8-key pages, the smallest the config takes. Each path's launch
   counters, reset just before it, must show its kernels: K1 and K2 on the
   dense path, K1 and K3 with K2 at zero on the paged ones, where prefill
   segments must have run; K2 (dense) or K3 (paged) once per layer per
   decode step dispatched, graph replays included. The chunk graphs
   captured, their capture seconds and their shared pool are printed.
   (c) the same golden at the port's defaults, prefix cache on, each case
   served twice in a row, dense and paged: every serving's ids equal the
   golden's, the lookups hit at least once a case (the second serving),
   no export fails, and every page is back on the free list or pinned by
   the page index;
5. full width — llama3-8b in bf16 from random init, the prefix cache off
   in (a) to (c), (a) on the dense cache:
   8 concurrent JSON-mode greedy requests, the counters > 0, one prompt's
   first-token logits through K1 against the plain K1 and one decode step
   of the live wave through K2 against the plain K2 (``TOL_E2E``); (b)
   paged, switched on by ``engine_max_seq=8192`` alone: one ~6000-token
   prompt (prefilled in 1024-token segments) and seven short ones, K1 and
   K3 > 0 with K2 at zero, every page back on the free list, and one decode
   step of the wave's live state through K3 against the plain K3
   (``TOL_E2E``). Both decode-step checks run on the device thread's
   stream between two dispatches, and both paths launch their decode
   kernel once per layer per step. Then five more waves of each: TTFT
   p50, TPOT p50 and decode tokens/s per wave, with the median and the
   spread; (c) five waves of each under torch.profiler, on fresh engines:
   the device's busy share (after every plain wave: the profiler leaves
   the process's launches slower), and the fp32 GEMMs the first profiled
   wave ran; (d) agent steps sharing a preamble: 8 concurrent requests a
   wave whose system message is the leading 900 bytes of the protocol
   rules and whose task differs in every request, dense (2048) and paged
   (8192): a cold wave, then five timed waves with the prefix cache on
   (8 hits a wave, each tail one K1 launch a layer against the cached
   prefix: the store's derived preamble entry, or 7 shared pages) and the
   same waves with it off; TTFT and TPOT p50 of both, the store or the
   pinned pages, and one warm request's first-token logits through the
   hit path against a full K1 prefill (``TOL_E2E``, the same argmax);
7. training — (a) golden: four ``Trainer.step`` calls on protocol-s in fp32
   (TF32 off) from the shipped checkpoint, on ``protocol_batches(4, 512,
   seed=11)``; the batches' hash and each step's loss and grad norm must
   match ``assets/protocol_s_train_golden.json`` (the JAX trainer's,
   ``TOL_TRAIN_GOLDEN``), and the counters read K1 = 2 x layers x steps
   (remat runs each layer's forward twice) and K4 = K5 = layers x steps;
   (b) llama3-1b at full width, bf16 compute over fp32 master weights
   from random init, remat on, 8 steps on one fixed
   ``synthetic_batches(cfg, 4, 2048)`` batch: every loss finite and the last
   below the first, exact launch counts, step time, tokens/s, model FLOPs
   utilisation, peak memory, one profiled step, and every parameter's
   gradient through the kernels against the same step through the plain
   K1, K4 and K5 (``TOL_E2E_TRAIN``);
6. last, each path's kernels timed at the shapes that path gave them (bf16
   at phase 5's and 7b's, fp32 at phase 4's and 7a's; K1 also at 5d's hit
   shapes and 5b's last segment; K2 and K3 with the
   L2 flushed and warm, K2 also as the profiler's device time a launch,
   in the harness and in phase 5a's profiled wave), with the yardstick's
   terms printed beside the fp32 rows (torch and CUDA versions, the TF32
   flags, and the device kernels of one SDPA forward and backward, which
   name the backend that ran); the kernels line, then the result line.

``--kernels-only`` stops after phase 3; ``--seed`` changes the kernel
checks' inputs and the llama3-8b and llama3-1b weights.

With no CUDA device (or outside a checkout of the repository) it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

NEG_INF = -2.0**30
# Limits against the plain versions, per dtype, on unit-variance inputs.
# fp32: the order of summation differs, and K1 and K5 run their products in
# 3xTF32, which keeps about 21 bits of each operand and drops terms of
# 2^-22 relative (tests/test_torch_tf32_split.py holds that arithmetic
# within these limits on the CPU). bf16: the kernel rounds p to
# bf16 against its running max and the plain version against the row max,
# so the attention output ("out": K1's o, K2's acc / l and o) moves by that
# rounding; K1's o is then rounded to bf16 once more, which the relative
# term covers (2^-7 is the widest bf16 spacing relative to a value). The
# bf16 "out" limit is about twice the largest reading over seeds 0-3 on an
# H100 (1.6e-3; PERF.md, PR 1). The statistics ("stats": lse, m, relative
# l) come from products that are exact in fp32 in either dtype, so both
# dtypes hold them to fp32's limit.
#
# K4 and K5 ("bwd"): each of dq, dk and dv as max |difference| / max |ref|.
# fp32: 1e-4 (summation order only; readings up to 5.5e-6). bf16: the
# kernels and the plain version round p and ds to bf16 from exponentials
# that differ in the last fp32 bits, so a rounding can land one bf16 step
# apart; bf16 dq is also rounded once more on output, which the relative
# term covers as for K1's o. The bf16 limit is about twice the largest
# reading over seeds 0-3 on an H100, in two draws of the inputs (1.34e-3,
# dv; PERF.md).
TOL = {
    "float32": {"out": 1e-4, "rel": 0.0, "stats": 1e-4, "bwd": 1e-4},
    "bfloat16": {"out": 3e-3, "rel": 2.0**-7, "stats": 1e-4, "bwd": 3e-3},
}
# K3 is held to K2's limits. Its int8 pools are dequantised to fp32 and p
# stays fp32 for them (as in the TPU kernel), so an int8 case is held to
# the fp32 limits whatever q's dtype.
# Full width, bf16: the first-token logits of one prompt with K1 against the
# same forward with the plain K1, as max |difference| / max |logit| (about
# twice the reading of seed 0, 4.7e-3); the argmax must agree wherever the
# top-2 margin exceeds twice the largest difference.
TOL_E2E = 1e-2
# Phase 7a: the port's fp32 training steps against the JAX trainer's on the
# CPU (assets/protocol_s_train_golden.json), relative. Only the order of
# summation differs, but AdamW normalises each update, so an element whose
# gradient is summation-order noise moves by a fraction of the learning
# rate and the later losses follow: on an H100 the third step's loss read
# 1.28e-5 and the grad norms 1.11e-5 at most (PERF.md). The loss
# limit is about twice that reading; the grad norm keeps 1e-4.
TOL_TRAIN_GOLDEN = {"loss": 3e-5, "grad_norm": 1e-4}
# Phase 7b: every parameter's gradient of one llama3-1b bf16 step through
# K1, K4 and K5 against the same step through their plain versions, as
# max |difference| / max |gradient| per leaf: about twice the H100 reading
# of seed 0 (1.996e-2, layer 14's wk; PERF.md). The two paths round
# p and ds to bf16 at different points, and 16 layers of bf16 backward
# carry the difference to every gradient.
TOL_E2E_TRAIN = 4e-2
TRAIN_STEPS = 8
# H100 SXM dense bf16 on the tensor cores (NVIDIA data sheet), and for fp32
# the fp32-accurate tensor-core rate, TF32's 495e12 over the three products
# of 3xTF32: the least time this card takes for fp32-accurate products. The
# yardstick does the same: SDPA's fp32 path runs PyTorch's memory-efficient
# attention, whose sm80+ fp32 GEMMs are CUTLASS's OpMultiplyAddFastF32
# (mem_eff_attention/gemm_kernel_utils.h in PyTorch's headers).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# Kernel names of csrc/ that a profile lists apart, wherever they rank.
PORT_KERNEL_NAMES = ("flash_fwd", "tile_bounds", "decode_split", "paged_split", "paged_merge",
                     "flash_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before every
    launch (a real caller finds the operands cold: between two calls of a
    layer's attention the other layers' weights stream through L2). All
    launches are queued back to back and read after one synchronize, and
    the flush (a 1 GiB write, ~0.3 ms of the card's time) keeps the card
    busy while the host prepares the next launch, so the host's wrapper
    time does not land between the events. The median launch is
    reported."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(2**30, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 20, warmup: int = 3, flush: bool = True) -> float:
        """``flush=False`` leaves the L2 warm with the operands of the
        previous launch: a spin kernel (~0.5 ms) stands in for the flush
        and keeps the card busy while the host queues the next launch."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            if flush:
                self.flush.zero_()
            else:
                torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        times = sorted(start.elapsed_time(end) for start, end in events)
        return times[len(times) // 2]


def randn(torch, gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


# --------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #

def tol_text(dtype_name: str, rel: bool = True) -> str:
    """The limits of one dtype; ``rel`` for K1, whose o is rounded to the
    input dtype (K2's and K3's outputs are fp32)."""
    t = TOL[dtype_name]
    rel = f" + {t['rel']:.3g}|ref|" if rel and t["rel"] else ""
    return f"out {t['out']:g}{rel}, stats {t['stats']:g}"


def check_flash(torch, fa, gen, device, name, dtype, B, T, N, K, H, valid,
                window=0, softcap=0.0, offset=0, S=None, shuffle=False):
    """K1 against its plain version. ``S`` keys (default T) at positions
    0..S-1, shuffled along the key axis with ``shuffle``; queries at
    ``offset``..``offset + T - 1``. Run twice: the outputs must be the
    same bits."""
    S = T if S is None else S
    q = randn(torch, gen, (B, T, N, H), dtype, device)
    k = randn(torch, gen, (B, S, K, H), dtype, device)
    v = randn(torch, gen, (B, S, K, H), dtype, device)
    qpos = (torch.arange(T, device=device, dtype=torch.int32) + offset)[None].repeat(B, 1)
    kpos = torch.arange(S, device=device, dtype=torch.int32)[None].repeat(B, 1)
    if shuffle:
        kpos = torch.stack([kpos[b, torch.randperm(S, generator=gen, device=device)]
                            for b in range(B)])
    val = torch.tensor(valid, device=device, dtype=torch.int32)
    o_k, lse_k = fa.flash_attention_with_lse(q, k, v, qpos, kpos, val, window, None, softcap)
    o_2, lse_2 = fa.flash_attention_with_lse(q, k, v, qpos, kpos, val, window, None, softcap)
    torch.cuda.synchronize()
    same = torch.equal(o_k, o_2) and torch.equal(lse_k, lse_2)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, qpos, kpos, val, window, None, softcap)
    empty = lse_p <= NEG_INF / 2
    tol = TOL[str(dtype)[6:]]
    d_o = (o_k.float() - o_p.float()).abs()
    err_o = d_o.max().item()
    # The part of the o error beyond one output rounding (the relative term).
    over_o = (d_o - tol["rel"] * o_p.float().abs()).max().item()
    err_lse = (lse_k - lse_p).abs()[~empty].max().item() if (~empty).any() else 0.0
    empty_ok = bool((lse_k[empty] == NEG_INF).all() and (o_k.float()[empty] == 0).all())
    ok = over_o <= tol["out"] and err_lse <= tol["stats"] and empty_ok and same
    log(f"  K1 {name:<34} {str(dtype)[6:]:<8} o {err_o:.2e} (beyond rel {over_o:.2e}) "
        f"lse {err_lse:.2e} empty rows exact={empty_ok} ({int(empty.sum())}) repeat "
        f"bit-identical {same} tol {tol_text(str(dtype)[6:])} {'ok' if ok else 'FAIL'}")
    return ok, max(err_o, err_lse)


def compare_stats(kernel, plain, tol_name):
    """Hold a kernel's ``(acc, m, l)`` to its plain version's: acc as acc /
    max(l, 1), the normalised output, m and relative l on rows with keys;
    rows with no key must be exact. Returns (ok, gated error, the log
    line's numbers)."""
    a_k, m_k, l_k = kernel
    a_p, m_p, l_p = plain
    empty = m_p <= NEG_INF / 2
    live = ~empty
    tol = TOL[tol_name]
    # acc is unnormalized: its scale is l (up to S keys' worth), so its
    # error is held as acc / max(l, 1), in units of the attention output,
    # in both dtypes; the raw acc error is printed beside it.
    d_acc = (a_k - a_p).abs()
    err_acc = d_acc[live].max().item() if live.any() else 0.0
    err_acc_l = ((d_acc / l_p.clamp_min(1.0)[..., None])[live].max().item()
                 if live.any() else 0.0)
    err_m = (m_k - m_p).abs()[live].max().item() if live.any() else 0.0
    err_l = ((l_k - l_p).abs() / l_p.clamp_min(1.0))[live].max().item() if live.any() else 0.0
    err_o = ((a_k / l_k.clamp_min(1e-30)[..., None] - a_p / l_p.clamp_min(1e-30)[..., None])
             .abs()[live].max().item()) if live.any() else 0.0
    empty_ok = bool((m_k[empty] == m_p[empty]).all() and (l_k[empty] == 0).all()
                    and (a_k[empty] == 0).all())
    ok = (max(err_acc_l, err_o) <= tol["out"] and max(err_m, err_l) <= tol["stats"]
          and empty_ok)
    text = (f"acc {err_acc:.2e} acc/l {err_acc_l:.2e} o {err_o:.2e} m {err_m:.2e} "
            f"l(rel) {err_l:.2e} empty rows exact={empty_ok} ({int(empty.sum())} rows) "
            f"tol {tol_text(tol_name, rel=False)} (acc/l gated) {'ok' if ok else 'FAIL'}")
    return ok, max(err_acc_l, err_o, err_m, err_l), text


def check_decode(torch, da, gen, device, name, dtype, B, N, K, S, H, last,
                 window=0, softcap=0.0, shift=1):
    """K2 against its plain version, query positions ``shift`` past each
    slot's last key (a few steps into a decode chunk when above 1). Run
    twice: the statistics must be the same bits."""
    q = randn(torch, gen, (B, N, H), dtype, device)
    kc = randn(torch, gen, (B, K, S, H), dtype, device)
    vc = randn(torch, gen, (B, K, S, H), dtype, device)
    lst = torch.tensor(last, device=device, dtype=torch.int32)
    qpos = torch.clamp(lst, min=0) + shift
    scale = H**-0.5
    got = da.decode_attention(q, kc, vc, lst, qpos, scale, softcap, window, return_stats=True)
    again = da.decode_attention(q, kc, vc, lst, qpos, scale, softcap, window, return_stats=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = da.decode_attention_plain(q, kc, vc, lst, qpos, scale, softcap, window)
    ok, err, text = compare_stats(got, want, str(dtype)[6:])
    log(f"  K2 {name:<34} {str(dtype)[6:]:<8} {text} repeat bit-identical {same}")
    return ok and same, err


def paged_inputs(torch, gen, device, dtype, B, N, K, H, P, lengths, step=0, ring=0,
                 hole=None, quantized=False, spare=8):
    """A random page pool whose pages are handed to the slots in a shuffled
    order, the block table (sentinel ``num_pages - 1``; ``hole`` = (slot,
    page) turns one inner entry into the sentinel), ``last``, the query
    position (a decode step ``step`` rows into its chunk), q and the ring."""
    import random

    rnd = random.Random(sum(lengths) + B)
    pages_per = [-(-n // P) for n in lengths]
    max_pages = max(max(pages_per), 1)
    num_pages = sum(pages_per) + spare + 1
    order = list(range(num_pages - 1))
    rnd.shuffle(order)
    table = torch.full((B, max_pages), num_pages - 1, dtype=torch.int32)
    it = iter(order)
    for b, n in enumerate(pages_per):
        for j in range(n):
            table[b, j] = next(it)
    if hole is not None:
        table[hole] = num_pages - 1
    shape = (K, num_pages, P, H)
    x = {"table": table.to(device), "num_pages": num_pages, "max_pages": max_pages}
    if quantized:
        x["k"] = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
        x["v"] = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
        x["ks"] = torch.rand(shape[:3], generator=gen, device=device) * 0.02 + 0.004
        x["vs"] = torch.rand(shape[:3], generator=gen, device=device) * 0.02 + 0.004
    else:
        x["k"] = randn(torch, gen, shape, dtype, device)
        x["v"] = randn(torch, gen, shape, dtype, device)
        x["ks"] = x["vs"] = None
    lst = torch.tensor(lengths, device=device, dtype=torch.int32) - 1
    x["last"] = lst
    x["qpos"] = lst + 1 + step
    x["q"] = randn(torch, gen, (B, N, H), dtype, device)
    x["rk"] = randn(torch, gen, (B, K, ring, H), dtype, device) if ring else None
    x["rv"] = randn(torch, gen, (B, K, ring, H), dtype, device) if ring else None
    return x


def check_paged(torch, pa, gen, device, name, dtype, B, N, K, H, P, lengths, ring=0, step=0,
                hole=None, window=0, softcap=0.0, q_blocks=1, quantized=False):
    x = paged_inputs(torch, gen, device, dtype, B, N, K, H, P, lengths, step, ring, hole,
                     quantized)
    kw = dict(q_positions=x["qpos"], n_blocks=x["max_pages"], scale=H**-0.5, softcap=softcap,
              window=window, q_blocks=q_blocks, k_scales=x["ks"], v_scales=x["vs"],
              ring_k=x["rk"], ring_v=x["rv"], ring_step=step if ring else None)
    got = pa.paged_decode_attention(x["q"], x["k"], x["v"], x["table"], x["last"], **kw)
    again = pa.paged_decode_attention(x["q"], x["k"], x["v"], x["table"], x["last"], **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    kw["ring_step"] = step
    want = pa.paged_decode_attention_plain(x["q"], x["k"], x["v"], x["table"], x["last"], **kw)
    tol_name = "float32" if quantized else str(dtype)[6:]
    ok, err, text = compare_stats(got, want, tol_name)
    log(f"  K3 {name:<34} {str(dtype)[6:]:<8} {text}; repeat bit-identical {same}")
    return ok and same, err


def check_flash_bwd(torch, fa, gen, device, name, dtype, B, T, S, N, K, H, valid, window=0,
                    softcap=0.0, offset=0, dlse=False, shuffle=False):
    """K4 and K5 through ``flash_attention_bwd`` (twice: the gradients must
    be the same bits) against the plain backward, on K1's own (o, lse).
    Keys at positions 0..S-1, shuffled along the key axis with ``shuffle``.
    Returns (ok, dq's gated error, dk's and dv's)."""
    dn = str(dtype)[6:]
    q = randn(torch, gen, (B, T, N, H), dtype, device)
    k = randn(torch, gen, (B, S, K, H), dtype, device)
    v = randn(torch, gen, (B, S, K, H), dtype, device)
    do = randn(torch, gen, (B, T, N, H), dtype, device)
    dl = randn(torch, gen, (B, T, N), torch.float32, device) if dlse else None
    qpos = (torch.arange(T, device=device, dtype=torch.int32) + offset)[None].repeat(B, 1)
    kpos = torch.arange(S, device=device, dtype=torch.int32)[None].repeat(B, 1)
    if shuffle:
        kpos = torch.stack([kpos[b, torch.randperm(S, generator=gen, device=device)]
                            for b in range(B)])
    val = torch.tensor(valid, device=device, dtype=torch.int32)
    args = (q, k, v, qpos, kpos, val, window)
    o, lse = fa.flash_attention_fwd(*args, None, softcap)
    got = fa.flash_attention_bwd(*args, o, lse, do, dl, None, softcap)
    again = fa.flash_attention_bwd(*args, o, lse, do, dl, None, softcap)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_attention_bwd_plain(*args, o, lse, do, dl, None, softcap)
    tol = TOL[dn]
    errs, texts = [], []
    for label, g, w, rel in (("dq", got[0], want[0], tol["rel"]), ("dk", got[1], want[1], 0.0),
                             ("dv", got[2], want[2], 0.0)):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        ref = w.abs().max().clamp_min(1e-30)
        err = float(d.max() / ref)
        over = float((d - rel * w.abs()).max() / ref)
        finite = bool(torch.isfinite(g).all())
        errs.append(over if finite else math.inf)
        texts.append(f"{label} {err:.2e}" + (f" (beyond rel {over:.2e})" if rel else ""))
    ok = same and max(errs) <= tol["bwd"]
    log(f"  K4/K5 {name:<31} {dn:<8} {', '.join(texts)} of max |ref|; repeat bit-identical "
        f"{same}; tol {tol['bwd']:g}{' + 2^-7|ref| on dq' if tol['rel'] else ''} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, errs[0], max(errs[1:])


def phase_kernels(torch, fa, da, pa, device, seed):
    """Returns the largest gated error per (kernel, dtype)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # K4 and K5 draw from their own generator, so K1-K3 see the inputs they
    # saw before the backward kernels existed.
    bgen = torch.Generator(device=device)
    bgen.manual_seed(seed)
    # So do the edge cases added with the redesigned K1 and K3, and those
    # added with the redesigned K4 and K5.
    egen = torch.Generator(device=device)
    egen.manual_seed(seed)
    begen = torch.Generator(device=device)
    begen.manual_seed(seed)
    # And the K3 page sizes added with the page-size repair, and K2's split
    # edges added with its split walk.
    pgen = torch.Generator(device=device)
    pgen.manual_seed(seed)
    dgen = torch.Generator(device=device)
    dgen.manual_seed(seed)
    # And K1 at the prefix cache's tail shapes.
    hgen = torch.Generator(device=device)
    hgen.manual_seed(seed)
    results, worst = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        flash_cases = [
            ("llama3-8b T2048 ragged", dict(B=2, T=2048, N=32, K=8, H=128, valid=[2048, 1377])),
            ("llama3-8b T512 window softcap", dict(B=2, T=512, N=32, K=8, H=128, valid=[512, 300],
                                                   window=96, softcap=30.0, offset=7)),
            ("llama3-1b H64 T1024 empty row", dict(B=3, T=1024, N=32, K=8, H=64,
                                                   valid=[1024, 0, 515])),
            ("protocol-s H32 T512 ragged", dict(B=4, T=512, N=8, K=4, H=32,
                                                valid=[415, 512, 1, 0])),
            ("protocol-s H32 T100 window", dict(B=2, T=100, N=8, K=4, H=32, valid=[100, 63],
                                                window=17, offset=3)),
        ]
        for name, kw in flash_cases:
            ok, err = check_flash(torch, fa, gen, device, name, dtype, **kw)
            results.append(ok)
            worst[("flash", dn)] = max(worst.get(("flash", dn), 0.0), err)
        decode_cases = [
            ("llama3-8b S2048 ragged", dict(B=8, N=32, K=8, S=2048, H=128,
                                            last=[2047, 1000, 230, 0, -1, 1500, 64, 2046])),
            ("llama3-8b S512 window softcap", dict(B=4, N=32, K=8, S=512, H=128,
                                                   last=[511, 200, -1, 37], window=64,
                                                   softcap=30.0)),
            ("llama3-1b H64 S1024", dict(B=4, N=32, K=8, S=1024, H=64, last=[1023, 512, 3, -1])),
            ("protocol-s H32 S512", dict(B=4, N=8, K=4, S=512, H=32, last=[414, 510, -1, 0])),
        ]
        for name, kw in decode_cases:
            ok, err = check_decode(torch, da, gen, device, name, dtype, **kw)
            results.append(ok)
            worst[("decode", dn)] = max(worst.get(("decode", dn), 0.0), err)
        paged_cases = [
            ("llama3-8b P128 6000+short ring@0", dict(
                B=8, N=32, K=8, H=128, P=128, lengths=[6000, 184, 190, 201, 176, 0, 188, 195],
                hole=(6, 1), ring=16, step=0)),
            ("llama3-8b P128 window softcap ring@R-1", dict(
                B=4, N=32, K=8, H=128, P=128, lengths=[1000, 300, 0, 129], hole=(0, 2),
                window=256, softcap=30.0, ring=16, step=15)),
            ("llama3-8b P128 int8 pools", dict(
                B=4, N=32, K=8, H=128, P=128, lengths=[3000, 100, 0, 700], hole=(3, 1),
                softcap=30.0, quantized=True)),
            ("llama3-1b H64 P128 ring@7", dict(
                B=4, N=32, K=8, H=64, P=128, lengths=[1500, 700, 0, 33], ring=16, step=7)),
            # A window shorter than the ring's live rows: it cuts the ring
            # and leaves no page in reach.
            ("llama3-1b H64 P128 window 4 ring@7", dict(
                B=4, N=32, K=8, H=64, P=128, lengths=[1500, 700, 0, 33], window=4, ring=16,
                step=7)),
            ("protocol-s H32 P16 ring@0", dict(
                B=4, N=8, K=4, H=32, P=16, lengths=[415, 510, 0, 1], hole=(1, 5), ring=16,
                step=0)),
            ("protocol-s H32 P16 q_blocks2 window", dict(
                B=4, N=8, K=4, H=32, P=16, lengths=[415, 63, 0, 200], q_blocks=2, window=40)),
        ]
        for name, kw in paged_cases:
            ok, err = check_paged(torch, pa, gen, device, name, dtype, **kw)
            results.append(ok)
            worst[("paged", dn)] = max(worst.get(("paged", dn), 0.0), err)
        bwd_cases = [
            ("llama3-1b H64 T2048 ragged dlse", dict(B=2, T=2048, S=2048, N=32, K=8, H=64,
                                                     valid=[2048, 1377], dlse=True)),
            ("llama3-8b H128 T1024 empty row", dict(B=2, T=1024, S=1024, N=32, K=8, H=128,
                                                    valid=[1024, 0])),
            ("llama3-8b H128 T512 window softcap", dict(B=2, T=512, S=512, N=32, K=8, H=128,
                                                        valid=[512, 300], window=96,
                                                        softcap=30.0, dlse=True)),
            ("H32 G1 T100 S160 offset 60", dict(B=3, T=100, S=160, N=4, K=4, H=32,
                                                valid=[160, 97, 0], offset=60, dlse=True)),
            ("protocol-s H32 T512 window", dict(B=4, T=512, S=512, N=8, K=4, H=32,
                                                valid=[415, 512, 1, 0], window=17, offset=3)),
        ]
        for name, kw in bwd_cases:
            ok, err_dq, err_dkv = check_flash_bwd(torch, fa, bgen, device, name, dtype, **kw)
            results.append(ok)
            worst[("bwd_dq", dn)] = max(worst.get(("bwd_dq", dn), 0.0), err_dq)
            worst[("bwd_dkv", dn)] = max(worst.get(("bwd_dkv", dn), 0.0), err_dkv)
        # K1: Tq and S off the 64-row tiles, query rows offset into the keys
        # (a paged segment), rows with no key (positions before every key,
        # a batch row with valid 0) and key positions out of order, so the
        # tile bounds meet boundary, full and dead tiles.
        flash_edges = [
            ("llama3-8b Tq200 S333 offset 133", dict(B=2, T=200, S=333, N=32, K=8, H=128,
                                                     valid=[333, 150], offset=133)),
            ("llama3-1b H64 Tq77 no-key rows window", dict(B=2, T=77, S=77, N=32, K=8, H=64,
                                                           valid=[77, 0], offset=-10,
                                                           window=5)),
            ("llama3-8b Tq130 S300 shuffled keys", dict(B=2, T=130, S=300, N=32, K=8, H=128,
                                                        valid=[300, 211], offset=170,
                                                        softcap=30.0, shuffle=True)),
            ("protocol-s H32 Tq45 S190 window", dict(B=3, T=45, S=190, N=8, K=4, H=32,
                                                     valid=[190, 100, 0], offset=145,
                                                     window=30)),
        ]
        for name, kw in flash_edges:
            ok, err = check_flash(torch, fa, egen, device, name, dtype, **kw)
            results.append(ok)
            worst[("flash", dn)] = max(worst.get(("flash", dn), 0.0), err)
        # K1 at the tail prefill's shapes (slice P2): T tail queries at
        # positions plen.. against the plen prefix keys and the tail, valid
        # plen + each row's tail — 5d's dense and paged hits, the last
        # segment of 5b's long prompt, and 4c's golden hits (dense: a
        # one-token tail in a bucket of 8; paged: 25 pages and a 15-token
        # tail).
        hit_cases = [
            ("llama3-8b hit A8 Tq256 S1186", dict(B=8, T=256, S=930 + 256, N=32, K=8, H=128,
                                                  valid=[930 + n for n in (148, 148, 150, 150,
                                                                           149, 150, 148, 256)],
                                                  offset=930)),
            ("llama3-8b paged hit A8 Tq256 S1152", dict(B=8, T=256, S=896 + 256, N=32, K=8,
                                                        H=128, valid=[896 + n for n in (
                                                            182, 182, 184, 184, 183, 184,
                                                            182, 1)], offset=896)),
            ("llama3-8b segment Tq1024 S6144", dict(B=1, T=1024, S=5120 + 1024, N=32, K=8,
                                                    H=128, valid=[5120 + 931], offset=5120)),
            ("protocol-s golden hit Tq8 S422", dict(B=1, T=8, S=414 + 8, N=8, K=4, H=32,
                                                    valid=[415], offset=414)),
            ("protocol-s paged hit Tq16 S416", dict(B=1, T=16, S=400 + 16, N=8, K=4, H=32,
                                                    valid=[415], offset=400)),
        ]
        for name, kw in hit_cases:
            ok, err = check_flash(torch, fa, hgen, device, name, dtype, **kw)
            results.append(ok)
            worst[("flash", dn)] = max(worst.get(("flash", dn), 0.0), err)
        # K3: the split walk (256 keys a split): slots ending mid-page inside
        # a split and exactly at a split's end, windows that leave whole
        # splits dead, 8 and 32 query rows per kv head, page sizes 32 to 256.
        paged_edges = [
            ("llama3-8b P128 split ends, ring@3", dict(
                B=4, N=32, K=8, H=128, P=128, lengths=[700, 512, 0, 256], ring=16, step=3)),
            ("llama3-8b P128 window kills splits", dict(
                B=4, N=32, K=8, H=128, P=128, lengths=[3000, 900, 0, 1], window=200,
                softcap=30.0, ring=16, step=9, hole=(0, 22))),
            ("llama3-1b H64 P64 G8 q_blocks2 window", dict(
                B=4, N=32, K=4, H=64, P=64, lengths=[1000, 300, 0, 65], q_blocks=2,
                window=100)),
            ("H64 P32 G32 q_blocks4 window", dict(
                B=2, N=32, K=1, H=64, P=32, lengths=[400, 0], q_blocks=4, window=50)),
            ("protocol-s H32 P16 int8 window hole", dict(
                B=4, N=8, K=4, H=32, P=16, lengths=[415, 513, 0, 33], quantized=True,
                window=300, hole=(1, 3))),
            ("llama3-8b P256 int8 ring@15", dict(
                B=4, N=32, K=8, H=128, P=256, lengths=[2000, 10, 0, 700], quantized=True,
                ring=16, step=15)),
        ]
        for name, kw in paged_edges:
            ok, err = check_paged(torch, pa, egen, device, name, dtype, **kw)
            results.append(ok)
            worst[("paged", dn)] = max(worst.get(("paged", dn), 0.0), err)
        # K3 at page sizes off the multiples of 16 and past one split (any
        # page from 8 on, as the JAX engine takes): a page's last tile cut
        # short, int8 scales that do not start 16-byte aligned, a page that
        # is a split of its own; slots end mid-page.
        paged_sizes = [
            ("protocol-s H32 P8 ring@5", dict(
                B=4, N=8, K=4, H=32, P=8, lengths=[415, 37, 0, 9], ring=16, step=5)),
            ("protocol-s H32 P8 int8 window", dict(
                B=4, N=8, K=4, H=32, P=8, lengths=[415, 63, 0, 9], quantized=True, window=100)),
            ("llama3-8b P24 window softcap hole", dict(
                B=4, N=32, K=8, H=128, P=24, lengths=[1000, 25, 0, 47], window=300,
                softcap=30.0, hole=(0, 5))),
            ("llama3-1b H64 P24 int8 ring@3", dict(
                B=4, N=32, K=8, H=64, P=24, lengths=[700, 23, 0, 49], quantized=True, ring=16,
                step=3)),
            ("llama3-1b H64 P100 ring@15", dict(
                B=4, N=32, K=8, H=64, P=100, lengths=[1777, 100, 0, 250], ring=16, step=15)),
            ("llama3-8b P100 int8 softcap hole", dict(
                B=4, N=32, K=8, H=128, P=100, lengths=[2050, 101, 0, 399], quantized=True,
                softcap=30.0, hole=(0, 4))),
            ("llama3-8b P512 ring@0", dict(
                B=4, N=32, K=8, H=128, P=512, lengths=[3000, 513, 0, 1], ring=16, step=0)),
            ("protocol-s H32 P512 int8 window", dict(
                B=4, N=8, K=4, H=32, P=512, lengths=[1500, 511, 0, 600], quantized=True,
                window=700)),
        ]
        for name, kw in paged_sizes:
            ok, err = check_paged(torch, pa, pgen, device, name, dtype, **kw)
            results.append(ok)
            worst[("paged", dn)] = max(worst.get(("paged", dn), 0.0), err)
        # K4 and K5: Tq and S off the 64-row tiles (and off K5's 32-row q
        # tiles at head_dim 128), query rows offset into the keys, rows with
        # no key, key positions out of order, G = 1 and G = 4, so the tile
        # bounds meet boundary, full and dead tiles on both sides.
        bwd_edges = [
            ("llama3-1b H64 Tq200 S333 offset 133", dict(B=2, T=200, S=333, N=32, K=8, H=64,
                                                         valid=[333, 150], offset=133,
                                                         dlse=True)),
            ("llama3-1b H64 Tq77 no-key rows window", dict(B=2, T=77, S=77, N=32, K=8, H=64,
                                                           valid=[77, 0], offset=-10,
                                                           window=5)),
            ("H64 G1 Tq130 S300 shuffled keys", dict(B=2, T=130, S=300, N=4, K=4, H=64,
                                                     valid=[300, 211], offset=170,
                                                     shuffle=True, dlse=True)),
            ("llama3-8b H128 Tq130 S300 shuffled softcap", dict(B=2, T=130, S=300, N=32, K=8,
                                                                H=128, valid=[300, 211],
                                                                offset=170, softcap=30.0,
                                                                shuffle=True)),
            ("llama3-8b H128 G4 Tq45 S190 window", dict(B=3, T=45, S=190, N=32, K=8, H=128,
                                                        valid=[190, 100, 0], offset=145,
                                                        window=30)),
            ("H32 G1 Tq45 S190 shuffled", dict(B=3, T=45, S=190, N=4, K=4, H=32,
                                                          valid=[190, 100, 0], offset=145,
                                                          shuffle=True, dlse=True)),
        ]
        for name, kw in bwd_edges:
            ok, err_dq, err_dkv = check_flash_bwd(torch, fa, begen, device, name, dtype, **kw)
            results.append(ok)
            worst[("bwd_dq", dn)] = max(worst.get(("bwd_dq", dn), 0.0), err_dq)
            worst[("bwd_dkv", dn)] = max(worst.get(("bwd_dkv", dn), 0.0), err_dkv)
        # K2's split walk (split_count splits of whole 32-key tiles a (kv
        # head, slot), merged by the last split to arrive): slots ending on a
        # split's last key and on the next one's first, a window that starts
        # inside a split, every slot empty, a batch wide enough for one split,
        # G = 1 and 8, and the golden fp32 step (one live slot of four).
        decode_edges = [
            ("llama3-8b Z9 split ends", dict(B=8, N=32, K=8, S=2048, H=128,
                                             last=[575, 576, 63, 64, 2047, 95, 0, 1151])),
            ("llama3-8b window crosses splits", dict(B=8, N=32, K=8, S=2048, H=128,
                                                     last=[2047, 700, 333, 100, -1, 64, 1500,
                                                           31], window=300, softcap=30.0,
                                                     shift=9)),
            ("llama3-8b every slot empty", dict(B=8, N=32, K=8, S=2048, H=128,
                                                last=[-1] * 8)),
            ("llama3-8b B66 one split", dict(B=66, N=32, K=8, S=256, H=128,
                                             last=[(37 * i) % 256 - 1 for i in range(66)])),
            ("H64 G8 S1024 window", dict(B=4, N=32, K=4, S=1024, H=64,
                                         last=[1023, 400, -1, 32], window=100, shift=5)),
            ("H64 G1 S1024", dict(B=4, N=8, K=8, S=1024, H=64, last=[1023, 511, 0, -1])),
            ("protocol-s golden step", dict(B=4, N=8, K=4, S=512, H=32,
                                            last=[462, -1, -1, -1])),
        ]
        for name, kw in decode_edges:
            ok, err = check_decode(torch, da, dgen, device, name, dtype, **kw)
            results.append(ok)
            worst[("decode", dn)] = max(worst.get(("decode", dn), 0.0), err)
    if not all(results):
        raise SystemExit("kernel check failed")
    return worst


# --------------------------------------------------------------------- #
# Phase 4: golden token ids on protocol-s, dense and paged
# --------------------------------------------------------------------- #

def record_requests(handler):
    """Wrap the engine's submit so the smoke sees each request's token ids."""
    batcher = handler.backend.batcher
    seen = []
    submit = batcher.submit

    def recording(request):
        seen.append(request)
        return submit(request)

    batcher.submit = recording
    return seen


def reset(kernels):
    for mod in kernels.values():
        mod.launches = 0
    kernels["flash"].launches_dq = kernels["flash"].launches_dkv = 0


def counts(kernels):
    """Every kernel's launches: K1, K2, K3 by module, K4 and K5 beside K1."""
    out = {name: mod.launches for name, mod in kernels.items()}
    out["bwd_dq"] = kernels["flash"].launches_dq
    out["bwd_dkv"] = kernels["flash"].launches_dkv
    return out


def launches_text(launches):
    return (f"flash_fwd {launches['flash']}, decode_attention {launches['decode']}, "
            f"paged_attention {launches['paged']}, flash_bwd_dq {launches['bwd_dq']}, "
            f"flash_bwd_dkv {launches['bwd_dkv']}")


# The decode pipeline's knobs all off: one chunk in flight, admission on the
# device thread, fixed chunks, the sampler (4a and 4b also run the defaults).
SERIAL_KNOBS = dict(engine_pipeline=1, engine_overlap_admission=False,
                    engine_chunk_policy="fixed", engine_fused_epilogue=False)


def graph_text(batcher):
    g = batcher.graph_report()
    pool = "not measured" if g["pool_bytes"] is None else f"{g['pool_bytes'] / 2**20:.1f} MiB"
    return (f"chunk graphs captured {g['graphs']}, capture {g['capture_s']:.3f} s, "
            f"shared pool {pool}")


def per_step_check(launches, batcher, steps, label):
    """The decode kernel of the path (K2 dense, K3 paged) launches once per
    layer per dispatched step, replays included; the other one never."""
    mine, other = ("paged", "decode") if batcher.paged else ("decode", "paged")
    per = launches[mine] / max(steps, 1)
    log(f"  {label}: {steps} decode steps dispatched, {launches[mine]} {mine}_attention "
        f"launches = {per:g} a step ({batcher.cfg.n_layers} layers); {graph_text(batcher)}")
    if steps <= 0 or launches[mine] != batcher.cfg.n_layers * steps or launches[other] != 0:
        raise SystemExit(f"{label}: the decode kernel did not launch once per layer per step")


def phase_golden(torch, kernels, root, asset, paged, page_size=None, knobs=None,
                 prefix_cache=0, repeat=1):
    """Serve the golden prompts with the asset's engine settings (the page
    size replaced by ``page_size``, the pipeline knobs by ``knobs``, if
    given) and hold the ids to it. The prefix cache is off, as on the
    JAX engine that made the golden, unless ``prefix_cache`` is None (the
    port's default, on); ``repeat`` serves each case that many times in a
    row, every serving held to the golden. Returns the path's launches
    and the shapes its fp32 kernels saw."""
    from pilottai_tpu_torch import LLMConfig, LLMHandler, PROTOCOL_S_NPZ
    from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
    from pilottai_tpu_torch.models.transformer import forward_prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmuls and cuDNN (torch.backends.*.allow_tf32 = False)")
    golden = json.loads((root / "pilottai_tpu_torch" / "assets" / asset).read_text())
    if page_size is not None:
        golden["engine"] = dict(golden["engine"], engine_page_size=page_size)
    golden["engine"] = dict(golden["engine"], **(knobs or {}))
    if prefix_cache is not None:
        golden["engine"]["engine_prefix_cache"] = prefix_cache
    log(f"  {asset}: engine {golden['engine']}")

    async def run():
        handler = LLMHandler(LLMConfig(
            provider="cuda", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
            sampling={"temperature": 0.0, "max_new_tokens": golden["max_new_tokens"]},
            **golden["engine"],
        ))
        await handler.start()
        seen = record_requests(handler)
        batcher = handler.backend.batcher
        try:
            out = []
            reset(kernels)
            for case in golden["cases"]:
                p = golden["prompts"][case["prompt"]]
                for _ in range(repeat):
                    seen.clear()
                    await handler.generate_response(
                        [ChatMessage(**m) for m in p["messages"]],
                        tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
                        json_mode=case["json_mode"],
                    )
                    out.append((list(seen[0].prompt_ids), seen[0].future.result()))
            await settle(batcher)
            return out, batcher
        finally:
            await handler.stop()

    t0 = time.perf_counter()
    got, batcher = asyncio.run(run())
    launches = counts(kernels)      # read once the engine's threads have stopped
    n = len(golden["cases"]) * repeat
    log(f"  launches on this run ({n} requests, fp32): {launches_text(launches)}")
    per_step_check(launches, batcher, batcher.blocks_dispatched, "golden")
    if paged:
        log(f"  paged: {batcher.num_pages} pages of {batcher.page_size}, prefill segments "
            f"{batcher.prefill_segments}, free pages after {batcher.alloc.free_pages}")
        if (launches["flash"] <= 0 or launches["paged"] <= 0 or launches["decode"] != 0
                or batcher.prefill_segments <= 0):
            raise SystemExit("the paged golden path did not run K1, K3 and prefill segments "
                             "with K2 at zero")
    elif launches["flash"] <= 0 or launches["decode"] <= 0 or launches["paged"] != 0:
        raise SystemExit("the dense golden path did not go through K1 and K2 alone")
    report = batcher.prefix_report()
    if report:
        log(f"  prefix cache: {report}")
        pinned = report.get("pinned_pages", 0)
        if batcher.paged:
            log(f"  pages after the run: {batcher.alloc.free_pages} free + {pinned} pinned "
                f"of {batcher.num_pages - 1}")
        if (report["hits"] < len(golden["cases"]) or report["export_failures"]
                or (batcher.paged and batcher.alloc.free_pages + pinned != batcher.num_pages - 1)):
            raise SystemExit("the prefix cache missed a repeat, an export failed, or pages "
                             "were neither returned nor pinned")
    elif prefix_cache is None:
        raise SystemExit("the prefix cache is not on at the port's defaults")
    failed = False
    cases = [case for case in golden["cases"] for _ in range(repeat)]
    for case, (prompt_ids, ids) in zip(cases, got):
        want = case["token_ids"]
        same = prompt_ids == case["prompt_ids"] and ids == want
        log(f"  prompt {case['prompt']} json_mode={case['json_mode']!s:<5} "
            f"{len(ids)} tokens {'equal' if same else 'DIFFER'}")
        if not same:
            failed = True
            pos = next((i for i, (a, b) in enumerate(zip(ids, want)) if a != b),
                       min(len(ids), len(want)))
            log(f"    first difference at generated position {pos}: "
                f"port {ids[pos] if pos < len(ids) else None} "
                f"golden {want[pos] if pos < len(want) else None}")
            seq = torch.tensor([prompt_ids + want[:pos]], device=batcher.device)
            T = seq.shape[1]
            logits, _, _ = forward_prefill(
                batcher.params, batcher.cfg, seq,
                torch.arange(T, device=batcher.device, dtype=torch.int32)[None],
                torch.tensor([T], device=batcher.device, dtype=torch.int32),
            )
            top = torch.topk(logits[0, -1], 2)
            log(f"    top-2 logits there {top.values.tolist()} ids {top.indices.tolist()} "
                f"margin {float(top.values[0] - top.values[1]):.3e}")
    log(f"  golden phase {time.perf_counter() - t0:.1f} s")
    if failed:
        raise SystemExit("golden token ids differ")
    # The shapes the fp32 kernels saw: one request at a time, the prompt
    # padded to its bucket, the decode read over every slot's panel (or,
    # paged, the request's pages) at mid-generation, mid-chunk.
    lens = [len(prompt_ids) for prompt_ids, _ in got]
    mean_gen = sum(len(ids) for _, ids in got) // len(got)
    last = [max(lens) + mean_gen // 2] + [-1] * (batcher.n_slots - 1)
    shapes = {
        "flash": dict(B=1, T=batcher._bucket(max(lens)), lens=[max(lens)]),
        "decode": dict(B=batcher.n_slots, S=batcher.max_seq_len, last=last),
        "model": batcher.cfg,
        "requests": n,
    }
    if paged:
        P = batcher.page_size
        table = [[-1] * batcher.alloc.table.shape[1] for _ in range(batcher.n_slots)]
        table[0][: -(-(last[0] + 1) // P)] = list(range(-(-(last[0] + 1) // P)))
        shapes["paged"] = dict(last=last, table=table, num_pages=batcher.num_pages, P=P,
                               R=batcher.chunk_size, step=batcher.chunk_size // 2)
    return launches, shapes


# --------------------------------------------------------------------- #
# Phase 5: llama3-8b at full width
# --------------------------------------------------------------------- #

# About 200 prompt tokens each once framed by the chat transcript.
FULL_PROMPT = (
    "Plan the next step of the document pipeline for report {i}. Reply with one JSON "
    "object with the keys task_complete, action, arguments and reasoning; cover churn."
)


def long_prompt(n_chars: int) -> str:
    """A report of about ``n_chars`` bytes (one byte-tokenizer token each),
    then the instruction."""
    lines, size, j = [], 0, 0
    while size < n_chars:
        line = (f"Section {j}: revenue in region {j % 9} moved {(j * 7) % 13} percent; "
                f"churn {(j * 5) % 11} percent; backlog {(j * 3) % 17} orders.")
        lines.append(line)
        size += len(line) + 1
        j += 1
    return ("\n".join(lines)[:n_chars] + "\nSummarize the risks in this report. Reply with "
            "one JSON object with the keys task_complete, action, arguments and reasoning.")


WAVES = 5


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


async def timed_waves(handler, requests, label, long_first=False, n_waves=WAVES,
                      profiled=False):
    """``n_waves`` waves of ``requests`` ((messages, max_new_tokens) pairs,
    greedy JSON). Plain waves give per wave the TTFT p50 (of the short
    prompts, the long one apart when ``long_first``: it is sent first and
    the rest once its segmented prefill has begun, as in 5b), the TPOT p50
    and the decode tokens/s. ``profiled`` waves run under torch.profiler
    and give the device's busy share of the wall instead: once the profiler
    has traced the card, launches in the process stay slower on the host
    (a graph replay by ~20 ms on this card), so every plain wave of a run
    comes before its first profiled one. Logs each wave, then the median
    and the spread; returns the waves and the first wave's device rows
    (profiled). Uses the engine's public entry points and the batcher's
    ``completed`` log only, so a parent tree's engine runs it too
    (``scripts/port_serving_ab.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pilottai_tpu_torch.engine.types import GenerationParams

    batcher = handler.backend.batcher

    def send(messages, n):
        return asyncio.ensure_future(handler.generate_response(
            messages, params=GenerationParams(temperature=0.0, max_new_tokens=n),
            json_mode=True))

    waves, rows0 = [], None
    for w in range(n_waves):
        batcher.completed.clear()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if long_first:
                seg0 = batcher.prefill_segments
                tasks = [send(*requests[0])]
                while (batcher._segmenting is None and batcher.prefill_segments == seg0
                       and not tasks[0].done()):
                    await asyncio.sleep(0.001)
                tasks += [send(*r) for r in requests[1:]]
            else:
                tasks = [send(*r) for r in requests]
            await asyncio.gather(*tasks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if profiled:
            rows = device_rows(prof)
            if w == 0:
                rows0 = rows
                report_profile(prof, wall * 1e6, f"wave 1 of {n_waves} ({label})")
            wave = {"busy": sum(r[0] for r in rows) / (wall * 1e6) if rows else None,
                    "wall_s": wall}
        else:
            timings = list(batcher.completed)
            long_t = [t["ttft_s"] for t in timings if long_first and t["prompt_tokens"] > 1000]
            short = [t for t in timings if not (long_first and t["prompt_tokens"] > 1000)]
            wave = {
                "ttft_ms": median(t["ttft_s"] for t in short) * 1e3,
                "ttft_long_ms": long_t[0] * 1e3 if long_t else None,
                "tpot_ms": median((t["e2e_s"] - t["ttft_s"]) / max(t["tokens"] - 1, 1)
                                  for t in timings) * 1e3,
                "tokens_s": sum(t["tokens"] for t in timings) / wall,
                "wall_s": wall,
            }
        waves.append(wave)
        log(f"  {'profiled ' if profiled else ''}wave {w + 1}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in wave.items()))
    for key in waves[0]:
        vals = [wv[key] for wv in waves if wv[key] is not None]
        if vals:
            log(f"  {label}, {n_waves} waves: {key} median {median(vals):.4f} "
                f"(min {min(vals):.4f}, max {max(vals):.4f})")
        else:
            log(f"  {label}, {n_waves} waves: {key} not measured")
    return waves, rows0


async def settle(batcher):
    """Wait until every dispatched chunk has been handed to the reader and
    folded: the launch counters and the steps dispatched then agree."""
    while batcher._results.qsize() or any(s is not None for s in batcher._slots):
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.05)


def device_rows(prof):
    """(device µs, name, count) of each device kernel a finished
    ``torch.profiler`` run saw, operator rows and user annotations left
    out."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", DeviceType.CUDA) == DeviceType.CPU
                or getattr(evt, "is_user_annotation", False)):
            continue
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev, evt.key, evt.count))
    return rows


def report_profile(prof, wall_us, label, top=8):
    """Log the device's busy share of ``wall_us`` and the kernels that fill
    it, from a finished ``torch.profiler`` run; returns the share. Only the
    device's own kernel rows count: an operator row (``aten::mm``, an
    autograd Function) carries the time of the kernels it launched, and a
    user annotation (``Optimizer.step#AdamW.step``) spans them on the
    device, so either would count them twice."""
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"  profiled {label}: the profiler saw no device time (busy share not measured)")
        return None
    log(f"  profiled {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms = {busy / wall_us:.3f} of the wall; top device time:")
    ranked = sorted(rows, reverse=True)
    for dev, key, count in ranked[:top]:
        log(f"    {dev / 1e3:9.2f} ms  {count:6d} x  {key[:90]}")
    # The port's own kernels, wherever they rank.
    ours = [r for r in ranked[top:] if any(n in r[1] for n in PORT_KERNEL_NAMES)]
    if ours:
        log("    and the port's kernels below those:")
    for dev, key, count in ours:
        log(f"    {dev / 1e3:9.2f} ms  {count:6d} x  {key[:90]}")
    return busy / wall_us


@contextlib.contextmanager
def plain_prefill_attention(fa):
    """Route the prefill's attention through the plain K1 while inside."""
    from pilottai_tpu_torch.models import transformer

    kernel = transformer.flash_attention
    transformer.flash_attention = lambda *a, **kw: fa.flash_attention_plain(*a, **kw)[0]
    try:
        yield
    finally:
        transformer.flash_attention = kernel


@contextlib.contextmanager
def recording_tail_k1(calls):
    """Record the shapes ``(T, S)`` and rows of every K1 launch of the tail
    prefill (``decode._tail_prefix_attn``: prefix hits and chunked-prefill
    segments) while inside; the launches themselves are the kernel's, and
    count as such. Shapes only: nothing is read from the card."""
    from pilottai_tpu_torch.engine import decode

    kernel = decode.flash_attention_with_lse

    def recording(q, k, *a, **kw):
        calls.append((q.shape[0], q.shape[1], k.shape[1]))
        return kernel(q, k, *a, **kw)

    decode.flash_attention_with_lse = recording
    try:
        yield
    finally:
        decode.flash_attention_with_lse = kernel


@contextlib.contextmanager
def plain_paged_attention(pa):
    """Route the decode step's paged attention through the plain K3 while
    inside."""
    from pilottai_tpu_torch.engine import decode

    kernel = decode.paged_decode_attention
    decode.paged_decode_attention = pa.paged_decode_attention_plain
    try:
        yield
    finally:
        decode.paged_decode_attention = kernel


def logits_agreement(got, want, rows):
    """max |difference| / max |logit| over ``rows``, and whether every row's
    argmax agrees (or its top-2 margin is within twice the difference)."""
    got, want = got[rows].float(), want[rows].float()
    diff = (got - want).abs()
    top = want.topk(2, dim=-1).values
    same = got.argmax(-1) == want.argmax(-1)
    close = (top[:, 0] - top[:, 1]) <= 2 * diff.max(dim=-1).values
    return {
        "rel": float(diff.max() / want.abs().max()),
        "max_diff": float(diff.max()),
        "max_logit": float(want.abs().max()),
        "same_argmax": bool(same.all()),
        "argmax_ok": bool((same | close).all()),
        "margin": float((top[:, 0] - top[:, 1]).min()),
    }


@contextlib.contextmanager
def plain_decode_attention(da):
    """Route the dense decode step's prefix attention through the plain K2
    while inside."""
    from pilottai_tpu_torch.engine import decode

    kernel = decode.decode_attention

    def plain(q, k, v, last, q_positions, scale, softcap, window, return_stats):
        return da.decode_attention_plain(q, k, v, last, q_positions, scale, softcap, window)

    decode.decode_attention = plain
    try:
        yield
    finally:
        decode.decode_attention = kernel


def decode_step_check(torch, mod, batcher):
    """One decode step of the batcher's live state (on its device thread,
    between two chunks) through its decode kernel, K2 on the dense cache or
    K3 on the paged one, and through that kernel's plain version: the
    logits of every live slot. The step writes only fresh rings, never the
    cache, and its launches are taken back out of the count."""
    from pilottai_tpu_torch.engine import decode

    cfg, cache, dstate = batcher.cfg, batcher.cache, batcher.dstate
    dev = batcher.device
    n0 = mod.launches
    pos = cache.lengths.clone()
    kw = {}
    if batcher.paged:
        kw = dict(table=torch.from_numpy(batcher.alloc.table.copy()).to(dev),
                  n_blocks=max(-(-int(pos.max()) // batcher.page_size), 1))

    def step():
        rings = decode.new_rings(cfg, batcher.n_slots, batcher.chunk_size,
                                 cache.layers[0][0].dtype, dev)
        return decode.decode_step_logits(batcher.params, cfg, cache, dstate.tokens, pos,
                                         pos - 1, rings, 0, **kw)

    got = step()
    with plain_paged_attention(mod) if batcher.paged else plain_decode_attention(mod):
        want = step()
    torch.cuda.synchronize()
    mod.launches = n0
    live = torch.nonzero(~dstate.done).flatten()
    out = logits_agreement(got, want, live)
    out["finite"] = bool(torch.isfinite(got).all())
    out["lengths"] = pos.tolist()
    return out


def phase_full_width(torch, kernels, seed):
    from pilottai_tpu_torch import LLMConfig, LLMHandler
    from pilottai_tpu_torch.models.transformer import forward_prefill

    fa, da = kernels["flash"], kernels["decode"]
    cfg = LLMConfig(provider="cuda", model_name="llama3-8b", dtype="bfloat16",
                    engine_slots=8, engine_admit_batch=8, engine_max_seq=2048,
                    engine_chunk=16, seed=seed, engine_prefix_cache=0)
    prompts = [[FULL_PROMPT.format(i=i)] for i in range(8)]
    shapes = {}
    state = {}

    async def run():
        handler = LLMHandler(cfg)
        t0 = time.perf_counter()
        await handler.start()
        torch.cuda.synchronize()
        log(f"  llama3-8b bf16 random init on the card in {time.perf_counter() - t0:.1f} s "
            f"({handler.backend.model_cfg.param_count() / 1e9:.2f}B params, "
            f"vocab {handler.backend.model_cfg.vocab_size})")
        params = {"temperature": 0.0, "max_new_tokens": 64}
        from pilottai_tpu_torch.engine.types import GenerationParams

        # Warm-up request (cuBLAS handles, allocator), not counted.
        await handler.generate_response(prompts[0], params=GenerationParams(
            temperature=0.0, max_new_tokens=4), json_mode=True)
        batcher = handler.backend.batcher
        decode = batcher._decode

        def watching():
            # The first step with all eight slots live is checked against
            # the plain K2.
            if "e2e" not in state and all(s is not None for s in batcher._slots):
                state["e2e"] = decode_step_check(torch, da, batcher)
            decode()

        batcher._decode = watching
        batcher.completed.clear()
        seen = record_requests(handler)
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        steps0 = batcher.blocks_dispatched
        t0 = time.perf_counter()
        replies = await asyncio.gather(*[
            handler.generate_response(p, params=GenerationParams(**params), json_mode=True)
            for p in prompts
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        await settle(batcher)
        launches = counts(kernels)
        per_step_check(launches, batcher, batcher.blocks_dispatched - steps0, "dense wave")
        batcher._decode = decode
        shapes["prompt_lens"] = [len(r.prompt_ids) for r in seen]
        shapes["gen_lens"] = [len(r.future.result()) for r in seen]
        timings = list(batcher.completed)
        peak = torch.cuda.max_memory_allocated()
        # Finite logits of the expected shape at full width, and the
        # first-token logits through K1 against the same forward with the
        # plain K1 on the same card.
        ids = torch.tensor([seen[0].prompt_ids], device=batcher.device)
        T = ids.shape[1]
        pos = torch.arange(T, device=batcher.device, dtype=torch.int32)[None]
        val = torch.tensor([T], device=batcher.device, dtype=torch.int32)
        logits, _, _ = forward_prefill(batcher.params, batcher.cfg, ids, pos, val)
        with plain_prefill_attention(fa):
            ref, _, _ = forward_prefill(batcher.params, batcher.cfg, ids, pos, val)
        finite = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (1, T, 384)
        e2e = logits_agreement(logits[0, T - 1][None], ref[0, T - 1][None], [0])
        shapes["model"] = handler.backend.model_cfg
        shapes["waves"], _ = await timed_waves(handler, [(p, 64) for p in prompts],
                                               "dense, 8 x 64 tokens")
        log(f"  after the waves: {graph_text(batcher)}")
        await handler.stop()
        return replies, wall, launches, timings, peak, finite, e2e

    replies, wall, launches, timings, peak, finite, e2e = asyncio.run(run())
    parsed = sum(1 for r in replies if parses(r.content))
    tokens = sum(t["tokens"] for t in timings)
    ttft = sorted(t["ttft_s"] for t in timings)
    tpot = sorted((t["e2e_s"] - t["ttft_s"]) / max(t["tokens"] - 1, 1) for t in timings)
    log(f"  8 requests, prompt tokens {shapes['prompt_lens']}, generated {shapes['gen_lens']}")
    log(f"  TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms; "
        f"TPOT p50 {tpot[len(tpot) // 2] * 1e3:.2f} ms; {tokens / wall:.1f} tokens/s over "
        f"{wall:.2f} s; peak memory {peak / 2**30:.2f} GiB")
    log(f"  JSON replies that parse: {parsed}/8; prefill logits finite: {finite}")
    e2e_ok = e2e["rel"] <= TOL_E2E and e2e["argmax_ok"]
    log(f"  first-token logits of a {shapes['prompt_lens'][0]}-token prompt, K1 vs plain K1 "
        f"(bf16): max |diff| {e2e['max_diff']:.3e} over max |logit| {e2e['max_logit']:.3e} "
        f"= {e2e['rel']:.3e}, tol {TOL_E2E:g}; same argmax {e2e['same_argmax']} "
        f"(top-2 margin {e2e['margin']:.3e}) {'ok' if e2e_ok else 'FAIL'}")
    step = state.get("e2e")
    step_ok = bool(step) and step["finite"] and step["rel"] <= TOL_E2E and step["argmax_ok"]
    if step:
        log(f"  one decode step of the live wave (slot lengths {step['lengths']}), K2 vs plain "
            f"K2 (bf16): max |diff| {step['max_diff']:.3e} over max |logit| "
            f"{step['max_logit']:.3e} = {step['rel']:.3e}, tol {TOL_E2E:g}; same argmax "
            f"{step['same_argmax']} (smallest top-2 margin {step['margin']:.3e}); finite "
            f"{step['finite']} {'ok' if step_ok else 'FAIL'}")
    else:
        log("  the wave never had all eight slots live: no decode-step check")
    log(f"  launches on this run: {launches_text(launches)}")
    if launches["flash"] <= 0 or launches["decode"] <= 0 or launches["paged"] != 0:
        raise SystemExit("the dense main path did not go through K1 and K2 alone")
    if parsed != 8 or not finite or not e2e_ok or not step_ok:
        raise SystemExit("full-width outputs are wrong")
    return launches, shapes


def phase_busy(torch, seed):
    """The device's busy share of five profiled waves of each llama3-8b
    workload, each on a fresh engine after one plain warm-up wave (the
    graphs captured). Runs after 5a and 5b, whose plain waves must not
    follow a profiled one. Returns K2's device time and launches in the
    first dense wave."""
    from pilottai_tpu_torch import LLMConfig, LLMHandler

    dense = [[FULL_PROMPT.format(i=i)] for i in range(8)]
    out = {}
    for label, max_seq, prompts, long_first in (
            ("dense, 8 x 64 tokens", 2048, dense, False),
            ("paged, 1 long + 7 short x 64 tokens", 8192, [[long_prompt(5900)]] + dense[:7],
             True)):
        async def run():
            handler = LLMHandler(LLMConfig(provider="cuda", model_name="llama3-8b",
                                           dtype="bfloat16", engine_slots=8,
                                           engine_admit_batch=8, engine_max_seq=max_seq,
                                           engine_chunk=16, seed=seed, engine_prefix_cache=0))
            await handler.start()
            try:
                reqs = [(p, 64) for p in prompts]
                await timed_waves(handler, reqs, f"{label}, warm-up", long_first, 1)
                return await timed_waves(handler, reqs, label, long_first, profiled=True)
            finally:
                await handler.stop()

        _, rows = asyncio.run(run())
        # fp32 GEMMs on the CUDA cores: the prefill's fp32 logits head, and
        # before the tail attention went through K1 the segments' prefix
        # einsums (~216 ms a paged wave).
        f32 = [(dev, key, count) for dev, key, count in rows or [] if "f32f32" in key]
        log(f"  fp32 GEMMs (f32f32) in the first profiled wave ({label}): {len(f32)} kernels, "
            f"{sum(c for _, _, c in f32)} launches, {sum(d for d, _, _ in f32) / 1e3:.2f} ms"
            + "".join(f"; {key[:70]} {count} x {dev / 1e3:.2f} ms" for dev, key, count in f32))
        if "wave_k2" not in out:
            # K2's device time a launch inside the wave, beside the harness's.
            k2 = [(dev, count) for dev, key, count in rows if "decode_split" in key]
            if k2:
                out["wave_k2"] = (sum(d for d, _ in k2), sum(c for _, c in k2))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def parses(text: str) -> bool:
    try:
        json.loads(text)
        return True
    except json.JSONDecodeError:
        return False


def phase_full_width_paged(torch, kernels, seed):
    """llama3-8b with an 8192-token context (paging switches on by itself):
    one long prompt, admitted in 1024-token segments, and seven short ones
    behind it; the long one is at the head of the queue, so all eight decode
    together once it is in."""
    from pilottai_tpu_torch import LLMConfig, LLMHandler
    from pilottai_tpu_torch.engine.types import GenerationParams

    pa = kernels["paged"]
    cfg = LLMConfig(provider="cuda", model_name="llama3-8b", dtype="bfloat16",
                    engine_slots=8, engine_admit_batch=8, engine_max_seq=8192,
                    engine_chunk=16, seed=seed, engine_prefix_cache=0)
    requests = [[long_prompt(5900)]] + [[FULL_PROMPT.format(i=i)] for i in range(7)]
    state = {"peak_pages": 0}

    async def run():
        handler = LLMHandler(cfg)
        t0 = time.perf_counter()
        await handler.start()
        torch.cuda.synchronize()
        batcher = handler.backend.batcher
        log(f"  llama3-8b bf16 random init, engine_max_seq 8192, on the card in "
            f"{time.perf_counter() - t0:.1f} s; paged {batcher.paged}: {batcher.num_pages} "
            f"pages of {batcher.page_size} (the last one scratch), prefill segments of "
            f"{batcher.prefill_chunk}, slot capacity {batcher.max_seq_len}")
        if not batcher.paged:
            raise SystemExit("engine_max_seq 8192 did not page the cache")
        await handler.generate_response(requests[1], params=GenerationParams(
            temperature=0.0, max_new_tokens=4), json_mode=True)
        decode = batcher._decode

        def watching():
            used = batcher.num_pages - 1 - batcher.alloc.free_pages
            state["peak_pages"] = max(state["peak_pages"], used)
            if all(s is not None for s in batcher._slots):
                # The first step with all eight live is checked against the
                # plain K3; the last one gives K3's timing shape.
                if "e2e" not in state:
                    state["e2e"] = decode_step_check(torch, pa, batcher)
                state["last"] = [int(n) - 1 for n in batcher.cache.lengths.tolist()]
                state["table"] = batcher.alloc.table.tolist()
            decode()

        batcher._decode = watching
        batcher.completed.clear()
        seen = record_requests(handler)
        seg0 = batcher.prefill_segments
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        steps0 = batcher.blocks_dispatched
        t0 = time.perf_counter()
        def send(p):
            return asyncio.ensure_future(handler.generate_response(
                p, params=GenerationParams(temperature=0.0, max_new_tokens=64),
                json_mode=True))

        # The long prompt heads the queue: the short ones are sent once its
        # segmented prefill has begun, and wait behind it (FIFO admission).
        with recording_tail_k1(state.setdefault("tail_calls", [])):
            tasks = [send(requests[0])]
            while (batcher._segmenting is None and batcher.prefill_segments == seg0
                   and not tasks[0].done()):
                await asyncio.sleep(0.001)
            tasks += [send(p) for p in requests[1:]]
            replies = await asyncio.gather(*tasks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            await settle(batcher)
        launches = counts(kernels)
        per_step_check(launches, batcher, batcher.blocks_dispatched - steps0, "paged wave")
        batcher._decode = decode
        out = dict(
            replies=replies, wall=wall, launches=launches,
            timings=list(batcher.completed), peak=torch.cuda.max_memory_allocated(),
            prompt_lens=[len(r.prompt_ids) for r in seen],
            gen_lens=[len(r.future.result()) for r in seen],
            segments=batcher.prefill_segments - seg0,
            free_after=batcher.alloc.free_pages, usable=batcher.num_pages - 1,
            table_clear=bool((batcher.alloc.table == batcher.alloc.sentinel).all()),
            num_pages=batcher.num_pages, P=batcher.page_size, R=batcher.chunk_size,
            model=handler.backend.model_cfg,
        )
        out["waves"], _ = await timed_waves(handler, [(p, 64) for p in requests],
                                            "paged, 1 long + 7 short x 64 tokens",
                                            long_first=True)
        log(f"  after the waves: {graph_text(batcher)}")
        await handler.stop()
        return out

    out = asyncio.run(run())
    timings = out["timings"]
    long_t = [t for t in timings if t["prompt_tokens"] > 1000]
    short_t = sorted((t for t in timings if t["prompt_tokens"] <= 1000),
                     key=lambda t: t["ttft_s"])
    tokens = sum(t["tokens"] for t in timings)
    tpot = sorted((t["e2e_s"] - t["ttft_s"]) / max(t["tokens"] - 1, 1) for t in timings)
    parsed = sum(1 for r in out["replies"] if parses(r.content))
    log(f"  8 requests, prompt tokens {out['prompt_lens']}, generated {out['gen_lens']}")
    log(f"  TTFT long {long_t[0]['ttft_s'] * 1e3:.1f} ms; TTFT short p50 "
        f"{short_t[len(short_t) // 2]['ttft_s'] * 1e3:.1f} ms max "
        f"{short_t[-1]['ttft_s'] * 1e3:.1f} ms; TPOT p50 {tpot[len(tpot) // 2] * 1e3:.2f} ms; "
        f"{tokens / out['wall']:.1f} tokens/s over {out['wall']:.2f} s; peak memory "
        f"{out['peak'] / 2**30:.2f} GiB")
    log(f"  prefill segments {out['segments']}; pages in use at the peak {state['peak_pages']} "
        f"of {out['usable']}; free after the wave {out['free_after']} of {out['usable']}, "
        f"block table clear {out['table_clear']}; JSON replies that parse: {parsed}/8")
    log(f"  launches on this run: {launches_text(out['launches'])}")
    e2e = state.get("e2e")
    e2e_ok = bool(e2e) and e2e["finite"] and e2e["rel"] <= TOL_E2E and e2e["argmax_ok"]
    if e2e:
        log(f"  one decode step of the live wave (slot lengths {e2e['lengths']}), K3 vs plain "
            f"K3 (bf16): max |diff| {e2e['max_diff']:.3e} over max |logit| "
            f"{e2e['max_logit']:.3e} = {e2e['rel']:.3e}, tol {TOL_E2E:g}; same argmax "
            f"{e2e['same_argmax']} (smallest top-2 margin {e2e['margin']:.3e}); finite "
            f"{e2e['finite']} {'ok' if e2e_ok else 'FAIL'}")
    else:
        log("  the wave never had all eight slots live: no decode-step check")
    launches = out["launches"]
    if launches["flash"] <= 0 or launches["paged"] <= 0 or launches["decode"] != 0:
        raise SystemExit("the paged main path did not go through K1 and K3 with K2 at zero")
    if out["segments"] <= 0 or out["free_after"] != out["usable"] or not out["table_clear"]:
        raise SystemExit("chunked prefill did not run, or pages were not returned")
    if parsed != 8 or not e2e_ok:
        raise SystemExit("paged full-width outputs are wrong")
    shapes = dict(last=state["last"], table=state["table"], num_pages=out["num_pages"],
                  P=out["P"], R=out["R"], step=out["R"] // 2, model=out["model"],
                  requests=len(requests))
    # The segments' tail attention: every extend segment and the final one
    # is one K1 launch a layer over the chain and the segment; the timing
    # phase takes the widest (the final segment over the longest chain).
    calls = state["tail_calls"]
    long_len = max(out["prompt_lens"])
    A, T, S = max(calls, key=lambda c: c[2])
    shapes["segment"] = dict(A=A, T=T, plen=S - T, tails=[min(T, long_len - (S - T))],
                             launches=len(calls), model=out["model"])
    log(f"  the segments' tail attention: {len(calls)} K1 launches "
        f"({len(calls) // out['model'].n_layers} tail prefills of {out['model'].n_layers} "
        f"layers), widest q [{A},{T}] against S {S} (a {S - T}-token chain)")
    return launches, shapes


# --------------------------------------------------------------------- #
# Phase 5d: agent steps sharing a preamble, with the prefix cache
# --------------------------------------------------------------------- #

# The system message of every request: the leading bytes of the port's
# protocol rules text (one byte a token).
PREAMBLE_BYTES = 900
# Each request's own task, about 120 tokens, differing in every request of
# every wave from its first digit on.
AGENT_TASK = ("Request {r}: plan the next step of the document pipeline for report {r}. "
              "Reply with one JSON object: task_complete, action, arguments, reasoning.")


def agent_step_prompts(root, wave, n=8):
    """The ``n`` requests of one wave: the shared preamble as the system
    message, then a task of their own."""
    from pilottai_tpu_torch.engine.types import ChatMessage

    preamble = (root / "pilottai_tpu_torch" / "prompts" / "rules.json").read_text()
    return [[ChatMessage(role="system", content=preamble[:PREAMBLE_BYTES]),
             ChatMessage(role="user", content=AGENT_TASK.format(r=wave * n + i))]
            for i in range(n)]


async def agent_wave(handler, prompts, max_new=64):
    """One wave of greedy JSON requests sent at once: TTFT p50, TPOT p50,
    decode tokens/s and the wall, and how many replies parse."""
    from pilottai_tpu_torch.engine.types import GenerationParams

    batcher = handler.backend.batcher
    batcher.completed.clear()
    t0 = time.perf_counter()
    replies = await asyncio.gather(*[
        handler.generate_response(p, params=GenerationParams(temperature=0.0,
                                                             max_new_tokens=max_new),
                                  json_mode=True)
        for p in prompts])
    wall = time.perf_counter() - t0
    timings = list(batcher.completed)
    return {
        "ttft_ms": median(t["ttft_s"] for t in timings) * 1e3,
        "tpot_ms": median((t["e2e_s"] - t["ttft_s"]) / max(t["tokens"] - 1, 1)
                          for t in timings) * 1e3,
        "tokens_s": sum(t["tokens"] for t in timings) / wall,
        "wall_s": wall,
        "parsed": sum(1 for r in replies if parses(r.content)),
    }


def hit_logits_check(torch, batcher, prompt_ids):
    """One warm prompt's first-token logits through the hit path (its tail
    prefilled against the cached prefix: the store's entry on the dense
    cache, the page chain on the paged one; one K1 launch a layer) against
    a full K1 prefill of the same prompt, on the engine's own weights and
    cache while it is idle."""
    from pilottai_tpu_torch.engine import decode
    from pilottai_tpu_torch.models.transformer import forward_prefill

    dev, cfg, params = batcher.device, batcher.cfg, batcher.params
    torch.cuda.synchronize()
    if batcher.paged:
        node = batcher.page_index.match(prompt_ids)
        plen = node.depth * batcher.page_size
        layer = decode._chain_layer(batcher.cache,
                                    torch.tensor(node.path_pages, device=dev, dtype=torch.long))
    else:
        entry = batcher.prefix_store.match(prompt_ids)
        plen = len(entry.ids)

        def layer(l):
            return entry.ks[l], entry.vs[l]
    tail = prompt_ids[plen:]
    tokens = torch.zeros((1, batcher._tail_bucket(len(tail))), dtype=torch.long, device=dev)
    tokens[0, : len(tail)] = torch.tensor(tail, device=dev)
    hit, _, _ = decode._tail_prefill(params, cfg, layer, plen, tokens,
                                     torch.tensor([len(tail)], device=dev, dtype=torch.int32))
    T = len(prompt_ids)
    ids = torch.tensor([prompt_ids], device=dev)
    full, _, _ = forward_prefill(params, cfg, ids,
                                 torch.arange(T, device=dev, dtype=torch.int32)[None],
                                 torch.tensor([T], device=dev, dtype=torch.int32))
    out = logits_agreement(hit[0, len(tail) - 1][None], full[0, T - 1][None], [0])
    out.update(finite=bool(torch.isfinite(hit).all()), plen=plen, tail=len(tail))
    return out


def phase_prefix_agent_steps(torch, kernels, root, seed, paged):
    """llama3-8b, 8 concurrent agent steps a wave sharing the preamble: a
    cold wave (it stores entries or pins pages, and captures the graphs),
    then ``WAVES`` timed waves of new tasks on the same engine with the
    prefix cache on (every request a hit, its tail prefilled through one K1
    launch a layer), and the same waves on an engine with the cache off.
    Returns the hit path's K1 launches and shape."""
    from pilottai_tpu_torch import LLMConfig, LLMHandler

    waves = [agent_step_prompts(root, w) for w in range(1 + WAVES)]
    knobs = dict(engine_max_seq=8192) if paged else dict(engine_max_seq=2048)
    results = {}

    async def serve(prefix_cache):
        handler = LLMHandler(LLMConfig(
            provider="cuda", model_name="llama3-8b", dtype="bfloat16", engine_slots=8,
            engine_admit_batch=8, engine_chunk=16, seed=seed,
            engine_prefix_cache=prefix_cache, **knobs))
        await handler.start()
        batcher = handler.backend.batcher
        if batcher.paged != paged:
            raise SystemExit("5d: the engine did not page as configured")
        seen = record_requests(handler)
        out = {"cold": await agent_wave(handler, waves[0]), "waves": [], "hits": [],
               "calls": []}
        await settle(batcher)
        out["cold_report"] = batcher.prefix_report()
        reset(kernels)
        with recording_tail_k1(out["calls"]):
            for w in waves[1:]:
                h0 = batcher.prefix_hits
                out["waves"].append(await agent_wave(handler, w))
                out["hits"].append(batcher.prefix_hits - h0)
            await settle(batcher)
        out["launches"] = counts(kernels)
        out["report"] = batcher.prefix_report()
        out["prompt_lens"] = [len(r.prompt_ids) for r in seen]
        out["graphs"] = graph_text(batcher)
        out["model"] = handler.backend.model_cfg
        out["pages"] = ((batcher.alloc.free_pages, batcher.num_pages - 1) if paged else None)
        if prefix_cache:
            out["e2e"] = hit_logits_check(torch, batcher, list(seen[-1].prompt_ids))
        await handler.stop()
        return out

    for label, prefix_cache in (("cache on", 4), ("cache off", 0)):
        log(f"  -- {label} (engine_prefix_cache={prefix_cache})")
        r = results[label] = asyncio.run(serve(prefix_cache))
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  cold wave: {r['cold']}; prefix cache after it: {r['cold_report'] or 'off'}")
        for i, (wave, hits) in enumerate(zip(r["waves"], r["hits"])):
            log(f"  wave {i + 1}: prefix hits {hits}, " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in wave.items()))
        for key in ("ttft_ms", "tpot_ms", "tokens_s"):
            vals = [wv[key] for wv in r["waves"]]
            log(f"  {label}, {WAVES} waves: {key} median {median(vals):.4f} "
                f"(min {min(vals):.4f}, max {max(vals):.4f})")
        log(f"  prompt tokens {sorted(set(r['prompt_lens']))}; {r['graphs']}")
        log(f"  launches over the timed waves: {launches_text(r['launches'])}")
        if r["report"]:
            log(f"  prefix cache after the waves: {r['report']}")
        if any(wv["parsed"] != 8 for wv in r["waves"] + [r["cold"]]):
            raise SystemExit(f"5d ({label}): a JSON reply does not parse")
    on, off = results["cache on"], results["cache off"]
    calls, model = on["calls"], on["model"]
    shapes = sorted({(A, T, S) for A, T, S in calls})
    A, T, S = max(calls, key=lambda c: (c[0], c[2])) if calls else (0, 0, 0)
    kv_mib = A * S * model.n_kv_heads * model.head_dim * 2 / 2**20
    log(f"  hit path: {len(calls)} K1 launches over the timed waves (q [A, T] against S keys: "
        f"{shapes}); one layer's keys, expanded over the rows with the tail behind them, "
        f"{kv_mib:.1f} MiB, and as much for the values (A {A}, S {S}, {model.n_kv_heads} kv "
        f"heads of {model.head_dim}, bf16), transient")
    e2e = on["e2e"]
    e2e_ok = e2e["finite"] and e2e["rel"] <= TOL_E2E and e2e["same_argmax"]
    log(f"  first-token logits of a warm {len(on['prompt_lens']) and on['prompt_lens'][-1]}-token "
        f"prompt, hit path (a {e2e['tail']}-token tail against the {e2e['plen']}-token cached "
        f"prefix) vs a full K1 prefill (bf16): max |diff| {e2e['max_diff']:.3e} over max "
        f"|logit| {e2e['max_logit']:.3e} = {e2e['rel']:.3e}, tol {TOL_E2E:g}; same argmax "
        f"{e2e['same_argmax']} (top-2 margin {e2e['margin']:.3e}) {'ok' if e2e_ok else 'FAIL'}")
    for key in ("ttft_ms", "tpot_ms"):
        a = median([wv[key] for wv in on["waves"]])
        b = median([wv[key] for wv in off["waves"]])
        log(f"  {key} p50 median: cache on {a:.4f}, cache off {b:.4f} ({a / b:.3f} of off)")
    report = on["report"]
    if paged:
        free, usable = on["pages"]
        log(f"  pages after the waves: {free} free + {report['pinned_pages']} pinned of {usable}")
        if free + report["pinned_pages"] != usable:
            raise SystemExit("5d: pages were neither returned nor pinned")
    else:
        log(f"  store: {report['entries']} entries of {report['entry_tokens']} tokens, "
            f"{report['bytes'] / 2**20:.1f} MiB")
    if any(h != 8 for h in on["hits"]) or report["export_failures"] or any(off["hits"]):
        raise SystemExit("5d: a warm wave did not hit 8 times, or an export failed")
    if on["launches"]["flash"] != len(calls) or not calls or not e2e_ok:
        raise SystemExit("5d: the hit path did not run through K1 alone, or its logits are off")
    plen = S - T
    return dict(A=A, T=T, plen=plen, tails=[n - plen for n in on["prompt_lens"][-A:]],
                launches=len(calls), model=model)


# --------------------------------------------------------------------- #
# Phase 7: training (golden protocol-s in fp32; llama3-1b at full width)
# --------------------------------------------------------------------- #

def batches_sha256(np, batches) -> str:
    """sha256 of every batch's int32 tokens, valid and loss_start, in order
    (as ``scripts/export_protocol_s_train_golden.py`` hashes them)."""
    import hashlib

    h = hashlib.sha256()
    for b in batches:
        for key in ("tokens", "valid", "loss_start"):
            h.update(np.ascontiguousarray(b[key], dtype=np.int32).tobytes())
    return h.hexdigest()


def expect_train_launches(launches, layers, steps, label):
    """Remat runs each layer's forward twice per step (K1), the backward
    once (K4, K5); serving kernels stay at zero."""
    want = {"flash": 2 * layers * steps, "bwd_dq": layers * steps, "bwd_dkv": layers * steps,
            "decode": 0, "paged": 0}
    log(f"  launches on this run ({steps} steps x {layers} layers): {launches_text(launches)}; "
        f"expected flash_fwd {want['flash']}, flash_bwd_dq {want['bwd_dq']}, flash_bwd_dkv "
        f"{want['bwd_dkv']}, the serving kernels 0")
    if launches != want:
        raise SystemExit(f"the {label} training path did not launch K1, K4 and K5 as expected")


def phase_train_golden(torch, kernels, root):
    """Four fp32 steps of the port's Trainer from the shipped protocol-s
    checkpoint, held to the JAX trainer's losses and grad norms."""
    import numpy as np

    from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ, load_npz
    from pilottai_tpu_torch.models.registry import get_model_config
    from pilottai_tpu_torch.train.protocol import protocol_batches
    from pilottai_tpu_torch.train.trainer import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = json.loads((root / "pilottai_tpu_torch" / "assets" /
                         "protocol_s_train_golden.json").read_text())
    cfg = get_model_config(golden["model"]).replace(dtype=torch.float32)
    trainer = Trainer(cfg, TrainConfig(**golden["train_config"]))
    state = trainer.init_from_params(load_npz(PROTOCOL_S_NPZ, cfg, dtype=torch.float32))
    spec = golden["batches"]
    stream = protocol_batches(spec["batch_size"], spec["seq_len"], seed=spec["seed"])
    batches = [next(stream) for _ in range(golden["steps"])]
    same_batches = batches_sha256(np, batches) == golden["batches_sha256"]
    log(f"  protocol_batches({spec['batch_size']}, {spec['seq_len']}, seed={spec['seed']}): "
        f"valid lengths {[b['valid'].tolist() for b in batches]}; hash equals the golden's: "
        f"{same_batches}; TF32 off")
    reset(kernels)
    got = []
    for batch in batches:
        state, metrics = trainer.step(state, batch)
        got.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    torch.cuda.synchronize()
    launches = counts(kernels)
    ok = same_batches
    for i, ((loss, norm), want) in enumerate(zip(got, golden["per_step"])):
        rl = abs(loss - want["loss"]) / abs(want["loss"])
        rn = abs(norm - want["grad_norm"]) / abs(want["grad_norm"])
        step_ok = rl <= TOL_TRAIN_GOLDEN["loss"] and rn <= TOL_TRAIN_GOLDEN["grad_norm"]
        ok &= step_ok
        log(f"  step {i}: loss {loss:.9g} (JAX {want['loss']:.9g}, rel {rl:.2e}) grad_norm "
            f"{norm:.9g} (JAX {want['grad_norm']:.9g}, rel {rn:.2e}) tol loss "
            f"{TOL_TRAIN_GOLDEN['loss']:g} grad_norm {TOL_TRAIN_GOLDEN['grad_norm']:g} "
            f"{'ok' if step_ok else 'FAIL'}")
    expect_train_launches(launches, cfg.n_layers, len(batches), "golden")
    if not ok:
        raise SystemExit("the golden training steps differ from the JAX trainer's")
    shapes = dict(B=spec["batch_size"], T=spec["seq_len"],
                  lens=[int(n) for n in batches[0]["valid"]], model=cfg)
    return launches, shapes


@contextlib.contextmanager
def plain_train_attention(fa):
    """Route the autograd Function's forward and backward through the plain
    K1, K4 and K5 while inside."""
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd = fa.flash_attention_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd


def train_grads(trainer, state, batch):
    """Every master leaf's gradient of one loss at the state's parameters
    (no update)."""
    from pilottai_tpu_torch.train.trainer import param_leaves

    trainer.loss_and_grads(state, batch)
    leaves = param_leaves(state.params)
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return grads


def phase_train_full(torch, kernels, seed, model="llama3-1b", B=4, T=2048):
    """llama3-1b, bf16 compute over fp32 master weights, remat on: 8 steps on
    one fixed batch of 4 x 2048, then a profiled step and the gradient
    check against the plain kernels."""
    from torch.profiler import ProfilerActivity, profile

    from pilottai_tpu_torch.models.registry import get_model_config
    from pilottai_tpu_torch.train.trainer import TrainConfig, Trainer, synthetic_batches

    fa = kernels["flash"]
    cfg = get_model_config(model)
    trainer = Trainer(cfg, TrainConfig(learning_rate=3e-4, warmup_steps=2,
                                       total_steps=TRAIN_STEPS, remat=True))
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    state = trainer.init(gen)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    log(f"  {model} fp32 master weights from random init (seed {seed}) in "
        f"{time.perf_counter() - t0:.1f} s: {n_params / 1e9:.3f}B params, vocab "
        f"{cfg.vocab_size}, tied head; compute {str(cfg.dtype)[6:]}, remat on")
    batch = next(synthetic_batches(cfg, B, T, seed=seed))
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        log(f"  step {i}: loss {losses[-1]:.6g} grad_norm {norms[-1]:.6g} "
            f"lr {state.scheduler.get_last_lr()[0]:.3g} (next) {times[-1] * 1e3:.1f} ms")
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(times[1:])
    p50 = steady[len(steady) // 2]
    tokens = B * T
    pairs = B * T * (T + 1) // 2
    attn_flops = 3 * 4 * cfg.n_heads * cfg.head_dim * pairs * cfg.n_layers
    model_flops = 6 * n_params * tokens + attn_flops
    mfu = model_flops / (p50 * PEAK_FLOPS["bfloat16"])
    log(f"  step time p50 {p50 * 1e3:.1f} ms (steps 1-{TRAIN_STEPS - 1}; min "
        f"{steady[0] * 1e3:.1f}, max {steady[-1] * 1e3:.1f}; step 0 {times[0] * 1e3:.1f} ms); "
        f"{tokens / p50:.0f} tokens/s; MFU {mfu:.4f} = (6 x {n_params:.4g} params x {tokens} "
        f"tokens + {attn_flops:.4g} attention FLOPs) / (step x 989e12); peak memory "
        f"{peak / 2**30:.2f} GiB")
    expect_train_launches(launches, cfg.n_layers, TRAIN_STEPS, model)
    finite = all(math.isfinite(x) for x in losses + norms)
    if not finite or not losses[-1] < losses[0]:
        raise SystemExit(f"{model} training did not lower a finite loss: {losses}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = report_profile(prof, wall_us, f"train step ({model}, {B} x {T})", top=12)

    before = counts(kernels)
    got = train_grads(trainer, state, batch)
    with plain_train_attention(fa):
        want = train_grads(trainer, state, batch)
    torch.cuda.synchronize()
    if counts(kernels) != dict(before, flash=before["flash"] + 2 * cfg.n_layers,
                               bwd_dq=before["bwd_dq"] + cfg.n_layers,
                               bwd_dkv=before["bwd_dkv"] + cfg.n_layers):
        raise SystemExit("the gradient check's kernel and plain runs launched the wrong kernels")
    from pilottai_tpu_torch.train.trainer import named_leaves

    worst, where, finite = -1.0, "", True
    for (name, _), g, w in zip(named_leaves(state.params), got, want):
        finite &= bool(torch.isfinite(g).all())
        rel = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, where = rel, name
    grads_ok = finite and worst <= TOL_E2E_TRAIN
    log(f"  one step's gradients, K1/K4/K5 vs plain K1/K4/K5 (bf16 compute, {len(got)} "
        f"leaves): largest max |diff| / max |grad| {worst:.3e} at {where}, tol "
        f"{TOL_E2E_TRAIN:g}; finite {finite} {'ok' if grads_ok else 'FAIL'}")
    del got, want, state, trainer
    if not grads_ok:
        raise SystemExit(f"{model} gradients through the kernels disagree with the plain ones")
    shapes = dict(B=B, T=T, lens=[T] * B, model=cfg, step_ms=p50 * 1e3, busy=busy)
    return launches, shapes


# --------------------------------------------------------------------- #
# Phase 6: timing at the main path's shapes
# --------------------------------------------------------------------- #

def entry(name, mod, launched, err, ms, plain, lib, flops, nbytes, dtype_name, tol,
          kernel="", **extra):
    """One kernels-line entry. ``kernel`` picks the module's K4 ("_DQ") or
    K5 ("_DKV") source and TPU origin instead of its first kernel's."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": getattr(mod, "SOURCE" + kernel),
        "replaces": getattr(mod, "REPLACES" + kernel),
        "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib, "dtype": dtype_name, "tolerance": tol, **extra,
    }


def profiled_launch_ms(torch, fn, name, iters=20):
    """The device time a launch of the kernel named ``name`` that ``fn``
    launches, from ``torch.profiler`` over ``iters`` calls queued back to
    back (L2 warm): the kernel's own duration, where a pair of CUDA events
    brackets the launch too. None if the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(dev, count) for dev, key, count in device_rows(prof) if name in key]
    return sum(d for d, _ in rows) / sum(c for _, c in rows) / 1e3 if rows else None


def time_kernels(torch, fa, da, device, timer, gen, dtype, cfg, flash, decode, launches,
                 worst, suffix=""):
    """Time K1 and K2 (kernel, plain version, SDPA) at one path's shapes in
    ``dtype`` and return their two entries of the kernels line."""
    import torch.nn.functional as F

    from pilottai_tpu_torch.ops.attention import prefill_mask

    dn = str(dtype)[6:]
    esz = torch.finfo(dtype).bits // 8
    N, K, H = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = N // K

    # K1 at the admission group's prefill shape.
    B, T, lens = flash["B"], flash["T"], flash["lens"]
    q = randn(torch, gen, (B, T, N, H), dtype, device)
    k = randn(torch, gen, (B, T, K, H), dtype, device)
    v = randn(torch, gen, (B, T, K, H), dtype, device)
    pos = torch.arange(T, device=device, dtype=torch.int32)[None].repeat(B, 1)
    val = torch.tensor(lens, device=device, dtype=torch.int32)
    k1 = timer.ms(lambda: fa.flash_attention_with_lse(q, k, v, pos, pos, val))
    k1_plain = timer.ms(lambda: fa.flash_attention_plain(q, k, v, pos, pos, val))
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    ks, vs = ks.repeat_interleave(G, dim=1), vs.repeat_interleave(G, dim=1)
    mask = prefill_mask(pos, pos, val)[:, None]
    k1_lib = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
    pairs = sum(sum(min(t + 1, n) for t in range(T)) for n in lens)
    k1_flops = 4 * H * N * pairs
    k1_bytes = esz * (2 * B * T * N * H) + 2 * esz * sum(lens) * K * H + 4 * B * N * T

    # K2 at a mid-generation decode step of the same requests.
    B, S, last = decode["B"], decode["S"], decode["last"]
    qd = randn(torch, gen, (B, N, H), dtype, device)
    kc = randn(torch, gen, (B, K, S, H), dtype, device)
    vc = randn(torch, gen, (B, K, S, H), dtype, device)
    lst = torch.tensor(last, device=device, dtype=torch.int32)
    k2 = timer.ms(lambda: da.decode_attention(qd, kc, vc, lst, lst, return_stats=True))
    k2_warm = timer.ms(lambda: da.decode_attention(qd, kc, vc, lst, lst, return_stats=True),
                       flush=False)
    k2_profiled = profiled_launch_ms(
        torch, lambda: da.decode_attention(qd, kc, vc, lst, lst, return_stats=True),
        "decode_split")
    k2_plain = timer.ms(lambda: da.decode_attention_plain(qd, kc, vc, lst, lst, H**-0.5))
    kce, vce = kc.repeat_interleave(G, dim=1), vc.repeat_interleave(G, dim=1)
    dmask = (torch.arange(S, device=device)[None, :] <= lst[:, None])[:, None, None, :]
    k2_lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], kce, vce, attn_mask=dmask))
    keys = sum(n + 1 for n in last if n >= 0)
    k2_flops = 4 * H * N * keys
    k2_bytes = 2 * esz * keys * K * H + esz * B * N * H + 4 * B * N * H + 2 * 4 * B * N

    kernels = [
        entry("flash_fwd" + suffix, fa, launches["flash"], worst[("flash", dn)], k1, k1_plain,
              k1_lib, k1_flops, k1_bytes, dn, tol_text(dn, True)),
        entry("decode_attention" + suffix, da, launches["decode"], worst[("decode", dn)], k2,
              k2_plain, k2_lib, k2_flops, k2_bytes, dn, tol_text(dn, False), warm_ms=k2_warm,
              profiled_ms=k2_profiled,
              splits=da.split_count(B, K, S, torch.cuda.get_device_properties(device)
                                    .multi_processor_count)),
    ]
    wave = decode.get("wave")
    if wave:
        kernels[1]["wave_ms"] = wave[0] / wave[1] / 1e3
        kernels[1]["wave_launches_profiled"] = wave[1]
    profiled_text = "not measured" if k2_profiled is None else f"{k2_profiled:.4f} ms"
    wave_text = (f", in the profiled wave {kernels[1]['wave_ms']:.4f} ms a launch "
                 f"({wave[1]} launches)" if wave else "")
    log(f"  K1 flash_fwd {dn:<8} q [{flash['B']},{T},{N},{H}] valid {lens}: kernel {k1:.4f} ms, "
        f"plain {k1_plain:.4f} ms, SDPA {k1_lib:.4f} ms, bound {kernels[0]['bound_ms']:.5f} ms "
        f"({kernels[0]['bound_by']})")
    log(f"  K2 decode    {dn:<8} q [{B},{N},{H}] cache S {S} last {last}, "
        f"{kernels[1]['splits']} splits: kernel {k2:.4f} ms (L2 warm {k2_warm:.4f} ms, "
        f"profiled {profiled_text} a launch{wave_text}), plain {k2_plain:.4f} ms, SDPA "
        f"{k2_lib:.4f} ms, bound {kernels[1]['bound_ms']:.5f} ms ({kernels[1]['bound_by']})")
    return kernels


def time_paged(torch, pa, device, timer, gen, dtype, shape, launched, worst, suffix="",
               **extra):
    """Time K3 (kernel, plain version, SDPA over panels gathered beforehand)
    at one paged path's decode step: its slots' lengths and block table, a
    pool of its size, the ring ``step`` rows into a chunk. Returns its entry
    of the kernels line."""
    import torch.nn.functional as F

    from pilottai_tpu_torch.ops.paged import gather_pages

    dn = str(dtype)[6:]
    esz = torch.finfo(dtype).bits // 8
    cfg = shape["model"]
    N, K, H = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = N // K
    P, num_pages, R, step, last = shape["P"], shape["num_pages"], shape["R"], shape["step"], \
        shape["last"]
    B = len(last)
    sentinel = num_pages - 1
    table = torch.tensor([[p if p >= 0 else sentinel for p in row] for row in shape["table"]],
                         device=device, dtype=torch.int32)
    n_blocks = max(-(-(max(last) + 1) // P), 1)
    k_pool = randn(torch, gen, (K, num_pages, P, H), dtype, device)
    v_pool = randn(torch, gen, (K, num_pages, P, H), dtype, device)
    q = randn(torch, gen, (B, N, H), dtype, device)
    rk = randn(torch, gen, (B, K, R, H), dtype, device)
    rv = randn(torch, gen, (B, K, R, H), dtype, device)
    lst = torch.tensor(last, device=device, dtype=torch.int32)
    qpos = lst + 1 + step
    kw = dict(q_positions=qpos, n_blocks=n_blocks, scale=H**-0.5, ring_k=rk, ring_v=rv,
              ring_step=step)
    k3 = timer.ms(lambda: pa.paged_decode_attention(q, k_pool, v_pool, table, lst, **kw))
    k3_warm = timer.ms(lambda: pa.paged_decode_attention(q, k_pool, v_pool, table, lst, **kw),
                       flush=False)
    k3_plain = timer.ms(lambda: pa.paged_decode_attention_plain(q, k_pool, v_pool, table, lst,
                                                                **kw))

    def gather():
        kg = torch.cat([gather_pages(k_pool, table, n_blocks), rk], dim=2)
        vg = torch.cat([gather_pages(v_pool, table, n_blocks), rv], dim=2)
        return kg.repeat_interleave(G, dim=1), vg.repeat_interleave(G, dim=1)

    gather_ms = timer.ms(gather)
    kg, vg = gather()
    col = torch.arange(n_blocks * P, device=device)
    live = (table[:, :n_blocks] != sentinel).repeat_interleave(P, dim=1)
    pmask = (col[None, :] <= lst[:, None]) & live
    rmask = (torch.arange(R, device=device) <= step)[None].expand(B, R)
    mask = torch.cat([pmask, rmask], dim=1)[:, None, None, :]
    k3_lib = timer.ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg,
                                                             attn_mask=mask))
    keys = sum(n + 1 for n in last if n >= 0)
    ring_rows = B * (step + 1)
    flops = 4 * H * N * (keys + ring_rows)
    nbytes = (2 * esz * (keys + ring_rows) * K * H + esz * B * N * H + 4 * B * n_blocks
              + 2 * 4 * B + 4 * B * N * H + 2 * 4 * B * N)
    e = entry("paged_attention" + suffix, pa, launched, worst[("paged", dn)], k3, k3_plain,
              k3_lib, flops, nbytes, dn, tol_text(dn, False), gather_ms=gather_ms,
              warm_ms=k3_warm, launches_per_request=launched / shape["requests"], **extra)
    log(f"  K3 paged     {dn:<8} q [{B},{N},{H}] P {P} pool {num_pages} pages, last {last}, "
        f"ring {R} at step {step}: kernel {k3:.4f} ms (L2 warm {k3_warm:.4f} ms), plain "
        f"{k3_plain:.4f} ms, SDPA "
        f"{k3_lib:.4f} ms (+ gather {gather_ms:.4f} ms), bound {e['bound_ms']:.5f} ms "
        f"({e['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return e


def time_tail(torch, fa, device, timer, gen, shape, worst, name):
    """Time K1 at one tail prefill's shape in bf16 (kernel, plain version,
    SDPA with an explicit mask over the same keys): ``A`` rows of ``T``
    tail queries at positions ``plen ..`` against the ``plen`` prefix keys
    and the tail, each row valid up to ``plen`` + its tail. Returns its
    entry of the kernels line; the bound counts the live rows' pairs."""
    import torch.nn.functional as F

    from pilottai_tpu_torch.ops.attention import prefill_mask

    dtype = torch.bfloat16
    esz = 2
    cfg = shape["model"]
    N, K, H = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    A, T, plen, tails = shape["A"], shape["T"], shape["plen"], shape["tails"]
    S = plen + T
    q = randn(torch, gen, (A, T, N, H), dtype, device)
    k = randn(torch, gen, (A, S, K, H), dtype, device)
    v = randn(torch, gen, (A, S, K, H), dtype, device)
    kpos = torch.arange(S, device=device, dtype=torch.int32)[None].repeat(A, 1)
    qpos = kpos[:, plen:].contiguous()
    val = torch.tensor([plen + n for n in tails], device=device, dtype=torch.int32)
    ms = timer.ms(lambda: fa.flash_attention_with_lse(q, k, v, qpos, kpos, val))
    plain = timer.ms(lambda: fa.flash_attention_plain(q, k, v, qpos, kpos, val))
    qs = q.transpose(1, 2)
    ks, vs = (x.transpose(1, 2).repeat_interleave(N // K, dim=1) for x in (k, v))
    mask = prefill_mask(qpos, kpos, val)[:, None]
    lib = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
    pairs = sum(plen * n + n * (n + 1) // 2 for n in tails)
    flops = 4 * H * N * pairs
    nbytes = esz * (2 * A * T * N * H) + 2 * esz * int(val.sum()) * K * H + 4 * A * N * T
    e = entry(name, fa, shape["launches"], worst[("flash", "bfloat16")], ms, plain, lib, flops,
              nbytes, "bfloat16", tol_text("bfloat16", True),
              shape=dict(A=A, T=T, S=S, plen=plen, tails=tails))
    log(f"  K1 {name} bf16 q [{A},{T},{N},{H}] against S {S} (prefix {plen}, tails {tails}): "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
        f"{e['bound_ms']:.5f} ms ({e['bound_by']}), {shape['launches']} launches on the path")
    return e


def time_train_kernels(torch, fa, device, timer, gen, dtype, shape, launches, worst,
                       suffix=""):
    """Time K1, K4 and K5 at one training path's attention shape in ``dtype``
    (kernel; plain version; SDPA's forward for K1 and SDPA's backward, which
    computes dq, dk and dv at once, for K4 and K5, both with an explicit
    mask) and return their three entries of the kernels line."""
    import torch.nn.functional as F

    from pilottai_tpu_torch.ops.attention import prefill_mask

    dn = str(dtype)[6:]
    esz = torch.finfo(dtype).bits // 8
    cfg = shape["model"]
    N, K, H = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = N // K
    B, T, lens = shape["B"], shape["T"], shape["lens"]
    q = randn(torch, gen, (B, T, N, H), dtype, device)
    k = randn(torch, gen, (B, T, K, H), dtype, device)
    v = randn(torch, gen, (B, T, K, H), dtype, device)
    do = randn(torch, gen, (B, T, N, H), dtype, device)
    pos = torch.arange(T, device=device, dtype=torch.int32)[None].repeat(B, 1)
    val = torch.tensor(lens, device=device, dtype=torch.int32)
    k1 = timer.ms(lambda: fa.flash_attention_fwd(q, k, v, pos, pos, val))
    k1_plain = timer.ms(lambda: fa.flash_attention_plain(q, k, v, pos, pos, val))
    mask = prefill_mask(pos, pos, val)[:, None]
    qs = q.transpose(1, 2).detach().requires_grad_()
    ks = k.transpose(1, 2).repeat_interleave(G, dim=1).detach().requires_grad_()
    vs = v.transpose(1, 2).repeat_interleave(G, dim=1).detach().requires_grad_()
    with torch.no_grad():
        k1_lib = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    dout = do.transpose(1, 2)
    bwd_lib = timer.ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True))
    del out
    o, lse = fa.flash_attention_fwd(q, k, v, pos, pos, val)
    ops = fa.bwd_operands(q, k, v, pos, pos, val, 0, o, lse, do)
    k4 = timer.ms(lambda: fa.flash_bwd_dq(ops))
    k5 = timer.ms(lambda: fa.flash_bwd_dkv(ops))
    bwd_plain = timer.ms(lambda: fa.flash_attention_bwd_plain(q, k, v, pos, pos, val, 0, o,
                                                              lse, do))
    pairs = sum(sum(min(t + 1, n) for t in range(T)) for n in lens)
    kv_live = 2 * esz * sum(lens) * K * H          # the live k and v rows, read once
    rows = 4 * B * N * T                            # one fp32 value per query row and head
    qsize = esz * B * T * N * H
    flops = {"k1": 4 * H * N * pairs, "k4": 6 * H * N * pairs, "k5": 8 * H * N * pairs}
    nbytes = {
        "k1": 2 * qsize + kv_live + rows,                        # q, o; k, v; lse
        "k4": 3 * qsize + kv_live + 2 * rows,                    # q, dO, dq; k, v; lse, delta
        "k5": 2 * qsize + kv_live + 2 * rows + 2 * 4 * B * T * K * H,  # ... dk, dv in fp32
    }
    tol = tol_text(dn, True)
    bwd_tol = f"{TOL[dn]['bwd']:g} of max |ref|" + (" + 2^-7|ref| on dq" if TOL[dn]["rel"] else "")
    covers = dict(plain_covers="dq, dk and dv (one plain backward)",
                  library_covers="dq, dk and dv (scaled_dot_product_attention backward)")
    out = [
        entry("flash_fwd_train" + suffix, fa, launches["flash"], worst[("flash", dn)], k1,
              k1_plain, k1_lib, flops["k1"], nbytes["k1"], dn, tol),
        entry("flash_bwd_dq" + suffix, fa, launches["bwd_dq"], worst[("bwd_dq", dn)], k4,
              bwd_plain, bwd_lib, flops["k4"], nbytes["k4"], dn, bwd_tol, kernel="_DQ",
              **covers),
        entry("flash_bwd_dkv" + suffix, fa, launches["bwd_dkv"], worst[("bwd_dkv", dn)], k5,
              bwd_plain, bwd_lib, flops["k5"], nbytes["k5"], dn, bwd_tol, kernel="_DKV",
              **covers),
    ]
    shape_text = f"q [{B},{T},{N},{H}] valid {lens}"
    for e, label in zip(out, ("K1 flash_fwd   ", "K4 flash_bwd_dq", "K5 flash_bwd_dkv")):
        log(f"  {label} {dn:<8} {shape_text}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} "
            f"ms, SDPA {e['library_ms']:.4f} ms, bound {e['bound_ms']:.5f} ms ({e['bound_by']}), "
            f"{e['launches']} launches on the path")
    return out


def sdpa_yardstick(torch, device, gen, shape):
    """What the fp32 rows' library call is: torch and CUDA versions, the
    TF32 flags, and the device kernels of one SDPA forward and one backward
    (explicit mask, fp32) at the golden training shape, from
    ``torch.profiler``; the kernel names say which backend ran and whether
    its products are TF32-split. Returns the names."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from pilottai_tpu_torch.ops.attention import prefill_mask

    cfg = shape["model"]
    N, K, H = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, T = shape["B"], shape["T"]
    qs = randn(torch, gen, (B, N, T, H), torch.float32, device).requires_grad_()
    ks, vs = (randn(torch, gen, (B, N, T, H), torch.float32, device).requires_grad_()
              for _ in range(2))
    pos = torch.arange(T, device=device, dtype=torch.int32)[None].repeat(B, 1)
    mask = prefill_mask(pos, pos, torch.tensor(shape["lens"], device=device,
                                               dtype=torch.int32))[:, None]
    reps = 3

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sorted(device_rows(prof), reverse=True)

    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    dout = torch.ones_like(out)
    rows = {
        "forward": profiled(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)),
        "backward": profiled(lambda: torch.autograd.grad(out, (qs, ks, vs), dout,
                                                         retain_graph=True)),
    }
    log(f"  yardstick: torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"torch.backends.cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, float32 matmul "
        f"precision {torch.get_float32_matmul_precision()!r}; SDPA backends enabled: flash "
        f"{torch.backends.cuda.flash_sdp_enabled()}, memory-efficient "
        f"{torch.backends.cuda.mem_efficient_sdp_enabled()}, math "
        f"{torch.backends.cuda.math_sdp_enabled()}")
    for label in ("forward", "backward"):
        log(f"  SDPA fp32 {label} q [{B},{N},{T},{H}] with a mask, device kernels ({reps} "
            f"profiled calls, device time a call): " +
            ("; ".join(f"{key[:110]} {dev / reps:.1f} us" for dev, key, _ in rows[label])
             or "none seen (not measured)"))
    return {label: [key for _, key, _ in r] for label, r in rows.items()}


def phase_timing(torch, kernels, device, seed, worst, paths):
    """Every path's kernels, each at the shapes its own run gave it: bf16 at
    the llama3-8b waves', fp32 at the golden protocol-s requests'."""
    fa, da, pa = kernels["flash"], kernels["decode"], kernels["paged"]
    timer = Timer(torch, device)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"  card before timing (SM clock, max SM clock, power, temperature): {clocks}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    launches, shapes = paths["full"]
    lens = shapes["prompt_lens"]
    T = 64
    while T < max(lens):
        T *= 2
    out = time_kernels(
        torch, fa, da, device, timer, gen, torch.bfloat16, shapes["model"],
        flash=dict(B=len(lens), T=T, lens=lens),
        decode=dict(B=len(lens), S=2048, last=[n + 32 for n in lens],
                    wave=shapes.get("wave_k2")),
        launches=launches, worst=worst)
    p_launches, p_shape = paths["full_paged"]
    out[0]["launches_paged"] = p_launches["flash"]
    out.append(time_paged(torch, pa, device, timer, gen, torch.bfloat16, p_shape,
                          p_launches["paged"], worst))
    # K1 on the tail prefill: 5d's dense and paged hits, 5b's last segment.
    out.append(time_tail(torch, fa, device, timer, gen, paths["prefix_dense"], worst,
                         "flash_fwd_prefix_hit"))
    out.append(time_tail(torch, fa, device, timer, gen, paths["prefix_paged"], worst,
                         "flash_fwd_prefix_hit_paged"))
    out.append(time_tail(torch, fa, device, timer, gen, p_shape["segment"], worst,
                         "flash_fwd_segment"))
    yard = sdpa_yardstick(torch, device, gen, paths["train_golden"][1])
    g_launches, g_shapes = paths["golden"]
    fp32 = time_kernels(
        torch, fa, da, device, timer, gen, torch.float32, g_shapes["model"],
        flash=g_shapes["flash"], decode=g_shapes["decode"], launches=g_launches, worst=worst,
        suffix="_fp32")
    gp_launches, gp_shapes = paths["golden_paged"]
    p8_launches = paths["golden_paged_p8"][0]
    fp32[0]["launches_paged"] = gp_launches["flash"]
    fp32[0]["launches_paged_p8"] = p8_launches["flash"]
    gp_shape = dict(gp_shapes["paged"], model=gp_shapes["model"], requests=gp_shapes["requests"])
    fp32.append(time_paged(torch, pa, device, timer, gen, torch.float32, gp_shape,
                           gp_launches["paged"], worst, suffix="_fp32",
                           launches_p8=p8_launches["paged"]))
    t_launches, t_shape = paths["train_full"]
    out += time_train_kernels(torch, fa, device, timer, gen, torch.bfloat16, t_shape,
                              t_launches, worst)
    g_launches, g_shape = paths["train_golden"]
    fp32 += time_train_kernels(torch, fa, device, timer, gen, torch.float32, g_shape,
                               g_launches, worst, suffix="_fp32")
    for e in fp32:
        if e["name"].startswith("flash_"):
            e["library_kernels"] = yard["backward" if "bwd" in e["name"] else "forward"]
    return out + fp32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (a quick first check of a changed kernel); "
                    "prints no result line")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel checks' inputs and the llama3-8b weights")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from pilottai_tpu_torch.ops.kernels import build
    from pilottai_tpu_torch.ops.kernels import decode_attention as da
    from pilottai_tpu_torch.ops.kernels import flash_attention as fa
    from pilottai_tpu_torch.ops.kernels import paged_attention as pa

    kernels = {"flash": fa, "decode": da, "paged": pa}
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    t_start = time.perf_counter()
    log("== 1. environment")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")
    log(smi)

    log("== 2. build (nvcc, sm_90a, the five kernels in parallel)")
    t0 = time.perf_counter()
    build.build_libraries(["flash_fwd", "decode_attention", "paged_attention", "flash_bwd_dq",
                           "flash_bwd_dkv"])
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for name, (secs, text) in build.build_log.items():
        log(f"  {name}: nvcc {secs:.1f} s")
        for line in text.splitlines():
            if ("entry function" in line or "registers" in line or "spill" in line
                    or "error" in line.lower()):
                log(f"    {line.strip()}")

    log("== 3. kernels vs plain versions")
    worst = phase_kernels(torch, fa, da, pa, device, args.seed)
    if args.kernels_only:
        return 0
    paths = {}
    log("== 4a. golden protocol-s token ids (fp32), dense cache")
    paths["golden"] = phase_golden(torch, kernels, root, "protocol_s_golden.json", paged=False)
    log("== 4a. again with the decode pipeline's knobs off")
    phase_golden(torch, kernels, root, "protocol_s_golden.json", paged=False,
                 knobs=SERIAL_KNOBS)
    log("== 4b. golden protocol-s token ids (fp32), paged cache, chunked prefill")
    paths["golden_paged"] = phase_golden(torch, kernels, root, "protocol_s_paged_golden.json",
                                         paged=True)
    log("== 4b. again with the decode pipeline's knobs off")
    phase_golden(torch, kernels, root, "protocol_s_paged_golden.json", paged=True,
                 knobs=SERIAL_KNOBS)
    log("== 4b. again at engine_page_size 8, the smallest page the config takes")
    paths["golden_paged_p8"] = phase_golden(torch, kernels, root,
                                            "protocol_s_paged_golden.json", paged=True,
                                            page_size=8)
    log("== 4c. golden protocol-s token ids (fp32) with the prefix cache on (the port's "
        "defaults), each case served twice: dense")
    phase_golden(torch, kernels, root, "protocol_s_golden.json", paged=False, prefix_cache=None,
                 repeat=2)
    log("== 4c. the same, paged cache, chunked prefill")
    phase_golden(torch, kernels, root, "protocol_s_paged_golden.json", paged=True,
                 prefix_cache=None, repeat=2)
    log("== 5a. llama3-8b full width, bf16, dense cache, 8 concurrent JSON requests")
    paths["full"] = phase_full_width(torch, kernels, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  after the dense engine stopped: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    log("== 5b. llama3-8b full width, bf16, paged cache (engine_max_seq 8192), "
        "1 long + 7 short JSON requests")
    paths["full_paged"] = phase_full_width_paged(torch, kernels, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log("== 5d. llama3-8b full width, bf16, 8 agent steps a wave sharing a preamble, prefix "
        "cache on and off: dense (engine_max_seq 2048)")
    paths["prefix_dense"] = phase_prefix_agent_steps(torch, kernels, root, args.seed, False)
    log("== 5d. the same, paged (engine_max_seq 8192, pages of 128)")
    paths["prefix_paged"] = phase_prefix_agent_steps(torch, kernels, root, args.seed, True)
    gc.collect()
    torch.cuda.empty_cache()
    log("== 5c. the device's busy share: five profiled waves of each llama3-8b workload")
    paths["full"][1].update(phase_busy(torch, args.seed))
    log("== 7a. golden training: protocol-s fp32, 4 steps against the JAX trainer")
    paths["train_golden"] = phase_train_golden(torch, kernels, root)
    log("== 7b. llama3-1b full width, bf16 compute, fp32 master weights, remat, 8 steps of 4 x "
        "2048")
    paths["train_full"] = phase_train_full(torch, kernels, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log("== 6. kernel times at each path's shapes")
    kernels_line = phase_timing(torch, kernels, device, args.seed, worst, paths)
    if not all(math.isfinite(k["ms"]) for k in kernels_line):
        raise SystemExit("non-finite timing")
    log(f"  smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
