#!/usr/bin/env python3
"""GPU smoke test for ``pilottai_tpu_torch``, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero, and the
result line is printed only when every phase passed):

1. environment — torch and CUDA versions, the card's name and power limit,
   and whether this torch has the bf16 x bf16 -> fp32 products
   (``torch.mm``/``torch.bmm`` with ``out_dtype``) the logits head and the
   speculative verify run on (without them those paths raise), and which
   of ``CUDAGraph``'s conditional-node methods it has (a chunk's exit once
   every slot is done needs them; without them every step runs);
2. build — the ten hand-written kernel sources from
   ``pilottai_tpu_torch/csrc`` with ``nvcc`` for sm_90a, in parallel (the
   head_dim 256 instantiations of K3, K4 and K5 are sources of their own,
   ``paged_attention_h256.cu``, ``flash_bwd_dq_h256.cu`` and
   ``flash_bwd_dkv_h256.cu``, beside the kernels' sources);
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
   keys: 5d's hits, 5b's last segment, 4c's golden hits); K3 at the
   speculative verify's shapes (``q_blocks`` D and no ring: llama3-8b at D
   4 and 8, 16 and 32 query rows a kv head, int8 pools, a window, and D 16,
   64 rows, through the wrapper's split into two launches). K1, K2 and K3
   also run twice and must give the same bits. K2's int8 body (an int8
   panel with fp32 scales, q in bf16 and in fp32) at head_dim 32, 64 and
   128, G = 1, 4 and 8, with a window, a soft-cap, empty rows and panels
   of S keys that are no multiple of 4 (a split's first scale off a
   16-byte boundary), held to the limits of q's dtype, each run twice for
   the same bits. Then the quantized product
   (``csrc/qmatmul.cu``, no ``pallas_call`` counterpart) against
   ``qmatmul_plain``: llama3-8b's seven matrices at 1, 8, 32 and 64 rows
   (the fused kernel) and 65 and 1472 (the dequant kernel, then
   ``torch.matmul``) in bf16, int8 and int4 at groups 128 and 96, an odd
   contraction, the untied llama3-8b head (int8, fp32 result) and
   protocol-s's matrices in fp32, each run twice for the same bits, within
   ``TOL_QMM``; and wk's shape at 64 and 65 rows, int8 and int4, captured in
   a CUDA graph, whose replays must give the eager bits. Then the integer
   arm (``PILOTTAI_QMATMUL=native``, ``csrc/int8_matmul.cu``): the row
   quantizer's bytes and scales equal ``quantize_rows_plain``'s and the s8
   product's result equal ``native_matmul_plain``'s bit for bit (bf16
   results after their one rounding), each call twice for the same bits,
   int8 and int4 at groups 128 and 96 at K 4100 (off both groups) and 1,
   8, 17, 32, 256 and 2048 rows in fp32 and bf16, llama3-8b's wq and wd
   at 8 and 2048 rows, protocol-s's matrices in fp32, and the pair captured
   in a CUDA graph. Then the head_dim 256 bodies of K1, K2 and K3 (the
   Gemma family) in both dtypes, each case twice for the same bits
   (``gemma_kernel_cases``): K1 at gemma2-2b's prefill (8 query heads on
   4 kv heads, a window, soft-cap 50) and gemma-2b's (one kv head), a tail
   shape and rows with no key; K2 at G 2 and 8, a window crossing splits,
   every slot empty, and its int8 body; K3 at pages of 128 and 16, the
   ring, ``q_blocks`` 4, a window and int8 pools; then K4 and K5 at head_dim
   256 (Gemma training) in both dtypes, each case twice for the same bits
   (``gemma_bwd_cases``): gemma2-2b's training shape (G 2, soft-cap 50, its
   4096-key window and one that bites, an lse cotangent, a ragged row),
   gemma-2b's (G 8, an empty row), G 1 with T != S and offset queries,
   shuffled keys, and 7c's two tiny shapes (4 x 512);
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
   decode step dispatched, graph replays included. Every engine of the
   smoke prints its warm-up sweep (``start()`` captures every chunk graph
   its settings reach: the wall, the graphs against the reachable keys,
   the eager chunks' and the captures' seconds, its requests,
   the buffers shared by shape against one set a variant, the shared
   pool) and fails if serving captured a graph after ``start()``.
   (c) the same golden at the port's defaults, prefix cache on, each case
   served twice in a row, dense and paged: every serving's ids equal the
   golden's, the lookups hit at least once a case (the second serving),
   no export fails, and every page is back on the free list or pinned by
   the page index; (d) the same golden with ``engine_speculate=4``, dense
   and paged (6/6 each), and again with ``engine_draft_layers=2`` with
   every slot put in model-draft mode at admission (the hysteresis alone
   never switches on these prompts), the model-draft graph replayed at
   least once: the paged verify launches K3 once per layer per block, the
   dense verify no decode kernel, and each model-draft block adds (D - 1)
   x draft layers launches of K2 (dense) or K3 (paged); tokens per block
   printed; (e) the quantized golden files (``protocol_s_int8_golden.json``,
   ``protocol_s_int4_paged_golden.json``, ``protocol_s_int4_golden.json``,
   the JAX engine's with ``engine_quant``): int8 dense, int4 at group 96
   paged with chunked prefill, int4 at group 128 dense with
   ``engine_speculate=4``, 6/6 each; the quantized product's fused kernel
   launches seven times a layer per decode step or verify block dispatched
   (prefills apart), and the prefills of more than 64 rows its dequant
   kernel; every dense engine of the smoke launches neither; (f) the
   int8-KV golden files (``protocol_s_kv8_golden.json``,
   ``protocol_s_kv8_paged_golden.json``, the JAX engine's with
   ``engine_kv_quantize="int8"``), dense and paged, 6/6 each, then each
   again with ``engine_speculate=4`` and the prefix cache on, every case
   served twice (12/12 each); the cache must be int8; (g) the integer
   arm's golden files (``protocol_s_int{8,4}_native*_golden.json``, the
   JAX engine's with ``PILOTTAI_QMATMUL=native``), each engine started with
   the variable set and holding that arm after it is unset: int8 dense,
   int4 at group 128 dense, int4 at group 96 paged, 6/6 each, and int4 at
   group 128 with ``engine_speculate=4`` and the prefix cache on, each case
   twice, 12/12; the integer product and its quantizer seven times a layer
   a step, block and prefill, the dequant arm's kernels never; (h) the
   Gemma golden files (``scripts/export_gemma_golden.py``: two head_dim
   256 test models registered from their files, gemma2-tiny-h256 with its
   128-key window and soft-caps and gemma-tiny-h256 with one kv head),
   dense and paged, 6/6 each;
5. full width — llama3-8b in bf16 from random init, the prefix cache off
   in (a) to (c); the engines of (a) and (b) serve the later runs at their
   settings too (5d with the cache off, 5e with speculation off, 5c), and
   stop after 5c. Peak memory is each engine's own: the process's peak
   less what the other live engines hold. (a) on the dense cache: the first wave served after
   ``start()``, then 8 concurrent JSON-mode greedy requests, the counters
   > 0, one prompt's
   first-token logits through K1 against the plain K1 and one decode step
   of the live wave through K2 against the plain K2 (``TOL_E2E``); (b)
   paged, switched on by ``engine_max_seq=8192`` alone: one ~6000-token
   prompt (prefilled in 1024-token segments) and seven short ones, K1 and
   K3 > 0 with K2 at zero, every page back on the free list, and one decode
   step of the wave's live state through K3 against the plain K3
   (``TOL_E2E``). Both decode-step checks run on the device thread's
   stream between two dispatches, and both paths launch their decode
   kernel once per layer per step. Then five more waves of each: TTFT
   p50, TPOT p50, decode tokens/s and the decode steps dispatched against
   the useful ones per wave, with the median and the spread; the first
   wave's TTFT beside the timed median; the TTFT of one request sent while
   a decode chunk is in flight; in (a) one replay of the 16-step graph with
   every slot done; (c) three waves of each under torch.profiler, on the
   shared engines:
   the device's busy share (after every plain wave: the profiler leaves
   the process's launches slower), and the fp32 GEMMs and the kinds of
   GEMM the first profiled wave ran (the logits head's among them); (d)
   agent steps sharing a preamble, 8 concurrent requests a
   wave whose system message is the leading 900 bytes of the protocol
   rules and whose task differs in every request, dense (2048) and paged
   (8192): a cold wave, then five timed waves with the prefix cache on
   (8 hits a wave, each tail one K1 launch a layer against the cached
   prefix: the store's derived preamble entry, or 7 shared pages) and the
   same waves on the shared engine, whose cache is off; TTFT and TPOT p50 of both, the store or the
   pinned pages, and one warm request's first-token logits through the
   hit path against a full K1 prefill (``TOL_E2E``, the same argmax);
   (e) speculative decoding at full width: 8 concurrent JSON requests,
   dense (2048) and paged (8192), ``engine_speculate=4``, the first wave
   served (its TTFT beside the timed median), a wave with the row-0 check
   and five timed waves, one request sent behind a chunk in flight, and
   the timed waves on the shared engine (speculation off):
   TTFT, TPOT p50 and tokens/s of both, tokens per block (more than one)
   and tokens a reply (at least half the budget), the launches per block,
   and one verify block's row-0 logits of the live wave against the plain
   decode step's for the same token (``TOL_E2E``, the same argmax); the
   speculative engines run 24 of llama3-8b's 32 layers (``SPEC_LAYERS``),
   and fixed chunks (``SPEC_KNOBS``), so their TPOT is not comparable with
   the shared engine's; (f) 5a's dense engine and requests with ``engine_quant`` int8
   and int4 (group 128): a first wave, a counted wave (the fused kernel
   seven times a layer a step, each matrix shape as often as a layer has
   it by the wrapper's counts by shape, one live decode step's logits through the
   kernel against the same step through ``qmatmul_plain``, ``TOL_E2E``
   and the same argmax), five timed waves (TTFT, TPOT, tokens/s), the
   engine's own peak and resident bytes, the weights' bytes a step, the
   seconds quantization took at start, and (recorded, not gated) the
   first-token logits' correlation and argmax agreement with 5a's bf16
   weights of the same seed; the head is tied, so it stays dense; (g) 5a's
   dense engine and requests and 5b's paged engine and requests (the
   6050-token prompt in 1024-token segments; fixed chunks,
   ``KV8_PAGED_KNOBS``) with
   ``engine_kv_quantize="int8"`` at all 32 layers: the first wave, a
   counted wave (K2's int8 body or K3 on the int8 pools once per layer a
   step, and one live step's logits through it against its plain version,
   ``TOL_E2E`` and the same argmax), five timed waves, the engine's own
   peak, the cache's bytes (int8 panels or pools and fp32 scales) against
   the bf16 engine's, and (recorded, not gated) how many leading tokens of
   one greedy reply equal the bf16 cache's; (h) 5f's runs on the integer
   arm (each engine started with ``PILOTTAI_QMATMUL=native``, fixed
   chunks), int8 and int4: the integer product seven times a layer a step
   by shape, the admission's prefill through it, one live step's logits
   against ``native_matmul_plain`` (``TOL_E2E``, the same argmax), and the
   TTFT and TPOT p50 of three timed waves beside 5f's and 5a's; (i) the
   Gemma family at head_dim 256 after 5c (``phase_gemma_full_width``,
   fixed chunks): gemma2-2b paged (8192) on 5b's requests, so its
   4096-key window masks in K1's segments and in K3, and gemma-2b dense
   (2048) on 5a's; the first-token logits of the longest prompt through
   K1 and one live decode step through K3 or K2 against their plain
   versions (``TOL_E2E``, the same argmax; gemma2-2b's logits before its
   soft-cap, ``uncapped``, the capped ones recorded), the decode kernel once per
   layer a step, TTFT and TPOT p50 of three timed waves, the engine's own
   peak, no graph captured after ``start()``;
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
   K1, K4 and K5 (``TOL_E2E_TRAIN``); (c) golden at head_dim 256: 7a's
   check on the two tiny Gemma test models (gemma2-tiny-h256 with its
   soft-caps and a 128-key window that bites at 512, gemma-tiny-h256 with
   G 4 on one kv head), four steps each from the file's weights, against
   ``assets/*_train_golden.json`` (the JAX trainer's,
   ``scripts/export_gemma_train_golden.py``); (d) gemma2-2b at its
   published widths (26 layers, head_dim 256, soft-caps 30 and 50, the
   256,128-token vocab), 7b's run and checks at ``GEMMA_TRAIN_B`` x 2048,
   peak memory printed;
6. last, each path's kernels timed at the shapes that path gave them (bf16
   at phase 5's and 7b's, fp32 at phase 4's and 7a's; K1 also at 5d's hit
   shapes and 5b's last segment; K2 and K3 with the
   L2 flushed and warm, K2 also as the profiler's device time a launch,
   in the harness and in phase 5a's profiled wave), with the yardstick's
   terms printed beside the fp32 rows (torch and CUDA versions, the TF32
   flags, and the device kernels of one SDPA forward and backward, which
   name the backend that ran); K3 also at 5e's paged verify shape (D rows
   a query head), with SDPA over the gathered panels, and K2's entry for the
   model drafts of 4d; K2's int8 body at 5g's dense decode step, beside
   K2's bf16 body at the same shape and SDPA over the panel dequantized
   beforehand (not counted), and K3 on int8 pools at 5g's paged step; the
   quantized product at 5f's decode step (8 rows,
   the four matrix shapes) and prefill, and at 4e's protocol-s shapes in
   fp32, each with the launches the wrapper counted at that shape and its
   body's launch plan (splits and their tiles), registers and blocks an
   SM, beside
   the library call that computes the same product
   (``torch._weight_int4pack_mm`` or ``torch._weight_int8pack_mm``,
   timed only here; where it raises, its error stands in the entry) and
   ``torch.matmul`` on a dense weight of the same shape (the speed
   quantization has to beat); the integer arm's product at 5h's shapes
   (wq, wk, wg, wd at 8, 32 and 2048 rows, int8 and int4, the product
   launch alone) beside ``native_matmul_plain``, ``torch._int_mm`` on the
   same int8 operands (more than 16 rows; timed only) and the dequant
   arm's kernel, and its row quantizer; the head_dim 256 bodies at 5i's
   shapes (K1 and K2 at gemma-2b's dense wave, K3 at gemma2-2b's paged
   wave, K1 at its widest segment) in bf16 and at 4h's gemma2-tiny-h256
   shapes in fp32, and K1, K4 and K5 at 7d's gemma2-2b step in bf16 and
   7c's gemma2-tiny-h256 steps in fp32, each beside its bound and SDPA
   (its backward for K4 and K5); the kernels line, then
   the result line. Each phase's header prints the second it starts at,
   and the last lines the smoke's wall time.

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
import os
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
# The quantized product (csrc/qmatmul.cu) against qmatmul_plain, as the
# part of max |difference| beyond "rel" x |ref|, over max |ref|. Both round
# each weight to the scale's dtype alike and sum in fp32, in another order.
# bf16 results: the two fp32 sums can round to neighbouring bf16 values, one
# rounding, 2^-7 of a value at most (the relative term), and the rest is
# summation order. fp32 (protocol-s, and the head's fp32 result in bf16):
# summation order alone. "out" is about twice the largest reading over
# seeds 0-3 on an H100 (5.80e-6 in bf16, at 1472 rows; 5.51e-6 in fp32,
# the head's fp32 result; protocol-s's fp32 1.61e-6; PERF.md).
TOL_QMM = {
    "bfloat16": {"out": 1.2e-5, "rel": 2.0**-7},
    "float32": {"out": 1.1e-5, "rel": 0.0},
}
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
# Phase 7d: gemma2-2b's batch rows of 2048 tokens. Its 2.615B parameters
# take ~47 GB as fp32 master weights, their gradients, AdamW's two moments
# and the bf16 copy, and each fp32 [B, T, V] tensor of the soft-capped loss
# takes 2.1 GB a row at the 256,128-token vocab: two rows fit one card.
GEMMA_TRAIN_B = 2
# H100 SXM dense bf16 on the tensor cores (NVIDIA data sheet), and for fp32
# the fp32-accurate tensor-core rate, TF32's 495e12 over the three products
# of 3xTF32: the least time this card takes for fp32-accurate products. The
# yardstick does the same: SDPA's fp32 path runs PyTorch's memory-efficient
# attention, whose sm80+ fp32 GEMMs are CUTLASS's OpMultiplyAddFastF32
# (mem_eff_attention/gemm_kernel_utils.h in PyTorch's headers).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3, "int8": 1979e12}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# The kernels line's "replaces" of the quantized product, which has no
# pallas_call: the JAX site whose XLA fusion it stands in for.
QMM_REPLACES = ("pilottai_tpu/models/qmatmul.py:128 (qmatmul; no pallas_call: XLA fuses "
                "pilottai_tpu/models/quant.py:123 dequant into the matmul)")
# Kernel names of csrc/ that a profile lists apart, wherever they rank.
PORT_KERNEL_NAMES = ("flash_fwd", "tile_bounds", "decode_split", "paged_split", "paged_merge",
                     "flash_bwd", "qmm_", "dequant_kernel")


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


def check_decode_int8(torch, da, gen, device, name, dtype, B, N, K, S, H, last,
                      window=0, softcap=0.0, shift=1):
    """K2's int8 body (an int8 panel with its fp32 scales, q in ``dtype``)
    against its plain version, held to the limits of q's dtype. Run twice:
    the statistics must be the same bits."""
    from pilottai_tpu_torch.ops.kvcache import quantize_kv

    q = randn(torch, gen, (B, N, H), dtype, device)
    kc, ks = quantize_kv(randn(torch, gen, (B, K, S, H), torch.float32, device))
    vc, vs = quantize_kv(randn(torch, gen, (B, K, S, H), torch.float32, device))
    lst = torch.tensor(last, device=device, dtype=torch.int32)
    qpos = torch.clamp(lst, min=0) + shift
    kw = dict(scale=H**-0.5, softcap=softcap, window=window, k_scales=ks, v_scales=vs)
    got = da.decode_attention(q, kc, vc, lst, qpos, return_stats=True, **kw)
    again = da.decode_attention(q, kc, vc, lst, qpos, return_stats=True, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = da.decode_attention_plain(q, kc, vc, lst, qpos, **kw)
    ok, err, text = compare_stats(got, want, str(dtype)[6:])
    log(f"  K2 int8 {name:<29} q {str(dtype)[6:]:<8} {text} repeat bit-identical {same}")
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
    # And K1 at the prefix cache's tail shapes, K3 at the verify's.
    hgen = torch.Generator(device=device)
    hgen.manual_seed(seed)
    vgen = torch.Generator(device=device)
    vgen.manual_seed(seed)
    # And K2's int8 body.
    kgen = torch.Generator(device=device)
    kgen.manual_seed(seed)
    # And the head_dim 256 bodies of K1, K2 and K3 (Gemma), and of K4 and K5.
    ggen = torch.Generator(device=device)
    ggen.manual_seed(seed)
    tgen = torch.Generator(device=device)
    tgen.manual_seed(seed)
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
        # K3 at the speculative verify's shapes (slice P4): a block of D
        # rows for each query head (q_blocks D, row d at the slot's
        # position + d), no ring; llama3-8b at D 4 and 8 (16 and 32 rows a
        # kv head), int8 pools, a window, and D 16 (64 rows), which the
        # wrapper splits into two launches of 32 rows.
        verify_cases = [
            ("llama3-8b verify D4 16 rows", dict(
                B=8, N=128, K=8, H=128, P=128, lengths=[260, 900, 0, 1, 2047, 131, 255, 700],
                q_blocks=4)),
            ("llama3-8b verify D8 32 rows window", dict(
                B=8, N=256, K=8, H=128, P=128, lengths=[260, 900, 0, 1, 2047, 131, 255, 700],
                q_blocks=8, window=300, softcap=30.0, hole=(1, 3))),
            ("llama3-8b verify D4 int8 window", dict(
                B=4, N=128, K=8, H=128, P=128, lengths=[3000, 260, 0, 129], q_blocks=4,
                quantized=True, window=500)),
            ("llama3-8b verify D16 split 2x32 rows", dict(
                B=4, N=512, K=8, H=128, P=128, lengths=[1500, 260, 0, 33], q_blocks=16,
                window=200)),
            ("protocol-s H32 P16 verify D4", dict(
                B=4, N=32, K=4, H=32, P=16, lengths=[415, 470, 0, 1], q_blocks=4)),
        ]
        for name, kw in verify_cases:
            ok, err = check_paged(torch, pa, vgen, device, name, dtype, **kw)
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
        # K2's int8 body (the int8 KV cache): the three head dims, a window,
        # a soft-cap, empty rows, and panels of S keys that are no multiple
        # of 4, so that a split's first scale sits off a 16-byte boundary.
        int8_cases = [
            ("llama3-8b S2048 ragged", dict(B=8, N=32, K=8, S=2048, H=128,
                                            last=[2047, 1000, 230, 0, -1, 1500, 64, 2046])),
            ("llama3-8b S301 window softcap", dict(B=4, N=32, K=8, S=301, H=128,
                                                   last=[300, 150, -1, 37], window=77,
                                                   softcap=30.0, shift=5)),
            ("H64 G8 S1001", dict(B=4, N=32, K=4, S=1001, H=64, last=[1000, 512, 3, -1])),
            ("protocol-s H32 S515 window", dict(B=4, N=8, K=4, S=515, H=32,
                                                last=[414, 514, -1, 0], window=45)),
            ("H128 G1 every slot empty", dict(B=4, N=8, K=8, S=259, H=128, last=[-1] * 4)),
        ]
        for name, kw in int8_cases:
            ok, err = check_decode_int8(torch, da, kgen, device, name, dtype, **kw)
            results.append(ok)
            worst[("decode_int8", dn)] = max(worst.get(("decode_int8", dn), 0.0), err)
        results += gemma_kernel_cases(torch, fa, da, pa, ggen, device, dtype, worst)
        results += gemma_bwd_cases(torch, fa, tgen, device, dtype, worst)
    if not all(results):
        raise SystemExit("kernel check failed")
    return worst


def gemma_kernel_cases(torch, fa, da, pa, gen, device, dtype, worst):
    """The head_dim 256 bodies (slice P9a): K1 at gemma2-2b's prefill (8
    query heads on 4 kv heads, a window, soft-cap 50) and gemma-2b's (one
    kv head), a tail shape and rows with no key; K2 at G 2 and 8, a window
    crossing splits, empty slots, and its int8 body; K3 at pages of 128
    and 16, the ring, ``q_blocks`` 4 (the verify), a window, int8 pools.
    Each case twice (bit-identical repeats). The errors go to the
    ``*_h256`` keys of ``worst``."""
    dn = str(dtype)[6:]
    results = []
    flash_cases = [
        ("gemma2-2b T512 window softcap", dict(B=2, T=512, N=8, K=4, H=256, valid=[512, 300],
                                               window=200, softcap=50.0)),
        ("gemma-2b G8 T512 ragged", dict(B=2, T=512, N=8, K=1, H=256, valid=[512, 377])),
        ("gemma2-2b tail Tq64 S1100", dict(B=2, T=64, S=1100, N=8, K=4, H=256,
                                           valid=[1100, 1000], offset=1036, window=300,
                                           softcap=50.0)),
        ("gemma-2b Tq77 no-key rows shuffled", dict(B=2, T=77, S=150, N=8, K=1, H=256,
                                                    valid=[150, 0], offset=-10, window=40,
                                                    shuffle=True)),
    ]
    for name, kw in flash_cases:
        ok, err = check_flash(torch, fa, gen, device, name, dtype, **kw)
        results.append(ok)
        worst[("flash_h256", dn)] = max(worst.get(("flash_h256", dn), 0.0), err)
    decode_cases = [
        ("gemma2-2b G2 window crosses splits", dict(B=8, N=8, K=4, S=2048, H=256,
                                                   last=[2047, 700, 333, 100, -1, 64, 1500,
                                                         31], window=300, softcap=50.0,
                                                   shift=9)),
        ("gemma-2b G8 S2048 ragged", dict(B=8, N=8, K=1, S=2048, H=256,
                                          last=[2047, 1000, 230, 0, -1, 1500, 64, 2046])),
        ("H256 G8 every slot empty", dict(B=4, N=8, K=1, S=512, H=256, last=[-1] * 4)),
    ]
    for name, kw in decode_cases:
        ok, err = check_decode(torch, da, gen, device, name, dtype, **kw)
        results.append(ok)
        worst[("decode_h256", dn)] = max(worst.get(("decode_h256", dn), 0.0), err)
    int8_cases = [
        ("gemma2-2b G2 S2048", dict(B=8, N=8, K=4, S=2048, H=256,
                                    last=[2047, 1000, 230, 0, -1, 1500, 64, 2046])),
        ("gemma-2b G8 S1001 window softcap", dict(B=4, N=8, K=1, S=1001, H=256,
                                                  last=[1000, 512, 3, -1], window=300,
                                                  softcap=50.0, shift=5)),
    ]
    for name, kw in int8_cases:
        ok, err = check_decode_int8(torch, da, gen, device, name, dtype, **kw)
        results.append(ok)
        worst[("decode_int8_h256", dn)] = max(worst.get(("decode_int8_h256", dn), 0.0), err)
    paged_cases = [
        ("gemma2-2b P128 6050+short window ring@0", dict(
            B=8, N=8, K=4, H=256, P=128, lengths=[6050, 184, 190, 201, 176, 0, 188, 195],
            hole=(6, 1), window=4096, softcap=50.0, ring=16, step=0)),
        ("gemma-2b G8 P16 ring@15", dict(
            B=4, N=8, K=1, H=256, P=16, lengths=[415, 510, 0, 1], hole=(1, 5), ring=16,
            step=15)),
        ("gemma2-2b verify q_blocks4 window", dict(
            B=4, N=32, K=4, H=256, P=128, lengths=[1500, 260, 0, 33], q_blocks=4, window=200,
            softcap=50.0)),
        ("gemma-2b G32 P16 verify q_blocks4", dict(
            B=4, N=32, K=1, H=256, P=16, lengths=[415, 63, 0, 200], q_blocks=4, window=40)),
        ("gemma2-2b P128 int8 pools ring@7", dict(
            B=4, N=8, K=4, H=256, P=128, lengths=[3000, 100, 0, 700], hole=(3, 1),
            softcap=50.0, quantized=True, ring=16, step=7)),
        ("gemma-2b P16 int8 window hole", dict(
            B=4, N=8, K=1, H=256, P=16, lengths=[415, 513, 0, 33], quantized=True, window=300,
            hole=(1, 3))),
    ]
    for name, kw in paged_cases:
        ok, err = check_paged(torch, pa, gen, device, name, dtype, **kw)
        results.append(ok)
        worst[("paged_h256", dn)] = max(worst.get(("paged_h256", dn), 0.0), err)
    return results


def gemma_bwd_cases(torch, fa, gen, device, dtype, worst):
    """The head_dim 256 bodies of K4 and K5 (slice P9c): gemma2-2b's
    training shape (8 query heads on 4 kv heads, soft-cap 50, its 4096-key
    window, which T 2048 does not reach, and a window that bites),
    gemma-2b's (G 8 on one kv head, an empty row), G 1 with T != S and
    offset query positions, shuffled keys, and the two tiny h256 models'
    golden training shapes (7c: 4 x 512, a 128-key window and soft-cap 50
    at G 2, G 4 on one kv head). Each case twice (bit-identical
    gradients). The errors go to the ``bwd_*_h256`` keys of ``worst``."""
    dn = str(dtype)[6:]
    cases = [
        ("gemma2-2b T2048 window4096 softcap dlse", dict(B=2, T=2048, S=2048, N=8, K=4, H=256,
                                                         valid=[2048, 1377], window=4096,
                                                         softcap=50.0, dlse=True)),
        ("gemma2-2b T1024 window 200 softcap", dict(B=2, T=1024, S=1024, N=8, K=4, H=256,
                                                    valid=[1024, 700], window=200,
                                                    softcap=50.0)),
        ("gemma-2b G8 T1024 empty row", dict(B=2, T=1024, S=1024, N=8, K=1, H=256,
                                             valid=[1024, 0])),
        ("H256 G1 Tq100 S160 offset 60 dlse", dict(B=3, T=100, S=160, N=4, K=4, H=256,
                                                   valid=[160, 97, 0], offset=60, dlse=True)),
        ("H256 G2 Tq130 S300 shuffled softcap", dict(B=2, T=130, S=300, N=8, K=4, H=256,
                                                     valid=[300, 211], offset=170,
                                                     softcap=50.0, shuffle=True, dlse=True)),
        ("gemma2-tiny-h256 T512 window 128", dict(B=4, T=512, S=512, N=4, K=2, H=256,
                                                  valid=[512, 415, 1, 0], window=128,
                                                  softcap=50.0, dlse=True)),
        ("gemma-tiny-h256 G4 T512", dict(B=4, T=512, S=512, N=4, K=1, H=256,
                                         valid=[512, 415, 300, 0])),
    ]
    results = []
    for name, kw in cases:
        ok, err_dq, err_dkv = check_flash_bwd(torch, fa, gen, device, name, dtype, **kw)
        results.append(ok)
        worst[("bwd_dq_h256", dn)] = max(worst.get(("bwd_dq_h256", dn), 0.0), err_dq)
        worst[("bwd_dkv_h256", dn)] = max(worst.get(("bwd_dkv_h256", dn), 0.0), err_dkv)
    return results


# --------------------------------------------------------------------- #
# Phase 3, the quantized product: csrc/qmatmul.cu against qmatmul_plain
# --------------------------------------------------------------------- #

# llama3-8b's seven matrices by shape (K, N): wq and wo, wk and wv, wg and
# wu, wd.
LLAMA_MATRICES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
PROTOCOL_S_MATRICES = ((256, 256), (256, 128), (256, 1024), (1024, 256))
QUANT_MODES = ((8, 128), (4, 128), (4, 96))  # (bits, int4 group)


def quant_name(bits, group):
    return "int8" if bits == 8 else f"int4 g{group}"


def check_qmatmul(torch, qk, gen, device, dtype, K, N, M, bits, group, out_f32=False,
                  label="", weights=None):
    """The kernel (fused up to 64 rows, dequant then matmul above) against
    ``qmatmul_plain`` on one shape, run twice: the results must be the same
    bits, and the launch must take the path its rows select. ``weights``
    reuses a quantized weight of the same shape. Returns (ok, gated error,
    the weight)."""
    from pilottai_tpu_torch.models.quant import quantize_array

    if weights is None:
        w = torch.randn((K, N), generator=gen, device=device, dtype=torch.float32) * K**-0.5
        weights = quantize_array(w, dtype, bits=bits, group=group)
        del w
    x = randn(torch, gen, (M, K), dtype, device)
    out = torch.float32 if out_f32 else None
    n0 = (qk.launches, qk.launches_dequant)
    got = qk.quant_matmul(x, weights, out)
    again = qk.quant_matmul(x, weights, out)
    torch.cuda.synchronize()
    fused = M <= qk.FUSED_MAX_ROWS
    path_ok = (qk.launches - n0[0], qk.launches_dequant - n0[1]) == ((2, 0) if fused else (0, 2))
    same = torch.equal(got, again)
    want = qk.qmatmul_plain(x, weights, out)
    odt = "float32" if out_f32 else str(dtype)[6:]
    tol = TOL_QMM[odt]
    d = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    err = d.max().item() / top
    over = (d - tol["rel"] * want.float().abs()).max().item() / top
    finite = bool(torch.isfinite(got).all())
    ok = over <= tol["out"] and same and path_ok and finite and got.dtype == want.dtype
    log(f"  qmatmul {label:<22} {quant_name(bits, group):<8} {str(dtype)[6:]:<8} M {M:>4} "
        f"[{K}x{N}]{' fp32 out' if out_f32 else ''} {'fused' if fused else 'dequant+mm'}: "
        f"{err:.2e} of max|ref| (beyond rel {over:.2e}) repeat bit-identical {same} "
        f"path {path_ok} tol {tol['out']:g}{' + 2^-7|ref|' if tol['rel'] else ''} "
        f"{'ok' if ok else 'FAIL'}")
    return ok, over, weights


def check_qmatmul_capture(torch, qk, gen, device, K, N, M, bits, group):
    """The product captured in a CUDA graph as a chunk graph captures it
    (a verify block past 64 rows takes the dequant path inside one): an
    eager call on the capturing stream first, then the capture, which
    counts one launch of the path its rows select, and two replays, which
    must give the eager result's bits."""
    from pilottai_tpu_torch.models.quant import quantize_array

    w = torch.randn((K, N), generator=gen, device=device, dtype=torch.float32) * K**-0.5
    qw = quantize_array(w, torch.bfloat16, bits=bits, group=group)
    x = randn(torch, gen, (M, K), torch.bfloat16, device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        want = qk.quant_matmul(x, qw)
    stream.synchronize()
    n0 = (qk.launches, qk.launches_dequant)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = qk.quant_matmul(x, qw)
    moved = (qk.launches - n0[0], qk.launches_dequant - n0[1])
    fused = M <= qk.FUSED_MAX_ROWS
    same = []
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(got, want))
    graph.reset()
    ok = all(same) and moved == ((1, 0) if fused else (0, 1))
    log(f"  qmatmul captured            {quant_name(bits, group):<8} bfloat16 M {M:>4} "
        f"[{K}x{N}] {'fused' if fused else 'dequant+mm'}: capture counted {moved[0]} fused and "
        f"{moved[1]} dequant launches; two replays equal the eager bits {same} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_qmatmul(torch, qk, device, seed):
    """The quantized product at every shape the paths give it: llama3-8b's
    seven matrices at 1, 8, 32 and 64 rows (fused) and 65 and 1472 (dequant,
    then torch.matmul) in bf16, int8 and int4 at groups 128 and 96; an odd
    contraction (a padded nibble); the untied llama3-8b head (int8, fp32
    result, 8 rows); protocol-s's matrices in fp32 at 4, 16, 64, 65 and 512
    rows; and, captured in a CUDA graph, wk's shape at 64 and 65 rows, int8
    and int4. Returns the largest gated error per dtype of the result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    log("  TF32 off for matmuls (the plain version's fp32 products)")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    results, worst = [], {}

    def run(dtype, K, N, rows, bits, group, label, out_f32=False):
        weights = None
        for M in rows:
            ok, err, weights = check_qmatmul(torch, qk, gen, device, dtype, K, N, M, bits,
                                             group, out_f32, label, weights)
            results.append(ok)
            key = "float32" if out_f32 else str(dtype)[6:]
            worst[key] = max(worst.get(key, 0.0), err)

    for bits, group in QUANT_MODES:
        for K, N in LLAMA_MATRICES:
            run(torch.bfloat16, K, N, (1, 8, 32, 64, 65, 1472), bits, group, "llama3-8b")
        run(torch.bfloat16, 1001, 384, (8, 65), bits, group, "odd K")
        for K, N in PROTOCOL_S_MATRICES:
            run(torch.float32, K, N, (4, 16, 64, 65, 512), bits, group, "protocol-s")
        run(torch.float32, 1001, 384, (4, 65), bits, group, "odd K")
    run(torch.bfloat16, 4096, 128256, (8,), 8, 128, "llama3-8b untied head", out_f32=True)
    for bits, group in QUANT_MODES[:2]:
        for M in (64, 65):
            results.append(check_qmatmul_capture(torch, qk, gen, device, 4096, 1024, M, bits,
                                                 group))
    if not all(results):
        raise SystemExit("quantized product check failed")
    return worst


def bits_of(torch, t):
    """A float tensor's bits as integers (fp32: int32, bf16: int16), so
    that an equality also tells -0 from 0."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def check_native(torch, i8, gen, device, dtype, K, N, M, bits, group, out_dtype=None,
                 label="", weights=None):
    """The integer arm's two kernels against their plain versions on one
    shape: the row quantizer's bytes and scales (and the workspace's zero
    padding) equal, the product's result equal bit for bit (fp32; bf16 the
    one rounding of it), two calls the same bits, one quantizer and one
    product launch a call. Returns (ok, max |diff| of the product, the
    weight)."""
    from pilottai_tpu_torch.models.quant import quantize_array

    if weights is None:
        w = torch.randn((K, N), generator=gen, device=device, dtype=torch.float32) * K**-0.5
        weights = quantize_array(w, dtype, bits=bits, group=group)
        del w
    x = randn(torch, gen, (M, K), dtype, device)
    n0 = (i8.launches, i8.launches_quant)
    got = i8.int8_matmul(x, weights, out_dtype)
    again = i8.int8_matmul(x, weights, out_dtype)
    moved = (i8.launches - n0[0], i8.launches_quant - n0[1])
    plan = i8.launch_plan(M, K, N, bits, group)
    xq, sx = i8.quantize_rows(x, plan)
    want_q, want_s = i8.quantize_rows_plain(x)
    want = i8.native_matmul_plain(x, weights, out_dtype)
    torch.cuda.synchronize()
    quant_ok = (torch.equal(xq[:M, :K], want_q)
                and torch.equal(bits_of(torch, sx[:M]), bits_of(torch, want_s[:, 0].contiguous()))
                and not bool(xq[M:].any()) and not bool(xq[:, K:].any()))
    same = torch.equal(bits_of(torch, got), bits_of(torch, again))
    equal = got.dtype == want.dtype and torch.equal(bits_of(torch, got), bits_of(torch, want))
    err = float((got.float() - want.float()).abs().max())
    ok = quant_ok and same and equal and moved == (2, 2) and bool(torch.isfinite(got).all())
    odt = str(got.dtype)[6:]
    log(f"  int8_matmul {label:<20} {quant_name(bits, group):<8} {str(dtype)[6:]:<8} -> "
        f"{odt:<8} M {M:>4} [{K}x{N}] (m16 tiles a warp {plan.mt}, {plan.n_groups} groups, "
        f"sum mode {plan.mode}): quantizer bytes and scales equal {quant_ok}; product equal "
        f"bit for bit {equal} (max |diff| {err:.3e}); repeat bit-identical {same}; launches "
        f"{moved[0]} product, {moved[1]} quantizer {'ok' if ok else 'FAIL'}")
    return ok, err, weights


def check_native_capture(torch, i8, gen, device, K, N, M, bits, group):
    """The pair captured in a CUDA graph after an eager call on the
    capturing stream: one launch of each counted, replays give the eager
    bits."""
    from pilottai_tpu_torch.models.quant import quantize_array

    w = torch.randn((K, N), generator=gen, device=device, dtype=torch.float32) * K**-0.5
    qw = quantize_array(w, torch.bfloat16, bits=bits, group=group)
    x = randn(torch, gen, (M, K), torch.bfloat16, device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        want = i8.int8_matmul(x, qw)
    stream.synchronize()
    n0 = (i8.launches, i8.launches_quant)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = i8.int8_matmul(x, qw)
    moved = (i8.launches - n0[0], i8.launches_quant - n0[1])
    same = []
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(bits_of(torch, got), bits_of(torch, want)))
    graph.reset()
    ok = all(same) and moved == (1, 1)
    log(f"  int8_matmul captured         {quant_name(bits, group):<8} bfloat16 M {M:>4} "
        f"[{K}x{N}]: capture counted {moved[0]} product and {moved[1]} quantizer launches; two "
        f"replays equal the eager bits {same} {'ok' if ok else 'FAIL'}")
    return ok


def phase_native(torch, i8, device, seed):
    """The integer arm (``PILOTTAI_QMATMUL=native``): int8 and int4 at
    groups 128 and 96 at K = 4100 (no multiple of either group: a short
    last group; 33 and 43 groups, XLA's windows) and 1, 8, 17, 32, 256 and
    2048 rows, fp32 and bf16 input, fp32 output; llama3-8b's wq and wd
    (K 14336: 112 groups) at 8 and 2048 rows with bf16 and fp32 output;
    protocol-s's four matrices in fp32 at 4 and 16 rows; and the pair
    captured in a CUDA graph. Returns the largest max |diff| (0 when every
    product equals its plain version bit for bit)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 7)
    results, worst = [], 0.0

    def run(dtype, K, N, rows, bits, group, out_dtype, label):
        nonlocal worst
        weights = None
        for M in rows:
            ok, err, weights = check_native(torch, i8, gen, device, dtype, K, N, M, bits, group,
                                            out_dtype, label, weights)
            results.append(ok)
            worst = max(worst, err)

    for bits, group in QUANT_MODES:
        for dtype in (torch.float32, torch.bfloat16):
            run(dtype, 4100, 1024, (1, 8, 17, 32, 256, 2048), bits, group, torch.float32,
                "K off the group")
        if bits == 8 or group == 128:
            for K, N in (LLAMA_MATRICES[0], LLAMA_MATRICES[3]):
                for out_dtype in (torch.float32, None):
                    run(torch.bfloat16, K, N, (8, 2048), bits, group, out_dtype, "llama3-8b")
        for K, N in PROTOCOL_S_MATRICES:
            run(torch.float32, K, N, (4, 16), bits, group, None, "protocol-s")
    for bits, group in QUANT_MODES[:2]:
        results.append(check_native_capture(torch, i8, gen, device, 4096, 1024, 8, bits, group))
    if not all(results):
        raise SystemExit("integer arm check failed")
    return worst


@contextlib.contextmanager
def qmatmul_env(arm):
    """``PILOTTAI_QMATMUL`` set to ``arm`` (None: unset) while inside: an
    engine reads it once, when it starts, and holds that arm."""
    old = os.environ.pop("PILOTTAI_QMATMUL", None)
    if arm is not None:
        os.environ["PILOTTAI_QMATMUL"] = arm
    try:
        yield
    finally:
        os.environ.pop("PILOTTAI_QMATMUL", None)
        if old is not None:
            os.environ["PILOTTAI_QMATMUL"] = old


# --------------------------------------------------------------------- #
# Phase 4: golden token ids on protocol-s, dense and paged
# --------------------------------------------------------------------- #

def record_requests(handler):
    """Wrap the engine's submit so the smoke sees each request's token ids."""
    batcher = handler.backend.batcher
    seen = []
    # The engine's own submit, however many times its requests are recorded.
    submit = batcher.__dict__.get("_smoke_submit", batcher.submit)
    batcher._smoke_submit = submit

    def recording(request):
        seen.append(request)
        return submit(request)

    batcher.submit = recording
    return seen


def reset(kernels):
    for mod in kernels.values():
        mod.launches = 0
    kernels["flash"].launches_dq = kernels["flash"].launches_dkv = 0
    kernels["qmatmul"].launches_dequant = 0
    kernels["qmatmul"].launches_by_shape.clear()
    kernels["int8_matmul"].launches_quant = 0
    kernels["int8_matmul"].launches_by_shape.clear()


def counts(kernels):
    """Every kernel's launches: K1, K2, K3, the quantized product's fused
    launches and the integer arm's product by module, K4 and K5 beside K1,
    the quantized product's dequant launches and the integer arm's
    quantizer beside theirs, both products' by shape."""
    out = {name: mod.launches for name, mod in kernels.items()}
    out["bwd_dq"] = kernels["flash"].launches_dq
    out["bwd_dkv"] = kernels["flash"].launches_dkv
    out["qmatmul_dequant"] = kernels["qmatmul"].launches_dequant
    out["qmatmul_shapes"] = dict(kernels["qmatmul"].launches_by_shape)
    out["int8_quant"] = kernels["int8_matmul"].launches_quant
    out["int8_shapes"] = dict(kernels["int8_matmul"].launches_by_shape)
    return out


def launches_text(launches):
    return (f"flash_fwd {launches['flash']}, decode_attention {launches['decode']}, "
            f"paged_attention {launches['paged']}, flash_bwd_dq {launches['bwd_dq']}, "
            f"flash_bwd_dkv {launches['bwd_dkv']}, qmatmul fused {launches['qmatmul']}, "
            f"qmatmul dequant {launches['qmatmul_dequant']}, int8_matmul "
            f"{launches['int8_matmul']}, int8 row quantizer {launches['int8_quant']}")


@contextlib.contextmanager
def counting_prefill_qmm(qk, into):
    """Count the batcher's prefills (admissions, tail prefills and
    chunked-prefill segments, one forward each) into ``into["calls"]``,
    the quantized product's fused launches made inside them into
    ``into["prefill"]`` (a prefill of 64 rows or fewer takes the fused
    kernel too) and the integer arm's product launches into
    ``into["prefill_native"]``, so that the decode steps' own can be held
    to seven a layer a step. The prefills run on the device thread one at
    a time, between chunks."""
    from pilottai_tpu_torch.engine import batcher as batcher_mod
    from pilottai_tpu_torch.ops.kernels import int8_matmul as i8

    names = ("admit_group", "admit_group_prefix", "admit_group_prefix_paged",
             "extend_prompt_paged")
    saved = {n: getattr(batcher_mod, n) for n in names}

    def counted(fn):
        def call(*a, **kw):
            n0, i0 = qk.launches, i8.launches
            try:
                return fn(*a, **kw)
            finally:
                into["prefill"] = into.get("prefill", 0) + qk.launches - n0
                into["prefill_native"] = into.get("prefill_native", 0) + i8.launches - i0
                into["calls"] = into.get("calls", 0) + 1
        return call

    for n, fn in saved.items():
        setattr(batcher_mod, n, counted(fn))
    try:
        yield into
    finally:
        for n, fn in saved.items():
            setattr(batcher_mod, n, fn)


def qmm_step_check(launches, counted, batcher, steps, label):
    """With quantized weights every decode step or verify block dispatched
    launches the fused product once for each of the seven matrices of every
    layer (graph replays included), and every prefill (``counted``, from
    ``counting_prefill_qmm``) seven a layer too: the fused kernel at 64 rows
    or fewer, the dequant kernel above. A dense engine launches neither."""
    if batcher.weight_quant == "none":
        log(f"  {label}: dense weights: quantized product {launches['qmatmul']} fused and "
            f"{launches['qmatmul_dequant']} dequant launches, integer arm "
            f"{launches['int8_matmul']} (none expected)")
        if launches["qmatmul"] or launches["qmatmul_dequant"] or launches["int8_matmul"]:
            raise SystemExit(f"{label}: dense weights launched the quantized product")
        return
    if batcher.qmatmul_arm == "native":
        native_step_check(launches, counted, batcher, steps, label)
        return
    if launches["int8_matmul"] or launches["int8_quant"]:
        raise SystemExit(f"{label}: the dequant arm launched the integer arm's kernels")
    per = 7 * batcher.cfg.n_layers
    prefill_fused, calls = counted.get("prefill", 0), counted.get("calls", 0)
    decode_fused = launches["qmatmul"] - prefill_fused
    log(f"  {label}: quantized product: {launches['qmatmul']} fused launches ({prefill_fused} in "
        f"{calls} prefills, {decode_fused} in {steps} decode steps or blocks = "
        f"{decode_fused / max(steps, 1):g} a step, expected {per}), "
        f"{launches['qmatmul_dequant']} dequant launches (prefills past 64 rows)")
    if (steps <= 0 or calls <= 0 or decode_fused != per * steps
            or prefill_fused + launches["qmatmul_dequant"] != per * calls):
        raise SystemExit(f"{label}: the quantized product did not launch seven times a layer "
                         "a decode step and a prefill")


def native_step_check(launches, counted, batcher, steps, label):
    """The integer arm (``PILOTTAI_QMATMUL=native`` held at ``start()``):
    every decode step or verify block launches the integer product seven
    times a layer and every prefill seven a layer too, each with one row
    quantizer launch, and the dequant arm's kernels never run."""
    per = 7 * batcher.cfg.n_layers
    prefill, calls = counted.get("prefill_native", 0), counted.get("calls", 0)
    decode = launches["int8_matmul"] - prefill
    log(f"  {label}: integer arm (held at start: {batcher.graph_report()['qmatmul_arm']}): "
        f"{launches['int8_matmul']} product launches ({prefill} in {calls} prefills, {decode} in "
        f"{steps} decode steps or blocks = {decode / max(steps, 1):g} a step, expected {per}), "
        f"{launches['int8_quant']} row-quantizer launches; the dequant arm's fused "
        f"{launches['qmatmul']} and dequant {launches['qmatmul_dequant']} (0 expected)")
    if (steps <= 0 or calls <= 0 or decode != per * steps or prefill != per * calls
            or launches["int8_quant"] != launches["int8_matmul"]
            or launches["qmatmul"] or launches["qmatmul_dequant"]
            or batcher.graph_report()["qmatmul_arm"] != "native"):
        raise SystemExit(f"{label}: the integer arm did not launch its two kernels seven times "
                         "a layer a decode step and a prefill, alone")


def qmm_shape_check(launches, batcher, steps, label):
    """The quantized product's launches by shape, as the wrapper counted
    them (graph replays included): every decode step of ``n_slots`` rows
    launches each of llama3-8b's matrix shapes as many times a layer as the
    layer has matrices of that shape, and no prefill has that few rows."""
    native = batcher.qmatmul_arm == "native"
    shapes = launches["int8_shapes" if native else "qmatmul_shapes"]
    L, B = batcher.cfg.n_layers, batcher.n_slots
    log(f"  {label}: the quantized product's launches by "
        f"{'(rows, K, N), integer arm' if native else '(path, rows, K, N)'}: " + ", ".join(
            f"{k} {n}" for k, n in sorted(shapes.items())))
    for i, (K, N) in enumerate(LLAMA_MATRICES):
        got = shapes.get((B, K, N) if native else ("fused", B, K, N), 0)
        want = MATRIX_COUNT[i] * L * steps
        if got != want:
            raise SystemExit(f"{label}: {got} fused launches at {B} rows [{K}x{N}], expected "
                             f"{want} ({MATRIX_COUNT[i]} a layer a step)")


# The decode pipeline's knobs all off: one chunk in flight, admission on the
# device thread, fixed chunks, the sampler (4a and 4b also run the defaults).
SERIAL_KNOBS = dict(engine_pipeline=1, engine_overlap_admission=False,
                    engine_chunk_policy="fixed", engine_fused_epilogue=False)


def mib(n):
    return "not measured" if n is None else f"{n / 2**20:.1f} MiB"


def graph_text(batcher):
    g = batcher.graph_report()
    drafts = f", model-draft replays {g['draft_replays']}" if batcher.draft_layers else ""
    return (f"chunk graphs captured after start() {g['graphs']} ({g['capture_s']:.3f} s), "
            f"buffers {mib(g['buffer_bytes'])}, shared pool {mib(g['pool_bytes'])}{drafts}")


def sweep_text(batcher):
    """The warm-up sweep ``start()`` ran: its wall, the graphs it captured
    against the keys the settings reach, the eager chunks' and the
    captures' seconds, its requests, the variants' buffers (shared by
    shape, and one set a variant) and the graphs' pool."""
    s = batcher.graph_report()["sweep"]
    return (f"warm-up sweep {s['wall_s']:.2f} s: {s['graphs']} chunk graphs for "
            f"{len(batcher.reachable_keys())} reachable keys, eager chunks {s['eager_s']:.2f} s, "
            f"capture {s['capture_s']:.2f} s, {s['requests']} requests; buffers "
            f"{mib(s['buffer_bytes'])} "
            f"({mib(s['buffer_bytes_unshared'])} as one set a variant), shared pool "
            f"{mib(s['pool_bytes'])}")


def sweep_check(batcher, label):
    """Log the sweep; every reachable key must have been captured."""
    log(f"  {label}: {sweep_text(batcher)}")
    if batcher.graph_report()["sweep"]["graphs"] != len(batcher.reachable_keys()):
        raise SystemExit(f"{label}: the sweep did not capture every reachable chunk graph")


def no_capture_check(batcher, label):
    """Serving after ``start()`` captures no chunk graph."""
    g = batcher.graph_report()
    if g["graphs"]:
        raise SystemExit(f"{label}: {g['graphs']} chunk graphs captured after start() "
                         f"({g['capture_s']:.3f} s)")


def spec_launch_check(launches, batcher, blocks, draft_blocks, label):
    """Under speculation the paged verify launches K3 once per layer per
    block and the dense verify no decode kernel (its prefix is plain
    tensor products); each block dispatched with model drafts adds (D - 1)
    x draft layers launches of K2 (dense) or K3 (paged)."""
    D, dl, L = batcher.speculate, batcher.draft_layers, batcher.cfg.n_layers
    draft = (D - 1) * dl * draft_blocks
    want = ({"paged": L * blocks + draft, "decode": 0} if batcher.paged
            else {"paged": 0, "decode": draft})
    rep = batcher.spec_report()
    log(f"  {label}: {blocks} verify blocks of {D} dispatched ({draft_blocks} with model drafts "
        f"through {dl} layers): paged_attention {launches['paged']} (expected "
        f"{want['paged']}), decode_attention {launches['decode']} (expected "
        f"{want['decode']}); tokens per block {rep['tokens_per_block']:.3f} ({rep['tokens']} "
        f"tokens over {rep['blocks']} (block, slot) pairs); {graph_text(batcher)}")
    if blocks <= 0 or any(launches[k] != v for k, v in want.items()):
        raise SystemExit(f"{label}: the verify's kernels did not launch as expected")


def draft_from_the_model(batcher):
    """Put every admitted slot in model-draft mode with a low acceptance
    EMA, so the model-draft variant runs whatever the hysteresis would do
    (on the golden prompts the n-gram drafts accept about two tokens a
    block, which never switches a slot over)."""
    admit = batcher._dispatch_prefill

    def admitted(prep):
        admit(prep)
        with batcher._lock:
            for idx, _ in prep.group:
                batcher._draft_on[idx] = True
                batcher._slot_rate[idx] = 1.0

    batcher._dispatch_prefill = admitted


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
                 prefix_cache=0, repeat=1, force_drafts=False, native=False):
    """Serve the golden prompts with the asset's engine settings (the page
    size replaced by ``page_size``, the pipeline or speculation knobs by
    ``knobs``, if given) and hold the ids to it. The prefix cache is off,
    as on the JAX engine that made the golden, unless ``prefix_cache`` is
    None (the port's default, on); ``repeat`` serves each case that many
    times in a row, every serving held to the golden; ``force_drafts``
    puts every slot in model-draft mode at admission; ``native`` starts the
    engine with ``PILOTTAI_QMATMUL=native`` (the variable unset again once
    it has started: the engine holds the arm it read). Returns the path's
    launches and the shapes its fp32 kernels saw."""
    from pilottai_tpu_torch import LLMConfig, LLMHandler, PROTOCOL_S_NPZ
    from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
    from pilottai_tpu_torch.models.transformer import forward_prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmuls and cuDNN (torch.backends.*.allow_tf32 = False)")
    golden = json.loads((root / "pilottai_tpu_torch" / "assets" / asset).read_text())
    model, checkpoint = "protocol-s", PROTOCOL_S_NPZ
    if "config" in golden:
        # A test model the golden file defines (4h: the head_dim 256 Gemma
        # ones), registered from its config, its weights beside it.
        from pilottai_tpu_torch.models.common import ModelConfig
        from pilottai_tpu_torch.models.registry import register_model

        register_model(ModelConfig(**golden["config"]))
        model = golden["model"]
        checkpoint = str(root / "pilottai_tpu_torch" / "assets" / golden["checkpoint"])
    if page_size is not None:
        golden["engine"] = dict(golden["engine"], engine_page_size=page_size)
    golden["engine"] = dict(golden["engine"], **(knobs or {}))
    if prefix_cache is not None:
        golden["engine"]["engine_prefix_cache"] = prefix_cache
    log(f"  {asset}: engine {golden['engine']}")
    quantize_seconds = {}

    async def run():
        handler = LLMHandler(LLMConfig(
            provider="cuda", model_name=model, checkpoint_path=checkpoint,
            sampling={"temperature": 0.0, "max_new_tokens": golden["max_new_tokens"]},
            **golden["engine"],
        ))
        with qmatmul_env("native" if native else None):
            await handler.start()
        quantize_seconds["s"] = handler.backend.quantize_seconds
        seen = record_requests(handler)
        batcher = handler.backend.batcher
        sweep_check(batcher, "engine start")
        if native and batcher.graph_report()["qmatmul_arm"] != "native":
            raise SystemExit("the engine did not hold the native arm it started under")
        if force_drafts:
            draft_from_the_model(batcher)
        try:
            out = []
            reset(kernels)
            qmm_counter.clear()
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
    qmm_counter = {}
    with counting_prefill_qmm(kernels["qmatmul"], qmm_counter):
        got, batcher = arun(run())
    launches = counts(kernels)      # read once the engine's threads have stopped
    no_capture_check(batcher, "golden")
    if golden["engine"].get("engine_kv_quantize"):
        panels, scales = cache_bytes(batcher.cache)
        log(f"  int8 KV cache: {panels} bytes of int8 {'pools' if paged else 'panels'} and "
            f"{scales} bytes of fp32 scales")
        cache = batcher.cache
        if cache.scales is None or cache.layers[0][0].dtype != torch.int8:
            raise SystemExit("engine_kv_quantize='int8' did not make an int8 cache")
    n = len(golden["cases"]) * repeat
    log(f"  launches on this run ({n} requests, fp32): {launches_text(launches)}")
    qmm_step_check(launches, qmm_counter, batcher, batcher.blocks_dispatched, "golden")
    if batcher.weight_quant != "none":
        wq = batcher.params["layers"][0]["mlp"]["wg"]
        log(f"  weights {batcher.weight_quant}"
            f"{f' group {batcher.quant_group}' if batcher.weight_quant == 'int4' else ''} "
            f"({type(wq).__name__}), {batcher.weight_bytes} bytes resident, "
            f"{batcher.weight_bytes_per_token} read a decode step; quantized in "
            f"{quantize_seconds.get('s', 0.0):.3f} s at start")
    if batcher.speculate:
        spec_launch_check(launches, batcher, batcher.blocks_dispatched, batcher.draft_blocks,
                          "golden")
        if force_drafts and not batcher.graph_report()["draft_replays"]:
            raise SystemExit("the model-draft variant was never replayed")
    else:
        per_step_check(launches, batcher, batcher.blocks_dispatched, "golden")
    if paged:
        log(f"  paged: {batcher.num_pages} pages of {batcher.page_size}, prefill segments "
            f"{batcher.prefill_segments}, free pages after {batcher.alloc.free_pages}")
        if (launches["flash"] <= 0 or launches["paged"] <= 0 or launches["decode"] != 0
                or batcher.prefill_segments <= 0):
            raise SystemExit("the paged golden path did not run K1, K3 and prefill segments "
                             "with K2 at zero")
    elif (launches["flash"] <= 0 or launches["paged"] != 0
          or (launches["decode"] <= 0 and not batcher.speculate)):
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
        "blocks": batcher.blocks_dispatched,
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
# 5h's timed waves, fewer than 5f's ``WAVES`` for the smoke's time limit.
NATIVE_WAVES = 3
# 5e's speculative engines run llama3-8b at 24 of its 32 layers (full
# width): their warm-up sweeps took ~290 s of the smoke at 32, and 4e and
# 5f need the time. At 16 layers the random model ended its replies after
# ~10 tokens and no draft was accepted, so 5e gates on the two below.
# 5e's numbers at full depth are in PERF.md.
SPEC_LAYERS = 24
# ... and they run fixed chunks of ``engine_chunk`` verify blocks, so their
# sweeps capture a quarter of the graphs (one chunk bucket, not four): at
# 24 layers and adaptive chunks they took 80-135 s each, and at 20 or 16
# layers the random model's replies end after 2 to 7 tokens with no draft
# accepted, so their depth cannot give the time back (PERF.md §4).
SPEC_KNOBS = dict(engine_speculate=4, engine_chunk_policy="fixed")
# 5e's timed waves must accept drafts (more than one token a verify block)
# and run their replies to at least this share of the 64-token budget.
SPEC_MIN_REPLY_SHARE = 0.5
# 5c's waves under torch.profiler. The busy share sums the profiler's raw
# device events (``device_busy_us``): building its event tree, as
# ``key_averages`` does, costs tens of seconds a wave (~60,000 kernel
# events), so only the first wave's kernel table takes that path. Three
# waves, not five: the Gemma phases (4h, 5i) needed the time.
PROFILED_WAVES = 3
# 5g's paged engine runs fixed chunks, not the adaptive policy: a quarter of
# the graphs to capture (14 of 56; ~100 s of capture on the H100 at
# adaptive chunks), for the Gemma phases' time. The phase measures the
# int8 cache, not the chunk policy; its TTFT and TPOT are therefore no
# longer held beside 5b's, whose engine runs the adaptive policy.
KV8_PAGED_KNOBS = dict(engine_chunk_policy="fixed")

_LOOP = None


def arun(coro):
    """Run a coroutine on the smoke's one event loop: the shared engines
    outlive a phase."""
    global _LOOP
    if _LOOP is None:
        _LOOP = asyncio.new_event_loop()
    return _LOOP.run_until_complete(coro)


# The llama3-8b engines of 5a (dense, 2048) and 5b (paged, 8192), kept for
# 5d's cache-off waves, 5e's speculation-off waves and 5c's profiled ones,
# which would otherwise each sweep the same graphs again. Stopped after 5c.
SHARED = {}
# The device bytes each live llama3-8b engine holds once started (its
# weights, cache, chunk buffers and graphs): a wave's peak less the other
# live engines' is the engine's own (``own_peak``).
RESIDENT = {}


def full_width_config(seed, max_seq, **knobs):
    from pilottai_tpu_torch import LLMConfig

    kw = dict(provider="cuda", model_name="llama3-8b", dtype="bfloat16", engine_slots=8,
              engine_admit_batch=8, engine_max_seq=max_seq, engine_chunk=16, seed=seed,
              engine_prefix_cache=0)
    kw.update(knobs)
    return LLMConfig(**kw)


@contextlib.contextmanager
def llama_depth(layers):
    """llama3-8b at ``layers`` layers (full width) for the engines started
    inside; None keeps its 32."""
    from pilottai_tpu_torch.engine import native

    get = native.get_model_config
    if layers is not None:
        native.get_model_config = lambda name: get(name).replace(n_layers=layers)
    try:
        yield
    finally:
        native.get_model_config = get


async def full_width_engine(torch, seed, max_seq, label, layers=None, **knobs):
    """A started llama3-8b engine at the smoke's settings and ``knobs``
    (at ``layers`` layers if given); without either, the shared one of
    ``max_seq`` (started at its first use). Logs the start, its warm-up
    sweep and the bytes it holds."""
    from pilottai_tpu_torch import LLMHandler

    if not knobs and layers is None and max_seq in SHARED:
        log(f"  {label}: the shared engine of engine_max_seq {max_seq}")
        return SHARED[max_seq]
    gc.collect()                        # an earlier engine's garbage goes first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with llama_depth(layers):
        handler = LLMHandler(full_width_config(seed, max_seq, **knobs))
    t0 = time.perf_counter()
    await handler.start()
    torch.cuda.synchronize()
    RESIDENT[handler] = torch.cuda.memory_allocated() - before
    cfg = handler.backend.model_cfg
    log(f"  {label}: llama3-8b bf16 random init at {cfg.n_layers} layers and start() in "
        f"{time.perf_counter() - t0:.1f} s ({cfg.param_count() / 1e9:.2f}B params, vocab "
        f"{cfg.vocab_size}); it holds {RESIDENT[handler] / 2**30:.2f} GiB")
    sweep_check(handler.backend.batcher, label)
    if not knobs and layers is None:
        SHARED[max_seq] = handler
    return handler


def own_peak(torch, handler):
    """The engine's own peak since the last ``reset_peak_memory_stats``:
    the process's peak less what the other live engines hold."""
    others = sum(b for h, b in RESIDENT.items() if h is not handler)
    return torch.cuda.max_memory_allocated() - others


async def release(handler):
    """Stop an engine unless it is shared."""
    if all(handler is not h for h in SHARED.values()):
        RESIDENT.pop(handler, None)
        await handler.stop()


def stop_shared():
    for handler in SHARED.values():
        RESIDENT.pop(handler, None)
        arun(handler.stop())
    SHARED.clear()


def first_wave_line(first, waves, label):
    """The first wave served after ``start()`` beside the timed waves."""
    t = median([w["ttft_ms"] for w in waves])
    f = first[0]["ttft_ms"]
    log(f"  {label}: the first wave served after start(): TTFT p50 {f:.4f} ms against the "
        f"timed waves' median {t:.4f} ms ({f / t:.3f} x)")
    return f / t


async def ttft_behind_chunk(handler, requests, label):
    """TTFT of one request submitted while a decode chunk is in flight:
    all requests but the last are sent, and once each has its first token
    and a chunk is dispatched but not folded, the last one. Logs the steps
    in flight, its TTFT and the steps dispatched against the useful ones
    over the wave."""
    from pilottai_tpu_torch.engine.types import GenerationParams

    batcher = handler.backend.batcher

    def send(messages, n):
        return asyncio.ensure_future(handler.generate_response(
            messages, params=GenerationParams(temperature=0.0, max_new_tokens=n),
            json_mode=True))

    await settle(batcher)
    seen = record_requests(handler)
    d0, u0 = batcher.blocks_dispatched, batcher.blocks_useful
    tasks = [send(*r) for r in requests[:-1]]
    t0 = time.perf_counter()
    while not (len(seen) == len(tasks) and all(r.first_token_at is not None for r in seen)
               and batcher.blocks_dispatched > batcher.blocks_folded):
        if time.perf_counter() - t0 > 60 or all(t.done() for t in tasks):
            raise SystemExit(f"{label}: no decode chunk in flight to submit behind")
        await asyncio.sleep(0.0005)
    in_flight = batcher.blocks_dispatched - batcher.blocks_folded
    tasks.append(send(*requests[-1]))
    await asyncio.gather(*tasks)
    await settle(batcher)
    last = seen[-1]
    ttft = (last.first_token_at - last.submitted_at) * 1e3
    log(f"  {label}: TTFT of a request submitted with {in_flight} decode steps dispatched and not "
        f"folded: {ttft:.4f} ms; steps dispatched over that wave "
        f"{batcher.blocks_dispatched - d0}, useful {batcher.blocks_useful - u0}")
    return ttft


def replay_all_done(torch, batcher, label):
    """One replay of the engine's widest chunk graph (the fused epilogue,
    dense) with every slot done, on the device thread while the engine is
    idle: the chunk has no exit (ROADMAP C.4), so it runs every step."""
    runner = batcher.runner
    graph = runner._variants[runner.key(batcher.chunk_size, batcher.fused_epilogue)].graph

    def timed():
        if not bool(batcher.dstate.done.all()):
            raise SystemExit(f"{label}: a slot is live; no all-done replay")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        graph.replay()
        ev[0].record()
        graph.replay()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    ms = batcher.call_on_device(timed)
    log(f"  {label}: one replay of the {batcher.chunk_size}-step graph with every slot done: "
        f"{ms:.4f} ms ({ms / batcher.chunk_size:.4f} ms a step; every step runs, ROADMAP C.4)")
    return ms


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
        blocks0 = (getattr(batcher, "blocks_dispatched", 0), getattr(batcher, "blocks_useful", 0))
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
            t1 = time.perf_counter()
            busy = device_busy_us(prof)
            wave = {"busy": busy / (wall * 1e6) if busy else None, "wall_s": wall,
                    "processing_s": time.perf_counter() - t1}
            if w == 0:
                rows0 = raw_device_rows(prof)
                report_profile(prof, wall * 1e6, f"wave 1 of {n_waves} ({label})", rows=rows0)
                log(f"  the raw events' device time {busy / 1e3:.3f} ms against the kernel "
                    f"table's {sum(r[0] for r in rows0) / 1e3:.3f} ms; the table took "
                    f"{time.perf_counter() - t1:.1f} s to build")
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
                "tokens_a_reply": sum(t["tokens"] for t in timings) / max(len(timings), 1),
            }
            if hasattr(batcher, "blocks_useful"):
                await settle(batcher)        # the chunks in flight at the end folded too
                wave["steps_dispatched"] = batcher.blocks_dispatched - blocks0[0]
                wave["steps_useful"] = batcher.blocks_useful - blocks0[1]
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


async def settle(batcher, timeout_s=300.0):
    """Wait until every slot is free and every dispatched chunk has been
    folded (``blocks_folded``; a tree without it: handed to the reader),
    so no chunk is still being dispatched: the launch counters and the
    steps dispatched then agree."""
    t0 = time.perf_counter()
    folded = getattr(batcher, "blocks_folded", None)
    while (batcher._results.qsize() or any(s is not None for s in batcher._slots)
           or (folded is not None and batcher.blocks_folded != batcher.blocks_dispatched)):
        if time.perf_counter() - t0 > timeout_s:
            raise SystemExit(f"the engine did not settle in {timeout_s:.0f} s")
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.05)


def device_busy_us(prof):
    """The device µs of a finished ``torch.profiler`` run's kernels, summed
    over the profiler's raw events, host events and user annotations left
    out: what ``device_rows`` sums, without the event tree it builds."""
    from torch.autograd import DeviceType

    total = 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CPU or getattr(evt, "is_user_annotation",
                                                           lambda: False)():
            continue
        total += evt.duration_ns()
    return total / 1e3


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


def raw_device_rows(prof):
    """``device_rows`` from the profiler's raw events grouped by name (the
    events ``device_busy_us`` sums), without the event tree that
    ``key_averages`` builds first: that tree took 17-26 s for each
    llama3-8b wave of 5c. The large waves' tables use it;
    ``profiled_launch_ms`` holds it against ``device_rows`` row by row."""
    from torch.autograd import DeviceType

    by_name = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CPU or getattr(evt, "is_user_annotation",
                                                           lambda: False)():
            continue
        dev, count = by_name.get(evt.name(), (0.0, 0))
        by_name[evt.name()] = (dev + evt.duration_ns() / 1e3, count + 1)
    return [(dev, name, count) for name, (dev, count) in by_name.items() if dev > 0]


def report_profile(prof, wall_us, label, top=8, rows=None):
    """Log the device's busy share of ``wall_us`` and the kernels that fill
    it, from a finished ``torch.profiler`` run; returns the share. Only the
    device's own kernel rows count: an operator row (``aten::mm``, an
    autograd Function) carries the time of the kernels it launched, and a
    user annotation (``Optimizer.step#AdamW.step``) spans them on the
    device, so either would count them twice. ``rows``: the run's
    ``device_rows`` where the caller has them."""
    rows = device_rows(prof) if rows is None else rows
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

    def plain(q, k, v, last, q_positions, scale, softcap, window, return_stats,
              k_scales=None, v_scales=None):
        return da.decode_attention_plain(q, k, v, last, q_positions, scale, softcap, window,
                                         k_scales, v_scales)

    decode.decode_attention = plain
    try:
        yield
    finally:
        decode.decode_attention = kernel


def uncapped(cfg):
    """``cfg`` with the logits' soft-cap off. The logits checks
    (``TOL_E2E``: max |difference| over max |logit|) compare a soft-capped
    head before the cap: gemma2-2b's cap of 30 pins max |logit| at 30 on
    random weights (the raw logits reach ~2000), and the cap turns a
    relative difference of ~2e-4 into ~2e-2 there, with the plain bf16
    forward itself ~5e-2 from the fp32 one (an H100 reading, PERF.md).
    The cap is monotonic, so the argmax is the same either way."""
    return cfg.replace(logit_softcap=0.0) if cfg.logit_softcap > 0.0 else cfg


def decode_step_check(torch, mod, batcher, plain=None, others=()):
    """One decode step of the batcher's live state (on its device thread,
    between two chunks) through its decode kernel, K2 on the dense cache or
    K3 on the paged one, and through that kernel's plain version (or
    through the route ``plain`` sets up): the logits of every live slot.
    The step writes only fresh rings, never the cache, and its launches
    (of ``mod`` and of the modules in ``others``) are taken back out of the
    counts. A soft-capped head (gemma2) is compared before its cap
    (``uncapped``), its capped logits recorded beside (``"capped"``)."""
    from pilottai_tpu_torch.engine import decode

    cfg, cache, dstate = uncapped(batcher.cfg), batcher.cache, batcher.dstate
    dev = batcher.device
    counters = [(m, a) for m in (mod, *others)
                for a in ("launches", "launches_dequant", "launches_quant", "launches_by_shape")
                if hasattr(m, a)]
    n0 = [dict(getattr(m, a)) if a == "launches_by_shape" else getattr(m, a)
          for m, a in counters]
    pos = cache.lengths.clone()
    kw = {}
    if batcher.paged:
        kw = dict(table=torch.from_numpy(batcher.alloc.table.copy()).to(dev),
                  n_blocks=max(-(-int(pos.max()) // batcher.page_size), 1))

    def step():
        rings = decode.new_rings(cfg, batcher.n_slots, batcher.chunk_size,
                                 decode.ring_dtype(cfg, cache), dev)
        return decode.decode_step_logits(batcher.params, cfg, cache, dstate.tokens, pos,
                                         pos - 1, rings, 0, **kw)

    got = step()
    if plain is None:
        plain = plain_paged_attention(mod) if batcher.paged else plain_decode_attention(mod)
    with plain:
        want = step()
    torch.cuda.synchronize()
    for (m, a), n in zip(counters, n0):
        if isinstance(n, dict):
            getattr(m, a).clear()
            getattr(m, a).update(n)
        else:
            setattr(m, a, n)
    live = torch.nonzero(~dstate.done).flatten()
    out = logits_agreement(got, want, live)
    out["finite"] = bool(torch.isfinite(got).all())
    out["lengths"] = pos.tolist()
    cap = batcher.cfg.logit_softcap
    if cap > 0.0:
        out["capped"] = logits_agreement(torch.tanh(got / cap) * cap,
                                         torch.tanh(want / cap) * cap, live)
    return out


def phase_full_width(torch, kernels, seed):
    from pilottai_tpu_torch.engine.types import GenerationParams
    from pilottai_tpu_torch.models.transformer import forward_prefill

    fa, da = kernels["flash"], kernels["decode"]
    prompts = [[FULL_PROMPT.format(i=i)] for i in range(8)]
    reqs = [(p, 64) for p in prompts]
    shapes = {}
    state = {}

    async def run():
        handler = await full_width_engine(torch, seed, 2048, "5a dense engine")
        batcher = handler.backend.batcher
        # The first wave the engine serves, as the timed waves are served.
        first, _ = await timed_waves(handler, reqs, "dense, the first wave served", n_waves=1)
        params = {"temperature": 0.0, "max_new_tokens": 64}
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
        peak = own_peak(torch, handler)
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
        shapes["waves"], _ = await timed_waves(handler, reqs, "dense, 8 x 64 tokens")
        shapes["first_wave"] = first_wave_line(first, shapes["waves"], "5a")
        shapes["behind_chunk_ms"] = await ttft_behind_chunk(handler, reqs, "5a")
        shapes["all_done_ms"] = replay_all_done(torch, batcher, "5a")
        log(f"  after the waves: {graph_text(batcher)}")
        no_capture_check(batcher, "5a")
        return replies, wall, launches, timings, peak, finite, e2e

    replies, wall, launches, timings, peak, finite, e2e = arun(run())
    parsed = sum(1 for r in replies if parses(r.content))
    tokens = sum(t["tokens"] for t in timings)
    ttft = sorted(t["ttft_s"] for t in timings)
    tpot = sorted((t["e2e_s"] - t["ttft_s"]) / max(t["tokens"] - 1, 1) for t in timings)
    log(f"  8 requests, prompt tokens {shapes['prompt_lens']}, generated {shapes['gen_lens']}")
    log(f"  TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms; "
        f"TPOT p50 {tpot[len(tpot) // 2] * 1e3:.2f} ms; {tokens / wall:.1f} tokens/s over "
        f"{wall:.2f} s; peak memory {peak / 2**30:.2f} GiB (the engine's own)")
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
    """The device's busy share of ``PROFILED_WAVES`` profiled waves of each
    llama3-8b workload, on the shared engines (their graphs captured at
    start).
    Runs after every plain wave of the run: once the profiler has traced
    the card, launches stay slower. Returns K2's device time and launches
    in the first dense wave."""
    dense = [[FULL_PROMPT.format(i=i)] for i in range(8)]
    out = {}
    for label, max_seq, prompts, long_first in (
            ("dense, 8 x 64 tokens", 2048, dense, False),
            ("paged, 1 long + 7 short x 64 tokens", 8192, [[long_prompt(5900)]] + dense[:7],
             True)):
        async def run():
            handler = await full_width_engine(torch, seed, max_seq, f"5c {label}")
            reqs = [(p, 64) for p in prompts]
            out = await timed_waves(handler, reqs, label, long_first, n_waves=PROFILED_WAVES,
                                    profiled=True)
            no_capture_check(handler.backend.batcher, "5c")
            return out

        _, rows = arun(run())
        # fp32 GEMMs on the CUDA cores: the prefill's fp32 logits head, and
        # before the tail attention went through K1 the segments' prefix
        # einsums (~216 ms a paged wave).
        f32 = [(dev, key, count) for dev, key, count in rows or [] if "f32f32" in key]
        log(f"  fp32 GEMMs (f32f32) in the first profiled wave ({label}): {len(f32)} kernels, "
            f"{sum(c for _, _, c in f32)} launches, {sum(d for d, _, _ in f32) / 1e3:.2f} ms"
            + "".join(f"; {key[:70]} {count} x {dev / 1e3:.2f} ms" for dev, key, count in f32))
        # Every kind of GEMM the wave ran, by device time (cuBLAS's nvjet and
        # xmma kernels, CUTLASS's): the projections', the logits head's (bf16
        # x bf16 -> fp32 on the card) and the dense ring's fp32 products.
        gemms = sorted(((dev, key, count) for dev, key, count in rows or []
                        if any(n in key.lower() for n in ("gemm", "nvjet", "cutlass"))),
                       reverse=True)
        log(f"  GEMM kinds in the first profiled wave ({label}): {len(gemms)} kernels")
        for dev, key, count in gemms[:8]:
            log(f"    {dev / 1e3:9.2f} ms  {count:6d} x  {key[:110]}")
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
    from pilottai_tpu_torch.engine.types import GenerationParams

    pa = kernels["paged"]
    requests = [[long_prompt(5900)]] + [[FULL_PROMPT.format(i=i)] for i in range(7)]
    reqs = [(p, 64) for p in requests]
    label = "paged, 1 long + 7 short x 64 tokens"
    state = {"peak_pages": 0}

    async def run():
        handler = await full_width_engine(torch, seed, 8192, "5b paged engine")
        batcher = handler.backend.batcher
        log(f"  engine_max_seq 8192: paged {batcher.paged}: {batcher.num_pages} pages of "
            f"{batcher.page_size} (the last one scratch), prefill segments of "
            f"{batcher.prefill_chunk}, slot capacity {batcher.max_seq_len}")
        if not batcher.paged:
            raise SystemExit("engine_max_seq 8192 did not page the cache")
        first, _ = await timed_waves(handler, reqs, f"{label}, the first wave served",
                                     long_first=True, n_waves=1)
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
            timings=list(batcher.completed), peak=own_peak(torch, handler),
            prompt_lens=[len(r.prompt_ids) for r in seen],
            gen_lens=[len(r.future.result()) for r in seen],
            segments=batcher.prefill_segments - seg0,
            free_after=batcher.alloc.free_pages, usable=batcher.num_pages - 1,
            table_clear=bool((batcher.alloc.table == batcher.alloc.sentinel).all()),
            num_pages=batcher.num_pages, P=batcher.page_size, R=batcher.chunk_size,
            model=handler.backend.model_cfg,
        )
        out["waves"], _ = await timed_waves(handler, reqs, label, long_first=True)
        out["first_wave"] = first_wave_line(first, out["waves"], "5b")
        out["behind_chunk_ms"] = await ttft_behind_chunk(handler, reqs[1:], "5b")
        log(f"  after the waves: {graph_text(batcher)}")
        no_capture_check(batcher, "5b")
        return out

    out = arun(run())
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
        f"{out['peak'] / 2**30:.2f} GiB (the engine's own)")
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
# Phase 5i: the Gemma family at full width (head_dim 256)
# --------------------------------------------------------------------- #

# 5i's timed waves, after the checked one (fewer than 5a's ``WAVES``, for the
# smoke's time limit).
GEMMA_WAVES = 3
# 5i's engines: fixed chunks, and no fused greedy epilogue, which JSON
# requests never take: 7 graphs to capture at 8192 (of 56 at the defaults;
# a gemma2-2b graph took ~3 s to capture on the H100) and 1 at 2048.
GEMMA_KNOBS = dict(engine_chunk_policy="fixed", engine_fused_epilogue=False)


def phase_gemma_full_width(torch, kernels, seed, model, max_seq):
    """``model`` (gemma2-2b or gemma-2b) at full width, bf16, random
    weights from ``seed`` and the byte vocab, through the user's entry
    points, on fixed chunks without the fused epilogue (``GEMMA_KNOBS``:
    the phase does not measure the adaptive policy, and its JSON requests
    never take the epilogue). ``max_seq`` 8192
    pages the cache (pages of 128, 1024-token segments) and serves 5b's
    requests, one ~6050-token report ahead of seven ~184-token JSON ones, so
    gemma2-2b's 4096-key window masks in K1's segments and in K3; 2048 keeps
    the cache dense and serves 5a's eight. The first decode step with every
    slot live runs through the path's kernel (K2 or K3) and through its
    plain version; the longest prompt's first-token logits through K1 and
    through the plain K1; then ``GEMMA_WAVES`` timed waves. Returns the
    wave's launches and the shapes phase 6 times the head_dim 256 bodies
    at."""
    from pilottai_tpu_torch import LLMConfig, LLMHandler
    from pilottai_tpu_torch.engine.types import GenerationParams
    from pilottai_tpu_torch.models.transformer import forward_prefill

    fa = kernels["flash"]
    paged = max_seq >= 4096
    mod = kernels["paged"] if paged else kernels["decode"]
    label = f"5i {model}"
    short = [[FULL_PROMPT.format(i=i)] for i in range(8)]
    requests = [[long_prompt(5900)]] + short[:7] if paged else short
    reqs = [(p, 64) for p in requests]
    state = {}

    async def run():
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        handler = LLMHandler(LLMConfig(
            provider="cuda", model_name=model, dtype="bfloat16", engine_slots=8,
            engine_admit_batch=8, engine_max_seq=max_seq, engine_chunk=16, seed=seed,
            engine_prefix_cache=0, **GEMMA_KNOBS))
        t0 = time.perf_counter()
        await handler.start()
        torch.cuda.synchronize()
        RESIDENT[handler] = torch.cuda.memory_allocated() - before
        batcher = handler.backend.batcher
        cfg = batcher.cfg
        log(f"  {label}: bf16 random init at {cfg.n_layers} layers (head_dim {cfg.head_dim}, "
            f"{cfg.n_heads} query heads on {cfg.n_kv_heads} kv heads, windows "
            f"{sorted(set(cfg.window_sizes().tolist()))}, soft-caps {cfg.attn_softcap:g} / "
            f"{cfg.logit_softcap:g}) and start() in {time.perf_counter() - t0:.1f} s "
            f"({cfg.param_count() / 1e9:.2f}B params, vocab {cfg.vocab_size}); it holds "
            f"{RESIDENT[handler] / 2**30:.2f} GiB")
        sweep_check(batcher, label)
        if batcher.paged != paged or cfg.head_dim != 256:
            raise SystemExit(f"{label}: paged {batcher.paged}, head_dim {cfg.head_dim}")
        if paged:
            log(f"  {label}: {batcher.num_pages} pages of {batcher.page_size}, prefill "
                f"segments of {batcher.prefill_chunk}")
        decode = batcher._decode

        def watching():
            if "e2e" not in state and all(s is not None for s in batcher._slots):
                state["e2e"] = decode_step_check(torch, mod, batcher)
                state["last"] = [int(n) - 1 for n in batcher.cache.lengths.tolist()]
                if paged:
                    state["table"] = batcher.alloc.table.tolist()
            decode()

        def send(p):
            return asyncio.ensure_future(handler.generate_response(
                p, params=GenerationParams(temperature=0.0, max_new_tokens=64),
                json_mode=True))

        batcher._decode = watching
        batcher.completed.clear()
        seen = record_requests(handler)
        seg0 = batcher.prefill_segments
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        steps0 = batcher.blocks_dispatched
        t0 = time.perf_counter()
        with recording_tail_k1(state.setdefault("tail_calls", [])):
            tasks = [send(requests[0])]
            while (paged and batcher._segmenting is None and batcher.prefill_segments == seg0
                   and not tasks[0].done()):
                await asyncio.sleep(0.001)
            tasks += [send(p) for p in requests[1:]]
            replies = await asyncio.gather(*tasks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            await settle(batcher)
        launches = counts(kernels)
        per_step_check(launches, batcher, batcher.blocks_dispatched - steps0, label)
        batcher._decode = decode
        out = dict(replies=replies, wall=wall, launches=launches, model=cfg,
                   timings=list(batcher.completed), peak=own_peak(torch, handler),
                   prompt_lens=[len(r.prompt_ids) for r in seen],
                   gen_lens=[len(r.future.result()) for r in seen],
                   segments=batcher.prefill_segments - seg0, R=batcher.chunk_size)
        if paged:
            out.update(num_pages=batcher.num_pages, P=batcher.page_size,
                       free_after=batcher.alloc.free_pages, usable=batcher.num_pages - 1)
        # The longest prompt's first-token logits through K1 (its windowed
        # layers mask past 4096 keys) against the same forward with the plain
        # K1 on the same card.
        ids = torch.tensor([max((r.prompt_ids for r in seen), key=len)], device=batcher.device)
        T = ids.shape[1]
        pos = torch.arange(T, device=batcher.device, dtype=torch.int32)[None]
        val = torch.tensor([T], device=batcher.device, dtype=torch.int32)
        logits, _, _ = forward_prefill(batcher.params, uncapped(cfg), ids, pos, val)
        with plain_prefill_attention(fa):
            ref, _, _ = forward_prefill(batcher.params, uncapped(cfg), ids, pos, val)
        out["finite"] = (bool(torch.isfinite(logits).all())
                         and tuple(logits.shape) == (1, T, cfg.vocab_size))
        got, want = logits[0, T - 1][None], ref[0, T - 1][None]
        out["k1"] = logits_agreement(got, want, [0])
        out["k1"]["T"] = T
        if cfg.logit_softcap > 0.0:
            cap = cfg.logit_softcap
            out["k1"]["capped"] = logits_agreement(torch.tanh(got / cap) * cap,
                                                   torch.tanh(want / cap) * cap, [0])
        del logits, ref
        out["waves"], _ = await timed_waves(handler, reqs, label, long_first=paged,
                                            n_waves=GEMMA_WAVES)
        log(f"  after the waves: {graph_text(batcher)}")
        no_capture_check(batcher, label)
        RESIDENT.pop(handler, None)
        await handler.stop()
        return out

    out = arun(run())
    timings = out["timings"]
    tpot = median((t["e2e_s"] - t["ttft_s"]) / max(t["tokens"] - 1, 1) for t in timings)
    short_t = [t["ttft_s"] for t in timings if t["prompt_tokens"] <= 1000]
    long_t = [t["ttft_s"] for t in timings if t["prompt_tokens"] > 1000]
    parsed = sum(1 for r in out["replies"] if parses(r.content))
    log(f"  8 requests, prompt tokens {out['prompt_lens']}, generated {out['gen_lens']}")
    log(f"  the checked wave: TTFT p50 {median(short_t) * 1e3:.4f} ms"
        + (f", long {long_t[0] * 1e3:.4f} ms" if long_t else "")
        + f"; TPOT p50 {tpot * 1e3:.4f} ms; "
        f"{sum(t['tokens'] for t in timings) / out['wall']:.1f} tokens/s over "
        f"{out['wall']:.2f} s; peak memory {out['peak'] / 2**30:.2f} GiB (the engine's own); "
        f"JSON replies that parse: {parsed}/8 (random weights)")
    log(f"  launches on this run: {launches_text(out['launches'])}")
    k1 = out["k1"]
    k1_ok = out["finite"] and k1["rel"] <= TOL_E2E and k1["argmax_ok"]
    which = " before the soft-cap" if "capped" in k1 else ""

    def capped_text(check):
        c = check.get("capped")
        return (f"; after the cap (recorded): {c['max_diff']:.3e} over {c['max_logit']:.3e} = "
                f"{c['rel']:.3e}, same argmax {c['same_argmax']}") if c else ""

    log(f"  first-token logits{which} of a {k1['T']}-token prompt, K1 vs plain K1 (bf16): max "
        f"|diff| {k1['max_diff']:.3e} over max |logit| {k1['max_logit']:.3e} = {k1['rel']:.3e}, "
        f"tol {TOL_E2E:g}; same argmax {k1['same_argmax']} (top-2 margin {k1['margin']:.3e}); "
        f"finite, shape [1, T, vocab] {out['finite']} {'ok' if k1_ok else 'FAIL'}"
        + capped_text(k1))
    step = state.get("e2e")
    step_ok = bool(step) and step["finite"] and step["rel"] <= TOL_E2E and step["argmax_ok"]
    kname = "K3" if paged else "K2"
    if step:
        log(f"  one decode step of the live wave (slot lengths {step['lengths']}), logits{which}, "
            f"{kname} vs plain {kname} (bf16): max |diff| {step['max_diff']:.3e} over max "
            f"|logit| {step['max_logit']:.3e} = {step['rel']:.3e}, tol {TOL_E2E:g}; same argmax "
            f"{step['same_argmax']} (smallest top-2 margin {step['margin']:.3e}); finite "
            f"{step['finite']} {'ok' if step_ok else 'FAIL'}" + capped_text(step))
    else:
        log("  the wave never had all eight slots live: no decode-step check")
    launches = out["launches"]
    if paged:
        log(f"  prefill segments {out['segments']}; free pages after the wave "
            f"{out['free_after']} of {out['usable']}")
        if launches["flash"] <= 0 or launches["paged"] <= 0 or launches["decode"] != 0:
            raise SystemExit(f"{label}: the paged path did not go through K1 and K3 with K2 "
                             "at zero")
        if out["segments"] <= 0 or out["free_after"] != out["usable"]:
            raise SystemExit(f"{label}: chunked prefill did not run, or pages were not returned")
    elif launches["flash"] <= 0 or launches["decode"] <= 0 or launches["paged"] != 0:
        raise SystemExit(f"{label}: the dense path did not go through K1 and K2 alone")
    if not (k1_ok and step_ok):
        raise SystemExit(f"{label}: full-width outputs are wrong")
    shapes = dict(model=out["model"], last=state["last"], prompt_lens=out["prompt_lens"],
                  requests=len(requests), waves=out["waves"], tpot_ms=tpot * 1e3,
                  ttft_ms=median(short_t) * 1e3, peak=out["peak"])
    if paged:
        calls = state["tail_calls"]
        A, T, S = max(calls, key=lambda c: c[2])
        long_len = max(out["prompt_lens"])
        shapes.update(table=state["table"], num_pages=out["num_pages"], P=out["P"],
                      R=out["R"], step=out["R"] // 2,
                      segment=dict(A=A, T=T, plen=S - T, tails=[min(T, long_len - (S - T))],
                                   launches=len(calls), model=out["model"]))
    return launches, shapes


# --------------------------------------------------------------------- #
# Phase 5f: llama3-8b at full width with int8 and int4 weights
# --------------------------------------------------------------------- #

@contextlib.contextmanager
def plain_qmatmul(qk):
    """Route every quantized product through ``qmatmul_plain`` while
    inside."""
    from pilottai_tpu_torch.models import qmatmul as qmm

    kernel = qmm.quant_matmul
    qmm.quant_matmul = qk.qmatmul_plain
    try:
        yield
    finally:
        qmm.quant_matmul = kernel


def native_against_dequant(paths, mode):
    """5h's TTFT and TPOT p50 beside 5f's (the dequant arm) and 5a's (bf16
    weights), all from this run."""
    def p50(waves, key):
        return median([w[key] for w in waves])

    rows = [("5h native", paths[f"native_{mode}"]["waves"]),
            ("5f dequant", paths[f"quant_{mode}"]["waves"]),
            ("5a bf16", paths["full"][1]["waves"])]
    log(f"  {mode}: " + "; ".join(f"{label} TTFT p50 {p50(w, 'ttft_ms'):.4f} ms, TPOT p50 "
                                  f"{p50(w, 'tpot_ms'):.4f} ms" for label, w in rows))


@contextlib.contextmanager
def plain_native(i8):
    """Route every product of the integer arm through
    ``native_matmul_plain`` while inside."""
    from pilottai_tpu_torch.models import qmatmul as qmm

    kernel = qmm.int8_matmul
    qmm.int8_matmul = i8.native_matmul_plain
    try:
        yield
    finally:
        qmm.int8_matmul = kernel


def phase_quant_full_width(torch, kernels, seed, mode, native=False):
    """5a's dense engine and requests with ``engine_quant=mode`` (int4 at
    group 128): the first wave served, a counted wave whose first step with
    all eight slots live runs ``decode_step_check`` with every quantized
    product through its plain version, five timed waves; the first-token
    logits of one prompt against 5a's bf16 weights of the same seed
    (recorded: random weights say nothing of quality). ``native`` (5h):
    the engine started with ``PILOTTAI_QMATMUL=native`` and fixed chunks,
    the plain version ``native_matmul_plain``, ``NATIVE_WAVES`` timed
    waves."""
    from pilottai_tpu_torch.engine.types import GenerationParams
    from pilottai_tpu_torch.models.transformer import forward_prefill

    qk, da = kernels["qmatmul"], kernels["decode"]
    i8 = kernels["int8_matmul"]
    prompts = [[FULL_PROMPT.format(i=i)] for i in range(8)]
    reqs = [(p, 64) for p in prompts]
    knobs = dict(engine_quant=mode)
    if mode == "int4":
        knobs["engine_quant_group"] = 128
    if native:
        knobs["engine_chunk_policy"] = "fixed"
    tag = f"5h {mode} native" if native else f"5f {mode}"
    out = {"mode": mode, "native": native}

    async def run():
        with qmatmul_env("native" if native else None):
            handler = await full_width_engine(torch, seed, 2048, f"{tag} engine", **knobs)
        backend, batcher = handler.backend, handler.backend.batcher
        out["quantize_s"] = backend.quantize_seconds
        out["resident"] = RESIDENT[handler]
        out["weight_bytes"] = batcher.weight_bytes
        out["weight_bytes_per_token"] = batcher.weight_bytes_per_token
        log(f"  {tag}: quantized at start in {backend.quantize_seconds:.3f} s; weights "
            f"{batcher.weight_bytes / 2**30:.3f} GiB resident, {batcher.weight_bytes_per_token} "
            f"bytes read a decode step; the engine holds {RESIDENT[handler] / 2**30:.2f} GiB")
        first, _ = await timed_waves(handler, reqs, f"{mode}, the first wave served", n_waves=1)
        state = {}
        decode = batcher._decode

        def watching():
            if "e2e" not in state and all(s is not None for s in batcher._slots):
                state["e2e"] = decode_step_check(
                    torch, i8 if native else qk, batcher,
                    plain=plain_native(i8) if native else plain_qmatmul(qk), others=(da, qk, i8))
            decode()

        batcher._decode = watching
        counter = {}
        torch.cuda.reset_peak_memory_stats()
        with counting_prefill_qmm(qk, counter):
            reset(kernels)
            counter.clear()
            steps0 = batcher.blocks_dispatched
            replies = await asyncio.gather(*[
                handler.generate_response(p, params=GenerationParams(temperature=0.0,
                                                                     max_new_tokens=64),
                                          json_mode=True) for p in prompts])
            await settle(batcher)
        batcher._decode = decode
        launches = counts(kernels)
        steps = batcher.blocks_dispatched - steps0
        out["peak"] = own_peak(torch, handler)
        per_step_check(launches, batcher, steps, f"{tag} wave")
        qmm_step_check(launches, counter, batcher, steps, f"{tag} wave")
        if native and not any(k[0] > 64 for k in launches["int8_shapes"]):
            raise SystemExit(f"{tag}: the admission's prefill did not take the integer kernels")
        if not native and launches["qmatmul_dequant"] <= 0:
            raise SystemExit(f"{tag}: the admission's prefill did not take the dequant kernel")
        qmm_shape_check(launches, batcher, steps, f"{tag} wave")
        out["launches"], out["steps"], out["model"] = launches, steps, batcher.cfg
        out["model_slots"] = batcher.n_slots
        out["parsed"] = sum(1 for r in replies if parses(r.content))
        # First-token logits against 5a's bf16 engine, the same seed.
        ids = torch.tensor([backend.tokenizer.encode(FULL_PROMPT.format(i=0))],
                           device=batcher.device)
        T = ids.shape[1]
        pos = torch.arange(T, device=batcher.device, dtype=torch.int32)[None]
        val = torch.tensor([T], device=batcher.device, dtype=torch.int32)
        out["T"] = T
        got, _, _ = forward_prefill(batcher.params, batcher.cfg, ids, pos, val)
        dense = SHARED[2048].backend.batcher
        want, _, _ = forward_prefill(dense.params, dense.cfg, ids, pos, val)
        got, want = got[0].float(), want[0].float()
        out["finite"] = bool(torch.isfinite(got).all())
        out["corr"] = float(torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1])
        out["argmax_agree"] = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        out["waves"], _ = await timed_waves(handler, reqs, f"{mode}, 8 x 64 tokens",
                                            n_waves=NATIVE_WAVES if native else WAVES)
        out["first_wave"] = first_wave_line(first, out["waves"], tag)
        log(f"  after the waves: {graph_text(batcher)}")
        no_capture_check(batcher, tag)
        if batcher.graph_report()["qmatmul_arm"] != ("native" if native else "dequant"):
            raise SystemExit(f"{tag}: the engine does not hold the arm it started under")
        out["e2e"] = state.get("e2e")
        await release(handler)

    arun(run())
    gc.collect()
    torch.cuda.empty_cache()
    w = out["waves"]
    log(f"  {tag}: TTFT p50 {median([x['ttft_ms'] for x in w]):.4f} ms, TPOT p50 "
        f"{median([x['tpot_ms'] for x in w]):.4f} ms, {median([x['tokens_s'] for x in w]):.4f} "
        f"tokens/s (medians of {len(w)} waves); peak memory {out['peak'] / 2**30:.2f} GiB (the "
        f"engine's own); JSON replies that parse {out['parsed']}/8")
    log(f"  {tag}: first-token logits of all {out['T']} positions against 5a's bf16 weights of the "
        f"same seed (recorded, not gated): correlation {out['corr']:.6f}, argmax agreement "
        f"{out['argmax_agree']:.4f}")
    step = out["e2e"]
    step_ok = bool(step) and step["finite"] and step["rel"] <= TOL_E2E and step["same_argmax"]
    if step:
        log(f"  one decode step of the live wave (slot lengths {step['lengths']}), the quantized "
            f"product vs {'native_matmul_plain' if native else 'qmatmul_plain'} ({mode}, bf16): "
            f"max |diff| {step['max_diff']:.3e} over max "
            f"|logit| {step['max_logit']:.3e} = {step['rel']:.3e}, tol {TOL_E2E:g}; same argmax "
            f"{step['same_argmax']} (smallest top-2 margin {step['margin']:.3e}); finite "
            f"{step['finite']} {'ok' if step_ok else 'FAIL'}")
    else:
        log("  the wave never had all eight slots live: no decode-step check")
    if not step_ok or not out["finite"]:
        raise SystemExit(f"{tag}: the quantized decode step disagrees with the plain one")
    return out


# --------------------------------------------------------------------- #
# Phase 5g: llama3-8b at full width with the int8 KV cache
# --------------------------------------------------------------------- #

def cache_bytes(cache):
    """Device bytes of a KV cache: its panels or pools, and its scales."""
    panels = sum(t.numel() * t.element_size() for pair in cache.layers for t in pair)
    scales = sum(t.numel() * t.element_size() for pair in (cache.scales or []) for t in pair)
    return panels, scales


async def greedy_ids(handler, messages, n):
    from pilottai_tpu_torch.engine.types import GenerationParams

    seen = record_requests(handler)
    await handler.generate_response(
        messages, params=GenerationParams(temperature=0.0, max_new_tokens=n), json_mode=True)
    return list(seen[-1].future.result())


def phase_kv8_full_width(torch, kernels, seed, paged):
    """5a's dense engine and requests (``paged=False``) or 5b's paged engine
    and requests (the 6050-token prompt in 1024-token segments; fixed
    chunks, ``KV8_PAGED_KNOBS``) with
    ``engine_kv_quantize="int8"``, at all 32 layers: the first wave served,
    a counted wave whose first step with all eight slots live runs
    ``decode_step_check`` through K2's int8 body (dense) or K3 on the int8
    pools (paged) against the plain version, five timed waves; the cache's
    bytes against the shared bf16 engine's; and (recorded: random weights)
    how many leading tokens of one greedy reply equal the bf16 engine's."""
    da, pa = kernels["decode"], kernels["paged"]
    max_seq = 8192 if paged else 2048
    if paged:
        prompts = [[long_prompt(5900)]] + [[FULL_PROMPT.format(i=i)] for i in range(7)]
    else:
        prompts = [[FULL_PROMPT.format(i=i)] for i in range(8)]
    reqs = [(p, 64) for p in prompts]
    tag = f"5g {'paged' if paged else 'dense'} int8 KV"
    out, state = {"paged": paged}, {}

    async def run():
        handler = await full_width_engine(torch, seed, max_seq, f"{tag} engine",
                                          engine_kv_quantize="int8",
                                          **(KV8_PAGED_KNOBS if paged else {}))
        batcher = handler.backend.batcher
        if batcher.cache.scales is None or batcher.paged != paged:
            raise SystemExit(f"{tag}: the engine's cache is not int8 or not "
                             f"{'paged' if paged else 'dense'}")
        bf16 = SHARED[max_seq].backend.batcher
        out["bytes"], out["bytes_bf16"] = cache_bytes(batcher.cache), cache_bytes(bf16.cache)
        out["resident"] = RESIDENT[handler]
        first, _ = await timed_waves(handler, reqs, f"{tag}, the first wave served",
                                     long_first=paged, n_waves=1)
        decode = batcher._decode

        def watching():
            if all(s is not None for s in batcher._slots):
                if "e2e" not in state:
                    state["e2e"] = decode_step_check(torch, pa if paged else da, batcher)
                state["last"] = [int(n) - 1 for n in batcher.cache.lengths.tolist()]
                state["table"] = batcher.alloc.table.tolist() if paged else None
            decode()

        batcher._decode = watching
        seen = record_requests(handler)
        seg0 = batcher.prefill_segments
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        steps0 = batcher.blocks_dispatched
        from pilottai_tpu_torch.engine.types import GenerationParams

        def send(p):
            return asyncio.ensure_future(handler.generate_response(
                p, params=GenerationParams(temperature=0.0, max_new_tokens=64),
                json_mode=True))

        tasks = [send(prompts[0])]
        if paged:
            while (batcher._segmenting is None and batcher.prefill_segments == seg0
                   and not tasks[0].done()):
                await asyncio.sleep(0.001)
        tasks += [send(p) for p in prompts[1:]]
        replies = await asyncio.gather(*tasks)
        await settle(batcher)
        batcher._decode = decode
        launches = counts(kernels)
        steps = batcher.blocks_dispatched - steps0
        out["peak"] = own_peak(torch, handler)
        per_step_check(launches, batcher, steps, f"{tag} wave")
        out.update(launches=launches, steps=steps, model=batcher.cfg,
                   segments=batcher.prefill_segments - seg0,
                   prompt_lens=[len(r.prompt_ids) for r in seen],
                   parsed=sum(1 for r in replies if parses(r.content)))
        if paged and (out["segments"] <= 0
                      or batcher.alloc.free_pages != batcher.num_pages - 1):
            raise SystemExit(f"{tag}: chunked prefill did not run, or pages were not returned")
        if paged:
            out.update(num_pages=batcher.num_pages, P=batcher.page_size, R=batcher.chunk_size)
        # Leading greedy tokens of one reply against the bf16 engine's.
        msgs = prompts[1] if paged else prompts[0]
        mine = await greedy_ids(handler, msgs, 64)
        theirs = await greedy_ids(SHARED[max_seq], msgs, 64)
        out["agree"] = next((i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b),
                            min(len(mine), len(theirs)))
        out["reply_lens"] = (len(mine), len(theirs))
        out["waves"], _ = await timed_waves(handler, reqs, f"{tag}, 8 x 64 tokens",
                                            long_first=paged)
        out["first_wave"] = first_wave_line(first, out["waves"], tag)
        log(f"  after the waves: {graph_text(batcher)}")
        no_capture_check(batcher, tag)
        await release(handler)

    arun(run())
    gc.collect()
    torch.cuda.empty_cache()
    w = out["waves"]
    (panels, scales), (panels16, _) = out["bytes"], out["bytes_bf16"]
    log(f"  {tag}: TTFT p50 {median([x['ttft_ms'] for x in w]):.4f} ms"
        + (f" (long prompt {median([x['ttft_long_ms'] for x in w]):.4f} ms)" if paged else "")
        + f", TPOT p50 {median([x['tpot_ms'] for x in w]):.4f} ms, "
        f"{median([x['tokens_s'] for x in w]):.4f} tokens/s (medians of {WAVES} waves); peak "
        f"memory {out['peak'] / 2**30:.2f} GiB (the engine's own); the engine holds "
        f"{out['resident'] / 2**30:.2f} GiB; JSON replies that parse {out['parsed']}/8")
    log(f"  {tag}: the cache holds {panels / 2**30:.4f} GiB of int8 panels + "
        f"{scales / 2**30:.4f} GiB of fp32 scales = {(panels + scales) / 2**30:.4f} GiB, "
        f"against {panels16 / 2**30:.4f} GiB in bf16 (5{'b' if paged else 'a'}'s engine): "
        f"{(panels + scales) / panels16:.4f} x")
    log(f"  {tag}: one greedy reply's leading tokens equal to the bf16 cache's (recorded, not "
        f"gated; random weights): {out['agree']} of {out['reply_lens'][0]} "
        f"(bf16 reply {out['reply_lens'][1]} tokens)")
    log(f"  launches on this run: {launches_text(out['launches'])}")
    step = state.get("e2e")
    step_ok = bool(step) and step["finite"] and step["rel"] <= TOL_E2E and step["same_argmax"]
    kernel = "K3 on the int8 pools vs plain K3" if paged else "K2's int8 body vs plain K2"
    if step:
        log(f"  one decode step of the live wave (slot lengths {step['lengths']}), {kernel} "
            f"(bf16): max |diff| {step['max_diff']:.3e} over max |logit| "
            f"{step['max_logit']:.3e} = {step['rel']:.3e}, tol {TOL_E2E:g}; same argmax "
            f"{step['same_argmax']} (smallest top-2 margin {step['margin']:.3e}); finite "
            f"{step['finite']} {'ok' if step_ok else 'FAIL'}")
    else:
        log("  the wave never had all eight slots live: no decode-step check")
    launches = out["launches"]
    mine, other = ("paged", "decode") if paged else ("decode", "paged")
    if launches["flash"] <= 0 or launches[mine] <= 0 or launches[other] != 0:
        raise SystemExit(f"{tag}: the path did not go through K1 and "
                         f"{'K3' if paged else 'K2'} alone")
    if out["parsed"] != 8 or not step_ok:
        raise SystemExit(f"{tag}: the int8 decode step disagrees with the plain one, or a "
                         "reply does not parse")
    out["last"], out["table"] = state["last"], state["table"]
    out["requests"] = len(prompts)
    return out


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
                                    torch.tensor(node.path_pages, device=dev, dtype=torch.long),
                                    cfg.dtype)
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
    cold wave (it stores entries or pins pages), then ``WAVES`` timed waves
    of new tasks on the same engine with the prefix cache on (every request
    a hit, its tail prefilled through one K1 launch a layer), and the same
    waves on the shared engine, whose cache is off. Returns the hit path's
    K1 launches and shape."""
    waves = [agent_step_prompts(root, w) for w in range(1 + WAVES)]
    results = {}

    async def serve(prefix_cache):
        handler = await full_width_engine(
            torch, seed, 8192 if paged else 2048, f"5d engine_prefix_cache={prefix_cache}",
            **(dict(engine_prefix_cache=prefix_cache) if prefix_cache else {}))
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
        no_capture_check(batcher, "5d")
        await release(handler)
        return out

    for label, prefix_cache in (("cache on", 4), ("cache off", 0)):
        log(f"  -- {label} (engine_prefix_cache={prefix_cache})")
        r = results[label] = arun(serve(prefix_cache))
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
# Phase 5e: speculative decoding at full width
# --------------------------------------------------------------------- #

def spec_row0_check(torch, kernels, batcher):
    """One verify block of the batcher's live state (on its device thread,
    between two chunks: the current token and n-gram drafts from the
    history) through ``decode.spec_block_forward``, against the plain
    decode step for the same current token: row 0's logits of every live
    slot. Neither writes the cache; the launches are taken back out of the
    counts. Also returns the slots' lengths and block table (K3's verify
    timing shape)."""
    from pilottai_tpu_torch.engine import decode

    cfg, cache, dstate, dev = batcher.cfg, batcher.cache, batcher.dstate, batcher.device
    mods = (kernels["decode"], kernels["paged"])
    n0 = [m.launches for m in mods]
    B, D = batcher.n_slots, batcher.speculate
    dtype = cache.layers[0][0].dtype
    pos = cache.lengths.clone()
    if batcher.paged:
        table = torch.from_numpy(batcher.alloc.table.copy()).to(dev)
        n_blocks = max(-(-int(pos.max()) // batcher.page_size), 1)
        plain_kw = spec_kw = dict(table=table, n_blocks=n_blocks)
    else:
        plain_kw, spec_kw = {}, dict(Sb=batcher._decode_bucket(int(pos.max())))
    want = decode.decode_step_logits(
        batcher.params, cfg, cache, dstate.tokens, pos, pos - 1,
        decode.new_rings(cfg, B, batcher.chunk_size, dtype, dev), 0, **plain_kw)
    drafts = decode._ngram_drafts(batcher.history[:, :-1], pos, dstate.tokens, D - 1)
    blk = torch.cat([dstate.tokens[:, None], drafts], dim=1)
    pvec = pos[:, None] + torch.arange(D, device=dev, dtype=pos.dtype)[None, :]
    h, _ = decode.spec_block_forward(batcher.params, cfg, cache, blk, pvec, pos,
                                     torch.zeros_like(pos), decode.new_rings(cfg, B, 1, dtype, dev),
                                     **spec_kw)
    got = decode._unembed(cfg, batcher.params, h)[:, 0]
    torch.cuda.synchronize()
    for m, n in zip(mods, n0):
        m.launches = n
    out = logits_agreement(got, want, torch.nonzero(~dstate.done).flatten())
    out.update(finite=bool(torch.isfinite(got).all()), lengths=pos.tolist(),
               last=(pos - 1).tolist())
    if batcher.paged:
        out["table"] = batcher.alloc.table.tolist()
    return out


def phase_spec_waves(torch, kernels, seed, paged):
    """llama3-8b, 8 concurrent JSON requests a wave, ``engine_speculate=4``:
    the first wave served after ``start()``, a second in which the first
    dispatch with all eight slots live runs ``spec_row0_check`` (and the
    acceptance EMA that sizes the chunks settles), then ``WAVES`` timed
    waves and one request sent behind a chunk in flight; and the timed
    waves on the shared engine with speculation off. The prefix cache is
    off on both: every wave repeats the prompts. Returns the paged
    verify's K3 launches and shape."""
    reqs = [([FULL_PROMPT.format(i=i)], 64) for i in range(8)]
    results = {}

    async def serve(speculate, label):
        handler = await full_width_engine(
            torch, seed, 8192 if paged else 2048, f"5e {label}",
            **(dict(SPEC_KNOBS, engine_speculate=speculate, layers=SPEC_LAYERS)
               if speculate else {}))
        batcher = handler.backend.batcher
        if batcher.paged != paged:
            raise SystemExit("5e: the engine did not page as configured")
        state = {}
        dispatch = batcher._decode

        def watching():
            if "e2e" not in state and all(s is not None for s in batcher._slots):
                state["e2e"] = spec_row0_check(torch, kernels, batcher)
            dispatch()

        torch.cuda.reset_peak_memory_stats()
        first = None
        if speculate:
            first, _ = await timed_waves(handler, reqs, f"{label}, the first wave served",
                                         n_waves=1)
            batcher._decode = watching
            await timed_waves(handler, reqs, f"{label}, the row-0 check", n_waves=1)
            await settle(batcher)
            batcher._decode = dispatch
        rep0, blocks0 = batcher.spec_report(), batcher.blocks_dispatched
        reset(kernels)
        waves, _ = await timed_waves(handler, reqs, label)
        await settle(batcher)
        out = dict(waves=waves, launches=counts(kernels),
                   blocks=batcher.blocks_dispatched - blocks0, graphs=graph_text(batcher),
                   peak=own_peak(torch, handler), model=handler.backend.model_cfg,
                   e2e=state.get("e2e"), num_pages=getattr(batcher, "num_pages", None),
                   P=batcher.page_size)
        if speculate:
            rep = batcher.spec_report()
            out["tokens_per_block"] = ((rep["tokens"] - rep0["tokens"])
                                       / max(rep["blocks"] - rep0["blocks"], 1))
            spec_launch_check(out["launches"], batcher, out["blocks"], 0, f"5e {label}")
            out["first_wave"] = first_wave_line(first, waves, f"5e {label}")
            out["behind_chunk_ms"] = await ttft_behind_chunk(handler, reqs, f"5e {label}")
        else:
            per_step_check(out["launches"], batcher, out["blocks"], f"5e {label}")
        no_capture_check(batcher, f"5e {label}")
        await release(handler)
        return out

    for label, speculate in (("speculation on", 4), ("speculation off", 0)):
        log(f"  -- {label} (engine_speculate={speculate})")
        r = results[label] = arun(serve(speculate, label))
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {r['graphs']}; peak memory {r['peak'] / 2**30:.2f} GiB (the engine's own)")
    on, off = results["speculation on"], results["speculation off"]
    depth = (f" (on at {on['model'].n_layers} layers, off at {off['model'].n_layers}: not a "
             "like-for-like ratio)" if on["model"].n_layers != off["model"].n_layers else "")
    for key in ("ttft_ms", "tpot_ms", "tokens_s"):
        a = median([wv[key] for wv in on["waves"]])
        b = median([wv[key] for wv in off["waves"]])
        log(f"  {key} median over {WAVES} waves: speculation on {a:.4f}, off {b:.4f} "
            f"({a / b:.3f} of off){depth}")
    reply = median([wv["tokens_a_reply"] for wv in on["waves"]])
    spec_ok = on["tokens_per_block"] > 1.0 and reply >= SPEC_MIN_REPLY_SHARE * 64
    log(f"  tokens per block over the timed waves: {on['tokens_per_block']:.3f} (D 4; more than "
        f"1 required); {on['blocks']} blocks dispatched against {off['blocks']} plain steps; "
        f"tokens a reply, median over the waves {reply:.2f} of 64 (at least "
        f"{SPEC_MIN_REPLY_SHARE * 64:g} required) {'ok' if spec_ok else 'FAIL'}")
    if not spec_ok:
        raise SystemExit("5e: the workload does not exercise speculation (no draft accepted, "
                         "or replies far short of their budget)")
    e2e = on["e2e"]
    e2e_ok = bool(e2e) and e2e["finite"] and e2e["rel"] <= TOL_E2E and e2e["same_argmax"]
    if e2e:
        log(f"  one verify block of the live wave (slot lengths {e2e['lengths']}), row 0 vs the "
            f"plain decode step for the same token (bf16): max |diff| {e2e['max_diff']:.3e} "
            f"over max |logit| {e2e['max_logit']:.3e} = {e2e['rel']:.3e}, tol {TOL_E2E:g}; "
            f"same argmax {e2e['same_argmax']} (smallest top-2 margin {e2e['margin']:.3e}); "
            f"finite {e2e['finite']} {'ok' if e2e_ok else 'FAIL'}")
    else:
        log("  the cold wave never had all eight slots live: no row-0 check")
    if not e2e_ok:
        raise SystemExit("5e: a verify block's row-0 logits disagree with the plain step's")
    if not paged:
        return None
    return on["launches"]["paged"], dict(
        last=e2e["last"], table=e2e["table"], num_pages=on["num_pages"], P=on["P"], D=4,
        model=on["model"], blocks=on["blocks"])


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
            "decode": 0, "paged": 0, "qmatmul": 0, "qmatmul_dequant": 0, "qmatmul_shapes": {},
            "int8_matmul": 0, "int8_quant": 0, "int8_shapes": {}}
    log(f"  launches on this run ({steps} steps x {layers} layers): {launches_text(launches)}; "
        f"expected flash_fwd {want['flash']}, flash_bwd_dq {want['bwd_dq']}, flash_bwd_dkv "
        f"{want['bwd_dkv']}, the serving kernels 0")
    if launches != want:
        raise SystemExit(f"the {label} training path did not launch K1, K4 and K5 as expected")


def golden_train_state(torch, root, golden):
    """The Trainer and its state for a golden training file: protocol-s
    from its shipped checkpoint, or the model of the file's ``config``
    from its ``checkpoint`` times ``init_scale`` (the Gemma files,
    ``scripts/export_gemma_train_golden.py``), in fp32."""
    from pilottai_tpu_torch.models.common import ModelConfig
    from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ, load_npz
    from pilottai_tpu_torch.models.registry import get_model_config
    from pilottai_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = (ModelConfig(**golden["config"]) if "config" in golden
           else get_model_config(golden["model"])).replace(dtype=torch.float32)
    npz = (root / "pilottai_tpu_torch" / "assets" / golden["checkpoint"] if "checkpoint" in golden
           else PROTOCOL_S_NPZ)
    trainer = Trainer(cfg, TrainConfig(**golden["train_config"]))
    params = load_npz(npz, cfg, dtype=torch.float32, scale=golden.get("init_scale"))
    return trainer, trainer.init_from_params(params)


def phase_train_golden(torch, kernels, root, asset="protocol_s_train_golden.json"):
    """Four fp32 steps of the port's Trainer from a golden file's weights
    (the shipped protocol-s checkpoint; 7c: a head_dim 256 Gemma test
    model's), held to the JAX trainer's losses and grad norms."""
    import numpy as np

    from pilottai_tpu_torch.train.protocol import protocol_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = json.loads((root / "pilottai_tpu_torch" / "assets" / asset).read_text())
    trainer, state = golden_train_state(torch, root, golden)
    cfg = trainer.model_cfg
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
    expect_train_launches(launches, cfg.n_layers, len(batches), golden["model"])
    if not ok:
        raise SystemExit(f"the golden {golden['model']} training steps differ from the JAX "
                         "trainer's")
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


def train_grads(trainer, state, batch, host=False):
    """Every master leaf's gradient of one loss at the state's parameters
    (no update); with ``host``, copied to the host's memory, so that the
    next run's gradients do not share the card with them."""
    from pilottai_tpu_torch.train.trainer import param_leaves

    trainer.loss_and_grads(state, batch)
    leaves = param_leaves(state.params)
    grads = [p.grad.to("cpu") if host else p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return grads


def phase_train_full(torch, kernels, seed, model="llama3-1b", B=4, T=2048):
    """A model at its published widths (7b llama3-1b, B 4; 7d gemma2-2b, B
    2), bf16 compute over fp32 master weights, remat on: 8 steps on one
    fixed batch of B x T, then a profiled step and the gradient check
    against the plain kernels (the kernels' gradients held on the host
    meanwhile)."""
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
    got = train_grads(trainer, state, batch, host=True)
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
        g = g.to(w.device)
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
    avg = device_rows(prof)
    rows = [(dev, count) for dev, key, count in avg if name in key]
    ms = sum(d for d, _ in rows) / sum(c for _, c in rows) / 1e3 if rows else None
    # The raw events' rows (5c's tables) against these, row by row.
    raw = {key: (dev, count) for dev, key, count in raw_device_rows(prof)}
    avg = {key: (dev, count) for dev, key, count in avg}
    same = raw.keys() == avg.keys() and all(
        raw[k][1] == avg[k][1] and math.isclose(raw[k][0], avg[k][0], rel_tol=1e-9) for k in raw)
    rows = [v for key, v in raw.items() if name in key]
    ms_raw = sum(d for d, _ in rows) / sum(c for _, c in rows) / 1e3 if rows else None
    log(f"  {name}: profiled ms a launch {ms} (key_averages), {ms_raw} (the raw events' rows); "
        f"all {len(avg)} device rows equal in both: {same}")
    return ms


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


def time_decode_int8(torch, da, device, timer, gen, shape, worst):
    """Time K2's int8 body (bf16 q, an int8 panel and its fp32 scales) at
    5g's dense decode step, beside K2's bf16 body at the same shape and
    SDPA over the panel dequantized to bf16 beforehand (the dequantization
    not counted). Returns its entry of the kernels line."""
    import torch.nn.functional as F

    from pilottai_tpu_torch.ops.kvcache import dequantize_kv, quantize_kv

    cfg, last = shape["model"], shape["last"]
    N, K, H = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G, B, S = N // K, len(last), shape["S"]
    q = randn(torch, gen, (B, N, H), torch.bfloat16, device)
    kf = randn(torch, gen, (B, K, S, H), torch.bfloat16, device)
    vf = randn(torch, gen, (B, K, S, H), torch.bfloat16, device)
    (kc, ks), (vc, vs) = quantize_kv(kf), quantize_kv(vf)
    lst = torch.tensor(last, device=device, dtype=torch.int32)
    kw = dict(return_stats=True, k_scales=ks, v_scales=vs)
    ms = timer.ms(lambda: da.decode_attention(q, kc, vc, lst, lst, **kw))
    warm = timer.ms(lambda: da.decode_attention(q, kc, vc, lst, lst, **kw), flush=False)
    profiled = profiled_launch_ms(torch, lambda: da.decode_attention(q, kc, vc, lst, lst, **kw),
                                  "decode_split")
    plain = timer.ms(lambda: da.decode_attention_plain(q, kc, vc, lst, lst, H**-0.5,
                                                       k_scales=ks, v_scales=vs))
    bf16 = timer.ms(lambda: da.decode_attention(q, kf, vf, lst, lst, return_stats=True))
    kd, vd = dequantize_kv(kc, ks, torch.bfloat16), dequantize_kv(vc, vs, torch.bfloat16)
    kde, vde = kd.repeat_interleave(G, dim=1), vd.repeat_interleave(G, dim=1)
    dmask = (torch.arange(S, device=device)[None, :] <= lst[:, None])[:, None, None, :]
    lib = timer.ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kde, vde,
                                                          attn_mask=dmask))
    keys = sum(n + 1 for n in last if n >= 0)
    flops = 4 * H * N * keys
    # The int8 keys and values, their fp32 scales, q, acc, m and l.
    nbytes = 2 * keys * K * H + 2 * 4 * keys * K + 2 * B * N * H + 4 * B * N * H + 2 * 4 * B * N
    e = entry("decode_attention_int8", da, shape["launches"], worst[("decode_int8", "bfloat16")],
              ms, plain, lib, flops, nbytes, "bfloat16", tol_text("bfloat16", False),
              warm_ms=warm, profiled_ms=profiled, bf16_cache_ms=bf16,
              library_note="SDPA over the panel dequantized to bf16 beforehand (not counted)",
              splits=da.split_count(B, K, S, torch.cuda.get_device_properties(device)
                                    .multi_processor_count))
    log(f"  K2 decode    int8 cache, bf16 q [{B},{N},{H}] S {S} last {last}, {e['splits']} "
        f"splits: kernel {ms:.4f} ms (L2 warm {warm:.4f} ms, profiled "
        f"{'not measured' if profiled is None else f'{profiled:.4f} ms'} a launch), K2 bf16 "
        f"at the same shape {bf16:.4f} ms, plain {plain:.4f} ms, SDPA on the dequantized panel "
        f"{lib:.4f} ms (dequantization not counted), bound {e['bound_ms']:.5f} ms "
        f"({e['bound_by']}: {nbytes / 1e6:.2f} MB)")
    return e


def time_paged(torch, pa, device, timer, gen, dtype, shape, launched, worst, suffix="",
               quantized=False, **extra):
    """Time K3 (kernel, plain version, SDPA over panels gathered beforehand)
    at one paged path's decode step: its slots' lengths and block table, a
    pool of its size, the ring ``step`` rows into a chunk. ``quantized``:
    int8 pools with their fp32 scale pools (SDPA then reads pools
    dequantized to ``dtype`` beforehand, the dequantization not counted).
    Returns its entry of the kernels line."""
    import torch.nn.functional as F

    from pilottai_tpu_torch.ops.kvcache import dequantize_kv, quantize_kv
    from pilottai_tpu_torch.ops.paged import gather_pages

    dn = str(dtype)[6:]
    esz = torch.finfo(dtype).bits // 8
    kv_esz = 1 if quantized else esz
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
    k_lib, v_lib = k_pool, v_pool
    if quantized:
        (k_pool, ks), (v_pool, vs) = quantize_kv(k_pool), quantize_kv(v_pool)
        kw.update(k_scales=ks, v_scales=vs)
        k_lib, v_lib = dequantize_kv(k_pool, ks, dtype), dequantize_kv(v_pool, vs, dtype)
    k3 = timer.ms(lambda: pa.paged_decode_attention(q, k_pool, v_pool, table, lst, **kw))
    k3_warm = timer.ms(lambda: pa.paged_decode_attention(q, k_pool, v_pool, table, lst, **kw),
                       flush=False)
    k3_plain = timer.ms(lambda: pa.paged_decode_attention_plain(q, k_pool, v_pool, table, lst,
                                                                **kw))

    def gather():
        kg = torch.cat([gather_pages(k_lib, table, n_blocks), rk], dim=2)
        vg = torch.cat([gather_pages(v_lib, table, n_blocks), rv], dim=2)
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
    nbytes = (2 * kv_esz * keys * K * H + 2 * esz * ring_rows * K * H + esz * B * N * H
              + 4 * B * n_blocks + 2 * 4 * B + 4 * B * N * H + 2 * 4 * B * N
              + (2 * 4 * keys * K if quantized else 0))
    worst_err = worst[("paged", "float32" if quantized else dn)]
    tol = tol_text("float32" if quantized else dn, False)
    e = entry("paged_attention" + suffix, pa, launched, worst_err, k3, k3_plain,
              k3_lib, flops, nbytes, dn, tol, gather_ms=gather_ms,
              warm_ms=k3_warm, launches_per_request=launched / shape["requests"], **extra)
    if quantized:
        e["library_note"] = ("SDPA over pools dequantized to bf16 beforehand (not counted), "
                             "plus the gather")
    log(f"  K3 paged     {dn:<8}{' int8 pools' if quantized else ''} q [{B},{N},{H}] P {P} "
        f"pool {num_pages} pages, last {last}, "
        f"ring {R} at step {step}: kernel {k3:.4f} ms (L2 warm {k3_warm:.4f} ms), plain "
        f"{k3_plain:.4f} ms, SDPA "
        f"{k3_lib:.4f} ms (+ gather {gather_ms:.4f} ms), bound {e['bound_ms']:.5f} ms "
        f"({e['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return e


# Each matrix shape's matrices a layer: wq and wo, wk and wv, wg and wu, wd.
MATRIX_NAMES = {0: "wq, wo", 1: "wk, wv", 2: "wg, wu", 3: "wd"}
MATRIX_COUNT = {0: 2, 1: 2, 2: 2, 3: 1}


def library_qmatmul(torch, x, qw, bits, group):
    """The one PyTorch call that computes ``x @ dequant(w)``, where there is
    one, on operands prepared once from the same weight:
    ``torch._weight_int4pack_mm`` (tinygemm: unsigned nibbles, a scale and
    a zero a group along K, each weight ``(u - 8) * scale + zero``, so a
    zero of 0 with ``u = q + 8`` gives the port's ``q * s``) and
    ``torch._weight_int8pack_mm`` (int8 ``[N, K]``, one scale a column,
    applied after the sum). Timed here only: the port calls neither.
    Returns ``(call, None)``, or ``(None, the error)`` where the call is
    missing or refuses the operands."""
    from pilottai_tpu_torch.models.quant import unpack_int4

    try:
        if bits == 4:
            u = unpack_int4(qw.q, qw.in_dim).t().to(torch.int32) + 8       # [N, K] in [0, 15]
            packed = (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8).contiguous()
            w4 = torch._convert_weight_to_int4pack(packed, 8)
            sz = torch.stack([qw.s, torch.zeros_like(qw.s)], dim=-1).contiguous()

            def call():
                return torch._weight_int4pack_mm(x, w4, group, sz)
        else:
            w8, s8 = qw.q.t().contiguous(), qw.s.reshape(-1).contiguous()

            def call():
                return torch._weight_int8pack_mm(x, w8, s8)
        call()
        torch.cuda.synchronize()
        return call, None
    except (AttributeError, NotImplementedError, RuntimeError, TypeError) as exc:
        return None, f"{type(exc).__name__}: {str(exc).strip().splitlines()[0][:240]}"


# The library call computes the same function if it agrees with the plain
# version to this share of max |ref|: it rounds differently (the int8 call
# scales after the sum), but a wrong layout of its operands is off by O(1).
LIBRARY_SAME = 2.0**-5


def time_qmatmul_shape(torch, qk, device, timer, gen, dtype, K, N, M, bits, group, launched,
                       err, name, shape_text):
    """One kernels-line entry of the quantized product at one shape: the
    kernel (fused, or dequant then matmul past 64 rows), its plain version,
    the library call that computes the same product where PyTorch has one
    (``library_qmatmul``: its time, or the error it raised), and
    ``torch.matmul`` on a dense weight of the same shape in ``dtype``, the
    speed quantization has to beat."""
    from pilottai_tpu_torch.models.quant import dequant, quantize_array

    dn = str(dtype)[6:]
    esz = torch.finfo(dtype).bits // 8
    w = torch.randn((K, N), generator=gen, device=device, dtype=torch.float32) * K**-0.5
    qw = quantize_array(w, dtype, bits=bits, group=group)
    dense = dequant(qw).contiguous()
    del w
    x = randn(torch, gen, (M, K), dtype, device)
    ms = timer.ms(lambda: qk.quant_matmul(x, qw))
    plain = timer.ms(lambda: qk.qmatmul_plain(x, qw))
    dense_ms = timer.ms(lambda: torch.matmul(x, dense))
    lib_name = "torch._weight_int4pack_mm" if bits == 4 else "torch._weight_int8pack_mm"
    call, why = library_qmatmul(torch, x, qw, bits, group)
    lib_ms = lib_err = None
    if call is not None:
        want = qk.qmatmul_plain(x, qw).float()
        lib_err = ((call().float() - want).abs().max() / want.abs().max()).item()
        if lib_err <= LIBRARY_SAME:
            lib_ms = timer.ms(call)
            library = f"{lib_name}, {lib_err:.2e} of max|ref| from the plain version"
        else:
            library = (f"none: {lib_name} disagrees with the plain version by {lib_err:.2e} "
                       f"of max|ref| (limit {LIBRARY_SAME:g})")
    else:
        library = f"none: {lib_name} raised {why}"
    q_bytes = qw.q.numel() + qw.s.numel() * esz
    nbytes = q_bytes + M * K * esz + M * N * esz
    fused = M <= qk.FUSED_MAX_ROWS
    plan = qk.plan_for(M, K, N, bits, group, dtype, device) if fused else None
    regs, per_sm = qk.kernel_info(dtype, bits, M, K, group, device) if fused else (None, None)
    e = entry(name, qk, launched, err, ms, plain, lib_ms, 2 * M * K * N, nbytes, dn,
              f"{TOL_QMM[dn]['out']:g} of max|ref|"
              + (" beyond 2^-7|ref|" if TOL_QMM[dn]["rel"] else ""),
              replaces=QMM_REPLACES, library=library, library_err=lib_err,
              dense_matmul_ms=dense_ms, weight_bytes=q_bytes, dense_weight_bytes=K * N * esz,
              shape=shape_text, rows=M, quant=quant_name(bits, group),
              path=f"fused, {plan.body} body" if fused else "dequant + torch.matmul",
              splits=plan.splits if fused else 1, registers=regs, blocks_per_sm=per_sm)
    lib_text = f"{lib_name} {lib_ms:.4f} ms" if lib_ms is not None else library
    body = (f"{e['splits']} splits of {plan.per}, {regs} registers, {per_sm} blocks an SM"
            if fused else "1 split")
    log(f"  qmatmul {quant_name(bits, group):<8} {dn:<8} {shape_text:<34} M {M:>4} "
        f"({e['path']}, {body}): kernel {ms:.4f} ms, bound {e['bound_ms']:.5f} ms "
        f"({e['bound_by']}, {q_bytes / 1e6:.2f} MB of weights), plain {plain:.4f} ms; "
        f"library: {lib_text}; torch.matmul on the {dn} weight {dense_ms:.4f} ms; launches "
        f"{launched} (counted at this shape)")
    return e


def time_qmatmul(torch, qk, device, timer, gen, worst, paths):
    """The quantized product at the shapes its paths gave it, each with
    the launches the wrapper counted at that shape on the path: 5f's
    decode step (8 rows) at llama3-8b's four matrix shapes and its
    admission's prefill (the rows it launched most at wg's shape), int8
    and int4; 4e's protocol-s shapes in fp32 (4 rows a decode step, 16 a
    verify block of 4)."""
    out = []
    for mode, (bits, group) in (("int8", (8, 128)), ("int4", (4, 128))):
        f = paths[f"quant_{mode}"]
        shapes, B = f["launches"]["qmatmul_shapes"], f["model_slots"]
        for i, (K, N) in enumerate(LLAMA_MATRICES):
            out.append(time_qmatmul_shape(
                torch, qk, device, timer, gen, torch.bfloat16, K, N, B, bits, group,
                shapes.get(("fused", B, K, N), 0), worst["bfloat16"], f"qmatmul_{mode}_{i}",
                f"5f decode, {MATRIX_NAMES[i]} [{K}x{N}]"))
        rows, n = max(((k[1], n) for k, n in shapes.items()
                       if k[0] == "dequant" and k[2:] == (4096, 14336)), key=lambda r: r[1])
        out.append(time_qmatmul_shape(
            torch, qk, device, timer, gen, torch.bfloat16, 4096, 14336, rows, bits, group,
            n, worst["bfloat16"], f"qmatmul_{mode}_prefill",
            f"5f prefill, wg, wu [4096x14336]"))
    for key, (bits, group), M in (("quant_golden_int8", (8, 128), 4),
                                  ("quant_golden_int4_paged", (4, 96), 4),
                                  ("quant_golden_int4_spec", (4, 128), 16)):
        launches, _ = paths[key]
        for i, (K, N) in enumerate(PROTOCOL_S_MATRICES):
            out.append(time_qmatmul_shape(
                torch, qk, device, timer, gen, torch.float32, K, N, M, bits, group,
                launches["qmatmul_shapes"].get(("fused", M, K, N), 0), worst["float32"],
                f"qmatmul_{key[13:]}_{i}_fp32",
                f"4e {key[13:]}, {MATRIX_NAMES[i]} [{K}x{N}]"))
    return out


NATIVE_REPLACES = ("pilottai_tpu/models/qmatmul.py:87 (_native_int8_matmul; no pallas_call: "
                   "XLA's int8 dot_general into int32, a grouped one for int4)")
QUANT_ROWS_REPLACES = ("pilottai_tpu/models/qmatmul.py:77 (_quantize_activation; no "
                       "pallas_call: XLA fuses the per-row amax, divide, round and clip)")
NATIVE_ROWS = (8, 32, 2048)


def time_native_shape(torch, i8, qk, device, timer, gen, K, N, M, bits, group, launched, err,
                      name, shape_text):
    """One kernels-line entry of the integer arm's product at one shape
    (bf16 activations, llama3-8b's weights): the product launch alone on a
    quantized workspace, ``native_matmul_plain``, ``torch._int_mm`` on the
    same int8 operands (the int4 weight unpacked to int8; the int32 sums
    only, timed here and never called by the port; it takes more than 16
    rows), and the dequant arm's kernel on the same weight and input."""
    from pilottai_tpu_torch.models.quant import quantize_array, unpack_int4

    w = torch.randn((K, N), generator=gen, device=device, dtype=torch.float32) * K**-0.5
    qw = quantize_array(w, torch.bfloat16, bits=bits, group=group)
    del w
    x = randn(torch, gen, (M, K), torch.bfloat16, device)
    plan = i8.launch_plan(M, K, N, bits, group)
    xq, sx = i8.quantize_rows(x, plan)
    out = torch.empty((M, N), device=device, dtype=torch.bfloat16)
    ms = timer.ms(lambda: i8.product(xq, sx, qw, plan, out))
    plain = timer.ms(lambda: i8.native_matmul_plain(x, qw), iters=3, warmup=1)
    dequant_arm = timer.ms(lambda: qk.quant_matmul(x, qw))
    lib_ms, library = None, "none: torch._int_mm takes more than 16 rows"
    if M > 16:
        a = xq[:M, :K].contiguous()
        b = (qw.q if bits == 8 else unpack_int4(qw.q, K)).contiguous()
        try:
            want = (a.double() @ b.double()).to(torch.int32)
            if torch.equal(torch._int_mm(a, b), want):
                lib_ms = timer.ms(lambda: torch._int_mm(a, b))
                library = "torch._int_mm (int32 sums only, no scales)"
            else:
                library = "none: torch._int_mm disagrees with the exact int32 sums"
        except (AttributeError, NotImplementedError, RuntimeError) as exc:
            library = f"none: torch._int_mm raised {type(exc).__name__}: {str(exc)[:160]}"
    # What the timed launch moves: the weight and its scales, the quantized
    # workspace (int8 rows padded to the plan's, their fp32 scales) and
    # the result.
    q_bytes = qw.q.numel() + qw.s.numel() * qw.s.element_size()
    nbytes = q_bytes + plan.rows * plan.kx + 4 * plan.rows + M * N * out.element_size()
    e = entry(name, i8, launched, err, ms, plain, lib_ms, 2 * M * K * N, nbytes, "int8",
              "bit for bit (fp32); the one rounding to bf16", replaces=NATIVE_REPLACES,
              library=library, dequant_arm_ms=dequant_arm,
              dequant_arm_path="fused" if M <= qk.FUSED_MAX_ROWS else "dequant + torch.matmul",
              weight_bytes=q_bytes, shape=shape_text, rows=M, quant=quant_name(bits, group),
              m16_tiles_a_warp=plan.mt, warps_a_block=plan.warps, grid=list(plan.grid),
              groups=plan.n_groups,
              sum_mode=plan.mode)
    log(f"  int8_matmul {quant_name(bits, group):<8} {shape_text:<30} M {M:>4} (grid "
        f"{plan.grid}, {plan.mt} m16 tiles a warp): kernel {ms:.4f} ms, bound "
        f"{e['bound_ms']:.5f} ms ({e['bound_by']}), plain {plain:.4f} ms; library: "
        f"{f'torch._int_mm {lib_ms:.4f} ms' if lib_ms is not None else library}; the dequant "
        f"arm ({e['dequant_arm_path']}) {dequant_arm:.4f} ms; launches {launched}")
    return e


def time_native(torch, i8, qk, device, timer, gen, worst, paths):
    """The integer arm at 5h's shapes: the product at llama3-8b's wq, wk,
    wg and wd, 8, 32 and 2048 rows, int8 and int4 at group 128, each with
    the launches counted at that shape in 5h's wave (0 where the wave
    launched none: 32 rows are a verify block's); the row quantizer at K
    4096 and 14336 and the same rows, with the launches of the products
    that read it."""
    out = []
    for mode, (bits, group) in (("int8", (8, 128)), ("int4", (4, 128))):
        shapes = paths[f"native_{mode}"]["launches"]["int8_shapes"]
        for i, (K, N) in enumerate(LLAMA_MATRICES):
            for M in NATIVE_ROWS:
                out.append(time_native_shape(
                    torch, i8, qk, device, timer, gen, K, N, M, bits, group,
                    shapes.get((M, K, N), 0), worst, f"int8_matmul_{mode}_{i}_m{M}",
                    f"5h, {MATRIX_NAMES[i]} [{K}x{N}]"))
    shapes = paths["native_int8"]["launches"]["int8_shapes"]
    for K in (4096, 14336):
        for M in NATIVE_ROWS:
            x = randn(torch, gen, (M, K), torch.bfloat16, device)
            plan = i8.launch_plan(M, K, 4096, 8, 128)
            ms = timer.ms(lambda: i8.quantize_rows(x, plan))
            plain = timer.ms(lambda: i8.quantize_rows_plain(x))
            launched = sum(n for (m, k, _), n in shapes.items() if (m, k) == (M, K))
            e = entry(f"int8_row_quantizer_k{K}_m{M}", i8, launched, 0.0, ms, plain, None,
                      0, M * K * 2 + M * K + 4 * M, "int8", "byte for byte",
                      replaces=QUANT_ROWS_REPLACES, library="none: no one PyTorch call",
                      shape=f"5h, x [{M}x{K}] bf16", rows=M)
            log(f"  int8 row quantizer x [{M}x{K}] bf16: kernel {ms:.4f} ms, bound "
                f"{e['bound_ms']:.5f} ms (bytes), plain {plain:.4f} ms; launches {launched} "
                "(5h's int8 wave, the products reading it)")
            out.append(e)
    return out


def time_paged_verify(torch, pa, device, timer, gen, dtype, shape, launched, worst):
    """Time K3 at the speculative verify's shape (kernel, plain version,
    SDPA over panels gathered beforehand): 5e's paged slots and block
    table, q ``[B, N·D, H]`` with ``q_blocks`` D and no ring. Returns its
    entry of the kernels line."""
    import torch.nn.functional as F

    from pilottai_tpu_torch.ops.paged import gather_pages

    dn = str(dtype)[6:]
    esz = torch.finfo(dtype).bits // 8
    cfg, D = shape["model"], shape["D"]
    N, K, H = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = N // K
    P, num_pages, last = shape["P"], shape["num_pages"], shape["last"]
    B = len(last)
    sentinel = num_pages - 1
    table = torch.tensor([[p if p >= 0 else sentinel for p in row] for row in shape["table"]],
                         device=device, dtype=torch.int32)
    n_blocks = max(-(-(max(last) + 1) // P), 1)
    k_pool = randn(torch, gen, (K, num_pages, P, H), dtype, device)
    v_pool = randn(torch, gen, (K, num_pages, P, H), dtype, device)
    q = randn(torch, gen, (B, N * D, H), dtype, device)
    lst = torch.tensor(last, device=device, dtype=torch.int32)
    kw = dict(q_positions=lst + 1, n_blocks=n_blocks, scale=H**-0.5, q_blocks=D)
    k3 = timer.ms(lambda: pa.paged_decode_attention(q, k_pool, v_pool, table, lst, **kw))
    k3_warm = timer.ms(lambda: pa.paged_decode_attention(q, k_pool, v_pool, table, lst, **kw),
                       flush=False)
    k3_plain = timer.ms(lambda: pa.paged_decode_attention_plain(q, k_pool, v_pool, table, lst,
                                                                **kw))

    def gather():
        return (gather_pages(k_pool, table, n_blocks).repeat_interleave(G, dim=1),
                gather_pages(v_pool, table, n_blocks).repeat_interleave(G, dim=1))

    gather_ms = timer.ms(gather)
    kg, vg = gather()
    col = torch.arange(n_blocks * P, device=device)
    live = (table[:, :n_blocks] != sentinel).repeat_interleave(P, dim=1)
    mask = ((col[None, :] <= lst[:, None]) & live)[:, None, None, :]
    qv = q.reshape(B, N, D, H)             # rows (kv head, query head, d) = (head, d)
    k3_lib = timer.ms(lambda: F.scaled_dot_product_attention(qv, kg, vg, attn_mask=mask))
    keys = sum(n + 1 for n in last if n >= 0)
    flops = 4 * H * N * D * keys
    nbytes = (2 * esz * keys * K * H + esz * B * N * D * H + 4 * B * n_blocks + 2 * 4 * B
              + 4 * B * N * D * H + 2 * 4 * B * N * D)
    blocks = shape["blocks"]
    e = entry("paged_attention_verify", pa, launched, worst[("paged", dn)], k3, k3_plain, k3_lib,
              flops, nbytes, dn, tol_text(dn, False), gather_ms=gather_ms, warm_ms=k3_warm,
              q_blocks=D, launches_per_block=launched / max(blocks, 1))
    log(f"  K3 verify    {dn:<8} q [{B},{N}x{D},{H}] q_blocks {D} P {P} pool {num_pages} pages, "
        f"last {last}: kernel {k3:.4f} ms (L2 warm {k3_warm:.4f} ms), plain {k3_plain:.4f} ms, "
        f"SDPA {k3_lib:.4f} ms (+ gather {gather_ms:.4f} ms), bound {e['bound_ms']:.5f} ms "
        f"({e['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
        f"{launched} launches over {blocks} blocks in 5e")
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


def worst_h256(worst):
    """Phase 3's head_dim 256 errors under the keys of the other head dims'
    (``("flash_h256", dtype)`` as ``("flash", dtype)``)."""
    return {(key[0][:-len("_h256")], key[1]): err for key, err in worst.items()
            if isinstance(key, tuple) and key[0].endswith("_h256")}


def time_gemma(torch, fa, da, pa, device, timer, gen, worst, paths):
    """The head_dim 256 bodies, each at the shapes its own run gave it: K1
    and K2 bf16 at gemma-2b's dense wave and K3 bf16 at gemma2-2b's paged
    wave, K1 at its widest segment (5i); K1, K2 and K3 fp32 at the
    gemma2-tiny-h256 golden requests (4h); K1, K4 and K5 bf16 at gemma2-2b's
    training step (7d) and fp32 at the gemma2-tiny-h256 golden training
    steps (7c). Their errors are phase 3's head_dim 256 cases'."""
    w256 = worst_h256(worst)
    d_launches, d = paths["gemma_dense"]
    lens = d["prompt_lens"]
    T = 64
    while T < max(lens):
        T *= 2
    out = time_kernels(torch, fa, da, device, timer, gen, torch.bfloat16, d["model"],
                       flash=dict(B=len(lens), T=T, lens=lens),
                       decode=dict(B=len(d["last"]), S=2048, last=d["last"]),
                       launches=d_launches, worst=w256, suffix="_h256")
    p_launches, p = paths["gemma_paged"]
    out[0]["launches_paged"] = p_launches["flash"]
    out.append(time_paged(torch, pa, device, timer, gen, torch.bfloat16, p,
                          p_launches["paged"], w256, suffix="_h256"))
    out.append(time_tail(torch, fa, device, timer, gen, p["segment"], w256,
                         "flash_fwd_segment_h256"))
    g_launches, g = paths["gemma_golden"]
    fp32 = time_kernels(torch, fa, da, device, timer, gen, torch.float32, g["model"],
                        flash=g["flash"], decode=g["decode"], launches=g_launches, worst=w256,
                        suffix="_h256_fp32")
    gp_launches, gp = paths["gemma_golden_paged"]
    fp32[0]["launches_paged"] = gp_launches["flash"]
    fp32.append(time_paged(torch, pa, device, timer, gen, torch.float32,
                           dict(gp["paged"], model=gp["model"], requests=gp["requests"]),
                           gp_launches["paged"], w256, suffix="_h256_fp32"))
    t_launches, t_shape = paths["train_gemma"]
    out += time_train_kernels(torch, fa, device, timer, gen, torch.bfloat16, t_shape,
                              t_launches, w256, suffix="_h256")
    g_launches, g_shape = paths["train_golden_gemma2_tiny_h256"]
    train_fp32 = time_train_kernels(torch, fa, device, timer, gen, torch.float32, g_shape,
                                    g_launches, w256, suffix="_h256_fp32")
    # 7c's gemma-tiny-h256 steps launched the same kernels at G 4.
    other = paths["train_golden_gemma_tiny_h256"][0]
    for e, key in zip(train_fp32, ("flash", "bwd_dq", "bwd_dkv")):
        e["launches_gemma_tiny_h256"] = other[key]
    return out + fp32 + train_fp32


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
    v_launches, v_shape = paths["spec_paged"]
    out.append(time_paged_verify(torch, pa, device, timer, gen, torch.bfloat16, v_shape,
                                 v_launches, worst))
    # The int8 KV cache at 5g's shapes: K2's int8 body, K3 on int8 pools.
    kv8 = paths["kv8"]
    out.append(time_decode_int8(torch, da, device, timer, gen,
                                dict(model=kv8["model"], last=kv8["last"], S=2048,
                                     launches=kv8["launches"]["decode"]), worst))
    kv8p = paths["kv8_paged"]
    out.append(time_paged(torch, pa, device, timer, gen, torch.bfloat16,
                          dict(kv8p, step=kv8p["R"] // 2), kv8p["launches"]["paged"], worst,
                          suffix="_int8", quantized=True))
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
    # K2 in 4d's model drafts (one row a slot over the dense panel, the shape
    # of the golden decode step timed above): the same times, its launches.
    draft = dict(fp32[1], name="decode_attention_draft_fp32",
                 launches=paths["golden_drafts"][0]["decode"],
                 shape="4d's model drafts: the golden decode step's")
    log(f"  K2 in 4d's model drafts: {draft['launches']} launches at the golden step's shape "
        f"({draft['ms']:.4f} ms)")
    fp32.append(draft)
    t_launches, t_shape = paths["train_full"]
    out += time_train_kernels(torch, fa, device, timer, gen, torch.bfloat16, t_shape,
                              t_launches, worst)
    g_launches, g_shape = paths["train_golden"]
    fp32 += time_train_kernels(torch, fa, device, timer, gen, torch.float32, g_shape,
                               g_launches, worst, suffix="_fp32")
    for e in fp32:
        if e["name"].startswith("flash_"):
            e["library_kernels"] = yard["backward" if "bwd" in e["name"] else "forward"]
    log("  -- head_dim 256 (Gemma): K1, K2 and K3 at 5i's shapes (bf16) and 4h's (fp32); K1, K4 "
        "and K5 at 7d's (bf16) and 7c's (fp32)")
    gemma = time_gemma(torch, fa, da, pa, device, timer, gen, worst, paths)
    log("  -- the quantized product (csrc/qmatmul.cu), no pallas_call counterpart")
    qmm = time_qmatmul(torch, kernels["qmatmul"], device, timer, gen, worst["qmatmul"], paths)
    log("  -- the integer arm (csrc/int8_matmul.cu), no pallas_call counterpart")
    native = time_native(torch, kernels["int8_matmul"], kernels["qmatmul"], device, timer, gen,
                         worst["int8_matmul"], paths)
    return out + fp32 + gemma + qmm + native


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
    from pilottai_tpu_torch.ops.kernels import int8_matmul as i8
    from pilottai_tpu_torch.ops.kernels import paged_attention as pa
    from pilottai_tpu_torch.ops.kernels import qmatmul as qk

    kernels = {"flash": fa, "decode": da, "paged": pa, "qmatmul": qk, "int8_matmul": i8}
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    t_start = time.perf_counter()

    def stage(title):
        log(f"== {title} (at {time.perf_counter() - t_start:.1f} s)")

    stage("1. environment")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")
    log(smi)
    log("  bf16 x bf16 -> fp32 products (the logits head, the speculative verify): "
        f"aten::mm.dtype {'present' if hasattr(torch.ops.aten.mm, 'dtype') else 'ABSENT'}, "
        f"aten::bmm.dtype {'present' if hasattr(torch.ops.aten.bmm, 'dtype') else 'ABSENT'}")

    # A decode chunk's exit once every slot is done needs a conditional node
    # in the chunk graph (ROADMAP C.4); these capture one.
    found = {m: hasattr(torch.cuda.CUDAGraph, m) for m in (
        "begin_capture_to_if_node", "end_capture_to_conditional_node",
        "get_currently_capturing_graph")}
    log("  CUDA-graph conditional nodes (a decode chunk's exit once every slot is done): "
        + ", ".join(f"CUDAGraph.{m} {'present' if ok else 'ABSENT'}" for m, ok in found.items())
        + ("" if all(found.values()) else "; every step of a chunk graph runs (ROADMAP C.4)"))

    stage("2. build (nvcc, sm_90a, the ten kernel sources in parallel)")
    t0 = time.perf_counter()
    build.build_libraries(["flash_fwd", "decode_attention", "paged_attention",
                           "paged_attention_h256", "flash_bwd_dq", "flash_bwd_dq_h256",
                           "flash_bwd_dkv", "flash_bwd_dkv_h256", "qmatmul", "int8_matmul"])
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for name, (secs, text) in build.build_log.items():
        log(f"  {name}: nvcc {secs:.1f} s")
        for line in text.splitlines():
            if ("entry function" in line or "registers" in line or "spill" in line
                    or "error" in line.lower()):
                log(f"    {line.strip()}")

    stage("3. kernels vs plain versions")
    worst = phase_kernels(torch, fa, da, pa, device, args.seed)
    stage("3. the quantized product (int8, int4) vs its plain version")
    worst["qmatmul"] = phase_qmatmul(torch, qk, device, args.seed)
    stage("3. the integer arm (PILOTTAI_QMATMUL=native): row quantizer and s8 product vs their "
          "plain versions")
    worst["int8_matmul"] = phase_native(torch, i8, device, args.seed)
    if args.kernels_only:
        return 0
    paths = {}
    stage("4a. golden protocol-s token ids (fp32), dense cache")
    paths["golden"] = phase_golden(torch, kernels, root, "protocol_s_golden.json", paged=False)
    stage("4a. again with the decode pipeline's knobs off")
    phase_golden(torch, kernels, root, "protocol_s_golden.json", paged=False,
                 knobs=SERIAL_KNOBS)
    stage("4b. golden protocol-s token ids (fp32), paged cache, chunked prefill")
    paths["golden_paged"] = phase_golden(torch, kernels, root, "protocol_s_paged_golden.json",
                                         paged=True)
    stage("4b. again with the decode pipeline's knobs off")
    phase_golden(torch, kernels, root, "protocol_s_paged_golden.json", paged=True,
                 knobs=SERIAL_KNOBS)
    stage("4b. again at engine_page_size 8, the smallest page the config takes")
    paths["golden_paged_p8"] = phase_golden(torch, kernels, root,
                                            "protocol_s_paged_golden.json", paged=True,
                                            page_size=8)
    stage("4c. golden protocol-s token ids (fp32) with the prefix cache on (the port's "
          "defaults), each case served twice: dense")
    phase_golden(torch, kernels, root, "protocol_s_golden.json", paged=False, prefix_cache=None,
                 repeat=2)
    stage("4c. the same, paged cache, chunked prefill")
    phase_golden(torch, kernels, root, "protocol_s_paged_golden.json", paged=True,
                 prefix_cache=None, repeat=2)
    for label, asset, paged in (("dense", "protocol_s_golden.json", False),
                                ("paged cache, chunked prefill", "protocol_s_paged_golden.json",
                                 True)):
        stage(f"4d. golden protocol-s token ids (fp32) with engine_speculate=4: {label}")
        phase_golden(torch, kernels, root, asset, paged=paged, knobs=dict(engine_speculate=4))
        stage(f"4d. again with engine_draft_layers=2, every slot drafting through the model: "
              f"{label}")
        paths["golden_drafts_paged" if paged else "golden_drafts"] = phase_golden(
            torch, kernels, root, asset, paged=paged,
            knobs=dict(engine_speculate=4, engine_draft_layers=2), force_drafts=True)
    for key, asset, knobs, label in (
            ("quant_golden_int8", "protocol_s_int8_golden.json", None, "int8, dense cache"),
            ("quant_golden_int4_paged", "protocol_s_int4_paged_golden.json", None,
             "int4 group 96, paged cache, chunked prefill"),
            ("quant_golden_int4_spec", "protocol_s_int4_golden.json",
             dict(engine_speculate=4), "int4 group 128, dense cache, engine_speculate=4")):
        stage(f"4e. golden protocol-s token ids (fp32) with quantized weights: {label}")
        paths[key] = phase_golden(torch, kernels, root, asset, paged="paged" in key, knobs=knobs)
    for label, asset, paged in (("dense", "protocol_s_kv8_golden.json", False),
                                ("paged cache, chunked prefill",
                                 "protocol_s_kv8_paged_golden.json", True)):
        stage(f"4f. golden protocol-s token ids (fp32) with the int8 KV cache: {label}")
        phase_golden(torch, kernels, root, asset, paged=paged)
        stage(f"4f. the same with engine_speculate=4 and the prefix cache on, each case served "
              f"twice: {label}")
        phase_golden(torch, kernels, root, asset, paged=paged, knobs=dict(engine_speculate=4),
                     prefix_cache=None, repeat=2)
    for key, asset, knobs, label, repeat in (
            ("native_golden_int8", "protocol_s_int8_native_golden.json", None,
             "int8, dense cache", 1),
            ("native_golden_int4", "protocol_s_int4_native_golden.json", None,
             "int4 group 128, dense cache", 1),
            ("native_golden_int4_paged", "protocol_s_int4_native_paged_golden.json", None,
             "int4 group 96, paged cache, chunked prefill", 1),
            ("native_golden_int4_spec", "protocol_s_int4_native_spec_golden.json", None,
             "int4 group 128, dense cache, engine_speculate=4, prefix cache on, each case "
             "served twice", 2)):
        stage(f"4g. golden protocol-s token ids (fp32) on the integer arm "
              f"(PILOTTAI_QMATMUL=native at start): {label}")
        paths[key] = phase_golden(torch, kernels, root, asset, paged="paged" in key, knobs=knobs,
                                  prefix_cache=None if repeat > 1 else 0, repeat=repeat,
                                  native=True)
    for stem in ("gemma2_tiny_h256", "gemma_tiny_h256"):
        for paged in (False, True):
            asset = f"{stem}{'_paged' if paged else ''}_golden.json"
            stage(f"4h. golden {stem.replace('_', '-')} token ids (fp32, head_dim 256): "
                  f"{'paged cache, chunked prefill' if paged else 'dense cache'}")
            got = phase_golden(torch, kernels, root, asset, paged=paged)
            if stem == "gemma2_tiny_h256":
                paths["gemma_golden_paged" if paged else "gemma_golden"] = got
    stage("5a. llama3-8b full width, bf16, dense cache, 8 concurrent JSON requests")
    paths["full"] = phase_full_width(torch, kernels, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  after 5a (its engine kept for 5c): {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    stage("5b. llama3-8b full width, bf16, paged cache (engine_max_seq 8192), "
          "1 long + 7 short JSON requests")
    paths["full_paged"] = phase_full_width_paged(torch, kernels, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    stage("5d. llama3-8b full width, bf16, 8 agent steps a wave sharing a preamble, prefix "
          "cache on and off: dense (engine_max_seq 2048)")
    paths["prefix_dense"] = phase_prefix_agent_steps(torch, kernels, root, args.seed, False)
    stage("5d. the same, paged (engine_max_seq 8192, pages of 128)")
    paths["prefix_paged"] = phase_prefix_agent_steps(torch, kernels, root, args.seed, True)
    gc.collect()
    torch.cuda.empty_cache()
    stage("5e. llama3-8b full width, bf16, engine_speculate=4, 8 concurrent JSON requests, "
          "speculation on and off: dense (engine_max_seq 2048)")
    phase_spec_waves(torch, kernels, args.seed, paged=False)
    stage("5e. the same, paged (engine_max_seq 8192, pages of 128)")
    paths["spec_paged"] = phase_spec_waves(torch, kernels, args.seed, paged=True)
    gc.collect()
    torch.cuda.empty_cache()
    for mode in ("int8", "int4"):
        stage(f"5f. llama3-8b full width, bf16 activations, {mode} weights, dense cache, 8 "
              "concurrent JSON requests")
        paths[f"quant_{mode}"] = phase_quant_full_width(torch, kernels, args.seed, mode)
    for mode in ("int8", "int4"):
        stage(f"5h. llama3-8b full width, bf16 activations, {mode} weights on the integer arm "
              "(PILOTTAI_QMATMUL=native at start), fixed chunks, dense cache, 5f's requests")
        paths[f"native_{mode}"] = phase_quant_full_width(torch, kernels, args.seed, mode,
                                                         native=True)
        native_against_dequant(paths, mode)
    stage("5g. llama3-8b full width, bf16, engine_kv_quantize='int8', dense cache (5a's "
          "requests)")
    paths["kv8"] = phase_kv8_full_width(torch, kernels, args.seed, paged=False)
    stage("5g. the same, paged (engine_max_seq 8192; 5b's requests, the long prompt in "
          "1024-token segments; fixed chunks)")
    paths["kv8_paged"] = phase_kv8_full_width(torch, kernels, args.seed, paged=True)
    stage(f"5c. the device's busy share: {PROFILED_WAVES} profiled waves of each llama3-8b "
          "workload")
    paths["full"][1].update(phase_busy(torch, args.seed))
    stop_shared()
    gc.collect()
    torch.cuda.empty_cache()
    stage("5i. gemma2-2b full width, bf16, paged cache (engine_max_seq 8192, pages of 128), "
          "5b's requests, fixed chunks")
    paths["gemma_paged"] = phase_gemma_full_width(torch, kernels, args.seed, "gemma2-2b", 8192)
    stage("5i. gemma-2b full width, bf16, dense cache (engine_max_seq 2048), 5a's requests, "
          "fixed chunks")
    paths["gemma_dense"] = phase_gemma_full_width(torch, kernels, args.seed, "gemma-2b", 2048)
    gc.collect()
    torch.cuda.empty_cache()
    stage("7a. golden training: protocol-s fp32, 4 steps against the JAX trainer")
    paths["train_golden"] = phase_train_golden(torch, kernels, root)
    stage("7b. llama3-1b full width, bf16 compute, fp32 master weights, remat, 8 steps of 4 x "
          "2048")
    paths["train_full"] = phase_train_full(torch, kernels, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    for stem in ("gemma2_tiny_h256", "gemma_tiny_h256"):
        stage(f"7c. golden training: {stem.replace('_', '-')} fp32 (head_dim 256), 4 steps "
              "against the JAX trainer")
        paths[f"train_golden_{stem}"] = phase_train_golden(torch, kernels, root,
                                                           f"{stem}_train_golden.json")
    stage(f"7d. gemma2-2b full width, bf16 compute, fp32 master weights, remat, 8 steps of "
          f"{GEMMA_TRAIN_B} x 2048 (head_dim 256: K1, K4, K5)")
    paths["train_gemma"] = phase_train_full(torch, kernels, args.seed, model="gemma2-2b",
                                            B=GEMMA_TRAIN_B)
    gc.collect()
    torch.cuda.empty_cache()
    stage("6. kernel times at each path's shapes")
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
