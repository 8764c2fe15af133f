"""The quantized product's launch plan and the arithmetic of its bf16
body, on the CPU (``ops/kernels/qmatmul.py``, ``csrc/qmatmul.cu``).

``launch_plan`` is a pure function of the shapes, the kernel's occupancy
and the SM count: every tile (bf16) or q row (fp32) of the contraction
falls in exactly one split and no split is empty, and the llama3-8b and
protocol-s shapes give the plans below. ``scale_rows`` (the ring's scale
rows a stage) bounds every tile's span of groups. The bf16 body's
dequant (byte_perm, LOP3 and two bf16x2 FMAs) is emulated bit for bit on
every int8 value and every pair of int4 nibbles and must give
``round_bf16(q * s)``, as ``qmatmul_plain`` rounds it. Then
``qmatmul_plain`` against the JAX package's dequant arm at shapes the
kernel's bodies take apart: an odd contraction in int4, group 96 at K =
256, a column slice with ``ldq > N``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pilottai_tpu.models import qmatmul as jqmatmul
from pilottai_tpu.models import quant as jquant
from pilottai_tpu_torch.models import quant
from pilottai_tpu_torch.ops.kernels import qmatmul as qk

N_SM = 132
LLAMA3_8B = {"wq, wo": (4096, 4096), "wk, wv": (4096, 1024), "wg, wu": (4096, 14336),
             "wd": (14336, 4096)}
PROTOCOL_S = ((256, 256), (256, 128), (256, 1024), (1024, 256))


# --------------------------------------------------------------------- #
# The launch plan
# --------------------------------------------------------------------- #

@settings(max_examples=300, deadline=None)
@given(N=st.integers(1, 20000), K=st.integers(1, 20000), slots=st.integers(1, 2000),
       min_tiles=st.integers(1, 8), max_splits=st.integers(0, 64))
def test_bf16_splits_cover_every_tile_once(N, K, slots, min_tiles, max_splits):
    Z, per = qk.split_count(N, K, slots, min_tiles, max_splits)
    k_tiles = -(-K // qk.K_TILE)
    assert Z >= 1 and per >= 1
    assert (Z - 1) * per < k_tiles <= Z * per  # every tile once, the last split not empty
    strips = -(-N // qk.COLS)
    assert Z == 1 or Z * strips <= max(slots, strips)  # one wave
    assert Z == 1 or per >= min_tiles or k_tiles < 2 * min_tiles
    assert Z <= max(1, max_splits)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 16, 32, 64])
def test_split_partials_stay_under_a_quarter_of_the_weight(M, bits):
    """The split sum's fp32 partials (written, then read by the last
    block) never outweigh a quarter of the weight's bytes: at 32 rows
    llama3-8b's wq takes 4 splits of 16 tiles in int4, 8 of 8 in int8."""
    for K, N in LLAMA3_8B.values():
        plan = qk.launch_plan(M, K, N, bits, 128, False, 4, N_SM)
        q_bytes = K * N // (2 if bits == 4 else 1)
        assert plan.splits == 1 or 4 * plan.partials <= q_bytes // 4  # fp32 bytes
    wq = qk.launch_plan(32, 4096, 4096, bits, 128, False, 4, N_SM)
    if M == 32:
        assert (wq.splits, wq.per) == ((4, 16) if bits == 4 else (8, 8))


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 64), N=st.integers(1, 5000), K=st.integers(1, 5000),
       bits=st.sampled_from([8, 4]), n_sm=st.integers(1, 200))
def test_fp32_splits_cover_every_q_row_once(M, N, K, bits, n_sm):
    groups, Z, per = qk.fp32_split(M, K, N, bits, n_sm)
    q_rows = K if bits == 8 else -(-K // 2)
    assert groups * qk.FP32_ROWS >= M > (groups - 1) * qk.FP32_ROWS
    assert per % qk.FP32_LANES == 0 and Z >= 1
    assert (Z - 1) * per < q_rows <= Z * per
    assert Z == 1 or per >= 2 * qk.FP32_LANES  # at least two steps a split


@pytest.mark.parametrize("blocks_per_sm", [3, 4, 5, 6])
def test_llama3_8b_decode_plans(blocks_per_sm):
    """At 8 rows: the one-wave grid from the occupancy (three blocks an SM
    on an H100 in int8, four in int4); wg/wu's 112 strips leave few
    splits, wk/wv's 8 strips many, each split at least
    ``MIN_SPLIT_TILES`` tiles (two tiles a split gave wk/wv 32 splits of
    2)."""
    slots = blocks_per_sm * N_SM
    for name, (K, N) in LLAMA3_8B.items():
        plan = qk.launch_plan(8, K, N, 4, 128, False, blocks_per_sm, N_SM)
        strips, k_tiles = N // qk.COLS, K // qk.K_TILE
        assert plan.body == "bf16" and plan.grid == (strips, plan.splits, 1)
        assert strips * plan.splits <= slots
        assert plan.per >= qk.MIN_SPLIT_TILES and plan.splits * plan.per >= k_tiles
        assert plan.scale_rows == 1  # group 128: one scale row a 64-row tile
        assert plan.partials == plan.splits * strips * 8 * qk.COLS
        assert plan.counters == strips
    expected = {  # (splits, tiles a split) at 4 blocks an SM
        "wq, wo": (16, 4), "wk, wv": (16, 4), "wg, wu": (4, 16), "wd": (16, 14)}
    if blocks_per_sm == 4:
        for name, (K, N) in LLAMA3_8B.items():
            plan = qk.launch_plan(8, K, N, 8, K, False, 4, N_SM)
            assert (plan.splits, plan.per) == expected[name], name
            assert plan.scale_rows == 0


def test_protocol_s_fp32_plans():
    """4e's fp32 shapes: 4 rows a decode step, 16 a verify block of 4."""
    want = {  # (M, bits, K, N): (row groups, splits, q rows a split)
        (4, 8, 256, 256): (1, 4, 64), (4, 8, 256, 128): (1, 4, 64),
        (4, 8, 256, 1024): (1, 4, 64), (4, 8, 1024, 256): (1, 16, 64),
        (16, 4, 256, 256): (4, 2, 64), (16, 4, 1024, 256): (4, 8, 64),
        (4, 4, 256, 1024): (1, 2, 64), (64, 8, 1024, 256): (16, 4, 256),
    }
    for (M, bits, K, N), (groups, Z, per) in want.items():
        plan = qk.launch_plan(M, K, N, bits, 96, True, 0, N_SM)
        strips = -(-N // qk.COLS)
        assert plan.body == "fp32" and plan.grid == (strips, groups, Z), (M, bits, K, N)
        assert (plan.splits, plan.per) == (Z, per), (M, bits, K, N)
        assert plan.counters == (strips * groups if Z > 1 else 0)
        assert plan.partials == (Z * strips * groups * qk.FP32_ROWS * qk.COLS if Z > 1 else 0)


@pytest.mark.parametrize("group", [1, 7, 16, 24, 32, 48, 64, 96, 100, 128, 192, 256, 1000])
def test_scale_rows_bound_every_tiles_span(group):
    for K in (1, 63, 64, 200, 1001, 4096):
        G = -(-K // group)
        spans = [min((min(k0 + qk.K_TILE, K) - 1) // group, G - 1) - min(k0 // group, G - 1) + 1
                 for k0 in range(0, K, qk.K_TILE)]
        assert max(spans) <= qk.scale_rows(K, group) <= G
        if K >= 4096:
            assert max(spans) == qk.scale_rows(K, group)  # not over-provisioned


# --------------------------------------------------------------------- #
# The bf16 body's dequant, emulated bit for bit
# --------------------------------------------------------------------- #

def _byte_perm(x, y, sel):
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(sel >> 4 * i) & 7] << 8 * i for i in range(4))


def _bf16(bits):
    return float(np.array([bits << 16], dtype=np.uint32).view(np.float32)[0])


def _round_bf16(v):
    """An fp32 value (exact here) rounded to bf16 bits, to nearest even."""
    u = int(np.array([v], dtype=np.float32).view(np.uint32)[0])
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF


def _fma_bf16x2(a, b, c):
    """fma.rn.bf16x2: each half a * b + c, exact then rounded once (the
    operands' products and sums here fit fp32 exactly)."""
    out = 0
    for h in range(2):
        x, y, z = (_bf16((v >> 16 * h) & 0xFFFF) for v in (a, b, c))
        exact = np.float32(x) * np.float32(y)  # 8 x 8 mantissa bits: exact in fp32
        out |= _round_bf16(exact + np.float32(z)) << 16 * h  # integers or + (-0): exact
    return out


SCALES = [0x3C23, 0xBC23, 0x3F80, 0x3A8F, 0xC2F7, 0x0080]  # incl. negative, the least normal


def _plain_bits(q, s_bits):
    """``dequant``'s bf16 weight: q * s rounded once."""
    w = torch.tensor([float(q)], dtype=torch.bfloat16) * torch.tensor(
        [_bf16(s_bits)], dtype=torch.float32).to(torch.bfloat16)
    return int(w.view(torch.int16).item()) & 0xFFFF


@pytest.mark.parametrize("s_bits", SCALES)
def test_int4_dequant_bits_are_the_plain_rounding(s_bits):
    """b_fragments_int4: the two nibbles of a byte (k rows 2r, 2r + 1)
    into the halves of a bf16x2, one LOP3 flipping their sign bit under the
    exponent of 128, two FMAs: round_bf16(q * s), -0 kept for q = 0."""
    s2 = s_bits | s_bits << 16
    for byte in range(256):
        for j in range(4):
            w = byte << 8 * j | (0x5A ^ byte) << 8 * ((j + 1) % 4)  # a neighbour in another byte
            u = _byte_perm(w, w >> 4, j | j << 4 | (4 + j) << 8 | (4 + j) << 12)
            q2 = _fma_bf16x2((u & 0x000F000F) ^ 0x43084308, 0x3F803F80, 0xC308C308)
            got = _fma_bf16x2(q2, s2, 0x80008000)
            lo, hi = ((byte & 0xF) ^ 8) - 8, ((byte >> 4) ^ 8) - 8
            assert got & 0xFFFF == _plain_bits(lo, s_bits), (byte, j)
            assert got >> 16 == _plain_bits(hi, s_bits), (byte, j)


@pytest.mark.parametrize("s_bits", SCALES)
def test_int8_dequant_bits_are_the_plain_rounding(s_bits):
    """b_fragments_int8: two int8 values (k rows 2t and 2t + 1) into the
    halves of a bf16x2, 128 + (q & 127) less 128 or 256 by the sign bit."""
    s2 = s_bits | s_bits << 16
    for v in range(256):
        lo_word, hi_word = v << 8, (255 - v) << 8  # byte j = 1 of two rows
        u = _byte_perm(lo_word, hi_word, 1 | 1 << 4 | 5 << 8 | 5 << 12)
        q2 = _fma_bf16x2((u & 0x007F007F) | 0x43004300, 0x3F803F80, (u & 0x00800080) | 0xC300C300)
        got = _fma_bf16x2(q2, s2, 0x80008000)
        q_lo, q_hi = v - 256 * (v >= 128), (255 - v) - 256 * (255 - v >= 128)
        assert got & 0xFFFF == _plain_bits(q_lo, s_bits), v
        assert got >> 16 == _plain_bits(q_hi, s_bits), v


# --------------------------------------------------------------------- #
# qmatmul_plain against the JAX dequant arm, at the bodies' edge shapes
# --------------------------------------------------------------------- #

def _quantized(K, N, bits, group, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K**-0.5).astype(np.float32)
    jw = jax.jit(lambda a: jquant.quantize_array(a, jnp.float32, bits=bits, group=group))(
        jnp.asarray(w))
    tw = quant.quantize_array(torch.from_numpy(w), torch.float32, bits=bits, group=group)
    return rng, jw, tw


def _slice(w, off, end, jax_side):
    if isinstance(w, (jquant.Q4Tensor, quant.Q4Tensor)):
        cls = jquant.Q4Tensor if jax_side else quant.Q4Tensor
        return cls(q=w.q[:, off:end], s=w.s[:, off:end], in_dim=w.in_dim, group=w.group)
    cls = jquant.QTensor if jax_side else quant.QTensor
    return cls(q=w.q[:, off:end], s=w.s[:, off:end])


@pytest.mark.parametrize("case", [
    "int4 odd K 1001 g128", "int4 odd K 255 g96", "int4 g96 K 256", "int8 column slice",
    "int4 g96 column slice"])
@pytest.mark.parametrize("M", [1, 4, 16])
def test_plain_matches_the_jax_dequant_arm(case, M):
    """fp32, within 1e-6 of max |ref|: only the order of summation
    differs. The column slices are views with ``ldq > N`` (a head tile):
    columns 136 .. 1136 of 1280, N = 1000 not a multiple of 128."""
    bits = 8 if case.startswith("int8") else 4
    group = 96 if "g96" in case else 128
    K = {"int4 odd K 1001 g128": 1001, "int4 odd K 255 g96": 255}.get(case, 256)
    N = 1280 if "slice" in case else 384
    rng, jw, tw = _quantized(K, N, bits, group, seed=M)
    if "slice" in case:
        jw, tw = _slice(jw, 136, 1136, True), _slice(tw, 136, 1136, False)
        assert tw.q.stride(0) == 1280 and tw.q.shape[1] == 1000
    x = rng.standard_normal((M, K)).astype(np.float32)
    got = qk.qmatmul_plain(torch.from_numpy(x), tw)
    want = np.asarray(jqmatmul.qmatmul(jnp.asarray(x), jw))
    assert got.shape == want.shape == (M, tw.q.shape[1])
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # On the CPU the wrapper is the plain version.
    assert torch.equal(qk.quant_matmul(torch.from_numpy(x), tw), got)
