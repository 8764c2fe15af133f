"""Slice P5c on the CPU: the integer-operand arm (``PILOTTAI_QMATMUL=native``,
``ops/kernels/int8_matmul.py``) against the JAX package's arm as the JAX
engine runs it, under ``jax.jit``, bit for bit; the launch plan of its two
kernels; and the product kernel's fragment arithmetic (``csrc/
int8_matmul.cu``) emulated lane by lane.

Under ``jit`` XLA multiplies ``max|x|`` by the fp32 reciprocal of 127
where the eager function divides, contracts each int4 group's product into
its reduction loop as an FMA for at most 32 groups, and above that splits
the reduction into windows of 32 groups (its tree-reduction rewriter).
``native_matmul_plain`` follows that program, so its results equal the
jitted function's in every bit, fp32 and bf16, at group counts on both
sides of 32 and in both levels of windows. The eager comparison stays in
``tests/test_torch_quant.py``.

The emulation builds each lane's ``mma.sync`` m16n8k32 A and B registers
as the kernel does (32-bit words of the weight rows, the nibbles spread to
16 times their value, ``byte_perm``'s 4 x 4 byte transpose, the permuted
columns), maps them back through the PTX fragment layouts, and runs the
kernel's epilogue with fp32 rounding at each operation: it must give
``native_matmul_plain``'s bits."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.models import qmatmul as jqmatmul
from pilottai_tpu.models import quant as jquant
from pilottai_tpu_torch.models import quant
from pilottai_tpu_torch.models.qmatmul import qmatmul
from pilottai_tpu_torch.ops.kernels import int8_matmul as i8

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np32(a):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32)


def _weights(bits, group, K, N, dtype, seed):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    w[min(7, K - 1), 3 % N] = 0.9  # an outlier column
    jw = jax.jit(lambda a: jquant.quantize_array(a, jdt, bits=bits, group=group))(
        jnp.asarray(w, jdt))
    tw = quant.quantize_array(torch.from_numpy(w).to(tdt), tdt, bits=bits, group=group)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    return jw, tw


def _native_jax(x, w, pref):
    """The JAX engine's arm: ``qmatmul`` under ``jit`` with the variable
    set while it traces."""
    old = os.environ.get("PILOTTAI_QMATMUL")
    os.environ["PILOTTAI_QMATMUL"] = "native"
    try:
        return jax.jit(lambda a, b: jqmatmul.qmatmul(a, b, preferred_element_type=pref))(x, w)
    finally:
        if old is None:
            del os.environ["PILOTTAI_QMATMUL"]
        else:
            os.environ["PILOTTAI_QMATMUL"] = old


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1, 96, 1000, 4096])
def test_row_quantizer_gives_the_jitted_jax_bytes(K, dtype):
    """``xq`` byte for byte and ``sx`` bit for bit against
    ``jax.jit(_quantize_activation)``, with an all-zero row (the 1e-8
    floor), a row with one value and exact halves."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(K)
    x = rng.standard_normal((2, 5, K)).astype(np.float32) * np.float32(3.0)
    x[0, 1] = 0.0
    x[1, 2] = 0.0
    x[1, 2, K // 2] = -0.25
    x[1, 3, : min(K, 4)] = [127.0, 0.5, -1.5, 2.5][: min(K, 4)]
    xq, sx = i8.quantize_rows_plain(torch.from_numpy(x).to(tdt))
    jxq, jsx = jax.jit(jqmatmul._quantize_activation)(jnp.asarray(x, jdt))
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32 and sx.shape == (2, 5, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy().view(np.int32), np.asarray(jsx).view(np.int32))


# (bits, group, K, N): int8; int4 at 128 (32 groups: the FMA chain at its
# longest), 96 (a short last group; 43 groups: two windows), 32 (128 groups:
# four windows), and an odd contraction with a ragged last window.
NATIVE_SHAPES = [
    (8, 128, 1000, 72),
    (8, 128, 4096, 40),
    (4, 128, 4096, 48),
    (4, 128, 14336, 16),
    (4, 96, 1000, 40),
    (4, 96, 4096, 24),
    (4, 32, 4096, 24),
    (4, 32, 1001, 36),
]


@pytest.mark.parametrize("out", [None, "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group,K,N", NATIVE_SHAPES)
def test_native_arm_equals_the_jitted_jax_arm(bits, group, K, N, dtype, out, monkeypatch):
    """``qmatmul`` on the native arm against ``jax.jit(qmatmul)`` with
    ``PILOTTAI_QMATMUL=native``: every output bit equal (bf16 after the
    one rounding of the fp32 result), on rows ``[3, 5, K]``."""
    monkeypatch.setenv("PILOTTAI_QMATMUL", "native")
    jw, tw = _weights(bits, group, K, N, dtype, seed=bits * K + group)
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(K + N).standard_normal((3, 5, K)).astype(np.float32)
    got = qmatmul(torch.from_numpy(x).to(tdt), tw,
                  preferred_element_type=torch.float32 if out else None)
    want = _native_jax(jnp.asarray(x, jdt), jw, jnp.float32 if out else None)
    assert got.dtype == (torch.float32 if out else tdt) and got.shape == (3, 5, N)
    np.testing.assert_array_equal(_np32(got), _np32(want))
    # The arm's own plain function, called directly, is the same function.
    assert torch.equal(got, i8.native_matmul_plain(torch.from_numpy(x).to(tdt), tw,
                                                   torch.float32 if out else None))


def test_fma_f32_rounds_once():
    """``fma_f32`` is one rounding of the exact ``a · b + c``: against the
    exact rational result rounded to fp32, on values where two roundings
    differ (a product's low bits cancelling against ``c``)."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(4000) * 1e-6)).astype(np.float32)
    got = i8.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()

    def round_f32(q: Fraction) -> np.float32:
        lo = np.float32(float(q))  # within an ulp; pick the nearer neighbour, ties to even
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                         int(np.array(v).view(np.int32)) & 1))
        return np.float32(best)

    want = np.array([round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    naive = (a * b + c).astype(np.float32)
    assert (naive != want).any()  # the test can tell one rounding from two


# --------------------------------------------------------------------- #
# The launch plan
# --------------------------------------------------------------------- #

LLAMA3_8B = {"wq, wo": (4096, 4096), "wk, wv": (4096, 1024), "wg, wu": (4096, 14336),
             "wd": (14336, 4096)}


@pytest.mark.parametrize("bits,group", [(8, 128), (4, 128), (4, 96), (4, 32)])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 32, 33, 72, 256, 2048])
def test_launch_plan_tiles_rows_columns_and_groups(M, bits, group):
    """Rows padded to whole row tiles (16 a warp's m16 tile, at most 64
    int8 and 32 int4), columns to whole strips of 32 columns a warp (one
    warp a block up to 64 rows, four above), the contraction
    to whole k32 steps (int4: whole groups, ``steps`` k32 steps each), the
    sum's mode by the group count, and the workspace's bytes (``xq`` and
    ``sx``) from those alone."""
    for K, N in list(LLAMA3_8B.values()) + [(1000, 40), (1001, 36)]:
        p = i8.launch_plan(M, K, N, bits, group)
        assert p.mt == (1 if M <= 16 else 2 if M <= 32 or bits == 4 else 4)
        assert p.rows % (16 * p.mt) == 0 and p.rows - 16 * p.mt < M <= p.rows
        assert p.warps == (1 if M <= 64 else 4)
        assert p.grid == (-(-N // (32 * p.warps)), p.rows // (16 * p.mt))
        assert p.kx % 32 == 0 and p.kx >= K and p.kx == p.n_groups * p.steps * 32
        if bits == 8:
            assert (p.n_groups, p.mode, p.kx) == (1, 0, -(-K // 32) * 32)
        else:
            G = -(-K // group)
            assert (p.n_groups, p.steps) == (G, group // 32)
            assert p.mode == (1 if G <= 32 else 2)
            if p.mode == 2:
                windows = i8.window_split(G)[0]
                assert windows == -(-G // 32) and 2 * p.lead <= windows * 32 - G
        assert p.workspace_bytes == p.rows * p.kx + 4 * p.rows


def test_launch_plan_windows_and_limits():
    """XLA's padding of the group axis (the smaller half of it before):
    43 groups in two windows after 10 zero groups; 112 (llama3-8b's wd at
    group 128) in four after 8; 1024 groups the most two levels hold."""
    for K, group, want in ((4096, 96, (43, 2, 2, 10)), (14336, 128, (112, 2, 4, 8)),
                           (32 * 1024, 32, (1024, 2, 32, 0))):
        p = i8.launch_plan(8, K, 64, 4, group)
        assert (p.n_groups, p.mode, i8.window_split(p.n_groups)[0], p.lead) == want
    with pytest.raises(ValueError, match="at most 1024"):
        i8.launch_plan(8, 32 * 1025, 64, 4, 32)
    with pytest.raises(ValueError, match="multiples of 32"):
        i8.launch_plan(8, 4096, 64, 4, 100)
    w = quant.quantize_array(torch.randn(40 * 32 * 33, 8), torch.float32, bits=4, group=1)
    with pytest.raises(ValueError):
        i8.native_matmul_plain(torch.randn(2, w.in_dim), w)


# --------------------------------------------------------------------- #
# The product kernel's fragments, emulated
# --------------------------------------------------------------------- #

def _byte_perm(x: int, y: int, s: int) -> int:
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _transpose4(r):
    a01, b01 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[0], r[1], 0x7362)
    a23, b23 = _byte_perm(r[2], r[3], 0x5140), _byte_perm(r[2], r[3], 0x7362)
    return [_byte_perm(a01, a23, 0x5410), _byte_perm(a01, a23, 0x7632),
            _byte_perm(b01, b23, 0x5410), _byte_perm(b01, b23, 0x7632)]


def _bytes_s8(word: int):
    return [((word >> (8 * i)) & 0xFF) - (256 if (word >> (8 * i)) & 0x80 else 0)
            for i in range(4)]


def _emulate(xq, sx, q, s, bits, K, N, plan):
    """The kernel's arithmetic, lane by lane: its A and B registers mapped
    back through the PTX m16n8k32 s8 layouts, int32 sums, and the
    epilogue's fp32 operations in its order."""
    rows, kx = xq.shape
    q_rows = q.shape[0]
    qb = q.astype(np.uint8)

    def word(row, col):  # load_word
        if row >= q_rows or col >= N:
            return 0
        return sum(int(qb[row, col + j]) << (8 * j) for j in range(4) if col + j < N)

    def b_half(k0, t, col):
        if bits == 8:
            return _transpose4([word(k0 + 4 * t + r, col) for r in range(4)])
        r = k0 // 2 + 2 * t
        p0, p1 = word(r, col), word(r + 1, col)
        return _transpose4([(p0 << 4) & 0xF0F0F0F0, p0 & 0xF0F0F0F0,
                            (p1 << 4) & 0xF0F0F0F0, p1 & 0xF0F0F0F0])

    f32 = np.float32
    out = np.zeros((rows, plan.grid[0] * 32 * plan.warps), np.float32)
    for bx in range(plan.grid[0]):
        for warp in range(plan.warps):
            n_warp = (bx * plan.warps + warp) * 32
            for by in range(plan.grid[1]):
                m0 = by * 16 * plan.mt
                acc = np.zeros((16 * plan.mt, 32), np.int64)  # [row, warp column]
                total = np.zeros_like(acc, dtype=np.float32)
                win = np.zeros_like(total)
                for grp in range(plan.n_groups):
                    for st in range(plan.steps):
                        k0 = (grp * plan.steps + st) * 32
                        A = np.zeros((16 * plan.mt, 32), np.int64)
                        B = np.zeros((32, 32), np.int64)  # [k, warp column]
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            lo = b_half(k0, t, n_warp + 4 * g)
                            hi = b_half(k0 + 16, t, n_warp + 4 * g)
                            for j in range(4):
                                # B register j: tile column g of n-tile j,
                                # the warp's column 4g + j.
                                for i, v in enumerate(_bytes_s8(lo[j])):
                                    B[4 * t + i, 4 * g + j] = v
                                for i, v in enumerate(_bytes_s8(hi[j])):
                                    B[16 + 4 * t + i, 4 * g + j] = v
                            for mi in range(plan.mt):
                                for h, koff in ((0, 0), (1, 0), (0, 16), (1, 16)):
                                    r = 16 * mi + g + 8 * h
                                    base = k0 + koff + 4 * t
                                    A[r, koff + 4 * t: koff + 4 * t + 4] = \
                                        xq[m0 + r, base: base + 4]
                        acc += A @ B
                    if plan.mode == 0:
                        continue
                    sc = np.array([f32(s[grp, n]) if n < N else f32(0)
                                   for n in range(n_warp, n_warp + 32)], np.float32)
                    v = (acc >> 4).astype(np.float32)
                    acc[:] = 0
                    if plan.mode == 1:
                        total = i8.fma_f32(torch.from_numpy(v), torch.from_numpy(
                            np.broadcast_to(sc, v.shape).copy()), torch.from_numpy(total)).numpy()
                    else:
                        win = (win + (v * sc).astype(np.float32)).astype(np.float32)
                        if (grp + plan.lead) % 32 == 31 or grp == plan.n_groups - 1:
                            total = (total + win).astype(np.float32)
                            win[:] = 0
                xs = sx[m0: m0 + 16 * plan.mt, None]
                if plan.mode == 0:
                    ws = np.array([s[0, n] if n < N else 0 for n in range(n_warp, n_warp + 32)],
                                  np.float32)
                    res = ((acc.astype(np.float32) * xs).astype(np.float32) * ws)
                else:
                    res = total * xs
                out[m0: m0 + 16 * plan.mt, n_warp: n_warp + 32] = res.astype(np.float32)
    return out


@pytest.mark.parametrize("bits,group,M,K,N", [
    (8, 128, 5, 100, 40),     # rows short of one m16 tile; K off the k32 steps; N off the strip
    (8, 128, 20, 64, 130),    # two m16 tiles a warp; a ragged last strip
    (8, 128, 70, 64, 136),    # four warps a block, four m16 tiles a warp, two row tiles
    (4, 32, 3, 200, 36),      # 7 groups, one FMA each; an odd last packed row pair
    (4, 64, 17, 130, 8),      # 3 groups of 2 k32 steps; the last group short
])
def test_kernel_fragments_give_the_plain_bits(bits, group, M, K, N):
    """The emulated kernel equals ``native_matmul_plain`` in fp32, bit for
    bit: the byte transposes, the permuted columns, the nibbles at 16
    times their value and the epilogue's order."""
    rng = np.random.default_rng(M * K + N)
    w = quant.quantize_array(torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)),
                             torch.float32, bits=bits, group=group)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    plan = i8.launch_plan(M, K, N, bits, group)
    xq, sx = i8.quantize_rows_plain(x)
    xq_ws = np.zeros((plan.rows, plan.kx), np.int64)
    xq_ws[:M, :K] = xq.numpy()
    sx_ws = np.zeros(plan.rows, np.float32)
    sx_ws[:M] = sx[:, 0].numpy()
    got = _emulate(xq_ws, sx_ws, w.q.numpy(), w.s.numpy(), bits, K, N, plan)[:M, :N]
    want = i8.native_matmul_plain(x, w, torch.float32).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
