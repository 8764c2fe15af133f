"""The integer-operand quantized product (``PILOTTAI_QMATMUL=native``): the
activation quantized per row to int8, the contraction in int32 against the
int8 or packed int4 weight, the scales folded in after.

Replaces no ``pallas_call`` (``REPLACES = None``): the JAX package's
``models/qmatmul.py:_native_int8_matmul`` leaves the arm to XLA (an int8
``dot_general`` into int32, a grouped one for int4). Two kernels of
``csrc/int8_matmul.cu`` compute it on the card:

* ``quantize_rows``: one block a row writes the row's int8 values and its
  scale ``sx`` into a workspace from the caching allocator (so the arm can
  be captured in a CUDA graph), the rows padded to the product's row tile
  and the columns to its contraction walk with zeros;
* ``int8_matmul``: ``mma.sync`` m16n8k32 on s8 operands with int32
  accumulators, one accumulator a scale group for int4, and the scales
  applied in the order XLA's compiled CPU program applies them, so that
  the fp32 result equals ``native_matmul_plain`` bit for bit.

That order (``native_matmul_plain``): ``amax / 127`` is a product with the
fp32 reciprocal of 127, as XLA rewrites it under ``jit``; int8 is
``(acc · sx) · s``; int4 sums ``acc_g · s[g]`` over the groups and then
multiplies by ``sx``: for at most 32 groups as one fused multiply-add a
group in index order (XLA contracts the product into its reduction loop),
for more as XLA's tree-reduction rewriter splits the reduction: windows
of 32 groups (the group axis padded with zeros to a multiple of 32, the
padding split evenly before and after, one more at the end), each summed
in order, then the windows in order (no FMA: the products are written
out first). ``launch_plan`` holds the shapes' side of both launches.

For a CUDA tensor the wrapper launches both kernels or raises; for a CPU
tensor it runs the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from pilottai_tpu_torch.models.quant import Q4Tensor, QTensor, unpack_int4

#: Product launches since the last reset (``chip_smoke.py`` reads it).
launches = 0
#: Quantizer launches since the last reset.
launches_quant = 0
#: Product launches by ``(M, K, N)``.
launches_by_shape: Dict[Tuple[int, int, int], int] = {}

SOURCE = "pilottai_tpu_torch/csrc/int8_matmul.cu"
#: No TPU kernel: the JAX package leaves the integer arm to XLA.
REPLACES = None
WARP_COLS = 32    # output columns a warp owns
WIDE_ROWS = 64    # more rows than this: four warps a block, else one
K_STEP = 32       # contraction rows an mma.sync m16n8k32 step takes
WINDOW = 32       # XLA's tree-reduction window over the scale groups
MAX_GROUPS = WINDOW * WINDOW  # two levels of windows: the kernel's limit
QUANT_THREADS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# fp32 reciprocal of the int8 range (see quantize_rows_plain).
_RECIP_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))

Quantized = Union[QTensor, Q4Tensor]


# --------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------- #

def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8: ``(xq int8, sx fp32 [..., 1])``.
    ``max|x| / 127`` is taken as XLA compiles it under ``jit``, a product
    with the fp32 reciprocal of 127; ``x / sx`` stays a division."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * _RECIP_127
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a · b + c`` rounded once to fp32 (an fp32 fused multiply-add), for
    fp32 tensors: the product is exact in fp64, the sum is rounded to odd
    in fp64 (two-sum error, then the neighbour toward it where the sum's
    last bit is even), which makes the one rounding to fp32 correct."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def window_split(n_groups: int) -> Tuple[int, int]:
    """``(windows, zero groups before the first)`` of XLA's tree-reduction
    split of a sum over more than ``WINDOW`` groups: the axis padded to
    whole windows, the padding's smaller half before."""
    padded = -(-n_groups // WINDOW) * WINDOW
    return padded // WINDOW, (padded - n_groups) // 2


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 values as int32, through fp64, where every partial
    sum is an integer below 2^53 and so exact in any order (the card has
    no integer ``matmul``)."""
    return (a.double() @ b.double()).to(torch.int32)


def native_matmul_plain(x: torch.Tensor, w: Quantized,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The integer-operand contraction in plain PyTorch: int8 activation by
    int8 weight into int32, scales folded in after, the result in
    ``out_dtype`` (default ``x.dtype``). int8: ``(acc · sx) · s``. int4:
    each group's int32 partial times its scales, summed over the groups in
    XLA's order, then times ``sx``: at most ``WINDOW`` groups, one fp32
    FMA a group in index order; more, the products rounded and summed in
    ``window_split``'s windows, each in order, then the windows in order
    (at most ``MAX_GROUPS`` groups)."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_rows_plain(x)
    if isinstance(w, QTensor):
        acc = _int_dot(xq, w.q)
        return (acc.float() * sx * w.s[0].float()).to(out_dtype)
    K, group, G = w.in_dim, w.group, w.s.shape[-2]
    if G > MAX_GROUPS:
        raise ValueError(f"native_matmul_plain: {G} scale groups; at most {MAX_GROUPS}")
    wq = unpack_int4(w.q, K)                                # [in, out] int8
    sf = w.s.float()
    lead = window_split(G)[1]
    total = win = None
    for g in range(G):
        lo, hi = g * group, min((g + 1) * group, K)
        a = _int_dot(xq[..., lo:hi], wq[lo:hi]).float()
        if total is None:
            total, win = torch.zeros_like(a), torch.zeros_like(a)
        if G <= WINDOW:
            total = fma_f32(a, sf[g].expand_as(a), total)
            continue
        win = win + a * sf[g]
        if (g + lead) % WINDOW == WINDOW - 1 or g == G - 1:
            total, win = total + win, torch.zeros_like(a)
    return (total * sx).to(out_dtype)


# --------------------------------------------------------------------- #
# The launch plan (shapes only, tested on the CPU)
# --------------------------------------------------------------------- #

class Plan(NamedTuple):
    """Both launches of one product: ``mt`` m16 tiles a warp (the block's
    rows ``16·mt``), ``warps`` a block (32 columns each), the product's
    ``grid`` (column strips, row tiles),
    the workspace's ``rows`` (M padded to the row tile) and ``kx``
    contraction columns (zero-padded to whole k32 steps, int4 to whole
    groups), ``steps`` k32 steps a scale group, ``n_groups``, the sum's
    ``mode`` (0 int8; 1 int4 one FMA a group; 2 int4 in windows), ``lead``
    (zero groups before the first window), and the workspace's bytes
    (``xq`` int8 and ``sx`` fp32)."""

    mt: int
    warps: int
    grid: Tuple[int, int]
    rows: int
    kx: int
    steps: int
    n_groups: int
    mode: int
    lead: int
    workspace_bytes: int


def launch_plan(M: int, K: int, N: int, bits: int, group: int) -> Plan:
    """The quantizer's and the product's launches for ``x [M, K]`` against
    a ``[K, N]`` weight (``bits`` 8, or 4 with scale groups of ``group``
    rows, a multiple of 32): up to 64 rows one warp a block, so that a
    decode step's column strips spread over the most SMs; more rows four
    warps, which share their rows of ``xq`` through L1."""
    if bits == 8:
        mt = 1 if M <= 16 else 2 if M <= 32 else 4
        kx = -(-K // K_STEP) * K_STEP
        steps, n_groups, mode, lead = kx // K_STEP, 1, 0, 0
    elif bits == 4:
        if group % K_STEP or group <= 0:
            raise ValueError(f"int8_matmul: int4 scale groups of {group} rows; the kernel takes "
                             f"multiples of {K_STEP}")
        n_groups = -(-K // group)
        if n_groups > MAX_GROUPS:
            raise ValueError(f"int8_matmul: {n_groups} scale groups; the kernel sums at most "
                             f"{MAX_GROUPS} (two levels of XLA's windows)")
        mt = 1 if M <= 16 else 2
        kx, steps = n_groups * group, group // K_STEP
        mode = 1 if n_groups <= WINDOW else 2
        lead = window_split(n_groups)[1] if mode == 2 else 0
    else:
        raise ValueError(f"int8_matmul: {bits}-bit weights")
    rows = -(-max(M, 1) // (16 * mt)) * 16 * mt
    warps = 1 if M <= WIDE_ROWS else 4
    return Plan(mt, warps, (-(-N // (WARP_COLS * warps)), rows // (16 * mt)), rows, kx, steps,
                n_groups, mode, lead, rows * kx + 4 * rows)


# --------------------------------------------------------------------- #
# The wrappers
# --------------------------------------------------------------------- #

def _layout(w: Quantized) -> Tuple[int, int, int, int]:
    """``(bits, K, group, q rows)`` of a quantized weight, checked."""
    if isinstance(w, QTensor):
        bits, K, group, G, q_rows = 8, w.q.shape[0], w.q.shape[0], 1, w.q.shape[0]
    elif isinstance(w, Q4Tensor):
        bits, K, group = 4, w.in_dim, w.group
        G, q_rows = -(-K // group), -(-K // 2)
    else:
        raise TypeError(f"int8_matmul: {type(w).__name__} is not a QTensor or Q4Tensor")
    if (w.q.dtype != torch.int8 or w.q.dim() != 2 or w.s.dim() != 2 or w.q.shape[0] != q_rows
            or tuple(w.s.shape) != (G, w.q.shape[1]) or w.q.stride(1) != 1
            or w.s.stride(1) != 1):
        raise ValueError(f"int8_matmul: unsupported weight q {tuple(w.q.shape)} {w.q.dtype} "
                         f"s {tuple(w.s.shape)} (2-D, columns contiguous)")
    return bits, K, group, q_rows


def quantize_rows(x2: torch.Tensor, plan: Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x2 [M, K]`` on the card into the workspace ``plan`` asks for:
    ``xq [plan.rows, plan.kx]`` int8 (zeros beyond ``x2``) and ``sx
    [plan.rows]`` fp32, by one launch of the quantizer."""
    global launches_quant
    from pilottai_tpu_torch.ops.kernels.build import load_library

    lib = _bind(load_library("int8_matmul"))
    M, K = x2.shape
    work = torch.empty(plan.workspace_bytes, device=x2.device, dtype=torch.int8)
    xq = work[: plan.rows * plan.kx].view(plan.rows, plan.kx)
    sx = work[plan.rows * plan.kx:].view(torch.float32)
    status = lib.pt_quantize_rows(_DTYPES[x2.dtype], x2.data_ptr(), x2.stride(0), M, plan.rows,
                                  K, plan.kx, xq.data_ptr(), sx.data_ptr(),
                                  torch.cuda.current_stream(x2.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"int8_matmul quantizer launch failed: "
                           f"{lib.pt_error_string(status).decode()}")
    launches_quant += 1
    return xq, sx


def int8_matmul(x: torch.Tensor, w: Quantized,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K]`` against a quantized ``w [K, N]`` on the integer arm,
    in ``out_dtype`` (``x.dtype`` or float32; default ``x.dtype``)."""
    if x.device.type == "cpu":
        return native_matmul_plain(x, w, out_dtype)
    return _launch(x, w, out_dtype)


def _launch(x: torch.Tensor, w: Quantized, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    if x.device.type != "cuda" or w.q.device != x.device or w.s.device != x.device:
        raise ValueError(f"int8_matmul: unsupported devices x {x.device} q {w.q.device} "
                         f"s {w.s.device}")
    bits, K, group, _ = _layout(w)
    if x.dtype not in _DTYPES or w.s.dtype != x.dtype:
        raise TypeError(f"int8_matmul: x and the scales must share float32 or bfloat16, got "
                        f"{x.dtype}/{w.s.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"int8_matmul: result dtype {out_dtype} for {x.dtype} inputs")
    if x.shape[-1] != K:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} against a weight of {K} rows")
    N = w.q.shape[1]
    x2 = x.reshape(-1, K)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), device=x.device, dtype=out_dtype)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    plan = launch_plan(M, K, N, bits, group)
    xq, sx = quantize_rows(x2, plan)
    product(xq, sx, w, plan, out)
    return out.reshape(*x.shape[:-1], N)


def product(xq: torch.Tensor, sx: torch.Tensor, w: Quantized, plan: Plan,
            out: torch.Tensor) -> torch.Tensor:
    """The product's launch on ``quantize_rows``' workspace into ``out [M,
    N]`` (the scales' dtype, or fp32)."""
    global launches
    from pilottai_tpu_torch.ops.kernels.build import load_library

    bits, K, _, q_rows = _layout(w)
    M, N = out.shape
    lib = _bind(load_library("int8_matmul"))
    status = lib.pt_int8_matmul(
        _DTYPES[w.s.dtype], bits, int(out.dtype == torch.float32), plan.mt, plan.mode,
        plan.warps, xq.data_ptr(), sx.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), out.data_ptr(),
        M, N, w.q.stride(0), w.s.stride(0), q_rows, plan.kx, plan.steps, plan.n_groups,
        plan.lead, torch.cuda.current_stream(out.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"int8_matmul launch failed: {lib.pt_error_string(status).decode()}")
    launches += 1
    key = (M, K, N)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.pt_int8_matmul
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pt_quantize_rows.argtypes = [I, P, L, I, I, I, I, P, P, P]
        lib.pt_quantize_rows.restype = I
        fn.argtypes = [I] * 6 + [P] * 5 + [I] * 9 + [P]
        fn.restype = I
        lib.pt_error_string.argtypes = [I]
        lib.pt_error_string.restype = ctypes.c_char_p
    return lib


def reset_counts() -> None:
    global launches, launches_quant
    launches = launches_quant = 0
    launches_by_shape.clear()


__all__ = ["int8_matmul", "launch_plan", "native_matmul_plain", "quantize_rows_plain"]
