"""The weight-only quantized product ``x @ dequant(w)`` for int8
(``QTensor``) and packed int4 (``Q4Tensor``) weights.

Replaces no ``pallas_call`` (``REPLACES = None``): the JAX package's
``models/qmatmul.py`` leaves ``x @ dequant(w)`` to XLA, which fuses the
dequant into the matmul's operand read. On the card a plain PyTorch
``x @ dequant(w)`` would write and read back a dense copy of every weight
every step, so the port computes the product with a kernel of its own,
``csrc/qmatmul.cu``, whose header says what bounds it and what its design
does about it:

* up to ``FUSED_MAX_ROWS`` rows (a decode step, a verify block, a draft
  step): one fused launch that reads the int8 or int4 bytes once and never
  writes a dense weight, its contraction split over the card by
  ``launch_plan`` (bf16: a producer warp and four consumer warps a block;
  fp32: 8 column chunks by 32 contraction lanes a block); the splits'
  partials are summed in a fixed order by the last block of each column
  strip, with int32 arrival counters that this wrapper keeps zeroed per
  device and stream, as K2's does;
* more rows (a prefill): one launch that dequantizes the weight into a
  dense workspace (``torch.empty``, so the caching allocator hands the
  same block back each call), then ``torch.matmul``.

Both paths are capturable: they allocate with ``torch.empty`` only and
read nothing on the host. For a CUDA tensor the wrapper launches its
kernels or raises; for a CPU tensor it runs ``qmatmul_plain``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from pilottai_tpu_torch.models.quant import Q4Tensor, QTensor, dequant

#: Fused-kernel launches since the last reset (``chip_smoke.py`` reads it).
launches = 0
#: Dequant-kernel launches (the prefill rows) since the last reset.
launches_dequant = 0
#: Both kinds of launch by ``(path, M, K, N)``, path "fused" or "dequant".
launches_by_shape: Dict[Tuple[str, int, int, int], int] = {}

SOURCE = "pilottai_tpu_torch/csrc/qmatmul.cu"
#: No TPU kernel: the JAX package leaves this product to XLA's fusion of
#: ``pilottai_tpu/models/quant.py:dequant`` into the matmul's operand read.
REPLACES = None
#: Rows the fused kernel takes; more go through the dequant kernel.
FUSED_MAX_ROWS = 64
COLS = 128   # output columns a block of the fused kernel owns
K_TILE = 64  # contraction rows a tile of the bf16 body
#: A bf16 split's tiles at least: the int4 ring's depth (int8's is six).
MIN_SPLIT_TILES = 4
FP32_ROWS = 4    # rows a block of the fp32 body accumulates
FP32_LANES = 32  # its contraction lanes: q rows a block walks at once
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Per (device index, stream): the int32 arrival counters, one a block of a
# split, zero between launches (the last block resets its own); per
# (device index, dtype, bits, row tiles, scale rows, whole groups): the
# fused kernel's registers a thread and blocks an SM; per device index and
# shapes: the launch plan.
_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}
_info: Dict[Tuple[int, int, int, int, int, bool], Tuple[int, int]] = {}
_plans: Dict[tuple, "Plan"] = {}

Quantized = Union[QTensor, Q4Tensor]


def qmatmul_plain(x: torch.Tensor, w: Quantized,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(w)``: each weight rounded once to the scale's dtype,
    the sums in fp32, the result in ``out_dtype`` (default ``x.dtype``)."""
    out = x.float() @ dequant(w).float()
    return out.to(out_dtype or x.dtype)


class Plan(NamedTuple):
    """One fused launch: ``grid`` blocks, the contraction in ``splits``
    runs of ``per`` (bf16: 64-row tiles; fp32: q rows, a packed int4 row
    holding two), the ring's ``scale_rows`` a stage (bf16 int4),
    ``partials`` fp32 scratch values and ``counters`` arrival counters
    (both 0 with one split)."""

    body: str
    grid: Tuple[int, int, int]
    splits: int
    per: int
    scale_rows: int
    partials: int
    counters: int


def scale_rows(K: int, group: int) -> int:
    """int4 scale rows a 64-row tile can span: tiles start at multiples of
    64, so a tile's first row sits at most ``group - gcd(64, group)`` into
    its group (``csrc/qmatmul.cu:tile_scale_rows``)."""
    return min(-(-K // group), 1 + (group - math.gcd(K_TILE, group) + K_TILE - 1) // group)


def split_count(N: int, K: int, slots: int, min_tiles: int = MIN_SPLIT_TILES,
                max_splits: int = 1 << 30) -> Tuple[int, int]:
    """``(splits, tiles a split)`` of a bf16 contraction: as many blocks as
    the card holds at once (``slots``: blocks an SM holds times the SMs),
    so that none waits for a second wave, each split at least
    ``min_tiles`` 64-row tiles long, at most ``max_splits``, and no split
    empty."""
    strips = -(-N // COLS)
    k_tiles = -(-K // K_TILE)
    want = max(1, min(slots // strips, k_tiles // min_tiles, max_splits))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per


def fp32_split(M: int, K: int, N: int, bits: int, n_sm: int) -> Tuple[int, int, int]:
    """``(row groups, splits, q rows a split)`` of an fp32 launch: about
    one block an SM, each split at least two of the block's steps
    (``FP32_LANES`` q rows each) long, and no split empty."""
    strips, groups = -(-N // COLS), -(-M // FP32_ROWS)
    steps = -(-(K if bits == 8 else -(-K // 2)) // FP32_LANES)
    want = max(1, min(steps // 2, n_sm // (strips * groups)))
    per = -(-steps // want)
    return groups, -(-steps // per), per * FP32_LANES


def launch_plan(M: int, K: int, N: int, bits: int, group: int, fp32: bool, blocks_per_sm: int,
                n_sm: int) -> Plan:
    """The fused launch for these shapes, from the kernel's occupancy
    (``blocks_per_sm``, bf16) and the card's SMs alone."""
    strips = -(-N // COLS)
    if fp32:
        groups, Z, per = fp32_split(M, K, N, bits, n_sm)
        blocks = strips * groups
        return Plan("fp32", (strips, groups, Z), Z, per, 0,
                    Z * blocks * FP32_ROWS * COLS if Z > 1 else 0, blocks if Z > 1 else 0)
    # The splits' fp32 partials (4 Z M N bytes, written and read back) stay
    # under a quarter of the weight's bytes (K N, or K N / 2 for int4).
    Z, per = split_count(N, K, max(1, blocks_per_sm) * n_sm, MIN_SPLIT_TILES,
                         K // (16 * M * (2 if bits == 4 else 1)))
    return Plan("bf16", (strips, Z, 1), Z, per, scale_rows(K, group) if bits == 4 else 0,
                Z * strips * M * COLS if Z > 1 else 0, strips if Z > 1 else 0)


def kernel_info(dtype: torch.dtype, bits: int, M: int, K: int, group: int,
                device: torch.device) -> Tuple[int, int]:
    """``(registers a thread, blocks an SM)`` of the fused kernel that
    ``M`` rows of ``dtype`` launch (bf16: with the ring this ``K`` and
    ``group`` give)."""
    from pilottai_tpu_torch.ops.kernels.build import load_library

    dev = torch.device(device)
    sr = scale_rows(K, group) if bits == 4 and dtype == torch.bfloat16 else 0
    key = (dev.index, _DTYPES[dtype], bits, -(-M // 16), sr, group % K_TILE == 0)
    if key not in _info:
        lib = _bind(load_library("qmatmul"))
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        status = lib.pt_qmatmul_info(_DTYPES[dtype], bits, M, K, group, ctypes.byref(regs),
                                     ctypes.byref(blocks))
        if status != 0:
            raise RuntimeError(f"qmatmul occupancy query failed: "
                               f"{lib.pt_error_string(status).decode()}")
        _info[key] = (regs.value, blocks.value)
    return _info[key]


def plan_for(M: int, K: int, N: int, bits: int, group: int, dtype: torch.dtype,
             device: torch.device) -> Plan:
    """The plan of a fused launch of these shapes on this card."""
    dev = torch.device(device)
    key = (dev.index, M, K, N, bits, group, dtype)
    if key not in _plans:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        fp32 = dtype == torch.float32
        blocks = 0 if fp32 else kernel_info(dtype, bits, M, K, group, dev)[1]
        _plans[key] = launch_plan(M, K, N, bits, group, fp32, blocks, n_sm)
    return _plans[key]


def _layout(w: Quantized) -> Tuple[int, int, int, int]:
    """``(bits, K, group, scale rows)`` of a quantized weight, checked."""
    if isinstance(w, QTensor):
        bits, K, group, G = 8, w.q.shape[0], w.q.shape[0], 1
        q_rows = K
    elif isinstance(w, Q4Tensor):
        bits, K, group = 4, w.in_dim, w.group
        G, q_rows = -(-K // group), -(-K // 2)
    else:
        raise TypeError(f"quant_matmul: {type(w).__name__} is not a QTensor or Q4Tensor")
    if (w.q.dtype != torch.int8 or w.q.dim() != 2 or w.s.dim() != 2 or w.q.shape[0] != q_rows
            or tuple(w.s.shape) != (G, w.q.shape[1]) or w.q.stride(1) != 1
            or w.s.stride(1) != 1):
        raise ValueError(f"quant_matmul: unsupported weight q {tuple(w.q.shape)} {w.q.dtype} "
                         f"s {tuple(w.s.shape)} (2-D, columns contiguous)")
    return bits, K, group, G


def quant_matmul(x: torch.Tensor, w: Quantized,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ w`` for a quantized ``w [K, N]``, in ``out_dtype``
    (``x.dtype`` or float32; default ``x.dtype``)."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, w, out_dtype)
    return _launch(x, w, out_dtype)


def _launch(x, w, out_dtype):
    global launches, launches_dequant
    if x.device.type != "cuda" or w.q.device != x.device or w.s.device != x.device:
        raise ValueError(f"quant_matmul: unsupported devices x {x.device} q {w.q.device} "
                         f"s {w.s.device}")
    bits, K, group, G = _layout(w)
    if x.dtype not in _DTYPES or w.s.dtype != x.dtype:
        raise TypeError(f"quant_matmul: x and the scales must share float32 or bfloat16, got "
                        f"{x.dtype}/{w.s.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"quant_matmul: result dtype {out_dtype} for {x.dtype} inputs")
    if x.shape[-1] != K:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} against a weight of {K} rows")
    N = w.q.shape[1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream

    from pilottai_tpu_torch.ops.kernels.build import load_library

    lib = _bind(load_library("qmatmul"))
    args = (w.q.data_ptr(), w.s.data_ptr())
    strides = (w.q.stride(0), w.s.stride(0), group, G)
    if M > FUSED_MAX_ROWS:
        dense = torch.empty((K, N), device=dev, dtype=x.dtype)
        status = lib.pt_qdequant(_DTYPES[x.dtype], bits, *args, dense.data_ptr(), K, N, *strides,
                                 stream)
        if status != 0:
            raise RuntimeError(f"qmatmul dequant launch failed: "
                               f"{lib.pt_error_string(status).decode()}")
        launches_dequant += 1
        _count("dequant", M, K, N)
        if out_dtype == x.dtype:
            out = torch.matmul(x2, dense)
        else:
            out = torch.mm(x2, dense, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], N)
    out = torch.empty((M, N), device=dev, dtype=out_dtype)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    plan = plan_for(M, K, N, bits, group, x.dtype, dev)
    part = arrivals = None
    if plan.splits > 1:
        part = torch.empty(plan.partials, device=dev, dtype=torch.float32)
        arrivals = _arrivals.get((dev.index, stream))
        if arrivals is None or arrivals.numel() < plan.counters:
            arrivals = torch.zeros(max(plan.counters, 1024), device=dev, dtype=torch.int32)
            _arrivals[(dev.index, stream)] = arrivals
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = lib.pt_qmatmul(
        _DTYPES[x.dtype], bits, int(out_dtype == torch.float32), x2.data_ptr(), *args,
        out.data_ptr(), ptr(part), ptr(arrivals), M, K, N, *strides, plan.per, plan.splits,
        stream,
    )
    if status != 0:
        raise RuntimeError(f"qmatmul launch failed: {lib.pt_error_string(status).decode()}")
    launches += 1
    _count("fused", M, K, N)
    return out.reshape(*x.shape[:-1], N)


def _count(path: str, M: int, K: int, N: int) -> None:
    key = (path, M, K, N)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.pt_qmatmul
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, I] + [P] * 6 + [I] * 9 + [P]
        fn.restype = I
        lib.pt_qdequant.argtypes = [I, I, P, P, P] + [I] * 6 + [P]
        lib.pt_qdequant.restype = I
        lib.pt_qmatmul_info.argtypes = [I] * 5 + [ctypes.POINTER(I)] * 2
        lib.pt_qmatmul_info.restype = I
        lib.pt_error_string.argtypes = [I]
        lib.pt_error_string.restype = ctypes.c_char_p
    return lib
