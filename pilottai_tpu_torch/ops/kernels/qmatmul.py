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
  writes a dense weight; its split-K partials are summed in split order by
  the last block of each column strip, with int32 arrival counters that
  this wrapper keeps zeroed per device and stream, as K2's does;
* more rows (a prefill): one launch that dequantizes the weight into a
  dense workspace (``torch.empty``, so the caching allocator hands the
  same block back each call), then ``torch.matmul``.

Both paths are capturable: they allocate with ``torch.empty`` only and
read nothing on the host. For a CUDA tensor the wrapper launches its
kernels or raises; for a CPU tensor it runs ``qmatmul_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

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
K_TILE = 64  # contraction rows a tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Per (device index, stream): the int32 arrival counters of the column
# strips, zero between launches (the last block of a strip resets its own);
# per (device index, bits, row tiles): the fused kernel's blocks the card
# holds at once.
_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}
_slots: Dict[Tuple[int, int, int], int] = {}

Quantized = Union[QTensor, Q4Tensor]


def qmatmul_plain(x: torch.Tensor, w: Quantized,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(w)``: each weight rounded once to the scale's dtype,
    the sums in fp32, the result in ``out_dtype`` (default ``x.dtype``)."""
    out = x.float() @ dequant(w).float()
    return out.to(out_dtype or x.dtype)


def split_count(N: int, K: int, slots: int) -> Tuple[int, int]:
    """``(splits, tiles a split)`` of the contraction: as many blocks as the
    card holds at once (``slots``: blocks an SM holds times the SMs), so
    that none waits for a second wave, each split at least two 64-row
    tiles long, and no split empty."""
    strips = -(-N // COLS)
    k_tiles = -(-K // K_TILE)
    want = max(1, min(slots // strips, k_tiles // 2))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per


def _card_slots(lib, dev: torch.device, bits: int, M: int) -> int:
    """Blocks of the fused bf16 kernel the card holds at once for M rows."""
    key = (dev.index, bits, -(-M // 16))
    if key not in _slots:
        blocks = ctypes.c_int(0)
        status = lib.pt_qmatmul_blocks_per_sm(bits, M, ctypes.byref(blocks))
        if status != 0:
            raise RuntimeError(f"qmatmul occupancy query failed: "
                               f"{lib.pt_error_string(status).decode()}")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        _slots[key] = max(1, blocks.value) * n_sm
    return _slots[key]


def fused_splits(M: int, K: int, N: int, bits: int, device: torch.device) -> Tuple[int, int]:
    """``(splits, tiles a split)`` of a bf16 fused launch of these shapes."""
    from pilottai_tpu_torch.ops.kernels.build import load_library

    lib = _bind(load_library("qmatmul"))
    return split_count(N, K, _card_slots(lib, torch.device(device), bits, M))


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
    k_tiles = -(-K // K_TILE)
    Z, per = 1, k_tiles
    part = arrivals = None
    if x.dtype == torch.bfloat16:
        Z, per = fused_splits(M, K, N, bits, dev)
    if Z > 1:
        part = torch.empty(Z * M * N, device=dev, dtype=torch.float32)
        strips = -(-N // COLS)
        arrivals = _arrivals.get((dev.index, stream))
        if arrivals is None or arrivals.numel() < strips:
            arrivals = torch.zeros(max(strips, 1024), device=dev, dtype=torch.int32)
            _arrivals[(dev.index, stream)] = arrivals
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = lib.pt_qmatmul(
        _DTYPES[x.dtype], bits, int(out_dtype == torch.float32), x2.data_ptr(), *args,
        out.data_ptr(), ptr(part), ptr(arrivals), M, K, N, *strides, per, Z, stream,
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
        lib.pt_qmatmul_blocks_per_sm.argtypes = [I, I, ctypes.POINTER(I)]
        lib.pt_qmatmul_blocks_per_sm.restype = I
        lib.pt_error_string.argtypes = [I]
        lib.pt_error_string.restype = ctypes.c_char_p
    return lib
