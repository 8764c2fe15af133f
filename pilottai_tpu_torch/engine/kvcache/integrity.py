"""KV integrity framing: a checksum and a layout header on every host-tier
entry and every exported entry (the port's own copy of
``pilottai_tpu/engine/kvcache/integrity.py``).

A bit flipped in host RAM between spill and restore, or a damaged
migration frame, would otherwise restore as wrong K/V and decode wrong
tokens with no fault anywhere. So every entry carries a frame:

* a **CRC-32** over the raw K/V bytes, sealed when the bytes become
  host-resident (the spill's first materialization, or the export's pack)
  and checked again at every consumption (restore, import);
* a **layout header** (``v``, ``kind``, each array's dtype and shape; the
  dtype doubles as the quantization mode) checked before any byte is
  read, so a version or layout mismatch is refused instead of reshaped.

A failed check is a contained fault: the consumer drops the entry, counts
``engine.kvcache.integrity_failures`` and prefills instead. Checksums
guard against rot and truncation; they are not authentication.

Host payloads are numpy arrays or CPU tensors. The card's Python has no
``ml_dtypes``, so numpy has no bfloat16 there and the port keeps a bf16
payload as a CPU tensor: its dtype string is ``"bfloat16"`` and the CRC
runs over the same raw bytes a numpy bfloat16 array of the JAX package
holds.
"""

from __future__ import annotations

import functools
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

KV_FRAME_VERSION = 1

#: Bytes a CRC task covers: arrays of two chunks or more in all are checked
#: in parallel chunks whose CRCs are combined in order, which gives zlib's
#: CRC-32 of the whole bytes (a llama3-8b entry is over 100 MB, a page of it
#: 16 MiB).
CRC_CHUNK = 2 << 20

_TORCH_NAMES = {
    torch.float32: "float32", torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.uint8: "uint8", torch.int32: "int32", torch.int64: "int64",
}


def dtype_name(a: Any) -> str:
    """The dtype string of an array or tensor, as numpy spells it."""
    if isinstance(a, torch.Tensor) or isinstance(getattr(a, "dtype", None), torch.dtype):
        return _TORCH_NAMES.get(a.dtype, str(a.dtype).replace("torch.", ""))
    return str(np.dtype(a.dtype))


def _byte_view(a: Any) -> np.ndarray:
    """Flat uint8 view of an array's raw bytes (a copy only where the
    buffer cannot be reinterpreted in place)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy() if t.numel() else np.zeros((0,), np.uint8)
    b = np.ascontiguousarray(np.asarray(a))
    try:
        return b.view(np.uint8).reshape(-1)
    except (TypeError, ValueError):
        return np.frombuffer(b.tobytes(), np.uint8)


def _mat_vec(mat: List[int], vec: int) -> int:
    """A 32 x 32 matrix over GF(2) (``mat[n]``: column n) times a vector."""
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _mat_mul(a: List[int], b: List[int]) -> List[int]:
    return [_mat_vec(a, col) for col in b]


@functools.lru_cache(maxsize=64)
def _zeros_op(nbytes: int) -> List[int]:
    """The operator that advances a CRC-32 over ``nbytes`` zero bytes
    (zlib's ``crc32_combine`` algebra)."""
    op = [0xEDB88320] + [1 << n for n in range(31)]     # one zero bit
    for _ in range(3):
        op = _mat_mul(op, op)                           # one zero byte
    out = [1 << n for n in range(32)]
    while nbytes:
        if nbytes & 1:
            out = _mat_mul(op, out)
        op = _mat_mul(op, op)
        nbytes >>= 1
    return out


def kv_checksum(arrays: Sequence[Any], crc: int = 0) -> int:
    """CRC-32 over the concatenated raw bytes of host arrays (zlib's, as
    the JAX package computes it; large ones in parallel chunks)."""
    views = [_byte_view(a) for a in arrays]
    if sum(v.size for v in views) < 2 * CRC_CHUNK:
        for v in views:
            crc = zlib.crc32(v, crc)
        return crc & 0xFFFFFFFF
    pieces = [v[i: i + CRC_CHUNK] for v in views for i in range(0, v.size, CRC_CHUNK)]
    # zlib.crc32 releases the interpreter lock on buffers this large.
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(zlib.crc32, pieces))
    for piece, part in zip(pieces, parts):
        crc = _mat_vec(_zeros_op(piece.size), crc) ^ part
    return crc & 0xFFFFFFFF


def entry_header(arrays: Sequence[Any], kind: str) -> Dict[str, Any]:
    """Layout, quantization and version header of one entry's K/V arrays.
    Reads only dtype and shape, so it is safe on device tensors before
    their copy has landed."""
    return {
        "v": KV_FRAME_VERSION,
        "kind": kind,
        "dtype": [dtype_name(a) for a in arrays],
        "shape": [tuple(int(d) for d in a.shape) for a in arrays],
    }


def header_matches(header: Optional[Dict[str, Any]], arrays: Sequence[Any]) -> bool:
    """Does a sealed header describe these host arrays? False on an
    unknown version, a header without dtypes or shapes, or any dtype or
    shape drift: the caller refuses the entry before reading a byte."""
    if not isinstance(header, dict):
        return False
    if header.get("v") != KV_FRAME_VERSION:
        return False
    dtypes = header.get("dtype")
    shapes = header.get("shape")
    if not isinstance(dtypes, (list, tuple)) or len(dtypes) != len(arrays):
        return False
    if not isinstance(shapes, (list, tuple)) or len(shapes) != len(arrays):
        return False
    for a, dt, sh in zip(arrays, dtypes, shapes):
        if dtype_name(a) != dt:
            return False
        if tuple(int(d) for d in a.shape) != tuple(int(d) for d in sh):
            return False
    return True


def frame_ok(entry: Dict[str, Any], arrays: Sequence[Any]) -> bool:
    """The full check of one sealed export entry: the CRC over the raw
    bytes, then the layout header. Every import runs it before a byte of
    the payload is read."""
    crc = entry.get("crc")
    if crc is None or kv_checksum(arrays) != int(crc):
        return False
    return header_matches(entry.get("header"), arrays)


def corrupt_arrays(arrays: Sequence[Any]) -> None:
    """Fault injection: flip one byte of the first non-empty contiguous
    array in place (the ``kvcache.*.corrupt`` fault points' rot)."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.numel() == 0 or not a.is_contiguous():
                continue
            flat = a.view(-1).view(torch.uint8)
            flat[0] ^= 0xFF
            return
        a = np.asarray(a)
        if a.size == 0 or not a.flags["C_CONTIGUOUS"]:
            continue
        a.view(np.uint8).reshape(-1)[0] ^= 0xFF
        return


__all__ = [
    "KV_FRAME_VERSION",
    "corrupt_arrays",
    "dtype_name",
    "entry_header",
    "frame_ok",
    "header_matches",
    "kv_checksum",
]
