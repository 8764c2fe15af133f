"""Weight-only quantization for serving: int8 and packed int4 (the port's
counterpart of ``pilottai_tpu/models/quant.py``, with its own copy of
the schemes, so that a quantized tree holds the JAX package's bytes).

Decode reads every matmul weight once a step, so storing the weights
below the compute precision shrinks the step's bytes in proportion. The
weights are consumed at one site, ``models/qmatmul.py:qmatmul``: on CUDA
a hand-written kernel reads the int8 or int4 bytes and never writes a
dense copy (``ops/kernels/qmatmul.py``).

Schemes:

* **int8** (``QTensor``): symmetric per output channel over the
  contraction axis (``axis=-2`` of ``[in, out]``).
* **int4** (``Q4Tensor``): symmetric per **group** of ``group``
  contraction rows and output channel, two nibbles per int8 byte along
  the contraction axis. The untied ``lm_head`` falls back to int8 (its
  argmax picks the token), and a MoE router would stay dense.

Norms and the embedding stay in the compute dtype. Serving only: the
trainer refuses quantized leaves (``models/transformer.py:
forward_train``), and the engine quantizes once at start
(``engine/native.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

# fp32 reciprocals of the int8 and int4 ranges (see quantize_array).
_RECIP_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))
_RECIP_7 = float(torch.tensor(1.0 / 7.0, dtype=torch.float32))


@dataclass
class QTensor:
    """int8 weight ``q`` of the weight's shape and its scale ``s [..., 1,
    out]`` in the compute dtype; ``arm`` the product's arm an engine holds
    for it ("native" or "dequant", ``models/qmatmul.py:hold_arm``), None
    where ``PILOTTAI_QMATMUL`` decides at each call."""

    q: torch.Tensor
    s: torch.Tensor
    arm: Optional[str] = None


@dataclass
class Q4Tensor:
    """Packed int4 weight: ``q`` int8 ``[..., ceil(in/2), out]``, byte ``b``
    holding row ``2b`` in its low nibble and row ``2b + 1`` in its high one
    (an odd last row pads with a zero nibble); ``s [..., ceil(in/group),
    out]`` in the compute dtype; ``in_dim`` the true contraction length;
    ``arm`` as ``QTensor``'s."""

    q: torch.Tensor
    s: torch.Tensor
    in_dim: int
    group: int
    arm: Optional[str] = None


def is_quantized(x: Any) -> bool:
    return isinstance(x, (QTensor, Q4Tensor))


def pack_int4(q8: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] into nibbles along ``axis=-2``: ``[..., in,
    out]`` to ``[..., ceil(in/2), out]``, row ``2b`` in the low nibble."""
    if q8.shape[-2] % 2:
        pad = torch.zeros_like(q8[..., :1, :])
        q8 = torch.cat([q8, pad], dim=-2)
    lo = q8[..., 0::2, :]
    hi = q8[..., 1::2, :]
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, in_dim: int) -> torch.Tensor:
    """The inverse of ``pack_int4``: int8 values in [-8, 7], trimmed to
    ``in_dim`` rows. Sign recovery is two arithmetic shifts."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    both = torch.stack([lo, hi], dim=-2)            # [..., P, 2, out]
    shape = packed.shape[:-2] + (2 * packed.shape[-2], packed.shape[-1])
    return both.reshape(shape)[..., :in_dim, :]


def dequant(w: Any) -> torch.Tensor:
    """A ``QTensor`` or ``Q4Tensor`` as a dense weight in the scale's
    dtype (each weight ``q * s`` rounded once to that dtype); a plain
    tensor passes through."""
    if isinstance(w, QTensor):
        return w.q.to(w.s.dtype) * w.s
    if isinstance(w, Q4Tensor):
        q = unpack_int4(w.q, w.in_dim)
        # Per-group scales repeated over their rows (the last group may be
        # short: trimmed after the repeat).
        s = torch.repeat_interleave(w.s, w.group, dim=-2)[..., : w.in_dim, :]
        return q.to(w.s.dtype) * s
    return w


def quantize_array(w: torch.Tensor, dtype: torch.dtype = torch.bfloat16, bits: int = 8,
                   group: int = 128) -> Any:
    """Symmetric weight-only quantization over the contraction axis
    (``axis=-2`` of ``[..., in, out]``): ``bits=8`` per output channel
    (``QTensor``), ``bits=4`` per ``group`` rows and output channel,
    packed (``Q4Tensor``; a short last group's amax runs over its real
    rows only).

    The scales are computed as XLA compiles the JAX function under
    ``jit``, which is how the JAX engine quantizes (``quantize_params`` is
    jitted): the division of the amax by the constant 127 (or 7) becomes a
    multiplication by its fp32 reciprocal, which rounds differently in the
    last bit now and then."""
    wf = w.float()
    if bits == 8:
        amax = wf.abs().amax(dim=-2, keepdim=True)
        scale = amax.clamp_min(1e-8) * _RECIP_127
        q = torch.clamp(torch.round(wf / scale), -127, 127)
        return QTensor(q=q.to(torch.int8), s=scale.to(dtype))
    if bits != 4:
        raise ValueError(f"unsupported weight quantization bits={bits}")
    group = max(1, int(group))
    in_dim = w.shape[-2]
    n_groups = -(-in_dim // group)
    if n_groups * group != in_dim:
        pad = wf.new_zeros(wf.shape[:-2] + (n_groups * group - in_dim, wf.shape[-1]))
        wf = torch.cat([wf, pad], dim=-2)
    grouped = wf.reshape(wf.shape[:-2] + (n_groups, group, wf.shape[-1]))
    amax = grouped.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-8) * _RECIP_7         # [..., G, 1, out]
    q = torch.clamp(torch.round(grouped / scale), -8, 7).to(torch.int8)
    q = q.reshape(wf.shape[:-2] + (n_groups * group, wf.shape[-1]))[..., :in_dim, :]
    return Q4Tensor(q=pack_int4(q), s=scale[..., 0, :].to(dtype), in_dim=in_dim, group=group)


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Dict[str, Any], str, Tuple[str, ...]]]:
    """``(parent dict, key, path)`` of every leaf under ``tree``."""
    for key, value in list(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield tree, key, path + (key,)


def quantize_params(params: Dict[str, Any], dtype: torch.dtype = torch.bfloat16, bits: int = 8,
                    group: int = 128) -> Dict[str, Any]:
    """Quantize every layer matmul weight (the 2-D leaves of
    ``params["layers"]``) and an untied ``lm_head``, **in place**: each
    leaf is replaced as it is quantized and its dense tensor dropped, so
    a start peaks at the dense tree plus one leaf's temporaries. Norms and
    the embedding stay dense. ``bits=4`` packs the layer weights with the
    JAX package's fallbacks: ``lm_head`` int8, a MoE ``router`` dense. An
    int8 leaf re-quantizes to int4 from its dequantized values. Returns
    ``params``."""
    for lp in params["layers"]:
        for parent, key, path in _leaves(lp):
            a = parent[key]
            if bits == 8:
                if is_quantized(a) or "router" in path or a.dim() < 2:
                    continue
                parent[key] = quantize_array(a, dtype)
            else:
                if isinstance(a, Q4Tensor):
                    continue
                if "router" in path:
                    if isinstance(a, QTensor):
                        parent[key] = dequant(a)
                    continue
                if isinstance(a, QTensor):
                    a = dequant(a)
                elif a.dim() < 2:
                    continue
                parent[key] = quantize_array(a, dtype, bits=4, group=group)
            del a
    if "lm_head" in params:
        head = params["lm_head"]
        if isinstance(head, Q4Tensor):
            params["lm_head"] = quantize_array(dequant(head), dtype)
        elif not isinstance(head, QTensor):
            params["lm_head"] = quantize_array(head, dtype)
    return params


def _all_leaves(tree: Any) -> Iterator[Any]:
    """Every leaf of a parameter tree (dicts and lists of layers), a
    quantized weight as one leaf."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _all_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _all_leaves(v)
    else:
        yield tree


def iter_quantized(params: Any) -> Iterator[Any]:
    """Every quantized weight of a parameter tree."""
    return (w for w in _all_leaves(params) if is_quantized(w))


def with_arm(tree: Any, arm: str) -> Any:
    """A copy of a parameter tree (dicts and lists of layers) whose
    quantized weights carry ``arm``; the tensors are shared, the tree's
    containers and the quantized weights' records are new."""
    if isinstance(tree, dict):
        return {k: with_arm(v, arm) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_arm(v, arm) for v in tree)
    return dataclasses.replace(tree, arm=arm) if is_quantized(tree) else tree


def has_quantized(params: Any) -> bool:
    return any(is_quantized(w) for w in _all_leaves(params))


def quant_mode(params: Any) -> Tuple[str, Optional[int]]:
    """``(mode, group)`` of a parameter tree as ``quantize_params`` left
    it: "int4" and the group width where any weight is packed int4 (its
    int8 fallbacks aside), "int8" and None where the quantized weights are
    all int8, "none" and None where none is quantized."""
    mode = "none"
    for w in _all_leaves(params):
        if isinstance(w, Q4Tensor):
            return "int4", w.group
        if isinstance(w, QTensor):
            mode = "int8"
    return mode, None


def _tree_bytes(tree: Any) -> int:
    return sum(w.q.numel() + w.s.numel() * w.s.element_size() if is_quantized(w)
               else w.numel() * w.element_size() for w in _all_leaves(tree))


def weight_stream_bytes(params: Dict[str, Any]) -> Dict[str, int]:
    """Bytes of the parameters: ``total`` resident, and ``per_token``
    read by one decode step — every layer weight, the final norm and the
    unembedding head (an untied ``lm_head``, or the tied embedding, which
    the logits projection reads whole; an untied model's embedding lookup
    reads one row and is not counted)."""
    total = _tree_bytes(params)
    per_token = _tree_bytes({k: v for k, v in params.items() if k != "embed"})
    if "lm_head" not in params and "embed" in params:
        per_token += _tree_bytes(params["embed"])
    return {"total": int(total), "per_token": int(per_token)}


__all__ = [
    "QTensor",
    "Q4Tensor",
    "dequant",
    "has_quantized",
    "is_quantized",
    "iter_quantized",
    "pack_int4",
    "quant_mode",
    "unpack_int4",
    "with_arm",
    "quantize_array",
    "quantize_params",
    "weight_stream_bytes",
]
