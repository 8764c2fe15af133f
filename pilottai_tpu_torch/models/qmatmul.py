"""The one site every weight matmul of the model calls (the port's
counterpart of ``pilottai_tpu/models/qmatmul.py``).

* A plain weight keeps ``torch.matmul`` (``matmul_f32`` when the caller
  asks for an fp32 result, as the logits head does).
* A ``QTensor`` or ``Q4Tensor`` takes the fused-dequant arm,
  ``x @ dequant(w)``: on CUDA the hand-written kernel of
  ``ops/kernels/qmatmul.py``, which reads the int8 or int4 bytes once; on
  the CPU its plain version. This is JAX's arm on every platform but the
  TPU, and the port's default.
* ``PILOTTAI_QMATMUL=native`` selects the integer-operand arm, as it does in
  the JAX package: the activation quantized per row to int8, the
  contraction in int32, the scales folded in after. On the CPU it runs in
  plain PyTorch, so that it can be held to JAX's arm; on CUDA it raises,
  naming ROADMAP item P5c (that arm on the card's int8 tensor cores).
  Nothing falls back quietly.

The einsum-shaped ``spec`` form of the JAX function serves the MoE experts
and comes with them (ROADMAP P9).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from pilottai_tpu_torch.models.common import matmul_f32
from pilottai_tpu_torch.models.quant import Q4Tensor, QTensor, is_quantized, unpack_int4
from pilottai_tpu_torch.ops.kernels.qmatmul import quant_matmul

NATIVE_ITEM = "P5c (the integer-operand quantized matmul on the card's int8 tensor cores)"


def native_quant_matmul_ok() -> bool:
    """Whether quantized weights take the integer-operand arm:
    ``PILOTTAI_QMATMUL`` decides (``native`` or ``dequant``), as in the JAX
    package, whose default (the TPU only) never holds here."""
    return os.environ.get("PILOTTAI_QMATMUL", "").lower() == "native"


def _quantize_activation(x: torch.Tensor):
    """Dynamic symmetric per-row int8: ``(xq int8, sx fp32 [..., 1])``."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def _native_int8_matmul(x: torch.Tensor, w: Any,
                        preferred_element_type: Optional[torch.dtype]) -> torch.Tensor:
    """The integer-operand contraction in plain PyTorch: int8 activation by
    int8 weight into int32, scales folded in after (per output channel, or
    per contraction group for int4, each group's int32 partial scaled
    before the sum over groups)."""
    out_dtype = preferred_element_type or x.dtype
    xq, sx = _quantize_activation(x)
    if isinstance(w, QTensor):
        acc = xq.to(torch.int32) @ w.q.to(torch.int32)
        out = acc.float() * sx * w.s[0].float()
        return out.to(out_dtype)
    in_dim, group = w.in_dim, w.group
    n_groups = w.s.shape[-2]
    wq = unpack_int4(w.q, in_dim).to(torch.int32)          # [in, out]
    xi = xq.to(torch.int32)
    pad = n_groups * group - in_dim
    if pad:
        wq = torch.cat([wq, wq.new_zeros((pad, wq.shape[-1]))], dim=0)
        xi = torch.cat([xi, xi.new_zeros(xi.shape[:-1] + (pad,))], dim=-1)
    acc = torch.einsum("...gi,gio->...go", xi.reshape(xi.shape[:-1] + (n_groups, group)),
                       wq.reshape(n_groups, group, wq.shape[-1]))
    out = (acc.float() * w.s.float()).sum(dim=-2) * sx
    return out.to(out_dtype)


def qmatmul(x: torch.Tensor, w: Any,
            preferred_element_type: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x``'s last axis against ``w``'s first, for a plain, int8 or packed
    int4 weight; ``preferred_element_type=torch.float32`` asks for an fp32
    result on every arm."""
    if is_quantized(w):
        if native_quant_matmul_ok():
            if x.is_cuda:
                raise NotImplementedError(
                    "PILOTTAI_QMATMUL=native: the integer-operand arm is not on the card yet; "
                    f"it arrives with ROADMAP item {NATIVE_ITEM}"
                )
            return _native_int8_matmul(x, w, preferred_element_type)
        return quant_matmul(x, w, preferred_element_type)
    if preferred_element_type == torch.float32:
        return matmul_f32(x, w)
    return x @ w


__all__ = ["qmatmul", "native_quant_matmul_ok", "Q4Tensor", "QTensor"]
