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
  contraction in int32, the scales folded in after
  (``ops/kernels/int8_matmul.py``: on CUDA a row quantizer and an s8
  ``mma.sync`` product, hand-written; on the CPU their plain versions
  ``quantize_rows_plain`` and ``native_matmul_plain``, JAX's
  ``_quantize_activation`` and ``_native_int8_matmul``, which equal the JAX
  engine's jitted arm bit for bit). The arm changes the numbers, so it
  stays opt-in.

An engine reads the variable once, when its batcher is built at
``start()`` (``hold_arm``), and serves from a copy of its parameter tree
whose quantized weights carry that arm, so that every chunk graph it
captures and every later call takes that arm whatever the variable says
afterwards, as a JAX ``jit`` traces the choice once; the caller's tree is
left as it was, so two engines over one tree hold their own arms. A weight
with no arm stamped (a call outside an engine) reads the variable at each
call, as the JAX function reads it at each trace.

The einsum-shaped ``spec`` form of the JAX function serves the MoE experts
and comes with them (ROADMAP P9).
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch

from pilottai_tpu_torch.models.common import matmul_f32
from pilottai_tpu_torch.models.quant import Q4Tensor, QTensor, is_quantized, with_arm
from pilottai_tpu_torch.ops.kernels.int8_matmul import int8_matmul
from pilottai_tpu_torch.ops.kernels.qmatmul import quant_matmul


def native_quant_matmul_ok() -> bool:
    """Whether quantized weights take the integer-operand arm:
    ``PILOTTAI_QMATMUL`` decides (``native`` or ``dequant``), as in the JAX
    package, whose default (the TPU only) never holds here."""
    return os.environ.get("PILOTTAI_QMATMUL", "").lower() == "native"


def hold_arm(params: Any) -> Tuple[Any, str]:
    """Read ``PILOTTAI_QMATMUL`` once; returns a copy of ``params`` whose
    quantized weights carry the arm (the tensors shared) and the arm
    ("native" or "dequant")."""
    arm = "native" if native_quant_matmul_ok() else "dequant"
    return with_arm(params, arm), arm


def qmatmul(x: torch.Tensor, w: Any,
            preferred_element_type: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x``'s last axis against ``w``'s first, for a plain, int8 or packed
    int4 weight; ``preferred_element_type=torch.float32`` asks for an fp32
    result on every arm."""
    if is_quantized(w):
        native = w.arm == "native" if w.arm is not None else native_quant_matmul_ok()
        if native:
            return int8_matmul(x, w, preferred_element_type)
        return quant_matmul(x, w, preferred_element_type)
    if preferred_element_type == torch.float32:
        return matmul_f32(x, w)
    return x @ w


__all__ = ["qmatmul", "hold_arm", "native_quant_matmul_ok", "Q4Tensor", "QTensor"]
