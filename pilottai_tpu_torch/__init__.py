"""pilottai_tpu_torch: the PyTorch/CUDA port of ``pilottai_tpu``'s engine.

The JAX package beside it stays the reference; this package imports
nothing from it (nor JAX) and keeps its own copy of whatever it needs.
Module paths mirror the JAX package's, so ``pilottai_tpu/engine/decode.py``
has its counterpart at ``pilottai_tpu_torch/engine/decode.py``.

Every TPU kernel on the ported path is a hand-written CUDA kernel for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound through
``ctypes`` (``ops/kernels/``). Entry points run on the CUDA device unless
the caller passes ``device="cpu"`` (or ``provider="cpu"``); without a
GPU and without that request they raise instead of falling back.

    from pilottai_tpu_torch import LLMConfig, LLMHandler

    handler = LLMHandler(LLMConfig(provider="cuda", model_name="protocol-s",
                                   checkpoint_path=PROTOCOL_S_NPZ))
    reply = await handler.generate_response("...", json_mode=True)
"""

from pilottai_tpu_torch.core.config import LLMConfig, SamplingConfig
from pilottai_tpu_torch.engine.handler import LLMHandler
from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ

__all__ = ["LLMConfig", "LLMHandler", "PROTOCOL_S_NPZ", "SamplingConfig"]
