"""Device selection for every entry point of the port.

The port runs on the CUDA device unless the caller asks for the CPU.
Without a GPU and without an explicit ``"cpu"`` it raises: a silent CPU
fallback would report host timings as if they were the card's.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(provider='cpu') to run the port on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def upload(data, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host data (a list or a numpy array) as a tensor on ``device``,
    without waiting for the device. On CUDA the data goes through pinned
    memory with a non-blocking copy: ``torch.tensor(data, device=...)``
    would wait for every kernel queued on the stream, decode chunks in
    flight included. The caching host allocator keeps the pinned block
    until the copy has run."""
    t = torch.as_tensor(np.asarray(data), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
