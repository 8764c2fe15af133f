"""Weight bridge: the JAX parameter tree (numpy leaves) → the port's
parameters and back, and the loader for ``.npz`` checkpoints (the shipped
protocol-s one and those ``train/protocol.py`` writes).

The JAX tree stacks every ``layers/…`` leaf on a leading L axis and lays
matmul weights out ``[in, out]``; the port keeps ``[in, out]`` and splits
the L axis into a list of per-layer dicts (``models/common.py``).
bfloat16 leaves arrive either as numpy's ``bfloat16`` extension dtype
(``np.asarray`` of a JAX array) or as raw ``uint16`` bit patterns (the
``.npz`` written by ``scripts/export_protocol_s_npz.py``); both widen to
float32 exactly before the cast to the serving dtype.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from pilottai_tpu_torch.device import DeviceLike, resolve_device
from pilottai_tpu_torch.models.common import ModelConfig

ASSETS = Path(__file__).resolve().parent.parent / "assets"
PROTOCOL_S_NPZ = str(ASSETS / "protocol_s.npz")


def _to_float32(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype == np.uint16:  # bfloat16 bit patterns
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def params_from_numpy(
    tree: Mapping[str, Any],
    cfg: ModelConfig,
    device: DeviceLike = None,
    dtype: torch.dtype | None = None,
) -> Dict[str, Any]:
    """Convert a JAX-layout parameter tree — nested (``{"layers":
    {"attn": {"wq": [L, E, Q]}}}``) or flat with ``/``-joined keys — into
    the port's parameters on ``device`` in ``dtype``."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    flat = _flatten(tree) if any(isinstance(v, Mapping) for v in tree.values()) else dict(tree)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(_to_float32(a))).to(device=device, dtype=dtype)

    layers = [{} for _ in range(cfg.n_layers)]
    params: Dict[str, Any] = {"layers": layers}
    for key, leaf in flat.items():
        parts = key.split("/")
        if parts[0] == "layers":
            stacked = _to_float32(leaf)
            if stacked.shape[0] != cfg.n_layers:
                raise ValueError(f"{key}: {stacked.shape[0]} layers, config has {cfg.n_layers}")
            for l in range(cfg.n_layers):
                node = layers[l]
                for p in parts[1:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = tensor(stacked[l])
        else:
            node = params
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = tensor(leaf)
    embed = params["embed"]
    if tuple(embed.shape) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(f"embed {tuple(embed.shape)} does not match {cfg.name}")
    return params


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The reverse of ``params_from_numpy``: the port's parameters as the
    flat JAX-layout tree (``/``-joined keys, ``layers/…`` leaves stacked on
    a leading L axis), bfloat16 leaves as their ``uint16`` bit patterns —
    what ``load_npz`` reads back from ``np.savez``."""
    flat: Dict[str, np.ndarray] = {}

    def array(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    for key, leaf in _flatten({k: v for k, v in params.items() if k != "layers"}).items():
        flat[key] = array(leaf)
    layers = params["layers"]
    for key in _flatten(layers[0]):
        stacked = torch.stack([_flatten(lp)[key].detach() for lp in layers])
        flat[f"layers/{key}"] = array(stacked)
    return flat


def load_npz(
    path: str | Path,
    cfg: ModelConfig,
    device: DeviceLike = None,
    dtype: torch.dtype | None = None,
) -> Dict[str, Any]:
    """Load a flat ``.npz`` checkpoint (``layers/attn/wq`` … keys)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, cfg, device=device, dtype=dtype)
