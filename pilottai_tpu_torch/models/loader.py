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

Quantized leaves (``models/quant.py``) travel as the fields of the JAX
package's ``QTensor`` and ``Q4Tensor`` under the leaf's path:
``<path>/q`` (int8, kept as it is) and ``<path>/s`` (the scales, cast to
the serving dtype), stacked on the L axis under ``layers/``, and for int4
also ``<path>/in_dim`` and ``<path>/group`` (scalars: JAX's static
fields, the same for every layer).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from pilottai_tpu_torch.device import DeviceLike, resolve_device
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.models.quant import Q4Tensor, QTensor, is_quantized

ASSETS = Path(__file__).resolve().parent.parent / "assets"
PROTOCOL_S_NPZ = str(ASSETS / "protocol_s.npz")
_QFIELDS = ("q", "s", "in_dim", "group")


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


def _gather_quantized(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``<path>/q``, ``<path>/s`` (and ``in_dim``, ``group``) as one dict
    leaf at ``<path>``, as is a JAX ``QTensor`` or ``Q4Tensor`` (its
    fields read as numpy); every other leaf as it is."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        if hasattr(leaf, "q") and hasattr(leaf, "s"):
            out[key] = {f: getattr(leaf, f) for f in _QFIELDS if hasattr(leaf, f)}
            continue
        head, _, field = key.rpartition("/")
        if field in _QFIELDS and f"{head}/q" in flat and f"{head}/s" in flat:
            out.setdefault(head, {})[field] = leaf
        else:
            out[key] = leaf
    return out


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
    flat = _gather_quantized(flat)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(_to_float32(a))).to(device=device, dtype=dtype)

    def leaf_at(leaf, l=None):
        """The leaf, or layer ``l`` of a stacked one."""
        if isinstance(leaf, dict):
            q, s = np.asarray(leaf["q"]), np.asarray(leaf["s"])
            if l is not None:
                q, s = q[l], s[l]
            q = torch.from_numpy(np.ascontiguousarray(q.astype(np.int8, copy=False))).to(device)
            if "in_dim" in leaf:
                return Q4Tensor(q=q, s=tensor(s), in_dim=int(leaf["in_dim"]),
                                group=int(leaf["group"]))
            return QTensor(q=q, s=tensor(s))
        return tensor(leaf if l is None else leaf[l])

    layers = [{} for _ in range(cfg.n_layers)]
    params: Dict[str, Any] = {"layers": layers}
    for key, leaf in flat.items():
        parts = key.split("/")
        if parts[0] == "layers":
            stacked = leaf if isinstance(leaf, dict) else _to_float32(leaf)
            n = np.shape(leaf["q"] if isinstance(leaf, dict) else stacked)[0]
            if n != cfg.n_layers:
                raise ValueError(f"{key}: {n} layers, config has {cfg.n_layers}")
            for l in range(cfg.n_layers):
                node = layers[l]
                for p in parts[1:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = leaf_at(stacked, l)
        else:
            node = params
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf_at(leaf)
    embed = params["embed"]
    if tuple(embed.shape) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(f"embed {tuple(embed.shape)} does not match {cfg.name}")
    return params


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The reverse of ``params_from_numpy``: the port's parameters as the
    flat JAX-layout tree (``/``-joined keys, ``layers/…`` leaves stacked on
    a leading L axis), bfloat16 leaves as their ``uint16`` bit patterns —
    what ``load_npz`` reads back from ``np.savez``. A quantized leaf writes
    its fields under its path."""
    flat: Dict[str, np.ndarray] = {}

    def array(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    def put(key: str, leaves: List[Any], stacked: bool) -> None:
        first = leaves[0]
        if is_quantized(first):
            put(f"{key}/q", [w.q for w in leaves], stacked)
            put(f"{key}/s", [w.s for w in leaves], stacked)
            if isinstance(first, Q4Tensor):
                flat[f"{key}/in_dim"] = np.asarray(first.in_dim)
                flat[f"{key}/group"] = np.asarray(first.group)
        else:
            flat[key] = array(torch.stack([t.detach() for t in leaves]) if stacked else first)

    for key, leaf in _flatten({k: v for k, v in params.items() if k != "layers"}).items():
        put(key, [leaf], stacked=False)
    per_layer = [_flatten(lp) for lp in params["layers"]]
    for key in per_layer[0]:
        put(f"layers/{key}", [f[key] for f in per_layer], stacked=True)
    return flat


def load_npz(
    path: str | Path,
    cfg: ModelConfig,
    device: DeviceLike = None,
    dtype: torch.dtype | None = None,
    scale: Mapping[str, float] | None = None,
) -> Dict[str, Any]:
    """Load a flat ``.npz`` checkpoint (``layers/attn/wq`` … keys); each
    leaf named in ``scale`` is multiplied by its factor in float32 first."""
    scale = scale or {}
    with np.load(path) as data:
        flat = {k: data[k] * np.float32(scale[k]) if k in scale else data[k] for k in data.files}
    return params_from_numpy(flat, cfg, device=device, dtype=dtype)
