"""Model configuration, parameter init, RMSNorm and RoPE — the port's
counterpart of ``pilottai_tpu/models/common.py`` for the llama and Gemma
families.

Parameters are a plain nested dict mirroring the JAX tree, except that
the stacked ``layers/…`` leaves (leading L axis, for ``lax.scan``)
become a list of per-layer dicts: PyTorch runs the layers as a Python
loop, and per-layer tensors let each layer's weights be made, moved and
freed on their own. Matmul weights keep the JAX ``[in, out]`` layout,
so ``x @ w`` needs no transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pilottai_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny-test"
    family: str = "llama"
    vocab_size: int = 512
    hidden_size: int = 256
    n_layers: int = 4
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 512
    max_seq_len: int = 2048
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = True
    # Family behaviours, explicit fields as in the JAX config.
    act: str = "silu"              # "silu" (llama) | "gelu_tanh" (gemma)
    scale_embed: bool = False      # gemma: x *= sqrt(hidden)
    rms_offset: bool = False       # gemma: scale = (1 + w)
    post_norms: bool = False       # gemma2: post-attention and post-MLP norms
    # Attention options the kernels implement (0 = off for llama).
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    sliding_window: int = 0
    sliding_pattern: int = 0
    query_scale: Optional[float] = None  # default head_dim**-0.5

    dtype: torch.dtype = torch.bfloat16

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def qscale(self) -> float:
        return self.query_scale if self.query_scale is not None else self.head_dim**-0.5

    def window_sizes(self) -> np.ndarray:
        """Per-layer sliding-window sizes; 0 = global attention."""
        if self.sliding_window <= 0 or self.sliding_pattern <= 0:
            return np.zeros((self.n_layers,), dtype=np.int32)
        out = np.full((self.n_layers,), self.sliding_window, dtype=np.int32)
        out[self.sliding_pattern - 1 :: self.sliding_pattern] = 0
        return out

    def replace(self, **kwargs: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kwargs)

    def param_count(self) -> int:
        E, F, V, L = self.hidden_size, self.intermediate_size, self.vocab_size, self.n_layers
        per_layer = (
            E * self.q_dim + 2 * E * self.kv_dim + self.q_dim * E  # attn
            + 3 * E * F                                             # gated MLP
            + 2 * E + (2 * E if self.post_norms else 0)             # norms
        )
        head = 0 if self.tie_embeddings else E * V
        return V * E + L * per_layer + E + head


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Random-init parameters with the JAX init's scaling: every matmul
    weight is ``N(0, 1) * fan_in**-0.5`` (the embedding ``N(0, 1)``), norm
    scales are ones, or zeros where the config's RMSNorm adds 1 to its
    scale (Gemma's ``rms_offset``). Each leaf is drawn in float32 on
    ``device`` from ``generator`` (which must live on that device) and
    cast, one leaf at a time, so an 8B bf16 init peaks at the tree plus
    one fp32 leaf."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def normal(shape: Tuple[int, ...], fan_in: float) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * fan_in**-0.5).to(dtype)

    fill = torch.zeros if cfg.rms_offset else torch.ones

    def norm(n: int) -> Dict[str, torch.Tensor]:
        return {"scale": fill((n,), device=device, dtype=dtype)}

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": norm(E),
            "ln2": norm(E),
            "attn": {
                "wq": normal((E, cfg.q_dim), E),
                "wk": normal((E, cfg.kv_dim), E),
                "wv": normal((E, cfg.kv_dim), E),
                "wo": normal((cfg.q_dim, E), cfg.q_dim),
            },
            "mlp": {
                "wg": normal((E, F), E),
                "wu": normal((E, F), E),
                "wd": normal((F, E), F),
            },
        })
        if cfg.post_norms:
            layers[-1]["ln1_post"] = norm(E)
            layers[-1]["ln2_post"] = norm(E)
    params: Dict[str, Any] = {
        "embed": normal((V, E), 1.0),
        "layers": layers,
        "final_norm": norm(E),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((E, V), E)
    return params


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result, which the JAX package asks for with
    ``preferred_element_type=jnp.float32``. bf16 operands on CUDA stay bf16
    and run on the tensor cores through the ``out_dtype`` overloads of
    ``torch.mm`` and ``torch.bmm`` (a torch without them raises); anywhere
    else the operands are cast to fp32, where every bf16 product is exact,
    so only the order of summation differs. ``a [..., m, k]`` against a 2-D
    ``b [k, n]``, or against ``b [..., k, n]`` with the same batch dims."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        if b.dim() == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    """RMSNorm with fp32 statistics; the result is cast back to x's dtype.
    With ``offset`` (Gemma) the scale is ``1 + w``, added in fp32."""
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    s = scale.float()
    if offset:
        s = s + 1.0
    return (normed * s).to(x.dtype)


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables for rotate-half RoPE: positions [B, T] → [B, T, H/2]
    fp32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # A fill, not torch.tensor(theta, device=...): that host copy would wait
    # for the stream, which a captured decode chunk must never do.
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(base, exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE: x [B, T, N, H], sin/cos [B, T, H/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
