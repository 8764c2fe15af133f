"""Gemma family configurations (the port's copy of
``pilottai_tpu/models/gemma.py``).

Gemma-1: GeGLU MLP, embedding scaled by sqrt(hidden), RMSNorm with a +1
offset, tied embeddings, head_dim 256. Gemma-2 adds logit and attention
soft-caps, post-attention and post-MLP norms and alternating
sliding-window and global attention.
"""

from pilottai_tpu_torch.models.common import ModelConfig

GEMMA_2B = ModelConfig(
    name="gemma-2b",
    family="gemma",
    vocab_size=256_128,
    hidden_size=2048,
    n_layers=18,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    intermediate_size=16_384,
    max_seq_len=8192,
    rope_theta=10_000.0,
    rms_eps=1e-6,
    tie_embeddings=True,
    act="gelu_tanh",
    scale_embed=True,
    rms_offset=True,
)

GEMMA2_2B = ModelConfig(
    name="gemma2-2b",
    family="gemma2",
    vocab_size=256_128,
    hidden_size=2304,
    n_layers=26,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    intermediate_size=9216,
    max_seq_len=8192,
    rope_theta=10_000.0,
    rms_eps=1e-6,
    tie_embeddings=True,
    act="gelu_tanh",
    scale_embed=True,
    rms_offset=True,
    post_norms=True,
    logit_softcap=30.0,
    attn_softcap=50.0,
    sliding_window=4096,
    sliding_pattern=2,
    query_scale=256.0**-0.5,
)

GEMMA_2B_BYTE = GEMMA_2B.replace(name="gemma-2b-byte", vocab_size=512)

GEMMA_TINY = ModelConfig(
    name="gemma-tiny",
    family="gemma2",
    vocab_size=512,
    hidden_size=128,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    intermediate_size=256,
    max_seq_len=512,
    act="gelu_tanh",
    scale_embed=True,
    rms_offset=True,
    post_norms=True,
    logit_softcap=30.0,
    attn_softcap=50.0,
    sliding_window=128,
    sliding_pattern=2,
)
