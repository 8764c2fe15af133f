"""Llama-3 family configurations (the port's copy of
``pilottai_tpu/models/llama.py``; the Mixtral entries wait for the MoE
slice). SwiGLU MLP, GQA, RoPE theta 500k, RMSNorm. The ``*-byte``
variants pair the trunk with the in-tree byte tokenizer."""

from pilottai_tpu_torch.models.common import ModelConfig

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    family="llama",
    vocab_size=128_256,
    hidden_size=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    max_seq_len=8192,
    rope_theta=500_000.0,
    rms_eps=1e-5,
    tie_embeddings=False,
)

LLAMA3_1B = ModelConfig(
    name="llama3-1b",
    family="llama",
    vocab_size=128_256,
    hidden_size=2048,
    n_layers=16,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    intermediate_size=8192,
    max_seq_len=8192,
    rope_theta=500_000.0,
    rms_eps=1e-5,
    tie_embeddings=True,
)

LLAMA3_8B_BYTE = LLAMA3_8B.replace(name="llama3-8b-byte", vocab_size=512, tie_embeddings=True)
LLAMA3_1B_BYTE = LLAMA3_1B.replace(name="llama3-1b-byte", vocab_size=512)

LLAMA_TINY = ModelConfig(
    name="llama-tiny",
    family="llama",
    vocab_size=512,
    hidden_size=128,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    intermediate_size=256,
    max_seq_len=512,
)

# The agent-protocol model (its trained checkpoint ships with the port as
# assets/protocol_s.npz): vocab 384 == the byte tokenizer's padded vocab.
PROTOCOL_S = ModelConfig(
    name="protocol-s",
    family="llama",
    vocab_size=384,
    hidden_size=256,
    n_layers=4,
    n_heads=8,
    n_kv_heads=4,
    head_dim=32,
    intermediate_size=1024,
    max_seq_len=1024,
    tie_embeddings=True,
)

PROTOCOL_XS = PROTOCOL_S.replace(
    name="protocol-xs", hidden_size=128, n_layers=2, n_heads=4, n_kv_heads=2,
    intermediate_size=384, max_seq_len=512,
)
