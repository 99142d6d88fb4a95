"""whisper-large-v3: encoder-decoder, 32 encoder + 32 decoder layers,
d_model 1280, 20H (no GQA), d_ff 5120, vocab 51866. The conv/mel frontend is a
STUB: input_specs() provides 1500 precomputed frame embeddings per example.
Decode shapes lower the decoder serve_step (self-attn KV cache + cross-attn to
encoder states). [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,          # decoder layers
    n_enc_layers=32,      # encoder layers
    enc_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    qkv_bias=True,
    act="gelu",
    tie_embeddings=True,
    rope_theta=0.0,       # whisper uses learned/sinusoidal positions, not RoPE
    optimizer="adamw",
))
