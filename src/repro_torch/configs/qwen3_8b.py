"""qwen3-8b: dense decoder, 36L, d_model 4096, 32H GQA(kv=8), d_ff 12288,
vocab 151936. Per-head RMS qk_norm, no attention bias. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=False,
    qk_norm=True,
    act="swiglu",
    tie_embeddings=False,
    rope_theta=1e6,
    optimizer="adamw",
))
