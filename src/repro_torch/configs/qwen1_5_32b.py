"""qwen1.5-32b: dense decoder, 64L, d_model 5120, 40H GQA(kv=40 -> MHA), d_ff 27392,
vocab 152064. QKV bias. [hf:Qwen/Qwen1.5-32B; hf]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    act="swiglu",
    tie_embeddings=False,
    rope_theta=1e6,
    optimizer="adamw",
))
