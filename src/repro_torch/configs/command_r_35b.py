"""command-r-35b: dense decoder, 40L, d_model 8192, 64H GQA(kv=8), d_ff 22528,
vocab 256000. GQA, no bias, parallel attention+FFN residual (Cohere layout).
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    qkv_bias=False,
    parallel_block=True,
    act="swiglu",
    tie_embeddings=True,
    rope_theta=8e6,
    optimizer="adamw",
))
