"""grok-1-314b: MoE decoder, 64L, d_model 6144, 48H GQA(kv=8), d_ff 32768,
vocab 131072, 8 experts top-2. Adafactor optimizer (Adam's m and v double
the optimizer state of a 314B-parameter model). [hf:xai-org/grok-1; unverified]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,       # dense-equivalent ff width; experts use moe_d_ff
    vocab_size=131072,
    head_dim=128,
    qkv_bias=False,
    act="geglu",
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    n_shared_experts=0,
    tie_embeddings=True,
    rope_theta=1e4,
    optimizer="adafactor",
))
