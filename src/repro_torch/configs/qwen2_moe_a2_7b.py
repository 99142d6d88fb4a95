"""qwen2-moe-a2.7b: MoE decoder, 24L, d_model 2048, 16H GQA(kv=16), expert
d_ff 1408, vocab 151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,        # shared-expert path width (4 x 1408)
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    act="swiglu",
    n_experts=60,
    top_k=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    tie_embeddings=False,
    rope_theta=1e6,
    optimizer="adamw",
))
