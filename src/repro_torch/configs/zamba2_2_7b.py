"""zamba2-2.7b: hybrid, 54 Mamba2 (SSD) layers, d_model 2560, ssm_state 64,
plus a SHARED attention(32H)+MLP(d_ff 10240) block invoked every 6 mamba
layers (9 invocations, one set of weights, per-invocation KV caches),
vocab 32000. [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    qkv_bias=False,
    act="gelu",
    ssm_state=64,
    ssm_heads=80,
    ssm_head_dim=64,     # expand=2 -> d_inner 5120 = 80 heads x 64
    ssm_chunk=256,
    d_conv=4,
    attn_every=6,
    tie_embeddings=True,
    rope_theta=1e4,
    optimizer="adamw",
))
