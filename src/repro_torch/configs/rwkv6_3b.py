"""rwkv6-3b (Finch): attention-free, 32L, d_model 2560, d_ff 8960, vocab 65536,
data-dependent decay linear attention. Chunked-parallel form for train/prefill;
O(1)-state recurrence for decode (long_500k applicable). [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # time-mix heads = d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    rwkv_head_dim=64,
    rwkv_chunk=128,
    act="relu_sq",        # rwkv channel-mix uses squared relu
    tie_embeddings=False,
    rope_theta=0.0,
    optimizer="adamw",
))
