"""paligemma-3b: VLM; transformer backbone = gemma-2b-style decoder: 18L,
d_model 2048, 8H MQA(kv=1), d_ff 16384, vocab 257216. The SigLIP vision
frontend is a STUB: input_specs() provides 256 precomputed patch embeddings
per example, prepended (prefix-LM) to the text tokens. [arXiv:2407.07726; hf]
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    qkv_bias=False,
    act="geglu",
    n_patches=256,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1e4,
    optimizer="adamw",
))
