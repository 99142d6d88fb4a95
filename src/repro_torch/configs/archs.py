"""Imports every architecture config module for registration side effects."""
from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    qwen2_1_5b,
    qwen1_5_32b,
    qwen3_8b,
    grok_1_314b,
    qwen2_moe_a2_7b,
    paligemma_3b,
    whisper_large_v3,
    zamba2_2_7b,
    rwkv6_3b,
)
