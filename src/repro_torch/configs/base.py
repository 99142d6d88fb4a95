"""Config system: architecture + shape + run configs, with a registry.

Every assigned architecture registers a ``ModelConfig`` via ``register_arch``.
Shapes (train_4k / prefill_32k / decode_32k / long_500k) are global and paired
with every LM arch; applicability filtering (e.g. long_500k only for
sub-quadratic families) lives in ``applicable_shapes``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | vlm | audio | hybrid | ssm
    # core transformer dims
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 512
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    parallel_block: bool = False  # command-r style parallel attn+ffn residual
    rope_theta: float = 10_000.0
    # mlp
    act: str = "swiglu"  # swiglu | geglu | gelu
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    # ssm / hybrid (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    d_conv: int = 4
    attn_every: int = 0  # zamba2: shared attention block period (0 = none)
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0  # stub frontend sequence length (whisper frames)
    # vlm (paligemma)
    n_patches: int = 0  # stub frontend patch embeddings per example
    # embeddings / norm
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""  # "" -> dtype; "float8_e4m3fn" halves decode HBM
    # runtime / performance knobs (hillclimb levers)
    attn_impl: str = "chunked"  # chunked | chunked_causal_skip | naive
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    loss_chunk: int = 512
    scan_layers: bool = True
    remat: str = "full"  # full | dots | none
    # optimizer
    optimizer: str = "adamw"  # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # parallelism
    grad_accum: int = 1

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Families with sub-quadratic sequence mixing: the only ones that run long_500k.
_SUBQUADRATIC = {"hybrid", "ssm"}

_ARCHS: dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _ARCHS:
        raise ValueError(f"duplicate arch {cfg.name!r}")
    _ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _ARCHS:
        raise KeyError(
            f"unknown arch {name!r}. Available: {sorted(_ARCHS)}. "
            "Architectures are registered by modules in repro_torch.configs."
        )
    return _ARCHS[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_ARCHS)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shapes that are well-defined for this architecture (assignment rules)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in _SUBQUADRATIC:
        names.append("long_500k")
    return names


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # Import all arch config modules for registration side effects.
    from repro_torch.configs import archs  # noqa: F401


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A reduced config of the same family for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128,
        vocab_size=128,
        head_dim=16,
        loss_chunk=32,
        attn_chunk_q=16,
        attn_chunk_kv=16,
        moe_group_size=16,
        scan_layers=cfg.scan_layers,
        dtype="float32",
        param_dtype="float32",
        kv_cache_dtype="",
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
                  moe_d_ff=64, n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=16)
    if cfg.attn_every:
        kw.update(attn_every=2, n_layers=4)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, enc_seq=24)
    if cfg.n_patches:
        kw.update(n_patches=8)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=16, rwkv_chunk=16)
    return cfg.replace(**kw)
