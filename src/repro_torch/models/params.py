"""Param schema: one declaration yields init values, meta-device shapes and
logical sharding axes. No ``nn.Module`` tree: params are plain nested dicts
of tensors (``lm.LanguageModel`` wraps one for ``state_dict``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int32": torch.int32,
}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name as a torch dtype."""
    return DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis per dim
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: str | None = None      # override param_dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Schema = dict[str, Any]  # nested dict with ParamSpec leaves


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def map_schema(fn: Callable[[ParamSpec], Any], schema: Schema):
    """``fn`` over every leaf of a nested dict, keeping its structure."""
    if isinstance(schema, dict):
        return {k: map_schema(fn, v) for k, v in schema.items()}
    return fn(schema)


def leaves(tree, path: tuple = ()) -> list[tuple[tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs of a nested dict in sorted key order (the
    order ``jax.tree.leaves`` visits a dict in)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], path + (k,))
        return out
    return [(path, tree)]


def at(tree, path: tuple):
    """The leaf of a nested dict at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def schema_axes(schema: Schema):
    return map_schema(lambda s: s.axes, schema)


def schema_shapes(schema: Schema, default_dtype: str):
    """Meta-device tensors: shape and dtype, no storage."""
    return map_schema(
        lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype or default_dtype),
                              device="meta"),
        schema,
    )


def schema_n_params(schema: Schema) -> int:
    return sum(int(np.prod(s.shape)) for _, s in leaves(schema))


def init_params(schema: Schema, default_dtype: str, *,
                generator: torch.Generator, device) -> dict:
    """Draws every leaf with ``generator`` (on ``device``): normal with std
    scale / sqrt(fan_in) (``embed``: std = scale), zeros or ones. Draws are
    float32, then cast to the leaf's dtype."""
    def draw(spec: ParamSpec):
        dtype = torch_dtype(spec.dtype or default_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(1, fan_in))
        if spec.init == "embed":
            std = spec.scale
        v = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return v.mul_(std).to(dtype)

    vals = {path: draw(spec) for path, spec in leaves(schema)}
    return _unflatten(schema, vals)


def _unflatten(schema: Schema, vals: dict, path: tuple = ()):
    if isinstance(schema, dict):
        return {k: _unflatten(v, vals, path + (k,)) for k, v in schema.items()}
    return vals[path]


def stack_layers(n: int, schema: Schema) -> Schema:
    """Prefix every spec with a leading scanned 'layers' dim."""
    return map_schema(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
        schema,
    )
