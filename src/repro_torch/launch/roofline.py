"""Roofline terms for an (arch x shape x mesh) cell, the port of
``repro.launch.roofline``, against one NVIDIA H100 (``launch.mesh``).

Three terms per cell, in seconds:

    compute    = FLOPs_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bytes/s
    collective = collective bytes per device / NVLink bytes/s

MODEL_FLOPS (the "useful" floor) = 6*N*D for dense training, 6*N_active*D
for MoE, 2*N(_active)*tokens for forward-only (prefill/decode); the ratio
MODEL_FLOPS / executed FLOPs exposes remat/redundancy waste.

The reference reads the executed FLOPs and bytes from XLA's
``cost_analysis`` and the collective bytes from the partitioned HLO text
(``parse_collectives``). Eager PyTorch compiles no module, so neither
exists here: ``derive_terms`` takes the same dicts from whoever measured
them, and ``parse_collectives`` refuses.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.api import YdfError
from repro_torch.launch.mesh import (
    H100_BF16_FLOPS,
    H100_BYTES_PER_S,
    H100_NVLINK_BYTES_PER_S,
)


def parse_collectives(hlo_text: str) -> dict:
    """The reference sums the collectives of XLA's partitioned HLO text; the
    port runs eager PyTorch, which compiles no HLO to read."""
    raise YdfError("parse_collectives reads XLA's HLO text, which eager "
                   "PyTorch does not produce; count a step's collective bytes "
                   "from its shapes instead")


# --------------------------------------------------------------- model flops

def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total params, active-per-token params). MoE experts scale by top_k/E."""
    from repro_torch.models import lm
    from repro_torch.models.params import leaves

    total = active = 0
    for keys, spec in leaves(lm.model_schema(cfg)):
        n = int(np.prod(spec.shape))
        total += n
        in_moe = "moe" in keys and "shared" not in keys and spec.shape and \
            cfg.n_experts and any(d == cfg.n_experts for d in spec.shape[:3])
        active += int(n * cfg.top_k / cfg.n_experts) if in_moe else n
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    _, n_active = count_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * shape.global_batch


# --------------------------------------------------------------- terms

@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global executed flops (remat/redundancy waste)."""
        g = self.flops_per_device * self.chips
        return self.model_flops / g if g else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time (higher is better)."""
        ideal = self.model_flops / self.chips / H100_BF16_FLOPS
        return ideal / self.bound_s if self.bound_s else 0.0


def derive_terms(cost: dict, coll: dict, cfg: ModelConfig, shape: ShapeConfig,
                 chips: int) -> RooflineTerms:
    """``cost``: {"flops", "bytes accessed"} per device; ``coll``:
    {"total_bytes"} of collectives per device."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll["total_bytes"])
    return RooflineTerms(
        compute_s=flops / H100_BF16_FLOPS,
        memory_s=byts / H100_BYTES_PER_S,
        collective_s=cbytes / H100_NVLINK_BYTES_PER_S,
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=cbytes,
        model_flops=model_flops(cfg, shape),
        chips=chips,
    )
