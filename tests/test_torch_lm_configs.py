"""The port's LM configs and param schemas against the reference's
(``repro.configs``, ``repro.models.params``): every registered arch, its
smoke config, the shapes and the parameter counts of every family at
full size (arithmetic over the schema, nothing allocated);
meta-device shapes and seeded init; and the LM modules load neither jax,
nor repro, nor ml_dtypes."""
from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs as ref_list_archs
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import applicable_shapes as ref_applicable_shapes
from repro.models import lm as ref_lm
from repro.models.params import schema_n_params as ref_schema_n_params
from repro_torch.configs import (
    SHAPES,
    applicable_shapes,
    get_arch,
    list_archs,
    smoke_config,
)
from repro_torch.models import lm
from repro_torch.models.params import (
    ParamSpec,
    init_params,
    schema_n_params,
    schema_shapes,
    stack_layers,
)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ref_list_archs()
ATTN = [a for a in ARCHS if ref_get_arch(a).family not in ("hybrid", "ssm")]


def test_every_arch_is_registered():
    assert list_archs() == ARCHS and len(ARCHS) == 10
    assert sorted(ATTN) == ["command-r-35b", "grok-1-314b", "paligemma-3b",
                            "qwen1.5-32b", "qwen2-1.5b", "qwen2-moe-a2.7b",
                            "qwen3-8b", "whisper-large-v3"]


@pytest.mark.parametrize("name", ARCHS)
def test_arch_config_equals_the_reference(name):
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(ref_get_arch(name))


@pytest.mark.parametrize("name", ARCHS)
def test_smoke_config_and_shapes_equal_the_reference(name):
    ours, ref = get_arch(name), ref_get_arch(name)
    assert dataclasses.asdict(smoke_config(ours)) == dataclasses.asdict(ref_smoke_config(ref))
    assert applicable_shapes(ours) == ref_applicable_shapes(ref)
    assert ours.resolved_head_dim() == ref.resolved_head_dim()


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-0")


FULL_SIZE = {"qwen2-1.5b": 1_543_714_304, "zamba2-2.7b": 2_314_535_840,
             "rwkv6-3b": 3_089_295_360}


@pytest.mark.parametrize("name", ARCHS)
def test_full_size_param_count_equals_the_reference(name):
    cfg = get_arch(name)
    n = schema_n_params(lm.model_schema(cfg))
    assert n == ref_schema_n_params(ref_lm.model_schema(ref_get_arch(name)))
    if name in FULL_SIZE:
        assert n == FULL_SIZE[name]


@pytest.mark.parametrize("name", ["zamba2-2.7b", "rwkv6-3b"])
def test_hybrid_and_ssm_schemas_equal_the_reference(name):
    """The hybrid and ssm families' param trees: every path, shape, axes
    and init equal to the reference's, at full size and in the smoke
    config (zamba2: the Mamba2 layers stacked (groups, per group), one
    shared attention block)."""
    from repro.models.params import ParamSpec as RefSpec
    for cfg, ref in ((get_arch(name), ref_get_arch(name)),
                     (smoke_config(get_arch(name)), ref_smoke_config(ref_get_arch(name)))):
        ours, theirs = {}, {}
        _walk(lm.model_schema(cfg), (), ours)
        _walk(ref_lm.model_schema(ref), (), theirs, RefSpec)
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert ours[k] == theirs[k], k
    zamba = lm.model_schema(get_arch("zamba2-2.7b"))
    assert zamba["mamba"]["m"]["in_proj"].shape == (9, 6, 2560, 2 * 5120 + 2 * 64 + 80)
    assert zamba["shared"]["attn"]["wq"].shape == (2560, 32, 80)


def _walk(tree, path, out, spec_type=ParamSpec):
    if isinstance(tree, spec_type):
        out[path] = (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale, tree.dtype)
        return
    for k, v in tree.items():
        _walk(v, path + (k,), out, spec_type)


def test_schema_shapes_are_meta_tensors():
    cfg = get_arch("qwen2-moe-a2.7b")
    shapes = schema_shapes(lm.model_schema(cfg), cfg.param_dtype)
    wq = shapes["layers"]["attn"]["wq"]
    assert wq.device.type == "meta" and wq.dtype == torch.bfloat16
    assert tuple(wq.shape) == (24, 2048, 16, 128)
    router = shapes["layers"]["moe"]["router"]
    assert router.dtype == torch.float32 and tuple(router.shape) == (24, 2048, 60)


def test_init_params_draws_the_reference_distributions():
    schema = {
        "w": ParamSpec((256, 64), ("embed", "mlp")),
        "stacked": stack_layers(3, {"w": ParamSpec((128, 32), ("embed", "mlp"), scale=2.0)}),
        "emb": ParamSpec((512, 16), ("vocab", "embed"), init="embed", scale=0.02),
        "z": ParamSpec((7,), (None,), init="zeros"),
        "o": ParamSpec((5,), (None,), init="ones", dtype="float32"),
    }

    def draw(seed):
        return init_params(schema, "bfloat16", device="cpu",
                           generator=torch.Generator().manual_seed(seed))

    p = draw(0)
    assert p["w"].dtype == torch.bfloat16 and p["o"].dtype == torch.float32
    assert tuple(p["stacked"]["w"].shape) == (3, 128, 32)
    assert torch.equal(p["z"], torch.zeros(7, dtype=torch.bfloat16))
    assert torch.equal(p["o"], torch.ones(5))
    assert abs(p["w"].float().std().item() - 1 / math.sqrt(256)) < 0.05 / math.sqrt(256)
    assert abs(p["stacked"]["w"].float().std().item() - 2 / math.sqrt(128)) < 0.1 / math.sqrt(128)
    assert abs(p["emb"].float().std().item() - 0.02) < 0.001
    again, other = draw(0), draw(1)
    assert torch.equal(p["w"], again["w"]) and not torch.equal(p["w"], other["w"])


def test_lm_modules_load_neither_jax_nor_repro_nor_ml_dtypes():
    code = ("import sys\n"
            "import repro_torch.configs, repro_torch.models.lm, "
            "repro_torch.serving.decode, repro_torch.launch.serve, "
            "repro_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
