"""The port's launch layer and gradient compression against the reference:

* ``distributed.compression``: ``quantize_int8`` / ``dequantize_int8`` bit
  for bit (halves round to even, an all-zero tensor), the stochastic path
  within its bound (the mesh sums: tests/test_torch_lm_mesh.py);
* ``launch.roofline``: ``count_params`` and ``model_flops`` for every
  registered arch and applicable shape, the terms' arithmetic on the H100
  constants, ``parse_collectives`` refused;
* ``launch.dryrun``: ``all_cells`` equal, and every cell's
  ``input_bytes_per_device`` equal to the reference's ``shard_bytes`` rule
  computed from the reference's specs and ``resolve_spec`` on a FakeMesh;
* ``launch.mesh``: the production meshes (abstract, and refused outside a
  world of 256 or 512 ranks, as ``launch.train`` / ``launch.serve`` do),
  the H100 constants as chip_smoke's, and no TPU v5e constant in the port.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro import sharding as ref_sharding
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.distributed import compression as ref_compression
from repro.launch import dryrun as ref_dryrun
from repro.launch import roofline as ref_roofline
from repro.models import lm as ref_lm
from repro.serving import serve_state_specs as ref_serve_state_specs
from repro.train.step import train_state_specs as ref_train_state_specs
from repro_torch.configs import SHAPES, applicable_shapes, get_arch, list_archs
from repro_torch.core.api import YdfError
from repro_torch.distributed.compression import dequantize_int8, quantize_int8
from repro_torch.launch import dryrun, mesh, roofline
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

ROOT = Path(__file__).resolve().parent.parent
CELLS = list(dryrun.all_cells())


# ----------------------------------------------------------- compression

def _quant_cases():
    rng = np.random.default_rng(5)
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 0.0, -127.0],
                      np.float32)
    return {"halves": halves, "zeros": np.zeros(7, np.float32),
            "normal": rng.standard_normal((4, 33)).astype(np.float32),
            "wide": (rng.standard_normal(1000) * 1e3).astype(np.float32)}


@pytest.mark.parametrize("name", list(_quant_cases()))
def test_quantize_int8_equals_the_reference_bit_for_bit(name):
    x = _quant_cases()[name]
    rq, rs = ref_compression.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.item() == float(rs)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_compression.dequantize_int8(rq, rs)))
    if name == "halves":   # x / scale is x: halves to even
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 0, -127]


def test_stochastic_rounding_stays_within_one_quantum():
    x = torch.from_numpy(_quant_cases()["normal"])
    g = torch.Generator().manual_seed(0)
    q, s = quantize_int8(x, generator=g)
    err = (dequantize_int8(q, s) - x).abs().max().item()
    assert err <= s.item() * (1 + 1e-6)
    q2, _ = quantize_int8(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(q, q2)
    assert not torch.equal(q, quantize_int8(x)[0])   # the noise moved some codes


# ----------------------------------------------------------- roofline

@pytest.mark.parametrize("arch", list_archs())
def test_count_params_and_model_flops_equal_the_reference(arch):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    assert roofline.count_params(cfg) == ref_roofline.count_params(ref_cfg)
    for shape in applicable_shapes(cfg):
        assert roofline.model_flops(cfg, SHAPES[shape]) == \
            ref_roofline.model_flops(ref_cfg, REF_SHAPES[shape])


def test_terms_on_the_h100_constants():
    cfg, ref_cfg = get_arch("qwen3-8b"), ref_get_arch("qwen3-8b")
    cost, coll = {"flops": 3.0e14, "bytes accessed": 2.0e11}, {"total_bytes": 5.0e9}
    t = roofline.derive_terms(cost, coll, cfg, SHAPES["train_4k"], 256)
    r = ref_roofline.derive_terms(cost, coll, ref_cfg, REF_SHAPES["train_4k"], 256)
    assert t.compute_s == 3.0e14 / mesh.H100_BF16_FLOPS
    assert t.memory_s == 2.0e11 / mesh.H100_BYTES_PER_S
    assert t.collective_s == 5.0e9 / mesh.H100_NVLINK_BYTES_PER_S
    assert (t.model_flops, t.useful_ratio) == (r.model_flops, r.useful_ratio)
    assert t.dominant == "compute" and t.bound_s == t.compute_s
    assert t.roofline_fraction == pytest.approx(
        t.model_flops / 256 / mesh.H100_BF16_FLOPS / t.bound_s)


def test_parse_collectives_is_refused():
    with pytest.raises(YdfError, match="HLO"):
        roofline.parse_collectives("%x = f32[8] all-reduce(f32[8] %y)")


# ----------------------------------------------------------- dry run

def test_all_cells_equal_the_reference():
    assert CELLS == list(ref_dryrun.all_cells())
    assert list(dryrun.all_cells(("single",))) == list(ref_dryrun.all_cells(("single",)))


class FakeMesh:
    def __init__(self, multi: bool):
        shape, axes = mesh.PRODUCTION_SHAPES[multi]
        self.axis_names, self.shape = axes, dict(zip(axes, shape))


def _ref_input_bytes(arch: str, shape_name: str, mesh_kind: str) -> int:
    """The reference's ``shard_bytes`` rule (dryrun.py:101-119) over the
    reference's argument specs, resolved on a FakeMesh."""
    cfg, shape = ref_get_arch(arch), REF_SHAPES[shape_name]
    fake = FakeMesh(mesh_kind == "multi")
    rules = ref_sharding.rules_for("train" if shape.kind == "train" else "serve",
                                   long_context=shape.seq_len >= 2 ** 19)
    batch = (ref_lm.batch_spec(cfg, shape), ref_lm.batch_axes(cfg, shape))
    if shape.kind == "train":
        s, a = ref_train_state_specs(cfg)
        args = [(s, a), batch]
    else:
        p, a = ref_serve_state_specs(cfg)
        args = [(p, a), batch]
        if shape.kind == "decode":
            args.append((ref_lm.cache_spec(cfg, shape.global_batch, shape.seq_len),
                         ref_lm.cache_axes(cfg)))
    total = 0
    for specs, axes in args:
        leaves, treedef = jax.tree.flatten(specs)
        for leaf, logical in zip(leaves, treedef.flatten_up_to(axes)):
            n = int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize
            spec = ref_sharding.resolve_spec(logical, fake, rules, leaf.shape)
            denom = 1
            for part in spec:
                if part is None:
                    continue
                for ax in (part if isinstance(part, tuple) else (part,)):
                    denom *= fake.shape[ax]
            total += -(-n // denom)
    return total


@pytest.mark.parametrize("arch", list_archs())
def test_run_cell_input_bytes_equal_the_reference_rule(arch):
    for a, shape, mesh_kind in CELLS:
        if a != arch:
            continue
        rec = dryrun.run_cell(arch, shape, mesh_kind, None)
        assert rec["input_bytes_per_device"] == _ref_input_bytes(arch, shape, mesh_kind), \
            (arch, shape, mesh_kind)
        assert rec["chips"] == (512 if mesh_kind == "multi" else 256)
        assert rec["hbm_share"] == rec["input_bytes_per_device"] / mesh.H100_HBM_BYTES
        assert rec["model_flops"] == ref_roofline.model_flops(ref_get_arch(arch),
                                                              REF_SHAPES[shape])
        assert not {"cost_analysis", "memory_analysis", "collectives"} & set(rec)


def test_dryrun_driver_writes_one_record_a_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(dryrun, "all_cells", lambda kinds: iter(
        [("qwen2-1.5b", "train_4k", "single"), ("rwkv6-3b", "long_500k", "multi")]))
    assert dryrun.driver(("single", "multi"), skip_done=False) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["qwen2-1.5b__train_4k__single.json", "rwkv6-3b__long_500k__multi.json"]
    with pytest.raises(YdfError, match="not applicable"):
        dryrun.run_cell("qwen2-1.5b", "long_500k", "single", None)


def test_the_results_directory_is_outside_src_and_ignored():
    results = Path(dryrun.RESULTS_DIR).resolve()
    assert results == ROOT / "results" / "dryrun_torch"
    assert "results/dryrun_torch/" in (ROOT / ".gitignore").read_text().split()


# ----------------------------------------------------------- meshes

def test_production_meshes():
    single, multi = mesh.production_mesh_shape(), mesh.production_mesh_shape(multi_pod=True)
    assert (single.shape, single.size) == ({"data": 16, "model": 16}, 256)
    assert (multi.shape, multi.size) == ({"pod": 2, "data": 16, "model": 16}, 512)
    with pytest.raises(YdfError, match="needs a world of 256 ranks; this one has 1"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(YdfError, match="needs a world of 512 ranks"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("kind,ranks", [("single", 256), ("multi", 512)])
def test_launchers_refuse_a_mesh_outside_its_world(tmp_path, kind, ranks):
    match = f"needs a world of {ranks} ranks; this one has 1"
    with pytest.raises(YdfError, match=match):
        launch_train.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                           "--mesh", kind, "--ckpt", str(tmp_path)])
    with pytest.raises(YdfError, match=match):
        launch_serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                           "--mesh", kind])
    assert not list(tmp_path.iterdir())


def test_h100_constants_have_one_source():
    assert (chip_smoke.H100_BF16_FLOPS, chip_smoke.H100_F32_FLOPS,
            chip_smoke.H100_BYTES_PER_S) == (989e12, 67e12, 3.35e12)
    assert chip_smoke.H100_BF16_FLOPS is mesh.H100_BF16_FLOPS
    assert mesh.H100_HBM_BYTES == 80e9


def test_no_tpu_v5e_constant_in_the_port():
    pattern = re.compile(r"\b(197e12|819e9|50e9)\b|16 \* 1024\*\*3|v5e|ICI_BW|HBM_PER_CHIP")
    hits = [f"{p}:{i}" for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.search(line)]
    assert not hits, hits
    assert math.isclose(mesh.H100_NVLINK_BYTES_PER_S * 2, 900e9)
