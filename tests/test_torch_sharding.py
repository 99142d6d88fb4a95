"""The port's sharding rules (``repro_torch.sharding``) against the
reference's: every case of ``tests/test_sharding.py`` on the port's types,
and a sweep in which ``resolve_spec`` equals the reference's entry for
entry, for every registered arch and applicable shape, over the param,
train-state, batch and cache axes, under the three rule sets, on the
single- and multi-pod production meshes and on (2, 2, 2) and (4, 2). Both
resolve on a ``FakeMesh`` (names and sizes only)."""
from __future__ import annotations

import jax
import pytest
import torch

from repro import sharding as ref_sharding
from repro.configs import applicable_shapes as ref_applicable_shapes
from repro.configs import get_arch as ref_get_arch
from repro.configs import SHAPES as REF_SHAPES
from repro.models import lm as ref_lm
from repro.serving import serve_state_specs as ref_serve_state_specs
from repro.train.step import train_state_specs as ref_train_state_specs
from repro_torch.configs import SHAPES, applicable_shapes, get_arch, list_archs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm
from repro_torch.models.params import leaves
from repro_torch.serving.decode import serve_state_specs
from repro_torch.sharding import (
    LONG_DECODE_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    NamedSharding,
    P,
    PartitionSpec,
    named_sharding,
    resolve_spec,
    rules_for,
    tree_shardings,
    with_logical_constraint,
)
from repro_torch.train.step import train_state_specs


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
RULES = {"train": (TRAIN_RULES, ref_sharding.TRAIN_RULES),
         "serve": (SERVE_RULES, ref_sharding.SERVE_RULES),
         "long_decode": (LONG_DECODE_RULES, ref_sharding.LONG_DECODE_RULES)}


# ------------------------------------------------ tests/test_sharding.py

def test_resolve_drops_non_dividing_axes():
    mesh = AbstractMesh((1, 1), ("data", "model"))
    spec = resolve_spec(("embed", "kv_heads", None), mesh, TRAIN_RULES, shape=(64, 2, 16))
    assert isinstance(spec, PartitionSpec)


def test_divisibility_logic_against_production_sizes():
    m = FakeMesh((16, 16), ("data", "model"))
    assert resolve_spec(("embed", "kv_heads", "qkv"), m, TRAIN_RULES,
                        shape=(8192, 8, 128)) == P("data", None, None)
    assert resolve_spec(("embed", "heads", "qkv"), m, TRAIN_RULES,
                        shape=(8192, 64, 128)) == P("data", "model", None)
    assert resolve_spec(("vocab", "embed"), m, TRAIN_RULES,
                        shape=(51866, 1280)) == P(None, "data")


def test_axis_used_once_per_spec():
    spec = resolve_spec(("batch", "seq", "embed"), FakeMesh((2, 16, 16), ("pod", "data", "model")),
                        TRAIN_RULES, shape=(256, 4096, 1024))
    assert spec[0] == ("pod", "data")
    assert spec[2] is None


def test_long_decode_rules_shard_kv_len():
    spec = resolve_spec(("layers", "batch", "kv_len", "kv_heads", "qkv"),
                        FakeMesh((16, 16), ("data", "model")), LONG_DECODE_RULES,
                        shape=(54, 1, 524288, 32, 80))
    assert spec[2] == "data"
    assert spec[1] is None


def test_tree_shardings_with_shape_tree():
    mesh = AbstractMesh((1, 1), ("data", "model"))
    specs = {"w": torch.empty((8, 4), device="meta"),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    sh = tree_shardings({"w": ("embed", "mlp"), "step": ()}, mesh, TRAIN_RULES, specs)
    assert sh["w"].spec == P("data", "model")
    assert sh["step"].spec == P()


def test_rules_for_modes():
    assert rules_for("train")["batch"] == ("pod", "data")
    assert rules_for("serve", long_context=True)["kv_len"] == ("pod", "data")
    assert rules_for("serve")["kv_len"] == ("model",)
    assert rules_for("train")["kv_len"] == ()


# ------------------------------------------------ the port's own types

def test_the_rule_tables_equal_the_reference():
    for ours, ref in RULES.values():
        assert ours == ref
    for kind, lc in (("train", False), ("serve", False), ("serve", True)):
        assert rules_for(kind, long_context=lc) == ref_sharding.rules_for(kind, long_context=lc)


def test_shard_shape_and_the_identity_constraint():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    sh = named_sharding(("batch", "seq", "embed"), mesh, TRAIN_RULES, (256, 4096, 1024))
    assert isinstance(sh, NamedSharding) and sh.spec == P(("pod", "data"), None, None)
    assert sh.shard_shape((256, 4096, 1024)) == (8, 4096, 1024)
    assert named_sharding(("embed", "mlp"), mesh, TRAIN_RULES).shard_shape(
        (1024, 4096)) == (64, 256)
    x = torch.ones(3)
    assert with_logical_constraint(x, ("embed",), mesh, TRAIN_RULES) is x


# ------------------------------------------------ the sweep

def _port_trees(cfg, shape):
    """{name: (axes tree, meta tree)} of the port for one arch and shape."""
    p_specs, p_axes = serve_state_specs(cfg)
    s_specs, s_axes = train_state_specs(cfg)
    out = {"params": (p_axes, p_specs), "state": (s_axes, s_specs),
           "batch": (lm.batch_axes(cfg, shape), lm.batch_spec(cfg, shape))}
    if shape.kind == "decode":
        out["cache"] = (lm.cache_axes(cfg),
                        lm.cache_spec(cfg, shape.global_batch, shape.seq_len))
    return out


def _ref_trees(cfg, shape):
    p_specs, p_axes = ref_serve_state_specs(cfg)
    s_specs, s_axes = ref_train_state_specs(cfg)
    out = {"params": (p_axes, p_specs), "state": (s_axes, s_specs),
           "batch": (ref_lm.batch_axes(cfg, shape), ref_lm.batch_spec(cfg, shape))}
    if shape.kind == "decode":
        out["cache"] = (ref_lm.cache_axes(cfg),
                        ref_lm.cache_spec(cfg, shape.global_batch, shape.seq_len))
    return out


def _ref_leaves(axes_tree, shape_tree):
    """(path, logical axes, shape) of the reference's trees, in the sorted
    key order of the port's ``leaves``."""
    shapes = jax.tree_util.tree_flatten_with_path(shape_tree)[0]
    out = []
    for path, s in shapes:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        a = axes_tree
        for k in keys:
            a = a[k]
        out.append((keys, tuple(a), tuple(s.shape)))
    return sorted(out)


def _entries(spec) -> list:
    return [tuple(e) if isinstance(e, (tuple, list)) else e for e in spec]


@pytest.mark.parametrize("arch", list_archs())
def test_resolve_spec_sweep_equals_the_reference(arch):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    assert applicable_shapes(cfg) == ref_applicable_shapes(ref_cfg)
    n = 0
    for shape_name in applicable_shapes(cfg):
        ours, ref = _port_trees(cfg, SHAPES[shape_name]), _ref_trees(ref_cfg,
                                                                     REF_SHAPES[shape_name])
        assert set(ours) == set(ref)
        for tree in ours:
            if tree in ("params", "state") and shape_name != applicable_shapes(cfg)[0]:
                continue            # the same for every shape
            mine = sorted((p, tuple(a), tuple(s.shape)) for (p, a), (_, s) in
                          zip(leaves(ours[tree][0]), leaves(ours[tree][1])))
            theirs = _ref_leaves(*ref[tree])
            assert [(p, a, s) for p, a, s in mine] == theirs, (arch, shape_name, tree)
            for (path, logical, shape) in mine:
                for mesh_shape, axes in MESHES.values():
                    m = FakeMesh(mesh_shape, axes)
                    for rules, ref_rules in RULES.values():
                        got = resolve_spec(logical, m, rules, shape)
                        want = ref_sharding.resolve_spec(logical, m, ref_rules, shape)
                        assert _entries(got) == _entries(want), (arch, shape_name, tree,
                                                                 path, axes, got, want)
                        n += 1
    assert n > 500, n
