"""Logical-axis sharding rules (MaxText-style) mapped onto a mesh, the port
of ``repro.sharding``.

Params and activations are annotated with *logical* axis names; a rules
table maps each logical axis to zero or more mesh axes. ``resolve_spec``
turns a tuple of logical names into a ``PartitionSpec`` (entries None, a
mesh axis or a tuple of mesh axes), exactly as the reference does; it
works on anything with ``axis_names`` and ``shape``, a process mesh
(``launch.mesh.make_mesh``, a ``core.mesh.ProcessMesh``) or an abstract one
(``core.mesh.AbstractMesh``).

The port has its own sharding type in place of ``jax.sharding``: a
``NamedSharding`` says which block of a global tensor each rank of a
process mesh holds. A dimension over several mesh axes is cut into as many
blocks as the axes' sizes multiply to, indexed row-major over the axes in
the spec's order (the block ``jax.sharding.NamedSharding`` gives that
device). ``shard`` takes this rank's block of a global tensor and
``gather`` puts the global tensor back together from the blocks (an
all-gather over each sharded dimension's axes).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

from repro_torch.core.api import YdfError
from repro_torch.core.mesh import ProcessMesh

# Default rules. Each logical axis maps to a tuple of mesh axes (or ()).
# "pod" only exists on the multi-pod mesh; missing axes are dropped at
# resolution time, so one table serves both meshes.
TRAIN_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": ("data",),        # FSDP shard of params + optimizer state
    "embed_act": (),           # activations: d_model dim left unsharded
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("data",),       # EP: experts sharded over data
    "expert_mlp": ("model",),
    "expert_group": ("pod", "data"),
    "kv_len": (),
    "layers": (),
    "conv": (),
    "state": (),
}

SERVE_RULES: dict[str, tuple[str, ...]] = dict(
    TRAIN_RULES,
    batch=("pod", "data"),
    embed=("data",),
    # the KV cache's LENGTH sharded over 'model' (flash-decoding style);
    # lengths the axis does not divide stay replicated
    kv_len=("model",),
)

# long-context decode: the cache length sharded over ('pod', 'data')
LONG_DECODE_RULES: dict[str, tuple[str, ...]] = dict(
    SERVE_RULES,
    batch=(),
    kv_len=("pod", "data"),
    embed=("data",),
)

def rules_for(kind: str, *, long_context: bool = False) -> dict[str, tuple[str, ...]]:
    if kind == "train":
        return dict(TRAIN_RULES)
    if long_context:
        return dict(LONG_DECODE_RULES)
    return dict(SERVE_RULES)


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), a mesh axis name, or a
    tuple of mesh axis names (the blocks row-major over them)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def resolve_spec(logical: Sequence[str | None], mesh,
                 rules: Mapping[str, tuple[str, ...]],
                 shape: Sequence[int] | None = None) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec valid on ``mesh``.

    If ``shape`` is given, mesh axes that do not divide the dimension size
    are dropped: e.g. kv_heads=2 cannot shard over model=16 and falls back
    to replication on that dim. A mesh axis shards at most one dimension.
    """
    used: set[str] = set()
    parts = []
    for i, ax in enumerate(logical):
        if ax is None:
            parts.append(None)
            continue
        cand = [a for a in rules.get(ax, ()) if a in mesh.axis_names and a not in used]
        phys = []
        prod = 1
        for a in cand:
            n = mesh.shape[a]
            if shape is not None and shape[i] % (prod * n) != 0:
                continue
            phys.append(a)
            prod *= n
        used.update(phys)
        if not phys:
            parts.append(None)
        elif len(phys) == 1:
            parts.append(phys[0])
        else:
            parts.append(tuple(phys))
    return PartitionSpec(*parts)


def spec_axes(part) -> tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


class NamedSharding:
    """``spec`` on ``mesh``: which block of a global tensor each rank holds.
    ``shard_shape`` works on any mesh; ``shard`` and ``gather`` need a
    process mesh (``core.mesh.ProcessMesh``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"

    def blocks(self, dim: int) -> int:
        """How many blocks dimension ``dim`` is cut into."""
        n = 1
        for a in spec_axes(self.spec[dim] if dim < len(self.spec) else None):
            n *= self.mesh.shape[a]
        return n

    def _cut(self, ndim: int, dims) -> list[int]:
        if len(self.spec) > ndim:
            raise YdfError(f"a spec of {len(self.spec)} entries {self.spec} on a "
                           f"tensor of {ndim} dimensions")
        return [d for d in range(len(self.spec))
                if (dims is None or d in dims) and self.blocks(d) > 1]

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of each rank's block (the dimensions must divide)."""
        out = list(global_shape)
        for d in self._cut(len(out), None):
            n = self.blocks(d)
            if out[d] % n:
                raise YdfError(f"dimension {d} of {tuple(global_shape)} does not "
                               f"split into {n} blocks under {self.spec}")
            out[d] //= n
        return tuple(out)

    def shard(self, full: torch.Tensor, dims=None) -> torch.Tensor:
        """This rank's block of the global tensor ``full`` (of the ``dims``
        given, all sharded ones by default): a copy, or ``full`` itself
        where no dimension is cut."""
        cut = self._cut(full.dim(), dims)
        if not cut:
            return full
        block = full
        for d in cut:
            n = self.blocks(d)
            if full.shape[d] % n:
                raise YdfError(f"dimension {d} of {tuple(full.shape)} does not "
                               f"split into {n} blocks under {self.spec}")
            size = full.shape[d] // n
            axes = spec_axes(self.spec[d])
            block = block.narrow(d, self.mesh.block_index(axes) * size, size)
        return block.clone()

    def gather(self, block: torch.Tensor, dims=None) -> torch.Tensor:
        """The global tensor from every rank's block (of the ``dims`` given,
        all sharded ones by default): one all-gather over the cut
        dimensions' axes together (each rank sends its block once), or
        ``block`` itself where none is cut."""
        cut = self._cut(block.dim(), dims)
        if not cut:
            return block
        axes = tuple(a for d in cut for a in spec_axes(self.spec[d]))
        counts = [self.blocks(d) for d in cut]
        # (blocks row-major over the cut dims, *block.shape), then each
        # dimension's block count moved in front of it and merged
        x = self.mesh.all_gather(block.unsqueeze(0), axes, dim=0)
        x = x.reshape(*counts, *block.shape)
        order, shape = [], []
        for j, n in enumerate(block.shape):
            if j in cut:
                order.append(cut.index(j))
            order.append(len(cut) + j)
            shape.append(n * (counts[cut.index(j)] if j in cut else 1))
        return x.permute(order).reshape(shape)


def check_mesh(mesh, rules) -> bool:
    """Whether a step runs sharded: a process mesh with rules, or neither."""
    if mesh is None and rules is None:
        return False
    if mesh is None:
        raise YdfError("sharding rules need a mesh (repro_torch.launch.mesh.make_mesh)")
    if not isinstance(mesh, ProcessMesh):
        raise YdfError(f"mesh {mesh!r} is not a process mesh: build one with "
                       "repro_torch.launch.mesh.make_mesh (or pass neither a mesh "
                       "nor rules, for one device)")
    if not isinstance(rules, dict):
        raise YdfError("a mesh needs its sharding rules "
                       "(repro_torch.sharding.rules_for)")
    return True


def batch_split(batch_shardings) -> tuple[str, ...]:
    """The mesh axes the rows of the batch are split over."""
    specs = {spec_axes(sh.spec[0]) for sh in batch_shardings.values()}
    if len(specs) != 1:
        raise YdfError(f"the batch's leaves split their rows differently: {specs}")
    return specs.pop()


def named_sharding(logical: Sequence[str | None], mesh,
                   rules: Mapping[str, tuple[str, ...]],
                   shape: Sequence[int] | None = None) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(logical, mesh, rules, shape))


def with_logical_constraint(x, logical: Sequence[str | None], mesh, rules):
    """The identity: the port places tensors by ``NamedSharding.shard`` and
    ``gather`` where a step needs them; there is no compiler to constrain
    (the reference's ``jax.lax.with_sharding_constraint``)."""
    return x


def _is_dict(x) -> bool:
    return isinstance(x, dict)


def tree_shardings(logical_tree, mesh, rules: Mapping[str, tuple[str, ...]],
                   shape_tree=None):
    """Map a nested dict of logical-axis tuples to one of NamedShardings.

    ``shape_tree`` (tensors or meta tensors, same structure) enables
    divisibility-aware resolution; always pass it for a tree that will be
    sharded.
    """
    if _is_dict(logical_tree):
        return {k: tree_shardings(v, mesh, rules,
                                  None if shape_tree is None else shape_tree[k])
                for k, v in logical_tree.items()}
    shape = None if shape_tree is None else tuple(shape_tree.shape)
    return named_sharding(logical_tree, mesh, rules, shape)


def tree_shard(tree, shardings):
    """``shard`` over a nested dict of global tensors."""
    if _is_dict(tree):
        return {k: tree_shard(v, shardings[k]) for k, v in tree.items()}
    return shardings.shard(tree)


def tree_gather(tree, shardings):
    """``gather`` over a nested dict of blocks."""
    if _is_dict(tree):
        return {k: tree_gather(v, shardings[k]) for k, v in tree.items()}
    return shardings.gather(tree)
