"""Process meshes: named axes over the ranks of a ``torch.distributed``
world, the one mesh type of the port (the LM steps, serving, the int8 psum,
the pipeline and the distributed GBT's (data, model) grid all use it).

``ProcessMesh(shape, axes)`` lays the ranks of the default process group
out row-major over named axes of any count (rank r at the coordinates
``np.unravel_index(r, shape)``) and creates the process groups the
collectives need: one group for every set of axes whose sizes multiply to
more than one, the same groups in the same order on every rank.
``AbstractMesh`` carries names and sizes only: it serves
``sharding.resolve_spec`` and the dry run, where the reference uses 256 or
512 placeholder devices.

Collectives run on the device tensors under NCCL. Under gloo with the
tensors on the card they run on host copies (``host_staged``): several
ranks share one card, and NCCL refuses two ranks on one device
(``core.distributed.default_backend``).

Importing this module touches no device and no process group.
"""
from __future__ import annotations

import itertools
from math import prod

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import YdfError
from repro_torch.obs import clock


class AbstractMesh:
    """Axis names and sizes without processes."""

    def __init__(self, shape, axes):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes) \
                or min(shape, default=1) < 1:
            raise YdfError(f"a mesh needs one size >= 1 per distinct axis name: "
                           f"{shape}, {axes}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.size = prod(shape)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def _transport(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a dtype the collectives carry: float8 and bool as bytes."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2, torch.bool):
        return t.view(torch.uint8)
    return t


class ProcessMesh(AbstractMesh):
    """The ranks of the default process group as a mesh of named axes;
    ``device`` is where this rank's tensors live (None is cuda; every rank
    of a one-card machine uses the same card). Construction is collective.

    ``traffic`` counts this rank's collectives: calls, the bytes it sends
    (each tensor's bytes as passed) and the host seconds spent in them,
    staging included (under NCCL the call returns before the card is done,
    so its seconds are the enqueue)."""

    def __init__(self, shape, axes, device=None):
        from repro_torch.core.engines import resolve_device
        super().__init__(shape, axes)
        self.device = resolve_device(device)
        if not dist.is_initialized():
            raise YdfError(
                "a process mesh needs an initialized default process group "
                "(torch.distributed.init_process_group); "
                "core.distributed.run_world starts one on this machine")
        world = dist.get_world_size()
        if world != self.size:
            raise YdfError(f"a {tuple(self.shape.values())} mesh needs a world of "
                           f"{self.size} ranks, this one has {world}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.host_staged = self.backend == "gloo" and self.device.type == "cuda"
        self.traffic = {"calls": 0, "bytes": 0, "seconds": 0.0}
        sizes = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, sizes))))
        # one group per set of axes (in mesh order) holding more than one
        # rank; sets that differ only by size-1 axes share a group
        self._groups: dict[tuple, tuple] = {}
        made: dict[tuple, tuple] = {}
        grid = np.arange(self.size).reshape(sizes)
        for k in range(1, len(axes) + 1):
            for subset in itertools.combinations(self.axis_names, k):
                live = tuple(a for a in subset if self.shape[a] > 1)
                if not live:
                    continue
                if live not in made:
                    keep = [self.axis_names.index(a) for a in live]
                    rest = [i for i in range(len(sizes)) if i not in keep]
                    members = np.moveaxis(grid, keep + rest,
                                          range(len(sizes))).reshape(
                        prod(self.shape[a] for a in live), -1)
                    mine = None
                    for col in range(members.shape[1]):
                        ranks = [int(r) for r in members[:, col]]
                        g = dist.new_group(ranks)
                        if self.rank in ranks:
                            mine = (g, ranks)
                    made[live] = mine
                self._groups[subset] = made[live]

    # ------------------------------------------------------------ layout
    def block_index(self, axes) -> int:
        """This rank's index row-major over ``axes`` (in the given order)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group_size(self, axes) -> int:
        return prod(self.shape[a] for a in axes)

    def axes_of(self, axes) -> tuple[str, ...]:
        """``axes`` as a tuple: one name, a sequence of names, or None for
        every axis of the mesh."""
        if axes is None:
            return self.axis_names
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def _group(self, axes):
        """(process group, its ranks in mesh order), or None for one rank."""
        axes = self.axes_of(axes)
        missing = [a for a in axes if a not in self.shape]
        if missing or len(set(axes)) != len(axes):
            raise YdfError(f"axes {axes} are not distinct axes of the mesh "
                           f"{self.axis_names}")
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups.get(key) if key else None

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host_staged else t

    def _count(self, t: torch.Tensor, t0: float) -> None:
        self.traffic["calls"] += 1
        self.traffic["bytes"] += t.numel() * t.element_size()
        self.traffic["seconds"] += clock.perf() - t0

    # ------------------------------------------------------------ collectives
    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """SUM (or MAX) of ``t`` over ``axes`` (a name, names, or None for
        the world): a new tensor, ``t`` itself where the axes hold one
        rank."""
        g = self._group(axes)
        if g is None:
            return t
        t0 = clock.perf()
        x = t.cpu() if self.host_staged else t.clone()
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=g[0])
        out = x.to(self.device)
        self._count(t, t0)
        return out

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` over ``axes``, concatenated along ``dim`` in
        block order (row-major over ``axes`` as given); ``t`` itself where
        the axes hold one rank."""
        axes = self.axes_of(axes)
        g = self._group(axes)
        if g is None:
            return t
        group, ranks = g
        t0 = clock.perf()
        x = _transport(self._stage(t).contiguous())
        parts = [torch.empty_like(x) for _ in ranks]
        dist.all_gather(parts, x, group=group)
        coords = [dict(zip(self.axis_names,
                           np.unravel_index(r, tuple(self.shape.values()))))
                  for r in ranks]
        order = sorted(range(len(ranks)), key=lambda j: [coords[j][a] for a in axes])
        out = torch.cat([parts[j].to(self.device) for j in order], dim=dim).view(t.dtype)
        self._count(t, t0)
        return out

    def rank_at(self, **moved) -> int:
        """The global rank at this rank's coordinates with ``moved`` axes
        set to the given indices."""
        c = dict(self.coords, **moved)
        return int(np.ravel_multi_index([c[a] for a in self.axis_names],
                                        tuple(self.shape.values())))

    def shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` sent to the next index along ``axis``: each rank returns what
        the previous one sent (zeros at index 0), the reference's
        ``ppermute`` with perm [(i, i + 1)]."""
        g = self._group((axis,))
        if g is None:
            return torch.zeros_like(t)
        i, n = self.coords[axis], self.shape[axis]
        t0 = clock.perf()
        x = _transport(self._stage(t).contiguous())
        got = torch.zeros_like(x)
        ops = []
        if i + 1 < n:
            ops.append(dist.P2POp(dist.isend, x, self.rank_at(**{axis: i + 1}), g[0]))
        if i > 0:
            ops.append(dist.P2POp(dist.irecv, got, self.rank_at(**{axis: i - 1}), g[0]))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        out = got.view(t.dtype).to(self.device)
        self._count(t, t0)
        return out

    def broadcast_flag(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        x = self._stage(torch.tensor([int(flag)], dtype=torch.int32,
                                     device=self.device))
        dist.broadcast(x, src=0)
        return bool(x.item())

    def barrier(self) -> None:
        """Every rank of the world has reached this call."""
        self.all_reduce(torch.zeros(1, device=self.device), None)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over mesh axes; the gradient of this rank's
    rows is the sum of every rank's gradient of them."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.rows = mesh, axes, x.shape[0]
        return mesh.all_gather(x, axes, dim=0)

    @staticmethod
    def backward(ctx, g):
        total = ctx.mesh.all_reduce(g.contiguous(), ctx.axes)
        i = ctx.mesh.block_index(ctx.axes)
        return total[i * ctx.rows:(i + 1) * ctx.rows], None, None


def gather_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` stacked along dim 0 in block order,
    differentiable (the MoE groups that span batch shards)."""
    return _GatherRows.apply(x, mesh, tuple(axes))
