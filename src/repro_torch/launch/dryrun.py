"""Dry run of the production meshes, the port of ``repro.launch.dryrun``.

For every (architecture x applicable shape x mesh) cell: the shapes of the
step's arguments (train: state and batch; prefill: params and batch;
decode: params, batch and cache) as meta tensors, every leaf's resolved
PartitionSpec on the abstract production mesh (16x16, or 2x16x16), the
bytes each device holds of them (``input_bytes_per_device``, the
reference's ``shard_bytes`` rule: a leaf's bytes over the product of its
spec's mesh axes, rounded up), the model FLOPs, and that share of one
H100's 80 GB. It allocates and compiles nothing. The reference also
records XLA's ``cost_analysis``, ``memory_analysis`` and the collectives of
the compiled HLO; eager PyTorch has none of them, so those keys are left
out.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-done]

The driver writes results/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")


def _cell_path(arch: str, shape: str, mesh: str, suffix: str = "") -> str:
    name = f"{arch}__{shape}__{mesh}{('__' + suffix) if suffix else ''}.json"
    return os.path.abspath(os.path.join(RESULTS_DIR, name))


def shard_bytes(specs, shardings, mesh) -> int:
    """Bytes one device holds of a tree of meta tensors under a tree of
    NamedShardings (the reference's rule: ceil(bytes / blocks))."""
    from repro_torch.models.params import at, leaves
    from repro_torch.sharding import spec_axes
    total = 0
    for path, leaf in leaves(specs):
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        denom = 1
        for part in at(shardings, path).spec:
            for ax in spec_axes(part):
                denom *= mesh.shape[ax]
        total += -(-n // denom)
    return total


def cell_args(cfg, shape):
    """(meta-tensor trees, logical-axes trees) of the cell's step arguments."""
    from repro_torch.models import lm
    from repro_torch.serving.decode import serve_state_specs
    from repro_torch.train.step import train_state_specs
    batch = (lm.batch_spec(cfg, shape), lm.batch_axes(cfg, shape))
    if shape.kind == "train":
        state = train_state_specs(cfg)
        return (state[0], batch[0]), (state[1], batch[1])
    p_specs, p_axes = serve_state_specs(cfg)
    if shape.kind == "prefill":
        return (p_specs, batch[0]), (p_axes, batch[1])
    cache = lm.cache_spec(cfg, shape.global_batch, shape.seq_len)
    return (p_specs, batch[0], cache), (p_axes, batch[1], lm.cache_axes(cfg))


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, out_path: str | None,
             overrides: dict | None = None,
             rules_overrides: dict | None = None) -> dict:
    from repro_torch.configs import SHAPES, applicable_shapes, get_arch
    from repro_torch.core.api import YdfError
    from repro_torch.launch.mesh import H100_HBM_BYTES, production_mesh_shape
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models.params import at, leaves as tree_leaves
    from repro_torch.obs import clock
    from repro_torch.sharding import rules_for, tree_shardings

    cfg = get_arch(arch_name)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    if shape_name not in applicable_shapes(cfg):
        raise YdfError(f"{shape_name} not applicable to {arch_name} "
                       "(DESIGN.md §Arch-applicability)")
    mesh = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    long_ctx = shape.seq_len >= 2 ** 19
    rules = rules_for("train" if shape.kind == "train" else "serve", long_context=long_ctx)
    if rules_overrides:
        rules.update(rules_overrides)

    t0 = clock.perf()
    specs, axes = cell_args(cfg, shape)
    shardings = [tree_shardings(a, mesh, rules, s) for a, s in zip(axes, specs)]
    input_bytes = sum(shard_bytes(s, sh, mesh) for s, sh in zip(specs, shardings))
    names = ("state", "batch") if shape.kind == "train" else ("params", "batch", "cache")
    leaves = {name: {"/".join(path): {"shape": list(leaf.shape),
                                      "dtype": str(leaf.dtype).replace("torch.", ""),
                                      "spec": list(at(sh, path).spec)}
                     for path, leaf in tree_leaves(s)}
              for name, s, sh in zip(names, specs, shardings)}
    flops = model_flops(cfg, shape)
    seconds = clock.perf() - t0

    print(f"== {arch_name} x {shape_name} x {mesh_kind} ({mesh.shape}) ==")
    print(f"input bytes/device: {input_bytes:.3e} "
          f"({input_bytes / H100_HBM_BYTES * 100:.1f}% of the H100's 80 GB)")
    print(f"model flops: {flops:.4e}")

    record = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(mesh.shape), "chips": mesh.size,
        "kind": shape.kind,
        "seconds": seconds,
        "input_bytes_per_device": input_bytes,
        "hbm_share": input_bytes / H100_HBM_BYTES,
        "model_flops": flops,
        "leaves": leaves,
        "overrides": overrides or {},
        "rules_overrides": {k: list(v) for k, v in (rules_overrides or {}).items()},
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def all_cells(mesh_kinds=("single", "multi")):
    from repro_torch.configs import applicable_shapes, get_arch, list_archs
    for arch in list_archs():
        for shape in applicable_shapes(get_arch(arch)):
            for mk in mesh_kinds:
                yield arch, shape, mk


def driver(mesh_kinds, skip_done: bool, overrides=None, suffix: str = "") -> int:
    """Every cell in this process; a failing cell's traceback goes to its
    ``.err`` file. Returns the number of failed cells."""
    cells = list(all_cells(mesh_kinds))
    os.makedirs(RESULTS_DIR, exist_ok=True)
    failures = 0
    for i, (arch, shape, mk) in enumerate(cells):
        out = _cell_path(arch, shape, mk, suffix)
        if skip_done and os.path.exists(out):
            continue
        try:
            run_cell(arch, shape, mk, out, overrides)
            status = "ok"
        except Exception:   # one cell's failure is recorded, the rest run
            failures += 1
            status = "FAIL"
            with open(out.replace(".json", ".err"), "w") as f:
                f.write(traceback.format_exc())
        print(f"[{i + 1}/{len(cells)}] {arch} x {shape} x {mk}: {status}", flush=True)
    return failures


def _parse_overrides(items) -> dict:
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value")
    ap.add_argument("--rules-override", action="append", default=[],
                    help="sharding rule override logical=axis1,axis2")
    ap.add_argument("--suffix", default="", help="result-file suffix (driver mode)")
    args = ap.parse_args(argv)

    kinds = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    overrides = _parse_overrides(args.override)
    if args.all:
        sys.exit(1 if driver(kinds, args.skip_done, overrides, args.suffix) else 0)
    rules_overrides = {}
    for ov in args.rules_override:
        k, v = ov.split("=", 1)
        rules_overrides[k] = tuple(a for a in v.split(",") if a)
    for mk in kinds:
        out = args.out or _cell_path(args.arch, args.shape, mk)
        run_cell(args.arch, args.shape, mk, out, overrides, rules_overrides)


if __name__ == "__main__":
    main()
