"""Fault-tolerant checkpointing of nested dicts of tensors (the LM train
state), as plain data.

  * ``save`` writes ``arrays.npz`` (leaf ``a{i}``) and ``manifest.json``
    (step, the leaves' ``/``-joined paths, dtypes and shapes, wall time,
    ``extra``) into a temporary directory that is atomically renamed: a
    preempted save never corrupts the latest step. No pickle is written or
    read; the tree is rebuilt from the paths.
  * dtypes numpy lacks (bfloat16, the float8 types) are stored as their
    raw words (uint16, uint8) with the dtype named in the manifest, and
    restored bit for bit.
  * ``save_async`` snapshots to host memory synchronously (a copy: the
    train step updates the state in place) and writes in a background
    thread; one save is in flight at a time.
  * ``restore`` places the arrays on ``device`` (None is cuda); with
    ``target``, leaves are cast to the target's dtypes and, with
    ``strict=False``, leaves missing from the checkpoint keep the
    target's values (schema evolution).
  * retention: the last ``keep`` checkpoints.
  * a state sharded over a mesh (``shardings``: a tree of
    ``sharding.NamedSharding``) saves collectively: every rank gathers
    the global arrays, rank 0 writes them, and the ranks meet at a
    barrier once the checkpoint is on disk. ``restore`` with
    ``shardings`` reads the global arrays and keeps this rank's blocks:
    the mesh that restores need not be the one that saved (RESHARDING).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.api import YdfError
from repro_torch.models.params import DTYPES
from repro_torch.obs import clock
from repro_torch.sharding import tree_gather, tree_shard

# dtypes numpy cannot hold: stored as unsigned words of their width,
# viewed through a torch integer dtype of that width
_RAW = {torch.bfloat16: (torch.int16, np.uint16),
        torch.float8_e4m3fn: (torch.uint8, np.uint8),
        torch.float8_e5m2: (torch.uint8, np.uint8)}
_TORCH = {**DTYPES, "float64": torch.float64, "int64": torch.int64,
          "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8,
          "bool": torch.bool, "float8_e5m2": torch.float8_e5m2}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            if not isinstance(k, str) or "/" in k or not k:
                raise YdfError(f"checkpoint keys must be non-empty strings "
                               f"without '/': {k!r} under {path or 'the root'}")
            out += _flatten(tree[k], f"{path}/{k}" if path else k)
        return out
    return [(path, tree)]


def _unflatten(named: dict[str, Any]):
    out: dict = {}
    for name, leaf in named.items():
        if name == "":
            return leaf
        d = out
        *parents, last = name.split("/")
        for k in parents:
            d = d.setdefault(k, {})
        d[last] = leaf
    return out


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(a numpy copy of the leaf, its dtype name)."""
    t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
    name = _dtype_name(t.dtype)
    t = t.to("cpu", copy=True)
    if t.dtype in _RAW:
        as_int, word = _RAW[t.dtype]
        return t.view(as_int).numpy().view(word), name
    return t.numpy(), name


def _from_host(a: np.ndarray, name: str) -> torch.Tensor:
    dt = _TORCH.get(name)
    if dt is None:
        raise YdfError(f"checkpoint leaf of unknown dtype {name!r}")
    if dt in _RAW:
        as_int, _ = _RAW[dt]
        ints = torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16 if as_int == torch.int16 else np.uint8))
        return ints.view(dt)
    return torch.from_numpy(np.ascontiguousarray(a))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._mesh = None             # of an in-flight sharded save

    def path(self, step: int) -> str:
        """The directory of ``step``'s checkpoint."""
        return os.path.join(self.dir, f"step_{step:010d}")

    # ---------------------------------------------------------- save
    def save(self, step: int, state, extra: dict | None = None, *,
             shardings=None) -> str:
        """Write ``state`` (this rank's blocks under ``shardings``, which
        makes the save collective); returns the checkpoint's directory."""
        self.save_async(step, state, extra, shardings=shardings)
        self.wait()
        return self.path(step)

    def save_async(self, step: int, state, extra: dict | None = None, *,
                   shardings=None) -> None:
        self.wait()  # one in-flight save at a time
        mesh = _mesh_of(shardings)
        if mesh is not None:
            state = tree_gather(state, shardings)
        self._mesh = mesh
        if mesh is not None and mesh.rank != 0:
            return                    # rank 0 writes
        host = self._snapshot(state)  # a copy, taken now

        def write():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save is written (after a sharded save,
        on every rank); raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        mesh, self._mesh = self._mesh, None
        if mesh is not None:
            mesh.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @staticmethod
    def _snapshot(state) -> list[tuple[str, np.ndarray, str]]:
        return [(name, *_to_host(leaf)) for name, leaf in _flatten(state)]

    def _write(self, step: int, host, extra: dict) -> str:
        final = self.path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, (_, a, _) in enumerate(host)})
        manifest = {"step": step, "names": [n for n, _, _ in host],
                    "dtypes": [d for _, _, d in host],
                    "shapes": [list(a.shape) for _, a, _ in host],
                    "time": clock.wall(), "extra": extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.path(s), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, target=None, strict: bool = True,
                device=None, shardings=None):
        """Load a checkpoint: (state, manifest). ``target``: a template tree
        (partial restore and dtype casts); the arrays land on ``device``
        (None is cuda); with ``shardings`` each leaf is this rank's block."""
        if shardings is None:
            return self._restore(step, target, strict, device)
        from repro_torch.core.engines import resolve_device
        dev = resolve_device(device)
        state, manifest = self._restore(step, target, strict, "cpu")
        return _to(tree_shard(state, shardings), dev), manifest

    def _restore(self, step, target, strict: bool, device):
        from repro_torch.core.engines import resolve_device
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as z:
            named = {name: _from_host(z[f"a{i}"], dt).to(dev)
                     for i, (name, dt) in enumerate(zip(manifest["names"],
                                                        manifest["dtypes"]))}
        if target is None:
            return _unflatten(named), manifest
        t_named = dict(_flatten(target))
        missing = sorted(set(t_named) - set(named))
        if missing and strict:
            raise KeyError(f"checkpoint is missing leaves {missing[:5]}...; "
                           "pass strict=False for best-effort partial restore")
        out = {}
        for name, t_leaf in t_named.items():
            if name in named:
                v = named[name]
                want = getattr(t_leaf, "dtype", None)
                if isinstance(want, torch.dtype) and v.dtype != want:
                    v = v.to(want)
                out[name] = v
            else:
                out[name] = t_leaf
        return _unflatten(out), manifest

    def restore_or_init(self, init_fn, *, device=None, shardings=None):
        step = self.latest_step()
        if step is None:
            return init_fn(), None
        return self.restore(step, device=device, shardings=shardings)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _mesh_of(shardings):
    """The mesh of a tree of NamedShardings (None for none)."""
    if shardings is None:
        return None
    if isinstance(shardings, dict):
        return next((m for m in map(_mesh_of, shardings.values()) if m is not None),
                    None)
    return shardings.mesh
