"""Checkpointed, interruption-safe training, the port of
``repro.train.checkpoint``.

The paper's *safety of use* principle says a library failure must never
silently cost the user their work. The invariant is **bit-identical
resume**: a run interrupted at any tree boundary and resumed produces the
same forest, byte for byte, as an uninterrupted run on the same device.

Three layers:

* **Atomic checkpoint store**: ``write_checkpoint``/``latest_checkpoint``.
  A checkpoint is a directory ``ckpt-<trees>`` holding the payload as plain
  data, ``state.npz`` (every array) and ``state.json`` (scalars, lists,
  ``None`` and the host RNG's ``bit_generator.state``, whose 128-bit ints
  JSON keeps exactly), and ``manifest.json`` (format version, trees done,
  the learner's train_config, the encoded-training-data fingerprint, the
  device type, and a content sha1 per payload file). No pickle is written or
  read. Writes go write-temp -> fsync -> rename, so a crash mid-write never
  leaves a half-visible checkpoint; reads verify the sha1s and ROLL BACK to
  the previous good checkpoint when a file is corrupt or truncated (the bad
  directory is renamed ``*.corrupt``, never trusted again).

* **CheckpointSession**: the seam learners drive at tree boundaries.
  ``resume()`` verifies the dataset fingerprint, the training config and
  the device type before trusting any state; ``save()`` fires every
  ``every_n_trees`` trees or ``every_seconds`` of wall clock, keeping
  ``keep_last``; ``should_stop()`` is the cooperative interruption (a
  SIGINT/SIGTERM captured by the session, or ``CheckpointPolicy.cancel``).
  On interruption the learner finalizes a servable truncated model. Every
  resume, rollback, checkpoint and interruption is an event in
  ``model.training_logs["resilience"]``.

* **resume_training(dir, dataset)**: rebuilds the learner from the
  manifest's train_config and continues it against the same directory.

A resume must run on the device type that wrote the checkpoint: the card
and the CPU grow the same trees on at least 99.5% of the structure fields,
not bit for bit (their float32 gains sum in different orders), so a
cross-device resume could not equal either uninterrupted run and is
refused.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.core.api import YdfError
from repro_torch.obs import trace

CHECKPOINT_FORMAT_VERSION = 1

_CKPT_PREFIX = "ckpt-"
_ARRAYS_FILE = "state.npz"
_FIELDS_FILE = "state.json"
_MANIFEST_FILE = "manifest.json"


# ---------------------------------------------------------------- policy

@dataclass(frozen=True)
class CheckpointPolicy:
    """Where and how often training checkpoints.

    ``cancel`` is the cooperative-interruption probe: polled at every tree
    boundary; returning True stops training AFTER the current tree, saves a
    final checkpoint and finalizes a servable truncated model. SIGINT /
    SIGTERM are captured to the same effect while a session is active.

    ``every_seconds`` adds a wall-clock cadence ON TOP of the tree cadence:
    a save becomes due when EITHER ``every_n_trees`` trees have grown since
    the last checkpoint OR ``every_seconds`` have elapsed, but it still
    only fires at the tree/block boundaries the training loop drives, never
    mid-tree. ``clock`` is the injectable time source (monotonic seconds)
    and is not part of the manifest.
    """
    directory: str
    every_n_trees: int = 10
    every_seconds: float | None = None
    keep_last: int = 2
    cancel: Callable[[], bool] | None = None
    clock: Callable[[], float] = time.monotonic

    def to_manifest(self) -> dict:
        return {"every_n_trees": int(self.every_n_trees),
                "every_seconds": (None if self.every_seconds is None
                                  else float(self.every_seconds)),
                "keep_last": int(self.keep_last)}


def as_policy(checkpoint) -> CheckpointPolicy | None:
    if checkpoint is None or isinstance(checkpoint, CheckpointPolicy):
        return checkpoint
    if isinstance(checkpoint, (str, os.PathLike)):
        return CheckpointPolicy(os.fspath(checkpoint))
    raise YdfError(
        f"checkpoint must be a CheckpointPolicy or a directory path, got "
        f"{type(checkpoint).__name__}. Example: "
        "learner.train(ds, checkpoint=CheckpointPolicy('/tmp/ck', every_n_trees=10)).")


# ---------------------------------------------------------------- payload

def _split(value, arrays: dict, path: str):
    """``value`` with every ndarray moved into ``arrays`` (under its key
    path) and replaced by a reference: the JSON half of the payload."""
    if isinstance(value, np.ndarray):
        arrays[path] = value
        return {"__array__": path}
    if isinstance(value, dict):
        return {k: _split(v, arrays, f"{path}.{k}" if path else k)
                for k, v in value.items()}
    return value


def _join(value, arrays):
    if isinstance(value, dict):
        if set(value) == {"__array__"}:
            return arrays[value["__array__"]]
        return {k: _join(v, arrays) for k, v in value.items()}
    return value


def _write_payload(directory: str, payload: dict) -> None:
    arrays: dict[str, np.ndarray] = {}
    fields = _split(payload, arrays, "")
    with open(os.path.join(directory, _ARRAYS_FILE), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(directory, _FIELDS_FILE), "w") as f:
        json.dump(fields, f)
        f.flush()
        os.fsync(f.fileno())


def _read_payload(directory: str) -> dict:
    with np.load(os.path.join(directory, _ARRAYS_FILE),
                 allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(directory, _FIELDS_FILE)) as f:
        return _join(json.load(f), arrays)


# ---------------------------------------------------------------- store

def _sha1(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:          # platforms without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def checkpoint_name(trees_done: int) -> str:
    return f"{_CKPT_PREFIX}{trees_done:08d}"


def write_checkpoint(directory: str, trees_done: int, payload: dict, *,
                     config: dict, fingerprint: str, done: bool = False,
                     policy: CheckpointPolicy | None = None,
                     keep_last: int = 2, device: str | None = None) -> str:
    """Atomically write ``<directory>/ckpt-<trees_done>``.

    Protocol: payload + manifest land in a ``.tmp-<pid>`` sibling, every
    file is fsync'ed, then ONE rename publishes the checkpoint. A crash at
    any point leaves either the previous state or a complete new checkpoint,
    never a torn one. Old checkpoints beyond ``keep_last`` are removed
    AFTER the new one is durable. ``device`` is the device type the state
    was computed on ("cuda" or "cpu").
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, checkpoint_name(trees_done))
    tmp = f"{final}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _write_payload(tmp, payload)
    manifest = {
        "format_version": CHECKPOINT_FORMAT_VERSION,
        "trees_done": int(trees_done),
        "done": bool(done),
        "config": config,
        "data_fingerprint": fingerprint,
        "device": device,
        "files": {name: _sha1(os.path.join(tmp, name))
                  for name in (_ARRAYS_FILE, _FIELDS_FILE)},
        "policy": (policy.to_manifest() if policy is not None
                   else {"every_n_trees": 10, "every_seconds": None,
                         "keep_last": keep_last}),
    }
    with open(os.path.join(tmp, _MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):      # same-boundary overwrite: replace whole
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)
    _gc(directory, keep_last)
    return final


def _gc(directory: str, keep_last: int) -> None:
    entries = sorted(_list_checkpoints(directory))
    for _, name in entries[:-max(1, keep_last)]:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _list_checkpoints(directory: str) -> list[tuple[int, str]]:
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return out
    for name in names:
        if not name.startswith(_CKPT_PREFIX) or "." in name:
            continue                      # skips *.tmp-* and *.corrupt
        try:
            out.append((int(name[len(_CKPT_PREFIX):]), name))
        except ValueError:
            continue
    return out


def _validate(path: str) -> dict | None:
    """Manifest of a checkpoint directory iff every content sha1 matches;
    None when missing/corrupt/truncated."""
    try:
        with open(os.path.join(path, _MANIFEST_FILE)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(manifest, dict) or \
            manifest.get("format_version", 1 << 30) > CHECKPOINT_FORMAT_VERSION:
        return None
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        return None
    for fname, digest in files.items():
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath) or _sha1(fpath) != digest:
            return None
    return manifest


def latest_checkpoint(directory: str
                      ) -> tuple[dict | None, dict | None, list[str]]:
    """(payload, manifest, rolled_back_names) of the newest VALID checkpoint.

    Newer checkpoints that fail validation (corrupt manifest, sha1 mismatch
    from a truncated write) are renamed ``<name>.corrupt``, evidence kept
    and never trusted again, and the previous good checkpoint wins.
    """
    rolled_back: list[str] = []
    for _, name in sorted(_list_checkpoints(directory), reverse=True):
        path = os.path.join(directory, name)
        manifest = _validate(path)
        payload = None
        if manifest is not None:
            try:
                payload = _read_payload(path)
            except Exception:            # sha1 passed but the read failed
                payload = None
        if payload is None:
            quarantine = path + ".corrupt"
            if os.path.exists(quarantine):
                shutil.rmtree(quarantine, ignore_errors=True)
            os.rename(path, quarantine)
            rolled_back.append(name)
            continue
        return payload, manifest, rolled_back
    return None, None, rolled_back


# ---------------------------------------------------------------- forest I/O

_FOREST_KEYS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
                "leaf_value", "n_nodes", "split_gain", "obl_weights",
                "obl_features", "tree_class")


def forest_payload(forest, n_trees: int) -> dict:
    """Copy the first ``n_trees`` trees of a Forest SoA into a plain dict
    (the grown-so-far state; independent of the preallocated capacity)."""
    out: dict[str, Any] = {"depth": int(forest.depth)}
    for k in _FOREST_KEYS:
        a = getattr(forest, k)
        out[k] = None if a is None else np.copy(a[:n_trees])
    return out


def restore_forest(forest, payload: dict) -> int:
    """Write a ``forest_payload`` back into a preallocated Forest. Returns
    the number of trees restored."""
    n = payload["feature"].shape[0]
    for k in _FOREST_KEYS:
        v = payload.get(k)   # a checkpoint may predate a key
        a = getattr(forest, k)
        if v is None or a is None:
            continue
        a[:n] = v
    forest.depth = max(forest.depth, payload["depth"])
    return n


# ---------------------------------------------------------------- session

def _normalize_config(config: dict) -> dict:
    return json.loads(json.dumps(config))


class CheckpointSession:
    """The tree-boundary checkpoint seam a training loop drives.

    Use as a context manager so SIGINT/SIGTERM become cooperative
    interruptions (a flag checked at tree boundaries) instead of mid-write
    crashes; the previous handlers are restored on exit.
    """

    def __init__(self, policy: CheckpointPolicy, *, config: dict,
                 fingerprint: str, device: str | None = None):
        self.policy = policy
        self.config = _normalize_config(config)
        self.fingerprint = fingerprint
        self.device = device
        self.events: list[dict] = []
        self.last_saved = 0
        # wall-clock cadence baseline: session open counts as "last save"
        # so a slow first tree cannot trigger an instant checkpoint storm
        self._last_save_time = policy.clock()
        self._interrupted = False
        self._prev_handlers: dict[int, Any] = {}

    # -- signals ------------------------------------------------------
    def __enter__(self) -> "CheckpointSession":
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    self._prev_handlers[sig] = signal.signal(
                        sig, self._on_signal)
                except (ValueError, OSError):
                    pass
        return self

    def __exit__(self, *exc) -> None:
        for sig, h in self._prev_handlers.items():
            try:
                signal.signal(sig, h)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()

    def _on_signal(self, signum, frame) -> None:
        self._interrupted = True
        self.events.append({"event": "signal", "signal": int(signum)})

    # -- lifecycle ----------------------------------------------------
    def should_stop(self) -> bool:
        if self._interrupted:
            return True
        cb = self.policy.cancel
        if cb is not None and cb():
            self._interrupted = True
            self.events.append({"event": "cancel"})
            return True
        return False

    @property
    def interrupted(self) -> bool:
        return self._interrupted

    def resume(self) -> dict | None:
        """The newest valid checkpoint's payload, or None for a fresh run.

        Rejects (YdfError with directions, nothing loaded) when the stored
        encoded-data fingerprint, training config or device type does not
        match: a checkpoint must never silently continue onto the wrong
        dataset, under different hyper-parameters, or on another device.
        """
        t0 = self.policy.clock()
        with trace.span("checkpoint/restore", directory=self.policy.directory):
            payload, manifest, rolled_back = latest_checkpoint(
                self.policy.directory)
        # quarantines newer than the loaded checkpoint count as rollbacks
        # even when an earlier reader (resume_training's manifest pre-read)
        # did the renaming before this session opened
        base = manifest["trees_done"] if manifest is not None else -1
        try:
            for name in os.listdir(self.policy.directory):
                if not name.endswith(".corrupt"):
                    continue
                stem = name[: -len(".corrupt")]
                try:
                    n = int(stem[len(_CKPT_PREFIX):])
                except ValueError:
                    continue
                if n > base and stem not in rolled_back:
                    rolled_back.append(stem)
        except FileNotFoundError:
            pass
        for name in rolled_back:
            self.events.append({"event": "rollback", "checkpoint": name,
                                "reason": "corrupt or truncated"})
        if payload is None:
            return None
        if manifest["data_fingerprint"] != self.fingerprint:
            raise YdfError(
                f"Checkpoint at {self.policy.directory!r} was written for a "
                "DIFFERENT dataset (encoded-data fingerprint "
                f"{manifest['data_fingerprint'][:12]}… != "
                f"{self.fingerprint[:12]}…). Resuming would silently mis-train. "
                "Solutions: (1) pass the original training dataset, or (2) "
                "point checkpoint.directory at a fresh directory to train "
                "from scratch.")
        if manifest["config"] != self.config:
            raise YdfError(
                f"Checkpoint at {self.policy.directory!r} was written under a "
                "different training configuration (learner / hyper-parameters "
                "/ seed changed). Bit-identical resume is impossible. "
                "Solutions: (1) recreate the learner with the original "
                "configuration (see resume_training), or (2) use a fresh "
                "checkpoint directory.")
        written_on = manifest.get("device")
        if None not in (written_on, self.device) and written_on != self.device:
            raise YdfError(
                f"Checkpoint at {self.policy.directory!r} was written by a "
                f"training on {written_on!r}, and this training runs on "
                f"{self.device!r}. The card and the CPU do not grow "
                "bit-identical trees, so the resumed forest could equal "
                "neither uninterrupted run. Solutions: (1) resume with "
                f"device={written_on!r}, or (2) use a fresh checkpoint "
                "directory.")
        self.last_saved = manifest["trees_done"]
        self.events.append({"event": "resume",
                            "trees_done": manifest["trees_done"],
                            "done": manifest["done"],
                            "restore_s": self.policy.clock() - t0})
        return payload

    def due(self, trees_done: int) -> bool:
        """Whether a cadence is due: ``every_n_trees`` trees since the last
        save, OR ``every_seconds`` of wall clock (policy.clock) since the
        last save. A trainer whose payload is costly to build asks first."""
        es = self.policy.every_seconds
        return (trees_done - self.last_saved >= self.policy.every_n_trees
                or (es is not None
                    and self.policy.clock() - self._last_save_time >= es))

    def save(self, trees_done: int, payload: dict, *, done: bool = False,
             force: bool = False) -> bool:
        """Checkpoint iff a cadence is ``due`` or forced. Returns True when
        a checkpoint was written. Called at tree/block boundaries only, so
        the wall-clock cadence can never tear a tree."""
        if trees_done <= 0 or not (force or self.due(trees_done)):
            return False
        t0 = self.policy.clock()
        with trace.span("checkpoint/save", trees_done=trees_done, done=done):
            write_checkpoint(self.policy.directory, trees_done, payload,
                             config=self.config, fingerprint=self.fingerprint,
                             done=done, policy=self.policy,
                             keep_last=self.policy.keep_last,
                             device=self.device)
        self.last_saved = trees_done
        self._last_save_time = self.policy.clock()
        self.events.append({"event": "checkpoint", "trees_done": trees_done,
                            "done": done,
                            "save_s": self._last_save_time - t0})
        return True


def open_session(checkpoint, config: dict, fingerprint: str,
                 device: str | None = None) -> CheckpointSession | None:
    """Session from a ``Learner.train(checkpoint=...)`` argument (None, a
    directory path, or a CheckpointPolicy); ``device`` is the training's
    device type."""
    policy = as_policy(checkpoint)
    if policy is None:
        return None
    return CheckpointSession(policy, config=config, fingerprint=fingerprint,
                             device=device)


# ---------------------------------------------------------------- resume

def resume_training(directory: str, dataset, valid=None, device=None):
    """Continue an interrupted training run from its checkpoint directory,
    on ``device`` (None is cuda; it must be the device type that wrote the
    checkpoint).

    The learner is rebuilt from the manifest's cross-API train_config
    (§3.10), so the caller supplies only the (same) dataset. The finished
    model is bit-identical to an uninterrupted run on that device.
    """
    _, manifest, _ = latest_checkpoint(directory)
    if manifest is None:
        raise YdfError(
            f"No valid checkpoint found in {directory!r}. A checkpoint "
            "directory is created by learner.train(..., checkpoint="
            "CheckpointPolicy(dir)). Solutions: (1) check the path, or (2) "
            "start a fresh training run with a checkpoint policy.")
    config = manifest["config"]
    if "learner" not in config:
        raise YdfError(
            f"Checkpoint at {directory!r} was not written by a Learner "
            f"(config: {sorted(config)}). Use the owning trainer's resume "
            "path.")
    from repro_torch.core.api import make_learner
    learner = make_learner(config, device=device)
    pol = manifest.get("policy", {})
    policy = CheckpointPolicy(directory,
                              every_n_trees=pol.get("every_n_trees", 10),
                              every_seconds=pol.get("every_seconds"),
                              keep_last=pol.get("keep_last", 2))
    return learner.train(dataset, valid, checkpoint=policy)
