"""The port's ``repro_torch.distributed.checkpoint.CheckpointManager``: the
reference's ``tests/test_checkpoint.py`` on the port (round trip,
retention, partial restore, dtype cast, asynchronous save, atomicity),
plus what the port adds: plain data only (``manifest.json`` and
``arrays.npz``, no pickle written or read), bfloat16 and float8 leaves
restored bit for bit from their raw words, and an asynchronous save
that holds the state as it was when called (the train step updates it
in place)."""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.core.api import YdfError
from repro_torch.distributed.checkpoint import CheckpointManager

CPU = "cpu"


def _state(x=1.0):
    return {"params": {"w": torch.full((4, 4), x), "b": torch.zeros(3)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _state(2.0), extra={"note": "hi"})
    state, manifest = mgr.restore(device=CPU)
    assert manifest["step"] == 10 and manifest["extra"]["note"] == "hi"
    assert torch.equal(state["params"]["w"], torch.full((4, 4), 2.0))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 7
    assert manifest["names"] == ["params/b", "params/w", "step"]


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    assert mgr.all_steps() == [3, 4]


def test_partial_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"w": torch.ones((2, 2))}})
    target = {"params": {"w": torch.zeros((2, 2)), "new_leaf": torch.full((3,), 9.0)}}
    with pytest.raises(KeyError):
        mgr.restore(1, target=target, strict=True, device=CPU)
    state, _ = mgr.restore(1, target=target, strict=False, device=CPU)
    assert torch.equal(state["params"]["w"], torch.ones((2, 2)))
    assert torch.equal(state["params"]["new_leaf"], torch.full((3,), 9.0))  # kept init


def test_dtype_cast_on_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((2,), dtype=torch.float32)})
    state, _ = mgr.restore(1, target={"w": torch.zeros((2,), dtype=torch.bfloat16)},
                           device=CPU)
    assert state["w"].dtype == torch.bfloat16


def test_async_save_holds_the_state_as_it_was(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(5.0)
    mgr.save_async(5, state)
    state["params"]["w"].fill_(-1.0)        # the next step writes in place
    mgr.wait()
    restored, _ = mgr.restore(5, device=CPU)
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 5.0))


def test_atomicity_tmp_cleanup(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    # a leftover .tmp dir (crashed save) must not be listed as a checkpoint
    os.makedirs(os.path.join(str(tmp_path), "step_0000000002.tmp"))
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2])
def test_low_precision_leaves_round_trip_bit_for_bit(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((5, 7), generator=g) * 30).to(dtype)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan")])
    if dtype == torch.float8_e4m3fn:            # no infinities in e4m3fn
        special = special[[0, 1, 4]]
    y = special.to(dtype)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": x, "nested": {"y": y}})
    path = os.path.join(str(tmp_path), "step_0000000003")
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    name = str(dtype).replace("torch.", "")
    assert manifest["dtypes"] == [name, name]
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as z:
        words = z["a1"]                           # x: the raw words
        assert words.dtype == (np.uint16 if dtype == torch.bfloat16 else np.uint8)
    state, _ = mgr.restore(3, device=CPU)
    for ours, want in ((state["x"], x), (state["nested"]["y"], y)):
        assert ours.dtype == dtype
        bits = torch.int16 if dtype == torch.bfloat16 else torch.uint8
        assert torch.equal(ours.view(bits), want.view(bits))


def test_plain_data_only(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    final = mgr.save(2, _state())
    assert sorted(os.listdir(final)) == ["arrays.npz", "manifest.json"]
    with zipfile.ZipFile(os.path.join(final, "arrays.npz")) as z:
        assert sorted(z.namelist()) == ["a0.npy", "a1.npy", "a2.npy"]
    json.load(open(os.path.join(final, "manifest.json")))      # plain JSON


def test_restore_or_init_and_bad_keys(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state, manifest = mgr.restore_or_init(lambda: _state(3.0), device=CPU)
    assert manifest is None and float(state["params"]["w"][0, 0]) == 3.0
    mgr.save(4, state)
    state, manifest = mgr.restore_or_init(lambda: _state(0.0), device=CPU)
    assert manifest["step"] == 4 and float(state["params"]["w"][0, 0]) == 3.0
    for bad in ({"a/b": torch.ones(1)}, {"": torch.ones(1)}, {1: torch.ones(1)}):
        with pytest.raises(YdfError, match="checkpoint keys"):
            mgr.save(5, bad)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(device=CPU)


def test_an_async_save_that_fails_raises_in_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(9, _state(), extra={"not json": object()})
    with pytest.raises(TypeError):
        mgr.wait()
    mgr.wait()                              # raised once
    assert mgr.all_steps() == []            # nothing half-written is listed
