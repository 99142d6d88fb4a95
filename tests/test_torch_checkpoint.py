"""Checkpointed, interruption-safe training in the port
(``repro_torch.train.checkpoint``), after ``tests/test_train_checkpoint.py``.

The invariant is BIT-IDENTICAL RESUME on one device type: a run
interrupted at a tree boundary and resumed produces ``array_equal`` forest
arrays and byte-stable predictions against an uninterrupted run, across
{GBT, RF} x {classification, regression} x {batched, device} engines, plus
CART's grown/pruned boundary, every learner on ``device="cpu"``. The store
is exercised adversarially (corrupt checkpoints roll back, the wrong
dataset, a changed config and another device type are refused, retention
keeps ``keep_last``), and the payload is plain data: ``state.npz`` and
``state.json``, no pickle. Against the JAX package: the port's resumed
batched GBT equals the reference's uninterrupted forest on every field,
and both packages write the same data fingerprint for the same data.
"""
import json
import os
import signal

import numpy as np
import pytest

from repro_torch.core import (
    CartLearner,
    GradientBoostedTreesLearner,
    RandomForestLearner,
    Task,
    YdfError,
)
from repro_torch.data.tabular import adult_like
from repro_torch.train.checkpoint import (
    CheckpointPolicy,
    CheckpointSession,
    checkpoint_name,
    latest_checkpoint,
    resume_training,
    write_checkpoint,
)

pytestmark = pytest.mark.resilience


def _cls_data():
    return adult_like(300, seed=5)


def _reg_data():
    rng = np.random.default_rng(7)
    x = rng.uniform(-3, 3, 400)
    z = rng.normal(size=400)
    y = np.sin(x) * 2 + 0.5 * z + rng.normal(scale=0.1, size=400)
    return {"x": x.astype(object), "z": z.astype(object),
            "y": y.astype(object)}


def _learner(kind, task, engine, **over):
    label = "income" if task == Task.CLASSIFICATION else "y"
    kw = dict(label=label, task=task, seed=11, growth_engine=engine,
              max_depth=3, num_trees=6, device="cpu")
    kw.update(over)
    if kind == "gbt":
        return GradientBoostedTreesLearner(**kw)
    # block = 2 so the 6-tree run has interior lockstep boundaries to
    # checkpoint/interrupt at (RF only checkpoints between blocks)
    kw.setdefault("tree_parallelism", 2)
    return RandomForestLearner(**kw)


def _resume(ckdir, ds, **kw):
    return resume_training(ckdir, ds, device="cpu", **kw)


def _cancel_after(n):
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] >= n
    return cancel


FOREST_ARRAYS = ("feature", "threshold", "split_bin", "cat_mask",
                 "left_child", "leaf_value", "n_nodes", "split_gain")


def assert_forests_bit_identical(a, b):
    assert a.n_trees == b.n_trees
    for k in FOREST_ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.depth == b.depth


def _predict(model, ds):
    return model.predict(ds, device="cpu")


# ------------------------------------------------------------ kill & resume

@pytest.mark.parametrize("engine", ["batched", "device"])
@pytest.mark.parametrize("task", [Task.CLASSIFICATION, Task.REGRESSION],
                         ids=["cls", "reg"])
@pytest.mark.parametrize("kind", ["gbt", "rf"])
def test_kill_and_resume_bit_identical(kind, task, engine, tmp_path):
    ds = _cls_data() if task == Task.CLASSIFICATION else _reg_data()
    clean = _learner(kind, task, engine).train(ds)

    ckdir = str(tmp_path / "ck")
    # 2nd poll: GBT stops after tree 2, RF (block=2) after tree 4, both
    # interior boundaries of the 6-tree run
    policy = CheckpointPolicy(ckdir, every_n_trees=2, keep_last=2,
                              cancel=_cancel_after(2))
    part = _learner(kind, task, engine).train(ds, checkpoint=policy)
    assert part.training_logs["interrupted"]
    # the truncated model is servable and strictly shorter than the full run
    assert 0 < part.forest.n_trees < clean.forest.n_trees
    assert np.isfinite(_predict(part, ds)).all()

    resumed = _resume(ckdir, ds)
    assert not resumed.training_logs["interrupted"]
    assert resumed.training_logs["growth_engine"] == engine
    assert any(e["event"] == "resume"
               for e in resumed.training_logs["resilience"])
    assert_forests_bit_identical(clean.forest, resumed.forest)
    assert _predict(clean, ds).tobytes() == _predict(resumed, ds).tobytes()


def test_gbt_bagging_rng_stream_survives_resume(tmp_path):
    """subsample < 1 draws the bag from the learner's rng at every tree:
    the resumed run continues the stream exactly where it stopped."""
    ds = _cls_data()
    kw = dict(subsample=0.6)
    clean = _learner("gbt", Task.CLASSIFICATION, "batched", **kw).train(ds)
    ckdir = str(tmp_path / "ck")
    _learner("gbt", Task.CLASSIFICATION, "batched", **kw).train(
        ds, checkpoint=CheckpointPolicy(ckdir, every_n_trees=1,
                                        cancel=_cancel_after(3)))
    resumed = _resume(ckdir, ds)
    assert_forests_bit_identical(clean.forest, resumed.forest)


def test_rng_state_round_trips_through_json_exactly():
    rng = np.random.default_rng(2024)
    rng.random(17)
    state = json.loads(json.dumps(rng.bit_generator.state))
    again = np.random.default_rng(0)
    again.bit_generator.state = state
    np.testing.assert_array_equal(again.random(1000), rng.random(1000))


def test_cart_grown_stage_resume(tmp_path):
    ds = _cls_data()
    kw = dict(label="income", seed=11, max_depth=4, device="cpu")
    clean = CartLearner(**kw).train(ds)
    ckdir = str(tmp_path / "ck")
    part = CartLearner(**kw).train(
        ds, checkpoint=CheckpointPolicy(ckdir, cancel=lambda: True))
    # interrupted between growth and pruning: servable, pruning pending
    assert part.training_logs["interrupted"]
    assert np.isfinite(_predict(part, ds)).all()
    _, manifest, _ = latest_checkpoint(ckdir)
    assert not manifest["done"]
    resumed = _resume(ckdir, ds)
    assert_forests_bit_identical(clean.forest, resumed.forest)
    assert _predict(clean, ds).tobytes() == _predict(resumed, ds).tobytes()


def test_sigint_becomes_cooperative_interruption(tmp_path):
    """A SIGINT mid-training must not raise KeyboardInterrupt: the session
    captures it, training stops at the next tree boundary with a final
    checkpoint, and the resumed run is bit-identical to a clean one."""
    ds = _cls_data()
    clean = _learner("gbt", Task.CLASSIFICATION, "batched").train(ds)
    ckdir = str(tmp_path / "ck")
    before = signal.getsignal(signal.SIGINT)
    calls = {"n": 0}

    def fire_sigint():                       # delivered between boundaries
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGINT)
        return False

    policy = CheckpointPolicy(ckdir, every_n_trees=2, cancel=fire_sigint)
    part = _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=policy)             # must NOT raise
    assert part.training_logs["interrupted"]
    assert any(e["event"] == "signal"
               for e in part.training_logs["resilience"])
    # the pre-training handler is restored after the session
    assert signal.getsignal(signal.SIGINT) is before
    resumed = _resume(ckdir, ds)
    assert_forests_bit_identical(clean.forest, resumed.forest)


def test_gbt_early_stopping_survives_resume(tmp_path):
    """Early-stopping bookkeeping (best_loss/best_t, the validation
    predictions) is part of the checkpoint closure: resuming mid-run must
    reproduce the clean run's best_t truncation exactly."""
    ds = _cls_data()
    kw = dict(label="income", seed=3, num_trees=40, max_depth=2,
              early_stopping="LOSS_INCREASE", early_stopping_patience=3,
              validation_ratio=0.2, device="cpu")
    clean = GradientBoostedTreesLearner(**kw).train(ds)
    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=3, cancel=_cancel_after(5))
    part = GradientBoostedTreesLearner(**kw).train(ds, checkpoint=policy)
    assert part.training_logs["interrupted"]
    resumed = _resume(ckdir, ds)
    assert_forests_bit_identical(clean.forest, resumed.forest)
    assert clean.training_logs["valid_loss"] == resumed.training_logs["valid_loss"]
    assert clean.training_logs["train_loss"] == resumed.training_logs["train_loss"]


def test_early_stopped_run_saves_done_and_resumes_to_the_same_model(tmp_path):
    ds = _cls_data()
    kw = dict(label="income", seed=3, num_trees=40, max_depth=2,
              early_stopping="LOSS_INCREASE", early_stopping_patience=3,
              validation_ratio=0.2, device="cpu")
    ckdir = str(tmp_path / "ck")
    first = GradientBoostedTreesLearner(**kw).train(
        ds, checkpoint=CheckpointPolicy(ckdir, every_n_trees=100))
    _, manifest, _ = latest_checkpoint(ckdir)
    assert manifest["done"] and manifest["trees_done"] < 40
    again = _resume(ckdir, ds)
    assert_forests_bit_identical(first.forest, again.forest)


def test_resume_of_finished_run_returns_same_model(tmp_path):
    ds = _reg_data()
    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=2)
    first = _learner("rf", Task.REGRESSION, "batched").train(
        ds, checkpoint=policy)
    _, manifest, _ = latest_checkpoint(ckdir)
    assert manifest["done"]
    again = _resume(ckdir, ds)     # grows nothing, rebuilds the model
    assert_forests_bit_identical(first.forest, again.forest)


# ------------------------------------------------------------ wall clock

class FakeClock:
    """Injectable monotonic clock: time advances only when told to."""

    def __init__(self):
        self.t = 0.0

    def advance(self, seconds):
        self.t += seconds

    def __call__(self):
        return self.t


def test_wall_clock_cadence_fires_at_boundaries(tmp_path):
    """every_seconds makes a save due by elapsed wall clock even when the
    tree cadence is far away; the timer resets AT the save, and nothing
    fires between boundaries (save() is only ever called at them)."""
    clk = FakeClock()
    pol = CheckpointPolicy(str(tmp_path / "ck"), every_n_trees=10**9,
                           every_seconds=5.0, clock=clk)
    sess = CheckpointSession(pol, config={"learner": "X"}, fingerprint="f")
    payload = {"trees": np.arange(3)}
    assert not sess.save(1, payload)          # 0.0s elapsed
    clk.advance(4.9)
    assert not sess.save(2, payload)          # 4.9s < 5.0s
    clk.advance(0.2)
    assert sess.save(3, payload)              # 5.1s since session open
    assert not sess.save(4, payload)          # timer reset by the save
    clk.advance(5.0)
    assert sess.save(5, payload)
    names = sorted(n for n in os.listdir(pol.directory) if "." not in n)
    assert names == [checkpoint_name(3), checkpoint_name(5)]


def test_wall_clock_and_tree_cadence_compose(tmp_path):
    """Either cadence being due triggers the save: trees without elapsed
    time, and elapsed time without trees."""
    clk = FakeClock()
    pol = CheckpointPolicy(str(tmp_path / "ck"), every_n_trees=3,
                           every_seconds=100.0, keep_last=10, clock=clk)
    sess = CheckpointSession(pol, config={"learner": "X"}, fingerprint="f")
    assert not sess.save(2, {})               # neither cadence due
    assert sess.save(3, {})                   # tree cadence
    clk.advance(100.0)
    assert sess.save(4, {})                   # wall clock, only 1 tree later
    assert not sess.save(5, {})


def test_wall_clock_policy_round_trips_through_manifest(tmp_path):
    """every_seconds survives the manifest so resume_training continues
    under the same wall-clock cadence, and the resumed run is still
    bit-identical to a clean one."""
    ds = _cls_data()
    clean = _learner("gbt", Task.CLASSIFICATION, "batched").train(ds)
    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=2, every_seconds=900.0,
                              cancel=_cancel_after(2))
    part = _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=policy)
    assert part.training_logs["interrupted"]
    _, manifest, _ = latest_checkpoint(ckdir)
    assert manifest["policy"]["every_seconds"] == 900.0
    resumed = _resume(ckdir, ds)
    assert_forests_bit_identical(clean.forest, resumed.forest)


def test_wall_clock_only_cadence_checkpoints_during_training(tmp_path):
    """Integration: tree cadence effectively off, FakeClock advanced via
    the cancel probe (polled at every boundary): intermediate checkpoints
    appear purely from elapsed wall clock."""
    ds = _cls_data()
    clk = FakeClock()

    def tick():                                # one boundary ~= 0.6s
        clk.advance(0.6)
        return False

    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=10**9, every_seconds=1.0,
                              keep_last=10, cancel=tick, clock=clk)
    model = _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=policy)
    saves = [e for e in model.training_logs["resilience"]
             if e["event"] == "checkpoint"]
    # 6 trees x 0.6s/boundary with a 1s cadence: interior saves happened
    # before the forced final one
    assert len(saves) >= 2
    assert any(not e["done"] for e in saves)


# ------------------------------------------------------------ store hardening

def test_checkpoint_is_plain_data(tmp_path):
    ds = _cls_data()
    ckdir = str(tmp_path / "ck")
    _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=CheckpointPolicy(ckdir, every_n_trees=2,
                                        cancel=_cancel_after(2)))
    (name,) = [n for n in os.listdir(ckdir) if "." not in n]
    path = os.path.join(ckdir, name)
    assert sorted(os.listdir(path)) == ["manifest.json", "state.json",
                                        "state.npz"]
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as z:
        assert "forest.feature" in z.files and "pred" in z.files
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["device"] == "cpu"
    assert sorted(manifest["files"]) == ["state.json", "state.npz"]


def test_corrupt_checkpoint_rolls_back_to_previous_good(tmp_path):
    ds = _cls_data()
    clean = _learner("gbt", Task.CLASSIFICATION, "batched").train(ds)
    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=1, keep_last=3,
                              cancel=_cancel_after(4))
    _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=policy)
    names = sorted(n for n in os.listdir(ckdir) if "." not in n)
    assert len(names) == 3
    # truncate the newest state file mid-byte: sha1 mismatch on read
    newest = os.path.join(ckdir, names[-1], "state.npz")
    with open(newest, "rb") as f:
        blob = f.read()
    with open(newest, "wb") as f:
        f.write(blob[: len(blob) // 2])

    resumed = _resume(ckdir, ds)
    events = resumed.training_logs["resilience"]
    assert any(e["event"] == "rollback" and e["checkpoint"] == names[-1]
               for e in events)
    # evidence quarantined, never re-trusted
    assert os.path.isdir(os.path.join(ckdir, names[-1] + ".corrupt"))
    # ... and the run still finishes bit-identical from the previous good one
    assert_forests_bit_identical(clean.forest, resumed.forest)


def test_all_checkpoints_corrupt_is_a_clear_error(tmp_path):
    ds = _cls_data()
    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=2, cancel=_cancel_after(3))
    _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=policy)
    for name in list(os.listdir(ckdir)):
        if "." in name:
            continue
        with open(os.path.join(ckdir, name, "manifest.json"), "w") as f:
            f.write("{ not json")
    with pytest.raises(YdfError, match="No valid checkpoint"):
        _resume(ckdir, ds)


def test_wrong_dataset_is_rejected(tmp_path):
    ds = _cls_data()
    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=2, cancel=_cancel_after(3))
    _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=policy)
    other = adult_like(300, seed=99)       # same shape, different rows
    with pytest.raises(YdfError, match="DIFFERENT dataset"):
        _resume(ckdir, other)


def test_changed_config_is_rejected(tmp_path):
    ds = _cls_data()
    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=2, cancel=_cancel_after(3))
    _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=policy)
    with pytest.raises(YdfError, match="different training configuration"):
        _learner("gbt", Task.CLASSIFICATION, "batched", num_trees=9).train(
            ds, checkpoint=CheckpointPolicy(ckdir))


def test_resume_on_another_device_type_is_rejected(tmp_path):
    """The manifest records the device type; a checkpoint written on the
    card is refused by a CPU training (and the other way round), because
    the two do not grow bit-identical trees."""
    ds = _cls_data()
    ckdir = str(tmp_path / "ck")
    _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=CheckpointPolicy(ckdir, every_n_trees=2,
                                        cancel=_cancel_after(2)))
    (name,) = [n for n in os.listdir(ckdir) if "." not in n]
    mpath = os.path.join(ckdir, name, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["device"] = "cuda"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(YdfError, match="written by a training on 'cuda'"):
        _resume(ckdir, ds)


def test_retention_keeps_last_k(tmp_path):
    ds = _reg_data()
    ckdir = str(tmp_path / "ck")
    policy = CheckpointPolicy(ckdir, every_n_trees=1, keep_last=2)
    _learner("rf", Task.REGRESSION, "batched", tree_parallelism=1).train(
        ds, checkpoint=policy)
    names = sorted(n for n in os.listdir(ckdir) if "." not in n)
    assert names == [checkpoint_name(5), checkpoint_name(6)]


def test_write_checkpoint_round_trips_a_nested_payload(tmp_path):
    rng = np.random.default_rng(3)
    payload = {"a": np.arange(5, dtype=np.int32), "none": None,
               "nested": {"x": rng.normal(size=(2, 3)), "s": "text",
                          "l": [1.5, float("inf")]},
               "rng": rng.bit_generator.state, "n": 7}
    write_checkpoint(str(tmp_path), 4, payload, config={"learner": "X"},
                     fingerprint="f", device="cpu")
    got, manifest, rolled = latest_checkpoint(str(tmp_path))
    assert rolled == [] and manifest["trees_done"] == 4
    np.testing.assert_array_equal(got["a"], payload["a"])
    assert got["a"].dtype == np.int32
    np.testing.assert_array_equal(got["nested"]["x"], payload["nested"]["x"])
    assert got["none"] is None and got["n"] == 7
    assert got["nested"]["s"] == "text"
    assert got["nested"]["l"] == [1.5, float("inf")]
    assert got["rng"] == payload["rng"]


# ------------------------------------------------------------ the reference

def test_resumed_gbt_equals_reference_uninterrupted_forest(tmp_path):
    from repro.core import GradientBoostedTreesLearner as RefGBT
    ds = _cls_data()
    ref = RefGBT(label="income", seed=11, max_depth=3, num_trees=6).train(ds)
    ckdir = str(tmp_path / "ck")
    _learner("gbt", Task.CLASSIFICATION, "batched").train(
        ds, checkpoint=CheckpointPolicy(ckdir, every_n_trees=2,
                                        cancel=_cancel_after(2)))
    resumed = _resume(ckdir, ds)
    assert_forests_bit_identical(ref.forest, resumed.forest)
    for k in ("tree_class", "init_pred"):
        np.testing.assert_array_equal(getattr(resumed.forest, k),
                                      getattr(ref.forest, k), err_msg=k)
    assert resumed.forest.out_dim == ref.forest.out_dim
    assert resumed.training_logs["valid_loss"] == ref.training_logs["valid_loss"]


@pytest.mark.parametrize("kind", ["gbt", "rf", "cart"])
def test_manifest_fingerprint_and_config_equal_reference(kind, tmp_path):
    from repro.core import (CartLearner as RefCart,
                            GradientBoostedTreesLearner as RefGBT,
                            RandomForestLearner as RefRF)
    from repro.train.checkpoint import CheckpointPolicy as RefPolicy
    ds = _cls_data()
    kw = dict(label="income", seed=11, max_depth=3)
    if kind != "cart":
        kw["num_trees"] = 4
    port = {"gbt": GradientBoostedTreesLearner, "rf": RandomForestLearner,
            "cart": CartLearner}[kind]
    ref = {"gbt": RefGBT, "rf": RefRF, "cart": RefCart}[kind]
    port(device="cpu", **kw).train(
        ds, checkpoint=CheckpointPolicy(str(tmp_path / "port")))
    ref(**kw).train(ds, checkpoint=RefPolicy(str(tmp_path / "ref")))
    _, mine, _ = latest_checkpoint(str(tmp_path / "port"))
    theirs = json.load(open(os.path.join(
        str(tmp_path / "ref"), checkpoint_name(mine["trees_done"]),
        "manifest.json")))
    assert mine["data_fingerprint"] == theirs["data_fingerprint"]
    assert mine["config"] == theirs["config"]
    assert (mine["trees_done"], mine["done"]) == \
        (theirs["trees_done"], theirs["done"])
