"""The port's sklearn import (``repro_torch.interop.from_sklearn``) against
sklearn's own predictions and the JAX package's import, on the scenarios of
``tests/test_interop_sklearn.py``. The module skips when sklearn is absent.

  * CART, Random Forest and ExtraTrees (classifier and regressor): the
    imported forest equals the reference's import on every field, the port
    predicts ``array_equal`` with the reference's import, and within the
    reference test's 1e-5 of sklearn's ``predict_proba``/``predict``.
  * Gradient boosting: the port's import predicts within 1e-5 of sklearn's
    ``predict_proba``/``predict``, the reference test's tolerance. The
    reference's import of the same estimators raises AttributeError under
    sklearn >= 1.6 (it reads the removed ``est._estimator_type``); a
    companion test pins that, so a change of either side shows.
  * Ties at the threshold, feature names, refusals and save/load as in the
    reference test; the import raises ``YdfError`` without a card unless
    given ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

sklearn = pytest.importorskip("sklearn")

from sklearn.ensemble import (  # noqa: E402
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from sklearn.tree import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)

from repro.interop import from_sklearn as ref_from_sklearn  # noqa: E402
from repro_torch.core import Model, YdfError  # noqa: E402
from repro_torch.core.models import (  # noqa: E402
    CartModel,
    GradientBoostedTreesModel,
    RandomForestModel,
)
from repro_torch.interop import from_sklearn  # noqa: E402

CPU = "cpu"
FIELDS = ("feature", "threshold", "split_bin", "cat_mask", "left_child",
          "leaf_value", "n_nodes", "split_gain", "init_pred")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU engines' small torch ops run on one thread: test workers
    share the host, and a thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(600, 5)).astype(np.float32)
    y_bin = (X[:, 0] + np.square(X[:, 1]) + rng.normal(0, 0.3, 600) > 0.7)
    y_multi = np.where(X[:, 2] > 0.4, 2, y_bin.astype(int))
    y_reg = (2 * X[:, 0] + np.sin(3 * X[:, 1])
             + rng.normal(0, 0.1, 600)).astype(np.float64)
    X_test = rng.normal(size=(200, 5)).astype(np.float32)
    return X, y_bin.astype(int), y_multi, y_reg, X_test


def _cols(A):
    return {f"f{i}": A[:, i] for i in range(A.shape[1])}


def _fit(make, target, data):
    X, y_bin, y_multi, y_reg, _ = data
    return make().fit(X, {"bin": y_bin, "multi": y_multi, "reg": y_reg}[target])


def _sklearn_out(est, target, X):
    return est.predict(X) if target == "reg" else est.predict_proba(X)


TREES = [
    ("dt_cls", lambda: DecisionTreeClassifier(max_depth=8, random_state=0),
     "bin", CartModel),
    ("dt_reg", lambda: DecisionTreeRegressor(max_depth=8, random_state=0),
     "reg", CartModel),
    ("rf_cls", lambda: RandomForestClassifier(n_estimators=20, random_state=0),
     "bin", RandomForestModel),
    ("rf_multi", lambda: RandomForestClassifier(n_estimators=15, random_state=0),
     "multi", RandomForestModel),
    ("rf_reg", lambda: RandomForestRegressor(n_estimators=15, random_state=0),
     "reg", RandomForestModel),
    ("extra_cls", lambda: ExtraTreesClassifier(n_estimators=10, random_state=0),
     "bin", RandomForestModel),
    ("extra_reg", lambda: ExtraTreesRegressor(n_estimators=10, random_state=0),
     "reg", RandomForestModel),
]

GBTS = [
    ("gbt_cls", lambda: GradientBoostingClassifier(n_estimators=25,
                                                   random_state=0), "bin"),
    ("gbt_multi", lambda: GradientBoostingClassifier(n_estimators=12,
                                                     random_state=0), "multi"),
    ("gbt_reg", lambda: GradientBoostingRegressor(n_estimators=25,
                                                  random_state=0), "reg"),
]


@pytest.mark.parametrize("name,make,target,model_cls", TREES,
                         ids=[c[0] for c in TREES])
def test_tree_imports_equal_the_reference_and_sklearn(data, name, make,
                                                      target, model_cls):
    X_test = data[4]
    est = _fit(make, target, data)
    model = from_sklearn(est, device=CPU)
    ref = ref_from_sklearn(est)
    assert isinstance(model, model_cls)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(model.forest, k),
                                      getattr(ref.forest, k), err_msg=k)
    assert model.forest.depth == ref.forest.depth
    assert model.forest.tree_class is None and ref.forest.tree_class is None
    assert (model.features, model.label, model.classes) == \
        (ref.features, ref.label, ref.classes)
    ours = model.predict(_cols(X_test), device=CPU)
    np.testing.assert_array_equal(ours, ref.predict(_cols(X_test)))
    np.testing.assert_allclose(ours, _sklearn_out(est, target, X_test),
                               atol=1e-5)
    if target != "reg":
        assert model.classes == [str(c) for c in est.classes_]
        np.testing.assert_array_equal(
            model.predict_class(_cols(X_test), device=CPU),
            est.predict(X_test))


@pytest.mark.parametrize("name,make,target", GBTS, ids=[c[0] for c in GBTS])
def test_gbt_import_predicts_as_sklearn(data, name, make, target):
    X_test = data[4]
    est = _fit(make, target, data)
    model = from_sklearn(est, device=CPU)
    assert isinstance(model, GradientBoostedTreesModel)
    ours = np.asarray(model.predict(_cols(X_test), device=CPU))
    np.testing.assert_allclose(ours, _sklearn_out(est, target, X_test),
                               atol=1e-5)
    if target != "reg":
        assert model.classes == [str(c) for c in est.classes_]
        np.testing.assert_array_equal(
            model.predict_class(_cols(X_test), device=CPU),
            est.predict(X_test))
        # the raw scores are sklearn's decision_function
        raw = np.asarray(model.predict_scores(_cols(X_test), device=CPU))
        want = np.asarray(est.decision_function(X_test)).reshape(len(X_test),
                                                                 -1)
        np.testing.assert_allclose(raw, want, atol=1e-5)


@pytest.mark.parametrize("name,make,target", GBTS, ids=[c[0] for c in GBTS])
def test_reference_gbt_import_reads_the_removed_estimator_type(data, name,
                                                               make, target):
    """The divergence the port corrects (ROADMAP C): the reference reads
    ``est._estimator_type``, which sklearn >= 1.6 no longer has."""
    est = _fit(make, target, data)
    if hasattr(est, "_estimator_type"):     # sklearn < 1.6: the reference works
        np.testing.assert_allclose(
            ref_from_sklearn(est).predict(_cols(data[4])),
            from_sklearn(est, device=CPU).predict(_cols(data[4]), device=CPU))
        return
    with pytest.raises(AttributeError, match="_estimator_type"):
        ref_from_sklearn(est)


@pytest.mark.parametrize("engine", ["ref", "vectorized", "bucketed", "naive"])
def test_imported_models_through_the_cpu_engines(data, engine):
    X, y_bin, _, _, X_test = data
    est = RandomForestClassifier(n_estimators=12, max_depth=9,
                                 random_state=1).fit(X, y_bin)
    model = from_sklearn(est, device=CPU)
    model.compile(engine, CPU)
    assert model.predictor(engine, CPU).name == engine
    np.testing.assert_allclose(
        model.predict(_cols(X_test), engine=engine, device=CPU),
        est.predict_proba(X_test), atol=1e-5)


def test_imported_gbt_through_serving_bundle_and_microbatcher(data):
    from repro_torch.serving.forest import MicroBatcher, make_forest_server
    X, y_bin, _, _, X_test = data
    est = GradientBoostingClassifier(n_estimators=15, random_state=2)
    est.fit(X, y_bin)
    model = from_sklearn(est, device=CPU)
    bundle = make_forest_server(model, "vectorized", device=CPU)
    mb = MicroBatcher(bundle=bundle, max_batch=128)
    t1 = mb.submit(_cols(X_test[:70]))
    t2 = mb.submit(_cols(X_test[70:]))
    out = np.concatenate([mb.result(t1), mb.result(t2)])
    np.testing.assert_allclose(out, est.predict_proba(X_test), atol=1e-5)
    assert mb.dispatches >= 1


def test_threshold_ties_route_like_sklearn():
    X = np.repeat(np.arange(8, dtype=np.float32), 10)[:, None]
    y = (X[:, 0] >= 4).astype(int)
    est = DecisionTreeClassifier(random_state=0).fit(X, y)
    model = from_sklearn(est, device=CPU)
    probe = np.arange(8, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(model.forest.threshold,
                                  ref_from_sklearn(est).forest.threshold)
    np.testing.assert_allclose(model.predict({"f0": probe[:, 0]}, device=CPU),
                               est.predict_proba(probe), atol=1e-6)


def test_feature_names_from_override_and_errors(data):
    X, y_bin, _, _, X_test = data
    est = DecisionTreeClassifier(max_depth=4, random_state=0).fit(X, y_bin)
    names = ["a", "b", "c", "d", "e"]
    model = from_sklearn(est, label="income", feature_names=names, device=CPU)
    assert model.features == names and model.label == "income"
    np.testing.assert_array_equal(
        model.predict({n: X_test[:8, i] for i, n in enumerate(names)},
                      device=CPU),
        est.predict_proba(X_test[:8]).astype(np.float32))
    with pytest.raises(YdfError, match="one name per training column"):
        from_sklearn(est, feature_names=["too", "few"], device=CPU)


def test_unfitted_and_unsupported_estimators_raise(data):
    from sklearn.ensemble import HistGradientBoostingClassifier
    from sklearn.linear_model import LogisticRegression
    X, y_bin, _, _, _ = data
    with pytest.raises(YdfError, match="not fitted"):
        from_sklearn(DecisionTreeClassifier(), device=CPU)
    with pytest.raises(YdfError, match="unsupported estimator"):
        from_sklearn(LogisticRegression().fit(X, y_bin), device=CPU)
    with pytest.raises(YdfError, match="stores bins"):
        from_sklearn(HistGradientBoostingClassifier(max_iter=2).fit(X, y_bin),
                     device=CPU)
    with pytest.raises(YdfError, match="n_outputs_"):
        from_sklearn(DecisionTreeRegressor(max_depth=2).fit(
            X, np.stack([y_bin, y_bin], 1)), device=CPU)


def test_imported_model_save_load_roundtrip(tmp_path, data):
    X, y_bin, _, y_reg, X_test = data
    for est in (RandomForestClassifier(n_estimators=8,
                                       random_state=3).fit(X, y_bin),
                GradientBoostingRegressor(n_estimators=6,
                                          random_state=3).fit(X, y_reg)):
        model = from_sklearn(est, device=CPU)
        before = model.predict(_cols(X_test), device=CPU)
        path = str(tmp_path / type(est).__name__)
        model.save(path)
        loaded = Model.load(path)
        assert type(loaded) is type(model)
        np.testing.assert_array_equal(loaded.predict(_cols(X_test),
                                                     device=CPU), before)


def test_import_needs_a_card_unless_given_the_cpu(data):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    X, y_bin, _, _, _ = data
    est = DecisionTreeClassifier(max_depth=3, random_state=0).fit(X, y_bin)
    with pytest.raises(YdfError, match="device='cpu'"):
        from_sklearn(est)


def test_the_import_module_does_not_import_sklearn():
    import ast
    from pathlib import Path
    import repro_torch.interop.sklearn as mod
    tree = ast.parse(Path(mod.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] == "sklearn"]
