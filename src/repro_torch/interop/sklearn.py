"""scikit-learn model import (paper §2.1 "integration with other libraries"),
the port's copy of ``repro.interop.sklearn``.

``from_sklearn(estimator)`` converts a fitted sklearn tree-based estimator
into the matching model class here — the imported model then flows unchanged
through the compiled serving stack: ``compile()``, the CUDA traversal
kernels, ``serving/forest.py`` bundles and the MicroBatcher. This is the
serving win the inference-platform comparison (Guan et al., 2023) measures:
one fast runtime for forests trained anywhere.

The import reads the estimator's public arrays and methods only and never
imports sklearn, so it runs where sklearn is not installed (the fitted
estimator arrives from elsewhere). ``device`` is where the model's predictor
is compiled (None: the card; without one ``from_sklearn`` raises
``YdfError`` unless ``device="cpu"`` is passed).

Supported estimators -> model classes:

  * ``DecisionTreeClassifier`` / ``ExtraTreeClassifier``     -> CartModel
  * ``DecisionTreeRegressor``  / ``ExtraTreeRegressor``      -> CartModel
  * ``RandomForestClassifier`` / ``ExtraTreesClassifier``    -> RandomForestModel
  * ``RandomForestRegressor``  / ``ExtraTreesRegressor``     -> RandomForestModel
  * ``GradientBoostingClassifier`` / ``GradientBoostingRegressor``
                                                 -> GradientBoostedTreesModel

Prediction equivalence (enforced in tests, 1e-5): probabilities match
``predict_proba``, regressions match ``predict``. Two conversion details
make that exact:

  * sklearn splits send ``x <= threshold`` LEFT; our conditions send
    ``x >= threshold`` RIGHT. The imported threshold is lifted to the
    smallest float32 strictly above sklearn's float64 threshold, so both
    route identically for every float32 input.
  * sklearn classification leaves hold per-class counts (fractions since
    sklearn 1.4); both normalize to the same distribution.

Caveats (documented, §2.1): sklearn imputes nothing — imported numerical
features impute missing values with 0.0 at serving time; estimators fitted
with NaN support (missing_go_to_left) are imported without that routing.

Gradient boosting: the initial raw score is recovered from the estimator's
``decision_function`` (classifiers) or ``predict`` (regressors), the kind
taken from the estimator's class. The reference reads the private
``est._estimator_type`` there, which sklearn >= 1.6 no longer has, so its
import of these estimators raises AttributeError (ROADMAP C).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import Task, YdfError
from repro_torch.core.py_tree import (
    CartBuilder,
    GradientBoostedTreesBuilder,
    Leaf,
    LogitValue,
    NonLeaf,
    NumericalHigherThan,
    ProbabilityValue,
    RandomForestBuilder,
    RegressionValue,
    Tree,
)

_SUPPORTED = (
    "DecisionTreeClassifier, DecisionTreeRegressor, ExtraTreeClassifier, "
    "ExtraTreeRegressor, RandomForestClassifier, RandomForestRegressor, "
    "ExtraTreesClassifier, ExtraTreesRegressor, GradientBoostingClassifier, "
    "GradientBoostingRegressor")


def _strictly_above(t: float) -> float:
    """Smallest float32 strictly greater than the float64 ``t``: makes our
    ``x >= t'`` route exactly like sklearn's ``x > t`` for float32 x."""
    t32 = np.float32(t)
    if t32 <= t:
        t32 = np.nextafter(t32, np.float32(np.inf))
    return float(t32)


def _check_fitted(est, attr: str) -> None:
    if not hasattr(est, attr):
        raise YdfError(
            f"{type(est).__name__} is not fitted (missing {attr!r}). "
            "Solution: call estimator.fit(X, y) before from_sklearn().")


def _convert_tree(sk_tree, value_of) -> Tree:
    """sklearn ``Tree`` arrays -> typed nodes. sklearn allocates children
    after parents, so a reverse-index sweep builds bottom-up without
    recursion (imported trees can be deeper than the recursion limit)."""
    left = sk_tree.children_left
    right = sk_tree.children_right
    feature = sk_tree.feature
    threshold = sk_tree.threshold
    nodes: list = [None] * sk_tree.node_count
    for i in range(sk_tree.node_count - 1, -1, -1):
        if left[i] < 0:  # TREE_LEAF
            nodes[i] = Leaf(value=value_of(i))
        else:
            nodes[i] = NonLeaf(
                condition=NumericalHigherThan(
                    feature=int(feature[i]),
                    threshold=_strictly_above(float(threshold[i]))),
                neg_child=nodes[int(left[i])],   # sklearn: x <= t goes left
                pos_child=nodes[int(right[i])])
    return Tree(root=nodes[0])


def _classification_value(sk_tree):
    values = sk_tree.value  # (n_nodes, 1, C): counts, or fractions >= 1.4

    def value_of(i):
        v = np.asarray(values[i][0], np.float64)
        s = v.sum()
        p = v / s if s > 0 else np.full(len(v), 1.0 / len(v))
        return ProbabilityValue(tuple(float(x) for x in p))

    return value_of


def _regression_value(sk_tree, scale: float = 1.0, logit: bool = False):
    values = sk_tree.value

    def value_of(i):
        v = float(values[i][0][0]) * scale
        return LogitValue(v) if logit else RegressionValue(v)

    return value_of


def _feature_columns(est, feature_names):
    n = int(est.n_features_in_)
    if feature_names is None:
        feature_names = [str(f) for f in getattr(
            est, "feature_names_in_", [f"f{i}" for i in range(n)])]
    if len(feature_names) != n:
        raise YdfError(
            f"feature_names has {len(feature_names)} entries but the "
            f"estimator was fitted on {n} features. Solution: pass one name "
            "per training column, in column order.")
    return list(feature_names)


def _single_output_or_raise(est) -> None:
    if getattr(est, "n_outputs_", 1) != 1:
        raise YdfError(
            f"{type(est).__name__} has n_outputs_={est.n_outputs_}; only "
            "single-label classification and scalar regression import. "
            "Solution: fit one estimator per output.")


# ------------------------------------------------------------------ converters

def _convert_cart(est, label, feature_names, classification: bool, device):
    _check_fitted(est, "tree_")
    _single_output_or_raise(est)
    names = _feature_columns(est, feature_names)
    if classification:
        builder = CartBuilder(label=label, task=Task.CLASSIFICATION,
                              features=names,
                              classes=[str(c) for c in est.classes_])
        builder.add_tree(_convert_tree(est.tree_, _classification_value(est.tree_)))
    else:
        builder = CartBuilder(label=label, task=Task.REGRESSION,
                              features=names)
        builder.add_tree(_convert_tree(est.tree_, _regression_value(est.tree_)))
    return builder.build(device=device)


def _convert_forest(est, label, feature_names, classification: bool, device):
    _check_fitted(est, "estimators_")
    _single_output_or_raise(est)
    names = _feature_columns(est, feature_names)
    if classification:
        # sklearn averages per-tree class distributions -> mean aggregation
        builder = RandomForestBuilder(
            label=label, task=Task.CLASSIFICATION, features=names,
            classes=[str(c) for c in est.classes_], winner_take_all=False)
        for t in est.estimators_:
            builder.add_tree(_convert_tree(t.tree_,
                                           _classification_value(t.tree_)))
    else:
        builder = RandomForestBuilder(label=label, task=Task.REGRESSION,
                                      features=names, winner_take_all=False)
        for t in est.estimators_:
            builder.add_tree(_convert_tree(t.tree_, _regression_value(t.tree_)))
    return builder.build(device=device)


def _gbt_init_pred(est, trees_by_class: list[list], lr: float,
                   n_features: int, K: int, classification: bool) -> np.ndarray:
    """The constant initial raw score, recovered through public API only:
    raw(x0) - lr * sum of tree outputs at x0, for a probe row x0. A
    classifier's raw score is its ``decision_function``, a regressor's its
    ``predict``; ``classification`` comes from the estimator's class."""
    x0 = np.zeros((1, n_features), np.float64)
    if classification:
        raw = np.atleast_2d(est.decision_function(x0))  # (1,) -> (1, 1)
        if raw.shape == (1, 1) and K == 1:
            raw = raw.reshape(1, 1)
    else:
        raw = est.predict(x0).reshape(1, 1)
    init = np.zeros(K, np.float32)
    for k in range(K):
        tree_sum = sum(float(t.predict(x0)[0]) for t in trees_by_class[k])
        init[k] = np.float32(raw[0, k if raw.shape[1] > 1 else 0]
                             - lr * tree_sum)
    return init


def _convert_gbt(est, label, feature_names, classification: bool, device):
    _check_fitted(est, "estimators_")
    names = _feature_columns(est, feature_names)
    lr = float(est.learning_rate)
    stages = est.estimators_              # (n_stages, K) DecisionTreeRegressors
    K = stages.shape[1]
    if classification:
        classes = [str(c) for c in est.classes_]
        builder = GradientBoostedTreesBuilder(
            label=label, task=Task.CLASSIFICATION, features=names,
            classes=classes)
        if builder.loss.out_dim != K:
            raise YdfError(
                f"GradientBoostingClassifier has {K} tree column(s) but "
                f"{len(classes)} classes map to {builder.loss.out_dim} "
                "output dimension(s); this estimator's loss layout is not "
                "supported.")
    else:
        builder = GradientBoostedTreesBuilder(label=label,
                                              task=Task.REGRESSION,
                                              features=names)
        if K != 1:
            raise YdfError(
                f"GradientBoostingRegressor with {K} tree columns is not "
                "supported (expected scalar regression).")
    trees_by_class: list[list] = [[] for _ in range(K)]
    for stage in stages:
        for k in range(K):
            trees_by_class[k].append(stage[k])
            builder.add_tree(
                _convert_tree(stage[k].tree_,
                              _regression_value(stage[k].tree_, scale=lr,
                                                logit=True)),
                tree_class=k if K > 1 else None)
    builder.init_pred = _gbt_init_pred(est, trees_by_class, lr,
                                       int(est.n_features_in_), K,
                                       classification)
    return builder.build(device=device)


# ------------------------------------------------------------------ public API

def from_sklearn(estimator, *, label: str = "label",
                 feature_names: list[str] | None = None, device=None):
    """Convert a fitted sklearn tree-based estimator into a servable model.

    ``label`` names the synthesized label column (sklearn does not keep
    one); ``feature_names`` overrides the feature column names (defaults to
    ``feature_names_in_`` when the estimator was fitted on a DataFrame,
    else ``f0..f{n-1}``). The returned model predicts from raw feature
    dicts/column mappings like any trained model. ``device`` is where its
    predictor is compiled (None: the card).
    """
    from repro_torch.core.engines import resolve_device
    resolve_device(device)               # no card: raise before any work

    kind = type(estimator).__name__
    table = {
        "DecisionTreeClassifier": (_convert_cart, True),
        "ExtraTreeClassifier": (_convert_cart, True),
        "DecisionTreeRegressor": (_convert_cart, False),
        "ExtraTreeRegressor": (_convert_cart, False),
        "RandomForestClassifier": (_convert_forest, True),
        "ExtraTreesClassifier": (_convert_forest, True),
        "RandomForestRegressor": (_convert_forest, False),
        "ExtraTreesRegressor": (_convert_forest, False),
        "GradientBoostingClassifier": (_convert_gbt, True),
        "GradientBoostingRegressor": (_convert_gbt, False),
    }
    if kind not in table:
        hist = "HistGradientBoosting" in kind
        raise YdfError(
            f"Cannot import a {kind}: unsupported estimator type"
            + (" (HistGradientBoosting stores bins, not raw-domain trees)"
               if hist else "")
            + f". Supported: {_SUPPORTED}.")
    fn, classification = table[kind]
    return fn(estimator, label, feature_names, classification, device)
