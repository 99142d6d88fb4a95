"""Carry a decision-forest model across from the JAX package as plain data.

The port never sees a ``repro`` object and never unpickles ``model.pkl``
(that needs ``repro``'s classes). A model crosses as:

  * its ``Forest`` fields as numpy arrays (``feature``, ``threshold``,
    ``cat_mask``, ``left_child``, ``leaf_value``, ``n_nodes``, ``depth``,
    ``tree_class``, ``init_pred``, ``out_dim``);
  * the dataspec dict that ``repro.core.dataspec.spec_to_dict`` writes (the
    same as ``dataspec.json`` in a saved model directory);
  * the feature list, task, classes and, for a GBT, the loss name.

``binned_from_arrays`` carries a binned dataset (``BinnedFeatures``) across
the same way, so both packages can grow trees from the same codes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import Task, YdfError
from repro_torch.core.binning import BinnedFeatures
from repro_torch.core.dataspec import spec_from_dict
from repro_torch.core.losses import loss_by_name
from repro_torch.core.models import (
    DecisionForestModel,
    GradientBoostedTreesModel,
    RandomForestModel,
)
from repro_torch.core.tree import MASK_WORDS, Forest

_REQUIRED = ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
             "n_nodes", "depth")


def forest_from_arrays(arrays: dict, feature_names: list[str]) -> Forest:
    """A port Forest from the reference Forest's fields; checks shapes and
    refuses sparse-oblique conditions, which the port does not serve."""
    missing = [k for k in _REQUIRED if k not in arrays]
    if missing:
        raise YdfError(f"Forest arrays are missing {missing}; expected the "
                       f"fields {list(_REQUIRED)} (plus tree_class, "
                       "init_pred and out_dim for a GBT).")
    feature = np.asarray(arrays["feature"], np.int32)
    if feature.ndim != 2:
        raise YdfError(f"feature must be (T, M), got {feature.shape}")
    T, M = feature.shape
    if (feature == -2).any():
        raise YdfError(
            "The forest has sparse-oblique conditions (feature == -2); the "
            "port serves axis-aligned numerical and categorical conditions "
            "only. Retrain with split_axis='AXIS_ALIGNED'.")
    leaf_value = np.asarray(arrays["leaf_value"], np.float32)
    cat_mask = np.asarray(arrays["cat_mask"], np.uint32)
    shapes = {"threshold": (T, M), "left_child": (T, M),
              "cat_mask": (T, M, MASK_WORDS), "n_nodes": (T,)}
    for name, want in shapes.items():
        got = np.shape(arrays[name])
        if got != want:
            raise YdfError(f"{name} must have shape {want}, got {got}")
    if leaf_value.ndim != 3 or leaf_value.shape[:2] != (T, M):
        raise YdfError(f"leaf_value must be (T, M, leaf_dim) with (T, M) = "
                       f"{(T, M)}, got {leaf_value.shape}")
    out_dim = int(arrays.get("out_dim", leaf_value.shape[-1]))
    tree_class = arrays.get("tree_class")
    init_pred = arrays.get("init_pred")
    return Forest(
        feature=feature,
        threshold=np.asarray(arrays["threshold"], np.float32),
        cat_mask=cat_mask,
        left_child=np.asarray(arrays["left_child"], np.int32),
        leaf_value=leaf_value,
        n_nodes=np.asarray(arrays["n_nodes"], np.int32),
        depth=int(arrays["depth"]),
        out_dim=out_dim,
        tree_class=(np.zeros(T, np.int32) if tree_class is None
                    else np.asarray(tree_class, np.int32)),
        init_pred=(np.zeros(out_dim, np.float32) if init_pred is None
                   else np.asarray(init_pred, np.float32)),
        feature_names=list(feature_names))


def model_from_arrays(kind: str, forest_arrays: dict, spec: dict,
                      features: list[str], *, task, classes=None,
                      loss: str | None = None,
                      winner_take_all: bool = True) -> DecisionForestModel:
    """The port's model for a reference model's data.

    kind: "gbt" or "rf". task: a ``Task`` (either package's) or its name.
    For a GBT, ``loss`` is the reference loss's ``name`` (``BINOMIAL_LOG_LIKELIHOOD``,
    ``MULTINOMIAL_LOG_LIKELIHOOD``, ``SQUARED_ERROR``); None derives it from
    the task and the forest's output dimension."""
    task = Task(getattr(task, "value", task))
    ds = spec_from_dict(spec)
    absent = [f for f in features if f not in ds.columns]
    if absent:
        raise YdfError(f"Feature(s) {absent} are not in the dataspec; its "
                       f"columns are {sorted(ds.columns)}.")
    forest = forest_from_arrays(forest_arrays, features)
    common = dict(forest=forest, spec=ds, features=features, task=task,
                  classes=None if classes is None else list(classes))
    if kind == "rf":
        return RandomForestModel(winner_take_all=winner_take_all, **common)
    if kind != "gbt":
        raise YdfError(f"Unknown model kind {kind!r}; expected 'gbt' or 'rf'.")
    if loss is None:
        if task == Task.REGRESSION:
            loss = "SQUARED_ERROR"
        elif task == Task.CLASSIFICATION:
            loss = ("BINOMIAL_LOG_LIKELIHOOD" if forest.out_dim == 1
                    else "MULTINOMIAL_LOG_LIKELIHOOD")
        else:
            raise YdfError(f"No default GBT loss for task {task.value}; pass "
                           "loss= with the reference model's loss name.")
    return GradientBoostedTreesModel(loss=loss_by_name(loss, forest.out_dim),
                                     **common)


def binned_from_arrays(codes, n_bins, is_cat, boundaries,
                       names) -> BinnedFeatures:
    """A port ``BinnedFeatures`` from the reference's fields, so both
    packages' growers see the same codes: codes (N, F) uint8, n_bins (F,),
    is_cat (F,) bool, boundaries (one ascending array per numerical
    feature, None per categorical one), names."""
    codes = np.ascontiguousarray(codes, np.uint8)
    if codes.ndim != 2:
        raise YdfError(f"codes must be (N, F), got {codes.shape}")
    F = codes.shape[1]
    if len(n_bins) != F or len(is_cat) != F or len(boundaries) != F \
            or len(names) != F:
        raise YdfError(f"n_bins, is_cat, boundaries and names must each have "
                       f"{F} entries, one per column of codes")
    return BinnedFeatures(
        codes=codes, n_bins=np.asarray(n_bins, np.int32),
        is_cat=np.asarray(is_cat, bool),
        boundaries=[None if b is None else np.asarray(b, np.float32)
                    for b in boundaries],
        names=list(names))
