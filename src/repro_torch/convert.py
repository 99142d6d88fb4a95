"""Carry a model across from the JAX package as plain data.

The port never sees a ``repro`` object and never unpickles ``model.pkl``
(that needs ``repro``'s classes). A model crosses as:

  * its ``Forest`` fields as numpy arrays (``feature``, ``threshold``,
    ``cat_mask``, ``left_child``, ``leaf_value``, ``n_nodes``, ``depth``,
    ``tree_class``, ``init_pred``, ``out_dim``, ``obl_weights`` and
    ``obl_features`` (both (T, M, P), required when any node is
    sparse-oblique, ``feature == -2``), and the training-side
    ``split_bin`` and ``split_gain`` when given: the gains are what the
    SUM_SCORE importance sums);
  * the dataspec dict that ``repro.core.dataspec.spec_to_dict`` writes (the
    same as ``dataspec.json`` in a saved model directory);
  * the feature list, task, classes and, for a GBT, the loss name
    (``LAMBDA_MART_NDCG`` for a ranking GBT); for an uplift forest the
    treatment column's name, for an isolation forest ``c_psi``;
  * a linear model (``core/baselines.py``) crosses as its ``W`` and ``b``
    with the same dataspec, features, task and classes.

``binned_from_arrays`` carries a binned dataset (``BinnedFeatures``) across
the same way, so both packages can grow trees from the same codes.

``lm_params_from_arrays`` carries a language model's weights across: the
reference's nested param dict as numpy arrays (bf16 leaves as float32
values, which is exact).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import Task, YdfError
from repro_torch.core.baselines import LinearModel
from repro_torch.core.binning import BinnedFeatures
from repro_torch.core.dataspec import spec_from_dict
from repro_torch.core.losses import loss_by_name
from repro_torch.core.models import (
    CartModel,
    DecisionForestModel,
    GradientBoostedTreesModel,
    IsolationForestModel,
    RandomForestModel,
    UpliftModel,
)
from repro_torch.core.tree import MASK_WORDS, Forest

_REQUIRED = ("feature", "threshold", "cat_mask", "left_child", "leaf_value",
             "n_nodes", "depth")


def forest_from_arrays(arrays: dict, feature_names: list[str]) -> Forest:
    """A port Forest from the reference Forest's fields; checks shapes, and
    that a forest with sparse-oblique nodes (``feature == -2``) carries its
    ``obl_weights`` (float32) and ``obl_features`` (int32, >= 0), both
    (T, M, P) with P >= 1."""
    missing = [k for k in _REQUIRED if k not in arrays]
    if missing:
        raise YdfError(f"Forest arrays are missing {missing}; expected the "
                       f"fields {list(_REQUIRED)} (plus tree_class, "
                       "init_pred and out_dim for a GBT).")
    feature = np.asarray(arrays["feature"], np.int32)
    if feature.ndim != 2:
        raise YdfError(f"feature must be (T, M), got {feature.shape}")
    T, M = feature.shape
    obl_w, obl_f = arrays.get("obl_weights"), arrays.get("obl_features")
    if (obl_w is None) != (obl_f is None):
        raise YdfError("obl_weights and obl_features come together: pass "
                       "both or neither.")
    if obl_w is not None:
        obl_w = np.asarray(obl_w, np.float32)
        obl_f = np.asarray(obl_f, np.int32)
        if obl_w.ndim != 3 or obl_w.shape[:2] != (T, M) \
                or obl_f.shape != obl_w.shape:
            raise YdfError(f"obl_weights and obl_features must both be "
                           f"(T, M, P) with (T, M) = {(T, M)}, got "
                           f"{obl_w.shape} and {obl_f.shape}")
        if (obl_f < 0).any():
            raise YdfError("obl_features holds a negative column")
    if (feature == -2).any() and (obl_w is None or obl_w.shape[-1] == 0):
        raise YdfError(
            "The forest has sparse-oblique conditions (feature == -2) but no "
            "oblique tables; pass the reference Forest's obl_weights and "
            "obl_features, (T, M, P) each.")
    leaf_value = np.asarray(arrays["leaf_value"], np.float32)
    cat_mask = np.asarray(arrays["cat_mask"], np.uint32)
    shapes = {"threshold": (T, M), "left_child": (T, M),
              "cat_mask": (T, M, MASK_WORDS), "n_nodes": (T,),
              "split_bin": (T, M), "split_gain": (T, M)}
    for name, want in shapes.items():
        if arrays.get(name) is None:
            continue                       # split_bin, split_gain: optional
        got = np.shape(arrays[name])
        if got != want:
            raise YdfError(f"{name} must have shape {want}, got {got}")
    if leaf_value.ndim != 3 or leaf_value.shape[:2] != (T, M):
        raise YdfError(f"leaf_value must be (T, M, leaf_dim) with (T, M) = "
                       f"{(T, M)}, got {leaf_value.shape}")
    out_dim = int(arrays.get("out_dim", leaf_value.shape[-1]))
    tree_class = arrays.get("tree_class")
    init_pred = arrays.get("init_pred")
    split_bin = arrays.get("split_bin")
    split_gain = arrays.get("split_gain")
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
        feature_names=list(feature_names),
        split_bin=(None if split_bin is None
                   else np.asarray(split_bin, np.uint16)),
        split_gain=(None if split_gain is None
                    else np.asarray(split_gain, np.float32)),
        obl_weights=obl_w, obl_features=obl_f)


def model_from_arrays(kind: str, forest_arrays: dict, spec: dict,
                      features: list[str], *, task, classes=None,
                      loss: str | None = None,
                      winner_take_all: bool = True,
                      treatment_col: str = "treatment",
                      c_psi: float | None = None
                      ) -> DecisionForestModel | LinearModel:
    """The port's model for a reference model's data.

    kind: "gbt", "rf", "cart", "uplift", "isolation" or "linear" (whose
    ``forest_arrays`` are the linear model's ``{"W", "b"}``: W (D, K) over
    the design matrix of ``core/baselines.py``, b (K,)). task: a ``Task``
    (either package's) or its name. A CART model serves as the reference's
    does: the mean of its one tree, without winner-take-all.
    For a GBT, ``loss`` is the reference loss's ``name`` (``BINOMIAL_LOG_LIKELIHOOD``,
    ``MULTINOMIAL_LOG_LIKELIHOOD``, ``SQUARED_ERROR``, and ``LAMBDA_MART_NDCG``
    for a ranking model); None derives it from the task and the forest's
    output dimension. An uplift forest takes the name of its treatment
    column (``treatment_col``), an isolation forest its ``c_psi`` (the
    reference model's field: c(psi), the mean path length it normalizes
    by). Neither keeps a ``tree_class``, as the reference's learners
    leave it."""
    task = Task(getattr(task, "value", task))
    ds = spec_from_dict(spec)
    absent = [f for f in features if f not in ds.columns]
    if absent:
        raise YdfError(f"Feature(s) {absent} are not in the dataspec; its "
                       f"columns are {sorted(ds.columns)}.")
    if kind == "linear":
        return _linear_from_arrays(forest_arrays, ds, features, task, classes)
    forest = forest_from_arrays(forest_arrays, features)
    common = dict(forest=forest, spec=ds, features=features, task=task,
                  classes=None if classes is None else list(classes))
    if kind == "rf":
        return RandomForestModel(winner_take_all=winner_take_all, **common)
    if kind == "cart":
        return CartModel(winner_take_all=False, **common)
    if kind == "uplift":
        forest.tree_class = None
        return UpliftModel(treatment_col=treatment_col, **common)
    if kind == "isolation":
        if c_psi is None:
            raise YdfError("An isolation forest needs c_psi (the reference "
                           "model's field); pass c_psi=model.c_psi.")
        forest.tree_class = None
        return IsolationForestModel(c_psi=float(c_psi), **common)
    if kind != "gbt":
        raise YdfError(f"Unknown model kind {kind!r}; expected 'gbt', 'rf', "
                       "'cart', 'uplift', 'isolation' or 'linear'.")
    if loss is None:
        if task == Task.REGRESSION:
            loss = "SQUARED_ERROR"
        elif task == Task.CLASSIFICATION:
            loss = ("BINOMIAL_LOG_LIKELIHOOD" if forest.out_dim == 1
                    else "MULTINOMIAL_LOG_LIKELIHOOD")
        elif task == Task.RANKING:
            loss = "LAMBDA_MART_NDCG"
        else:
            raise YdfError(f"No default GBT loss for task {task.value}; pass "
                           "loss= with the reference model's loss name.")
    return GradientBoostedTreesModel(loss=loss_by_name(loss, forest.out_dim),
                                     **common)


def _linear_from_arrays(arrays: dict, spec, features: list[str], task,
                        classes) -> LinearModel:
    missing = [k for k in ("W", "b") if k not in arrays]
    if missing:
        raise YdfError(f"A linear model's arrays are missing {missing}; "
                       "expected W (D, K) and b (K,).")
    W = np.asarray(arrays["W"], np.float32)
    b = np.asarray(arrays["b"], np.float32)
    if W.ndim != 2 or b.shape != (W.shape[1],):
        raise YdfError(f"W must be (D, K) and b (K,), got {W.shape} and "
                       f"{b.shape}")
    return LinearModel(W=W, b=b, spec=spec, features=features, label=None,
                       task=task,
                       classes=None if classes is None else list(classes))


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


def lm_params_from_arrays(cfg, tree: dict, *, device=None, dtype=None) -> dict:
    """The port's nested param dict for ``cfg`` from the reference's, given
    as numpy arrays (e.g. ``jax.tree.map(lambda a: np.asarray(a,
    np.float32), params)``). Every leaf's path and shape must match
    ``lm.model_schema(cfg)``; each is cast to its spec's dtype (``dtype``, a
    dtype name, replaces ``cfg.param_dtype`` as the default) on ``device``
    (None is cuda)."""
    import torch

    from repro_torch.core.engines import resolve_device
    from repro_torch.models import lm
    from repro_torch.models.params import leaves, torch_dtype
    dev = resolve_device(device)
    schema = lm.model_schema(cfg)
    want = {path for path, _ in leaves(schema)}
    got = {path for path, _ in leaves(tree)}
    if want != got:
        missing = sorted(".".join(p) for p in want - got)
        extra = sorted(".".join(p) for p in got - want)
        raise YdfError(f"{cfg.name}: the param tree does not match the "
                       f"schema: missing {missing}, extra {extra}")
    arrays = dict(leaves(tree))
    default = dtype or cfg.param_dtype

    out = {}
    for path, spec in leaves(schema):
        a = np.asarray(arrays[path])
        if tuple(a.shape) != tuple(spec.shape):
            raise YdfError(f"{cfg.name}: {'.'.join(path)} has shape "
                           f"{a.shape}, the schema says {spec.shape}")
        out[path] = torch.tensor(a, dtype=torch.float32).to(
            device=dev, dtype=torch_dtype(spec.dtype or default))
    return _nest(out)


def lm_train_state_from_arrays(cfg, tree: dict, *, device=None, dtype=None) -> dict:
    """The port's train state ({"params", "slots", "step"}) for ``cfg`` from
    the reference's, given as numpy arrays. The params go through
    ``lm_params_from_arrays`` (``dtype`` as there); every slot must match
    ``opt_slot_specs``' paths and shapes and becomes float32; the step an
    int32 scalar. On ``device`` (None is cuda)."""
    import torch

    from repro_torch.core.engines import resolve_device
    from repro_torch.models.params import leaves
    from repro_torch.train.step import train_state_specs
    dev = resolve_device(device)
    if set(tree) != {"params", "slots", "step"}:
        raise YdfError(f"a train state has params, slots and step; got {sorted(tree)}")
    params = lm_params_from_arrays(cfg, tree["params"], device=dev, dtype=dtype)
    specs, _ = train_state_specs(cfg)
    want = dict(leaves(specs["slots"]))
    got = dict(leaves(tree["slots"]))
    if set(want) != set(got):
        missing = sorted(".".join(p) for p in set(want) - set(got))
        extra = sorted(".".join(p) for p in set(got) - set(want))
        raise YdfError(f"{cfg.name}: the slots do not match the optimizer's "
                       f"({cfg.optimizer}): missing {missing}, extra {extra}")
    slots = {}
    for path, spec in want.items():
        a = np.asarray(got[path], np.float32)
        if tuple(a.shape) != tuple(spec.shape):
            raise YdfError(f"{cfg.name}: slot {'.'.join(path)} has shape "
                           f"{a.shape}, the optimizer's is {tuple(spec.shape)}")
        slots[path] = torch.tensor(a, dtype=torch.float32, device=dev)
    step = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=dev)
    return {"params": params, "slots": _nest(slots), "step": step}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out
