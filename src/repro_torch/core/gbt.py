"""Gradient Boosted Trees learner (Friedman 2001), the port of
``repro.core.gbt``: paper App. C.1 defaults, LOSS_INCREASE early stopping
on a self-extracted validation set (§3.3), deterministic training.

Trees grow through the reference's engines (core/grower.py) on the
learner's ``device`` (None is cuda). The default, "batched", builds every
histogram with the hand-written CUDA histogram kernel on a CUDA device and
with numpy on the CPU (``histogram_backend="auto"``); "device" runs the
level loop on the device with the fused split-search kernel (its plain
PyTorch version on the CPU); "oracle" is the host ground truth. The
boosting loop around them is host numpy, as in the reference: gradients,
leaf values, the validation predictions and the loss values. The trained
``GradientBoostedTreesModel`` serves through the port's engines.

Not ported yet: sparse-oblique splits (``split_axis="SPARSE_OBLIQUE"`` and
the benchmark_rank1 template raise), the checkpoint seam (a non-None
``checkpoint`` raises) and the ranking task.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.api import Learner, Task, YdfError, register_learner
from repro_torch.core.evaluation import evaluate_predictions
from repro_torch.core.grower import GrowthParams, grow_tree, resolve_engine
from repro_torch.core.grower_device import _resolve_impl
from repro_torch.core.hist_backend import resolve_backend
from repro_torch.core.hparams import GBTHparams
from repro_torch.core.losses import make_loss
from repro_torch.core.models import (
    GradientBoostedTreesModel,
    TrainData,
    _as_vertical,
    extract_validation,
    prepare_train_data,
    raw_matrix,
)
from repro_torch.core.splitters import SplitterParams
from repro_torch.core.tree import Forest, empty_forest, predict_raw
from repro_torch.obs import trace
from repro_torch.obs.logs import build_training_logs


@register_learner("GRADIENT_BOOSTED_TREES")
class GradientBoostedTreesLearner(Learner):

    def default_hparams(self) -> GBTHparams:
        return GBTHparams()

    def train(self, dataset, valid=None, checkpoint=None
              ) -> GradientBoostedTreesModel:
        from repro_torch.core.engines import resolve_device
        if checkpoint is not None:
            raise YdfError(
                "Checkpointed training (checkpoint=...) is not ported yet. "
                "Solution: train without checkpoint=.")
        if self.task not in (Task.CLASSIFICATION, Task.REGRESSION):
            raise YdfError(
                f"GBT training for task={self.task.value} is not ported yet; "
                "the port trains CLASSIFICATION and REGRESSION.")
        device = resolve_device(self.device)
        hp: GBTHparams = self.hparams
        rng = np.random.default_rng(self.seed)
        td = prepare_train_data(self, dataset, max_bins=hp.max_bins)

        # §3.3: extract validation from train when early stopping needs one
        if valid is not None:
            train_idx = np.arange(td.ds.n_rows)
            Xv, yv, wv = _encode_eval_set(self, td, valid)
        elif hp.early_stopping != "NONE" and hp.validation_ratio > 0:
            train_idx, valid_idx = extract_validation(
                td.ds.n_rows, hp.validation_ratio, self.seed)
            Xv, yv = td.X_raw[valid_idx], td.y[valid_idx]
            wv = td.w[valid_idx]
        else:
            train_idx = np.arange(td.ds.n_rows)
            Xv = yv = wv = None

        sub_td = _subset_td(td, train_idx)
        N = len(train_idx)
        y, w = sub_td.y, sub_td.w
        loss = make_loss(self.task, hp.loss, td.n_classes)
        K = loss.out_dim

        max_nodes = (hp.max_num_nodes if hp.growing_strategy == "BEST_FIRST_GLOBAL"
                     else 2 ** (hp.max_depth + 1))
        oblique = hp.split_axis == "SPARSE_OBLIQUE"
        forest = empty_forest(hp.num_trees * K, max_nodes, 1,
                              feature_names=td.features)
        init = loss.init_pred(y, w)
        forest.init_pred = np.zeros(K, np.float32)
        forest.init_pred[:] = init
        forest.out_dim = K
        forest.tree_class = np.arange(hp.num_trees * K, dtype=np.int32) % K

        sp = SplitterParams(
            stat_kind="gh", min_examples=hp.min_examples,
            l2=hp.l2_regularization, categorical_algorithm=hp.categorical_algorithm,
            num_candidate_ratio=(hp.num_candidate_attributes_ratio
                                 if hp.num_candidate_attributes_ratio > 0 else 1.0),
            oblique=oblique,
            oblique_num_projections_exponent=hp.sparse_oblique_num_projections_exponent,
        )
        gp = GrowthParams(max_depth=hp.max_depth, max_nodes=max_nodes,
                          growing_strategy=hp.growing_strategy, splitter=sp,
                          engine=hp.growth_engine,
                          histogram_backend=hp.histogram_backend,
                          sampling_key=self.seed & 0xFFFFFFFF,
                          device=str(device))
        engine_used, engine_fallback = resolve_engine(gp, td.binned, oblique)
        if engine_used == "device":
            impl = {"device_impl": _resolve_impl(
                gp.device_impl, bool(td.binned.is_cat.any()), device)}
        elif engine_used == "batched":
            impl = {"histogram_backend": resolve_backend(
                gp.histogram_backend, device).name}
        else:
            impl = {}
        shrink, l2 = hp.shrinkage, hp.l2_regularization

        def leaf_fn(s):
            # s = [sum g, sum h_gain, sum h_true, count]; Newton step * shrinkage
            return np.array([-shrink * s[0] / (s[2] + l2 + 1e-12)], np.float32)

        pred = np.tile(init[None, :], (N, 1)).astype(np.float64)
        pred_v = (np.tile(init[None, :], (len(yv), 1)).astype(np.float64)
                  if yv is not None else None)
        best_loss, best_t, patience = np.inf, 0, hp.early_stopping_patience
        train_losses, valid_losses = [], []
        trees_done = 0
        for it in range(hp.num_trees):
            with trace.span("gbt/grad_hess", iteration=it):
                g, h = loss.grad_hess(pred, y, w)
            bag = w if hp.subsample >= 1.0 else w * (rng.random(N) < hp.subsample)
            for k in range(K):
                t = it * K + k
                stats = np.stack([
                    g[:, k] * bag,
                    (h[:, k] if hp.use_hessian_gain else np.ones(N)) * bag,
                    h[:, k] * bag,
                    bag,
                ], axis=1).astype(np.float64)
                with trace.span("gbt/tree", tree=t, iteration=it):
                    node_of = grow_tree(forest, t, sub_td.binned,
                                        sub_td.X_raw, stats, bag > 0,
                                        leaf_fn, gp, rng)
                vals = forest.leaf_value[t, np.maximum(node_of, 0), 0]
                upd = np.where(node_of >= 0, vals, 0.0)
                if hp.subsample < 1.0:  # OOB examples still move (predict path)
                    oob = (bag <= 0)
                    if oob.any():
                        tr = predict_raw(_one_tree(forest, t), sub_td.X_raw[oob])
                        upd = upd.copy()
                        upd[oob] = tr[:, 0, 0]
                pred[:, k] += upd
                if pred_v is not None:
                    pv = predict_raw(_one_tree(forest, t), Xv)[:, 0, 0]
                    pred_v[:, k] += pv
            trees_done = it + 1
            train_losses.append(loss.value(pred, y, w))
            if pred_v is not None:
                vl = loss.value(pred_v, yv, wv)
                valid_losses.append(vl)
                if vl < best_loss - 1e-9:
                    best_loss, best_t = vl, it + 1
                elif hp.early_stopping == "LOSS_INCREASE" and it + 1 - best_t >= patience:
                    break

        n_keep = (best_t if pred_v is not None and hp.early_stopping != "NONE"
                  else trees_done) * K
        forest = forest.truncated(max(min(n_keep, trees_done * K), K))
        self_eval = None
        if pred_v is not None and len(yv):
            self_eval = evaluate_predictions(
                self.task, loss.activation(pred_v), yv,
                classes=td.classes if self.task == Task.CLASSIFICATION else None,
                source="validation")
        model = GradientBoostedTreesModel(
            loss=loss, forest=forest, spec=td.ds.spec, features=td.features,
            label=self.label, task=self.task, classes=td.classes,
            self_evaluation=self_eval)
        model.training_logs = build_training_logs(
            learner="gbt", num_trees=forest.n_trees // K,
            growth_engine=engine_used, engine_fallback=engine_fallback,
            extra={"train_loss": train_losses, "valid_loss": valid_losses,
                   "device": str(device), **impl})
        return model


def _one_tree(forest: Forest, t: int) -> Forest:
    return dataclasses.replace(
        forest,
        feature=forest.feature[t:t + 1], threshold=forest.threshold[t:t + 1],
        split_bin=forest.split_bin[t:t + 1], cat_mask=forest.cat_mask[t:t + 1],
        left_child=forest.left_child[t:t + 1],
        leaf_value=forest.leaf_value[t:t + 1], n_nodes=forest.n_nodes[t:t + 1],
        split_gain=forest.split_gain[t:t + 1],
        tree_class=forest.tree_class[t:t + 1])


def _encode_eval_set(learner, td: TrainData, valid):
    """Encode an external validation set with the TRAINING dataspec so class
    indices and imputation match (paper §3.3 external-valid path)."""
    vds = _as_vertical(valid, td.ds.spec)
    Xv = raw_matrix(vds, td.features)
    if learner.task == Task.CLASSIFICATION:
        enc = vds.categorical[learner.label]
        if (enc <= 0).any():
            raise YdfError(
                f'Validation label "{learner.label}" contains values unseen in '
                "training (or missing). Solution: filter those rows.")
        yv = (enc - 1).astype(np.int32)
    else:
        yv = vds.numerical[learner.label].astype(np.float64)
    return Xv, yv, np.ones(len(yv), np.float64)


def _subset_td(td: TrainData, idx: np.ndarray) -> TrainData:
    if len(idx) == td.ds.n_rows and (idx == np.arange(len(idx))).all():
        return td
    binned = dataclasses.replace(td.binned, codes=td.binned.codes[idx])
    return dataclasses.replace(td, binned=binned, X_raw=td.X_raw[idx],
                               y=td.y[idx], w=td.w[idx])
