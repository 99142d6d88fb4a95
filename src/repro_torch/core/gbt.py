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

``checkpoint=`` (a directory or a ``train.checkpoint.CheckpointPolicy``)
snapshots the boosting state at tree boundaries, as the reference does:
the trees so far, the cached train and validation predictions, the
early-stopping bookkeeping and the host RNG's state. A resumed run on the
same device type grows the same forest bit for bit.

``split_axis="SPARSE_OBLIQUE"`` (and the ``benchmark_rank1`` template,
which also sets BEST_FIRST_GLOBAL growth and RANDOM categorical splits)
adds a sparse-oblique projection pass per node on the host; its
configurations resolve to the batched engine, whose axis-aligned
histograms still go through the histogram backend (the CUDA kernel on the
card).

``task=RANKING`` trains LambdaMART (``repro_torch.tasks.ranking``): the
validation split keeps every group whole, the loss holds the train and
validation group layouts, and its lambda pass (host numpy, bit-identical
to the reference, inside the ``gbt/grad_hess`` span) gives the gh stats
that every engine then grows trees from. The model keeps only the loss's
serving head and the group column's name (``ranking_group``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch.core.api import Learner, Task, YdfError, register_learner
from repro_torch.core.dataspec import VerticalDataset
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
from repro_torch.train.checkpoint import (
    forest_payload,
    open_session,
    restore_forest,
)


@register_learner("GRADIENT_BOOSTED_TREES")
class GradientBoostedTreesLearner(Learner):

    def default_hparams(self) -> GBTHparams:
        return GBTHparams()

    def train(self, dataset, valid=None, checkpoint=None
              ) -> GradientBoostedTreesModel:
        from repro_torch.core.engines import resolve_device
        from repro_torch.core.rf import training_data_fingerprint
        # the tasks package registers learners that import this module
        from repro_torch.tasks.ranking import (
            LambdaMARTLoss,
            group_aware_split,
            group_layout,
        )
        device = resolve_device(self.device)
        hp: GBTHparams = self.hparams
        rng = np.random.default_rng(self.seed)
        td = prepare_train_data(self, dataset, max_bins=hp.max_bins)

        # §3.3: extract validation from train when early stopping needs one.
        # Ranking keeps every group WHOLE on one side of the split — a torn
        # group corrupts both its lambda pairs and its NDCG.
        groups_v = None
        if valid is not None:
            train_idx = np.arange(td.ds.n_rows)
            Xv, yv, wv, groups_v = _encode_eval_set(self, td, valid)
        elif hp.early_stopping != "NONE" and hp.validation_ratio > 0:
            if self.task == Task.RANKING:
                train_idx, valid_idx = group_aware_split(
                    td.groups, hp.validation_ratio, self.seed)
            else:
                train_idx, valid_idx = extract_validation(
                    td.ds.n_rows, hp.validation_ratio, self.seed)
            Xv, yv = td.X_raw[valid_idx], td.y[valid_idx]
            wv = td.w[valid_idx]
            if td.groups is not None:
                groups_v = td.groups[valid_idx]
        else:
            train_idx = np.arange(td.ds.n_rows)
            Xv = yv = wv = None

        sub_td = _subset_td(td, train_idx)
        N = len(train_idx)
        y, w = sub_td.y, sub_td.w
        if self.task == Task.RANKING:
            # built here, not in make_loss: the loss owns the train/valid
            # group layouts, which only exist after the split above. It
            # tells them apart by the IDENTITY of the label array, so the
            # loop below passes these very ``y`` and ``yv`` objects.
            loss = LambdaMARTLoss(
                y, group_layout(sub_td.groups), k=hp.ndcg_truncation,
                y_valid=yv,
                layout_valid=None if yv is None else group_layout(groups_v))
        else:
            loss = make_loss(self.task, hp.loss, td.n_classes)
        K = loss.out_dim

        max_nodes = (hp.max_num_nodes if hp.growing_strategy == "BEST_FIRST_GLOBAL"
                     else 2 ** (hp.max_depth + 1))
        oblique = hp.split_axis == "SPARSE_OBLIQUE"
        n_num = int((~td.binned.is_cat).sum())
        forest = empty_forest(hp.num_trees * K, max_nodes, 1,
                              oblique_dims=n_num if oblique else 0,
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
        impl = _engine_logs(gp, engine_used, td.binned, device)
        shrink, l2 = hp.shrinkage, hp.l2_regularization

        def leaf_fn(s):
            # s = [sum g, sum h_gain, sum h_true, count]; Newton step * shrinkage
            return np.array([-shrink * s[0] / (s[2] + l2 + 1e-12)], np.float32)

        pred = np.tile(init[None, :], (N, 1)).astype(np.float64)
        pred_v = (np.tile(init[None, :], (len(yv), 1)).astype(np.float64)
                  if yv is not None else None)
        best_loss, best_t, patience = np.inf, 0, hp.early_stopping_patience
        train_losses, valid_losses = [], []

        # -- checkpoint seam: the bit-identical-resume closure is (forest
        # slices, pred, pred_v, early-stop bookkeeping,
        # rng.bit_generator.state) snapshotted at tree boundaries. The seam
        # sits OUTSIDE grow_tree, so every engine checkpoints the same way;
        # a resumed run builds its engine state afresh.
        sess = open_session(checkpoint, self.train_config(),
                            training_data_fingerprint(td.X_raw, td.y),
                            device.type)
        trees_done, stopped, interrupted = 0, False, False

        def _payload(complete: bool) -> dict:
            return {"kind": "gbt", "trees_done": trees_done,
                    "done": bool(complete),
                    "forest": forest_payload(forest, trees_done * K),
                    "pred": np.copy(pred),
                    "pred_v": None if pred_v is None else np.copy(pred_v),
                    "rng_state": rng.bit_generator.state,
                    "best_loss": float(best_loss), "best_t": int(best_t),
                    "train_losses": list(train_losses),
                    "valid_losses": list(valid_losses)}

        if sess is not None:
            state = sess.resume()
            if state is not None:
                trees_done = int(state["trees_done"])
                stopped = bool(state["done"])
                restore_forest(forest, state["forest"])
                pred[:] = state["pred"]
                if pred_v is not None and state["pred_v"] is not None:
                    pred_v[:] = state["pred_v"]
                rng.bit_generator.state = state["rng_state"]
                best_loss = state["best_loss"]
                best_t = state["best_t"]
                train_losses = list(state["train_losses"])
                valid_losses = list(state["valid_losses"])

        with (sess if sess is not None else contextlib.nullcontext()):
            for it in range(trees_done, hp.num_trees):
                if stopped:
                    break
                with trace.span("gbt/grad_hess", iteration=it):
                    g, h = loss.grad_hess(pred, y, w)
                bag = w if hp.subsample >= 1.0 else w * (rng.random(N) < hp.subsample)
                for k in range(K):
                    t = it * K + k
                    with trace.span("gbt/stats", tree=t):
                        stats = np.stack([
                            g[:, k] * bag,
                            (h[:, k] if hp.use_hessian_gain else np.ones(N))
                            * bag,
                            h[:, k] * bag,
                            bag,
                        ], axis=1).astype(np.float64)
                    with trace.span("gbt/tree", tree=t, iteration=it):
                        node_of = grow_tree(forest, t, sub_td.binned,
                                            sub_td.X_raw, stats, bag > 0,
                                            leaf_fn, gp, rng,
                                            sub_td.num_lo, sub_td.num_hi)
                    # the leaf gather and the prediction updates
                    with trace.span("gbt/update", tree=t):
                        vals = forest.leaf_value[t, np.maximum(node_of, 0), 0]
                        upd = np.where(node_of >= 0, vals, 0.0)
                        # OOB examples still move (predict path)
                        if hp.subsample < 1.0:
                            oob = (bag <= 0)
                            if oob.any():
                                tr = predict_raw(_one_tree(forest, t),
                                                 sub_td.X_raw[oob])
                                upd = upd.copy()
                                upd[oob] = tr[:, 0, 0]
                        pred[:, k] += upd
                        if pred_v is not None:
                            pv = predict_raw(_one_tree(forest, t), Xv)[:, 0, 0]
                            pred_v[:, k] += pv
                trees_done = it + 1
                with trace.span("gbt/loss", iteration=it):
                    train_losses.append(loss.value(pred, y, w))
                    vl = None if pred_v is None else loss.value(pred_v, yv, wv)
                if pred_v is not None:
                    valid_losses.append(vl)
                    if vl < best_loss - 1e-9:
                        best_loss, best_t = vl, it + 1
                    elif hp.early_stopping == "LOSS_INCREASE" and it + 1 - best_t >= patience:
                        stopped = True
                if sess is not None:
                    complete = stopped or trees_done == hp.num_trees
                    if not complete and sess.should_stop():
                        interrupted = True
                    sess.save(trees_done, _payload(complete), done=complete,
                              force=complete or interrupted)
                    if interrupted:
                        break

        n_keep = (best_t if pred_v is not None and hp.early_stopping != "NONE"
                  and not interrupted else trees_done) * K
        forest = forest.truncated(max(min(n_keep, trees_done * K), K))
        self_eval = None
        if pred_v is not None and len(yv):
            self_eval = evaluate_predictions(
                self.task, loss.activation(pred_v), yv,
                classes=td.classes if self.task == Task.CLASSIFICATION else None,
                groups=groups_v,
                source="validation")
        # a loss that holds training-set state (LambdaMART's group layouts)
        # ships its stripped serving head instead
        model_loss = loss.serving_head() if hasattr(loss, "serving_head") else loss
        model = GradientBoostedTreesModel(
            loss=model_loss, forest=forest, spec=td.ds.spec,
            features=td.features, label=self.label, task=self.task,
            classes=td.classes, self_evaluation=self_eval)
        if self.task == Task.RANKING:
            model.ranking_group = hp.ranking_group
        model.training_logs = build_training_logs(
            learner="gbt", num_trees=forest.n_trees // K,
            growth_engine=engine_used, engine_fallback=engine_fallback,
            resilience=sess.events if sess is not None else None,
            interrupted=interrupted,
            extra={"train_loss": train_losses, "valid_loss": valid_losses,
                   "device": str(device), **impl})
        return model


def _engine_logs(gp: GrowthParams, engine_used: str, binned,
                 device) -> dict:
    """The training_logs entry naming what ran under the engine: the
    device engine's split-search impl, or the batched engine's histogram
    backend."""
    if engine_used == "device":
        return {"device_impl": _resolve_impl(
            gp.device_impl, bool(binned.is_cat.any()), device)}
    if engine_used == "batched":
        return {"histogram_backend": resolve_backend(
            gp.histogram_backend, device).name}
    return {}


def _one_tree(forest: Forest, t: int) -> Forest:
    return dataclasses.replace(
        forest,
        feature=forest.feature[t:t + 1], threshold=forest.threshold[t:t + 1],
        split_bin=forest.split_bin[t:t + 1], cat_mask=forest.cat_mask[t:t + 1],
        left_child=forest.left_child[t:t + 1],
        leaf_value=forest.leaf_value[t:t + 1], n_nodes=forest.n_nodes[t:t + 1],
        split_gain=forest.split_gain[t:t + 1],
        obl_weights=None if forest.obl_weights is None else forest.obl_weights[t:t + 1],
        obl_features=None if forest.obl_features is None else forest.obl_features[t:t + 1],
        tree_class=forest.tree_class[t:t + 1])


def _encode_eval_set(learner, td: TrainData, valid):
    """Encode an external validation set with the TRAINING dataspec so class
    indices and imputation match (paper §3.3 external-valid path). For
    ranking the 4th return is the valid set's group ids (else None), read
    from the RAW column — the training vocabulary must not collapse unseen
    validation groups into one out-of-dictionary bucket."""
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
    groups_v = None
    if learner.task == Task.RANKING:
        gcol = learner.hparams.ranking_group
        if isinstance(valid, VerticalDataset):
            col = np.asarray(valid.column(gcol))
        else:
            if gcol not in valid:
                raise YdfError(
                    f'Ranking validation set is missing the group column '
                    f'"{gcol}".')
            col = np.asarray(valid[gcol], dtype=object).ravel()
        groups_v = np.unique(col.astype(str),
                             return_inverse=True)[1].astype(np.int64)
    return Xv, yv, np.ones(len(yv), np.float64), groups_v


def _subset_td(td: TrainData, idx: np.ndarray) -> TrainData:
    if len(idx) == td.ds.n_rows and (idx == np.arange(len(idx))).all():
        return td
    binned = dataclasses.replace(td.binned, codes=td.binned.codes[idx])
    return dataclasses.replace(
        td, binned=binned, X_raw=td.X_raw[idx], y=td.y[idx], w=td.w[idx],
        groups=None if td.groups is None else td.groups[idx])
