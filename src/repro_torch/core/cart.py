"""CART learner (Breiman et al. 1984), the port of ``repro.core.cart``: a
single tree grown on a train split and pruned bottom-up on a
self-extracted validation split (reduced-error pruning), as in YDF's CART.

The tree grows through the reference's engines (core/grower.py) on the
learner's ``device`` (None is cuda): by default the batched engine, whose
every level histogram is built by the CUDA histogram kernel on the card and
by numpy on the CPU. Pruning is host numpy over ``predict_raw``, as in the
reference. ``checkpoint=`` has one interior boundary, the grown but
unpruned tree: pruning is deterministic given the forest and the
seed-derived validation split, so a resume from that stage re-prunes to
the same tree.
"""
from __future__ import annotations

import contextlib

import numpy as np

from repro_torch.core.api import Learner, Task, register_learner
from repro_torch.core.gbt import _engine_logs
from repro_torch.core.grower import GrowthParams, grow_tree, resolve_engine
from repro_torch.core.hparams import CartHparams
from repro_torch.core.models import (
    CartModel,
    extract_validation,
    prepare_train_data,
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


@register_learner("CART")
class CartLearner(Learner):
    def default_hparams(self) -> CartHparams:
        return CartHparams()

    def train(self, dataset, valid=None, checkpoint=None) -> CartModel:
        from repro_torch.core.engines import resolve_device
        from repro_torch.core.rf import training_data_fingerprint
        device = resolve_device(self.device)
        hp: CartHparams = self.hparams
        rng = np.random.default_rng(self.seed)
        td = prepare_train_data(self, dataset, max_bins=hp.max_bins)
        N = td.ds.n_rows
        if valid is None and N >= 20:
            tr_idx, va_idx = extract_validation(N, hp.validation_ratio, self.seed)
        else:
            tr_idx, va_idx = np.arange(N), np.arange(0)
        if self.task == Task.CLASSIFICATION:
            C = td.n_classes
            stat_kind, out_dim = "class", C
            base = np.concatenate([np.eye(C)[td.y], np.ones((N, 1))], 1)

            def leaf_fn(s):
                return (s[:-1] / max(s[-1], 1e-12)).astype(np.float32)
        else:
            stat_kind, out_dim = "moment", 1
            base = np.stack([td.y, np.square(td.y), np.ones(N)], 1)

            def leaf_fn(s):
                return np.array([s[0] / max(s[-1], 1e-12)], np.float32)

        sp = SplitterParams(stat_kind=stat_kind, min_examples=hp.min_examples,
                            categorical_algorithm=hp.categorical_algorithm)
        gp = GrowthParams(max_depth=hp.max_depth, max_nodes=hp.max_num_nodes,
                          growing_strategy="LOCAL", splitter=sp,
                          engine=hp.growth_engine,
                          histogram_backend=hp.histogram_backend,
                          device=str(device))
        engine_used, fallback = resolve_engine(gp, td.binned)
        forest = empty_forest(1, hp.max_num_nodes, out_dim,
                              feature_names=td.features)

        # -- checkpoint seam: one interior boundary, grown but unpruned
        sess = open_session(checkpoint, self.train_config(),
                            training_data_fingerprint(td.X_raw, td.y),
                            device.type)
        state = sess.resume() if sess is not None else None
        grown = pruned = interrupted = False
        if state is not None:
            restore_forest(forest, state["forest"])
            grown, pruned = True, bool(state["done"])

        def _payload(complete: bool) -> dict:
            return {"kind": "cart", "trees_done": 1, "done": bool(complete),
                    "forest": forest_payload(forest, 1)}

        with (sess if sess is not None else contextlib.nullcontext()):
            if not grown:
                w = np.zeros(N)
                w[tr_idx] = 1.0
                with trace.span("cart/grow"):
                    grow_tree(forest, 0, td.binned, td.X_raw,
                              base * w[:, None], w > 0, leaf_fn, gp, rng)
                if sess is not None and sess.should_stop():
                    # servable unpruned tree now; pruning happens on resume
                    interrupted = True
                    sess.save(1, _payload(False), done=False, force=True)
            if not pruned and not interrupted:
                if len(va_idx):
                    with trace.span("cart/prune", valid_rows=len(va_idx)):
                        _prune(forest, td.X_raw[va_idx], td.y[va_idx],
                               self.task)
                if sess is not None:
                    sess.save(1, _payload(True), done=True, force=True)

        model = CartModel(winner_take_all=False, forest=forest, spec=td.ds.spec,
                          features=td.features, label=self.label, task=self.task,
                          classes=td.classes)
        model.training_logs = build_training_logs(
            learner="cart", num_trees=1,
            growth_engine=engine_used, engine_fallback=fallback,
            resilience=sess.events if sess is not None else None,
            interrupted=interrupted,
            extra={"device": str(device),
                   **_engine_logs(gp, engine_used, td.binned, device)})
        return model


def _prune(forest: Forest, Xv: np.ndarray, yv: np.ndarray, task: Task) -> None:
    """Reduced-error pruning: convert an internal node to a leaf whenever that
    does not hurt validation accuracy / squared error."""
    t = 0
    n = int(forest.n_nodes[t])

    def valid_score() -> float:
        pr = predict_raw(forest, Xv)[:, 0]          # (Nv, out_dim)
        if task == Task.CLASSIFICATION:
            return float((pr.argmax(1) == yv).mean())
        return -float(np.mean(np.square(pr[:, 0] - yv)))

    # bottom-up: children have larger ids than parents by construction. The
    # score of the current tree is carried from one node to the next (the
    # reference scores it again), which makes the same decisions with half
    # the traversals.
    internal = [i for i in range(n) if forest.left_child[t, i] >= 0]
    before = valid_score()
    for node in sorted(internal, reverse=True):
        saved = forest.left_child[t, node]
        forest.left_child[t, node] = -1
        after = valid_score()
        if after < before:
            forest.left_child[t, node] = saved      # revert
        else:
            before = after
