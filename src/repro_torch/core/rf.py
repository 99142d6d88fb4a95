"""Random Forest learner (Breiman 2001), the port of ``repro.core.rf``:
bootstrap bagging, per-node attribute sampling (sqrt rule default), deep
trees, winner-take-all voting, and out-of-bag Self-Evaluation (§3.6).

Trees grow through the reference's engines (core/grower.py) on the
learner's ``device`` (None is cuda). The default, "batched", grows a block
of ``tree_parallelism`` trees in lockstep on the CPU (the numpy backend and
one gathered bincount per level); on a CUDA device "auto" is the cuda
backend, so the trees grow one by one, every level histogram built by the
hand-written CUDA histogram kernel. "device" grows each block in lockstep
through the device engine's level step (the fused split-search kernel on
numerical data). Bootstrap draws, leaf values and the out-of-bag
evaluation are host numpy, as in the reference.

``checkpoint=`` checkpoints at ``tree_parallelism`` block boundaries only,
on every engine and device (on the card the batched engine grows a block's
trees one by one, and the block stays the unit), so a resumed
``range(trees_done, ..., block)`` realigns with the uninterrupted run's
blocks. The per-tree rng streams are re-derived from (seed, tree), not
stored.

``split_axis="SPARSE_OBLIQUE"`` (and the ``benchmark_rank1`` template,
which also sets RANDOM categorical splits) draws projections from each
tree's rng stream, so those trees grow one by one on every device (no
lockstep block), through the batched engine.
"""
from __future__ import annotations

import contextlib
import hashlib

import numpy as np

from repro_torch.core.api import Learner, Task, register_learner
from repro_torch.core.evaluation import evaluate_predictions
from repro_torch.core.gbt import _engine_logs, _one_tree
from repro_torch.core.grower import GrowthParams, grow_trees, resolve_engine
from repro_torch.core.hparams import RFHparams
from repro_torch.core.models import RandomForestModel, prepare_train_data
from repro_torch.core.splitters import SplitterParams
from repro_torch.core.tree import empty_forest, predict_raw
from repro_torch.obs import trace
from repro_torch.obs.logs import build_training_logs
from repro_torch.train.checkpoint import (
    forest_payload,
    open_session,
    restore_forest,
)


def training_data_fingerprint(X: np.ndarray, y: np.ndarray) -> str:
    """Digest of the encoded feature matrix + labels: re-encoding the
    training dataset yields the same digest, and any other dataset (even
    one of equal size) does not."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(X, np.float32).tobytes())
    h.update(np.ascontiguousarray(y, np.float64).tobytes())
    return h.hexdigest()


@register_learner("RANDOM_FOREST")
class RandomForestLearner(Learner):
    # hyper-parameter templates (``template="benchmark_rank1"``) are applied
    # by the Learner base BEFORE explicit overrides (§3.11)

    def default_hparams(self) -> RFHparams:
        return RFHparams()

    def train(self, dataset, valid=None, checkpoint=None) -> RandomForestModel:
        from repro_torch.core.engines import resolve_device
        device = resolve_device(self.device)
        hp: RFHparams = self.hparams
        td = prepare_train_data(self, dataset, max_bins=hp.max_bins)
        N, F = td.binned.codes.shape
        if self.task == Task.CLASSIFICATION:
            C = td.n_classes
            stat_kind, out_dim = "class", C
            onehot = np.eye(C)[td.y]                     # (N, C)
            base_stats = np.concatenate([onehot, np.ones((N, 1))], 1)

            def leaf_fn(s):
                tot = max(s[-1], 1e-12)
                return (s[:-1] / tot).astype(np.float32)
        else:
            stat_kind, out_dim = "moment", 1
            base_stats = np.stack([td.y, np.square(td.y), np.ones(N)], 1)

            def leaf_fn(s):
                return np.array([s[0] / max(s[-1], 1e-12)], np.float32)

        if hp.num_candidate_attributes == "SQRT":
            ratio = min(1.0, np.sqrt(F) / F)  # Breiman rule of thumb
        elif hp.num_candidate_attributes == "ALL":
            ratio = 1.0
        else:
            ratio = float(hp.num_candidate_attributes)
        oblique = hp.split_axis == "SPARSE_OBLIQUE"
        sp = SplitterParams(
            stat_kind=stat_kind, min_examples=hp.min_examples,
            categorical_algorithm=hp.categorical_algorithm,
            num_candidate_ratio=ratio, oblique=oblique,
            oblique_num_projections_exponent=hp.sparse_oblique_num_projections_exponent)
        # Per-tree rng streams + keyed per-node feature sampling: every draw
        # is a function of (seed, tree) or (seed, tree, node), never of the
        # order trees or nodes are processed in, so independent trees can
        # grow as lockstep BLOCKS with forests bit-identical to sequential
        # growth at equal seeds.
        gp = GrowthParams(max_depth=hp.max_depth, max_nodes=hp.max_num_nodes,
                          growing_strategy=hp.growing_strategy, splitter=sp,
                          engine=hp.growth_engine,
                          histogram_backend=hp.histogram_backend,
                          feature_sampling="keyed",
                          sampling_key=self.seed & 0xFFFFFFFF,
                          device=str(device))
        engine_used, fallback = resolve_engine(gp, td.binned, oblique)
        block = max(1, int(hp.tree_parallelism))
        n_num = int((~td.binned.is_cat).sum())
        forest = empty_forest(hp.num_trees, hp.max_num_nodes, out_dim,
                              oblique_dims=n_num if oblique else 0,
                              feature_names=td.features)

        oob_sum = np.zeros((N, out_dim), np.float64)
        oob_cnt = np.zeros(N, np.int64)
        tree_rng = [np.random.default_rng((self.seed & 0xFFFFFFFF, 104729, t))
                    for t in range(hp.num_trees)]
        # -- checkpoint seam: at block boundaries only (see the module
        # docstring); no generator state is stored
        sess = open_session(checkpoint, self.train_config(),
                            training_data_fingerprint(td.X_raw, td.y),
                            device.type)
        trees_done, interrupted = 0, False

        def _payload(complete: bool) -> dict:
            return {"kind": "rf", "trees_done": trees_done,
                    "done": bool(complete),
                    "forest": forest_payload(forest, trees_done),
                    "oob_sum": np.copy(oob_sum), "oob_cnt": np.copy(oob_cnt)}

        if sess is not None:
            state = sess.resume()
            if state is not None:
                trees_done = int(state["trees_done"])
                restore_forest(forest, state["forest"])
                oob_sum[:] = state["oob_sum"]
                oob_cnt[:] = state["oob_cnt"]

        with (sess if sess is not None else contextlib.nullcontext()):
            for b0 in range(trees_done, hp.num_trees, block):
                ts = list(range(b0, min(b0 + block, hp.num_trees)))
                counts_b, stats_b = [], []
                for t in ts:
                    if hp.bootstrap:
                        counts = tree_rng[t].multinomial(
                            N, np.full(N, 1.0 / N)).astype(np.float64)
                    else:
                        counts = np.ones(N)
                    counts_b.append(counts)
                    stats_b.append(base_stats * counts[:, None])
                with trace.span("rf/block", first_tree=ts[0], trees=len(ts)):
                    grow_trees(forest, ts, td.binned, td.X_raw, stats_b,
                               [c > 0 for c in counts_b], leaf_fn, gp,
                               [tree_rng[t] for t in ts], td.num_lo,
                               td.num_hi, block=block)
                if hp.compute_oob and hp.bootstrap:
                    for bi, t in enumerate(ts):
                        oob = counts_b[bi] == 0
                        if not oob.any():
                            continue
                        pr = predict_raw(_one_tree(forest, t), td.X_raw[oob])[:, 0]
                        if hp.winner_take_all and out_dim > 1:
                            vote = np.zeros_like(pr)
                            vote[np.arange(len(pr)), pr.argmax(1)] = 1.0
                            pr = vote
                        oob_sum[oob] += pr
                        oob_cnt[oob] += 1
                trees_done = ts[-1] + 1
                if sess is not None:
                    complete = trees_done == hp.num_trees
                    if not complete and sess.should_stop():
                        interrupted = True
                    sess.save(trees_done, _payload(complete), done=complete,
                              force=complete or interrupted)
                    if interrupted:
                        break
        if interrupted:
            # servable truncated model: only fully-grown trees survive
            forest = forest.truncated(max(trees_done, 1))

        self_eval = None
        if hp.compute_oob and hp.bootstrap and (oob_cnt > 0).any():
            seen = oob_cnt > 0
            preds = oob_sum[seen] / oob_cnt[seen, None]
            if self.task == Task.CLASSIFICATION:
                preds = preds / np.maximum(preds.sum(1, keepdims=True), 1e-12)
                self_eval = evaluate_predictions(
                    self.task, preds, td.y[seen], classes=td.classes,
                    source="out-of-bag")
            else:
                self_eval = evaluate_predictions(self.task, preds[:, 0],
                                                 td.y[seen], source="out-of-bag")

        model = RandomForestModel(
            winner_take_all=hp.winner_take_all, forest=forest, spec=td.ds.spec,
            features=td.features, label=self.label, task=self.task,
            classes=td.classes, self_evaluation=self_eval)
        oob_logs = None
        if self_eval is not None:
            oob_logs = {
                "source": self_eval.source,
                "n_examples": self_eval.n_examples,
                "metrics": {k: float(v) for k, v in self_eval.metrics.items()
                            if isinstance(v, float)},
                "coverage": float((oob_cnt > 0).mean()),
                "mean_trees_per_example": float(oob_cnt.mean()),
            }
        model.training_logs = build_training_logs(
            learner="rf", num_trees=forest.n_trees,
            growth_engine=engine_used, engine_fallback=fallback,
            resilience=sess.events if sess is not None else None,
            interrupted=interrupted,
            extra={"tree_parallelism": block, "oob": oob_logs,
                   "device": str(device),
                   **_engine_logs(gp, engine_used, td.binned, device)})
        if hp.compute_oob and hp.bootstrap:
            # what regenerates the per-tree bootstrap bags post hoc (the
            # multinomial draw is the first use of each per-tree rng stream),
            # and a fingerprint that tells the training set from any other
            model.bag_info = {
                "seed": self.seed & 0xFFFFFFFF, "n_rows": N,
                "num_trees": forest.n_trees,
                "fingerprint": training_data_fingerprint(td.X_raw, td.y)}
        return model
