"""The typed tree API (DESIGN.md §7), the port's copy of
``repro.core.py_tree``: inspect, edit and build forests.

The Forest SoA (repro_torch/core/tree.py) is the *execution* format — flat arrays,
engine-friendly, closed. This module is the *manipulation* format: plain
dataclasses (``Leaf`` / ``NonLeaf`` with typed conditions and leaf values)
that round-trip with the SoA exactly:

    trees  = forest.to_trees()              # SoA -> typed nodes
    forest = Forest.from_trees(trees, like=forest)   # typed nodes -> SoA

Round-trips are bit-identical for compact forests (everything the growers
produce): ``NonLeaf.split_order`` preserves the original child-pair
allocation order, ``NonLeaf.value`` preserves the per-node statistics the
growers leave on internal nodes (CART pruning reads them), and conditions
carry both the raw-domain threshold and the binned split index. A forest
carried across from the JAX package without its training fields
(``split_bin`` is None, ``convert.forest_from_arrays``) reads as
``split_bin=0`` on every numerical condition, the default of a hand-written
one; inference never reads it.

On top of it:
  * ``ModelInspector`` — per-tree structure stats + plot_tree-style ASCII
    rendering (``DecisionForestModel.inspect()`` / ``summary(verbose=)``).
  * ``ModelBuilder`` subclasses — construct RandomForest / GBT / CART models
    from hand-written or converted trees, synthesizing the DataSpec so built
    models encode raw request dicts exactly like trained ones (§5.1) and flow
    unchanged through ``compile()``, the CUDA traversal kernels and serving
    bundles. ``build(device=)`` compiles the model's predictor there (None
    is the card, and raises ``YdfError`` without one unless
    ``device="cpu"`` is passed).

Validation follows the paper's §2.1 error style: say what failed in task
terms, show the offending values, propose concrete fixes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Union

import numpy as np

from repro_torch.core.api import Task, YdfError
from repro_torch.core.dataspec import OOD, Column, DataSpec, Semantic
from repro_torch.core.tree import MASK_WORDS, Forest, empty_forest

MAX_CATEGORY = MASK_WORDS * 32 - 1  # ids above this cannot be mask-encoded


# ===================================================================== values

@dataclass(frozen=True)
class ProbabilityValue:
    """A leaf holding a class distribution (RF / CART classification)."""
    probability: tuple[float, ...]

    def vector(self) -> np.ndarray:
        return np.asarray(self.probability, np.float32)


@dataclass(frozen=True)
class RegressionValue:
    """A leaf holding a scalar target estimate (regression trees)."""
    value: float

    def vector(self) -> np.ndarray:
        return np.asarray([self.value], np.float32)


@dataclass(frozen=True)
class LogitValue:
    """A leaf holding an additive score contribution (GBT trees)."""
    logit: float

    def vector(self) -> np.ndarray:
        return np.asarray([self.logit], np.float32)


AbstractValue = Union[ProbabilityValue, RegressionValue, LogitValue]


def value_from_vector(vec: np.ndarray, kind: str) -> AbstractValue:
    vec = np.asarray(vec)
    if kind == "probability":
        return ProbabilityValue(tuple(float(v) for v in vec))
    if kind == "logit":
        return LogitValue(float(vec[0]))
    if kind == "regression":
        return RegressionValue(float(vec[0]))
    raise YdfError(f"Unknown leaf-value kind {kind!r}. "
                   "Expected 'probability', 'regression' or 'logit'.")


# ================================================================= conditions

@dataclass(frozen=True)
class NumericalHigherThan:
    """Go to ``pos_child`` when ``x[feature] >= threshold``.

    ``split_bin`` is the binned-domain split index the training engines use;
    it is carried so SoA round-trips are exact, and may stay 0 for
    hand-written or imported trees (inference never reads it).
    """
    feature: int
    threshold: float
    split_bin: int = 0


@dataclass(frozen=True)
class CategoricalIsIn:
    """Go to ``pos_child`` when the category code of ``x[feature]`` is in
    ``categories``. Codes index the column's dictionary (0 = out-of-dict);
    ``ModelBuilder`` also accepts the category *strings* and resolves them
    against the feature's vocabulary."""
    feature: int
    categories: tuple = ()


@dataclass(frozen=True)
class Oblique:
    """Go to ``pos_child`` when ``sum_k weights[k] * x[features[k]] >=
    threshold`` (sparse-oblique, paper §3.8)."""
    features: tuple[int, ...]
    weights: tuple[float, ...]
    threshold: float


AbstractCondition = Union[NumericalHigherThan, CategoricalIsIn, Oblique]


# ====================================================================== nodes

@dataclass
class Leaf:
    value: AbstractValue

    @property
    def is_leaf(self) -> bool:
        return True


@dataclass
class NonLeaf:
    """``neg_child`` is taken when the condition is False, ``pos_child`` when
    True. ``value`` optionally carries the node-level statistics growers
    leave on internal nodes (CART pruning promotes them to leaf values).
    ``split_order`` is the SoA child-pair allocation rank; ``to_trees`` fills
    it so round-trips are bit-identical, hand-written trees may leave it None
    (children are then allocated in level order)."""
    condition: AbstractCondition
    neg_child: "AnyNode"
    pos_child: "AnyNode"
    value: AbstractValue | None = None
    split_order: int | None = None

    @property
    def is_leaf(self) -> bool:
        return False


AnyNode = Union[Leaf, NonLeaf]


@dataclass
class Tree:
    """One decision tree. ``tree_class`` is the GBT multiclass tree->class
    assignment (None outside multiclass GBT)."""
    root: AnyNode
    tree_class: int | None = None

    # ------------------------------------------------------------- traversal
    def iter_nodes(self) -> Iterator[tuple[AnyNode, int]]:
        """Yields (node, depth) in pre-order."""
        stack = [(self.root, 0)]
        while stack:
            node, d = stack.pop()
            yield node, d
            if not node.is_leaf:
                stack.append((node.pos_child, d + 1))
                stack.append((node.neg_child, d + 1))

    def leaves(self) -> list[Leaf]:
        return [n for n, _ in self.iter_nodes() if n.is_leaf]

    @property
    def n_nodes(self) -> int:
        return sum(1 for _ in self.iter_nodes())

    @property
    def n_leaves(self) -> int:
        return len(self.leaves())

    @property
    def depth(self) -> int:
        return max(d for _, d in self.iter_nodes())

    def pretty(self, *, feature_names: list[str] | None = None,
               cat_vocabs: dict[int, list[str]] | None = None,
               classes: list[str] | None = None, max_depth: int = 8) -> str:
        return render_tree(self, feature_names=feature_names,
                           cat_vocabs=cat_vocabs, classes=classes,
                           max_depth=max_depth)


# ============================================================== SoA -> trees

def _condition_at(forest: Forest, t: int, s: int) -> AbstractCondition:
    f = int(forest.feature[t, s])
    if f == -2:
        w = forest.obl_weights[t, s]
        fo = forest.obl_features[t, s]
        P = len(w)
        while P > 1 and w[P - 1] == 0.0 and fo[P - 1] == 0:
            P -= 1  # trailing zero padding is layout, not semantics
        return Oblique(features=tuple(int(v) for v in fo[:P]),
                       weights=tuple(float(v) for v in w[:P]),
                       threshold=float(forest.threshold[t, s]))
    if f < 0:
        raise YdfError(
            f"Tree {t} node {s} is internal (left_child="
            f"{int(forest.left_child[t, s])}) but has no condition "
            f"(feature={f}). The forest arrays are corrupt.")
    if forest.cat_mask[t, s].any():
        bits = np.unpackbits(forest.cat_mask[t, s].view(np.uint8),
                             bitorder="little")
        return CategoricalIsIn(
            feature=f, categories=tuple(int(c) for c in np.where(bits)[0]))
    # a forest carried across without its training fields has no split_bin:
    # its conditions take a hand-written condition's default
    split_bin = 0 if forest.split_bin is None else int(forest.split_bin[t, s])
    return NumericalHigherThan(feature=f,
                               threshold=float(forest.threshold[t, s]),
                               split_bin=split_bin)


def forest_to_trees(forest: Forest, *, value_kind: str | None = None
                    ) -> list[Tree]:
    """Extract the reachable structure of every tree as typed nodes.

    ``value_kind`` selects the leaf wrapper ('probability' / 'regression' /
    'logit'); default: 'probability' when the leaf dimension is > 1, else
    'regression'. ``ModelInspector`` passes the model-accurate kind.
    """
    leaf_dim = forest.leaf_value.shape[-1]
    kind = value_kind or ("probability" if leaf_dim > 1 else "regression")
    trees: list[Tree] = []
    for t in range(forest.n_trees):
        lc = forest.left_child[t]
        order = [0]
        i = 0
        while i < len(order):
            s = order[i]
            i += 1
            if lc[s] >= 0:
                order += [int(lc[s]), int(lc[s]) + 1]
        node_of: dict[int, AnyNode] = {}
        for s in reversed(order):
            vec = forest.leaf_value[t, s]
            if lc[s] < 0:
                node_of[s] = Leaf(value=value_from_vector(vec, kind))
            else:
                left = int(lc[s])
                node_of[s] = NonLeaf(
                    condition=_condition_at(forest, t, s),
                    neg_child=node_of[left], pos_child=node_of[left + 1],
                    value=(value_from_vector(vec, kind) if vec.any() else None),
                    split_order=((left - 1) // 2 if left % 2 == 1 else None))
        tc = (int(forest.tree_class[t])
              if forest.tree_class is not None else None)
        trees.append(Tree(root=node_of[0], tree_class=tc))
    return trees


# ============================================================== trees -> SoA

def _resolve_categories(cond: CategoricalIsIn, ti: int,
                        cat_vocabs: dict[int, list[str]] | None) -> list[int]:
    codes: list[int] = []
    for c in cond.categories:
        if isinstance(c, (int, np.integer)):
            codes.append(int(c))
            continue
        vocab = (cat_vocabs or {}).get(cond.feature)
        if vocab is None:
            raise YdfError(
                f"Tree {ti}: CategoricalIsIn on feature {cond.feature} uses "
                f"the category string {c!r} but no vocabulary is known for "
                "that feature. Solutions: (1) use integer category codes, or "
                "(2) build through ModelBuilder with a CATEGORICAL feature "
                "declaring its vocabulary.")
        if str(c) not in vocab:
            raise YdfError(
                f"Tree {ti}: category {c!r} is not in the vocabulary of "
                f"feature {cond.feature}: {vocab}. Solution: declare it in "
                "the feature's vocabulary or drop it from the condition.")
        codes.append(vocab.index(str(c)))
    return codes


def _validate_condition(cond, ti: int, n_features: int | None,
                        cat_vocabs) -> list[int] | None:
    """Returns resolved category codes for CategoricalIsIn, else None."""
    if isinstance(cond, NumericalHigherThan):
        if not np.isfinite(cond.threshold):
            raise YdfError(
                f"Tree {ti}: NumericalHigherThan(feature={cond.feature}) has "
                f"a non-finite threshold ({cond.threshold}). Solution: use a "
                "finite float threshold.")
        if not 0 <= int(cond.split_bin) <= 0xFFFF:
            raise YdfError(
                f"Tree {ti}: split_bin={cond.split_bin} does not fit uint16. "
                "Solution: leave split_bin at 0 for hand-written trees.")
        feats = [cond.feature]
    elif isinstance(cond, CategoricalIsIn):
        codes = _resolve_categories(cond, ti, cat_vocabs)
        if not codes:
            raise YdfError(
                f"Tree {ti}: CategoricalIsIn(feature={cond.feature}) has an "
                "empty category set — the SoA encodes categorical tests as "
                "bit masks and an empty mask means 'numerical'. Solution: "
                "put at least one category in the set, or replace the node "
                "by its neg_child.")
        bad = [c for c in codes if not 0 <= c <= MAX_CATEGORY]
        if bad:
            raise YdfError(
                f"Tree {ti}: category code(s) {bad} out of the supported "
                f"range [0, {MAX_CATEGORY}] (the SoA stores {MASK_WORDS}*32 "
                "category bits per node). Solution: re-map rare categories "
                "into the dictionary's first 256 entries.")
        feats = [cond.feature]
    elif isinstance(cond, Oblique):
        if len(cond.features) != len(cond.weights) or not cond.features:
            raise YdfError(
                f"Tree {ti}: Oblique condition has {len(cond.features)} "
                f"feature(s) but {len(cond.weights)} weight(s); both must be "
                "equal-length and non-empty.")
        if not (np.isfinite(cond.threshold)
                and np.isfinite(cond.weights).all()):
            raise YdfError(
                f"Tree {ti}: Oblique condition has non-finite threshold or "
                f"weights (threshold={cond.threshold}, "
                f"weights={cond.weights}).")
        feats = list(cond.features)
    else:
        raise YdfError(
            f"Tree {ti}: unsupported condition type {type(cond).__name__!r}. "
            "Supported: NumericalHigherThan, CategoricalIsIn, Oblique.")
    for f in feats:
        if not isinstance(f, (int, np.integer)) or f < 0:
            raise YdfError(
                f"Tree {ti}: condition references feature {f!r}; features "
                "are referenced by non-negative column index into the "
                "model's feature list.")
        if n_features is not None and f >= n_features:
            raise YdfError(
                f"Tree {ti}: condition references feature index {int(f)} but "
                f"the model has only {n_features} input feature(s). "
                "Solutions: (1) fix the feature index, or (2) declare the "
                "missing feature column.")
    return codes if isinstance(cond, CategoricalIsIn) else None


def _leaf_vector(value, ti: int, leaf_dim: int | None) -> np.ndarray:
    if not hasattr(value, "vector"):
        raise YdfError(
            f"Tree {ti}: leaf value {value!r} is not a typed value. Wrap it "
            "as ProbabilityValue / RegressionValue / LogitValue.")
    vec = value.vector()
    if not np.isfinite(vec).all():
        raise YdfError(
            f"Tree {ti}: leaf value {value!r} contains non-finite entries.")
    if leaf_dim is not None and len(vec) != leaf_dim:
        raise YdfError(
            f"Tree {ti}: leaf value has dimension {len(vec)} but the forest "
            f"leaf dimension is {leaf_dim} (every leaf must agree; "
            "classification leaves carry one probability per class). "
            f"Offending value: {value!r}.")
    return vec


@dataclass
class _TreeLayout:
    nodes: list  # BFS list of (node, slot, depth)
    ranks: dict  # id(internal node) -> child-pair allocation rank
    n_nodes: int
    depth: int


def _layout_tree(tr: Tree, ti: int, max_nodes: int | None) -> _TreeLayout:
    """Assign SoA slots: root at 0, the k-th split's children at (1+2k, 2+2k).

    Ranks come from ``split_order`` when every internal node carries a
    consistent hint (bit-identical round-trips); otherwise — hand-written or
    edited trees — ranks are assigned in level order.
    """
    if not isinstance(tr, Tree):
        raise YdfError(
            f"Expected a py_tree.Tree at index {ti}, got {type(tr).__name__}."
            " Wrap the root node: Tree(root=node).")
    # BFS collect, with cycle/DAG detection
    order: list[tuple[AnyNode, AnyNode | None, int]] = [(tr.root, None, 0)]
    seen: set[int] = {id(tr.root)}
    i = 0
    internals: list[NonLeaf] = []
    depth = 0
    while i < len(order):
        node, _, d = order[i]
        i += 1
        depth = max(depth, d)
        if node.is_leaf:
            continue
        if not isinstance(node, NonLeaf):
            raise YdfError(
                f"Tree {ti}: node {node!r} is neither Leaf nor NonLeaf.")
        internals.append(node)
        for child in (node.neg_child, node.pos_child):
            if id(child) in seen:
                raise YdfError(
                    f"Tree {ti}: the same node object appears twice — trees "
                    "must be trees, not DAGs or cycles. Solution: "
                    "copy.deepcopy the shared subtree.")
            seen.add(id(child))
            order.append((child, node, d + 1))
    S = len(internals)
    n_nodes = 1 + 2 * S
    if max_nodes is not None and n_nodes > max_nodes:
        raise YdfError(
            f"Tree {ti} needs {n_nodes} node slots ({S} splits) but the "
            f"node budget is max_nodes={max_nodes}. Solutions: (1) raise "
            "max_nodes, or (2) prune the tree.")
    # ranks: honor split_order hints when complete and consistent
    ranks: dict[int, int] | None = {}
    hints = [n.split_order for n in internals]
    if S and all(h is not None for h in hints):
        if sorted(hints) != list(range(S)):
            ranks = None
        else:
            for n in internals:
                ranks[id(n)] = int(n.split_order)
            for node, parent, _ in order:
                if (ranks is not None and parent is not None
                        and not node.is_leaf
                        and ranks[id(node)] <= ranks[id(parent)]):
                    ranks = None  # child allocated before its parent: invalid
                    break
    else:
        ranks = None
    if ranks is None:  # level-order fallback
        ranks = {id(n): r for r, n in enumerate(internals)}
    # slots from parent ranks
    slot: dict[int, int] = {id(tr.root): 0}
    nodes = []
    for node, parent, d in order:
        if parent is not None:
            base = 1 + 2 * ranks[id(parent)]
            slot[id(node)] = base + (1 if node is parent.pos_child else 0)
        nodes.append((node, slot[id(node)], d))
    return _TreeLayout(nodes=nodes, ranks=ranks, n_nodes=n_nodes, depth=depth)


def forest_from_trees(trees: list[Tree], *,
                      feature_names: list[str] | None = None,
                      n_features: int | None = None,
                      out_dim: int | None = None,
                      max_nodes: int | None = None,
                      oblique_dims: int | None = None,
                      init_pred: np.ndarray | None = None,
                      tree_class: str = "auto",
                      depth: int | None = None,
                      cat_vocabs: dict[int, list[str]] | None = None,
                      like: Forest | None = None) -> Forest:
    """Build a Forest SoA from typed trees, validating as it goes.

    ``like`` copies layout metadata (capacity, leaf/out dims, oblique
    projection width, feature names, init_pred, depth) from an existing
    forest so ``Forest.from_trees(f.to_trees(), like=f)`` is bit-identical.
    Without ``like`` the layout is sized to fit the trees exactly.
    """
    if not trees:
        raise YdfError("from_trees needs at least one Tree; got an empty "
                       "list. Solution: add a tree, e.g. "
                       "Tree(root=Leaf(value=RegressionValue(0.0))).")
    if like is not None:
        feature_names = (like.feature_names if feature_names is None
                         else feature_names)
        n_features = (len(like.feature_names) or None) if n_features is None \
            else n_features
        out_dim = like.out_dim if out_dim is None else out_dim
        max_nodes = like.max_nodes if max_nodes is None else max_nodes
        if oblique_dims is None:
            oblique_dims = (0 if like.obl_weights is None
                            else like.obl_weights.shape[-1])
        init_pred = like.init_pred if init_pred is None else init_pred
        depth = like.depth if depth is None else depth
    if feature_names and n_features is None:
        n_features = len(feature_names)

    # -------- validate + layout every tree
    layouts: list[_TreeLayout] = []
    leaf_dim: int | None = None
    max_obl = 0
    max_feat = -1
    for ti, tr in enumerate(trees):
        layout = _layout_tree(tr, ti, max_nodes)
        for node, _, _ in layout.nodes:
            if node.is_leaf:
                vec = _leaf_vector(node.value, ti, leaf_dim)
                leaf_dim = len(vec) if leaf_dim is None else leaf_dim
            else:
                _validate_condition(node.condition, ti, n_features, cat_vocabs)
                if isinstance(node.condition, Oblique):
                    max_obl = max(max_obl, len(node.condition.features))
                    max_feat = max(max_feat, *node.condition.features)
                else:
                    max_feat = max(max_feat, node.condition.feature)
                if node.value is not None:
                    _leaf_vector(node.value, ti, leaf_dim)
        layouts.append(layout)
    if n_features is None:
        n_features = max_feat + 1
    if oblique_dims is None:
        oblique_dims = max_obl
    elif max_obl > oblique_dims:
        raise YdfError(
            f"An Oblique condition projects over {max_obl} features but the "
            f"forest's oblique projection width is {oblique_dims}. Solution: "
            f"pass oblique_dims>={max_obl} (or drop `like=`).")
    if max_nodes is None:
        max_nodes = max(l.n_nodes for l in layouts)

    T = len(trees)
    forest = empty_forest(
        T, max_nodes, out_dim or (leaf_dim or 1),
        oblique_dims=oblique_dims,
        feature_names=list(feature_names or [f"f{j}" for j in range(n_features)]))
    # empty_forest sizes leaf_value by out_dim; the leaf dim can differ
    # (GBT multiclass: scalar leaves + tree->class map)
    if (leaf_dim or 1) != forest.leaf_value.shape[-1]:
        forest.leaf_value = np.zeros((T, max_nodes, leaf_dim), np.float32)
    forest.out_dim = out_dim or (leaf_dim or 1)
    if init_pred is not None:
        forest.init_pred = np.asarray(init_pred, np.float32).copy()
    else:
        forest.init_pred = np.zeros(forest.out_dim, np.float32)

    computed_depth = 0
    for t, (tr, layout) in enumerate(zip(trees, layouts)):
        forest.n_nodes[t] = layout.n_nodes
        computed_depth = max(computed_depth, layout.depth)
        for node, s, _ in layout.nodes:
            if node.is_leaf:
                forest.leaf_value[t, s] = node.value.vector()
                continue
            if node.value is not None:
                forest.leaf_value[t, s] = node.value.vector()
            cond = node.condition
            forest.left_child[t, s] = 1 + 2 * layout.ranks[id(node)]
            if isinstance(cond, Oblique):
                forest.feature[t, s] = -2
                k = len(cond.features)
                forest.obl_features[t, s, :k] = cond.features
                forest.obl_weights[t, s, :k] = cond.weights
                forest.threshold[t, s] = cond.threshold
            elif isinstance(cond, CategoricalIsIn):
                forest.feature[t, s] = cond.feature
                for c in _resolve_categories(cond, t, cat_vocabs):
                    forest.cat_mask[t, s, c // 32] |= \
                        np.uint32(1) << np.uint32(c % 32)
            else:
                forest.feature[t, s] = cond.feature
                forest.threshold[t, s] = cond.threshold
                forest.split_bin[t, s] = cond.split_bin
    # depth is the engines' traversal bound: honor a larger stored depth
    # (truncated forests keep the pre-truncation max) but never a smaller
    # one — an edit that deepens a tree must deepen the bound too, or
    # inference silently stops above the new leaves
    forest.depth = max(computed_depth, depth or 0)

    classes_of = [tr.tree_class for tr in trees]
    if tree_class == "none" or all(c is None for c in classes_of):
        forest.tree_class = None
    else:
        forest.tree_class = np.asarray(
            [0 if c is None else int(c) for c in classes_of], np.int32)
    return forest


# ============================================================== ASCII render

def _fname(j: int, feature_names: list[str] | None) -> str:
    if feature_names and 0 <= j < len(feature_names):
        return f'"{feature_names[j]}"'
    return f'"f{j}"'


def _condition_str(cond: AbstractCondition,
                   feature_names: list[str] | None,
                   cat_vocabs: dict[int, list[str]] | None) -> str:
    if isinstance(cond, NumericalHigherThan):
        return f"{_fname(cond.feature, feature_names)} >= {cond.threshold:g}"
    if isinstance(cond, CategoricalIsIn):
        vocab = (cat_vocabs or {}).get(cond.feature)
        names = [vocab[c] if vocab and isinstance(c, (int, np.integer))
                 and c < len(vocab) else str(c) for c in cond.categories]
        shown = names[:6] + (["..."] if len(names) > 6 else [])
        return (f"{_fname(cond.feature, feature_names)} in "
                "{" + ", ".join(shown) + "}")
    terms = " + ".join(f"{w:g}*{_fname(f, feature_names)}"
                       for f, w in zip(cond.features, cond.weights))
    return f"{terms} >= {cond.threshold:g}"


def _value_str(value: AbstractValue, classes: list[str] | None) -> str:
    if isinstance(value, ProbabilityValue):
        p = value.probability
        if classes and len(classes) == len(p):
            inner = ", ".join(f"{c}:{v:.3g}" for c, v in zip(classes, p))
        else:
            inner = ", ".join(f"{v:.3g}" for v in p)
        return f"p=[{inner}]"
    if isinstance(value, LogitValue):
        return f"logit={value.logit:g}"
    return f"value={value.value:g}"


def render_tree(tree: Tree, *, feature_names: list[str] | None = None,
                cat_vocabs: dict[int, list[str]] | None = None,
                classes: list[str] | None = None, max_depth: int = 8) -> str:
    """plot_tree-style ASCII rendering (paper §4.1 show_model artefacts)."""
    lines: list[str] = []
    # iterative: imported trees can be deeper than the recursion limit
    stack = [(tree.root, "", "", 0)]
    while stack:
        node, prefix, tag, depth = stack.pop()
        head = f"{tag} " if tag else ""
        if node.is_leaf:
            lines.append(prefix + head + _value_str(node.value, classes))
            continue
        lines.append(prefix + head + _condition_str(
            node.condition, feature_names, cat_vocabs))
        bar = prefix + ("│   " if tag.startswith("├") else "    ")
        if depth >= max_depth:
            lines.append(bar + "... (max_depth reached)")
            continue
        stack.append((node.neg_child, bar, "└─(neg)", depth + 1))
        stack.append((node.pos_child, bar, "├─(pos)", depth + 1))
    return "\n".join(lines)


# ================================================================= inspector

class ModelInspector:
    """Read-side of the typed API: iterate a model's trees, per-tree
    structure stats, ASCII rendering. Conversion is lazy and cached."""

    def __init__(self, model):
        self.model = model
        self._trees: list[Tree] | None = None

    @property
    def value_kind(self) -> str:
        from repro_torch.core.models import GradientBoostedTreesModel
        if isinstance(self.model, GradientBoostedTreesModel):
            return "logit"
        return ("probability" if self.model.task == Task.CLASSIFICATION
                else "regression")

    def trees(self) -> list[Tree]:
        if self._trees is None:
            self._trees = forest_to_trees(self.model.forest,
                                          value_kind=self.value_kind)
            if self.value_kind != "logit":
                # only a GBT's trees have a class; the port's RF and CART
                # forests carry a zero tree_class array where the
                # reference's carry None
                for tr in self._trees:
                    tr.tree_class = None
        return self._trees

    def iter_trees(self) -> Iterator[Tree]:
        return iter(self.trees())

    def tree(self, i: int) -> Tree:
        trees = self.trees()
        if not 0 <= i < len(trees):
            raise YdfError(f"Tree index {i} out of range: the model has "
                           f"{len(trees)} trees.")
        return trees[i]

    @property
    def n_trees(self) -> int:
        return self.model.forest.n_trees

    def tree_stats(self) -> list[dict]:
        return [{"tree": i, "depth": tr.depth, "n_nodes": tr.n_nodes,
                 "n_leaves": tr.n_leaves, "tree_class": tr.tree_class}
                for i, tr in enumerate(self.trees())]

    def stats_summary(self) -> dict:
        st = self.tree_stats()
        depths = np.array([s["depth"] for s in st])
        leaves = np.array([s["n_leaves"] for s in st])
        return {"n_trees": len(st),
                "depth_min": int(depths.min()), "depth_max": int(depths.max()),
                "depth_mean": float(depths.mean()),
                "leaves_mean": float(leaves.mean()),
                "leaves_total": int(leaves.sum())}

    def _cat_vocabs(self) -> dict[int, list[str]]:
        out = {}
        for j, name in enumerate(self.model.features):
            col = self.model.spec[name]
            if col.semantic == Semantic.CATEGORICAL:
                out[j] = list(col.vocab)
        return out

    def plot_tree(self, i: int = 0, max_depth: int = 8) -> str:
        return self.tree(i).pretty(
            feature_names=list(self.model.features),
            cat_vocabs=self._cat_vocabs(),
            classes=getattr(self.model, "classes", None),
            max_depth=max_depth)


# ==================================================================== builder

@dataclass
class FeatureColumn:
    """A feature declaration for DataSpec synthesis. ``mean`` is the
    numerical imputation value served for missing inputs; ``vocab`` is the
    categorical dictionary in frequency order (most frequent first — code 1
    doubles as the categorical imputation, like trained models)."""
    name: str
    semantic: Semantic = Semantic.NUMERICAL
    vocab: tuple[str, ...] = ()
    mean: float = 0.0


def _coerce_feature(obj, idx: int) -> FeatureColumn:
    if isinstance(obj, FeatureColumn):
        return obj
    if isinstance(obj, str):
        return FeatureColumn(name=obj)
    if isinstance(obj, (tuple, list)) and len(obj) >= 2:
        name, sem = obj[0], Semantic(obj[1]) if not isinstance(obj[1], Semantic) else obj[1]
        vocab = tuple(obj[2]) if len(obj) > 2 else ()
        if sem == Semantic.CATEGORICAL and not vocab:
            raise YdfError(
                f"Feature {name!r} is CATEGORICAL but declares no "
                "vocabulary. Solution: pass (name, 'CATEGORICAL', "
                "['red', 'blue', ...]) in frequency order.")
        return FeatureColumn(name=name, semantic=sem, vocab=vocab)
    raise YdfError(
        f"Cannot interpret feature declaration #{idx}: {obj!r}. Accepted: a "
        "name (NUMERICAL), a (name, semantic[, vocab]) tuple, or a "
        "FeatureColumn.")


def synthesize_dataspec(features: list[FeatureColumn], label: str,
                        task: Task, classes: list[str] | None) -> DataSpec:
    """Build the DataSpec a trained model would have carried, so built
    models encode raw request dicts exactly like trained ones (§5.1)."""
    columns: dict[str, Column] = {}
    for fc in features:
        if fc.name == label:
            raise YdfError(f"Feature {fc.name!r} collides with the label "
                           "column name. Solution: rename one of them.")
        if fc.semantic == Semantic.CATEGORICAL:
            vocab = [OOD] + [str(v) for v in fc.vocab]
            if len(set(vocab)) != len(vocab):
                raise YdfError(
                    f"Feature {fc.name!r} has duplicate vocabulary entries: "
                    f"{list(fc.vocab)}.")
            columns[fc.name] = Column(
                name=fc.name, semantic=Semantic.CATEGORICAL, vocab=vocab,
                counts={v: len(vocab) - i for i, v in enumerate(vocab[1:])},
                manually_defined=True)
        else:
            columns[fc.name] = Column(
                name=fc.name, semantic=fc.semantic, mean=fc.mean,
                manually_defined=True)
    if task == Task.CLASSIFICATION:
        vocab = [OOD] + [str(c) for c in (classes or [])]
        columns[label] = Column(
            name=label, semantic=Semantic.CATEGORICAL, vocab=vocab,
            counts={v: len(vocab) - i for i, v in enumerate(vocab[1:])},
            manually_defined=True)
    else:
        columns[label] = Column(name=label, semantic=Semantic.NUMERICAL,
                                manually_defined=True)
    return DataSpec(columns=columns, n_rows=0)


class ModelBuilder:
    """Base of the write-side API: accumulate typed trees, synthesize the
    DataSpec, emit a servable model. Subclasses fix the model family."""

    def __init__(self, *, label: str, features,
                 task: Task = Task.CLASSIFICATION,
                 classes: list[str] | None = None):
        self.label = label
        self.task = task
        self.features = [_coerce_feature(f, i) for i, f in enumerate(features)]
        names = [f.name for f in self.features]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise YdfError(f"Duplicate feature name(s): {dup}.")
        if task == Task.CLASSIFICATION:
            if not classes or len(classes) < 2:
                raise YdfError(
                    "A classification ModelBuilder needs the label classes "
                    f"(got {classes!r}). Solution: pass classes=['no', 'yes'] "
                    "in the probability-column order the leaves use.")
            self.classes: list[str] | None = [str(c) for c in classes]
        else:
            self.classes = None
        self.trees: list[Tree] = []

    # ------------------------------------------------------------ helpers
    @property
    def n_classes(self) -> int:
        return len(self.classes) if self.classes else 0

    def _cat_vocabs(self) -> dict[int, list[str]]:
        return {j: [OOD] + [str(v) for v in fc.vocab]
                for j, fc in enumerate(self.features)
                if fc.semantic == Semantic.CATEGORICAL}

    def add_tree(self, tree: Tree | AnyNode) -> "ModelBuilder":
        if isinstance(tree, (Leaf, NonLeaf)):
            tree = Tree(root=tree)
        self.trees.append(tree)
        return self

    def _spec(self) -> DataSpec:
        return synthesize_dataspec(self.features, self.label, self.task,
                                   self.classes)

    def _check_leaf_kind(self, allowed: tuple, leaf_dim: int) -> None:
        for ti, tr in enumerate(self.trees):
            for node, _ in tr.iter_nodes():
                if not node.is_leaf:
                    continue
                if not isinstance(node.value, allowed):
                    names = "/".join(a.__name__ for a in allowed)
                    raise YdfError(
                        f"Tree {ti}: {type(self).__name__} expects {names} "
                        f"leaves, got {type(node.value).__name__}. Solution: "
                        "wrap leaf values in the matching type.")
                vec = node.value.vector()
                if len(vec) != leaf_dim:
                    raise YdfError(
                        f"Tree {ti}: leaf dimension {len(vec)} != expected "
                        f"{leaf_dim} ({'one probability per class' if leaf_dim > 1 else 'a scalar'}).")
                if isinstance(node.value, ProbabilityValue):
                    s = float(vec.sum())
                    if not np.isclose(s, 1.0, atol=1e-3):
                        raise YdfError(
                            f"Tree {ti}: ProbabilityValue sums to {s:.4g}, "
                            "not 1. Solution: normalize the distribution "
                            "(or use RegressionValue for raw scores).")

    def build(self, *, max_nodes: int | None = None, device=None):
        raise NotImplementedError

    @staticmethod
    def _compiled(model, device):
        """Compile the built model's default predictor on ``device`` (None
        is the card): the forest is packed and uploaded now, and a kernel
        that does not build raises here."""
        model.compile(None, device)
        return model


class RandomForestBuilder(ModelBuilder):
    """Builds a ``RandomForestModel``: classification leaves are class
    distributions averaged (or majority-voted) across trees; regression
    leaves are scalar estimates averaged across trees."""

    def __init__(self, *, winner_take_all: bool = False, **kw):
        super().__init__(**kw)
        self.winner_take_all = winner_take_all

    def build(self, *, max_nodes: int | None = None, device=None):
        from repro_torch.core.engines import resolve_device
        resolve_device(device)           # no card: raise before any work
        if not self.trees:
            raise YdfError(f"{type(self).__name__} has no trees; call "
                           "add_tree() before build().")
        leaf_dim = self.n_classes if self.task == Task.CLASSIFICATION else 1
        self._check_leaf_kind(
            (ProbabilityValue,) if leaf_dim > 1 else (RegressionValue,),
            leaf_dim)
        forest = forest_from_trees(
            self.trees, feature_names=[f.name for f in self.features],
            out_dim=leaf_dim, max_nodes=max_nodes, tree_class="none",
            cat_vocabs=self._cat_vocabs())
        return self._compiled(self._model_cls()(
            winner_take_all=self.winner_take_all, forest=forest,
            spec=self._spec(), features=[f.name for f in self.features],
            label=self.label, task=self.task, classes=self.classes), device)

    def _model_cls(self):
        from repro_torch.core.models import RandomForestModel
        return RandomForestModel


class CartBuilder(RandomForestBuilder):
    """Builds a single-tree ``CartModel``."""

    def build(self, *, max_nodes: int | None = None, device=None):
        if len(self.trees) != 1:
            raise YdfError(
                f"CartBuilder builds exactly one tree, got {len(self.trees)}."
                " Solution: use RandomForestBuilder for multi-tree models.")
        return super().build(max_nodes=max_nodes, device=device)

    def _model_cls(self):
        from repro_torch.core.models import CartModel
        return CartModel


class GradientBoostedTreesBuilder(ModelBuilder):
    """Builds a ``GradientBoostedTreesModel``: leaves are additive logit /
    score contributions, summed per class (``tree_class`` routes multiclass
    trees) on top of ``init_pred``, then passed through the task's
    activation (sigmoid / softmax / identity)."""

    def __init__(self, *, init_pred=None, **kw):
        super().__init__(**kw)
        from repro_torch.core.losses import make_loss
        self.loss = make_loss(self.task, "DEFAULT", self.n_classes)
        self.init_pred = np.zeros(self.loss.out_dim, np.float32) \
            if init_pred is None else np.asarray(init_pred, np.float32)
        if self.init_pred.shape != (self.loss.out_dim,):
            raise YdfError(
                f"init_pred has shape {self.init_pred.shape}, expected "
                f"({self.loss.out_dim},) — one bias per output dimension "
                f"({self.loss.name}).")

    def add_tree(self, tree: Tree | AnyNode,
                 tree_class: int | None = None) -> "ModelBuilder":
        if isinstance(tree, (Leaf, NonLeaf)):
            tree = Tree(root=tree)
        if tree_class is not None:
            tree = dataclasses.replace(tree, tree_class=tree_class)
        self.trees.append(tree)
        return self

    def build(self, *, max_nodes: int | None = None, device=None):
        from repro_torch.core.engines import resolve_device
        from repro_torch.core.models import GradientBoostedTreesModel
        resolve_device(device)           # no card: raise before any work
        if not self.trees:
            raise YdfError("GradientBoostedTreesBuilder has no trees; call "
                           "add_tree() before build().")
        K = self.loss.out_dim
        self._check_leaf_kind((LogitValue, RegressionValue), 1)
        if K > 1:
            missing = [i for i, tr in enumerate(self.trees)
                       if tr.tree_class is None]
            if missing:
                raise YdfError(
                    f"Multiclass GBT ({K} classes) needs a tree_class on "
                    f"every tree; tree(s) {missing[:5]} have none. Solution: "
                    "add_tree(tree, tree_class=k) with k in "
                    f"[0, {K - 1}].")
            bad = [i for i, tr in enumerate(self.trees)
                   if not 0 <= tr.tree_class < K]
            if bad:
                raise YdfError(
                    f"tree_class out of range on tree(s) {bad[:5]}; must be "
                    f"in [0, {K - 1}].")
        forest = forest_from_trees(
            self.trees, feature_names=[f.name for f in self.features],
            out_dim=K, max_nodes=max_nodes,
            tree_class="auto" if K > 1 else "none",
            init_pred=self.init_pred, cat_vocabs=self._cat_vocabs())
        if K > 1 and forest.tree_class is None:
            forest.tree_class = np.zeros(forest.n_trees, np.int32)
        return self._compiled(GradientBoostedTreesModel(
            loss=self.loss, forest=forest, spec=self._spec(),
            features=[f.name for f in self.features], label=self.label,
            task=self.task, classes=self.classes), device)
