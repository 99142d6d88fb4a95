"""Model analysis (DESIGN.md §8), the port's copy of ``repro.analysis`` —
the paper's third pillar: "the training,
serving and INTERPRETATION of decision forest models".

``analyze_model(model, ds)`` (surfaced as ``model.analyze(ds)``) bundles the
three engines into one AnalysisReport:

  * structural variable importances — one vectorized pass over the Forest
    SoA (importance.structural_importances);
  * permutation variable importances (+ the Random-Forest out-of-bag
    variant) — inference-heavy sweeps dispatched as stacked replica batches
    through the cached CompiledPredictor / ForestServeBundle
    (importance.permutation_importances / oob_permutation_importances);
  * partial dependence + ICE curves — grid x sample cross products through
    the same compiled path (partial_dependence.partial_dependence).

Reports render as text (``report()``) and as JSON payloads (``to_dict()``).
Every sweep runs on ``device`` (None is the card; without one it raises
``YdfError`` unless ``device="cpu"`` is passed): on the card through the
cuda engine's traversal kernel.
"""
from __future__ import annotations

from repro_torch.analysis.importance import (  # noqa: F401
    oob_permutation_importances,
    permutation_importances,
    regenerate_oob_masks,
    structural_importances,
)
from repro_torch.analysis.partial_dependence import partial_dependence  # noqa: F401
from repro_torch.analysis.report import (  # noqa: F401
    AnalysisReport,
    ImportanceEntry,
    ImportanceTable,
    PDPCurve,
    sparkline,
)
from repro_torch.core.api import Task, YdfError  # noqa: F401


def _has_label(model, dataset) -> bool:
    from repro_torch.core.dataspec import VerticalDataset
    if isinstance(dataset, VerticalDataset):
        return (model.label in dataset.spec.columns
                and (model.label in dataset.numerical
                     or model.label in dataset.categorical))
    try:
        return model.label in dataset
    except TypeError:
        return False


def analyze_model(model, dataset=None, *, permutation_repetitions: int = 3,
                  features: list[str] | None = None, grid_size: int = 16,
                  sample_rows: int = 256, ice: bool = False,
                  oob: bool | str = "auto", seed: int = 42, bundle=None,
                  row_budget: int | None = None, device=None,
                  engine: str | None = None) -> AnalysisReport:
    """Build the full analysis report.

    Without ``dataset`` only the structural importances are computed. With
    one, permutation importances and an evaluation are added when the label
    column is present, the OOB variant when ``oob`` is "auto"/True and the
    model carries regenerable bags for a same-sized dataset, and PDP curves
    always. ``bundle`` routes every sweep through a ForestServeBundle's
    padded buckets; ``row_budget`` caps rows per stacked dispatch.
    ``device`` (None: the card) and ``engine`` select the predictor every
    sweep dispatches through.
    """
    from repro_torch.core.engines import resolve_device
    resolve_device(device)               # no card: raise before any work
    if oob is True and dataset is None:
        raise YdfError(
            "oob=True requires the training dataset; analyze() was called "
            "without one. Solution: model.analyze(train_ds, oob=True).")
    notes: list[str] = []
    tables = structural_importances(model)
    evaluation = None
    pdp: list[PDPCurve] = []
    n_examples = 0
    kw = {"device": device, "engine": engine}
    if row_budget is not None:
        kw["row_budget"] = row_budget
    if dataset is not None:
        if _has_label(model, dataset):
            table, evaluation = permutation_importances(
                model, dataset, repetitions=permutation_repetitions,
                seed=seed, bundle=bundle, **kw)
            tables.append(table)
            n_examples = evaluation.n_examples
            bag_ok = (getattr(model, "bag_info", None) is not None
                      and evaluation.n_examples
                      == model.bag_info.get("n_rows", -1))
            if oob is True or (oob == "auto" and bag_ok):
                # the engine itself verifies the dataset IS the training
                # set (size + content fingerprint); under "auto" a mismatch
                # downgrades to a note instead of failing the analysis
                try:
                    oob_table, oob_eval = oob_permutation_importances(
                        model, dataset, seed=seed,
                        repetitions=permutation_repetitions, **kw)
                    tables.append(oob_table)
                    notes.append(
                        f"out-of-bag baseline {oob_table.metric}="
                        f"{oob_table.baseline:.6g} over "
                        f"{oob_eval.n_examples} examples")
                except YdfError as e:
                    if oob is True:
                        raise
                    notes.append(f"OOB importances skipped: {e}")
            elif oob == "auto" and getattr(model, "bag_info", None):
                notes.append(
                    "OOB importances skipped: dataset size differs from the "
                    "training set (pass the training dataset to enable)")
        else:
            if oob is True:
                raise YdfError(
                    "oob=True requires the training dataset WITH its label "
                    f'column, but "{model.label}" is absent. Solution: pass '
                    "the labeled training dataset to analyze().")
            notes.append(
                f'label column "{model.label}" absent: permutation '
                "importances and evaluation skipped")
        pdp = partial_dependence(
            model, dataset, features=features, grid_size=grid_size,
            sample_rows=sample_rows, ice=ice, seed=seed, bundle=bundle, **kw)
        if not n_examples and pdp:
            n_examples = pdp[0].n_sample
    return AnalysisReport(
        model_type=type(model).__name__, task=model.task.value,
        label=model.label, n_examples=n_examples, importances=tables,
        pdp=pdp, evaluation=evaluation, notes=notes)
