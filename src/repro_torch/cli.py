"""The CLI API (paper §4.1), the port's copy of ``repro.cli``: the same
verbs, over format-prefixed datasets, plus ``--device`` on every verb.

  python -m repro_torch.cli infer_dataspec --dataset=csv:train.csv --output=spec.json
  python -m repro_torch.cli show_dataspec  --dataspec=spec.json
  python -m repro_torch.cli train  --dataset=csv:train.csv --label=income \
        --learner=GRADIENT_BOOSTED_TREES --output=/tmp/model \
        [--task=CLASSIFICATION] [--hparam num_trees=50] [--template=...]
  python -m repro_torch.cli show_model --model=/tmp/model
  python -m repro_torch.cli evaluate --dataset=csv:test.csv --model=/tmp/model [--json]
  python -m repro_torch.cli analyze  --dataset=csv:test.csv --model=/tmp/model \
        [--json] [--output=report.json] [--repetitions=3] [--sample=256]
  python -m repro_torch.cli predict  --dataset=csv:test.csv --model=/tmp/model \
        --output=csv:predictions.csv
  python -m repro_torch.cli serve    --dataset=csv:requests.csv --model=/tmp/model \
        [--deadline-ms=50] [--request-rows=32] [--engines=vectorized,naive] \
        [--output=csv:predictions.csv] [--json]
  python -m repro_torch.cli benchmark_inference --dataset=csv:test.csv --model=/tmp/model
  python -m repro_torch.cli profile train --dataset=csv:train.csv --label=income \
        --trace=trace.json [--learner=...] [--hparam k=v]
  python -m repro_torch.cli profile infer --dataset=csv:test.csv --model=/tmp/model \
        --trace=trace.json

Training configurations are cross-API compatible (§3.10): a model trained
here loads from Python and vice versa. Models are the port's plain-data
model directories (``Model.save``/``Model.load``).

``--device`` (default ``cuda``) is where every verb trains, predicts,
analyzes and serves; without a card each verb raises ``YdfError`` unless
``--device=cpu`` is given. Engine names are the port's (``--engines`` of
``serve``: cuda, ref, bucketed, leaf_path, vectorized, naive). The verb
``import_sklearn`` would unpickle an estimator; this package reads no
pickle, so the verb refuses with directions to
``repro_torch.interop.from_sklearn(estimator).save(dir)`` in Python.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_spec(path: str):
    from repro_torch.core.dataspec import spec_from_dict
    with open(path) as f:
        return spec_from_dict(json.load(f))


def _dump_spec(spec, path: str):
    from repro_torch.core.dataspec import spec_to_dict
    with open(path, "w") as f:
        json.dump(spec_to_dict(spec), f, indent=1)


def cmd_infer_dataspec(args):
    from repro_torch.core.dataspec import infer_dataspec
    from repro_torch.data.io import read_dataset
    spec = infer_dataspec(read_dataset(args.dataset),
                          semantics=dict(kv.split("=") for kv in args.semantic))
    _dump_spec(spec, args.output)
    print(f"dataspec written to {args.output} "
          f"({len(spec.columns)} columns, {spec.n_rows} rows)")


def cmd_show_dataspec(args):
    print(_load_spec(args.dataspec).report())


def _parse_hparams(pairs):
    hparams = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                pass
        if v in ("true", "false", "True", "False"):
            v = str(v).lower() == "true"
        hparams[k] = v
    return hparams


def cmd_train(args):
    from repro_torch.core import Task, get_learner
    from repro_torch.data.io import read_dataset
    if args.resume:
        # continue an interrupted run: the learner is rebuilt from the
        # checkpoint manifest's train_config — only the dataset is re-read
        from repro_torch.train.checkpoint import resume_training
        data = read_dataset(args.dataset)
        valid = read_dataset(args.valid) if args.valid else None
        model = resume_training(args.resume, data, valid, device=args.device)
        model.save(args.output)
        print(f"resumed from {args.resume}; model written to {args.output}")
        logs = getattr(model, "training_logs", None)
        for ev in (logs or {}).get("resilience", []):
            print(f"  resilience: {ev}")
        return
    hparams = _parse_hparams(args.hparam)
    task = Task(args.task.upper())
    learner_name = args.learner
    if args.learner == "GRADIENT_BOOSTED_TREES":
        # the flag default; tasks with a dedicated learner re-route
        learner_name = {Task.UPLIFT: "UPLIFT_TREES",
                        Task.ANOMALY: "ISOLATION_FOREST"}.get(task,
                                                              args.learner)
    cls = get_learner(learner_name)
    kw = dict(label=args.label, task=task, seed=args.seed,
              device=args.device, **hparams)
    if args.template:
        kw["template"] = args.template
    learner = cls(**kw)
    data = read_dataset(args.dataset)
    valid = read_dataset(args.valid) if args.valid else None
    checkpoint = None
    if args.checkpoint_dir:
        from repro_torch.train.checkpoint import CheckpointPolicy
        checkpoint = CheckpointPolicy(args.checkpoint_dir,
                                      every_n_trees=args.checkpoint_every)
    model = learner.train(data, valid, checkpoint=checkpoint)
    model.save(args.output)
    se = getattr(model, "self_evaluation", None)
    logs = getattr(model, "training_logs", None)
    if isinstance(logs, dict) and logs.get("interrupted"):
        print("training interrupted; truncated model saved "
              f"(resume with: train --resume {args.checkpoint_dir} ...)")
    print(f"model written to {args.output}")
    if se is not None:
        print(se.report())


def cmd_show_model(args):
    from repro_torch.core import Model
    print(Model.load(args.model).summary(verbose=args.verbose))


def cmd_import_sklearn(args):
    """The reference's verb unpickles a fitted sklearn estimator. This
    package reads no pickle (its models are plain data), so the verb
    refuses and says how to import the estimator from Python."""
    from repro_torch.core.api import YdfError
    raise YdfError(
        f"import_sklearn would unpickle {args.estimator!r}, and this package "
        "reads no pickle. Solution: import the fitted estimator in Python, "
        "where it is already an object: "
        "repro_torch.interop.from_sklearn(estimator, label=..., "
        "device=...).save(dir), then use the model directory with the "
        "other verbs (--model=dir).")


def cmd_evaluate(args):
    from repro_torch.core import Model
    from repro_torch.data.io import read_dataset
    model = Model.load(args.model)
    ev = model.evaluate(read_dataset(args.dataset), device=args.device)
    if args.json:
        print(json.dumps(ev.to_dict(), indent=1))
    else:
        print(ev.report())


def cmd_analyze(args):
    """Model analysis (DESIGN.md §8): structural importances always;
    permutation importances, PDP curves and an evaluation when a dataset
    is given. The report prints as text or dumps as JSON."""
    from repro_torch.core import Model
    from repro_torch.data.io import read_dataset
    model = Model.load(args.model)
    data = read_dataset(args.dataset) if args.dataset else None
    rep = model.analyze(data, permutation_repetitions=args.repetitions,
                        sample_rows=args.sample, device=args.device)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rep.to_dict(), f, indent=1)
        print(f"analysis report written to {args.output}")
    if args.json:
        print(json.dumps(rep.to_dict(), indent=1))
    elif not args.output:
        print(rep.report())


def cmd_predict(args):
    from repro_torch.core import Model, Task
    from repro_torch.data.io import read_dataset, write_dataset
    model = Model.load(args.model)
    pred = model.predict(read_dataset(args.dataset), device=args.device)
    if model.task == Task.CLASSIFICATION:
        cols = {f"p_{c}": pred[:, i] for i, c in enumerate(model.classes)}
    else:
        cols = {"prediction": np.asarray(pred)}
    write_dataset(cols, args.output)
    print(f"{len(pred)} predictions written to {args.output}")


def cmd_serve(args):
    """Batch-score a dataset through the fault-tolerant ForestServer
    (DESIGN.md §9) and print the serving-metrics summary. Rows ride as
    deadline-bounded requests through admission control, retries and the
    engine-degradation chain — sheds and timeouts surface as NaN rows in
    the output and as counters in the summary, never as silent gaps."""
    from repro_torch.core import Model, Task
    from repro_torch.data.io import read_dataset, write_dataset
    from repro_torch.serving.server import ForestServer, RequestShed, YdfError
    model = Model.load(args.model)
    data = read_dataset(args.dataset)
    data.pop(model.label, None)          # serving requests carry features only
    n = len(next(iter(data.values())))
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms else None
    engines = args.engines.split(",") if args.engines else None
    srv = ForestServer(model, engines=engines,
                       default_deadline_s=deadline_s, warmup=True,
                       device=args.device)
    step = max(1, args.request_rows)
    spans, tickets = [], []
    for lo in range(0, n, step):
        req = {k: v[lo:lo + step] for k, v in data.items()}
        try:
            tickets.append(srv.submit(req))
        except RequestShed:
            tickets.append(None)
        spans.append((lo, min(lo + step, n)))
    srv.pump()
    out = np.full((n,) + tuple(srv._state(None).bundle(0).predictor.out_shape),
                  np.nan, np.float32)
    for t, (lo, hi) in zip(tickets, spans):
        if t is None:
            continue
        try:
            out[lo:hi] = srv.result(t)
        except YdfError:
            pass                         # timed out / failed: NaN rows, counted
    if args.output:
        if model.task == Task.CLASSIFICATION:
            cols = {f"p_{c}": out[:, i] for i, c in enumerate(model.classes)}
        else:
            cols = {"prediction": out.reshape(n)}
        write_dataset(cols, args.output)
        print(f"{n} rows scored to {args.output}")
    chain = " -> ".join(f"{e['engine']}[{e['circuit']}]"
                        for e in srv.engine_status())
    print(f"served {len(spans)} requests x {step} rows "
          f"(deadline {'none' if deadline_s is None else f'{args.deadline_ms:g} ms'}, "
          f"engine chain {chain})")
    if args.json:
        print(json.dumps(srv.metrics.to_dict(), indent=1))
    else:
        print(srv.metrics.summary())


def cmd_benchmark_inference(args):
    from repro_torch.core import Model
    from repro_torch.core.engines import benchmark_inference
    from repro_torch.data.io import read_dataset
    model = Model.load(args.model)
    print(benchmark_inference(model, read_dataset(args.dataset),
                              repetitions=args.repetitions,
                              device=args.device))


def cmd_profile(args):
    """Per-phase profiling (DESIGN.md §13): run one training or one
    inference pass under the tracer, write a Chrome trace-event file
    (loadable in chrome://tracing / ui.perfetto.dev) and print the phase
    summary — where the time went, phase by phase, subsystem by
    subsystem. On a CUDA device the device's operations, from
    ``torch.profiler``'s records, fill a lane of their own on the spans'
    timeline. No flags change what runs; profiling observes, it does
    not steer."""
    import contextlib

    import torch

    from repro_torch.data.io import read_dataset
    from repro_torch.obs import trace
    from repro_torch.obs.export import (device_ops, phase_summary,
                                        profile_dict, write_chrome_trace)
    data = read_dataset(args.dataset)
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
    else:
        prof = contextlib.nullcontext()
    if args.what == "train":
        from repro_torch.core import Task, get_learner
        cls = get_learner(args.learner)
        learner = cls(label=args.label, task=Task(args.task.upper()),
                      seed=args.seed, device=args.device,
                      **_parse_hparams(args.hparam))
        with prof, trace.capture() as tracer:
            model = learner.train(data)
            if on_card:
                torch.cuda.synchronize()
        if args.output:
            model.save(args.output)
            print(f"model written to {args.output}")
    else:
        from repro_torch.core import Model
        model = Model.load(args.model)
        data.pop(model.label, None)
        with prof, trace.capture() as tracer:
            for _ in range(max(1, args.repetitions)):
                model.predict(data, device=args.device)
            if on_card:
                torch.cuda.synchronize()
    ops = device_ops(prof, tracer) if on_card else []
    write_chrome_trace(args.trace, tracer, ops)
    print(f"chrome trace ({tracer.span_count()} spans, "
          f"{len(tracer.events)} events, {len(ops)} device operations) "
          f"written to {args.trace}")
    if args.json:
        print(json.dumps(profile_dict(tracer), indent=1))
        return
    rows = sorted(phase_summary(tracer).items(),
                  key=lambda kv: -kv[1]["self_s"])
    print(f"{'phase':<32} {'count':>7} {'total_ms':>10} "
          f"{'self_ms':>10} {'mean_ms':>9}")
    for name, d in rows:
        print(f"{name:<32} {d['count']:>7} {d['total_s'] * 1e3:>10.2f} "
              f"{d['self_s'] * 1e3:>10.2f} {d['mean_s'] * 1e3:>9.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    # every verb takes --device
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="where the verb runs: cuda (the default; raises "
                             "without a card) or cpu")

    p = sub.add_parser("infer_dataspec", parents=[device])
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--semantic", action="append", default=[],
                   help="override col=SEMANTIC")
    p.set_defaults(fn=cmd_infer_dataspec)

    p = sub.add_parser("show_dataspec", parents=[device])
    p.add_argument("--dataspec", required=True)
    p.set_defaults(fn=cmd_show_dataspec)

    p = sub.add_parser("train", parents=[device])
    p.add_argument("--dataset", required=True)
    p.add_argument("--valid")
    p.add_argument("--label", required=True)
    p.add_argument("--task", default="CLASSIFICATION",
                   help="CLASSIFICATION | REGRESSION | ranking | uplift | "
                        "anomaly (case-insensitive; uplift/anomaly pick "
                        "their dedicated learner automatically)")
    p.add_argument("--learner", default="GRADIENT_BOOSTED_TREES")
    p.add_argument("--template")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--hparam", action="append", default=[])
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                   help="write atomic tree-boundary training checkpoints here "
                        "(interruption-safe training, DESIGN.md §11)")
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=10, help="checkpoint cadence in trees")
    p.add_argument("--resume", metavar="CHECKPOINT_DIR",
                   help="resume an interrupted run from its checkpoint "
                        "directory (learner rebuilt from the manifest; "
                        "bit-identical to an uninterrupted run)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("show_model", parents=[device])
    p.add_argument("--model", required=True)
    p.add_argument("--verbose", type=int, default=0, nargs="?", const=4,
                   help="render tree #0 down to this depth")
    p.set_defaults(fn=cmd_show_model)

    p = sub.add_parser("import_sklearn", parents=[device])
    p.add_argument("--estimator", required=True,
                   help="pickled fitted sklearn estimator (.pkl); refused: "
                        "this package reads no pickle")
    p.add_argument("--label", default="label")
    p.add_argument("--feature-names", dest="feature_names",
                   help="comma-separated feature column names")
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_import_sklearn)

    p = sub.add_parser("evaluate", parents=[device])
    p.add_argument("--dataset", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--json", action="store_true",
                   help="dump the evaluation as JSON instead of text")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("analyze", parents=[device])
    p.add_argument("--model", required=True)
    p.add_argument("--dataset",
                   help="analysis dataset; omit for structural-only analysis")
    p.add_argument("--json", action="store_true",
                   help="dump the report as JSON instead of text")
    p.add_argument("--output", help="write the JSON report to this path")
    p.add_argument("--repetitions", type=int, default=3,
                   help="permutation-importance repetitions")
    p.add_argument("--sample", type=int, default=256,
                   help="background sample size for PDP curves")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("predict", parents=[device])
    p.add_argument("--dataset", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("serve", parents=[device])
    p.add_argument("--dataset", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--output", help="write predictions (csv:/json: path); "
                                    "shed/timed-out rows are NaN")
    p.add_argument("--deadline-ms", dest="deadline_ms", type=float, default=0,
                   help="per-request deadline in ms (0 = no deadline)")
    p.add_argument("--request-rows", dest="request_rows", type=int, default=32,
                   help="rows per simulated request")
    p.add_argument("--engines", help="comma-separated degradation chain, "
                                     "e.g. vectorized,naive (the port's "
                                     "engine names)")
    p.add_argument("--json", action="store_true",
                   help="dump the serving metrics as JSON instead of text")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("benchmark_inference", parents=[device])
    p.add_argument("--dataset", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--repetitions", type=int, default=3)
    p.set_defaults(fn=cmd_benchmark_inference)

    p = sub.add_parser("profile", parents=[device],
                       help="trace one train/infer pass (DESIGN.md §13)")
    p.add_argument("what", choices=("train", "infer"))
    p.add_argument("--dataset", required=True)
    p.add_argument("--trace", default="profile_trace.json",
                   help="Chrome trace-event output path "
                        "(chrome://tracing / ui.perfetto.dev)")
    p.add_argument("--json", action="store_true",
                   help="dump the phase breakdown as JSON instead of a table")
    # train mode
    p.add_argument("--label", help="label column (train mode)")
    p.add_argument("--task", default="CLASSIFICATION")
    p.add_argument("--learner", default="GRADIENT_BOOSTED_TREES")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--hparam", action="append", default=[])
    p.add_argument("--output", help="also save the trained model here")
    # infer mode
    p.add_argument("--model", help="model directory (infer mode)")
    p.add_argument("--repetitions", type=int, default=1,
                   help="predict passes to trace (infer mode)")
    p.set_defaults(fn=cmd_profile)

    args = ap.parse_args(argv)
    from repro_torch.core.engines import resolve_device
    resolve_device(args.device)      # no card: raise before the verb runs
    args.fn(args)


if __name__ == "__main__":
    main()
