"""The port's command line (``repro_torch.cli``) against the JAX package's
(``repro.cli``).

The reference's CLI scenarios (``tests/test_analysis.py::test_cli_analyze_
and_evaluate_json``, ``tests/test_obs.py::test_cli_profile_train_chrome_
trace``, ``tests/test_tasks.py::test_cli_train_task_round_trip``,
``tests/test_serving_server.py::test_cli_serve_smoke`` and
``tests/test_train_checkpoint.py::test_cli_train_checkpoint_and_resume``)
run through ``repro_torch.cli.main([..., "--device=cpu"])``. Where both
CLIs run the same verbs on the same CSV (each trains its own model, and
the two packages' CPU forests are bit-identical), their outputs are equal:
the ``predict`` CSVs byte for byte, the evaluation and analysis JSON, the
dataspec files and reports, ``show_model`` and ``serve``'s scores.
``import_sklearn`` refuses with directions (the port reads no pickle), and
a verb without ``--device`` raises ``YdfError`` on a host without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.cli import main as ref_main
from repro.data.tabular import (
    adult_like,
    grouped_relevance,
    planted_anomaly,
    randomized_treatment,
    train_test_split,
)
from repro_torch.cli import main
from repro_torch.core import Model, Task, YdfError
from repro_torch.data.io import read_dataset, write_dataset
from repro_torch.obs.export import validate_chrome_trace

ROOT = Path(__file__).resolve().parent.parent
CPU = "--device=cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU engines' small torch ops run on one thread: test workers
    share the host, and a thread pool per worker oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(capsys, fn, *argv) -> str:
    capsys.readouterr()
    fn(list(argv))
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """adult_like written as train/test CSVs (the reference CLI's input)."""
    d = tmp_path_factory.mktemp("csv")
    train, test = train_test_split(adult_like(900, seed=2), 0.3, 1)
    out = {}
    for name, data in (("train", train), ("test", test)):
        out[name] = f"csv:{d / name}.csv"
        write_dataset(data, out[name])
    return out


@pytest.fixture(scope="module")
def models(csvs, tmp_path_factory):
    """The same GBT trained by each CLI: (port dir, reference dir)."""
    d = tmp_path_factory.mktemp("models")
    argv = ["train", "--dataset", csvs["train"], "--label", "income",
            "--hparam", "num_trees=6", "--hparam", "max_depth=4"]
    main(argv + ["--output", str(d / "port"), CPU])
    ref_main(argv + ["--output", str(d / "ref")])
    return str(d / "port"), str(d / "ref")


# ------------------------------------------------------- both CLIs, one CSV

def test_predict_csvs_are_byte_identical(models, csvs, tmp_path, capsys):
    port, ref = models
    out, ref_out = tmp_path / "p.csv", tmp_path / "r.csv"
    text = run(capsys, main, "predict", "--dataset", csvs["test"],
               "--model", port, "--output", f"csv:{out}", CPU)
    ref_text = run(capsys, ref_main, "predict", "--dataset", csvs["test"],
                   "--model", ref, "--output", f"csv:{ref_out}")
    assert text == ref_text.replace(str(ref_out), str(out))
    assert out.read_bytes() == ref_out.read_bytes()
    model = Model.load(port)
    assert out.read_text().splitlines()[0] == ",".join(
        f"p_{c}" for c in model.classes)


def test_evaluate_analyze_and_show_model_equal_reference(models, csvs,
                                                         tmp_path, capsys):
    port, ref = models
    for verb in (["evaluate", "--json"], ["evaluate"]):
        got = run(capsys, main, *verb, "--model", port, "--dataset",
                  csvs["test"], CPU)
        assert got == run(capsys, ref_main, *verb, "--model", ref,
                          "--dataset", csvs["test"])
    args = ["--repetitions", "1", "--sample", "32"]
    got = run(capsys, main, "analyze", "--model", port, "--dataset",
              csvs["test"], "--json", *args, CPU)
    want = run(capsys, ref_main, "analyze", "--model", ref, "--dataset",
               csvs["test"], "--json", *args)
    assert json.loads(got) == json.loads(want)
    assert run(capsys, main, "analyze", "--model", port, CPU) == \
        run(capsys, ref_main, "analyze", "--model", ref)
    for verbose in ([], ["--verbose"], ["--verbose", "2"]):
        assert run(capsys, main, "show_model", "--model", port, *verbose,
                   CPU) == run(capsys, ref_main, "show_model", "--model",
                               ref, *verbose)


def test_dataspec_verbs_equal_reference(csvs, tmp_path, capsys):
    spec, ref_spec = tmp_path / "s.json", tmp_path / "r.json"
    argv = ["infer_dataspec", "--dataset", csvs["train"], "--semantic",
            "education=CATEGORICAL"]
    run(capsys, main, *argv, "--output", str(spec), CPU)
    run(capsys, ref_main, *argv, "--output", str(ref_spec))
    assert json.loads(spec.read_text()) == json.loads(ref_spec.read_text())
    assert run(capsys, main, "show_dataspec", "--dataspec", str(spec),
               CPU) == run(capsys, ref_main, "show_dataspec", "--dataspec",
                           str(ref_spec))


# ------------------------------------------------ the reference's scenarios

def test_cli_analyze_and_evaluate_json(models, csvs, tmp_path, capsys):
    port, _ = models
    out_json = str(tmp_path / "report.json")
    main(["analyze", "--model", port, "--dataset", csvs["test"],
          "--repetitions", "1", "--sample", "32", "--output", out_json, CPU])
    with open(out_json) as f:
        payload = json.load(f)
    assert payload["label"] == "income"
    assert any(t["kind"] == "MEAN_DECREASE_ACCURACY"
               for t in payload["variable_importances"])
    assert "NUM_NODES" in run(capsys, main, "analyze", "--model", port, CPU)
    ev = json.loads(run(capsys, main, "evaluate", "--model", port,
                        "--dataset", csvs["test"], "--json", CPU))
    assert ev["metrics"]["accuracy"] > 0.5


def test_cli_profile_train_and_infer_chrome_traces(csvs, tmp_path, capsys):
    out = tmp_path / "trace.json"
    mdir = tmp_path / "m"
    text = run(capsys, main, "profile", "train", f"--dataset={csvs['train']}",
               "--label=income", f"--trace={out}", "--hparam", "num_trees=3",
               "--output", str(mdir), CPU)
    doc = json.loads(out.read_text())
    validate_chrome_trace(doc)
    grower = {e["name"] for e in doc["traceEvents"]
              if e["ph"] == "X" and e["name"].startswith("grower/")}
    assert len(grower) >= 5, grower
    assert "phase" in text and "chrome trace" in text
    out2 = tmp_path / "infer.json"
    text = run(capsys, main, "profile", "infer", f"--dataset={csvs['test']}",
               f"--model={mdir}", f"--trace={out2}", "--repetitions", "2",
               "--json", CPU)
    doc = json.loads(out2.read_text())
    validate_chrome_trace(doc)
    assert [e for e in doc["traceEvents"]
            if e["ph"] == "X" and e["name"] == "engines/dispatch"]
    prof = json.loads(text[text.index("{"):])
    assert prof["phases"]["engines/dispatch"]["count"] == 2


def test_cli_train_task_round_trip(tmp_path, capsys):
    cases = [
        ("ranking", grouped_relevance(n_groups=25, seed=7), "rel",
         Task.RANKING, "GradientBoostedTreesModel"),
        ("uplift", randomized_treatment(n=300, seed=11), "outcome",
         Task.UPLIFT, "UpliftModel"),
        ("anomaly", planted_anomaly(n_inlier=120, n_anomaly=8, seed=13),
         "anomaly", Task.ANOMALY, "IsolationForestModel"),
    ]
    for task_arg, data, label, task, model_cls in cases:
        csv_path = f"csv:{tmp_path}/{task_arg}.csv"
        write_dataset(data, csv_path)
        out = str(tmp_path / f"model_{task_arg}")
        main(["train", "--dataset", csv_path, "--label", label,
              "--task", task_arg, "--seed", "7",
              "--hparam", "num_trees=4", "--output", out, CPU])
        model = Model.load(out)
        assert model.task == task
        assert type(model).__name__ == model_cls
        pred, ref_pred = tmp_path / f"p_{task_arg}.csv", \
            tmp_path / f"r_{task_arg}.csv"
        main(["predict", "--dataset", csv_path, "--model", out,
              "--output", f"csv:{pred}", CPU])
        ref_out = str(tmp_path / f"ref_{task_arg}")
        ref_main(["train", "--dataset", csv_path, "--label", label,
                  "--task", task_arg, "--seed", "7",
                  "--hparam", "num_trees=4", "--output", ref_out])
        ref_main(["predict", "--dataset", csv_path, "--model", ref_out,
                  "--output", f"csv:{ref_pred}"])
        assert pred.read_bytes() == ref_pred.read_bytes(), task_arg
    capsys.readouterr()


def test_cli_serve_smoke(models, csvs, tmp_path, capsys):
    port, ref = models
    feats = {k: v[:40] for k, v in read_dataset(csvs["test"]).items()
             if k != "income"}
    csv = "csv:" + str(tmp_path / "req.csv")
    write_dataset(feats, csv)
    out_csv = "csv:" + str(tmp_path / "preds.csv")
    text = run(capsys, main, "serve", "--dataset", csv, "--model", port,
               "--request-rows", "8", "--deadline-ms", "5000",
               "--output", out_csv, CPU)
    assert "engine chain" in text and "shed=0" in text and "p50" in text
    assert "engine chain ref[closed]" in text
    preds = read_dataset(out_csv)
    model = Model.load(port)
    want = model.predict(feats, device="cpu")
    got = np.stack([preds[f"p_{c}"].astype(np.float32)
                    for c in model.classes], 1)
    np.testing.assert_allclose(got, want, atol=1e-6)
    ref_csv = "csv:" + str(tmp_path / "ref_preds.csv")
    ref_main(["serve", "--dataset", csv, "--model", ref, "--request-rows",
              "8", "--deadline-ms", "5000", "--output", ref_csv])
    capsys.readouterr()
    ref_preds = read_dataset(ref_csv)
    for c in model.classes:
        np.testing.assert_array_equal(preds[f"p_{c}"].astype(np.float32),
                                      ref_preds[f"p_{c}"].astype(np.float32))
    text = run(capsys, main, "serve", "--dataset", csv, "--model", port,
               "--engines", "vectorized,naive", "--json", CPU)
    assert "engine chain vectorized[closed] -> naive[closed]" in text


def test_cli_train_checkpoint_and_resume(tmp_path, capsys):
    ds = adult_like(300, seed=5)
    csv_path = f"csv:{tmp_path}/train.csv"
    write_dataset(ds, csv_path)
    ckdir = str(tmp_path / "ck")
    out1 = str(tmp_path / "m1")
    main(["train", "--dataset", csv_path, "--label", "income",
          "--learner", "GRADIENT_BOOSTED_TREES", "--seed", "11",
          "--hparam", "num_trees=4", "--hparam", "max_depth=3",
          "--output", out1, "--checkpoint-dir", ckdir,
          "--checkpoint-every", "2", CPU])
    assert os.path.isdir(ckdir) and os.listdir(ckdir)
    out2 = str(tmp_path / "m2")
    text = run(capsys, main, "train", "--dataset", csv_path, "--label",
               "income", "--resume", ckdir, "--output", out2, CPU)
    assert "resumed from" in text
    m1, m2 = Model.load(out1), Model.load(out2)
    for k in ("feature", "threshold", "split_bin", "cat_mask", "left_child",
              "leaf_value", "n_nodes", "split_gain"):
        np.testing.assert_array_equal(getattr(m1.forest, k),
                                      getattr(m2.forest, k), err_msg=k)


def test_cli_benchmark_inference_lists_the_cpu_engines(models, csvs,
                                                       capsys):
    port, _ = models
    text = run(capsys, main, "benchmark_inference", "--dataset",
               csvs["test"], "--model", port, "--repetitions", "1", CPU)
    assert text.startswith("benchmark_inference on cpu")
    for engine in ("ref", "bucketed", "leaf_path", "vectorized", "naive"):
        assert f"  {engine} " in text


# ---------------------------------------------------- refusals, the device

def test_import_sklearn_refuses_with_directions(tmp_path):
    est = tmp_path / "est.pkl"
    est.write_bytes(b"not read")
    with pytest.raises(YdfError, match="reads no pickle") as err:
        main(["import_sklearn", "--estimator", str(est), "--output",
              str(tmp_path / "m"), CPU])
    assert "repro_torch.interop.from_sklearn" in str(err.value)
    assert not (tmp_path / "m").exists()


def test_verbs_need_a_card_unless_given_the_cpu(models, csvs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    port, _ = models
    for argv in (["predict", "--dataset", csvs["test"], "--model", port,
                  "--output", f"csv:{tmp_path}/p.csv"],
                 ["evaluate", "--dataset", csvs["test"], "--model", port],
                 ["show_model", "--model", port],
                 ["train", "--dataset", csvs["train"], "--label", "income",
                  "--output", str(tmp_path / "m")],
                 ["infer_dataspec", "--dataset", csvs["train"], "--output",
                  str(tmp_path / "s.json")]):
        with pytest.raises(YdfError, match="device='cpu'"):
            main(argv)
        with pytest.raises(YdfError, match="device='cpu'"):
            main(argv + ["--device=cuda"])
    assert not (tmp_path / "m").exists()
    assert not (tmp_path / "p.csv").exists()


def test_python_dash_m_runs_the_port_cli(models, csvs, tmp_path):
    port, _ = models
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.cli", "predict", "--dataset",
         csvs["test"], "--model", port, "--output",
         f"csv:{tmp_path}/p.csv", CPU],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "predictions written" in proc.stdout
    assert "jax" not in proc.stderr.lower()
