"""What the metric readers in ``bench/metrics/`` share: spans by name,
device seconds of kernels by name, and the rooflines' arithmetic."""
from __future__ import annotations

from bench import workcount

# the port's kernels, named as the profiler names them: in the anonymous
# namespace of their .cu file, a template's name with its arguments and
# return type ("void (anonymous namespace)::split_kernel<4>(...)")
B1_KERNELS = ("split_kernel", "prep_kernel", "reduce_kernel")
B2_KERNELS = ("forest_infer_tiled_kernel",)
PORT_NAMESPACE = "(anonymous namespace)::"
GBT_STATS = 4               # gradient, gain hessian, hessian, count


def spans(rec: dict, name: str) -> list[float]:
    """Durations (s) of the program's or the harness's spans ``name``."""
    tracer = rec.get("spans")
    return [] if tracer is None else [s.duration for s in tracer.find(name)]


def is_kernel(profiled: str, names: tuple) -> bool:
    """Whether the profiler's kernel name ``profiled`` is one of the port's
    kernels ``names``: the whole name, not a part of another (PyTorch's own
    ``at::native::reduce_kernel<...>`` is not B1's ``reduce_kernel``)."""
    name = profiled.removeprefix("void ")
    if not name.startswith(PORT_NAMESPACE):
        return False
    name = name[len(PORT_NAMESPACE):]
    return any(name.startswith(n) and name[len(n):len(n) + 1] in ("(", "<")
               for n in names)


def kernel_s(rec: dict, names: tuple) -> float:
    """Device seconds of the port's kernels ``names``."""
    return sum(v[1] for k, v in rec.get("kernels", {}).items()
               if is_kernel(k, names))


def share(part: float, whole: float):
    """``part`` over ``whole`` in %, or None with nothing to divide by."""
    return None if not whole or not part else 100.0 * part / whole


def idle(rec: dict):
    if not rec.get("busy_s") or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def training_work(rec: dict) -> dict:
    """B1's and the whole window's (bytes, ops) over its trainings."""
    hp = rec["config"]["hparams"]
    out = {"b1": [0, 0], "whole": [0, 0]}
    for t in rec.get("trainings", []):
        w = workcount.training(t["rows_trained"], rec["features"], GBT_STATS,
                               t["depths"], hp["max_depth"])
        for k in out:
            out[k][0] += w[k][0]
            out[k][1] += w[k][1]
    return out


def least_calls(rec: dict, count) -> float:
    """Least seconds of the window's calls in ``rec["work"]`` by ``count``
    (``workcount.b2_call`` or ``workcount.scoring_call``). Where requests
    share calls (``dispatches``: the server batches them), the rows and
    visits of all requests and the forest once a call are summed, and the
    larger of their byte and operation bounds taken: never more than the
    sum of each call's least time."""
    w = rec.get("work")
    if not w:
        return 0.0
    args = (w["features"], w["nodes"], w["trees"], w["out_dim"])
    if "dispatches" not in w:
        return sum(workcount.least_s(*count(r, v, *args))
                   for r, v in zip(w["rows"], w["visits"]))
    nbytes, ops = count(sum(w["rows"]), sum(w["visits"]), *args)
    forest = count(0, 0, *args)[0]
    return workcount.least_s(nbytes + (w["dispatches"] - 1) * forest, ops)
