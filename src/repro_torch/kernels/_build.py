"""Build the port's CUDA sources with nvcc into libraries for ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface (``extern "C"``) and is
compiled on first use into a shared library under ``build/repro_torch/``
at the root of the checkout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so <src>

The library's name carries a hash of the source, the headers beside it
(``csrc/*.cuh``, which a source may include) and the flags, so an edited
source or header is rebuilt and processes that share the checkout reuse one
build.
Each kernel's wrapper loads its library with ``ctypes.CDLL`` once per
process. ``SOURCES`` lists every kernel source of the port, and
``build_all`` builds them together, one nvcc process each. Nothing here
runs at import time. A failed build raises ``RuntimeError``
with nvcc's output: a kernel that does not build is a fault of the
program, never an engine failure to degrade around.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

from repro_torch.obs import clock

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_KERNELS = Path(__file__).resolve().parent
SOURCES = tuple(_KERNELS / p for p in (
    "forest_infer/csrc/forest_infer.cu",     # B2, tiled traversal
    "forest_infer/csrc/forest_single.cu",    # B4, single-tree traversal
    "histogram/csrc/fused_split.cu",         # B1, split search
    "histogram/csrc/histogram.cu",           # B3, histograms
))


@dataclass(frozen=True)
class BuildResult:
    library: Path
    seconds: float      # 0.0 when an earlier build was reused
    log: str            # nvcc's output (ptxas register / spill report)


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc was not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin;"
        " the CUDA kernels of repro_torch are built from source on first use."
        " Install the CUDA toolkit, or pass device='cpu' to run the plain "
        "PyTorch versions.")


def build(source: Path) -> BuildResult:
    """Compile ``source`` into a shared library (reusing an identical
    earlier build). Raises RuntimeError when nvcc fails."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    if lib.is_file():
        return BuildResult(lib, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = clock.perf()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, check=False)
    seconds = clock.perf() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
            f"{log}")
    os.replace(tmp, lib)   # atomic: a concurrent builder sees all or nothing
    return BuildResult(lib, seconds, log)


def build_all() -> dict[Path, BuildResult]:
    """Build every source of ``SOURCES``, one nvcc process each, all started
    together. Raises the first build's RuntimeError after all have ended."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))
