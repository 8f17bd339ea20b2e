"""Build the CUDA sources at first use and load them through ``ctypes``.

Each library is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named by the
sha256 of its sources and flags, under ``build/repro_torch/`` at the root
of the checkout.  A library already on disk under the same name is loaded
as it is.  Nothing is compiled when a module is imported: only the first
launch of a kernel on a CUDA tensor calls ``load_library``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildReport:
    """One library: where it is, how long ``nvcc`` took (0 when it was
    found on disk) and what ``-Xptxas -v`` reported for each kernel."""

    path: Path
    seconds: float
    log: str


#: nvcc runs in this process.
build_count = 0
#: library name -> its BuildReport, for libraries loaded in this process.
reports: dict[str, BuildReport] = {}
_libraries: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # libraries may be built from several threads


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels are built on a machine with "
                           "the CUDA toolkit")
    return path


def load_library(name: str, sources: list[Path]) -> ctypes.CDLL:
    """The shared library built from ``sources``, compiled if not on disk."""
    global build_count
    with _lock:
        lib = _libraries.get(name)
    if lib is not None:
        return lib
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    built = not so.exists()
    if not built:
        report = BuildReport(so, 0.0, log_path.read_text()
                             if log_path.exists() else "")
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        log = proc.stdout + proc.stderr
        log_path.write_text(log)
        os.replace(tmp, so)
        report = BuildReport(so, seconds, log)
    lib = ctypes.CDLL(str(so))
    with _lock:
        build_count += built
        reports[name] = report
        _libraries[name] = lib
    return lib
