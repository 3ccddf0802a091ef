"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

into ``imagecaptioner_tpu_torch/_build/`` (listed in ``.gitignore``).  The
library name carries a hash of the source and of the shared ``csrc/*.cuh``
headers, so an edited source rebuilds and a stale library is never loaded.  Importing this module needs no nvcc:
nothing is compiled until a kernel is first launched or ``build_all`` runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("attention_core", "greedy_decode", "decoder_scan",
           "decoder_scan_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):  # shared device helpers
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    ``(process, tmp_path, lib_path)`` or None."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, job) -> None:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    (BUILD / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib)


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source at once (one nvcc each, started together)
    and return the wall seconds taken."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = BUILD / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        lib.ic_error_string.restype = ctypes.c_char_p
        lib.ic_error_string.argtypes = [ctypes.c_int]
        msg = lib.ic_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
