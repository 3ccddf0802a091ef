"""The native (C++) caption tokenizer, loaded with ctypes
(``imagecaptioner_tpu/native/__init__.py``).

``tokenize_native`` gives the tokens of ``data/tokenizer.tokenize_py``,
faster, for building the vocabulary over large caption CSVs.  The library
is the port's own copy of the source, ``native/tokenizer.cpp`` here, built
at first use by ``g++ -O2 -shared -fPIC`` into
``imagecaptioner_tpu_torch/_build/`` (git-ignored).  Its name carries a
hash of the source and the flags, as ``ops/_build.py`` names the CUDA
libraries, so an edited source rebuilds and a stale library is never
loaded.  If ``g++`` or the build fails, ``native_available()`` is False and
``data/tokenizer.tokenize`` runs the Python tokenizer, as the JAX package
does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

SRC = Path(__file__).resolve().with_name("tokenizer.cpp")
BUILD = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD / f"libtokenizer-{digest[:12]}.so"


def build() -> Path:
    """Compile the tokenizer unless its library exists; returns its path.
    Raises if ``g++`` fails."""
    lib = library_path()
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, subprocess.SubprocessError):
                return None
            lib.ic_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int]
            lib.ic_tokenize.restype = ctypes.c_int
            _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def tokenize_native(text: str) -> List[str]:
    """The C++ tokenizer; raises RuntimeError if the library is unavailable
    (``data.tokenizer.tokenize`` falls back to Python)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native tokenizer unavailable")
    data = str(text).encode("utf-8", errors="replace")
    cap = max(256, 2 * len(data) + 16)
    buf = ctypes.create_string_buffer(cap)
    n = lib.ic_tokenize(data, buf, cap)
    if n < 0:  # buffer too small (pathological punctuation blowup)
        cap *= 4
        buf = ctypes.create_string_buffer(cap)
        n = lib.ic_tokenize(data, buf, cap)
        if n < 0:
            raise RuntimeError("native tokenizer buffer overflow")
    if n == 0:
        return []
    return buf.value.decode("utf-8", errors="replace").split("\n")
