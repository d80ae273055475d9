"""ctypes binding of the native trace parser (``trace_parser.cc``).

The source compiles with ``g++ -O2 -shared -fPIC`` at first use into
``build/native/libtraceparser-<hash>.so`` at the repository root, named by
a hash of the source and the flags, as ``ops/build.py`` names the kernels:
an edited source rebuilds, an unchanged one is reused. A failed build or
load raises; nothing falls back to Python on a build failure. A file the
parser declines (a structural surprise) gives None, and the caller parses
it in Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "trace_parser.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtraceparser-{digest[:16]}.so"


def build() -> Path:
    """Compile ``trace_parser.cc`` unless its library already exists;
    return the library's path. Raises with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the parser if needed and load it."""
    lib = ctypes.CDLL(str(build()))
    lib.parse_trace_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.parse_trace_file.restype = ctypes.c_long
    lib.free_trace.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.free_trace.restype = None
    return lib


def parse_trace_file(path: str | Path) -> Optional[np.ndarray]:
    """Parse a trace JSON file natively to ``[N, 4]`` float32 (x, y, z, t),
    or None where the parser declines the file (return value < 0)."""
    lib = load_library()
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.parse_trace_file(str(path).encode(), ctypes.byref(out))
    if n < 0:
        return None
    try:
        if n == 0:
            return np.zeros((0, 4), dtype=np.float32)
        return np.ctypeslib.as_array(out, shape=(n, 4)).copy()
    finally:
        lib.free_trace(out)
