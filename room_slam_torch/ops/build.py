"""Build the port's CUDA sources (``room_slam_torch/csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go to ``build/kernels/`` at the repository
root, named by a hash of the source and the flags: an edited source
rebuilds, an unchanged one is reused. nvcc's output (with the ``-Xptxas -v``
lines: each kernel's registers, stack and spills) is kept beside each
library as ``lib<name>-<hash>.log``; ``ptxas_usage`` reads it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float
    log: str     # nvcc's output with the -Xptxas -v lines
    reused: bool = False   # the library was already built


def kernel_sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "room_slam_torch's kernels")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its library already exists. Raises
    with nvcc's output if the build fails."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return BuildResult(name, out, 0.0,
                           log.read_text() if log.exists() else "", True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, out)
    return BuildResult(name, out, time.perf_counter() - t0, proc.stdout)


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Each kernel's resources from nvcc's ``-Xptxas -v`` output, by mangled
    name: ``registers``, ``stack`` (bytes of stack frame), ``spill_stores``
    and ``spill_loads`` (bytes)."""
    usage: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([A-Za-z0-9_]+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


def build_all() -> List[BuildResult]:
    """Build every kernel source in ``csrc/``, one ``nvcc`` per source, all
    started together."""
    names = kernel_sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build(name).path))
