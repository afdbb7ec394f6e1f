"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` (``two_loop``: the kernels; ``conditional``: CUDA
graph IF nodes for the captured solver iteration) exposes a plain C
interface and is compiled on first use into ``build/lib<name>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

The library is rebuilt when the hash of its source and flags changes; the
compiler's report (registers, shared memory, spills) is kept beside it as
``build/lib<name>.log``. No PyTorch headers are compiled, so a build takes
seconds. The wrappers that call into a library declare its ``argtypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    path: Path
    seconds: float   # compile time; 0.0 when the cached library was current
    compiled: bool
    log: str         # nvcc / ptxas report


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, else the toolkit's standard
    location, else the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: install the CUDA toolkit or set CUDA_HOME")
    return found


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless the cached library is current."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f"lib{name}.sha256"
    log = BUILD_DIR / f"lib{name}.log"
    if so.is_file() and stamp.is_file() and stamp.read_text() == key:
        return Built(so, 0.0, False, log.read_text() if log.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees old or new, never half
    log.write_text(proc.stderr)
    stamp.write_text(key)
    return Built(so, seconds, True, proc.stderr)


def build_all(names) -> dict[str, Built]:
    """:func:`build` for each name, the nvcc runs started together."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


_LOADED: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return _LOADED[name]
