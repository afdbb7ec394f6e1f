"""Builds the port's native sources and loads them with ctypes.

Each ``csrc/<name>.cu`` (``two_loop``: the kernels; ``conditional``: CUDA
graph IF nodes for the captured solver iteration) exposes a plain C
interface and is compiled on first use into ``build/lib<name>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

Host C++ without CUDA (``runtime/runtime.cpp``, the native host runtime)
goes through :func:`build_host` instead, with

    g++ -std=c++20 -O3 -fPIC -shared -pthread

(``$CXX`` in place of ``g++`` where it is set), so it builds where there is
no nvcc. A library is rebuilt when the hash of its source, compiler and
flags changes; the compiler's report (for nvcc: registers, shared memory,
spills) is kept beside it as ``build/lib<name>.log``; a failed build raises
with the compiler's stderr. No PyTorch headers are compiled, so a build
takes seconds. The wrappers that call into a library declare its
``argtypes``.
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

from lbfgs_ffnn_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++20", "-O3", "-fPIC", "-shared", "-pthread")


class Built(NamedTuple):
    path: Path
    seconds: float   # compile time; 0.0 when the cached library was current
    compiled: bool
    log: str         # the compiler's report (nvcc: ptxas's)


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


def gxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless the cached library is current."""
    return _compile(CSRC / f"{name}.cu", name, nvcc(), NVCC_FLAGS)


def build_host(src: Path) -> Built:
    """Compile the host C++ file ``src`` with :func:`gxx` into
    ``build/lib<stem>.so`` unless the cached library is current."""
    return _compile(src, src.stem, gxx(), GXX_FLAGS)


def _compile(src: Path, name: str, compiler: str, flags) -> Built:
    """``compiler flags -o build/lib<name>.so src``, keyed by the hash of the
    source, the compiler and the flags; raises with the compiler's stderr
    when it fails. The span ``native.build`` (``detail`` the library's
    name) holds the hash check and the compile."""
    with profiling.span("native.build", name):
        return _compile_now(src, name, compiler, flags)


def _compile_now(src: Path, name: str, compiler: str, flags) -> Built:
    key = hashlib.sha256(src.read_bytes() + " ".join((compiler, *flags)).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f"lib{name}.sha256"
    log = BUILD_DIR / f"lib{name}.log"
    if so.is_file() and stamp.is_file() and stamp.read_text() == key:
        return Built(so, 0.0, False, log.read_text() if log.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"{compiler} could not run on {src}: {exc}") from exc
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed ({proc.returncode}) on {src}:\n"
                           f"{proc.stderr}")
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
    """The loaded library for ``csrc/<name>.cu``, built first if needed (the
    span ``native.load``, its build within it)."""
    if name not in _LOADED:
        with profiling.span("native.load", name):
            _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return _LOADED[name]
