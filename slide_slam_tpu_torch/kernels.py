"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with ctypes. A library is built at
first use into `slide_slam_tpu_torch/_build/` (listed in .gitignore), under
a name that carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is built when the
package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    if verbose and proc.stderr:
        print(f"[nvcc {name}.cu]\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


def build_all(names, verbose: bool = False) -> dict:
    """Build several sources at once: one nvcc process each, all started
    together. Returns {name: library path}."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {n: pool.submit(build, n, verbose) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
