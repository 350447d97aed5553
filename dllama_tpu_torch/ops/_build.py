"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` into a shared library with a plain C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/libdllama_kernels-<hash>.so csrc/*.cu

The library lands in ``dllama_tpu_torch/build/`` at first use, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  Importing the package never needs ``nvcc``: the
build runs at the first CUDA call (or an explicit :func:`load`).  Without
``nvcc`` the build raises — there is no other path to hand back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
SOURCES = [os.path.join(HERE, "csrc", "q40_matmul.cu")]
BUILD_DIR = os.path.join(PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: ctypes.CDLL | None = None
#: nvcc's output from the build this process ran (``-Xptxas -v`` register
#: and shared-memory report); empty when the library was already built
build_log = ""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the default
    toolkit location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc not found (looked in "
        "$CUDA_HOME/bin, PATH and /usr/local/cuda/bin).  The CUDA path has "
        "no substitute for its kernels; install the CUDA toolkit, or run on "
        "the CPU with --device cpu / device='cpu'")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdllama_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for their hash exists;
    returns its path."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *SOURCES]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}\n{r.stderr}")
    build_log = r.stdout + r.stderr
    os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    return path


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare signatures."""
    global _lib
    if _lib is None:
        from . import q40
        _lib = q40.bind(ctypes.CDLL(build()))
    return _lib
