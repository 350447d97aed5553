"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers it
includes) into an object, all sources at once in parallel processes, and
links them into one shared library with a plain C interface, loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o build/<source>-<hash>.o csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/libdllama_kernels-<hash>.so build/*-<hash>.o

The library lands in ``dllama_tpu_torch/build/`` at first use, named by a
hash of the sources, headers and flags, so an edited source rebuilds and an
unchanged one is reused.  A build holds a file lock in that directory, so
processes that start together (a supervised pod's replicas) compile once:
the others wait and load the library the first one built.  Importing the package never needs ``nvcc``: the
build runs at the first CUDA call (or an explicit :func:`load`).  Without
``nvcc`` the build raises — there is no other path to hand back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
CSRC = os.path.join(HERE, "csrc")
SOURCES = ("q40_matmul.cu", "q8_matmul.cu", "paged_attention.cu", "tp_allreduce.cu",
           "paged_prefill_attention.cu", "paged_prefill_f32.cu", "paged_prefill_f16.cu",
           "paged_prefill_int8.cu")
# headers the sources include: hashed with them, so an edit rebuilds
HEADERS = ("mma_common.cuh", "gemv_common.cuh", "sm90_common.cuh", "wgmma_matmul.cuh",
           "paged_prefill_attention.cuh")
BUILD_DIR = os.path.join(PKG, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: ctypes.CDLL | None = None
_load_lock = threading.Lock()
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
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdllama_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands as parallel processes; returns their joined output,
    each command's followed by a line of its seconds; raises naming every
    one that failed, with its output."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [""] * len(procs)

    def wait(i):
        out = procs[i].communicate()[0]
        outs[i] = out + f"{os.path.basename(cmds[i][-1])}: {time.perf_counter() - t0:.1f} s\n"

    waiters = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = [f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}"
              for cmd, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build() -> str:
    """Compile the sources unless the library for their hash exists;
    returns its path.  Holds ``build/.lock`` while it checks and builds."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.exists(path):  # another process may have built it
            _compile(nvcc, path)
    return path


def _compile(nvcc: str, path: str) -> None:
    global build_log
    tag = f"{os.path.basename(path)[:-3]}.{os.getpid()}"
    srcs = [os.path.join(CSRC, name) for name in SOURCES]
    objs = [os.path.join(BUILD_DIR, f"{name[:-3]}-{tag}.o") for name in SOURCES]
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, src]
                        for src, o in zip(srcs, objs)])
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_log = log
    os.replace(tmp, path)  # atomic: a reader never loads a partial file


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare signatures."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:  # several scheduler threads may launch first at once
        if _lib is None:
            from . import attention, q8, q40
            _lib = attention.bind(q8.bind(q40.bind(ctypes.CDLL(build()))))
    return _lib
