"""Build and bind the port's CUDA kernels (no JAX counterpart: the JAX
package's Pallas kernels are compiled by JAX itself).

At first use on a CUDA machine every source in ../csrc/*.cu is compiled by
its own `nvcc` process, all started together, into a shared library with a
plain C interface under ../_build/<hash of sources and flags>/, and loaded
with ctypes. A change to any source or flag changes the hash and so
rebuilds. Importing this module builds nothing.

Flags: sm_90a (Hopper), and `--fmad=false` so nvcc contracts no `a*b + c`
on its own: the kernels call `__fmaf_rn` exactly where the plain versions
round once (core/fp.py), so integer results (pixels, levels, keys) agree bit
for bit. Division and sqrt stay IEEE (no fast math).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("dda", "block_meta", "proj_apply", "proj_sample", "slot_resolve",
           "block_rmw", "add", "hash", "empty")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD, _digest())


def build_all() -> dict:
    """Compile every missing library in parallel; returns {name: .so path}.
    Raises with nvcc's output if any compile fails. nvcc's resource report
    (-Xptxas -v) is kept beside each library as <name>.log."""
    out = build_dir()
    os.makedirs(out, exist_ok=True)
    paths = {n: os.path.join(out, f"lib{n}.so") for n in SOURCES}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    errors = []
    for n, (p, tmp, path) in procs.items():
        log, _ = p.communicate()
        with open(os.path.join(out, f"{n}.log"), "w") as f:
            f.write(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


@functools.cache
def bind(name: str, fn: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry `fn` of library `name`, built on first use, with its
    argtypes set and an int (cudaError_t) result. Bound once per entry."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build_all()[name])
        f = getattr(_libs[name], fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f
