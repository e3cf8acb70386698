"""Build and load the CUDA sweep kernels (``csrc/sweep.cu``).

``nvcc`` compiles the source at first use into a shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), placed
in ``softbodysim_torch/_build/kernels/`` under a name keyed by a hash of
the source and the flags; ctypes loads it.  A failed build raises: there is
no fallback to the plain PyTorch versions on a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_KDIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_KDIR, "csrc", "sweep.cu")
BUILD_DIR = os.path.join(os.path.dirname(_KDIR), "_build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: round as the plain PyTorch versions do
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",          # registers / shared memory / spills in the log
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libsbs_sweep-{key[:16]}.so")


def build() -> str:
    """Compile the library unless this source already has one; its path.
    The compiler's output (ptxas resource report) goes to ``<lib>.log``."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler output of the current build ('' if not built here)."""
    try:
        with open(library_path() + ".log") as f:
            return f.read()
    except OSError:
        return ""


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set."""
    lib = ctypes.CDLL(build())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sbs_w_fill.restype = i
    lib.sbs_w_fill.argtypes = [p, p, p, p, i, i, p]
    lib.sbs_edge_sweep.restype = i
    lib.sbs_edge_sweep.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                   i, f, i, p]
    lib.sbs_tet_sweep.restype = i
    lib.sbs_tet_sweep.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                  i, f, i, i, p]
    return lib
