"""Build and load the CUDA kernels (every ``csrc/*.cu``, which may include
the ``csrc/*.cuh`` headers) as one library.

``nvcc`` compiles each source at first use into an object file -- one
compiler per source, all started together (a timed-out compiler is
killed) -- and links them into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), placed in ``softbodysim_torch/_build/kernels/`` under a name keyed
by a hash of all the sources, the headers and the flags; ctypes loads it.
A failed build raises: there is no fallback to the plain PyTorch versions
on a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_KDIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_KDIR, "csrc")
SOURCES = tuple(sorted(glob.glob(os.path.join(CSRC, "*.cu"))))
HEADERS = tuple(sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
BUILD_DIR = os.path.join(os.path.dirname(_KDIR), "_build", "kernels")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + (
    "-std=c++17", "-O3",
    # no FMA contraction: round as the plain PyTorch versions do
    "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",          # registers / shared memory / spills in the log
)
TIMEOUT = 900
# one build at a time in a process (threads share the objects' file names)
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsbs_kernels-{h.hexdigest()[:16]}.so")


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=TIMEOUT)


def build() -> str:
    """Compile the library unless these sources already have one; its
    path.  The compilers' output (ptxas resource report) goes to
    ``<lib>.log``."""
    with _BUILD_LOCK:
        return _build_locked()


def _build_locked() -> str:
    out = library_path()
    if os.path.exists(out):
        return out
    if not SOURCES:
        raise RuntimeError(f"no CUDA sources under {_KDIR}/csrc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(s)}.o" for s in SOURCES]
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc each
            runs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o",
                                 so[1], so[0]]), zip(SOURCES, objs)))
        log = "".join(f"== {os.path.basename(s)}\n{r.stdout}{r.stderr}"
                      for s, r in zip(SOURCES, runs))
        if any(r.returncode for r in runs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        link = _run([nvcc, *ARCH, "-shared", "-o", f"{tag}.so", *objs])
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    with open(out + ".log", "w") as f:
        f.write(log + link.stdout + link.stderr)
    os.replace(f"{tag}.so", out)
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
    signatures = {
        # sweep.cu
        "sbs_w_fill": [p, p, p, p, i, i, i, p],
        "sbs_sweep_ctas": [i, i, i, i, p, p],
        "sbs_sweep": [i, p, p],
        # jacobi.cu
        "sbs_jacobi_ctas_per_sm": [i, i],
        "sbs_jacobi_pass": [i, p, p, p, p, p, p, p, p, p, p, i, i, p, p, p,
                            p, p, p, p, p, p, i, p, p, i, i, f, f, f, f, f,
                            f, f, i, p],
        # collide.cu
        "sbs_collide": [p, i, p, i, i, f, f, f, f, f, f, f, i, p],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = args
    return lib
