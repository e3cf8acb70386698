"""The kernel library with one CUDA source swapped for an instrumented copy:
the shared part of the phase profilers (``profile_sweep_phases.py``,
``profile_jacobi_phases.py``).

A profiler reads ``source(name)``, places its stamps with ``insert`` (which
raises when the source no longer holds the anchor once: the profiler must
follow the source), and calls ``build``: the copy goes into
``softbodysim_torch/_build/<subdir>/`` and the library is built from it
before anything loads the plain one, so the wrappers launch the
instrumented kernels.  The copy must define ``sbs_phase_take(out)``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "softbodysim_torch", "kernels", "csrc")


def source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def insert(src: str, anchor: str, code: str, name: str,
           before: bool = False) -> str:
    """``code`` placed after (or before) the one ``anchor`` of ``src``."""
    if src.count(anchor) != 1:
        raise RuntimeError(f"{name} changed: no single {anchor!r}")
    return src.replace(anchor, code + anchor if before else anchor + code)


def build(name: str, text: str, subdir: str) -> ctypes.CDLL:
    """The library with ``csrc/<name>`` replaced by ``text``; binds
    ``sbs_phase_take``."""
    from softbodysim_torch.kernels import _build

    out = os.path.join(ROOT, "softbodysim_torch", "_build", subdir)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, name)
    with open(path, "w") as f:
        f.write(text)
    _build.SOURCES = tuple(path if os.path.basename(src) == name else src
                           for src in _build.SOURCES)
    _build.BUILD_DIR = out
    lib = _build.load()
    lib.sbs_phase_take.restype = ctypes.c_int
    lib.sbs_phase_take.argtypes = [ctypes.c_void_p]
    return lib


def card_clocks() -> str:
    """The card's name, power limit and SM clock (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
