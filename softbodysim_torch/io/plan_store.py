"""Persistent packed-plan cache: skip host-side packing on cold starts.

Packing the sweep plans is host work that grows with scene size (seconds
for the super-block plans of a 100k-particle scene, tens of seconds for its
legacy 128-wide plans).  The result is a deterministic function of the
topology arrays and the packing parameters, so it is cached on disk, keyed
by a content hash.  The counterpart of ``softbodysim_tpu/io/plan_store.py``
with the port's own directory, key tag and ``PACK_VERSION``: the two
packages never read each other's entries.

Environment:
- ``SOFTBODYSIM_TORCH_PLAN_CACHE``: cache directory (default
  ``softbodysim_torch/_build/plans`` inside the package's checkout).
- ``SOFTBODYSIM_NO_PLAN_CACHE=1``: disable the cache (the switch both
  packages read).
- ``SOFTBODYSIM_PLAN_CACHE_GB``: size bound (default 20); the least
  recently used entries are evicted after each save (loads touch mtime).

Entries are pickles of the plan dataclasses -- an internal cache format;
any failure to load falls back to packing.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile

import numpy as np

# Bump on ANY change to the packers' outputs (pack_superblocks,
# pack_constraints, _pack_order, regroup_plan, order_vertices,
# aligned_order): it invalidates every cached plan.
PACK_VERSION = 1
_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build",
    "plans")


def cache_dir() -> str:
    return os.environ.get("SOFTBODYSIM_TORCH_PLAN_CACHE") or _DEFAULT_DIR


def enabled() -> bool:
    return os.environ.get("SOFTBODYSIM_NO_PLAN_CACHE", "") not in (
        "1", "true", "True")


def content_key(parts) -> str:
    """SHA-1 over a list of arrays / scalars / None (arrays hash dtype,
    shape and bytes), under the port's tag and PACK_VERSION."""
    h = hashlib.sha1(f"softbodysim_torch plans v{PACK_VERSION}|".encode())
    for p in parts:
        if p is None:
            h.update(b"\x00none")
        elif isinstance(p, np.ndarray):
            a = np.ascontiguousarray(p)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(memoryview(a).cast("B"))
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return h.hexdigest()


def load(key: str):
    """The cached object for ``key``, or None (miss, disabled, error)."""
    if not enabled():
        return None
    path = os.path.join(cache_dir(), key + ".pkl")
    try:
        with open(path, "rb") as fh:
            obj = pickle.load(fh)
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
            ImportError, ValueError):
        return None
    try:
        os.utime(path)            # LRU touch
    except OSError:
        pass
    return obj


def _evict(max_bytes: int) -> None:
    """Drop least-recently-used entries until the cache fits."""
    d = cache_dir()
    try:
        entries = []
        for f in os.listdir(d):
            if f.endswith(".pkl"):
                st = os.stat(os.path.join(d, f))
                entries.append((st.st_mtime, st.st_size,
                                os.path.join(d, f)))
    except OSError:
        return
    total = sum(e[1] for e in entries)
    for _, size, p in sorted(entries):
        if total <= max_bytes:
            break
        try:
            os.unlink(p)
            total -= size
        except OSError:
            pass


def save(key: str, obj) -> None:
    """Atomic write (temporary file + rename); never raises."""
    if not enabled():
        return
    d = cache_dir()
    tmp = None
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(obj, fh, protocol=5)
        os.replace(tmp, os.path.join(d, key + ".pkl"))
        tmp = None
        try:
            gb = float(os.environ.get("SOFTBODYSIM_PLAN_CACHE_GB", "20"))
        except ValueError:
            gb = 20.0
        _evict(int(gb * 2**30))
    except Exception:   # incl. PicklingError: skip the cache, never raise
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
