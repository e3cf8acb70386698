"""ctypes bindings for the native topology library (``native/softtopo.cpp``).

The library is compiled with ``g++`` at first use into the port's own build
directory (``softbodysim_torch/_build/native/``, named by a hash of the
source, so an edited source rebuilds).  Every entry point has a NumPy
fallback: the library only speeds up large-mesh set-up, and returns results
bit-identical to the fallbacks.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "native")
_SRC = os.path.normpath(os.path.join(_PKG_DIR, "..", "native",
                                     "softtopo.cpp"))


_BUILD_LOCK = threading.Lock()


def build_shared(src: str, stem: str) -> str:
    """The path of ``src`` built as a shared library into BUILD_DIR
    (``lib<stem>-<hash of the source>.so``), compiled with ``g++`` first
    unless this source has a build; raises OSError when the source is
    missing, RuntimeError when it does not build."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{key}.so")
    with _BUILD_LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            run = subprocess.run(
                ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp,
                 src], capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"cannot build {src}: {e}") from e
        if run.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed to build {src} "
                               f"({run.returncode}):\n{run.stderr}")
        os.replace(tmp, out)     # atomic: concurrent builds race safely
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(build_shared(_SRC, "softtopo"))
    except (OSError, RuntimeError):  # no source, compiler or usable build:
        return None                  # use NumPy
    i64, i32, voidp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

    lib.st_build_topology.restype = voidp
    lib.st_build_topology.argtypes = [f32p, i64, i32p, i64]
    for name in ("st_num_edges", "st_num_surface"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [voidp]
    for name in ("st_get_edges", "st_get_surface", "st_get_edge_colors",
                 "st_get_tet_colors"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [voidp, i32p]
    lib.st_free.restype = None
    lib.st_free.argtypes = [voidp]
    lib.st_orient.restype = None
    lib.st_orient.argtypes = [f32p, i32p, i64]
    lib.st_greedy_color.restype = None
    lib.st_greedy_color.argtypes = [i32p, i64, i32, i64, i32p]

    lib.st_pack_super.restype = voidp
    lib.st_pack_super.argtypes = [i64p, i64, i32, i32, i32, i32]
    lib.st_pack_num_super.restype = i64
    lib.st_pack_num_super.argtypes = [voidp]
    lib.st_pack_dmax.restype = i32
    lib.st_pack_dmax.argtypes = [voidp]
    lib.st_pack_fill.restype = None
    lib.st_pack_fill.argtypes = [voidp, i32p, i32p, i32p, i64p, f32p]
    lib.st_pack_free.restype = None
    lib.st_pack_free.argtypes = [voidp]

    lib.st_permute_rows.restype = None
    lib.st_permute_rows.argtypes = [voidp, voidp, i64p, i64, i64]

    lib.st_voxelize.restype = voidp
    lib.st_voxelize.argtypes = [f32p, i64, i32p, i64, ctypes.c_float]
    for name in ("st_vox_num_verts", "st_vox_num_tets"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [voidp]
    lib.st_vox_get_verts.restype = None
    lib.st_vox_get_verts.argtypes = [voidp, f32p]
    lib.st_vox_get_tets.restype = None
    lib.st_vox_get_tets.argtypes = [voidp, i32p]
    lib.st_vox_free.restype = None
    lib.st_vox_free.argtypes = [voidp]
    return lib


def native_build_topology(vertices: np.ndarray, tets: np.ndarray):
    """(edges (E,2), surface (S,3), edge_colors (E,), tet_colors (T,)), or
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(tets, np.int32)
    h = lib.st_build_topology(v, len(v), t, len(t))
    try:
        ne = lib.st_num_edges(h)
        ns = lib.st_num_surface(h)
        edges = np.empty((ne, 2), np.int32)
        surface = np.empty((ns, 3), np.int32)
        ecol = np.empty((ne,), np.int32)
        tcol = np.empty((len(t),), np.int32)
        if ne:
            lib.st_get_edges(h, edges.reshape(-1))
            lib.st_get_edge_colors(h, ecol)
        if ns:
            lib.st_get_surface(h, surface.reshape(-1))
        if len(t):
            lib.st_get_tet_colors(h, tcol)
        return edges, surface, ecol, tcol
    finally:
        lib.st_free(h)


def native_orient(vertices: np.ndarray,
                  tets: np.ndarray) -> Optional[np.ndarray]:
    """Positively-oriented int32 copy of ``tets``, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.array(tets, np.int32, order="C", copy=True)
    if len(t):
        lib.st_orient(v, t.reshape(-1), len(t))
    return t


def native_greedy_color(constraints: np.ndarray, num_vertices: int):
    lib = get_lib()
    if lib is None:
        return None
    cons = np.ascontiguousarray(constraints, np.int32)
    n, arity = cons.shape
    out = np.empty((n,), np.int32)
    if n:
        lib.st_greedy_color(cons.reshape(-1), n, arity, num_vertices, out)
    return out


def native_permute_blocks(arr: np.ndarray,
                          order: np.ndarray) -> Optional[np.ndarray]:
    """``out[i] = arr[order[i]]`` along axis 0 as one memcpy per block, or
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr)
    o = np.ascontiguousarray(order, np.int64)
    nb = a.shape[0]
    if nb == 0 or len(o) != nb:
        return None
    out = np.empty_like(a)
    lib.st_permute_rows(a.ctypes.data_as(ctypes.c_void_p),
                        out.ctypes.data_as(ctypes.c_void_p),
                        o, nb, a.nbytes // nb)
    return out


def native_pack_super(cons: np.ndarray, slots_cap: int, layer_cap: int,
                      order_mode: int = 1):
    """Native greedy super-block packing: (nsup, dmax, slots, rel, inv,
    perm, scale), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    cons = np.ascontiguousarray(cons, np.int64)
    n, arity = cons.shape
    h = lib.st_pack_super(cons, n, arity, slots_cap, layer_cap, order_mode)
    try:
        nsup = int(lib.st_pack_num_super(h))
        dmax = int(lib.st_pack_dmax(h))
        slots = np.zeros((nsup, 128), np.int32)
        rel = np.zeros((nsup * arity * 8, 128), np.int32)
        inv = np.zeros((nsup * slots_cap * dmax * 8, 128), np.int32)
        perm = np.zeros((nsup * 8 * 128,), np.int64)
        scale = np.zeros((nsup * 8, 128), np.float32)
        lib.st_pack_fill(h, slots, rel, inv, perm, scale)
    finally:
        lib.st_pack_free(h)
    return nsup, dmax, slots, rel, inv, perm, scale


def native_voxelize(vertices: np.ndarray, triangles: np.ndarray,
                    cell: float):
    """The voxel tetrahedralizer (``core/tetrahedralize.py``'s
    ``voxelize_numpy``, same output): (verts (V, 3) f32, tets (T, 4) i32),
    or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32).reshape(-1, 3)
    t = np.ascontiguousarray(triangles, np.int32).reshape(-1, 3)
    h = lib.st_voxelize(v.reshape(-1), len(v), t.reshape(-1), len(t),
                        ctypes.c_float(cell))
    try:
        nv = lib.st_vox_num_verts(h)
        nt = lib.st_vox_num_tets(h)
        verts = np.empty((nv, 3), np.float32)
        tets = np.empty((nt, 4), np.int32)
        if nv:
            lib.st_vox_get_verts(h, verts.reshape(-1))
        if nt:
            lib.st_vox_get_tets(h, tets.reshape(-1))
        return verts, tets
    finally:
        lib.st_vox_free(h)
