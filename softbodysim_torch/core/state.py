"""Simulation state and solver parameters (PyTorch).

The same six state fields and the same solver knobs, with the same
defaults, as ``softbodysim_tpu/core/state.py``; the state holds fp32 torch
tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def f32(x) -> float:
    """x rounded to float32, as a Python float (exact in either width): a
    scalar the kernels and the plain versions round alike."""
    return float(np.float32(x))


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device (default: the card, ``cuda:0``; the CPU
    only when asked for).  A CUDA device without a usable card raises:
    nothing falls back to the CPU."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is false (pass device='cpu' to run on the CPU)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(dev)!r} (cpu|cuda)")
    return dev


@dataclasses.dataclass(frozen=True)
class SimState:
    """Dynamic per-step state.

    x         : (V, 3) committed positions
    v         : (V, 3) velocities
    x_star    : (V, 3) predicted positions (the solve target)
    inv_mass  : (V,)   inverse masses; 0 == pinned
    edge_lambda: (E,)  accumulated XPBD multipliers (distance), public order
    tet_lambda : (T,)  accumulated XPBD multipliers (volume), public order

    Lambdas are zeroed ONLY at init, never per substep.
    """

    x: Any
    v: Any
    x_star: Any
    inv_mass: Any
    edge_lambda: Any
    tet_lambda: Any


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Static solver configuration; the fields and defaults of the JAX
    package's SolverParams (see its docstrings for each knob).

    The port runs the 'xpbd' dialect on the block-synchronous sweep backend
    (``xpbd_backend`` 'sweep', or its alias 'pallas'; 'auto' picks it on a
    CUDA device at >= 100k constraints) and the coloured Gauss-Seidel
    backend 'gather' (what 'auto' picks otherwise; 'scatter' is its
    alias), and the 'jacobi' dialect on the 'segment', 'gather' and 'pass'
    backends (``jacobi_backend``; 'pallas' is an alias of 'pass', which
    'auto' picks on a CUDA device at >= 100k constraints)."""

    substeps: int = 2
    iterations: int = 6
    dialect: str = "xpbd"

    # --- xpbd dialect ---
    edge_compliance: float = 5e-4
    volume_compliance: float = 0.0
    friction: float = 0.2          # ground friction at commit

    # --- jacobi dialect ---
    edge_stiffness: float = 0.9
    volume_stiffness: float = 0.98
    sor_omega: float = 1.4
    particle_radius: float = 0.02

    gravity: tuple = (0.0, -9.81, 0.0)

    ground_enabled: bool = True
    ground_y: float = 0.0
    ground_point: tuple = (0.0, 0.0, 0.0)
    ground_normal: tuple = (0.0, 1.0, 0.0)

    use_pallas: str = "auto"
    jacobi_backend: str = "auto"
    xpbd_backend: str = "auto"

    # block-synchronous sweep scheme: "scale" | "split" | "auto" (split,
    # omega (1.5, 2.2)); scalar or (edge, tet) pair
    xpbd_block_scheme: Any = "auto"
    xpbd_block_omega: Any = 1.0
    xpbd_block_local_iters: Any = 1

    xpbd_x_dtype: str = "float32"

    chebyshev: bool = False
    chebyshev_rho: float = 0.95
    chebyshev_delay: int = 4

    self_collision: bool = False
    self_collision_cell: float = 0.1
    self_collision_max_per_cell: int = 8

    surface_collision: bool = False
    surface_thickness: float = 0.02
    surface_collision_cell: float = 0.0
    surface_collision_max_per_cell: int = 8

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)


def init_state(topology, pinned=None, *, inv_mass_mode: str = "tet",
               density: float = 1.0, pin_top_layer: bool = False,
               pin_top_epsilon: float = 1e-4, device=None) -> SimState:
    """A fresh SimState on ``device`` (default: the card): zero
    velocities, x_star = x,
    lambdas = 0, inverse masses from tet volumes, pinned rows zeroed.

    inv_mass_mode:
      'tet'     -- each tet with |vol|>1e-12 adds 4/|vol| of inverse mass
                   to each corner (server variant).
      'density' -- lumped mass m += density*|vol|/4 per corner,
                   inv_mass = 1/m (in-engine variant).
    """
    dev = resolve_device(device)
    x0 = np.asarray(topology.vertices, np.float32)
    v_count = x0.shape[0]
    tets = np.asarray(topology.tets, np.int64)

    w = np.zeros(v_count, np.float32)
    if not tets.size:
        # tet-less topology (cloth): uniform unit mass per particle
        w = np.ones(v_count, np.float32)
    if tets.size:
        a, b, c, d = tets[:, 0], tets[:, 1], tets[:, 2], tets[:, 3]
        vol = np.einsum("...i,...i->...",
                        np.cross(x0[b] - x0[a], x0[c] - x0[a]),
                        x0[d] - x0[a]) / 6.0
        avol = np.abs(vol)
        if inv_mass_mode == "tet":
            contrib = np.where(avol > 1e-12,
                               4.0 / np.maximum(avol, 1e-30), 0.0)
            contrib = contrib.astype(np.float32)
            for corner in (a, b, c, d):
                np.add.at(w, corner, contrib)
        elif inv_mass_mode == "density":
            dens = max(1e-6, float(density))
            mass = np.zeros(v_count, np.float32)
            share = (dens * np.maximum(1e-12, avol) * 0.25).astype(np.float32)
            for corner in (a, b, c, d):
                np.add.at(mass, corner, share)
            w = np.where(mass > 0.0, 1.0 / np.maximum(mass, 1e-30), 0.0)
            w = w.astype(np.float32)
        else:
            raise ValueError(f"unknown inv_mass_mode {inv_mass_mode!r}")

    if pin_top_layer and v_count:
        top_y = float(x0[:, 1].max())
        w[np.abs(x0[:, 1] - top_y) <= pin_top_epsilon] = 0.0

    if pinned is not None:
        pinned = np.asarray(pinned, np.int64)
        pinned = pinned[(pinned >= 0) & (pinned < v_count)]
        w[pinned] = 0.0

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    x = t(x0)
    return SimState(
        x=x,
        v=torch.zeros((v_count, 3), dtype=torch.float32, device=dev),
        x_star=x.clone(),
        inv_mass=t(w),
        edge_lambda=torch.zeros((topology.edges.shape[0],),
                                dtype=torch.float32, device=dev),
        tet_lambda=torch.zeros((tets.shape[0],), dtype=torch.float32,
                               device=dev),
    )


def tet_signed_volume(p0, p1, p2, p3):
    """Signed tet volume dot(cross(p1 - p0, p2 - p0), p3 - p0) / 6 of
    (..., 3) tensors, fp32 (PBDServer.h:140-145); array-equal to the JAX
    package's ``tet_signed_volume``."""
    return torch.sum(torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
                     * (p3 - p0), dim=-1) / 6.0
