"""PyTorch wrapper of the fused collide kernel (``csrc/collide.cu``), with
its plain PyTorch version beside it.

* ``collide`` -- replaces ``softbodysim_tpu/kernels/collide.py::
  _collide_kernel``: the ground plane, then every collider in order, in one
  pass over the particles.  The jacobi pass backend runs the same code
  fused into its last pass of each iteration
  (``jacobi.jacobi_tet_pass_collide``, ``csrc/collide_math.cuh``).
* ``collide_positions`` -- the same stage on positions and inverse masses
  as a ``torch.autograd.Function``, for the plain steps (xpbd 'gather',
  jacobi 'segment' / 'gather', the heterogeneous batch): its forward
  builds the (V, 4) table and runs the kernel on it in place on the card,
  as those steps did around ``collide``; its backward is the
  vector-Jacobian product of ``collide_plain``, recomputed at the saved
  inputs (the JAX package's custom-VJP sidestep,
  ``softbodysim_tpu/diff.py::_sharded_xpbd_custom_vjp``: forward on one
  implementation, backward through its twin's linearisation, which the
  kernel's check against ``collide_plain`` licenses).  No backward kernel
  is written: the JAX kernel has no VJP either.

``collide`` works in place on a (V, 4) table of rows x, y, z, inverse
mass (the layout of the pass backend) and writes only free rows; the
callers that own such a table call it (the sweep step, the pass
backend's plain version).  The table is f32, or bf16 (the sweep step's
``xpbd_x_dtype="bfloat16"`` table): a bf16 row is pushed out in f32 from
its upcast and rounded once on the store, as the JAX sweep step does
(``softbodysim_tpu/solver/xpbd_pallas.py:652-658``).  Both wrappers run
the plain version on the CPU and launch the kernel on a CUDA device,
raising if the launch is refused; ``collide.launches`` counts the f32
kernel's launches by either wrapper and nothing else, ``collide_bf16``
the bf16 instantiation's.  ``collide_plain`` is out of place.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..collide.primitives import (Colliders, collide_particles,
                                  project_ground_plane)
from ..core.state import f32, resolve_device
from . import LaunchCounter, count_launch
from .sweep import _check, _check_xw, _lib, _ptr, _raise_on, _stream

COLUMNS = 12        # [type, pos3, quat4, data3, active]


class Ground(NamedTuple):
    """The ground plane as float32-exact Python floats: the unit normal,
    a point on the plane and the particle radius (floored at 1e-6)."""

    enabled: bool
    point: tuple
    normal: tuple
    radius: float


# The xpbd dialect's collider stage: world-space colliders at particle
# radius exactly 0 and no ground plane (the xpbd ground is the y clamp), as
# the JAX xpbd steps call collide_particles(p, 0.0, ...)
# (softbodysim_tpu/solver/xpbd_pallas.py:652-658, xpbd.py:415-419).
XPBD_GROUND = Ground(enabled=False, point=(0.0, 0.0, 0.0),
                     normal=(0.0, 1.0, 0.0), radius=0.0)


def make_ground(params) -> Ground:
    """The jacobi dialect's ground (solver/jacobi.py:283-288 of the JAX
    package): a normal shorter than 1e-6 becomes (0, 1, 0)."""
    gn = np.asarray(params.ground_normal, np.float32)
    n2 = float(np.dot(gn, gn))
    gn = (gn / np.float32(np.sqrt(n2)) if n2 >= 1e-12
          else np.array([0.0, 1.0, 0.0], np.float32))
    return Ground(
        enabled=bool(params.ground_enabled),
        point=tuple(float(v) for v in np.asarray(params.ground_point,
                                                 np.float32)),
        normal=tuple(float(v) for v in gn.astype(np.float32)),
        radius=f32(max(1e-6, params.particle_radius)))


def runtime_colliders(template: Optional[Colliders],
                      colliders_rt: Optional[Colliders], device):
    """The collider set of this step, for every dialect: the runtime poses
    when given (same count as the make-time template), else the
    template."""
    if colliders_rt is None:
        return template
    if template is None:
        raise ValueError("runtime colliders require a make-time collider "
                         "template")
    if colliders_rt.count != template.count:
        raise ValueError(f"runtime colliders: {colliders_rt.count} slots, "
                         f"the template has {template.count}")
    return colliders_rt.to(device)


def pack_colliders(colliders: Optional[Colliders], device=None):
    """(K, 12) f32 table [type, pos3, quat4, data3, active] on the
    colliders' device (``device``, default the card, for None); one
    inactive zero row for an empty set (as the JAX package packs it)."""
    if colliders is None or colliders.count == 0:
        dev = (colliders.device if colliders is not None and device is None
               else resolve_device(device))
        return torch.zeros((1, COLUMNS), dtype=torch.float32, device=dev)
    k, ft = colliders.count, torch.float32
    return torch.cat([
        colliders.type.to(ft).reshape(k, 1),
        colliders.position.to(ft).reshape(k, 3),
        colliders.rotation.to(ft).reshape(k, 4),
        colliders.data.to(ft).reshape(k, 3),
        colliders.active.to(ft).reshape(k, 1)], 1).contiguous()


def unpack_colliders(packed: torch.Tensor) -> Colliders:
    """The Colliders view of a packed table."""
    return Colliders(type=packed[:, 0].to(torch.int32),
                     position=packed[:, 1:4], rotation=packed[:, 4:8],
                     data=packed[:, 8:11], active=packed[:, 11] != 0.0)


def collide_plain(xw: torch.Tensor, packed: torch.Tensor,
                  ground: Ground) -> torch.Tensor:
    """``project_ground_plane`` then ``collide_particles`` on the free rows
    of ``xw``: a new (V, 4) table of xw's dtype (xw is not written; a bf16
    table is pushed out from its f32 upcast and rounded once)."""
    xf = xw.float()
    p = xf[:, :3]
    if ground.enabled:
        point, normal = (torch.tensor(v, dtype=torch.float32,
                                      device=xw.device)
                         for v in (ground.point, ground.normal))
        p = project_ground_plane(p, ground.radius, point, normal)
    p = collide_particles(p, ground.radius, unpack_colliders(packed))
    p = torch.where((xf[:, 3] != 0.0)[:, None], p, xf[:, :3])
    return torch.cat([p, xf[:, 3:]], 1).to(xw.dtype)


def check_packed(packed: torch.Tensor, dev: torch.device) -> None:
    """Raise unless ``packed`` is a (K, 12) f32 table on ``dev``."""
    if not isinstance(packed, torch.Tensor) or packed.dim() != 2 \
            or packed.shape[1] != COLUMNS:
        raise ValueError(f"packed must be a (K, {COLUMNS}) tensor")
    _check(packed, "packed", torch.float32, packed.shape, dev)


def collide(xw: torch.Tensor, packed: torch.Tensor,
            ground: Ground) -> torch.Tensor:
    """The whole collide stage on the free rows of ``xw``, in place;
    returns xw.  ``packed``: a (K, 12) table from ``pack_colliders`` on
    xw's device."""
    dev = _check_xw(xw)
    check_packed(packed, dev)
    if dev.type == "cpu":
        return xw.copy_(collide_plain(xw, packed, ground))
    _launch(xw, packed, ground)
    return xw


def _launch(xw: torch.Tensor, packed: torch.Tensor, ground: Ground) -> None:
    """The kernel on ``xw`` (a checked table on the card), in place,
    counted as ``collide``'s launch (``collide_bf16``'s on a bf16
    table)."""
    (gpx, gpy, gpz), (gnx, gny, gnz) = ground.point, ground.normal
    f = ctypes.c_float
    bf16 = xw.dtype == torch.bfloat16
    rc = _lib().sbs_collide(
        _ptr(xw), xw.shape[0], _ptr(packed), packed.shape[0],
        int(ground.enabled), f(gpx), f(gpy), f(gpz), f(gnx), f(gny), f(gnz),
        f(ground.radius), int(bf16), _stream(xw.device))
    _raise_on(rc, "collide")
    count_launch(collide_bf16 if bf16 else collide)


collide.launches = 0
collide_bf16 = LaunchCounter("collide_bf16")


class CollideFunction(torch.autograd.Function):
    """The collide stage with a gradient: forward on the kernel (the plain
    version on the CPU) into the (V, 4) table it builds from (p, w),
    backward through ``collide_plain`` at the saved inputs."""

    @staticmethod
    def forward(ctx, p, w, packed, ground):
        ctx.ground = ground
        ctx.save_for_backward(p, w, packed)
        xw = torch.cat([p, w[:, None]], 1)
        if xw.device.type == "cpu":
            return collide_plain(xw, packed, ground)
        _launch(xw, packed, ground)
        return xw

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = collide_plain(torch.cat([ins[0], ins[1][:, None]], 1),
                                ins[2], ctx.ground)
            got = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], grad))
        return (*(next(got) if n else None for n in need), None)


def collide_positions(p: torch.Tensor, w: torch.Tensor, packed: torch.Tensor,
                      ground: Ground) -> torch.Tensor:
    """The collide stage on positions ``p`` (V, 3) with inverse masses
    ``w`` (V,): new (V, 3) positions (free rows moved), with a gradient
    w.r.t. ``p``, ``w`` and ``packed`` (``CollideFunction``)."""
    dev = p.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if p.dtype != torch.float32 or w.dtype != torch.float32 \
            or p.dim() != 2 or p.shape[1] != 3 \
            or tuple(w.shape) != tuple(p.shape[:1]) or w.device != dev:
        raise ValueError("p must be a (V, 3) and w a (V,) float32 tensor "
                         "on one device")
    check_packed(packed, dev)
    return CollideFunction.apply(p, w, packed, ground)[:, :3]
