"""Primitive collision push-out: sphere / oriented box / capsule + ground
plane (PyTorch).

The counterpart of ``softbodysim_tpu/collide/primitives.py``: the branchless
GPU forms of the reference's collision math, colliders applied
*sequentially* in registration order, each push scaled by its slot's
``active`` flag.  These are the plain versions of the fused collide kernel
(``kernels/collide.py``) and the collide path of every backend that does
not launch it.

Every sum of three products is written out left to right, and the guard
constants are float32-exact, so the arithmetic is the kernel's own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.state import f32, resolve_device

SPHERE = 0
BOX = 1
CAPSULE = 2


_EPS_TINY = f32(1e-18)
_EPS_BOX = f32(1e-20)
_EPS_NORMAL = f32(1e-9)
_EPS_AXIS = f32(1e-12)


@dataclasses.dataclass(frozen=True)
class Colliders:
    """SoA collider set; fields are (K, ...) tensors on one device."""

    type: torch.Tensor        # (K,) int32
    position: torch.Tensor    # (K, 3) f32 world position
    rotation: torch.Tensor    # (K, 4) f32 quaternion (x, y, z, w)
    data: torch.Tensor        # (K, 3) f32 (sphere r | box half extents |
    #                                      capsule r, half height)
    active: torch.Tensor      # (K,) bool

    @property
    def count(self) -> int:
        return int(self.type.shape[0])

    @property
    def device(self) -> torch.device:
        return self.type.device

    def to(self, device) -> "Colliders":
        """The same set on ``device`` (self when already there)."""
        dev = torch.device(device)
        if self.device == dev:
            return self
        return Colliders(*(getattr(self, f.name).to(dev)
                           for f in dataclasses.fields(self)))

    @staticmethod
    def empty(device=None) -> "Colliders":
        return Colliders.build([], device=device)

    @staticmethod
    def build(items: Sequence[Optional[dict]],
              capacity: Optional[int] = None, device=None) -> "Colliders":
        """items: dicts with keys type, position, rotation (optional), data;
        ``None`` entries are tombstones (inactive slot, id kept stable).
        ``capacity`` pads with inactive slots, so sets of one capacity have
        one shape.  ``device`` defaults to the card."""
        dev = resolve_device(device)
        k = len(items)
        cap = k if capacity is None else max(int(capacity), k)
        typ = np.zeros((cap,), np.int32)
        pos = np.zeros((cap, 3), np.float32)
        rot = np.tile(np.array([0, 0, 0, 1], np.float32), (cap, 1))
        dat = np.zeros((cap, 3), np.float32)
        act = np.zeros((cap,), bool)
        for i, it in enumerate(items):
            if it is None:
                continue
            typ[i] = it["type"]
            pos[i] = it["position"]
            if "rotation" in it:
                rot[i] = it["rotation"]
            d = np.asarray(it["data"], np.float32).ravel()
            dat[i, : d.size] = d
            act[i] = True
        return Colliders(*(torch.from_numpy(a).to(dev)
                           for a in (typ, pos, rot, dat, act)))

    @staticmethod
    def sphere(center, radius) -> dict:
        return {"type": SPHERE, "position": center, "data": [radius, 0, 0]}

    @staticmethod
    def box(center, half_extents, rotation=(0, 0, 0, 1)) -> dict:
        return {"type": BOX, "position": center, "rotation": rotation,
                "data": half_extents}

    @staticmethod
    def capsule(center, radius, half_height, rotation=(0, 0, 0, 1)) -> dict:
        return {"type": CAPSULE, "position": center, "rotation": rotation,
                "data": [radius, half_height, 0]}


def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def cross3(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def quat_rotate(q, v):
    """Rotate v by quaternion q = (x, y, z, w): v + w*t + q.xyz x t with
    t = 2 * q.xyz x v (SoftBodyCompute.compute:78-82)."""
    qv = q[..., :3]
    t = 2.0 * cross3(qv, v)
    return v + q[..., 3:4] * t + cross3(qv, t)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def push_out_sphere(center, radius, p, r):
    """Sphere push-out (SoftBodyCompute.compute:108-122): (N, 3) pushes,
    zero where not penetrating."""
    big_r = radius + r
    d = p - center
    dist2 = dot3(d, d)
    dist = torch.sqrt(dist2.clamp_min(_EPS_TINY))
    up = torch.tensor([0.0, 1.0, 0.0], dtype=p.dtype, device=p.device)
    n = torch.where((dist > _EPS_NORMAL)[..., None], d / dist[..., None], up)
    push = n * (big_r - dist)[..., None]
    return torch.where((dist2 < big_r * big_r)[..., None], push, 0.0)


def push_out_capsule(center, rotation, radius, half_height, p, r):
    """Capsule push-out: the closest point on the segment along the rotated
    +y axis, then the sphere form (SoftBodyCompute.compute:124-150)."""
    up = torch.tensor([0.0, 1.0, 0.0], dtype=p.dtype, device=p.device)
    axis = quat_rotate(rotation, up)
    a = center - axis * half_height
    b = center + axis * half_height
    ab = b - a
    ab2 = dot3(ab, ab)
    t = torch.where(ab2 < _EPS_AXIS, 0.0,
                    dot3(p - a, ab) / ab2.clamp_min(_EPS_BOX))
    t = t.clamp(0.0, 1.0)
    cp = a + ab * t[..., None]
    return push_out_sphere(cp, radius, p, r)


def push_out_box(center, rotation, half_extents, p, r):
    """Oriented-box push-out (SoftBodyCompute.compute:152-204): outside or
    in the shell, along the clamp offset when closer than r; fully inside,
    out through the nearest face plus r."""
    pl = quat_rotate(quat_conjugate(rotation), p - center)
    cl = torch.minimum(torch.maximum(pl, -half_extents), half_extents)
    d = pl - cl
    dist2 = dot3(d, d)
    outside = dist2 > _EPS_TINY

    dist = torch.sqrt(dist2.clamp_min(_EPS_BOX))
    push_out_l = (d / dist[..., None]) * (r - dist)[..., None]
    push_out_l = torch.where((dist < r)[..., None], push_out_l, 0.0)

    ap = pl.abs()
    dx = half_extents[..., 0] - ap[..., 0]
    dy = half_extents[..., 1] - ap[..., 1]
    dz = half_extents[..., 2] - ap[..., 2]
    sx = torch.where(pl[..., 0] >= 0, 1.0, -1.0)
    sy = torch.where(pl[..., 1] >= 0, 1.0, -1.0)
    sz = torch.where(pl[..., 2] >= 0, 1.0, -1.0)
    use_x = (dx <= dy) & (dx <= dz)
    use_y = (~use_x) & (dy <= dz)
    use_z = ~(use_x | use_y)
    push_in_l = torch.stack([torch.where(use_x, sx * (dx + r), 0.0),
                             torch.where(use_y, sy * (dy + r), 0.0),
                             torch.where(use_z, sz * (dz + r), 0.0)], -1)
    push_l = torch.where(outside[..., None], push_out_l, push_in_l)
    return quat_rotate(rotation, push_l)


def push_out_one(ctype, position, rotation, data, p, r):
    """All three forms, selected by collider type; (N, 3) pushes."""
    sphere = push_out_sphere(position, data[0], p, r)
    box = push_out_box(position, rotation, data, p, r)
    capsule = push_out_capsule(position, rotation, data[0], data[1], p, r)
    return torch.where(ctype == SPHERE, sphere,
                       torch.where(ctype == BOX, box, capsule))


def collide_particles(p, r, colliders: Optional[Colliders]):
    """Apply every collider, in order, to (N, 3) world positions (the
    reference's per-particle collider loop); inactive slots push by 0."""
    if colliders is None or colliders.count == 0:
        return p
    act = colliders.active.to(p.dtype)
    for k in range(colliders.count):
        push = push_out_one(colliders.type[k], colliders.position[k],
                            colliders.rotation[k], colliders.data[k], p, r)
        p = p + act[k] * push
    return p


def project_ground_plane(p, r, point, normal):
    """Arbitrary ground plane push (SoftBodySolver.cs:548-551 /
    SoftBodyCompute.compute:403-408): dist = n.(p - p0); where dist < r,
    push along n by (r - dist)."""
    dist = dot3(normal, p - point)
    pushed = p + normal * (r - dist)[..., None]
    return torch.where((dist < r)[..., None], pushed, p)
