"""The reference's four benchmark scenes as presets, and the scene
engines: per-body World, grouped families, one merged mesh, or the fewest
merged programs (partitioned).

Scene configs from SURVEY.md section 4 (the scenes are the reference's
only test suite), as ``softbodysim_tpu/api/scenes.py`` sets them:

  sample_scene  1 body, substeps 2 x iters 6; edgeStiffness .7,
                volumeStiffness 1, omega 1.4, density .2, radius .01
                              (SampleScene.unity:1139-1147,1208-1215)
  four_body     4 bodies, dt 1/60                  (4fumoTest.unity:1483-1491)
  extreme_test  24 bodies (16 balls + 8 heavier), edgeStiffness .5,
                volumeStiffness 1        (ExtremeTest.unity:163-170,3213-3221)
  batch_test    20 bodies (10 small balls + 10 x the 8.6k-vertex 'default'
                mesh)                              (BatchTest.unity:2912-2920)

Bodies use the reference's own tetrahedralized Unity assets when the
environment variable SOFTBODYSIM_REFERENCE names a checkout of the
reference (``io/unity_assets.py``), else procedural stand-ins of matching
scale.  All scenes use the jacobi dialect with gravity (0, -10, 0), as the
scenes' manager blocks do.  Every engine runs on ``device`` (default: the
card; ``device="cpu"`` runs the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ..collide.primitives import Colliders
from ..core import meshes
from ..core.state import SolverParams
from ..core.topology import Topology, build_topology, merge_topologies
from .engine import Engine
from .world import Body, World

GENERATED = os.path.join("Assets", "SoftBody", "Generated")
# per-body options a merged program honours; any other makes a body solo
_MERGEABLE_KW = {"density", "pinned"}


def _material(p: SolverParams) -> Tuple[str, str]:
    """The params fields that merge per constraint: stiffness for jacobi,
    compliance for xpbd."""
    return (("edge_stiffness", "volume_stiffness") if p.dialect == "jacobi"
            else ("edge_compliance", "volume_compliance"))


def _normalized(p: SolverParams) -> SolverParams:
    kf = _material(p)
    return p.replace(**{kf[0]: 0.0, kf[1]: 0.0})


def _backend_knob(p: SolverParams) -> str:
    return "jacobi_backend" if p.dialect == "jacobi" else "xpbd_backend"


@dataclasses.dataclass
class Scene:
    name: str
    bodies: List[Tuple[str, Topology, SolverParams, dict]]
    colliders: List[dict]
    substeps: int = 2
    iterations: int = 6
    groups: Optional[list] = None   # List[parallel.groups.Group]

    def _colliders(self, device):
        return (Colliders.build(self.colliders, device=device)
                if self.colliders else None)

    def build_world(self, fixed_dt: float = 1.0 / 60.0, *,
                    device=None) -> World:
        world = World(fixed_dt=fixed_dt, device=device)
        for item in self.colliders:
            world.add_collider(item)
        for name, topo, params, kw in self.bodies:
            world.register(Body(topo, params, name=name, **kw))
        return world

    def build_grouped(self, *, device=None):
        """One batched step per mesh family (``parallel/groups.py``): the
        path for many small bodies."""
        from ..parallel.groups import GroupedSceneEngine

        if not self.groups:
            raise ValueError(f"scene {self.name} defines no groups")
        return GroupedSceneEngine(self.groups,
                                  colliders=self._colliders(device),
                                  device=device)

    def build_merged(self, backend: str = "pallas", *, device=None):
        """Every body becomes a vertex range of ONE merged sim mesh
        (``merge_topologies``) stepped by the single-scene backend
        ``backend`` ('pallas': the pass kernels for jacobi, the sweep
        kernels for xpbd; 'auto' resolves on the merged size).  No
        constraint crosses a body boundary, so this is each body's own
        physics.

        Bodies may differ in edge / volume stiffness (jacobi) or compliance
        (xpbd): they merge as per-constraint tables; every OTHER
        SolverParams field, and the density, must be uniform.  Returns
        (engine, vertex_offsets)."""
        if not self.bodies:
            raise ValueError(f"scene {self.name} has no bodies")
        # merged execution honours only density / pinned; anything else
        # (pin_top_layer, inv_mass_mode, ...) would be dropped silently
        for name, _, _, kw in self.bodies:
            extra = set(kw) - _MERGEABLE_KW
            if extra:
                raise ValueError(
                    f"build_merged: body {name!r} has unsupported per-body "
                    f"options {sorted(extra)} (merged execution honors only "
                    "density/pinned; use build_world for the rest)")
        params0 = self.bodies[0][2]
        kf = _material(params0)
        norm0 = _normalized(params0)
        if any(_normalized(p) != norm0 for _, _, p, _ in self.bodies):
            raise ValueError(
                "build_merged requires uniform SolverParams (apart from "
                f"{kf[0]}/{kf[1]}, which merge per-constraint)")
        mixed = any(getattr(p, f) != getattr(params0, f)
                    for _, _, p, _ in self.bodies for f in kf)
        densities = {kw.get("density", 1.0) for _, _, _, kw in self.bodies}
        if len(densities) != 1:
            raise ValueError("build_merged requires uniform density")
        merged, voffs = merge_topologies([t for _, t, _, _ in self.bodies])
        pinned = [int(i) + int(voffs[b])
                  for b, (_, _, _, kw) in enumerate(self.bodies)
                  if kw.get("pinned") is not None
                  for i in np.atleast_1d(kw["pinned"]).tolist()]
        solver_kw = {}
        if mixed:
            names = (("edge_k", "tet_k") if params0.dialect == "jacobi"
                     else ("edge_c", "tet_c"))
            for name, f, count in zip(names, kf, ("num_edges", "num_tets")):
                solver_kw[name] = np.concatenate([
                    np.full(getattr(t, count), getattr(p, f), np.float32)
                    for _, t, p, _ in self.bodies])
        eng = Engine(merged,
                     params0.replace(**{_backend_knob(params0): backend}),
                     colliders=self._colliders(device),
                     density=densities.pop(),
                     pinned=np.asarray(pinned, np.int64) if pinned else None,
                     device=device, **solver_kw)
        return eng, voffs

    def build_partitioned(self, backend: str = "pallas", *,
                          device=None) -> "PartitionedSceneEngine":
        """Bodies grouped into the FEWEST merged programs: by dialect and
        every SolverParams field but the per-constraint material knobs,
        and by density; each group is one ``build_merged`` program (two
        dialects: two programs, whatever the body count).  Bodies with
        per-body options beyond density / pinned run as singleton
        Engines, with their exact per-body semantics.  The reference steps
        every body separately (SoftBodyManager.cs:217-233)."""
        if not self.bodies:
            raise ValueError(f"scene {self.name} has no bodies")
        parts: List[dict] = []       # greedy stable first-fit partition
        for body in self.bodies:
            _, _, params, kw = body
            if set(kw) - _MERGEABLE_KW:
                parts.append({"solo": True, "key": None, "bodies": [body]})
                continue
            key = (_normalized(params), kw.get("density", 1.0))
            hit = next((q for q in parts
                        if not q["solo"] and q["key"] == key), None)
            if hit is not None:
                hit["bodies"].append(body)
            else:
                parts.append({"solo": False, "key": key, "bodies": [body]})

        entries = []
        for q in parts:
            bodies = q["bodies"]
            if len(bodies) == 1:
                name, topo, params, kw = bodies[0]
                eng = Engine(topo,
                             params.replace(**{_backend_knob(params):
                                               backend}),
                             colliders=self._colliders(device),
                             device=device, **kw)
                entries.append((eng, [name], None))
            else:
                sub = Scene(name=f"{self.name}/part{len(entries)}",
                            bodies=bodies, colliders=self.colliders,
                            substeps=self.substeps,
                            iterations=self.iterations)
                eng, voffs = sub.build_merged(backend=backend,
                                              device=device)
                entries.append((eng, [b[0] for b in bodies], voffs))
        return PartitionedSceneEngine(entries)


class PartitionedSceneEngine:
    """A scene as a small set of merged engines (``build_partitioned``).
    Each engine's steps are enqueued before any wait, so partitions
    overlap on the device."""

    def __init__(self, entries):
        # entries: [(engine, [body names], voffs-or-None)]
        self.entries = entries

    @property
    def num_programs(self) -> int:
        return len(self.entries)

    def step(self, dt: float = 1.0 / 60.0) -> "PartitionedSceneEngine":
        for eng, _, _ in self.entries:
            eng.step(dt)
        return self

    def run(self, n: int, dt: float = 1.0 / 60.0):
        """Partitions do not interact, so each engine enqueues its n steps
        (Engine.run's RUN_CHUNK bursts) before the one wait."""
        for eng, _, _ in self.entries:
            eng.run(n, dt)
        return self.block()

    def block(self) -> "PartitionedSceneEngine":
        for eng, _, _ in self.entries:
            eng.block()
        return self

    def positions(self):
        """{body name: (V, 3) world positions} across all partitions."""
        out = {}
        for eng, names, voffs in self.entries:
            pos = eng.positions()
            if voffs is None:
                out[names[0]] = pos
            else:
                for i, nm in enumerate(names):
                    out[nm] = pos[voffs[i]:voffs[i + 1]]
        return out


def _asset(name: str) -> Optional[Topology]:
    from ..io.unity_assets import load_tet_asset

    root = os.environ.get("SOFTBODYSIM_REFERENCE")
    path = None if root is None else os.path.join(root, GENERATED, name)
    if path is not None and os.path.exists(path):
        return load_tet_asset(path)
    return None


def _bunny(center, scale: float = 1.0) -> Topology:
    t = _asset("Bunny-LowPoly_Tet 1.asset")
    if t is None:
        t = meshes.tet_ball(2, 0.3, (0, 0, 0))
    return _recenter(t, center, scale)


def _ball_small(center, scale: float = 1.0) -> Topology:
    t = _asset("Icosphere_Tet.asset")
    if t is None:
        t = meshes.tet_ball(2, 0.25, (0, 0, 0))
    return _recenter(t, center, scale)


def _ball_large(center, scale: float = 1.0) -> Topology:
    t = _asset("Icosphere.001_Tet.asset")
    if t is None:
        t = meshes.tet_ball(3, 0.4, (0, 0, 0))
    return _recenter(t, center, scale)


def _default_mesh(center, scale: float = 1.0) -> Topology:
    t = _asset("default_Tet 10.asset")
    if t is None:
        t = meshes.tet_cube(12, 12, 12, 0.8, (0, 0, 0))
    return _recenter(t, center, scale)


def _recenter(t: Topology, center, scale: float = 1.0) -> Topology:
    c = t.vertices.mean(axis=0)
    verts = (t.vertices - c) * np.float32(scale) + np.asarray(
        center, np.float32)
    return build_topology(verts, t.tets.astype(np.int64), edges=t.edges,
                          surface_tris=t.surface_tris, orient=False)


def _params(edge=0.9, vol=0.98, omega=1.4, radius=0.02, substeps=2, iters=6):
    return SolverParams(
        dialect="jacobi", substeps=substeps, iterations=iters,
        edge_stiffness=edge, volume_stiffness=vol, sor_omega=omega,
        particle_radius=radius, gravity=(0.0, -10.0, 0.0))


def _grid_positions(n: int, spacing: float = 0.9, height: float = 1.2):
    side = int(np.ceil(np.sqrt(n)))
    out = []
    for i in range(n):
        r, c = divmod(i, side)
        out.append(((c - side / 2) * spacing, height + 0.5 * (i % 3),
                    (r - side / 2) * spacing))
    return out


def _make_groups(specs):
    """specs: [(name, base_topo, offsets, params, density)]"""
    from ..parallel.groups import Group

    return [Group(t, offs, p, name=n, density=d)
            for n, t, offs, p, d in specs]


def sample_scene() -> Scene:
    p = _params(edge=0.7, vol=1.0, omega=1.4, radius=0.01)
    base = _bunny((0.0, 0.0, 0.0))
    return Scene(
        name="SampleScene",
        bodies=[("fumo", _bunny((0.0, 1.0, 0.0)), p, {"density": 0.2})],
        colliders=[Colliders.box((0.0, 0.1, 0.0), (0.6, 0.1, 0.6))],
        groups=_make_groups([("fumo", base, [(0.0, 1.0, 0.0)], p, 0.2)]),
    )


def four_body_test() -> Scene:
    p = _params()
    positions = _grid_positions(4, spacing=1.0)
    bodies = [(f"fumo{i}", _bunny(pos), p, {})
              for i, pos in enumerate(positions)]
    base = _bunny((0.0, 0.0, 0.0))
    return Scene(
        name="4fumoTest", bodies=bodies,
        colliders=[Colliders.box((0.0, 0.1, 0.0), (1.5, 0.1, 1.5))],
        groups=_make_groups([("fumo", base, positions, p, 1.0)]))


def extreme_test() -> Scene:
    p = _params(edge=0.5, vol=1.0)
    positions = _grid_positions(24, spacing=0.8, height=1.5)
    bodies = []
    for i, pos in enumerate(positions):
        if i < 16:
            bodies.append((f"ball{i}", _ball_small(pos), p, {}))
        else:
            bodies.append((f"cirno{i}", _bunny(pos), p, {}))
    return Scene(
        name="ExtremeTest", bodies=bodies,
        colliders=[Colliders.box((0.0, 0.1, 0.0), (2.5, 0.1, 2.5))],
        groups=_make_groups([
            ("ball", _ball_small((0, 0, 0)), positions[:16], p, 1.0),
            ("cirno", _bunny((0, 0, 0)), positions[16:], p, 1.0),
        ]))


def batch_test() -> Scene:
    """20 bodies: 10 icospheres + 10 "default" heavies (V = 8613 each with
    the reference's assets).

    Per-solver tunings and instance scales from BatchTest.unity: every
    solver uses edgeStiffness .493, volumeStiffness .98, sorOmega 1.4,
    particleRadius .01, density 1 (BatchTest.unity:992-999); balls are
    scaled x2, the default meshes x0.61614 (5) and x1.23228 (5), dropped
    from y 10-26 like the reference layout.
    """
    p = _params(edge=0.493, vol=0.98, radius=0.01)
    ball_pos = _grid_positions(10, spacing=5.0, height=6.0)
    small_pos = [(-30.0 + 16.0 * i, 12.0, -25.0) for i in range(5)]
    large_pos = [(-40.0 + 22.0 * i, 26.0, 25.0) for i in range(5)]
    bodies = [(f"ball{i}", _ball_small(pos, scale=2.0), p, {})
              for i, pos in enumerate(ball_pos)]
    bodies += [(f"big{i}", _default_mesh(pos, scale=0.61614), p, {})
               for i, pos in enumerate(small_pos)]
    bodies += [(f"big{i + 5}", _default_mesh(pos, scale=1.23228), p, {})
               for i, pos in enumerate(large_pos)]
    return Scene(
        name="BatchTest", bodies=bodies, colliders=[],
        groups=_make_groups([
            ("ball", _ball_small((0, 0, 0), scale=2.0), ball_pos, p, 1.0),
            ("big_s", _default_mesh((0, 0, 0), scale=0.61614), small_pos,
             p, 1.0),
            ("big_l", _default_mesh((0, 0, 0), scale=1.23228), large_pos,
             p, 1.0),
        ]))


ALL_SCENES = {
    "sample": sample_scene,
    "4fumo": four_body_test,
    "extreme": extreme_test,
    "batch": batch_test,
}
