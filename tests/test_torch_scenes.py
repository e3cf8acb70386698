"""The port's scene layer against the JAX package's, on the CPU: the merge
helpers and the four presets' topologies (array-equal), merged and
partitioned scenes, World, the grouped engine and DynamicMergedWorld.

Tolerances: a merged or partitioned scene against the JAX package's over
10 steps within 1e-4 m (the oracle parity contract; the two sides sum in
different fp32 orders); the port's merged scene against its own solo
Engines within 2e-5 m over 20 steps (the JAX tests' own bound); grouped
against per-body World before contact within 1e-4 m (the JAX test's).
State carried across a DynamicMergedWorld rebuild is array-equal.

The merged and partitioned checks start from a deformed state (every
position moved by N(0, 1 cm), the same draws on both sides), so every
constraint carries a correction from the first step and its stiffness or
compliance shows in the result; each solo check also swaps the bodies'
materials and requires the merged scene to move far outside its bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import softbodysim_tpu as jsbs
from softbodysim_tpu.api import scenes as jscenes
from softbodysim_tpu.core import adjacency as jadj
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core import topology as jtopo
from softbodysim_tpu.io import unity_assets as jassets

import softbodysim_torch as sbt
from softbodysim_torch.api import scenes
from softbodysim_torch.core import adjacency, meshes
from softbodysim_torch.core.topology import merge_topologies
from softbodysim_torch.io import unity_assets
from softbodysim_torch.io.from_jax import (params_from_fields,
                                           topology_from_fields)
from softbodysim_torch.perf import StepStats

DT = 1.0 / 60.0
JAX_TOL = 1e-4
SOLO_TOL = 2e-5
JITTER = 0.01          # m: the deformed start's position noise
# a swapped material must move the merged scene by this many of its bound
SWAP_FACTOR = 100.0


def _noise(n, seed):
    return np.random.default_rng(seed).normal(0.0, JITTER, (n, 3)).astype(
        np.float32)


def _deform(eng, noise):
    """Move an Engine's positions (x and x_star) by ``noise``: a port
    Engine, or the JAX package's (its state fields are jax arrays)."""
    s = eng.state
    if isinstance(s.x, torch.Tensor):
        x = s.x + torch.from_numpy(noise).to(s.x.device)
        eng.state = dataclasses.replace(s, x=x, x_star=x.clone())
    else:
        import jax.numpy as jnp

        x = s.x + jnp.asarray(noise)
        eng.state = dataclasses.replace(s, x=x, x_star=jnp.copy(x))


def _deform_parts(part):
    """Deform every program of a PartitionedSceneEngine (seeded by its
    index: the same draws for the port's and the JAX package's)."""
    for i, (eng, _, _) in enumerate(part.entries):
        _deform(eng, _noise(eng.topology.num_particles, 40 + i))


def _solo_start(solos, merged, voffs):
    """Each solo Engine starts from its body's slice of the merged start."""
    x = merged.state.x
    for i, solo in enumerate(solos):
        xi = x[voffs[i]:voffs[i + 1]].clone()
        solo.state = dataclasses.replace(solo.state, x=xi, x_star=xi.clone())


def assert_topology_equal(a, b):
    for f in ("vertices", "edges", "tets", "surface_tris", "edge_rest",
              "tet_rest_vol"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for fam in ("edge_colors", "tet_colors"):
        for g in ("idx", "mask", "order"):
            np.testing.assert_array_equal(
                getattr(getattr(a, fam), g), getattr(getattr(b, fam), g),
                err_msg=f"{fam}.{g}")


def _bodies(mod):
    """Three unlike bodies (tet cube, tet ball, cloth) of ``mod``'s meshes."""
    cloth, _ = mod.cloth_patch(3, 4, size=0.5, height=0.8)
    return [mod.tet_cube(2, 3, 2, size=0.4, center=(0.5, 0.6, 0.0)),
            mod.tet_ball(1, 0.2, (-0.5, 0.7, 0.0)), cloth]


# ---- host helpers ----------------------------------------------------------

def test_merge_topologies_matches_jax():
    got, voffs = merge_topologies(_bodies(meshes))
    want, jvoffs = jtopo.merge_topologies(_bodies(jmeshes))
    assert_topology_equal(got, want)
    np.testing.assert_array_equal(voffs, jvoffs)
    with pytest.raises(ValueError):
        merge_topologies([])


def test_combine_topologies_matches_jax():
    got, slices = adjacency.combine_topologies(_bodies(meshes))
    want, jslices = jadj.combine_topologies(_bodies(jmeshes))
    assert_topology_equal(got, want)
    assert slices == jslices


@pytest.mark.parametrize("kw", [dict(), dict(bending=False,
                                             pinned_corners=False)])
def test_cloth_patch_matches_jax(kw):
    got, pins = meshes.cloth_patch(5, 3, size=0.7, height=1.1, **kw)
    want, jpins = jmeshes.cloth_patch(5, 3, size=0.7, height=1.1, **kw)
    assert_topology_equal(got, want)
    np.testing.assert_array_equal(pins, jpins)
    assert got.num_tets == 0


def test_build_topology_explicit_edges_matches_jax():
    """Explicit edges and surface with orient=False (an asset's stored
    lists, scenes._recenter), and explicit edges with derived surface."""
    ball = meshes.tet_ball(1, 0.3)
    edges = ball.edges[::-1].copy()        # a stored order, not derived
    for kw in (dict(edges=edges, surface_tris=ball.surface_tris,
                    orient=False), dict(edges=edges)):
        got = sbt.build_topology(ball.vertices * 2.0, ball.tets, **kw)
        want = jsbs.build_topology(ball.vertices * 2.0, ball.tets, **kw)
        assert_topology_equal(got, want)


def test_topology_carried_from_jax_fields():
    jt = jmeshes.tet_cube(2, 2, 3, size=0.5)
    assert_topology_equal(topology_from_fields(jt),
                          meshes.tet_cube(2, 2, 3, size=0.5))


def test_unity_asset_parser_matches_jax(tmp_path):
    """A serialized SoftBodyTetMeshAsset (the reference's YAML layout) parses
    to the JAX parser's arrays and loads to the same Topology."""
    t = meshes.tet_cube(1, 1, 2, size=0.5)

    def blob(a):
        return np.asarray(a, "<u4").ravel().tobytes().hex()

    lines = ["MonoBehaviour:", "  vertices:"]
    lines += [f"  - {{x: {x!r}, y: {y!r}, z: {z!r}}}"
              for x, y, z in t.vertices.tolist()]
    lines += [f"  tetIds: {blob(t.tets)}", f"  edgeIds: {blob(t.edges)}",
              f"  surfaceTriIds: {blob(t.surface_tris)}"]
    path = tmp_path / "cube_Tet.asset"
    path.write_text("\n".join(lines) + "\n")
    got, want = (unity_assets.parse_tet_asset(str(path)),
                 jassets.parse_tet_asset(str(path)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert_topology_equal(unity_assets.load_tet_asset(str(path)),
                          jassets.load_tet_asset(str(path)))
    empty = tmp_path / "empty.asset"
    empty.write_text("MonoBehaviour:\n")
    with pytest.raises(ValueError):
        unity_assets.load_tet_asset(str(empty))


@pytest.mark.parametrize("preset", sorted(scenes.ALL_SCENES))
def test_preset_topologies_match_jax(preset):
    got, want = scenes.ALL_SCENES[preset](), jscenes.ALL_SCENES[preset]()
    assert got.name == want.name and got.colliders == want.colliders
    assert len(got.bodies) == len(want.bodies)
    for (n, t, p, kw), (jn, jt, jp, jkw) in zip(got.bodies, want.bodies):
        assert (n, kw) == (jn, jkw)
        assert p == params_from_fields(jp)
        assert_topology_equal(t, jt)
    for g, jg in zip(got.groups, want.groups):
        assert (g.name, g.density, g.count) == (jg.name, jg.density,
                                                jg.count)
        np.testing.assert_array_equal(g.offsets, jg.offsets)
        assert_topology_equal(g.topology, jg.topology)


# ---- merged and partitioned scenes -----------------------------------------

def _mixed_stiffness(mod, pmod):
    t1 = mod.tet_cube(2, 2, 2, size=0.4, center=(-0.6, 0.5, 0.0))
    t2 = mod.tet_cube(2, 2, 2, size=0.4, center=(0.6, 0.5, 0.0))
    return [("stiff", t1, pmod._params(edge=0.9, vol=0.98), {}),
            ("soft", t2, pmod._params(edge=0.3, vol=0.5), {})]


def _mixed_dialect(mod, pmod, params_cls):
    tj1 = mod.tet_cube(2, 2, 2, size=0.4, center=(-0.9, 0.6, 0.0))
    tj2 = mod.tet_cube(3, 2, 2, size=0.4, center=(0.0, 0.6, 0.0))
    tx1 = mod.tet_cube(2, 3, 2, size=0.4, center=(0.9, 0.6, 0.0))
    px = params_cls(dialect="xpbd", substeps=2, iterations=6)
    return [("j1", tj1, pmod._params(edge=0.9, vol=0.98), {}),
            ("x1", tx1, px, {}),
            ("j2", tj2, pmod._params(edge=0.3, vol=0.5), {})]


@pytest.fixture(scope="module")
def jax_scenes():
    """The JAX package's merged (mixed stiffness) and partitioned (mixed
    dialect) scenes, 10 steps each on its 'gather' backends from the
    deformed start."""
    eng, voffs = jscenes.Scene(
        name="mixed", colliders=[],
        bodies=_mixed_stiffness(jmeshes, jscenes)).build_merged(
            backend="gather")
    part = jscenes.Scene(
        name="mix", colliders=[],
        bodies=_mixed_dialect(jmeshes, jscenes,
                              jsbs.SolverParams)).build_partitioned(
            backend="gather")
    _deform(eng, _noise(eng.topology.num_particles, 30))
    _deform_parts(part)
    for _ in range(10):
        eng.step(DT)
        part.step(DT)
    return {"merged": (eng.positions(), voffs),
            "partitioned": part.positions()}


def test_merged_mixed_stiffness_matches_jax(jax_scenes):
    scene = scenes.Scene(name="mixed", colliders=[],
                         bodies=_mixed_stiffness(meshes, scenes))
    eng, voffs = scene.build_merged(backend="gather", device="cpu")
    assert eng.backend == "gather"
    assert eng._raw_step.edge_k is not None      # per-constraint tables
    _deform(eng, _noise(eng.topology.num_particles, 30))
    eng.run(10, DT)
    want, jvoffs = jax_scenes["merged"]
    np.testing.assert_array_equal(voffs, jvoffs)
    np.testing.assert_allclose(eng.positions(), want, rtol=0, atol=JAX_TOL)


def _merged_vs_solo(bodies, knob, backend, steps):
    """The merged scene and its solo Engines from the same deformed start,
    ``steps`` steps: (merged positions, [solo positions], voffs)."""
    eng, voffs = scenes.Scene(name="mixed", colliders=[],
                              bodies=bodies).build_merged(
        backend=backend, device="cpu")
    solos = [sbt.Engine(t, p.replace(**{knob: backend}), device="cpu")
             for _, t, p, _ in bodies]
    _deform(eng, _noise(eng.topology.num_particles, 31))
    _solo_start(solos, eng, voffs)
    for _ in range(steps):
        eng.step(DT)
        for s in solos:
            s.step(DT)
    return eng.positions(), [s.positions() for s in solos], voffs


def _check_merged_vs_solo(bodies, knob, backend, steps):
    """Each body of the merged scene within SOLO_TOL of its solo Engine;
    with the two bodies' materials swapped, the merged scene is at least
    SWAP_FACTOR x SOLO_TOL away from them (so the tables decide)."""
    pos, solo, voffs = _merged_vs_solo(bodies, knob, backend, steps)
    for i, want in enumerate(solo):
        np.testing.assert_allclose(pos[voffs[i]:voffs[i + 1]], want,
                                   rtol=0, atol=SOLO_TOL)
    (n0, t0, p0, k0), (n1, t1, p1, k1) = bodies
    swapped, _, _ = _merged_vs_solo([(n0, t0, p1, k0), (n1, t1, p0, k1)],
                                    knob, backend, steps)
    assert np.abs(swapped - pos).max() > SWAP_FACTOR * SOLO_TOL


def test_merged_mixed_stiffness_matches_solo():
    _check_merged_vs_solo(_mixed_stiffness(meshes, scenes),
                          "jacobi_backend", "gather", 20)


def _mixed_compliance():
    base = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=6)
    return [("stiff", meshes.tet_cube(3, 3, 3, size=0.4,
                                      center=(-0.6, 0.25, 0.0)),
             base.replace(edge_compliance=1e-4, volume_compliance=0.0), {}),
            ("soft", meshes.tet_cube(3, 3, 2, size=0.4,
                                     center=(0.6, 0.25, 0.0)),
             base.replace(edge_compliance=5e-3, volume_compliance=1e-3), {})]


def test_merged_mixed_compliance_sweep_matches_solo():
    """A mixed-compliance xpbd merge runs the sweep plans with edge_c /
    tet_c tables (their plain versions on the CPU): each body within
    SOLO_TOL of its solo 'sweep' Engine, which reads no table, over 10
    steps that reach the ground."""
    _check_merged_vs_solo(_mixed_compliance(), "xpbd_backend", "sweep", 10)


def test_sweep_plan_compliance_follows_constraints():
    """The sweep plans' per-constraint compliance, read back through the
    constraint each packed slot solves (its layout vertices mapped to the
    public constraint with the same vertices): every live slot holds that
    constraint's compliance, every pad slot 0."""
    from softbodysim_torch.solver.xpbd_sweep import SweepStep

    topo, _ = merge_topologies([t for _, t, _, _ in _mixed_compliance()])
    rng = np.random.default_rng(8)
    tables = {"edges": rng.uniform(1e-5, 1e-2, topo.num_edges),
              "tets": rng.uniform(1e-6, 1e-3, topo.num_tets)}
    step = SweepStep(topo, sbt.SolverParams(dialect="xpbd"), device="cpu",
                     edge_c=tables["edges"].astype(np.float32),
                     tet_c=tables["tets"].astype(np.float32))
    old2new = step._old2new.numpy()
    for fam, cons in (("edges", topo.edges), ("tets", topo.tets)):
        plan = step.gpu_plans[fam]
        public = {tuple(sorted(r)): i for i, r in enumerate(
            old2new[cons.astype(np.int64)].tolist())}
        live = plan.verts[:, 0] >= 0
        ids = [public[tuple(sorted(r))] for r in plan.verts[live].tolist()]
        assert sorted(ids) == list(range(len(cons)))
        np.testing.assert_array_equal(
            plan.atab[live], tables[fam].astype(np.float32)[ids])
        assert not plan.atab[~live].any()


def test_partitioned_mixed_dialect_matches_jax(jax_scenes):
    part = scenes.Scene(
        name="mix", colliders=[],
        bodies=_mixed_dialect(meshes, scenes,
                              sbt.SolverParams)).build_partitioned(
        backend="gather", device="cpu")
    assert part.num_programs == 2
    assert [e.backend for e, _, _ in part.entries] == ["gather", "gather"]
    _deform_parts(part)
    for _ in range(10):
        part.step(DT)
    pos, want = part.positions(), jax_scenes["partitioned"]
    assert set(pos) == set(want) == {"j1", "j2", "x1"}
    for name in pos:
        np.testing.assert_allclose(pos[name], want[name], rtol=0,
                                   atol=JAX_TOL, err_msg=name)


def test_merged_and_partitioned_errors():
    t = meshes.tet_cube(2, 2, 2)
    p = scenes._params()
    bad = [
        [("a", t, p, {}), ("b", t, scenes._params(omega=1.0), {})],
        [("a", t, p, {"density": 1.0}), ("b", t, p, {"density": 2.0})],
        [("a", t, p, {"pin_top_layer": True})],
    ]
    for bodies in bad:
        with pytest.raises(ValueError):
            scenes.Scene(name="bad", colliders=[],
                         bodies=bodies).build_merged(device="cpu")
    for build in ("build_merged", "build_partitioned"):
        with pytest.raises(ValueError):
            getattr(scenes.Scene(name="none", colliders=[], bodies=[]),
                    build)(device="cpu")
    with pytest.raises(ValueError):
        scenes.Scene(name="g", colliders=[], bodies=[]).build_grouped(
            device="cpu")
    # mixed compliance merges as edge_c / tet_c: the sweep backend only,
    # as in the JAX package
    px = sbt.SolverParams(dialect="xpbd")
    xs = scenes.Scene(name="x", colliders=[], bodies=[
        ("a", t, px, {}), ("b", t, px.replace(edge_compliance=1e-3), {})])
    with pytest.raises(ValueError, match="edge_c"):
        xs.build_merged(backend="gather", device="cpu")


def test_merged_carries_per_body_pinned():
    t1 = meshes.tet_cube(2, 2, 2, size=0.4, center=(-0.6, 1.0, 0.0))
    t2 = meshes.tet_cube(2, 2, 2, size=0.4, center=(0.6, 1.0, 0.0))
    p = scenes._params()
    eng, voffs = scenes.Scene(name="pin", colliders=[], bodies=[
        ("free", t1, p, {}), ("pinned", t2, p, {"pinned": [0, 1]})]
    ).build_merged(backend="gather", device="cpu")
    eng.run(8, DT)
    pos = eng.positions()
    np.testing.assert_allclose(pos[voffs[1]:voffs[1] + 2], t2.vertices[:2],
                               atol=1e-6)
    assert pos[:voffs[1], 1].min() < t1.vertices[:, 1].min() - 1e-3


def test_partitioned_solo_kwargs_body():
    t1 = meshes.tet_cube(2, 2, 2, size=0.4, center=(-0.6, 0.6, 0.0))
    t2 = meshes.tet_cube(2, 2, 2, size=0.4, center=(0.6, 0.6, 0.0))
    p = scenes._params()
    part = scenes.Scene(name="solo", colliders=[], bodies=[
        ("plain", t1, p, {}), ("pinned_top", t2, p, {"pin_top_layer": True})]
    ).build_partitioned(backend="gather", device="cpu")
    assert part.num_programs == 2
    part.run(10, DT)
    pos = part.positions()
    top = t2.vertices[:, 1] >= t2.vertices[:, 1].max() - 1e-6
    np.testing.assert_allclose(pos["pinned_top"][top], t2.vertices[top],
                               atol=1e-6)
    assert pos["plain"][:, 1].min() < t1.vertices[:, 1].min() - 1e-3


# ---- World and the grouped engine -------------------------------------------

def _world(**kw):
    w = sbt.World(fixed_dt=DT, device="cpu", **kw)
    w.register(sbt.Body(meshes.tet_cube(1, 1, 1, size=0.3),
                        sbt.SolverParams(substeps=1, iterations=2)))
    return w


def test_world_frame_accumulator():
    w = _world()
    assert w.frame(1.0 / 30.0) == 2          # two fixed steps
    assert w.frame(1.0 / 240.0) == 0         # accumulates without stepping
    assert sum(w.frame(1.0 / 240.0) for _ in range(3)) == 1


def test_world_frame_clamps_and_overflow_reset():
    w = _world(max_steps_per_frame=3, max_frame_delta_time=0.05)
    assert w.frame(10.0) == 3                # clamped, then capped
    assert w._accumulator == 0.0             # the cap resets it
    assert w.frame(1.0 / 240.0) == 0


def test_world_unregister_stats_and_collider_capacity():
    w = _world()
    b = w.bodies[0]
    engine0 = b.engine
    ids = [w.add_collider(sbt.Colliders.sphere((5.0, i, 0.0), 0.1))
           for i in range(3)]
    assert w.collider_capacity == 8 and b.engine is not engine0
    engine1 = b.engine
    w.remove_collider(ids[1])
    w.update_collider(ids[0], sbt.Colliders.sphere((6.0, 0.0, 0.0), 0.1))
    assert b.engine is engine1               # same capacity: no rebuild
    assert w.add_collider(sbt.Colliders.sphere((7, 0, 0), 0.1)) == ids[1]
    for i in range(6):
        w.add_collider(sbt.Colliders.sphere((8.0, i, 0.0), 0.1))
    assert w.collider_capacity == 16 and b.engine is not engine1
    w.step(block=True)
    x0 = b.positions().copy()
    w.unregister(b)
    w.step()
    np.testing.assert_array_equal(b.positions(), x0)
    assert "step=" in w.stats.report(prefix="[t]")
    st = StepStats()
    with st.scope("step"):
        pass
    st.add("pack", 0.001)
    line = st.report(prefix="[t]")
    assert line.startswith("[t]") and "pack=" in line and "%" in line
    assert st.count == 0 and not st.sums


def test_sample_scene_world_runs():
    world = scenes.sample_scene().build_world(device="cpu")
    for _ in range(20):
        world.step()
    pos = world.positions()["fumo"]
    assert np.isfinite(pos).all()
    assert pos[:, 1].min() < 1.0 - 0.3      # it fell


def test_grouped_matches_world_prefix():
    """Grouped and per-body execution agree before contact (the JAX
    test's protocol and bound)."""
    scene = scenes.four_body_test()
    grouped = scene.build_grouped(device="cpu")
    world = scene.build_world(device="cpu")
    for _ in range(8):
        grouped.step(DT)
        world.step()
    gpos = dict(grouped.positions())
    assert len(gpos) == 4
    for i, (_, pos) in enumerate(world.positions().items()):
        np.testing.assert_allclose(gpos[f"fumo#{i}"], pos, rtol=0,
                                   atol=1e-4)


def test_grouped_refuses_kernel_backends():
    """With the JAX package's words for its Pallas steps."""
    scene, jscene = scenes.four_body_test(), jscenes.four_body_test()
    for g in scene.groups + jscene.groups:
        g.params = g.params.replace(jacobi_backend="pallas")
    with pytest.raises(ValueError, match="cannot be vmapped") as got:
        scene.build_grouped(device="cpu")
    with pytest.raises(ValueError) as want:
        jscene.build_grouped()
    assert str(got.value) == str(want.value)


# ---- DynamicMergedWorld -----------------------------------------------------

def _cube(n=3, center=(0.0, 0.6, 0.0)):
    return meshes.tet_cube(n, n, n, size=0.4, center=center)


def test_dynamic_growth_carries_state_exactly():
    params = sbt.SolverParams(dialect="xpbd", substeps=2, iterations=4)
    w = sbt.DynamicMergedWorld(params, device="cpu")
    w.add_body("a", _cube(2))
    w.run(10, DT)
    xa, va = w.positions("a").copy(), w.velocities("a").copy()
    ea = w.engine.state.edge_lambda.clone()
    ref = sbt.DynamicMergedWorld(params, device="cpu")
    ref.add_body("a", _cube(2))
    ref.run(10, DT)

    w.add_body("b", _cube(2, center=(10.0, 0.6, 0.0)))
    np.testing.assert_array_equal(w.positions("a"), xa)
    np.testing.assert_array_equal(w.velocities("a"), va)
    na = w._bodies["a"].num_edges
    assert torch.equal(w.engine.state.edge_lambda[:na], ea)
    assert w.engine.topology.num_particles == (
        2 * _cube(2).num_particles)
    w.run(5, DT)
    ref.run(5, DT)
    np.testing.assert_allclose(w.positions("a"), ref.positions("a"),
                               rtol=0, atol=1e-5)
    assert np.isfinite(w.positions("b")).all()


def test_dynamic_removal_and_jacobi_growth():
    w = sbt.DynamicMergedWorld(sbt.SolverParams(dialect="xpbd", substeps=1,
                                                iterations=3),
                               device="cpu")
    w.add_body("a", _cube())
    w.add_body("b", _cube(2, center=(5.0, 0.6, 0.0)), pinned=[0])
    w.run(10, DT)
    xb = w.positions("b").copy()
    lam_b = w.engine.state.tet_lambda[_cube().num_tets:].clone()
    w.remove_body("a")
    np.testing.assert_array_equal(w.positions("b"), xb)
    assert torch.equal(w.engine.state.tet_lambda, lam_b)
    w.run(3, DT)
    np.testing.assert_array_equal(w.positions("b")[0], xb[0])   # pinned

    j = sbt.DynamicMergedWorld(sbt.SolverParams(dialect="jacobi",
                                                substeps=2, iterations=4),
                               device="cpu")
    j.add_body("a", _cube())
    j.run(5, DT)
    assert j.backend == "gather"
    xa = j.positions("a").copy()
    j.add_body("b", _cube(2, center=(4.0, 0.6, 0.0)))
    np.testing.assert_array_equal(j.positions("a"), xa)
    j.run(5, DT)
    assert np.isfinite(j.positions()).all()


def test_dynamic_names_and_empty():
    w = sbt.DynamicMergedWorld(sbt.SolverParams(), device="cpu")
    with pytest.raises(ValueError):
        w.step()
    w.add_body("a", _cube(2))
    with pytest.raises(ValueError):
        w.add_body("a", _cube(2))
    with pytest.raises(KeyError):
        w.remove_body("zz")


def test_scene_dataclass_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(scenes.Scene)]
            == [f.name for f in dataclasses.fields(jscenes.Scene)])
