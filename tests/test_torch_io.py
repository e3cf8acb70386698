"""IO and the mesh pipeline of the port against the JAX package on the
CPU: checkpoints (exact resume on every backend, files read across the two
packages), params JSON, OBJ text, rollouts, topology files, the voxel
tetrahedralizer (native and NumPy paths) and the tree accounting.

Tolerances: none -- resume is bit for bit, and every file, string and
array equals the JAX package's (the same NumPy code on the same inputs).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import softbodysim_tpu as sbs
from softbodysim_tpu.core import native as jnative
from softbodysim_tpu.core import tetrahedralize as jtet
from softbodysim_tpu.io import checkpoint as jck
from softbodysim_tpu.io import export as jexp
from softbodysim_tpu.io import topology_store as jts
from softbodysim_tpu.utils import config as jcfg
from softbodysim_tpu.utils import trees as jtrees

import softbodysim_torch as sbt
from softbodysim_torch.core import native as tnative
from softbodysim_torch.core import tetrahedralize as ttet
from softbodysim_torch.core.adjacency import combine_topologies
from softbodysim_torch.io import checkpoint as tck
from softbodysim_torch.io import export as texp
from softbodysim_torch.io import topology_store as tts
from softbodysim_torch.io.from_jax import state_to_numpy
from softbodysim_torch.solver.xpbd_sweep import Carry
from softbodysim_torch.utils import config as tcfg
from softbodysim_torch.utils import trees as ttrees

DT = 1.0 / 60.0
FIELDS = ("x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")
CONTACT = dict(particle_radius=0.02, self_collision=True,
               self_collision_cell=0.05, self_collision_max_per_cell=0,
               surface_collision=True, surface_thickness=0.02)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tiny scenes run fastest on one core: under a parallel test
    run, torch's intra-op threads would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    lo = sbt.meshes.tet_cube(3, 3, 3, size=0.3, center=(0.0, 0.15, 0.0))
    hi = sbt.meshes.tet_cube(3, 3, 3, size=0.3, center=(0.037, 0.46, 0.023))
    return combine_topologies([lo, hi])[0]


RESUME_CASES = [("xpbd", "gather"), ("xpbd", "sweep"), ("jacobi", "gather"),
                ("jacobi", "segment"), ("jacobi", "pass")]


@pytest.mark.parametrize("dialect,backend", RESUME_CASES)
def test_checkpoint_resume_exact(dialect, backend, tmp_path):
    """Save at step 3 (the Engine's public state: lambdas unpacked to
    public order), load into a fresh Engine, step 3 more: the same bits as
    6 uninterrupted steps, contact on."""
    topo = _pair()
    knob = "xpbd_backend" if dialect == "xpbd" else "jacobi_backend"
    params = sbt.SolverParams(dialect=dialect, substeps=2, iterations=3,
                              **CONTACT, **{knob: backend})
    a = sbt.Engine(topo, params, device="cpu")
    for _ in range(3):
        a.step(DT)
    path = str(tmp_path / "ck.npz")
    tck.save_state(path, a.state, params, metadata={"step": 3})
    for _ in range(3):
        a.step(DT)
    state, meta = tck.load_state(path, device="cpu")
    assert meta["step"] == 3
    b = sbt.Engine(topo, tck.params_from_metadata(meta).replace(
        **CONTACT, **{knob: backend}), device="cpu")
    assert b.backend == backend
    b.state = state
    for _ in range(3):
        b.step(DT)
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    if dialect == "xpbd":
        assert a.state.edge_lambda.abs().max() > 0


def _jax_state(seed):
    topo = sbs.meshes.tet_cube(2, 2, 2)
    s = sbs.init_state(topo)
    rng = np.random.default_rng(seed)
    return sbs.SimState(**{f: jnp.asarray(rng.normal(size=np.shape(
        getattr(s, f))).astype(np.float32)) for f in FIELDS})


PARAMS = dict(substeps=3, iterations=5, dialect="jacobi", friction=0.4,
              gravity=(0.0, -10.0, 0.5), ground_y=0.1, sor_omega=1.2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_load(writer, tmp_path):
    js = _jax_state(7)
    arrays = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    path = str(tmp_path / "ck.npz")
    meta_in = {"scene": "cube", "step": 12}
    if writer == "jax":
        jck.save_state(path, js, sbs.SolverParams(**PARAMS), meta_in)
        state, meta = tck.load_state(path, device="cpu")
        got = state_to_numpy(state)
        assert tck.params_from_metadata(meta) == sbt.SolverParams(**PARAMS)
    else:
        tck.save_state(path, sbt.SimState(**{
            f: torch.from_numpy(a.copy()) for f, a in arrays.items()}),
            sbt.SolverParams(**PARAMS), meta_in)
        state, meta = jck.load_state(path, device_put=False)
        got = {f: getattr(state, f) for f in FIELDS}
        assert jck.params_from_metadata(meta) == sbs.SolverParams(**PARAMS)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], arrays[f])
    assert meta["scene"] == "cube" and meta["step"] == 12
    # the same metadata JSON from both writers
    other = str(tmp_path / "other.npz")
    (tck.save_state(other, state, sbt.SolverParams(**PARAMS), meta_in)
     if writer == "jax" else
     jck.save_state(other, js, sbs.SolverParams(**PARAMS), meta_in))
    with np.load(path) as z1, np.load(other) as z2:
        assert bytes(z1["__meta__"]) == bytes(z2["__meta__"])


def test_load_state_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    jck.save_state(path, _jax_state(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tck.load_state(path)


def test_params_json_equal_to_jax(tmp_path):
    tp = sbt.SolverParams(**PARAMS, self_collision=True,
                          xpbd_block_omega=(1.5, 2.2))
    jp = sbs.SolverParams(**PARAMS, self_collision=True,
                          xpbd_block_omega=(1.5, 2.2))
    text = tcfg.params_to_json(tp)
    assert text == jcfg.params_to_json(jp)
    path = str(tmp_path / "p.json")
    jcfg.params_to_json(jp, path)
    assert tcfg.params_from_json(path) == tcfg.params_from_json(text)
    assert jcfg.params_from_json(tcfg.params_to_json(tp)) == \
        jcfg.params_from_json(text)
    with pytest.raises(ValueError, match="unknown"):
        tcfg.params_from_json('{"warp": 1}')


def test_obj_text_and_sequences_equal_to_jax(tmp_path):
    topo = sbt.meshes.tet_cube(2, 2, 2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(topo.num_particles, 3)).astype(np.float32)
    n = rng.normal(size=x.shape).astype(np.float32)
    for normals in (None, n):
        a, b = str(tmp_path / "a.obj"), str(tmp_path / "b.obj")
        texp.write_obj(a, torch.from_numpy(x), topo.surface_tris,
                       None if normals is None else torch.from_numpy(normals))
        jexp.write_obj(b, x, topo.surface_tris, normals)
        assert open(a).read() == open(b).read()
    tw = texp.ObjSequenceWriter(str(tmp_path / "t"), topo.surface_tris)
    jw = jexp.ObjSequenceWriter(str(tmp_path / "j"), topo.surface_tris)
    for k in range(2):
        pa, pb = tw.append(torch.from_numpy(x + k)), jw.append(x + k)
        assert os.path.basename(pa) == os.path.basename(pb)
        assert open(pa).read() == open(pb).read()


def test_rollouts_equal_to_jax(tmp_path):
    rng = np.random.default_rng(4)
    frames = [rng.normal(size=(10, 3)).astype(np.float32) for _ in range(4)]
    seeds = np.arange(3, dtype=np.int32)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    texp.save_rollout(a, [torch.from_numpy(f) for f in frames],
                      seeds=torch.from_numpy(seeds))
    jexp.save_rollout(b, frames, seeds=seeds)
    ta, jb = texp.load_rollout(a), jexp.load_rollout(b)
    assert sorted(ta) == sorted(jb) == ["positions", "seeds"]
    for k in ta:
        assert ta[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(ta[k], jb[k])
    np.testing.assert_array_equal(jexp.load_rollout(a)["positions"],
                                  np.stack(frames))


def _topo_arrays(t):
    return {k: np.asarray(getattr(t, k)) for k in (
        "vertices", "edges", "tets", "surface_tris", "edge_rest",
        "tet_rest_vol")} | {
        f"{fam}.{k}": np.asarray(getattr(getattr(t, fam), k))
        for fam in ("edge_colors", "tet_colors")
        for k in ("idx", "mask", "order")}


def _assert_same_topology(a, b):
    ta, tb = _topo_arrays(a), _topo_arrays(b)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_topology_files_cross_load(writer, tmp_path):
    jt = sbs.meshes.tet_ball(1, 0.3)
    tt = sbt.meshes.tet_ball(1, 0.3)
    path = str(tmp_path / "t.tet.npz")
    (jts.save_topology if writer == "jax" else tts.save_topology)(
        path, jt if writer == "jax" else tt)
    _assert_same_topology(tts.load_topology(path), jts.load_topology(path))
    other = str(tmp_path / "o.tet.npz")
    (tts.save_topology if writer == "jax" else jts.save_topology)(
        other, tt if writer == "jax" else jt)
    with np.load(path) as z1, np.load(other) as z2:
        assert sorted(z1.files) == sorted(z2.files)
        for k in z1.files:
            assert z1[k].dtype == z2[k].dtype
            np.testing.assert_array_equal(z1[k], z2[k])


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_topology_from_mesh_matches_jax(path, monkeypatch):
    """A closed icosphere at resolution 8 through the whole pipeline
    (voxelize, snap, build): array-equal to the JAX package's, on the
    native library and on the NumPy fallback."""
    verts, faces = sbs.meshes.icosphere(2)
    if path == "numpy":
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "native_voxelize",
                                lambda *a: None)
    else:
        assert tnative.get_lib() is not None, "the native library builds"
        v, t = tnative.native_voxelize(verts, faces, 0.25)
        jv, jt = jnative.native_voxelize(verts, faces, 0.25)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(t, jt)
    _assert_same_topology(ttet.topology_from_mesh(verts, faces, resolution=8),
                          jtet.topology_from_mesh(verts, faces,
                                                  resolution=8))
    v, t = ttet.voxelize_numpy(verts, faces, 0.25)
    jv, jt = jtet.voxelize_numpy(verts, faces, 0.25)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


def test_topology_from_obj_matches_jax(tmp_path):
    verts, faces = sbs.meshes.icosphere(1)
    path = str(tmp_path / "s.obj")
    jexp.write_obj(path, verts, faces)
    _assert_same_topology(
        ttet.topology_from_obj(path, resolution=6, snap=False),
        jtet.topology_from_obj(path, resolution=6, snap=False))


def test_tree_accounting():
    topo = sbt.meshes.tet_cube(2, 2, 2)
    ts = sbt.init_state(topo, device="cpu")
    js = sbs.init_state(sbs.meshes.tet_cube(2, 2, 2))
    assert ttrees.tree_bytes(ts) == jtrees.tree_bytes(js)
    carry = Carry(xw=torch.zeros(8, 4), xp=torch.zeros(8, 3),
                  vv=torch.zeros(8, 3), lam_e=torch.zeros(5),
                  lam_t=torch.zeros(2, dtype=torch.float64), w_e=None,
                  w_t=None)
    assert ttrees.tree_bytes(carry) == 4 * (32 + 24 + 24 + 5) + 8 * 2
    text = ttrees.tree_summary({"carry": carry, "n": 3})
    assert "['carry'].xw: float32 (8, 4)" in text
    assert "['carry'].lam_t: float64 (2,)" in text
    assert "['n']: 3" in text
    assert text.endswith(f"total: {ttrees.tree_bytes(carry) / 1e6:.2f} MB")
    assert ttrees.tree_summary(ts).splitlines()[0] == \
        f".x: float32 ({topo.num_particles}, 3)"
