"""The port's last four public helpers against the JAX package's, and the
port's examples (``softbodysim_torch/examples/``) run on the CPU at a
small size.

- ``core/state.py::tet_signed_volume``, ``core/meshes.py::single_tet`` and
  ``load_obj_uv``, ``core/adjacency.py::build_tri_adjacency``: array-equal
  to the JAX functions (the OBJ has seams, quads and vertices without a
  ``vt``).
- Each example's ``main`` runs to its end with ``--device cpu`` and small
  ``--steps`` / ``--batch``, and the checks it makes hold:
  checkpoint_resume resumes bit for bit, fit_materials moves toward its
  target, moving_collider leaves no particle inside the capsule,
  mixed_dialect_world runs as two programs, multi_client serves every
  session on an ephemeral port, textured_fumo raises FileNotFoundError
  naming the path without the reference checkout.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysim_tpu.core import adjacency as jadj
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core import state as jstate

from softbodysim_torch.core import adjacency, meshes, state

TOPO_FIELDS = ("vertices", "edges", "tets", "edge_rest", "tet_rest_vol",
               "surface_tris", "edge_colors", "tet_colors")


# --------------------------------------------------------------------------
# The helpers
# --------------------------------------------------------------------------

def test_tet_signed_volume_array_equal():
    rng = np.random.default_rng(3)
    pts = [rng.normal(0.0, 1.0, (7, 64, 3)).astype(np.float32)
           for _ in range(4)]
    want = np.asarray(jstate.tet_signed_volume(*map(jnp.asarray, pts)))
    got = state.tet_signed_volume(*map(torch.from_numpy, pts))
    assert got.dtype == torch.float32 and got.shape == (7, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    # a right-handed unit corner: +1/6
    e = torch.eye(3)
    assert float(state.tet_signed_volume(torch.zeros(3), e[0], e[1],
                                         e[2])) == pytest.approx(1 / 6)


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_single_tet_array_equal(scale):
    want, got = jmeshes.single_tet(scale), meshes.single_tet(scale)
    for f in TOPO_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        if f.endswith("_colors"):          # ColorGroups(idx, mask)
            a, b = (a.idx, a.mask), (b.idx, b.mask)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f)
    assert got.num_tets == 1 and got.num_edges == 6


def _write_obj(path):
    """A unit square of two quads over 6 vertices: the middle edge is a
    seam (its vertices have two vt each, the first met wins), vertex 6 is
    referenced without a vt, vertex 7 by no face; and one vt index out of
    range."""
    path.write_text(
        "# seams and untextured corners\n"
        "v 0 0 0\nv 1 0 0\nv 2 0 0\nv 0 1 0\nv 1 1 0\nv 2 1 0\n"
        "v 3 0 0\nv 9 9 9\n"
        "vt 0.0 0.0\nvt 0.5 0.0\nvt 0.5 1.0\nvt 0.0 1.0\n"
        "vt 0.6 0.0\nvt 1.0 0.0\nvt 1.0 1.0\nvt 0.6 1.0\n"
        "f 1/1 2/2 5/3 4/4\n"
        "f 2/5/1 3/6/1 6/7/1 5/8/1\n"
        "f 3 7 6\n"
        "f 7/99 3/6 6\n")
    return str(path)


def test_load_obj_uv_array_equal(tmp_path):
    path = _write_obj(tmp_path / "seams.obj")
    want = jmeshes.load_obj_uv(path)
    got = meshes.load_obj_uv(path)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    v, f, uv = got
    assert v.shape == (8, 3) and f.shape == (6, 3)
    np.testing.assert_array_equal(uv[1], [0.5, 0.0])     # the first vt won
    np.testing.assert_array_equal(uv[6], [0.0, 0.0])     # no vt in range
    np.testing.assert_array_equal(uv[7], [0.0, 0.0])     # in no face


@pytest.mark.parametrize("case", ["ball", "random", "isolated"])
def test_build_tri_adjacency_array_equal(case):
    if case == "ball":
        topo = meshes.tet_ball(2)
        nv, tris = topo.num_particles, topo.surface_tris
    elif case == "random":
        nv = 40
        tris = np.random.default_rng(5).integers(0, nv, (200, 3))
    else:       # vertices in no triangle, and no triangle at all
        nv, tris = 9, np.zeros((0, 3), np.int64)
    want = jadj.build_tri_adjacency(nv, tris)
    got = adjacency.build_tri_adjacency(nv, tris)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


# --------------------------------------------------------------------------
# The examples, on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The examples' ops are tiny: one intra-op thread runs them as fast
    and leaves the host to the other workers' tests."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _main(name, *argv):
    import importlib

    mod = importlib.import_module(f"softbodysim_torch.examples.{name}")
    return mod.main([*argv, "--device", "cpu"])


def test_checkpoint_resume_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert _main("checkpoint_resume", "--steps", "4") == 0.0
    assert (tmp_path / "softbody_ckpt.npz").exists()


def test_datagen(tmp_path):
    out = tmp_path / "roll.npz"
    r = _main("datagen", "--batch", "6", "--steps", "3", "--out", str(out))
    assert r["scene_steps_per_s"] > 0 and r["projections_per_s"] > 0
    with np.load(out) as z:
        pos, ks = z["positions"], z["edge_stiffness"]
    assert pos.shape[:2] == (6, 3) and np.isfinite(pos).all()
    assert ks.shape == (6,) and ((ks >= 0.3) & (ks < 1.0)).all()
    # the scenes differ (jittered starts, sampled stiffness) and the seeded
    # generator repeats itself
    assert np.abs(pos[0] - pos[1]).max() > 1e-4
    again = _main("datagen", "--batch", "6", "--steps", "3")
    np.testing.assert_array_equal(again["positions"], pos[:, -1])


def test_drop_bodies(tmp_path):
    out = _main("drop_bodies", "--bodies", "2", "--steps", "8", "--out",
                str(tmp_path))
    assert sorted(out) == ["body0", "body1"]
    assert all(np.isfinite(p).all() for p in out.values())
    objs = sorted(os.listdir(tmp_path / "body0"))
    assert len(objs) == 2          # steps 0 and 4
    text = (tmp_path / "body0" / objs[0]).read_text()
    assert "\nvn " in text and "\nf " in text


def test_fit_materials_moves_toward_target():
    res = _main("fit_materials", "--steps", "2")
    assert res.losses[-1] < res.losses[0]
    assert res.params["edge_compliance"] < 3e-3       # from its 10x guess


def test_mixed_dialect_world_two_programs():
    programs, out = _main("mixed_dialect_world", "--steps", "4")
    assert programs == 2 and len(out) == 6
    assert all(np.isfinite(p).all() for p in out.values())


def test_mixed_materials():
    shapes = _main("mixed_materials", "--steps", "4")
    assert len(shapes) == 3
    assert all(np.isfinite(hw).all() for hw in shapes.values())


def test_moving_collider_pushes_out():
    out = _main("moving_collider", "--steps", "12")
    assert len(out) == 4 and all(np.isfinite(p).all() for p in out.values())
    # the capsule swept through: it moved the balls along x
    assert max(p[:, 0].mean() for p in out.values()) > 0.6


def test_multi_client():
    res = _main("multi_client", "--steps", "3")
    assert sorted(res) == [0, 1, 2]
    assert all(p.shape == (43, 3) and np.isfinite(p).all()
               for p in res.values())


def test_reference_scenes_export(tmp_path):
    html = tmp_path / "sample.html"
    steps, pos = _main("reference_scenes", "--scene", "sample", "--seconds",
                       "0.2", "--export", str(html), "--export-obj")
    assert steps >= 1 and html.exists()
    assert os.listdir(tmp_path / "sample_frames")
    assert all(np.isfinite(p).all() for p in pos.values())


def _write_fumo(root):
    """An icosphere render mesh with per-vertex UVs where the fumo would
    be in the reference checkout."""
    v, f = meshes.icosphere(2)
    uv = np.stack([np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi) + 0.5,
                   v[:, 1] * 0.5 + 0.5], 1)
    d = root / "Assets" / "Models"
    d.mkdir(parents=True)
    lines = [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in v]
    lines += [f"vt {a:.6f} {b:.6f}" for a, b in uv]
    lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in f + 1]
    (d / "cirno_low.obj").write_text("\n".join(lines) + "\n")


def test_textured_fumo(tmp_path, monkeypatch):
    monkeypatch.delenv("SOFTBODYSIM_REFERENCE", raising=False)
    with pytest.raises(FileNotFoundError, match="cirno_low.obj"):
        _main("textured_fumo")
    monkeypatch.setenv("SOFTBODYSIM_REFERENCE", str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError,
                       match=str(tmp_path / "nothing")):
        _main("textured_fumo")
    _write_fumo(tmp_path / "ref")
    monkeypatch.setenv("SOFTBODYSIM_REFERENCE", str(tmp_path / "ref"))
    out = tmp_path / "fumo.html"
    assert _main("textured_fumo", str(out), "2") == str(out)
    assert "Blinn-Phong" in out.read_text()
