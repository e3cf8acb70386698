"""The port's render layer against the JAX package's on the CPU: vertex
normals and skinning within 1e-6 (index_add_ against segment_sum, two fp32
summation orders), and the NumPy parts -- the embedding, UV transfer, the
HTML exports, the recorder and the OBJ writer -- identical, to the byte.
The live viewport serves its page and frames over HTTP."""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysim_tpu.render import embedding as jemb
from softbodysim_tpu.render import normals as jnormals
from softbodysim_tpu.render import uv_transfer as juv
from softbodysim_tpu.render import viewer as jviewer

import softbodysim_torch as sbt
from softbodysim_torch.core.tetrahedralize import topology_from_mesh
from softbodysim_torch.render import embedding as temb
from softbodysim_torch.render import normals as tnormals
from softbodysim_torch.render import uv_transfer as tuv
from softbodysim_torch.render import viewer as tviewer
from softbodysim_torch.render.live import LiveViewer

TOL = 1e-6


@pytest.fixture(scope="module")
def ball():
    """An icosphere's render surface embedded in its voxel sim mesh, and a
    deformed sim state (seeded)."""
    v, f = sbt.meshes.icosphere(2)
    v = (v * 0.3).astype(np.float32)
    topo = topology_from_mesh(v, f, resolution=6)
    rng = np.random.default_rng(0)
    x = (topo.vertices + rng.normal(0, 0.01, topo.vertices.shape)).astype(
        np.float32)
    return v, f, topo, x


def test_vertex_normals_match_jax(ball):
    _, _, topo, x = ball
    want = np.asarray(jnormals.vertex_normals(
        jnp.asarray(x), jnp.asarray(topo.surface_tris, jnp.int32)))
    got = tnormals.vertex_normals(torch.from_numpy(x),
                                  torch.from_numpy(topo.surface_tris))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    fn = tnormals.make_normals_fn(topo, device="cpu")
    torch.testing.assert_close(fn(torch.from_numpy(x)), got, rtol=0,
                               atol=0)
    # interior vertices touch no surface triangle: the (0, 1, 0) fallback
    inner = np.setdiff1d(np.arange(topo.num_particles), topo.surface_tris)
    np.testing.assert_array_equal(got.numpy()[inner], [[0, 1, 0]] * len(
        inner))
    empty = tnormals.vertex_normals(torch.from_numpy(x),
                                    torch.zeros((0, 3), dtype=torch.int64))
    np.testing.assert_array_equal(empty.numpy(), [[0, 1, 0]] * len(x))


def test_embedding_and_skinning_match_jax(ball):
    v, _, topo, x = ball
    j = jemb.embed_mesh(v, topo.vertices, topo.tets)
    t = temb.embed_mesh(v, topo.vertices, topo.tets)
    for field in ("tet_id", "bary", "inside"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    want = np.asarray(jemb.skin_positions(jnp.asarray(x), topo.tets, j))
    got = temb.skin_positions(torch.from_numpy(x), topo.tets, t)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(temb.skin_positions(x, topo.tets, t),
                                  jemb.skin_positions(x, topo.tets, j))
    _, skin = temb.embed_topology(v, None, topo)
    np.testing.assert_allclose(skin(topo.vertices), v, rtol=0, atol=1e-5)


def test_uv_transfer_identical(ball, tmp_path):
    v, f, topo, _ = ball
    rng = np.random.default_rng(1)
    uvs = rng.uniform(size=(len(v), 2)).astype(np.float32)
    perm = rng.permutation(len(v))
    for dst in (v, v[perm]):                         # exact, permuted
        np.testing.assert_array_equal(tuv.transfer_uvs(v, uvs, dst),
                                      juv.transfer_uvs(v, uvs, dst))
    with pytest.warns(RuntimeWarning):               # voxel mesh: nearest
        got = tuv.transfer_uvs(v, uvs, topo.vertices)
    with pytest.warns(RuntimeWarning):
        want = juv.transfer_uvs(v, uvs, topo.vertices)
    np.testing.assert_array_equal(got, want)
    normals = rng.normal(size=(len(v), 3))
    for mod, name in ((tuv, "t.obj"), (juv, "j.obj")):
        mod.write_obj_with_uvs(str(tmp_path / name), v, f, uvs, normals)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj"
                                                 ).read_bytes()


def test_html_exports_identical(ball, tmp_path):
    v, f, _, _ = ball
    rng = np.random.default_rng(2)
    frames = (v[None] + rng.normal(0, 0.01, (3,) + v.shape)).astype(
        np.float32)
    uvs = rng.uniform(size=(len(v), 2)).astype(np.float32)
    for mod, tag in ((tviewer, "t"), (jviewer, "j")):
        mod.export_html(str(tmp_path / f"{tag}.html"), frames, f,
                        title="rollout")
        mod.export_html_lit(str(tmp_path / f"{tag}_lit.html"), frames, f,
                            uvs, title="rollout (lit)")
        rec = mod.AnimationRecorder()
        rec.add_body(f, lambda: frames[0], uvs=uvs)
        rec.capture().capture()
        rec.export(str(tmp_path / f"{tag}_rec.html"), title="rec")
    for name in ("{}.html", "{}_lit.html", "{}_rec.html"):
        assert ((tmp_path / name.format("t")).read_bytes()
                == (tmp_path / name.format("j")).read_bytes()), name
    np.testing.assert_array_equal(tviewer.checker_texture(),
                                  jviewer.checker_texture())


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read(), dict(r.headers)


def test_live_viewer_page_and_frames():
    tris = np.array([[0, 1, 2], [1, 2, 3]], np.int64)
    pos = np.arange(12, dtype=np.float32).reshape(4, 3)
    lv = LiveViewer(tris, lambda: pos, port=0)
    try:
        page, _ = _get(lv.url)
        assert b"webgl2" in page and b"NV=4" in page
        body, hdr = _get(lv.url + "frame")
        assert hdr["X-Frame-Index"] == "1"
        np.testing.assert_array_equal(
            np.frombuffer(body, np.float32).reshape(4, 3), pos)
        lv.publish(pos + 1.0)
        body, hdr = _get(lv.url + "frame")
        assert hdr["X-Frame-Index"] == "2"
        np.testing.assert_array_equal(
            np.frombuffer(body, np.float32).reshape(4, 3), pos + 1.0)
        stats, _ = _get(lv.url + "stats")
        assert json.loads(stats) == {"frames": 2, "nv": 4}
    finally:
        lv.stop()


def test_serve_view_publishes_the_last_reply():
    """The PBD1 server with ``view=True`` (``serve --view``): the viewer's
    frame is the last reply, bit for bit."""
    from softbodysim_torch.api import PBDClient, PBDServer

    topo = sbt.meshes.tet_cube(2, 2, 2, size=0.5, center=(0.0, 0.8, 0.0))
    srv = PBDServer(port=0, verbose=False, view=True, view_port=0,
                    device="cpu").start_background().wait_ready()
    try:
        with PBDClient(port=srv.port) as cli:
            cli.init(topo.vertices, topo.edges, topo.tets)
            cli.step(1.0 / 60.0)
            last = cli.step(1.0 / 60.0)
        srv._thread.join(timeout=30.0)
        assert not srv._thread.is_alive()
        assert srv._viewer.frames_published == 2
        body, _ = _get(srv._viewer.url + "frame")
        np.testing.assert_array_equal(
            np.frombuffer(body, np.float32).reshape(-1, 3), last)
    finally:
        srv.stop()
