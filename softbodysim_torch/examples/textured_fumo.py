"""Textured lit viewer: the cirno fumo, end to end.

Pipeline (the reference's render stack on the port):
  1. load the reference's cirno_low.obj render mesh WITH its UVs
     (``core/meshes.load_obj_uv``), from the reference checkout named by
     SOFTBODYSIM_REFERENCE (Assets/Models/cirno_low.obj);
  2. tetrahedralize it body-fitted (``core/tetrahedralize.
     topology_from_mesh``: voxel 5-tet + surface snap);
  3. embed the render mesh in the sim mesh (``render/embedding.py``,
     barycentric skinning, the reference's tet-embedding of the render
     mesh);
  4. drop it on the ground with the XPBD solver;
  5. export a playable single-file WebGL viewer with smooth per-frame
     normals and textured Blinn-Phong lighting (``render/viewer.py``; a
     procedural checker texture, since the reference ships only the
     texture's .meta).

    SOFTBODYSIM_REFERENCE=<checkout> python -m \
        softbodysim_torch.examples.textured_fumo [out.html] [steps] \
        [--device cuda]
"""

import argparse
import os

import numpy as np

from softbodysim_torch import Engine, SolverParams
from softbodysim_torch.core.meshes import load_obj_uv
from softbodysim_torch.core.tetrahedralize import topology_from_mesh
from softbodysim_torch.render.embedding import embed_topology
from softbodysim_torch.render.viewer import AnimationRecorder, checker_texture

OBJ = os.path.join("Assets", "Models", "cirno_low.obj")


def obj_path() -> str:
    """The render mesh in the reference checkout; FileNotFoundError naming
    the path when it is not there."""
    root = os.environ.get("SOFTBODYSIM_REFERENCE")
    path = os.path.join(root or "$SOFTBODYSIM_REFERENCE", OBJ)
    if root is None or not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: the fumo's render mesh is read from the reference "
            "checkout named by SOFTBODYSIM_REFERENCE")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="fumo_textured.html")
    ap.add_argument("steps", nargs="?", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rv, rf, ruv = load_obj_uv(obj_path())
    # normalize to ~1 m tall above the ground
    rv = rv - rv.min(0)
    rv = rv / max(1e-9, rv[:, 1].max())
    rv[:, 1] += 0.45

    topo = topology_from_mesh(rv, rf, resolution=16)
    print(f"sim mesh: V={topo.num_particles} E={topo.num_edges} "
          f"T={topo.num_tets}; render verts={len(rv)}")
    emb, skin = embed_topology(rv, rf, topo)
    print(f"embedding: {emb.inside_fraction * 100:.1f}% inside")

    eng = Engine(topo, SolverParams(dialect="xpbd", substeps=4,
                                    iterations=4,
                                    volume_compliance=1e-6),
                 device=args.device)
    rec = AnimationRecorder()
    rec.add_body(rf, lambda: np.asarray(
        skin(eng.positions_device()).cpu().numpy()), uvs=ruv)
    for _ in range(args.steps):
        eng.step(1.0 / 60.0)
        rec.capture()
    path = rec.export(args.out, fps=60, title="cirno fumo (textured)",
                      texture=checker_texture(256, 12))
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
