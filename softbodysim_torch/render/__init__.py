"""Rendering: vertex normals, the render-mesh embedding and skinning, UV
transfer, the playable HTML export (``viewer``) and the live browser
viewport (``live``)."""

from .normals import make_normals_fn, vertex_normals
from .uv_transfer import (transfer_uvs, transfer_uvs_nearest,
                          write_obj_with_uvs)
from .embedding import (MeshEmbedding, embed_mesh, embed_topology,
                        skin_positions)

__all__ = ["vertex_normals", "make_normals_fn", "transfer_uvs",
           "transfer_uvs_nearest", "write_obj_with_uvs", "MeshEmbedding",
           "embed_mesh", "embed_topology", "skin_positions"]
