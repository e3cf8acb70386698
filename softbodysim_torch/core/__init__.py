"""Host-side core: topology, meshes, native library, state."""
