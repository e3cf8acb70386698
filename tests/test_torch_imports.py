"""The port imports neither jax nor the JAX package.  Checked by scanning
the sources (this test process has jax imported already, so sys.modules
proves nothing)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "softbodysim_tpu"}
PORT_FILES = sorted((ROOT / "softbodysim_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
EXAMPLES = ("checkpoint_resume", "datagen", "drop_bodies", "fit_materials",
            "mixed_dialect_world", "mixed_materials", "moving_collider",
            "multi_client", "reference_scenes", "textured_fumo")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("softbodysim_torch/kernels/sweep.py",
                 "softbodysim_torch/kernels/jacobi.py",
                 "softbodysim_torch/kernels/jacobi_plan.py",
                 "softbodysim_torch/kernels/collide.py",
                 "softbodysim_torch/diff.py",
                 "softbodysim_torch/collide/primitives.py",
                 "softbodysim_torch/core/adjacency.py",
                 "softbodysim_torch/solver/accel.py",
                 "softbodysim_torch/solver/graphs.py",
                 "softbodysim_torch/solver/jacobi.py",
                 "softbodysim_torch/solver/jacobi_pass.py",
                 "softbodysim_torch/solver/xpbd_sweep.py",
                 "softbodysim_torch/api/engine.py",
                 "softbodysim_torch/api/world.py",
                 "softbodysim_torch/api/scenes.py",
                 "softbodysim_torch/api/dynamic.py",
                 "softbodysim_torch/parallel/batching.py",
                 "softbodysim_torch/parallel/groups.py",
                 "softbodysim_torch/parallel/hetero.py",
                 "softbodysim_torch/perf/timing.py",
                 "softbodysim_torch/perf/convergence.py",
                 "softbodysim_torch/io/unity_assets.py",
                 "softbodysim_torch/io/from_jax.py",
                 "softbodysim_torch/io/checkpoint.py",
                 "softbodysim_torch/io/export.py",
                 "softbodysim_torch/io/topology_store.py",
                 "softbodysim_torch/solver/spatial.py",
                 "softbodysim_torch/solver/surface_collide.py",
                 "softbodysim_torch/solver/contact.py",
                 "softbodysim_torch/core/tetrahedralize.py",
                 "softbodysim_torch/utils/config.py",
                 "softbodysim_torch/utils/trees.py",
                 "softbodysim_torch/api/protocol.py",
                 "softbodysim_torch/api/client.py",
                 "softbodysim_torch/api/server.py",
                 "softbodysim_torch/api/watchdog.py",
                 "softbodysim_torch/api/native_server.py",
                 "softbodysim_torch/render/__init__.py",
                 "softbodysim_torch/render/live.py",
                 "softbodysim_torch/render/normals.py",
                 "softbodysim_torch/render/embedding.py",
                 "softbodysim_torch/render/uv_transfer.py",
                 "softbodysim_torch/render/viewer.py",
                 "softbodysim_torch/parallel/collectives.py",
                 "softbodysim_torch/parallel/sharding.py",
                 "softbodysim_torch/parallel/constraint.py",
                 "softbodysim_torch/parallel/vertex.py",
                 "softbodysim_torch/solver/global_stages.py",
                 "softbodysim_torch/solver/xpbd_sweep_sharded.py",
                 "softbodysim_torch/solver/jacobi_pass_sharded.py",
                 "softbodysim_torch/core/fixed.py",
                 "softbodysim_torch/__main__.py",
                 "softbodysim_torch/entry.py",
                 *(f"softbodysim_torch/examples/{m}.py" for m in EXAMPLES),
                 "chip_smoke.py"):
        assert must in names
    # and the scan does catch an import
    assert "jax" in set(_imported_roots(ROOT / "softbodysim_tpu"
                                        / "core" / "state.py"))


def test_remote_session_script_imports_no_jax():
    """The shell example's embedded client imports the port only."""
    import re

    text = (ROOT / "softbodysim_torch" / "examples"
            / "remote_session.sh").read_text()
    roots = {m.group(1).split(".")[0] for m in re.finditer(
        r"^\s*(?:from|import)\s+([\w.]+)", text, re.M)}
    assert "softbodysim_torch" in roots
    assert not roots & FORBIDDEN
    assert "softbodysim_tpu" not in text and "JAX_PLATFORMS" not in text
