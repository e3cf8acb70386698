"""``softbodysim_torch.perf``'s profiling on the CPU: the stage profiles
have the JAX package's names and keys (``softbodysim_tpu/perf/
profile.py``, run here on tet_cube(3)) with finite positive times, a
trace of an Engine's steps is summed by op and names the step's ops, and
``step_rate`` / ``window_ms`` time a CPU Engine.  These are host-clock
times of PyTorch's CPU kernels, no device metric; on the card the same
functions fence with CUDA events (chip_smoke.py, phase N).
"""

import glob
import math
import os

import pytest

from softbodysim_tpu import SolverParams as JParams
from softbodysim_tpu.core import meshes as jmeshes
from softbodysim_tpu.core.state import init_state as j_init_state
from softbodysim_tpu.perf import profile as jprofile

import softbodysim_torch as sbt
from softbodysim_torch import perf
from softbodysim_torch.perf.profile import window_ms

DT = 1.0 / 60.0
CUBE3 = dict(nx=3, ny=3, nz=3, size=0.5, center=(0.0, 0.6, 0.0))
STAGES = {"xpbd": ("profile_xpbd_stages", dict(dialect="xpbd")),
          "jacobi": ("profile_jacobi_stages",
                     dict(dialect="jacobi", particle_radius=0.02))}


def _finite_positive(values):
    return all(math.isfinite(v) and v > 0.0 for v in values)


@pytest.mark.parametrize("dialect", list(STAGES))
def test_stage_profiles_have_the_jax_keys(dialect):
    name, kw = STAGES[dialect]
    jtopo = jmeshes.tet_cube(**CUBE3)
    want = getattr(jprofile, name)(jtopo, JParams(**kw),
                                   j_init_state(jtopo), repeats=1)
    topo = sbt.meshes.tet_cube(**CUBE3)
    got = getattr(perf, name)(topo, sbt.SolverParams(**kw),
                              sbt.init_state(topo, device="cpu"), repeats=2)
    assert list(got) == list(want)
    assert _finite_positive(got.values()), got


def test_trace_summary_names_the_step_ops(tmp_path):
    eng = sbt.Engine(sbt.meshes.tet_cube(**CUBE3), sbt.SolverParams(
        dialect="xpbd", xpbd_backend="sweep"), device="cpu").run(1, DT)
    with perf.trace(str(tmp_path)) as log_dir:
        eng.run(2, DT)
    assert log_dir == str(tmp_path)
    assert len(glob.glob(os.path.join(log_dir, "trace-*.json"))) == 1
    top = perf.trace_summary(log_dir, top=10)
    assert len(top) == 10
    every = perf.trace_summary(log_dir, top=10_000)
    assert every[:10] == top
    durs = [d for d, _ in every]
    assert durs == sorted(durs, reverse=True) and _finite_positive(durs)
    names = {n for _, n in every}
    # the CPU trace holds no device work: the host's operators, among
    # them the plain sweeps' scatter of corrections
    assert all(n.startswith("aten::") for n in names), names
    assert "aten::index_add_" in names


def test_step_rate_and_window_on_a_cpu_engine(capsys):
    eng = sbt.Engine(sbt.meshes.tet_cube(**CUBE3), sbt.SolverParams(
        dialect="xpbd", xpbd_backend="sweep"), device="cpu")
    r = perf.step_rate(lambda e, dt: e.step(dt), eng, DT, steps=4,
                       warmup=1)
    assert set(r) == {"steps_per_sec", "ms_per_step"}
    assert _finite_positive(r.values())
    assert math.isclose(r["steps_per_sec"] * r["ms_per_step"], 1e3,
                        rel_tol=1e-9)
    ms = window_ms(eng.backend, lambda n: eng.run(n, DT), 2)
    assert _finite_positive([ms])
    assert capsys.readouterr().out.startswith(
        "sweep: ms/step in 3 windows of 2 steps: ")
