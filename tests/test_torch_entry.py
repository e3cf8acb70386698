"""The port's entry hooks (``softbodysim_torch/entry.py``) on the CPU,
against the JAX package's ``__graft_entry__.py``.

- ``entry(device="cpu")`` against ``__graft_entry__.entry()`` under
  ``jax.jit``: positions within 1e-4 m after 1 and 10 steps.
- ``dryrun_multichip(2, device="cpu")`` (two gloo ranks, a (1, 2) mesh):
  each of the six modes against the same mode computed by the JAX
  functions on two devices of the 8-device virtual CPU mesh
  (tests/conftest.py), at the tolerance the mode has in
  tests/test_torch_sharded*.py: the constraint-parallel and the
  kernel-sharded modes 1e-5 m, the vertex-sharded modes with colliders and
  contact 2e-5 m.
- ``dryrun_multichip(4, device="cpu")`` (a (2, 2) mesh): every mode
  finite, and every value a mode replicates (the gathered batch, the
  gathered positions) the same bits on every rank.
- Without a card, ``entry()`` and ``dryrun_multichip(n)`` raise; NCCL on
  the CPU raises.

The JAX references run in processes of their own (the pattern of
tests/test_torch_sharded.py), while the port's ranks run.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from softbodysim_torch.entry import MODES, dryrun_multichip, entry

DT = np.float32(1.0 / 60.0)
TOL = {"jacobi_mesh": 1e-5, "xpbd_mesh": 1e-5, "jacobi_vertex": 2e-5,
       "xpbd_vertex": 2e-5, "xpbd_sweep_sharded": 1e-5,
       "jacobi_pass_sharded": 1e-5}
ENTRY_TOL = 1e-4
ENTRY_STEPS = (1, 10)


# --------------------------------------------------------------------------
# The JAX references: __graft_entry__.py's modes on two devices, returning
# the positions its asserts look at
# --------------------------------------------------------------------------

def _jax_setup():
    from jax.sharding import Mesh

    from softbodysim_tpu import SolverParams
    from softbodysim_tpu.collide.primitives import Colliders
    from softbodysim_tpu.core import meshes
    from softbodysim_tpu.parallel import make_mesh

    n = 2
    devices = jax.devices()[:n]
    model = 2 if n % 2 == 0 and n > 1 else 1
    return dict(
        mesh=make_mesh(shape=(n // model, model), devices=devices),
        vmesh=Mesh(np.asarray(devices), axis_names=("model",)),
        topo=meshes.tet_cube(2, 2, 2, center=(0.0, 0.5, 0.0)),
        ptopo=meshes.tet_cube(7, 7, 7, size=0.7, center=(0.0, 0.8, 0.0)),
        batch=max(2, 2 * (n // model)),
        params=SolverParams(dialect="jacobi", substeps=1, iterations=2),
        xparams=SolverParams(dialect="xpbd", substeps=1, iterations=2),
        cols=Colliders.build([Colliders.sphere((0.0, 0.1, 0.0), 0.15)]))


def _ref_mesh():
    from softbodysim_tpu.parallel import (init_batch_state,
                                          make_mesh_sharded_step,
                                          make_xpbd_sharded_step,
                                          shard_batch)

    s = _jax_setup()
    step = jax.jit(make_mesh_sharded_step(s["topo"], s["params"],
                                          s["mesh"]))
    st = shard_batch(init_batch_state(s["topo"], s["batch"],
                                      inv_mass_mode="density"),
                     s["mesh"], axis="data")
    out = {"jacobi_mesh": np.asarray(step(st, DT).x)}
    xstep = make_xpbd_sharded_step(s["topo"], s["xparams"], s["mesh"])
    out["xpbd_mesh"] = np.asarray(jax.jit(xstep)(
        xstep.build_state(batch=s["batch"]), DT).x)
    return out


def _ref_vertex():
    from softbodysim_tpu.core.state import init_state
    from softbodysim_tpu.parallel import (make_vertex_sharded_step,
                                          make_xpbd_vertex_sharded_step)

    s = _jax_setup()
    vstep = make_vertex_sharded_step(
        s["topo"], s["params"].replace(self_collision=True,
                                       self_collision_cell=0.2,
                                       self_collision_max_per_cell=16),
        s["vmesh"], colliders=s["cols"])
    out = {"jacobi_vertex": vstep.unpad(jax.jit(vstep)(vstep.build_state(),
                                                       DT)[0])}
    xvstep = make_xpbd_vertex_sharded_step(
        s["topo"], s["xparams"].replace(surface_collision=True,
                                        surface_thickness=0.02,
                                        surface_collision_max_per_cell=8),
        s["vmesh"], axis="model")
    out["xpbd_vertex"] = np.asarray(jax.jit(xvstep)(
        init_state(s["topo"], inv_mass_mode="tet"), DT).x)
    return out


def _ref_sweep():
    from softbodysim_tpu.core.state import init_state
    from softbodysim_tpu.solver.xpbd_pallas_sharded import (
        make_xpbd_pallas_sharded_step)

    s = _jax_setup()
    step = make_xpbd_pallas_sharded_step(s["ptopo"], s["xparams"],
                                         s["vmesh"], colliders=s["cols"])
    return {"xpbd_sweep_sharded": np.asarray(step(init_state(s["ptopo"]),
                                                  DT).x)}


def _ref_pass():
    from softbodysim_tpu.core.state import init_state
    from softbodysim_tpu.solver.jacobi_pallas_sharded import (
        make_jacobi_pallas_sharded_step)

    s = _jax_setup()
    step = make_jacobi_pallas_sharded_step(s["ptopo"], s["params"],
                                           s["vmesh"])
    return {"jacobi_pass_sharded": np.asarray(step(init_state(
        s["ptopo"], inv_mass_mode="density"), DT).x)}


def _ref_entry():
    import __graft_entry__

    fn, (state, dt) = __graft_entry__.entry()
    step = jax.jit(fn)
    out = {}
    for n in range(1, max(ENTRY_STEPS) + 1):
        state = step(state, dt)
        if n in ENTRY_STEPS:
            out[n] = np.asarray(state.x)
    return out


REFS = {"mesh": _ref_mesh, "vertex": _ref_vertex, "sweep": _ref_sweep,
        "pass": _ref_pass, "entry": _ref_entry}
# the reference that computes each mode
REF_OF = {"jacobi_mesh": "mesh", "xpbd_mesh": "mesh",
          "jacobi_vertex": "vertex", "xpbd_vertex": "vertex",
          "xpbd_sweep_sharded": "sweep", "jacobi_pass_sharded": "pass"}


def _reference(name):
    # the compiles are the file's heaviest CPU work: they yield the CPU
    # to the tests that other workers run beside them
    os.nice(10)
    return REFS[name]()


class _Background:
    """The JAX references (a process each) and the port's dry runs at two
    and four ranks (one after another on a thread), started when the
    module's first test runs."""

    def __init__(self):
        import multiprocessing

        self._pool = multiprocessing.get_context("spawn").Pool(len(REFS))
        self._refs = {n: self._pool.apply_async(_reference, (n,))
                      for n in REFS}
        self._out, self._err = {}, []

        def work():
            try:
                for n in (2, 4):
                    self._out[n] = dryrun_multichip(n, device="cpu",
                                                    timeout_s=240.0)
            except Exception as e:                # noqa: BLE001
                self._err.append(e)       # raised again by dryrun()

        self._thread = threading.Thread(target=work)
        self._thread.start()

    def dryrun(self, n):
        self._thread.join()
        if self._err:
            raise self._err[0]
        return self._out[n]

    def ref(self, name):
        return self._refs[name].get(timeout=240)

    def close(self):
        self._thread.join()
        self._pool.terminate()
        self._pool.join()


@pytest.fixture(scope="module")
def bg():
    # one intra-op thread in every process this module starts (the ranks'
    # ops are tiny): the host stays shared with the other workers' tests
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        b = _Background()
        yield b
        b.close()
    finally:
        if saved is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = saved


def test_entry_matches_jax_entry(bg):
    fn, (state, dt) = entry(device="cpu")
    assert state.x.device.type == "cpu" and dt == DT
    ref = bg.ref("entry")
    x0 = state.x.numpy().copy()
    for n in range(1, max(ENTRY_STEPS) + 1):
        state = fn(state, dt)
        if n in ENTRY_STEPS:
            np.testing.assert_allclose(state.x.numpy(), ref[n], rtol=0,
                                       atol=ENTRY_TOL)
    assert state.x.shape == (343, 3)
    # it fell: the comparison saw the step act
    assert (x0[:, 1] - state.x.numpy()[:, 1]).min() > 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_dryrun_two_ranks_matches_jax(bg, mode):
    got = bg.dryrun(2)["positions"][mode]
    want = bg.ref(REF_OF[mode])[mode]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[mode])


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_modes_finite_and_replicated(bg, world):
    res = bg.dryrun(world)
    assert set(res["positions"]) == set(MODES)
    assert len(res["ranks"]) == world == len(res["launches"])
    batch = max(2, 2 * (world // 2))
    for mode, x in res["positions"].items():
        assert np.isfinite(x).all(), mode
        if mode.endswith("_mesh"):      # the whole batch, gathered
            assert x.shape == (batch, 27, 3)
        for r in res["ranks"][1:]:
            np.testing.assert_array_equal(r[mode], x, err_msg=mode)
    # the plain versions ran: no kernel launch is counted on the CPU
    assert all(not n for r in res["launches"] for n in r.values())


def test_dryrun_single_rank_runs_every_mode():
    res = dryrun_multichip(1, device="cpu", timeout_s=120.0)
    assert set(res["positions"]) == set(MODES)
    assert all(np.isfinite(x).all() for x in res["positions"].values())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
def test_hooks_need_the_card_without_a_device():
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_multichip(1)
    with pytest.raises(ValueError, match="NCCL"):
        dryrun_multichip(2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="at least one rank"):
        dryrun_multichip(0, device="cpu")
