"""The port's differentiable simulation (``softbodysim_torch/diff.py``)
against the JAX package's (``softbodysim_tpu/diff.py``) on the CPU, small
meshes, inputs from a numpy seed.

Each JAX reference (``jax.value_and_grad`` through ``sbs.diff.
make_rollout``, ``diff.fit``, a ``jax.vmap`` of rollouts) is computed once
per module: XLA:CPU compiles reverse-mode programs slowly.

Tolerances:
- trajectories 1e-4 m (the oracle parity contract);
- gradients 1e-3 of the largest |component| of the JAX gradient (fp32
  rounding through a few steps of reverse mode; both sides take the same
  branches of every clamp and contact test);
- ``fit``: the loss curve and the fitted value within 1e-3 relative (Adam
  in float32 on both sides, the same schedule);
- remat against no remat: bit for bit (the same ops recomputed);
- the ballistic identities (a free body's centre of mass is ballistic):
  1e-3 relative, as ``tests/test_diff.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import softbodysim_tpu as sbs
from softbodysim_tpu import diff as jdiff
from softbodysim_tpu.core.adjacency import combine_topologies as j_combine

import softbodysim_torch as sbt
from softbodysim_torch import diff
from softbodysim_torch.core.adjacency import combine_topologies

DT = 1.0 / 60.0
NSTEPS = 3
GRAD_TOL = 1e-3
X_TOL = 1e-4
# a cube dropped onto the ground, sliding: the ground clamp, the contact
# test and the friction at commit all act
XPBD = dict(dialect="xpbd", substeps=2, iterations=2, ground_enabled=True,
            friction=0.3, edge_compliance=1e-3, volume_compliance=1e-4)
XPBD_OV = {"edge_compliance": 1e-3, "volume_compliance": 1e-4,
           "friction": 0.3, "gravity_override": (0.5, -9.81, 0.0)}
# a cube thrown into a box and a sphere, over the ground plane
JACOBI = dict(dialect="jacobi", substeps=2, iterations=2,
              ground_enabled=True, particle_radius=0.01,
              edge_stiffness=0.5, volume_stiffness=0.8, sor_omega=1.2)
JACOBI_OV = {"edge_stiffness": 0.5, "volume_stiffness": 0.8,
             "sor_omega": 1.2}
COLLIDERS = [dict(type=1, position=(0.3, 0.12, 0.0),
                  rotation=(0.0, 0.0, 0.1305, 0.9914), data=(0.1, 0.1, 0.3)),
             dict(type=0, position=(-0.1, 0.05, 0.05), data=(0.12, 0, 0))]
# two cubes merged, the upper one 1 cm over the lower (surface contact)
CONTACT = dict(dialect="xpbd", substeps=1, iterations=2,
               ground_enabled=True, particle_radius=0.02,
               surface_collision=True, surface_thickness=0.02,
               edge_compliance=1e-3)
V0 = (1.5, -2.0, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny meshes run fastest on one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cube(mod):
    return mod.meshes.tet_cube(2, 2, 2, size=0.3, center=(0.0, 0.2, 0.0))


def _pair(mod):
    lo = mod.meshes.tet_cube(2, 2, 2, size=0.3, center=(0.0, 0.15, 0.0))
    hi = mod.meshes.tet_cube(2, 2, 2, size=0.3,
                             center=(0.037, 0.46, 0.023))
    merge = j_combine if mod is sbs else combine_topologies
    return merge([lo, hi])[0]


def _weights(topo, seed):
    """A fixed cotangent: the loss is sum(trajectory * W)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (NSTEPS, topo.num_particles, 3)).astype(np.float32)


def _v0(topo):
    return np.tile(np.asarray(V0, np.float32), (topo.num_particles, 1))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max err {err:.3e}, scale " \
                               f"{scale:.3e}"


def _jax_grads(topo, params, names, w, colliders=None, inv_mass_mode="tet"):
    """(trajectory, {name: gradient}) of sum(rollout * w) in JAX, one
    program for all names ('state0.v' is the initial velocity)."""
    s0 = sbs.init_state(topo, inv_mass_mode=inv_mass_mode)
    jc = None if colliders is None else sbs.Colliders.build(colliders)
    r = jdiff.make_rollout(topo, params, dt=DT, nsteps=NSTEPS, colliders=jc)
    ov_names = [n for n in names if n != "state0.v"]

    def loss(ov, v):
        st = sbs.SimState(x=s0.x, v=v, x_star=s0.x_star,
                          inv_mass=s0.inv_mass, edge_lambda=s0.edge_lambda,
                          tet_lambda=s0.tet_lambda)
        tr = r(st, ov)
        return jnp.sum(tr * w), tr

    ov = {n: jnp.asarray(XPBD_OV.get(n, JACOBI_OV.get(n)), jnp.float32)
          for n in ov_names}
    (_, tr), (g_ov, g_v) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(
        ov, jnp.asarray(_v0(topo)))
    grads = {n: np.asarray(g) for n, g in g_ov.items()}
    grads["state0.v"] = np.asarray(g_v)
    return np.asarray(tr), grads


def _port_grads(topo, params, names, w, colliders=None, remat=True,
                inv_mass_mode="tet"):
    """The port's counterpart of ``_jax_grads`` on the CPU."""
    s0 = sbt.init_state(topo, inv_mass_mode=inv_mass_mode, device="cpu")
    tc = None if colliders is None else sbt.Colliders.build(colliders,
                                                            device="cpu")
    r = diff.make_rollout(topo, params, dt=DT, nsteps=NSTEPS, colliders=tc,
                          remat=remat, device="cpu")
    ov = {n: torch.tensor(XPBD_OV.get(n, JACOBI_OV.get(n)),
                          dtype=torch.float32, requires_grad=True)
          for n in names if n != "state0.v"}
    v = torch.from_numpy(_v0(topo)).requires_grad_(True)
    st = sbt.SimState(x=s0.x, v=v, x_star=s0.x_star, inv_mass=s0.inv_mass,
                      edge_lambda=s0.edge_lambda, tet_lambda=s0.tet_lambda)
    tr = r(st, ov)
    inputs = list(ov.values()) + [v]
    got = torch.autograd.grad((tr * torch.from_numpy(w)).sum(), inputs)
    grads = {n: g.numpy() for n, g in zip(list(ov) + ["state0.v"], got)}
    return tr.detach().numpy(), grads, r


XPBD_NAMES = ("edge_compliance", "volume_compliance", "friction",
              "gravity_override", "state0.v")
JACOBI_NAMES = ("edge_stiffness", "volume_stiffness", "sor_omega",
                "state0.v")
CONTACT_NAMES = ("edge_compliance", "state0.v")


@pytest.fixture(scope="module")
def xpbd_case():
    w = _weights(_cube(sbt), 0)
    return (_jax_grads(_cube(sbs), sbs.SolverParams(**XPBD), XPBD_NAMES, w),
            _port_grads(_cube(sbt), sbt.SolverParams(**XPBD), XPBD_NAMES, w))


@pytest.fixture(scope="module")
def jacobi_case():
    w = _weights(_cube(sbt), 1)
    return (_jax_grads(_cube(sbs), sbs.SolverParams(**JACOBI), JACOBI_NAMES,
                       w, COLLIDERS, "density"),
            _port_grads(_cube(sbt), sbt.SolverParams(**JACOBI), JACOBI_NAMES,
                        w, COLLIDERS, inv_mass_mode="density"))


@pytest.fixture(scope="module")
def contact_case():
    w = _weights(_pair(sbt), 2)
    return (_jax_grads(_pair(sbs), sbs.SolverParams(**CONTACT),
                       CONTACT_NAMES, w),
            _port_grads(_pair(sbt), sbt.SolverParams(**CONTACT),
                        CONTACT_NAMES, w))


# ---- gradients against the JAX package -----------------------------------


@pytest.mark.parametrize("name", XPBD_NAMES)
def test_xpbd_gradients_match_jax(name, xpbd_case):
    """The coloured step ('scatter' on both sides) through ground contact
    and friction: each override's gradient and the initial velocity's."""
    (jtr, jg), (tr, g, r) = xpbd_case
    assert r.step.backend == "gather" and r.step.differentiable
    np.testing.assert_allclose(tr, jtr, rtol=0, atol=X_TOL)
    assert tr[:, :, 1].min() <= 1e-6               # it reached the ground
    _close(g[name], jg[name], GRAD_TOL, name)
    assert np.abs(g[name]).max() > 0


@pytest.mark.parametrize("name", JACOBI_NAMES)
def test_jacobi_gradients_match_jax(name, jacobi_case):
    """The segment step with a box and a sphere collider over the ground
    plane (the collide stage through ``collide_positions``)."""
    (jtr, jg), (tr, g, r) = jacobi_case
    assert r.step.backend == "segment"
    np.testing.assert_allclose(tr, jtr, rtol=0, atol=X_TOL)
    _close(g[name], jg[name], GRAD_TOL, name)
    assert np.abs(g[name]).max() > 0


@pytest.mark.parametrize("name", CONTACT_NAMES)
def test_surface_contact_gradients_match_jax(name, contact_case):
    """Two bodies in surface contact: the integer corner sum carries the
    float scatter's gradient, the JAX package's."""
    (jtr, jg), (tr, g, r) = contact_case
    assert r.step.contact.surf_fn is not None
    np.testing.assert_allclose(tr, jtr, rtol=0, atol=X_TOL)
    _close(g[name], jg[name], GRAD_TOL, name)


def test_surface_contact_value_is_the_integer_sum():
    """Under autograd the stage's forward is the integer corner sum bit
    for bit; only its gradient differs."""
    from softbodysim_torch.solver import surface_collide as tsc

    topo = _pair(sbt)
    rng = np.random.default_rng(3)
    p = torch.from_numpy((topo.vertices + rng.normal(
        0, 0.004, topo.vertices.shape)).astype(np.float32))
    w = torch.ones(topo.num_particles)
    tris = torch.from_numpy(topo.surface_tris.astype(np.int64))
    plain = tsc.surface_collision_deltas(p, w, tris, 0.02, 0.2, 8)
    q = p.clone().requires_grad_(True)
    flt = tsc.surface_collision_deltas(q, w, tris, 0.02, 0.2, 8)
    assert flt.requires_grad and not plain.requires_grad
    assert torch.equal(flt.detach(), plain) and plain.abs().max() > 0
    g, = torch.autograd.grad(flt.square().sum(), q)
    assert torch.isfinite(g).all() and g.abs().max() > 0


# ---- the rollout's own contracts -------------------------------------------


@pytest.mark.parametrize("dialect", ["xpbd", "jacobi"])
def test_remat_matches_no_remat_bitwise(dialect, xpbd_case, jacobi_case):
    (_, _), (tr, g, _) = xpbd_case if dialect == "xpbd" else jacobi_case
    if dialect == "xpbd":
        args = (_cube(sbt), sbt.SolverParams(**XPBD), XPBD_NAMES,
                _weights(_cube(sbt), 0))
        kw = {}
    else:
        args = (_cube(sbt), sbt.SolverParams(**JACOBI), JACOBI_NAMES,
                _weights(_cube(sbt), 1), COLLIDERS)
        kw = dict(inv_mass_mode="density")
    tr2, g2, _ = _port_grads(*args, remat=False, **kw)
    np.testing.assert_array_equal(tr2, tr)
    for n in g:
        np.testing.assert_array_equal(g2[n], g[n], err_msg=n)


@pytest.mark.parametrize("form", ["translation", "gravity"])
def test_ballistic_identities(form):
    """No ground, no pins: the projections conserve momentum, so the
    centre of mass is ballistic.  d(final mean y)/d(dv0) = nsteps * dt;
    d(final mean y)/d(g_y) = T^2 (n+1) / (2n) over the n substeps
    (tests/test_diff.py's two forms)."""
    nsteps, ss = 3, 2
    params = sbt.SolverParams(dialect="xpbd", substeps=ss, iterations=1,
                              ground_enabled=False)
    topo = _cube(sbt)
    s0 = sbt.init_state(topo, device="cpu")
    r = diff.make_rollout(topo, params, dt=DT, nsteps=nsteps, device="cpu")
    t = torch.tensor(0.0 if form == "translation" else -9.81,
                     requires_grad=True)
    if form == "translation":
        v = s0.v + torch.stack([torch.zeros(()), t, torch.zeros(())])
        st = sbt.SimState(x=s0.x, v=v, x_star=s0.x_star,
                          inv_mass=s0.inv_mass, edge_lambda=s0.edge_lambda,
                          tet_lambda=s0.tet_lambda)
        y = r(st)[-1, :, 1].mean()
        want = nsteps * DT
    else:
        g = torch.stack([torch.zeros(()), t, torch.zeros(())])
        y = r(s0, {"gravity_override": g})[-1, :, 1].mean()
        n, total = nsteps * ss, nsteps * DT
        want = total * total * (n + 1) / (2 * n)
    got, = torch.autograd.grad(y, t)
    assert float(got) == pytest.approx(want, rel=1e-3)


def test_compliance_tensors_of_every_shape():
    """A 0-dim compliance and a per-constraint table of that value give
    the same trajectory and gradient (the 0-dim one summed over the
    table's)."""
    topo = _cube(sbt)
    params = sbt.SolverParams(**XPBD)
    s0 = sbt.init_state(topo, device="cpu")
    r = diff.make_rollout(topo, params, dt=DT, nsteps=2, remat=False,
                          device="cpu")
    c0 = torch.tensor(1e-3, requires_grad=True)
    ct = torch.full((topo.num_edges,), 1e-3, requires_grad=True)
    a, b = r(s0, {"edge_compliance": c0}), r(s0, {"edge_compliance": ct})
    np.testing.assert_allclose(a.detach(), b.detach(), rtol=0, atol=1e-7)
    g0, = torch.autograd.grad(a[-1, :, 1].sum(), c0)
    gt, = torch.autograd.grad(b[-1, :, 1].sum(), ct)
    assert float(g0) == pytest.approx(float(gt.sum()), rel=1e-4)


def test_vmapped_jax_rollouts_match_a_loop_of_port_rollouts():
    """jax.vmap over two compliances (one program, a batch of
    trajectories) against the port's rollouts one by one."""
    params = dict(dialect="xpbd", substeps=1, iterations=2,
                  ground_enabled=False)
    jt = _cube(sbs)
    top = np.where(jt.vertices[:, 1] >= jt.vertices[:, 1].max() - 1e-6)[0]
    js0 = sbs.init_state(jt, pinned=top)
    jr = jdiff.make_rollout(jt, sbs.SolverParams(**params), dt=DT, nsteps=4)
    cs = np.asarray([1e-4, 1e-2], np.float32)
    batch = np.asarray(jax.vmap(
        lambda c: jr(js0, {"edge_compliance": c}))(jnp.asarray(cs)))
    topo = _cube(sbt)
    s0 = sbt.init_state(topo, pinned=top, device="cpu")
    r = diff.make_rollout(topo, sbt.SolverParams(**params), dt=DT, nsteps=4,
                          device="cpu")
    for i, c in enumerate(cs):
        with torch.no_grad():
            got = r(s0, {"edge_compliance": torch.tensor(c)}).numpy()
        np.testing.assert_allclose(got, batch[i], rtol=0, atol=X_TOL)
    assert batch[1, -1, :, 1].min() < batch[0, -1, :, 1].min()


@pytest.fixture(scope="module")
def fit_case():
    """A short fit of the edge compliance from 10x off, in JAX and on the
    port, from one target (the JAX rollout at the true value): a free cube
    deformed by a random initial velocity field, at a compliance where
    alpha / sdt^2 is of the order of the inverse masses (the trajectory
    is sensitive to it)."""
    params = dict(dialect="xpbd", substeps=1, iterations=2,
                  ground_enabled=False, edge_compliance=0.5)
    v0 = np.random.default_rng(4).normal(
        0.0, 1.0, (_cube(sbt).num_particles, 3)).astype(np.float32)
    jt = _cube(sbs)
    js0 = sbs.init_state(jt)
    js0 = sbs.SimState(x=js0.x, v=jnp.asarray(v0), x_star=js0.x_star,
                       inv_mass=js0.inv_mass, edge_lambda=js0.edge_lambda,
                       tet_lambda=js0.tet_lambda)
    jp = sbs.SolverParams(**params)
    target = np.asarray(jdiff.make_rollout(jt, jp, dt=DT, nsteps=2)(
        js0, {"edge_compliance": jnp.float32(0.5)}))
    kw = dict(dt=DT, fit_params=("edge_compliance",),
              init={"edge_compliance": 5.0}, steps=4, learning_rate=0.25,
              remat=False)
    want = jdiff.fit(jt, jp, target, state0=js0, **kw)
    topo = _cube(sbt)
    s0 = sbt.init_state(topo, device="cpu")
    s0 = sbt.SimState(x=s0.x, v=torch.from_numpy(v0), x_star=s0.x_star,
                      inv_mass=s0.inv_mass, edge_lambda=s0.edge_lambda,
                      tet_lambda=s0.tet_lambda)
    got = diff.fit(topo, sbt.SolverParams(**params), target, state0=s0,
                   device="cpu", **kw)
    return want, got


def test_fit_matches_jax_fit(fit_case):
    want, got = fit_case
    assert len(got.losses) == len(want.losses) == 5
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    assert got.params["edge_compliance"] == pytest.approx(
        want.params["edge_compliance"], rel=1e-3)
    assert got.converged == want.converged
    assert got.losses[-1] < got.losses[0]


def test_fit_takes_an_optimizer_callable():
    """``optimizer``: params -> torch.optim.Optimizer (no schedule); SGD
    at lr 0 leaves the start value, each loss the starting loss."""
    topo = _cube(sbt)
    top = np.where(topo.vertices[:, 1]
                   >= topo.vertices[:, 1].max() - 1e-6)[0]
    target = np.zeros((NSTEPS, topo.num_particles, 3), np.float32)
    res = diff.fit(topo, sbt.SolverParams(dialect="xpbd", substeps=1,
                                          iterations=1,
                                          ground_enabled=False),
                   target, dt=DT, init={"edge_compliance": 2e-3},
                   state0=sbt.init_state(topo, pinned=top, device="cpu"),
                   steps=2, device="cpu",
                   optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    assert res.params["edge_compliance"] == pytest.approx(2e-3, rel=1e-6)
    assert np.ptp(res.losses) == 0.0 and len(res.losses) == 3


# ---- differentiable_params and the errors ----------------------------------


XPBD_BACKENDS = ["auto", "pallas", "sweep", "gather", "scatter"]
JACOBI_BACKENDS = ["auto", "pallas", "pass", "gather", "segment"]


@pytest.mark.parametrize("dialect,backend",
                         [("xpbd", b) for b in XPBD_BACKENDS]
                         + [("jacobi", b) for b in JACOBI_BACKENDS])
def test_differentiable_params_matches_jax(dialect, backend):
    """The backend the port picks is the JAX function's (the port's
    names 'sweep' / 'pass' are its 'pallas').  One difference, by design:
    the JAX function sets use_pallas='off' (its Pallas collide kernel has
    no VJP); the port keeps use_pallas, its collide kernel has a gradient
    (``kernels/collide.py::collide_positions``)."""
    knob = "xpbd_backend" if dialect == "xpbd" else "jacobi_backend"
    jname = {"sweep": "pallas", "pass": "pallas"}.get(backend, backend)
    for use_pallas in ("auto", "on", "off"):
        p = sbt.SolverParams(dialect=dialect, use_pallas=use_pallas,
                             **{knob: backend})
        q = diff.differentiable_params(p)
        jq = jdiff.differentiable_params(sbs.SolverParams(
            dialect=dialect, use_pallas=use_pallas, **{knob: jname}))
        assert getattr(q, knob) == getattr(jq, knob)
        assert jq.use_pallas == "off" and q.use_pallas == use_pallas
        if backend in ("gather", "scatter", "segment"):
            assert q is p                       # untouched: the same object
        if dialect == "xpbd":
            step = sbt.make_step(_cube(sbt), q, device="cpu",
                                 differentiable=True)
            assert step.differentiable and step.backend == "gather"
        else:
            step = sbt.make_step(_cube(sbt), q, device="cpu")
            assert step.backend == q.jacobi_backend


def _both(fn_j, fn_t, match):
    with pytest.raises(ValueError, match=match):
        fn_j()
    with pytest.raises(ValueError, match=match):
        fn_t()


ERRORS = ["override", "fit_param", "target_shape", "observed_range",
          "sharded_target", "sharded_state0"]


@pytest.mark.parametrize("case", ERRORS)
def test_value_errors_match_jax(case):
    """Every ValueError of the JAX module, raised by the port on the same
    inputs."""
    jt, tt = _cube(sbs), _cube(sbt)
    jp = sbs.SolverParams(dialect="xpbd", ground_enabled=False)
    tp = sbt.SolverParams(dialect="xpbd", ground_enabled=False)
    V = tt.num_particles
    if case == "override":
        jr = jdiff.make_rollout(jt, jp, dt=DT, nsteps=1)
        tr = diff.make_rollout(tt, tp, dt=DT, nsteps=1, device="cpu")
        s = sbt.init_state(tt, device="cpu")
        _both(lambda: jr(sbs.init_state(jt), {"edge_stiffness": 0.5}),
              lambda: tr(s, {"edge_stiffness": 0.5}), "not fittable")
    elif case == "fit_param":
        z = np.zeros((2, V, 3))
        _both(lambda: jdiff.fit(jt, jp, z, dt=DT, fit_params=("sor_omega",),
                                steps=1),
              lambda: diff.fit(tt, tp, z, dt=DT, fit_params=("sor_omega",),
                               steps=1, device="cpu"), "not fittable")
    elif case == "target_shape":
        z = np.zeros((3, 5, 3))
        _both(lambda: jdiff.make_trajectory_loss(jt, jp, z, dt=DT),
              lambda: diff.make_trajectory_loss(tt, tp, z, dt=DT,
                                                device="cpu"),
              "target must be")
    elif case == "observed_range":
        z = np.zeros((2, 2, 3))
        _both(lambda: jdiff.make_trajectory_loss(jt, jp, z, dt=DT,
                                                 observed=[0, V]),
              lambda: diff.make_trajectory_loss(tt, tp, z, dt=DT,
                                                observed=[0, V],
                                                device="cpu"),
              "observed ids must be")
    elif case == "sharded_target":
        z = np.zeros((2, V, 3))
        _both(lambda: jdiff.make_trajectory_loss(jt, jp, z, dt=DT,
                                                 mesh=object()),
              lambda: diff.make_trajectory_loss(tt, tp, z, dt=DT,
                                                mesh=object(),
                                                device="cpu"),
              "sharded target must be")
    else:
        z = np.zeros((2, 2, V, 3))
        _both(lambda: jdiff.make_trajectory_loss(jt, jp, z, dt=DT,
                                                 mesh=object()),
              lambda: diff.make_trajectory_loss(tt, tp, z, dt=DT,
                                                mesh=object(),
                                                device="cpu"),
              "explicit batched")


def test_mesh_rollout_not_ported_yet(tmp_path):
    """The mesh rollout is ported (tests/test_torch_sharded_modes.py holds
    it on gloo worlds of 2 and 4): a mesh without a "data" dimension is
    refused, and on a (data, model) mesh of one rank the rollout of a
    one-scene batch is the single-device trajectory, bit for bit."""
    import torch.distributed as dist

    from softbodysim_torch.parallel import make_mesh

    topo = _cube(sbt)
    params = sbt.SolverParams(dialect="jacobi", jacobi_backend="segment")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="'data'"):
            diff.make_rollout(topo, params, dt=DT, nsteps=1,
                              mesh=make_mesh(), device="cpu")
        mesh = make_mesh(shape=(1, 1), axis_names=("data", "model"))
        s0 = sbt.init_state(topo, device="cpu")
        batch = sbt.SimState(**{f: getattr(s0, f)[None] for f in (
            "x", "v", "x_star", "inv_mass", "edge_lambda", "tet_lambda")})
        got = diff.make_rollout(topo, params, dt=DT, nsteps=2, mesh=mesh,
                                device="cpu")(batch)
        want = diff.make_rollout(topo, params, dt=DT, nsteps=2,
                                 device="cpu")(s0)
        assert tuple(got.shape) == (2, 1) + tuple(want.shape[1:])
        assert torch.equal(got[:, 0], want)
    finally:
        dist.destroy_process_group()


def test_differentiable_build_refuses_kernel_backends():
    """make_step(differentiable=True) with an explicit xpbd kernel backend
    raises; 'auto' picks the coloured backend without looking at the size
    or the device; the jacobi dialect has no such build (its plain steps
    differentiate as built)."""
    topo = _cube(sbt)
    for backend in ("sweep", "pallas"):
        with pytest.raises(ValueError, match="differentiable=True"):
            sbt.make_step(topo, sbt.SolverParams(xpbd_backend=backend),
                          device="cpu", differentiable=True)
    step = sbt.make_step(topo, sbt.SolverParams(), device="cpu",
                         differentiable=True)        # 'auto': no lookup
    assert step.backend == "gather" and step.differentiable
    with pytest.raises(TypeError):
        sbt.make_step(topo, sbt.SolverParams(dialect="jacobi"),
                      device="cpu", differentiable=True)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    topo = _cube(sbt)
    with pytest.raises(RuntimeError, match="is_available"):
        diff.make_rollout(topo, sbt.SolverParams(), dt=DT, nsteps=1)
    with pytest.raises(RuntimeError, match="is_available"):
        diff.make_trajectory_loss(
            topo, sbt.SolverParams(),
            np.zeros((1, topo.num_particles, 3)), dt=DT)
