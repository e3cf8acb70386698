"""The port's collide stage against the JAX package on the CPU: each
push-out and ``collide_particles`` against ``softbodysim_tpu.collide.
primitives``, the fused collide kernel's plain version against the Pallas
kernel in interpret mode, ``pack_colliders`` and the collider round trip.

Tolerance: 1e-6 m -- the same float32 arithmetic in the same order; the
two frameworks may round a fused sum or a division by reciprocal
differently, by an ulp or so at |x| ~ 1 m.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from softbodysim_tpu.collide import primitives as jprim
from softbodysim_tpu.kernels.collide import make_fused_collide
from softbodysim_tpu.kernels.collide import pack_colliders as jpack

from softbodysim_torch.collide import primitives as tprim
from softbodysim_torch.io.from_jax import (colliders_from_numpy,
                                           colliders_to_numpy)
from softbodysim_torch.kernels import collide as kc

TOL = 1e-6
R = 0.03


def _quat(rng):
    q = rng.normal(size=4).astype(np.float32)
    return q / np.float32(np.linalg.norm(q))


def _items(rng):
    """All three types with rotations, a tombstone between them."""
    return [
        jprim.Colliders.sphere((0.0, 0.2, 0.0), 0.4),
        jprim.Colliders.box((0.5, 0.0, -0.3), (0.3, 0.2, 0.25),
                            rotation=tuple(_quat(rng))),
        None,
        jprim.Colliders.capsule((-0.5, 0.1, 0.3), 0.2, 0.3,
                                rotation=tuple(_quat(rng))),
        jprim.Colliders.box((0.0, -0.4, 0.0), (0.5, 0.1, 0.5)),
    ]


def _points(rng, n=2000):
    return rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)


def _sets(items, capacity=None):
    jc = jprim.Colliders.build(items, capacity)
    tc = colliders_from_numpy(
        {k: np.asarray(getattr(jc, k)) for k in
         ("type", "position", "rotation", "data", "active")}, "cpu")
    return jc, tc


def test_build_matches_jax():
    rng = np.random.default_rng(0)
    items = _items(rng)
    jc = jprim.Colliders.build(items, capacity=8)
    tc = tprim.Colliders.build(items, capacity=8, device="cpu")
    for k, a in colliders_to_numpy(tc).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jc, k)), k)
    assert tc.count == 8 and tc.device.type == "cpu"
    assert tprim.Colliders.empty(device="cpu").count == 0


@pytest.mark.parametrize("kind", ["sphere", "box", "capsule"])
def test_push_out_matches_jax(kind):
    rng = np.random.default_rng(1)
    p = _points(rng)
    q = _quat(rng)
    c = np.array([0.1, -0.05, 0.2], np.float32)
    if kind == "sphere":
        args = (c, np.float32(0.45))
        jf, tf = jprim.push_out_sphere, tprim.push_out_sphere
    elif kind == "box":
        args = (c, q, np.array([0.4, 0.3, 0.5], np.float32))
        jf, tf = jprim.push_out_box, tprim.push_out_box
    else:
        args = (c, q, np.float32(0.25), np.float32(0.35))
        jf, tf = jprim.push_out_capsule, tprim.push_out_capsule
    want = np.asarray(jf(*(jnp.asarray(a) for a in args), jnp.asarray(p), R))
    got = tf(*(torch.as_tensor(a) for a in args), torch.as_tensor(p), R)
    assert np.abs(want).max() > 0.1            # points were pushed
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_quat_rotate_matches_jax():
    rng = np.random.default_rng(2)
    q, v = _quat(rng), _points(rng, 100)
    np.testing.assert_allclose(
        tprim.quat_rotate(torch.as_tensor(q), torch.as_tensor(v)).numpy(),
        np.asarray(jprim.quat_rotate(jnp.asarray(q), jnp.asarray(v))),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("capacity", [None, 8])
def test_collide_particles_matches_jax(capacity):
    """Sequential application, an inactive tombstone between active slots
    and inactive capacity padding."""
    rng = np.random.default_rng(3)
    jc, tc = _sets(_items(rng), capacity)
    p = _points(rng)
    want = np.asarray(jprim.collide_particles(jnp.asarray(p), R, jc))
    got = tprim.collide_particles(torch.as_tensor(p), R, tc).numpy()
    assert np.abs(want - p).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_ground_plane_matches_jax():
    rng = np.random.default_rng(4)
    p = _points(rng)
    n = np.array([0.1, 1.0, -0.2], np.float32)
    n = n / np.float32(np.linalg.norm(n))
    pt = np.array([0.0, -0.1, 0.05], np.float32)
    want = np.asarray(jprim.project_ground_plane(
        jnp.asarray(p), R, jnp.asarray(pt), jnp.asarray(n)))
    got = tprim.project_ground_plane(torch.as_tensor(p), R,
                                     torch.as_tensor(pt), torch.as_tensor(n))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("capacity", [None, 6])
def test_pack_colliders_array_equal(capacity):
    jc, tc = _sets(_items(np.random.default_rng(5)), capacity)
    np.testing.assert_array_equal(kc.pack_colliders(tc).numpy(),
                                  np.asarray(jpack(jc)))
    np.testing.assert_array_equal(kc.pack_colliders(None, "cpu").numpy(),
                                  np.asarray(jpack(None)))
    back = kc.unpack_colliders(kc.pack_colliders(tc))
    for k, a in colliders_to_numpy(back).items():
        np.testing.assert_array_equal(a, colliders_to_numpy(tc)[k], k)


def test_colliders_numpy_round_trip():
    jc, tc = _sets(_items(np.random.default_rng(6)), 7)
    arrays = colliders_to_numpy(tc)
    for k, a in arrays.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jc, k)), k)
        assert a.dtype == np.asarray(getattr(jc, k)).dtype, k
    again = colliders_to_numpy(colliders_from_numpy(arrays, device="cpu"))
    for k in arrays:
        np.testing.assert_array_equal(again[k], arrays[k], k)
    with pytest.raises(KeyError):
        colliders_from_numpy({"type": arrays["type"]}, device="cpu")


@pytest.mark.parametrize("case", ["all_types", "ground_only", "no_ground"])
def test_collide_plain_matches_pallas_interpret(case):
    """The fused stage's plain version against the Pallas kernel in
    interpret mode (as tests/test_kernels.py runs it)."""
    rng = np.random.default_rng(7)
    v = 777
    p = _points(rng, v)
    w = rng.uniform(0.0, 2.0, (v,)).astype(np.float32)
    w[::5] = 0.0
    items = [] if case == "ground_only" else _items(rng)
    jc, tc = _sets(items) if items else (None, None)
    gn = np.array([0.0, 1.0, 0.0], np.float32)
    gp = np.array([0.0, -0.2, 0.0], np.float32)
    ground = case != "no_ground"
    fn = make_fused_collide(jc, ground_enabled=ground, ground_point=gp,
                            ground_normal=gn, radius=R, num_particles=v,
                            interpret=True)
    want = np.asarray(fn(jnp.asarray(p), jnp.asarray(w)))

    g = kc.Ground(enabled=ground, point=tuple(map(float, gp)),
                  normal=tuple(map(float, gn)), radius=float(np.float32(R)))
    xw = torch.from_numpy(np.concatenate([p, w[:, None]], 1))
    packed = kc.pack_colliders(tc, "cpu")
    before = kc.collide.launches
    out = kc.collide(xw, packed, g)
    assert out is xw and kc.collide.launches == before      # plain on CPU
    np.testing.assert_allclose(xw[:, :3].numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(xw[:, 3].numpy(), w)
    np.testing.assert_array_equal(xw[w == 0, :3].numpy(), p[w == 0])
    assert np.abs(want - p).max() > 0.01


def test_make_ground_normalizes():
    from softbodysim_torch import SolverParams

    g = kc.make_ground(SolverParams(ground_normal=(0.0, 2.0, 0.0),
                                    particle_radius=0.0))
    assert g.normal == (0.0, 1.0, 0.0) and g.radius == float(
        np.float32(1e-6))
    g = kc.make_ground(SolverParams(ground_normal=(0.0, 0.0, 0.0)))
    assert g.normal == (0.0, 1.0, 0.0)


def test_collide_wrapper_validates_inputs():
    xw = torch.zeros((10, 4))
    packed = kc.pack_colliders(None, "cpu")
    g = kc.Ground(True, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.02)
    with pytest.raises(ValueError):
        kc.collide(xw[:, :3], packed, g)
    with pytest.raises(TypeError):
        kc.collide(xw.double(), packed, g)
    with pytest.raises(ValueError):
        kc.collide(xw, packed[:, :11], g)
    with pytest.raises(ValueError):
        kc.collide(xw.t().contiguous().t(), packed, g)
    with pytest.raises(ValueError):
        kc.collide(xw.to("meta"), packed, g)
