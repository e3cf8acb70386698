"""Serving on the CPU: the port's PBD1 codecs, server, client, native
server, watchdog and CLI against the JAX package's.

The codecs' bytes are identical.  Sessions run a wire config in which
every field of the wire -> Engine mapping shows (``WIRE``: two compliances
of different sizes, friction, sideways gravity, a ground the cube lands on
in its first steps, one pinned corner, tet-volume inverse masses): a
session on the port's server (``device="cpu"``) is held against the JAX
PBDServer's session (the JAX Engine under the JAX package's own mapping)
within 1e-4 m over 10 steps (tests/test_torch_xpbd.py's tolerance for the
coloured backends, looser than 1e-5), and each single fault of the
mapping moves the run more than 10x that (``test_wire_mapping_shows``).
The JAX client and server talk to the port's server and client; a
pipelined reply k equals lock-step reply k-1, two concurrent sessions and
the native server equal their solo runs, bit for bit (the same CPU code on
the same inputs); a sweep launch that timed out ends its session unsent.
The watchdog's NaN rollback matches the JAX Watchdog's (rollback count,
restored step; positions within 1e-4 m).  No test times anything.
"""

import dataclasses
import socket
import struct
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodysim_tpu.api import protocol as jproto
from softbodysim_tpu.api.client import PBDClient as JClient
from softbodysim_tpu.api.server import PBDServer as JServer
from softbodysim_tpu.api.watchdog import Watchdog as JWatchdog
from softbodysim_tpu.api.watchdog import WatchdogConfig as JWatchdogConfig
from softbodysim_tpu.core.state import SimState as JState

import softbodysim_torch as sbt
from softbodysim_torch import io as tio
from softbodysim_torch.__main__ import main as cli_main
from softbodysim_torch.api import PBDClient, PBDServer, Watchdog
from softbodysim_torch.api import native_server, protocol
from softbodysim_torch.api import server as server_mod
from softbodysim_torch.api.native_server import NativePBDServer
from softbodysim_torch.api.server import engine_from_init
from softbodysim_torch.api.watchdog import WatchdogConfig
from softbodysim_torch.core.state import SimState

DT = 1.0 / 60.0
STEPS = 10
TOL = 1e-4          # tests/test_torch_xpbd.py: coloured backends, 10 steps
_WIRE = dict(substeps=2, iterations=2, edge_compliance=2e-3,
             volume_compliance=2e-5, gravity=(3.0, -9.81, 0.0),
             ground_enabled=1, ground_y=0.40, friction=0.6)
WIRE = protocol.WireParams(**_WIRE)
JWIRE = jproto.WireParams(**_WIRE)
PINNED = np.array([6], np.uint32)   # _cube()'s top corner at (-x, -z)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny scenes run fastest on one core; one intra-op thread also keeps
    the CPU sums in one order, so solo and concurrent runs compare bit for
    bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cube(center_y=0.7, nx=2):
    """tet_cube(2) of side 0.5: its bottom at 0.45, 5 cm over WIRE's
    ground."""
    return sbt.meshes.tet_cube(nx, 2, 2, size=0.5, center=(0.0, center_y,
                                                            0.0))


def _session(port, topo, steps, wire=WIRE, client=PBDClient, pinned=PINNED):
    with client(port=port) as cli:
        cli.init(topo.vertices, topo.edges, topo.tets, params=wire,
                 pinned=pinned)
        return [cli.step(DT) for _ in range(steps)]


@pytest.fixture(scope="module")
def jax_session():
    """(replies, engine): the port's client in a session of the JAX
    PBDServer on _cube() with WIRE and PINNED, and the JAX Engine the JAX
    server built for it (its mapping), compiled once for the module."""
    srv = JServer(port=0, verbose=False).start_background().wait_ready()
    replies = _session(srv.port, _cube(), STEPS)
    srv._thread.join(timeout=30.0)
    return replies, srv.engine


def _server(**kw):
    return PBDServer(port=0, verbose=False, device="cpu",
                     **kw).start_background().wait_ready()


def _finished(srv):
    srv._thread.join(timeout=30.0)
    assert not srv._thread.is_alive(), "server thread hung"


def _init(topo, wire=WIRE, pinned=PINNED):
    return protocol.unpack_init(protocol.pack_init(protocol.InitMessage(
        wire, np.asarray(pinned, np.uint32), topo.vertices, topo.edges,
        topo.tets))[12:])


def _solo(topo, steps, wire=WIRE, pinned=PINNED):
    """The wire config's Engine in process, built as the server builds
    it."""
    eng = engine_from_init(_init(topo, wire, pinned), "cpu")
    return [eng.step(DT).positions().copy() for _ in range(steps)]


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codecs_byte_identical(seed):
    rng = np.random.default_rng(seed)
    v, e, t, p = (int(x) for x in rng.integers(1, 40, 4))
    kw = dict(substeps=int(rng.integers(1, 9)),
              iterations=int(rng.integers(1, 9)),
              dt_hint=float(rng.uniform(0, 1)), omega=float(rng.uniform(1, 2)),
              edge_compliance=float(rng.uniform(0, 1e-3)),
              volume_compliance=float(rng.uniform(0, 1e-3)),
              gravity=tuple(float(g) for g in rng.normal(size=3)),
              ground_enabled=int(rng.integers(0, 2)),
              ground_y=float(rng.normal()), friction=float(rng.uniform()))
    arrays = dict(pinned=rng.integers(0, v, p).astype(np.uint32),
                  x0=rng.normal(size=(v, 3)).astype(np.float32),
                  edges=rng.integers(0, v, (e, 2)).astype(np.uint32),
                  tets=rng.integers(0, v, (t, 4)).astype(np.uint32))
    ours = protocol.pack_init(protocol.InitMessage(
        params=protocol.WireParams(**kw), **arrays))
    theirs = jproto.pack_init(jproto.InitMessage(
        params=jproto.WireParams(**kw), **arrays))
    assert ours == theirs
    back = protocol.unpack_init(ours[12:])
    for k, a in arrays.items():
        np.testing.assert_array_equal(getattr(back, k), a)
    dt = float(rng.uniform(0, 0.1))
    assert protocol.pack_step(dt) == jproto.pack_step(dt)
    pos = rng.normal(size=(v, 3))
    assert protocol.pack_positions(pos) == jproto.pack_positions(pos)
    for msg_type in range(6):
        assert (protocol.pack_header(msg_type, v)
                == jproto.pack_header(msg_type, v))
    assert protocol.pack_shutdown() == jproto.pack_shutdown()


# --------------------------------------------------------------------------
# sessions against the JAX package
# --------------------------------------------------------------------------

def test_loopback_session_matches_jax_engine(jax_session):
    srv = _server()
    replies = _session(srv.port, _cube(), STEPS)
    _finished(srv)
    assert srv.engine.device.type == "cpu"
    for k, (got, want) in enumerate(zip(replies, jax_session[0])):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"step {k + 1}")
    # the config acts: the cube lands on the ground and, held by its
    # pinned corner and the friction, drifts with the sideways gravity
    last, x0 = replies[-1], _cube().vertices
    assert abs(last[:, 1].min() - WIRE.ground_y) < 1e-6
    np.testing.assert_array_equal(last[PINNED], x0[PINNED])
    assert last[:, 0].mean() > x0[:, 0].mean() + 1e-3


def _drop_pins(wire, pinned):
    return wire, [], "tet"


def _density_masses(wire, pinned):
    return wire, pinned, "density"


def _wire_fault(**kw):
    def fault(wire, pinned):
        kw2 = {k: (v(wire) if callable(v) else v) for k, v in kw.items()}
        return dataclasses.replace(wire, **kw2), pinned, "tet"
    return fault


MAPPING_FAULTS = {
    "compliances_swapped": _wire_fault(
        edge_compliance=lambda w: w.volume_compliance,
        volume_compliance=lambda w: w.edge_compliance),
    "friction_dropped": _wire_fault(friction=0.0),
    "ground_y_dropped": _wire_fault(ground_y=0.0),
    "ground_disabled": _wire_fault(ground_enabled=0),
    "gravity_vertical": _wire_fault(gravity=(0.0, -9.81, 0.0)),
    "substeps_one": _wire_fault(substeps=1),
    "iterations_one": _wire_fault(iterations=1),
    "pins_dropped": _drop_pins,
    "density_masses": _density_masses,
}


@pytest.mark.parametrize("fault", list(MAPPING_FAULTS))
def test_wire_mapping_shows(fault, jax_session):
    """A port whose wire -> Engine mapping had this one fault would part
    from the JAX server's session by more than 10x TOL: the sessions'
    1e-4 m bound above sees every field of the mapping."""
    wire, pinned, mode = MAPPING_FAULTS[fault](WIRE, PINNED)
    eng = engine_from_init(_init(_cube(), wire, pinned), "cpu")
    if mode != "tet":
        eng.reset(pinned=pinned, inv_mass_mode=mode)
    off = 0.0
    for want in jax_session[0]:
        off = float(np.abs(eng.step(DT).positions() - want).max())
        if off > 10 * TOL:
            break
    assert off > 10 * TOL, off


def test_jax_client_against_port_server(jax_session):
    srv = _server()
    replies = _session(srv.port, _cube(), STEPS, wire=JWIRE, client=JClient)
    _finished(srv)
    for got, want in zip(replies, jax_session[0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_port_client_against_jax_server(jax_session):
    """The port's client in the JAX server's session (the fixture's),
    against the port's solo run."""
    for got, want in zip(jax_session[0], _solo(_cube(), STEPS)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_pipelined_reply_is_previous_lockstep_reply():
    topo = _cube()
    srv = _server()
    lock = _session(srv.port, topo, 6)
    _finished(srv)
    srv = _server(pipeline=True)
    pipe = _session(srv.port, topo, 6)
    _finished(srv)
    np.testing.assert_array_equal(pipe[0], topo.vertices)
    for k in range(1, 6):
        np.testing.assert_array_equal(pipe[k], lock[k - 1])


def test_two_concurrent_sessions_equal_their_solo_runs():
    """Two clients on one multi-session server, stepping from two threads
    at once; each reply stream equals its solo run, and one client's
    SHUTDOWN ends only its own session."""
    topos = {"a": _cube(), "b": _cube(center_y=1.1, nx=3)}
    solo = {k: _solo(t, 6) for k, t in topos.items()}
    srv = PBDServer(port=0, verbose=False, device="cpu")
    srv.start_background(multi=True).wait_ready()
    results, errors = {}, []
    start = threading.Barrier(2)

    def run(tag):
        try:
            with PBDClient(port=srv.port) as cli:
                topo = topos[tag]
                cli.init(topo.vertices, topo.edges, topo.tets, params=WIRE,
                         pinned=PINNED)
                start.wait(timeout=30.0)
                results[tag] = [cli.step(DT) for _ in range(6)]
        except Exception as e:      # reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in "ab"]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
            assert not th.is_alive()
        assert not errors, errors
        for tag in "ab":
            for got, want in zip(results[tag], solo[tag]):
                np.testing.assert_array_equal(got, want)
        # sessions stay independent: a closed session leaves b serving
        with PBDClient(port=srv.port) as cli:
            cli.init(topos["b"].vertices, topos["b"].edges,
                     topos["b"].tets, params=WIRE, pinned=PINNED)
            np.testing.assert_array_equal(cli.step(DT), solo["b"][0])
    finally:
        srv.stop()
    assert not srv._thread.is_alive()


def test_reinit_resets_the_world():
    topo = _cube()
    srv = _server()
    with PBDClient(port=srv.port) as cli:
        cli.init(topo.vertices, topo.edges, topo.tets, params=WIRE,
                 pinned=PINNED)
        for _ in range(5):
            first = cli.step(DT)
        cli.init(topo.vertices, topo.edges, topo.tets, params=WIRE,
                 pinned=PINNED)
        again = cli.step(DT)
    _finished(srv)
    assert first[:, 1].mean() < again[:, 1].mean()
    np.testing.assert_array_equal(again, _solo(topo, 1)[0])


@pytest.fixture
def timeout_word(monkeypatch):
    """Servers whose sessions step on the sweep backend with each plan's
    timed-out word replaced by this (1,) int32 tensor: a test sets it to 1
    where a CUDA launch that aborted would have."""
    word = torch.zeros(1, dtype=torch.int32)
    real = server_mod.engine_from_init

    def make(init, device):
        eng = real(init, device)
        eng.switch_params(dataclasses.replace(eng.params,
                                              xpbd_backend="sweep"))
        plans = eng._raw_step.device_plans
        for k, p in plans.items():
            plans[k] = p._replace(staged=types.SimpleNamespace(
                timeouts=word))
        return eng

    monkeypatch.setattr(server_mod, "engine_from_init", make)
    monkeypatch.setattr(native_server, "engine_from_init", make)
    return word


@pytest.mark.parametrize("kind", ["lockstep", "pipelined", "native"])
def test_timed_out_sweep_ends_the_session(kind, timeout_word, capsys):
    """Two good steps; then a sweep launch of the third (in pipelined
    mode: of the second, which the third STEP's reply carries) times out:
    the server reports it, sends no positions and ends the session, and
    the word is reset."""
    topo = _cube()
    srv = (NativePBDServer(port=0, device="cpu") if kind == "native" else
           PBDServer(port=0, device="cpu", pipeline=kind == "pipelined"))
    srv.start_background().wait_ready()
    with PBDClient(port=srv.port) as cli:
        cli.init(topo.vertices, topo.edges, topo.tets, params=WIRE,
                 pinned=PINNED)
        good = [cli.step(DT) for _ in range(2)]
        timeout_word.fill_(1)
        with pytest.raises(ConnectionError):
            cli.step(DT)
    srv._thread.join(timeout=30.0)
    assert not srv._thread.is_alive()
    assert "timed out" in capsys.readouterr().out
    assert int(timeout_word) == 0
    eng = server_mod.engine_from_init(_init(topo), "cpu")  # the same sweeps
    want = [eng.step(DT).positions().copy() for _ in range(2)]
    if kind == "pipelined":
        want = [topo.vertices] + want[:1]
    for got, w in zip(good, want):
        np.testing.assert_array_equal(got, w)


# --------------------------------------------------------------------------
# malformed traffic (as tests/test_protocol.py)
# --------------------------------------------------------------------------

FUZZ = {
    "zero_magic": b"\x00" * 12,
    "unknown_type": b"PBD1" + struct.pack("<II", 99, 0),
    "absurd_size": b"PBD1" + struct.pack("<II", 2, 0xFFFFFFFF),
    "truncated_init": b"PBD1" + struct.pack("<II", 1, 8) + b"\x01" * 8,
    "noise": bytes(np.random.default_rng(0).integers(0, 256, 64,
                                                     dtype=np.uint8)),
}


def _expect_close(s):
    s.settimeout(10)
    try:
        assert s.recv(1024) == b""          # orderly close
    except ConnectionResetError:
        pass


@pytest.mark.parametrize("case", list(FUZZ))
def test_fuzzed_frames_end_the_session(case):
    srv = _server()
    with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as s:
        s.sendall(FUZZ[case])
        _expect_close(s)
    _finished(srv)


def test_truncated_init_payload_closes_session():
    srv = _server()
    payload = struct.pack("<III", 1000, 1000, 1000)   # counts, no arrays
    with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as s:
        s.sendall(protocol.pack_header(protocol.MSG_INIT, len(payload))
                  + payload)
        _expect_close(s)
    _finished(srv)
    assert srv.engine is None


def test_step_before_init_is_ignored():
    topo = _cube()
    srv = _server()
    with PBDClient(port=srv.port) as cli:
        cli.sock.sendall(protocol.pack_step(DT))
        cli.init(topo.vertices, topo.edges, topo.tets, params=WIRE,
                 pinned=PINNED)
        pos = cli.step(DT)
    _finished(srv)
    np.testing.assert_array_equal(pos, _solo(topo, 1)[0])


# --------------------------------------------------------------------------
# native server, watchdog, CLI
# --------------------------------------------------------------------------

def test_native_server_session_matches_solo():
    topo = _cube()
    srv = NativePBDServer(port=0, verbose=False, device="cpu")
    srv.start_background().wait_ready()
    replies = _session(srv.port, topo, 5)
    srv._thread.join(timeout=30.0)
    assert not srv._thread.is_alive()
    for got, want in zip(replies, _solo(topo, 5)):
        np.testing.assert_array_equal(got, want)


def test_native_server_rejects_garbage():
    srv = NativePBDServer(port=0, verbose=False, device="cpu")
    srv.start_background().wait_ready()
    with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as s:
        s.sendall(b"NOTPBD1GARBAGE")
        _expect_close(s)
    srv._thread.join(timeout=30.0)
    assert not srv._thread.is_alive()


def test_watchdog_nan_rollback_matches_jax(jax_session):
    """10 healthy steps (two snapshots), a NaN injected, 5 more steps: one
    rollback on both sides, to the same step and positions (the JAX
    server's Engine and the port's, each built by its server's
    mapping)."""
    cfg = dict(check_every=5)
    j = jax_session[1].reset(pinned=PINNED, inv_mass_mode="tet")
    t = engine_from_init(_init(_cube()), "cpu")
    jw = JWatchdog(j, JWatchdogConfig(**cfg))
    tw = Watchdog(t, WatchdogConfig(**cfg))
    for _ in range(10):
        assert jw.step(DT) and tw.step(DT)
    np.testing.assert_allclose(t.positions(), j.positions(), atol=TOL)
    js, ts = j.state, t.state
    j.state = JState(x=js.x.at[0, 0].set(jnp.nan), v=js.v,
                     x_star=js.x_star, inv_mass=js.inv_mass,
                     edge_lambda=js.edge_lambda, tet_lambda=js.tet_lambda)
    x_bad = ts.x.clone()
    x_bad[0, 0] = float("nan")
    t.state = SimState(x=x_bad, v=ts.v, x_star=ts.x_star,
                       inv_mass=ts.inv_mass, edge_lambda=ts.edge_lambda,
                       tet_lambda=ts.tet_lambda)
    j_ok = [jw.step(DT) for _ in range(5)]
    t_ok = [tw.step(DT) for _ in range(5)]
    assert j_ok == t_ok and not all(t_ok)
    assert jw.rollbacks == tw.rollbacks == 1
    assert jw._steps == tw.steps == 5
    np.testing.assert_allclose(t.positions(), j.positions(), atol=TOL)
    assert np.isfinite(t.positions()).all()


def test_cli_info_bench_tetra_scene(tmp_path, capsys):
    cli_main(["info"])
    out = capsys.readouterr().out
    assert "torch" in out and "native PBD1 server lib: built" in out
    with pytest.raises(SystemExit) as e:
        cli_main(["bench"])
    assert e.value.code != 0 and "The port's bench" in str(e.value.code)
    v, f = sbt.meshes.icosphere(2)
    obj = tmp_path / "ball.obj"
    tio.write_obj(str(obj), v * 0.3, triangles=f)
    out_path = tmp_path / "ball.tet.npz"
    cli_main(["tetra", str(obj), "-o", str(out_path), "--resolution", "6"])
    topo = tio.load_topology(str(out_path))
    assert topo.num_tets > 0
    assert f"T={topo.num_tets}" in capsys.readouterr().out
    cli_main(["scene", "sample", "--device", "cpu", "--seconds", "0.5"])
    out = capsys.readouterr().out
    assert "GroupedSceneEngine on cpu" in out and "min_y =" in out


def test_servers_and_cli_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, the servers and ``serve`` raise rather than fall
    back to the CPU; a native library that cannot be built raises rather
    than fall back to the Python server."""
    from softbodysim_torch.api import native_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PBDServer(port=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NativePBDServer(port=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["serve", "--port", "0"])
    monkeypatch.setattr(native_server, "_SRC", str(tmp_path / "none.cpp"))
    native_server.get_lib.cache_clear()
    try:
        with pytest.raises(OSError):
            NativePBDServer(port=0, device="cpu")
        assert not native_server.available()
    finally:
        native_server.get_lib.cache_clear()
