"""PBD1 TCP server backed by the port's Engine (the card by default).

Drop-in replacement for the reference's C++ PBDServer (CProgram/):
single-client, lock-step MSG_INIT -> (MSG_STEP -> MSG_POSITIONS)* ->
MSG_SHUTDOWN (Server.cpp:20-149), with the same CLI surface as main.cpp:18-25
(``--port P --mode serial|parallel [--threads N]``).  The serial/parallel
stepper choice of the reference is meaningless here -- the card's kernels
replace the thread pool -- so both modes map to the same engine (the flag
is accepted and logged for compatibility).

Beyond the reference: ``--pipeline`` overlaps device compute with the
network round trip, and ``--multi`` serves MANY concurrent clients, each
session with its own Engine.  Sessions of one device enqueue their device
work one at a time, on the device's current stream, under one lock per
device (``device_work``): a CUDA graph capture (the coloured step's first
use) then never overlaps another session's launches, and the cooperative
sweep kernels, which each fill the card, never run side by side.  Sessions
still overlap on the host and the network: a session builds its INIT's
host plans, waits for its reply's copy and sends it without holding the
lock.  A step whose sweep launch timed out ends its session unsent.

Each reply is copied into the session's pinned host buffer with a
``non_blocking`` copy and a CUDA event, enqueued under the lock; the
session waits on that event only.  In pipelined mode the reply to STEP k
(step k-1's positions) is copied and sent before step k is dispatched, so
it never waits for step k, and the step's host dispatch and device time
both overlap the client's frame.

The 1 Hz stats line mirrors Sim.cpp:412-417.
"""

from __future__ import annotations

import argparse
import contextlib
import socket
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.state import SolverParams, resolve_device
from ..core.topology import build_topology
from ..perf.timing import StepStats
from ..solver.select import resolve_backend
from ..solver.xpbd_sweep import sweep_host
from . import protocol
from .engine import Engine

# per device, the lock every session holds while it enqueues device work
# (builds its Engine, dispatches a step, enqueues a reply's copy): the
# device is one per process, whatever the servers
_DEVICE_LOCKS: dict = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


@contextlib.contextmanager
def device_work(device: torch.device):
    """Hold ``device``'s lock, with the device current on this thread (a
    thread that C++ or a server created starts on device 0)."""
    with _DEVICE_LOCKS_GUARD:
        lock = _DEVICE_LOCKS.setdefault(str(device), threading.RLock())
    with lock:
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield


def engine_from_init(init: protocol.InitMessage, device) -> Engine:
    """The wire -> Engine mapping: the 12 wire parameters over the
    SolverParams defaults (xpbd dialect), the wire topology kept exactly
    as sent (orient=False, so rest state matches the client's intent) and
    tet-volume inverse masses (the server variant).

    The host work (the topology; on the sweep backend its plans and
    schedules) runs first, and only the Engine's device work holds the
    device's lock: a session's INIT stalls other sessions' steps only for
    its uploads."""
    device = resolve_device(device)
    wp = init.params
    params = SolverParams(
        dialect="xpbd",
        substeps=max(1, wp.substeps),
        iterations=max(1, wp.iterations),
        edge_compliance=wp.edge_compliance,
        volume_compliance=wp.volume_compliance,
        gravity=tuple(wp.gravity),
        ground_enabled=bool(wp.ground_enabled),
        ground_y=wp.ground_y,
        friction=wp.friction,
    )
    topo = build_topology(
        init.x0, init.tets.astype(np.int64),
        edges=init.edges.astype(np.int64),
        surface_tris=np.zeros((0, 3), np.int64), orient=False)
    kw = {}
    if resolve_backend(topo, params, device=device) == "sweep":
        kw["host"] = sweep_host(topo, params, device)
    with device_work(device):
        return Engine(topo, params, pinned=init.pinned, inv_mass_mode="tet",
                      device=device, **kw)


class ReplyBuffer:
    """A session's reply: (V, 3) f32 in host memory (pinned for a CUDA
    device), filled by an asynchronous copy whose event ``wait`` waits
    on."""

    def __init__(self, num_particles: int, device: torch.device):
        self.device = device
        self.host = torch.empty((num_particles, 3), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self._copied: Optional[torch.cuda.Event] = None
        self._engine: Optional[Engine] = None

    def enqueue(self, engine: Engine) -> None:
        """Copy the engine's committed positions, in stream order; call
        with the device's lock held."""
        self.host.copy_(engine.positions_device(), non_blocking=True)
        self._engine = engine
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))

    def wait(self) -> np.ndarray:
        """The copied positions, once the copy has landed (a view of the
        buffer: valid until the next ``enqueue``).  Raises RuntimeError
        if a sweep launch of the engine aborted on a timed-out wait before
        the copy: those positions are not valid."""
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None
        self._engine.raise_on_timeouts()
        return self.host.numpy()


class _Session:
    """Per-connection world state (engine, reply buffer, stats)."""

    def __init__(self, sid: int):
        self.sid = sid
        self.engine: Optional[Engine] = None
        self.reply: Optional[ReplyBuffer] = None
        self.stats = StepStats()
        self.frames = 0
        self.last_print = time.perf_counter()


class PBDServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 7777,
                 mode: str = "serial", verbose: bool = True,
                 pipeline: bool = False, view: bool = False,
                 view_port: int = 8900, device=None):
        self.host = host
        self.port = port
        self.mode = mode
        self.verbose = verbose
        # every session's Engine runs here (default: the card; raises
        # without one -- nothing falls back to the CPU)
        self.device = resolve_device(device)
        # Pipelined mode (extension over the reference's lock-step protocol,
        # Server.cpp:115-137): the reply to STEP k carries the positions of
        # step k-1, so device compute of step k overlaps the network round
        # trip and the client's frame work, at one frame of latency.
        self.pipeline = pipeline
        self.engine: Optional[Engine] = None   # session 0's engine (tests)
        self.stats = StepStats()               # session 0's stats
        self.init_seconds: Optional[float] = None   # session 0's last INIT
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._running = False
        self._accepting = False
        self._nsid = 0
        self._clients: list = []
        self._clients_lock = threading.Lock()
        # live browser viewport (reference: real-time Unity viewport; here a
        # render/live.py HTTP stream fed per MSG_STEP; session 0 only)
        self.view = view
        self.view_port = view_port
        self._viewer = None

    # -- lifecycle --
    def start_background(self, multi: bool = False) -> "PBDServer":
        """Listen + serve on a background thread (for tests and in-process
        embedding).  ``multi=True`` serves concurrent clients."""
        self._listen(backlog=16 if multi else 1)
        target = self.serve_forever if multi else self.serve_one
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return self

    def _listen(self, backlog: int = 1):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        if self.port == 0:
            self.port = self._sock.getsockname()[1]
        self._sock.listen(backlog)
        self._ready.set()
        self._log(f"listening on {self.host}:{self.port} mode={self.mode} "
                  f"device={self.device}")

    def wait_ready(self, timeout: float = 10.0):
        self._ready.wait(timeout)
        return self

    def serve_one(self):
        """Accept a single client and run the comm loop (the reference is
        single-client, Net.cpp:57-102)."""
        if self._sock is None:
            self._listen()
        client, addr = self._sock.accept()
        client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._log(f"client connected from {addr}")
        self._running = True
        try:
            self._comm_loop(client, self._new_session())
        except OSError as e:
            # socket torn down under the loop (stop() during a read, client
            # vanished): end the session, don't crash the serve thread
            self._log(f"session ended by socket error: {e}")
        finally:
            client.close()
            self._sock.close()
            self._running = False
            self._log("shut down")

    def serve_forever(self):
        """Accept clients until ``stop()``; one comm-loop thread per client,
        each with its own engine.  A client's MSG_SHUTDOWN ends only its
        session (multi-session semantics; the single-client mode keeps the
        reference's shutdown-the-server behavior)."""
        if self._sock is None:
            self._listen(backlog=16)
        self._running = True
        self._accepting = True
        threads = []
        while self._accepting:
            try:
                client, addr = self._sock.accept()
            except OSError:
                if not self._accepting:
                    break           # listener closed by stop()
                # transient accept failure (ECONNABORTED, fd exhaustion):
                # keep serving -- existing sessions must not strand future
                # clients
                time.sleep(0.05)
                continue
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ses = self._new_session()
            with self._clients_lock:
                self._clients.append(client)
            self._log(f"client {ses.sid} connected from {addr}")

            def run(client=client, ses=ses):
                try:
                    self._comm_loop(client, ses)
                except OSError as e:
                    self._log(f"client {ses.sid} socket error: {e}")
                finally:
                    client.close()
                    with self._clients_lock:
                        if client in self._clients:
                            self._clients.remove(client)
                    self._log(f"client {ses.sid} session ended")

            th = threading.Thread(target=run, daemon=True)
            th.start()
            threads = [t for t in threads if t.is_alive()]
            threads.append(th)
        for th in threads:
            th.join(timeout=5.0)
        self._running = False
        self._log("shut down")

    def stop(self):
        """End serve_forever: stop accepting, close the listener AND the
        live client sockets (comm loops unblock with EOF/error and their
        sessions end; without this, stop() would stall on reads)."""
        self._accepting = False
        if self._sock is not None:
            # shutdown wakes a thread blocked in accept(); close alone
            # does not on Linux
            for end in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                        self._sock.close):
                try:
                    end()
                except OSError:
                    pass
        with self._clients_lock:
            clients = list(self._clients)
        for c in clients:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # join the background serve thread so no session thread is still
        # inside a recv when the caller proceeds to tear down state
        th = self._thread
        if th is not None and th is not threading.current_thread():
            th.join(timeout=10.0)
        if self._viewer is not None:
            self._viewer.stop()
            self._viewer = None

    def _new_session(self) -> _Session:
        ses = _Session(self._nsid)
        self._nsid += 1
        if ses.sid == 0:
            ses.stats = self.stats      # session 0 reports on the server
        return ses

    def _maybe_publish(self, pos, ses: _Session):
        """Feed the live viewport (serve --view): lazily created at the
        first frame (the surface comes from the INIT'd topology).
        Session 0 only -- one viewport per server."""
        if not self.view or ses.sid != 0 or ses.engine is None:
            return
        if self._viewer is None:
            from ..render.live import LiveViewer

            self._viewer = LiveViewer(
                ses.engine.topology.surface_tris, None,
                port=self.view_port, title="PBD1 live")
            self._log(f"live viewer at {self._viewer.url}")
        self._viewer.publish(pos)

    # -- protocol --
    def _comm_loop(self, client: socket.socket, ses: _Session):
        while True:
            msg = protocol.read_message(client)
            if msg is None:
                break
            msg_type, payload = msg

            if msg_type == protocol.MSG_INIT:
                try:
                    self._handle_init(payload, ses)
                except Exception as e:
                    # malformed INIT: end the session cleanly (the C++
                    # reference would crash-parse; we close instead)
                    self._log(f"bad INIT: {type(e).__name__}: {e}")
                    break
            elif msg_type == protocol.MSG_STEP:
                if len(payload) < 4:
                    break
                if ses.engine is None:
                    continue  # reference ignores STEP before INIT
                dt = float(np.frombuffer(payload[:4], "<f4")[0])
                try:
                    pos = self._step(client, ses, dt)
                except OSError:
                    raise
                except Exception as e:
                    # a failed step (a sweep launch that timed out) ends
                    # the session; its positions are never sent
                    self._log(f"session {ses.sid} step failed: "
                              f"{type(e).__name__}: {e}")
                    break
                self._maybe_publish(pos, ses)
                self._tick_stats(ses)
            elif msg_type == protocol.MSG_SHUTDOWN:
                break
            else:
                break  # unknown type tears the session down (Server.cpp:141-143)

    def _step(self, client: socket.socket, ses: _Session,
              dt: float) -> np.ndarray:
        """One STEP: the step and the reply (of this step, or in pipelined
        mode of the one before); returns the positions sent."""
        if self.pipeline:
            # reply with step k-1's positions, then dispatch step k: its
            # host dispatch and device time overlap the client's frame
            pos = self._reply(client, ses)
            with ses.stats.scope("step"), device_work(self.device):
                ses.engine.step(dt)
        else:
            with ses.stats.scope("step"), device_work(self.device):
                ses.engine.step(dt)
            pos = self._reply(client, ses)
        return pos

    def _reply(self, client: socket.socket, ses: _Session) -> np.ndarray:
        """Copy the committed positions to the host and send them; returns
        them (a view of the session's buffer)."""
        with ses.stats.scope("wait"):
            with device_work(self.device):
                ses.reply.enqueue(ses.engine)
            pos = ses.reply.wait()
        with ses.stats.scope("pack"):
            client.sendall(protocol.pack_positions(pos))
        return pos

    def _handle_init(self, payload: bytes, ses: _Session):
        t0 = time.perf_counter()
        init = protocol.unpack_init(payload)
        ses.engine = ses.reply = None       # a re-INIT frees the old world
        ses.engine = engine_from_init(init, self.device)
        with device_work(self.device):
            ses.reply = ReplyBuffer(len(init.x0), self.device)
        init_s = time.perf_counter() - t0
        if ses.sid == 0:
            self.engine = ses.engine    # exposed for tests / embedding
            self.init_seconds = init_s
            # a re-INIT replaces the world (Server.cpp:106-110): drop the
            # live viewer so the next publish rebuilds on the new topology
            if self._viewer is not None:
                self._viewer.stop()
                self._viewer = None
        self._log(
            f"Init received (session {ses.sid}). V={len(init.x0)} "
            f"E={len(init.edges)} T={len(init.tets)} "
            f"pinned={len(init.pinned)} backend={ses.engine.backend} "
            f"make {init_s:.2f} s")

    def _tick_stats(self, ses: _Session):
        ses.frames += 1
        now = time.perf_counter()
        if now - ses.last_print >= 1.0 and self.verbose:
            topo = ses.engine.topology
            line = ses.stats.report(
                prefix=f"[PBDServer s{ses.sid}] Mode={self.mode} "
                       f"V={topo.num_particles} "
                       f"E={topo.num_edges} "
                       f"T={topo.num_tets} |")
            print(line, flush=True)
            ses.frames = 0
            ses.last_print = now

    def _log(self, msg: str):
        if self.verbose:
            print(f"[PBDServer] {msg}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="PBD1 soft-body server (the port's engine on the card)")
    ap.add_argument("--port", type=int, default=7777)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--mode", choices=["serial", "parallel"],
                    default="serial",
                    help="accepted for reference-CLI parity; both modes run "
                         "the same engine")
    ap.add_argument("--threads", type=int, default=0,
                    help="ignored (the card's kernels replace the thread "
                         "pool)")
    ap.add_argument("--pipeline", action="store_true",
                    help="reply to STEP k with step k-1's positions so "
                         "device compute overlaps the network round trip "
                         "(one-frame latency; protocol extension)")
    ap.add_argument("--multi", action="store_true",
                    help="serve many concurrent clients, one engine per "
                         "session (a client's SHUTDOWN ends only its "
                         "session)")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: cuda:0)")
    args = ap.parse_args(argv)
    srv = PBDServer(host=args.host, port=args.port, mode=args.mode,
                    pipeline=args.pipeline, device=args.device)
    if args.multi:
        srv.serve_forever()
    else:
        srv.serve_one()


if __name__ == "__main__":
    main()
