"""PBD1 client -- the PBDRemoteWorld counterpart.

Implements the client half of the wire protocol
(Assets/Scripts/Softbody/PBDRemoteWorld.cs:187-349): connect with NoDelay,
send one INIT carrying the full SoA topology, then lock-step
STEP(dt) -> POSITIONS round trips with one request in flight, and a
best-effort SHUTDOWN on close.

The socket timeout defaults to ``INIT_TIMEOUT``: the server builds its
engine when INIT arrives (host plans: seconds at the north star; at a
process's first launch also the kernel build), so the first STEP's reply
carries that make time.
"""

from __future__ import annotations

import socket
from typing import Optional

import numpy as np

from . import protocol
from .protocol import InitMessage, WireParams

# seconds a reply may take: above the north star's make time at INIT
INIT_TIMEOUT = 300.0


class RemoteWorld:
    """Asynchronous remote-sim client -- full PBDRemoteWorld parity.

    Reference behavior (PBDRemoteWorld.cs): a background net thread
    ("PBDRemoteNet", :127-129) owns the socket; the game thread requests
    steps (one in flight, :201-246); results land in a back buffer swapped
    under a lock (:235-243); the main thread pumps the front buffer when
    fresh (:138-147).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 7777,
                 timeout: float = INIT_TIMEOUT):
        import threading

        self._cli = PBDClient(host, port, timeout=timeout)
        self._lock = threading.Lock()
        self._step_requested = threading.Event()
        self._stop = threading.Event()
        self._front: Optional[np.ndarray] = None
        self._back: Optional[np.ndarray] = None
        self._fresh = False
        self._dt = 1.0 / 60.0
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._net_loop, name="PBDRemoteNet", daemon=True)

    def init(self, x0, edges, tets, params=None, pinned=None):
        self._cli.init(x0, edges, tets, params=params, pinned=pinned)
        self._thread.start()
        return self

    def _net_loop(self):
        try:
            while not self._stop.is_set():
                if not self._step_requested.wait(timeout=0.05):
                    continue
                self._step_requested.clear()
                dt = self._dt
                pos = self._cli.step(dt)
                with self._lock:
                    self._back = pos
                    self._front, self._back = self._back, self._front
                    self._fresh = True
        except BaseException as e:  # surface net errors to the caller
            self._error = e

    def request_step(self, dt: float = 1.0 / 60.0) -> bool:
        """Non-blocking step request; False if one is already in flight."""
        if self._error:
            raise self._error
        if self._step_requested.is_set():
            return False
        self._dt = dt
        self._step_requested.set()
        return True

    def pump_positions(self) -> Optional[np.ndarray]:
        """Latest positions if a new frame arrived since the last pump,
        else None (PumpPositionsToMesh semantics)."""
        if self._error:
            raise self._error
        with self._lock:
            if not self._fresh:
                return None
            self._fresh = False
            return self._front

    def close(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        self._cli.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PBDClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 7777,
                 timeout: float = INIT_TIMEOUT):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.num_particles = 0

    def init(self, x0: np.ndarray, edges: np.ndarray, tets: np.ndarray,
             params: Optional[WireParams] = None,
             pinned: Optional[np.ndarray] = None):
        msg = InitMessage(
            params=params or WireParams(),
            pinned=np.asarray(
                pinned if pinned is not None else [], np.uint32),
            x0=np.asarray(x0, np.float32).reshape(-1, 3),
            edges=np.asarray(edges, np.uint32).reshape(-1, 2),
            tets=np.asarray(tets, np.uint32).reshape(-1, 4),
        )
        self.num_particles = len(msg.x0)
        self.sock.sendall(protocol.pack_init(msg))

    def step(self, dt: float) -> np.ndarray:
        """Lock-step request/response: returns (V, 3) world positions."""
        self.sock.sendall(protocol.pack_step(dt))
        msg = protocol.read_message(self.sock)
        if msg is None:
            raise ConnectionError("server closed during STEP")
        msg_type, payload = msg
        if msg_type != protocol.MSG_POSITIONS:
            raise ConnectionError(f"unexpected reply type {msg_type}")
        return np.frombuffer(payload, "<f4").reshape(-1, 3).copy()

    def close(self):
        try:
            self.sock.sendall(protocol.pack_shutdown())
        except OSError:
            pass
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
