"""Native (C++) PBD1 server front-end.

The comm loop, framing, and sockets run in C++ (native/pbdnet.cpp --
the reference's Net.cpp/Server.cpp layers), while INIT/STEP dispatch into
the port's Engine through ctypes callbacks.  This is the architecture
parity point for the reference's native runtime: C++ owns the wire, the
card owns the compute.

The library is compiled with ``g++`` at first use into the port's own
build directory (``softbodysim_torch/_build/native/``, named by a hash of
the source: ``core/native.py::build_shared``).  A failed build
raises: nothing gives way to the Python server (``api/server.py``).

    python -m softbodysim_torch.api.native_server --port 7777
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional

from ..core.native import build_shared
from ..core.state import resolve_device
from . import protocol
from .engine import Engine
from .server import ReplyBuffer, device_work, engine_from_init

_SRC = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
    "pbdnet.cpp"))

_INIT_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                            ctypes.c_uint64)
_STEP_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_float,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                            ctypes.POINTER(ctypes.c_uint64))
_READY_CB = ctypes.CFUNCTYPE(None, ctypes.c_int)

@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The built library with ``sb_serve``'s signature set; raises when it
    cannot be built or loaded."""
    lib = ctypes.CDLL(build_shared(_SRC, "pbdnet"))
    lib.sb_serve.restype = ctypes.c_int
    lib.sb_serve.argtypes = [ctypes.c_int, _INIT_CB, _STEP_CB, _READY_CB,
                             ctypes.c_int]
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (OSError, RuntimeError):
        return False
    return True


class NativePBDServer:
    """Single-client PBD1 server with a native comm loop; the session's
    Engine runs on ``device`` (default: the card)."""

    def __init__(self, port: int = 7777, verbose: bool = True, device=None):
        self.port = port
        self.verbose = verbose
        self.device = resolve_device(device)
        self.engine: Optional[Engine] = None
        self._reply: Optional[ReplyBuffer] = None  # alive until the next step
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lib = get_lib()
        # keep callback objects referenced for the server's lifetime
        self._cb_init = _INIT_CB(self._on_init)
        self._cb_step = _STEP_CB(self._on_step)
        self._cb_ready = _READY_CB(self._on_ready)

    # -- callbacks (invoked from the C++ comm thread; ctypes grabs the GIL;
    # device_work makes the session's device current on that thread)
    def _on_ready(self, port: int):
        self.port = port
        self._ready.set()

    def _on_init(self, payload_ptr, size: int) -> int:
        try:
            payload = ctypes.string_at(payload_ptr, size)
            init = protocol.unpack_init(payload)
            self.engine = self._reply = None
            self.engine = engine_from_init(init, self.device)
            with device_work(self.device):
                self._reply = ReplyBuffer(len(init.x0), self.device)
            if self.verbose:
                print(f"[pbdnet] Init: V={len(init.x0)} E={len(init.edges)} "
                      f"T={len(init.tets)} backend={self.engine.backend}",
                      flush=True)
            return 0
        except Exception as e:  # malformed INIT ends the session
            if self.verbose:
                print(f"[pbdnet] bad INIT: {type(e).__name__}: {e}",
                      flush=True)
            return 1

    def _on_step(self, dt: float, out_pos, out_count) -> int:
        try:
            if self.engine is None:
                out_count[0] = 0
                out_pos[0] = ctypes.cast(
                    None, ctypes.POINTER(ctypes.c_float))
                return 0
            with device_work(self.device):
                self.engine.step(float(dt))
                self._reply.enqueue(self.engine)
            # C-contiguous f32, pinned; raises if a sweep launch of the
            # step timed out (the step fails, and the session ends)
            pos = self._reply.wait()
            out_pos[0] = pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            out_count[0] = pos.size
            return 0
        except Exception as e:   # a failed step ends the session
            if self.verbose:
                print(f"[pbdnet] step failed: {type(e).__name__}: {e}",
                      flush=True)
            return 1

    # -- lifecycle
    def serve_one(self) -> int:
        """Blocking: C++ accept + comm loop; returns sb_serve's code (0 on
        an orderly session end) when the session ends."""
        return self._lib.sb_serve(self.port, self._cb_init, self._cb_step,
                                  self._cb_ready, 1 if self.verbose else 0)

    def start_background(self) -> "NativePBDServer":
        self._thread = threading.Thread(target=self.serve_one, daemon=True)
        self._thread.start()
        return self

    def wait_ready(self, timeout: float = 10.0) -> "NativePBDServer":
        self._ready.wait(timeout)
        return self


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="PBD1 server with native (C++) comm loop")
    ap.add_argument("--port", type=int, default=7777)
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: cuda:0)")
    args = ap.parse_args(argv)
    NativePBDServer(port=args.port, device=args.device).serve_one()


if __name__ == "__main__":
    main()
