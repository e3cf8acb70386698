"""PBD1 wire protocol: framing and payload codecs (pure ``struct`` /
NumPy; the bytes are those of ``softbodysim_tpu/api/protocol.py``).

Byte-compatible with the reference protocol so the original Unity client
(PBDRemoteWorld) could connect to this server unchanged:

  header     12 bytes {magic u32 = 0x31444250 ('PBD1' LE), type u32,
             payload size u32}            (PBDServer.h:47-62)
  MSG_INIT   V,E,T u32; SolverParams {substeps u32, iterations u32,
             dtHint f32, omega f32, edgeCompliance f32, volumeCompliance
             f32, gravity f32x3, groundEnabled u32, groundY f32, friction
             f32}; pinnedCount u32 + pinned u32[]; x0 f32[V*3];
             edges u32[E*2]; tets u32[T*4]  (Server.cpp:30-113, mirrored by
             PBDRemoteWorld.SendInit, PBDRemoteWorld.cs:278-349)
  MSG_STEP   dt f32                       (Server.cpp:115-137)
  MSG_POSITIONS  f32[V*3]                 (Server.cpp:10-18)
  MSG_SHUTDOWN   empty                    (Server.cpp:138-139)

All little-endian.  Note the reference deserializes ``omega`` and ``dtHint``
but never reads them in the solver (dead params, SURVEY.md section 5); we
keep them in the wire struct for compatibility and likewise ignore them in
the XPBD engine.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
from typing import Optional, Tuple

import numpy as np

MAGIC = 0x31444250  # 'PBD1' little-endian

MSG_INIT = 1
MSG_STEP = 2
MSG_POSITIONS = 3
MSG_SHUTDOWN = 4

_HEADER = struct.Struct("<III")
_PARAMS = struct.Struct("<IIffff3fIff")


@dataclasses.dataclass
class WireParams:
    """The 12-field wire SolverParams (PBDServer.h:147-161)."""

    substeps: int = 2
    iterations: int = 6
    dt_hint: float = 1.0 / 60.0
    omega: float = 1.6          # dead on the server path (kept for parity)
    edge_compliance: float = 5e-4
    volume_compliance: float = 0.0
    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    ground_enabled: int = 1
    ground_y: float = 0.0
    friction: float = 0.2

    def pack(self) -> bytes:
        return _PARAMS.pack(
            self.substeps, self.iterations, self.dt_hint, self.omega,
            self.edge_compliance, self.volume_compliance,
            self.gravity[0], self.gravity[1], self.gravity[2],
            self.ground_enabled, self.ground_y, self.friction)

    @staticmethod
    def unpack(buf: bytes, offset: int = 0) -> Tuple["WireParams", int]:
        vals = _PARAMS.unpack_from(buf, offset)
        p = WireParams(
            substeps=vals[0], iterations=vals[1], dt_hint=vals[2],
            omega=vals[3], edge_compliance=vals[4], volume_compliance=vals[5],
            gravity=(vals[6], vals[7], vals[8]), ground_enabled=vals[9],
            ground_y=vals[10], friction=vals[11])
        return p, offset + _PARAMS.size


@dataclasses.dataclass
class InitMessage:
    params: WireParams
    pinned: np.ndarray        # (P,) u32
    x0: np.ndarray            # (V, 3) f32
    edges: np.ndarray         # (E, 2) u32
    tets: np.ndarray          # (T, 4) u32


def pack_header(msg_type: int, size: int) -> bytes:
    return _HEADER.pack(MAGIC, msg_type, size)


def pack_init(msg: InitMessage) -> bytes:
    x0 = np.ascontiguousarray(msg.x0, "<f4")
    edges = np.ascontiguousarray(msg.edges, "<u4")
    tets = np.ascontiguousarray(msg.tets, "<u4")
    pinned = np.ascontiguousarray(msg.pinned, "<u4")
    v, e, t = len(x0), len(edges), len(tets)
    payload = b"".join([
        struct.pack("<III", v, e, t),
        msg.params.pack(),
        struct.pack("<I", len(pinned)),
        pinned.tobytes(),
        x0.tobytes(),
        edges.tobytes(),
        tets.tobytes(),
    ])
    return pack_header(MSG_INIT, len(payload)) + payload


def unpack_init(payload: bytes) -> InitMessage:
    v, e, t = struct.unpack_from("<III", payload, 0)
    off = 12
    params, off = WireParams.unpack(payload, off)
    (pinned_count,) = struct.unpack_from("<I", payload, off)
    off += 4
    pinned = np.frombuffer(payload, "<u4", pinned_count, off).copy()
    off += 4 * pinned_count
    x0 = np.frombuffer(payload, "<f4", v * 3, off).reshape(v, 3).copy()
    off += 12 * v
    edges = np.frombuffer(payload, "<u4", e * 2, off).reshape(e, 2).copy()
    off += 8 * e
    tets = np.frombuffer(payload, "<u4", t * 4, off).reshape(t, 4).copy()
    return InitMessage(params=params, pinned=pinned, x0=x0, edges=edges,
                       tets=tets)


def pack_step(dt: float) -> bytes:
    payload = struct.pack("<f", dt)
    return pack_header(MSG_STEP, len(payload)) + payload


def pack_positions(pos: np.ndarray) -> bytes:
    buf = np.ascontiguousarray(pos, "<f4").tobytes()
    return pack_header(MSG_POSITIONS, len(buf)) + buf


def pack_shutdown() -> bytes:
    return pack_header(MSG_SHUTDOWN, 0)


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Blocking exact-read loop (Net.cpp:27-41); None on EOF."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


MAX_PAYLOAD = 1 << 30  # 1 GiB sanity cap (the reference trusts the header)


def read_message(sock: socket.socket) -> Optional[Tuple[int, bytes]]:
    """Read one framed message; None on EOF, bad magic, or an absurd
    payload size (Server.cpp:4-8: bad magic tears the session down; the
    size cap is a hardening addition over the reference)."""
    hdr = recv_exact(sock, _HEADER.size)
    if hdr is None:
        return None
    magic, msg_type, size = _HEADER.unpack(hdr)
    if magic != MAGIC or size > MAX_PAYLOAD:
        return None
    payload = recv_exact(sock, size) if size else b""
    if payload is None:
        return None
    return msg_type, payload
