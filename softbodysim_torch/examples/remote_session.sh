#!/bin/sh
# Two-process PBD1 session: a server on the card and a client over TCP --
# the reference's Unity <-> PBDServer topology (PBD1 wire protocol,
# byte-compatible).
#
#     sh softbodysim_torch/examples/remote_session.sh [PORT] [DEVICE]
#
# DEVICE is the server's torch device (default cuda); the client needs
# none.
set -e
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
PORT="${1:-7791}"
DEVICE="${2:-cuda}"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

python -m softbodysim_torch.api.server --port "$PORT" --mode parallel \
    --device "$DEVICE" &
SERVER_PID=$!

python - "$PORT" <<'PY'
import sys
import time

import numpy as np

from softbodysim_torch.api.client import PBDClient
from softbodysim_torch.api.protocol import WireParams
from softbodysim_torch.core import meshes

port = int(sys.argv[1])
topo = meshes.tet_cube(3, 3, 3, size=0.6, center=(0, 0.8, 0))
for _ in range(120):                 # the server is up within a minute
    try:
        cli = PBDClient(port=port)
        break
    except OSError:
        time.sleep(0.5)
else:
    sys.exit("no PBD1 server on port %d" % port)
with cli:
    cli.init(topo.vertices, topo.edges, topo.tets,
             params=WireParams(substeps=2, iterations=6))
    for _ in range(90):
        pos = cli.step(1 / 60)
    print("client: final min_y=%.4f  finite=%s" %
          (pos[:, 1].min(), np.isfinite(pos).all()))
PY

wait $SERVER_PID 2>/dev/null || true
