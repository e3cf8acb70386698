"""Multi-session serving: one server, N concurrent PBD1 clients.

The reference PBDServer is single-client (Net.cpp:57-102): one process
per simulation.  With ``start_background(multi=True)`` this server gives
every connection its own Engine on one device, and the sessions' device
work interleaves under one lock per device -- one card serving N
independent simulations over the unmodified PBD1 wire protocol.

    python -m softbodysim_torch.examples.multi_client [--steps 30] \
        [--device cuda]
"""

import argparse
import threading

import numpy as np

from softbodysim_torch.api.client import PBDClient
from softbodysim_torch.api.protocol import WireParams
from softbodysim_torch.api.server import PBDServer
from softbodysim_torch.core import meshes

N_CLIENTS, DT = 3, 1 / 60


def client_session(port, tag, center_y, steps, results):
    topo = meshes.tet_ball(1, 0.25, (0.0, center_y, 0.0))
    with PBDClient(port=port, timeout=600.0) as cli:
        cli.init(topo.vertices, topo.edges, topo.tets,
                 params=WireParams(substeps=2, iterations=4))
        for _ in range(steps):
            pos = cli.step(DT)
        results[tag] = pos
        print(f"client {tag}: {steps} steps, "
              f"min_y={pos[:, 1].min():.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    srv = PBDServer(port=0, verbose=False, device=args.device)
    srv.start_background(multi=True).wait_ready()
    print(f"multi-session server on port {srv.port}")

    results = {}
    threads = [
        threading.Thread(target=client_session,
                         args=(srv.port, i, 0.8 + 0.3 * i, args.steps,
                               results))
        for i in range(N_CLIENTS)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.stop()

    assert len(results) == N_CLIENTS
    for tag, pos in sorted(results.items()):
        assert np.isfinite(pos).all()
    print(f"{N_CLIENTS} concurrent sessions served; all trajectories finite")
    return results


if __name__ == "__main__":
    main()
