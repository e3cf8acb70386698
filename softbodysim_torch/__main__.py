"""Unified CLI: python -m softbodysim_torch <command>

Commands:
  serve   PBD1 TCP server (reference PBDServer CLI parity)
  scene   run a reference benchmark scene preset with 1 Hz stats
  bench   not ported yet (exits non-zero)
  info    torch / card / native and kernel library status
  tetra   tetrahedralize a closed OBJ into a .tet.npz asset

``serve`` and ``scene`` run on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _run_scene(args) -> None:
    from .api.scenes import ALL_SCENES
    from .core.state import resolve_device

    device = resolve_device(args.device)
    sc = ALL_SCENES[args.name]()
    # one merged mesh on the kernel backends is the card's path; fall back
    # to grouped batches on the CPU or for scenes that cannot merge
    merged = None
    if device.type == "cuda":
        try:
            merged, _ = sc.build_merged(device=device)
        except ValueError:
            merged = None
    viewer = None
    if args.view and merged is None:
        # per-body world path: concatenated surfaces, any scene
        world = sc.build_world(device=device)
        from .render.live import LiveViewer

        tris, off = [], 0
        for b in world.bodies:
            tris.append(np.asarray(b.topology.surface_tris, np.int64) + off)
            off += b.topology.num_particles

        def world_positions():
            return np.concatenate([b.positions() for b in world.bodies],
                                  axis=0)

        viewer = LiveViewer(np.concatenate(tris, 0), world_positions,
                            port=args.view_port, title=sc.name)
        print("live viewer at", viewer.url)
        eng = world
        burst = 1
    else:
        eng = (merged if merged is not None
               else sc.build_grouped(device=device))
        # merged engines advance in RUN_CHUNK bursts; grouped engines one
        # step per call
        burst = eng.RUN_CHUNK if merged is not None else 1
        if args.view and merged is not None:
            from .render.live import LiveViewer

            viewer = LiveViewer(merged.topology.surface_tris,
                                merged.positions,
                                port=args.view_port, title=sc.name)
            print("live viewer at", viewer.url)
            burst = 4                 # smoother frame cadence

    def advance():
        if burst > 1:
            eng.run(burst)
        else:
            eng.step()
        if viewer is not None:
            viewer.publish()

    block = getattr(eng, "block", None) or getattr(eng, "sync")
    print(f"[{sc.name}] {type(eng).__name__} on {device}, backend "
          f"{getattr(eng, 'backend', None)}", flush=True)
    advance()
    block()
    t_end = time.time() + args.seconds
    last = time.time()
    frames = 0
    while time.time() < t_end:
        advance()
        frames += burst
        if time.time() - last >= 1.0:
            block()
            print(f"[{sc.name}] {frames / (time.time() - last):.1f} "
                  "steps/s", flush=True)
            last = time.time()
            frames = 0
    block()
    if merged is not None:
        min_y = float(eng.positions()[:, 1].min())
    elif viewer is not None:
        min_y = float(world_positions()[:, 1].min())
    else:
        min_y = float(min(pos[:, 1].min() for _, pos in eng.positions()))
    if viewer is not None:
        viewer.stop()
    print("min_y =", min_y)


def _info() -> None:
    import torch

    from . import __version__
    from .api import native_server
    from .core.native import get_lib
    from .kernels import _build

    print(f"softbodysim_torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}")
        try:
            _build.load()
            kernels = f"built, {_build.library_path()}"
        except RuntimeError as e:
            kernels = f"build failed: {e}"
    else:
        print("devices: no CUDA device (pass --device cpu to serve / scene)")
        kernels = "not built (no CUDA device)"
    print(f"kernel library: {kernels}")
    print(f"native lib: {'built' if get_lib() is not None else 'NumPy fallback'}")
    print(f"native PBD1 server lib: "
          f"{'built' if native_server.available() else 'unavailable'}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="softbodysim_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    serve = sub.add_parser("serve", help="PBD1 TCP server")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=7777)
    serve.add_argument("--mode", choices=["serial", "parallel"],
                       default="serial")
    serve.add_argument("--threads", type=int, default=0)
    serve.add_argument("--view", action="store_true",
                       help="live browser viewport of the simulated body")
    serve.add_argument("--view-port", type=int, default=8900)
    serve.add_argument("--pipeline", action="store_true",
                       help="overlap device compute with the round trip "
                            "(reply carries the previous step's positions)")
    serve.add_argument("--multi", action="store_true",
                       help="serve many concurrent clients, one engine per "
                            "session")
    serve.add_argument("--device", default=None,
                       help="torch device of the engines (default: cuda:0)")

    scene = sub.add_parser("scene", help="run a benchmark scene preset")
    scene.add_argument("name", choices=["sample", "4fumo", "extreme",
                                        "batch"])
    scene.add_argument("--seconds", type=float, default=3.0)
    scene.add_argument("--view", action="store_true",
                       help="live browser viewport while the scene runs")
    scene.add_argument("--view-port", type=int, default=8900)
    scene.add_argument("--device", default=None,
                       help="torch device (default: cuda:0)")

    sub.add_parser("bench", help="throughput benchmark (not ported yet)")

    sub.add_parser("info", help="environment info")

    tetra = sub.add_parser(
        "tetra", help="tetrahedralize a closed OBJ into a .tet.npz asset")
    tetra.add_argument("input", help="closed triangle mesh (.obj)")
    tetra.add_argument("-o", "--output", required=True,
                       help="output topology file (.tet.npz)")
    tetra.add_argument("--no-snap", action="store_true",
                       help="keep the raw voxel hull (skip the "
                            "surface-conforming snap)")
    tetra.add_argument("--resolution", type=int, default=12,
                       help="voxels across the longest extent")

    args = ap.parse_args(argv)

    if args.cmd == "serve":
        from .api.server import PBDServer

        srv = PBDServer(host=args.host, port=args.port, mode=args.mode,
                        pipeline=args.pipeline, view=args.view,
                        view_port=args.view_port, device=args.device)
        srv.serve_forever() if args.multi else srv.serve_one()
    elif args.cmd == "scene":
        _run_scene(args)
    elif args.cmd == "bench":
        sys.exit("softbodysim_torch bench is not ported yet (ROADMAP.md "
                 "queue 1, 'The port's bench'); bench.py is the JAX "
                 "package's")
    elif args.cmd == "tetra":
        from .core.tetrahedralize import topology_from_obj
        from .io import save_topology

        topo = topology_from_obj(args.input, resolution=args.resolution,
                                 snap=not args.no_snap)
        save_topology(args.output, topo)
        print(f"{args.input} -> {args.output}: V={topo.num_particles} "
              f"E={topo.num_edges} T={topo.num_tets} "
              f"S={len(topo.surface_tris)}")
    elif args.cmd == "info":
        _info()


if __name__ == "__main__":
    main()
