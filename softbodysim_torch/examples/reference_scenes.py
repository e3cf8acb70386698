"""Run the reference's benchmark scenes (SampleScene / 4fumoTest /
ExtremeTest / BatchTest analogs) and print the manager-style 1 Hz stats
line (SoftBodyManager.cs:183-192 format family).  The bodies are the
reference's Unity assets when SOFTBODYSIM_REFERENCE names its checkout,
procedural stand-ins otherwise.

    python -m softbodysim_torch.examples.reference_scenes --scene sample \
        --seconds 3 [--device cuda]
    python -m softbodysim_torch.examples.reference_scenes --scene extreme \
        --seconds 5
"""

import argparse
import time

import numpy as np

from softbodysim_torch.api.scenes import ALL_SCENES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=sorted(ALL_SCENES), default="sample")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dt", type=float, default=1.0 / 60.0)
    ap.add_argument("--export", metavar="OUT.html", default=None,
                    help="record every step and write a playable WebGL "
                         "animation (plus OUT_frames/*.obj with --export-obj)")
    ap.add_argument("--export-obj", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scene = ALL_SCENES[args.scene]()
    total_particles = sum(t.num_particles for _, t, _, _ in scene.bodies)
    total_cons = sum(t.num_edges + t.num_tets for _, t, _, _ in scene.bodies)
    print(f"[{scene.name}] bodies={len(scene.bodies)} "
          f"particles={total_particles} constraints={total_cons}")

    world = scene.build_world(fixed_dt=args.dt, device=args.device)
    world.step()  # warm-up: the first step builds and captures
    world.stats.reset()

    recorder = None
    if args.export:
        from softbodysim_torch.render.viewer import AnimationRecorder

        recorder = AnimationRecorder()
        for body in world.bodies:
            recorder.add_body(body.topology.surface_tris, body.positions)

    t_end = time.time() + args.seconds
    last_report = time.time()
    steps = 0
    while time.time() < t_end:
        world.step()
        steps += 1
        if recorder is not None:
            recorder.capture()
        if time.time() - last_report >= 1.0:
            print(world.stats.report(
                prefix=f"[{scene.name}] Bodies {len(world.bodies)} |"))
            last_report = time.time()

    if recorder is not None:
        obj_dir = (args.export.rsplit(".", 1)[0] + "_frames"
                   if args.export_obj else None)
        out = recorder.export(args.export, fps=int(round(1.0 / args.dt)),
                              title=scene.name, obj_dir=obj_dir)
        print(f"wrote {out} ({recorder.num_frames} frames)")

    positions = world.positions()
    for name, pos in positions.items():
        assert np.isfinite(pos).all(), f"{name} diverged"
    print("all bodies finite; min_y =",
          min(p[:, 1].min() for p in positions.values()))
    return steps, positions


if __name__ == "__main__":
    main()
