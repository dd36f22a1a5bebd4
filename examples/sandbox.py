#!/usr/bin/env python
"""Sandbox demo — the analog of starframe's ``examples/sandbox``
(SURVEY.md §2 row 19): pick a scene, simulate it headlessly, interact
programmatically (spawn / grab), and render frames to SVG.

Usage::

    python examples/sandbox.py --scene box_stack --seconds 5 --render out/
    python examples/sandbox.py --scene mechanism --grab 0,6 --seconds 3
    python examples/sandbox.py --list

``--grab x,y`` demonstrates the mouse-grab flow (SURVEY.md §3.3): a point
query picks the body under the cursor, a temporary distance joint drags it
toward the point for the first second.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import starframe_tpu as sf
from starframe_tpu import runtime

SCENES = {
    "box_stack": lambda: sf.scenes.box_stack(),
    "pile": lambda: sf.scenes.pile(n_bodies=500),
    "rope_bridge": lambda: sf.scenes.rope_bridge(),
    "mechanism": lambda: sf.scenes.mechanism(),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="box_stack", choices=sorted(SCENES))
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--render", default=None, help="directory for SVG frames")
    ap.add_argument("--render-every", type=int, default=30)
    ap.add_argument("--grab", default=None, help="x,y world point to grab/drag")
    ap.add_argument("--cast", default=None,
                    help="x,y dir_x,dir_y: sweep a unit circle and report "
                         "the first hit (shape_cast demo)")
    ap.add_argument("--lit", default=None,
                    help="PNG path: render the final frame with the "
                         "radiance-cascades GI pass")
    ap.add_argument("--html", default=None,
                    help="HTML path: write the snapshot-player viewer")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    if args.list:
        print("\n".join(sorted(SCENES)))
        return

    runtime.configure()
    scene = SCENES[args.scene]()
    world = scene.world

    grab = None
    if args.grab:
        # mouse-grab flow (SURVEY.md §3.3): point query picks the body under
        # the cursor, then a kinematic cursor body + a soft runtime pin joint
        # drag it for the first second. Capacities are static, so spare rows
        # are appended once up front; spawning into them never recompiles.
        gx, gy = (float(v) for v in args.grab.split(","))
        world = sf.state.expand_capacity(world, extra_bodies=1, extra_joints=1)
        picked = sf.queries.pick_body(world, (gx, gy))
        if picked < 0:
            print(f"grab at ({gx}, {gy}): nothing there")
        else:
            world, cursor = sf.spawn_body(world, pos=(gx, gy),
                                          body_type="kinematic")
            world, joint = sf.spawn_joint(
                world, sf.JOINT_PIN, cursor, picked,
                anchor_b=sf.queries.body_local_point(world, picked, (gx, gy)),
                compliance=2e-4, damping=20.0,
            )
            grab = dict(cursor=cursor, joint=joint, start=np.array([gx, gy]),
                        target=np.array([gx + 2.0, gy + 1.5]))
            print(f"grab at ({gx}, {gy}): body {picked}, dragging to "
                  f"{grab['target']}")

    from starframe_tpu.step import make_step

    if args.cast:
        # swept-shape query demo (SURVEY.md §2 row 12): a unit circle flying
        # through the scene — e.g. a projectile trajectory probe
        origin, direction = args.cast.split(" ") if " " in args.cast \
            else args.cast.split(";") if ";" in args.cast else (args.cast, "1,0")
        ox, oy = (float(v) for v in origin.split(","))
        dx, dy = (float(v) for v in direction.split(","))
        sh = sf.Shape.circle(0.5)
        hit = sf.queries.shape_cast(world, sh.verts, len(sh.verts), sh.radius,
                                    0.0, (ox, oy), (dx * 30, dy * 30))
        if bool(hit.hit):
            print(f"shape_cast from ({ox},{oy}): hit collider "
                  f"{int(hit.collider)} (body {int(hit.body)}) at t="
                  f"{float(hit.t):.3f}, point {np.asarray(hit.point)}")
        else:
            print(f"shape_cast from ({ox},{oy}): no hit within 30 units")

    step = make_step(scene.config, scene.capacity.max_pairs,
                     with_contacts=True, donate=False)
    n_frames = int(args.seconds * 60)
    events = sf.ContactEvents()
    snapshots = []

    t0 = time.perf_counter()
    for f in range(n_frames):
        if grab is not None and f <= 60:
            t = min(f / 60.0, 1.0)
            cur = grab["start"] * (1 - t) + grab["target"] * t
            world = sf.set_body_pose(world, grab["cursor"], pos=cur)
            if f == 60:  # release
                world = sf.despawn_joint(world, grab["joint"])
                world = sf.despawn_body(world, grab["cursor"])
                print(f"frame {f}: released grab")
        world, contacts, diag = step(world)
        events.update(contacts)
        if events.started:
            print(f"frame {f}: contact started {sorted(events.started)[:4]}")
        if args.render and f % args.render_every == 0:
            os.makedirs(args.render, exist_ok=True)
            sf.observer.render_svg(world, os.path.join(args.render, f"f{f:05d}.svg"),
                                   contacts=contacts)
        if args.html and f % args.render_every == 0:
            snapshots.append(world)
    if args.html and snapshots:
        sf.observer.export_html(args.html, snapshots)
        print(f"wrote viewer: {args.html} ({len(snapshots)} frames)")
    if args.lit:
        # radiance-cascades GI over the final frame with a light above
        pos = np.asarray(world.bodies.pos)
        lo = pos.min(0) - 4.0
        hi = pos.max(0) + 4.0
        light = sf.lighting.Light(pos=((lo[0] + hi[0]) / 2, hi[1] - 1.0),
                                  intensity=3.0, radius=0.8)
        img = sf.lighting.illuminate(world, [light], lo, hi, res=256)
        sf.lighting.save_png(args.lit, img)
        print(f"wrote lit frame: {args.lit}")

    diag.assert_no_overflow()
    dt = time.perf_counter() - t0
    ke = float(np.asarray(diag.kinetic_energy))
    print(f"{args.scene}: {n_frames} frames in {dt:.2f}s "
          f"({n_frames / dt:.0f} fps) | final KE {ke:.3f} | "
          f"{int(diag.touching_count)} touching pairs")


if __name__ == "__main__":
    main()
