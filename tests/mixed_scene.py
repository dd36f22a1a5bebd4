"""Shared test scene: one static ground + ``n - 1`` mixed dynamic circles and
boxes with random initial velocities, settling into contact within a few
frames."""

import numpy as np

from starframe_tpu.config import Capacity
from starframe_tpu.shapes import Shape
from starframe_tpu.state import WorldBuilder


def mixed_scene(n=128, seed=0):
    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(40.0, 0.5), friction=0.5)
    cols = int(np.ceil(np.sqrt((n - 1) * 2)))
    for i in range(n - 1):
        row, col = divmod(i, cols)
        pos = (-(cols - 1) * 0.55 + col * 1.1 + rng.uniform(-0.05, 0.05),
               0.7 + row * 1.1)
        body = b.add_body(pos=pos, vel=rng.normal(scale=0.3, size=2),
                          ang_vel=float(rng.normal(scale=0.2)))
        shape = Shape.circle(0.45) if i % 2 == 0 else Shape.box(0.4, 0.35)
        b.add_collider(body, shape, friction=0.5, restitution=0.2)
    cap = Capacity(max_bodies=n, max_colliders=n, max_pairs=8 * n,
                   max_joints=0, max_verts=4)
    return b.build(cap)
