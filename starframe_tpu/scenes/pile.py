"""Bench config 2 (BASELINE.json:8): pyramid + pile stress — 10k convex
bodies settling under gravity (contact-heavy broadphase/narrowphase)."""

from __future__ import annotations

import numpy as np

from ..config import Capacity, SolverConfig
from ..shapes import Shape
from ..state import WorldBuilder
from .base import Scene


def _pile_config(b: WorldBuilder, substeps: int,
                 sleep_velocity: float = 0.1) -> SolverConfig:
    """Grid broadphase sized from the scene. While the pile falls, bodies
    whose swept AABB outgrows 1.5x the mean extent go to the broadphase's
    dense large set: the 10k pile peaked above the default 64 of them around
    frame 110 on an H100 (PERF.md, PR 1), so the large set scales with the
    collider count."""
    return SolverConfig(dt=1 / 60, substeps=substeps, broadphase="grid",
                        grid_cell_capacity=b.suggest_grid_cell_capacity(),
                        max_large=max(64, len(b._colliders) // 32),
                        sleep_velocity=sleep_velocity, sleep_frames=30)


def pile(
    n_bodies: int = 10_000,
    body_half: float = 0.5,
    friction: float = 0.5,
    seed: int = 0,
    substeps: int = 10,
    container_half_width: float = None,
    sleep: bool = True,
) -> Scene:
    """Mixed boxes/hexagons/circles packed in a grid above a container, falling
    into a pile. Sized so the settled pile is several bodies deep."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))

    cols = int(np.ceil(np.sqrt(n_bodies * 4)))
    rows = int(np.ceil(n_bodies / cols))
    spacing = body_half * 2.2
    if container_half_width is None:
        container_half_width = cols * spacing / 2 + 2.0

    # container: floor + two walls
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(container_half_width + 2.0, 0.5), friction=friction)
    wl = b.add_static(pos=(-container_half_width, rows * spacing))
    b.add_collider(wl, Shape.box(0.5, rows * spacing + 4.0), friction=friction)
    wr = b.add_static(pos=(container_half_width, rows * spacing))
    b.add_collider(wr, Shape.box(0.5, rows * spacing + 4.0), friction=friction)

    x0 = -(cols - 1) * spacing / 2
    count = 0
    for row in range(rows):
        for col in range(cols):
            if count >= n_bodies:
                break
            x = x0 + col * spacing + rng.uniform(-0.05, 0.05) * body_half
            y = body_half * 1.5 + row * spacing
            body = b.add_body(pos=(x, y), angle=float(rng.uniform(0, np.pi)))
            kind = rng.integers(0, 3)
            if kind == 0:
                b.add_collider(body, Shape.circle(body_half * 0.9), friction=friction)
            elif kind == 1:
                b.add_collider(body, Shape.box(body_half, body_half * 0.8), friction=friction)
            else:
                b.add_collider(body, Shape.hexagon(body_half), friction=friction)
            count += 1

    # capacities + grid fan-out come from the builder's scene-stat estimators
    # (SURVEY.md §7.8.1) — no hand-tuned numbers; overflow counters backstop
    world, cap = b.build()
    # sleeping on by default — the reference engine sleeps settled islands
    # (SURVEY.md §2 row 11). ``sleep=False`` keeps every body live (what
    # contact-event consumers that must observe sleeping pairs want).
    cfg = _pile_config(b, substeps, sleep_velocity=0.1 if sleep else 0.0)
    return Scene("pile", world, cap, cfg)


def pile_joints(
    n_bodies: int = 10_000,
    joint_fraction: float = 0.2,
    body_half: float = 0.5,
    friction: float = 0.5,
    seed: int = 0,
    substeps: int = 10,
) -> Scene:
    """Pile variant where ``joint_fraction`` of the bodies fall as
    distance-jointed dumbbells (the reference ticks joints in the same solve
    at any scale, SURVEY.md §3.2 step 4). Dumbbell pairs are disjoint, so
    the joint graph is 1-colorable and the joint pass costs one exact-GS
    sweep per substep."""
    import dataclasses

    from .base import tighten_joint_colors

    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))

    cols = int(np.ceil(np.sqrt(n_bodies * 4)))
    rows = int(np.ceil(n_bodies / cols))
    spacing = body_half * 2.2
    container_half_width = cols * spacing / 2 + 2.0

    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(container_half_width + 2.0, 0.5),
                   friction=friction)
    wl = b.add_static(pos=(-container_half_width, rows * spacing))
    b.add_collider(wl, Shape.box(0.5, rows * spacing + 4.0), friction=friction)
    wr = b.add_static(pos=(container_half_width, rows * spacing))
    b.add_collider(wr, Shape.box(0.5, rows * spacing + 4.0), friction=friction)

    x0 = -(cols - 1) * spacing / 2
    count = 0
    prev = None  # pending dumbbell partner (same grid row)
    n_joints = 0
    target_jointed = int(n_bodies * joint_fraction)
    for row in range(rows):
        prev = None
        for col in range(cols):
            if count >= n_bodies:
                break
            x = x0 + col * spacing + rng.uniform(-0.05, 0.05) * body_half
            y = body_half * 1.5 + row * spacing
            body = b.add_body(pos=(x, y), angle=float(rng.uniform(0, np.pi)))
            kind = rng.integers(0, 3)
            if kind == 0:
                b.add_collider(body, Shape.circle(body_half * 0.9),
                               friction=friction)
            elif kind == 1:
                b.add_collider(body, Shape.box(body_half, body_half * 0.8),
                               friction=friction)
            else:
                b.add_collider(body, Shape.hexagon(body_half),
                               friction=friction)
            count += 1
            if 2 * n_joints < target_jointed:
                if prev is None:
                    prev = body
                else:
                    b.distance_joint(prev, body)
                    prev = None
                    n_joints += 1

    world, cap = b.build()
    # sleeping on, as in pile(): settled dumbbells freeze as pairs
    cfg = tighten_joint_colors(world, _pile_config(b, substeps))
    return Scene("pile_joints", world, cap, cfg)


def pile_compound(
    n_bodies: int = 10_000,
    body_half: float = 0.5,
    friction: float = 0.5,
    seed: int = 0,
    substeps: int = 10,
) -> Scene:
    """Pile variant where every dynamic body is a COMPOUND: two-collider
    dumbbells and L-shapes (SURVEY.md §2 row 4's compound colliders [D],
    BASELINE.json:10, at the pile's own 10k scale)."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))

    # compounds are ~2 half-widths wide: sparser spacing than pile(), and
    # column count scaled so the lattice keeps pile()'s ~4:1 aspect (a
    # taller lattice means faster impacts)
    spacing = body_half * 3.4
    cols = int(np.ceil(np.sqrt(n_bodies * 4 * 3.4 / 2.2)))
    rows = int(np.ceil(n_bodies / cols))
    container_half_width = cols * spacing / 2 + 2.0

    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(container_half_width + 2.0, 0.5),
                   friction=friction)
    wl = b.add_static(pos=(-container_half_width, rows * spacing))
    b.add_collider(wl, Shape.box(0.5, rows * spacing + 4.0), friction=friction)
    wr = b.add_static(pos=(container_half_width, rows * spacing))
    b.add_collider(wr, Shape.box(0.5, rows * spacing + 4.0), friction=friction)

    x0 = -(cols - 1) * spacing / 2
    r = body_half * 0.55
    count = 0
    for row in range(rows):
        for col in range(cols):
            if count >= n_bodies:
                break
            x = x0 + col * spacing + rng.uniform(-0.05, 0.05) * body_half
            y = body_half * 1.5 + row * spacing
            body = b.add_body(pos=(x, y), angle=float(rng.uniform(0, np.pi)))
            if rng.integers(0, 2) == 0:  # dumbbell: two offset circles
                b.add_collider(body, Shape.circle(r), friction=friction,
                               offset=(-body_half * 0.6, 0.0))
                b.add_collider(body, Shape.circle(r), friction=friction,
                               offset=(body_half * 0.6, 0.0))
            else:  # L-shape: two offset boxes
                b.add_collider(body, Shape.box(body_half, body_half * 0.35),
                               friction=friction,
                               offset=(0.0, -body_half * 0.5))
                b.add_collider(body,
                               Shape.box(body_half * 0.35, body_half * 0.6),
                               friction=friction,
                               offset=(-body_half * 0.65, body_half * 0.45))
            count += 1

    world, cap = b.build()
    return Scene("pile_compound", world, cap, _pile_config(b, substeps))
