"""Bench config 5 (BASELINE.json:11): 4096 independent 256-body worlds
vmapped on one chip, deterministic replay — the RL-style workload the
north-star throughput target is defined on."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Capacity, SolverConfig
from ..parallel import replicate_world
from ..shapes import Shape
from ..state import WorldBuilder
from .base import Scene


def _single_world(n_bodies: int, substeps: int):
    b = WorldBuilder(gravity=(0.0, -9.81))
    n_dyn = n_bodies - 3
    cols = int(np.ceil(np.sqrt(n_dyn * 2)))
    spacing = 1.1
    x0 = -(cols - 1) * spacing / 2
    # wall centers clear the spawn grid: inner face at grid extent + 0.7, so
    # edge bodies (half-extent 0.45) spawn with a 0.25 gap instead of inside
    # the wall (a 0.25 spawn overlap used to launch them at the
    # depenetration-velocity cap)
    half_width = -x0 + 1.2
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(half_width + 2.0, 0.5), friction=0.5)
    wl = b.add_static(pos=(-half_width, 10.0))
    b.add_collider(wl, Shape.box(0.5, 20.0), friction=0.5)
    wr = b.add_static(pos=(half_width, 10.0))
    b.add_collider(wr, Shape.box(0.5, 20.0), friction=0.5)
    for i in range(n_dyn):
        row, col = divmod(i, cols)
        body = b.add_body(pos=(x0 + col * spacing, 0.6 + row * spacing))
        if i % 2 == 0:
            b.add_collider(body, Shape.circle(0.45), friction=0.5)
        else:
            b.add_collider(body, Shape.box(0.45, 0.45), friction=0.5)

    # measured: this scene peaks at ~2.6 candidate pairs/body while settling;
    # 4x/body is ~1.5x headroom (overflow counters guard the margin)
    cap = Capacity(
        max_bodies=n_bodies,
        max_colliders=n_bodies,
        max_pairs=max(4 * n_bodies, 512),
        max_joints=0,
        max_verts=4,
    )
    world, cap = b.build(cap)
    cfg = SolverConfig(dt=1 / 60, substeps=substeps)
    return world, cap, cfg


def batchify(scene: Scene, n_worlds: int, seed: int = 0,
             noise: float = 0.05) -> Scene:
    """Turn any single-world scene into an ``n_worlds`` batch: replicates
    the world and adds per-world deterministic velocity perturbations so
    worlds diverge. Capacities and config are the scene's own."""
    batched = replicate_world(scene.world, n_worlds)

    key = jax.random.PRNGKey(seed)
    dyn = (batched.bodies.inv_mass > 0)[..., None]
    vel = jnp.where(
        dyn,
        batched.bodies.vel + noise * jax.random.normal(
            key, batched.bodies.vel.shape, jnp.float32),
        batched.bodies.vel,
    )
    batched = dataclasses.replace(
        batched, bodies=dataclasses.replace(batched.bodies, vel=vel)
    )
    return Scene(f"batched_{scene.name}", batched, scene.capacity,
                 scene.config)


def batched_worlds(
    n_worlds: int = 4096,
    n_bodies: int = 256,
    substeps: int = 10,
    seed: int = 0,
) -> Scene:
    """``n_worlds`` copies of a 256-body settling scene with per-world
    deterministic initial-velocity perturbations (so worlds diverge but
    replays are bit-identical — BASELINE.json:11)."""
    world, cap, cfg = _single_world(n_bodies, substeps)
    batched = replicate_world(world, n_worlds)

    key = jax.random.PRNGKey(seed)
    dyn = (batched.bodies.inv_mass > 0)[..., None]
    noise = 0.1 * jax.random.normal(key, batched.bodies.vel.shape, jnp.float32)
    vel = jnp.where(dyn, batched.bodies.vel + noise, batched.bodies.vel)
    batched = dataclasses.replace(
        batched, bodies=dataclasses.replace(batched.bodies, vel=vel)
    )
    return Scene("batched_worlds", batched, cap, cfg)
