"""Continuous collision detection (bullet bodies).

Reference surface: starframe/Box2D bullet semantics (SURVEY.md §2 row 6's
CCD deferral closed in r3): a body flagged ``bullet=True`` must not tunnel
through thin geometry at ANY speed. Array-program realization: no per-pair
TOI root-finding loop — the frame's speculative manifolds already carry
frame-start normals + anchors, so the clamp is one fused P-last pass
(kernels.bullet_advance_scale) + a scatter-min, inside the same jitted
substep.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from starframe_tpu.config import SolverConfig
from starframe_tpu.shapes import Shape
from starframe_tpu.state import WorldBuilder
from starframe_tpu.step import step_world

CFG = SolverConfig(dt=1 / 60, substeps=10, ccd=True)
WALL_FACE = -0.15  # wall half-width 0.1 + bullet radius 0.05


def _bullet_world(speed, restitution=0.0, bullet=True, target="static"):
    wb = WorldBuilder()
    wb.gravity = (0.0, 0.0)
    wall = wb.add_body(pos=(0.0, 0.0), body_type=target)
    wb.add_collider(wall, Shape.box(0.1, 2.0), restitution=restitution)
    b = wb.add_body(pos=(-3.0, 0.0), vel=(speed, 0.0), bullet=bullet)
    wb.add_collider(b, Shape.circle(0.05), restitution=restitution)
    return wb.build()


def _run(w, cfg, frames=30):
    stepj = jax.jit(lambda w: step_world(w, cfg, max_pairs=16))
    for _ in range(frames):
        w = stepj(w)
    return w


@pytest.mark.parametrize("speed", [200.0, 1000.0, 10000.0])
def test_bullet_never_tunnels(speed):
    w, _ = _bullet_world(speed)
    w = _run(w, CFG)
    x = float(w.bodies.pos[1, 0])
    # stopped ON the near face (within contact margin + ccd slop)
    assert WALL_FACE - 0.06 < x <= WALL_FACE + 0.01, x


def test_without_ccd_fast_bullet_crosses():
    """Pins the failure mode the feature exists for: at 1000 m/s one substep
    jumps the whole wall and the rate-capped discrete solve extrudes the
    body out the FAR side."""
    w, _ = _bullet_world(1000.0, bullet=False)
    w = _run(w, dataclasses.replace(CFG, ccd=False))
    assert float(w.bodies.pos[1, 0]) > 0.0


def test_bullet_restitution_sees_true_approach_speed():
    """The TOI clamp scales positions, not velocities: the velocity pass
    must see the full 1000 m/s approach and reflect ~e * v."""
    w, _ = _bullet_world(1000.0, restitution=0.9)
    w = _run(w, CFG, frames=10)
    vx = float(w.bodies.vel[1, 0])
    assert -950.0 < vx < -820.0, vx


def test_bullet_into_dynamic_target_transfers_momentum():
    w, _ = _bullet_world(500.0, target="dynamic")
    w = _run(w, CFG)
    # no tunnel: bullet stays behind the (now moving) wall body
    assert float(w.bodies.pos[1, 0]) < float(w.bodies.pos[0, 0])
    # momentum went somewhere real: the wall picked up forward speed
    assert float(w.bodies.vel[0, 0]) > 0.1


def test_ccd_inert_for_unflagged_scenes():
    """ccd=True must not perturb ordinary scenes: no body is flagged, so
    trajectories match the ccd=False run bitwise."""
    def build():
        wb = WorldBuilder()
        wb.gravity = (0.0, -10.0)
        g = wb.add_body(pos=(0.0, -0.5), body_type="static")
        wb.add_collider(g, Shape.box(5.0, 0.5))
        b = wb.add_body(pos=(0.1, 2.0), vel=(1.0, 0.0))
        wb.add_collider(b, Shape.box(0.2, 0.2), restitution=0.4)
        return wb.build()

    w_on, _ = build()
    w_off, _ = build()
    w_on = _run(w_on, CFG, frames=60)
    w_off = _run(w_off, dataclasses.replace(CFG, ccd=False), frames=60)
    assert jnp.array_equal(w_on.bodies.pos, w_off.bodies.pos)
    assert jnp.array_equal(w_on.bodies.angle, w_off.bodies.angle)


def test_ccd_requires_frame_manifolds():
    w, _ = _bullet_world(100.0)
    bad = dataclasses.replace(CFG, manifold_refresh="substep")
    with pytest.raises(ValueError, match="manifold_refresh"):
        step_world(w, bad, max_pairs=16)


# ---------------------------------------------------------------------------
# batched worlds: the same TOI clamp under vmap, so batched RL workloads with
# bullet projectiles keep CCD (BASELINE.json:11 is the workload shape)
# ---------------------------------------------------------------------------

import numpy as np

from starframe_tpu import parallel as par
from starframe_tpu.config import Capacity


def _bullet_batch(speed, restitution=0.0, target="static", n=8, worlds=4):
    """``_bullet_world`` plus far-away filler bodies, replicated into a world
    batch with per-world speeds ``speed * (1 + 0.1 * w)``."""
    wb = WorldBuilder()
    wb.gravity = (0.0, 0.0)
    wall = wb.add_body(pos=(0.0, 0.0), body_type=target)
    wb.add_collider(wall, Shape.box(0.1, 2.0), restitution=restitution)
    b = wb.add_body(pos=(-3.0, 0.0), vel=(speed, 0.0), bullet=True)
    wb.add_collider(b, Shape.circle(0.05), restitution=restitution)
    for i in range(n - 2):
        pad = wb.add_body(pos=(1000.0 + 10.0 * i, 0.0))
        wb.add_collider(pad, Shape.circle(0.3))
    cap = Capacity(max_bodies=n, max_colliders=n, max_pairs=4 * n,
                   max_joints=0, max_verts=4)
    w, cap = wb.build(cap)
    batch = par.replicate_world(w, worlds)
    scale = 1.0 + 0.1 * jnp.arange(worlds, dtype=jnp.float32)
    vel = batch.bodies.vel.at[:, 1, 0].multiply(scale)
    batch = dataclasses.replace(
        batch, bodies=dataclasses.replace(batch.bodies, vel=vel))
    return batch, cap


def _run_batch(worlds, cfg, frames, max_pairs=32):
    stepb = jax.jit(lambda w: par.batched_step(w, cfg, max_pairs))
    for _ in range(frames):
        worlds = stepb(worlds)
    return worlds


@pytest.mark.parametrize("speed", [200.0, 1000.0, 10000.0])
def test_batched_bullet_never_tunnels(speed):
    worlds, _ = _bullet_batch(speed)
    worlds = _run_batch(worlds, CFG, frames=30)
    x = np.asarray(worlds.bodies.pos[:, 1, 0])
    assert ((WALL_FACE - 0.06 < x) & (x <= WALL_FACE + 0.01)).all(), x


@pytest.mark.parametrize("speed", [1000.0, 10000.0])
def test_batched_without_ccd_bullet_crosses(speed):
    """The failure mode the clamp prevents, per world of the batch (at these
    speeds one substep jumps the whole wall)."""
    worlds, _ = _bullet_batch(speed)
    worlds = _run_batch(worlds, dataclasses.replace(CFG, ccd=False), 30)
    assert (np.asarray(worlds.bodies.pos[:, 1, 0]) > 0.0).all()


def test_batched_bullet_restitution_sees_true_approach_speed():
    worlds, _ = _bullet_batch(1000.0, restitution=0.9, worlds=1)
    worlds = _run_batch(worlds, CFG, frames=10)
    vx = np.asarray(worlds.bodies.vel[:, 1, 0])
    assert ((-950.0 < vx) & (vx < -820.0)).all(), vx


def test_batched_bullet_into_dynamic_target_transfers_momentum():
    worlds, _ = _bullet_batch(500.0, target="dynamic")
    worlds = _run_batch(worlds, CFG, frames=30)
    assert (np.asarray(worlds.bodies.pos[:, 1, 0])
            < np.asarray(worlds.bodies.pos[:, 0, 0])).all()
    assert (np.asarray(worlds.bodies.vel[:, 0, 0]) > 0.1).all()


def test_batched_ccd_inert_for_unflagged_scenes():
    """ccd=True under vmap must not perturb unflagged batches: every TOI
    factor is exactly 1, the where() keeps poses bitwise."""
    from starframe_tpu.state import BODY_BULLET

    worlds, _ = _bullet_batch(2.0)
    b = worlds.bodies
    worlds = dataclasses.replace(
        worlds, bodies=dataclasses.replace(b, flags=b.flags & ~BODY_BULLET))
    on = _run_batch(worlds, CFG, frames=20)
    off = _run_batch(worlds, dataclasses.replace(CFG, ccd=False), frames=20)
    assert jnp.array_equal(on.bodies.pos, off.bodies.pos)
    assert jnp.array_equal(on.bodies.angle, off.bodies.angle)
    assert jnp.array_equal(on.bodies.vel, off.bodies.vel)
