"""Big-single-world scene shapes on the XLA tier, cut to CPU size: compound
piles (two colliders per body), jointed piles (distance dumbbells and weld
pairs) and island sleeping (exact freeze of quiet sleepers, wake on a fast
impact). The full-size scenes run on the GPU in ``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import starframe_tpu as sf
from starframe_tpu.config import Capacity, SolverConfig
from starframe_tpu.shapes import Shape
from starframe_tpu.state import WorldBuilder
from starframe_tpu.step import step


def _run(world, cfg, max_pairs, frames):
    stepj = jax.jit(lambda w: step(w, cfg, max_pairs))
    for _ in range(frames):
        world, _, diag = stepj(world)
        diag.assert_no_overflow()
    return world, diag


# ---------------------------------------------------------------------------
# compound pile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_compound_pile_settles_without_overflow(seed):
    """``pile_compound`` at CPU size: dumbbells and L-shapes fall into a
    pile with no truncation, no deep overlap and nothing through the floor;
    each body's two colliders move as one rigid body."""
    scene = sf.scenes.pile_compound(n_bodies=48, seed=seed)
    w0 = scene.world
    assert w0.colliders.m > w0.bodies.n  # two colliders per dynamic body
    w, diag = _run(w0, scene.config, scene.capacity.max_pairs, 90)
    pos = np.asarray(w.bodies.pos)
    dyn = np.asarray(w.bodies.inv_mass) > 0
    assert np.isfinite(pos).all()
    assert (pos[dyn, 1] > 0.0).all(), "a compound fell through the floor"
    assert float(diag.max_penetration) < 0.05
    assert int(diag.touching_count) > 0
    # fell: every body is lower than it started
    assert (pos[dyn, 1] <= np.asarray(w0.bodies.pos)[dyn, 1] + 1e-3).all()


def test_compound_pile_batched_matches_single():
    """Compound worlds under vmap match the single-world step exactly."""
    scene = sf.scenes.pile_compound(n_bodies=24, seed=3)
    batch = sf.scenes.batchify(scene, 3, seed=2)
    cfg, mp = batch.config, batch.capacity.max_pairs
    out = sf.make_batched_step(cfg, mp, donate=False)(batch.world)
    one = sf.make_step(cfg, mp, donate=False)(
        sf.parallel.world_slice(batch.world, 1))
    np.testing.assert_allclose(np.asarray(out.bodies.pos[1]),
                               np.asarray(one.bodies.pos), atol=1e-5)


# ---------------------------------------------------------------------------
# jointed pile
# ---------------------------------------------------------------------------


def _jointed_world(pairs=6, weld_pairs=3):
    """Ground + distance-jointed circle dumbbells + welded box pairs."""
    b = WorldBuilder(gravity=(0.0, -9.81))
    r = 0.4
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(60.0, 0.5), friction=0.3)
    joints, welds = [], []
    for i in range(pairs):
        x = -15.0 + 3.0 * i
        a = b.add_body(pos=(x, 2.0), angle=0.1 * (i % 5))
        b.add_collider(a, Shape.circle(r), friction=0.3, restitution=0.1)
        c = b.add_body(pos=(x + 1.2, 2.6))
        b.add_collider(c, Shape.circle(r), friction=0.3, restitution=0.1)
        b.distance_joint(a, c)
        joints.append((a, c))
    for i in range(weld_pairs):
        x = 10.0 + 3.0 * i
        a = b.add_body(pos=(x, 1.5))
        b.add_collider(a, Shape.box(0.4, 0.3), friction=0.3)
        c = b.add_body(pos=(x + 0.9, 1.5))
        b.add_collider(c, Shape.box(0.4, 0.3), friction=0.3)
        b.weld_joint(a, c)
        welds.append((a, c))
    n = 1 + 2 * (pairs + weld_pairs)
    cap = Capacity(max_bodies=n, max_colliders=n, max_pairs=16 * n,
                   max_joints=pairs + weld_pairs, max_verts=4)
    world, cap = b.build(cap)
    return world, cap, joints, welds


@pytest.mark.parametrize("joint_solver", ["colored", "jacobi"])
def test_jointed_pile_keeps_constraints(joint_solver):
    """Distance joints hold their rest length through the landing and weld
    pairs keep their relative pose, on both joint solvers."""
    world, cap, joints, welds = _jointed_world()
    cfg = SolverConfig(substeps=8, joint_solver=joint_solver,
                       max_joint_colors=2, broadphase="grid",
                       grid_cell_capacity=10)
    out, _ = _run(world, cfg, cap.max_pairs, 60)
    pos = np.asarray(out.bodies.pos)
    ang = np.asarray(out.bodies.angle)
    pos0 = np.asarray(world.bodies.pos)
    assert (pos[1:, 1] > 0.0).all()
    for a, c in joints:
        rest = np.linalg.norm(pos0[a] - pos0[c])
        assert abs(np.linalg.norm(pos[a] - pos[c]) - rest) < 0.05, (a, c)
    for a, c in welds:
        rel0 = pos0[c] - pos0[a]
        rot = np.array([[np.cos(ang[a]), -np.sin(ang[a])],
                        [np.sin(ang[a]), np.cos(ang[a])]])
        assert np.linalg.norm(pos[c] - pos[a] - rot @ rel0) < 0.05, (a, c)
        assert abs(ang[c] - ang[a]) < 0.05


def test_pile_joints_scene_sleeps_dumbbells_as_pairs():
    """``pile_joints`` at CPU size: no truncation while falling, and the
    island rule never leaves one half of a dumbbell asleep while its
    partner is awake."""
    scene = sf.scenes.pile_joints(n_bodies=40, joint_fraction=0.5)
    cfg = dataclasses.replace(scene.config, sleep_frames=5)
    w, _ = _run(scene.world, cfg, scene.capacity.max_pairs, 150)
    j = w.joints
    live = np.asarray(j.jtype[: j.j]) != sf.state.JOINT_OFF
    asleep = np.asarray(w.bodies.sleep_count) >= cfg.sleep_frames
    ja = np.asarray(j.body_a[: j.j])[live]
    jb = np.asarray(j.body_b[: j.j])[live]
    assert len(ja) > 0
    np.testing.assert_array_equal(asleep[ja], asleep[jb])


# ---------------------------------------------------------------------------
# island sleeping: exact freeze and wake
# ---------------------------------------------------------------------------


def _presleep(world, idx, sleep_frames):
    """Force bodies ``idx`` into the asleep state (counter run out, v = 0)."""
    b = world.bodies
    idx = np.asarray(idx)
    return dataclasses.replace(world, bodies=dataclasses.replace(
        b, sleep_count=b.sleep_count.at[idx].set(sleep_frames),
        vel=b.vel.at[idx].set(0.0), ang_vel=b.ang_vel.at[idx].set(0.0)))


def _sleep_scene(n=41):
    """Ground + a resting row (to be put to sleep) + an awake falling row
    confined to the left third, so the right-side sleepers see no contact."""
    b = WorldBuilder(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(100.0, 0.5), friction=0.5)
    half = (n - 1) // 2
    sleepers = []
    for i in range(n - 1):
        if i < half:
            x = -((half - 1) * 1.3) / 2 + i * 1.3
            body = b.add_body(pos=(x, 0.45))
            sleepers.append(int(body))
        else:
            per_row = max(half // 3, 1)
            j = i - half
            x = -((half - 1) * 1.3) / 2 + (j % per_row) * 1.3 + 0.37
            body = b.add_body(pos=(x, 3.0 + (j // per_row) * 1.2))
        b.add_collider(body, Shape.circle(0.45), friction=0.5,
                       restitution=0.3)
    cap = Capacity(max_bodies=n, max_colliders=n, max_pairs=8 * n,
                   max_joints=0, max_verts=4)
    world, cap = b.build(cap)
    return world, cap, sleepers


SLEEP_CFG = SolverConfig(substeps=4, sleep_velocity=0.05, sleep_frames=10)


def test_quiet_sleepers_stay_bit_frozen():
    world, cap, sleepers = _sleep_scene()
    world = _presleep(world, sleepers, SLEEP_CFG.sleep_frames)
    out, _ = _run(world, SLEEP_CFG, cap.max_pairs, 12)
    # the right half of the sleeping row sees no awake body: bit-frozen
    far = sleepers[len(sleepers) // 2 + 2:]
    np.testing.assert_array_equal(np.asarray(out.bodies.pos)[far],
                                  np.asarray(world.bodies.pos)[far])
    assert (np.asarray(out.bodies.sleep_count)[far]
            >= SLEEP_CFG.sleep_frames).all()


@pytest.mark.parametrize("batched", [False, True])
def test_fast_impact_wakes_struck_sleeper(batched):
    """A fast body dropped onto one sleeper wakes it (counter reset) while
    far sleepers stay asleep — alone and under vmap."""
    world, cap, sleepers = _sleep_scene()
    world = _presleep(world, sleepers, SLEEP_CFG.sleep_frames)
    b = world.bodies
    awake_idx = sleepers[-1] + 1
    target = sleepers[len(sleepers) // 4]
    tx = float(np.asarray(b.pos)[target, 0])
    world = dataclasses.replace(world, bodies=dataclasses.replace(
        b, pos=b.pos.at[awake_idx].set(jnp.asarray([tx, 1.4])),
        vel=b.vel.at[awake_idx].set(jnp.asarray([0.0, -8.0]))))
    if batched:
        worlds = sf.parallel.replicate_world(world, 2)
        stepb = sf.make_batched_step(SLEEP_CFG, cap.max_pairs, donate=False)
        for _ in range(8):
            worlds = stepb(worlds)
        out = sf.parallel.world_slice(worlds, 1)
    else:
        out, _ = _run(world, SLEEP_CFG, cap.max_pairs, 8)
    counts = np.asarray(out.bodies.sleep_count)
    assert counts[target] < SLEEP_CFG.sleep_frames
    far = sleepers[3 * len(sleepers) // 4:]
    assert (counts[far] >= SLEEP_CFG.sleep_frames).all()
