"""The one jitted ``step``: broadphase → narrowphase → XPBD substeps → events.

The array-program equivalent of ``PhysicsWorld::tick`` (SURVEY.md §3.2; stage order
is driver-normative, BASELINE.json:5). The whole frame is a single traced
program: control crosses host↔device exactly once per frame — or once per
rollout via :func:`rollout`'s ``lax.scan`` — which is the discipline the 1e8
body-steps/sec target depends on (SURVEY.md §3.5, §7.8.5).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .broadphase import broadphase, compute_aabbs
from .config import Capacity, SolverConfig
from .contacts import Contacts
from .diagnostics import Diagnostics, compute_diagnostics
from .narrowphase import build_pair_data, narrowphase, world_verts
from .solver import BodyState, joint_plan, substep
from .state import World


def _capacity_of(world: World) -> Capacity:
    return Capacity(
        max_bodies=world.bodies.n,
        max_colliders=world.colliders.m,
        max_pairs=0,  # filled by caller
        max_joints=world.joints.j,
        max_verts=world.colliders.max_verts,
    )


def frame_prep(world: World, cfg: SolverConfig, max_pairs: int):
    """Per-frame collision prep: AABBs + broadphase + hoisted PairData
    (SURVEY.md §3.2 steps 1-2). The AABB sweep covers the whole frame so the
    pair set stays valid while manifolds regenerate inside each substep."""
    cap = dataclasses.replace(_capacity_of(world), max_pairs=max_pairs)
    wverts = world_verts(world)
    lo, hi = compute_aabbs(world, wverts, cfg.contact_margin, cfg.dt)
    pairs = broadphase(world, lo, hi, cap, cfg)
    pd = build_pair_data(
        world.colliders, world.bodies, pairs.pair_a, pairs.pair_b, pairs.valid)
    return pairs, pd


def speculative_margin(pd, bodies, cfg: SolverConfig):
    """Per-pair velocity-expanded contact margin [P] for once-per-frame
    manifolds: surfaces approaching at v close the gap by at most
    ``(|v_a|+|v_b|)*dt`` within the frame (rotation bounded via each
    collider's circumradius) — Box2D's speculative-distance idea."""
    ext_a = jnp.max(jnp.sqrt(pd.verts_ax**2 + pd.verts_ay**2), axis=0) + pd.radius_a
    ext_b = jnp.max(jnp.sqrt(pd.verts_bx**2 + pd.verts_by**2), axis=0) + pd.radius_b
    spd = jnp.linalg.norm(bodies.vel, axis=-1)
    spd_a = spd[pd.body_a] + jnp.abs(bodies.ang_vel[pd.body_a]) * ext_a
    spd_b = spd[pd.body_b] + jnp.abs(bodies.ang_vel[pd.body_b]) * ext_b
    return cfg.contact_margin + cfg.dt * (spd_a + spd_b)


def _empty_contacts(max_pairs: int) -> Contacts:
    z = jnp.zeros((max_pairs,), jnp.float32)
    zi = jnp.zeros((max_pairs,), jnp.int32)
    zb = jnp.zeros((max_pairs,), bool)
    z2 = jnp.zeros((max_pairs, 2), jnp.float32)
    z22 = jnp.zeros((max_pairs, 2, 2), jnp.float32)
    zb2 = jnp.zeros((max_pairs, 2), bool)
    return Contacts(body_a=zi, body_b=zi, collider_a=zi, collider_b=zi,
                    normal_a=z2, anchor_a=z22, anchor_b=z22, point_mask=zb2,
                    solve_mask=zb2, friction=z, restitution=z, touching=zb,
                    separation=z2)


def step(
    world: World,
    cfg: SolverConfig,
    max_pairs: int,
    gravity: Optional[jax.Array] = None,
) -> tuple[World, Contacts, Diagnostics]:
    """Advance one frame of ``cfg.dt`` seconds. Pure function of the world.

    ``gravity`` overrides ``world.gravity`` for this frame (starframe's
    per-tick forcefield argument — SURVEY.md §3.1).

    With ``cfg.sleep_velocity > 0`` the sleep system is active (starframe's
    island sleeping, SURVEY.md §2 row 11, realized as array masks):
    bodies that stay slow for ``sleep_frames`` frames freeze exactly (their
    inverse masses are zeroed for the frame, so awake neighbors solve
    against them as static — no drift), a touching awake body wakes them
    the next frame (sleep propagation replaces explicit island extraction),
    and once EVERY dynamic body sleeps the entire pipeline is skipped via
    ``lax.cond`` — a settled scene costs ~nothing per frame.
    """
    g = world.gravity if gravity is None else gravity
    if cfg.sleep_velocity <= 0.0:
        return _live_step(world, cfg, max_pairs, g)
    live, skip, any_awake = _sleep_branches(world, cfg, max_pairs, g)
    return jax.lax.cond(any_awake, live, skip, world)


def _joint_slow_closure(slow, joints, hops: int = 3):
    """Island-style joint sleep coupling (SURVEY.md §2 row 11: the reference
    sleeps whole islands, and joint-connected bodies are one island): a body
    only counts as slow while its joint partners are slow too, so a dumbbell
    sleeps as a PAIR — never one half frozen while the other yanks against
    it (measured r5: half-frozen dumbbells re-jitter the 10k jointed pile
    into wake avalanches). ``hops`` bounds in-frame propagation along
    chains; longer chains converge across frames (the counter must run out
    anyway)."""
    if joints is None or joints.body_a.shape[0] == 0:
        return slow
    ja, jb = joints.body_a, joints.body_b
    inert = jnp.logical_not(joints.active > 0)
    for _ in range(hops):
        ps = ((slow[ja] & slow[jb]) | inert).astype(jnp.int32)
        s32 = slow.astype(jnp.int32).at[ja].min(ps).at[jb].min(ps)
        slow = s32 > 0
    return slow


def _joint_wake_closure(wake, joints, hops: int = 3):
    """Wake propagates across joint edges (the other half of the island
    rule): waking one endpoint wakes its partner."""
    if joints is None or joints.body_a.shape[0] == 0:
        return wake
    ja, jb = joints.body_a, joints.body_b
    jact = joints.active > 0
    for _ in range(hops):
        pw = ((wake[ja] | wake[jb]) & jact).astype(jnp.int32)
        w32 = wake.astype(jnp.int32).at[ja].max(pw).at[jb].max(pw)
        wake = w32 > 0
    return wake


def _sleep_branches(world, cfg, max_pairs, g):
    b = world.bodies
    dynamic = b.inv_mass > 0
    asleep = (b.sleep_count >= cfg.sleep_frames) & dynamic
    any_awake = jnp.any(dynamic & jnp.logical_not(asleep))

    def live(world):
        bw = world.bodies
        awake_f = 1.0 - asleep.astype(jnp.float32)
        eff = dataclasses.replace(
            world,
            bodies=dataclasses.replace(
                bw, inv_mass=bw.inv_mass * awake_f,
                inv_inertia=bw.inv_inertia * awake_f),
        )
        nw, contacts, diag = _live_step(eff, cfg, max_pairs, g)
        # restore true masses; reset the sleep counter of any body touching
        # a FAST partner (the island rule: a body cannot sleep — and a
        # sleeper wakes — while something moving is in contact with it;
        # mutually-resting bodies all run their counters out together)
        nb0 = nw.bodies
        spd2 = jnp.sum(nb0.vel**2, axis=-1) + nb0.ang_vel**2
        fast = dynamic & (
            spd2 >= (cfg.sleep_velocity * cfg.wake_velocity_factor) ** 2)
        wa = contacts.touching & fast[contacts.body_b]
        wb = contacts.touching & fast[contacts.body_a]
        n = bw.inv_mass.shape[0]
        wake = (
            jnp.zeros((n,), bool)
            .at[contacts.body_a].max(wa)
            .at[contacts.body_b].max(wb)
        ) & dynamic
        wake = _joint_wake_closure(wake, world.joints) & dynamic
        nb = dataclasses.replace(
            nb0,
            inv_mass=bw.inv_mass,
            inv_inertia=bw.inv_inertia,
            sleep_count=jnp.where(wake, 0, nb0.sleep_count),
        )
        return dataclasses.replace(nw, bodies=nb), contacts, diag

    def skip(world):
        bw = world.bodies
        nb = dataclasses.replace(bw, prev_pos=bw.pos, prev_angle=bw.angle)
        nw = dataclasses.replace(world, bodies=nb,
                                 step_count=world.step_count + 1)
        zi = jnp.zeros((), jnp.int32)
        zf = jnp.zeros((), jnp.float32)
        diag = Diagnostics(pair_count=zi, pair_overflow=zi, cell_overflow=zi,
                           contact_count=zi, touching_count=zi,
                           max_penetration=zf, kinetic_energy=zf)
        return nw, _empty_contacts(max_pairs), diag

    return live, skip, any_awake


def step_world(
    world: World,
    cfg: SolverConfig,
    max_pairs: int,
    gravity: Optional[jax.Array] = None,
) -> World:
    """World-only step: like :func:`step` but the all-asleep skip branch
    carries ONLY the world through the ``lax.cond`` — contacts/diagnostics
    never materialize, so a fully-sleeping scene's frame is just a state
    copy (measured ~10x cheaper than the tuple-returning skip at 10k
    bodies). This is what ``make_step(with_contacts=False)`` builds."""
    g = world.gravity if gravity is None else gravity
    if cfg.sleep_velocity <= 0.0:
        return _live_step(world, cfg, max_pairs, g)[0]
    live, skip, any_awake = _sleep_branches(world, cfg, max_pairs, g)

    def skip_world(w):
        bw = w.bodies
        nb = dataclasses.replace(bw, prev_pos=bw.pos, prev_angle=bw.angle)
        return dataclasses.replace(w, bodies=nb, step_count=w.step_count + 1)

    return jax.lax.cond(any_awake, lambda w: live(w)[0], skip_world, world)


def _live_step(
    world: World,
    cfg: SolverConfig,
    max_pairs: int,
    g,
) -> tuple[World, Contacts, Diagnostics]:
    pairs, pd = frame_prep(world, cfg, max_pairs)

    # 3-5: XPBD substep loop
    h = cfg.dt / cfg.substeps
    b = world.bodies
    s0 = BodyState(b.pos, b.angle, b.vel, b.ang_vel)
    touched0 = jnp.zeros((max_pairs,), bool)

    if cfg.ccd and cfg.manifold_refresh != "frame":
        raise ValueError(
            "cfg.ccd requires manifold_refresh='frame': the TOI clamp "
            "trusts frame-start manifold normals; per-substep re-narrowphase "
            "after a crossing would pick the far-side feature")

    cb_frame = None
    if cfg.manifold_refresh == "frame":
        # reference pipeline order (SURVEY.md §3.2): narrowphase ONCE at
        # frame-start poses; the speculative margin is velocity-expanded
        # so contacts that form during this frame's substeps are already
        # in the manifold (solve activates only at actual penetration)
        from .kernels import gather_pair_pose, narrowphase_b

        cb_frame = narrowphase_b(
            pd, gather_pair_pose(pd, b.pos, b.angle),
            speculative_margin(pd, b, cfg),
        )

    jplan = joint_plan(world.joints, b.n)

    def body_fn(_, carry):
        s, touched = carry
        s, _, t = substep(s, b, pd, world.joints, g, h, cfg, cb=cb_frame,
                          jplan=jplan)
        return s, touched | t

    s, touched = jax.lax.fori_loop(0, cfg.substeps, body_fn, (s0, touched0))

    # 6: events — manifolds at the final pose, with `touching` reflecting
    # any in-frame contact (a bounce separates before the frame ends); the
    # whole block is dead-code-eliminated by XLA when contacts are unused
    contacts = narrowphase(pd, s.pos, s.angle, cfg.contact_margin)
    contacts = dataclasses.replace(contacts, touching=contacts.touching | touched)

    # sleeping: zero velocities of bodies that stayed slow for sleep_frames
    sleep_count = b.sleep_count
    vel, ang_vel = s.vel, s.ang_vel
    if cfg.sleep_velocity > 0.0:
        slow = (jnp.sum(vel**2, axis=-1) + ang_vel**2) < cfg.sleep_velocity**2
        slow = _joint_slow_closure(slow, world.joints)
        sleep_count = jnp.where(slow, sleep_count + 1, 0)
        asleep = (sleep_count >= cfg.sleep_frames) & (b.inv_mass > 0)
        vel = jnp.where(asleep[:, None], 0.0, vel)
        ang_vel = jnp.where(asleep, 0.0, ang_vel)

    new_bodies = dataclasses.replace(
        b,
        pos=s.pos,
        angle=s.angle,
        vel=vel,
        ang_vel=ang_vel,
        prev_pos=b.pos,  # frame-start pose, for render interpolation
        prev_angle=b.angle,
        sleep_count=sleep_count,
    )
    new_world = dataclasses.replace(
        world, bodies=new_bodies, step_count=world.step_count + 1
    )
    diag = compute_diagnostics(new_world, contacts, pairs)
    return new_world, contacts, diag


def make_step(
    cfg: SolverConfig,
    max_pairs: int,
    with_contacts: bool = False,
    donate: bool = True,
):
    """Build a jitted per-frame step function ``world -> world`` (or
    ``world -> (world, contacts, diagnostics)`` with ``with_contacts=True``).

    The input world buffer is donated so stepping is allocation-free in
    steady state (SURVEY.md §7.8.5)."""

    def _full(world: World):
        return step(world, cfg, max_pairs)

    def _plain(world: World):
        return step_world(world, cfg, max_pairs)

    fn = _full if with_contacts else _plain
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def rollout(world: World, cfg: SolverConfig, max_pairs: int, n_frames: int,
            record=None):
    """On-device N-frame rollout via ``lax.scan`` — zero host sync inside
    (the headless equivalent of starframe's fixed-timestep loop,
    SURVEY.md §2 row 13). ``record(world) -> pytree`` selects the per-frame
    trajectory to stack (default: body poses)."""
    if record is None:
        record = lambda w: (w.bodies.pos, w.bodies.angle)

    def body_fn(w, _):
        w2, _, diag = step(w, cfg, max_pairs)
        return w2, (record(w2), diag)

    final, (traj, diags) = jax.lax.scan(body_fn, world, None, length=n_frames)
    return final, traj, diags


def make_rollout(cfg: SolverConfig, max_pairs: int, n_frames: int, record=None):
    return jax.jit(partial(rollout, cfg=cfg, max_pairs=max_pairs,
                           n_frames=n_frames, record=record))
