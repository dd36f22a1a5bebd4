"""XPBD substep solver: integrate → project positions → derive velocities →
velocity solve.

The array-program rebuild of starframe's solver core (SURVEY.md §2 rows 7-9;
pipeline order is driver-normative, BASELINE.json:5 / SURVEY.md §3.2 step 5),
following Müller et al. 2020 "Detailed Rigid Body Simulation with XPBD"
(small steps): ~10 substeps per 60 Hz frame, one projection per substep,
velocities re-derived from pose deltas, restitution + dynamic friction in a
velocity pass.

Parallelization: instead of the reference's scalar Gauss-Seidel loop, every
constraint row is solved simultaneously (one fused elementwise pass over the
whole constraint buffer) and the position corrections are summed per body,
normalized by the per-body constraint count ("mass-splitting" averaged
Jacobi) with optional under-relaxation — the known-good GPU-engine pattern
chosen in SURVEY.md §7.5. No two constraints ever race: the per-body sum is
the only write, and it adds in an order fixed by the data, not the hardware
(:mod:`starframe_tpu.segment`), so replays are bitwise equal.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import math2d as m2
from . import segment
from .config import SolverConfig
from .contacts import Contacts
from .state import (
    BODY_KINEMATIC,
    JOINT_ANGLE_RANGE,
    JOINT_ANGULAR_MOTOR,
    JOINT_DISTANCE,
    JOINT_PIN,
    JOINT_WELD,
    Bodies,
    Joints,
)

_EPS = 1e-10


class BodyState(NamedTuple):
    """The mutable part of body state inside the substep loop."""

    pos: jax.Array  # [N, 2]
    angle: jax.Array  # [N]
    vel: jax.Array  # [N, 2]
    ang_vel: jax.Array  # [N]


def _safe_div(num, den):
    return jnp.where(den > _EPS, num / jnp.maximum(den, _EPS), 0.0)


@jax.named_scope("integrate")
def integrate(s: BodyState, bodies: Bodies, gravity, h: float) -> BodyState:
    """Semi-implicit Euler: v += g h (dynamic bodies); pose += v h."""
    dyn = (bodies.inv_mass > 0.0)[:, None]
    vel = s.vel + jnp.where(dyn, gravity[None, :] * h, 0.0)
    pos = s.pos + vel * h
    angle = s.angle + s.ang_vel * h
    return BodyState(pos, angle, vel, s.ang_vel)


# ---------------------------------------------------------------------------
# Position projection
# ---------------------------------------------------------------------------


class _Accum(NamedTuple):
    dpos: jax.Array  # [N, 2]
    dang: jax.Array  # [N]
    count: jax.Array  # [N]


def _accum_init(n: int) -> _Accum:
    return _Accum(
        dpos=jnp.zeros((n, 2), jnp.float32),
        dang=jnp.zeros((n,), jnp.float32),
        count=jnp.zeros((n,), jnp.float32),
    )


def joint_plan(joints: Joints, n: int):
    """Per-frame segment plan for the joint rows' ``concat(body_a,
    body_b)`` targets — the layout :func:`solve_joint_positions` and
    :func:`velocity_joints` return. None for an empty joint table."""
    if joints.j == 0:
        return None
    return segment.plan(jnp.concatenate([joints.body_a, joints.body_b]), n)


def _accumulate(plan, vec2s, scalars, counts) -> _Accum:
    """Per-body sums of per-constraint contributions (each list holds one
    array per target side, laid out like the ``idx`` of ``plan``), in an
    order fixed by the data (:mod:`starframe_tpu.segment`)."""
    val = jnp.concatenate(
        [
            jnp.concatenate([v2, sc[:, None], ct[:, None]], axis=1)
            for v2, sc, ct in zip(vec2s, scalars, counts)
        ]
    )  # [K, 4]
    out = segment.segment_sum(val, plan)
    return _Accum(dpos=out[:, :2], dang=out[:, 2], count=out[:, 3])


def _apply_accum(s: BodyState, acc: _Accum, relaxation: float, max_dpos: float,
                 dx=None, dang_tot=None):
    """Apply count-normalized corrections. When ``dx``/``dang_tot`` running
    totals are passed, also returns them updated — the substep reconstructs
    velocities from these *applied deltas* instead of ``(pos - pos0)/h``,
    which suffers catastrophic f32 cancellation far from the origin."""
    cnt = jnp.maximum(acc.count, 1.0)
    dpos = jnp.clip(acc.dpos * (relaxation / cnt)[:, None], -max_dpos, max_dpos)
    dang = jnp.clip(acc.dang * (relaxation / cnt), -max_dpos, max_dpos)
    s = BodyState(s.pos + dpos, s.angle + dang, s.vel, s.ang_vel)
    if dx is None:
        return s
    return s, dx + dpos, dang_tot + dang


def _contact_kinematics(s: BodyState, contacts: Contacts):
    """Current-pose world geometry of every contact point."""
    ba, bb = contacts.body_a, contacts.body_b
    pos_a, ang_a = s.pos[ba], s.angle[ba]
    pos_b, ang_b = s.pos[bb], s.angle[bb]
    n_w = m2.rotate(ang_a, contacts.normal_a)  # [P, 2]
    wa = m2.transform(pos_a[:, None, :], ang_a[:, None], contacts.anchor_a)  # [P,2,2]
    wb = m2.transform(pos_b[:, None, :], ang_b[:, None], contacts.anchor_b)
    ra = wa - pos_a[:, None, :]
    rb = wb - pos_b[:, None, :]
    return n_w, wa, wb, ra, rb


@jax.named_scope("solve_joints")
def solve_joint_positions(
    s: BodyState, bodies: Bodies, joints: Joints, h: float,
    mask=None,
):
    """Position projection for distance/pin/weld joints and angle limits
    (starframe's user constraints — SURVEY.md §2 row 8). ``mask`` restricts
    the pass to one color batch (graph-colored Gauss-Seidel). Returns
    contribution lists for :func:`_accumulate` over :func:`joint_plan`."""
    ba, bb = joints.body_a, joints.body_b
    im_a, im_b = bodies.inv_mass[ba], bodies.inv_mass[bb]
    ii_a, ii_b = bodies.inv_inertia[ba], bodies.inv_inertia[bb]
    jt = joints.jtype

    pos_a, ang_a = s.pos[ba], s.angle[ba]
    pos_b, ang_b = s.pos[bb], s.angle[bb]
    wa = m2.transform(pos_a, ang_a, joints.anchor_a)
    wb = m2.transform(pos_b, ang_b, joints.anchor_b)
    ra = wa - pos_a
    rb = wb - pos_b

    delta = wb - wa
    d = m2.norm(delta)
    n = delta / jnp.maximum(d, _EPS)[..., None]
    # pin/weld behave like a distance constraint with lo = hi = 0; a zero
    # distance makes the direction ill-defined, but then C = 0 too.
    is_dist = jt == JOINT_DISTANCE
    is_point = (jt == JOINT_PIN) | (jt == JOINT_WELD)
    lo = jnp.where(is_point, 0.0, joints.lo)
    hi = jnp.where(is_point, 0.0, joints.hi)
    c_lin = jnp.where(d > hi, d - hi, jnp.where(d < lo, d - lo, 0.0))
    sel = jnp.ones_like(jt, bool) if mask is None else mask
    lin_active = (is_dist | is_point) & (jnp.abs(c_lin) > 0.0) & (d > _EPS) & sel

    cr_a = m2.cross2(ra, n)
    cr_b = m2.cross2(rb, n)
    w_a = im_a + ii_a * cr_a * cr_a
    w_b = im_b + ii_b * cr_b * cr_b
    alpha_t = joints.compliance / (h * h)
    dlam = jnp.where(lin_active, _safe_div(-c_lin, w_a + w_b + alpha_t), 0.0)
    p_imp = dlam[:, None] * n

    # angular rows: weld locks relative angle at rest; angle_range limits it
    phi = m2.angle_wrap(ang_b - ang_a - joints.rest)
    is_weld = jt == JOINT_WELD
    is_rng = jt == JOINT_ANGLE_RANGE
    c_ang = jnp.where(
        is_weld, phi, jnp.where(phi > joints.hi, phi - joints.hi, jnp.where(phi < joints.lo, phi - joints.lo, 0.0))
    )
    ang_active = (is_weld | is_rng) & (jnp.abs(c_ang) > 0.0) & sel
    dlam_ang = jnp.where(ang_active, _safe_div(-c_ang, ii_a + ii_b + alpha_t), 0.0)

    n_active = lin_active.astype(jnp.float32) + ang_active.astype(jnp.float32)
    return (
        [-p_imp * im_a[:, None], p_imp * im_b[:, None]],
        [-ii_a * m2.cross2(ra, p_imp) - dlam_ang * ii_a,
         ii_b * m2.cross2(rb, p_imp) + dlam_ang * ii_b],
        [n_active, n_active],
    )


# ---------------------------------------------------------------------------
# Velocity pass
# ---------------------------------------------------------------------------


@jax.named_scope("velocity_joints")
def velocity_joints(s: BodyState, bodies: Bodies, joints: Joints, h: float):
    """Joint velocity rows: angular motors (BASELINE.json:10) + damping.
    Returns contribution lists for :func:`_accumulate` over
    :func:`joint_plan`."""
    jba, jbb = joints.body_a, joints.body_b
    j_ii_a = bodies.inv_inertia[jba]
    j_ii_b = bodies.inv_inertia[jbb]
    is_motor = joints.jtype == JOINT_ANGULAR_MOTOR
    err = joints.motor_speed - (s.ang_vel[jbb] - s.ang_vel[jba])
    lam_m = _safe_div(err, j_ii_a + j_ii_b)
    lam_m = jnp.clip(lam_m, -joints.motor_max * h, joints.motor_max * h)
    lam_m = jnp.where(is_motor, lam_m, 0.0)

    # joint damping: bleed relative anchor-point velocity (all joint types)
    damped = joints.active & (joints.damping > 0.0)
    pos_a, ang_a = s.pos[jba], s.angle[jba]
    pos_b, ang_b = s.pos[jbb], s.angle[jbb]
    jwa = m2.transform(pos_a, ang_a, joints.anchor_a)
    jwb = m2.transform(pos_b, ang_b, joints.anchor_b)
    jra = jwa - pos_a
    jrb = jwb - pos_b
    ju_rel = (
        s.vel[jbb]
        + m2.cross_sv(s.ang_vel[jbb], jrb)
        - s.vel[jba]
        - m2.cross_sv(s.ang_vel[jba], jra)
    )
    j_im_a = bodies.inv_mass[jba]
    j_im_b = bodies.inv_mass[jbb]
    w_lin = j_im_a + j_im_b
    damp_f = jnp.minimum(joints.damping * h, 1.0)
    p_d = jnp.where(damped[:, None], -ju_rel * _safe_div(damp_f, w_lin)[:, None], 0.0)

    j_act = (is_motor | damped).astype(jnp.float32)
    return (
        [-p_d * j_im_a[:, None], p_d * j_im_b[:, None]],
        [-lam_m * j_ii_a - j_ii_a * m2.cross2(jra, p_d),
         lam_m * j_ii_b + j_ii_b * m2.cross2(jrb, p_d)],
        [j_act, j_act],
    )


# ---------------------------------------------------------------------------
# One substep
# ---------------------------------------------------------------------------


def _accumulate_contacts(pd, vals_a, vals_b) -> _Accum:
    """Per-body sums of the pair rows' ``[4, P]`` contributions to their A
    and B bodies (rows: dx, dy, dang, count)."""
    out = segment.segment_sum(jnp.concatenate([vals_a.T, vals_b.T]), pd.plan)
    return _Accum(dpos=out[:, :2], dang=out[:, 2], count=out[:, 3])


def substep(
    s: BodyState,
    bodies: Bodies,
    pd,
    joints: Joints,
    gravity,
    h: float,
    cfg: SolverConfig,
    cb=None,
    jplan=None,
):
    """One XPBD substep.

    Collision *pairs* come from the frame-level broadphase (pre-gathered
    into ``pd``: PairData). With ``cb=None`` (``manifold_refresh='substep'``)
    manifolds are regenerated here at the integrated pose (TGS-style) —
    frame-long stored anchors on rotating bodies displace the normal's
    application point and pump angular momentum into rolling contact. With a
    precomputed ``cb`` (``manifold_refresh='frame'``, the reference's
    pipeline order) the frame-start manifolds are reused across substeps and
    only the anchor kinematics are re-evaluated at current poses.
    ``jplan`` is the frame's :func:`joint_plan`.
    """
    from .kernels import (
        bullet_advance_scale,
        gather_pair_pose,
        gather_pair_vel,
        narrowphase_b,
        solve_contacts_b,
        velocity_contacts_b,
    )

    s0 = s  # pose at substep start (for velocity reconstruction + friction)
    s = integrate(s, bodies, gravity, h)
    v_tilde = s  # velocities after external forces, before projection

    pose0 = gather_pair_pose(pd, s0.pos, s0.angle)
    if cb is None:
        cb = narrowphase_b(pd, gather_pair_pose(pd, s.pos, s.angle),
                           cfg.contact_margin)
    elif cfg.ccd:
        # continuous collision: clamp flagged bullets' integrated advance at
        # their earliest TOI against the frame manifolds (cfg.ccd docs).
        # Velocities are NOT scaled — v_tilde carries the full speed into
        # the contact's velocity pass, so restitution acts on the real
        # approach speed at the clamped (surface + ccd_slop) pose.
        from .state import BODY_BULLET

        bullet = (bodies.flags & BODY_BULLET) != 0
        f = bullet_advance_scale(
            pose0, gather_pair_pose(pd, s.pos, s.angle), pd, cb, bullet,
            s.pos.shape[0], cfg.ccd_slop)
        hit = f < 1.0  # where() keeps unclamped bodies bitwise untouched
        s = BodyState(
            jnp.where(hit[:, None], s0.pos + f[:, None] * (s.pos - s0.pos),
                      s.pos),
            jnp.where(hit, s0.angle + f * (s.angle - s0.angle), s.angle),
            s.vel, s.ang_vel)

    n_b = s.pos.shape[0]
    # a zero-capacity joint table ([0]-shaped arrays) makes every joint pass
    # a no-op graph that XLA eliminates — no special-casing needed, but skip
    # tracing the color loop entirely for a little compile time
    joint_iters = range(cfg.max_joint_colors) if joints.j > 0 else range(0)
    dx = jnp.zeros((n_b, 2), jnp.float32)  # applied position corrections
    dth = jnp.zeros((n_b,), jnp.float32)  # applied angle corrections
    lam_n = jnp.zeros(cb.pmask.shape, jnp.float32)
    for _ in range(cfg.iterations):
        # contacts: averaged Jacobi over the whole (dynamic-topology) buffer
        vals_a, vals_b, lam_i = solve_contacts_b(
            gather_pair_pose(pd, s.pos, s.angle), pose0, pd, cb, h,
            cfg.contact_compliance,
        )
        lam_n = lam_n + lam_i
        acc2 = _accumulate_contacts(pd, vals_a, vals_b)
        # joints: graph-colored Gauss-Seidel — each color batch has no shared
        # dynamic bodies, so corrections apply exactly (BASELINE.json:5);
        # falls back to one averaged-Jacobi pass when coloring is disabled
        if cfg.joint_solver == "colored":
            s, dx, dth = _apply_accum(s, acc2, cfg.relaxation, cfg.max_dpos_eff, dx, dth)
            for color in joint_iters:
                # final batch sweeps any colors beyond the static bound;
                # count-normalization in _apply_accum keeps that tail safe
                last = color == cfg.max_joint_colors - 1
                msk = (joints.color >= color) if last else (joints.color == color)
                j_contrib = solve_joint_positions(s, bodies, joints, h, mask=msk)
                accj = _accumulate(jplan, *j_contrib)
                # joint corrections are constraint maintenance, not
                # depenetration — the rate cap (max_dpos_eff) applies only
                # to contacts; capping joints makes stiff mechanisms spongy
                s, dx, dth = _apply_accum(s, accj, 1.0, cfg.max_dpos, dx, dth)
        else:
            j_contrib = solve_joint_positions(s, bodies, joints, h)
            accj = _accumulate(jplan, *j_contrib)
            acc2 = _Accum(acc2.dpos + accj.dpos, acc2.dang + accj.dang,
                          acc2.count + accj.count)
            s, dx, dth = _apply_accum(s, acc2, cfg.relaxation, cfg.max_dpos_eff, dx, dth)

    # velocity reconstruction: v = ṽ + (applied corrections)/h — identical to
    # the paper's (pos - pos0)/h but free of f32 cancellation at large |pos|
    kin = ((bodies.flags & BODY_KINEMATIC) != 0)[:, None]
    vel = jnp.where(kin, s.vel, v_tilde.vel + dx / h)
    ang_vel = jnp.where(kin[:, 0], s.ang_vel, v_tilde.ang_vel + dth / h)
    s = BodyState(s.pos, s.angle, vel, ang_vel)

    # velocity pass: restitution + dynamic friction (contacts, P-last) plus
    # motors and joint damping (row-major), one accumulation
    cv_a, cv_b = velocity_contacts_b(
        gather_pair_pose(pd, s.pos, s.angle),
        gather_pair_vel(pd, s.vel, s.ang_vel),
        gather_pair_vel(pd, v_tilde.vel, v_tilde.ang_vel),
        pd, cb, lam_n, h, cfg.restitution_threshold,
    )
    accv = _accumulate_contacts(pd, cv_a, cv_b)
    if joints.j > 0:
        jv = velocity_joints(s, bodies, joints, h)
        accjv = _accumulate(jplan, *jv)
        accv = _Accum(accv.dpos + accjv.dpos, accv.dang + accjv.dang,
                      accv.count + accjv.count)
    cnt = jnp.maximum(accv.count, 1.0)
    vel = s.vel + accv.dpos / cnt[:, None]
    ang_vel = s.ang_vel + accv.dang / cnt
    if cfg.linear_damping > 0.0:
        vel = vel * (1.0 / (1.0 + h * cfg.linear_damping))
    if cfg.angular_damping > 0.0:
        ang_vel = ang_vel * (1.0 / (1.0 + h * cfg.angular_damping))

    # contact happened at any point during this substep? (events need the
    # in-frame view — a bounce separates again before the frame ends)
    from .kernels import TOUCH_SLOP

    touched = jnp.any(
        (lam_n > 0.0) | ((cb.sep < TOUCH_SLOP) & (cb.pmask > 0.0)), axis=0
    )
    return BodyState(s.pos, s.angle, vel, ang_vel), cb, touched
