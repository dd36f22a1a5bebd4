"""Batched P-last compute kernels: narrowphase manifold + contact solve.

These are plain ``jax.numpy`` functions that XLA fuses. The pair axis is
LAST (``[V, P]``, ``[P]``) and x/y live in separate arrays, so every
elementwise op runs over contiguous ``[*, P]`` rows instead of small padded
trailing dims (``[P, 2, 2]``, ``[P, V, 2]``). Same math as
:func:`narrowphase.manifold_pair` (the scalar reference kept for unit
tests; a parity test pins them together).

The solve functions return per-pair ``[4, P]`` contribution rows; the
solver sums them into bodies (:func:`solver._accumulate_contacts`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_EPS = 1e-10
_PARALLEL_COS = 0.98
# surfaces within this slop count as "touching" for contact events
TOUCH_SLOP = 1e-3


class ManifoldB(NamedTuple):
    """P-last manifold arrays (2 candidate points per pair)."""

    n_x: jax.Array  # [P] contact normal (A->B)
    n_y: jax.Array  # [P]
    wa_x: jax.Array  # [2, P] surface points on A
    wa_y: jax.Array  # [2, P]
    wb_x: jax.Array  # [2, P]
    wb_y: jax.Array  # [2, P]
    sep: jax.Array  # [2, P]
    pmask: jax.Array  # [2, P] f32 0/1 mask


def _edge_data_b(vx, vy, n_valid):
    """Edges + outward normals for padded CCW polys, P-last.

    vx, vy: [V, P]; n_valid: [P]. Returns e0/e1/normal components [V, P] and
    edge_valid [V, P]. The wrap "gather" is a static roll + masked overwrite.
    """
    V = vx.shape[0]
    # rank tracks the input so the same code runs on [V, P] and packed
    # [V, G, P] arrays
    idx = jax.lax.broadcasted_iota(jnp.int32, (V,) + (1,) * (vx.ndim - 1), 0)
    wrap = idx == (n_valid[None, :] - 1)  # [V, P]
    e1x = jnp.where(wrap, vx[0][None, :], jnp.roll(vx, -1, axis=0))
    e1y = jnp.where(wrap, vy[0][None, :], jnp.roll(vy, -1, axis=0))
    dx = e1x - vx
    dy = e1y - vy
    length = jnp.sqrt(dx * dx + dy * dy)
    valid = (idx < n_valid[None, :]) & (n_valid[None, :] >= 2) & (length > 1e-9)
    inv = 1.0 / jnp.maximum(length, _EPS)
    # outward normal of CCW edge: perp_cw(d) = (dy, -dx)
    nx = dy * inv
    ny = -dx * inv
    return vx, vy, e1x, e1y, nx, ny, valid


def _sat_b(e0x, e0y, nx, ny, valid, ox, oy):
    """Max separation over edge normals vs other-shape verts, P-last.

    e0*/n*: [V, P]; valid: [V, P]; o*: [W, P] (other verts, padded with v0).
    Returns (sep[P], onehot[V, P] of the argmax edge).
    """
    # min_j (n . o_j), statically unrolled over the other shape's verts
    # (W <= 8): avoids materializing a [V, W, P] cube
    W = ox.shape[0]
    mn = nx * ox[0][None, :] + ny * oy[0][None, :]  # [V, P]
    for j in range(1, W):
        mn = jnp.minimum(mn, nx * ox[j][None, :] + ny * oy[j][None, :])
    sep = mn - (nx * e0x + ny * e0y)
    sep = jnp.where(valid, sep, -jnp.inf)
    best = jnp.max(sep, axis=0)  # [P]
    onehot = _first_true(sep == best[None, :])
    return best, onehot


def _first_true(mask):
    """f32 one-hot of the first True row per column (static unroll over the
    small leading axis)."""
    V = mask.shape[0]
    seen = mask[0]
    rows = [mask[0].astype(jnp.float32)]
    for i in range(1, V):
        rows.append((mask[i] & jnp.logical_not(seen)).astype(jnp.float32))
        seen = seen | mask[i]
    return jnp.stack(rows)


def _select_b(onehot, rows):
    """Masked-sum row selection, P-last. onehot: [V, P] f32 0/1; rows: [V, P]."""
    return (onehot * rows).sum(axis=0)


def _closest_seg_seg_b(p1x, p1y, q1x, q1y, p2x, p2y, q2x, q2y):
    """Segment-segment closest points (Ericson 5.1.9), P-last, degenerate-safe."""
    d1x, d1y = q1x - p1x, q1y - p1y
    d2x, d2y = q2x - p2x, q2y - p2y
    rx, ry = p1x - p2x, p1y - p2y
    a = d1x * d1x + d1y * d1y
    e = d2x * d2x + d2y * d2y
    f = d2x * rx + d2y * ry
    c = d1x * rx + d1y * ry
    b = d1x * d2x + d1y * d2y
    denom = a * e - b * b

    a_deg = a <= _EPS
    e_deg = e <= _EPS

    s_gen = jnp.where(
        denom > _EPS,
        jnp.clip((b * f - c * e) / jnp.where(denom > _EPS, denom, 1.0), 0.0, 1.0),
        0.0,
    )
    t_gen = (b * s_gen + f) / jnp.where(e_deg, 1.0, e)
    t_cl = jnp.clip(t_gen, 0.0, 1.0)
    s_re = jnp.clip((b * t_cl - c) / jnp.where(a_deg, 1.0, a), 0.0, 1.0)
    s_gen = jnp.where((t_gen < 0.0) | (t_gen > 1.0), s_re, s_gen)
    t_gen = t_cl

    s = jnp.where(
        a_deg & e_deg,
        0.0,
        jnp.where(
            a_deg,
            0.0,
            jnp.where(e_deg, jnp.clip(-c / jnp.where(a_deg, 1.0, a), 0.0, 1.0), s_gen),
        ),
    )
    t = jnp.where(
        a_deg & e_deg,
        0.0,
        jnp.where(
            a_deg,
            jnp.clip(f / jnp.where(e_deg, 1.0, e), 0.0, 1.0),
            jnp.where(e_deg, 0.0, t_gen),
        ),
    )
    return p1x + d1x * s, p1y + d1y * s, p2x + d2x * t, p2y + d2y * t


def manifold_batch(vax, vay, na, ra, vbx, vby, nb, rb, margin) -> ManifoldB:
    """P-last contact manifolds for rounded convex polygons.

    va*/vb*: [V, P] world verts (padded with v0); na/nb/ra/rb: [P].
    Mirrors :func:`narrowphase.manifold_pair` 1:1 (see that docstring for
    the algorithm and SURVEY.md §7.4 for why SAT+closest replaces GJK).
    """
    e0ax, e0ay, e1ax, e1ay, nax, nay, eva = _edge_data_b(vax, vay, na)
    e0bx, e0by, e1bx, e1by, nbx, nby, evb = _edge_data_b(vbx, vby, nb)

    sep_a, oh_a = _sat_b(e0ax, e0ay, nax, nay, eva, vbx, vby)
    sep_b, oh_b = _sat_b(e0bx, e0by, nbx, nby, evb, vax, vay)

    a_has = na >= 2
    b_has = nb >= 2
    both_points = jnp.logical_not(a_has | b_has)

    flip = sep_b > sep_a + 1e-5
    s_core = jnp.maximum(sep_a, sep_b)

    def pick(fa, fb):
        return jnp.where(flip, fb, fa)

    r0x = pick(_select_b(oh_a, e0ax), _select_b(oh_b, e0bx))
    r0y = pick(_select_b(oh_a, e0ay), _select_b(oh_b, e0by))
    r1x = pick(_select_b(oh_a, e1ax), _select_b(oh_b, e1bx))
    r1y = pick(_select_b(oh_a, e1ay), _select_b(oh_b, e1by))
    n_refx = pick(_select_b(oh_a, nax), _select_b(oh_b, nbx))
    n_refy = pick(_select_b(oh_a, nay), _select_b(oh_b, nby))
    r_ref = pick(ra, rb)
    r_inc = pick(rb, ra)

    # incident edge: most anti-parallel normal on the other shape
    inc_a = jnp.where(eva, nax * n_refx[None] + nay * n_refy[None], jnp.inf)
    inc_b = jnp.where(evb, nbx * n_refx[None] + nby * n_refy[None], jnp.inf)
    mina = jnp.min(inc_a, axis=0)
    minb = jnp.min(inc_b, axis=0)
    oha = _first_true(inc_a == mina[None])
    ohb = _first_true(inc_b == minb[None])
    # incident is on the OTHER shape from the reference: B when not flipped,
    # A when flipped — hence pick(B-variant, A-variant).
    i_has = (flip & a_has) | (jnp.logical_not(flip) & b_has)
    i0x = pick(jnp.where(b_has, _select_b(ohb, e0bx), vbx[0]),
               jnp.where(a_has, _select_b(oha, e0ax), vax[0]))
    i0y = pick(jnp.where(b_has, _select_b(ohb, e0by), vby[0]),
               jnp.where(a_has, _select_b(oha, e0ay), vay[0]))
    i1x = pick(jnp.where(b_has, _select_b(ohb, e1bx), vbx[0]),
               jnp.where(a_has, _select_b(oha, e1ax), vax[0]))
    i1y = pick(jnp.where(b_has, _select_b(ohb, e1by), vby[0]),
               jnp.where(a_has, _select_b(oha, e1ay), vay[0]))
    inc_dot = pick(minb, mina)

    # ---- clip path ----
    tdx = r1x - r0x
    tdy = r1y - r0y
    t_len = jnp.sqrt(tdx * tdx + tdy * tdy)
    inv_t = 1.0 / jnp.maximum(t_len, _EPS)
    thx = tdx * inv_t
    thy = tdy * inv_t
    lo = thx * r0x + thy * r0y
    hi = thx * r1x + thy * r1y
    s0 = thx * i0x + thy * i0y
    s1 = thx * i1x + thy * i1y
    ds = s1 - s0
    ds_ok = jnp.abs(ds) > 1e-6
    inv_ds = jnp.where(ds_ok, 1.0 / jnp.where(ds_ok, ds, 1.0), 0.0)
    lo_ = jnp.minimum(lo, hi)
    hi_ = jnp.maximum(lo, hi)
    cs0 = jnp.clip(s0, lo_, hi_)
    cs1 = jnp.clip(s1, lo_, hi_)
    f0 = (cs0 - s0) * inv_ds
    f1 = (cs1 - s0) * inv_ds
    q0x = i0x + (i1x - i0x) * f0
    q0y = i0y + (i1y - i0y) * f0
    q1x = i0x + (i1x - i0x) * f1
    q1y = i0y + (i1y - i0y) * f1
    # perpendicular-incident degenerate clip: take the deepest endpoint
    deep0 = (n_refx * i0x + n_refy * i0y) <= (n_refx * i1x + n_refy * i1y)
    dpx = jnp.where(deep0, i0x, i1x)
    dpy = jnp.where(deep0, i0y, i1y)
    q0x = jnp.where(ds_ok, q0x, dpx)
    q0y = jnp.where(ds_ok, q0y, dpy)
    q1x = jnp.where(ds_ok, q1x, dpx)
    q1y = jnp.where(ds_ok, q1y, dpy)

    def clip_point(qx, qy):
        plane = n_refx * (qx - r0x) + n_refy * (qy - r0y)
        sep = plane - r_ref - r_inc
        wrx = qx - n_refx * plane + n_refx * r_ref
        wry = qy - n_refy * plane + n_refy * r_ref
        wix = qx - n_refx * r_inc
        wiy = qy - n_refy * r_inc
        return sep, wrx, wry, wix, wiy

    csep0, cwr0x, cwr0y, cwi0x, cwi0y = clip_point(q0x, q0y)
    csep1, cwr1x, cwr1y, cwi1x, cwi1y = clip_point(q1x, q1y)
    clip_distinct = jnp.sqrt((q1x - q0x) ** 2 + (q1y - q0y) ** 2) > 1e-6

    # ---- closest path ----
    c1x, c1y, c2x, c2y = _closest_seg_seg_b(r0x, r0y, r1x, r1y, i0x, i0y, i1x, i1y)
    c1x = jnp.where(both_points, pick(vax[0], vbx[0]), c1x)
    c1y = jnp.where(both_points, pick(vay[0], vby[0]), c1y)
    c2x = jnp.where(both_points, pick(vbx[0], vax[0]), c2x)
    c2y = jnp.where(both_points, pick(vby[0], vay[0]), c2y)
    dvx = c2x - c1x
    dvy = c2y - c1y
    d_len = jnp.sqrt(dvx * dvx + dvy * dvy)
    inv_d = 1.0 / jnp.maximum(d_len, _EPS)
    ncx = jnp.where(d_len > 1e-9, dvx * inv_d, jnp.where(both_points, 0.0, n_refx))
    ncy = jnp.where(d_len > 1e-9, dvy * inv_d, jnp.where(both_points, 1.0, n_refy))
    psep = d_len - r_ref - r_inc
    pwrx = c1x + ncx * r_ref
    pwry = c1y + ncy * r_ref
    pwix = c2x - ncx * r_inc
    pwiy = c2y - ncy * r_inc

    # ---- choose path (matches manifold_pair) ----
    parallel = i_has & (inc_dot < -_PARALLEL_COS)
    clip_has_extent = jnp.abs(cs1 - cs0) > 1e-6
    both_thin = (na <= 2) & (nb <= 2)
    deep_clip = (s_core <= 0.0) & jnp.logical_not(both_thin)
    use_clip = jnp.logical_not(both_points) & (deep_clip | (parallel & clip_has_extent))

    noutx = jnp.where(use_clip, n_refx, ncx)
    nouty = jnp.where(use_clip, n_refy, ncy)
    wrx = jnp.where(use_clip[None, :], jnp.stack([cwr0x, cwr1x]), jnp.stack([pwrx, pwrx]))
    wry = jnp.where(use_clip[None, :], jnp.stack([cwr0y, cwr1y]), jnp.stack([pwry, pwry]))
    wix = jnp.where(use_clip[None, :], jnp.stack([cwi0x, cwi1x]), jnp.stack([pwix, pwix]))
    wiy = jnp.where(use_clip[None, :], jnp.stack([cwi0y, cwi1y]), jnp.stack([pwiy, pwiy]))
    seps = jnp.where(use_clip[None, :], jnp.stack([csep0, csep1]), jnp.stack([psep, psep]))

    pmask0 = (seps[0] < margin).astype(jnp.float32)
    pmask1 = (use_clip & clip_distinct & (seps[1] < margin)).astype(jnp.float32)
    pmask = jnp.stack([pmask0, pmask1])  # f32 0/1

    flipn = jnp.where(flip, -1.0, 1.0)
    n_x = noutx * flipn
    n_y = nouty * flipn
    wa_x = jnp.where(flip[None, :], wix, wrx)
    wa_y = jnp.where(flip[None, :], wiy, wry)
    wb_x = jnp.where(flip[None, :], wrx, wix)
    wb_y = jnp.where(flip[None, :], wry, wiy)
    return ManifoldB(n_x, n_y, wa_x, wa_y, wb_x, wb_y, seps, pmask)


# ---------------------------------------------------------------------------
# P-last contact position solve + velocity pass
# ---------------------------------------------------------------------------


class PairPose(NamedTuple):
    """Per-pair gathered poses (position + cos/sin), P-last [P] components
    (filled by :func:`gather_pair_pose`)."""

    pax: jax.Array
    pay: jax.Array
    ca: jax.Array
    sa: jax.Array
    pbx: jax.Array
    pby: jax.Array
    cb: jax.Array
    sb: jax.Array


class PairVel(NamedTuple):
    """Per-pair gathered velocities, P-last [P] components."""

    vax: jax.Array
    vay: jax.Array
    oa: jax.Array
    vbx: jax.Array
    vby: jax.Array
    ob: jax.Array


def make_pair_pose(pax, pay, aa, pbx, pby, ab) -> PairPose:
    return PairPose(pax, pay, jnp.cos(aa), jnp.sin(aa),
                    pbx, pby, jnp.cos(ab), jnp.sin(ab))


def gather_pair_pose(pd, pos, angle) -> PairPose:
    return make_pair_pose(
        pos[:, 0][pd.body_a], pos[:, 1][pd.body_a], angle[pd.body_a],
        pos[:, 0][pd.body_b], pos[:, 1][pd.body_b], angle[pd.body_b],
    )


def gather_pair_vel(pd, vel, ang_vel) -> PairVel:
    return PairVel(
        vel[:, 0][pd.body_a], vel[:, 1][pd.body_a], ang_vel[pd.body_a],
        vel[:, 0][pd.body_b], vel[:, 1][pd.body_b], ang_vel[pd.body_b],
    )


class ContactsB(NamedTuple):
    """Internal P-last contact storage used by the substep loop."""

    n_ax: jax.Array  # [P] normal (A->B) in body-A frame
    n_ay: jax.Array  # [P]
    a_ax: jax.Array  # [2, P] anchors on A, body frame
    a_ay: jax.Array  # [2, P]
    b_ax: jax.Array  # [2, P] anchors on B, body frame
    b_ay: jax.Array  # [2, P]
    solve_mask: jax.Array  # [2, P] f32 0/1
    pmask: jax.Array  # [2, P] f32 0/1
    sep: jax.Array  # [2, P]


def narrowphase_b(pd, pose: PairPose, margin: float) -> ContactsB:
    """P-last narrowphase: transform verts at the given pair poses, build
    manifolds."""
    pax, pay, ca, sa, pbx, pby, cb, sb = pose

    vax = pax[None] + ca[None] * pd.verts_ax - sa[None] * pd.verts_ay  # [V, P]
    vay = pay[None] + sa[None] * pd.verts_ax + ca[None] * pd.verts_ay
    vbx = pbx[None] + cb[None] * pd.verts_bx - sb[None] * pd.verts_by
    vby = pby[None] + sb[None] * pd.verts_bx + cb[None] * pd.verts_by

    m = manifold_batch(vax, vay, pd.nverts_a, pd.radius_a,
                       vbx, vby, pd.nverts_b, pd.radius_b, margin)

    # body-local anchors and normal (rotate by -angle)
    dxa = m.wa_x - pax[None]
    dya = m.wa_y - pay[None]
    a_ax = ca[None] * dxa + sa[None] * dya
    a_ay = -sa[None] * dxa + ca[None] * dya
    dxb = m.wb_x - pbx[None]
    dyb = m.wb_y - pby[None]
    b_ax = cb[None] * dxb + sb[None] * dyb
    b_ay = -sb[None] * dxb + cb[None] * dyb
    n_ax = ca * m.n_x + sa * m.n_y
    n_ay = -sa * m.n_x + ca * m.n_y

    pmask = m.pmask * pd.valid.astype(jnp.float32)[None, :]
    solve_mask = pmask * (1.0 - pd.sensor.astype(jnp.float32))[None, :]
    return ContactsB(n_ax, n_ay, a_ax, a_ay, b_ax, b_ay, solve_mask, pmask, m.sep)


def _pair_kinematics(cb_: ContactsB, pose: PairPose):
    """World-space contact geometry at the given pair poses, P-last."""
    pax, pay, ca, sa, pbx, pby, cb, sb = pose
    nx = ca * cb_.n_ax - sa * cb_.n_ay  # [P]
    ny = sa * cb_.n_ax + ca * cb_.n_ay
    rax = ca[None] * cb_.a_ax - sa[None] * cb_.a_ay  # [2, P] anchor offset from COM
    ray = sa[None] * cb_.a_ax + ca[None] * cb_.a_ay
    rbx = cb[None] * cb_.b_ax - sb[None] * cb_.b_ay
    rby = sb[None] * cb_.b_ax + cb[None] * cb_.b_ay
    wax = pax[None] + rax
    way = pay[None] + ray
    wbx = pbx[None] + rbx
    wby = pby[None] + rby
    return nx, ny, rax, ray, rbx, rby, wax, way, wbx, wby


def bullet_advance_scale(pose0: PairPose, pose1: PairPose, pd,
                         cb_: ContactsB, bullet: jax.Array, n_bodies: int,
                         slop: float) -> jax.Array:
    """Per-body CCD advance fraction [N] in [0, 1] for bullet bodies.

    For every contact point, measures how far the pair CLOSED along its
    frame-start normal during this substep (``c0 - c1`` with anchors
    re-evaluated at each pose) and, where that advance would carry the pair
    from separation ``c0`` past ``slop`` of penetration, yields the fraction
    that lands it exactly at ``slop``. The per-body factor is the min over
    the body's pairs; scaling the integrated displacement by it is the
    conservative-advancement TOI clamp (starframe/Box2D bullet semantics,
    SURVEY.md §2 row 6 CCD): the bullet stops ON the surface it would have
    crossed, the now-shallow contact activates normally, and the velocity
    pass sees the true approach speed for restitution.

    Only the flagged body of a pair is clamped: a non-bullet partner keeps
    its full advance (its own per-substep motion is by definition small
    enough for the discrete solver, else flag it too).
    """
    nx0, ny0, *_, wax0, way0, wbx0, wby0 = _pair_kinematics(cb_, pose0)
    _, _, _, _, _, _, wax1, way1, wbx1, wby1 = _pair_kinematics(cb_, pose1)
    n_x = nx0[None]  # [1, P] frame-start normal (A->B side convention)
    n_y = ny0[None]
    c0 = (wbx0 - wax0) * n_x + (wby0 - way0) * n_y  # [2, P]
    c1 = (wbx1 - wax1) * n_x + (wby1 - way1) * n_y
    advance = c0 - c1  # > 0 where the pair closes this substep
    allowed = jnp.maximum(c0, 0.0) + slop
    need = (advance > allowed) & (cb_.solve_mask > 0.0)
    f_pt = jnp.where(need, allowed / jnp.maximum(advance, _EPS), 1.0)
    f_pair = jnp.min(f_pt, axis=0)  # [P]
    f = jnp.ones((n_bodies,), jnp.float32)
    f = f.at[pd.body_a].min(jnp.where(bullet[pd.body_a], f_pair, 1.0))
    f = f.at[pd.body_b].min(jnp.where(bullet[pd.body_b], f_pair, 1.0))
    return f


def solve_contacts_b(pose: PairPose, pose0: PairPose, pd, cb_: ContactsB,
                     h: float, contact_compliance: float):
    """XPBD contact projection, P-last. Returns (vals_a[4,P], vals_b[4,P],
    lam_n[2,P]) where vals rows are (dpos_x, dpos_y, dang, count) ready for
    the pair->body accumulation. ``pose0`` (substep-start poses) is the
    static-friction reference."""
    im_a = pd.inv_mass_a[None]  # [1, P]
    im_b = pd.inv_mass_b[None]
    ii_a = pd.inv_inertia_a[None]
    ii_b = pd.inv_inertia_b[None]

    nx, ny, rax, ray, rbx, rby, wax, way, wbx, wby = _pair_kinematics(cb_, pose)
    nxp = nx[None]  # [1, P]
    nyp = ny[None]

    c = (wbx - wax) * nxp + (wby - way) * nyp  # [2, P]
    active = (c < 0.0) & (cb_.solve_mask > 0.0)

    cr_a = rax * nyp - ray * nxp  # [2, P]
    cr_b = rbx * nyp - rby * nxp
    w_a = im_a + ii_a * cr_a * cr_a
    w_b = im_b + ii_b * cr_b * cr_b
    alpha_t = contact_compliance / (h * h)
    den = w_a + w_b + alpha_t
    dlam = jnp.where(active & (den > _EPS), -c / jnp.maximum(den, _EPS), 0.0)
    p_x = dlam * nxp  # [2, P]
    p_y = dlam * nyp

    # static friction at position level
    _, _, _, _, _, _, wax0, way0, wbx0, wby0 = _pair_kinematics(cb_, pose0)
    dpx = (wax - wax0) - (wbx - wbx0)
    dpy = (way - way0) - (wby - wby0)
    dpn = dpx * nxp + dpy * nyp
    tx = dpx - dpn * nxp
    ty = dpy - dpn * nyp
    ct = jnp.sqrt(tx * tx + ty * ty)
    inv_ct = 1.0 / jnp.maximum(ct, _EPS)
    thx = tx * inv_ct
    thy = ty * inv_ct
    cr_at = rax * thy - ray * thx
    cr_bt = rbx * thy - rby * thx
    w_at = im_a + ii_a * cr_at * cr_at
    w_bt = im_b + ii_b * cr_bt * cr_bt
    dent = w_at + w_bt
    dlam_t = jnp.where(dent > _EPS, -ct / jnp.maximum(dent, _EPS), 0.0)
    stick = active & (jnp.abs(dlam_t) < pd.friction[None] * dlam)
    pt_x = jnp.where(stick, dlam_t * thx, 0.0)
    pt_y = jnp.where(stick, dlam_t * thy, 0.0)

    # per-body contributions summed over the 2 points
    ca_x = (-p_x + pt_x).sum(0)  # [P]
    ca_y = (-p_y + pt_y).sum(0)
    cb_x = (p_x - pt_x).sum(0)
    cb_y = (p_y - pt_y).sum(0)
    dang_a = (ii_a * (-(rax * p_y - ray * p_x) + (rax * pt_y - ray * pt_x))).sum(0)
    dang_b = (ii_b * ((rbx * p_y - rby * p_x) - (rbx * pt_y - rby * pt_x))).sum(0)
    n_act = active.sum(0).astype(jnp.float32)

    vals_a = jnp.stack([ca_x * pd.inv_mass_a, ca_y * pd.inv_mass_a, dang_a, n_act])
    vals_b = jnp.stack([cb_x * pd.inv_mass_b, cb_y * pd.inv_mass_b, dang_b, n_act])
    return vals_a, vals_b, dlam


def velocity_contacts_b(pose: PairPose, pvel: PairVel, pvel0: PairVel,
                        pd, cb_: ContactsB, lam_n, h: float,
                        restitution_threshold: float):
    """Restitution + dynamic friction velocity impulses, P-last.
    Returns (vals_a[4,P], vals_b[4,P]) for accumulation (rows: dvx, dvy,
    dang, count)."""
    im_a = pd.inv_mass_a[None]
    im_b = pd.inv_mass_b[None]
    ii_a = pd.inv_inertia_a[None]
    ii_b = pd.inv_inertia_b[None]

    nx, ny, rax, ray, rbx, rby, *_ = _pair_kinematics(cb_, pose)
    nxp, nyp = nx[None], ny[None]

    def point_vel(vx, vy, om, rx, ry):
        return vx[None] - om[None] * ry, vy[None] + om[None] * rx

    uax, uay = point_vel(pvel.vax, pvel.vay, pvel.oa, rax, ray)
    ubx, uby = point_vel(pvel.vbx, pvel.vby, pvel.ob, rbx, rby)
    relx = ubx - uax
    rely = uby - uay
    vn = relx * nxp + rely * nyp  # [2, P]
    utx = relx - vn * nxp
    uty = rely - vn * nyp
    vt = jnp.sqrt(utx * utx + uty * uty)

    ua0x, ua0y = point_vel(pvel0.vax, pvel0.vay, pvel0.oa, rax, ray)
    ub0x, ub0y = point_vel(pvel0.vbx, pvel0.vby, pvel0.ob, rbx, rby)
    vn0 = (ub0x - ua0x) * nxp + (ub0y - ua0y) * nyp

    active = (lam_n > 0.0) & (cb_.solve_mask > 0.0)

    cr_a = rax * nyp - ray * nxp
    cr_b = rbx * nyp - rby * nxp
    w_n = im_a + ii_a * cr_a * cr_a + im_b + ii_b * cr_b * cr_b

    e = jnp.where(vn0 < -restitution_threshold, pd.restitution[None], 0.0)
    dv_n = jnp.where(active, -vn + jnp.maximum(-e * vn0, 0.0), 0.0)
    lam_v = jnp.where(w_n > _EPS, dv_n / jnp.maximum(w_n, _EPS), 0.0)
    pnx = lam_v * nxp
    pny = lam_v * nyp

    inv_vt = 1.0 / jnp.maximum(vt, _EPS)
    thx = utx * inv_vt
    thy = uty * inv_vt
    cr_at = rax * thy - ray * thx
    cr_bt = rbx * thy - rby * thx
    w_t = im_a + ii_a * cr_at * cr_at + im_b + ii_b * cr_bt * cr_bt
    lam_f = jnp.minimum(
        jnp.where(w_t > _EPS, vt / jnp.maximum(w_t, _EPS), 0.0),
        pd.friction[None] * lam_n / h,
    )
    lam_f = jnp.where(active, lam_f, 0.0)
    pfx = lam_f * thx
    pfy = lam_f * thy

    impx = pnx - pfx  # applied +imp to b, -imp to a
    impy = pny - pfy
    cb_x = impx.sum(0)
    cb_y = impy.sum(0)
    dang_b = (ii_b * (rbx * impy - rby * impx)).sum(0)
    dang_a = -(ii_a * (rax * impy - ray * impx)).sum(0)
    n_act = active.sum(0).astype(jnp.float32)

    vals_a = jnp.stack([-cb_x * pd.inv_mass_a, -cb_y * pd.inv_mass_a, dang_a, n_act])
    vals_b = jnp.stack([cb_x * pd.inv_mass_b, cb_y * pd.inv_mass_b, dang_b, n_act])
    return vals_a, vals_b
