"""Narrowphase: one vectorized manifold kernel for all shape pairs.

Starframe dispatches per shape pair (circle/capsule/convex-poly via GJK +
feature clipping — BASELINE.json:5, SURVEY.md §2 row 6). An accelerator wants one
branch-free kernel, not a dispatch tree, so this module implements contact
generation for the *unified* shape: a rounded convex polygon (core vertices +
dilation radius; circle = 1 vertex, capsule = 2). The algorithm produces the
same manifolds GJK+clipping would (SURVEY.md §7.4 licenses the swap: the
rebuild needs equivalent manifolds, not the same algorithm):

1. SAT over the edge normals of both cores (masked over vertex counts) gives
   the max-separation axis. In 2D this is exact for core overlap.
2. If the cores are separated (the common case for rounded shapes resting on
   each other), the closest-point pair between the two SAT candidate edges
   supplies the axis — this covers vertex/cap Voronoi regions, circles and
   capsule ends, where no edge normal is the true axis.
3. Reference-face clipping of the incident edge yields up to 2 contact
   points with per-point separations; non-parallel separated pairs keep the
   single closest point.

Everything is fixed-shape and mask-driven; the per-pair function is vmapped
over the pair buffer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import math2d as m2
from . import segment
from .contacts import Contacts
from .segment import SegmentPlan
from .state import COL_SENSOR, World

_PARALLEL_COS = 0.98  # |cos| above which edges count as parallel
_EPS = 1e-10

from .kernels import TOUCH_SLOP  # noqa: E402  (shared with the solver)


def collider_world_verts(colliders, body_pos, body_angle) -> jax.Array:
    """Transform all collider core vertices to world space: [M, V, 2]."""
    pos = body_pos[colliders.body_idx]  # [M, 2]
    ang = body_angle[colliders.body_idx]  # [M]
    return m2.transform(pos[:, None, :], ang[:, None], colliders.verts)


def world_verts(world: World) -> jax.Array:
    return collider_world_verts(world.colliders, world.bodies.pos, world.bodies.angle)


def _select_row(rows, idx):
    """rows[idx] without a dynamic gather: one-hot mask + sum-reduce.

    Under vmap over the pair axis, per-pair scalar-index gathers lower to
    element-granularity gather ops; a masked sum is plain elementwise
    work.
    rows: [V, ...]; idx: scalar int. Returns rows[idx] with shape rows[1:].
    """
    V = rows.shape[0]
    sel = jnp.arange(V) == idx
    sel = sel.reshape((V,) + (1,) * (rows.ndim - 1))
    return jnp.where(sel, rows, 0).sum(axis=0)


def _edge_data(v, n_valid):
    """Edge endpoints + outward normals of a padded CCW polygon.

    v: [V, 2] world verts (slots >= n_valid padded with v[0]).
    Returns (e0[V,2], e1[V,2], normals[V,2], edge_valid[V]).

    The wrap gather ``v[(i+1) % n]`` is expressed as a static roll plus a
    masked overwrite at the wrap row — rolls are static slicing, gathers
    are not (see _select_row).
    """
    V = v.shape[0]
    idx = jnp.arange(V)
    e0 = v
    e1 = jnp.where((idx == n_valid - 1)[:, None], v[0][None, :], jnp.roll(v, -1, axis=0))
    d = e1 - e0
    length = m2.norm(d)
    valid = (idx < n_valid) & (n_valid >= 2) & (length > 1e-9)
    n = m2.perp_cw(d) / jnp.maximum(length, _EPS)[..., None]
    return e0, e1, n, valid


def _sat(e0, normals, edge_valid, verts_other):
    """Max separation over one shape's edge normals vs the other's verts.

    Padded verts of the other shape equal its v0, so the min over the full
    buffer is exact without a mask. Returns (best_sep, best_idx).

    NOTE: written as broadcast-multiply-sum, NOT einsum/@ — under vmap over
    the pair axis a contraction lowers to millions of tiny 8x8 matrix
    products; elementwise keeps it one fused pass.
    """
    # support distance: min_j n_i . w_j  -  n_i . e0_i
    proj = (normals[:, None, :] * verts_other[None, :, :]).sum(-1)  # [V, W]
    sep = jnp.min(proj, axis=1) - (normals * e0).sum(-1)
    sep = jnp.where(edge_valid, sep, -jnp.inf)
    return jnp.max(sep), jnp.argmax(sep)


def _closest_seg_seg(p1, q1, p2, q2):
    """Closest points between segments [p1,q1] and [p2,q2] (Ericson 5.1.9),
    branch-free; degenerate (point) segments are handled."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = m2.dot2(d1, d1)
    e = m2.dot2(d2, d2)
    f = m2.dot2(d2, r)
    c = m2.dot2(d1, r)
    b = m2.dot2(d1, d2)
    denom = a * e - b * b

    a_deg = a <= _EPS
    e_deg = e <= _EPS

    s_gen = jnp.where(denom > _EPS, jnp.clip((b * f - c * e) / jnp.where(denom > _EPS, denom, 1.0), 0.0, 1.0), 0.0)
    t_gen = (b * s_gen + f) / jnp.where(e_deg, 1.0, e)
    # clamp t then recompute s
    t_cl = jnp.clip(t_gen, 0.0, 1.0)
    s_re = jnp.clip((b * t_cl - c) / jnp.where(a_deg, 1.0, a), 0.0, 1.0)
    s_gen = jnp.where((t_gen < 0.0) | (t_gen > 1.0), s_re, s_gen)
    t_gen = t_cl

    # degenerate cases
    s = jnp.where(a_deg & e_deg, 0.0, jnp.where(a_deg, 0.0, jnp.where(e_deg, jnp.clip(-c / jnp.where(a_deg, 1.0, a), 0.0, 1.0), s_gen)))
    t = jnp.where(a_deg & e_deg, 0.0, jnp.where(a_deg, jnp.clip(f / jnp.where(e_deg, 1.0, e), 0.0, 1.0), jnp.where(e_deg, 0.0, t_gen)))

    c1 = p1 + d1 * s
    c2 = p2 + d2 * t
    return c1, c2


def manifold_pair(va, na, ra, vb, nb, rb, margin):
    """Contact manifold between two rounded convex polygons in world space.

    Returns (normal[2] A->B, wa[2,2], wb[2,2], sep[2], pmask[2]) where wa/wb
    are surface points on A/B, ``dot(wb_k - wa_k, normal) == sep_k`` and
    points are kept while ``sep < margin`` (speculative contacts).
    """
    e0a, e1a, nrm_a, eva = _edge_data(va, na)
    e0b, e1b, nrm_b, evb = _edge_data(vb, nb)

    sep_a, ia = _sat(e0a, nrm_a, eva, vb)
    sep_b, ib = _sat(e0b, nrm_b, evb, va)

    a_has_edges = na >= 2
    b_has_edges = nb >= 2
    both_points = jnp.logical_not(a_has_edges | b_has_edges)

    # prefer A as reference with a small bias for temporal coherence
    flip = sep_b > sep_a + 1e-5
    s_core = jnp.maximum(sep_a, sep_b)

    # reference edge (on R) and its normal (masked-sum selection, no gathers)
    r0 = jnp.where(flip, _select_row(e0b, ib), _select_row(e0a, ia))
    r1 = jnp.where(flip, _select_row(e1b, ib), _select_row(e1a, ia))
    n_ref = jnp.where(flip, _select_row(nrm_b, ib), _select_row(nrm_a, ia))
    r_ref = jnp.where(flip, rb, ra)
    r_inc = jnp.where(flip, ra, rb)

    # incident edge (on I): most anti-parallel to n_ref; degenerate -> (v0, v0)
    inc_dots_a = jnp.where(eva, (nrm_a * n_ref).sum(-1), jnp.inf)
    inc_dots_b = jnp.where(evb, (nrm_b * n_ref).sum(-1), jnp.inf)
    ka = jnp.argmin(inc_dots_a)
    kb = jnp.argmin(inc_dots_b)
    i_has_edges = jnp.where(flip, a_has_edges, b_has_edges)
    i0 = jnp.where(
        flip,
        jnp.where(a_has_edges, _select_row(e0a, ka), va[0]),
        jnp.where(b_has_edges, _select_row(e0b, kb), vb[0]),
    )
    i1 = jnp.where(
        flip,
        jnp.where(a_has_edges, _select_row(e1a, ka), va[0]),
        jnp.where(b_has_edges, _select_row(e1b, kb), vb[0]),
    )
    inc_normal_dot = jnp.where(flip, jnp.min(inc_dots_a), jnp.min(inc_dots_b))

    # ---- path 1: clip incident edge against reference face ----
    t_dir = r1 - r0
    t_len = m2.norm(t_dir)
    t_hat = t_dir / jnp.maximum(t_len, _EPS)
    lo = (t_hat * r0).sum(-1)
    hi = (t_hat * r1).sum(-1)
    s0 = (t_hat * i0).sum(-1)
    s1 = (t_hat * i1).sum(-1)
    ds = s1 - s0
    ds_ok = jnp.abs(ds) > 1e-6
    inv_ds = jnp.where(ds_ok, 1.0 / jnp.where(ds_ok, ds, 1.0), 0.0)
    cs0 = jnp.clip(s0, jnp.minimum(lo, hi), jnp.maximum(lo, hi))
    cs1 = jnp.clip(s1, jnp.minimum(lo, hi), jnp.maximum(lo, hi))
    q0 = i0 + (i1 - i0) * ((cs0 - s0) * inv_ds)
    q1 = i0 + (i1 - i0) * ((cs1 - s0) * inv_ds)
    # incident edge ~perpendicular to the ref tangent (e.g. crossed
    # capsules): both projections coincide — take the endpoint deepest
    # along the ref normal, not an arbitrary one
    deep = jnp.where((n_ref * i0).sum(-1) <= (n_ref * i1).sum(-1), i0, i1)
    q0 = jnp.where(ds_ok, q0, deep)
    q1 = jnp.where(ds_ok, q1, deep)

    def _clip_point(q):
        plane_d = (n_ref * (q - r0)).sum(-1)
        sep = plane_d - r_ref - r_inc
        w_ref = q - n_ref * plane_d + n_ref * r_ref
        w_inc = q - n_ref * r_inc
        return sep, w_ref, w_inc

    csep0, cw_ref0, cw_inc0 = _clip_point(q0)
    csep1, cw_ref1, cw_inc1 = _clip_point(q1)
    clip_distinct = m2.norm(q1 - q0) > 1e-6

    # ---- path 2: closest points between the two candidate edges ----
    c_ref, c_inc = _closest_seg_seg(r0, r1, i0, i1)
    # for both_points (two circles) the "edges" are the centers themselves
    c_ref = jnp.where(both_points, jnp.where(flip, vb[0], va[0]), c_ref)
    c_inc = jnp.where(both_points, jnp.where(flip, va[0], vb[0]), c_inc)
    d_vec = c_inc - c_ref
    d_len = m2.norm(d_vec)
    n_close = jnp.where(
        d_len > 1e-9, d_vec / jnp.maximum(d_len, _EPS), jnp.where(both_points, jnp.array([0.0, 1.0]), n_ref)
    )
    psep = d_len - r_ref - r_inc
    pw_ref = c_ref + n_close * r_ref
    pw_inc = c_inc - n_close * r_inc

    # ---- choose path ----
    parallel = i_has_edges & (inc_normal_dot < -_PARALLEL_COS)
    # clip is only valid while the clipped incident span has real extent on
    # the ref face; collapsed-to-corner means the true closest feature is the
    # corner (vertex Voronoi region) -> closest path. Two *thin* shapes
    # (segments/circles, <= 2 core verts) have no interior: a non-parallel
    # crossing must use the closest-point depth, not endpoint plane distance.
    clip_has_extent = jnp.abs(cs1 - cs0) > 1e-6
    both_thin = (na <= 2) & (nb <= 2)
    deep_clip = (s_core <= 0.0) & jnp.logical_not(both_thin)
    use_clip = jnp.logical_not(both_points) & (
        deep_clip | (parallel & clip_has_extent)
    )

    n_out = jnp.where(use_clip, n_ref, n_close)  # ref -> inc
    w_ref_pts = jnp.where(use_clip, jnp.stack([cw_ref0, cw_ref1]), jnp.stack([pw_ref, pw_ref]))
    w_inc_pts = jnp.where(use_clip, jnp.stack([cw_inc0, cw_inc1]), jnp.stack([pw_inc, pw_inc]))
    seps = jnp.where(use_clip, jnp.stack([csep0, csep1]), jnp.stack([psep, psep]))

    pmask0 = seps[0] < margin
    pmask1 = use_clip & clip_distinct & (seps[1] < margin)
    pmask = jnp.stack([pmask0, pmask1])

    # un-flip into A->B convention
    normal = jnp.where(flip, -n_out, n_out)
    wa = jnp.where(flip, w_inc_pts, w_ref_pts)
    wb = jnp.where(flip, w_ref_pts, w_inc_pts)
    return normal, wa, wb, seps, pmask


_manifold_vmapped = jax.vmap(manifold_pair, in_axes=(0, 0, 0, 0, 0, 0, None))


def _dataclass_pytree(cls):
    import dataclasses

    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_dataclass_pytree
class PairData:
    """Per-candidate-pair data that is constant for a whole frame.

    Gathered ONCE per frame from the collider/body tables so the
    per-substep narrowphase + solve touch no large gathers — only the
    [P]-sized pose lookups change per substep. Vertex buffers are stored
    P-last with split x/y (``[V, P]``) so every per-substep elementwise op
    runs over contiguous rows (see kernels.py docstring).
    """

    pair_a: jax.Array  # [P] i32 collider idx
    pair_b: jax.Array  # [P] i32
    valid: jax.Array  # [P] bool
    body_a: jax.Array  # [P] i32
    body_b: jax.Array  # [P] i32
    verts_ax: jax.Array  # [V, P] f32 body-frame core verts, x
    verts_ay: jax.Array  # [V, P]
    verts_bx: jax.Array  # [V, P]
    verts_by: jax.Array  # [V, P]
    nverts_a: jax.Array  # [P] i32
    nverts_b: jax.Array  # [P] i32
    radius_a: jax.Array  # [P] f32
    radius_b: jax.Array  # [P] f32
    friction: jax.Array  # [P] f32 combined
    restitution: jax.Array  # [P] f32 combined
    sensor: jax.Array  # [P] bool
    inv_mass_a: jax.Array  # [P] f32
    inv_mass_b: jax.Array  # [P] f32
    inv_inertia_a: jax.Array  # [P] f32
    inv_inertia_b: jax.Array  # [P] f32
    # pair->body accumulation order over concat(body_a, body_b) [2P]
    plan: SegmentPlan

    @property
    def p(self) -> int:
        return self.pair_a.shape[-1]


@jax.named_scope("build_pair_data")
def build_pair_data(colliders, bodies, pair_a, pair_b, pair_valid) -> PairData:
    """Hoist all frame-constant per-pair lookups out of the substep loop."""
    c = colliders
    ca, cb = pair_a, pair_b
    body_a = c.body_idx[ca]
    body_b = c.body_idx[cb]
    va = c.verts[ca]  # [P, V, 2]
    vb = c.verts[cb]
    n = bodies.inv_mass.shape[0]
    return PairData(
        pair_a=ca,
        pair_b=cb,
        valid=pair_valid,
        body_a=body_a,
        body_b=body_b,
        verts_ax=va[..., 0].T,
        verts_ay=va[..., 1].T,
        verts_bx=vb[..., 0].T,
        verts_by=vb[..., 1].T,
        nverts_a=c.nverts[ca],
        nverts_b=c.nverts[cb],
        radius_a=c.radius[ca],
        radius_b=c.radius[cb],
        friction=jnp.sqrt(c.friction[ca] * c.friction[cb]),
        restitution=jnp.maximum(c.restitution[ca], c.restitution[cb]),
        sensor=((c.flags[ca] | c.flags[cb]) & COL_SENSOR) != 0,
        inv_mass_a=bodies.inv_mass[body_a],
        inv_mass_b=bodies.inv_mass[body_b],
        inv_inertia_a=bodies.inv_inertia[body_a],
        inv_inertia_b=bodies.inv_inertia[body_b],
        plan=segment.plan(jnp.concatenate([body_a, body_b]), n),
    )


@jax.named_scope("narrowphase")
def narrowphase(pd: PairData, body_pos, body_angle, margin: float) -> Contacts:
    """Public-layout contact manifolds at the given poses (events/queries/
    observer API). The hot path uses :func:`kernels.narrowphase_b` directly;
    this converts its P-last arrays into the row-major :class:`Contacts`.
    """
    from .kernels import gather_pair_pose, narrowphase_b

    cb = narrowphase_b(pd, gather_pair_pose(pd, body_pos, body_angle), margin)
    seps = cb.sep.T  # [P, 2]
    pmask = cb.pmask.T > 0.0
    return Contacts(
        body_a=pd.body_a,
        body_b=pd.body_b,
        collider_a=pd.pair_a,
        collider_b=pd.pair_b,
        normal_a=jnp.stack([cb.n_ax, cb.n_ay], axis=-1),
        anchor_a=jnp.stack([cb.a_ax.T, cb.a_ay.T], axis=-1),
        anchor_b=jnp.stack([cb.b_ax.T, cb.b_ay.T], axis=-1),
        point_mask=pmask,
        solve_mask=cb.solve_mask.T > 0.0,
        friction=pd.friction,
        restitution=pd.restitution,
        touching=jnp.any(pmask & (seps < TOUCH_SLOP), axis=1),
        separation=seps,
    )
