"""2D math core: rotations, poses (isometries), AABB helpers.

Array-program equivalent of starframe's math layer (expected upstream
``src/math.rs``: ``Pose``/``Vec2``/``Rotor2``/``AABB`` — SURVEY.md §2 row 1;
the pose+velocity body model is driver-normative, BASELINE.json:5).

Representation choices (SoA-friendly, fully vmappable):

- a rotation is a scalar angle in radians; cos/sin are computed at use sites
  (XLA fuses these into the surrounding elementwise work);
- a pose is the pair ``(pos[..., 2], angle[...])`` passed as separate arrays
  so callers keep structure-of-arrays layout;
- everything is a pure function of jnp arrays; no classes on the hot path.

All functions broadcast over arbitrary leading batch axes.
"""

from __future__ import annotations

import jax.numpy as jnp


def rotate(angle, v):
    """Rotate 2D vector(s) ``v[..., 2]`` by ``angle[...]`` radians (CCW)."""
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    x = v[..., 0]
    y = v[..., 1]
    return jnp.stack([c * x - s * y, s * x + c * y], axis=-1)


def rotate_inv(angle, v):
    """Rotate ``v`` by ``-angle`` (inverse rotation)."""
    return rotate(-angle, v)


def transform(pos, angle, v):
    """Apply pose ``(pos, angle)`` to local point(s) ``v``: R(angle) v + pos."""
    return rotate(angle, v) + pos


def transform_inv(pos, angle, p):
    """Map world point(s) ``p`` into the local frame of pose ``(pos, angle)``."""
    return rotate(-angle, p - pos)


def compose(pos_a, ang_a, pos_b, ang_b):
    """Compose two poses: ``a ∘ b`` (apply b first, then a)."""
    return transform(pos_a, ang_a, pos_b), ang_a + ang_b


def perp(v):
    """90° CCW perpendicular: (x, y) -> (-y, x)."""
    return jnp.stack([-v[..., 1], v[..., 0]], axis=-1)


def perp_cw(v):
    """90° CW perpendicular: (x, y) -> (y, -x). Outward normal of CCW edge."""
    return jnp.stack([v[..., 1], -v[..., 0]], axis=-1)


def cross2(a, b):
    """2D scalar cross product: a.x*b.y - a.y*b.x."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def cross_sv(s, v):
    """Cross product of out-of-plane scalar ``s`` with vector ``v``: s ẑ × v."""
    return jnp.stack([-s * v[..., 1], s * v[..., 0]], axis=-1)


def dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def norm(v, eps=0.0):
    return jnp.sqrt(dot2(v, v) + eps)


def normalize(v, eps: float = 1e-12):
    """Safe normalize; returns (unit_vector, length). Zero vectors -> (0, 0)."""
    n = norm(v)
    inv = jnp.where(n > eps, 1.0 / jnp.maximum(n, eps), 0.0)
    return v * inv[..., None], n


def normalize_or(v, fallback, eps: float = 1e-8):
    """Normalize ``v``; where its length <= eps, return ``fallback`` instead."""
    n = norm(v)
    unit = v / jnp.maximum(n, eps)[..., None]
    return jnp.where((n > eps)[..., None], unit, fallback), n


def angle_wrap(a):
    """Wrap angle(s) to (-pi, pi]."""
    return a - 2.0 * jnp.pi * jnp.round(a / (2.0 * jnp.pi))


# ---------------------------------------------------------------------------
# AABBs: stored as (lo[..., 2], hi[..., 2]) array pairs.
# ---------------------------------------------------------------------------


def aabb_overlap(lo_a, hi_a, lo_b, hi_b):
    """Boolean AABB-vs-AABB overlap test (broadcasting)."""
    return jnp.all(lo_a <= hi_b, axis=-1) & jnp.all(lo_b <= hi_a, axis=-1)


def aabb_contains(lo, hi, p):
    return jnp.all(lo <= p, axis=-1) & jnp.all(p <= hi, axis=-1)


def lerp(a, b, t):
    return a + (b - a) * t


def pose_lerp(pos0, ang0, pos1, ang1, t):
    """Interpolate poses for render interpolation (starframe's fixed-timestep
    renderer interpolates between the last two physics poses — SURVEY.md §1
    layer 5 [K-high])."""
    dang = angle_wrap(ang1 - ang0)
    return lerp(pos0, pos1, t), ang0 + dang * t
