"""2D global illumination: radiance cascades (SURVEY.md §2 row 18).

Starframe's recent lighting system is a radiance-cascades-style 2D GI pass
over the scene (point/area emitters, occluders, soft penumbrae). The
array-program rebuild expresses the whole pipeline as dense array work under
jit — scene rasterization, per-cascade interval raymarching, and the
top-down cascade merge are maps/scans over image grids, which is exactly
the shape XLA vectorizes well. This is a rendering feature (off the physics
metric path); it runs on any backend.

Pipeline (``illuminate``):

1. Rasterize: colliders -> occupancy [H, W] (opacity), emitters -> radiance
   [H, W, 3] (from body-attached or free-floating :class:`Light`s).
2. Cascade k (k = n-1 .. 0): probes every 2^k pixels, 4 * 2^k directions,
   each marching the radial interval [t_k, t_k+1) through the occupancy
   with alpha compositing; merged with the bilinearly-upsampled cascade
   k+1 radiance where the interval ray escaped unoccluded.
3. Irradiance = direction-average of cascade 0 — the lit image.

The cascade construction gives each scene point ~O(log R) rays total while
resolving both sharp near shadows and soft distant light — the property
radiance cascades are known for.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .state import World


@dataclasses.dataclass
class Light:
    pos: tuple  # world position
    color: tuple = (1.0, 1.0, 1.0)
    radius: float = 0.5  # emitter disc radius
    intensity: float = 1.0
    body: Optional[int] = None  # optional: follow a body


def rasterize_occupancy(world: World, lo, hi, res: int = 256):
    """Collider opacity [res, res] on the world window [lo, hi] (active,
    non-sensor colliders occlude)."""
    from .narrowphase import world_verts
    from .queries import _point_in_shape

    lo = jnp.asarray(lo, jnp.float32)
    hi = jnp.asarray(hi, jnp.float32)
    xs = lo[0] + (jnp.arange(res) + 0.5) / res * (hi[0] - lo[0])
    ys = lo[1] + (jnp.arange(res) + 0.5) / res * (hi[1] - lo[1])
    grid = jnp.stack(jnp.meshgrid(xs, ys, indexing="xy"), -1)  # [H, W, 2]

    wverts = world_verts(world)
    c = world.colliders
    keep = c.active & jnp.logical_not(c.is_sensor)

    def per_collider(v, nv, r, k):
        inside = jax.vmap(jax.vmap(lambda p: _point_in_shape(p, v, nv, r)))(grid)
        return inside & k

    hit = jax.vmap(per_collider)(wverts, c.nverts, c.radius, keep)
    return jnp.any(hit, axis=0).astype(jnp.float32)  # [H, W]


def rasterize_emitters(world: World, lights: Sequence[Light], lo, hi,
                       res: int = 256):
    """Emitter radiance [res, res, 3]."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    xs = lo[0] + (np.arange(res) + 0.5) / res * (hi[0] - lo[0])
    ys = lo[1] + (np.arange(res) + 0.5) / res * (hi[1] - lo[1])
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    img = np.zeros((res, res, 3), np.float32)
    pos = np.asarray(world.bodies.pos)
    for lt in lights:
        p = np.asarray(lt.pos, np.float32)
        if lt.body is not None:
            p = pos[lt.body] + p
        d2 = (gx - p[0]) ** 2 + (gy - p[1]) ** 2
        disc = (d2 <= lt.radius**2).astype(np.float32)
        img += disc[..., None] * np.asarray(lt.color, np.float32) * lt.intensity
    return jnp.asarray(img)


def _bilinear(img, yx):
    """Bilinear sample img [H, W, C] at fractional pixel coords yx [..., 2]."""
    H, W = img.shape[0], img.shape[1]
    y = jnp.clip(yx[..., 0], 0.0, H - 1.0)
    x = jnp.clip(yx[..., 1], 0.0, W - 1.0)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, H - 1)
    x1 = jnp.minimum(x0 + 1, W - 1)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    a = img[y0, x0]
    b = img[y0, x1]
    c = img[y1, x0]
    d = img[y1, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


@partial(jax.jit, static_argnames=("n_cascades", "base_dirs", "steps"))
def radiance_cascades(emissive, occupancy, n_cascades: int = 5,
                      base_dirs: int = 4, steps: int = 8):
    """Compute GI via radiance cascades.

    emissive [H, W, 3]; occupancy [H, W] in [0, 1]. Returns irradiance
    [H, W, 3]. Cascade k probes sit every 2^k pixels with ``base_dirs * 2^k``
    directions covering the radial interval [I_k, I_k+1), I_k = 2^k - 1
    (in pixels, scaled by base interval)."""
    H, W = occupancy.shape
    base_len = 2.0  # pixels covered by cascade 0

    def march(y0, x0, dirs, t0, t1):
        """Raymarch [t0, t1) from fractional pixel (y0, x0) along dirs
        [D, 2]; returns (radiance [.., D, 3], transmittance [.., D, 1])."""
        ts = t0 + (jnp.arange(steps) + 0.5) / steps * (t1 - t0)
        dt = (t1 - t0) / steps

        def sample(t):
            yx = jnp.stack([
                y0[..., None] + dirs[:, 0] * t,
                x0[..., None] + dirs[:, 1] * t,
            ], -1)  # [..., D, 2]
            occ = _bilinear(occupancy[..., None], yx)  # [..., D, 1]
            emi = _bilinear(emissive, yx)  # [..., D, 3]
            return occ, emi

        def body(carry, t):
            rad, trans = carry
            occ, emi = sample(t)
            # emitters are treated as their own (unit-density) medium so a
            # ray entering a light disc picks up its radiance even when the
            # occupancy there is zero
            alpha = 1.0 - jnp.exp(
                -(occ + (emi.sum(-1, keepdims=True) > 0)) * dt * 2.0)
            rad = rad + trans * emi * alpha
            trans = trans * (1.0 - alpha)
            return (rad, trans), None

        D = dirs.shape[0]
        rad0 = jnp.zeros(y0.shape + (D, 3))
        tr0 = jnp.ones(y0.shape + (D, 1))
        (rad, trans), _ = jax.lax.scan(body, (rad0, tr0), ts)
        return rad, trans

    upper = None  # cascade k+1 radiance [Hk1, Wk1, D_k1, 3]
    for k in range(n_cascades - 1, -1, -1):
        sp = 2**k
        Hk, Wk = H // sp, W // sp
        D = base_dirs * (2**k)
        ang = (jnp.arange(D) + 0.5) / D * 2 * jnp.pi
        dirs = jnp.stack([jnp.sin(ang), jnp.cos(ang)], -1)  # (dy, dx)
        yy = (jnp.arange(Hk) + 0.5) * sp
        xx = (jnp.arange(Wk) + 0.5) * sp
        y0, x0 = jnp.meshgrid(yy, xx, indexing="ij")
        t0 = base_len * (2.0**k - 1.0)
        t1 = base_len * (2.0 ** (k + 1) - 1.0)
        rad, trans = march(y0, x0, dirs, t0, t1)  # [Hk, Wk, D, 3/1]

        if upper is not None:
            # merge: where this interval stayed clear, continue into the
            # (2x coarser, 2x more directions) parent cascade's radiance
            Hk1, Wk1, D1, _ = upper.shape
            py = (y0 / (2.0 * sp)) - 0.5
            px = (x0 / (2.0 * sp)) - 0.5
            pimg = upper.reshape(Hk1, Wk1, D1 * 3)
            up = _bilinear(pimg, jnp.stack([py, px], -1)).reshape(Hk, Wk, D1, 3)
            # each direction d inherits its two children (2d, 2d+1)
            parent = 0.5 * (up[:, :, 0::2][:, :, :D] + up[:, :, 1::2][:, :, :D])
            rad = rad + trans * parent
        upper = rad

    return upper.mean(axis=2)  # direction average -> irradiance [H, W, 3]


def illuminate(world: World, lights: Sequence[Light], lo, hi, res: int = 256,
               n_cascades: int = 5, ambient: float = 0.02):
    """Full GI pass: rasterize the world + lights, run the cascades, return
    an irradiance image [res, res, 3] (row 0 = top of the window)."""
    occ = rasterize_occupancy(world, lo, hi, res)
    emi = rasterize_emitters(world, lights, lo, hi, res)
    img = radiance_cascades(emi, occ, n_cascades=n_cascades)
    img = img + ambient
    return jnp.flipud(jnp.clip(img, 0.0, 1.0))


def save_png(path: str, img) -> str:
    """Write an irradiance image to PNG (matplotlib backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, np.asarray(img))
    return path
