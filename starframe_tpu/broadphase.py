"""Broadphase: candidate pair generation, fixed capacity.

Array-program replacement for starframe's hierarchical spatial grid ("HGrid",
SURVEY.md §2 row 5; BASELINE.json:5 mandates a "sort-and-segment pair
generator"). Two paths share one output contract:

- ``dense``: masked O(M²) upper-triangular AABB test — fastest under a few
  hundred colliders (one fused elementwise pass, one compaction sort).
- ``grid``: spatial hash of AABB centers -> key sort -> 9-neighborhood
  segment scan with a bounded per-cell fan-out. Colliders whose AABB exceeds
  a few cells go through a small dense "large set" (the 2-level HGrid
  hierarchy equivalent, SURVEY.md §7.3).

Both emit ``(pair_a[P], pair_b[P], valid[P], overflow)`` with P static; every
truncation is *counted* so tests can assert overflow == 0 (SURVEY.md §4.6).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .config import Capacity, SolverConfig
from .state import BODY_KINEMATIC, COL_SENSOR, World


def _dataclass_pytree(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_dataclass_pytree
class PairBuffer:
    pair_a: jax.Array  # [P] i32 collider indices
    pair_b: jax.Array  # [P] i32
    valid: jax.Array  # [P] bool
    count: jax.Array  # i32 — true number of pairs found (may exceed P)
    overflow: jax.Array  # i32 — pairs dropped (count - P, clamped at 0)
    cell_overflow: jax.Array  # i32 — grid cells fuller than the scan fan-out


@jax.named_scope("compute_aabbs")
def compute_aabbs(world: World, wverts: jax.Array, expand_margin: float, dt: float):
    """World AABBs [M, 2] (lo, hi) from world verts + radius, expanded by the
    speculative contact margin and per-frame velocity sweep (contacts are
    detected once per frame and must stay valid across substeps —
    SURVEY.md §3.2)."""
    c = world.colliders
    b = world.bodies
    r = c.radius[:, None]
    lo = jnp.min(wverts, axis=1) - r
    hi = jnp.max(wverts, axis=1) + r
    vel = b.vel[c.body_idx]
    sweep = jnp.abs(vel) * dt
    lo = lo - sweep - 0.5 * expand_margin
    hi = hi + sweep + 0.5 * expand_margin
    # inactive colliders: banish to non-overlapping points at +inf-ish
    far = 1e30
    inactive = jnp.logical_not(c.active)
    m = c.m
    offs = (jnp.arange(m, dtype=jnp.float32) * 4.0 + far)[:, None]
    lo = jnp.where(inactive[:, None], offs, lo)
    hi = jnp.where(inactive[:, None], offs + 1.0, hi)
    return lo, hi


def _pair_eligible(world: World, i, j):
    """Filters common to all paths. i, j broadcastable collider index arrays."""
    c = world.colliders
    b = world.bodies
    body_i = c.body_idx[i]
    body_j = c.body_idx[j]
    diff_body = body_i != body_j
    layer_ok = (
        ((c.mask[i] >> c.layer[j]) & 1) & ((c.mask[j] >> c.layer[i]) & 1)
    ) != 0

    def dynamicish(bi):
        return (b.inv_mass[bi] > 0) | (b.inv_inertia[bi] > 0) | ((b.flags[bi] & BODY_KINEMATIC) != 0)

    sensorish = ((c.flags[i] | c.flags[j]) & COL_SENSOR) != 0
    someone_moves = dynamicish(body_i) | dynamicish(body_j)
    return diff_body & layer_ok & (someone_moves | sensorish)


def _compact(mask_flat, idx_a_flat, idx_b_flat, max_pairs: int):
    """Compact masked candidates into the fixed pair buffer.

    Lowering note: one key sort that carries the packed (a, b) payload
    replaces ``jnp.nonzero(size=)`` + gathers: sort keys are 0 for hits and
    1 for misses (stable sort keeps hit order), then the first
    ``max_pairs`` slots are the compacted pairs."""
    count = jnp.sum(mask_flat, dtype=jnp.int32)
    key = jnp.where(mask_flat, jnp.int32(0), jnp.int32(1))
    _, pa_s, pb_s = jax.lax.sort(
        (key, idx_a_flat.astype(jnp.int32), idx_b_flat.astype(jnp.int32)),
        num_keys=1, is_stable=True,
    )
    if pa_s.shape[0] < max_pairs:  # fewer candidates than capacity: pad
        pad = max_pairs - pa_s.shape[0]
        pa_s = jnp.pad(pa_s, (0, pad))
        pb_s = jnp.pad(pb_s, (0, pad))
    pair_a = pa_s[:max_pairs]
    pair_b = pb_s[:max_pairs]
    valid = jnp.arange(max_pairs, dtype=jnp.int32) < jnp.minimum(count, max_pairs)
    pair_a = jnp.where(valid, pair_a, 0)
    pair_b = jnp.where(valid, pair_b, 0)
    overflow = jnp.maximum(count - max_pairs, 0)
    return pair_a, pair_b, valid, count, overflow


@jax.named_scope("broadphase_dense")
def dense_pairs(world: World, lo, hi, cap: Capacity) -> PairBuffer:
    m = world.colliders.m
    i = jnp.arange(m, dtype=jnp.int32)[:, None]
    j = jnp.arange(m, dtype=jnp.int32)[None, :]
    overlap = jnp.all(lo[:, None, :] <= hi[None, :, :], axis=-1) & jnp.all(
        lo[None, :, :] <= hi[:, None, :], axis=-1
    )
    mask = (i < j) & overlap & _pair_eligible(world, i, j)
    ii = jnp.broadcast_to(i, (m, m)).ravel()
    jj = jnp.broadcast_to(j, (m, m)).ravel()
    pa, pb, valid, count, overflow = _compact(mask.ravel(), ii, jj, cap.max_pairs)
    return PairBuffer(pa, pb, valid, count, overflow, jnp.zeros((), jnp.int32))


_HASH_X = np.uint32(0x9E3779B1).astype(np.int32)  # int32 wraparound
_HASH_Y = np.uint32(0x85EBCA77).astype(np.int32)


def _hash_cell(cx, cy):
    """Spatial hash of integer cell coords -> non-negative int32."""
    h = cx * _HASH_X ^ (cy * _HASH_Y)
    h = h ^ (h >> 15)
    return h & jnp.int32(0x7FFFFFFF)


_SENTINEL = np.int32(0x7FFFFFFF)


@jax.named_scope("broadphase_grid")
def grid_pairs(world: World, lo, hi, cap: Capacity, cfg: SolverConfig) -> PairBuffer:
    """Sort-and-segment spatial hash (SURVEY.md §7.3).

    Cell size is data-dependent (mean active extent × 1.5) — a traced scalar,
    which is fine under jit since only shapes must be static.
    """
    c = world.colliders
    m = c.m
    K = cfg.grid_cell_capacity
    L = min(cfg.max_large, m)

    active = c.active
    ext = hi - lo
    max_ext = jnp.max(ext, axis=-1)  # [M]
    n_active = jnp.maximum(jnp.sum(active), 1)
    mean_ext = jnp.sum(jnp.where(active, max_ext, 0.0)) / n_active
    cell = jnp.maximum(mean_ext * 1.5, 1e-3)

    # Correctness bound, not a tuning knob: the center-hash 9-neighborhood
    # scan finds a small-small pair iff the centers differ by <= 1 cell per
    # axis, which overlap guarantees only when e_i + e_j <= 2*cell. Keeping
    # every extent-> cell collider in the "small" set therefore guarantees
    # completeness; anything larger goes through the dense large-set path.
    # (A 3*cell threshold here silently dropped overlapping mid-size pairs.)
    is_large = active & (max_ext > cell)
    is_small = active & jnp.logical_not(is_large)

    # ---- small-small via hashed grid ----
    center = (lo + hi) * 0.5
    cx = jnp.floor(center[:, 0] / cell).astype(jnp.int32)
    cy = jnp.floor(center[:, 1] / cell).astype(jnp.int32)
    key = jnp.where(is_small, _hash_cell(cx, cy), _SENTINEL)
    order = jnp.argsort(key)
    skey = key[order]

    # 9-neighborhood hashes per collider, deduped against hash collisions
    dx = jnp.array([-1, 0, 1, -1, 0, 1, -1, 0, 1], jnp.int32)
    dy = jnp.array([-1, -1, -1, 0, 0, 0, 1, 1, 1], jnp.int32)
    nh = _hash_cell(cx[:, None] + dx[None, :], cy[:, None] + dy[None, :])  # [M, 9]
    # mask duplicate hashes within the 9 (collisions would duplicate pairs)
    dup = (nh[:, :, None] == nh[:, None, :]) & (
        jnp.arange(9)[None, :, None] > jnp.arange(9)[None, None, :]
    )
    nh = jnp.where(jnp.any(dup, axis=2) | jnp.logical_not(is_small)[:, None], _SENTINEL, nh)

    start = jnp.searchsorted(skey, nh.ravel(), side="left").reshape(m, 9)  # [M, 9]
    pos = start[:, :, None] + jnp.arange(K, dtype=jnp.int32)[None, None, :]  # [M, 9, K]
    in_range = pos < m
    pos_c = jnp.clip(pos, 0, m - 1)
    hit = in_range & (skey[pos_c] == nh[:, :, None]) & (nh[:, :, None] != _SENTINEL)
    cand = order[pos_c]  # [M, 9, K] candidate collider j for each i

    i_idx = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32)[:, None, None], cand.shape)
    overlap = jnp.all(lo[cand] <= hi[i_idx], axis=-1) & jnp.all(lo[i_idx] <= hi[cand], axis=-1)
    ss_mask = hit & (i_idx < cand) & overlap & _pair_eligible(world, i_idx, cand)

    # cell overflow: an entry K slots later still in the same cell => missed
    pos_k = jnp.arange(m)
    prev = jnp.clip(pos_k - K, 0, m - 1)
    cell_over = jnp.sum(
        ((skey == skey[prev]) & (pos_k >= K) & (skey != _SENTINEL)).astype(jnp.int32)
    )

    # ---- large sets (2nd HGrid level equivalent) ----
    (large_idx,) = jnp.nonzero(is_large, size=L, fill_value=0)
    n_large = jnp.sum(is_large, dtype=jnp.int32)
    lvalid = jnp.arange(L) < jnp.minimum(n_large, L)
    large_overflow = jnp.maximum(n_large - L, 0)

    li = large_idx  # [L]
    # large vs all (small+large): [L, M]
    all_j = jnp.arange(m, dtype=jnp.int32)[None, :]
    li_b = li[:, None]
    lm_overlap = jnp.all(lo[all_j] <= hi[li_b], axis=-1) & jnp.all(lo[li_b] <= hi[all_j], axis=-1)
    other_large = is_large[all_j]
    # dedupe: large-small always (large as 'a'); large-large only li < j
    lm_mask = (
        lvalid[:, None]
        & lm_overlap
        & _pair_eligible(world, li_b, all_j)
        & jnp.where(other_large, li_b < all_j, li_b != all_j)
        & (is_small[all_j] | other_large)
    )

    # ---- compact all candidates into the pair buffer ----
    mask_flat = jnp.concatenate([ss_mask.ravel(), lm_mask.ravel()])
    ia_flat = jnp.concatenate([i_idx.ravel(), jnp.broadcast_to(li_b, lm_mask.shape).ravel()])
    jb_flat = jnp.concatenate([cand.ravel(), jnp.broadcast_to(all_j, lm_mask.shape).ravel()])
    pa, pb, valid, count, overflow = _compact(mask_flat, ia_flat, jb_flat, cap.max_pairs)
    return PairBuffer(pa, pb, valid, count, overflow + large_overflow, cell_over)


def broadphase(world: World, lo, hi, cap: Capacity, cfg: SolverConfig) -> PairBuffer:
    mode = cfg.broadphase
    if mode == "auto":
        # measured on an H100 (PERF.md, PR 1): dense beats grid by ~20% at
        # 64 and 128 colliders, and grid at 256 overflows the default cell
        # fan-out in a settling batch
        mode = "dense" if cap.max_colliders <= 384 else "grid"
    if mode == "dense":
        return dense_pairs(world, lo, hi, cap)
    if mode == "grid":
        return grid_pairs(world, lo, hi, cap, cfg)
    raise ValueError(f"unknown broadphase {mode!r}")
