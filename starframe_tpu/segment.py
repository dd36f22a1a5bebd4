"""Deterministic segment sums: per-body totals of per-constraint values.

The solver sums each substep's constraint corrections into their bodies.
``zeros.at[idx].add(vals)`` lowers to floating-point atomics on a GPU, so
the order of the additions — and with it the rounding — changes from run to
run, and bitwise replay (BASELINE.json:11) is lost. Here the order is fixed
by the data instead: entries are stably sorted by target once per frame
(:func:`plan`; the targets do not change inside a frame), and each
accumulation is a segmented prefix sum over that order (:func:`segment_sum`).
Sums restart at every target, so there is no cancellation across targets.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SegmentPlan(NamedTuple):
    """Sorted layout of ``K`` entries over ``N`` targets."""

    order: jax.Array  # [K] i32 stable argsort of the entry targets
    head: jax.Array  # [K] bool: sorted entry k starts a target's run
    last: jax.Array  # [N] i32 sorted position of each target's last entry
    has: jax.Array  # [N] bool: the target has any entry


def plan(idx: jax.Array, n: int) -> SegmentPlan:
    """Plan for entries targeting ``idx`` ([K] ints in ``[0, n)``)."""
    idx = idx.astype(jnp.int32)
    order = jnp.argsort(idx, stable=True).astype(jnp.int32)
    sidx = idx[order]
    head = jnp.concatenate([jnp.ones((1,), bool), sidx[1:] != sidx[:-1]])
    ids = jnp.arange(n, dtype=jnp.int32)
    end = jnp.searchsorted(sidx, ids, side="right").astype(jnp.int32)
    start = jnp.searchsorted(sidx, ids, side="left").astype(jnp.int32)
    return SegmentPlan(order, head, jnp.maximum(end - 1, 0), end > start)


def _combine(a, b):
    # segmented addition: b's run restarts wherever b holds a run head
    fa, va = a
    fb, vb = b
    return fa | fb, jnp.where(fb[..., None], vb, va + vb)


def segment_sum(vals: jax.Array, p: SegmentPlan) -> jax.Array:
    """``[N, C]`` per-target sums of ``vals`` ([K, C], laid out like the
    ``idx`` the plan was made from); 0 for targets with no entry."""
    sv = vals[p.order]
    _, run = jax.lax.associative_scan(_combine, (p.head, sv))
    return jnp.where(p.has[:, None], run[p.last], 0.0)
