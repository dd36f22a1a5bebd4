"""Deterministic segment sums (starframe_tpu.segment) against a plain
per-entry numpy loop, on random rows and on a frame's real contact rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import starframe_tpu as sf
from starframe_tpu import segment


def _reference(vals, idx, n):
    out = np.zeros((n, vals.shape[1]), np.float64)
    for v, i in zip(vals, idx):
        out[i] += v
    return out


@pytest.mark.parametrize("k, n", [(1, 1), (7, 3), (64, 5), (300, 40),
                                  (1000, 1000)])
def test_segment_sum_matches_loop(rng, k, n):
    idx = rng.integers(0, n, size=k)
    vals = rng.normal(size=(k, 4)).astype(np.float32)
    p = segment.plan(jnp.asarray(idx), n)
    out = np.asarray(segment.segment_sum(jnp.asarray(vals), p))
    np.testing.assert_allclose(out, _reference(vals, idx, n), rtol=1e-5,
                               atol=1e-5)


def test_segment_sum_empty_targets_are_zero(rng):
    idx = np.array([2, 2, 5, 2], np.int32)
    p = segment.plan(jnp.asarray(idx), 8)
    out = np.asarray(segment.segment_sum(jnp.ones((4, 2), jnp.float32), p))
    np.testing.assert_array_equal(out[:, 0], [0, 0, 3, 0, 0, 1, 0, 0])
    np.testing.assert_array_equal(np.asarray(p.has),
                                  [0, 0, 1, 0, 0, 1, 0, 0])


def test_segment_sum_keeps_the_data_order(rng):
    """Each target's entries are summed in their original order (stable
    sort): the result depends on the data only."""
    idx = np.zeros(5, np.int32)
    vals = np.array([[1e8], [1.0], [-1e8], [1.0], [1.0]], np.float32)
    p = segment.plan(jnp.asarray(idx), 1)
    out = float(segment.segment_sum(jnp.asarray(vals), p)[0, 0])
    # a tree sum over the five, in order, rounds the first +1 away
    assert out == float(jax.lax.associative_scan(
        jnp.add, jnp.asarray(vals[:, 0]))[-1])


@pytest.mark.parametrize("scene", ["mechanism", "pile"])
def test_contact_accumulation_matches_loop(scene):
    """One frame's real contact-solve rows, summed into bodies by the
    solver, match a float64 per-row loop."""
    from starframe_tpu.kernels import (gather_pair_pose, narrowphase_b,
                                       solve_contacts_b)
    from starframe_tpu.solver import _accumulate_contacts
    from starframe_tpu.step import frame_prep, speculative_margin

    sc = (sf.scenes.mechanism(n_pendulum_links=3) if scene == "mechanism"
          else sf.scenes.pile(n_bodies=60))
    cfg = sc.config
    stepj = jax.jit(lambda w: sf.step(w, cfg, sc.capacity.max_pairs)[0])
    w = sc.world
    for _ in range(20):  # into contact
        w = stepj(w)
    _, pd = frame_prep(w, cfg, sc.capacity.max_pairs)
    b = w.bodies
    pose = gather_pair_pose(pd, b.pos, b.angle)
    cb = narrowphase_b(pd, pose, speculative_margin(pd, b, cfg))
    vals_a, vals_b, _ = solve_contacts_b(pose, pose, pd, cb, cfg.h,
                                         cfg.contact_compliance)
    acc = _accumulate_contacts(pd, vals_a, vals_b)
    got = np.concatenate([np.asarray(acc.dpos), np.asarray(acc.dang)[:, None],
                          np.asarray(acc.count)[:, None]], axis=1)
    idx = np.concatenate([np.asarray(pd.body_a), np.asarray(pd.body_b)])
    vals = np.concatenate([np.asarray(vals_a).T, np.asarray(vals_b).T])
    assert np.abs(vals).sum() > 0  # real contacts
    np.testing.assert_allclose(got, _reference(vals, idx, b.n), rtol=1e-5,
                               atol=1e-6)
