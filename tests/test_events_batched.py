"""Contact events + batched rollout + replay determinism
(BASELINE.json:11 "deterministic replay")."""

import numpy as np
import pytest

import starframe_tpu as sf
from starframe_tpu.shapes import Shape

from mixed_scene import mixed_scene


def test_contact_events_started_and_ended():
    b = sf.WorldBuilder()
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(10.0, 0.5), restitution=0.9)
    ball = b.add_body(pos=(0.0, 1.2))
    b.add_collider(ball, Shape.circle(0.3), restitution=0.9)
    world, cap = b.build()
    step = sf.make_step(sf.SolverConfig(restitution_threshold=0.1),
                        cap.max_pairs, with_contacts=True, donate=False)
    ev = sf.ContactEvents()
    history = []
    for _ in range(90):
        world, contacts, diag = step(world)
        ev.update(contacts)
        if ev.started:
            history.append("start")
        if ev.ended:
            history.append("end")
    # restitution 0.9 from 1.2: bounces -> at least one start AND one end
    assert "start" in history and "end" in history
    pair = (0, 1)
    assert all(s == {pair} or s == set() for s in [ev.started, ev.ended])


def test_touching_keys_unique():
    """Regression (ADVICE r1, medium): with x64 disabled, an int64 shift-pack
    truncates to the low word and keys (1,5) and (3,5) collide. Keys must be
    unique per canonical pair."""
    import itertools

    import jax.numpy as jnp

    from starframe_tpu.contacts import Contacts
    from starframe_tpu.events import touching_keys

    import dataclasses

    n = 13
    pairs = list(itertools.combinations(range(n), 2))
    p = len(pairs)
    ca = jnp.array([q[0] for q in pairs], jnp.int32)
    cb = jnp.array([q[1] for q in pairs], jnp.int32)
    zp = jnp.zeros((p,), jnp.float32)
    zp2 = jnp.zeros((p, 2), jnp.float32)
    z22 = jnp.zeros((p, 2, 2), jnp.float32)
    mask = jnp.ones((p, 2), bool)
    c = Contacts(
        body_a=ca, body_b=cb, collider_a=ca, collider_b=cb,
        normal_a=zp2, anchor_a=z22, anchor_b=z22,
        point_mask=mask, solve_mask=mask, friction=zp, restitution=zp,
        touching=jnp.ones((p,), bool), separation=zp2,
    )
    keys, touching = touching_keys(c, n_colliders=n)
    keys = np.asarray(keys)
    assert len(np.unique(keys)) == p
    # swapped order produces the same canonical key
    c_swapped = dataclasses.replace(c, collider_a=cb, collider_b=ca)
    keys2, _ = touching_keys(c_swapped, n_colliders=n)
    np.testing.assert_array_equal(keys, np.asarray(keys2))


def test_batched_rollout_and_determinism():
    scene = sf.scenes.batched_worlds(n_worlds=8, n_bodies=16, substeps=4)
    roll = sf.parallel.make_batched_rollout(scene.config, scene.capacity.max_pairs, 20)
    final1, traj1, diag1 = roll(scene.world)
    final2, traj2, _ = roll(scene.world)
    assert int(np.asarray(diag1["pair_overflow"])) == 0
    assert int(np.asarray(diag1["cell_overflow"])) == 0
    # bit-exact determinism across runs (BASELINE.json:11)
    np.testing.assert_array_equal(np.asarray(final1.bodies.pos), np.asarray(final2.bodies.pos))
    np.testing.assert_array_equal(np.asarray(traj1[0]), np.asarray(traj2[0]))
    assert traj1[0].shape == (20, 8, 16, 2)
    assert np.isfinite(np.asarray(final1.bodies.pos)).all()


def test_batched_step_determinism():
    """Frame-by-frame batched replays are bit-exact."""
    scene = sf.scenes.batched_worlds(n_worlds=4, n_bodies=32, substeps=6, seed=3)
    step = sf.make_batched_step(scene.config, scene.capacity.max_pairs, donate=False)

    def run():
        w = scene.world
        for _ in range(30):
            w = step(w)
        return np.asarray(w.bodies.pos), np.asarray(w.bodies.angle)

    p1, a1 = run()
    p2, a2 = run()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(a1, a2)


def _event_sets(prev_keys, keys, m):
    import jax.numpy as jnp

    from starframe_tpu.events import key_event_masks, keys_to_set

    started, ended = key_event_masks(prev_keys, keys)
    return (keys_to_set(np.asarray(jnp.where(started, keys, -1)), m),
            keys_to_set(np.asarray(jnp.where(ended, prev_keys, -1)), m))


@pytest.mark.parametrize("seed", [21, 22])
def test_batched_event_masks_match_xla_diffs(seed):
    """started/ended events computed on device from batched_step_events'
    canonical keys match each world's per-step ``diff_contacts``, frame by
    frame."""
    import jax

    from starframe_tpu.config import SolverConfig
    from starframe_tpu.events import diff_contacts, keys_to_set
    from starframe_tpu.parallel import (batch_worlds, batched_step_events,
                                        world_slice)
    from starframe_tpu.step import step

    worlds_list = [mixed_scene(n=32, seed=seed + k)[0] for k in range(2)]
    _, cap = mixed_scene(n=32, seed=seed)
    cfg = SolverConfig(substeps=4, restitution_threshold=0.1)
    worlds = batch_worlds(worlds_list)
    M = worlds.colliders.m

    ev_step = jax.jit(lambda w: batched_step_events(w, cfg, cap.max_pairs))
    step_x = jax.jit(lambda w: step(w, cfg, cap.max_pairs)[:2])
    w_k = worlds
    w_x = list(worlds_list)
    prev_keys, prev_contacts = None, [None, None]
    n_events = 0
    for frame in range(24):
        w_k, keys, diag = ev_step(w_k)
        assert int(np.asarray(diag["pair_overflow"])) == 0
        for wi in range(2):
            w_x[wi], contacts = step_x(w_x[wi])
            np.testing.assert_array_equal(
                np.asarray(world_slice(w_k, wi).bodies.pos),
                np.asarray(w_x[wi].bodies.pos))
            x_started, x_persisted, x_ended = diff_contacts(
                prev_contacts[wi], contacts)
            assert keys_to_set(np.asarray(keys[wi]), M) == (
                x_started | x_persisted), f"frame {frame}: touching differ"
            if prev_keys is not None:
                k_started, k_ended = _event_sets(prev_keys[wi], keys[wi], M)
                assert k_started == x_started, f"frame {frame}: started"
                assert k_ended == x_ended, f"frame {frame}: ended"
                n_events += len(k_started) + len(k_ended)
            prev_contacts[wi] = jax.tree.map(np.asarray, contacts)
        prev_keys = keys
    assert n_events > 0, "scene produced no contact events to compare"


def test_batched_rollout_with_keys_matches_per_step_events():
    """batched_rollout(with_keys=True) stacks the same canonical touch keys
    per frame that batched_step_events produces step by step."""
    import jax

    from starframe_tpu.config import SolverConfig
    from starframe_tpu.events import keys_to_set
    from starframe_tpu.parallel import (batched_rollout, batched_step_events,
                                        replicate_world)

    world, cap = mixed_scene(n=32, seed=11)
    worlds = replicate_world(world, 2)
    M = world.colliders.m
    n_frames = 18
    cfg = SolverConfig(substeps=4)
    final, traj, diag = jax.jit(
        lambda w: batched_rollout(w, cfg, cap.max_pairs, n_frames,
                                  with_keys=True))(worlds)
    (_, keys) = traj
    assert keys.shape == (n_frames, 2, cap.max_pairs)
    ev_step = jax.jit(lambda w: batched_step_events(w, cfg, cap.max_pairs))
    w_s = worlds
    n_touching = 0
    for f in range(n_frames):
        w_s, keys_s, dg = ev_step(w_s)
        assert int(np.asarray(dg["pair_overflow"])) == 0
        for wi in range(2):
            roll_set = keys_to_set(np.asarray(keys[f][wi]), M)
            assert roll_set == keys_to_set(np.asarray(keys_s[wi]), M), (f, wi)
            n_touching += len(roll_set)
    np.testing.assert_array_equal(np.asarray(final.bodies.pos),
                                  np.asarray(w_s.bodies.pos))
    assert n_touching > 0
