"""Batched + sharded world tests on the 8-virtual-CPU-device mesh
(SURVEY.md §4.5: "multi-node without a cluster")."""

import jax
import numpy as np
import pytest

import starframe_tpu as sf


@pytest.fixture(scope="module")
def small_batch():
    scene = sf.scenes.batched_worlds(n_worlds=16, n_bodies=12, substeps=3)
    return scene


def test_batched_step_equals_per_world_step(small_batch):
    """vmapped step == stepping each world separately."""
    scene = small_batch
    bstep = sf.make_batched_step(scene.config, scene.capacity.max_pairs, donate=False)
    out = bstep(scene.world)

    sstep = sf.make_step(scene.config, scene.capacity.max_pairs, donate=False)
    w3 = sstep(sf.parallel.world_slice(scene.world, 3))
    np.testing.assert_allclose(
        np.asarray(out.bodies.pos[3]), np.asarray(w3.bodies.pos), atol=1e-5
    )


def test_sharded_step_matches_unsharded(small_batch, cpu_devices):
    scene = small_batch
    mesh = sf.parallel.make_mesh(cpu_devices[:8])

    # unsharded reference on cpu device 0
    ref_in = jax.device_put(scene.world, cpu_devices[0])
    bstep = sf.make_batched_step(scene.config, scene.capacity.max_pairs, donate=False)
    ref = bstep(ref_in)

    sharded_in = sf.parallel.shard_world(scene.world, mesh)
    sstep = sf.parallel.make_sharded_step(
        scene.config, scene.capacity.max_pairs, mesh, donate=False
    )
    out = sstep(sharded_in)

    np.testing.assert_allclose(
        np.asarray(jax.device_get(out.bodies.pos)),
        np.asarray(jax.device_get(ref.bodies.pos)),
        atol=1e-5,
    )
    # output really is distributed over the mesh
    devs = {s.device for s in out.bodies.pos.addressable_shards}
    assert len(devs) == 8


def test_worlds_stay_independent(small_batch):
    """Perturbing one world never leaks into the others (BASELINE.json:11)."""
    import dataclasses
    import jax.numpy as jnp

    scene = small_batch
    bstep = sf.make_batched_step(scene.config, scene.capacity.max_pairs, donate=False)

    w = scene.world
    vel = w.bodies.vel.at[5].add(7.0)  # kick world 5 only
    w_kicked = dataclasses.replace(w, bodies=dataclasses.replace(w.bodies, vel=vel))

    a = bstep(w)
    b = bstep(w_kicked)
    pa = np.asarray(a.bodies.pos)
    pb = np.asarray(b.bodies.pos)
    others = [i for i in range(16) if i != 5]
    np.testing.assert_array_equal(pa[others], pb[others])
    assert not np.allclose(pa[5], pb[5])


def test_global_metrics_aggregate(small_batch, cpu_devices):
    scene = small_batch
    mesh = sf.parallel.make_mesh(cpu_devices[:8])
    sharded = sf.parallel.shard_world(scene.world, mesh)
    m = sf.parallel.global_metrics(sharded)
    assert np.isfinite(float(m["total_kinetic_energy"]))
    assert m["n_worlds"] == 16


def test_graft_entry_dryrun(cpu_devices):
    """The multi-device dry run passes on the virtual CPU mesh."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as g

    with jax.default_device(cpu_devices[0]):
        g.dryrun_multichip(8)
