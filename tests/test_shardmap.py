"""Sharded world axis: ``make_sharded_step`` (``shard_map`` over a 1-D mesh)
against the unsharded batched step on 2, 4 and 8 virtual CPU devices, for
the batched, rope and mechanism scenes; the compiled sharded step holds no
collective. Also covers the batched overflow diagnostics (SURVEY.md §4.6).
"""

import jax
import numpy as np
import pytest

import starframe_tpu as sf
import starframe_tpu.parallel as par
from starframe_tpu.config import Capacity, SolverConfig
from starframe_tpu.shapes import Shape
from starframe_tpu.state import WorldBuilder

N_WORLDS = 8
COLLECTIVES = ("all-reduce", "all-gather", "collective-permute", "all-to-all",
               "reduce-scatter")


def _scene(name):
    if name == "batched":
        return sf.scenes.batched_worlds(n_worlds=N_WORLDS, n_bodies=16,
                                        substeps=2)
    base = (sf.scenes.rope_bridge(n_particles=12, n_loads=2) if name == "rope"
            else sf.scenes.mechanism(n_pendulum_links=3))
    return sf.scenes.batchify(base, N_WORLDS, seed=1)


@pytest.fixture(scope="module")
def scenes():
    return {name: _scene(name) for name in ("batched", "rope", "mechanism")}


@pytest.mark.parametrize("n_devices", [2, 4, 8])
@pytest.mark.parametrize("name", ["batched", "rope", "mechanism"])
def test_sharded_step_matches_unsharded(scenes, cpu_devices, name, n_devices):
    scene = scenes[name]
    cfg, mp = scene.config, scene.capacity.max_pairs
    mesh = par.make_mesh(cpu_devices[:n_devices])
    sstep = par.make_sharded_step(cfg, mp, mesh, donate=False, with_diag=True)
    ref_step = par.make_batched_step(cfg, mp, donate=False)

    w = par.shard_world(scene.world, mesh)
    ref = jax.device_put(scene.world, cpu_devices[0])
    for _ in range(2):
        w, diag = sstep(w)
        ref = ref_step(ref)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(w.bodies.pos)),
        np.asarray(jax.device_get(ref.bodies.pos)), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(w.bodies.vel)),
        np.asarray(jax.device_get(ref.bodies.vel)), atol=1e-4)
    # one counter entry per shard, all clean
    for k, v in diag.items():
        assert v.shape == (n_devices,), k
        assert int(np.asarray(v).max()) == 0, k
    # the output stays distributed over the whole mesh
    assert len({s.device for s in w.bodies.pos.addressable_shards}) == n_devices


@pytest.mark.parametrize("name", ["batched", "rope", "mechanism"])
def test_sharded_step_has_no_collectives(scenes, cpu_devices, name):
    """Worlds are embarrassingly parallel: the compiled sharded step must
    contain no cross-device communication (BASELINE.json:11's per-device x
    linear-scaling argument)."""
    scene = scenes[name]
    mesh = par.make_mesh(cpu_devices[:4])
    sstep = par.make_sharded_step(scene.config, scene.capacity.max_pairs, mesh,
                                  donate=False, with_diag=True)
    txt = sstep.lower(par.shard_world(scene.world, mesh)).compile().as_text()
    for op in COLLECTIVES:
        assert op not in txt, f"unexpected collective {op} in sharded step"


# ---------------------------------------------------------------------------
# overflow diagnostics on the batched path
# ---------------------------------------------------------------------------


def _crowded_scene(n=32, cluster=8):
    """A deliberate pair-buffer crowder: ``cluster`` dynamic circles stacked
    in one spot, so the cluster alone has cluster*(cluster-1)/2 pairs."""
    b = WorldBuilder(gravity=(0.0, 0.0))
    for i in range(cluster):
        body = b.add_body(pos=(0.01 * i, 0.01 * i))
        b.add_collider(body, Shape.circle(0.5))
    # spread the rest far apart
    for i in range(n - cluster):
        body = b.add_body(pos=(100.0 + 10.0 * i, 0.0))
        b.add_collider(body, Shape.circle(0.3))
    cap = Capacity(max_bodies=n, max_colliders=n, max_pairs=8 * n,
                   max_joints=0, max_verts=4)
    world, cap = b.build(cap)
    return world, cap


def test_slot_overflow_surfaces_in_rollout_diag():
    """A pair buffer smaller than the cluster's 28 pairs must surface as a
    hard ``pair_overflow`` in the rollout diag; a big enough one is clean."""
    world, cap = _crowded_scene(cluster=8)
    worlds = par.replicate_world(world, 4)
    cfg = SolverConfig(substeps=2)

    _, _, diag = jax.jit(
        lambda w: par.batched_rollout(w, cfg, 8, 2))(worlds)
    assert int(np.asarray(diag["pair_overflow"])) > 0, (
        "a deliberately tiny pair buffer must surface an overflow")

    _, _, diag = jax.jit(
        lambda w: par.batched_rollout(w, cfg, cap.max_pairs, 2))(worlds)
    assert int(np.asarray(diag["pair_overflow"])) == 0
    assert int(np.asarray(diag["cell_overflow"])) == 0


def test_batched_step_with_diag_surfaces_overflow():
    """A user stepping a batch FRAME-BY-FRAME through the public API sees
    the overflow counters the rollout carries — silent truncation through
    make_batched_step was exactly the SURVEY §4.6 hazard."""
    world, cap = _crowded_scene(cluster=8)
    worlds = par.replicate_world(world, 8)
    cfg = SolverConfig(substeps=2)

    step_d = jax.jit(lambda w: par.batched_step(w, cfg, 8, with_diag=True))
    w2, diag = step_d(worlds)
    assert int(np.asarray(diag["pair_overflow"])) > 0, (
        "a deliberately tiny pair buffer must surface in the per-step diag")
    # stepping again from the returned state keeps reporting
    _, diag2 = step_d(w2)
    assert set(diag2) == {"pair_overflow", "cell_overflow"}
    assert int(np.asarray(diag2["pair_overflow"])) > 0

    _, diag = jax.jit(lambda w: par.batched_step(
        w, cfg, cap.max_pairs, with_diag=True))(worlds)
    assert int(np.asarray(diag["pair_overflow"])) == 0

    # the world-only shape is unchanged (no diag unless asked)
    w_only = jax.jit(lambda w: par.batched_step(w, cfg, cap.max_pairs))(worlds)
    assert w_only.bodies.pos.shape == worlds.bodies.pos.shape


def test_batched_step_with_diag_vmap_path():
    """The grid broadphase's cell overflow reaches the same with_diag
    surface: a one-entry cell fan-out under the stacked cluster."""
    world, cap = _crowded_scene(cluster=8)
    worlds = par.replicate_world(world, 4)
    cfg = SolverConfig(substeps=2, broadphase="grid", grid_cell_capacity=1)
    _, diag = jax.jit(lambda w: par.batched_step(
        w, cfg, cap.max_pairs, with_diag=True))(worlds)
    assert int(np.asarray(diag["cell_overflow"])) > 0
