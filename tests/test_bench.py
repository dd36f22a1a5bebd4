"""bench.py's scene builders and chunk runner at reduced size on the CPU,
and its refusal to measure without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402

SMALL = dict(worlds=2, bodies=12, pile_bodies=40)


@pytest.mark.parametrize("config", bench.CONFIGS)
def test_build_scene_reduced(config):
    scene = bench.build_scene(config, **SMALL)
    batched = config.startswith("batched")
    assert (scene.world.bodies.pos.ndim == 3) == batched
    if batched:
        assert scene.world.bodies.pos.shape[0] == 2
    if config.startswith("pile"):
        assert (np.asarray(scene.world.bodies.inv_mass) > 0).sum() == 40
    assert (scene.config.sleep_velocity > 0) == (
        config in ("pile", "pile_joints", "pile_compound"))


@pytest.mark.parametrize("config", ["batched", "pile_events", "box_stack"])
def test_chunk_runner_counts(config):
    scene = bench.build_scene(config, **SMALL)
    run = bench.chunk_runner(scene, 3, with_events=config == "pile_events")
    w, counters = jax.block_until_ready(run(scene.world))
    pair_ovf, cell_ovf, events = (int(x) for x in np.asarray(counters))
    assert pair_ovf == 0 and cell_ovf == 0
    assert np.isfinite(np.asarray(w.bodies.pos)).all()
    assert int(np.asarray(w.step_count).max()) == 3
    if config == "pile_events":
        assert events >= 0


def test_bench_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "bench.py", "--config", "box_stack"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr
