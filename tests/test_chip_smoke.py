"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to run
without a GPU. The full-size run is ``python chip_smoke.py`` on the card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def test_phase_flagship_tiny():
    diff = cs.phase_flagship(n_worlds=4, n_bodies=16, substeps=2, frames=4,
                             step_frames=2)
    assert diff <= cs.REF_ATOL


def test_phase_pile_tiny():
    diff = cs.phase_pile(n_bodies=120, frames=4, step_frames=2)
    assert diff <= cs.REF_ATOL


def test_phase_determinism_tiny():
    cs.phase_determinism(n_worlds=4, n_bodies=16, substeps=2,
                         flagship_frames=3, pile_bodies=120, pile_frames=3)


def test_phase_scenes_tiny():
    cs.phase_scenes(frames=2)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_phase_sharded_tiny(cpu_devices, n_devices):
    diff = cs.phase_sharded(n_devices=n_devices, n_worlds=2 * n_devices,
                            n_bodies=16, substeps=2, frames=2,
                            devices=cpu_devices)
    assert diff <= cs.REF_ATOL


@pytest.mark.parametrize("diffs, ok", [
    ([0.0] * 200, True),
    ([2e-4] * 198 + [0.02, 0.03], True),     # two contact flips of 200
    ([2e-3] * 200, False),                   # everyone off: a wrong solve
    ([0.0] * 199 + [0.2], False),            # one body far beyond a flip
])
def test_check_reference_bounds(diffs, ok):
    import numpy as np

    if ok:
        cs.check_reference("t", np.asarray(diffs))
    else:
        with pytest.raises(AssertionError):
            cs.check_reference("t", np.asarray(diffs))


def test_analytic_probes():
    assert abs(cs.drop_ball() - 2.1) <= 0.1
    assert abs(cs.resting_circle() - 0.5) <= 0.02


def _run_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--chips", "4")])
def test_main_refuses_cpu(args):
    out = _run_smoke(REPO, *args)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_main_fails_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_phases_on_gpu(gpu_device):
    """On the card: the phases at reduced sizes, kernels as compiled."""
    cs.phase_flagship(n_worlds=256, frames=20, step_frames=5)
    cs.phase_pile(n_bodies=2000, frames=20, step_frames=5)
    cs.phase_scenes(frames=20)
