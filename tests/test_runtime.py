"""Process setup of the entry points (starframe_tpu.runtime): where the
persistent compilation cache lives."""

from pathlib import Path

import jax
import pytest

from starframe_tpu import runtime

REPO = Path(__file__).resolve().parent.parent


def test_cache_dir_follows_env_when_set(tmp_path):
    env = {runtime.CACHE_ENV: str(tmp_path / "cache")}
    assert runtime.cache_dir(env) == tmp_path / "cache"


@pytest.mark.parametrize("env", [{}, {runtime.CACHE_ENV: ""}])
def test_cache_dir_unset_is_fixed_in_checkout(env):
    path = runtime.cache_dir(env)
    assert path == REPO / ".jax_cache"
    # fixed: the same path every time, never built from a pid or the time
    assert runtime.cache_dir(dict(env)) == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize("value", ["cache", "/var/cache/jax", "a/b c"])
def test_cache_dir_takes_env_value_verbatim(value):
    assert runtime.cache_dir({runtime.CACHE_ENV: value}) == Path(value)


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_configure_without_env_uses_checkout_cache(monkeypatch,
                                                   restore_cache_config):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    path = runtime.configure()
    assert path == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(path)
    assert runtime.configure() == path  # idempotent


def test_configure_with_env_sets_no_other_path(monkeypatch, tmp_path,
                                               restore_cache_config):
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert runtime.configure() == tmp_path
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_package_import_starts_no_backend():
    """Importing the package does no device work (no module-level device
    arrays), so a program can still set up JAX after the import."""
    import subprocess
    import sys

    code = ("import starframe_tpu\n"
            "from jax._src import xla_bridge\n"
            "assert not xla_bridge.backends_are_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
