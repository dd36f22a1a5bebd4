"""Process-level setup shared by the command-line entry points
(``chip_smoke.py``, ``bench.py``, ``examples/sandbox.py``): the persistent
compilation cache, and the card record measurements are reported with.

``JAX_COMPILATION_CACHE_DIR``, when set, is where JAX keeps compiled
programs and nothing here overrides it. Otherwise the cache lives in
``.jax_cache/`` at the root of the checkout — a fixed path, because the path
is part of the cache key and a moving directory never hits. Call
:func:`configure` before the process's first compilation.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir(environ=None) -> Path:
    """Directory the persistent compilation cache uses under ``environ``
    (default: the process environment)."""
    environ = os.environ if environ is None else environ
    return Path(environ[CACHE_ENV]) if environ.get(CACHE_ENV) else DEFAULT_CACHE_DIR


def configure() -> Path:
    """Point JAX's persistent compilation cache at :func:`cache_dir`;
    returns that directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path


def card_info() -> list[str]:
    """``name, power limit`` of each NVIDIA card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (a card
    below its top power limit runs slower under load, so every reported
    number carries this)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()
