"""Every float32 contraction on the main path asks for HIGHEST precision.

On a GPU a float32 ``dot_general`` at DEFAULT precision may run in TF32
(about three decimal digits), which would round the solver's per-body
correction sums. This walks the traced step — through ``scan``, ``cond``,
``while`` and nested ``jit`` — and checks every ``dot_general`` it finds.
"""

import jax
import jax.extend
import pytest

import starframe_tpu as sf
from starframe_tpu.parallel import batched_rollout, batched_step
from starframe_tpu.step import rollout, step

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """All ``dot_general`` precision params in a closed jaxpr, recursively."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    found += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    found += _dot_precisions(sub)
    return found


def _is_highest(precision):
    if isinstance(precision, tuple):
        return all(p == HIGHEST for p in precision)
    return precision == HIGHEST


def _scenes():
    return {
        "batched": lambda: sf.scenes.batched_worlds(n_worlds=2, n_bodies=12,
                                                    substeps=2),
        "mechanism": lambda: sf.scenes.mechanism(n_pendulum_links=2,
                                                 substeps=2),
        "rope_bridge": lambda: sf.scenes.rope_bridge(n_particles=8, n_loads=1,
                                                     substeps=2),
        "pile": lambda: sf.scenes.pile(n_bodies=40, substeps=2),
    }


def _entries(name, scene):
    cfg, mp = scene.config, scene.capacity.max_pairs
    if name == "batched":
        return {"batched_step": lambda w: batched_step(w, cfg, mp),
                "batched_rollout": lambda w: batched_rollout(
                    w, cfg, mp, 2, with_keys=True)}
    return {"step": lambda w: step(w, cfg, mp),
            "rollout": lambda w: rollout(w, cfg, mp, 2)}


@pytest.mark.parametrize("name, entry", [
    ("batched", "batched_step"), ("batched", "batched_rollout"),
    ("mechanism", "step"), ("mechanism", "rollout"),
    ("rope_bridge", "step"), ("rope_bridge", "rollout"),
    ("pile", "step"), ("pile", "rollout"),
])
def test_main_path_dots_are_highest(name, entry):
    scene = _scenes()[name]()
    fn = _entries(name, scene)[entry]
    precisions = _dot_precisions(jax.make_jaxpr(fn)(scene.world).jaxpr)
    bad = [p for p in precisions if not _is_highest(p)]
    assert not bad, f"dot_general below HIGHEST precision: {bad}"


def test_walker_finds_nested_default_precision_dots():
    """The check itself: a DEFAULT-precision dot inside scan + cond is
    reported, a HIGHEST one is not."""
    import jax.numpy as jnp

    def f(x, prec):
        def body(c, _):
            c = jax.lax.cond(c.sum() > 0,
                             lambda c: jnp.dot(c, c, precision=prec),
                             lambda c: c, c)
            return c, ()
        return jax.lax.scan(body, x, None, length=2)[0]

    x = jnp.eye(3)
    default = _dot_precisions(jax.make_jaxpr(lambda x: f(x, None))(x).jaxpr)
    assert default and not all(_is_highest(p) for p in default)
    best = _dot_precisions(jax.make_jaxpr(lambda x: f(x, HIGHEST))(x).jaxpr)
    assert best and all(_is_highest(p) for p in best)
