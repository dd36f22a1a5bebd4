"""Batched and sharded worlds: ``vmap`` over a leading world axis, sharded
over a 1-D device mesh.

The reference is a single-process engine; its data-parallel scaling analogue
(SURVEY.md §2.9) is (a) thousands of independent worlds batched with ``vmap``
(BASELINE.json:11 — 4096 × 256-body worlds on one device) and (b) the world
axis sharded over devices with ``shard_map``: worlds are independent, so the
step has no cross-device traffic, and collectives appear only in aggregate
metrics (:func:`global_metrics`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .config import SolverConfig
from .events import touching_keys
from .state import World
from .step import step


def batch_worlds(worlds: Sequence[World]) -> World:
    """Stack identical-capacity worlds along a new leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *worlds)


def replicate_world(world: World, n: int) -> World:
    """Broadcast one world into an ``n``-way batch."""
    return jax.tree.map(lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), world)


def world_slice(batched: World, i: int) -> World:
    return jax.tree.map(lambda x: x[i], batched)


def _vmapped_step(worlds: World, cfg: SolverConfig, max_pairs: int):
    """``step`` over the leading world axis -> (worlds, contacts, diag), each
    with a leading world axis."""
    return jax.vmap(lambda w: step(w, cfg, max_pairs))(worlds)


def _batch_keys(worlds: World, contacts):
    """Per-world canonical touching-pair keys ``[W, P]`` (-1 where the pair
    slot is not touching) — :func:`events.touching_keys` over the batch."""
    m = worlds.colliders.m
    keys, touching = jax.vmap(lambda c: touching_keys(c, m))(contacts)
    return jnp.where(touching, keys, -1)


def _overflow_diag(d) -> dict:
    """Hard truncation counters of a batched frame, reduced over worlds:
    ``pair_overflow`` (candidate pairs dropped past ``max_pairs``) and
    ``cell_overflow`` (grid cells fuller than the scan fan-out). Both must
    be 0 for trustworthy physics (SURVEY.md §4.6)."""
    return dict(pair_overflow=jnp.max(d.pair_overflow),
                cell_overflow=jnp.max(d.cell_overflow))


def batched_step_events(worlds: World, cfg: SolverConfig, max_pairs: int):
    """Batched step that also returns the frame's canonical contact-pair
    keys. Returns ``(new_worlds, keys [W, P], diag)``; diff consecutive
    frames' keys with :func:`starframe_tpu.events.key_event_masks` (the
    device-side analogue of :func:`~starframe_tpu.events.diff_contacts`)."""
    w2, contacts, d = _vmapped_step(worlds, cfg, max_pairs)
    return w2, _batch_keys(worlds, contacts), _overflow_diag(d)


def batched_step(worlds: World, cfg: SolverConfig, max_pairs: int,
                 with_diag: bool = False):
    """Frame step over the leading world axis (un-jitted): ``vmap(step)``.

    With ``with_diag=True`` returns ``(worlds, diag)`` where ``diag`` holds
    the same hard counters :func:`batched_rollout` carries (SURVEY.md §4.6:
    silent truncation is the #1 hazard of the fixed-capacity design, so the
    frame-by-frame API surfaces it too): ``pair_overflow`` and
    ``cell_overflow``, each the max over worlds."""
    w2, _, d = _vmapped_step(worlds, cfg, max_pairs)
    if not with_diag:
        return w2
    return w2, _overflow_diag(d)


def make_batched_step(cfg: SolverConfig, max_pairs: int, donate: bool = True,
                      with_diag: bool = False):
    """Jitted ``worlds -> worlds`` over a leading world axis (or
    ``worlds -> (worlds, diag)`` with ``with_diag=True`` — the overflow
    counters of :func:`batched_step`)."""
    fn = partial(batched_step, cfg=cfg, max_pairs=max_pairs,
                 with_diag=with_diag)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def batched_rollout(worlds: World, cfg: SolverConfig, max_pairs: int,
                    n_frames: int, record=None, with_keys: bool = False):
    """On-device N-frame rollout of a world batch via ``lax.scan`` — the
    RL-workload shape (BASELINE.json:11): one host round trip for the whole
    trajectory. ``record(worlds) -> pytree`` picks what to stack per frame
    (default: poses). With ``with_keys=True`` each trajectory entry becomes
    ``(record(w), keys [W, P] i32)`` — the frame's canonical touching-pair
    keys (see :func:`batched_step_events`).

    Returns ``(final, traj, diag)``; ``diag`` holds the max over frames of
    the hard counters ``pair_overflow`` and ``cell_overflow`` (both must be
    0; silent truncation is the #1 hazard of the fixed-capacity design,
    SURVEY.md §4.6).
    """
    if record is None:
        record = lambda w: (w.bodies.pos, w.bodies.angle)

    def body(carry, _):
        w, povf, covf = carry
        w2, contacts, d = _vmapped_step(w, cfg, max_pairs)
        povf = jnp.maximum(povf, jnp.max(d.pair_overflow))
        covf = jnp.maximum(covf, jnp.max(d.cell_overflow))
        rec = record(w2)
        if with_keys:
            rec = (rec, _batch_keys(w, contacts))
        return (w2, povf, covf), rec

    zero = jnp.int32(0)
    (final, povf, covf), traj = jax.lax.scan(
        body, (worlds, zero, zero), None, length=n_frames)
    return final, traj, dict(pair_overflow=povf, cell_overflow=covf)


def make_batched_rollout(cfg: SolverConfig, max_pairs: int, n_frames: int,
                         record=None):
    return jax.jit(partial(batched_rollout, cfg=cfg, max_pairs=max_pairs,
                           n_frames=n_frames, record=record))


def make_mesh(devices=None, axis: str = "worlds") -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis,))


def world_sharding(mesh: Mesh, world: World, axis: str = "worlds"):
    """NamedSharding pytree: every leaf sharded along its leading world axis."""
    spec = P(axis)
    return jax.tree.map(lambda _: NamedSharding(mesh, spec), world)


def shard_world(batched: World, mesh: Mesh, axis: str = "worlds") -> World:
    return jax.device_put(batched, world_sharding(mesh, batched, axis))


def make_sharded_step(
    cfg: SolverConfig,
    max_pairs: int,
    mesh: Optional[Mesh] = None,
    axis: str = "worlds",
    donate: bool = True,
    with_diag: bool = False,
):
    """Jitted step over a world batch sharded across ``mesh``.

    Worlds are embarrassingly parallel (BASELINE.json:11): ``shard_map``
    runs :func:`batched_step` on each device's local shard, so the step has
    no cross-device communication. Place the input with :func:`shard_world`;
    the output keeps the same sharding. The world count must divide evenly
    over the mesh. With ``with_diag=True`` the step also returns the hard
    counters of :func:`batched_step`, one entry per shard (leading axis =
    mesh size; reduce with ``max`` on the host).
    """
    mesh = make_mesh() if mesh is None else mesh
    spec = P(axis)

    def local_step(worlds: World):
        if not with_diag:
            return batched_step(worlds, cfg, max_pairs)
        w2, diag = batched_step(worlds, cfg, max_pairs, with_diag=True)
        return w2, {k: v[None] for k, v in diag.items()}

    # check_vma=False: the body is purely per-shard (no collectives), and
    # varying-axes inference rejects the step's replicated loop-carry inits
    fn = jax.shard_map(local_step, mesh=mesh, in_specs=spec,
                       out_specs=(spec, spec) if with_diag else spec,
                       check_vma=False)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def global_metrics(worlds: World) -> dict:
    """Cross-shard aggregate diagnostics — the only place a collective
    appears (an all-reduce XLA inserts for the jnp.sum over the sharded
    axis; SURVEY.md §5.8)."""
    b = worlds.bodies
    mass = jnp.where(b.inv_mass > 0, 1.0 / jnp.maximum(b.inv_mass, 1e-12), 0.0)
    ke = 0.5 * jnp.sum(mass * jnp.sum(b.vel**2, axis=-1))
    return {
        "total_kinetic_energy": ke,
        "mean_speed": jnp.mean(jnp.linalg.norm(b.vel, axis=-1)),
        "n_worlds": b.pos.shape[0],
    }
