"""On-device diagnostics returned from ``step`` (SURVEY.md §5.5).

Replaces starframe's debug rendering / devlog eyeballing with a pytree of
counters computed inside the jitted step and pulled lazily by the host:
pair/contact counts, buffer-overflow counters (the fault detection that
matters for the fixed-capacity design — SURVEY.md §5.3), max penetration,
and kinetic energy.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .contacts import Contacts
from .state import World


def _dataclass_pytree(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_dataclass_pytree
class Diagnostics:
    pair_count: jax.Array  # i32 — candidate pairs found by broadphase
    pair_overflow: jax.Array  # i32 — pairs + large-set rows dropped (MUST be 0; SURVEY.md §4.6)
    cell_overflow: jax.Array  # i32 — grid cells fuller than the scan fan-out
    contact_count: jax.Array  # i32 — manifold points generated
    touching_count: jax.Array  # i32 — pairs actually in contact (sep < 0)
    max_penetration: jax.Array  # f32 — deepest surface overlap at detection
    kinetic_energy: jax.Array  # f32 — sum 1/2 m v² + 1/2 I ω²

    def assert_no_overflow(self):
        """Host-side check; call on concrete (non-traced) diagnostics."""
        import numpy as np

        if int(np.asarray(self.pair_overflow)) != 0:
            raise RuntimeError(
                f"pair buffer overflow: {int(self.pair_overflow)} pairs dropped — "
                "raise Capacity.max_pairs (or SolverConfig.max_large, the "
                "grid broadphase's large-collider set)"
            )
        if int(np.asarray(self.cell_overflow)) != 0:
            raise RuntimeError(
                f"grid cell overflow: {int(self.cell_overflow)} entries past fan-out — "
                "raise SolverConfig.grid_cell_capacity"
            )


def compute_diagnostics(world: World, contacts: Contacts, pairs) -> Diagnostics:
    b = world.bodies
    mass = jnp.where(b.inv_mass > 0, 1.0 / jnp.maximum(b.inv_mass, 1e-12), 0.0)
    inertia = jnp.where(b.inv_inertia > 0, 1.0 / jnp.maximum(b.inv_inertia, 1e-12), 0.0)
    ke = 0.5 * jnp.sum(mass * jnp.sum(b.vel**2, axis=-1)) + 0.5 * jnp.sum(
        inertia * b.ang_vel**2
    )
    pen = jnp.where(contacts.point_mask, -contacts.separation, 0.0)
    return Diagnostics(
        pair_count=pairs.count,
        pair_overflow=pairs.overflow,
        cell_overflow=pairs.cell_overflow,
        contact_count=jnp.sum(contacts.point_mask, dtype=jnp.int32),
        touching_count=jnp.sum(contacts.touching, dtype=jnp.int32),
        max_penetration=jnp.max(pen),
        kinetic_energy=ke,
    )
