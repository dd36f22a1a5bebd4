"""Contact manifold storage (fixed capacity, SoA over the pair axis).

The array-program equivalent of starframe's per-pair ``ContactResult`` manifolds
(SURVEY.md §2 rows 6-7): one row per candidate pair, up to two contact points
per manifold (2D feature clipping yields at most 2 — BASELINE.json:5), with
body-local anchors and an A-frame-local normal so the XPBD substep loop can
refresh penetration as poses change without re-running collision detection
(Müller et al. 2020 "small steps" discipline, SURVEY.md §3.2 step 5).
"""

from __future__ import annotations

import dataclasses

import jax


def _dataclass_pytree(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_dataclass_pytree
class Contacts:
    """Per-candidate-pair contact manifolds ``[P]`` with up to 2 points."""

    body_a: jax.Array  # [P] i32
    body_b: jax.Array  # [P] i32
    collider_a: jax.Array  # [P] i32
    collider_b: jax.Array  # [P] i32
    normal_a: jax.Array  # [P, 2] f32 — contact normal (A->B) in body-A frame
    anchor_a: jax.Array  # [P, 2, 2] f32 — surface points in body-A frame
    anchor_b: jax.Array  # [P, 2, 2] f32 — surface points in body-B frame
    point_mask: jax.Array  # [P, 2] bool — which of the 2 points exist
    solve_mask: jax.Array  # [P, 2] bool — point_mask minus sensor pairs
    friction: jax.Array  # [P] f32 combined
    restitution: jax.Array  # [P] f32 combined
    touching: jax.Array  # [P] bool — surface separation < 0 at detection
    separation: jax.Array  # [P, 2] f32 — surface separation at detection

    @property
    def p(self) -> int:
        return self.body_a.shape[-1]
