"""Scene container shared by all builders."""

from __future__ import annotations

import dataclasses

from ..config import Capacity, SolverConfig
from ..state import World
from ..step import make_step, make_rollout


def tighten_joint_colors(world: World, cfg: SolverConfig) -> SolverConfig:
    """Clamp ``cfg.max_joint_colors`` to the scene's ACTUAL chromatic count
    (known host-side at build time from the greedy coloring). The colored-GS
    solver runs one masked pass per color bound — a rope chain needs 2
    colors, so the default bound of 8 would burn 6 empty sequential passes
    per substep. Joints spawned at runtime that recolor beyond the static
    bound still solve correctly: the last pass sweeps all remaining colors
    count-normalized (solver.py)."""
    import numpy as np

    from ..state import JOINT_OFF

    j = world.joints
    if j.j == 0:
        return cfg
    jtype = np.asarray(j.jtype[..., : j.j])
    colors = np.asarray(j.color[..., : j.j])
    live = jtype != JOINT_OFF
    if not live.any():
        return cfg
    used = int(colors[live].max()) + 1
    return dataclasses.replace(
        cfg, max_joint_colors=min(cfg.max_joint_colors, max(used, 1)))


@dataclasses.dataclass
class Scene:
    name: str
    world: World
    capacity: Capacity
    config: SolverConfig

    @property
    def n_bodies(self) -> int:
        import numpy as np

        return int(np.asarray(self.world.bodies.active.sum()))

    def make_step(self, with_contacts: bool = False, donate: bool = True):
        return make_step(self.config, self.capacity.max_pairs, with_contacts, donate)

    def make_rollout(self, n_frames: int, record=None):
        return make_rollout(self.config, self.capacity.max_pairs, n_frames, record)


def add_ground(builder, half_width: float = 100.0, y: float = 0.0,
               thickness: float = 1.0, friction: float = 0.6):
    """Static ground slab centered at (0, y - thickness/2)."""
    from ..shapes import Shape

    g = builder.add_static(pos=(0.0, y - thickness / 2))
    builder.add_collider(g, Shape.box(half_width, thickness / 2), friction=friction)
    return g
