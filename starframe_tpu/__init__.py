"""starframe-tpu: a fully batched 2D rigid-body physics engine in JAX.

A from-scratch rebuild of the capabilities of ``m0lentum/starframe`` (a Rust
2D game-physics engine) as array programs: the whole simulation step —
broadphase, narrowphase, XPBD substep solve, velocity pass — runs as a single
XLA-compiled program over fixed-capacity SoA arrays, batches thousands of
independent worlds along a leading axis with ``jax.vmap``, and shards that
axis over a device mesh with ``shard_map``.

Reference provenance: the normative capability spec is ``SURVEY.md``
(§1-§7) and ``BASELINE.json`` in this repo. Citations in docstrings point
there.

Quick start::

    import starframe_tpu as sf

    scene = sf.scenes.box_stack()
    world = scene.world
    step = scene.make_step()  # = sf.make_step(scene.config, scene.capacity.max_pairs)
    for _ in range(600):
        world = step(world)
"""

from . import math2d
from .config import SolverConfig, Capacity
from .state import (
    World,
    Bodies,
    Colliders,
    Joints,
    WorldBuilder,
    BodyKey,
    ColliderKey,
    JointKey,
    BODY_ACTIVE,
    BODY_KINEMATIC,
    BODY_DYNAMIC,
    COL_ACTIVE,
    COL_SENSOR,
    JOINT_DISTANCE,
    JOINT_PIN,
    JOINT_WELD,
    JOINT_ANGLE_RANGE,
    JOINT_ANGULAR_MOTOR,
    spawn_body,
    spawn_collider,
    spawn_joint,
    despawn_body,
    despawn_joint,
    set_body_pose,
)
from . import shapes
from .shapes import Shape
from .step import make_step, step, rollout, make_rollout
from .contacts import Contacts
from . import scenes
from . import events
from .events import ContactEvents, diff_contacts
from . import io
from . import queries
from .queries import raycast, query_point, query_aabb, RayHit
from .diagnostics import Diagnostics
from .parallel import (batch_worlds, batched_rollout, batched_step_events,
                       make_batched_rollout, make_batched_step,
                       make_sharded_step)
from . import parallel
from .game import Game, GameState, FixedTimestep
from .ropes import Rope, attach_rope
from . import observer
from .observer import Camera, MeshInstance
from . import mesh
from . import lighting
from .mesh import Mesh, Skeleton, Skin, AnimationClip, Animator, load_gltf

__version__ = "0.1.0"

__all__ = [
    "math2d",
    "SolverConfig",
    "Capacity",
    "World",
    "Bodies",
    "Colliders",
    "Joints",
    "WorldBuilder",
    "BodyKey",
    "ColliderKey",
    "JointKey",
    "Shape",
    "shapes",
    "make_step",
    "step",
    "rollout",
    "make_rollout",
    "Contacts",
    "scenes",
    "events",
    "ContactEvents",
    "diff_contacts",
    "io",
    "queries",
    "raycast",
    "query_point",
    "query_aabb",
    "RayHit",
    "Diagnostics",
    "spawn_body",
    "spawn_collider",
    "spawn_joint",
    "despawn_body",
    "despawn_joint",
    "set_body_pose",
    "batch_worlds",
    "batched_step_events",
    "make_batched_rollout",
    "make_batched_step",
    "make_sharded_step",
    "batched_rollout",
    "parallel",
    "Camera",
    "MeshInstance",
    "Game",
    "GameState",
    "FixedTimestep",
    "Rope",
    "attach_rope",
    "observer",
    "mesh",
    "lighting",
    "Mesh",
    "Skeleton",
    "Skin",
    "AnimationClip",
    "Animator",
    "load_gltf",
]
