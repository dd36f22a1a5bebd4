"""World state: fixed-capacity SoA arrays + host-side scene builder.

Array-program replacement for starframe's object storage and body/collider/
constraint model (SURVEY.md §2 rows 2-4, 8; generational arenas + typed keys
in the Rust reference become fixed-capacity arrays + active masks + integer
keys here, per the driver-normative design in BASELINE.json:5).

Design (SURVEY.md §7.2):

- One :class:`World` pytree of arrays; capacities are static; dead slots are
  inert (``inv_mass = 0``, AABB pushed far away). Spawn/despawn happens on
  host between frames via :class:`WorldBuilder` / the despawn helpers.
- Compound shapes: a body may own several colliders; collider offsets are
  baked into the collider's local vertices at build time, so the hot path
  never composes collider offset poses (one fewer transform per pair).
- Rope particles are ordinary bodies with ``inv_inertia = 0`` plus distance
  constraint rows (SURVEY.md §2 row 10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import math2d
from .config import Capacity
from .shapes import Shape

# Body flags
BODY_ACTIVE = 1
BODY_KINEMATIC = 2
BODY_DYNAMIC = 4  # declared dynamic (may transiently be massless at spawn)
BODY_BULLET = 8  # continuous collision: TOI-clamp this body's advance

# Collider flags
COL_ACTIVE = 1
COL_SENSOR = 2

# Joint types (stored in Joints.jtype)
JOINT_OFF = 0
JOINT_DISTANCE = 1  # |pa - pb| constrained into [lo, hi]
JOINT_PIN = 2  # pa == pb (2-dof point attachment / revolute)
JOINT_ANGLE_RANGE = 3  # relative angle constrained into [lo, hi]
JOINT_ANGULAR_MOTOR = 4  # drive relative angular velocity to motor_speed
JOINT_WELD = 5  # pin + relative angle locked to `rest`


def _dataclass_pytree(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_dataclass_pytree
class Bodies:
    """Rigid-body dynamic state, SoA over the body axis ``[N]``.

    Mirrors starframe's ``Body`` (pose + velocity + mass, SURVEY.md §2 row 3);
    static bodies have ``inv_mass == inv_inertia == 0``; kinematic bodies add
    the ``BODY_KINEMATIC`` flag (they integrate velocity but ignore impulses,
    which zero inverse mass already guarantees).
    """

    pos: jax.Array  # [N, 2] f32
    angle: jax.Array  # [N] f32
    vel: jax.Array  # [N, 2] f32
    ang_vel: jax.Array  # [N] f32
    inv_mass: jax.Array  # [N] f32
    inv_inertia: jax.Array  # [N] f32
    flags: jax.Array  # [N] i32
    # Previous frame pose, for render interpolation (fixed-timestep loop with
    # interpolated rendering is a signature starframe design — SURVEY.md §1.5).
    prev_pos: jax.Array  # [N, 2] f32
    prev_angle: jax.Array  # [N] f32
    sleep_count: jax.Array  # [N] i32

    @property
    def active(self):
        return (self.flags & BODY_ACTIVE) != 0

    @property
    def n(self) -> int:
        return self.pos.shape[-2]


@_dataclass_pytree
class Colliders:
    """Collision shapes, SoA over the collider axis ``[M]``.

    Unified shape model (this repo's array-first redesign of starframe's
    circle/capsule/convex-poly taxonomy, SURVEY.md §2 row 4 + §7.4): every
    shape is a *rounded convex polygon* — ``nverts`` core vertices dilated by
    ``radius``. circle = 1 vertex + r, capsule = 2 vertices + r, box/hexagon
    = 4/6 vertices (+ optional rounding). One narrowphase kernel covers all
    pairs with no shape-type dispatch, which is exactly what a vector machine wants.
    """

    body_idx: jax.Array  # [M] i32 (owning body)
    verts: jax.Array  # [M, V, 2] f32 core vertices, CCW, in body frame
    nverts: jax.Array  # [M] i32 (1..V)
    radius: jax.Array  # [M] f32 dilation radius (>= 0)
    friction: jax.Array  # [M] f32
    restitution: jax.Array  # [M] f32
    layer: jax.Array  # [M] i32 collision layer index (0..31)
    mask: jax.Array  # [M] i32 bitmask of layers this collider hits
    flags: jax.Array  # [M] i32

    @property
    def active(self):
        return (self.flags & COL_ACTIVE) != 0

    @property
    def is_sensor(self):
        return (self.flags & COL_SENSOR) != 0

    @property
    def m(self) -> int:
        return self.verts.shape[-3]

    @property
    def max_verts(self) -> int:
        return self.verts.shape[-2]


@_dataclass_pytree
class Joints:
    """User constraints: distance/pin/weld joints, angle limits, motors.

    Mirrors starframe's builder-configured constraints with compliance and
    motors (SURVEY.md §2 row 8, BASELINE.json:10). Rope stretch constraints
    are rows of this same table (``JOINT_DISTANCE`` between particles).
    """

    jtype: jax.Array  # [J] i32
    body_a: jax.Array  # [J] i32
    body_b: jax.Array  # [J] i32
    anchor_a: jax.Array  # [J, 2] f32 (body-local)
    anchor_b: jax.Array  # [J, 2] f32 (body-local)
    rest: jax.Array  # [J] f32 (rest length / rest relative angle)
    lo: jax.Array  # [J] f32 (min length / min relative angle)
    hi: jax.Array  # [J] f32
    compliance: jax.Array  # [J] f32 (XPBD alpha; 0 = rigid)
    damping: jax.Array  # [J] f32 (velocity-pass joint damping per second)
    motor_speed: jax.Array  # [J] f32 (target relative angular velocity)
    motor_max: jax.Array  # [J] f32 (max |impulse| per substep budget scale)
    # Greedy graph-coloring batch index (BASELINE.json:5 "graph-colored
    # constraint batches"): no two same-color joints share a dynamic body,
    # so each color batch solves as exact parallel Gauss-Seidel. Computed at
    # build time by the native helper (starframe_tpu/native).
    color: jax.Array  # [J] i32

    @property
    def active(self):
        return self.jtype != JOINT_OFF

    @property
    def j(self) -> int:
        return self.jtype.shape[-1]


@_dataclass_pytree
class World:
    """The whole simulation state: one pytree, ready for jit/vmap/shard_map.

    The array-program analogue of starframe's ``PhysicsWorld`` + hecs world
    (SURVEY.md §2 rows 2-3). Checkpoint/resume is trivial because this is a
    pytree of arrays (SURVEY.md §5.4) — see :mod:`starframe_tpu.io`.
    """

    bodies: Bodies
    colliders: Colliders
    joints: Joints
    gravity: jax.Array  # [2] f32
    step_count: jax.Array  # i32 scalar


# Typed keys (starframe's BodyKey/ColliderKey arena keys -> plain indices).
class BodyKey(int):
    pass


class ColliderKey(int):
    pass


class JointKey(int):
    pass


_ALL_LAYERS = np.int32(-1)  # all mask bits set


def empty_world(cap: Capacity, gravity=(0.0, -9.81)) -> World:
    """An all-inactive world with the given capacities."""
    nb, nc, nj, nv = cap.max_bodies, cap.max_colliders, cap.max_joints, cap.max_verts
    f32 = jnp.float32
    i32 = jnp.int32
    bodies = Bodies(
        pos=jnp.zeros((nb, 2), f32),
        angle=jnp.zeros((nb,), f32),
        vel=jnp.zeros((nb, 2), f32),
        ang_vel=jnp.zeros((nb,), f32),
        inv_mass=jnp.zeros((nb,), f32),
        inv_inertia=jnp.zeros((nb,), f32),
        flags=jnp.zeros((nb,), i32),
        prev_pos=jnp.zeros((nb, 2), f32),
        prev_angle=jnp.zeros((nb,), f32),
        sleep_count=jnp.zeros((nb,), i32),
    )
    colliders = Colliders(
        body_idx=jnp.zeros((nc,), i32),
        verts=jnp.zeros((nc, nv, 2), f32),
        nverts=jnp.ones((nc,), i32),
        radius=jnp.zeros((nc,), f32),
        friction=jnp.full((nc,), 0.5, f32),
        restitution=jnp.zeros((nc,), f32),
        layer=jnp.zeros((nc,), i32),
        mask=jnp.full((nc,), _ALL_LAYERS, i32),
        flags=jnp.zeros((nc,), i32),
    )
    # zero-capacity joint tables are truly empty ([0]-shaped): every joint
    # pass then compiles to a no-op graph, so contact-only worlds pay nothing
    joints = Joints(
        jtype=jnp.zeros((nj,), i32),
        body_a=jnp.zeros((nj,), i32),
        body_b=jnp.zeros((nj,), i32),
        anchor_a=jnp.zeros((nj, 2), f32),
        anchor_b=jnp.zeros((nj, 2), f32),
        rest=jnp.zeros((nj,), f32),
        lo=jnp.zeros((nj,), f32),
        hi=jnp.zeros((nj,), f32),
        compliance=jnp.zeros((nj,), f32),
        damping=jnp.zeros((nj,), f32),
        motor_speed=jnp.zeros((nj,), f32),
        motor_max=jnp.full((nj,), jnp.inf, f32),
        color=jnp.zeros((nj,), i32),
    )
    return World(
        bodies=bodies,
        colliders=colliders,
        joints=joints,
        gravity=jnp.asarray(gravity, f32),
        step_count=jnp.zeros((), i32),
    )


class WorldBuilder:
    """Host-side scene construction (numpy), producing a device :class:`World`.

    Plays the role of starframe's spawn APIs (``PhysicsWorld::insert_body``,
    collider/constraint builders — SURVEY.md §2 rows 2-4, 8 [K-med]): bodies,
    colliders (with optional offset pose, baked into local verts), joints,
    ropes. Mass/inertia are computed from attached collider shapes unless
    overridden, as in the reference's mass-from-collider flow [K-med].
    """

    def __init__(self, gravity=(0.0, -9.81)):
        self.gravity = tuple(gravity)
        self._bodies: list[dict] = []
        self._colliders: list[dict] = []
        self._joints: list[dict] = []

    # -- bodies -----------------------------------------------------------

    def add_body(
        self,
        pos=(0.0, 0.0),
        angle: float = 0.0,
        vel=(0.0, 0.0),
        ang_vel: float = 0.0,
        body_type: str = "dynamic",
        mass: Optional[float] = None,
        inertia: Optional[float] = None,
        bullet: bool = False,
    ) -> BodyKey:
        """``bullet=True`` marks the body for continuous collision
        detection: with ``SolverConfig.ccd`` enabled, its per-substep
        advance is clamped at the time of impact against every broadphase
        partner, so it cannot tunnel through thin geometry at any speed
        (starframe/Box2D bullet semantics)."""
        if body_type not in ("dynamic", "static", "kinematic"):
            raise ValueError(f"unknown body_type {body_type!r}")
        self._bodies.append(
            dict(
                pos=np.asarray(pos, np.float32),
                angle=float(angle),
                vel=np.asarray(vel, np.float32),
                ang_vel=float(ang_vel),
                body_type=body_type,
                mass=mass,
                inertia=inertia,
                bullet=bool(bullet),
            )
        )
        return BodyKey(len(self._bodies) - 1)

    def add_static(self, pos=(0.0, 0.0), angle: float = 0.0) -> BodyKey:
        return self.add_body(pos=pos, angle=angle, body_type="static")

    def add_particle(self, pos, mass: float, vel=(0.0, 0.0)) -> BodyKey:
        """Point-mass body (no rotational dof): used for rope particles."""
        return self.add_body(pos=pos, vel=vel, mass=mass, inertia=np.inf)

    # -- colliders ---------------------------------------------------------

    def add_collider(
        self,
        body: int,
        shape: Shape,
        friction: float = 0.5,
        restitution: float = 0.0,
        density: float = 1.0,
        layer: int = 0,
        mask: int = -1,
        sensor: bool = False,
        offset=(0.0, 0.0),
        offset_angle: float = 0.0,
    ) -> ColliderKey:
        """Attach a collider to ``body``. ``offset``/``offset_angle`` place the
        shape relative to the body origin (compound shapes, BASELINE.json:10);
        the offset is baked into the stored vertices."""
        off = np.asarray(offset, np.float32)
        c, s = np.cos(offset_angle), np.sin(offset_angle)
        rot = np.array([[c, -s], [s, c]], np.float32)
        verts = shape.verts @ rot.T + off
        self._colliders.append(
            dict(
                body=int(body),
                verts=verts.astype(np.float32),
                radius=float(shape.radius),
                friction=float(friction),
                restitution=float(restitution),
                density=float(density),
                layer=int(layer),
                mask=int(mask),
                sensor=bool(sensor),
            )
        )
        return ColliderKey(len(self._colliders) - 1)

    # -- joints -------------------------------------------------------------

    def _add_joint(self, **kw) -> JointKey:
        row = dict(
            jtype=JOINT_OFF,
            body_a=0,
            body_b=0,
            anchor_a=(0.0, 0.0),
            anchor_b=(0.0, 0.0),
            rest=0.0,
            lo=0.0,
            hi=0.0,
            compliance=0.0,
            damping=0.0,
            motor_speed=0.0,
            motor_max=np.inf,
        )
        row.update(kw)
        if row["anchor_a"] is None or row["anchor_b"] is None:
            # a None anchor would np-convert to NaN and silently poison the
            # whole solve — fail loudly at build time instead
            raise ValueError(
                "joint anchors must not be None — pass world_point or "
                "explicit anchor_a/anchor_b")
        self._joints.append(row)
        return JointKey(len(self._joints) - 1)

    def distance_joint(
        self,
        body_a: int,
        body_b: int,
        anchor_a=(0.0, 0.0),
        anchor_b=(0.0, 0.0),
        rest: Optional[float] = None,
        limits: Optional[tuple] = None,
        compliance: float = 0.0,
        damping: float = 0.0,
    ) -> JointKey:
        """Distance constraint between body-local anchor points. With
        ``limits=(lo, hi)`` the length is only constrained into that range
        (starframe's min/max distance limit modes, SURVEY.md §2 row 8)."""
        if rest is None:
            pa = self._world_anchor(body_a, anchor_a)
            pb = self._world_anchor(body_b, anchor_b)
            rest = float(np.linalg.norm(pa - pb))
        lo, hi = limits if limits is not None else (rest, rest)
        return self._add_joint(
            jtype=JOINT_DISTANCE,
            body_a=body_a,
            body_b=body_b,
            anchor_a=anchor_a,
            anchor_b=anchor_b,
            rest=rest,
            lo=lo,
            hi=hi,
            compliance=compliance,
            damping=damping,
        )

    def pin_joint(
        self,
        body_a: int,
        body_b: int,
        world_point=None,
        anchor_a=None,
        anchor_b=None,
        compliance: float = 0.0,
        damping: float = 0.0,
    ) -> JointKey:
        """Point attachment (revolute joint): the two body-local anchors are
        constrained to coincide; rotation stays free. Give either a world
        point (anchors derived from current poses) or explicit anchors;
        with neither, the midpoint between the two bodies is used."""
        if world_point is None and anchor_a is None and anchor_b is None:
            world_point = 0.5 * (np.asarray(self._bodies[body_a]["pos"])
                                 + np.asarray(self._bodies[body_b]["pos"]))
        if world_point is not None:
            anchor_a = self._local_anchor(body_a, world_point)
            anchor_b = self._local_anchor(body_b, world_point)
        return self._add_joint(
            jtype=JOINT_PIN,
            body_a=body_a,
            body_b=body_b,
            anchor_a=anchor_a,
            anchor_b=anchor_b,
            compliance=compliance,
            damping=damping,
        )

    def weld_joint(self, body_a, body_b, world_point=None, anchor_a=None,
                   anchor_b=None, compliance: float = 0.0) -> JointKey:
        """Pin + relative angle locked at its build-time value. Give either
        a world point or explicit anchors; with neither, the midpoint
        between the two bodies is used."""
        if world_point is None and anchor_a is None and anchor_b is None:
            world_point = 0.5 * (np.asarray(self._bodies[body_a]["pos"])
                                 + np.asarray(self._bodies[body_b]["pos"]))
        if world_point is not None:
            anchor_a = self._local_anchor(body_a, world_point)
            anchor_b = self._local_anchor(body_b, world_point)
        rel = self._bodies[body_b]["angle"] - self._bodies[body_a]["angle"]
        return self._add_joint(
            jtype=JOINT_WELD,
            body_a=body_a,
            body_b=body_b,
            anchor_a=anchor_a,
            anchor_b=anchor_b,
            rest=rel,
            compliance=compliance,
        )

    def angle_limit(self, body_a, body_b, lo, hi, compliance: float = 0.0) -> JointKey:
        """Constrain relative angle (angle_b - angle_a) into [lo, hi]."""
        return self._add_joint(
            jtype=JOINT_ANGLE_RANGE, body_a=body_a, body_b=body_b,
            lo=lo, hi=hi, compliance=compliance,
        )

    def angular_motor(self, body_a, body_b, speed, max_torque=np.inf) -> JointKey:
        """Drive relative angular velocity (ω_b - ω_a) toward ``speed`` with a
        torque budget (starframe's joint motors — BASELINE.json:10)."""
        return self._add_joint(
            jtype=JOINT_ANGULAR_MOTOR, body_a=body_a, body_b=body_b,
            motor_speed=speed, motor_max=max_torque,
        )

    # -- helpers -------------------------------------------------------------

    def _world_anchor(self, body: int, local) -> np.ndarray:
        b = self._bodies[body]
        c, s = np.cos(b["angle"]), np.sin(b["angle"])
        la = np.asarray(local, np.float32)
        return b["pos"] + np.array([c * la[0] - s * la[1], s * la[0] + c * la[1]])

    def _local_anchor(self, body: int, world) -> np.ndarray:
        b = self._bodies[body]
        c, s = np.cos(-b["angle"]), np.sin(-b["angle"])
        d = np.asarray(world, np.float32) - b["pos"]
        return np.array([c * d[0] - s * d[1], s * d[0] + c * d[1]], np.float32)

    # -- build ---------------------------------------------------------------

    def _collider_extents(self, margin: float = 0.05):
        """Host-side per-collider AABB extents at build poses (numpy)."""
        exts = []
        centers = []
        for c in self._colliders:
            b = self._bodies[c["body"]]
            co, si = np.cos(b["angle"]), np.sin(b["angle"])
            rot = np.array([[co, -si], [si, co]], np.float32)
            wv = c["verts"] @ rot.T + b["pos"]
            lo = wv.min(0) - c["radius"] - margin
            hi = wv.max(0) + c["radius"] + margin
            exts.append(hi - lo)
            centers.append((lo + hi) / 2)
        return np.asarray(exts, np.float32), np.asarray(centers, np.float32)

    def _auto_capacity(self, cap: Optional[Capacity],
                       reserve=(0, 0, 0)) -> Capacity:
        nb = len(self._bodies) + reserve[0]
        nc = len(self._colliders) + reserve[1]
        nj = len(self._joints) + reserve[2]
        nv = max([2] + [len(c["verts"]) for c in self._colliders])
        if cap is not None:
            if (cap.max_bodies < nb or cap.max_colliders < nc
                    or cap.max_joints < nj or cap.max_verts < nv):
                raise ValueError("capacity too small for scene")
            return cap
        # Pair capacity from scene stats (SURVEY.md §7.8.1 "capacity
        # auto-sizing"): a settled 2D packing of convex bodies touches <=~8
        # similar-size neighbors, i.e. <=4 pairs/collider counting each pair
        # once; the speculative margin + impact transients push candidates
        # higher, so budget 4/collider with the runtime overflow counters
        # (diagnostics) as the backstop — a 10k pile measured 1.85 live
        # pairs/collider settled under this margin (r2 profile).
        max_pairs = -(-max(4 * nc, 64) // 512) * 512
        return Capacity(
            max_bodies=max(nb, 1),
            max_colliders=max(nc, 1),
            max_pairs=max_pairs,
            max_joints=nj,
            max_verts=nv,
        )

    def suggest_grid_cell_capacity(self, margin: float = 0.05) -> int:
        """Grid-broadphase per-cell fan-out from the scene's size
        distribution: how many of the smallest colliders can crowd one
        broadphase cell when packed (SURVEY.md §7.8.1). Scenes pass this to
        ``SolverConfig(grid_cell_capacity=...)`` instead of hand-tuning."""
        if not self._colliders:
            return 8
        exts, _ = self._collider_extents(margin)
        max_ext = exts.max(-1)
        cell = 1.5 * float(np.mean(max_ext))
        small = float(np.percentile(max_ext, 10))
        # worst case: the smallest colliders tile a (cell + ext)^2 window
        # whose centers hash to one cell; 1.2x safety over the packing bound
        packed = (cell / max(small, 1e-3) + 1.0) ** 2
        return int(max(8, np.ceil(1.2 * packed)))

    def build(self, capacity: Optional[Capacity] = None, reserve_bodies: int = 0,
              reserve_colliders: int = 0, reserve_joints: int = 0,
              ) -> tuple[World, Capacity]:
        """Materialize the scene. ``reserve_*`` pre-allocate spare inactive
        rows for runtime :func:`spawn_body`/:func:`spawn_collider`/
        :func:`spawn_joint` (capacities are compile-time static, so spare
        rows are how a game spawns mid-run without recompiling)."""
        cap = self._auto_capacity(
            capacity, (reserve_bodies, reserve_colliders, reserve_joints))
        world = empty_world(cap, self.gravity)

        nb, nc, nj = len(self._bodies), len(self._colliders), len(self._joints)
        nv = cap.max_verts

        # mass properties from colliders (density-weighted), unless overridden
        mass = np.zeros(nb, np.float64)
        inertia = np.zeros(nb, np.float64)
        for c in self._colliders:
            if c["sensor"]:
                continue
            sh = Shape(verts=c["verts"], radius=c["radius"])
            m, i_origin = sh.mass_properties(c["density"])
            mass[c["body"]] += m
            inertia[c["body"]] += i_origin

        b_pos = np.zeros((cap.max_bodies, 2), np.float32)
        b_angle = np.zeros(cap.max_bodies, np.float32)
        b_vel = np.zeros((cap.max_bodies, 2), np.float32)
        b_angvel = np.zeros(cap.max_bodies, np.float32)
        b_invm = np.zeros(cap.max_bodies, np.float32)
        b_invi = np.zeros(cap.max_bodies, np.float32)
        b_flags = np.zeros(cap.max_bodies, np.int32)
        for i, b in enumerate(self._bodies):
            b_pos[i] = b["pos"]
            b_angle[i] = b["angle"]
            b_vel[i] = b["vel"]
            b_angvel[i] = b["ang_vel"]
            b_flags[i] = BODY_ACTIVE | (BODY_KINEMATIC if b["body_type"] == "kinematic" else 0) \
                | (BODY_DYNAMIC if b["body_type"] == "dynamic" else 0) \
                | (BODY_BULLET if b.get("bullet") else 0)
            if b["body_type"] == "dynamic":
                m = b["mass"] if b["mass"] is not None else mass[i]
                inr = b["inertia"] if b["inertia"] is not None else inertia[i]
                if m <= 0:
                    raise ValueError(f"dynamic body {i} has no mass (attach a collider or pass mass=)")
                b_invm[i] = 1.0 / m
                b_invi[i] = 0.0 if np.isinf(inr) else (1.0 / inr if inr > 0 else 0.0)

        c_body = np.zeros(cap.max_colliders, np.int32)
        c_verts = np.zeros((cap.max_colliders, nv, 2), np.float32)
        c_nverts = np.ones(cap.max_colliders, np.int32)
        c_radius = np.zeros(cap.max_colliders, np.float32)
        c_fric = np.full(cap.max_colliders, 0.5, np.float32)
        c_rest = np.zeros(cap.max_colliders, np.float32)
        c_layer = np.zeros(cap.max_colliders, np.int32)
        c_mask = np.full(cap.max_colliders, -1, np.int32)
        c_flags = np.zeros(cap.max_colliders, np.int32)
        for i, c in enumerate(self._colliders):
            v = c["verts"]
            c_body[i] = c["body"]
            c_verts[i, : len(v)] = v
            # pad unused vertex slots with the first vertex so max/min scans
            # over the full buffer stay exact without masking
            c_verts[i, len(v):] = v[0]
            c_nverts[i] = len(v)
            c_radius[i] = c["radius"]
            c_fric[i] = c["friction"]
            c_rest[i] = c["restitution"]
            c_layer[i] = c["layer"]
            c_mask[i] = c["mask"]
            c_flags[i] = COL_ACTIVE | (COL_SENSOR if c["sensor"] else 0)

        jn = cap.max_joints
        j_arr = {
            "jtype": np.zeros(jn, np.int32),
            "body_a": np.zeros(jn, np.int32),
            "body_b": np.zeros(jn, np.int32),
            "anchor_a": np.zeros((jn, 2), np.float32),
            "anchor_b": np.zeros((jn, 2), np.float32),
            "rest": np.zeros(jn, np.float32),
            "lo": np.zeros(jn, np.float32),
            "hi": np.zeros(jn, np.float32),
            "compliance": np.zeros(jn, np.float32),
            "damping": np.zeros(jn, np.float32),
            "motor_speed": np.zeros(jn, np.float32),
            "motor_max": np.full(jn, np.inf, np.float32),
        }
        for i, jrow in enumerate(self._joints):
            for k in j_arr:
                j_arr[k][i] = jrow[k]

        # graph-color the joint topology (static bodies never conflict)
        j_color = np.zeros(jn, np.int32)
        if nj > 0:
            from . import native

            body_static = (b_invm == 0.0) & (b_invi == 0.0) & ((b_flags & BODY_KINEMATIC) == 0)
            j_color[:nj], _ = native.greedy_color(
                j_arr["body_a"][:nj], j_arr["body_b"][:nj],
                active=(j_arr["jtype"][:nj] != JOINT_OFF),
                body_is_static=body_static, n_bodies=cap.max_bodies,
            )
        j_arr["color"] = j_color

        world = World(
            bodies=Bodies(
                pos=jnp.asarray(b_pos),
                angle=jnp.asarray(b_angle),
                vel=jnp.asarray(b_vel),
                ang_vel=jnp.asarray(b_angvel),
                inv_mass=jnp.asarray(b_invm),
                inv_inertia=jnp.asarray(b_invi),
                flags=jnp.asarray(b_flags),
                prev_pos=jnp.asarray(b_pos),
                prev_angle=jnp.asarray(b_angle),
                sleep_count=jnp.zeros(cap.max_bodies, jnp.int32),
            ),
            colliders=Colliders(
                body_idx=jnp.asarray(c_body),
                verts=jnp.asarray(c_verts),
                nverts=jnp.asarray(c_nverts),
                radius=jnp.asarray(c_radius),
                friction=jnp.asarray(c_fric),
                restitution=jnp.asarray(c_rest),
                layer=jnp.asarray(c_layer),
                mask=jnp.asarray(c_mask),
                flags=jnp.asarray(c_flags),
            ),
            joints=Joints(**{k: jnp.asarray(v) for k, v in j_arr.items()}),
            gravity=jnp.asarray(self.gravity, jnp.float32),
            step_count=jnp.zeros((), jnp.int32),
        )
        return world, cap


# -- runtime spawn/despawn (between frames; SURVEY.md §7.2) -----------------
#
# Starframe's spawn APIs work mid-game (SURVEY.md §2 row 2). The array-program
# equivalent: capacities are compile-time static, so WorldBuilder.build()
# pre-allocates spare inactive rows (``reserve_*``) and these helpers
# activate/deactivate rows by VALUE only — array shapes never change, so the
# jitted step is NOT recompiled (asserted by tests/test_spawn.py via the jit
# cache size).


def _free_body_slot(world: World) -> int:
    flags = np.asarray(jax.device_get(world.bodies.flags))
    free = np.nonzero((flags & BODY_ACTIVE) == 0)[0]
    if len(free) == 0:
        raise ValueError("no free body slots (build with reserve_bodies=...)")
    return int(free[0])


def _free_collider_slot(world: World) -> int:
    flags = np.asarray(jax.device_get(world.colliders.flags))
    free = np.nonzero((flags & COL_ACTIVE) == 0)[0]
    if len(free) == 0:
        raise ValueError("no free collider slots (build with reserve_colliders=...)")
    return int(free[0])


def _free_joint_slot(world: World) -> int:
    jt = np.asarray(jax.device_get(world.joints.jtype))
    free = np.nonzero(jt == JOINT_OFF)[0]
    if len(free) == 0:
        raise ValueError("no free joint slots (build with reserve_joints=...)")
    return int(free[0])


def spawn_body(
    world: World,
    pos=(0.0, 0.0),
    angle: float = 0.0,
    vel=(0.0, 0.0),
    ang_vel: float = 0.0,
    body_type: str = "dynamic",
    mass: Optional[float] = None,
    inertia: Optional[float] = None,
    bullet: bool = False,
) -> tuple[World, BodyKey]:
    """Activate a new body in a free slot at runtime (host-side, O(capacity),
    no recompile). Dynamic bodies start massless until a collider is spawned
    on them (or pass ``mass``/``inertia`` explicitly)."""
    if body_type not in ("dynamic", "static", "kinematic"):
        raise ValueError(f"unknown body_type {body_type!r}")
    i = _free_body_slot(world)
    b = world.bodies
    f32 = jnp.float32
    inv_m = inv_i = 0.0
    if body_type == "dynamic":
        if mass is not None and mass > 0:
            inv_m = 1.0 / mass
        if inertia is not None and inertia > 0 and not np.isinf(inertia):
            inv_i = 1.0 / inertia
    flags = BODY_ACTIVE | (BODY_KINEMATIC if body_type == "kinematic" else 0) \
        | (BODY_DYNAMIC if body_type == "dynamic" else 0) \
        | (BODY_BULLET if bullet else 0)
    pos = jnp.asarray(pos, f32)
    bodies = dataclasses.replace(
        b,
        pos=b.pos.at[i].set(pos),
        angle=b.angle.at[i].set(angle),
        vel=b.vel.at[i].set(jnp.asarray(vel, f32)),
        ang_vel=b.ang_vel.at[i].set(ang_vel),
        inv_mass=b.inv_mass.at[i].set(inv_m),
        inv_inertia=b.inv_inertia.at[i].set(inv_i),
        flags=b.flags.at[i].set(flags),
        prev_pos=b.prev_pos.at[i].set(pos),
        prev_angle=b.prev_angle.at[i].set(angle),
        sleep_count=b.sleep_count.at[i].set(0),
    )
    return dataclasses.replace(world, bodies=bodies), BodyKey(i)


def spawn_collider(
    world: World,
    body: int,
    shape: Shape,
    friction: float = 0.5,
    restitution: float = 0.0,
    density: float = 1.0,
    layer: int = 0,
    mask: int = -1,
    sensor: bool = False,
    offset=(0.0, 0.0),
    offset_angle: float = 0.0,
    update_mass: bool = True,
) -> tuple[World, ColliderKey]:
    """Attach a collider to ``body`` at runtime. With ``update_mass`` (and a
    dynamic, non-sensor combination) the body's mass/inertia accumulate the
    shape's density-weighted properties, as in the builder flow."""
    k = _free_collider_slot(world)
    off = np.asarray(offset, np.float32)
    c_, s_ = np.cos(offset_angle), np.sin(offset_angle)
    rot = np.array([[c_, -s_], [s_, c_]], np.float32)
    verts = (shape.verts @ rot.T + off).astype(np.float32)
    nv = len(verts)
    cap_v = world.colliders.max_verts
    if nv > cap_v:
        raise ValueError(f"shape has {nv} verts, capacity is {cap_v}")
    padded = np.tile(verts[0], (cap_v, 1))
    padded[:nv] = verts

    c = world.colliders
    colliders = dataclasses.replace(
        c,
        body_idx=c.body_idx.at[k].set(body),
        verts=c.verts.at[k].set(jnp.asarray(padded)),
        nverts=c.nverts.at[k].set(nv),
        radius=c.radius.at[k].set(float(shape.radius)),
        friction=c.friction.at[k].set(friction),
        restitution=c.restitution.at[k].set(restitution),
        layer=c.layer.at[k].set(layer),
        mask=c.mask.at[k].set(mask),
        flags=c.flags.at[k].set(COL_ACTIVE | (COL_SENSOR if sensor else 0)),
    )
    world = dataclasses.replace(world, colliders=colliders)

    b = world.bodies
    is_dyn = bool(int(np.asarray(jax.device_get(b.flags[body]))) & BODY_DYNAMIC)
    if update_mass and not sensor and is_dyn:
        sh = Shape(verts=verts, radius=float(shape.radius))
        m_add, i_add = sh.mass_properties(density)
        inv_m = float(np.asarray(jax.device_get(b.inv_mass[body])))
        inv_i = float(np.asarray(jax.device_get(b.inv_inertia[body])))
        m_new = ((1.0 / inv_m) if inv_m > 0 else 0.0) + m_add
        i_new = ((1.0 / inv_i) if inv_i > 0 else 0.0) + i_add
        bodies = dataclasses.replace(
            b,
            inv_mass=b.inv_mass.at[body].set(1.0 / m_new if m_new > 0 else 0.0),
            inv_inertia=b.inv_inertia.at[body].set(
                1.0 / i_new if i_new > 0 else 0.0),
        )
        world = dataclasses.replace(world, bodies=bodies)
    return world, ColliderKey(k)


def spawn_joint(world: World, jtype: int, body_a: int, body_b: int,
                anchor_a=(0.0, 0.0), anchor_b=(0.0, 0.0), rest: float = 0.0,
                lo: float = 0.0, hi: float = 0.0, compliance: float = 0.0,
                damping: float = 0.0, motor_speed: float = 0.0,
                motor_max: float = np.inf) -> tuple[World, JointKey]:
    """Activate a joint row at runtime and recolor the joint graph (host-side
    greedy coloring, same as the build-time flow)."""
    i = _free_joint_slot(world)
    j = world.joints
    f32 = jnp.float32
    joints = dataclasses.replace(
        j,
        jtype=j.jtype.at[i].set(jtype),
        body_a=j.body_a.at[i].set(body_a),
        body_b=j.body_b.at[i].set(body_b),
        anchor_a=j.anchor_a.at[i].set(jnp.asarray(anchor_a, f32)),
        anchor_b=j.anchor_b.at[i].set(jnp.asarray(anchor_b, f32)),
        rest=j.rest.at[i].set(rest),
        lo=j.lo.at[i].set(lo),
        hi=j.hi.at[i].set(hi),
        compliance=j.compliance.at[i].set(compliance),
        damping=j.damping.at[i].set(damping),
        motor_speed=j.motor_speed.at[i].set(motor_speed),
        motor_max=j.motor_max.at[i].set(motor_max),
    )
    world = dataclasses.replace(world, joints=joints)
    return _recolor_joints(world), JointKey(i)


def despawn_joint(world: World, joint: int) -> World:
    j = world.joints
    joints = dataclasses.replace(j, jtype=j.jtype.at[joint].set(JOINT_OFF))
    return dataclasses.replace(world, joints=joints)


def _recolor_joints(world: World) -> World:
    from . import native

    j = world.joints
    jt = np.asarray(jax.device_get(j.jtype))
    if (jt != JOINT_OFF).sum() == 0:
        return world
    b = world.bodies
    inv_m = np.asarray(jax.device_get(b.inv_mass))
    inv_i = np.asarray(jax.device_get(b.inv_inertia))
    flags = np.asarray(jax.device_get(b.flags))
    body_static = (inv_m == 0.0) & (inv_i == 0.0) & ((flags & BODY_KINEMATIC) == 0)
    color, _ = native.greedy_color(
        np.asarray(jax.device_get(j.body_a)),
        np.asarray(jax.device_get(j.body_b)),
        active=(jt != JOINT_OFF),
        body_is_static=body_static,
        n_bodies=b.n,
    )
    joints = dataclasses.replace(j, color=jnp.asarray(color, jnp.int32))
    return dataclasses.replace(world, joints=joints)


def set_body_pose(world: World, body: int, pos=None, angle=None,
                  vel=None, ang_vel=None) -> World:
    """Host-side pose/velocity override (kinematic drivers, cursor bodies).
    Also wakes the body (resets its sleep counter)."""
    b = world.bodies
    f32 = jnp.float32
    kw = {"sleep_count": b.sleep_count.at[body].set(0)}
    if pos is not None:
        kw["pos"] = b.pos.at[body].set(jnp.asarray(pos, f32))
    if angle is not None:
        kw["angle"] = b.angle.at[body].set(angle)
    if vel is not None:
        kw["vel"] = b.vel.at[body].set(jnp.asarray(vel, f32))
    if ang_vel is not None:
        kw["ang_vel"] = b.ang_vel.at[body].set(ang_vel)
    return dataclasses.replace(world, bodies=dataclasses.replace(b, **kw))


def wake_body(world: World, body: int) -> World:
    """Reset a body's sleep counter (host-side)."""
    b = world.bodies
    return dataclasses.replace(
        world,
        bodies=dataclasses.replace(b, sleep_count=b.sleep_count.at[body].set(0)),
    )


def expand_capacity(world: World, extra_bodies: int = 0, extra_colliders: int = 0,
                    extra_joints: int = 0) -> World:
    """Grow a world's fixed capacities by appending inactive rows (host-side;
    the jitted step recompiles ONCE for the new shapes, after which runtime
    spawns into the spare rows are recompile-free)."""
    cap = Capacity(
        max_bodies=world.bodies.n + extra_bodies,
        max_colliders=world.colliders.m + extra_colliders,
        max_pairs=1,
        max_joints=world.joints.j + extra_joints,
        max_verts=world.colliders.max_verts,
    )
    blank = empty_world(cap)

    def pad(old, new):
        if old.shape == new.shape:
            return old
        n_extra = new.shape[0] - old.shape[0]
        return jnp.concatenate([old, new[new.shape[0] - n_extra:]], axis=0)

    bodies = jax.tree.map(pad, world.bodies, blank.bodies)
    colliders = jax.tree.map(pad, world.colliders, blank.colliders)
    joints = jax.tree.map(pad, world.joints, blank.joints)
    return dataclasses.replace(world, bodies=bodies, colliders=colliders,
                               joints=joints)


# -- host-side despawn/mutation helpers (between frames; SURVEY.md §7.2) ----


def despawn_body(world: World, body: int) -> World:
    """Deactivate a body and all colliders attached to it. O(capacity)."""
    b = world.bodies
    flags = b.flags.at[body].set(b.flags[body] & ~BODY_ACTIVE)
    inv_mass = b.inv_mass.at[body].set(0.0)
    inv_inertia = b.inv_inertia.at[body].set(0.0)
    c = world.colliders
    owned = c.body_idx == body
    cflags = jnp.where(owned, c.flags & ~COL_ACTIVE, c.flags)
    return dataclasses.replace(
        world,
        bodies=dataclasses.replace(b, flags=flags, inv_mass=inv_mass, inv_inertia=inv_inertia),
        colliders=dataclasses.replace(c, flags=cflags),
    )


def world_pose(world: World):
    """Convenience: (pos, angle) arrays of all bodies."""
    return world.bodies.pos, world.bodies.angle
