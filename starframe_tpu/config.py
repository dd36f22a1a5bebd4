"""Static configuration: solver parameters and fixed world capacities.

Equivalent of starframe's plain params structs (``PhysicsParams``-style
defaults — SURVEY.md §5.6 [K-med]). Both dataclasses below are frozen and
hashable so they can be closed over / passed as static jit arguments; array
shapes are derived from :class:`Capacity` at world-build time and never
change afterwards (the fixed-capacity design mandated by BASELINE.json:5).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Capacity:
    """Fixed array capacities for one world. All shapes are static under jit.

    Every buffer has an overflow counter in :class:`~starframe_tpu.diagnostics.
    Diagnostics` — silent truncation is the #1 correctness risk of the
    fixed-shape design (SURVEY.md §7.8) and tests assert the counters are 0.
    """

    max_bodies: int = 128
    max_colliders: int = 128
    max_pairs: int = 1024
    max_joints: int = 0
    max_verts: int = 8  # max vertices per convex polygon core

    def __post_init__(self):
        if self.max_verts < 2:
            raise ValueError("max_verts must be >= 2 (capsules need 2)")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """XPBD solver configuration (static under jit).

    Defaults follow the driver-normative bench configs: 60 Hz frames with
    10 XPBD substeps (BASELINE.json:7) per Müller et al. 2020 "small steps".
    """

    dt: float = 1.0 / 60.0
    substeps: int = 10
    # Jacobi position-solve sweeps per substep. 1 matches the small-steps
    # paper's Gauss-Seidel; Jacobi benefits slightly from 2.
    iterations: int = 1
    # Under-relaxation for Jacobi accumulation (applied on top of dividing by
    # the per-body constraint count). 1.0 = plain averaged Jacobi.
    relaxation: float = 1.0
    # Speculative contact margin: manifolds are kept while surface separation
    # < margin so contacts created at frame start stay valid as bodies move
    # during substeps. Constraints only activate at actual penetration.
    contact_margin: float = 0.05
    # Baumgarte-free XPBD compliance for contacts (0 = rigid).
    contact_compliance: float = 0.0
    # Restitution is skipped below this approach speed (prevents jitter).
    restitution_threshold: float = 0.5
    # Global damping applied in the velocity pass, per second.
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    # Max angular correction stability clamp (radians per substep-projection).
    max_dpos: float = 1e3
    # PhysX-style depenetration rate limit (m/s and rad/s): position
    # corrections are clipped to at most this * h per substep, so XPBD's
    # velocity reconstruction (v += dx/h) can never convert a deep spawn
    # overlap into a launch. Deep overlaps resolve over several substeps at
    # this speed instead. 10 m/s never binds in sane scenes (resting-stack
    # corrections reconstruct to < 1 m/s) but stops the 100+ m/s explosions
    # unclamped corrections produce.
    max_depenetration_velocity: float = 10.0
    # Broadphase: 'dense' (O(n^2) masked; best for a few hundred colliders)
    # or 'grid' (sort-and-segment spatial hash; BASELINE.json:5 "sort-and-
    # segment pair generator"). 'auto' picks by collider capacity.
    broadphase: str = "auto"
    # Grid broadphase: number of colliders one cell can hold before overflow.
    # Objects whose AABB extent exceeds one cell go through the dense "large
    # set" path (2-level HGrid equivalent, SURVEY.md §7.3); that threshold is
    # fixed at 1.0 cells — it is a completeness bound of the 9-neighborhood
    # scan, not a tunable (see broadphase.grid_pairs).
    grid_cell_capacity: int = 8
    max_large: int = 64
    # Joint position solve: 'colored' = graph-colored exact Gauss-Seidel
    # batches (colors from the native greedy coloring at build time,
    # BASELINE.json:5); 'jacobi' = one averaged pass with the contacts.
    joint_solver: str = "colored"
    # Static upper bound on color batches per substep (scenes needing more
    # still work: the solver normalizes by per-body count within a batch).
    max_joint_colors: int = 8
    # Velocity at which bodies are considered for sleeping (0 disables).
    sleep_velocity: float = 0.0
    sleep_frames: int = 30
    # Wake-on-fast-contact threshold = sleep_velocity * this factor. At 1.0
    # any not-quite-sleepable neighbor resets a sleeper's counter every
    # frame, so surface jitter in a settled pile cascades wake waves through
    # the whole contact network and half the pile never sleeps (measured:
    # the 10k pile plateaus at 54% asleep). Waking only on contacts
    # decisively faster than the sleep threshold (2x) lets mutually-resting
    # bodies run their counters out; a genuinely struck sleeper still wakes
    # (impacts carry speeds far above 2x the sleep threshold).
    wake_velocity_factor: float = 2.0
    # Manifold regeneration cadence: 'frame' = narrowphase once per frame at
    # frame-start poses with a velocity-expanded speculative margin (the
    # reference's pipeline order, SURVEY.md §3.2: broadphase -> narrowphase ->
    # substeps); 'substep' = regenerate at every substep's integrated pose
    # (TGS-style; more accurate for fast rolling contact, ~10x the manifold
    # math).
    manifold_refresh: str = "frame"
    # Continuous collision detection for bodies flagged ``bullet=True``
    # (state.BODY_BULLET): each substep, a bullet's integrated advance is
    # clamped at its earliest time of impact against the frame's speculative
    # manifolds, so it lands on the surface (plus ``ccd_slop`` of allowed
    # penetration to activate the contact) instead of crossing thin geometry
    # in one substep. Zero cost when off (static gate); requires
    # manifold_refresh='frame' (the clamp trusts frame-start normals —
    # post-tunnel re-narrowphase would pick the far side).
    ccd: bool = False
    # Penetration depth a TOI-clamped bullet is allowed per substep: deep
    # enough that the contact constraint activates and restitution sees the
    # true approach speed, shallow enough that the depenetration rate cap
    # resolves it within a substep.
    ccd_slop: float = 0.005

    @property
    def h(self) -> float:
        """Substep length."""
        return self.dt / self.substeps

    @property
    def max_dpos_eff(self) -> float:
        """Per-substep position-correction clip: the tighter of ``max_dpos``
        and the depenetration rate limit (``max_depenetration_velocity * h``).
        The contact solve clips with this, which bounds reconstructed
        velocity at ``max_depenetration_velocity``."""
        return min(self.max_dpos, self.max_depenetration_velocity * self.h)
