#!/usr/bin/env python
"""Bring-up smoke test: the engine's main path on an NVIDIA GPU.

Runs each phase through the public entry points, at the sizes
``BASELINE.json`` defines, and checks what comes out against a plain
reference: the same ``step`` on the CPU backend of this process, bitwise
replay, analytic probes and the hard overflow counters.

    python chip_smoke.py             # one GPU: phases 1-5
    python chip_smoke.py --chips 4   # four GPUs: the sharded world axis only

Phases:

1. device — the default JAX device must be a GPU; there is no CPU fallback.
2. flagship — 4096 worlds x 256 bodies x 10 substeps through
   ``batched_rollout`` and ``make_batched_step``; four worlds re-stepped
   alone with ``step`` on the CPU.
3. pile — the 10k-body pile through ``rollout`` and ``make_step``.
4. determinism — the flagship and pile rollouts twice from one state,
   bitwise equal.
5. scenes — ``box_stack``, ``rope_bridge``, ``mechanism`` through
   ``make_step``, plus the ball-drop and resting-circle probes.
6. sharded (``--chips 4``) — ``make_sharded_step`` over four GPUs against
   the same worlds stepped on one.

Timings are bring-up readings, not benchmarks (``bench.py`` measures). Every
phase prints its readings on its own line; the last line of standard output
is ``{"ok": true, "device": {...}}`` and appears only if every phase passed.
Each phase function takes its sizes, so the tests run them at tiny sizes on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Contact physics is chaotic: the CPU and GPU backends round differently
# (fused multiply-adds, transcendental implementations), and each contact
# solve amplifies those ulp-level differences, so only 3 frames (30
# substeps) are compared. Two bounds:
# - REF_ATOL: bodies agree to 1e-3 m / 1e-3 rad — under 0.3% of a body's
#   half-extent — while a wrong solve moves most bodies by centimetres;
# - a contact whose separation is within rounding of zero can be active on
#   one backend and not the other. Such a flip moves its bodies by at most
#   the depenetration cap per substep (10 m/s * h = 0.0167 m), so up to
#   REF_OUTLIERS of the bodies may exceed REF_ATOL, none by more than
#   REF_FLIP_ATOL (three capped substeps). Spawn overlaps in the 10k pile
#   make such flips likely; the measured worst was 0.0197 m.
REF_FRAMES = 3
REF_ATOL = 1e-3
REF_OUTLIERS = 0.01
REF_FLIP_ATOL = 0.05
READING = "bring-up reading, not a benchmark"


def log(phase: str, **readings):
    items = " ".join(f"{k}={v}" for k, v in readings.items())
    print(f"[{phase}] {items}", flush=True)


def peak_bytes(device):
    stats = device.memory_stats()
    return stats.get("peak_bytes_in_use") if stats else "not measured"


def _compile(fn, *args):
    """AOT-compile ``fn`` for ``args``; returns (compiled, seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _rate(n_bodies: int, frames: int, seconds: float) -> dict:
    return dict(ms_per_frame=seconds / frames * 1e3,
                body_steps_per_s=n_bodies * frames / seconds,
                timing=READING)


def _finite(*arrays):
    for a in arrays:
        assert np.isfinite(np.asarray(a)).all(), "non-finite state"


def _assert_counters(**counters):
    for name, value in counters.items():
        v = int(np.max(np.asarray(value)))
        assert v == 0, f"hard counter {name} = {v}"


def cpu_reference(world, cfg, max_pairs: int, frames: int = REF_FRAMES):
    """The plain reference: ``step`` on the CPU backend, one world alone."""
    import jax

    from starframe_tpu.step import step

    w = jax.device_put(world, jax.devices("cpu")[0])
    fn = jax.jit(lambda w: step(w, cfg, max_pairs)[0])
    for _ in range(frames):
        w = fn(w)
    return w


def _pose_diffs(a, b) -> np.ndarray:
    """Per-body max of the position and angle differences."""
    dp = np.abs(np.asarray(a.bodies.pos) - np.asarray(b.bodies.pos)).max(-1)
    da = np.abs(np.asarray(a.bodies.angle) - np.asarray(b.bodies.angle))
    return np.maximum(dp, da)


def check_reference(name: str, diffs: np.ndarray) -> dict:
    """Hold per-body differences from the reference to the bounds above;
    returns the readings to log."""
    out = dict(max_abs_diff=float(diffs.max()),
               share_over_atol=float((diffs > REF_ATOL).mean()),
               tolerance=REF_ATOL, outlier_share=REF_OUTLIERS,
               outlier_tolerance=REF_FLIP_ATOL)
    assert out["share_over_atol"] <= REF_OUTLIERS, f"{name} vs reference: {out}"
    assert out["max_abs_diff"] <= REF_FLIP_ATOL, f"{name} vs reference: {out}"
    return out


def _n_dynamic(world) -> int:
    return int((np.asarray(world.bodies.inv_mass) > 0).sum())


def _batched_roll_fn(cfg, max_pairs: int, frames: int):
    """The batched rollout phases 2 and 4 compile (one definition, so the
    second compile is a persistent-cache hit)."""
    import starframe_tpu as sf

    return lambda w: sf.batched_rollout(w, cfg, max_pairs, frames,
                                        record=lambda _: ())


def _roll_fn(cfg, max_pairs: int, frames: int):
    """The single-world rollout phases 3 and 4 compile."""
    from starframe_tpu.step import rollout

    return lambda w: rollout(w, cfg, max_pairs, frames, record=lambda _: ())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    """Phase 1: the default device must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (default device is {dev.platform}); "
            "nothing was run")
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()))


def phase_flagship(n_worlds=4096, n_bodies=256, substeps=10, frames=200,
                   step_frames=30, ref_worlds=4):
    """Phase 2: the batched-RL flagship (BASELINE.json:11)."""
    import jax

    import starframe_tpu as sf
    from starframe_tpu.parallel import world_slice

    scene = sf.scenes.batched_worlds(n_worlds=n_worlds, n_bodies=n_bodies,
                                     substeps=substeps)
    cfg, mp, w0 = scene.config, scene.capacity.max_pairs, scene.world
    n_dyn = _n_dynamic(w0)
    dev = jax.devices()[0]

    step_fn = lambda w: sf.parallel.batched_step(w, cfg, mp, with_diag=True)
    step_c, step_s = _compile(step_fn, w0)
    mem = step_c.memory_analysis()
    log("flagship", step_compile_s=step_s, step_memory_analysis=mem)

    roll_c, roll_s = _compile(_batched_roll_fn(cfg, mp, frames), w0)
    (final, _, diag), t = _timed(roll_c, w0)
    _assert_counters(**diag)
    _finite(final.bodies.pos, final.bodies.vel)
    log("flagship", rollout_compile_s=roll_s, frames=frames,
        **_rate(n_dyn, frames, t), peak_bytes=peak_bytes(dev))

    # make_batched_step, host-dispatched frame by frame from the rollout's end
    w = final
    t0 = time.perf_counter()
    for _ in range(step_frames):
        w, d = step_c(w)
        _assert_counters(**d)
    jax.block_until_ready(w)
    t = time.perf_counter() - t0
    _finite(w.bodies.pos)
    log("flagship", step_frames=step_frames, **_rate(n_dyn, step_frames, t),
        peak_bytes=peak_bytes(dev))

    # plain reference: a few worlds stepped alone on the CPU backend
    w = w0
    for _ in range(REF_FRAMES):
        w, _ = step_c(w)
    picks = sorted({0, 1, n_worlds // 2, n_worlds - 1})[:ref_worlds]
    diffs = np.concatenate([
        _pose_diffs(world_slice(w, i),
                    cpu_reference(world_slice(w0, i), cfg, mp))
        for i in picks])
    ref = check_reference("flagship", diffs)
    log("flagship", ref_worlds=picks, ref_frames=REF_FRAMES, vs="cpu", **ref)
    return ref["max_abs_diff"]


def phase_pile(n_bodies=10_000, frames=300, step_frames=30):
    """Phase 3: the 10k-body pile (BASELINE.json:8)."""
    import jax

    import starframe_tpu as sf

    scene = sf.scenes.pile(n_bodies=n_bodies)
    cfg, mp, w0 = scene.config, scene.capacity.max_pairs, scene.world
    n_dyn = _n_dynamic(w0)
    dev = jax.devices()[0]

    roll_c, roll_s = _compile(_roll_fn(cfg, mp, frames), w0)
    (final, _, diags), t = _timed(roll_c, w0)
    _assert_counters(pair_overflow=diags.pair_overflow,
                     cell_overflow=diags.cell_overflow)
    _finite(final.bodies.pos, final.bodies.vel)
    asleep = float((np.asarray(final.bodies.sleep_count)
                    >= cfg.sleep_frames).mean())
    log("pile", rollout_compile_s=roll_s, frames=frames,
        **_rate(n_dyn, frames, t), asleep_share=asleep,
        peak_bytes=peak_bytes(dev))

    step = scene.make_step(with_contacts=True, donate=False)
    (w, _, _), t = _timed(step, final)
    log("pile", make_step_compile_and_first_frame_s=t)
    t0 = time.perf_counter()
    for _ in range(step_frames):
        w, _, d = step(w)
        d.assert_no_overflow()
    jax.block_until_ready(w)
    t = time.perf_counter() - t0
    log("pile", step_frames=step_frames, **_rate(n_dyn, step_frames, t))

    w = w0
    for _ in range(REF_FRAMES):
        w = step(w)[0]
    ref = check_reference("pile", _pose_diffs(w, cpu_reference(w0, cfg, mp)))
    log("pile", ref_frames=REF_FRAMES, vs="cpu", **ref)
    return ref["max_abs_diff"]


def phase_determinism(n_worlds=4096, n_bodies=256, substeps=10,
                      flagship_frames=200, pile_bodies=10_000,
                      pile_frames=300):
    """Phase 4: the same rollout twice from one state is bitwise equal.
    (The default frame counts match phases 2 and 3, so the compiled
    programs come from the persistent cache.)"""
    import starframe_tpu as sf

    def twice(fn, w):
        compiled, _ = _compile(fn, w)
        a, _ = _timed(compiled, w)
        b, _ = _timed(compiled, w)
        for x, y in ((a[0].bodies.pos, b[0].bodies.pos),
                     (a[0].bodies.angle, b[0].bodies.angle),
                     (a[0].bodies.vel, b[0].bodies.vel)):
            assert np.array_equal(np.asarray(x), np.asarray(y)), \
                "replay differs"

    fl = sf.scenes.batched_worlds(n_worlds=n_worlds, n_bodies=n_bodies,
                                  substeps=substeps)
    twice(_batched_roll_fn(fl.config, fl.capacity.max_pairs,
                           flagship_frames), fl.world)
    pl = sf.scenes.pile(n_bodies=pile_bodies)
    twice(_roll_fn(pl.config, pl.capacity.max_pairs, pile_frames), pl.world)
    log("determinism", flagship_frames=flagship_frames,
        pile_frames=pile_frames, bitwise_equal=True)


def drop_ball(frames=150, substeps=10):
    """Analytic probe: a ball (r=0.5) dropped from 3.0 with restitution 0.8
    falls 2.5 m onto the ground; it rebounds 0.8^2 * 2.5 = 1.6 m, to a
    peak of 2.1. Returns the peak height after the first bounce."""
    import starframe_tpu as sf
    from starframe_tpu.scenes.base import add_ground

    b = sf.WorldBuilder()
    add_ground(b, half_width=10.0)  # a pair's restitution is the max of its two
    ball = b.add_body(pos=(0.0, 3.0))
    b.add_collider(ball, sf.Shape.circle(0.5), restitution=0.8)
    world, cap = b.build()
    step = sf.make_step(sf.SolverConfig(substeps=substeps), cap.max_pairs,
                        donate=False)
    peak, bounced = 0.0, False
    for _ in range(frames):
        world = step(world)
        y, vy = (float(v) for v in np.asarray(
            [world.bodies.pos[1, 1], world.bodies.vel[1, 1]]))
        bounced = bounced or vy > 0
        if bounced:
            peak = max(peak, y)
    return peak


def resting_circle(frames=120, substeps=10):
    """Analytic probe: a circle (r=0.5) resting on the ground settles with
    its centre at its radius. Returns the centre height."""
    import starframe_tpu as sf
    from starframe_tpu.scenes.base import add_ground

    b = sf.WorldBuilder()
    add_ground(b, half_width=10.0)
    ball = b.add_body(pos=(0.0, 0.5))
    b.add_collider(ball, sf.Shape.circle(0.5))
    world, cap = b.build()
    step = sf.make_step(sf.SolverConfig(substeps=substeps), cap.max_pairs,
                        donate=False)
    for _ in range(frames):
        world = step(world)
    return float(np.asarray(world.bodies.pos[1, 1]))


def phase_scenes(frames=120, scenes=("box_stack", "rope_bridge",
                                     "mechanism")):
    """Phase 5: the 60 Hz scenes through ``make_step``, and the probes."""
    import jax

    import starframe_tpu as sf

    for name in scenes:
        scene = getattr(sf.scenes, name)()
        cfg, mp, w0 = scene.config, scene.capacity.max_pairs, scene.world
        step = scene.make_step(with_contacts=True, donate=False)
        (w, _, d), compile_s = _timed(step, w0)
        t0 = time.perf_counter()
        for _ in range(frames):
            w, _, d = step(w)
            d.assert_no_overflow()
        jax.block_until_ready(w)
        t = time.perf_counter() - t0
        _finite(w.bodies.pos, w.bodies.vel)
        ref = w0
        for _ in range(REF_FRAMES):
            ref = step(ref)[0]
        check = check_reference(name, _pose_diffs(
            ref, cpu_reference(w0, cfg, mp)))
        log("scenes", scene=name, compile_and_first_frame_s=compile_s,
            frames=frames, **_rate(_n_dynamic(w0), frames, t),
            ref_frames=REF_FRAMES, vs="cpu", **check)

    peak = drop_ball()
    assert abs(peak - 2.1) <= 0.1, f"ball-drop rebound peak {peak}"
    rest = resting_circle()
    assert abs(rest - 0.5) <= 0.02, f"resting circle at {rest}"
    log("scenes", ball_drop_peak=peak, expected=2.1, tolerance=0.1,
        resting_circle_y=rest, expected_rest=0.5, rest_tolerance=0.02)


def phase_sharded(n_devices=4, n_worlds=4096, n_bodies=256, substeps=10,
                  frames=30, devices=None):
    """Phase 6: the world axis sharded over ``n_devices`` with
    ``make_sharded_step``, against the same worlds on one device."""
    import jax

    import starframe_tpu as sf
    from starframe_tpu import parallel as par

    devices = (jax.devices() if devices is None else devices)[:n_devices]
    assert len(devices) == n_devices, f"need {n_devices} devices"
    mesh = par.make_mesh(devices)
    scene = sf.scenes.batched_worlds(n_worlds=n_worlds, n_bodies=n_bodies,
                                     substeps=substeps)
    cfg, mp = scene.config, scene.capacity.max_pairs
    sharded = par.shard_world(scene.world, mesh)
    sstep = par.make_sharded_step(cfg, mp, mesh, donate=False,
                                  with_diag=True)
    (w, d), compile_s = _timed(sstep, sharded)
    _assert_counters(**d)
    shard_devs = {s.device for s in w.bodies.pos.addressable_shards}
    assert len(shard_devs) == n_devices, f"output on {len(shard_devs)} devices"
    for _ in range(REF_FRAMES - 1):
        w, d = sstep(w)
        _assert_counters(**d)

    ref = jax.device_put(scene.world, devices[0])
    ref_step = par.make_batched_step(cfg, mp, donate=False)
    for _ in range(REF_FRAMES):
        ref = ref_step(ref)
    check = check_reference("sharded", _pose_diffs(jax.device_get(w),
                                                   jax.device_get(ref)))

    t0 = time.perf_counter()
    for _ in range(frames):
        w, d = sstep(w)
        _assert_counters(**d)
    jax.block_until_ready(w)
    t = time.perf_counter() - t0
    _finite(w.bodies.pos)
    log("sharded", devices=n_devices, worlds=n_worlds,
        compile_and_first_frame_s=compile_s, frames=frames,
        **_rate(_n_dynamic(scene.world), frames, t),
        ref_frames=REF_FRAMES, vs="one_device", **check,
        shard_devices=len(shard_devs))
    return check["max_abs_diff"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded world-axis phase")
    args = ap.parse_args(argv)

    from starframe_tpu import runtime

    cache = runtime.configure()
    import jax

    device = phase_device()
    print("\n".join(runtime.card_info()), flush=True)
    log("device", **device, compile_cache=cache)
    if args.chips == 4:
        phase_sharded(n_devices=4)
    else:
        phase_flagship()
        phase_pile()
        phase_determinism()
        phase_scenes()
    device["count"] = len(jax.devices())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
