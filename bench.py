#!/usr/bin/env python
"""Benchmark CLI: prints ONE JSON line with the headline metric of one
configuration on one GPU.

    python bench.py [--config NAME] [--frames N] [--profile DIR]

Configurations: ``batched`` (the default: 4096 x 256-body worlds,
BASELINE.json:11), ``batched_rope``, ``batched_mechanism``, ``pile``
(10k bodies, BASELINE.json:8), ``pile_events``, ``pile_joints``,
``pile_compound``, ``box_stack``, ``rope_bridge``, ``mechanism``.

Each timed chunk is N frames in one on-device ``lax.scan`` (one host round
trip per rollout, the deployment shape of SURVEY.md §3.5), timed on the host
clock up to ``block_until_ready``. The 60 Hz scenes also report p50/p99 of
single-frame dispatches. Compilation is reported apart from the timed
chunks. The run fails without a GPU, and the JSON line names the device:
platform, kind, count, and the card's name and power limit. Secondary
readings go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

CONFIGS = ("batched", "batched_rope", "batched_mechanism", "pile",
           "pile_events", "pile_joints", "pile_compound", "box_stack",
           "rope_bridge", "mechanism")
LATENCY_CONFIGS = ("box_stack", "rope_bridge", "mechanism")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_scene(config: str, worlds: int = 4096, bodies: int = 256,
                pile_bodies: int = 10_000):
    """The scene a configuration benchmarks (sizes as given)."""
    import starframe_tpu as sf

    if config == "batched":
        return sf.scenes.batched_worlds(n_worlds=worlds, n_bodies=bodies)
    if config in ("batched_rope", "batched_mechanism"):
        base = (sf.scenes.rope_bridge() if config == "batched_rope"
                else sf.scenes.mechanism())
        return sf.scenes.batchify(base, min(worlds, 1024))
    if config == "pile_joints":
        return sf.scenes.pile_joints(n_bodies=pile_bodies)
    if config == "pile_compound":
        return sf.scenes.pile_compound(n_bodies=pile_bodies)
    if config in ("pile", "pile_events"):
        # pile_events keeps sleeping off: event consumers observe every
        # touching pair, and a sleeping pair's contacts freeze
        return sf.scenes.pile(n_bodies=pile_bodies, sleep=config == "pile")
    if config in LATENCY_CONFIGS:
        return getattr(sf.scenes, config)()
    raise ValueError(f"unknown config {config!r}")


def chunk_runner(scene, n_frames: int, with_events: bool = False):
    """Jitted ``world -> (world, counters)``: ``n_frames`` frames in one
    ``lax.scan``. ``counters`` = (pair_overflow, cell_overflow, events),
    the hard counters as max over the chunk plus, with ``with_events``, the
    touching-pair count summed over frames (keeps the event path live)."""
    import jax
    import jax.numpy as jnp

    import starframe_tpu as sf
    from starframe_tpu.events import touching_keys

    cfg, mp = scene.config, scene.capacity.max_pairs
    batched = scene.world.bodies.pos.ndim == 3

    def chunk(w):
        if batched:
            w, _, d = sf.batched_rollout(w, cfg, mp, n_frames,
                                         record=lambda _: ())
            return w, jnp.stack([d["pair_overflow"], d["cell_overflow"],
                                 jnp.int32(0)])

        def body(carry, _):
            w, povf, covf, ev = carry
            w2, contacts, d = sf.step(w, cfg, mp)
            if with_events:
                keys, touching = touching_keys(contacts, w.colliders.m)
                ev = ev + jnp.sum(touching & (keys >= 0), dtype=jnp.int32)
            return (w2, jnp.maximum(povf, d.pair_overflow),
                    jnp.maximum(covf, d.cell_overflow), ev), ()

        zero = jnp.int32(0)
        (w, povf, covf, ev), _ = jax.lax.scan(
            body, (w, zero, zero, zero), None, length=n_frames)
        return w, jnp.stack([povf, covf, ev])

    return jax.jit(chunk)


def bench_scene(scene, frames: int, reps: int = 3, profile_dir: str = None,
                latency_reps: int = 0, with_events: bool = False) -> dict:
    import jax

    flags = np.asarray(jax.device_get(scene.world.bodies.flags))
    n_body_per_frame = int(((flags & 1) != 0).sum())
    log(f"[bench] scene={scene.name} bodies/frame={n_body_per_frame} "
        f"max_pairs={scene.capacity.max_pairs} "
        f"substeps={scene.config.substeps}")

    run = chunk_runner(scene, frames, with_events=with_events)
    t0 = time.perf_counter()
    w, counters = jax.block_until_ready(run(scene.world))
    compile_s = time.perf_counter() - t0
    log(f"[bench] compile + first {frames}-frame chunk: {compile_s:.1f} s")

    times = []
    worst = np.asarray(counters)
    for _ in range(reps):
        t0 = time.perf_counter()
        w, counters = jax.block_until_ready(run(w))
        times.append(time.perf_counter() - t0)
        worst = np.maximum(worst, np.asarray(counters))
    pair_ovf, cell_ovf = int(worst[0]), int(worst[1])
    log("[bench] per-chunk ms/frame: "
        + " ".join(f"{t / frames * 1e3:.3f}" for t in times))
    per_frame = min(times) / frames
    bps = n_body_per_frame / per_frame
    log(f"[bench] best of {reps}: {per_frame * 1e3:.3f} ms/frame | "
        f"{bps:.3e} body-steps/s | pair_overflow={pair_ovf} "
        f"cell_overflow={cell_ovf}")
    if pair_ovf or cell_ovf:
        log("[bench] WARNING: capacity overflow — physics truncated "
            "contacts; raise the pair or cell capacity (SURVEY.md §4.6)")

    out = dict(compile_s=round(compile_s, 3), ms_per_frame=per_frame * 1e3,
               body_steps_per_s=bps, pair_overflow=pair_ovf,
               cell_overflow=cell_ovf)
    if latency_reps:
        # p50/p99 of single-frame dispatches, host round trip included
        run1 = chunk_runner(scene, 1)
        w1, _ = jax.block_until_ready(run1(w))
        lat = []
        for _ in range(latency_reps):
            t0 = time.perf_counter()
            w1, _ = jax.block_until_ready(run1(w1))
            lat.append(time.perf_counter() - t0)
        out["p50_ms"] = float(np.percentile(lat, 50)) * 1e3
        out["p99_ms"] = float(np.percentile(lat, 99)) * 1e3
        log(f"[bench] single-frame latency over {latency_reps} reps: "
            f"p50 {out['p50_ms']:.3f} ms  p99 {out['p99_ms']:.3f} ms")

    if profile_dir:
        log(f"[bench] writing jax.profiler trace to {profile_dir}")
        with jax.profiler.trace(profile_dir):
            jax.block_until_ready(run(w))
    return out


def device_record() -> dict:
    """The device the run measured, as JAX and ``nvidia-smi`` name it.
    Exits non-zero when the default device is not a GPU."""
    import jax

    from starframe_tpu import runtime

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (default device is {dev.platform})")
    name, limit = runtime.card_info()[0].split(", ")
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), card=name, power_limit=limit)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="batched", choices=CONFIGS)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames per timed chunk (default: 240 for the "
                         "piles, 60 otherwise)")
    ap.add_argument("--worlds", type=int, default=4096)
    ap.add_argument("--bodies", type=int, default=256)
    ap.add_argument("--pile-bodies", type=int, default=10_000)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a jax.profiler trace of one timed chunk")
    ap.add_argument("--latency-reps", type=int, default=None,
                    help="single-frame reps for p50/p99 (default: 30 for "
                         "the 60 Hz scenes, 0 otherwise)")
    args = ap.parse_args(argv)

    from starframe_tpu import runtime

    runtime.configure()
    device = device_record()
    log(f"[bench] device: {device}")

    scene = build_scene(args.config, args.worlds, args.bodies,
                        args.pile_bodies)
    pile = args.config.startswith("pile")
    frames = args.frames or (240 if pile else 60)
    # the sleeping pile needs ~700-900 frames to reach its sleeping steady
    # state; 6 chunks of 240 cover both the settling and the settled regime
    reps = 6 if args.config == "pile" else 3
    lat = args.latency_reps
    if lat is None:
        lat = 30 if args.config in LATENCY_CONFIGS else 0
    res = bench_scene(scene, frames, reps=reps, profile_dir=args.profile,
                      latency_reps=lat,
                      with_events=args.config == "pile_events")
    out = {
        "config": args.config,
        "metric": f"body-steps/s ({scene.name})",
        "value": res["body_steps_per_s"],
        "unit": "body-steps/s",
        "frames_per_chunk": frames,
        **res,
        "device": device,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
