#!/usr/bin/env python
"""On-card smoke test of the frame path, at the reference's scene size.

    python chip_smoke.py               # one GPU: phases a-e
    python chip_smoke.py --devices 4   # four GPUs: phase f only

Phases, on the procedural bunny (144,500 triangles, the reference bunny's
count) at 640x480:

  a. the card: name, power limit, platform, device kind, CUDA build time;
  b. the CUDA kernel against the plain reference (trace_wavefront) on the
     same card, every ray, for primary, AO (8 samples, any hit) and
     diffuse (8 samples, closest hit) rays; disagreements are adjudicated
     by the scalar CPU oracle (tpu_rt.trace.verify) and none may be wrong;
  c. Renderer.render_frame + update_result, primary and AO at 8 samples
     (default max_batch, so AO takes two batches), once per tracer:
     finite images whose hit ids agree after adjudication;
  d. warm frame wall time and trace time of both tracers in (c);
  e. one grad_step_sharded on a one-card mesh, CUDA routing against XLA
     routing;
  f. (--devices 4) trace_sharded with CUDA routing on a four-card mesh
     against the one-card trace, and the sharded grad step against the
     one-card grad step.

A failed phase prints its traceback; the script then exits 1 and prints
no result.  The last line on success is one JSON object naming the device.
It exits 2 when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import traceback

import numpy as np

WIDTH, HEIGHT = 640, 480
SCENE = "bunny"
SAMPLES = 8
WARM_REPEATS = 3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7

failures: list[str] = []


def phase(name):
    """Run a phase; record and print its failure, never hide it."""

    def wrap(fn):
        def run(*args, **kwargs):
            print(f"== phase {name}", flush=True)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            except Exception:
                traceback.print_exc()
                sys.stderr.flush()
                failures.append(name)
                print(f"== phase {name} FAILED after "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                return None
            print(f"== phase {name} ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out

        return run

    return wrap


def check_report(label, report):
    print(f"  {label}: rays={report['rays']} disputed={report['disputed']} "
          f"tie={report['tie']} graze={report['graze']} "
          f"kernel_wrong={report['wrong']}", flush=True)
    if report["wrong"]:
        raise AssertionError(f"{label}: {report['wrong']} rays wrong, first "
                             f"{report['first_wrong']}")


def setup():
    from tpu_rt.bench.workload import suite_ao_radius, suite_camera
    from tpu_rt.bvh import load_or_build_bvh
    from tpu_rt.scene import Scene, procedural

    t0 = time.perf_counter()
    scene = Scene(procedural.scene_by_name(SCENE))
    flat, _ = load_or_build_bvh(scene, cache_dir="bvhcache")
    print(f"setup: {SCENE} {scene.num_triangles} triangles, "
          f"{flat.nodes.shape[0]} nodes, {flat.tri_woop.shape[0]} refs, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return scene, flat, suite_camera(SCENE, scene), suite_ao_radius(SCENE, scene)


@phase("a card")
def phase_card():
    from tpu_rt.bench.device import card_info, device_summary
    from tpu_rt.trace.cuda_tracer import load_kernel

    print(f"  card: {card_info()}")
    print(f"  jax: {device_summary()}")
    info = load_kernel()
    print(f"  cuda kernel: build/load {info['build_s']:.1f} s, "
          f"{info['sm_count']} SMs x {info['blocks_per_sm']} blocks/SM")


def primary_rays(camera):
    from tpu_rt.raygen import RayGen

    rays, _, _ = RayGen().primary(camera, WIDTH, HEIGHT)
    return rays


@phase("b kernel vs oracle")
def phase_kernel(scene, flat, camera, ao_radius):
    import jax.numpy as jnp

    from tpu_rt.raygen.generators import gen_ao_rays
    from tpu_rt.trace import make_routing_tracer, trace_wavefront
    from tpu_rt.trace.verify import compare_hits

    routing, kind, tables = make_routing_tracer(flat, prefer="auto")
    print(f"  make_routing_tracer('auto'): kind={kind}")
    assert kind == "cuda", kind
    rays = primary_rays(camera)
    got = routing(tables, rays, any_hit=False)
    want = trace_wavefront(tables, rays)
    check_report("primary", compare_hits(flat, rays, got, want, False))
    normals = jnp.asarray(scene.tri_normal)
    for label, any_hit, dist in (("ao", True, ao_radius),
                                 ("diffuse", False, float(camera.far))):
        sec, _, _ = gen_ao_rays(rays.origin, rays.dirn, want.t, want.tri,
                                normals, SAMPLES, jnp.float32(dist),
                                jnp.uint32(0))
        got = routing(tables, sec, any_hit=any_hit)
        ref = trace_wavefront(tables, sec, any_hit=any_hit)
        check_report(f"{label} {SAMPLES} spp",
                     compare_hits(flat, sec, got, ref, any_hit))


def render(scene, camera, ao_radius, ray_type, tracer):
    """Cold frame (compiles), then WARM_REPEATS timed warm frames."""
    import jax

    from tpu_rt.renderer import Renderer, RendererParams

    r = Renderer(WIDTH, HEIGHT, RendererParams(
        ray_type=ray_type, num_samples=SAMPLES, ao_radius=ao_radius,
        tracer=tracer, cache_dir="bvhcache"))
    r.set_scene(scene)
    r.render_frame(camera)
    r.update_result()
    frames, traces = [], []
    for _ in range(WARM_REPEATS):
        t0 = time.perf_counter()
        stats = r.render_frame(camera)
        img = r.update_result()
        jax.block_until_ready(img)
        frames.append(time.perf_counter() - t0)
        traces.append(stats["trace_time_s"])
    assert r.active_tracer == tracer, r.active_tracer
    assert img.shape == (HEIGHT, WIDTH, 4), img.shape
    assert np.isfinite(img).all()
    return r, img, frames, traces


@phase("c frame path")
def phase_frames(scene, flat, camera, ao_radius):
    from tpu_rt.trace.verify import compare_hits

    timings = {}
    for ray_type in ("primary", "ao"):
        rc, _, fc, tc = render(scene, camera, ao_radius, ray_type, "cuda")
        rx, _, fx, tx = render(scene, camera, ao_radius, ray_type, "xla")
        any_hit = ray_type == "ao"
        assert len(rc._batches) == len(rx._batches)
        print(f"  {ray_type}: {len(rc._batches)} batch(es)")
        if ray_type != "primary":
            check_report(f"{ray_type} frame primary hits", compare_hits(
                flat, rc.primary.rays, rc.primary.hits, rx.primary.hits,
                False))
        for i, (bc, bx) in enumerate(zip(rc._batches, rx._batches)):
            check_report(f"{ray_type} frame batch {i}", compare_hits(
                flat, bc.rays, bc.hits, bx.hits, any_hit))
        timings[ray_type] = {"cuda": (fc, tc), "xla": (fx, tx)}
    return timings


@phase("d timing")
def phase_timing(timings):
    from tpu_rt.bench.device import card_info

    print(f"  card: {card_info()}")
    for ray_type, by_tracer in timings.items():
        for tracer, (frames, traces) in by_tracer.items():
            print(f"  {ray_type} {tracer}: warm frame median "
                  f"{statistics.median(frames) * 1e3:.3f} ms "
                  f"(min {min(frames) * 1e3:.3f}), trace median "
                  f"{statistics.median(traces) * 1e3:.3f} ms "
                  f"(min {min(traces) * 1e3:.3f}), {WARM_REPEATS} frames")


def grad_inputs(scene, camera, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_rt.dist.sharding import AXIS, shard_rays

    rays = primary_rays(camera)
    rng = np.random.default_rng(0)
    target = jax.device_put(
        jnp.asarray(rng.uniform(0, 1, (WIDTH * HEIGHT, 3)).astype(np.float32)),
        NamedSharding(mesh, P(AXIS, None)))
    return (rays, shard_rays(rays, mesh), jnp.asarray(scene.vtx_pos),
            jnp.asarray(scene.tri_vtx_index), jnp.asarray(scene.tri_material),
            target)


def grad_step(mesh, flat, scene, camera, prefer):
    from tpu_rt.dist import grad_step_sharded
    from tpu_rt.dist.sharding import replicate_bvh
    from tpu_rt.trace import make_routing_tracer

    routing, kind, tables = make_routing_tracer(flat, prefer=prefer)
    tables = replicate_bvh(tables, mesh)
    _, srays, vtx, tvi, mat, target = grad_inputs(scene, camera, mesh)
    out = grad_step_sharded(mesh, tables, srays, vtx, tvi, mat, target,
                            routing=routing, tables=tables)
    return [np.asarray(x) for x in out]


def compare_grads(label, a, b):
    loss_a, gv_a, gm_a = a
    loss_b, gv_b, gm_b = b
    print(f"  {label}: loss {float(loss_a):.8f} vs {float(loss_b):.8f}, "
          f"|g_vtx| {np.linalg.norm(gv_a):.6e} vs {np.linalg.norm(gv_b):.6e}")
    assert np.isfinite(loss_a) and np.isfinite(gv_a).all() and np.isfinite(gm_a).all()
    np.testing.assert_allclose(loss_a, loss_b, rtol=LOSS_RTOL)
    np.testing.assert_allclose(gv_a, gv_b, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gm_a, gm_b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@phase("e gradient step")
def phase_grad(scene, flat, camera):
    import jax

    from tpu_rt.dist import make_ray_mesh

    mesh = make_ray_mesh(jax.devices()[:1])
    compare_grads("1-card cuda vs xla routing",
                  grad_step(mesh, flat, scene, camera, "cuda"),
                  grad_step(mesh, flat, scene, camera, "xla"))


@phase("f four cards")
def phase_four(scene, flat, camera, n):
    import jax

    from tpu_rt.dist import make_ray_mesh, trace_sharded
    from tpu_rt.dist.sharding import replicate_bvh, shard_rays
    from tpu_rt.trace import make_routing_tracer

    devices = jax.devices()
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    mesh = make_ray_mesh(devices[:n])
    routing, kind, tables = make_routing_tracer(flat, prefer="cuda")
    rays = primary_rays(camera)
    assert rays.origin.shape[0] % n == 0
    one = routing(tables, rays, any_hit=False)
    rep = replicate_bvh(tables, mesh)
    sharded = trace_sharded(rep, shard_rays(rays, mesh), mesh,
                            routing=routing, tables=rep)
    same = np.asarray(sharded.tri) == np.asarray(one.tri)
    print(f"  trace_sharded {n} cards vs 1 card: {int(same.sum())}/"
          f"{same.size} hit ids equal")
    assert same.all()
    one_mesh = make_ray_mesh(devices[:1])
    compare_grads(f"grad step {n} cards vs 1 card (cuda routing)",
                  grad_step(mesh, flat, scene, camera, "cuda"),
                  grad_step(one_mesh, flat, scene, camera, "cuda"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase (f)")
    args = ap.parse_args(argv)

    from tpu_rt.bench.device import require_gpu
    from tpu_rt.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    dev = require_gpu("chip_smoke.py")
    print(f"compile cache: {cache}")
    phase_card()
    scene, flat, camera, ao_radius = setup()
    if args.devices == 4:
        phase_four(scene, flat, camera, 4)
    else:
        phase_kernel(scene, flat, camera, ao_radius)
        timings = phase_frames(scene, flat, camera, ao_radius)
        if timings is not None:
            phase_timing(timings)
        phase_grad(scene, flat, camera)
    if failures:
        print(f"FAILED phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
