"""Frame orchestrator — the tpu_rt equivalent of the reference Renderer
(src/rt/cuda/Renderer.cc): owns scene, BVH (with cache), ray generators,
tracer, and the begin_frame / next_batch / trace_batch / update_result cycle.

Differences from the reference, by design:
- num_samples and sort_secondary are real knobs (the reference hard-forces
  numSamples=1 and sort off in the committed benchmark, App.cc:155-157);
- the random seed is explicit and deterministic (fixes the reference's
  rand() leak at RayGen.cc:106);
- batch results are retained so reconstruction runs once over the frame.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from tpu_rt.bvh import BuildParams, Platform, load_or_build_bvh
from tpu_rt.core.math import to_abgr
from tpu_rt.core.types import Hits, Rays
from tpu_rt.raygen import RayGen
from tpu_rt.rays.buffer import morton_sort_device_coarse
from tpu_rt.scene import Camera, Scene
from tpu_rt.shade import count_hits, reconstruct_image
from tpu_rt.trace import make_routing_tracer

RAY_TYPES = ("primary", "ao", "diffuse")


@dataclass
class RendererParams:
    """Reference Renderer::Params (Renderer.hh:54-76)."""

    ray_type: str = "primary"
    ao_radius: float = 5.0
    num_samples: int = 8
    # OFF by default, matching the reference's COMMITTED benchmark
    # (App.cc:157 forces sortSecondary=false); gen_ao_rays already emits
    # rays in pixel-coherent primary-slot order.  The flag is real (the
    # reference's is dead).
    sort_secondary: bool = False
    # Opt-in dynamic-fetch analogue: sort degenerate (primary-miss)
    # rays to the end of each secondary batch and trace only the live
    # prefix (rays/buffer.py sort_dead_last_device/trace_live_prefix).
    # Useful for the XLA wavefront tracer, whose batch while_loop runs
    # until the last live lane finishes; the CUDA kernel retires dead
    # rays at fetch.  Not yet measured on the GPU, so OFF.
    compact_degenerate: bool = False
    max_batch: int = 1 << 21
    seed: int = 0
    cache_dir: str | None = "bvhcache"
    # "auto": the CUDA kernel on a GPU, the XLA wavefront tracer
    # elsewhere; "cuda"/"xla" force one (trace.make_routing_tracer).
    tracer: str = "auto"
    # Directory for a jax.profiler trace of render_frame (None = off).
    profile_dir: str | None = None


@dataclass
class BatchRecord:
    rays: Rays
    hits: Hits | None
    slot_to_id: np.ndarray
    id_to_slot: np.ndarray
    input_range: tuple


class Renderer:
    def __init__(self, width: int = 640, height: int = 480, params: RendererParams | None = None):
        self.width = width
        self.height = height
        self.params = params or RendererParams()
        assert self.params.ray_type in RAY_TYPES
        self.platform = Platform.gpu()
        self.build_params = BuildParams()
        self.raygen = RayGen(self.params.max_batch)
        self.scene: Scene | None = None
        self.flat = None
        self.bvh_stats = None
        self._dbvh = None
        self._routing = None
        self.active_tracer = None
        self._tri_normal_dev = None
        self._tri_shaded_dev = None
        self._tri_material_dev = None
        self.trace_time_s = 0.0
        self.rays_traced = 0
        self.rays_skipped = 0

    # -- setup ---------------------------------------------------------------

    def set_mesh(self, mesh) -> None:
        self.set_scene(Scene(mesh))

    def set_scene(self, scene: Scene) -> None:
        self.scene = scene
        self.flat = None
        self._dbvh = None

    def set_build_params(self, params: BuildParams) -> None:
        self.build_params = params
        self.flat = None
        self._dbvh = None

    def _ensure_bvh(self):
        if self._dbvh is None:
            assert self.scene is not None, "set_mesh/set_scene first"
            self.flat, self.bvh_stats = load_or_build_bvh(
                self.scene, self.platform, self.build_params, cache_dir=self.params.cache_dir
            )
            self._routing, self.active_tracer, self._dbvh = (
                make_routing_tracer(self.flat, prefer=self.params.tracer))
            self._tri_normal_dev = jnp.asarray(self.scene.tri_normal)
            self._tri_shaded_dev = jnp.asarray(self.scene.tri_shaded)
            self._tri_material_dev = jnp.asarray(self.scene.tri_material)
        return self._dbvh

    # -- frame cycle ---------------------------------------------------------

    def begin_frame(self, camera: Camera) -> None:
        """BVH setup + primary raygen (+ immediate primary trace for
        secondary ray types), reference Renderer::beginFrame
        (Renderer.cc:112-152)."""
        self._ensure_bvh()
        self.camera = camera
        self.phase_s = {"raygen": 0.0, "sort": 0.0, "trace": 0.0,
                        "reconstruct": 0.0}
        t0 = time.perf_counter()
        rays, s2i, i2s = self.raygen.primary(camera, self.width, self.height)
        self.phase_s["raygen"] += time.perf_counter() - t0
        self.primary = BatchRecord(
            rays=rays, hits=None, slot_to_id=s2i, id_to_slot=i2s, input_range=(0, rays.origin.shape[0])
        )
        self.trace_time_s = 0.0
        self.rays_traced = 0
        self.rays_skipped = 0
        if self.params.ray_type != "primary":
            self.primary.hits = self._timed_trace(self.primary.rays, any_hit=False, count=False)
        self._new_batch = True
        self._batch: BatchRecord | None = None
        self._batch_live = None
        self._batches: list[BatchRecord] = []

    def _timed_trace(self, rays: Rays, any_hit: bool, count: bool = True) -> Hits:
        """Trace with kernel-only timing, the Mray/s metric discipline
        (App.cc:188-204: trace time only, and only for the measured batches;
        the pre-trace of primaries for secondary types is not counted)."""
        self._ensure_bvh()
        jax.block_until_ready(rays)
        t0 = time.perf_counter()
        # The frame path consumes only (tri, t), the reference kernel's
        # int2 result (STORE_RESULT, kepler_dynamic_fetch.cu:407-408).
        hits = jax.block_until_ready(self._trace(rays, any_hit))
        dt = time.perf_counter() - t0
        self.phase_s["trace"] += dt
        if count:
            self.trace_time_s += dt
            self.rays_traced += int(rays.origin.shape[0])
        return hits

    def get_total_num_rays(self) -> int:
        """Ray budget of the frame (Renderer.cc:221-238): primary count, or
        primary hit count x num_samples for secondary types."""
        if self.params.ray_type == "primary":
            return self.width * self.height
        assert self.primary.hits is not None
        return int(count_hits(self.primary.hits.tri)) * self.params.num_samples

    def next_batch(self) -> bool:
        """Generate the next trace batch (Renderer::nextBatch,
        Renderer.cc:242-291)."""
        p = self.params
        if p.ray_type == "primary":
            if not self._new_batch:
                return False
            self._new_batch = False
            self._batch = self.primary
            self._batches.append(self.primary)
            return True

        max_dist = p.ao_radius if p.ray_type == "ao" else float(self.camera.far)
        t0 = time.perf_counter()
        out = self.raygen.ao(
            self.primary.rays,
            self.primary.hits,
            self.scene.tri_normal,
            p.num_samples,
            max_dist,
            self._new_batch,
            seed=p.seed,
        )
        self.phase_s["raygen"] += time.perf_counter() - t0
        self._new_batch = False
        if out is None:
            self._batch = None
            return False
        rays, s2i, i2s, rng = out

        self._batch_live = None
        if p.sort_secondary or p.compact_degenerate:
            # Fully device-side Morton sort (the reference round-trips
            # keys through a host qsort, RayBuffer.cc:256-324; here the
            # device keys, sorts, and permutes rays — only the
            # ID<->slot maps, which reconstruction reads host-side anyway,
            # come back).  compact_degenerate implies the dead-last sort
            # even when sort_secondary is off (it is a permutation too).
            t0 = time.perf_counter()
            if p.compact_degenerate:
                from tpu_rt.rays.buffer import sort_dead_last_device

                order_dev = sort_dead_last_device(rays)
                self._batch_live = int(jnp.sum(rays.tmax >= 0))
            else:
                # Coarse 30-bit key: coherence needs only coarse
                # locality (rays/buffer.py docstring).
                order_dev = morton_sort_device_coarse(rays.origin,
                                                      rays.dirn)
            rays = Rays(
                origin=rays.origin[order_dev],
                dirn=rays.dirn[order_dev],
                tmin=rays.tmin[order_dev],
                tmax=rays.tmax[order_dev],
            )
            order = np.asarray(order_dev)
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size, dtype=order.dtype)
            s2i = np.asarray(s2i)[order]
            i2s = inv[np.asarray(i2s)]
            self.phase_s["sort"] += time.perf_counter() - t0

        self._batch = BatchRecord(
            rays=rays, hits=None, slot_to_id=np.asarray(s2i), id_to_slot=np.asarray(i2s), input_range=rng
        )
        self._batches.append(self._batch)
        return True

    def trace_batch(self) -> float:
        """Trace the current batch; returns elapsed seconds (kernel only)."""
        assert self._batch is not None
        t0 = self.trace_time_s
        any_hit = self.params.ray_type == "ao"  # needClosestHit for diffuse
        live = getattr(self, "_batch_live", None)
        if live is not None:
            from tpu_rt.rays.buffer import live_prefix_len, trace_live_prefix

            jax.block_until_ready(self._batch.rays)
            t1 = time.perf_counter()
            hits = jax.block_until_ready(trace_live_prefix(
                lambda r: self._trace(r, any_hit), self._batch.rays, live))
            dt = time.perf_counter() - t1
            self.phase_s["trace"] += dt
            self.trace_time_s += dt
            # Count only rays physically traced: the live prefix rounded
            # up to its size bucket.  The skipped dead suffix is recorded
            # separately so frame stats stay auditable.
            n_batch = int(self._batch.rays.origin.shape[0])
            traced = live_prefix_len(live, n_batch)
            self.rays_traced += traced
            self.rays_skipped += n_batch - traced
            self._batch.hits = hits
        else:
            self._batch.hits = self._timed_trace(self._batch.rays,
                                                 any_hit=any_hit)
        return self.trace_time_s - t0

    def _trace(self, rays: Rays, any_hit: bool) -> Hits:
        return self._routing(self._dbvh, rays, any_hit=any_hit)

    def render_frame(self, camera: Camera) -> dict:
        """Full frame: begin_frame + batch loop.  Returns timing/ray stats.

        Metric discipline per the reference (App.cc:188-204 with
        Renderer.cc:221-238): the Mray/s numerator is get_total_num_rays()
        — the primary-ray count, or primary HITS x num_samples for
        secondary types — NOT the number of rays physically traced (which
        for AO/diffuse includes degenerate tmax=-1 rays for primary
        misses and would inflate the rate by the miss fraction).

        Per-phase wall-clock (raygen/sort/trace/reconstruct) accumulates
        in self.phase_s and is returned under "phase_s"; set
        RendererParams.profile_dir to also capture a jax.profiler trace
        of the frame (SURVEY section 5 tracing/profiling row)."""
        import contextlib

        prof = (jax.profiler.trace(self.params.profile_dir)
                if self.params.profile_dir else contextlib.nullcontext())
        with prof:
            self.begin_frame(camera)
            total_rays = self.get_total_num_rays()
            while self.next_batch():
                self.trace_batch()
        mrays_per_s = (
            total_rays / (self.trace_time_s * 1e6) if self.trace_time_s > 0 else float("inf")
        )
        return {
            "total_rays": total_rays,
            "rays_traced": self.rays_traced,
            "rays_skipped": self.rays_skipped,
            "trace_time_s": self.trace_time_s,
            "mrays_per_s": mrays_per_s,
            "phase_s": dict(self.phase_s),
        }

    # -- reconstruction ------------------------------------------------------

    def update_result(self) -> np.ndarray:
        """Reconstruct the frame RGBA image [h, w, 4] f32
        (Renderer::updateResult, Renderer.cc:421-445)."""
        t0 = time.perf_counter()
        try:
            return self._update_result()
        finally:
            if hasattr(self, "phase_s"):
                self.phase_s["reconstruct"] += time.perf_counter() - t0

    def _update_result(self) -> np.ndarray:
        p = self.params
        num_pixels = self.width * self.height
        if p.ray_type == "primary":
            image = reconstruct_image(
                jnp.asarray(self.primary.slot_to_id),
                self.primary.hits.tri if self.primary.hits is not None else self._batches[0].hits.tri,
                jnp.asarray(self.primary.id_to_slot),
                self._batches[0].hits.tri,
                self._tri_shaded_dev,
                self._tri_material_dev,
                "primary",
                1,
                num_pixels,
            )
            return np.asarray(image).reshape(self.height, self.width, 4)

        # Secondary: assemble full per-primary sample results across batches.
        s = p.num_samples
        batch_tri = np.full(num_pixels * s, -1, np.int32)
        for b in self._batches:
            lo, hi = b.input_range
            ids = np.arange((hi - lo) * s, dtype=np.int64)
            slots = np.asarray(b.id_to_slot)[ids]
            tri = np.asarray(b.hits.tri)[slots]
            # Map to global (input-slot, sample) ids: input slot k of this
            # batch is primary slot lo + k.
            global_base = (lo * s)
            batch_tri[global_base : global_base + tri.size] = tri

        image = reconstruct_image(
            jnp.asarray(self.primary.slot_to_id),
            self.primary.hits.tri,
            jnp.arange(num_pixels * s, dtype=jnp.int32),  # identity: assembled above
            jnp.asarray(batch_tri),
            self._tri_shaded_dev,
            self._tri_material_dev,
            p.ray_type,
            s,
            num_pixels,
        )
        return np.asarray(image).reshape(self.height, self.width, 4)

    def update_result_u32(self) -> np.ndarray:
        """ABGR8 image [h, w] u32, the reference's display format."""
        return to_abgr(self.update_result())
