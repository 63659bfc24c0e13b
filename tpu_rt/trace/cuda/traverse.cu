// BVH traversal kernel for NVIDIA Hopper (sm_90a), called from JAX through
// the XLA foreign function interface (tpu_rt/trace/cuda_tracer.py).
//
// The design is the Aila-Laine persistent while-while tracer
// (kepler_dynamic_fetch.cu:66-411 in the reference), rewritten for the
// independent thread scheduling of Volta and later:
//
// - one ray per thread; a fixed grid of persistent warps pulls rays from a
//   work counter, and the finished lanes of a warp refill together through
//   a ballot/popc prefix (dynamic fetch).  The counter is a scratch result
//   of the FFI call, zeroed on the call's stream, so two calls never share
//   it;
// - speculative while-while traversal with one postponed leaf;
// - a 64-entry per-thread stack in local memory (xla_tracer.STACK_DEPTH);
// - Compact2 nodes read as 4 x float4 and Woop triangles as 3 x float4
//   through the read-only path (__ldg);
// - span tests with fminf/fmaxf in place of Kepler's vmin/vmax video
//   instructions.
//
// Every warp-wide operation names its lanes: __ballot_sync/__shfl_sync over
// the exact set of live lanes where the result must be exact (the refill),
// __activemask() where the vote is only a scheduling heuristic (leaf
// postponing, dynamic fetch) and any subset of lanes gives correct hits.
//
// Arithmetic parity with cpu_reference.trace_flat_scalar (and
// xla_tracer.py): the 2^-80 ooeps clamp of the inverse direction, strict t
// bounds (tmin < t < hitT), the any-hit early exit, and rays with tmax < 0
// are never traced.  float32 throughout, compiled with -fmad=false: every
// product and sum rounds on its own, in the oracle's order, so slab and
// triangle tests decide exactly as the oracle does.  (With FMA contraction
// a slab test near a box face can cull the box the oracle enters.)
//
// Layout (tpu_rt.core.types.FlatBVH):
//   rays  [N, 8]  f32: origin.xyz, tmin, dir.xyz, tmax
//   nodes [M, 16] f32: c0 xy slabs, c1 xy slabs, z slabs, links (i32 bits:
//                      child0, child1, count0, count1; a leaf link is ~first)
//   woop  [R, 12] f32: woopZ, woopU, woopV
//   tri_index [R] i32, leaf_counts [R + 1] i32
//   out   [N, 2]  i32: original triangle id (-1 miss), hit t as f32 bits

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStackDepth = 64;          // reference STACK_SIZE
constexpr int kSentinel = 0x7FFFFFFF;    // core.types.SENTINEL
constexpr int kBlockThreads = 128;       // 4 warps per block
constexpr int kDynamicFetchThreshold = 20;  // reference DYNAMIC_FETCH_THRESHOLD
constexpr float kOoeps = 8.271806125530277e-25f;  // 2^-80

__device__ __forceinline__ float span_begin(float a0, float a1, float b0,
                                            float b1, float c0, float c1,
                                            float d) {
  return fmaxf(fmaxf(fminf(a0, a1), fminf(b0, b1)), fmaxf(fminf(c0, c1), d));
}

__device__ __forceinline__ float span_end(float a0, float a1, float b0,
                                          float b1, float c0, float c1,
                                          float d) {
  return fminf(fminf(fmaxf(a0, a1), fmaxf(b0, b1)), fminf(fmaxf(c0, c1), d));
}

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) > kOoeps ? d : copysignf(kOoeps, d));
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlockThreads)
trace_kernel(const float4* __restrict__ rays, const float4* __restrict__ nodes,
             const float4* __restrict__ woop,
             const int* __restrict__ tri_index,
             const int* __restrict__ leaf_counts, int2* __restrict__ out,
             unsigned int* __restrict__ counter, int num_rays) {
  int stack[kStackDepth];
  int sp = 0;
  int node = kSentinel;  // kSentinel: no ray, fetch one
  int leaf = 0;          // < 0: a postponed leaf link
  int ray = 0;
  int hit_row = -1;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float idirx = 0.f, idiry = 0.f, idirz = 0.f;
  float oodx = 0.f, oody = 0.f, oodz = 0.f;
  float tmin = 0.f, hit_t = 0.f;

  const unsigned int lane = threadIdx.x & 31u;
  const unsigned int lanes_below = (1u << lane) - 1u;
  unsigned int live = 0xFFFFFFFFu;  // blocks are whole warps

  while (true) {
    // ---- dynamic fetch: finished lanes take the next rays together ----
    const bool idle = node == kSentinel;
    const unsigned int idle_mask = __ballot_sync(live, idle);
    if (idle) {
      const int leader = __ffs(idle_mask) - 1;
      unsigned int base = 0;
      if (static_cast<int>(lane) == leader) {
        base = atomicAdd(counter, static_cast<unsigned int>(__popc(idle_mask)));
      }
      base = __shfl_sync(idle_mask, base, leader);
      ray = static_cast<int>(base) + __popc(idle_mask & lanes_below);
      if (ray < num_rays) {
        const float4 o = __ldg(&rays[2 * ray]);
        const float4 d = __ldg(&rays[2 * ray + 1]);
        ox = o.x; oy = o.y; oz = o.z; tmin = o.w;
        dx = d.x; dy = d.y; dz = d.z; hit_t = d.w;
        idirx = safe_inv(dx);
        idiry = safe_inv(dy);
        idirz = safe_inv(dz);
        oodx = ox * idirx;
        oody = oy * idiry;
        oodz = oz * idirz;
        sp = 0;
        leaf = 0;
        hit_row = -1;
        node = hit_t < 0.0f ? kSentinel : 0;  // degenerate rays never trace
      }
    }
    const bool done = idle && ray >= num_rays;
    live = __ballot_sync(live, !done);
    if (done) break;

    // ---- while-while traversal ----
    while (node != kSentinel) {
      // Inner nodes until a leaf is found (postponed) or every active lane
      // holds one.
      while (static_cast<unsigned int>(node) <
             static_cast<unsigned int>(kSentinel)) {
        const float4* rec = nodes + 4 * node;
        const float4 n0xy = __ldg(rec + 0);
        const float4 n1xy = __ldg(rec + 1);
        const float4 nz = __ldg(rec + 2);
        const int4 link = __ldg(reinterpret_cast<const int4*>(rec + 3));

        const float c0lox = n0xy.x * idirx - oodx;
        const float c0hix = n0xy.y * idirx - oodx;
        const float c0loy = n0xy.z * idiry - oody;
        const float c0hiy = n0xy.w * idiry - oody;
        const float c0loz = nz.x * idirz - oodz;
        const float c0hiz = nz.y * idirz - oodz;
        const float c1loz = nz.z * idirz - oodz;
        const float c1hiz = nz.w * idirz - oodz;
        const float c0min =
            span_begin(c0lox, c0hix, c0loy, c0hiy, c0loz, c0hiz, tmin);
        const float c0max =
            span_end(c0lox, c0hix, c0loy, c0hiy, c0loz, c0hiz, hit_t);
        const float c1lox = n1xy.x * idirx - oodx;
        const float c1hix = n1xy.y * idirx - oodx;
        const float c1loy = n1xy.z * idiry - oody;
        const float c1hiy = n1xy.w * idiry - oody;
        const float c1min =
            span_begin(c1lox, c1hix, c1loy, c1hiy, c1loz, c1hiz, tmin);
        const float c1max =
            span_end(c1lox, c1hix, c1loy, c1hiy, c1loz, c1hiz, hit_t);

        const bool hit0 = c0max >= c0min;
        const bool hit1 = c1max >= c1min;
        if (!hit0 && !hit1) {
          node = sp > 0 ? stack[min(--sp, kStackDepth - 1)] : kSentinel;
        } else {
          int near_child = hit0 ? link.x : link.y;
          if (hit0 && hit1) {
            int far_child = link.y;
            if (c1min < c0min) {
              near_child = link.y;
              far_child = link.x;
            }
            // The builder bounds the depth at 64 levels, so at most 64
            // entries are ever pushed; the clamp only keeps the index in
            // the array.
            stack[min(sp, kStackDepth - 1)] = far_child;
            ++sp;
          }
          node = near_child;
        }
        // Postpone the first leaf found and keep traversing.
        if (node < 0 && leaf >= 0) {
          leaf = node;
          node = sp > 0 ? stack[min(--sp, kStackDepth - 1)] : kSentinel;
        }
        if (!__any_sync(__activemask(), leaf >= 0)) break;
      }

      // Leaves: the postponed one, then the one in `node` if any.
      while (leaf < 0) {
        const int first = ~leaf;
        const int end = first + __ldg(&leaf_counts[first]);
        for (int row = first; row < end; ++row) {
          const float4* tri = woop + 3 * row;
          const float4 v00 = __ldg(tri + 0);
          const float oz_ = v00.w - ox * v00.x - oy * v00.y - oz * v00.z;
          const float inv_dz = 1.0f / (dx * v00.x + dy * v00.y + dz * v00.z);
          const float t = oz_ * inv_dz;
          if (t > tmin && t < hit_t) {
            const float4 v11 = __ldg(tri + 1);
            const float ox_ = v11.w + ox * v11.x + oy * v11.y + oz * v11.z;
            const float dx_ = dx * v11.x + dy * v11.y + dz * v11.z;
            const float u = ox_ + t * dx_;
            if (u >= 0.0f) {
              const float4 v22 = __ldg(tri + 2);
              const float oy_ = v22.w + ox * v22.x + oy * v22.y + oz * v22.z;
              const float dy_ = dx * v22.x + dy * v22.y + dz * v22.z;
              const float v = oy_ + t * dy_;
              if (v >= 0.0f && u + v <= 1.0f) {
                hit_t = t;
                hit_row = row;
                if (kAnyHit) {
                  node = kSentinel;
                  break;
                }
              }
            }
          }
        }
        leaf = node;
        if (node < 0) {
          node = sp > 0 ? stack[min(--sp, kStackDepth - 1)] : kSentinel;
        }
      }

      // Too few lanes still tracing: go back and refill the idle ones.
      if (__popc(__activemask()) < kDynamicFetchThreshold) break;
    }

    if (node == kSentinel) {
      const int id = hit_row >= 0 ? __ldg(&tri_index[hit_row]) : -1;
      out[ray] = make_int2(id, __float_as_int(hit_t));
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

ffi::Error TraceImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rays,
                     ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> woop,
                     ffi::Buffer<ffi::S32> tri_index,
                     ffi::Buffer<ffi::S32> leaf_counts,
                     ffi::ResultBuffer<ffi::S32> out,
                     ffi::ResultBuffer<ffi::U32> counter, int32_t any_hit,
                     int32_t grid) {
  const auto rdims = rays.dimensions();
  if (rdims.size() != 2 || rdims[1] != 8) {
    return ffi::Error::InvalidArgument("rays must be [N, 8] float32");
  }
  if (nodes.dimensions().size() != 2 || nodes.dimensions()[1] != 16 ||
      woop.dimensions().size() != 2 || woop.dimensions()[1] != 12) {
    return ffi::Error::InvalidArgument(
        "nodes must be [M, 16] and woop [R, 12] float32");
  }
  if (!aligned16(rays.typed_data()) || !aligned16(nodes.typed_data()) ||
      !aligned16(woop.typed_data()) || !aligned16(out->typed_data())) {
    return ffi::Error::InvalidArgument("buffers must be 16-byte aligned");
  }
  const int64_t num_rays = rdims[0];
  if (num_rays > INT32_MAX / 2) {
    return ffi::Error::InvalidArgument("too many rays for one call");
  }
  cudaError_t err = cudaMemsetAsync(counter->typed_data(), 0,
                                    sizeof(unsigned int), stream);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  if (num_rays == 0 || grid <= 0) return ffi::Error::Success();

  const auto* r = reinterpret_cast<const float4*>(rays.typed_data());
  const auto* n = reinterpret_cast<const float4*>(nodes.typed_data());
  const auto* w = reinterpret_cast<const float4*>(woop.typed_data());
  auto* o = reinterpret_cast<int2*>(out->typed_data());
  if (any_hit) {
    trace_kernel<true><<<grid, kBlockThreads, 0, stream>>>(
        r, n, w, tri_index.typed_data(), leaf_counts.typed_data(), o,
        counter->typed_data(), static_cast<int>(num_rays));
  } else {
    trace_kernel<false><<<grid, kBlockThreads, 0, stream>>>(
        r, n, w, tri_index.typed_data(), leaf_counts.typed_data(), o,
        counter->typed_data(), static_cast<int>(num_rays));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TpuRtTrace, TraceImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rays
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // woop
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tri_index
                                  .Arg<ffi::Buffer<ffi::S32>>()  // leaf_counts
                                  .Ret<ffi::Buffer<ffi::S32>>()  // out
                                  .Ret<ffi::Buffer<ffi::U32>>()  // counter
                                  .Attr<int32_t>("any_hit")
                                  .Attr<int32_t>("grid"));

// Launch sizing for the persistent grid: the SM count of `device` and how
// many blocks of the traversal kernel fit on one SM (occupancy API).
// Called once per process from Python; returns a cudaError_t.
extern "C" int tpu_rt_trace_occupancy(int device, int* sm_count,
                                      int* blocks_per_sm) {
  cudaError_t err = cudaDeviceGetAttribute(
      sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int closest = 0, any = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &closest, trace_kernel<false>, kBlockThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &any, trace_kernel<true>, kBlockThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks_per_sm = closest < any ? closest : any;
  return 0;
}

extern "C" int tpu_rt_trace_block_threads() { return kBlockThreads; }
