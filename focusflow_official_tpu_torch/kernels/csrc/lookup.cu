// Correlation-pyramid window lookup (RAFT CorrBlock), one launch for all levels.
//
// Replaces the TPU kernel `focusflow_official_tpu/ops/pallas_lookup.py`
// (`_level_kernel`, called from `lookup_corr_pyramid_pallas`). The TPU has no
// gather, so that kernel stages each query's rows in VMEM and extracts an
// integer-aligned patch with lane/sublane rolls. Hopper gathers in hardware,
// so here a warp stages each (query, level) patch in shared memory with
// coalesced row runs and computes the window from it (`lookup.cuh`).
//
// out[b, q, l*K2 + ix*K + iy] = bilinear(corr_l[b, q], coords[b, q] / 2^l
//                                        + (ix - r, iy - r)),  K = 2r+1
// with zero outside the level (grid_sample's zero padding) and the
// reference channel order: the x-offset varies slowest. Taps are summed in
// f32 whatever the level's type; the output takes the level's type, so a
// bf16 output is that f32 sum rounded once (the bits of the f32 result cast
// to bf16).
//
// What bounds it: bytes (the output, and each query's (2r+3)^2 patch a
// level), and in fact the latency of two dependent loads (coordinates, then
// patch). Design: a block of 4 warps takes 8 consecutive (query, level)
// units, 2 a warp; a warp issues the loads of its 2 patches at once (8
// values a lane in flight), stages them, and computes 81 values a unit, 3 a
// lane. Small blocks of few registers keep many warps in flight to hide the
// two latencies. The units of a warp are consecutive, so its stores cover
// one stretch of the output: a query's row of L*81 values, or 2 rows at L = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lookup.cuh"

namespace {

using namespace fflookup;

constexpr int WARPS = 4, UNITS = 2;  // a block: 4 warps of 2 (query, level) units
constexpr int THREADS = 32 * WARPS;

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
lookup_kernel(const __grid_constant__ Levels lv, int num_levels,
              const float* __restrict__ coords, T* __restrict__ out, int units) {
  using G = Geometry<R>;
  __shared__ T patches[WARPS][UNITS][PATCH_STRIDE];
  __shared__ int2 tables[WARPS][UNITS][TABLE_STRIDE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Lanes<R> ln(lane);
  const int u0 = (blockIdx.x * WARPS + warp) * UNITS;
  const int ch = num_levels * G::K2;

  // unit u = (query u / L, level u % L): a warp's units are consecutive.
  // Every unit's coordinates are asked for before the first patch load
  // waits on them: one latency, not one a unit.
  T v[UNITS][G::PSLOTS];
  Unit un[UNITS];
  float2 c[UNITS];
  int bq = u0 / num_levels, l = u0 - bq * num_levels;
  int bqs[UNITS], ls[UNITS];
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    bqs[i] = bq;
    ls[i] = l;
    if (u0 + i < units) c[i] = __ldg(reinterpret_cast<const float2*>(coords) + bq);
    if (++l == num_levels) {
      l = 0;
      ++bq;
    }
  }
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    if (u0 + i < units) {
      un[i] = make_unit<R>(c[i].x, c[i].y, ls[i]);
      load_patch<T, R>(v[i], lv, ls[i], bqs[i], un[i], ln, lane);
    }
  }
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    if (u0 + i < units) {
      store_patch<T, R>(patches[warp][i], v[i], lane);
      axis_entry<R>(tables[warp][i], un[i], lane);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    if (u0 + i >= units) break;
    T* row = out + (long long)bqs[i] * ch + ls[i] * G::K2;
    window_values<T, R>(patches[warp][i], tables[warp][i], lane,
                        [&](int wi, float val) { row[wi] = ffconv::from_f<T>(val); });
  }
}

template <typename T>
int launch(const Levels& lv, int num_levels, const float* coords, void* out, int units,
           int radius, cudaStream_t s) {
  const int blocks = (units + WARPS * UNITS - 1) / (WARPS * UNITS);
  return with_radius(radius, [&](auto rad) {
    lookup_kernel<T, decltype(rad)::value><<<blocks, THREADS, 0, s>>>(
        lv, num_levels, coords, static_cast<T*>(out), units);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// levels: num_levels (<= 4) contiguous (B, Q, H_l, W_l) tensors of one type
// (bf16 if is_bf16, else f32); coords: (B*Q, 2) f32 level-0 (x, y);
// out: (B*Q, num_levels*(2r+1)^2) in the levels' type; radius 3 or 4;
// B*Q*num_levels < 2^31. Returns the launch's cudaError_t.
extern "C" int ff_lookup(const void* c0, const void* c1, const void* c2, const void* c3,
                         int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                         int num_levels, const float* coords, void* out, long long nq,
                         int radius, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > 4 || nq * num_levels >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const int units = (int)(nq * num_levels);
  Levels lv = {{c0, c1, c2, c3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(lv, num_levels, coords, out, units, radius, s)
                 : launch<float>(lv, num_levels, coords, out, units, radius, s);
}

// The units (query, level) a block of `ff_lookup` takes.
extern "C" int ff_lookup_units_per_block() { return WARPS * UNITS; }
