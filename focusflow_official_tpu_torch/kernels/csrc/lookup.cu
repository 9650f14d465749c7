// Correlation-pyramid window lookup (RAFT CorrBlock), one launch for all levels.
//
// Replaces the TPU kernel `focusflow_official_tpu/ops/pallas_lookup.py`
// (`_level_kernel`, called from `lookup_corr_pyramid_pallas`). The TPU has no
// gather, so that kernel stages each query's rows in VMEM and extracts an
// integer-aligned patch with lane/sublane rolls. Hopper gathers in hardware:
// here each thread computes one output channel of one query and reads its
// four bilinear taps straight from the level's row in device memory.
//
// out[b, q, l*K2 + ix*K + iy] = bilinear(corr_l[b, q], coords[b, q] / 2^l
//                                        + (ix - r, iy - r)),  K = 2r+1
// with zero outside the level (grid_sample's zero padding) and the
// reference channel order: the x-offset varies slowest. Taps are summed in
// f32 whatever the level's type.
//
// What bounds it: bytes. Each output value (f32) is written once and needs
// four taps; a query's 81 windows of one level share one (K+1)x(K+1) patch,
// so the taps a query needs are ~100 values per level, read through L1/L2.
// Design: threads of a block cover consecutive channels of consecutive
// queries, so the output stores are fully coalesced and the neighbouring
// threads of one query hit the same patch rows in cache. The per-value
// arithmetic lives in `lookup.cuh`, shared with `lookup_fold.cu`, which
// applies convc1 in the same launch so the window never reaches HBM.

#include <cuda_runtime.h>

#include "lookup.cuh"

namespace {

using fflookup::Levels;

template <typename T>
__global__ void lookup_kernel(Levels lv, int num_levels, const float* __restrict__ coords,
                              float* __restrict__ out, long long nq, int radius) {
  const int k = 2 * radius + 1;
  const int k2 = k * k;
  const int ch = num_levels * k2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nq * ch) return;
  const long long bq = t / ch;
  const int c = (int)(t - bq * ch);
  const int l = c / k2;
  const int wi = c - l * k2;
  const int ix = wi / k;  // x-offset: slow axis (reference quirk)
  const int iy = wi - ix * k;
  out[t] = fflookup::window_value<T>(lv, coords, bq, l, ix, iy, radius);
}

}  // namespace

// levels: num_levels (<= 4) contiguous (B, Q, H_l, W_l) tensors of one type
// (bf16 if is_bf16, else f32); coords: (B*Q, 2) f32 level-0 (x, y);
// out: (B*Q, num_levels*(2r+1)^2) f32. Returns the launch's cudaError_t.
extern "C" int ff_lookup(const void* c0, const void* c1, const void* c2, const void* c3,
                         int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                         int num_levels, const float* coords, float* out, long long nq,
                         int radius, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > 4) return (int)cudaErrorInvalidValue;
  Levels lv = {{c0, c1, c2, c3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int k = 2 * radius + 1;
  const long long total = nq * num_levels * k * k;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    lookup_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(lv, num_levels, coords, out,
                                                                     nq, radius);
  else
    lookup_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(lv, num_levels, coords, out, nq,
                                                             radius);
  return (int)cudaGetLastError();
}
