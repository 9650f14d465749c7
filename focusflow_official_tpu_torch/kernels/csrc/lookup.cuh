// One value of the correlation-pyramid window, shared by `lookup.cu`
// (kernel A, which writes the window) and `lookup_fold.cu` (which keeps it
// in shared memory and applies convc1 to it):
//
//   window_value(l, ix, iy) = bilinear(corr_l[bq], coords[bq] / 2^l
//                                      + (ix - r, iy - r))
//
// with zero outside the level (grid_sample's zero padding). The four taps
// are weighted and summed in f32, in one fixed order, whatever the level's
// type, so both kernels give the same bits.

#pragma once

#include <cuda_runtime.h>

#include "convert.cuh"

namespace fflookup {

struct Levels {
  const void* ptr[4];
  int h[4];
  int w[4];
};

template <typename T>
__device__ __forceinline__ float window_value(const Levels& lv, const float* __restrict__ coords,
                                              long long bq, int l, int ix, int iy, int radius) {
  const float inv_scale = 1.0f / (float)(1 << l);  // exact: a power of two
  const float x = coords[2 * bq] * inv_scale + (float)(ix - radius);
  const float y = coords[2 * bq + 1] * inv_scale + (float)(iy - radius);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;

  const int H = lv.h[l];
  const int W = lv.w[l];
  const T* base = reinterpret_cast<const T*>(lv.ptr[l]) + bq * (long long)H * W;
  auto tap = [&](int xi, int yi, float wgt) -> float {
    if (xi < 0 || xi > W - 1 || yi < 0 || yi > H - 1) return 0.0f;
    return __fmul_rn(ffconv::to_f(base[(long long)yi * W + xi]), wgt);
  };
  float v = tap(x0, y0, __fmul_rn(1.0f - wx, 1.0f - wy));
  v = __fadd_rn(v, tap(x0 + 1, y0, __fmul_rn(wx, 1.0f - wy)));
  v = __fadd_rn(v, tap(x0, y0 + 1, __fmul_rn(1.0f - wx, wy)));
  v = __fadd_rn(v, tap(x0 + 1, y0 + 1, __fmul_rn(wx, wy)));
  return v;
}

}  // namespace fflookup
