// The correlation-pyramid window gather, shared by `lookup.cu` (kernel A,
// which writes the window) and `lookup_fold.cu` (which keeps it in shared
// memory and applies convc1 to it):
//
//   window(l, ix, iy) = bilinear(corr_l[bq], coords[bq] / 2^l + (ix - r, iy - r))
//
// with zero outside the level (grid_sample's zero padding). A warp takes one
// (query, level) unit at a time. It stages the unit's P x P patch, P = 2r+3,
// anchored at (floor(cx / 2^l) - r, floor(cy / 2^l) - r), into shared memory
// once: lane + 32 j holds patch value j of the flat patch, so lanes cover
// consecutive columns of a patch row (one coalesced run a row), zero where
// the patch leaves the level. Every window value is then computed from the
// patch with the per-value f32 arithmetic of the plain version:
//
//   x = cx * 2^-l + (ix - r), x0 = floor(x), wx = x - x0 (the same for y),
//   v = ((t00 (1-wx)(1-wy) + t10 wx (1-wy)) + t01 (1-wx) wy) + t11 wx wy
//
// x, x0 and wx depend on ix alone and y, y0 and wy on iy alone, so a unit's
// 2K of them are computed once, into an axis table in shared memory, and
// each of the K^2 values reads its two entries.
//
// Why P = 2r+3 and not 2r+2: in f32, floor(s + d) for an integer d is
// floor(s) + d or floor(s) + d + 1 (s = 1 - 2^-24, d = 4: s + d rounds to
// 5), so x0 - anchor lies in [0, 2r+1] and x0 + 1 in [1, 2r+2]. With the
// per-value arithmetic the patch gives the plain version's bits; a tap
// outside the level reads +0 from the patch, and +0 * w adds what a skipped
// tap adds. The radius is a template argument, built for 3 and 4 (the
// paths take 4; 3 is the radius of RAFT's small variant): the patch and window sizes are then
// constants, and so are the lanes' places in them.

#pragma once

#include <cuda_runtime.h>

#include "convert.cuh"

namespace fflookup {

struct Levels {
  const void* ptr[4];
  int h[4];
  int w[4];
};

constexpr int MAX_RADIUS = 4;
constexpr int PATCH_STRIDE = 128;  // values a unit's patch takes in shared memory
constexpr int TABLE_STRIDE = 2 * (2 * MAX_RADIUS + 1);  // entries of a unit's axis table

template <int R>
struct Geometry {
  static constexpr int P = 2 * R + 3, PP = P * P;  // the patch
  static constexpr int K = 2 * R + 1, K2 = K * K;  // the window
  static constexpr int PSLOTS = (PP + 31) / 32;    // patch values a lane holds
  static constexpr int WSLOTS = (K2 + 31) / 32;    // window values a lane computes
  static_assert(PP <= PATCH_STRIDE && 2 * K <= 32, "patch");
};

// This lane's places in a unit's patch (row, column of lane + 32 j), fixed
// for the launch.
template <int R>
struct Lanes {
  using G = Geometry<R>;
  int prow[G::PSLOTS], pcol[G::PSLOTS];

  __device__ __forceinline__ explicit Lanes(int lane) {
#pragma unroll
    for (int j = 0; j < G::PSLOTS; ++j) {
      const int e = lane + 32 * j;
      prow[j] = e / G::P;
      pcol[j] = e - prow[j] * G::P;
    }
  }
  // slot j of `lane` lies in the patch
  __device__ __forceinline__ static bool in_patch(int lane, int j) {
    return lane + 32 * j < G::PP;
  }
};

// One (query, level) unit: its level-l coordinates and the patch's anchor.
struct Unit {
  float x, y;  // coords / 2^l
  int ax, ay;  // floor(x) - r, floor(y) - r
};

template <int R>
__device__ __forceinline__ Unit make_unit(float cx, float cy, int l) {
  const float inv_scale = 1.0f / (float)(1 << l);  // exact: a power of two
  Unit u;
  u.x = __fmul_rn(cx, inv_scale);
  u.y = __fmul_rn(cy, inv_scale);
  u.ax = (int)floorf(u.x) - R;
  u.ay = (int)floorf(u.y) - R;
  return u;
}

// This lane's patch values of unit `u` at level `l` of query `bq`, zero
// outside the level and past the patch.
template <typename T, int R>
__device__ __forceinline__ void load_patch(T (&v)[Geometry<R>::PSLOTS], const Levels& lv, int l,
                                           long long bq, const Unit& u, const Lanes<R>& ln,
                                           int lane) {
  using G = Geometry<R>;
  const int H = lv.h[l], W = lv.w[l];
  // a patch wholly outside the level (or coordinates far enough out that
  // the offsets below could overflow) reads nothing
  const bool none = u.ax >= W || u.ax + G::P <= 0 || u.ay >= H || u.ay + G::P <= 0;
  const T* corner = reinterpret_cast<const T*>(lv.ptr[l]) + bq * (long long)H * W +
                    (none ? 0 : u.ay * W + u.ax);
#pragma unroll
  for (int j = 0; j < G::PSLOTS; ++j) {
    const bool in = !none && Lanes<R>::in_patch(lane, j) &&
                    (unsigned)(u.ax + ln.pcol[j]) < (unsigned)W &&
                    (unsigned)(u.ay + ln.prow[j]) < (unsigned)H;
    v[j] = in ? corner[ln.prow[j] * W + ln.pcol[j]] : ffconv::from_f<T>(0.0f);
  }
}

// the lane's values into the unit's patch in shared memory
template <typename T, int R>
__device__ __forceinline__ void store_patch(T* __restrict__ patch,
                                            const T (&v)[Geometry<R>::PSLOTS], int lane) {
#pragma unroll
  for (int j = 0; j < Geometry<R>::PSLOTS; ++j)
    if (Lanes<R>::in_patch(lane, j)) patch[lane + 32 * j] = v[j];
}

// This lane's entry of unit `u`'s axis table (2K entries; lanes past 2K
// write none): lane i < K the column offset px and the fraction wx of
// window column ix = i, lane K + i the row offset py * P and the fraction
// wy of window row iy = i, by the plain version's f32 arithmetic.
template <int R>
__device__ __forceinline__ void axis_entry(int2* __restrict__ table, const Unit& u, int lane) {
  using G = Geometry<R>;
  if (lane >= 2 * G::K) return;
  const bool col = lane < G::K;
  const int i = col ? lane : lane - G::K;
  const float c = __fadd_rn(col ? u.x : u.y, (float)(i - R));
  const float c0 = floorf(c);
  // in [0, P-2] for every finite coordinate (see the header); the clamp
  // keeps a NaN or an overflowing coordinate inside the patch
  const int o = (int)min((unsigned)((int)c0 - (col ? u.ax : u.ay)), (unsigned)(G::P - 2));
  table[lane] = make_int2(col ? o : o * G::P, __float_as_int(__fsub_rn(c, c0)));
}

// Every window value this lane computes from a unit's staged patch and
// axis table, handed to sink(window index ix*K + iy, value): the four taps
// weighted and summed in the plain version's order.
template <typename T, int R, typename Sink>
__device__ __forceinline__ void window_values(const T* __restrict__ patch,
                                              const int2* __restrict__ table, int lane,
                                              Sink sink) {
  using G = Geometry<R>;
#pragma unroll
  for (int j = 0; j < G::WSLOTS; ++j) {
    const int wi = lane + 32 * j;
    if (wi >= G::K2) break;
    const int2 ex = table[wi / G::K];        // x-offset: slow axis (reference quirk)
    const int2 ey = table[G::K + wi % G::K];
    const T* t = patch + ex.x + ey.x;
    const float wx = __int_as_float(ex.y), wy = __int_as_float(ey.y);
    const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
    float v = __fmul_rn(ffconv::to_f(t[0]), __fmul_rn(ux, uy));
    v = __fadd_rn(v, __fmul_rn(ffconv::to_f(t[1]), __fmul_rn(wx, uy)));
    v = __fadd_rn(v, __fmul_rn(ffconv::to_f(t[G::P]), __fmul_rn(ux, wy)));
    v = __fadd_rn(v, __fmul_rn(ffconv::to_f(t[G::P + 1]), __fmul_rn(wx, wy)));
    sink(wi, v);
  }
}

template <int R>
struct Radius {
  static constexpr int value = R;
};

// f(Radius<radius>{}) for a radius of 3 or 4, else cudaErrorInvalidValue
template <typename F>
inline int with_radius(int radius, F f) {
  switch (radius) {
    case 3: return f(Radius<3>{});
    case 4: return f(Radius<4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fflookup
