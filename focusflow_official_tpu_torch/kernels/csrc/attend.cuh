// The per-query loop shared by `attention.cu` (kernel E) and
// `window_attention.cu` (kernel F): one thread, one query of one head.
//
//   out = sum_j softmax_j(scale * <q, k_j>) v_j
//
// with k_j = kp + j * ks and v_j = vp + j * vs, read from shared or global
// memory. Scores, softmax and the P.V sum are f32 whatever the storage
// type. The softmax is taken online over chunks of CH keys: the chunk's
// scores sit in registers, the running max is raised once per chunk and
// the running sum and accumulator are rescaled by exp(m_old - m_new), so
// no score ever reaches memory and each score is computed once.
//
// Loads and stores move 16 bytes at a time: every row handed to these
// helpers starts on a 16-byte boundary and holds a multiple of 16 bytes
// (the wrappers check the pointers and the widths).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ffattn {

// N contiguous values at p -> f32
template <int N>
__device__ __forceinline__ void load_f(const float* __restrict__ p, float* out) {
  static_assert(N % 4 == 0, "f32 rows are read as float4");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = u.x;
    out[4 * i + 1] = u.y;
    out[4 * i + 2] = u.z;
    out[4 * i + 3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void load_f(const __nv_bfloat16* __restrict__ p, float* out) {
  static_assert(N % 8 == 0, "bf16 rows are read as 8-value uint4");
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // a bf16 is the high half of an f32; the lower address is the low half
      out[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
      out[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_f(float* __restrict__ p, const float* v) {
  static_assert(N % 4 == 0, "f32 rows are written as float4");
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

template <int N>
__device__ __forceinline__ void store_f(__nv_bfloat16* __restrict__ p, const float* v) {
  static_assert(N % 8 == 0, "bf16 rows are written as 8-value uint4");
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(v[8 * i + 2 * k]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(v[8 * i + 2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    reinterpret_cast<uint4*>(p)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int D, int DV, typename T>
__device__ __forceinline__ void attend(const float (&q)[D], const T* __restrict__ kp,
                                       long long ks, const T* __restrict__ vp, long long vs,
                                       int M, float scale, float (&out)[DV]) {
  constexpr int CH = 8;
  float m = -INFINITY;
  float l = 0.0f;
  float acc[DV];
#pragma unroll
  for (int e = 0; e < DV; ++e) acc[e] = 0.0f;

  for (int j0 = 0; j0 < M; j0 += CH) {
    float s[CH];
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      s[c] = -INFINITY;
      if (j0 + c < M) {
        float kv[D];
        load_f<D>(kp + (long long)(j0 + c) * ks, kv);
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(q[e], kv[e], dot);
        s[c] = dot * scale;
        cmax = fmaxf(cmax, s[c]);
      }
    }
    const float mn = fmaxf(m, cmax);  // finite: the chunk holds a key
    const float corr = expf(m - mn);  // exp(-inf) = 0 on the first chunk
    l *= corr;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[e] *= corr;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (j0 + c < M) {
        const float p = expf(s[c] - mn);
        l += p;
        float vv[DV];
        load_f<DV>(vp + (long long)(j0 + c) * vs, vv);
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
    }
    m = mn;
  }
  const float inv = 1.0f / l;
#pragma unroll
  for (int e = 0; e < DV; ++e) out[e] = acc[e] * inv;
}

}  // namespace ffattn
