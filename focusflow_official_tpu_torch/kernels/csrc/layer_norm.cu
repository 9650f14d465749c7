// LayerNorm over the last axis of (rows, C) activations, in their own type:
//
//   mean = E[x], var = E[(x - mean)^2] (biased), rstd = rsqrt(var + eps),
//   y = weight * (rstd * (x - mean)) + bias,
//
// statistics in f32, y rounded to x's type (round to nearest even, as
// `.to(bfloat16)` rounds); weight and bias read in their own type. With
// stats pointers, the per-row f32 mean and rstd are written too (the
// training forward saves them for `native_layer_norm_backward`).
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which
// fuses it with its neighbours. The port first ran it as three PyTorch
// kernels on bf16 rows: a cast to f32, `F.layer_norm` in f32 and a cast
// back, 20 bytes an element, with PyTorch's kernel at about a fifth of the
// card's bandwidth on FF-FlowFormer's 64- to 256-wide rows (a block a row,
// a 128-wide bf16 row being 256 bytes). It is FF-FlowFormer's costliest op
// when served: 99 calls a forward, 12.4 M rows a 4-pair request.
//
// What bounds it: bytes. x read once and y written once, 4 bytes an
// element in bf16; the arithmetic (a few operations an element) is far
// below the card's rate. The design keeps every byte at full width:
//
// - A group of `lanes` threads takes a row, each thread 16-byte vectors of
//   it (8 bf16 or 4 f32): 8 lanes a row at C = 64 bf16, 16 at 128, 32 at
//   256; wider rows give a lane up to MAX_VPL vectors. A warp takes
//   32 / lanes rows at once, so a 128-byte row keeps the whole warp busy.
// - The row stays in registers: the mean and then the variance are two
//   butterfly shuffle sums inside the lane group (every lane ends with the
//   same bits), so the second pass reads no memory.
// - A lane's channels are the same in every row, so it loads its slice of
//   weight and bias once.
// - The grid is persistent (as many blocks as fit the card at once), each
//   warp walking rows grid-stride with UNROLL rows' loads in flight a lane.
// - Entry `vector` takes C a whole number of 16-byte vectors (at most
//   32 x MAX_VPL of them) and 16-byte aligned x and y; every other row
//   takes `scalar`, a warp a row over 2-byte or 4-byte values, three reads
//   of the row (mostly from L1).
//
// The device names (`ff_layer_norm_rows`, `ff_layer_norm_rows_scalar`)
// carry "layer_norm", so a profile files them with the layer norms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 2;   // rows a lane has in flight
constexpr int MAX_VPL = 4;  // 16-byte vectors of a row a lane holds

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// the sum of v over an aligned group of `lanes` threads (a power of two);
// every thread of the group gets the same bits
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 16 bytes -> Vec<T>::N f32 values
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float (&out)[Vec<T>::N]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = __uint_as_float(u[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the high half of an f32
      out[2 * k] = __uint_as_float(u[k] << 16);
      out[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
}

// Vec<T>::N f32 values -> 16 bytes of T
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[Vec<T>::N]) {
  unsigned w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the lower address is the low half
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(v[2 * k]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Thread (group, lane) of a warp holds vectors lane, lane + lanes, ... (VPL
// of them, those past the row's nvec idle) of rows base + u * rpw + group,
// u < UNROLL, for base stepping grid-stride over the rows.
template <typename T, typename W, int VPL>
__global__ void __launch_bounds__(THREADS)
ff_layer_norm_rows(const T* __restrict__ x, const W* __restrict__ weight,
                   const W* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean_out,
                   float* __restrict__ rstd_out, long long rows, int C, int lanes, float eps) {
  constexpr int N = Vec<T>::N;
  const int nvec = C / N;
  const int lane_id = threadIdx.x & 31;
  const int lane = lane_id & (lanes - 1);
  const int group = lane_id / lanes;
  const int rpw = 32 / lanes;  // rows a warp takes at once
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long step = (long long)gridDim.x * WARPS * UNROLL * rpw;

  bool has[VPL];
  float w[VPL][N], b[VPL][N];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int vi = lane + v * lanes;
    has[v] = vi < nvec;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      w[v][e] = has[v] ? to_f(weight[vi * N + e]) : 0.0f;
      b[v][e] = has[v] ? to_f(bias[vi * N + e]) : 0.0f;
    }
  }

  // the loop bound depends on the warp alone: every thread of a warp takes
  // part in every shuffle
  for (long long base = warp * UNROLL * rpw; base < rows; base += step) {
    uint4 raw[UNROLL][VPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = base + u * rpw + group;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        raw[u][v] = (r < rows && has[v])
                        ? *reinterpret_cast<const uint4*>(x + r * C + (lane + v * lanes) * N)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = base + u * rpw + group;
      float f[VPL][N];
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        unpack<T>(raw[u][v], f[v]);
#pragma unroll
        for (int e = 0; e < N; ++e) s += f[v][e];  // idle vectors hold zeros
      }
      const float mean = group_sum(s, lanes) / (float)C;
      float q = 0.0f;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        if (has[v]) {
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float d = f[v][e] - mean;
            q = fmaf(d, d, q);
          }
        }
      const float rstd = rsqrtf(group_sum(q, lanes) / (float)C + eps);
      if (r < rows) {
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          if (has[v]) {
            float o[N];
#pragma unroll
            for (int e = 0; e < N; ++e) o[e] = fmaf(w[v][e], rstd * (f[v][e] - mean), b[v][e]);
            *reinterpret_cast<uint4*>(y + r * C + (lane + v * lanes) * N) = pack<T>(o);
          }
        if (mean_out && lane == 0) {
          mean_out[r] = mean;
          rstd_out[r] = rstd;
        }
      }
    }
  }
}

// A warp a row, any C and alignment: the sums, then the output, each a
// pass over the row.
template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
ff_layer_norm_rows_scalar(const T* __restrict__ x, const W* __restrict__ weight,
                          const W* __restrict__ bias, T* __restrict__ y,
                          float* __restrict__ mean_out, float* __restrict__ rstd_out,
                          long long rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32; r < rows; r += warps) {
    const T* xr = x + r * C;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
    const float mean = group_sum(s, 32) / (float)C;
    float q = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(xr[c]) - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(group_sum(q, 32) / (float)C + eps);
    T* yr = y + r * C;
    for (int c = lane; c < C; c += 32)
      yr[c] = from_f<T>(fmaf(to_f(weight[c]), rstd * (to_f(xr[c]) - mean), to_f(bias[c])));
    if (mean_out && lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

// the persistent grid: as many blocks as fit the card at once (the
// kernel's occupancy, asked once), no more than the rows need
template <typename K>
int grid_for(K kernel, int& per_sm, long long blocks_needed, int sms) {
  if (per_sm == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0);
    per_sm = n > 0 ? n : 1;
  }
  const long long cap = (long long)per_sm * sms;
  return (int)(blocks_needed < cap ? blocks_needed : cap);
}

template <typename T, typename W, int VPL>
int launch_vector(const void* x, const void* weight, const void* bias, void* y, float* mean,
                  float* rstd, long long rows, int C, int lanes, float eps, int sms,
                  cudaStream_t st) {
  static int per_sm = 0;
  const auto kernel = ff_layer_norm_rows<T, W, VPL>;
  const long long rows_a_block = (long long)WARPS * UNROLL * (32 / lanes);
  const int grid = grid_for(kernel, per_sm, (rows + rows_a_block - 1) / rows_a_block, sms);
  kernel<<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), static_cast<const W*>(weight),
                                   static_cast<const W*>(bias), static_cast<T*>(y), mean, rstd,
                                   rows, C, lanes, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* x, const void* weight, const void* bias, void* y, float* mean,
           float* rstd, long long rows, int C, int vec, float eps, int sms, cudaStream_t st) {
  if (vec) {
    constexpr int N = Vec<T>::N;
    const int nvec = C / N;
    const int vpl = (nvec + 31) / 32;
    int lanes = 1;
    while (lanes * vpl < nvec) lanes <<= 1;
    if (vpl == 1)
      return launch_vector<T, W, 1>(x, weight, bias, y, mean, rstd, rows, C, lanes, eps, sms, st);
    if (vpl == 2)
      return launch_vector<T, W, 2>(x, weight, bias, y, mean, rstd, rows, C, lanes, eps, sms, st);
    return launch_vector<T, W, MAX_VPL>(x, weight, bias, y, mean, rstd, rows, C, lanes, eps, sms,
                                        st);
  }
  static int per_sm = 0;
  const auto kernel = ff_layer_norm_rows_scalar<T, W>;
  const int grid = grid_for(kernel, per_sm, (rows + WARPS - 1) / WARPS, sms);
  kernel<<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), static_cast<const W*>(weight),
                                   static_cast<const W*>(bias), static_cast<T*>(y), mean, rstd,
                                   rows, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const void* x, const void* weight, const void* bias, void* y, float* mean,
             float* rstd, long long rows, int C, int w_bf16, int vec, float eps, int sms,
             cudaStream_t st) {
  if (w_bf16)
    return launch<T, __nv_bfloat16>(x, weight, bias, y, mean, rstd, rows, C, vec, eps, sms, st);
  return launch<T, float>(x, weight, bias, y, mean, rstd, rows, C, vec, eps, sms, st);
}

}  // namespace

// x, y: (rows, C) contiguous, bf16 if x_bf16 else f32; weight, bias: (C,)
// contiguous, bf16 if w_bf16 else f32; mean, rstd: (rows,) f32, or both
// null. vec: 1 for the 16-byte entry (C a whole number of 16-byte vectors,
// at most 128 of them, x and y 16-byte aligned), 0 for the scalar one. sms:
// the card's SM count. Returns the launch's cudaError_t.
extern "C" int ff_layer_norm(const void* x, const void* weight, const void* bias, void* y,
                             float* mean, float* rstd, long long rows, int C, float eps,
                             int x_bf16, int w_bf16, int vec, int sms, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || C < 1 || sms < 1 || (mean == nullptr) != (rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    const int width = x_bf16 ? 8 : 4;
    const auto aligned = [](const void* p) {
      return reinterpret_cast<unsigned long long>(p) % 16 == 0;
    };
    if (C % width != 0 || C / width > 32 * MAX_VPL || !aligned(x) || !aligned(y))
      return (int)cudaErrorInvalidValue;
  }
  if (x_bf16)
    return launch_w<__nv_bfloat16>(x, weight, bias, y, mean, rstd, rows, C, w_bf16, vec, eps,
                                   sms, st);
  return launch_w<float>(x, weight, bias, y, mean, rstd, rows, C, w_bf16, vec, eps, sms, st);
}
