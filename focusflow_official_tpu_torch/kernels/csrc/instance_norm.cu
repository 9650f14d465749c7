// Instance normalisation of NHWC activations (no affine, biased variance).
//
//   ff_in_stats:     mean[b, c] = E[x], inv[b, c] = rsqrt(max(E[x^2] - mean^2, 0) + eps)
//                    over the H*W positions of (b, c), summed in f32;
//   ff_in_normalize: y = (x - mean) * inv in x's type, optionally ReLU'd.
//
// Replaces the TPU kernels of `focusflow_official_tpu/kernels/instance_norm.py`:
// `_stats_kernel` (behind `instance_norm_stats` and `instance_norm_pallas`)
// and `_norm_kernel` (behind `instance_norm_pallas`). The TPU version walks
// H*W in order on one core and carries the sums in its output block from one
// grid step to the next. Blocks on Hopper run in no order, so the stats
// split H*W: S blocks per sample each reduce a slab of rows into a partial
// (B, S, 2, C) buffer.
//
// What bounds both: bytes. The stats read x once (and write 2*B*C floats);
// normalize reads x once and writes y once. At the fnet's shapes a stats
// call reads 3.6-28.8 MB, 1.1-8.6 us at 3.35 TB/s, so latency counts as
// much: enough loads in flight to cover the memory's, and no second launch.
//
// - `in_stats<T, VEC>` (VEC = 8 bf16 or 4 f32 a thread: C a multiple of
//   VEC, x 16-byte aligned; VEC = 1 otherwise): C/VEC threads cover a row
//   with 16-byte loads, neighbouring threads on neighbouring addresses, so a
//   256-thread block has 32 rows of C = 64 in flight, and each thread has
//   UNROLL loads in flight before it adds them in row order. A thread keeps
//   per-channel f32 sums of its vector; the block adds its threads' sums
//   through shared memory in a fixed order and writes its partial.
// - The finish is folded into the same launch: each block writes its
//   partial, fences, and takes a ticket from a per-sample counter; the block
//   that draws the last ticket adds the sample's S partials in index order
//   (so the bits do not depend on which block finished last), a thread a
//   value with FIN_BATCH loads in flight, writes mean and inv, and puts the
//   counter back to 0, so it is zero between launches (and stays valid
//   inside a CUDA graph). The counters are the wrapper's, allocated once
//   with zeros for each (device, stream): launches on one stream never
//   overlap, and two launches on two streams take two buffers, so running
//   ones never share a counter.
//
// At the fnet's two smaller shapes the launch itself and the finish, which
// waits for the last block, take longer than the bytes.
//
// In bf16 the normalize rounds after the subtraction and after the product,
// as PyTorch's elementwise ops do, so it equals the plain version bit for
// bit. Its grid is capped at 16 blocks an SM, from the card's SM count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                  // row loads a thread has in flight
constexpr int FIN_CHANNELS = THREADS / 2;  // channels a finish pass takes: s1 and s2, a thread each
constexpr int FIN_BATCH = 16;              // partial loads a finishing thread has in flight

// ld(0) + ld(1) + ... + ld(n - 1) added to acc in index order, N loads in
// flight before their adds (past n adds zeros)
template <int N, typename Load>
__device__ __forceinline__ float sum_in_order(Load ld, int n, float acc) {
  for (int i = 0; i < n; i += N) {
    float t[N];
#pragma unroll
    for (int u = 0; u < N; ++u) t[u] = i + u < n ? ld(i + u) : 0.0f;
#pragma unroll
    for (int u = 0; u < N; ++u) acc += t[u];
  }
  return acc;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// VEC values of one row at p -> f32: one 16-byte load for VEC * sizeof(T) == 16
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f(*p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "f32 vectors are float4");
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  } else {
    static_assert(VEC == 8, "bf16 vectors are 8 values");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the high half of an f32
      out[2 * k] = __uint_as_float(w[k] << 16);
      out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// grid (S, B): block (s, b) reduces rows [s*rows, (s+1)*rows) of sample b
// into partial[b, s] (the sums of x and of x^2); the last block of sample b
// to finish adds the S partials in index order and writes mean[b] and
// inv[b].
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
in_stats(const T* __restrict__ x, float* __restrict__ partial, float* __restrict__ mean,
         float* __restrict__ inv, unsigned* __restrict__ counters, int HW, int C, int rows,
         float eps) {
  __shared__ float sh[2 * THREADS * VEC];
  float* sh1 = sh;  // the threads' sums of x, then the finish's values
  float* sh2 = sh + THREADS * VEC;
  const int tid = threadIdx.x;
  const int S = gridDim.x, s = blockIdx.x, b = blockIdx.y;
  const int groups = C / VEC;  // vectors a row
  const int lanes = groups < THREADS ? groups : THREADS;
  const int rps = THREADS / lanes;  // rows in flight a step
  const int lane = tid % lanes, rsub = tid / lanes;
  const int r0 = s * rows;
  const int r1 = min(HW, r0 + rows);
  const T* xb = x + (long long)b * HW * C;
  float* pb = partial + (long long)(b * S + s) * 2 * C;

  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int g = g0 + lane;
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = 0.0f;
    if (rsub < rps && g < groups) {
      const T* xg = xb + g * VEC;
      for (int r = r0 + rsub; r < r1; r += UNROLL * rps) {
        float v[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (r + u * rps < r1) {
            load_vec<T, VEC>(xg + (long long)(r + u * rps) * C, v[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[u][e] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)  // in row order; a row past r1 adds zeros
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            s1[e] += v[u][e];
            s2[e] = fmaf(v[u][e], v[u][e], s2[e]);
          }
      }
      // slot (rsub, channel of this chunk)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sh1[rsub * lanes * VEC + lane * VEC + e] = s1[e];
        sh2[rsub * lanes * VEC + lane * VEC + e] = s2[e];
      }
    }
    __syncthreads();
    // the rps row groups of each channel added in order
    for (int cc = tid; cc < lanes * VEC; cc += THREADS) {
      const int c = g0 * VEC + cc;
      if (c < C) {
        const int stride = lanes * VEC;
        pb[c] = sum_in_order<8>([&](int j) { return sh1[j * stride + cc]; }, rps, 0.0f);
        pb[C + c] = sum_in_order<8>([&](int j) { return sh2[j * stride + cc]; }, rps, 0.0f);
      }
    }
    __syncthreads();
  }

  // this block's partial is out; the last block of the sample finishes
  __threadfence();
  __syncthreads();
  bool last = false;
  if (tid == 0) {
    last = atomicAdd(&counters[b], 1u) == (unsigned)(S - 1);
    __threadfence();
  }
  if (!__syncthreads_or(last)) return;

  // The finish, FIN_CHANNELS channels a pass: thread v sums value v (the
  // sum of x of channel c0 + v, or for v >= cn the sum of x^2 of channel
  // c0 + v - cn) over the S partials in index order, FIN_BATCH loads in
  // flight, from L2 (other SMs wrote them).
  const float* ps = partial + (long long)b * S * 2 * C;
  for (int c0 = 0; c0 < C; c0 += FIN_CHANNELS) {
    const int cn = min(FIN_CHANNELS, C - c0);
    float acc = 0.0f;
    if (tid < 2 * cn) {
      const float* pv = ps + (tid < cn ? c0 + tid : C + c0 + tid - cn);
      acc = sum_in_order<FIN_BATCH>(
          [&](int p) { return __ldcg(pv + (long long)p * 2 * C); }, S, 0.0f);
    }
    sh1[tid] = acc;
    __syncthreads();
    if (tid < cn) {
      const float m = sh1[tid] / (float)HW;
      const float var = fmaxf(sh1[cn + tid] / (float)HW - m * m, 0.0f);
      mean[b * C + c0 + tid] = m;
      inv[b * C + c0 + tid] = rsqrtf(var + eps);
    }
    __syncthreads();
  }
  if (tid == 0) counters[b] = 0u;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
normalize(const T* __restrict__ x, const float* __restrict__ mean, const float* __restrict__ inv,
          T* __restrict__ y, long long total, long long per_sample, int C, int relu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const int b = (int)(i / per_sample);
    const float m = round_to<T>(mean[b * C + c]);
    const float s = round_to<T>(inv[b * C + c]);
    float v = round_to<T>(to_f(x[i]) - m);
    v = v * s;
    if (relu) v = fmaxf(v, 0.0f);
    y[i] = from_f<T>(v);
  }
}

template <typename T, int VEC>
int launch_stats(const void* x, float* partial, float* mean, float* inv, unsigned* counters,
                 int B, int HW, int C, int S, float eps, cudaStream_t st) {
  const int rows = (HW + S - 1) / S;
  in_stats<T, VEC><<<dim3(S, B), THREADS, 0, st>>>(static_cast<const T*>(x), partial, mean,
                                                   inv, counters, HW, C, rows, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, HW, C) contiguous, bf16 if is_bf16 else f32; partial: (B, S, 2, C)
// f32 scratch; mean, inv: (B, C) f32; counters: B unsigned ints, all 0, left
// 0. vec: 1 for the 16-byte entry (C a multiple of 8 in bf16 or 4 in f32,
// x 16-byte aligned), 0 for scalar loads. Returns the launch's cudaError_t.
extern "C" int ff_in_stats(const void* x, float* partial, float* mean, float* inv,
                           unsigned* counters, int B, int HW, int C, int S, float eps,
                           int is_bf16, int vec, void* stream) {
  if (B == 0 || C == 0) return 0;
  if (S < 1 || HW < 1 || B > 65535 || S > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    const int width = is_bf16 ? 8 : 4;
    if (C % width != 0 || reinterpret_cast<unsigned long long>(x) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (is_bf16)
      return launch_stats<__nv_bfloat16, 8>(x, partial, mean, inv, counters, B, HW, C, S, eps,
                                            st);
    return launch_stats<float, 4>(x, partial, mean, inv, counters, B, HW, C, S, eps, st);
  }
  if (is_bf16)
    return launch_stats<__nv_bfloat16, 1>(x, partial, mean, inv, counters, B, HW, C, S, eps, st);
  return launch_stats<float, 1>(x, partial, mean, inv, counters, B, HW, C, S, eps, st);
}

// x, y: (B, HW, C) contiguous of one type; mean, inv: (B, C) f32; at most
// max_blocks blocks (the wrapper passes 16 an SM).
extern "C" int ff_in_normalize(const void* x, const float* mean, const float* inv, void* y, int B,
                               int HW, int C, int relu, int is_bf16, int max_blocks,
                               void* stream) {
  const long long per_sample = (long long)HW * C;
  const long long total = per_sample * B;
  if (total == 0) return 0;
  if (max_blocks < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    normalize<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), mean, inv, static_cast<__nv_bfloat16*>(y), total,
        per_sample, C, relu);
  else
    normalize<float><<<(unsigned)blocks, THREADS, 0, st>>>(static_cast<const float*>(x), mean,
                                                           inv, static_cast<float*>(y), total,
                                                           per_sample, C, relu);
  return (int)cudaGetLastError();
}
