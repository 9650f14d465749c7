// Instance normalisation of NHWC activations (no affine, biased variance).
//
//   ff_in_stats:     mean[b, c] = E[x], inv[b, c] = rsqrt(max(E[x^2] - mean^2, 0) + eps)
//                    over the H*W positions of (b, c), summed in f32;
//   ff_in_normalize: y = (x - mean) * inv in x's type, optionally ReLU'd;
//                    with a residual r (ResidualBlock's shortcut), relu(r + y).
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
// normalize reads x (and r) once and writes y once: 7.2-86.5 MB at the fnet's
// shapes, 2-26 us at 3.35 TB/s, so latency counts as much: enough loads in
// flight to cover the memory's, and no second launch.
//
// - Both kernels share one layout of the threads (VEC = 8 bf16 or 4 f32 a
//   thread: C a multiple of VEC, every pointer 16-byte aligned, the
//   `vector` entry; VEC = 1 otherwise, the `scalar` entry): C/VEC threads
//   cover a row with 16-byte accesses, neighbouring threads on
//   neighbouring addresses, and the block is a whole number of rows of
//   them (256 threads at C = 64 and 128 in bf16, 252 at C = 96), so each
//   thread keeps the same channels from row to row and has UNROLL rows'
//   loads in flight. Block (s, b) takes a slab of rows of sample b; the
//   grid's S slabs a sample come from the card's SM count.
// - `in_stats`: a thread keeps per-channel f32 sums of its vector; the block
//   adds its threads' sums through shared memory in a fixed order and
//   writes its partial. The finish is folded into the same launch: each
//   block writes its partial, fences, and takes a ticket from a per-sample
//   counter; the block that draws the last ticket adds the sample's S
//   partials in index order (so the bits do not depend on which block
//   finished last), a thread a value with FIN_BATCH loads in flight, writes
//   mean and inv, and puts the counter back to 0, so it is zero between
//   launches (and stays valid inside a CUDA graph). The counters are the
//   wrapper's, allocated once with zeros for each (device, stream):
//   launches on one stream never overlap, and two launches on two streams
//   take two buffers, so running ones never share a counter. At the fnet's
//   two smaller shapes the launch itself and the finish, which waits for
//   the last block, take longer than the bytes.
// - `normalize`: a thread loads its channels' mean and inv once, rounded to
//   x's type, so no element pays a `%` or a `/` (the first form took both
//   per element, with 2-byte accesses, at 3.4-5.4x its byte bound). With a
//   residual it reads r beside x and writes relu(r + y), which took two
//   more full passes of PyTorch's elementwise kernels (add, then ReLU) in
//   each instance-norm ResidualBlock. 8 blocks an SM.
//
// Numbers: in bf16 the normalize rounds after the subtraction, after the
// product and after the residual add, as PyTorch's elementwise ops do, so
// both forms equal the plain version bit for bit. In f32 the product and
// the add are `__fmul_rn` and `__fadd_rn`, which the compiler does not
// contract into one FMA, so there too each rounds as its own op.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                  // row loads a stats thread has in flight
constexpr int NORM_UNROLL = 4;             // rows a normalize thread has in flight
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

// VEC values of T as they lie in memory: one 16-byte piece, or one value
template <typename T, int VEC> struct Piece { using type = uint4; };
template <typename T> struct Piece<T, 1> { using type = T; };

template <typename T, int VEC>
__device__ __forceinline__ typename Piece<T, VEC>::type load_piece(const T* __restrict__ p) {
  if constexpr (VEC == 1)
    return *p;
  else
    return *reinterpret_cast<const uint4*>(p);
}

// a piece -> VEC f32 values
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename Piece<T, VEC>::type& w,
                                       float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f(w);
  } else {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
    if constexpr (sizeof(T) == 4) {
      static_assert(VEC == 4, "f32 pieces are 4 values");
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = __uint_as_float(u[k]);
    } else {
      static_assert(VEC == 8, "bf16 pieces are 8 values");
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // a bf16 is the high half of an f32
        out[2 * k] = __uint_as_float(u[k] << 16);
        out[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
      }
    }
  }
}

// VEC values of one row at p -> f32: one 16-byte load for VEC * sizeof(T) == 16
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  unpack<T, VEC>(load_piece<T, VEC>(p), out);
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

// VEC f32 values -> T at p: one 16-byte store for VEC * sizeof(T) == 16
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "f32 vectors are float4");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(VEC == 8, "bf16 vectors are 8 values");
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the lower address is the low half
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(v[2 * k]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// grid (S, B), blockDim.x = lanes * rps: block (s, b) normalizes rows
// [s*rows, (s+1)*rows) of sample b. Thread (rsub, lane) owns the channel
// vectors lane, lane + lanes, ... (one unless C / VEC > THREADS), loads
// their mean and inv once, rounded to T, and walks rows rsub, rsub + rps,
// ... with NORM_UNROLL rows' loads in flight, kept as loaded (16 bytes a
// row) until their turn. With RES it also reads r at the same place and
// writes relu(r + y) instead of y.
template <typename T, int VEC, bool RES>
__global__ void __launch_bounds__(THREADS)
normalize(const T* __restrict__ x, const float* __restrict__ mean, const float* __restrict__ inv,
          const T* __restrict__ res, T* __restrict__ y, int HW, int C, int rows, int relu) {
  using P = typename Piece<T, VEC>::type;
  const int groups = C / VEC;
  const int lanes = groups < THREADS ? groups : THREADS;
  const int rps = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, rsub = threadIdx.x / lanes;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(HW, r0 + rows);
  for (int g = lane; g < groups; g += lanes) {
    float m[VEC], s[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      m[e] = round_to<T>(mean[b * C + g * VEC + e]);
      s[e] = round_to<T>(inv[b * C + g * VEC + e]);
    }
    const long long col = (long long)b * HW * C + g * VEC;
    for (int r = r0 + rsub; r < r1; r += NORM_UNROLL * rps) {
      P xw[NORM_UNROLL], rw[NORM_UNROLL];
#pragma unroll
      for (int u = 0; u < NORM_UNROLL; ++u) {
        if (r + u * rps < r1) {
          const long long at = col + (long long)(r + u * rps) * C;
          xw[u] = load_piece<T, VEC>(x + at);
          if constexpr (RES) rw[u] = load_piece<T, VEC>(res + at);
        }
      }
#pragma unroll
      for (int u = 0; u < NORM_UNROLL; ++u) {
        if (r + u * rps < r1) {
          float v[VEC], rv[VEC];
          unpack<T, VEC>(xw[u], v);
          if constexpr (RES) unpack<T, VEC>(rw[u], rv);
          // PyTorch's rounding: T after the subtraction, the product and
          // the add. __fmul_rn and __fadd_rn keep f32's product and add
          // apart (no FMA), as the two elementwise ops are
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float t = __fmul_rn(round_to<T>(v[e] - m[e]), s[e]);
            if (relu) t = fmaxf(t, 0.0f);
            if constexpr (RES) t = fmaxf(__fadd_rn(rv[e], round_to<T>(t)), 0.0f);
            v[e] = t;
          }
          store_vec<T, VEC>(y + col + (long long)(r + u * rps) * C, v);
        }
      }
    }
  }
}

template <typename T, int VEC>
int launch_normalize(const void* x, const float* mean, const float* inv, const void* res,
                     void* y, int B, int HW, int C, int relu, int max_blocks, cudaStream_t st) {
  const int groups = C / VEC;
  const int lanes = groups < THREADS ? groups : THREADS;
  const int rps = THREADS / lanes;
  const int steps = (HW + rps * NORM_UNROLL - 1) / (rps * NORM_UNROLL);  // row steps a sample
  const int S = max(1, min(steps, (max_blocks + B - 1) / B));
  const int rows = (HW + S - 1) / S;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  T* yp = static_cast<T*>(y);
  const dim3 grid(S, B);
  if (res)
    normalize<T, VEC, true><<<grid, lanes * rps, 0, st>>>(xp, mean, inv, rp, yp, HW, C, rows,
                                                          relu);
  else
    normalize<T, VEC, false><<<grid, lanes * rps, 0, st>>>(xp, mean, inv, rp, yp, HW, C, rows,
                                                           relu);
  return (int)cudaGetLastError();
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

// x, y and res (null for the plain form): (B, HW, C) contiguous of one
// type; mean, inv: (B, C) f32. y = (x - mean) * inv in x's type, ReLU'd if
// relu; with res, y = relu(res + that). vec: 1 for the 16-byte entry (C a
// multiple of 8 in bf16 or 4 in f32; x, res and y 16-byte aligned), 0 for
// scalar loads. At most max_blocks blocks (the wrapper passes 8 an SM).
extern "C" int ff_in_normalize(const void* x, const float* mean, const float* inv,
                               const void* res, void* y, int B, int HW, int C, int relu,
                               int is_bf16, int vec, int max_blocks, void* stream) {
  if (B == 0 || HW == 0 || C == 0) return 0;
  if (B < 0 || HW < 0 || C < 0 || B > 65535 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    const int width = is_bf16 ? 8 : 4;
    const auto aligned = [](const void* p) {
      return reinterpret_cast<unsigned long long>(p) % 16 == 0;
    };
    if (C % width != 0 || !aligned(x) || !aligned(y) || (res && !aligned(res)))
      return (int)cudaErrorInvalidValue;
    if (is_bf16)
      return launch_normalize<__nv_bfloat16, 8>(x, mean, inv, res, y, B, HW, C, relu, max_blocks,
                                                st);
    return launch_normalize<float, 4>(x, mean, inv, res, y, B, HW, C, relu, max_blocks, st);
  }
  if (is_bf16)
    return launch_normalize<__nv_bfloat16, 1>(x, mean, inv, res, y, B, HW, C, relu, max_blocks,
                                              st);
  return launch_normalize<float, 1>(x, mean, inv, res, y, B, HW, C, relu, max_blocks, st);
}
