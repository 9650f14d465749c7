// convc1 of the motion encoder as a tiled matrix product with bias:
//   out[m, n] = sum_k a[m, k] * w[n, k] + bias[n]     (f32 accumulation)
// a: (M, K) looked-up windows in the reference channel order, w: (N, K) the
// convc1 weight as PyTorch stores it (O, I), out: (M, N) in a's type.
//
// Replaces the TPU kernel `focusflow_official_tpu/kernels/fold.py`
// (`_kernel`, called from `fold_chunks_conv` / `fold_full_conv`). That
// kernel reads the lookup's per-level chunks with its weight rows permuted
// to the chunk order; here the lookup already emits the reference order, so
// the weight is used as it is stored.
//
// What bounds it: bytes. At M = 7040, K = 324, N = 256 the product is
// 1.17 GFLOP against ~8 MB moved in bf16, well under the card's ~295
// FLOP/byte balance point. Design: 64x64 output tiles, 16-deep K slices
// staged in shared memory as f32, each of 256 threads accumulating a 4x4
// sub-tile in registers with plain FMA (`fold.cuh`, shared with
// `lookup_fold.cu`, which runs this product on a window it keeps in shared
// memory). Tensor cores (mma.sync / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fold.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

using ffconv::to_f;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fold_kernel(const T* __restrict__ a, const T* __restrict__ w, const T* __restrict__ bias,
            T* __restrict__ out, int M, int N, int K) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // output columns tx + 16 j
  const int ty = tid / (BN / TN);  // output rows    ty + 16 i
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? to_f(a[(long long)m * K + k]) : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int n = n0 + r, k = k0 + kk;
      Ws[kk][r] = (n < N && k < K) ? to_f(w[(long long)n * K + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = Ws[kk][tx + 16 * j];
      fffold::fma_outer<TM, TN>(acc, av, wv);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(long long)m * N + n] = fffold::biased<T>(acc[i][j], bias[n]);
    }
  }
}

}  // namespace

// a: (M, K), w: (N, K), bias: (N,), out: (M, N); all contiguous, all bf16 if
// is_bf16 else f32. Returns the launch's cudaError_t.
extern "C" int ff_fold(const void* a, const void* w, const void* bias, void* out, int M, int N,
                       int K, int is_bf16, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    fold_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, N, K);
  else
    fold_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(a),
                                                static_cast<const float*>(w),
                                                static_cast<const float*>(bias),
                                                static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}
