// The correlation-pyramid window lookup and convc1 in one launch:
//
//   out[b, q, n] = sum_c window(b, q)[c] * w[n, c] + bias[n]
//
// where window(b, q) is the L*(2r+1)^2 bilinear window of `lookup.cu`
// (reference channel order, taps summed in f32), rounded to the compute
// type as the unfused path rounds it, and the product is accumulated in f32
// with the bias added in f32, as `fold.cu` does.
//
// Replaces the TPU kernel `focusflow_official_tpu/kernels/stage2.py`
// (`_kernel`, called from `stage2_fold`). That kernel finishes the TPU's
// matmul-form lookup: it takes the level-0 volume already contracted with
// the x tents, builds the y tents in VMEM, contracts, and applies the folded
// convc1 on the MXU, so the window never reaches HBM. The port's lookup
// gathers from the pooled pyramid instead, so there is no half-contracted
// input here; what carries over is the function (volume, coords, convc1)
// -> (B, Q, O) and the fact that the window stays on chip.
//
// What bounds it: bytes in principle (the taps read, the weight, and a
// (Q, O) output: about 4 MB at Q = 7040, O = 256 in bf16, against 1.17
// GFLOP), the f32 FMA units in this form. Design: a block of 512 threads
// takes 32 queries. It first writes their windows to shared memory, one
// value per thread step with consecutive threads on consecutive channels of
// one query (the gather pattern of `lookup.cu`), stored k-major. It then
// multiplies that 32 x K tile by the (O, K) weight in slices of 16 along k,
// staged through shared memory as f32, each thread holding a 4 x 4 register
// tile of the 32 x 256 output (`fold.cuh`). The k order equals
// `fold.cu`'s, so the result equals lookup-then-fold bit for bit. Tensor
// cores (wgmma on the window tile) and TMA for the weight are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fold.cuh"
#include "lookup.cuh"

namespace {

using ffconv::from_f;
using ffconv::to_f;
using fflookup::Levels;

constexpr int BM = 32, BN = 256, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 512
constexpr int MAX_SMEM = 227 * 1024;

// floats of shared memory: the window tile, k rounded up to whole slices,
// and one weight slice
__host__ __device__ constexpr int k_padded(int K) { return (K + BK - 1) / BK * BK; }
__host__ __device__ constexpr int smem_floats(int K) {
  return k_padded(K) * (BM + 1) + BK * (BN + 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lookup_fold_kernel(Levels lv, int num_levels, const float* __restrict__ coords,
                   const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ out,
                   long long nq, int radius, int N) {
  extern __shared__ float smem[];
  const int k = 2 * radius + 1;
  const int k2 = k * k;
  const int K = num_levels * k2;
  const int Kp = k_padded(K);
  float(*As)[BM + 1] = reinterpret_cast<float(*)[BM + 1]>(smem);            // [Kp][BM + 1]
  float(*Ws)[BN + 1] = reinterpret_cast<float(*)[BN + 1]>(smem + Kp * (BM + 1));  // [BK][BN + 1]

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;

  // the windows of this block's queries, rounded through T, zero past nq
  // and past K
  for (int e = tid; e < BM * Kp; e += THREADS) {
    const int r = e / Kp;
    const int c = e - r * Kp;
    const long long bq = m0 + r;
    float v = 0.0f;
    if (bq < nq && c < K) {
      const int l = c / k2;
      const int wi = c - l * k2;
      const int ix = wi / k;  // x-offset: slow axis (reference quirk)
      const int iy = wi - ix * k;
      v = to_f(from_f<T>(fflookup::window_value<T>(lv, coords, bq, l, ix, iy, radius)));
    }
    As[c][r] = v;
  }
  __syncthreads();

  const int tx = tid % (BN / TN);  // output columns tx + 64 j
  const int ty = tid / (BN / TN);  // output rows    ty + 8 i
  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int n = n0 + r, kg = k0 + kk;
        Ws[kk][r] = (n < N && kg < K) ? to_f(w[(long long)n * K + kg]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], wv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[k0 + kk][ty + (BM / TM) * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) wv[j] = Ws[kk][tx + (BN / TN) * j];
        fffold::fma_outer<TM, TN>(acc, av, wv);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + ty + (BM / TM) * i;
      if (m >= nq) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + (BN / TN) * j;
        if (n < N) out[m * N + n] = fffold::biased<T>(acc[i][j], bias[n]);
      }
    }
  }
}

template <typename T>
int launch(const Levels& lv, int num_levels, const float* coords, const void* w, const void* bias,
           void* out, long long nq, int radius, int N, int K, cudaStream_t s) {
  const int bytes = smem_floats(K) * (int)sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lookup_fold_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (nq + BM - 1) / BM;
  lookup_fold_kernel<T><<<(unsigned)blocks, THREADS, bytes, s>>>(
      lv, num_levels, coords, static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), nq, radius, N);
  return (int)cudaGetLastError();
}

}  // namespace

// levels: num_levels (<= 4) contiguous (B, Q, H_l, W_l) tensors; coords:
// (B*Q, 2) f32 level-0 (x, y); w: (N, num_levels*(2r+1)^2), bias: (N,),
// out: (B*Q, N). Levels, w, bias and out are all bf16 if is_bf16, else f32.
// Returns the launch's cudaError_t.
extern "C" int ff_lookup_fold(const void* c0, const void* c1, const void* c2, const void* c3,
                              int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                              int num_levels, const float* coords, const void* w,
                              const void* bias, void* out, long long nq, int radius, int N,
                              int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > 4 || radius < 0) return (int)cudaErrorInvalidValue;
  if (nq == 0 || N == 0) return 0;
  Levels lv = {{c0, c1, c2, c3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int k = 2 * radius + 1;
  const int K = num_levels * k * k;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(lv, num_levels, coords, w, bias, out, nq, radius, N, K, s);
  return launch<float>(lv, num_levels, coords, w, bias, out, nq, radius, N, K, s);
}
