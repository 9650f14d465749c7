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
// What bounds it: bytes on paper (at M = 7040, K = 324, N = 256 the product
// is 1.17 GFLOP against ~8 MB moved in bf16, well under the card's ~295
// FLOP/byte balance point; 0.0025 ms), latency and instruction count in
// fact: every block must bring its operands in before its first product,
// the phases of a block do not overlap, and the whole launch is one or two
// rounds of blocks. Two entries, chosen by type:
//
// - `fold_mma` (bf16; 1 <= K <= 896, the tiles that fit shared memory, else
//   the call is refused): the tensor-core entry. A block owns a square output tile and stages ALL of
//   K for its rows of `a` and its rows of `w` as bf16, in one pass behind
//   one barrier; then each warp runs an unbroken chain of
//   `mma.sync.m16n8k16` (bf16 in, f32 out) over its piece, its operands
//   read with `ldmatrix` (`w`, stored (n, k), is the B operand as it lies).
//   The tile is 128 x 128 (16 warps of 32 x 32) where that still gives
//   three quarters of the card's SMs a block, else 64 x 64 (8 warps of 32 x 16): the large tile
//   stages each value half as often and reads shared memory two thirds as
//   often per product. The trap is K = 81 and K = 324: rows are 162 and 648
//   bytes, so a row starts on a 2-byte boundary only and neither `cp.async`
//   nor `ldmatrix` can take it as it lies. But a tile's rows are one
//   contiguous span that starts on a 16-byte boundary (64 K values): it is
//   read flat and written at a padded row stride: K rounded up to a
//   multiple of 16, zeros in the padding, plus 8 values so that `ldmatrix`
//   meets no bank conflict. The pieces of the flat walk are 8 bytes where K
//   is a multiple of 4 (324: no piece crosses two rows, each is loaded and
//   stored whole), else (81) 4-byte pairs stored as two 2-byte values
//   (16-byte loads would scatter with four-way bank conflicts). The staging is instruction-bound, not
//   byte-bound: the wider piece is what K = 324 gains from. The output
//   tile leaves through shared memory as 16-byte row pieces where N is a
//   multiple of 8 (4-byte stores from the fragments fill half a sector an
//   instruction). bf16 x bf16 products are exact in f32, so the result
//   differs from the plain version by the order of the f32 sums only.
// - `fold_kernel` (f32, where TF32 would cost the 1e-4 agreement): 64x64
//   output tiles, 16-deep K slices staged as f32,
//   each of 256 threads accumulating a 4x4 sub-tile in registers with plain
//   FMA (`fold.cuh`, shared with `lookup_fold.cu`, which runs this product
//   on a window it keeps in shared memory; from f32 inputs the two agree bit
//   for bit, from bf16 inputs to one bf16 ulp: another order of sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fold.cuh"
#include "mma.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
fold_kernel(const float* __restrict__ a, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K) {
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
      As[kk][r] = (m < M && k < K) ? a[(long long)m * K + k] : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int n = n0 + r, k = k0 + kk;
      Ws[kk][r] = (n < N && k < K) ? w[(long long)n * K + k] : 0.0f;
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
      if (n < N) out[(long long)m * N + n] = fffold::biased<float>(acc[i][j], bias[n]);
    }
  }
}

using bf16 = __nv_bfloat16;
constexpr int MMA_MAX_SMEM = 227 * 1024;

// A tile shape of `fold_mma`: a square T x T output tile a block, WR x WC
// warps, each owning FM 16-row and FN 16-column pieces of it.
template <int T_, int WR_, int WC_>
struct Tile {
  static constexpr int T = T_, WR = WR_, WC = WC_;
  static constexpr int THREADS = 32 * WR * WC;
  static constexpr int FM = T / WR / 16, FN = T / WC / 16;
  static constexpr int OS = T + 8;  // row stride of the output tile in shared memory
  // shared row stride of the operand tiles, in values
  static int stride(int K) { return ((K + 15) & ~15) + 8; }
  // shared memory: the two operand tiles, then the output tile in their place
  static int smem(int K) {
    const int tiles = 2 * T * stride(K) * 2, otile = T * OS * 2;
    return tiles > otile ? tiles : otile;
  }
};
using Small = Tile<64, 2, 4>;   // 256 threads, warps of 32 x 16
using Large = Tile<128, 4, 4>;  // 512 threads, warps of 32 x 32

// The large tile stages each operand value half as often and reads shared
// memory two thirds as often per product; it pays where 128 x 128 tiles
// still give three quarters of the card's `sms` SMs a block.
inline bool use_large(int M, int N, int K, int sms) {
  return N >= 128 && Large::smem(K) <= MMA_MAX_SMEM &&
         4LL * ((M + 127) / 128) * ((N + 127) / 128) >= 3LL * sms;
}

// flat values f, f + 1 of a span of `valid` values from `src` (4-byte
// aligned, f even) as one register, zeros past the span
__device__ __forceinline__ uint32_t load_pair(const bf16* __restrict__ src, int f, int valid) {
  if (f + 1 < valid) return __ldg(reinterpret_cast<const uint32_t*>(src) + (f >> 1));
  if (f < valid) return __ldg(reinterpret_cast<const unsigned short*>(src) + f);  // odd length
  return 0u;
}

// the pair whose first value is (row, col) of a tile of K-value rows, into
// `dst` at a stride of KS values; its second value may open the next row
__device__ __forceinline__ void store_pair(unsigned short* __restrict__ dst, uint32_t v, int row,
                                           int col, int K, int KS) {
  unsigned short* d = dst + row * KS + col;
  d[0] = (unsigned short)(v & 0xffffu);
  if (col + 1 < K)
    d[1] = (unsigned short)(v >> 16);
  else
    dst[(row + 1) * KS] = (unsigned short)(v >> 16);
}

// Stage both tiles of `fold_mma`: As[r][c] = a[m0 + r][c] and Ws[r][c] =
// w[n0 + r][c] for c < K, zeros in rows past M and N (`avalid`, `wvalid`:
// the values of each tile's span that exist). A tile's rows are one span
// of T K values from a 16-byte boundary, walked flat in pieces; both tiles
// have the same shape, so one (row, column) walk serves both. The loads of
// U pieces of each tile go out before the first store, so a thread waits
// for device memory once per U pieces and not once per piece.
// WIDE (K a multiple of 4): pieces of 4 values, 8 bytes, each aligned in
// the span and in the padded row, none across two rows.
// Otherwise (rows may start on 2-byte boundaries only): 4-byte pairs of the
// span, stored as two 2-byte values (a warp reads 128 contiguous bytes, and
// its stores meet no bank conflict); a pair's second value may open the
// next row, and the last pair of an odd span is half outside it.
template <bool WIDE, typename TL>
__device__ __forceinline__ void stage_tiles(unsigned short* __restrict__ As,
                                            unsigned short* __restrict__ Ws,
                                            const bf16* __restrict__ asrc,
                                            const bf16* __restrict__ wsrc, int avalid,
                                            int wvalid, int K, int KS, int tid) {
  using P = typename std::conditional<WIDE, uint2, uint32_t>::type;
  constexpr int PV = WIDE ? 4 : 2;        // values a piece
  constexpr int U = WIDE ? 8 : 12;
  constexpr int STEP = PV * TL::THREADS;  // flat values a pass of the block
  const int total = TL::T * K;            // a multiple of 16
  const int dq = STEP / K, dr = STEP - dq * K;
  int row = (PV * tid) / K, col = PV * tid - row * K;
  for (int f = PV * tid; f < total; f += U * STEP) {
    P va[U], vw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ff = f + u * STEP;
      if constexpr (WIDE) {
        va[u] = ff < avalid ? __ldg(reinterpret_cast<const P*>(asrc + ff)) : P{};
        vw[u] = ff < wvalid ? __ldg(reinterpret_cast<const P*>(wsrc + ff)) : P{};
      } else {
        va[u] = load_pair(asrc, ff, avalid);
        vw[u] = load_pair(wsrc, ff, wvalid);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (f + u * STEP < total) {
        if constexpr (WIDE) {
          *reinterpret_cast<P*>(As + row * KS + col) = va[u];
          *reinterpret_cast<P*>(Ws + row * KS + col) = vw[u];
        } else {
          store_pair(As, va[u], row, col, K, KS);
          store_pair(Ws, vw[u], row, col, K, KS);
        }
      }
      row += dq;
      col += dr;
      if (col >= K) {
        col -= K;
        ++row;
      }
    }
  }
}

template <bool WIDE, typename TL>
__global__ void __launch_bounds__(TL::THREADS)
fold_mma(const bf16* __restrict__ a, const bf16* __restrict__ w, const bf16* __restrict__ bias,
         bf16* __restrict__ out, int M, int N, int K) {
  using namespace ffmma;
  constexpr int T = TL::T, FM = TL::FM, FN = TL::FN, OS = TL::OS;
  extern __shared__ __align__(16) unsigned short smem[];
  const int KS = ((K + 15) & ~15) + 8;
  unsigned short* As = smem;
  unsigned short* Ws = smem + T * KS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;

  stage_tiles<WIDE, TL>(As, Ws, a + (long long)m0 * K, w + (long long)n0 * K,
                     min(T, M - m0) * K, min(T, N - n0) * K, K, KS, tid);
  const int padk = KS - 8 - K;  // zeros up to the multiple of 16
  for (int e = tid; e < T * padk; e += TL::THREADS) {
    const int at = (e / padk) * KS + K + e % padk;
    As[at] = 0;
    Ws[at] = 0;
  }
  __syncthreads();

  // warp (wr, wc) owns FM 16-row pieces and 2 FN 8-column pieces of the tile
  const int wr = warp / TL::WC, wc = warp % TL::WC;
  float acc[FM][2 * FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2 * FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // ldmatrix row addresses of this lane. A, 16 rows x 16 k: matrices (rows
  // 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
  // = a0..a3. W, 16 columns x 16 k: (cols 0-7, k 0-7), (cols 0-7, k 8-15),
  // (cols 8-15, k 0-7), (cols 8-15, k 8-15) = b0, b1 of two column tiles.
  const unsigned short* ap =
      As + (wr * 16 * FM + (lane & 7) + ((lane >> 3) & 1) * 8) * KS + (lane >> 4) * 8;
  const unsigned short* wp =
      Ws + (wc * 16 * FN + (lane & 7) + (lane >> 4) * 8) * KS + ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < KS - 8; k0 += 16) {
    uint32_t af[FM][4], wf[FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i) ldmatrix_x4(af[i], ap + i * 16 * KS + k0);
#pragma unroll
    for (int j = 0; j < FN; ++j) ldmatrix_x4(wf[j], wp + j * 16 * KS + k0);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        mma_bf16(acc[i][2 * j], af[i], wf[j][0], wf[j][1]);
        mma_bf16(acc[i][2 * j + 1], af[i], wf[j][2], wf[j][3]);
      }
  }

  // this lane: rows g and g + 8 of each row piece, columns 2t and 2t + 1 of
  // each column piece
  const int g = lane >> 2, t = lane & 3;
  if (N % 8 == 0) {
    // rows of the output start on 16-byte boundaries: the tile leaves
    // through shared memory as 16-byte pieces, whole sectors a warp
    __syncthreads();  // every warp is done with As and Ws
    unsigned short* Os = smem;  // [T][OS]
#pragma unroll
    for (int j = 0; j < 2 * FN; ++j) {
      const int col = wc * 16 * FN + j * 8 + 2 * t;
      const bool in = n0 + col < N;  // then col + 1 too
      const float b0 = in ? ffconv::to_f(bias[n0 + col]) : 0.0f;
      const float b1 = in ? ffconv::to_f(bias[n0 + col + 1]) : 0.0f;
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wr * 16 * FM + i * 16 + g + 8 * half;
          *reinterpret_cast<uint32_t*>(Os + row * OS + col) =
              pack_bf16(acc[i][j][2 * half] + b0, acc[i][j][2 * half + 1] + b1);
        }
    }
    __syncthreads();
    for (int e = tid; e < T * (T / 8); e += TL::THREADS) {
      const int r = e / (T / 8), p = e % (T / 8);
      if (m0 + r < M && n0 + p * 8 < N)
        *reinterpret_cast<uint4*>(out + (long long)(m0 + r) * N + n0 + p * 8) =
            *reinterpret_cast<const uint4*>(Os + r * OS + p * 8);
    }
    return;
  }
  const bool pairs = (N & 1) == 0;  // then (m * N + n) is even: 4-byte stores
#pragma unroll
  for (int j = 0; j < 2 * FN; ++j) {
    const int n = n0 + wc * 16 * FN + j * 8 + 2 * t;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const float b0 = ffconv::to_f(bias[n]), b1 = two ? ffconv::to_f(bias[n + 1]) : 0.0f;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wr * 16 * FM + i * 16 + g + 8 * half;
        if (m >= M) continue;
        bf16* o = out + (long long)m * N + n;
        const float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
        if (two && pairs) {
          *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (two) o[1] = __float2bfloat16(v1);
        }
      }
  }
}

template <bool WIDE, typename TL>
int launch_tile(const bf16* a, const bf16* w, const bf16* bias, bf16* out, int M, int N, int K,
                cudaStream_t s) {
  const int smem = TL::smem(K);
  cudaError_t err = cudaFuncSetAttribute(fold_mma<WIDE, TL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + TL::T - 1) / TL::T, (N + TL::T - 1) / TL::T);
  fold_mma<WIDE, TL><<<grid, TL::THREADS, smem, s>>>(a, w, bias, out, M, N, K);
  return (int)cudaGetLastError();
}

template <bool WIDE>
int launch_mma(const bf16* a, const bf16* w, const bf16* bias, bf16* out, int M, int N, int K,
               cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (use_large(M, N, K, sms)) return launch_tile<WIDE, Large>(a, w, bias, out, M, N, K, s);
  return launch_tile<WIDE, Small>(a, w, bias, out, M, N, K, s);
}

}  // namespace

// a: (M, K), w: (N, K), bias: (N,), out: (M, N); all contiguous; all bf16 (a
// and w 16-byte aligned, 1 <= K and the 64-row tiles within shared memory,
// else cudaErrorInvalidValue) if is_bf16, else f32. Returns the launch's
// cudaError_t.
extern "C" int ff_fold(const void* a, const void* w, const void* bias, void* out, int M, int N,
                       int K, int is_bf16, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (K < 1 || Small::smem(K) > MMA_MAX_SMEM) return (int)cudaErrorInvalidValue;
    const bf16* ap = static_cast<const bf16*>(a);
    const bf16* wp = static_cast<const bf16*>(w);
    const bf16* bp = static_cast<const bf16*>(bias);
    bf16* op = static_cast<bf16*>(out);
    if (K % 4 == 0) return launch_mma<true>(ap, wp, bp, op, M, N, K, s);
    return launch_mma<false>(ap, wp, bp, op, M, N, K, s);
  }
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fold_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(w),
                                       static_cast<const float*>(bias),
                                       static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// Which kernel `ff_fold` runs on this type: 0 `fold_kernel` (f32 FMA tiles),
// 1 `fold_mma`.
extern "C" int ff_fold_entry(int is_bf16) { return is_bf16 ? 1 : 0; }
