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
// What bounds it: bytes in principle (the patches read, the weight, and a
// (Q, O) output: about 4 MB at Q = 7040, O = 256 in bf16, against 1.17
// GFLOP); in fact the SM's load/store pipeline, which the gather's loads
// (2-byte values in 11 row runs a unit), its shared-memory traffic (about
// 30 accesses a warp per (query, level) unit) and the product's `ldmatrix`
// reads of the weight all pass through. Two entries,
// chosen by type; both take the window from `lookup.cuh`'s staged patches
// (a warp a (query, level) unit, the f32 arithmetic of A):
//
// - `lookup_fold_mma` (bf16): a persistent grid, one block an SM, of 16
//   gather warps and 8 product warps. Each block owns one slice of up to
//   256 output columns and a contiguous run of queries (runs differ by one
//   row at most: 53 or 54 at Q = 7040 on 132 SMs). The product warps stage
//   the block's slice of the weight ONCE, by `cp.async` in 8-byte pieces
//   where K is a multiple of 4 (rows of 648 bytes start on 8-byte
//   boundaries only), at the padded row stride of `fold.cu` (K rounded up
//   to 16, + 8: no `ldmatrix` bank conflict). The run is gathered in passes
//   of 16 rows, gather warp w taking row w and its levels one at a time:
//   it stores the level's patch, sends that level's loads for the next
//   pass into the registers just freed, and computes the window from the
//   stored patch, rounded to bf16 straight into the row of a window buffer
//   (the reference k order, zeros in the K padding). Two passes fill one of
//   two 32-row window pairs; the product warps multiply a full pair
//   (`mma.sync.m16n8k16`, both operands by `ldmatrix`, the weight the B
//   operand as it lies, f32 accumulators), each all 32 rows by 32 columns,
//   so a weight fragment read from shared memory serves two 16-row pieces,
//   and hand it back through named barriers while the gather fills the
//   other pair. The bias is added in f32 and the sum rounded once, stored
//   from the fragments. At K = 324 and N = 256: 176,128 bytes of weight,
//   44,032 of window pairs, 6,400 of patches and axis tables. The k chain
//   and the bias are those of `fold_mma`, so the result is that of A then B
//   in bf16 up to the order of the tensor cores' sums (in fact bit-equal on
//   the card).
// - `lookup_fold_fma` (f32): 32 queries a block; the window is written
//   k-major to shared memory as f32, then multiplied by the weight in
//   16-deep slices staged as f32, each of 512 threads holding a 4 x 4
//   register tile of the 32 x 256 output (`fold.cuh`). The k order equals
//   `fold.cu`'s FMA tiles, so the result equals A then B bit for bit.
//
// Which entry, grid and column slices a call runs is planned by the
// wrapper (`kernels/lookup_fold.py::plan`) from this file's layout
// (`ff_lookup_fold_rows`, `ff_lookup_fold_cols`) and passed in; this file
// checks it and says how much shared memory it takes (`ff_lookup_fold_smem`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fold.cuh"
#include "lookup.cuh"
#include "mma.cuh"

namespace {

using namespace fflookup;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 512, WARPS = THREADS / 32;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int PAIR = 2;  // units a warp stages at once

// ---- f32: FMA tiles

constexpr int BM = 32, BN = 256, BK = 16, TM = 4, TN = 4;

__host__ __device__ constexpr int k_padded(int K) { return (K + BK - 1) / BK * BK; }
// floats of shared memory: the window tile, k rounded up to whole slices,
// one weight slice and the warps' patches
__host__ __device__ constexpr int fma_smem_floats(int K) {
  return k_padded(K) * (BM + 1) + BK * (BN + 1) + WARPS * PAIR * (PATCH_STRIDE + 2 * TABLE_STRIDE);
}

template <int R>
__global__ void __launch_bounds__(THREADS)
lookup_fold_fma(const __grid_constant__ Levels lv, int num_levels,
                const float* __restrict__ coords, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out, long long nq, int N) {
  using G = Geometry<R>;
  extern __shared__ float smem[];
  const int K = num_levels * G::K2;
  const int Kp = k_padded(K);
  float(*As)[BM + 1] = reinterpret_cast<float(*)[BM + 1]>(smem);            // [Kp][BM + 1]
  float(*Ws)[BN + 1] = reinterpret_cast<float(*)[BN + 1]>(smem + Kp * (BM + 1));  // [BK][BN + 1]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* mine = smem + Kp * (BM + 1) + BK * (BN + 1) + warp * PAIR * PATCH_STRIDE;
  int2* mytab = reinterpret_cast<int2*>(smem + Kp * (BM + 1) + BK * (BN + 1) +
                                        WARPS * PAIR * PATCH_STRIDE) + warp * PAIR * TABLE_STRIDE;
  const Lanes<R> ln(lane);
  const long long m0 = (long long)blockIdx.x * BM;

  // zeros past nq and past K; the window's values overwrite the rest
  for (int e = tid; e < Kp * (BM + 1); e += THREADS) (&As[0][0])[e] = 0.0f;
  __syncthreads();
  // the windows of this block's queries: unit u = (level u / BM, row u % BM)
  const int units = BM * num_levels;
  for (int u0 = warp; u0 < units; u0 += WARPS * PAIR) {
    float v[PAIR][G::PSLOTS];
    Unit un[PAIR];
#pragma unroll
    for (int i = 0; i < PAIR; ++i) {
      const int u = u0 + WARPS * i;
      const long long bq = m0 + u % BM;
      if (u < units && bq < nq) {
        un[i] = make_unit<R>(coords[2 * bq], coords[2 * bq + 1], u / BM);
        load_patch<float, R>(v[i], lv, u / BM, bq, un[i], ln, lane);
        store_patch<float, R>(mine + i * PATCH_STRIDE, v[i], lane);
        axis_entry<R>(mytab + i * TABLE_STRIDE, un[i], lane);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PAIR; ++i) {
      const int u = u0 + WARPS * i, l = u / BM, r = u % BM;
      if (u >= units || m0 + r >= nq) continue;
      window_values<float, R>(mine + i * PATCH_STRIDE, mytab + i * TABLE_STRIDE, lane,
                              [&](int wi, float val) { As[l * G::K2 + wi][r] = val; });
    }
    __syncwarp();  // the patches are read before the next pair's land
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
        Ws[kk][r] = (n < N && kg < K) ? w[(long long)n * K + kg] : 0.0f;
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
        if (n < N) out[m * N + n] = fffold::biased<float>(acc[i][j], bias[n]);
      }
    }
  }
}

// ---- bf16: tensor cores, the weight resident, gather and product in
// warps of their own

constexpr int ROWS = 16;                  // query rows a gather pass: one a gather warp
constexpr int GW = ROWS;                  // gather warps
constexpr int MW = 8;                     // product warps, 32 columns each
constexpr int MMA_THREADS = 32 * (GW + MW);
constexpr int FM = 2;                     // passes a product round: 16-row pieces
constexpr int SLICE = 256;                // output columns a block owns
constexpr int MCOLS = SLICE / MW;         // 32
constexpr int NB = MCOLS / 16;            // ldmatrix x4 pieces of the weight a k step (2 n8 each)
// named barriers (0 is __syncthreads): window pair p full / empty, the
// product warps among themselves
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_MMA = 5;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__host__ __device__ constexpr int stride(int K) { return ((K + 15) & ~15) + 8; }

// rows of the resident weight slice: the widest slice, in whole warp columns
__host__ __device__ inline int weight_rows(int N) {
  const int n = N < SLICE ? N : SLICE;
  return (n + MCOLS - 1) / MCOLS * MCOLS;
}

// bytes: the weight slice and two window pairs of FM x ROWS rows at the
// padded stride; each gather warp's patch and axis table of one unit
__host__ __device__ inline int mma_smem(int K, int N) {
  return (weight_rows(N) + 2 * FM * ROWS) * stride(K) * 2 +
         GW * (PATCH_STRIDE * 2 + TABLE_STRIDE * (int)sizeof(int2));
}

// The weight slice into shared memory by `n` threads: Ws[r][c] = src[r * K
// + c] for r < ns, c < K; zeros in the K padding and in the rows past ns.
// `wide` (K a multiple of 4): 8-byte `cp.async` pieces, each aligned in the
// span and in the padded row, none across two rows (the caller waits).
__device__ __forceinline__ void stage_weight(bf16* __restrict__ Ws, const bf16* __restrict__ src,
                                             int ns, int K, int KS, int WRS, bool wide, int tid,
                                             int n) {
  for (int r = tid; r < WRS; r += n)
    for (int c = r < ns ? K : 0; c < KS; ++c) Ws[r * KS + c] = __float2bfloat16(0.0f);
  if (wide) {
    const int step = 4 * n;  // flat values a pass
    const int total = ns * K;
    const int dq = step / K, dr = step - dq * K;
    int row = (4 * tid) / K, col = 4 * tid - row * K;
    for (int f = 4 * tid; f < total; f += step) {
      ffmma::cp_async8(Ws + row * KS + col, src + f);
      row += dq;
      col += dr;
      if (col >= K) {
        col -= K;
        ++row;
      }
    }
  } else {
    for (int f = tid; f < ns * K; f += n) {
      const int row = f / K;
      Ws[row * KS + f - row * K] = src[f];
    }
  }
}

// A block owns column slice blockIdx.x / per_slice and a contiguous run of
// queries (the runs of a slice differ by one row at most), walked in passes
// of ROWS rows; FM passes make a round, written into one of two window
// pairs. Gather warp w takes row w of a pass and its levels one at a time:
// it stores the level's patch, sends that level's load for the next pass,
// and computes the window from the stored patch. Product warp m multiplies
// each full pair (FM x 16 rows, so that a weight fragment read from shared
// memory serves FM row pieces) by columns 32 m .. +32 of the weight slice
// and hands the pair back.
template <int R>
__global__ void __launch_bounds__(MMA_THREADS, 1)
lookup_fold_mma(const __grid_constant__ Levels lv, int num_levels,
                const float* __restrict__ coords, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, bf16* __restrict__ out, long long nq, int N,
                int per_slice) {
  using namespace ffmma;
  using G = Geometry<R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = num_levels * G::K2, KS = stride(K);
  const int WRS = weight_rows(N);
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);  // [WRS][KS]
  bf16* Wb = Ws + WRS * KS;                      // [2][FM * ROWS][KS]

  const int slice = blockIdx.x / per_slice;
  const long long part = blockIdx.x % per_slice;
  const int n0 = slice * SLICE, ns = min(SLICE, N - n0);
  const long long q0 = nq * part / per_slice, q1 = nq * (part + 1) / per_slice;
  const long long passes = (q1 - q0 + ROWS - 1) / ROWS;
  const long long rounds = (passes + FM - 1) / FM;

  if (warp < GW) {
    // ---- gather: pass s is rows q0 + s * ROWS .. + ROWS, rows (s % FM) *
    // ROWS .. of pair (s / FM) & 1
    bf16* patch = Wb + 2 * FM * ROWS * KS + warp * PATCH_STRIDE;
    int2* table = reinterpret_cast<int2*>(Wb + 2 * FM * ROWS * KS + GW * PATCH_STRIDE) +
                  warp * TABLE_STRIDE;
    const Lanes<R> ln(lane);
    bf16 v[4][G::PSLOTS];
    auto row_of = [&](long long s) { return q0 + s * ROWS + warp; };
    auto coord = [&](long long s) {
      const long long q = row_of(s);
      return s < passes && q < q1 ? __ldg(reinterpret_cast<const float2*>(coords) + q)
                                  : make_float2(0.0f, 0.0f);
    };
    float2 c = coord(0), cnext = coord(1);
    if (row_of(0) < q1) {
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (l < num_levels)
          load_patch<bf16, R>(v[l], lv, l, row_of(0), make_unit<R>(c.x, c.y, l), ln, lane);
    }
    for (long long s = 0; s < passes; ++s) {
      const long long t = s / FM;
      const int p = (int)(t & 1);
      const bool mine = row_of(s) < q1, next = s + 1 < passes && row_of(s + 1) < q1;
      bf16* dst = Wb + (p * FM * ROWS + (int)(s % FM) * ROWS + warp) * KS;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (l >= num_levels) break;
        if (mine) {
          store_patch<bf16, R>(patch, v[l], lane);
          axis_entry<R>(table, make_unit<R>(c.x, c.y, l), lane);
        }
        __syncwarp();
        if (next)  // level l of the next pass, into the registers just stored
          load_patch<bf16, R>(v[l], lv, l, row_of(s + 1), make_unit<R>(cnext.x, cnext.y, l), ln,
                              lane);
        if (l == 0 && s % FM == 0 && t >= 2)
          bar_sync(BAR_EMPTY + p, MMA_THREADS);  // the product is done with pair p
        if (mine)
          window_values<bf16, R>(patch, table, lane, [&](int wi, float val) {
            dst[l * G::K2 + wi] = __float2bfloat16(val);
          });
        __syncwarp();  // the patch is read before the next one lands
      }
      c = cnext;
      cnext = coord(s + 2);
      if (s % FM == FM - 1 || s == passes - 1) bar_arrive(BAR_FULL + p, MMA_THREADS);
    }
    return;
  }

  // ---- product: warp m owns columns 32 m .. +32 of the slice; the k chain
  // and the bias as `fold_mma`'s
  const int m = warp - GW, mtid = tid - GW * 32;
  stage_weight(Ws, w + (long long)n0 * K, ns, K, KS, WRS, K % 4 == 0, mtid, MW * 32);
  cp_async_commit();
  const int padk = KS - 8 - K;  // the window's zeros up to the multiple of 16
  for (int e = mtid; e < 2 * FM * ROWS * padk; e += MW * 32)
    Wb[(e / padk) * KS + K + e % padk] = __float2bfloat16(0.0f);
  cp_async_wait<0>();
  bar_sync(BAR_MMA, MW * 32);  // the weight and the padding are in place
  const int col0 = m * MCOLS;
  const bool active = col0 < ns;
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix row addresses (as `fold.cu::fold_mma`): A 16 rows x 16 k as
  // a0..a3; W 16 columns x 16 k as b0, b1 of two 8-column pieces
  const int aoff = ((lane & 7) + ((lane >> 3) & 1) * 8) * KS + (lane >> 4) * 8;
  const bf16* wp = Ws + (col0 + (lane & 7) + (lane >> 4) * 8) * KS + ((lane >> 3) & 1) * 8;
  const bool pairs = (N & 1) == 0;  // then (m * N + n) is even for even n: 4-byte stores
  for (long long t = 0; t < rounds; ++t) {
    const int p = (int)(t & 1);
    bar_sync(BAR_FULL + p, MMA_THREADS);
    float acc[FM][2 * NB][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    if (active) {
      const bf16* ap = Wb + p * FM * ROWS * KS + aoff;
      for (int k0 = 0; k0 < KS - 8; k0 += 16) {
        uint32_t af[FM][4], wf[NB][4];
#pragma unroll
        for (int i = 0; i < FM; ++i) ldmatrix_x4(af[i], ap + i * 16 * KS + k0);
#pragma unroll
        for (int j = 0; j < NB; ++j) ldmatrix_x4(wf[j], wp + j * 16 * KS + k0);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            mma_bf16(acc[i][2 * j], af[i], wf[j][0], wf[j][1]);
            mma_bf16(acc[i][2 * j + 1], af[i], wf[j][2], wf[j][3]);
          }
      }
    }
    if (t + 2 < rounds) bar_arrive(BAR_EMPTY + p, MMA_THREADS);  // pair p is read
    if (!active) continue;
    // bias in f32, one rounding, stored from the fragments: this lane has
    // rows g and g + 8 of each 16-row piece, columns 2 tq and 2 tq + 1 of
    // each 8-column piece
    const long long m0 = q0 + t * FM * ROWS;
#pragma unroll
    for (int j = 0; j < 2 * NB; ++j) {
      const int n = n0 + col0 + j * 8 + 2 * tq;
      if (n >= n0 + ns) continue;
      const bool two = n + 1 < n0 + ns;
      const float b0v = ffconv::to_f(bias[n]), b1v = two ? ffconv::to_f(bias[n + 1]) : 0.0f;
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long q = m0 + i * 16 + g + 8 * half;
          if (q >= q1) continue;
          bf16* o = out + q * N + n;
          const float v0 = acc[i][j][2 * half] + b0v, v1 = acc[i][j][2 * half + 1] + b1v;
          if (two && pairs) {
            *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (two) o[1] = __float2bfloat16(v1);
          }
        }
    }
  }
}

template <int R>
int launch_mma(const Levels& lv, int num_levels, const float* coords, const bf16* w,
               const bf16* bias, bf16* out, long long nq, int N, int K, int grid, int slices,
               cudaStream_t s) {
  const int smem = mma_smem(K, N);
  if (smem > MAX_SMEM || slices != (N + SLICE - 1) / SLICE || grid % slices != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lookup_fold_mma<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lookup_fold_mma<R><<<grid, MMA_THREADS, smem, s>>>(lv, num_levels, coords, w, bias, out, nq, N,
                                                     grid / slices);
  return (int)cudaGetLastError();
}

template <int R>
int launch_fma(const Levels& lv, int num_levels, const float* coords, const float* w,
               const float* bias, float* out, long long nq, int N, int K, cudaStream_t s) {
  const int bytes = fma_smem_floats(K) * (int)sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lookup_fold_fma<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (nq + BM - 1) / BM;
  lookup_fold_fma<R><<<(unsigned)blocks, THREADS, bytes, s>>>(lv, num_levels, coords, w, bias,
                                                               out, nq, N);
  return (int)cudaGetLastError();
}

}  // namespace

// levels: num_levels (<= 4) contiguous (B, Q, H_l, W_l) tensors; coords:
// (B*Q, 2) f32 level-0 (x, y), 8-byte aligned; w: (N, num_levels*(2r+1)^2),
// bias: (N,), out: (B*Q, N); radius 3 or 4. Levels, w, bias and out are
// all bf16 if is_bf16, else f32. bf16 runs the plan (`grid` blocks over
// `slices` = ceil(N / 256) column slices; w 16-byte aligned); f32 ignores it.
// Returns the launch's cudaError_t.
extern "C" int ff_lookup_fold(const void* c0, const void* c1, const void* c2, const void* c3,
                              int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                              int num_levels, const float* coords, const void* w,
                              const void* bias, void* out, long long nq, int radius, int N,
                              int is_bf16, int grid, int slices, void* stream) {
  if (num_levels < 1 || num_levels > 4) return (int)cudaErrorInvalidValue;
  if (nq == 0 || N == 0) return 0;
  Levels lv = {{c0, c1, c2, c3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int K = num_levels * (2 * radius + 1) * (2 * radius + 1);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return with_radius(radius, [&](auto rad) {
      return launch_fma<decltype(rad)::value>(lv, num_levels, coords,
                                              static_cast<const float*>(w),
                                              static_cast<const float*>(bias),
                                              static_cast<float*>(out), nq, N, K, s);
    });
  return with_radius(radius, [&](auto rad) {
    return launch_mma<decltype(rad)::value>(lv, num_levels, coords, static_cast<const bf16*>(w),
                                            static_cast<const bf16*>(bias),
                                            static_cast<bf16*>(out), nq, N, K, grid, slices, s);
  });
}

// The bf16 entry's layout: shared memory a launch takes at these sizes
// (bytes), query rows a gather pass, output columns a block owns.
extern "C" int ff_lookup_fold_smem(int K, int N) { return mma_smem(K, N); }
extern "C" int ff_lookup_fold_rows() { return ROWS; }
extern "C" int ff_lookup_fold_cols() { return SLICE; }
