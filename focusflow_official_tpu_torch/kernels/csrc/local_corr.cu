// PWC-Net's local correlation (the (2r+1)^2-channel cost volume), NHWC:
//
//   out[b, y, x, (dy+r)(2r+1) + (dx+r)] = (1/C) sum_c f1[b, y, x, c]
//                                                 * f2[b, y+dy, x+dx, c]
//
// for dy, dx in [-r, r], zero outside f2, channels dy-major, f32
// accumulation, output in the inputs' type; optionally a leaky ReLU on the
// rounded output (the PWC decoder's, in the same launch).
//
// Replaces the TPU kernel `focusflow_official_tpu/ops/pallas_local_corr.py`
// (`_kernel`, called from `_forward`). That kernel holds one whole batch
// element channels-leading in VMEM, reads an f2 that was zero-padded in HBM
// first, and gives up above 10 MB a batch element. None of that carries
// over: here a block takes a few rows of a 16-pixel segment, any image size
// goes, and f2's border is zero-filled as it is staged, not a padded copy.
//
// What bounds it on the card: bytes. Each input is read once and the
// (2r+1)^2-wide output written once (at r = 4 the output is 81/C of an
// input: most of the traffic below C = 81). The (2r+1)^2 C products of a
// pixel are no limit on the tensor cores, but on the f32 units they cost
// 2(2r+1) shared-memory loads per channel and pixel, which at the finest
// PWC level is four times the byte time; and the coarse levels have too few
// pixels to fill 132 SMs, so there the launch and the latency of one
// block's chain of loads and products set the time.
//
// - `local_corr_mma` (bf16, any C, radius 1-4): the products on the tensor
//   cores. For one output row, one 16-pixel segment and one dy, A is f1's
//   16 pixels x 16 channels and B is the f2 halo row of that dy (the
//   segment plus r on each side, staged 24 pixels wide: three n8 tiles), so
//   one k16 step is three `mma.sync.m16n8k16` (`mma.cuh`) into S (16 x 24,
//   f32); D's outputs are the band S[i][i + dx + r], 2r+1 of S's 24 columns.
//   bf16 products are exact in f32, so only the order of the f32 sum moves.
//   A block (`kernels/local_corr.py::plan`, which the launch takes as given)
//   stages `rows` rows of f1 and the rows + ndy - 1 halo rows of f2 that its
//   ndy dy rows touch, with `cp.async` (16-byte pieces where C is a multiple
//   of 8 and the maps are 16-byte aligned, 8-byte pieces for a multiple of 4,
//   plain loads otherwise), zero-filled outside the image and past C, in
//   bf16 with rows padded by 8 values so `ldmatrix` meets no bank conflict.
//   Up to C = 256 the channels are staged at once; beyond, in chunks through
//   a two-stage ring, the next in flight while one is multiplied. A warp
//   takes a run of (row, dy) pairs and one of `split` slices of the k16
//   steps (the coarse levels split channels so that every warp works); it
//   leaves each pair's band in shared memory as f32, in the output's order
//   through a bank swizzle; the slices are summed there in a fixed order
//   (the same bits on every launch), scaled by 1/C, rounded, and the block
//   writes each row's outputs as contiguous runs, 8 bytes a store. The plan
//   fills the card: fewer rows a block where segments are few, then the dy
//   rows spread over blocks. At the finest level a block's loads, its
//   products with their band stores (each warp a chain of ldmatrix, mma and
//   shared stores, in step with the block's other warps) and its output
//   stores run one after another, the products the longest; the coarse
//   levels sit near the launch's own cost.
// - `local_corr_kernel` (f32): the FMA form. 8 x 8 output pixels a block,
//   f1 and the f2 halo staged as f32 32 channels at a time, thread (pixel,
//   dy) keeping its dx row's sums in registers; where the tiles do not fill
//   the card, the dy rows spread over blocks (`ndy` a block, from the plan).
//
// The leaky ReLU rounds sum / C to the output type first, then takes
// x > 0 ? x : x * slope in f32 (`__fmul_rn`) and rounds again: bit-equal to
// the plain form followed by PyTorch's `F.leaky_relu`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convert.cuh"
#include "mma.cuh"

namespace {

using ffconv::from_f;
using ffconv::to_f;
using bf16 = __nv_bfloat16;

constexpr int MAX_R = 4;
constexpr int MAX_SMEM = 232448;

// the output's type after an optional leaky ReLU on the rounded value
template <typename T>
__device__ __forceinline__ T finish(float v, float slope, bool has_slope) {
  T o = from_f<T>(v);
  if (has_slope) {
    const float f = to_f(o);
    o = from_f<T>(f > 0.0f ? f : __fmul_rn(f, slope));
  }
  return o;
}

// ---------------------------------------------------------------- f32 FMA

constexpr int TH = 8, TW = 8, NPIX = TH * TW, CC = 32;

// 4 contiguous values -> f32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

// Stage `npix` pixels x CC channels [c0, c0 + CC) into dst[npix][CC + 1],
// zero for a pixel outside the image and for a channel >= C. Pixel i is at
// (y0 + i / width, x0 + i % width) of the (H, W, C) image `src`.
template <bool VEC>
__device__ __forceinline__ void stage_f32(float (*dst)[CC + 1], const float* __restrict__ src,
                                          int npix, int width, int y0, int x0, int H, int W,
                                          int C, int c0, int tid, int nthreads) {
  if (VEC) {
    for (int e = tid; e < npix * (CC / 4); e += nthreads) {
      const int i = e / (CC / 4), c = 4 * (e % (CC / 4));
      const int y = y0 + i / width, x = x0 + i % width;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (y >= 0 && y < H && x >= 0 && x < W && c0 + c < C)
        load4(src + ((long long)y * W + x) * C + c0 + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[i][c + j] = v[j];
    }
  } else {
    for (int e = tid; e < npix * CC; e += nthreads) {
      const int i = e / CC, c = e % CC;
      const int y = y0 + i / width, x = x0 + i % width;
      float v = 0.0f;
      if (y >= 0 && y < H && x >= 0 && x < W && c0 + c < C)
        v = src[((long long)y * W + x) * C + c0 + c];
      dst[i][c] = v;
    }
  }
}

constexpr int MIN_THREADS = 256;  // enough threads to stage the tiles quickly
__host__ __device__ constexpr int block_threads(int ndy) {
  return NPIX * ndy > MIN_THREADS ? NPIX * ndy : MIN_THREADS;
}

// grid: (tiles along x, tiles along y, B * groups); block: block_threads(ndy)
// threads, of which NPIX * ndy compute and all stage and store. Group g of a
// tile takes the displacement rows dy0 = g * ndy ... dy0 + ndy - 1.
template <int R, bool VEC>
__global__ void __launch_bounds__(block_threads(2 * R + 1))
local_corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                  float* __restrict__ out, int H, int W, int C, int ndy, int groups, float slope,
                  int has_slope) {
  constexpr int K = 2 * R + 1;
  constexpr int HW = TW + 2 * R;  // halo width
  __shared__ float f1s[NPIX][CC + 1];
  __shared__ float f2s[(TH + K - 1) * HW][CC + 1];
  static_assert((TH + K - 1) * HW * (CC + 1) >= NPIX * K * K,
                "f2's tile is reused for the block's outputs");

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.z / groups;
  const int dy0 = (blockIdx.z - b * groups) * ndy;
  const int nd = min(ndy, K - dy0);  // displacement rows of this block
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int dyl = tid / NPIX;
  const int p = tid - dyl * NPIX;
  const int py = p / TW, px = p - py * TW;

  const float* f1b = f1 + (long long)b * H * W * C;
  const float* f2b = f2 + (long long)b * H * W * C;
  const int halo_rows = TH + nd - 1;

  float acc[K];
#pragma unroll
  for (int dx = 0; dx < K; ++dx) acc[dx] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    stage_f32<VEC>(f1s, f1b, NPIX, TW, ty0, tx0, H, W, C, c0, tid, nthreads);
    stage_f32<VEC>(f2s, f2b, halo_rows * HW, HW, ty0 + dy0 - R, tx0 - R, H, W, C, c0, tid,
                   nthreads);
    __syncthreads();
    if (dyl < nd) {
      const float(*row)[CC + 1] = f2s + (py + dyl) * HW + px;
#pragma unroll 8
      for (int c = 0; c < CC; ++c) {
        const float a = f1s[p][c];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc[dx] = fmaf(a, row[dx][c], acc[dx]);
      }
    }
    __syncthreads();
  }

  // The sums go through shared memory (f2's tile is done with), so that
  // the stores walk each pixel's nd * K outputs in order: with all dy rows
  // in the block a tile row of 8 pixels is one contiguous run of 8 K^2
  // values, where a thread storing its own K values would touch a
  // different 32-byte sector with every store.
  float* os = &f2s[0][0];  // [NPIX][nd * K]
  const int run = nd * K;
  if (dyl < nd) {
    const float inv_c = 1.0f / (float)C;
#pragma unroll
    for (int dx = 0; dx < K; ++dx) os[p * run + dyl * K + dx] = acc[dx] * inv_c;
  }
  __syncthreads();
  for (int e = tid; e < NPIX * run; e += nthreads) {
    const int i = e / run, j = e - i * run;
    const int y = ty0 + i / TW, x = tx0 + i % TW;
    if (y < H && x < W)
      out[(((long long)b * H + y) * W + x) * (K * K) + dy0 * K + j] =
          finish<float>(os[e], slope, has_slope);
  }
}

template <int R>
int launch_fma(const float* f1, const float* f2, float* out, int B, int H, int W, int C, int ndy,
               float slope, int has_slope, cudaStream_t s) {
  constexpr int K = 2 * R + 1;
  if (ndy < 1 || ndy > K) return (int)cudaErrorInvalidValue;
  const int gx = (W + TW - 1) / TW, gy = (H + TH - 1) / TH;
  const int groups = (K + ndy - 1) / ndy;
  if ((long long)B * groups > 65535 || gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(gx, gy, B * groups);
  const int threads = block_threads(ndy);
  // 4-wide loads need every pixel row to start on a 16-byte boundary
  const bool vec = C % 4 == 0 && reinterpret_cast<size_t>(f1) % 16 == 0 &&
                   reinterpret_cast<size_t>(f2) % 16 == 0;
  if (vec)
    local_corr_kernel<R, true><<<grid, threads, 0, s>>>(f1, f2, out, H, W, C, ndy, groups, slope,
                                                        has_slope);
  else
    local_corr_kernel<R, false><<<grid, threads, 0, s>>>(f1, f2, out, H, W, C, ndy, groups,
                                                         slope, has_slope);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16 tensor cores

constexpr int SEG = 16;   // output pixels a segment: the rows of one m16 tile
constexpr int HALO = 24;  // f2 pixels staged a halo row: 16 + 2r <= 24, three n8 tiles
constexpr int PAD = 8;    // values added to a staged row
constexpr int MMA_WARPS = 8;  // the most warps a block

struct Plan {
  int rows;   // output rows a block
  int ndy;    // dy rows a block (divides 2r + 1)
  int split;  // slices of a chunk's k16 steps, one a warp task
  int warps;  // warps a block
  int chunk;  // channels staged at a time (a multiple of 16)
};

__host__ __device__ inline int padded_c(int C) { return (C + 15) / 16 * 16; }

// The band sums lie in the output's order, [split][rows][SEG][ndy K],
// with word w stored at swz(w): bit 3 flipped where bit 5 is set. A warp
// stores register (j, v) of every lane at once, at words 81 i + 2t + const
// (all dy rows; i = g + 8 (v / 2)), which without the swizzle fall into 8
// banks (up to 4 lanes a bank) and with it into 16 (at most 2); the swizzle
// keeps 4-word groups whole, so the epilogue reads each as one 16-byte load
// and 8 neighbouring groups still meet no conflict.
__host__ __device__ inline int swz(int w) { return w ^ (((w >> 5) & 1) << 3); }

// shared memory of a launch: f1's rows and f2's halo rows for each ring
// stage, then the f32 band sums [split][rows][SEG][ndy K]
inline long long mma_smem(int C, int R, const Plan& p) {
  const int K = 2 * R + 1;
  const int nchunks = (padded_c(C) + p.chunk - 1) / p.chunk;
  const long long stage =
      (long long)(p.rows * SEG + (p.rows + p.ndy - 1) * HALO) * (p.chunk + PAD) * sizeof(bf16);
  return (nchunks > 1 ? 2 : 1) * stage + (long long)p.split * p.rows * SEG * p.ndy * K * 4;
}

// grid: B * bands * segs * groups blocks (groups fastest, then segments,
// bands, batch), 32 * warps threads, mma_smem bytes. VEC: values a copy
// (8: 16 bytes, 4: 8 bytes, 1: plain loads).
template <int R, int VEC>
__global__ void __launch_bounds__(32 * MMA_WARPS)
local_corr_mma(const bf16* __restrict__ f1, const bf16* __restrict__ f2, bf16* __restrict__ out,
               int H, int W, int C, Plan p, int bands, int segs, int groups, float slope,
               int has_slope) {
  using namespace ffmma;
  constexpr int K = 2 * R + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = p.rows, nd = p.ndy, split = p.split, chunk = p.chunk;
  const int RS = chunk + PAD;  // staged row stride, in values
  const int hrows = rows + nd - 1;
  const int npix = rows * SEG + hrows * HALO;  // staged rows a stage
  const int stage_vals = npix * RS;
  const int cpad = padded_c(C);
  const int nchunks = (cpad + chunk - 1) / chunk;
  bf16* st = reinterpret_cast<bf16*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + (size_t)(nchunks > 1 ? 2 : 1) * stage_vals *
                                                       sizeof(bf16));

  int idx = blockIdx.x;
  const int grp = idx % groups;
  idx /= groups;
  const int seg = idx % segs;
  idx /= segs;
  const int band = idx % bands;
  const long long b = idx / bands;
  const int y0 = band * rows, x0 = seg * SEG, dy0 = grp * nd;  // dy0: index of -r..r
  const bf16* f1b = f1 + b * H * W * C;
  const bf16* f2b = f2 + b * H * W * C;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // chunk ch -> dst: staged row q < rows * SEG is f1's pixel (y0 + q / SEG,
  // x0 + q % SEG); the rest are f2's halo rows from y0 + dy0 - r, each HALO
  // pixels from x0 - r. Zero outside the image, past the halo and past C.
  auto copy = [&](bf16* dst, int q, int cv, int c0) {
    int y, x;
    const bf16* src;
    if (q < rows * SEG) {
      y = y0 + q / SEG, x = x0 + q % SEG, src = f1b;
    } else {
      const int h = q - rows * SEG, hx = h % HALO;
      y = y0 + dy0 - R + h / HALO, x = hx < SEG + 2 * R ? x0 - R + hx : -1, src = f2b;
    }
    const int c = c0 + cv;
    const bool ok = y >= 0 && y < H && x >= 0 && x < W && c < C;
    bf16* d = dst + q * RS + cv;
    const bf16* s = ok ? src + ((long long)y * W + x) * C + c : src;
    if constexpr (VEC == 8)
      cp_async16(d, s, ok ? 16 : 0);
    else if constexpr (VEC == 4)
      cp_async8(d, s, ok ? 8 : 0);
    else
      *d = ok ? *s : __ushort_as_bfloat16(0);
  };
  // thread tid copies piece tid % pieces of staged rows tid / pieces, then
  // every `step` rows on (one division a thread, not one a copy)
  const int pieces = chunk / VEC;
  const int step = nthreads / pieces;
  auto stage = [&](int ch, bf16* dst) {
    const int c0 = ch * chunk;
    if (step > 0) {
      if (tid < step * pieces)
        for (int q = tid / pieces; q < npix; q += step) copy(dst, q, (tid % pieces) * VEC, c0);
    } else {
      for (int e = tid; e < npix * pieces; e += nthreads)
        copy(dst, e / pieces, (e % pieces) * VEC, c0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warp w takes slice w % split of a run of pairs (pair = rr nd + dyl):
  // run w / split of nwarps / split runs, each of `per` pairs
  const int npairs = rows * nd, sl = warp % split, runs = nwarps / split;
  const int per = (npairs + runs - 1) / runs, p_begin = (warp / split) * per;
  const int p_end = min(npairs, p_begin + per);
  const int run = nd * K;  // a pixel's outputs in this block
  const int c = 2 * t - g, lane_base = g * (run - 1) + 2 * t, row8 = 8 * (run - 1);
  // ldmatrix row addresses of this lane, in values: A (16 pixels x 16
  // channels); B's halo pixels 0-15 as b0, b1 of two n8 tiles; pixels 16-23
  // as b0, b1 of the third (`mma.cuh`)
  const int a_off = (lane & 15) * RS + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
  const int b2_off = (16 + (lane & 7)) * RS + ((lane >> 3) & 1) * 8;

  stage(0, st);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      stage(ch + 1, st + ((ch + 1) & 1) * stage_vals);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* f1s = st + (ch & 1) * stage_vals;
    const bf16* f2s = f1s + rows * SEG * RS;
    const int kc = min(chunk, cpad - ch * chunk) / 16;  // k16 steps of this chunk
    int rr = p_begin / nd, dyl = p_begin - rr * nd;
    for (int pair = p_begin; pair < p_end; ++pair) {
      const bf16* ap = f1s + rr * SEG * RS + a_off;
      const bf16* bp = f2s + (rr + dyl) * HALO * RS;
      float acc[3][4] = {};
      for (int kk = sl; kk < kc; kk += split) {
        uint32_t a[4], bq[4], bt[2];
        ldmatrix_x4(a, ap + kk * 16);
        ldmatrix_x4(bq, bp + b_off + kk * 16);
        ldmatrix_x2(bt, bp + b2_off + kk * 16);
        mma_bf16(acc[0], a, bq[0], bq[1]);
        mma_bf16(acc[1], a, bq[2], bq[3]);
        mma_bf16(acc[2], a, bt[0], bt[1]);
      }
      // the band: register (j, v) holds S[i][n], i = g + 8 (v / 2), n = 8j +
      // 2t + v % 2; it is output dx index d = n - i = c + 8j + v % 2 - 8 (v
      // / 2) where that lies in [0, 2r], word i run + d of the pair's sums =
      // lane_base + 8j + v % 2 + (v / 2) row8
      const int base = ((sl * rows + rr) * SEG) * run + dyl * K + lane_base;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int dk = 8 * j + (v & 1) - 8 * (v >> 1);  // d - c
          if ((unsigned)(c + dk) < (unsigned)K) {
            float* o = red + swz(base + 8 * j + (v & 1) + (v >> 1) * row8);
            if (ch == 0)
              *o = acc[j][v];
            else
              *o += acc[j][v];
          }
        }
      if (++dyl == nd) dyl = 0, ++rr;
    }
    __syncthreads();  // the stage is free again; after the last, the sums are whole
  }

  // element e of the block's outputs (a row's SEG pixels of nd K each, in
  // the output's order): the slices' sums, scaled, rounded, finished
  const float inv_c = 1.0f / (float)C;
  const int slice = rows * SEG * run;
  auto sum = [&](int e) {
    float v = red[swz(e)];
    for (int s = 1; s < split; ++s) v += red[swz(s * slice + e)];
    return v;
  };
  auto value = [&](float v) { return finish<bf16>(__fmul_rn(v, inv_c), slope, has_slope); };
  if (nd == K && split == 1) {
    // all dy rows: a row's segment is SEG K^2 contiguous outputs, written
    // four at a time from one 16-byte load as 8-byte stores where they are
    // in the image and aligned (x0 is a multiple of 16: where W is a
    // multiple of 4 and the output 8-byte aligned)
    constexpr int KK = K * K, QUADS = SEG * KK / 4;  // 4-value groups a row
    for (int q = tid; q < rows * QUADS; q += nthreads) {
      const int rr = q / QUADS, at = 4 * (q - rr * QUADS);
      const int y = y0 + rr;
      if (y >= H) continue;
      const float4 v4 = *reinterpret_cast<const float4*>(red + swz(4 * q));
      const bf16 o4[4] = {value(v4.x), value(v4.y), value(v4.z), value(v4.w)};
      bf16* o = out + ((b * H + y) * W + x0) * KK + at;
      if (x0 + (at + 3) / KK < W && (reinterpret_cast<size_t>(o) & 7) == 0) {
        *reinterpret_cast<uint2*>(o) =
            make_uint2((uint32_t)__bfloat16_as_ushort(o4[0]) |
                           ((uint32_t)__bfloat16_as_ushort(o4[1]) << 16),
                       (uint32_t)__bfloat16_as_ushort(o4[2]) |
                           ((uint32_t)__bfloat16_as_ushort(o4[3]) << 16));
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (x0 + (at + u) / KK < W) o[u] = o4[u];
      }
    }
  } else {
    // some dy rows: a pixel's run of nd K outputs at a time; thread tid
    // takes element e = tid, + nthreads, ... = pixel pix, output j
    const int jump = nthreads / run, jrem = nthreads - jump * run;
    int pix = tid / run, j = tid - pix * run;
    for (int e = tid; e < slice; e += nthreads) {
      const int y = y0 + pix / SEG, x = x0 + pix % SEG;
      if (y < H && x < W) out[((b * H + y) * W + x) * (K * K) + dy0 * K + j] = value(sum(e));
      pix += jump, j += jrem;
      if (j >= run) j -= run, ++pix;
    }
  }
}

template <int R, int VEC>
int launch_mma_vec(const bf16* f1, const bf16* f2, bf16* out, int H, int W, int C, const Plan& p,
                   int grid, int bands, int segs, int groups, float slope, int has_slope,
                   cudaStream_t s) {
  const int smem = (int)mma_smem(C, R, p);
  cudaError_t err = cudaFuncSetAttribute(local_corr_mma<R, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  local_corr_mma<R, VEC><<<grid, 32 * p.warps, smem, s>>>(f1, f2, out, H, W, C, p, bands, segs,
                                                          groups, slope, has_slope);
  return (int)cudaGetLastError();
}

template <int R>
int launch_mma(const bf16* f1, const bf16* f2, bf16* out, int B, int H, int W, int C,
               const Plan& p, float slope, int has_slope, cudaStream_t s) {
  constexpr int K = 2 * R + 1;
  if (p.rows < 1 || p.ndy < 1 || K % p.ndy || p.split < 1 || p.warps < 1 || p.warps % p.split ||
      p.warps > MMA_WARPS || p.chunk < 16 || p.chunk % 16 || mma_smem(C, R, p) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int bands = (H + p.rows - 1) / p.rows, segs = (W + SEG - 1) / SEG, groups = K / p.ndy;
  const long long grid = (long long)B * bands * segs * groups;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // a copy's source must be aligned to its width: every pixel row, so C
  // too, and the maps' first values
  const size_t a = reinterpret_cast<size_t>(f1) | reinterpret_cast<size_t>(f2);
  if (C % 8 == 0 && a % 16 == 0)
    return launch_mma_vec<R, 8>(f1, f2, out, H, W, C, p, (int)grid, bands, segs, groups, slope,
                                has_slope, s);
  if (C % 4 == 0 && a % 8 == 0)
    return launch_mma_vec<R, 4>(f1, f2, out, H, W, C, p, (int)grid, bands, segs, groups, slope,
                                has_slope, s);
  return launch_mma_vec<R, 1>(f1, f2, out, H, W, C, p, (int)grid, bands, segs, groups, slope,
                              has_slope, s);
}

template <int R>
int launch_r(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int is_bf16,
             const Plan& p, float slope, int has_slope, cudaStream_t s) {
  if (is_bf16)
    return launch_mma<R>(static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
                         static_cast<bf16*>(out), B, H, W, C, p, slope, has_slope, s);
  return launch_fma<R>(static_cast<const float*>(f1), static_cast<const float*>(f2),
                       static_cast<float*>(out), B, H, W, C, p.ndy, slope, has_slope, s);
}

}  // namespace

// f1, f2: contiguous (B, H, W, C); out: contiguous (B, H, W, (2r+1)^2); all
// bf16 if is_bf16 (the tensor-core entry), else f32 (the FMA entry, which
// reads only ndy). radius in 1..4. The launch is the plan's
// (`kernels/local_corr.py::plan`): rows, ndy, split, warps, chunk. With
// has_slope, the output is leaky_relu(out, slope). Returns the launch's
// cudaError_t.
extern "C" int ff_local_corr(const void* f1, const void* f2, void* out, int B, int H, int W,
                             int C, int radius, int is_bf16, int rows, int ndy, int split,
                             int warps, int chunk, float slope, int has_slope, void* stream) {
  if (radius < 1 || radius > MAX_R || C < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Plan p{rows, ndy, split, warps, chunk};
  switch (radius) {
    case 1: return launch_r<1>(f1, f2, out, B, H, W, C, is_bf16, p, slope, has_slope, s);
    case 2: return launch_r<2>(f1, f2, out, B, H, W, C, is_bf16, p, slope, has_slope, s);
    case 3: return launch_r<3>(f1, f2, out, B, H, W, C, is_bf16, p, slope, has_slope, s);
    default: return launch_r<4>(f1, f2, out, B, H, W, C, is_bf16, p, slope, has_slope, s);
  }
}

// shared memory (bytes) of a bf16 launch with this plan, as built
extern "C" long long ff_local_corr_smem(int C, int radius, int rows, int ndy, int split,
                                        int chunk) {
  return mma_smem(C, radius, Plan{rows, ndy, split, 1, chunk});
}
