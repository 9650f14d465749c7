// PWC-Net's local correlation (the 81-channel cost volume), NHWC:
//
//   out[b, y, x, (dy+r)(2r+1) + (dx+r)] = (1/C) sum_c f1[b, y, x, c]
//                                                 * f2[b, y+dy, x+dx, c]
//
// for dy, dx in [-r, r], zero outside f2, channels dy-major, f32
// accumulation, output in the inputs' type.
//
// Replaces the TPU kernel `focusflow_official_tpu/ops/pallas_local_corr.py`
// (`_kernel`, called from `_forward`). That kernel holds one whole batch
// element channels-leading in VMEM, reads an f2 that was zero-padded in HBM
// first, and gives up above 10 MB a batch element. None of that carries
// over: here a block takes an 8 x 8 tile of output pixels, any image size
// goes, and f2's border is a bounds check, not a padded copy.
//
// What bounds it: bytes. Each input is read once and the (2r+1)^2-wide
// output written once (at r = 4 the output is 81/C of an input: most of
// the traffic below C = 81); the (2r+1)^2 C products a pixel needs all
// reuse one halo of f2, which is what shared memory is for. Design: the
// block stages the f1 tile and the f2 halo tile (the tile plus r on each
// side) through shared memory as f32, 32 channels at a time; thread
// (pixel, dy) keeps the 2r+1 sums of its dx row in registers, reading f1
// once per channel and f2 along the halo row. Rows are padded to 33 floats
// so a warp's pixels fall in different banks. The sums leave through shared
// memory, so the stores are contiguous runs and not 2r+1 values a thread. Loads are 4 values wide where
// C is a multiple of 4 (8 bytes in bf16: a 196-channel pixel row is 392
// bytes, which 16-byte loads would straddle), scalar otherwise. The coarse
// PWC levels have too few pixels to fill the card with one tile a block
// (7 x 16 is two tiles), so there a block takes only some of the dy rows
// and the rest go to other blocks (each block then stages only the halo
// rows its dy rows touch); the launch works the split out from the number
// of tiles and the card's SM count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convert.cuh"

namespace {

using ffconv::from_f;
using ffconv::to_f;

constexpr int TH = 8, TW = 8, NPIX = TH * TW, CC = 32, MAX_R = 4;

// 4 contiguous values -> f32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the high half of an f32; the lower address is the low half
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Stage `npix` pixels x CC channels [c0, c0 + CC) into dst[npix][CC + 1],
// zero for a pixel outside the image and for a channel >= C. Pixel i is at
// (y0 + i / width, x0 + i % width) of the (H, W, C) image `src`.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(float (*dst)[CC + 1], const T* __restrict__ src, int npix,
                                      int width, int y0, int x0, int H, int W, int C, int c0,
                                      int tid, int nthreads) {
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
        v = to_f(src[((long long)y * W + x) * C + c0 + c]);
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
template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(block_threads(2 * R + 1))
local_corr_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out, int H,
                  int W, int C, int ndy, int groups) {
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

  const T* f1b = f1 + (long long)b * H * W * C;
  const T* f2b = f2 + (long long)b * H * W * C;
  const int halo_rows = TH + nd - 1;

  float acc[K];
#pragma unroll
  for (int dx = 0; dx < K; ++dx) acc[dx] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    stage<T, VEC>(f1s, f1b, NPIX, TW, ty0, tx0, H, W, C, c0, tid, nthreads);
    stage<T, VEC>(f2s, f2b, halo_rows * HW, HW, ty0 + dy0 - R, tx0 - R, H, W, C, c0, tid,
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
      out[(((long long)b * H + y) * W + x) * (K * K) + dy0 * K + j] = from_f<T>(os[e]);
  }
}

template <typename T, int R>
int launch_r(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
             cudaStream_t s) {
  constexpr int K = 2 * R + 1;
  const int gx = (W + TW - 1) / TW, gy = (H + TH - 1) / TH;
  // all dy rows in one block where the tiles alone give every SM a block;
  // else the dy rows are spread over as many blocks as that takes
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)gx * gy * B;
  const long long want = (sms + tiles - 1) / tiles;
  const int split = want < K ? (int)want : K;
  const int ndy = (K + split - 1) / split;
  const int groups = (K + ndy - 1) / ndy;
  if ((long long)B * groups > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(gx, gy, B * groups);
  const int threads = block_threads(ndy);
  // 4-wide loads need every pixel row to start on a 4-value boundary
  const size_t align = 4 * sizeof(T);
  const bool vec = C % 4 == 0 && reinterpret_cast<size_t>(f1) % align == 0 &&
                   reinterpret_cast<size_t>(f2) % align == 0;
  const T* a = static_cast<const T*>(f1);
  const T* b2 = static_cast<const T*>(f2);
  T* o = static_cast<T*>(out);
  if (vec)
    local_corr_kernel<T, R, true><<<grid, threads, 0, s>>>(a, b2, o, H, W, C, ndy, groups);
  else
    local_corr_kernel<T, R, false><<<grid, threads, 0, s>>>(a, b2, o, H, W, C, ndy, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int radius,
           cudaStream_t s) {
  switch (radius) {
    case 1: return launch_r<T, 1>(f1, f2, out, B, H, W, C, s);
    case 2: return launch_r<T, 2>(f1, f2, out, B, H, W, C, s);
    case 3: return launch_r<T, 3>(f1, f2, out, B, H, W, C, s);
    case 4: return launch_r<T, 4>(f1, f2, out, B, H, W, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// f1, f2: contiguous (B, H, W, C); out: contiguous (B, H, W, (2r+1)^2); all
// bf16 if is_bf16, else f32. radius in 1..4. Returns the launch's
// cudaError_t.
extern "C" int ff_local_corr(const void* f1, const void* f2, void* out, int B, int H, int W,
                             int C, int radius, int is_bf16, void* stream) {
  if (radius < 1 || radius > MAX_R || C < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(f1, f2, out, B, H, W, C, radius, s);
  return launch<float>(f1, f2, out, B, H, W, C, radius, s);
}
