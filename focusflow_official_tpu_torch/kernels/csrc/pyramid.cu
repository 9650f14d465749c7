// The correlation pyramid of one chunk of ALT_CORR's walk, levels 1..L-1 in
// one launch:
//
//   level l (R, H >> l, W >> l) = the 2x2 means of level l-1, l = 1..L-1,
//
// floor semantics at every level (the odd last row and column are dropped:
// 270 -> 135 -> 67 -> 33), level 0 being the R = B*n rows of the chunk's
// product, bf16 or f32. Every mean is taken in f32 from the f32 means one
// level finer and rounded once into the rows' type (round to nearest even,
// as `.to(bfloat16)` rounds). That is
// `ops/corr.py::corr_pyramid` to the bit: its `avg_pool2x2` is one CUDA
// `mean` over the four values of a 2x2 cell, which PyTorch's reduction
// takes as four threads' values (the identity 0 plus each value), summed
// by a shuffle tree that pairs each column's two values first, ((a00 +
// a10) + (a01 + a11)), then times the factor 1/4 (`mean4`; the card's
// `avg_pool2x2` matched this order on every cell of random maps, and
// each other order missed on a sixth to a quarter of them).
//
// Replaces no TPU kernel: the JAX package's ALT_CORR pools the chunk with
// XLA, which fuses the means. The port first ran `corr_pyramid` on the
// chunk: an f32 copy of the bf16 rows, three `avg_pool2x2` reductions (each
// after a copy where a level's height is odd) and a cast of each level,
// about 3.8 GB moved for a 2048-query chunk at 3840x2160, where 0.70 GB is
// needed; 88% of a 4K request.
//
// What bounds it: bytes. The rows are read once (2 bytes an element in
// bf16) and levels 1..L-1 written once (a third as many elements), with a
// few additions an element. The design:
//
// - A thread takes a patch of 2^k x 2^k level-0 cells (k = L-1 over most of
//   the map: 8 x 8 at four levels) and forms the patch's whole subtree in
//   registers: its 2^(k-1) x 2^(k-1) level-1 means, their means, ..., one
//   level-k mean. No f32 value reaches device memory.
// - In the `vector` entry a row of a patch is one aligned load (16 bytes:
//   8 bf16), and each level's rows of the patch are stored whole (8, 4 and
//   2 bytes at bf16); neighbouring threads take neighbouring patches of a
//   row, so a warp reads 512 contiguous bytes of each of 8 rows.
// - The floor leaves strips at the bottom and right of the map narrower
//   than a patch, where the finer levels still have cells (level-1 rows
//   132-134 and level-2 row 66 at 270 rows). The wrapper cuts the map into
//   regions (`kernels/pyramid.py::regions`): the main one of 2^k patches,
//   then bands of 2^j rows or columns, one for each set bit j >= 1 of
//   H mod 2^k and W mod 2^k, each tiled by the largest patches that fit
//   both its height and its width. Each level cell lies in one patch.
// - Work items run region by region, map by map within a region, patch
//   by patch along rows within a map, over a persistent grid sized from
//   the kernel's occupancy and the SM count.
// - Entry `vector` takes W a multiple of 2^(L-1) and a 16-byte aligned
//   input: every patch row and level row is then aligned to its own size.
//   Every other map takes `scalar`: element loads and stores, the same
//   arithmetic.
//
// The device name (`ff_pyramid_levels`) is none of the port's other kernels'
// and names no copy, so a profile files it with the elementwise work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 4;  // what kernel G looks up
constexpr int MAX_K = MAX_LEVELS - 1;
constexpr int MAX_REGIONS = MAX_K * MAX_K;  // row bands x column bands

struct Region {
  long long start;  // its first work item
  int n;            // patches a map
  int cols;         // patches a row
  int y0, x0;       // its first level-0 row and column
  int k;            // its patches are 2^k x 2^k
};

struct Plan {
  Region reg[MAX_REGIONS];
  int regions;
  int W;           // level-0 width
  long long hw;    // level-0 cells a map
};

template <typename T>
struct Levels {
  T* p[MAX_K];          // levels 1..L-1
  int w[MAX_K];         // their widths
  long long hw[MAX_K];  // their cells a map
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// PyTorch's CUDA mean of a 2x2 cell: the identity 0 added to each value
// (which only turns a -0 into +0, so the sum of four -0 is +0, as added
// here once), each column's pair summed, then their sum, times 1/4
__device__ __forceinline__ float mean4(float a00, float a01, float a10, float a11) {
  return (((a00 + a10) + (a01 + a11)) + 0.0f) * 0.25f;
}

// 32-bit words <-> f32 values: a word holds one f32 or two bf16, the one at
// the lower address in the low half
template <typename T>
__device__ __forceinline__ void unpack_word(unsigned u, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u);
  } else {
    v[0] = __uint_as_float(u << 16);
    v[1] = __uint_as_float(u & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ unsigned pack_word(const float* v) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v[0]);
  } else {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(v[0]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(v[1]));
    return lo | (hi << 16);
  }
}

// S contiguous values of T at p -> f32. VEC: p is aligned to the segment's
// bytes (at most 16), which are loaded in 16-, 8- or 4-byte words.
template <typename T, int S, bool VEC>
__device__ __forceinline__ void load_seg(const T* __restrict__ p, float (&v)[S]) {
  constexpr int BYTES = S * (int)sizeof(T);
  if constexpr (VEC && BYTES >= 4) {
    constexpr int PER = 4 / (int)sizeof(T);  // values a word
    unsigned u[BYTES / 4];
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int c = 0; c < BYTES / 16; ++c) {
        const uint4 q = reinterpret_cast<const uint4*>(p)[c];
        u[4 * c] = q.x;
        u[4 * c + 1] = q.y;
        u[4 * c + 2] = q.z;
        u[4 * c + 3] = q.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      u[0] = q.x;
      u[1] = q.y;
    } else {
      u[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) unpack_word<T>(u[i], &v[i * PER]);
  } else {
#pragma unroll
    for (int e = 0; e < S; ++e) v[e] = to_f(p[e]);
  }
}

// N f32 values -> N contiguous values of T at p, stored as load_seg loads
template <typename T, int N, bool VEC>
__device__ __forceinline__ void store_seg(T* __restrict__ p, const float (&v)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (VEC && BYTES >= 4) {
    constexpr int PER = 4 / (int)sizeof(T);
    unsigned u[BYTES / 4];
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) u[i] = pack_word<T>(&v[i * PER]);
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int c = 0; c < BYTES / 16; ++c)
        reinterpret_cast<uint4*>(p)[c] =
            make_uint4(u[4 * c], u[4 * c + 1], u[4 * c + 2], u[4 * c + 3]);
    } else if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = u[0];
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = from_f<T>(v[e]);
  }
}

// The 2x2 means of a patch's N x N f32 values of level LEVEL-1 -> its
// N/2 x N/2 cells of level LEVEL, stored at rows y.., columns x.. of the
// level in map r; then the levels above, while a level has more than one
// cell of the patch.
template <int N, int LEVEL, bool VEC, typename T>
__device__ __forceinline__ void pool(const float (&a)[N][N], const Levels<T>& out, long long r,
                                     int y, int x) {
  constexpr int M = N / 2;
  float m[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
      m[i][j] = mean4(a[2 * i][2 * j], a[2 * i][2 * j + 1], a[2 * i + 1][2 * j],
                      a[2 * i + 1][2 * j + 1]);
  const int w = out.w[LEVEL - 1];
  T* dst = out.p[LEVEL - 1] + r * out.hw[LEVEL - 1] + (long long)y * w + x;
#pragma unroll
  for (int i = 0; i < M; ++i) store_seg<T, M, VEC>(dst + (long long)i * w, m[i]);
  if constexpr (M > 1) pool<M, LEVEL + 1, VEC, T>(m, out, r, y >> 1, x >> 1);
}

// The patch of 2^K x 2^K level-0 cells at (y0, x0) of map r: every row
// loaded first (S loads in flight), then levels 1..K.
template <int K, bool VEC, typename T>
__device__ __forceinline__ void patch(const T* __restrict__ x, const Plan& plan,
                                      const Levels<T>& out, long long r, int y0, int x0) {
  constexpr int S = 1 << K;
  const T* src = x + r * plan.hw + (long long)y0 * plan.W + x0;
  float a[S][S];
#pragma unroll
  for (int y = 0; y < S; ++y) load_seg<T, S, VEC>(src + (long long)y * plan.W, a[y]);
  pool<S, 1, VEC, T>(a, out, r, y0 >> 1, x0 >> 1);
}

template <bool VEC, typename T>
__global__ void __launch_bounds__(THREADS)
ff_pyramid_levels(const T* __restrict__ x, const __grid_constant__ Levels<T> out,
                  const __grid_constant__ Plan plan, long long items) {
  const long long step = (long long)gridDim.x * THREADS;
  for (long long it = (long long)blockIdx.x * THREADS + threadIdx.x; it < items; it += step) {
    int g = 0;
    while (g + 1 < plan.regions && it >= plan.reg[g + 1].start) ++g;
    const Region& rg = plan.reg[g];
    const long long local = it - rg.start;
    const long long r = local / rg.n;
    const int e = (int)(local - r * rg.n);
    const int py = e / rg.cols;
    const int y0 = rg.y0 + (py << rg.k);
    const int x0 = rg.x0 + ((e - py * rg.cols) << rg.k);
    if (rg.k == 3)
      patch<3, VEC>(x, plan, out, r, y0, x0);
    else if (rg.k == 2)
      patch<2, VEC>(x, plan, out, r, y0, x0);
    else
      patch<1, VEC>(x, plan, out, r, y0, x0);
  }
}

template <bool VEC, typename T>
int launch(const void* x, void* const* lv, const Plan& plan, long long items, int H, int levels,
           int sms, cudaStream_t st) {
  static int per_sm = 0;  // the kernel's occupancy, asked once
  const auto kernel = ff_pyramid_levels<VEC, T>;
  if (per_sm == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0);
    per_sm = n > 0 ? n : 1;
  }
  Levels<T> out{};
  for (int l = 1; l < levels; ++l) {
    out.p[l - 1] = static_cast<T*>(lv[l - 1]);
    out.w[l - 1] = plan.W >> l;
    out.hw[l - 1] = (long long)(H >> l) * (plan.W >> l);
  }
  const long long blocks = (items + THREADS - 1) / THREADS;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(blocks < cap ? blocks : cap);
  kernel<<<grid, THREADS, 0, st>>>(static_cast<const T*>(x), out, plan, items);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

// x: (rows, H, W) contiguous, bf16 if bf16 else f32. l1..l3: levels 1..
// levels-1, each (rows, H >> l, W >> l) contiguous in x's type (null past
// levels-1). regions: n_regions x (y0, x0, patch rows, patch columns, k)
// as `kernels/pyramid.py::regions` cuts the map, whose patches must cover
// level 1 once. vec: 1 for the aligned entry (W a multiple of
// 2^(levels-1), every pointer 16-byte aligned), 0 for the scalar one. sms:
// the card's SM count. Returns the launch's cudaError_t.
extern "C" int ff_pyramid(const void* x, void* l1, void* l2, void* l3, long long rows, int H,
                          int W, int levels, const int* regions, int n_regions, int bf16,
                          int vec, int sms, void* stream) {
  const int k = levels - 1;
  if (levels < 2 || levels > MAX_LEVELS || H < 1 || W < 1 || (H >> k) < 1 || (W >> k) < 1 ||
      rows < 0 || n_regions < 1 || n_regions > MAX_REGIONS || sms < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  void* lv[MAX_K] = {l1, l2, l3};
  for (int l = 0; l < k; ++l)
    if (lv[l] == nullptr || (vec && !aligned16(lv[l]))) return (int)cudaErrorInvalidValue;
  if (vec && (W % (1 << k) != 0 || !aligned16(x))) return (int)cudaErrorInvalidValue;

  Plan plan{};
  plan.regions = n_regions;
  plan.W = W;
  plan.hw = (long long)H * W;
  long long start = 0, level1 = 0;
  for (int i = 0; i < n_regions; ++i) {
    const int* q = regions + 5 * i;
    const int y0 = q[0], x0 = q[1], prows = q[2], pcols = q[3], pk = q[4];
    if (pk < 1 || pk > k || prows < 1 || pcols < 1 || y0 < 0 || x0 < 0 ||
        y0 + ((long long)prows << pk) > H || x0 + ((long long)pcols << pk) > W)
      return (int)cudaErrorInvalidValue;
    Region& rg = plan.reg[i];
    rg.start = start;
    rg.n = prows * pcols;
    rg.cols = pcols;
    rg.y0 = y0;
    rg.x0 = x0;
    rg.k = pk;
    start += rows * rg.n;
    level1 += (long long)rg.n << (2 * (pk - 1));
  }
  if (level1 != (long long)(H >> 1) * (W >> 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (vec)
    return bf16 ? launch<true, bf>(x, lv, plan, start, H, levels, sms, st)
                : launch<true, float>(x, lv, plan, start, H, levels, sms, st);
  return bf16 ? launch<false, bf>(x, lv, plan, start, H, levels, sms, st)
              : launch<false, float>(x, lv, plan, start, H, levels, sms, st);
}
