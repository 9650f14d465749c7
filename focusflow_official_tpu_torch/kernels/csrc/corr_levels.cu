// A chunk of ALT_CORR's walk in one launch: the chunk's rows of the
// correlation volume on the tensor cores and all its levels from their f32
// sums,
//
//   level 0 (B, n, H, W)       = bf16(f1[b, s + q] . f2[b, y, x]),  f32 sums,
//   level l (B, n, H>>l, W>>l) = bf16 of the 2x2 means, l = 1..L-1,
//
// each mean taken in f32 from the f32 means one level finer with floor
// semantics (the odd last row and column dropped: 270 -> 135 -> 67 -> 33),
// in the order ((a00 + a10) + (a01 + a11)) * 1/4, and rounded once to
// nearest even. f1 is the walk's scaled query operand (B, Q, C) and f2 the
// key map (B, H, W, C), both bf16 with C contiguous. Level 0 is never read
// back: the levels are `ops/corr.py::corr_pyramid` of the f32 product,
// which the plain version (`ops/corr.py::chunk_levels` on the CPU) computes.
//
// Replaces no TPU kernel: the JAX package's ALT_CORR leaves the chunk's
// product and its pooling to XLA. On the card the walk ran cuBLAS's product
// (writing bf16 level 0) and then the pyramid kernel (`pyramid.cu`), which
// read level 0 back to pool it: 403 GB of a 4K request's 1.07 TB moved only
// to be averaged.
//
// What bounds it: the stores. A 4K chunk (n = 2048 queries against a 270 x
// 480 map, C = 256) writes 530.8 MB of level 0 and 174 MB of levels 1-3 and
// reads fmap2's 66.4 MB once: 772 MB, 0.230 ms at 3.35 TB/s; its 136 GFLOP
// take 0.137 ms at the bf16 peak. Stores in a tile's pattern (64 bytes of
// each of 64 queries' maps) reach about 2.1 TB/s, contiguous ones 2.8 (a
// store-only kernel, H100 80GB HBM3). The design keeps the tensor cores
// and the stores busy together:
//
// - An output tile is 64 queries x one patch of 8 x 32 keys of the key map
//   (wgmma m64n256k16, A and B K-major from 128-byte swizzled shared
//   memory). A patch holds whole 8 x 8 cells, so levels 1-3 of its queries
//   pool inside the tile, in registers: a thread holds two adjacent keys
//   of every patch row for two queries, so level 1 is its own sums.
// - A block keeps its patch's keys (all C channels, 32 KB a 64-channel
//   slice) resident and walks its queries tile by tile: fmap2 leaves device
//   memory once a chunk; the chunk's f1 rows (1 MB at 4K) stream from L2
//   through a ring of 64-channel slices, loaded by TMA from one thread of a
//   producer warpgroup, which hands its registers to the consumers
//   (`setmaxnreg`). Tensor maps give the ragged edges: keys past the map and
//   channels past C load as zeros, and every level-l cell inside (H >> l,
//   W >> l) averages level-0 cells inside the map only, so any map size
//   and any C that is a multiple of 8 (at most 256) take one code path.
// - Two consumer warpgroups take the tiles in turn and issue their
//   products in that order, so one's products run while the other pools
//   and stores. Each row of level 0 goes through 512 bytes of the warp's
//   shared memory (one stmatrix, one 16-byte read a lane: a thread's key
//   pairs come back as 16 contiguous bytes), eight rows at a time; a
//   four-lane transpose gives each thread 4 contiguous cells of level 1,
//   which levels 2 and 3 pool in the thread. A tile inside the chunk and
//   the map stores unmasked; at the edges cells past the map or the chunk
//   are masked, and rows not aligned to a store's size take element stores.
// - A patch's levels 2 and 3 are 16 and 8 bytes of a query's rows, sharing
//   32-byte sectors with other blocks' patches; stored in place, a sector
//   that other blocks complete only after its eviction costs the memory a
//   read-modify-write (0.13 ms of a 4K chunk). They go whole into records
//   by patch and query instead, and a second kernel of the same launch
//   (`ff_corr_levels_coarse`) moves them into place, whole rows a warp.
// - A persistent grid of one block an SM walks units of (batch, patch,
//   group of query tiles), `kernels/corr_levels.py::plan`.
//
// The device names (`ff_corr_levels`, `ff_corr_levels_coarse`) are none of
// the port's other kernels' and name no copy, so a profile files them with
// the elementwise work, as it did the pyramid kernel that they replace on
// this path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_Q = 64;                  // queries a tile: wgmma's M
constexpr int PATCH_Y = 8, PATCH_X = 32;    // keys a patch: wgmma's N = 256
constexpr int KSLICE = 64;                  // channels a slice: one 128-byte swizzle row
constexpr int MAX_SLICES = 4;               // C <= 256
constexpr int STAGES = 8;                   // f1 slices in flight
constexpr int A_BYTES = TILE_Q * KSLICE * 2;              // 8 KB
constexpr int B_BYTES = PATCH_Y * PATCH_X * KSLICE * 2;   // 32 KB
constexpr int CONSUMERS = 2;                // warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;            // + the producer's warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;    // 128 x 40 + 256 x 232 <= 64K
constexpr int STAGING_BYTES = 4 * CONSUMERS * 4096;      // a consumer warp's 8 level-0 rows
constexpr int ACC = 128;                    // f32 sums a thread: 64 x 256 / 128
constexpr int MAX_LEVELS = 4;               // what kernel G looks up
constexpr int RECORD = 24;                  // a patch's levels 2 and 3 of a query, bf16 cells

struct Params {
  uint16_t* lv[MAX_LEVELS];  // levels 0..L-1, bf16 (null past L-1)
  int levels;
  int n, s;                  // the chunk's queries and its first
  int H, W;                  // the key map
  int slices;                // 64-channel slices: ceil(C / 64)
  int py, px;                // patches a map: rows, columns
  int batch;
  int tiles, per;            // query tiles in the chunk; a unit's
  int units;
  int vec0, vec1;            // level-0 rows 16-byte, level-1 rows 8-byte aligned
  int vec2, vec3;            // level-2 rows 16-byte, level-3 rows 8-byte aligned
  uint16_t* coarse;          // levels 2 and 3 by patch and query (`ff_corr_levels_coarse`)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma
//
// The accumulator of m64nNk16 (PTX ISA, "wgmma .m64nNk16 register
// fragment D"): thread t of the warpgroup, warp w = t / 32, lane l, holds
// d[4j + 2i + e] = D[16w + l/4 + 8i][8j + 2(l%4) + e], i, e in {0, 1}.
// Key column 8j + 2p + e of a patch is (y, x) = (j / 4, 8 (j % 4) + 2p + e).

// a K-major operand tile of 128-byte rows, 128-byte swizzled, 1024-byte
// aligned: 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 256, f32, the accumulator layout above) += a (64 x 16) * b (256 x 16)^T,
// both read from shared memory through their descriptors; d = a * b^T where
// `accumulate` is 0
__device__ __forceinline__ void mma_m64n256k16(float (&d)[ACC], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving reads or writes of the accumulator across
// this point: wgmma writes it asynchronously, behind the compiler's back,
// until `wgmma.wait_group`
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the epilogue

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float mean4(float a00, float a01, float a10, float a11) {
  return ((a00 + a10) + (a01 + a11)) * 0.25f;
}

// the four lanes of a quad (p = lane % 4) exchange values: v[g] of lane p
// becomes v[p] of lane g
template <typename T>
__device__ __forceinline__ void quad_transpose(T (&v)[4], int p) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (g & bit) continue;
      const bool hi = (p & bit) != 0;
      const T recv = __shfl_xor_sync(0xffffffffu, hi ? v[g] : v[g | bit], bit);
      if (hi)
        v[g] = recv;
      else
        v[g | bit] = recv;
    }
  }
}

// four 8 x 8 bf16 matrices from the accumulator's layout (lane l: row
// l/4, columns 2 (l%4), +1 of matrix j in w[j]) to the rows whose
// addresses lanes 8j .. 8j+7 give
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&w)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// bf16 values of a row from `dst` on, `room` of them inside the map: `v`
// packed two a word (the lower address in the low half), stored whole
// where `vec` says the row's start is aligned to their size
template <bool FULL>
__device__ __forceinline__ void store8(uint16_t* dst, uint4 v, int room, bool vec) {
  if (FULL || (vec && room >= 8)) {
    *reinterpret_cast<uint4*>(dst) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < room) dst[e] = (uint16_t)(w[e >> 1] >> (16 * (e & 1)));
}

template <bool FULL>
__device__ __forceinline__ void store4(uint16_t* dst, const float (&v)[4], int room, bool vec) {
  if (FULL || (vec && room >= 4)) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < room) dst[e] = bf16_bits(v[e]);
}

// The tile's levels from its f32 sums: queries t*64 + 16*warp + lane/4 +
// 8i of the chunk, keys of patch (py, px) of map b. A lane holds, for each
// patch row y and column group g (d[4(4y + g) + 2i + e]), keys 8g + 2p + e,
// p = lane % 4. Level 0 goes through the warp's 4 KB of shared memory
// (`stage`): one stmatrix a row puts its 32 keys of the warp's 8 queries in
// place and each lane reads back its 8 contiguous keys of each row. Level 1 is the
// lane's own 2 x 2 means (cell 4g + p), a four-lane transpose hands lane p
// cells 4p .. 4p+3, and levels 2 and 3 pool those in the lane, stored whole
// into the coarse buffer (`ff_corr_levels_coarse` puts them in place).
template <bool FULL>
__device__ __forceinline__ void epilogue(const float (&acc)[ACC], const Params& P, int b,
                                         int py, int px, int t, int warp, int lane,
                                         uint32_t stage) {
  const int p = lane & 3, r = lane >> 2;
  // the lane's place in levels 0 and 1: its first column, the patch's rows
  // and the lane's columns inside the map
  int rows[2], room[2];
  long long first[2];  // the lane's first cell in its query's map
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int hl = P.H >> l, wl = P.W >> l, y0 = (PATCH_Y * py) >> l;
    const int x0 = ((PATCH_X * px) >> l) + (8 >> l) * p;
    rows[l] = hl - y0;
    room[l] = wl - x0;
    first[l] = (long long)y0 * wl + x0;
  }
  // the stmatrix rows (lane l: row l % 8 of matrix l / 8) and the lane's
  // 16 bytes, 16-byte slots swizzled by row pairs against bank conflicts
  const int sr = lane & 7, sm = lane >> 3;
  const uint32_t put = stage + sr * 64 + (((sm ^ (sr >> 1)) & 3) << 4);
  const uint32_t get = stage + r * 64 + (((p ^ (r >> 1)) & 3) << 4);

  float l1[2][4][4];  // [i][y1][s]: level-1 cell 4p + s of patch row y1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = t * TILE_Q + 16 * warp + r + 8 * i;
    const bool qok = FULL || q < P.n;
    const long long map = (long long)b * P.n + q;  // the query's map in the chunk

    // level 0: 8 x 32 keys, each row through its 512 bytes of the staging
    uint4 v[PATCH_Y];
#pragma unroll
    for (int y = 0; y < PATCH_Y; ++y) {
      uint32_t w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int k = 4 * (4 * y + g) + 2 * i;
        w[g] = pack2(acc[k], acc[k + 1]);
      }
      stmatrix_x4(put + y * 512, w);
    }
    __syncwarp();
#pragma unroll
    for (int y = 0; y < PATCH_Y; ++y) v[y] = ld_shared16(get + y * 512);
    __syncwarp();  // every lane's reads done: the staging is free for the next rows
    uint16_t* dst0 = P.lv[0] + map * P.H * P.W + first[0];
#pragma unroll
    for (int y = 0; y < PATCH_Y; ++y)
      if (FULL || (qok && y < rows[0] && room[0] > 0))
        store8<FULL>(dst0 + y * P.W, v[y], room[0], P.vec0);
    if (P.levels < 2) continue;

    // level 1: 4 x 16 cells
    const int w1 = P.W >> 1;
    uint16_t* dst1 = P.lv[1] + map * (P.H >> 1) * w1 + first[1];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int top = 4 * (8 * y + g) + 2 * i, bot = top + 16;
        l1[i][y][g] = mean4(acc[top], acc[top + 1], acc[bot], acc[bot + 1]);
      }
      quad_transpose(l1[i][y], p);
      if (FULL || (qok && y < rows[1] && room[1] > 0))
        store4<FULL>(dst1 + y * w1, l1[i][y], room[1], P.vec1);
    }
    if (P.levels < 3) continue;

    // level 2: 2 x 8 cells, the lane's 2p and 2p + 1, into the query's
    // record of the patch: its rows at cells 0 and 8, level 3 at 16 + 2j
    uint16_t* record = P.coarse + ((((long long)b * P.py + py) * P.px + px) * P.n + q) * RECORD;
    float l2[2][2];
#pragma unroll
    for (int y = 0; y < 2; ++y) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
        l2[y][s] = mean4(l1[i][2 * y][2 * s], l1[i][2 * y][2 * s + 1], l1[i][2 * y + 1][2 * s],
                         l1[i][2 * y + 1][2 * s + 1]);
      if (qok) *reinterpret_cast<uint32_t*>(record + 8 * y + 2 * p) = pack2(l2[y][0], l2[y][1]);
    }

    // level 3: 1 x 4 cells, the lane's p (a zero beside it, and with three
    // levels in its place: the record's 48 bytes are written whole)
    const float v3 = mean4(l2[0][0], l2[0][1], l2[1][0], l2[1][1]);
    if (qok) *reinterpret_cast<uint32_t*>(record + 16 + 2 * p) = P.levels > 3 ? bf16_bits(v3) : 0;
  }
}

// Levels 2 and 3 from the coarse buffer into place. A patch's cells of
// levels 2 and 3 are 16 and 8 bytes of a query's row, so a block storing
// them in place would leave parts of 32-byte sectors to other blocks, which
// write them later: each such sector costs the memory a read-modify-write.
// The main kernel stores them whole into a 48-byte record of each patch
// and query (records of a patch's queries side by side), and this pass
// moves them into place: a block takes one patch row of 16 queries, reads
// their records patch by patch into shared memory and writes the queries'
// rows of both levels whole.
constexpr int FIX_Q = 16, FIX_PX = 16;  // queries, patches a pass of a block
constexpr int RECORD_CHUNKS = RECORD * 2 / 16;

__global__ void __launch_bounds__(256) ff_corr_levels_coarse(const Params P) {
  __shared__ uint4 rec[FIX_PX][FIX_Q][RECORD_CHUNKS];
  const int H2 = P.H >> 2, W2 = P.W >> 2, H3 = P.H >> 3, W3 = P.W >> 3;
  const int py = blockIdx.x, q0 = blockIdx.y * FIX_Q, b = blockIdx.z;
  const int nq = min(FIX_Q, P.n - q0);
  for (int x0 = 0; x0 < P.px; x0 += FIX_PX) {
    const int npx = min(FIX_PX, P.px - x0);
    __syncthreads();  // the last pass's reads of `rec` are done
    for (int c = threadIdx.x; c < npx * nq * RECORD_CHUNKS; c += 256) {
      const int x = c / (nq * RECORD_CHUNKS), rest = c - x * nq * RECORD_CHUNKS;
      const long long patch = ((long long)b * P.py + py) * P.px + x0 + x;
      rec[x][rest / RECORD_CHUNKS][rest % RECORD_CHUNKS] = __ldcs(
          reinterpret_cast<const uint4*>(P.coarse + (patch * P.n + q0) * RECORD) + rest);
    }
    __syncthreads();
    // level 2: rows 2py, 2py+1 of each query, a thread 8 cells (one patch)
    const int rows2 = min(2, H2 - 2 * py);
    for (int c = threadIdx.x; c < nq * 2 * npx; c += 256) {
      const int q = c / (2 * npx), y = c / npx % 2, x = c % npx, px = x0 + x;
      const int room = W2 - 8 * px;
      if (y >= rows2 || room <= 0) continue;
      const uint4 v = rec[x][q][y];
      uint16_t* dst =
          P.lv[2] + (((long long)b * P.n + q0 + q) * H2 + 2 * py + y) * W2 + 8 * px;
      if (P.vec2 && room >= 8) {
        __stcs(reinterpret_cast<uint4*>(dst), v);
        continue;
      }
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 8 && e < room; ++e)
        __stcs(dst + e, (uint16_t)(w[e >> 1] >> (16 * (e & 1))));
    }
    if (P.levels < 4 || py >= H3) continue;
    // level 3: row py of each query, a thread 4 cells (in the low halves)
    for (int c = threadIdx.x; c < nq * npx; c += 256) {
      const int q = c / npx, x = c % npx, px = x0 + x;
      const int room = W3 - 4 * px;
      if (room <= 0) continue;
      const uint4 v = rec[x][q][2];
      const uint16_t c3[4] = {(uint16_t)v.x, (uint16_t)v.y, (uint16_t)v.z, (uint16_t)v.w};
      uint16_t* dst = P.lv[3] + (((long long)b * P.n + q0 + q) * H3 + py) * W3 + 4 * px;
      if (P.vec3 && room >= 4) {
        __stcs(reinterpret_cast<uint2*>(dst),
               make_uint2(c3[0] | (uint32_t)c3[1] << 16, c3[2] | (uint32_t)c3[3] << 16));
        continue;
      }
      for (int e = 0; e < 4 && e < room; ++e) __stcs(dst + e, c3[e]);
    }
  }
}

struct Unit {
  int b, py, px, t0, t1;
};

// unit u -> (map, patch, query tiles); `kernels/corr_levels.py::unit`
__device__ __forceinline__ Unit unit_of(const Params& P, int u) {
  Unit o;
  o.px = u % P.px;
  u /= P.px;
  o.py = u % P.py;
  u /= P.py;
  o.b = u % P.batch;
  o.t0 = (u / P.batch) * P.per;
  o.t1 = min(o.t0 + P.per, P.tiles);
  return o;
}

// Shared memory, 1024-byte aligned: the patch's keys (slices x 32 KB), the
// ring of f1 slices (STAGES x 8 KB), each consumer warp's 4 KB of level-0
// staging, then the barriers: full and empty of each stage, full and empty
// of the keys, and each consumer warpgroup's turn at the tensor cores.
__global__ void __launch_bounds__(THREADS, 1)
    ff_corr_levels(const __grid_constant__ CUtensorMap f1_map,
                   const __grid_constant__ CUtensorMap f2_map, const Params P) {
  extern __shared__ unsigned char smem[];
  const uint32_t keys = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t ring = keys + P.slices * B_BYTES;
  const uint32_t staging = ring + STAGES * A_BYTES;
  const uint32_t bars = staging + STAGING_BYTES;
  const uint32_t keys_full = bars + 16 * STAGES, keys_empty = keys_full + 8;
  const uint32_t turn = keys_empty + 8;  // turn + 8 * wg
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(bars + 8 * s, 1);
      bar_init(bars + 8 * (STAGES + s), 4);  // a warp of the consumer
    }
    bar_init(keys_full, 1);
    bar_init(keys_empty, 4 * CONSUMERS);
    for (int w = 0; w < CONSUMERS; ++w) bar_init(turn + 8 * w, 4);  // the other's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 4 * CONSUMERS * 32) return;
    uint32_t seq = 0, round = 0;
    for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++round) {
      const Unit o = unit_of(P, u);
      bar_wait(keys_empty, (round & 1) ^ 1);
      bar_expect(keys_full, P.slices * B_BYTES);
      for (int k = 0; k < P.slices; ++k)
        load_4d(keys + k * B_BYTES, &f2_map, keys_full, k * KSLICE, o.px * PATCH_X,
                o.py * PATCH_Y, o.b);
      for (int t = o.t0; t < o.t1; ++t)
        for (int k = 0; k < P.slices; ++k, ++seq) {
          const uint32_t st = seq % STAGES;
          bar_wait(bars + 8 * (STAGES + st), ((seq / STAGES) & 1) ^ 1);
          bar_expect(bars + 8 * st, A_BYTES);
          load_3d(ring + st * A_BYTES, &f1_map, bars + 8 * st, k * KSLICE, P.s + t * TILE_Q,
                  o.b);
        }
    }
    return;
  }

  // The consumers take the block's tiles in turn, warpgroup 0 the even
  // ones, and issue their products in that order: each waits until the
  // other has issued its last tile's, so one's products run while the
  // other pools and stores.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4;
  const uint32_t stage = staging + warp * (STAGING_BYTES / (4 * CONSUMERS));
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
  uint32_t seq = 0, round = 0, tile = 0, mine = 0;
  for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++round) {
    const Unit o = unit_of(P, u);
    bar_wait(keys_full, round & 1);
    for (int t = o.t0; t < o.t1; ++t, ++tile) {
      if ((tile & 1) != (uint32_t)wg) {
        seq += P.slices;
        continue;
      }
      // warpgroup 0's m-th issue follows warpgroup 1's (m-1)-th, 1's m-th 0's m-th
      bar_wait(turn + 8 * wg, (mine & 1) ^ (wg == 0));
      ++mine;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int k = 0; k < P.slices; ++k) {
        const uint32_t st = (seq + k) % STAGES;
        bar_wait(bars + 8 * st, ((seq + k) / STAGES) & 1);
        const uint64_t da = desc(ring + st * A_BYTES), db = desc(keys + k * B_BYTES);
#pragma unroll
        for (int kk = 0; kk < KSLICE / 16; ++kk)  // 32 bytes of the swizzled row a step
          mma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, k | kk);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) bar_arrive(turn + 8 * (1 - wg));
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      __syncwarp();
      if (lane == 0)
        for (int k = 0; k < P.slices; ++k)
          bar_arrive(bars + 8 * (STAGES + (seq + k) % STAGES));
      seq += P.slices;
      // a tile inside the chunk and the map, with aligned rows, stores unmasked
      if ((t + 1) * TILE_Q <= P.n && (o.py + 1) * PATCH_Y <= P.H &&
          (o.px + 1) * PATCH_X <= P.W && P.vec0 && P.vec1)
        epilogue<true>(acc, P, o.b, o.py, o.px, t, warp % 4, lane, stage);
      else
        epilogue<false>(acc, P, o.b, o.py, o.px, t, warp % 4, lane, stage);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(keys_empty);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor of `rank` dims (innermost first, byte strides of dims
// 1..rank-1), read in boxes of `box`, 128-byte swizzled, zeros past its edges
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// f1: (batch, q_total, C) bf16, the walk's scaled queries; f2: (batch, H, W,
// C) bf16; both contiguous and 16-byte aligned, C a multiple of 8 up to 256.
// l0..l3: levels 0..levels-1 of queries s .. s+n-1, each (batch, n, H >> l,
// W >> l) bf16 contiguous (null past levels-1). coarse: with three levels or
// more, bf16 scratch of coarse_cells, at least batch x py x px x n x 24 cells,
// py and px the patch rows and columns (refused if smaller). per: query tiles
// (of 64) a unit, grid: blocks, both from `kernels/corr_levels.py::plan`.
// Returns the launches' cudaError_t.
extern "C" int ff_corr_levels_launch(const void* f1, const void* f2, void* l0, void* l1, void* l2,
                                     void* l3, void* coarse, long long coarse_cells, int batch,
                                     int q_total, int s, int n, int H, int W, int C, int levels,
                                     int per, int grid, void* stream) {
  const int k = levels - 1;
  if (batch < 1 || n < 1 || s < 0 || (long long)s + n > q_total || C < 8 || C % 8 != 0 ||
      C > KSLICE * MAX_SLICES || levels < 1 || levels > MAX_LEVELS || H < 1 || W < 1 ||
      (H >> k) < 1 || (W >> k) < 1 || per < 1 || grid < 1 || !aligned(f1, 16) || !aligned(f2, 16))
    return (int)cudaErrorInvalidValue;
  void* lv[MAX_LEVELS] = {l0, l1, l2, l3};
  Params P{};
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (l < levels && (lv[l] == nullptr || !aligned(lv[l], 2))) return (int)cudaErrorInvalidValue;
    P.lv[l] = l < levels ? static_cast<uint16_t*>(lv[l]) : nullptr;
  }
  P.levels = levels;
  P.n = n;
  P.s = s;
  P.H = H;
  P.W = W;
  P.slices = (C + KSLICE - 1) / KSLICE;
  P.py = (H + PATCH_Y - 1) / PATCH_Y;
  P.px = (W + PATCH_X - 1) / PATCH_X;
  P.batch = batch;
  P.tiles = (n + TILE_Q - 1) / TILE_Q;
  P.per = per;
  const long long units = (long long)(P.tiles + per - 1) / per * batch * P.py * P.px;
  const long long records = (long long)batch * P.py * P.px * n;
  if (units > 0x7fffffff || (levels > 2 && (coarse == nullptr || !aligned(coarse, 16) ||
                                            coarse_cells < records * RECORD)))
    return (int)cudaErrorInvalidValue;
  P.units = (int)units;
  P.vec0 = W % 8 == 0 && aligned(l0, 16);
  P.vec1 = levels > 1 && (W >> 1) % 4 == 0 && aligned(l1, 8);
  P.vec2 = levels > 2 && (W >> 2) % 8 == 0 && aligned(l2, 16);
  P.vec3 = levels > 3 && (W >> 3) % 4 == 0 && aligned(l3, 8);
  P.coarse = static_cast<uint16_t*>(coarse);

  CUtensorMap f1_map, f2_map;
  const cuuint64_t e = 2;  // bytes a value
  const cuuint64_t d1[3] = {(cuuint64_t)C, (cuuint64_t)q_total, (cuuint64_t)batch};
  const cuuint64_t s1[2] = {C * e, (cuuint64_t)q_total * C * e};
  const cuuint32_t b1[3] = {KSLICE, TILE_Q, 1};
  const cuuint64_t d2[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)batch};
  const cuuint64_t s2[3] = {C * e, (cuuint64_t)W * C * e, (cuuint64_t)H * W * C * e};
  const cuuint32_t b2[4] = {KSLICE, PATCH_X, PATCH_Y, 1};
  if (!encode(&f1_map, f1, 3, d1, s1, b1) || !encode(&f2_map, f2, 4, d2, s2, b2))
    return (int)cudaErrorInvalidValue;

  const int bars = 8 * (2 * STAGES + 2 + CONSUMERS);
  const int smem = P.slices * B_BYTES + STAGES * A_BYTES + STAGING_BYTES + bars + 1024;
  static bool sized = false;
  if (!sized) {
    const int most = MAX_SLICES * B_BYTES + STAGES * A_BYTES + STAGING_BYTES + bars + 1024;
    const cudaError_t err =
        cudaFuncSetAttribute(ff_corr_levels, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int blocks = grid < P.units ? grid : P.units;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ff_corr_levels<<<blocks, THREADS, smem, st>>>(f1_map, f2_map, P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || levels < 3) return (int)err;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 fix(P.py, (n + FIX_Q - 1) / FIX_Q, batch);
  ff_corr_levels_coarse<<<fix, 256, 0, st>>>(P);
  return (int)cudaGetLastError();
}
