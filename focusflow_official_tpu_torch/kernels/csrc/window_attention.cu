// 7x7-window multi-head attention on natural-layout grids:
//   q, k, v, out (B, Hp, Wp, H*D), Hp and Wp multiples of 7; each query
//   attends to the 49 keys of its own 7x7 window, per head, softmax in f32.
//
// Replaces the TPU kernel `focusflow_official_tpu/kernels/window_attention.py`
// (`_kernel`, called through `window_attention`). That kernel loads whole
// window ROWS (7 x Wp x C slabs) into VMEM and issues every window's and
// head's 49x49 dots on the MXU in sequence. Here the grid is flat and reads
// each window straight out of the natural layout, writing its outputs back
// in place: nothing is partitioned or merged in device memory.
//
// What bounds it on the card: bytes (q, k, v read once, out written once;
// 59 MB at the Twins stage-1 shape, 0.018 ms). The products are small (two
// 49x49xD products a window and head) and one exponential a score comes to
// a sixth of the byte time. So the design is about moving the window's rows
// in wide pieces and keeping many windows in flight.
//
// - `window_mma` (bf16, head widths 16 or 32: every shape of the FlowFormer
//   path): one block per (window, group of heads), one warp per head. A
//   group is the most heads whose columns fit 64 values (128 bytes a pixel),
//   so a block holds 27 KB of shared memory and eight blocks fit an SM (a
//   one-off timing of twice and half as many heads a block was no faster;
//   PERF.md). The block stages the group's columns of the window's 49 pixels of q, k and
//   v with `cp.async` in 16-byte pieces, neighbouring threads on neighbouring
//   addresses (a pixel's group slice is one contiguous run); rows 49-63 are
//   written as zeros (P is 0 there, but 0 * NaN = NaN). Rows are padded by
//   8 values (16 bytes), so `ldmatrix` meets no bank conflict. A warp takes
//   its head's 64 (padded) query rows as four m16 tiles, one after the
//   other: S = Q.K^T over 56 keys (seven n8 tiles, one or two k16 steps),
//   keys 49-55 set to -inf, the row max and sum by quad shuffles, P =
//   2^(s * scale * log2 e - max) by `ex2` of one FMA, rounded to bf16 as
//   the A operand of O = P.V (four k16 steps over 64 keys, V through
//   `ldmatrix.trans`), all through `mma.sync.m16n8k16` (`mma.cuh`). A row
//   has 49 scores, so the softmax is taken whole, with no online rescaling.
//   The outputs go back over the warp's own columns of the staged q, and the
//   block writes its 49 rows out as 16-byte stores. The padded query rows
//   are never stored.
// - `window_attn` (f32, or a head width of 8): one 64-thread block per
//   (window, head, batch entry) stages that head's 49 keys and values; each
//   of 49 threads walks one query's scores, softmax and P.V on the f32 FMA
//   units (`attend.cuh`).
//
// Padded tokens are ordinary keys: the caller zero-pads the grid before its
// q/k/v projections, so they carry the projection bias, as in the
// reference; nothing is masked but the tile padding. Wp = 259 or 133 (odd)
// is fine: every pixel row is C values long, and C * sizeof(T) is a
// multiple of 16 (the wrapper checks it), so each head group's slice
// starts on a 16-byte boundary whatever the window's column.
//
// Numbers: `window_mma` rounds P to bf16 before P.V (the row sum is of the
// unrounded P), so against the f32 plain version an output moves by at most
// 2^-8 of its row's sum of p |v|, as E's tensor-core entry.

#include "attend.cuh"
#include "mma.cuh"

namespace {

using ffattn::attend;
using ffattn::load_f;
using ffattn::store_f;
using bf16 = __nv_bfloat16;

constexpr int WS = 7;
constexpr int WT = WS * WS;  // tokens in a window
constexpr int THREADS = 64;  // window_attn
constexpr int ROWS = 64;     // window_mma: the 49 tokens padded to four m16 tiles
constexpr int KEYS = 56;     // ... and to seven n8 key tiles
constexpr int PAD = 8;       // values added to a shared row
constexpr int GROUP_VALUES = 64;  // the most columns a block's head group takes
constexpr int MAX_WARPS = GROUP_VALUES / 16;  // a group's most heads
constexpr float LOG2E = 1.4426950408889634f;

enum Entry { ENTRY_FMA = 0, ENTRY_MMA = 1 };

inline Entry entry_for(bool is_bf16, int d) {
  return is_bf16 && (d == 16 || d == 32) ? ENTRY_MMA : ENTRY_FMA;
}

// heads a window_mma block takes: the most that divide H, with their
// columns within GROUP_VALUES
inline int group_heads(int H, int d) {
  int hb = GROUP_VALUES / d;
  if (hb > H) hb = H;
  while (H % hb) --hb;
  return hb;
}

inline size_t mma_smem(int hb, int d) { return (size_t)3 * ROWS * (hb * d + PAD) * sizeof(bf16); }

// grid (windows, head groups, B), 32 * hb threads; dynamic shared memory
// mma_smem(hb, D): q, k, v of the group's columns, 64 rows each
template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS)
window_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ out, int Hp, int Wp, int H, float scale) {
  using namespace ffmma;
  static_assert(D % 16 == 0, "a head is whole k16 steps and n8 tile pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hb = blockDim.x >> 5;  // heads of this group
  const int CB = hb * D;           // columns staged
  const int RS = CB + PAD;         // shared row stride, in values
  const int P = CB / 8;            // 16-byte pieces a pixel
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + ROWS * RS;
  bf16* vs = ks + ROWS * RS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nw = Wp / WS;
  const int wy = blockIdx.x / nw, wx = blockIdx.x % nw;
  const long long b = blockIdx.z;
  const long long C = (long long)H * D;
  const long long col0 = (long long)blockIdx.y * CB;
  // global offset, in values, of token p (< 49) of this window, at the group's first column
  auto token = [&](int p) {
    const long long pix = (b * Hp + wy * WS + p / WS) * Wp + wx * WS + p % WS;
    return pix * C + col0;
  };

  // stage q, k, v: rows 49-63 written as zeros
  for (int e = tid; e < ROWS * P; e += blockDim.x) {
    const int r = e / P, c = e % P;
    const bool ok = r < WT;
    const long long src = token(ok ? r : 0) + c * 8;
    const int bytes = ok ? 16 : 0;
    cp_async16(qs + r * RS + c * 8, q + src, bytes);
    cp_async16(ks + r * RS + c * 8, k + src, bytes);
    cp_async16(vs + r * RS + c * 8, v + src, bytes);
  }
  cp_async_commit();

  // exp(scale * s) = 2^(sl * s) with sl > 0: a negative scale moves into q's
  // sign (exact in bf16), a zero one becomes the least normal float
  const float sl = fmaxf(fabsf(scale) * LOG2E, 1.17549435e-38f);
  const uint32_t flip = scale < 0.0f ? 0x80008000u : 0u;
  const int hc = warp * D;  // this head's first column in the group
  // ldmatrix row addresses of this lane, in values: Q as the A operand
  // (rows 0-15, k 0-15); K (16 keys x 16 d) as b0, b1 of two key tiles; V
  // (16 keys x 16 dv, transposed) as b0, b1 of two dv tiles (see attention.cu)
  const int q_off = (lane & 15) * RS + (lane >> 4) * 8 + hc;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8 + hc;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8 + hc;

  cp_async_wait<0>();
  __syncthreads();

#pragma unroll 1
  for (int mt = 0; mt < ROWS / 16; ++mt) {
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(qf[kk], qs + mt * 16 * RS + kk * 16 + q_off);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] ^= flip;
    }

    // S = Q.K^T over keys 0-55 (keys 56-63 come with the last pair, unused)
    float s[KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
#pragma unroll
      for (int jp = 0; jp < KEYS / 16; ++jp) {
        ldmatrix_x4(kb, ks + jp * 16 * RS + kk * 16 + k_off);
        mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
      ldmatrix_x4(kb, ks + (KEYS / 16) * 16 * RS + kk * 16 + k_off);
      mma_bf16(s[KEYS / 8 - 1], qf[kk], kb[0], kb[1]);
    }
    // keys 49-55 leave the softmax: in tile 6 only column 48 (t = 0, first) is a key
    s[6][1] = s[6][3] = -INFINITY;
    if (t != 0) s[6][0] = s[6][2] = -INFINITY;

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float m0 = mx0 * sl, m1 = mx1 * sl;  // finite: every row has 49 keys

    // P rounded to bf16 as the A operand of four k16 steps; keys 56-63 are 0
    uint32_t pf[ROWS / 16][4];
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      const float p0 = ex2(fmaf(s[j][0], sl, -m0));
      const float p1 = ex2(fmaf(s[j][1], sl, -m0));
      const float p2 = ex2(fmaf(s[j][2], sl, -m1));
      const float p3 = ex2(fmaf(s[j][3], sl, -m1));
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    pf[ROWS / 16 - 1][2] = pf[ROWS / 16 - 1][3] = 0u;
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);

    float o[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nt][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + kk * 16 * RS + np * 16 + v_off);
        mma_bf16(o[2 * np], pf[kk], vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pf[kk], vb[2], vb[3]);
      }

    // out over this head's columns of the staged q rows of this tile (read
    // into qf already; no other warp touches these columns)
    const float i0 = 1.0f / sum0, i1 = 1.0f / sum1;
    uint32_t* w0 = reinterpret_cast<uint32_t*>(qs + (mt * 16 + g) * RS + hc);
    uint32_t* w1 = reinterpret_cast<uint32_t*>(qs + (mt * 16 + g + 8) * RS + hc);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      w0[nt * 4 + t] = pack_bf16(o[nt][0] * i0, o[nt][1] * i0);
      w1[nt * 4 + t] = pack_bf16(o[nt][2] * i1, o[nt][3] * i1);
    }
  }
  __syncthreads();

  // the 49 real rows leave as 16-byte stores
  for (int e = tid; e < WT * P; e += blockDim.x) {
    const int r = e / P, c = e % P;
    *reinterpret_cast<uint4*>(out + token(r) + c * 8) =
        *reinterpret_cast<const uint4*>(qs + r * RS + c * 8);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
window_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, int Hp, int Wp, int H, float scale) {
  __shared__ __align__(16) unsigned char kraw[WT * D * sizeof(T)];
  __shared__ __align__(16) unsigned char vraw[WT * D * sizeof(T)];
  T* ks = reinterpret_cast<T*>(kraw);
  T* vs = reinterpret_cast<T*>(vraw);
  const int nw = Wp / WS;
  const int wy = blockIdx.x / nw, wx = blockIdx.x % nw;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long C = (long long)H * D;

  // stage the window's keys and values of this head, 16 bytes per copy
  constexpr int KC = D * sizeof(T) / 16;
  for (int e = threadIdx.x; e < WT * KC; e += THREADS) {
    const int p = e / KC, c = e % KC;
    const long long pix = (b * Hp + wy * WS + p / WS) * Wp + wx * WS + p % WS;
    const long long src = (pix * C + h * D) * sizeof(T) / 16 + c;
    reinterpret_cast<uint4*>(ks)[e] = reinterpret_cast<const uint4*>(k)[src];
    reinterpret_cast<uint4*>(vs)[e] = reinterpret_cast<const uint4*>(v)[src];
  }
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= WT) return;
  const long long pix = (b * Hp + wy * WS + i / WS) * Wp + wx * WS + i % WS;
  const long long off = pix * C + h * D;
  float qr[D];
  load_f<D>(q + off, qr);
  float o[D];
  attend<D, D>(qr, ks, D, vs, D, WT, scale, o);
  store_f<D>(out + off, o);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Hp, int Wp,
               int H, float scale, cudaStream_t s) {
  const int hb = group_heads(H, D);
  const size_t smem = mma_smem(hb, D);
  cudaError_t err = cudaFuncSetAttribute(
      window_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Hp / WS) * (Wp / WS), H / hb, B);
  window_mma<D><<<grid, 32 * hb, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Hp, Wp, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, void* out, int B, int Hp, int Wp,
               int H, float scale, cudaStream_t s) {
  dim3 grid((Hp / WS) * (Wp / WS), H, B);
  window_attn<T, D><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hp, Wp, H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int with_d(int d, const void* q, const void* k, const void* v, void* out, int B, int Hp, int Wp,
           int H, float scale, cudaStream_t s) {
  switch (d) {
    case 8: return launch_fma<T, 8>(q, k, v, out, B, Hp, Wp, H, scale, s);
    case 16: return launch_fma<T, 16>(q, k, v, out, B, Hp, Wp, H, scale, s);
    case 32: return launch_fma<T, 32>(q, k, v, out, B, Hp, Wp, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (B, Hp, Wp, H*d), contiguous, 16-byte aligned, all bf16 if
// is_bf16 else f32; Hp, Wp multiples of 7; d in {8, 16, 32}. Returns the
// launch's cudaError_t.
extern "C" int ff_window_attention(const void* q, const void* k, const void* v, void* out, int B,
                                   int Hp, int Wp, int H, int d, float scale, int is_bf16,
                                   void* stream) {
  if (Hp % WS != 0 || Wp % WS != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hp <= 0 || Wp <= 0 || H <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (entry_for(is_bf16 != 0, d) == ENTRY_MMA) {
    if (d == 16) return launch_mma<16>(q, k, v, out, B, Hp, Wp, H, scale, s);
    return launch_mma<32>(q, k, v, out, B, Hp, Wp, H, scale, s);
  }
  if (is_bf16) return with_d<bf16>(d, q, k, v, out, B, Hp, Wp, H, scale, s);
  return with_d<float>(d, q, k, v, out, B, Hp, Wp, H, scale, s);
}

// Which kernel `ff_window_attention` runs for this type and head width: 0
// `window_attn` (f32 FMA), 1 `window_mma` (tensor cores).
extern "C" int ff_window_attention_entry(int d, int is_bf16) {
  return (int)entry_for(is_bf16 != 0, d);
}
