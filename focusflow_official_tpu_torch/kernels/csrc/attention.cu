// Multi-head softmax attention whose key/value side is small:
//   q (B, N, H*D), k (B, M, H*D), v (B, M, H*DV) -> out (B, N, H*DV),
//   out[b, n, h] = softmax_j(scale * <q[b, n, h], k[b, j, h]>) . v[b, :, h]
// in f32 whatever the storage type; heads are column slices, as in the
// pre-head-split (B, N, C) projections the callers hold.
//
// Replaces the TPU kernel `focusflow_official_tpu/kernels/attention.py`
// (`_attn_kernel`, called through `small_kv_attention`). That kernel loads a
// 512-query block and ALL of one batch entry's keys and values into VMEM and
// runs the heads as MXU dots. On Hopper one block cannot hold all heads'
// keys at the widths of this path (448 x 256 x 2 bf16 = 458 KB), so the
// work is cut by head as well:
//
// - `attn_mma` (bf16, head widths 16 or 32, N >= 64: the Twins and vertical
//   global attentions, N = 7k-28k, M = 448): the tensor-core entry. A block
//   of 8 warps takes 256 queries of one (head, batch entry); a warp owns
//   two tiles of 16 queries, whose Q fragments stay in registers for the
//   whole walk over the keys, and every K and V fragment it reads serves
//   both tiles. Keys and values arrive in chunks of 128 through a ring of
//   two `cp.async` stages (rows padded by 8 values, so `ldmatrix` meets no
//   bank conflict): the first product starts after one chunk, and the next
//   chunk lands while this one is worked on. S = Q.K^T and O += P.V run as `mma.sync.m16n8k16` (bf16 in, f32
//   out): K, stored (key, d), is the B operand as it lies; V, stored (key,
//   dv), is read with `ldmatrix.trans`; the S accumulators, rounded to
//   bf16, already are the A operand of the second product. The softmax is
//   online in f32 on the accumulator fragments, 32 keys at a time: a row's
//   scores lie in the four lanes of a quad, so its max and sum are two
//   shuffles; exponentials are `ex2.approx` of a fused scale-and-subtract.
//   Padded keys of the last chunk are staged as zeros and their scores set
//   to -inf before the row max. O leaves through shared memory as 16-byte
//   row pieces.
// - `attn_staged` (N < 64: the perceiver's input layer, 7040 entries of 8
//   queries x 112 keys, its latent self-attention, 8 x 8, and the decoder's
//   cross-attend, 1 x 8, all 8 heads, B = 7040). Bound by bytes: at the input
//   layer K and V are 404 MB, read once 0.129 ms at 3.35 TB/s. The first
//   form (`attn_direct` below: one thread a (query, head) reading its head
//   slice of every key and value row from device memory through L1) read
//   each entry's rows once for each of its N queries, with one 32-byte
//   piece in flight a thread: 3.3x the byte bound. Here a block copies an
//   entry's rows into shared memory once, for all its queries and heads, as
//   16-byte `cp.async` pieces (a round's chunk of keys for several entries:
//   tens of KB in flight a block), through a ring of two stages that
//   carries on from one round of entries to the next. The rows are padded
//   so that the lanes reading 8 heads of one key meet no bank conflict.
//   Then the f32 work binds as much as the bytes: each (query, key) pair
//   costs d + dv multiply-adds and as many bf16 -> f32 conversions of its
//   key and value, so a thread takes two queries of one head and converts
//   each staged row once for both, and the scale rides in q so that a
//   weight is one `ex2`. Small entries share a block (the decoder's 8
//   threads an entry put 32 entries in a round). Any M: the last chunk of a
//   round is ragged and the walk stops at M.
// - `attn_tiled` (N >= 64, f32 inputs or a head width of 8): one block per
//   (query tile of 128, head, batch entry) stages that head's K and V in
//   shared memory once; each thread then walks all keys for one query on
//   the f32 FMA units (`attend.cuh`), reading every key as a broadcast.
// - `attn_direct` (N >= 64 where neither of those launches: more than 65535
//   batch entries, or f32 keys beyond shared memory): one thread per (batch
//   entry, query, head), reading keys and values from device memory.
//
// What bounds `attn_mma` on the card: not the tensor cores. At head widths
// of 16 and 32 the two products are 13 GFLOP at the largest shape of the
// path, which `mma.sync` does in about 0.02 ms even well under the card's
// peak. Each score costs one exponential on the special-function units (16
// lanes a clock an SM: 1.0e8 scores at the Twins shape, 0.03 ms), a handful
// of f32 operations around it, and its share of the `ldmatrix` traffic
// (with one 16-query tile a warp, 8 KB of shared-memory reads per 64 keys,
// as long as the exponentials); bytes (q, k, v read once, out written
// once: 14-29 MB, 0.01 ms) come after. That is why this is `mma.sync` and
// not `wgmma`: a 64-row warpgroup tile would speed up the one part that
// does not bind. The design spends its effort on the rest: the scale is
// folded into the exponent's FMA, a warp's two query tiles share each K and
// V fragment (half the `ldmatrix` traffic; two tiles of 32-key steps fill
// the 128 registers that two blocks an SM allow), and K/V re-staging
// through L2 falls with the queries a block takes (50 MB at 256 queries a
// block at the Twins shape, 100 MB at 128).
//
// Numbers: `attn_mma` rounds P to bf16 before P.V (the row sum is of the
// unrounded P), so against the f32 plain version each weight carries up to
// 2^-8 relative error (bf16 keeps 8 significant bits): an output moves by at
// most 2^-8 of its row's sum of p |v|.
// The other three entries keep P in f32 (`attn_staged`'s weights are
// `ex2.approx` of f32 scores, about 2^-22 relative).

#include <type_traits>

#include "attend.cuh"
#include "mma.cuh"

namespace {

using ffattn::attend;
using ffattn::load_f;
using ffattn::store_f;
using bf16 = __nv_bfloat16;

constexpr int TQ = 128;         // queries per block in attn_tiled
constexpr int DIRECT = 256;     // threads per block in attn_direct
constexpr int MIN_TILED_N = 64;
constexpr int MAX_SMEM = 227 * 1024;

// attn_staged; the launch plan (heads a group, units a round, keys a chunk,
// grid) is the wrapper's, `kernels/attention.py::staged_plan`
constexpr int ST_THREADS = 256;
constexpr int ST_STAGES = 2;  // chunks in the cp.async ring

// attn_mma
constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int QT = 2;       // 16-query tiles a warp
constexpr int SC = 32;      // keys per softmax step
constexpr int KC = 128;     // keys per staged chunk
constexpr int STAGES = 2;   // chunks in the cp.async ring
constexpr int PAD = 8;      // values added to a shared row: ldmatrix without bank conflicts
constexpr int BQ = 16 * QT * MMA_WARPS;  // queries per block
constexpr float LOG2E = 1.4426950408889634f;

enum Entry { ENTRY_DIRECT = 0, ENTRY_TILED = 1, ENTRY_MMA = 2, ENTRY_STAGED = 3 };

// which kernel a call runs: by type and shape only
inline Entry entry_for(bool is_bf16, int d, int dv, int B, int N, int M) {
  if (N < MIN_TILED_N) return ENTRY_STAGED;
  if (B > 65535) return ENTRY_DIRECT;
  if (is_bf16 && d % 16 == 0 && dv % 16 == 0) return ENTRY_MMA;
  const long long smem = (long long)M * (d + dv) * (is_bf16 ? 2 : 4);
  return smem <= MAX_SMEM ? ENTRY_TILED : ENTRY_DIRECT;
}

// a staged row of g 16-byte pieces takes one more piece after every 8
__host__ __device__ constexpr int padded(int g) { return g + (g + 7) / 8; }
// where piece p of a row lies in its padded row
__device__ __forceinline__ int pad_at(int p) { return p + (p >> 3); }

template <int D, int DV>
__global__ void __launch_bounds__(MMA_THREADS, 2)
attn_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         bf16* __restrict__ out, int N, int M, int H, float scale) {
  using namespace ffmma;
  constexpr int KS = D + PAD, VS = DV + PAD;  // shared row strides, in values
  constexpr int KP = D / 8, VP = DV / 8;      // 16-byte pieces a row
  static_assert(D % 16 == 0 && DV % 16 == 0, "head widths are whole k and n tile pairs");
  static_assert(KC % SC == 0 && SC % 16 == 0, "a chunk is whole softmax steps of key pairs");
  static_assert(STAGES * KC * (KS + VS) >= MMA_WARPS * 16 * QT * VS,
                "the output tiles leave through the ring");
  __shared__ __align__(16) bf16 smem[STAGES * KC * (KS + VS)];
  bf16* ksm = smem;                     // [STAGES][KC][KS]
  bf16* vsm = smem + STAGES * KC * KS;  // [STAGES][KC][VS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long C = (long long)H * D, CV = (long long)H * DV;
  const bf16* kg = k + b * M * C + h * D;
  const bf16* vg = v + b * M * CV + h * DV;
  const int nchunks = (M + KC - 1) / KC;

  // chunk c -> stage c % STAGES; keys past M are written as zeros
  auto stage_chunk = [&](int c) {
    bf16* kd = ksm + (c % STAGES) * KC * KS;
    bf16* vd = vsm + (c % STAGES) * KC * VS;
    const int j0 = c * KC;
    for (int e = tid; e < KC * (KP + VP); e += MMA_THREADS) {
      const bool is_k = e < KC * KP;
      const int e2 = is_k ? e : e - KC * KP;
      const int r = is_k ? e2 / KP : e2 / VP;
      const int p = is_k ? e2 % KP : e2 % VP;
      const bool ok = j0 + r < M;
      const long long j = ok ? j0 + r : M - 1;
      if (is_k)
        cp_async16(kd + r * KS + p * 8, kg + j * C + p * 8, ok ? 16 : 0);
      else
        cp_async16(vd + r * VS + p * 8, vg + j * CV + p * 8, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) stage_chunk(c);
    cp_async_commit();
  }

  // this warp's queries: tiles of 16 rows, rows g and g + 8 of each in this lane
  const int n0 = blockIdx.x * BQ + warp * (16 * QT);
  const bool active = n0 < N;
  // exp(scale * s) = 2^(sl * s) with sl > 0: a negative scale moves into q's
  // sign (exact in bf16), a zero one becomes the least normal float
  const float sl = fmaxf(fabsf(scale) * LOG2E, 1.17549435e-38f);
  const uint32_t flip = scale < 0.0f ? 0x80008000u : 0u;
  uint32_t qf[QT][D / 16][4];
#pragma unroll
  for (int qt = 0; qt < QT; ++qt) {
    const int r0 = n0 + qt * 16 + g, r1 = r0 + 8;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q + (b * N + r0) * C + h * D);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(q + (b * N + r1) * C + h * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[qt][kk][0] = r0 < N ? __ldg(q0 + kk * 8 + t) ^ flip : 0u;
      qf[qt][kk][1] = r1 < N ? __ldg(q1 + kk * 8 + t) ^ flip : 0u;
      qf[qt][kk][2] = r0 < N ? __ldg(q0 + kk * 8 + 4 + t) ^ flip : 0u;
      qf[qt][kk][3] = r1 < N ? __ldg(q1 + kk * 8 + 4 + t) ^ flip : 0u;
    }
  }

  float m[QT][2], l[QT][2], o[QT][DV / 8][4];
#pragma unroll
  for (int qt = 0; qt < QT; ++qt) {
    m[qt][0] = m[qt][1] = -INFINITY;
    l[qt][0] = l[qt][1] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[qt][nt][i] = 0.0f;
  }

  // ldmatrix row addresses of this lane, in values from a stage's start:
  // K, 16 keys x 16 d: matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15),
  // (keys 8-15, d 0-7), (keys 8-15, d 8-15) = b0, b1 of two key tiles
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * KS + ((lane >> 3) & 1) * 8;
  // V, 16 keys x 16 dv, transposed: (keys 0-7, dv 0-7), (keys 8-15, dv 0-7),
  // (keys 0-7, dv 8-15), (keys 8-15, dv 8-15) = b0, b1 of two dv tiles
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * VS + (lane >> 4) * 8;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();              // everyone's have, and chunk c - 1 is done with
    if (c + STAGES - 1 < nchunks) stage_chunk(c + STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* kc = ksm + (c % STAGES) * KC * KS;
    const bf16* vc = vsm + (c % STAGES) * KC * VS;

#pragma unroll
    for (int s0 = 0; s0 < KC; s0 += SC) {
      const int left = M - (c * KC + s0);  // keys from this step's first to the last
      if (left <= 0) break;                // a step never holds only padded keys

      // S = Q.K^T for SC keys, every K fragment used by all QT tiles
      float s[QT][SC / 8][4];
#pragma unroll
      for (int qt = 0; qt < QT; ++qt)
#pragma unroll
        for (int j = 0; j < SC / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[qt][j][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < SC / 16; ++jp) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kc + (s0 + jp * 16) * KS + kk * 16 + k_off);
#pragma unroll
          for (int qt = 0; qt < QT; ++qt) {
            mma_bf16(s[qt][2 * jp], qf[qt][kk], kb[0], kb[1]);
            mma_bf16(s[qt][2 * jp + 1], qf[qt][kk], kb[2], kb[3]);
          }
        }
      if (left < SC) {  // padded keys leave the softmax: -inf before the row max
#pragma unroll
        for (int j = 0; j < SC / 8; ++j) {
          const int key = j * 8 + 2 * t;
#pragma unroll
          for (int qt = 0; qt < QT; ++qt) {
            if (key >= left) s[qt][j][0] = s[qt][j][2] = -INFINITY;
            if (key + 1 >= left) s[qt][j][1] = s[qt][j][3] = -INFINITY;
          }
        }
      }

      // online softmax on the fragments; P rounded to bf16 as the A operand
      uint32_t pf[QT][SC / 16][4];
#pragma unroll
      for (int qt = 0; qt < QT; ++qt) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < SC / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[qt][j][0], s[qt][j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[qt][j][2], s[qt][j][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m[qt][0], mx0 * sl);  // finite: the step holds a key
        const float mn1 = fmaxf(m[qt][1], mx1 * sl);
        const float c0 = ex2(m[qt][0] - mn0);  // 2^-inf = 0 on the first step
        const float c1 = ex2(m[qt][1] - mn1);
        m[qt][0] = mn0;
        m[qt][1] = mn1;
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int j = 0; j < SC / 8; ++j) {
          const float p0 = ex2(fmaf(s[qt][j][0], sl, -mn0));
          const float p1 = ex2(fmaf(s[qt][j][1], sl, -mn0));
          const float p2 = ex2(fmaf(s[qt][j][2], sl, -mn1));
          const float p3 = ex2(fmaf(s[qt][j][3], sl, -mn1));
          sum0 += p0 + p1;
          sum1 += p2 + p3;
          pf[qt][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
          pf[qt][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
        l[qt][0] = fmaf(l[qt][0], c0, sum0);  // this lane's columns; the quad adds up at the end
        l[qt][1] = fmaf(l[qt][1], c1, sum1);
#pragma unroll
        for (int nt = 0; nt < DV / 8; ++nt) {
          o[qt][nt][0] *= c0;
          o[qt][nt][1] *= c0;
          o[qt][nt][2] *= c1;
          o[qt][nt][3] *= c1;
        }
      }

      // O += P.V, every V fragment used by all QT tiles
#pragma unroll
      for (int kk = 0; kk < SC / 16; ++kk)
#pragma unroll
        for (int np = 0; np < DV / 16; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vc + (s0 + kk * 16) * VS + np * 16 + v_off);
#pragma unroll
          for (int qt = 0; qt < QT; ++qt) {
            mma_bf16(o[qt][2 * np], pf[qt][kk], vb[0], vb[1]);
            mma_bf16(o[qt][2 * np + 1], pf[qt][kk], vb[2], vb[3]);
          }
        }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: each warp's tiles leave through it
  if (!active) return;
  bf16* os = smem + warp * (16 * QT) * VS;
#pragma unroll
  for (int qt = 0; qt < QT; ++qt) {
    float l0 = l[qt][0], l1 = l[qt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.0f / l0, i1 = 1.0f / l1;
    uint32_t* w0 = reinterpret_cast<uint32_t*>(os + (qt * 16 + g) * VS);
    uint32_t* w1 = reinterpret_cast<uint32_t*>(os + (qt * 16 + g + 8) * VS);
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      w0[nt * 4 + t] = pack_bf16(o[qt][nt][0] * i0, o[qt][nt][1] * i0);
      w1[nt * 4 + t] = pack_bf16(o[qt][nt][2] * i1, o[qt][nt][3] * i1);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * QT * VP; e += 32) {
    const int r = e / VP, p = e % VP;
    if (n0 + r < N)
      *reinterpret_cast<uint4*>(out + (b * N + n0 + r) * CV + h * DV + p * 8) =
          *reinterpret_cast<const uint4*>(os + r * VS + p * 8);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(TQ)
attn_tiled(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int N, int M, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + (long long)M * D;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long C = (long long)H * D, CV = (long long)H * DV;

  // stage this head's keys and values, 16 bytes per copy
  constexpr int KW = D * sizeof(T) / 16, VW = DV * sizeof(T) / 16;
  const uint4* kg = reinterpret_cast<const uint4*>(k + b * M * C + h * D);
  const uint4* vg = reinterpret_cast<const uint4*>(v + b * M * CV + h * DV);
  uint4* kd = reinterpret_cast<uint4*>(ks);
  uint4* vd = reinterpret_cast<uint4*>(vs);
  const long long krow = C * sizeof(T) / 16, vrow = CV * sizeof(T) / 16;
  for (int e = threadIdx.x; e < M * KW; e += TQ) kd[e] = kg[(e / KW) * krow + e % KW];
  for (int e = threadIdx.x; e < M * VW; e += TQ) vd[e] = vg[(e / VW) * vrow + e % VW];
  __syncthreads();

  const int n = blockIdx.x * TQ + threadIdx.x;
  if (n >= N) return;
  const long long row = b * N + n;
  float qr[D];
  load_f<D>(q + row * C + h * D, qr);
  float o[DV];
  attend<D, DV>(qr, ks, D, vs, DV, M, scale, o);
  store_f<DV>(out + row * CV + h * DV, o);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(DIRECT)
attn_direct(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, long long total, int N, int M, int H, float scale) {
  const long long t = (long long)blockIdx.x * DIRECT + threadIdx.x;
  if (t >= total) return;
  const int h = (int)(t % H);
  const long long row = t / H;  // b * N + n
  const long long b = row / N;
  const long long C = (long long)H * D, CV = (long long)H * DV;
  float qr[D];
  load_f<D>(q + row * C + h * D, qr);
  float o[DV];
  attend<D, DV>(qr, k + b * M * C + h * D, C, v + b * M * CV + h * DV, CV, M, scale, o);
  store_f<DV>(out + row * CV + h * DV, o);
}

// Keys [0, n) of one head, staged at kp and vp (row strides ks, vs), added
// to QP running softmaxes (m: the max of the scores so far, l: the sum of
// their exponentials, acc: the weighted value sum). q carries the scale
// times log2(e), so a score is its dot product and exp(scale * dot - max)
// one `ex2`. Chunks of CH keys: their scores in registers, the max raised
// once a chunk; each K and V row loaded once for all QP queries.
template <int QP, int D, int DV, typename T>
__device__ __forceinline__ void staged_keys(const float (&q)[QP][D], const T* __restrict__ kp,
                                            int ks, const T* __restrict__ vp, int vs, int n,
                                            float (&m)[QP], float (&l)[QP],
                                            float (&acc)[QP][DV]) {
  constexpr int CH = 8;
  for (int j0 = 0; j0 < n; j0 += CH) {
    float s[CH][QP], cmax[QP];
#pragma unroll
    for (int i = 0; i < QP; ++i) cmax[i] = -INFINITY;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (j0 + c < n) {
        float kv[D];
        load_f<D>(kp + (j0 + c) * ks, kv);
#pragma unroll
        for (int i = 0; i < QP; ++i) {
          float dot = 0.0f;
#pragma unroll
          for (int e = 0; e < D; ++e) dot = fmaf(q[i][e], kv[e], dot);
          s[c][i] = dot;
          cmax[i] = fmaxf(cmax[i], dot);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < QP; ++i) {
      const float mn = fmaxf(m[i], cmax[i]);  // finite: the chunk holds a key
      const float corr = ffmma::ex2(m[i] - mn);  // 2^-inf = 0 on the first chunk
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[i][e] *= corr;
      m[i] = mn;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (j0 + c < n) {
        float vv[DV];
        load_f<DV>(vp + (j0 + c) * vs, vv);
#pragma unroll
        for (int i = 0; i < QP; ++i) {
          const float p = ffmma::ex2(s[c][i] - m[i]);
          l[i] += p;
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }
}

// A unit is one batch entry's group of hg heads: its ceil(N / QP) x hg
// (query group, head) threads, heads fastest, a thread QP queries of one
// head, and the hg-head slice of the entry's M key and value rows. A round
// is `units` consecutive units; block x takes rounds x, x + gridDim.x, ...
// A round's keys arrive in chunks of kc through a ring of ST_STAGES
// shared-memory stages, the chunks of all of this block's rounds one
// stream, so the next chunk (of this round or the next) lands while this
// one is worked on. Every value of K and V is copied once, as 16-byte
// `cp.async` pieces; a thread of the unit's share of the block copies a
// fixed piece column of the rows. A unit's staged K rows (V rows) put one
// spare piece after every 8, so the 8 lanes of a quarter-warp, reading 8
// heads of one key, meet 8 different bank groups (a head slice of 1, 2, 4
// or 8 pieces never crosses a spare). Each thread carries its queries'
// running softmax from chunk to chunk (`staged_keys`); a round's queries
// are loaded before the wait for its first chunk, so their latency hides
// behind it.
template <typename T, int D, int DV, int QP>
__global__ void __launch_bounds__(ST_THREADS, 2)
attn_staged(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, int B, int N, int M, int H, int hg, int units, int kc,
            float scale) {
  using ffmma::cp_async16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int EPG = 16 / sizeof(T);         // values a piece
  constexpr int GK = D / EPG, GV = DV / EPG;  // pieces of one head's key, value
  const int G = H / hg;                       // head groups an entry
  const long long total = (long long)B * G;   // units
  const long long rounds = (total + units - 1) / units;
  const int gk = hg * GK, gv = hg * GV;       // pieces of a unit's key row, value row
  const int rsk = padded(gk), rsv = padded(gv);
  const int unit_vals = kc * (rsk + rsv) * EPG;  // a unit's share of a stage, in values
  const int stage_vals = units * unit_vals;
  const int nch = (M + kc - 1) / kc;
  const long long C = (long long)H * D, CV = (long long)H * DV;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long my_rounds =
      blockIdx.x < rounds ? (rounds - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = my_rounds * nch;
  const int tid = threadIdx.x;

  // staging: ST_THREADS / units threads a unit slot, each a piece column
  const int tpu = ST_THREADS / units;
  const int s_us = tid / tpu, s_t = tid % tpu;
  const int lanes = min(gk + gv, tpu);
  const int s_col = s_t % lanes, s_row = s_t / lanes, s_rstep = tpu / lanes;
  const bool stager = s_us < units && s_row < s_rstep;
  // step (rnd, c) -> stage `slot`
  auto stage = [&](long long rnd, int c, int slot) {
    const long long u = rnd * units + s_us;
    if (!stager || u >= total) return;
    const int j0 = c * kc, n = min(kc, M - j0);
    T* kd = sm + slot * stage_vals + s_us * unit_vals;
    T* vd = kd + kc * rsk * EPG;
    const long long b = u / G;
    const int h0 = (int)(u % G) * hg;
    for (int j = s_row; j < n; j += s_rstep) {
      const T* kr = k + (b * M + j0 + j) * C + (long long)h0 * D;
      const T* vr = v + (b * M + j0 + j) * CV + (long long)h0 * DV;
      for (int p = s_col; p < gk + gv; p += lanes) {
        if (p < gk)
          cp_async16(kd + (j * rsk + pad_at(p)) * EPG, kr + p * EPG, 16);
        else
          cp_async16(vd + (j * rsv + pad_at(p - gk)) * EPG, vr + (p - gk) * EPG, 16);
      }
    }
  };

  // compute: thread (unit slot, query group, head of the group)
  const int per_unit = (N + QP - 1) / QP * hg;
  const int c_us = tid / per_unit, c_n0 = (tid % per_unit) / hg * QP, c_h = tid % hg;
  const bool worker = c_us < units;
  const int koff = pad_at(c_h * GK) * EPG, voff = pad_at(c_h * GV) * EPG;
  const float sl = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)

  long long prnd = blockIdx.x;  // the chunk the ring takes next
  int pc = 0;
  auto advance = [&](long long& rnd, int& c) {
    if (++c == nch) {
      c = 0;
      rnd += gridDim.x;
    }
  };
#pragma unroll
  for (int s = 0; s < ST_STAGES - 1; ++s) {
    if (s < steps) {
      stage(prnd, pc, s);
      advance(prnd, pc);
    }
    ffmma::cp_async_commit();
  }

  long long rnd = blockIdx.x;
  int c = 0;
  float qr[QP][D], m[QP], l[QP], acc[QP][DV];
  long long b = 0;
  int h = 0;
  for (long long s = 0; s < steps; ++s) {
    const long long u = rnd * units + c_us;
    const bool busy = worker && u < total;
    if (busy && c == 0) {  // this round's queries, before the wait
      b = u / G;
      h = (int)(u % G) * hg + c_h;
#pragma unroll
      for (int i = 0; i < QP; ++i) {
        const int n = min(c_n0 + i, N - 1);  // a group past N repeats the last query
        load_f<D>(q + (b * N + n) * C + (long long)h * D, qr[i]);
        m[i] = -INFINITY;
        l[i] = 0.0f;
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[i][e] = 0.0f;
      }
    }
    ffmma::cp_async_wait<ST_STAGES - 2>();  // this thread's copies of chunk s have landed
    __syncthreads();                        // everyone's have, and chunk s - 1 is done with
    if (s + ST_STAGES - 1 < steps) {
      stage(prnd, pc, (int)((s + ST_STAGES - 1) % ST_STAGES));
      advance(prnd, pc);
    }
    ffmma::cp_async_commit();
    if (busy) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < QP; ++i)
#pragma unroll
          for (int e = 0; e < D; ++e) qr[i][e] *= sl;
      }
      const T* kd = sm + (int)(s % ST_STAGES) * stage_vals + c_us * unit_vals;
      const T* vd = kd + kc * rsk * EPG;
      staged_keys<QP, D, DV>(qr, kd + koff, rsk * EPG, vd + voff, rsv * EPG,
                             min(kc, M - c * kc), m, l, acc);
      if (c == nch - 1) {
#pragma unroll
        for (int i = 0; i < QP; ++i) {
          if (c_n0 + i >= N) break;
          const float inv = 1.0f / l[i];
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[i][e] *= inv;
          store_f<DV>(out + (b * N + c_n0 + i) * CV + (long long)h * DV, acc[i]);
        }
      }
    }
    advance(rnd, c);
  }
  ffmma::cp_async_wait<0>();
}

// the shared memory a staged launch takes, in bytes
inline long long staged_smem(int d, int dv, int esize, int hg, int units, int kc) {
  const int epg = 16 / esize;
  return (long long)ST_STAGES * units * kc * (padded(hg * d / epg) + padded(hg * dv / epg)) * 16;
}

struct Plan {  // attn_staged's launch, from the wrapper
  int hg, qp, units, kc, grid;
};

template <typename T, int D, int DV>
const void* staged_kernel(int qp) {
  if (qp == 1) return reinterpret_cast<const void*>(attn_staged<T, D, DV, 1>);
  if (qp == 2) return reinterpret_cast<const void*>(attn_staged<T, D, DV, 2>);
  return nullptr;
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int N, int M, int H,
           float scale, Plan plan, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  constexpr bool is_bf16 = std::is_same<T, bf16>::value;
  const Entry entry = entry_for(is_bf16, D, DV, B, N, M);
  if (entry == ENTRY_STAGED) {
    const long long smem = staged_smem(D, DV, sizeof(T), plan.hg, plan.units, plan.kc);
    const void* fn = staged_kernel<T, D, DV>(plan.qp);
    if (!fn || plan.hg < 1 || H % plan.hg != 0 || plan.units < 1 || plan.kc < 1 ||
        plan.grid < 1 || (long long)(N + plan.qp - 1) / plan.qp * plan.hg * plan.units > ST_THREADS ||
        smem > MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (plan.qp == 1)
      attn_staged<T, D, DV, 1><<<plan.grid, ST_THREADS, (size_t)smem, s>>>(
          qp, kp, vp, op, B, N, M, H, plan.hg, plan.units, plan.kc, scale);
    else
      attn_staged<T, D, DV, 2><<<plan.grid, ST_THREADS, (size_t)smem, s>>>(
          qp, kp, vp, op, B, N, M, H, plan.hg, plan.units, plan.kc, scale);
  } else if (entry == ENTRY_MMA) {
    if constexpr (is_bf16 && D % 16 == 0 && DV % 16 == 0) {
      dim3 grid((N + BQ - 1) / BQ, H, B);
      attn_mma<D, DV><<<grid, MMA_THREADS, 0, s>>>(qp, kp, vp, op, N, M, H, scale);
    }
  } else if (entry == ENTRY_TILED) {
    const long long smem = (long long)M * (D + DV) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        attn_tiled<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + TQ - 1) / TQ, H, B);
    attn_tiled<T, D, DV><<<grid, TQ, (size_t)smem, s>>>(qp, kp, vp, op, N, M, H, scale);
  } else {
    const long long total = (long long)B * N * H;
    const long long blocks = (total + DIRECT - 1) / DIRECT;
    attn_direct<T, D, DV><<<(unsigned)blocks, DIRECT, 0, s>>>(qp, kp, vp, op, total, N, M, H,
                                                              scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int with_dv(int dv, const void* q, const void* k, const void* v, void* out, int B, int N, int M,
            int H, float scale, Plan plan, cudaStream_t s) {
  switch (dv) {
    case 8: return launch<T, D, 8>(q, k, v, out, B, N, M, H, scale, plan, s);
    case 16: return launch<T, D, 16>(q, k, v, out, B, N, M, H, scale, plan, s);
    case 32: return launch<T, D, 32>(q, k, v, out, B, N, M, H, scale, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int with_d(int d, int dv, const void* q, const void* k, const void* v, void* out, int B, int N,
           int M, int H, float scale, Plan plan, cudaStream_t s) {
  switch (d) {
    case 8: return with_dv<T, 8>(dv, q, k, v, out, B, N, M, H, scale, plan, s);
    case 16: return with_dv<T, 16>(dv, q, k, v, out, B, N, M, H, scale, plan, s);
    case 32: return with_dv<T, 32>(dv, q, k, v, out, B, N, M, H, scale, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, N, H*d), k (B, M, H*d), v (B, M, H*dv), out (B, N, H*dv): contiguous,
// 16-byte aligned, all bf16 if is_bf16 else f32; d, dv in {8, 16, 32}. hg,
// qp, units, kc, grid: the staged entry's plan (`staged_plan` in the
// wrapper), checked here and read only where that entry runs. Returns the
// launch's cudaError_t.
extern "C" int ff_attention(const void* q, const void* k, const void* v, void* out, int B, int N,
                            int M, int H, int d, int dv, float scale, int is_bf16, int hg,
                            int qp, int units, int kc, int grid, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return 0;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Plan plan{hg, qp, units, kc, grid};
  if (is_bf16)
    return with_d<__nv_bfloat16>(d, dv, q, k, v, out, B, N, M, H, scale, plan, s);
  return with_d<float>(d, dv, q, k, v, out, B, N, M, H, scale, plan, s);
}

// Which kernel `ff_attention` runs at these sizes and this type: 0
// `attn_direct`, 1 `attn_tiled` (both f32 FMA loops over device memory and
// over one head's staged keys), 2 `attn_mma`, 3 `attn_staged`.
extern "C" int ff_attention_entry(int B, int N, int M, int d, int dv, int is_bf16) {
  return (int)entry_for(is_bf16 != 0, d, dv, B, N, M);
}

template <typename T, int D>
const void* staged_kernel_dv(int dv, int qp) {
  switch (dv) {
    case 8: return staged_kernel<T, D, 8>(qp);
    case 16: return staged_kernel<T, D, 16>(qp);
    case 32: return staged_kernel<T, D, 32>(qp);
    default: return nullptr;
  }
}

template <typename T>
const void* staged_kernel_d(int d, int dv, int qp) {
  switch (d) {
    case 8: return staged_kernel_dv<T, 8>(dv, qp);
    case 16: return staged_kernel_dv<T, 16>(dv, qp);
    case 32: return staged_kernel_dv<T, 32>(dv, qp);
    default: return nullptr;
  }
}

// Blocks of a staged launch of this plan (hg heads a group, qp queries a
// thread, units a round, kc keys a chunk) that one SM holds at once, from
// its registers and the shared memory the plan takes; 0 where none fits,
// -1 for widths or a plan it is not built for.
extern "C" int ff_attention_staged_blocks(int d, int dv, int is_bf16, int hg, int qp, int units,
                                          int kc) {
  const void* fn = is_bf16 ? staged_kernel_d<bf16>(d, dv, qp) : staged_kernel_d<float>(d, dv, qp);
  const long long smem = staged_smem(d, dv, is_bf16 ? 2 : 4, hg, units, kc);
  if (!fn || hg < 1 || units < 1 || kc < 1 || smem > MAX_SMEM) return -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, ST_THREADS, (size_t)smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}
