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
// - `attn_tiled` (N >= 64: the Twins and vertical global attentions,
//   N = 7k-28k, M = 448): one block per (query tile of 128, head, batch
//   entry) stages that head's K and V (M x D and M x DV, <= 57 KB in bf16)
//   in shared memory once; each thread then walks all keys for one query,
//   reading every key as a broadcast.
// - `attn_direct` (N < 64: the perceiver's latent attentions and the
//   decoder's cross-attend, B = 7040, N = 8 or 1, M <= 112): one thread per
//   (batch entry, query, head), heads fastest, so a 256-thread block covers
//   many batch entries and a warp's key loads are one contiguous span of a
//   key row; keys and values are read through L1.
//
// What bounds it on the card: at tensor-core rates, bytes (q, k, v read
// once, out written once: 14-29 MB at the Twins shapes, 0.01 ms). This
// first version runs the dot products on the f32 FMA units, one query per
// thread, so it is bound by FMA issue: ~3*M*D FMAs per query and head. The
// tensor-core (mma / wgmma) form, with a query tile per warp, is later work.

#include "attend.cuh"

namespace {

using ffattn::attend;
using ffattn::load_f;
using ffattn::store_f;

constexpr int TQ = 128;         // queries per block in attn_tiled
constexpr int DIRECT = 256;     // threads per block in attn_direct
constexpr int MIN_TILED_N = 64;
constexpr int MAX_SMEM = 227 * 1024;

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
  constexpr int KC = D * sizeof(T) / 16, VC = DV * sizeof(T) / 16;
  const uint4* kg = reinterpret_cast<const uint4*>(k + b * M * C + h * D);
  const uint4* vg = reinterpret_cast<const uint4*>(v + b * M * CV + h * DV);
  uint4* kd = reinterpret_cast<uint4*>(ks);
  uint4* vd = reinterpret_cast<uint4*>(vs);
  const long long krow = C * sizeof(T) / 16, vrow = CV * sizeof(T) / 16;
  for (int e = threadIdx.x; e < M * KC; e += TQ) kd[e] = kg[(e / KC) * krow + e % KC];
  for (int e = threadIdx.x; e < M * VC; e += TQ) vd[e] = vg[(e / VC) * vrow + e % VC];
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

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int N, int M, int H,
           float scale, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  const long long smem = (long long)M * (D + DV) * sizeof(T);
  if (N >= MIN_TILED_N && smem <= MAX_SMEM && B <= 65535) {
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
            int H, float scale, cudaStream_t s) {
  switch (dv) {
    case 8: return launch<T, D, 8>(q, k, v, out, B, N, M, H, scale, s);
    case 16: return launch<T, D, 16>(q, k, v, out, B, N, M, H, scale, s);
    case 32: return launch<T, D, 32>(q, k, v, out, B, N, M, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int with_d(int d, int dv, const void* q, const void* k, const void* v, void* out, int B, int N,
           int M, int H, float scale, cudaStream_t s) {
  switch (d) {
    case 8: return with_dv<T, 8>(dv, q, k, v, out, B, N, M, H, scale, s);
    case 16: return with_dv<T, 16>(dv, q, k, v, out, B, N, M, H, scale, s);
    case 32: return with_dv<T, 32>(dv, q, k, v, out, B, N, M, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, N, H*d), k (B, M, H*d), v (B, M, H*dv), out (B, N, H*dv): contiguous,
// 16-byte aligned, all bf16 if is_bf16 else f32; d, dv in {8, 16, 32}.
// Returns the launch's cudaError_t.
extern "C" int ff_attention(const void* q, const void* k, const void* v, void* out, int B, int N,
                            int M, int H, int d, int dv, float scale, int is_bf16,
                            void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return 0;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return with_d<__nv_bfloat16>(d, dv, q, k, v, out, B, N, M, H, scale, s);
  return with_d<float>(d, dv, q, k, v, out, B, N, M, H, scale, s);
}
