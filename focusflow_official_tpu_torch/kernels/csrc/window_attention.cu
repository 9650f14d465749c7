// 7x7-window multi-head attention on natural-layout grids:
//   q, k, v, out (B, Hp, Wp, H*D), Hp and Wp multiples of 7; each query
//   attends to the 49 keys of its own 7x7 window, per head, softmax in f32.
//
// Replaces the TPU kernel `focusflow_official_tpu/kernels/window_attention.py`
// (`_kernel`, called through `window_attention`). That kernel loads whole
// window ROWS (7 x Wp x C slabs) into VMEM and issues every window's and
// head's 49x49 dots on the MXU in sequence. Here the grid is flat: one
// 64-thread block per (window, head, batch entry) stages the window's 49
// keys and values of that head in shared memory (49 x D each, 3 KB in bf16
// at D = 16) and each of 49 threads computes one query's scores, softmax and
// P.V in registers. Nothing is partitioned or merged in device memory: the
// block reads its window straight out of the natural layout and writes its
// outputs back in place.
//
// Padded tokens are ordinary keys: the caller zero-pads the grid before its
// q/k/v projections, so they carry the projection bias, as in the
// reference; nothing is masked. Wp = 259 or 133 (odd) is fine: every pixel
// row is C values long, and C * sizeof(T) is a multiple of 16, so each head
// slice starts on a 16-byte boundary whatever the window's column.
//
// What bounds it on the card: bytes (q, k, v read once, out written once;
// 59 MB at the Twins stage-1 shape, 0.018 ms). The 49x49 products are tiny
// (2 x 49 x 49 x D FMAs a window and head), and 49 of 64 lanes work, so this
// first version is bound by f32 FMA issue and latency, not by bytes. A warp
// per window with `mma.sync` tiles is later work.

#include "attend.cuh"

namespace {

using ffattn::attend;
using ffattn::load_f;
using ffattn::store_f;

constexpr int WS = 7;
constexpr int WT = WS * WS;  // tokens in a window
constexpr int THREADS = 64;

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hp, int Wp, int H,
           float scale, cudaStream_t s) {
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
    case 8: return launch<T, 8>(q, k, v, out, B, Hp, Wp, H, scale, s);
    case 16: return launch<T, 16>(q, k, v, out, B, Hp, Wp, H, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Hp, Wp, H, scale, s);
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
  if (is_bf16) return with_d<__nv_bfloat16>(d, q, k, v, out, B, Hp, Wp, H, scale, s);
  return with_d<float>(d, q, k, v, out, B, Hp, Wp, H, scale, s);
}
