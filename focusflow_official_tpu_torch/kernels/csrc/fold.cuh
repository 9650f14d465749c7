// The register tile of the convc1 product, shared by `fold.cu` (kernel B)
// and `lookup_fold.cu`: one k step of a TM x TN outer product with plain
// f32 FMAs, and the bias epilogue. Both kernels walk k upwards in slices of
// 16 and call these in the same order, so from the same window values they
// give the same bits.

#pragma once

#include <cuda_runtime.h>

#include "convert.cuh"

namespace fffold {

template <int TM, int TN>
__device__ __forceinline__ void fma_outer(float (&acc)[TM][TN], const float (&av)[TM],
                                          const float (&wv)[TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
}

// out = acc + bias in f32, rounded once to T
template <typename T>
__device__ __forceinline__ T biased(float acc, T bias) {
  return ffconv::from_f<T>(acc + ffconv::to_f(bias));
}

}  // namespace fffold
