// Device code shared by vq_nearest.cu and vq_stats.cu: the nearest-codeword
// search of one head, so that both kernels give bit-equal indices and
// codeword rows on the same inputs.
//
// The rounding of every step is fixed: dist = (|x|^2 - 2 x.e) + |e|^2 in
// fp32 with no contraction across the three terms, strict < while a lane
// scans its codewords in rising order, and a butterfly reduction that breaks
// ties to the lower index, as jnp.argmin and torch.argmin do.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace vq {

constexpr int kWarps = 8;          // keep in sync with ops/vq.py
constexpr int kRowsPerBlock = 64;  // rows of one head per tile

// Whole block: copy one head's codebook E [d][K] to ``es`` and its squared
// codeword norms to ``esq`` [K] (both shared memory). Ends synchronised.
__device__ __forceinline__ void stage_codebook(const float* __restrict__ eh, float* es,
                                               float* esq, int d, int K) {
  for (int i = threadIdx.x; i < d * K; i += blockDim.x) es[i] = eh[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) {
      const float e = es[j * K + k];
      s = fmaf(e, e, s);
    }
    esq[k] = s;
  }
  __syncthreads();
}

// One warp: copy the input row ``xr`` [d] to ``xw`` (shared memory) and
// return the index of its nearest codeword, the same value in every lane.
__device__ __forceinline__ int warp_nearest(const float* __restrict__ xr, float* xw,
                                            const float* es, const float* esq, int d, int K,
                                            int lane) {
  float part = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = xr[j];
    xw[j] = v;
    part = fmaf(v, v, part);
  }
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  __syncwarp();
  const float xsq = part;

  float best = CUDART_INF_F;
  int bi = K;
  for (int k = lane; k < K; k += 32) {
    float dot = 0.f;
    for (int j = 0; j < d; ++j) dot = fmaf(xw[j], es[j * K + k], dot);
    // (|x|^2 - 2 x.e) + |e|^2, rounded step by step (no contraction)
    const float dist = __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.f, dot)), esq[k]);
    if (dist < best) {
      best = dist;
      bi = k;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ob < best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  if (bi >= K) bi = 0;  // every distance was NaN
  return bi;
}

// One warp: write codeword ``bi`` of the staged codebook to ``qr`` [d].
__device__ __forceinline__ void warp_store_codeword(float* __restrict__ qr, const float* es,
                                                    int bi, int d, int K, int lane) {
  for (int j = lane; j < d; j += 32) qr[j] = es[j * K + bi];
}

}  // namespace vq
