// Device code shared by vq_nearest.cu and vq_stats.cu: the nearest-codeword
// search of one head, so that both kernels give bit-equal indices and
// codeword rows on the same inputs.
//
// The rounding of every step is fixed: each (row, codeword) dot is one fmaf
// chain over j = 0..d-1 in rising order, dist = (|x|^2 - 2 x.e) + |e|^2 in
// fp32 with no contraction across the three terms, strict < while a lane
// scans its codewords k = lane, lane + 32, ... in rising order, and a
// butterfly reduction that breaks ties to the lower index, as jnp.argmin and
// torch.argmin do; |x|^2 is a lane-strided sum and a shuffle tree.
//
// What bounds the search: latency, not work. A dot is a chain of d dependent
// fmaf, so a warp that takes one row at a time waits on two chains per lane.
// Here a warp takes a group of 8 rows at once: each lane runs 16 independent
// chains (2 codewords x 8 rows), every codebook value it reads from shared
// memory feeds all 8 rows, and the rows are read as 16-byte broadcasts (4
// values of j per load), so per 4 steps of j a lane issues 8 + 8 loads for 64
// fmaf. The codebook lies in shared memory twice: es [d][K] for the dots
// (lanes on consecutive k: no bank conflict) and et [K][d + 4] for the
// gather of the chosen codewords (a row is contiguous: 16-byte reads).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace vq {

constexpr int kWarps = 8;          // keep in sync with ops/vq.py
constexpr int kRowsPerBlock = 64;  // rows of one head per tile
constexpr int kGroup = 8;          // rows a warp searches at once

// Row stride of et in floats: a multiple of 4 (16-byte rows) that is no
// multiple of 32 at d = 64 (rows start in different banks).
__host__ __device__ __forceinline__ int et_stride(int d) { return (d + 3) / 4 * 4 + 4; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whole block: one head's codebook E [d][K] to ``es``, its transpose to
// ``et`` [K][et_stride(d)] and its squared codeword norms to ``esq`` [K]
// (all shared memory). Ends synchronised.
__device__ __forceinline__ void stage_codebook(const float* __restrict__ eh, float* es, float* et,
                                               float* esq, int d, int K) {
  const int n = d * K;
  if (n % 4 == 0 && aligned16(eh)) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<float4*>(es)[i] = __ldg(reinterpret_cast<const float4*>(eh) + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) es[i] = eh[i];
  }
  __syncthreads();
  const int ldt = et_stride(d);
  if (d % 4 == 0) {
    for (int i = threadIdx.x; i < K * (d / 4); i += blockDim.x) {
      const int k = i % K, j = i / K * 4;
      *reinterpret_cast<float4*>(et + k * ldt + j) =
          make_float4(es[j * K + k], es[(j + 1) * K + k], es[(j + 2) * K + k], es[(j + 3) * K + k]);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) et[(i % K) * ldt + i / K] = es[i];
  }
  // one chain per codeword, j rising; the K chains run side by side
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < d; ++j) {
      const float e = es[j * K + k];
      s = fmaf(e, e, s);
    }
    esq[k] = s;
  }
  __syncthreads();
}

// One warp: rows n0 .. n0 + valid - 1 (valid <= kGroup) of head h to ``xg``
// [kGroup][d] (shared memory), the rows past ``valid`` as zeros.
__device__ __forceinline__ void warp_load_rows(const float* __restrict__ x, long long stride_n,
                                               float* xg, int valid, int d, int lane) {
  const bool vec = d % 4 == 0 && stride_n % 4 == 0 && aligned16(x);
  if (vec) {
    const int q = d / 4;
    for (int i = lane; i < kGroup * q; i += 32) {
      const int r = i / q, c = i - r * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid) v = __ldg(reinterpret_cast<const float4*>(x + r * stride_n) + c);
      reinterpret_cast<float4*>(xg + r * d)[c] = v;
    }
  } else {
    for (int i = lane; i < kGroup * d; i += 32) {
      const int r = i / d, j = i - r * d;
      xg[i] = r < valid ? x[r * stride_n + j] : 0.f;
    }
  }
  __syncwarp();
}

// One warp: the nearest codeword of each of the kGroup rows at ``xg``
// [kGroup][d] (shared memory) -> bi[r], the same values in every lane.
__device__ __forceinline__ void warp_nearest_rows(const float* xg, const float* es,
                                                  const float* esq, int d, int K, int lane,
                                                  int (&bi)[kGroup]) {
  float xsq[kGroup], best[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    float part = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = xg[r * d + j];
      part = fmaf(v, v, part);
    }
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    xsq[r] = part;
    best[r] = CUDART_INF_F;
    bi[r] = K;
  }

  for (int k0 = 0; k0 < K; k0 += 64) {
    const int ka = k0 + lane, kb = ka + 32;
    const float* ea = es + min(ka, K - 1);  // a lane past K computes and discards
    const float* eb = es + min(kb, K - 1);
    float da[kGroup], db[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) da[r] = db[r] = 0.f;
    if (d % 4 == 0) {
      for (int j = 0; j < d; j += 4) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ea[(j + i) * K];
          b[i] = eb[(j + i) * K];
        }
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(xg + r * d + j);
          da[r] = fmaf(v.x, a[0], da[r]);
          db[r] = fmaf(v.x, b[0], db[r]);
          da[r] = fmaf(v.y, a[1], da[r]);
          db[r] = fmaf(v.y, b[1], db[r]);
          da[r] = fmaf(v.z, a[2], da[r]);
          db[r] = fmaf(v.z, b[2], db[r]);
          da[r] = fmaf(v.w, a[3], da[r]);
          db[r] = fmaf(v.w, b[3], db[r]);
        }
      }
    } else {
      for (int j = 0; j < d; ++j) {
        const float a = ea[j * K], b = eb[j * K];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float v = xg[r * d + j];
          da[r] = fmaf(v, a, da[r]);
          db[r] = fmaf(v, b, db[r]);
        }
      }
    }
    // (|x|^2 - 2 x.e) + |e|^2, rounded step by step (no contraction)
    if (ka < K) {
      const float sq = esq[ka];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const float dist = __fadd_rn(__fsub_rn(xsq[r], __fmul_rn(2.f, da[r])), sq);
        if (dist < best[r]) {
          best[r] = dist;
          bi[r] = ka;
        }
      }
    }
    if (kb < K) {
      const float sq = esq[kb];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const float dist = __fadd_rn(__fsub_rn(xsq[r], __fmul_rn(2.f, db[r])), sq);
        if (dist < best[r]) {
          best[r] = dist;
          bi[r] = kb;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[r], o);
      if (ob < best[r] || (ob == best[r] && oi < bi[r])) {
        best[r] = ob;
        bi[r] = oi;
      }
    }
    if (bi[r] >= K) bi[r] = 0;  // every distance was NaN
  }
}

// One warp: codewords ``gidx[r]`` (shared memory) of the staged transpose to
// rows r < valid of ``q`` (row stride ``stride`` floats, d floats a row).
__device__ __forceinline__ void warp_store_codewords(float* __restrict__ q, long long stride,
                                                     const float* et, const int* gidx, int valid,
                                                     int d, int lane) {
  const int ldt = et_stride(d);
  if (d % 4 == 0 && stride % 4 == 0 && aligned16(q)) {
    const int nq = d / 4;
    for (int i = lane; i < valid * nq; i += 32) {
      const int r = i / nq, c = i - r * nq;
      reinterpret_cast<float4*>(q + r * stride)[c] =
          reinterpret_cast<const float4*>(et + gidx[r] * ldt)[c];
    }
  } else {
    for (int i = lane; i < valid * d; i += 32) {
      const int r = i / d, j = i - r * d;
      q[r * stride + j] = et[gidx[r] * ldt + j];
    }
  }
}

}  // namespace vq
