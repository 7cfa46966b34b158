// Fused HiFi-GAN MRF dilation layer:
//   y = x + conv_k(lrelu(dconv_{k,d}(lrelu(x), w1, b1)), w2, b2)
// leaky-relu slope 0.1, torch 'same' zero padding on both convs, the mid
// activation zeroed outside [0, T). x, y are [B, T, C] fp32 (channels
// last); w1, w2 are [k, C_in, C_out] (tap, in, out); b1, b2 are [C].
//
// Replaces: msmctts_tpu/ops/pallas_resblock.py::fused_resblock_layer
// (Pallas kernel _make_kernel, pallas_resblock.py:62-158), which took only
// C in {128, 256} (TPU lane width). This kernel takes every CSMSC MRF layer:
// C 256/128/64/32, k 3/7/11, d 1/3/5, i.e. all 36 dilation layers of a
// HiFi-GAN decode, and any C that is a multiple of 4 up to 1024.
//
// What bounds it on an H100: operations. A layer does 4*k*C^2*B*T FLOP
// against 8*B*T*C bytes of activations (k*C/2 FLOP per byte, 48 to 1400
// at CSMSC), far above the fp32 ridge of ~20 FLOP/byte, so it is bound by
// the 67 TFLOP/s of fp32 FMA (495 TF32 / 989 bf16 on tensor cores, which
// this first version does not use).
//
// Design: one block per (time tile, batch row), computing all C output
// channels, so that conv1's output never leaves the SM:
//   1. lrelu(x) for the tile plus a halo of (k-1)/2*d + (k-1)/2 rows on
//      each side goes to shared memory (zeros outside [0, T), which is the
//      zero padding of the conv's input since lrelu(0) = 0);
//   2. conv1 fills a shared mid buffer of tile + (k-1) rows; mid rows
//      outside [0, T) are zeroed, which is conv2's zero padding;
//   3. conv2 and the residual add write the tile; only y returns to DRAM.
// Each thread owns 4 consecutive output channels (one float4 of weights per
// input channel and tap, read through L1/L2) and RT time rows, so one weight
// load feeds 4*RT FMAs and one shared load feeds 4. Shared rows are padded
// to C+1 floats so the time lanes of one warp hit distinct banks. The time
// tile is chosen on the host by C, k and d so both buffers fit the 227 KB
// of shared memory (ops/resblock.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // keep in sync with ops/resblock.py
constexpr int kRows = 8;       // time rows per thread and pass
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

// acc[m][*] += sum_j sum_ci src[(row_m + j*step) * ld + ci] * w[j][ci][co..co+3]
__device__ __forceinline__ void conv_rows(float (&acc)[kRows][4], const int (&rows)[kRows],
                                          const float* __restrict__ src, int ld, int step,
                                          const float* __restrict__ w, int C, int k, int co) {
  for (int j = 0; j < k; ++j) {
    const float* wj = w + (size_t)j * C * C + co;
    const float* sj = src + j * step * ld;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wj + (size_t)ci * C));
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const float xv = sj[rows[m] * ld + ci];
        acc[m][0] = fmaf(xv, wv.x, acc[m][0]);
        acc[m][1] = fmaf(xv, wv.y, acc[m][1]);
        acc[m][2] = fmaf(xv, wv.z, acc[m][2]);
        acc[m][3] = fmaf(xv, wv.w, acc[m][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
resblock_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out,
                int T, int C, int k, int dil, int tile) {
  extern __shared__ float smem[];
  const int ld = C + 1;
  const int h2 = (k - 1) / 2;
  const int ha = h2 * dil + h2;
  const int rx = tile + 2 * ha;  // x rows [t0 - ha, t0 + tile + ha)
  const int rm = tile + 2 * h2;  // mid rows [t0 - h2, t0 + tile + h2)
  float* xs = smem;
  float* ms = smem + rx * ld;

  const int b = blockIdx.y;
  const int t0 = (int)blockIdx.x * tile;
  const float* xb = x + (size_t)b * T * C;
  const int c4 = C / 4;

  for (int i = threadIdx.x; i < rx * c4; i += kThreads) {
    const int r = i / c4;
    const int c = (i - r * c4) * 4;
    const int t = t0 - ha + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C + c));
    float* dst = xs + r * ld + c;
    dst[0] = lrelu(v.x);
    dst[1] = lrelu(v.y);
    dst[2] = lrelu(v.z);
    dst[3] = lrelu(v.w);
  }
  __syncthreads();

  const int cg = threadIdx.x % c4;
  const int tl = threadIdx.x / c4;
  const int ntl = kThreads / c4;  // time lanes; threads with tl >= ntl idle
  const int co = cg * 4;
  const bool active = tl < ntl;

  // conv1 (dilated): mid row m is time t0 - h2 + m and reads x rows m + j*dil
  if (active) {
    const float4 bias = __ldg(reinterpret_cast<const float4*>(b1 + co));
    for (int base = 0; base < rm; base += ntl * kRows) {
      float acc[kRows][4];
      int rows[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        rows[m] = min(base + tl + m * ntl, rm - 1);
        acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
      }
      conv_rows(acc, rows, xs, ld, dil, w1, C, k, co);
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int row = base + tl + m * ntl;
        if (row < rm) {
          const int t = t0 - h2 + row;
          const bool valid = t >= 0 && t < T;
          float* dst = ms + row * ld + co;
          dst[0] = valid ? lrelu(acc[m][0] + bias.x) : 0.f;
          dst[1] = valid ? lrelu(acc[m][1] + bias.y) : 0.f;
          dst[2] = valid ? lrelu(acc[m][2] + bias.z) : 0.f;
          dst[3] = valid ? lrelu(acc[m][3] + bias.w) : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // conv2: output row o is time t0 + o and reads mid rows o + j
  if (active) {
    const float4 bias = __ldg(reinterpret_cast<const float4*>(b2 + co));
    for (int base = 0; base < tile; base += ntl * kRows) {
      float acc[kRows][4];
      int rows[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        rows[m] = min(base + tl + m * ntl, tile - 1);
        acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
      }
      conv_rows(acc, rows, ms, ld, 1, w2, C, k, co);
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int row = base + tl + m * ntl;
        const int t = t0 + row;
        if (row < tile && t < T) {
          const size_t off = ((size_t)b * T + t) * C + co;
          const float4 r = __ldg(reinterpret_cast<const float4*>(x + off));
          float4 y;
          y.x = r.x + (acc[m][0] + bias.x);
          y.y = r.y + (acc[m][1] + bias.y);
          y.z = r.z + (acc[m][2] + bias.z);
          y.w = r.w + (acc[m][3] + bias.w);
          *reinterpret_cast<float4*>(out + off) = y;
        }
      }
    }
  }
}

}  // namespace

extern "C" int resblock_launch(const float* x, const float* w1, const float* b1,
                               const float* w2, const float* b2, float* out,
                               int B, int T, int C, int k, int dil, int tile, void* stream) {
  if (B == 0 || T == 0) return 0;
  const int h2 = (k - 1) / 2;
  const int ha = h2 * dil + h2;
  const size_t smem = (size_t)((tile + 2 * ha) + (tile + 2 * h2)) * (C + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile - 1) / tile, B);
  resblock_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, out, T, C, k, dil, tile);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
