// Multi-head nearest-codeword snap: argmin over squared L2 distances and
// the gather of the chosen codeword, with no EMA statistics.
//
// Replaces: msmctts_tpu/ops/pallas_vq.py::vq_nearest (Pallas kernel
// _vq_snap_kernel, pallas_vq.py:133-194). On the serving path it carries
// every inference quantization: the predictor's per-stage snap and the
// synthesis re-quantization (the TPU path ran the stats kernel _vq_kernel
// there and discarded the statistics).
//
// What bounds it on an H100: memory and launch time. At the CSMSC shapes
// (N = 512 or 2048 rows, H = 4 heads, d = 64, K = 64) one call reads
// N*H*d*4 bytes and writes as many again (2 MB each at N = 2048) and does
// 2*N*H*d*K FLOP, which is under 3 us of either DRAM or fp32 FMA time;
// the launch itself costs as much.
//
// Design: block (row tile, head). The head's codebook E [d, K] and its
// squared norms |E|^2 [K] are staged in shared memory (16.25 KB at CSMSC),
// so device memory sees each input row once and each output row once. One
// warp per row: the row goes to shared memory, each lane takes codewords
// k = lane, lane + 32, ..., computes dist = |x|^2 - 2 x.E + |E|^2 in fp32
// in the reference's order of operations, keeps the first minimum (strict
// <), and a butterfly reduction breaks ties to the lower index, as
// jnp.argmin and torch.argmin do. x is read through its row and head
// strides as it comes ([N, H, d], unit stride in d); no head-major copy and
// no padding of N: the last tile is masked.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;          // keep in sync with ops/vq.py
constexpr int kRowsPerBlock = 64;  // rows of one head per block

__global__ void __launch_bounds__(kWarps * 32)
vq_nearest_kernel(const float* __restrict__ x, long long stride_n, long long stride_h,
                  const float* __restrict__ embed, int* __restrict__ idx,
                  float* __restrict__ quant, int N, int H, int d, int K) {
  extern __shared__ float smem[];
  float* es = smem;         // [d][K] codebook of this head
  float* esq = es + d * K;  // [K] squared codeword norms
  float* xs = esq + K;      // [kWarps][d] one input row per warp

  const int h = blockIdx.y;
  const float* eh = embed + (size_t)h * d * K;
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

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xw = xs + warp * d;
  const int row0 = (int)blockIdx.x * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);
  for (int n = row0 + warp; n < row_end; n += kWarps) {
    const float* xr = x + (long long)n * stride_n + (long long)h * stride_h;
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
    if (lane == 0) idx[(size_t)n * H + h] = bi;
    float* qr = quant + ((size_t)n * H + h) * d;
    for (int j = lane; j < d; j += 32) qr[j] = es[j * K + bi];
    __syncwarp();  // xw is rewritten by the warp's next row
  }
}

}  // namespace

extern "C" int vq_nearest_launch(const float* x, long long stride_n, long long stride_h,
                                 const float* embed, int* idx, float* quant,
                                 int N, int H, int d, int K, void* stream) {
  if (N == 0) return 0;
  const size_t smem = (size_t)(d * K + K + kWarps * d) * sizeof(float);
  if (smem > 48 * 1024) {  // beyond the default dynamic shared-memory limit
    cudaError_t err = cudaFuncSetAttribute(
        vq_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, H);
  vq_nearest_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, stride_n, stride_h, embed, idx, quant, N, H, d, K);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
