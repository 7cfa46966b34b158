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
// no padding of N: the last tile is masked. The search itself lives in
// vq_common.cuh, shared with vq_stats.cu.

#include "vq_common.cuh"

namespace {

using vq::kRowsPerBlock;
using vq::kWarps;

__global__ void __launch_bounds__(kWarps * 32)
vq_nearest_kernel(const float* __restrict__ x, long long stride_n, long long stride_h,
                  const float* __restrict__ embed, int* __restrict__ idx,
                  float* __restrict__ quant, int N, int H, int d, int K) {
  extern __shared__ float smem[];
  float* es = smem;         // [d][K] codebook of this head
  float* esq = es + d * K;  // [K] squared codeword norms
  float* xs = esq + K;      // [kWarps][d] one input row per warp

  const int h = blockIdx.y;
  vq::stage_codebook(embed + (size_t)h * d * K, es, esq, d, K);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xw = xs + warp * d;
  const int row0 = (int)blockIdx.x * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);
  for (int n = row0 + warp; n < row_end; n += kWarps) {
    const float* xr = x + (long long)n * stride_n + (long long)h * stride_h;
    const int bi = vq::warp_nearest(xr, xw, es, esq, d, K, lane);
    if (lane == 0) idx[(size_t)n * H + h] = bi;
    vq::warp_store_codeword(quant + ((size_t)n * H + h) * d, es, bi, d, K, lane);
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
