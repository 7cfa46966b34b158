// Multi-head nearest-codeword snap: argmin over squared L2 distances and
// the gather of the chosen codeword, with no EMA statistics.
//
// Replaces: msmctts_tpu/ops/pallas_vq.py::vq_nearest (Pallas kernel
// _vq_snap_kernel, pallas_vq.py:133-194). On the serving path it carries
// every inference quantization: the predictor's per-stage snap and the
// synthesis re-quantization (the TPU path ran the stats kernel _vq_kernel
// there and discarded the statistics).
//
// What bounds it on an H100: latency. At the CSMSC shapes (N = 512 or 2048
// rows, H = 4 heads, d = 64, K = 64) one call reads N*H*d*4 bytes and writes
// as many again (2 MB each at N = 2048) and does 2*N*H*d*K FLOP, which is
// under 3 us of either DRAM or fp32 FMA time; what a block spends is the
// wait for its codebook, then chains of d dependent fmaf per distance.
//
// Design: block (row tile of 64, head), 8 warps, each warp one group of 8
// rows. A warp first asks for its rows (16-byte loads, through the row and
// head strides of x [N, H, d] as it comes: no head-major copy, no padding of
// N, the last group is short), then the block stages the head's codebook
// E [d, K], its transpose and |E|^2 [K] in shared memory (33.5 KB at CSMSC),
// so both waits overlap and device memory sees each input row once and each
// output row once. The search (vq_common.cuh, shared with vq_stats.cu) runs
// the 8 rows against the lane's codewords as 16 independent fmaf chains;
// the chosen codewords leave as 16-byte stores from the transposed copy.

#include "vq_common.cuh"

namespace {

using vq::kGroup;
using vq::kRowsPerBlock;
using vq::kWarps;

__global__ void __launch_bounds__(kWarps * 32)
vq_nearest_kernel(const float* __restrict__ x, long long stride_n, long long stride_h,
                  const float* __restrict__ embed, int* __restrict__ idx,
                  float* __restrict__ quant, int N, int H, int d, int K) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;                        // [d][K] codebook of this head
  float* et = es + d * K;                  // [K][et_stride(d)] its transpose
  float* xs = et + K * vq::et_stride(d);   // [kWarps][kGroup][d] one row group per warp
  float* esq = xs + kWarps * kGroup * d;   // [K] squared codeword norms
  int* gidx = reinterpret_cast<int*>(esq + K);  // [kWarps][kGroup] chosen codewords

  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xg = xs + warp * kGroup * d;
  int* gi = gidx + warp * kGroup;
  const int row0 = (int)blockIdx.x * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, N);

  // the warp's first group is on its way while the codebook is staged
  int n0 = row0 + warp * kGroup;
  if (n0 < row_end)
    vq::warp_load_rows(x + (long long)n0 * stride_n + (long long)h * stride_h, stride_n, xg,
                       min(kGroup, row_end - n0), d, lane);
  vq::stage_codebook(embed + (size_t)h * d * K, es, et, esq, d, K);

  for (; n0 < row_end; n0 += kWarps * kGroup) {
    const int valid = min(kGroup, row_end - n0);
    if (n0 != row0 + warp * kGroup)
      vq::warp_load_rows(x + (long long)n0 * stride_n + (long long)h * stride_h, stride_n, xg,
                         valid, d, lane);
    int bi[kGroup];
    vq::warp_nearest_rows(xg, es, esq, d, K, lane, bi);
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (lane == r) {
        gi[r] = bi[r];
        if (r < valid) idx[(size_t)(n0 + r) * H + h] = bi[r];
      }
    __syncwarp();
    vq::warp_store_codewords(quant + ((size_t)n0 * H + h) * d, (long long)H * d, et, gi, valid, d, lane);
    __syncwarp();  // xg and gi are rewritten by the warp's next group
  }
}

}  // namespace

extern "C" int vq_nearest_launch(const float* x, long long stride_n, long long stride_h,
                                 const float* embed, int* idx, float* quant,
                                 int N, int H, int d, int K, void* stream) {
  if (N == 0) return 0;
  const size_t smem =
      (size_t)(d * K + K * vq::et_stride(d) + kWarps * kGroup * d + K + kWarps * kGroup) * sizeof(float);
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
