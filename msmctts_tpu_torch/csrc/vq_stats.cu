// Multi-head nearest-codeword search with masked EMA statistics: indices,
// codeword rows, and per head counts[k] = sum_n mask[n] * [idx[n] == k] and
// sums[j][k] = sum_n mask[n] * x[n][j] * [idx[n] == k], in fp32.
//
// Replaces: msmctts_tpu/ops/pallas_vq.py::vq_nearest_stats (Pallas kernel
// _vq_kernel, pallas_vq.py:43-130). It runs twice per autoencoder train
// step, once per quantizer stage, and feeds the codebook EMA.
//
// What bounds it on an H100: memory. At the CSMSC shapes (N = 1600 or 6400
// rows, H = 4, d = 64, K = 64) a call reads N*H*d*4 bytes and writes as many
// (6.5 MB each at N = 6400); the distances take 2*N*H*d*K FLOP and the
// statistics, done as a one-hot product like the TPU kernel's, as many again,
// together under 4 us of fp32 time.
//
// Design. The TPU kernel carries its sums from one grid step to the next;
// blocks here run in no order, and float atomics would make the EMA state
// differ from run to run. So the reduction has a fixed order:
//   1. grid (G, H). Block (g, h) walks the row tiles g, g + G, g + 2G, ...
//      of head h in rising order. For each tile of 64 rows it stages the
//      rows in shared memory, finds each row's codeword with the search of
//      vq_common.cuh (bit-equal to vq_nearest.cu), writes idx and quant, and
//      then every thread adds the tile's rows, in row order, to the
//      accumulators it owns (a fixed set of (j, k) cells kept in shared
//      memory). No two threads share a cell, so there is no atomic.
//   2. the block writes its accumulators to part[g][h]; a second kernel adds
//      the G partials of each cell in rising g.
// G depends on N alone (ops/vq.py), so equal inputs give bit-equal counts
// and sums on every launch. Rows past a sequence's length (mask 0) still get
// idx and quant; only the statistics leave them out. x is read through its
// strides, N is not padded: the last tile is short.

#include "vq_common.cuh"

namespace {

using vq::kRowsPerBlock;
using vq::kWarps;

__global__ void __launch_bounds__(kWarps * 32)
vq_stats_kernel(const float* __restrict__ x, long long stride_n, long long stride_h,
                const float* __restrict__ embed, const float* __restrict__ mask,
                int* __restrict__ idx, float* __restrict__ quant, float* __restrict__ part,
                int N, int H, int d, int K) {
  extern __shared__ float smem[];
  float* es = smem;                     // [d][K] codebook of this head
  float* esq = es + d * K;              // [K] squared codeword norms
  float* xs = esq + K;                  // [kRowsPerBlock][d] the tile's rows
  float* acc = xs + kRowsPerBlock * d;  // [K] counts, then [d][K] sums
  float* rmask = acc + K + d * K;       // [kRowsPerBlock] row weights
  int* ridx = reinterpret_cast<int*>(rmask + kRowsPerBlock);  // [kRowsPerBlock]

  const int h = blockIdx.y;
  const int cells = K + d * K;
  for (int e = threadIdx.x; e < cells; e += blockDim.x) acc[e] = 0.f;
  vq::stage_codebook(embed + (size_t)h * d * K, es, esq, d, K);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRowsPerBlock;
    const int rows = min(kRowsPerBlock, N - row0);
    for (int r = warp; r < kRowsPerBlock; r += kWarps) {
      if (r >= rows) {
        if (lane == 0) ridx[r] = -1;
        continue;
      }
      const int n = row0 + r;
      const float* xr = x + (long long)n * stride_n + (long long)h * stride_h;
      const int bi = vq::warp_nearest(xr, xs + r * d, es, esq, d, K, lane);
      if (lane == 0) {
        idx[(size_t)n * H + h] = bi;
        ridx[r] = bi;
        rmask[r] = mask[n];
      }
      vq::warp_store_codeword(quant + ((size_t)n * H + h) * d, es, bi, d, K, lane);
    }
    __syncthreads();
    // the tile's statistics, rows in rising order, each cell by its owner
    for (int e = threadIdx.x; e < cells; e += blockDim.x) {
      float s = acc[e];
      if (e < K) {
        for (int r = 0; r < rows; ++r)
          if (ridx[r] == e) s += rmask[r];
      } else {
        const int j = (e - K) / K, k = (e - K) % K;
        for (int r = 0; r < rows; ++r)
          if (ridx[r] == k) s = fmaf(rmask[r], xs[r * d + j], s);
      }
      acc[e] = s;
    }
    __syncthreads();  // xs, ridx and rmask are rewritten by the next tile
  }
  float* out = part + ((size_t)blockIdx.x * H + h) * cells;
  for (int e = threadIdx.x; e < cells; e += blockDim.x) out[e] = acc[e];
}

// counts [H][K] and sums [H][d][K] from part [G][H][K + d*K], adding the G
// partials of each cell in rising g.
__global__ void vq_stats_reduce_kernel(const float* __restrict__ part, float* __restrict__ counts,
                                       float* __restrict__ sums, int G, int H, int d, int K) {
  const int cells = K + d * K;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * cells) return;
  const int h = e / cells, o = e % cells;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += part[((size_t)g * H + h) * cells + o];
  if (o < K)
    counts[h * K + o] = s;
  else
    sums[(size_t)h * d * K + (o - K)] = s;
}

}  // namespace

// part is scratch of G*H*(K + d*K) floats; G row-tile walkers per head, with
// 1 <= G <= ceil(N / 64).
extern "C" int vq_stats_launch(const float* x, long long stride_n, long long stride_h,
                               const float* embed, const float* mask, int* idx, float* quant,
                               float* part, float* counts, float* sums, int N, int H, int d,
                               int K, int G, void* stream) {
  if (N == 0) return 0;
  const size_t smem =
      (size_t)(d * K + K + kRowsPerBlock * d + K + d * K + 2 * kRowsPerBlock) * sizeof(float);
  if (smem > 48 * 1024) {  // beyond the default dynamic shared-memory limit
    cudaError_t err = cudaFuncSetAttribute(
        vq_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  vq_stats_kernel<<<dim3(G, H), kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, stride_n, stride_h, embed, mask, idx, quant, part, N, H, d, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cells = H * (K + d * K);
  vq_stats_reduce_kernel<<<(cells + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, counts, sums, G, H, d, K);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
