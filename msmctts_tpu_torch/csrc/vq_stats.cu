// Multi-head nearest-codeword search with masked EMA statistics: indices,
// codeword rows, and per head counts[k] = sum_n mask[n] * [idx[n] == k] and
// sums[j][k] = sum_n mask[n] * x[n][j] * [idx[n] == k], in fp32.
//
// Replaces: msmctts_tpu/ops/pallas_vq.py::vq_nearest_stats (Pallas kernel
// _vq_kernel, pallas_vq.py:43-130). It runs twice per autoencoder train
// step, once per quantizer stage, and feeds the codebook EMA.
//
// What bounds it on an H100: by the roofline, memory. At the CSMSC shapes
// (N = 1600 or 6400 rows, H = 4, d = 64, K = 64) a call reads N*H*d*4 bytes
// and writes as many (6.5 MB each at N = 6400); the distances take
// 2*N*H*d*K FLOP, under 4 us of fp32 time. What it spends is the search
// (vq_common.cuh, the same as vq_nearest.cu's), which waits on shared-memory
// latency at the few warps an SM holds; the statistics are a sparse sum, one
// value per row and column, which the TPU kernel computes as a dense one-hot
// product and which here costs a list and a few batched adds per tile.
//
// Design. The TPU kernel carries its sums from one grid step to the next;
// blocks here run in no order, and float atomics would make the EMA state
// differ from run to run. So the reduction has a fixed order:
//   1. grid (G, H). Block (g, h) walks the row tiles g, g + G, g + 2G, ...
//      of head h in rising order. For each tile of 64 rows it stages the
//      rows in shared memory (16-byte loads), each warp finds the codewords
//      of one group of 8 rows with the search of vq_common.cuh (bit-equal
//      to vq_nearest.cu), writes idx and quant (16-byte stores), and then
//      the statistics pass scatters each row to the owners of its cells.
//      The sums cells (j, k) fall into items of 32 consecutive j by one
//      slice of the codewords (at d = K = 64: 2 x 4 items of 32 x 16 cells),
//      one item per warp, one j per lane; the counts of a slice belong to
//      lane 0 of the slice's first item. A warp lists the tile's rows whose
//      code falls in its slice, in rising order (ballot and prefix count),
//      and adds them kRun rows at a time: the loads of a batch are
//      independent, and a row whose codeword an earlier row of the batch
//      had starts from that row's result, so every cell still adds its rows
//      one after another in rising order, the fmaf chain of one row at a
//      time. The accumulators lie in shared memory as [d][K | 1]: the 32
//      lanes of a warp (consecutive j, one k) hit 32 banks.
//   2. the block writes its accumulators to part[g][h]; a second kernel adds
//      the G partials of each cell in rising g. It is a programmatic
//      dependent launch: its blocks are scheduled while the first kernel
//      drains, and wait (griddepcontrol.wait) until its partials are
//      written. (Adding them in the last block of each head instead, found
//      by an arrival ticket, leaves one block per head to read G x 16.6 KB:
//      slower than this second launch at every N measured.)
// G depends on N alone (ops/vq.py::stats_plan), so equal inputs give
// bit-equal counts and sums on every launch. Rows past a sequence's length
// (mask 0) still get idx and quant; the statistics weigh them by their mask
// (fmaf(mask, x, s), so a non-finite x there propagates as in the plain
// version). x is read through its strides, N is not padded: the last tile
// is short.

#include "vq_common.cuh"

namespace {

using vq::kGroup;
using vq::kRowsPerBlock;
using vq::kWarps;

constexpr int kRun = 4;          // rows a warp adds to its cells at once
constexpr int kBlocksPerSM = 2;  // the register budget: 128 a thread, two blocks on an SM

// Row stride of the sums accumulators: odd, so 32 consecutive j at one k
// fall in 32 banks.
__host__ __device__ __forceinline__ int acc_stride(int K) { return K | 1; }
// items of the statistics pass: j in chunks of 32, the codewords in slices
__host__ __device__ __forceinline__ int j_chunks(int d) { return (d + 31) / 32; }
__host__ __device__ __forceinline__ int k_slices(int d) { return max(1, kWarps / j_chunks(d)); }

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
vq_stats_kernel(const float* __restrict__ x, long long stride_n, long long stride_h,
                const float* __restrict__ embed, const float* __restrict__ mask,
                int* __restrict__ idx, float* __restrict__ quant, float* __restrict__ part,
                int N, int H, int d, int K) {
  extern __shared__ __align__(16) float smem[];
  const int ldacc = acc_stride(K);
  float* es = smem;                       // [d][K] codebook of this head
  float* et = es + d * K;                 // [K][et_stride(d)] its transpose
  float* xs = et + K * vq::et_stride(d);  // [kRowsPerBlock][d] the tile's rows
  float* acc = xs + kRowsPerBlock * d;    // [d][ldacc] sums
  float* cnt = acc + d * ldacc;           // [K] counts
  float* esq = cnt + K;                   // [K] squared codeword norms
  float* rmask = esq + K;                 // [kRowsPerBlock] row weights
  int* ridx = reinterpret_cast<int*>(rmask + kRowsPerBlock);  // [kRowsPerBlock]
  int* lists = ridx + kRowsPerBlock;      // [kWarps][kRowsPerBlock] rows per warp

  const int h = blockIdx.y;
  for (int e = threadIdx.x; e < d * ldacc + K; e += blockDim.x) acc[e] = 0.f;
  vq::stage_codebook(embed + (size_t)h * d * K, es, et, esq, d, K);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = j_chunks(d), slices = k_slices(d);
  const int width = (K + slices - 1) / slices;
  int* list = lists + warp * kRowsPerBlock;
  const int tiles = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRowsPerBlock;
    const int rows = min(kRowsPerBlock, N - row0);
    for (int g = warp; g < kRowsPerBlock / kGroup; g += kWarps) {
      const int r0 = g * kGroup;
      const int valid = min(kGroup, rows - r0);
      if (valid <= 0) continue;
      const int n0 = row0 + r0;
      float* xg = xs + r0 * d;
      vq::warp_load_rows(x + (long long)n0 * stride_n + (long long)h * stride_h, stride_n, xg, valid, d, lane);
      int bi[kGroup];
      vq::warp_nearest_rows(xg, es, esq, d, K, lane, bi);
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        if (lane == r && r < valid) {
          ridx[r0 + r] = bi[r];
          idx[(size_t)(n0 + r) * H + h] = bi[r];
          rmask[r0 + r] = mask[n0 + r];
        }
      __syncwarp();
      vq::warp_store_codewords(quant + ((size_t)n0 * H + h) * d, (long long)H * d, et, ridx + r0, valid, d, lane);
    }
    __syncthreads();
    // the tile's statistics, each cell by its owner, rows in rising order
    for (int item = warp; item < chunks * slices; item += kWarps) {
      const int j = item % chunks * 32 + lane;
      const int jj = min(j, d - 1);  // a lane past d reads and discards
      const int k0 = item / chunks * width, k1 = min(K, k0 + width);
      const bool owns_counts = item % chunks == 0 && lane == 0;
      float* aj = acc + jj * ldacc;
      int n = 0;
      for (int base = 0; base < rows; base += 32) {
        const int r = base + lane;
        const int c = r < rows ? ridx[r] : -1;
        const bool mine = c >= k0 && c < k1;
        const unsigned m = __ballot_sync(0xffffffffu, mine);
        if (mine) list[n + __popc(m & ((1u << lane) - 1u))] = r;
        n += __popc(m);
      }
      __syncwarp();
      for (int t = 0; t < n; t += kRun) {
        // a batch past the list's end repeats its last row with weight 0:
        // fmaf(0, 0, s) and s + 0 leave every value as it is
        int kk[kRun];
        float w[kRun], xv[kRun], a[kRun], ca[kRun];
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const bool real = t + u < n;
          const int r = list[real ? t + u : n - 1];
          kk[u] = ridx[r];
          w[u] = real ? rmask[r] : 0.f;
          xv[u] = real ? xs[r * d + jj] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          a[u] = aj[kk[u]];
          ca[u] = owns_counts ? cnt[kk[u]] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
#pragma unroll
          for (int p = 0; p < u; ++p)
            if (kk[p] == kk[u]) {  // the latest earlier row of this codeword
              a[u] = a[p];
              ca[u] = ca[p];
            }
          a[u] = fmaf(w[u], xv[u], a[u]);
          ca[u] += w[u];
        }
#pragma unroll
        for (int u = 0; u < kRun; ++u) {  // in order: the last row of a codeword stores last
          if (j < d) aj[kk[u]] = a[u];
          if (owns_counts) cnt[kk[u]] = ca[u];
        }
      }
      __syncwarp();  // the list is rewritten by the warp's next item or tile
    }
    __syncthreads();  // xs, ridx and rmask are rewritten by the next tile
  }
  const int cells = K + d * K;
  float* out = part + ((size_t)blockIdx.x * H + h) * cells;
  for (int e = threadIdx.x; e < cells; e += blockDim.x)
    out[e] = e < K ? cnt[e] : acc[(e - K) / K * ldacc + (e - K) % K];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// counts [H][K] and sums [H][d][K] from part [G][H][K + d*K], adding the G
// partials of each cell in rising g.
__global__ void vq_stats_reduce_kernel(const float* __restrict__ part, float* __restrict__ counts,
                                       float* __restrict__ sums, int G, int H, int d, int K) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // every block of vq_stats_kernel has finished
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
// 1 <= G <= ceil(N / 64), from ops/vq.py::stats_plan.
extern "C" int vq_stats_launch(const float* x, long long stride_n, long long stride_h,
                               const float* embed, const float* mask, int* idx, float* quant,
                               float* part, float* counts, float* sums, int N, int H, int d,
                               int K, int G, void* stream) {
  if (N == 0) return 0;
  const size_t smem = (size_t)(d * K + K * vq::et_stride(d) + kRowsPerBlock * d + d * acc_stride(K) + 2 * K +
                               2 * kRowsPerBlock + kWarps * kRowsPerBlock) * sizeof(float);
  if (smem > 48 * 1024) {  // beyond the default dynamic shared-memory limit
    cudaError_t err = cudaFuncSetAttribute(
        vq_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  vq_stats_kernel<<<dim3(G, H), kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, stride_n, stride_h, embed, mask, idx, quant, part, N, H, d, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H * (K + d * K) + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, vq_stats_reduce_kernel, (const float*)part, counts, sums, G, H, d, K);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
