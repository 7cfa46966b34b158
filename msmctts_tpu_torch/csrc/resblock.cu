// Fused HiFi-GAN MRF dilation layer on Hopper's tensor cores:
//   y = x + conv_k(lrelu(dconv_{k,d}(lrelu(x), w1, b1)), w2, b2)
// leaky-relu slope 0.1, torch 'same' zero padding on both convs, the mid
// activation zeroed outside [0, T). x, y are [B, T, C] fp32 (channels
// last); b1, b2 are [C]; the weights come prepared (ops/resblock.py::
// prepare_taps): both convs' taps split into a TF32 head and a TF32 tail and
// laid out as the shared-memory image the tensor cores read.
//
// Replaces: msmctts_tpu/ops/pallas_resblock.py::fused_resblock_layer
// (Pallas kernel _make_kernel, pallas_resblock.py:62-158), which took only
// C in {128, 256} (TPU lane width) and ran its dots at Precision.HIGHEST, a
// multi-pass split of fp32 on the MXU. This kernel takes the four CSMSC
// widths, C in {256, 128, 64, 32}, any odd k and any dilation that fits
// shared memory: all 36 dilation layers of a HiFi-GAN decode.
//
// What bounds it on an H100: operations. A layer does 4*k*C^2*B*T FLOP
// against 8*B*T*C bytes of activations (k*C/2 FLOP per byte, 48 to 1400 at
// CSMSC). fp32 FMA peaks at 67 TFLOP/s; the tensor cores at 495 TFLOP/s in
// TF32, a third of which, 165 TFLOP/s, is the ceiling of the 3xTF32 scheme
// that keeps fp32-class accuracy:
//   a*b ~= a_lo*b_hi + a_hi*b_lo + a_hi*b_hi   (hi = tf32(v), lo = tf32(v - hi))
//
// Design. Each conv is an implicit GEMM: for tap j the product
// [M rows, C_in] x [C_in, C_out] on rows shifted by j*d (conv1) or j (conv2),
// k8 slice by k8 slice, with wgmma.mma_async m64nNk8 (wgmma_tf32.cuh).
//   * A (activations) comes from registers: one fp32 plane of lrelu(x), later
//     of mid, lies row-major in shared memory (rows padded to C+4 floats, so
//     a fragment load hits 32 banks); a thread loads its 4 values at any row
//     shift with plain loads and splits them in registers, so tap shifts cost
//     nothing and the split costs no shared memory. Fragments are double
//     buffered: slice s+1 is loaded while the products of slice s run.
//   * B (weights) is staged and shared: a producer warp streams slabs of
//     kSlabSteps k8 slices (all C_out, head and tail; 8 or 16 KB) through a
//     ring in shared memory with cp.async.bulk and mbarriers (full / empty
//     per stage), 2 to 6 stages deep, so copies overlap the products and one
//     slab feeds both consumer warpgroups. The slabs are stored in device
//     memory as they lie in shared memory, so a copy is one contiguous block.
//   * The tensor cores add to their accumulator with truncation; over the
//     hundreds of slices of a conv that bias reaches 1e-4. So they accumulate
//     only kFlush slices (a tap's C/8 where that is fewer; small terms
//     first), and the partial is then added to a second fp32 register
//     accumulator with round-to-nearest.
//   * A block owns M time rows (a multiple of 64) and all C_out: two consumer
//     warpgroups, side by side in C_out at C = 256 (64 x 128 each), else one
//     below the other in time. conv1 computes mid rows [t0-h2, t0-h2+M),
//     which go through bias, lrelu and the [0, T) mask into the x buffer
//     (conv1 no longer reads it) and never to device memory; conv2 computes M
//     rows of which the first M-(k-1) are stored with bias and the residual,
//     re-read from device memory. The halo costs (k-1)/M of each conv.
//   * ops/resblock.py::plan_layer is the single source of M, ring depth and
//     shared bytes; the launcher takes them from it and refuses an M that is
//     not this width's.
// L2 traffic: each block streams the layer's prepared weights once,
// 16*k*C^2 bytes, for M-(k-1) output rows.

#include "wgmma_tf32.cuh"

namespace {

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kFlush = 16;                  // k8 slices per tensor-core accumulation
constexpr int kMaxStages = 8;
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

// C: channels; NW: output channels per warpgroup, which owns 64 rows;
// BLOCKS: blocks per SM the registers are budgeted for.
template <int C, int NW, int BLOCKS>
struct Config {
  static constexpr int kColSplit = C / NW;                 // warpgroups side by side in C_out
  static constexpr int kRowGroups = 2 / kColSplit;         // warpgroups stacked in time
  static constexpr int kM = kRowGroups * 64;               // rows per block
  static constexpr int kChunks = C / 8;                    // k8 slices per tap
  static constexpr int kSlabSteps = 256 / C < kChunks ? 256 / C : kChunks;  // 16 KB, within a tap
  static_assert(C % 32 == 0 && C <= 256 && 2 % kColSplit == 0, "no body for this width");
  static constexpr int kStepBytes = C * 64;                // one k8 slice: C_out x 8 x (head, tail)
  static constexpr int kSlabBytes = kSlabSteps * kStepBytes;
  static constexpr int kLd = C + 4;
};

template <int C, int NW, int BLOCKS>
__global__ void __launch_bounds__(kThreads, BLOCKS)
resblock_kernel(const float* __restrict__ x, const float* __restrict__ wprep,
                const float* __restrict__ b1, const float* __restrict__ b2,
                float* __restrict__ out, int T, int k, int dil, int stages) {
  using Cfg = Config<C, NW, BLOCKS>;
  constexpr int M = Cfg::kM, LD = Cfg::kLd, KS = Cfg::kSlabSteps, CHUNKS = Cfg::kChunks;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + 128;
  float* xs = reinterpret_cast<float*>(ring + (size_t)stages * Cfg::kSlabBytes);

  const int h2 = (k - 1) / 2;
  const int ha = h2 * dil + h2;
  const int rows_x = M + (k - 1) * dil;  // x rows [t0 - ha, t0 - ha + rows_x)
  const int tile_out = M - (k - 1);
  const int b = blockIdx.y;
  const int t0 = (int)blockIdx.x * tile_out;
  const int S = k * CHUNKS;  // k8 slices per conv

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(full + s, 1);
      tc::mbar_init(empty + s, kConsumers / 32);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kConsumers / 32) {
    // producer: keep the ring full of weight slabs, conv1's then conv2's
    if (lane == 0) {
      const int slabs = 2 * S / KS;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wprep);
      for (int s = 0; s < slabs; ++s) {
        const int stage = s % stages;
        tc::mbar_wait(empty + stage, ((s / stages) & 1) ^ 1);
        tc::mbar_expect_tx(full + stage, Cfg::kSlabBytes);
        tc::bulk_copy_g2s(ring + (size_t)stage * Cfg::kSlabBytes, src + (size_t)s * Cfg::kSlabBytes,
                          Cfg::kSlabBytes, full + stage);
      }
    }
    return;
  }

  // ---- consumers
  const float* xb = x + (size_t)b * T * C;
  for (int i = threadIdx.x; i < rows_x * (C / 4); i += kConsumers) {
    const int r = i / (C / 4);
    const int c = (i - r * (C / 4)) * 4;
    const int t = t0 - ha + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C + c));
    v.x = lrelu(v.x), v.y = lrelu(v.y), v.z = lrelu(v.z), v.w = lrelu(v.w);
    *reinterpret_cast<float4*>(xs + r * LD + c) = v;
  }
  tc::named_barrier(1, kConsumers);

  const int wg = warp >> 2;
  const int col0 = (wg % Cfg::kColSplit) * NW;  // this warpgroup's first output channel
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = (wg / Cfg::kColSplit) * 64 + (warp & 3) * 16 + g;  // the thread's rows: row0, row0 + 8
  const uint32_t ring_addr = tc::smem_u32(ring) + col0 * 32;

  float acc[NW / 2];   // the conv's sum
  float part[NW / 2];  // the tensor cores' partial sum
  uint32_t ahi[2][4], alo[2][4];

  // fragments of k8 slice ``chunk`` of tap ``j`` of a conv whose taps are ``shift`` rows apart
  auto load_a = [&](uint32_t (&hi)[4], uint32_t (&lo)[4], int j, int chunk, int shift) {
    const float* q = xs + (row0 + j * shift) * LD + chunk * 8 + tq;
    tc::split_tf32(q[0], hi[0], lo[0]);
    tc::split_tf32(q[8 * LD], hi[1], lo[1]);
    tc::split_tf32(q[4], hi[2], lo[2]);
    tc::split_tf32(q[8 * LD + 4], hi[3], lo[3]);
  };

  int slab = 0;  // weight slabs consumed so far, over both convs
#pragma unroll 1
  for (int conv = 0; conv < 2; ++conv) {
    const int shift = conv == 0 ? dil : 1;
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    load_a(ahi[0], alo[0], 0, 0, shift);

    // Per tap the CHUNKS slices are unrolled, so which slice opens a slab,
    // which ends a partial sum and which fragment buffer it reads are fixed
    // at compile time; only the barrier waits depend on the run.
#pragma unroll 1
    for (int j = 0; j < k; ++j) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        constexpr int kEvery = CHUNKS < kFlush ? CHUNKS : kFlush;
        const int u = c & 1;  // this slice's fragment buffer; the next slice's is u ^ 1
        const int ks = c % KS;
        const bool opens = c % kEvery == 0;          // starts a partial sum
        const bool flush = (c + 1) % kEvery == 0;    // ends it
        const int stage = slab % stages;
        if (ks == 0) tc::mbar_wait(full + stage, (slab / stages) & 1);
        const uint32_t base = ring_addr + stage * Cfg::kSlabBytes + ks * Cfg::kStepBytes;
        const uint64_t dhi = tc::make_desc(base, 128, 256);
        const uint64_t dlo = tc::make_desc(base + C * 32, 128, 256);
        tc::wgmma_fence();
        tc::mma_rs<NW>(part, alo[u], dhi, opens ? 0 : 1);  // small terms first
        tc::mma_rs<NW>(part, ahi[u], dlo, 1);
        tc::mma_rs<NW>(part, ahi[u], dhi, 1);
        tc::wgmma_commit();
        if (flush)
          tc::wgmma_wait<0>();
        else
          tc::wgmma_wait<1>();
        // the slice before this one is done, and this one too after a flush:
        // hand their slabs back to the producer
        if (!opens && ks == 0 && lane == 0) tc::mbar_arrive(empty + (slab + stages - 1) % stages);
        if (ks == KS - 1) {
          if (flush && lane == 0) tc::mbar_arrive(empty + stage);
          ++slab;
        }
        // the other fragment buffer is free now: the next slice's fragments
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tc::pin(ahi[u ^ 1][i]);
          tc::pin(alo[u ^ 1][i]);
        }
        if (c + 1 < CHUNKS)
          load_a(ahi[u ^ 1], alo[u ^ 1], j, c + 1, shift);
        else if (j + 1 < k)
          load_a(ahi[u ^ 1], alo[u ^ 1], j + 1, 0, shift);
        if (flush) {
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) {
            tc::pin(part[i]);
            acc[i] += part[i];
          }
        }
      }
    }

    if (conv == 0) {
      // mid = lrelu(conv1 + b1), zero outside [0, T), over the x buffer
      tc::named_barrier(1, kConsumers);  // every warp has read its last x fragment
#pragma unroll
      for (int i = 0; i < NW / 2; i += 2) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int col = col0 + 8 * (i / 4) + 2 * tq;
        const int t = t0 - h2 + row;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + col));
        float2 v = make_float2(0.f, 0.f);
        if (t >= 0 && t < T) v = make_float2(lrelu(acc[i] + bias.x), lrelu(acc[i + 1] + bias.y));
        *reinterpret_cast<float2*>(xs + row * LD + col) = v;
      }
      tc::named_barrier(1, kConsumers);
    } else {
#pragma unroll
      for (int i = 0; i < NW / 2; i += 2) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int col = col0 + 8 * (i / 4) + 2 * tq;
        const int t = t0 + row;
        if (row < tile_out && t < T) {
          const size_t off = ((size_t)b * T + t) * C + col;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + col));
          const float2 r = __ldg(reinterpret_cast<const float2*>(x + off));
          *reinterpret_cast<float2*>(out + off) =
              make_float2(r.x + (acc[i] + bias.x), r.y + (acc[i + 1] + bias.y));
        }
      }
    }
  }
}

template <int C, int NW, int BLOCKS>
int launch(const float* x, const float* wprep, const float* b1, const float* b2, float* out,
           int B, int T, int k, int dil, int tile, int stages, cudaStream_t stream) {
  using Cfg = Config<C, NW, BLOCKS>;
  if (tile != Cfg::kM || stages < 2 || stages > kMaxStages || k >= Cfg::kM) return (int)cudaErrorInvalidValue;
  const size_t smem = 128 + (size_t)stages * Cfg::kSlabBytes +
                      (size_t)(Cfg::kM + (k - 1) * dil) * Cfg::kLd * sizeof(float);
  auto kernel = resblock_kernel<C, NW, BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_out = Cfg::kM - (k - 1);
  const dim3 grid((T + tile_out - 1) / tile_out, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, wprep, b1, b2, out, T, k, dil, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// tile (rows per block) and stages (ring depth) come from
// ops/resblock.py::plan_layer; wprep from ops/resblock.py::prepare_taps.
extern "C" int resblock_launch(const float* x, const float* wprep, const float* b1, const float* b2,
                               float* out, int B, int T, int C, int k, int dil, int tile, int stages,
                               void* stream) {
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 256: return launch<256, 128, 1>(x, wprep, b1, b2, out, B, T, k, dil, tile, stages, s);
    case 128: return launch<128, 128, 1>(x, wprep, b1, b2, out, B, T, k, dil, tile, stages, s);
    case 64: return launch<64, 64, 2>(x, wprep, b1, b2, out, B, T, k, dil, tile, stages, s);
    case 32: return launch<32, 32, 3>(x, wprep, b1, b2, out, B, T, k, dil, tile, stages, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
