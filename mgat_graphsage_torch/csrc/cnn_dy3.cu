// Masked fc1 input gradient of the fingerprint CNN, for Hopper (sm_90a).
//
// Replaces: mgat_graphsage_tpu/ops/pallas_cnn.py::_dy3_pallas (_dy3_kernel),
// kernel 1 of the fused CNN-branch backward.
//
// Computes, for every molecule b and pos-major column k = w * C + c of the
// flattened conv3 output (all f32):
//     dy3[b, k] = (sum_h dy[b, h] * fc1_w[h, k]) * (y3[b, k] > 0)
// dyt [H, Bp] is dy transposed by the caller, its columns zero-padded to
// Bp = B rounded up to 128; fc1_w [H, K] (torch Linear layout, K = W * C,
// pos-major columns); y3 [B, K] the post-ReLU conv3 output as the forward
// flattened it; dy3 [B, K], read as [B, W, C] by csrc/cnn_chain_bwd.cu with
// no copy between.  The ReLU mask uses the post-activation, as the
// reference does.
//
// Bound on the H100: operations.  2 B H K flops (8.6 GFLOP at B=128,
// H=256, K=131072, 128 us at 67 TFLOP/s) against the fc1 weight (134 MB),
// y3 and dy3 (67 MB each): 32 flops per byte, only 1.6x above the f32
// ridge of 20, so loads and stores that are not hidden set the pace.
//
// What held the first design back (351 us): a single-buffered loop
// (load, sync, FMAs, sync: nothing in flight while the FMAs ran), dy
// re-read and transposed with scalar, bank-conflicted stores by each of
// the 1024 blocks, and an epilogue (y3 in, dy3 out) that started only
// after the main loop.
//
// Design: a persistent SIMT SGEMM, no library and no tensor cores (the
// f32 preset keeps IEEE f32).  Tiles are 128 molecules x 256 columns,
// 256 threads, each an 8 x 16 register tile (5.3 FMAs per float loaded
// from shared memory, where 8 x 8 gives 4, the point at which a 16-byte
// shared load's four cycles match the FMA pipe); the grid is at most one
// block per SM (512 tiles over 128 blocks at K=131072, 4 each: the same
// finish time as 132 blocks), and each block walks its tiles.  With
// B <= 128 and dyt fitting beside the ring, dyt is copied into shared
// memory once per block (128 KB at H=256) and kept; otherwise dyt's
// 16 x 128 chunks stream through the ring with the weight.  The fc1
// weight streams in 16 x 256 chunks through a 6-stage ring filled by
// cp.async, with one __syncthreads per stage: five chunks stay in flight
// while the FMAs run, across tile boundaries, so one tile's epilogue
// overlaps the next tile's loads.  Each tile's ReLU mask is read from y3
// during its main loop, two float4 per chunk, and kept as 128 bits in
// registers; the epilogue writes four float4 per row with streaming
// stores.  Each output is one thread's sum over h in ascending order: no
// atomics, and the result repeats bit for bit.  Shared memory: 224 KB at
// B <= 128, H = 256.
//
// bf16 variant (cnn_dy3_bf16_launch, compute_dtype="bfloat16"): dy [B, H],
// fc1_w [H, K], y3 and dy3 [B, K], all bf16.  As the reference's kernel
// does (pallas_cnn.py:_dy3_kernel), the products are summed in f32 and the
// sum is rounded once to bf16 (round to nearest even), then masked.
// Bound on the H100 at B=1024, H=256, K=131072: bytes.  fc1 (67 MB), y3
// and dy3 (268 MB each) are 604 MB, 180 us at 3.35 TB/s; the 68.7 GFLOP
// take 69 us at the dense bf16 tensor-core rate, 114 flops a byte against
// the card's ridge of ~295: a memory stream with a product inside.
//
// Design (cnn_dy3_bf16_kernel): persistent and weight-stationary, one block
// per SM.  A work item is one column tile of BN = 128 columns (64 for
// 256 < H <= 512): the block loads the item's weight slab [H, BN] (64 KB at
// H = 256) into shared memory once, so the weight comes from device memory
// once whatever order the blocks run in, and walks all B molecules in
// chunks of 64 against it.  Warp-specialised: one producer warp issues TMA
// loads of each chunk's dy rows [64, H] (a 2-stage ring, from L2, where dy
// stays) and of the slabs; a second one streams the chunks' y3 tiles
// [64, BN] through a ring of its own (2 stages), ahead of the products, so
// the mask is in shared memory before the epilogue needs it and the next
// item's loads are in flight when the slab is swapped.  Two
// consumer warpgroups take alternate chunks (ping-pong: one's epilogue
// overlaps the other's products), each running wgmma m64nBNk16 over H: A
// the dy tile (K-major), B the slab (MN-major, the transpose bit).  The
// epilogue masks and rounds the sums into the group's staging tile, which
// a TMA store sends out as whole lines while the next chunk computes.
// Every tile in shared memory is TMA's 128-byte swizzle of 64 x 64 boxes;
// rows past B and columns past K load as zeros and are dropped on store.
// Each output is one thread's fixed sequence of wgmma k-steps, summed in
// f32 and rounded once: no split over H, no atomics, and the result
// repeats bit for bit.  setmaxnreg moves registers from the producer
// warpgroup (40) to the consumers (232).  Shared memory: 193 KB at H = 256
// (slab 64, dy 64, y3 32, staging 32).  The tensor maps are encoded at each
// launch through the runtime's driver entry point (no libcuda link).
// Needs H % 8 == 0, H <= 512, K % 8 == 0 and 16-byte aligned tensors
// (checked by the caller).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 128;      // molecules per tile
constexpr int kBN = 256;      // columns per tile
constexpr int kBK = 16;       // rows of the weight per ring stage
constexpr int kStages = 6;
constexpr int kThreads = 256;
constexpr int kPairs = 16;    // y3 float4 pairs per thread and tile
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ unsigned positive4(const float4& v) {
  return (v.x > 0.0f ? 1u : 0u) | (v.y > 0.0f ? 2u : 0u) |
         (v.z > 0.0f ? 4u : 0u) | (v.w > 0.0f ? 8u : 0u);
}

__global__ void __launch_bounds__(kThreads, 1)
cnn_dy3_kernel(const float* __restrict__ dyt, const float* __restrict__ w,
               const float* __restrict__ y3, float* __restrict__ out,
               int batch, int bpad, int h, int k, int resident) {
  extern __shared__ __align__(16) float smem[];
  const int nk = (h + kBK - 1) / kBK;          // ring chunks per tile
  float* dy_s = smem;                          // resident: [nk * 16][128]
  float* ring = dy_s + (resident ? nk * kBK * kBM : 0);
  const int a_floats = resident ? 0 : kBK * kBM;          // [16][128] dyt
  const int stage_floats = a_floats + kBK * kBN;          // + [16][256] w

  const int t = threadIdx.x;
  const int tb = t / 16;          // rows 8*tb .. 8*tb+7
  const int tc = t % 16;          // cols 64*q + 4*tc .. +3, q = 0..3
  const int nct = (k + kBN - 1) / kBN;
  const int tiles = nct * (bpad / kBM);
  const int my_tiles = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = my_tiles * nk;

  // the i-th tile of this block: first molecule b0, first column c0
  auto tile_origin = [&](int i, int& b0, int& c0) {
    const int tl = blockIdx.x + i * gridDim.x;
    b0 = (tl / nct) * kBM;
    c0 = (tl % nct) * kBN;
  };

  // start the copies of ring chunk g (nothing past the last one)
  auto issue_chunk = [&](int g) {
    if (g >= total) return;
    int b0, c0;
    tile_origin(g / nk, b0, c0);
    const int h0 = (g % nk) * kBK;
    float* st = ring + (g % kStages) * stage_floats;
#pragma unroll
    for (int r = 0; r < kBK * kBN / 4 / kThreads; ++r) {
      const int idx = t + r * kThreads;
      const int row = idx / (kBN / 4);
      const int col = (idx % (kBN / 4)) * 4;
      const bool ok = h0 + row < h && c0 + col < k;
      cp_async16(st + a_floats + row * kBN + col,
                 ok ? w + (size_t)(h0 + row) * k + c0 + col : w, ok);
    }
    if (!resident) {
#pragma unroll
      for (int r = 0; r < kBK * kBM / 4 / kThreads; ++r) {
        const int idx = t + r * kThreads;
        const int row = idx / (kBM / 4);
        const int col = (idx % (kBM / 4)) * 4;
        const bool ok = h0 + row < h;
        cp_async16(st + row * kBM + col,
                   ok ? dyt + (size_t)(h0 + row) * bpad + b0 + col : dyt, ok);
      }
    }
  };

  // the ReLU mask of this thread's 8 x 16 outputs, as bits r * 16 + 4 q + e
  // (rows 0-3 in lo, 4-7 in hi), read from y3 in 16 pairs of float4 during
  // the main loop: pair p is row p / 2, q = 2 (p % 2) and 2 (p % 2) + 1
  unsigned long long lo = 0, hi = 0;
  float4 yv0 = make_float4(0.f, 0.f, 0.f, 0.f), yv1 = yv0;
  auto load_pair = [&](int p, int b0, int c0) {
    const int row = b0 + 8 * tb + p / 2;
    const int col = c0 + 64 * (2 * (p % 2)) + 4 * tc;
    const bool rok = row < batch;
    const float* src = y3 + (size_t)row * k + col;
    yv0 = rok && col < k ? __ldcs(reinterpret_cast<const float4*>(src))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    yv1 = rok && col + 64 < k
              ? __ldcs(reinterpret_cast<const float4*>(src + 64))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto keep_pair = [&](int p) {
    const unsigned long long bits =
        (unsigned long long)(positive4(yv0) | (positive4(yv1) << 4))
        << ((p / 2 % 4) * 16 + 8 * (p % 2));
    if (p / 2 < 4) lo |= bits; else hi |= bits;
  };

  // prologue: dyt (when resident) and the first kStages - 1 chunks
  if (resident) {
    for (int idx = t; idx < nk * kBK * (kBM / 4); idx += kThreads) {
      const int row = idx / (kBM / 4);
      const int col = (idx % (kBM / 4)) * 4;
      const bool ok = row < h;
      cp_async16(dy_s + row * kBM + col,
                 ok ? dyt + (size_t)row * bpad + col : dyt, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue_chunk(s);
    cp_commit();
  }

  float acc[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.0f;

  for (int g = 0; g < total; ++g) {
    cp_wait<kStages - 2>();       // chunk g has landed (this thread's part)
    __syncthreads();              // ... everyone's; slot (g-1) % S is free
    issue_chunk(g + kStages - 1);
    cp_commit();

    const int kc = g % nk;
    int b0, c0;
    tile_origin(g / nk, b0, c0);
    // y3 pair kc - 1 has had a chunk's time to land; start pair kc
    if (kc >= 1 && kc <= kPairs) keep_pair(kc - 1);
    if (kc < kPairs) load_pair(kc, b0, c0);

    const float* st = ring + (g % kStages) * stage_floats;
    const float* as = resident ? dy_s + kc * kBK * kBM : st;
    const float* bs = st + a_floats;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = ld4(as + kk * kBM + 8 * tb);
      const float4 a1 = ld4(as + kk * kBM + 8 * tb + 4);
      float4 bq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) bq[q] = ld4(bs + kk * kBN + 64 * q + 4 * tc);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][4 * q + 0] = fmaf(av[r], bq[q].x, acc[r][4 * q + 0]);
          acc[r][4 * q + 1] = fmaf(av[r], bq[q].y, acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(av[r], bq[q].z, acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(av[r], bq[q].w, acc[r][4 * q + 3]);
        }
    }

    if (kc == nk - 1) {
      // epilogue: the rest of the mask, then masked streaming stores
      if (nk <= kPairs) keep_pair(nk - 1);
      for (int p = nk; p < kPairs; ++p) {
        load_pair(p, b0, c0);
        keep_pair(p);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = b0 + 8 * tb + r;
        const unsigned m16 =
            (unsigned)(((r < 4) ? lo : hi) >> ((r % 4) * 16)) & 0xffffu;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = c0 + 64 * q + 4 * tc;
          if (row < batch && col < k) {
            const unsigned m = m16 >> (4 * q);
            float4 res;
            res.x = (m & 1u) ? acc[r][4 * q + 0] : 0.0f;
            res.y = (m & 2u) ? acc[r][4 * q + 1] : 0.0f;
            res.z = (m & 4u) ? acc[r][4 * q + 2] : 0.0f;
            res.w = (m & 8u) ? acc[r][4 * q + 3] : 0.0f;
            __stcs(reinterpret_cast<float4*>(out + (size_t)row * k + col),
                   res);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][4 * q + e] = 0.0f;
        }
      }
      lo = hi = 0;
    }
  }
  cp_wait<0>();
}

size_t smem_bytes(int h, int resident) {
  const size_t nk = (size_t)((h + kBK - 1) / kBK);
  return ((resident ? nk * kBK * kBM : 0) +
          (size_t)kStages * ((resident ? 0 : kBK * kBM) + kBK * kBN)) *
         sizeof(float);
}

}  // namespace

// dyt [H, Bp] (dy transposed, Bp = batch rounded up to 128, padding
// columns zero), fc1_w [H, K], y3 and out [B, K]; all f32, contiguous, on
// the current device, 16-byte aligned, K % 4 == 0 (checked by the caller).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cnn_dy3_launch(const void* dyt, const void* fc1_w,
                              const void* y3, void* out, int batch, int h,
                              int k, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (h == 0) {                   // an empty sum: dy3 = 0
    return (int)cudaMemsetAsync(out, 0, (size_t)batch * k * sizeof(float),
                                (cudaStream_t)stream);
  }
  const int bpad = (batch + kBM - 1) / kBM * kBM;
  const int resident =
      bpad == kBM && smem_bytes(h, 1) <= kSmemLimit ? 1 : 0;
  const size_t smem = smem_bytes(h, resident);
  cudaError_t err = cudaFuncSetAttribute(
      cnn_dy3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as the busiest needs rounds for: the same finish time
  // as one per SM, with every block taking the same number of tiles
  const int tiles = (k + kBN - 1) / kBN * (bpad / kBM);
  const int rounds = (tiles + sms - 1) / sms;
  const int grid = (tiles + rounds - 1) / rounds;
  cnn_dy3_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(dyt), static_cast<const float*>(fc1_w),
      static_cast<const float*>(y3), static_cast<float*>(out), batch, bpad,
      h, k, resident);
  return (int)cudaGetLastError();
}

namespace {

// ---- bf16 kernel 4b: persistent, weight-stationary, TMA and wgmma --------
constexpr int kChunkM = 64;               // molecules per chunk: one wgmma M
constexpr int kBox = 64;                  // a TMA box: 64 x 64 bf16 ...
constexpr int kBoxBytes = kBox * kBox * 2;    // ... 8 KB, 128-byte rows
constexpr int kConsumers = 2;             // consumer warpgroups (ping-pong)
constexpr int kDyStages = 2;              // stages of the dy and y3 rings
constexpr int kY3Stages = 2;
// chunk g goes to stage g % stages and to group g % kConsumers: with
// stages a multiple of the groups, each stage is read by one group, whose
// parity waits then see every phase of it
static_assert(kDyStages % kConsumers == 0 && kY3Stages % kConsumers == 0,
              "a ring stage must belong to one consumer group");
constexpr int kThreadsBf16 = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;         // setmaxnreg of each warpgroup
constexpr int kConsumerRegs = 232;
constexpr int kMaxH = 512;

// columns per work item: the weight slab [H, BN] is 64 KB at the most
int tile_cols(int h) { return h <= 256 ? 128 : 64; }

// 8 KB boxes of shared memory at BN columns and nkb boxes of 64 along H:
// the slab, the dy ring, the y3 ring, one staging tile per consumer
int smem_boxes(int bn, int nkb) {
  return nkb * (bn / 64) + kDyStages * nkb + kY3Stages * (bn / 64) +
         kConsumers * (bn / 64);
}

// work items (column tiles) of block `block` in a grid of `grid`
__host__ __device__ int block_items(int items, int grid, int block) {
  return block < items ? (items - 1 - block) / grid + 1 : 0;
}

// the first chunk that consumer group wg takes among g0, g0 + 1, ...: the
// block's chunks are dealt round robin over the groups
__host__ __device__ int first_chunk(int g0, int wg) {
  return g0 + (wg - g0 % kConsumers + kConsumers) % kConsumers;
}

// the last of those before g_end, or -1 if there is none
__host__ __device__ int last_chunk(int first, int g_end) {
  return first < g_end
             ? first + (g_end - 1 - first) / kConsumers * kConsumers
             : -1;
}

// byte offset of element (r, c) in a tile of 64 rows stored as 64-column
// boxes, as TMA lays them out under the 128-byte swizzle: 16-byte chunk
// c / 8 of row r sits at chunk (c / 8) ^ (r % 8) of the row
__host__ __device__ int tile_offset(int r, int c) {
  return c / 64 * kBoxBytes + r * 128 + ((c % 64 / 8 ^ r % 8) << 4) +
         c % 8 * 2;
}

// row and column of accumulator element i of thread `lane` in warp `warp`
// of a consumer group (the wgmma m64nN layout: n8 block i / 4, rows
// 16 warp + lane / 4 and 8 below it, two columns a thread)
__host__ __device__ int frag_row(int warp, int lane, int i) {
  return 16 * warp + lane / 4 + 8 * (i % 4 / 2);
}

__host__ __device__ int frag_col(int lane, int i) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BN>
__global__ void __launch_bounds__(kThreadsBf16, 1)
cnn_dy3_bf16_kernel(__grid_constant__ const CUtensorMap dy_map,
                    __grid_constant__ const CUtensorMap w_map,
                    __grid_constant__ const CUtensorMap y3_map,
                    __grid_constant__ const CUtensorMap out_map, int batch,
                    int h, int k) {
  constexpr int NB = BN / 64;             // boxes across a tile
  extern __shared__ unsigned char dsmem[];
  const int nkb = (h + kBox - 1) / kBox;  // boxes along H
  const int nks = (h + 15) / 16;          // wgmma k-steps
  const uint32_t slab = (smem_u32(dsmem) + 1023u) & ~1023u;
  const uint32_t dy_s = slab + nkb * NB * kBoxBytes;
  const uint32_t y3_s = dy_s + kDyStages * nkb * kBoxBytes;
  const uint32_t st_s = y3_s + kY3Stages * NB * kBoxBytes;
  const uint32_t bars = st_s + kConsumers * NB * kBoxBytes;
  const uint32_t slab_full = bars, slab_empty = bars + 8;
  const uint32_t dy_full = bars + 16, dy_empty = dy_full + 8 * kDyStages;
  const uint32_t y3_full = dy_empty + 8 * kDyStages;
  const uint32_t y3_empty = y3_full + 8 * kY3Stages;

  const int items = (k + BN - 1) / BN;    // column tiles
  const int nch = (batch + kChunkM - 1) / kChunkM;
  const int my_items = block_items(items, gridDim.x, blockIdx.x);
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    // full: the producer's arrival and the bytes; empty: one arrival from
    // each warp of the group that read the stage (of both, for the slab)
    mbar_init(slab_full, 1);
    mbar_init(slab_empty, 4 * kConsumers);
    for (int s = 0; s < kDyStages; ++s) {
      mbar_init(dy_full + 8 * s, 1);
      mbar_init(dy_empty + 8 * s, 4);
    }
    for (int s = 0; s < kY3Stages; ++s) {
      mbar_init(y3_full + 8 * s, 1);
      mbar_init(y3_empty + 8 * s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: warp 0 streams dy and the slabs, warp 1 y3
    if constexpr (kConsumers > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0 && lane == 0) {
      int g = 0;
      for (int it = 0; it < my_items; ++it) {
        const int n0 = (blockIdx.x + it * gridDim.x) * BN;
        for (int j = 0; j < nch; ++j, ++g) {
          const int s = g % kDyStages;
          mbar_wait(dy_empty + 8 * s, (g / kDyStages & 1) ^ 1);
          mbar_expect(dy_full + 8 * s, nkb * kBoxBytes);
          for (int kb = 0; kb < nkb; ++kb)
            tma_load(dy_s + (s * nkb + kb) * kBoxBytes, &dy_map, kBox * kb,
                     kChunkM * j, dy_full + 8 * s);
          if (j == 0) {
            // the slab of this item, once both groups are done with the
            // last one's products; this item's first dy chunk is in flight
            mbar_wait(slab_empty, (it & 1) ^ 1);
            mbar_expect(slab_full, nkb * NB * kBoxBytes);
            for (int nb = 0; nb < NB; ++nb)
              for (int kb = 0; kb < nkb; ++kb)
                tma_load(slab + (nb * nkb + kb) * kBoxBytes, &w_map,
                         n0 + kBox * nb, kBox * kb, slab_full);
          }
        }
      }
    } else if (warp == 1 && lane == 0) {
      int g = 0;
      for (int it = 0; it < my_items; ++it) {
        const int n0 = (blockIdx.x + it * gridDim.x) * BN;
        for (int j = 0; j < nch; ++j, ++g) {
          const int s = g % kY3Stages;
          mbar_wait(y3_empty + 8 * s, (g / kY3Stages & 1) ^ 1);
          mbar_expect(y3_full + 8 * s, NB * kBoxBytes);
          for (int nb = 0; nb < NB; ++nb)
            tma_load(y3_s + (s * NB + nb) * kBoxBytes, &y3_map,
                     n0 + kBox * nb, kChunkM * j, y3_full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer group wg: every kConsumers-th chunk of the block
    if constexpr (kConsumers > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tw = threadIdx.x % 128;
    const uint32_t st = st_s + wg * NB * kBoxBytes;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int g = 0;
    for (int it = 0; it < my_items; ++it, g += nch) {
      const int n0 = (blockIdx.x + it * gridDim.x) * BN;
      const int first = first_chunk(g, wg);
      const int last = last_chunk(first, g + nch);
      mbar_wait(slab_full, it & 1);
      if (last < 0 && lane == 0) mbar_arrive(slab_empty);
      for (int gc = first; gc < g + nch; gc += kConsumers) {
        const int j = gc - g;
        const int s = gc % kDyStages;
        mbar_wait(dy_full + 8 * s, gc / kDyStages & 1);
        // ---- products: A the dy chunk (K-major), B the slab (MN-major,
        // transposed); each output one fixed sequence of k-steps
        wgmma_hold(acc);
        wgmma_fence();
        for (int ks = 0; ks < nks; ++ks) {
          const uint64_t da = wgmma_desc(
              dy_s + (s * nkb + ks / 4) * kBoxBytes + 32 * (ks % 4), 16, 1024);
          const uint64_t db = wgmma_desc(slab + ks * 2048,
                                         nkb * kBoxBytes, 1024);
          wgmma_bf16<BN>(acc, da, db, ks > 0);
        }
        wgmma_commit();
        wgmma_wait();
        wgmma_hold(acc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(dy_empty + 8 * s);
          if (gc == last) mbar_arrive(slab_empty);
        }
        // ---- epilogue: mask, round once, stage, store by TMA
        const int ys = gc % kY3Stages;
        const uint32_t yb = y3_s + ys * NB * kBoxBytes;
        mbar_wait(y3_full + 8 * ys, gc / kY3Stages & 1);
        if (tw == 0) bulk_wait_read();    // the staging tile is free
        named_sync(1 + wg, 128);
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
          const int off = tile_offset(frag_row(warp, lane, i),
                                      frag_col(lane, i));
          const uint32_t m = lds32(yb + off);
          // a bf16 is the high half of the f32 of the same value
          sts32(st + off, pack_bf16x2(
                              __uint_as_float(m << 16) > 0.0f ? acc[i] : 0.0f,
                              __uint_as_float(m & 0xFFFF0000u) > 0.0f
                                  ? acc[i + 1] : 0.0f));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(y3_empty + 8 * ys);
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if (tw == 0) {
          for (int nb = 0; nb < NB; ++nb)
            tma_store(&out_map, st + nb * kBoxBytes, n0 + kBox * nb,
                      kChunkM * j);
          bulk_commit();
        }
      }
    }
    if (tw == 0) bulk_wait();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query: no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 [rows, cols] tensor in boxes of 64 x 64 under the
// 128-byte swizzle; outside the tensor a load reads zeros, a store drops
bool box_map(EncodeTiled enc, CUtensorMap* map, const void* p, int rows,
             int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_bf16(const CUtensorMap (&maps)[4], int batch, int h, int k,
                cudaStream_t stream) {
  const size_t smem =
      1024 + (size_t)smem_boxes(BN, (h + kBox - 1) / kBox) * kBoxBytes +
      8 * (2 + 2 * kDyStages + 2 * kY3Stages);
  cudaError_t err = cudaFuncSetAttribute(
      cnn_dy3_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int items = (k + BN - 1) / BN;
  cnn_dy3_bf16_kernel<BN><<<items < sms ? items : sms, kThreadsBf16, smem,
                            stream>>>(maps[0], maps[1], maps[2], maps[3],
                                      batch, h, k);
  return (int)cudaGetLastError();
}

}  // namespace

// dy [B, H], fc1_w [H, K], y3 and out [B, K]: bf16, contiguous, on the
// current device, 16-byte aligned, H % 8 == 0, H <= 512 and K % 8 == 0
// (checked by the caller).  Returns cudaGetLastError() after the launch (0
// on success), cudaErrorInvalidValue for a shape it does not take or a
// tensor map the driver refuses.
extern "C" int cnn_dy3_bf16_launch(const void* dy, const void* fc1_w,
                                   const void* y3, void* out, int batch,
                                   int h, int k, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (h == 0) {                   // an empty sum: dy3 = 0
    return (int)cudaMemsetAsync(out, 0, (size_t)batch * k * 2,
                                (cudaStream_t)stream);
  }
  const EncodeTiled enc = encode_tiled();
  CUtensorMap maps[4];
  if (h > kMaxH || h % 8 || k % 8 || enc == nullptr ||
      !box_map(enc, &maps[0], dy, batch, h) ||
      !box_map(enc, &maps[1], fc1_w, h, k) ||
      !box_map(enc, &maps[2], y3, batch, k) ||
      !box_map(enc, &maps[3], out, batch, k))
    return (int)cudaErrorInvalidValue;
  return tile_cols(h) == 128
             ? launch_bf16<128>(maps, batch, h, k, (cudaStream_t)stream)
             : launch_bf16<64>(maps, batch, h, k, (cudaStream_t)stream);
}
