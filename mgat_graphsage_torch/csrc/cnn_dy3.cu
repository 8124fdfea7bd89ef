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
// take 69 us at the dense bf16 tensor-core rate.  So this variant uses
// the tensor cores: mma.sync m16n8k16 (bf16 in, f32 sums), one 128 x 128
// output tile per block (8 warps of 64 x 32), the reduction over h in
// chunks of 32 through a 4-stage cp.async ring (dy rows and weight rows,
// ldmatrix to fragments, the weight's with .trans since its rows run
// along the columns).  Blocks take the molecule tiles of one column
// block next to each other, so each weight column block comes from device
// memory once and from L2 for the others.  The epilogue reads the mask
// from y3 and writes bf16 pairs.  Each output is one thread's fixed
// sequence of mma steps: the result repeats bit for bit.  Needs H % 8 ==
// 0, K % 8 == 0 and 16-byte aligned tensors (checked by the caller).
// Shared memory: 74 KB, two blocks per SM.

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

constexpr int kHM = 128;                  // molecules per tile
constexpr int kHN = 128;                  // columns per tile
constexpr int kHK = 32;                   // rows of the weight per stage
constexpr int kHStages = 4;
constexpr int kHThreads = 256;            // 8 warps: 2 x 4 of 64 x 32
constexpr int kAS = kHK + 8;              // dy tile row stride: 80 bytes
constexpr int kBS = kHN + 8;              // weight tile row stride: 272 B
constexpr int kHStage = kHM * kAS + kHK * kBS;   // bf16 per stage

__device__ __forceinline__ void cp_async16b(void* dst, const void* src,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__global__ void __launch_bounds__(kHThreads, 2)
cnn_dy3_bf16_kernel(const __nv_bfloat16* __restrict__ dy,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ y3,
                    __nv_bfloat16* __restrict__ out, int batch, int h,
                    int k) {
  extern __shared__ __align__(16) __nv_bfloat16 hsmem[];
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int wm = warp / 4;        // rows 64 * wm .. +63 of the tile
  const int wn = warp % 4;        // columns 32 * wn .. +31
  const int mt = (batch + kHM - 1) / kHM;
  const int b0 = (int)(blockIdx.x % mt) * kHM;
  const int n0 = (int)(blockIdx.x / mt) * kHN;
  const int nk = (h + kHK - 1) / kHK;

  // chunk c of the reduction into stage c % kHStages: 128 dy rows x 32 and
  // 32 weight rows x 128, 16 bytes (8 values) a copy, zero outside
  auto issue = [&](int c) {
    if (c < nk) {
      __nv_bfloat16* as = hsmem + (c % kHStages) * kHStage;
      __nv_bfloat16* bs = as + kHM * kAS;
      const int h0 = c * kHK;
      for (int idx = t; idx < kHM * (kHK / 8); idx += kHThreads) {
        const int r = idx / (kHK / 8);
        const int q = (idx % (kHK / 8)) * 8;
        const bool ok = b0 + r < batch && h0 + q < h;
        cp_async16b(as + r * kAS + q,
                    ok ? dy + (size_t)(b0 + r) * h + h0 + q : dy, ok);
      }
      for (int idx = t; idx < kHK * (kHN / 8); idx += kHThreads) {
        const int r = idx / (kHN / 8);
        const int q = (idx % (kHN / 8)) * 8;
        const bool ok = h0 + r < h && n0 + q < k;
        cp_async16b(bs + r * kBS + q,
                    ok ? w + (size_t)(h0 + r) * k + n0 + q : w, ok);
      }
    }
    cp_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int c = 0; c < kHStages - 1; ++c) issue(c);
  for (int c = 0; c < nk; ++c) {
    cp_wait<kHStages - 2>();      // chunk c has landed (this thread's part)
    __syncthreads();              // ... everyone's; slot (c-1) % S is free
    issue(c + kHStages - 1);
    const __nv_bfloat16* as = hsmem + (c % kHStages) * kHStage;
    const __nv_bfloat16* bs = as + kHM * kAS;
#pragma unroll
    for (int ks = 0; ks < kHK; ks += 16) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], as + (64 * wm + 16 * i + lane % 16) * kAS + ks +
                          (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_t(b[j], bs + (ks + lane % 8 + ((lane / 8) % 2) * 8) * kBS +
                            32 * wn + 16 * j + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][2 * (j % 2)],
                   b[j / 2][2 * (j % 2) + 1]);
    }
  }
  cp_wait<0>();

  // epilogue: round each sum once to bf16, keep it where y3 > 0
  const int g = lane / 4;
  const int q2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = b0 + 64 * wm + 16 * i + g + 8 * hf;
      if (row >= batch) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 32 * wn + 8 * j + q2;
        if (col >= k) continue;
        const size_t at = (size_t)row * k + col;
        const __nv_bfloat162 m =
            *reinterpret_cast<const __nv_bfloat162*>(y3 + at);
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            __low2float(m) > 0.0f ? acc[i][j][2 * hf] : 0.0f,
            __high2float(m) > 0.0f ? acc[i][j][2 * hf + 1] : 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(out + at) = v;
      }
    }
}

}  // namespace

// dy [B, H], fc1_w [H, K], y3 and out [B, K]: bf16, contiguous, on the
// current device, 16-byte aligned, H % 8 == 0 and K % 8 == 0 (checked by
// the caller).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cnn_dy3_bf16_launch(const void* dy, const void* fc1_w,
                                   const void* y3, void* out, int batch,
                                   int h, int k, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (h == 0) {                   // an empty sum: dy3 = 0
    return (int)cudaMemsetAsync(out, 0, (size_t)batch * k * 2,
                                (cudaStream_t)stream);
  }
  const size_t smem = (size_t)kHStages * kHStage * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      cnn_dy3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((batch + kHM - 1) / kHM) *
                          ((k + kHN - 1) / kHN);
  cnn_dy3_bf16_kernel<<<(unsigned)tiles, kHThreads, smem,
                        (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(fc1_w),
      static_cast<const __nv_bfloat16*>(y3),
      static_cast<__nv_bfloat16*>(out), batch, h, k);
  return (int)cudaGetLastError();
}
