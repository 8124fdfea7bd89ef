// Fused conv3 -> conv2 -> conv1 backward of the fingerprint CNN, for
// Hopper (sm_90a).
//
// Replaces: mgat_graphsage_tpu/ops/pallas_cnn.py::cnn_chain_bwd
// (_chain_bwd_kernel), kernel 2 of the fused CNN-branch backward.
//
// The branch's forward is three k=3 SAME convolutions with ReLU over the
// bit axis: y1 = relu(conv(fp, w1)), y2 = relu(conv(y1, w2)),
// y3 = relu(conv(y2, w3)), channels 1 -> 32 -> 64 -> 128 (torch weight
// layout [out, in, 3], cross-correlation, zero padding 1).  Given
// d3 = dL/d(conv3 pre-activation) (the output of csrc/cnn_dy3.cu, already
// masked by y3 > 0), this computes in f32:
//     dw3[o,i,k] = sum_{b,w} d3[b,w,o] y2[b,i,w+k-1]     db3[o] = sum d3
//     d2[b,w,i]  = (y2[b,i,w] > 0) sum_{o,k} w3[o,i,k] d3[b,w-k+1,o]
//     dw2, db2 from d2 and y1 the same way; d1 from d2 and w2
//     dw1[o,0,k] = sum_{b,w} d1[b,w,o] fp[b,w+k-1]        db1[o] = sum d1
// with every position outside [0, W) read as 0.  The fingerprint gets no
// gradient.  Layouts are the forward's own: d3 [B, W, 128] (pos-major, as
// cnn_dy3 writes it), y2 [B, 64, W] and y1 [B, 32, W] (NCW, as the convs
// wrote them), fp [B, W]; no copy stands between them and this kernel.
//
// Bound on the H100: operations.  At B=128, W=1024 the two dgrads and
// three wgrads are 16.4 GFLOP against 118 MB of activations: 139 flops per
// byte, far above the f32 ridge of 20.  So the design keeps the FMA pipe
// fed: every product is a register tile fed by 16-byte shared loads.
//
// Design: the position axis is cut into tiles of 32 positions of one
// molecule (any B and W; the last tile of a row is ragged).  A persistent
// grid of one block per SM walks the tiles in a fixed order.  A tile needs
// d3 over its positions +-2 and y2, y1, fp over +-1 (zero outside
// [0, W)); cp.async copies the next tile's into the second of two stage
// buffers while the current tile computes: d3 rows pos-major, y2, y1 and
// fp rows channel-major as windows of positions w0-4 .. w0+35, in 16-byte
// copies where W % 4 == 0, else in 4-byte copies (same layout).  Per tile:
//   dw3: each thread an 8 x 4 x 3 register tile that lives across tiles,
//     fed per 4 positions by 8 d3 and 12 y2 16-byte loads (384 FMAs);
//   d2 = mask * dgrad(d3, w3) over the tile +-1 (34 rows x 64 channels,
//     K = 3 x 128): each thread 9 rows x 4 channels for a quarter of the
//     out channels, reading 11 d3 rows and 12 w3 rows (float4) per 4 out
//     channels for 432 FMAs; the four quarters sit in one warp and are
//     added by shuffles (a reduce-scatter: each lane keeps one channel);
//     four row groups start at 0, 9, 18, 25, the last storing 27.. only;
//   dw2 in shared memory, one owner thread per element (4 x 2 x 3 each);
//     d1 = mask * dgrad(d2, w2) over the tile (32 x 32, K = 3 x 64) the
//     same way with 4-row tiles; d1 never leaves registers: the lane that
//     ends holding it adds its dw1 and db1 terms, as the d2 lane adds db2
//     and the dw3 lanes db3.
// Two barriers per tile.  Each block then writes its sums once (dw3
// thread-major, in whole lines), and a second kernel adds the blocks'
// sums in block order.  No atomics, every sum in a fixed order: the result
// repeats bit for bit.  Shared memory: 222 KB.
//
// bf16 kernel (cnn_chain_bwd_bf16_launch, compute_dtype="bfloat16"): d3,
// y2, y1, fp, w3 and w2 in bf16; every sum and the six outputs in f32; as
// the reference's kernel does (pallas_cnn.py:_chain_bwd_kernel), d2 and d1
// are rounded to bf16 before their ReLU masks.  Bound on the H100 at
// B=1024, W=1024: 472 MB of bf16 activations, 141 us at 3.35 TB/s, against
// ~131 GFLOP, 133 us at the dense bf16 tensor-core rate: the two nearly
// even, so the design has to stream near the HBM rate and keep the tensor
// cores busy.  All four products run on them (mma.sync m16n8k16, bf16 in,
// f32 sums), with operands read by ldmatrix straight from the staged bf16
// tiles.  Tiles of kBTW = 128 positions of one molecule; a persistent grid
// of one block (8 warps) per SM walks them, and a 2-stage cp.async ring
// stages the next tile while this one computes: d3 rows w0-2 .. w0+129
// pos-major, y2, y1 and fp windows w0-8 .. w0+135 channel-major (16-byte
// copies where W % 8 == 0, else plain loads).  A position shift is a whole
// row of the pos-major operand, never 2 bytes of a window, so every
// ldmatrix row stays 16-byte aligned; rows are padded to an odd number of
// 16-byte chunks, so the 8 rows of one 8x8 fall in 8 bank groups.  Per
// tile:
//   dw3[k] (128 x 64, K = the 128 core positions p): A = d3 rows p - k + 1
//     (ldmatrix.trans; a row outside the core reads a zero row), B = the
//     y2 window (ldmatrix); warp w keeps out channels 16w .. 16w+15 x 64 x
//     3 taps in registers across tiles (96 a thread).  The two terms whose
//     y2 position lies outside the core (p = w0-1 at k = 0, w0+128 at
//     k = 2) are added on the FMA pipe;
//   d2 transposed (64 channels x 136 rows w0-4 .. w0+131, K = 3 x 128): A =
//     w3 as [k][i][o], B = the d3 rows shifted by 1 - k; each sum is
//     rounded to bf16, masked by y2 > 0 and stored pos-major (rows outside
//     w0-1 .. w0+128 as 0): the next level's operand.  Warps 0-3 take 9
//     column tiles, warps 4-7 eight;
//   dw2 as dw3 from d2 and the y1 window (24 registers a thread);
//   d1 transposed (32 channels x the 128 core positions, K = 3 x 64), from
//     w2 and the shifted d2 rows; rounded, masked by y1 > 0, and never
//     stored: each lane adds its dw1 and db1 terms from the fp window;
//   db3 and db2 on the FMA pipe over the core rows.
// Two barriers per tile.  Each block then writes its sums once, in the
// output's layout, and a second kernel adds the blocks' sums in block
// order.  No atomics, every sum in a fixed order: the result repeats bit
// for bit.  Shared memory: 212 KB; 250 registers, no spills.  The tile
// width was swept (kernel_phases.py, one H100 SXM at 700 W): 32, 64 and
// 128 positions took 1048, 807 and 656 us at B=W=1024, a third ring stage
// at 64 positions 790 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kC3 = 128;
constexpr int kC2 = 64;
constexpr int kC1 = 32;
constexpr int kTW = 32;            // core positions per tile
constexpr int kP3 = kTW + 4;       // d3 rows: positions w0-2 .. w0+TW+1
constexpr int kP2 = kTW + 2;       // d2 rows: positions w0-1 .. w0+TW
constexpr int kWin = kTW + 8;      // y2, y1, fp windows: w0-4 .. w0+TW+3
constexpr int kWS = kWin + 4;      // their row stride: rows 2 and 4 apart
                                   // start in other banks
constexpr int kQ = 3;              // window index of position w0-1
constexpr int kYRows = kC2 + kC1 + 1;  // y2 rows | y1 rows | fp
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR2 = 9;             // d2 rows per thread (4 groups cover 34)
constexpr int kR1 = 4;             // d1 rows per thread (8 groups cover 32)

constexpr int kNW3 = kC3 * kC2 * 3;
constexpr int kNW2 = kC2 * kC1 * 3;
constexpr int kNW1 = kC1 * 3;
// partial / output layout: dw3 | db3 | dw2 | db2 | dw1 | db1
constexpr int kOffDb3 = kNW3;
constexpr int kOffDw2 = kOffDb3 + kC3;
constexpr int kOffDb2 = kOffDw2 + kNW2;
constexpr int kOffDw1 = kOffDb2 + kC2;
constexpr int kOffDb1 = kOffDw1 + kNW1;
constexpr int kNTot = kOffDb1 + kC1;

// shared memory regions, in floats (each a multiple of 4)
constexpr int kSW3 = 3 * kC3 * kC2;          // [k][o][i]
constexpr int kSW2 = 3 * kC2 * kC1;          // [k][o][i]
constexpr int kSD3 = kP3 * kC3;     // one stage buffer: d3 | y2 | y1 | fp
constexpr int kStage = kSD3 + kYRows * kWS;
constexpr int kSD2 = kP2 * kC2;
constexpr int kSRed1 = kWarps * kC1 * 4;     // per-warp dw1 | db1 sums,
constexpr int kSRed2 = 4 * kC2;              // per-row-group db2 sums: in d2s
constexpr int kSmemFloats = kSW3 + kSW2 + 2 * kStage + kSD2 + kNW2;
static_assert(kSRed1 + kSRed2 <= kSD2, "sums fit where d2 was");
static_assert(kSmemFloats * 4 <= 232448, "shared memory of one block");
static_assert(kR2 * 4 >= kP2 && 3 * kR2 <= kP2, "d2 row groups");
static_assert(kR1 * kWarps == kTW, "d1 row groups");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float part_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// acc[r][0..3] holds four channels' partial sums over a quarter of K in
// each of the lanes l, l^8, l^16, l^24 (ks = lane >> 3).  Afterwards
// acc[r][0] holds the full sum of channel ks, (q0 + q2) + (q1 + q3).
template <int R>
__device__ __forceinline__ void reduce_scatter(float (&acc)[R][4], int ks) {
  const bool hi = (ks >> 1) & 1;
  const bool lo = ks & 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float s0 = hi ? acc[r][0] : acc[r][2];
    const float s1 = hi ? acc[r][1] : acc[r][3];
    float k0 = hi ? acc[r][2] : acc[r][0];
    float k1 = hi ? acc[r][3] : acc[r][1];
    k0 += __shfl_xor_sync(0xffffffffu, s0, 16);
    k1 += __shfl_xor_sync(0xffffffffu, s1, 16);
    const float s = lo ? k0 : k1;
    const float k = lo ? k1 : k0;
    acc[r][0] = k + __shfl_xor_sync(0xffffffffu, s, 8);
  }
}

// Copy tile `tile` into one stage buffer (zero outside [0, W)): d3 rows
// pos-major, y2, y1 and fp rows as windows of positions w0-4 .. w0+TW+3,
// in 16-byte copies where W % 4 == 0 (`vec`: a chunk of 4 positions then
// lies wholly inside or outside [0, W)), else in 4-byte copies.
__device__ __forceinline__ void stage_tile(float* st, int tile, int nwt,
                                           const float* __restrict__ d3g,
                                           const float* __restrict__ y2g,
                                           const float* __restrict__ y1g,
                                           const float* __restrict__ fpg,
                                           int width, bool vec, int t) {
  const int b = tile / nwt;
  const int w0 = (tile - b * nwt) * kTW;
  for (int idx = t; idx < kP3 * (kC3 / 4); idx += kThreads) {
    const int s = idx / (kC3 / 4);
    const int c = (idx - s * (kC3 / 4)) * 4;
    const int p = w0 - 2 + s;
    const bool ok = p >= 0 && p < width;
    cp_async16(st + s * kC3 + c,
               d3g + ((size_t)b * width + (ok ? p : 0)) * kC3 + c, ok);
  }
  float* ys = st + kSD3;
  const int step = vec ? 4 : 1;
  const int per_row = kWin / step;
  for (int idx = t; idx < kYRows * per_row; idx += kThreads) {
    const int row = idx / per_row;
    const int q = (idx - row * per_row) * step;
    const int p = w0 - 4 + q;
    const bool ok = p >= 0 && p < width;
    const float* src = row < kC2 ? y2g + ((size_t)b * kC2 + row) * width
                     : row < kC2 + kC1
                         ? y1g + ((size_t)b * kC1 + row - kC2) * width
                         : fpg + (size_t)b * width;
    if (vec)
      cp_async16(ys + row * kWS + q, src + (ok ? p : 0), ok);
    else
      cp_async4(ys + row * kWS + q, src + (ok ? p : 0), ok);
  }
  cp_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
cnn_chain_bwd_kernel(const float* __restrict__ d3g,
                     const float* __restrict__ y2g,
                     const float* __restrict__ y1g,
                     const float* __restrict__ fpg,
                     const float* __restrict__ w3g,
                     const float* __restrict__ w2g,
                     float* __restrict__ partials, int batch, int width,
                     int vec) {
  extern __shared__ __align__(16) float smem[];
  float* w3s = smem;
  float* w2s = w3s + kSW3;
  float* stages = w2s + kSW2;
  float* d2s = stages + 2 * kStage;
  float* dw2a = d2s + kSD2;      // [k][i][o]

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int nwt = (width + kTW - 1) / kTW;
  const int ntiles = batch * nwt;
  if ((int)blockIdx.x < ntiles)
    stage_tile(stages, blockIdx.x, nwt, d3g, y2g, y1g, fpg, width, vec, t);

  for (int idx = t; idx < kNW3; idx += kThreads) {
    const int o = idx / (kC2 * 3);
    const int rem = idx - o * (kC2 * 3);
    const int i = rem / 3;
    const int k = rem - i * 3;
    w3s[(k * kC3 + o) * kC2 + i] = w3g[idx];
  }
  for (int idx = t; idx < kNW2; idx += kThreads) {
    const int o = idx / (kC1 * 3);
    const int rem = idx - o * (kC1 * 3);
    const int i = rem / 3;
    const int k = rem - i * 3;
    w2s[(k * kC2 + o) * kC1 + i] = w2g[idx];
  }
  for (int idx = t; idx < kNW2; idx += kThreads) dw2a[idx] = 0.0f;

  // dw3 register tile: out channels 4*tb3 .. +3 and 64 + 4*tb3 .. +3
  // (r < 4, r >= 4), in channels 4*ib3 .. +3; the lanes with ib3 == 0 also
  // sum db3 for their 8 channels
  const int tb3 = t % 16;
  const int ib3 = t / 16;
  float acc3[3][8][4];
  float db3p[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    db3p[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc3[k][r][c] = 0.0f;
  }
  // d2 lanes: rows r2 .. r2+8 (owning those >= 9*rg), channel 4*cg2 + ks
  const int ks = lane >> 3;
  const int rg = warp >> 1;
  const int r2 = min(kR2 * rg, kP2 - kR2);
  const int cg2 = (warp & 1) * 8 + (lane & 7);
  // d1 lanes: rows kR1*warp .. +3, channel 4*cg1 + ks
  const int cg1 = lane & 7;
  float db2p = 0.0f, db1p = 0.0f;
  float dw1p[3] = {0.0f, 0.0f, 0.0f};

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    cp_wait_all();
    __syncthreads();   // this tile staged; the previous tile's readers done
    if (tile + (int)gridDim.x < ntiles)
      stage_tile(stages + (buf ^ 1) * kStage, tile + gridDim.x, nwt, d3g,
                 y2g, y1g, fpg, width, vec, t);
    const float* d3s = stages + buf * kStage;
    const float* y2s = d3s + kSD3;            // [64][kWS]
    const float* y1s = y2s + kC2 * kWS;       // [32][kWS]
    const float* fps = y1s + kC1 * kWS;

    // ---- level 3: dw3 (registers), db3 ---------------------------------
    for (int sc0 = 0; sc0 < kTW; sc0 += 4) {
      // y2 at positions w0 + sc + k - 1 = window index sc + k + 3
      float yv[4][12];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int h = 0; h < 3; ++h) {
          const float4 v = ld4(y2s + (4 * ib3 + c) * kWS + sc0 + 4 * h);
          yv[c][4 * h] = v.x;
          yv[c][4 * h + 1] = v.y;
          yv[c][4 * h + 2] = v.z;
          yv[c][4 * h + 3] = v.w;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a0 = ld4(d3s + (sc0 + u + 2) * kC3 + 4 * tb3);
        const float4 a1 = ld4(d3s + (sc0 + u + 2) * kC3 + 64 + 4 * tb3);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        if (ib3 == 0) {
#pragma unroll
          for (int r = 0; r < 8; ++r) db3p[r] += av[r];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc3[k][r][c] = fmaf(av[r], yv[c][u + k + 3], acc3[k][r][c]);
      }
    }
    // ---- level 3: d2 = mask * dgrad(d3, w3), db2 ------------------------
    {
      float acc[kR2][4];
#pragma unroll
      for (int r = 0; r < kR2; ++r) acc[r][0] = acc[r][1] = acc[r][2] =
          acc[r][3] = 0.0f;
#pragma unroll 2
      for (int j = 0; j < kC3 / 16; ++j) {
        const int o = 16 * j + 4 * ks;
        float4 dv[kR2 + 2];
#pragma unroll
        for (int r = 0; r < kR2 + 2; ++r) dv[r] = ld4(d3s + (r2 + r) * kC3 + o);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float4 wv = ld4(w3s + (k * kC3 + o + u) * kC2 + 4 * cg2);
#pragma unroll
            for (int r = 0; r < kR2; ++r) {
              const float d = part_of(dv[r - k + 2], u);
              acc[r][0] = fmaf(d, wv.x, acc[r][0]);
              acc[r][1] = fmaf(d, wv.y, acc[r][1]);
              acc[r][2] = fmaf(d, wv.z, acc[r][2]);
              acc[r][3] = fmaf(d, wv.w, acc[r][3]);
            }
          }
      }
      reduce_scatter<kR2>(acc, ks);
      const int ch = 4 * cg2 + ks;
#pragma unroll
      for (int r = 0; r < kR2; ++r) {
        const int s2 = r2 + r;
        if (s2 >= kR2 * rg) {
          const float v =
              y2s[ch * kWS + s2 + kQ] > 0.0f ? acc[r][0] : 0.0f;
          d2s[s2 * kC2 + ch] = v;
          if (s2 >= 1 && s2 <= kTW) db2p += v;
        }
      }
    }
    __syncthreads();

    // ---- level 2: dw2 (shared sums) ------------------------------------
    {
      const int tb2 = t % 16;     // out channels 4*tb2 .. +3
      const int ib2 = t / 16;     // in channels 2*ib2, +1
      float a2[3][4][2];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) a2[k][r][0] = a2[k][r][1] = 0.0f;
      for (int sc0 = 0; sc0 < kTW; sc0 += 4) {
        float yv[2][12];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int h = 0; h < 3; ++h) {
            const float4 v = ld4(y1s + (2 * ib2 + c) * kWS + sc0 + 4 * h);
            yv[c][4 * h] = v.x;
            yv[c][4 * h + 1] = v.y;
            yv[c][4 * h + 2] = v.z;
            yv[c][4 * h + 3] = v.w;
          }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 a = ld4(d2s + (sc0 + u + 1) * kC2 + 4 * tb2);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                a2[k][r][c] = fmaf(av[r], yv[c][u + k + 3], a2[k][r][c]);
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float4* p = reinterpret_cast<float4*>(
              dw2a + (k * kC1 + 2 * ib2 + c) * kC2 + 4 * tb2);
          float4 cur = *p;
          cur.x += a2[k][0][c];
          cur.y += a2[k][1][c];
          cur.z += a2[k][2][c];
          cur.w += a2[k][3][c];
          *p = cur;
        }
    }
    // ---- level 2: d1 = mask * dgrad(d2, w2), dw1, db1 ------------------
    {
      const int r1 = kR1 * warp;
      float acc[kR1][4];
#pragma unroll
      for (int r = 0; r < kR1; ++r) acc[r][0] = acc[r][1] = acc[r][2] =
          acc[r][3] = 0.0f;
#pragma unroll 1
      for (int j = 0; j < kC2 / 16; ++j) {
        const int o = 16 * j + 4 * ks;
        float4 dv[kR1 + 2];
#pragma unroll
        for (int r = 0; r < kR1 + 2; ++r) dv[r] = ld4(d2s + (r1 + r) * kC2 + o);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float4 wv = ld4(w2s + (k * kC2 + o + u) * kC1 + 4 * cg1);
#pragma unroll
            for (int r = 0; r < kR1; ++r) {
              const float d = part_of(dv[r - k + 2], u);
              acc[r][0] = fmaf(d, wv.x, acc[r][0]);
              acc[r][1] = fmaf(d, wv.y, acc[r][1]);
              acc[r][2] = fmaf(d, wv.z, acc[r][2]);
              acc[r][3] = fmaf(d, wv.w, acc[r][3]);
            }
          }
      }
      reduce_scatter<kR1>(acc, ks);
      const int ch = 4 * cg1 + ks;
      const float4 m4 = ld4(y1s + ch * kWS + r1 + kQ + 1);
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int r = 0; r < kR1; ++r) {
        const int sc = r1 + r;
        const float v = mv[r] > 0.0f ? acc[r][0] : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          dw1p[k] = fmaf(v, fps[sc + k + kQ], dw1p[k]);
        db1p += v;
      }
    }
  }
  cp_wait_all();
  __syncthreads();   // d2s is free: the dw1, db1 and db2 sums go there
  float* red1 = d2s;
  float* red2 = d2s + kSRed1;

  // ---- this block's sums -> partials[blockIdx.x] -------------------------
  {
    float* r = red1 + (warp * kC1 + 4 * cg1 + ks) * 4;
    r[0] = dw1p[0];
    r[1] = dw1p[1];
    r[2] = dw1p[2];
    r[3] = db1p;
    red2[rg * kC2 + 4 * cg2 + ks] = db2p;
  }
  __syncthreads();
  float* part = partials + (size_t)blockIdx.x * kNTot;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[((k * 8 + r) * 4 + c) * kThreads + t] = acc3[k][r][c];
  if (ib3 == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      part[kOffDb3 + (r < 4 ? 0 : 60) + 4 * tb3 + r] = db3p[r];
  }
  for (int idx = t; idx < kNW2; idx += kThreads) {
    const int o = idx / (kC1 * 3);
    const int rem = idx - o * (kC1 * 3);
    const int i = rem / 3;
    const int k = rem - i * 3;
    part[kOffDw2 + idx] = dw2a[(k * kC1 + i) * kC2 + o];
  }
  if (t < kC2) {
    float s = 0.0f;
    for (int g = 0; g < 4; ++g) s += red2[g * kC2 + t];
    part[kOffDb2 + t] = s;
  } else if (t < kC2 + kC1 * 4) {
    const int o = (t - kC2) / 4;
    const int q = (t - kC2) % 4;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red1[(w * kC1 + o) * 4 + q];
    part[(q < 3 ? kOffDw1 + o * 3 + q : kOffDb1 + o)] = s;
  }
}

// Sum over blocks g, in order, of partials[g][q], stored at q's place in
// the output: the dw3 part of a partial row is thread-major (element
// ((k * 8 + r) * 4 + c) * kThreads + t is thread t's acc3[k][r][c]), so
// the blocks wrote it in whole lines.
__global__ void cnn_chain_reduce_kernel(const float* __restrict__ partials,
                                        float* __restrict__ out, int blocks) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= kNTot) return;
  float s = 0.0f;
  for (int g = 0; g < blocks; ++g) s += partials[(size_t)g * kNTot + q];
  int e = q;
  if (q < kNW3) {
    const int t = q % kThreads;
    const int j = q / kThreads;
    const int c = j % 4;
    const int r = (j / 4) % 8;
    const int k = j / 32;
    const int o = (r < 4 ? 0 : 60) + 4 * (t % 16) + r;
    const int i = 4 * (t / 16) + c;
    e = (o * kC2 + i) * 3 + k;
  }
  out[e] = s;
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 operands on the tensor cores (cnn_chain_bwd_bf16_launch)
// ---------------------------------------------------------------------------

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kBTW = 128;           // core positions per tile
constexpr int kBStages = 2;         // depth of the cp.async ring
constexpr int kBThreads = 256;      // 8 warps
constexpr int kBWarps = kBThreads / 32;
constexpr int kBD3Lo = 2;           // d3 rows staged from w0 - kBD3Lo
constexpr int kBD2Lo = 4;           // d2 rows computed from w0 - kBD2Lo
constexpr int kBWinLo = 8;          // y2, y1, fp windows from w0 - kBWinLo
constexpr int kBP3 = kBTW + 2 * kBD3Lo;     // d3 rows of a tile
constexpr int kBP2 = kBTW + 2 * kBD2Lo;     // d2 rows of a tile
constexpr int kBWin = kBTW + 2 * kBWinLo;   // window positions of a tile
// Row strides in bf16.  Each is an odd number of 16-byte chunks, so the 8
// rows that one ldmatrix 8x8 reads lie in 8 different groups of 4 banks.
constexpr int kBD3S = kC3 + 8;
constexpr int kBD2S = kC2 + 8;
constexpr int kBW3S = kC3 + 8;
constexpr int kBW2S = kC2 + 8;
constexpr int kBWS = kBWin + ((kBWin / 8) % 2 ? 0 : 8);
constexpr int kBYRows = kC2 + kC1 + 1;      // y2 rows | y1 rows | fp
constexpr int kBStage = kBP3 * kBD3S + kBYRows * kBWS;
constexpr int kBN2 = kBP2 / 8;              // d2 column tiles (8 rows each)
constexpr int kBN2a = (kBN2 + 1) / 2;       // warps 0-3 take these
constexpr int kBN1 = kBTW / 32;             // d1 column tiles of one warp
// shared memory, in bf16: w3t [3][64][kBW3S] | w2t [3][32][kBW2S] | ring
// of kBStages stages | d2 [kBP2][kBD2S] | a zero row of 128
constexpr int kBOffW2 = 3 * kC2 * kBW3S;
constexpr int kBOffRing = kBOffW2 + 3 * kC1 * kBW2S;
constexpr int kBOffD2 = kBOffRing + kBStages * kBStage;
constexpr int kBOffZero = kBOffD2 + kBP2 * kBD2S;
constexpr int kBSmemLoop = (kBOffZero + kC3) * 2;             // bytes
// after the walk the same memory holds the block's sums: one partial row
// and the scratch of its bias and dw1 reductions
constexpr int kBScratch = 4 * kC3 + 8 * kC2 + kBWarps * 16 * 4;
constexpr int kBSmemSums = (kNTot + kBScratch) * 4;
constexpr int kBSmem = kBSmemLoop > kBSmemSums ? kBSmemLoop : kBSmemSums;
static_assert(kBTW % 32 == 0, "d1 tiles: 8 positions x 4 warp columns");
static_assert(kBSmem <= 232448, "shared memory of one block, bf16");
static_assert((kBWinLo - kBD2Lo) % 2 == 0 && kBWinLo % 8 == 0,
              "window pairs 4-byte aligned, window chunks 16-byte aligned");
static_assert(kNTot % 4 == 0 && kBStage % 8 == 0 && kBOffD2 % 8 == 0,
              "16-byte alignment of the regions");

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// Copy tile `tile` into stage `st` (zero outside [0, W)): d3 rows w0-2 ..
// w0+TW+1 pos-major in 16-byte copies; y2, y1 and fp rows as windows of
// positions w0-8 .. w0+TW+7, in 16-byte copies where `vec` (W % 8 == 0 and
// aligned rows: a chunk of 8 positions then lies wholly inside or outside
// [0, W)), else in plain loads and stores.
__device__ __forceinline__ void stage_tile_bf16(
    bf16* st, int tile, int nwt, const bf16* __restrict__ d3g,
    const bf16* __restrict__ y2g, const bf16* __restrict__ y1g,
    const bf16* __restrict__ fpg, int width, bool vec, int t) {
  const int b = tile / nwt;
  const int w0 = (tile - b * nwt) * kBTW;
  for (int idx = t; idx < kBP3 * (kC3 / 8); idx += kBThreads) {
    const int s = idx / (kC3 / 8);
    const int c = (idx - s * (kC3 / 8)) * 8;
    const int p = w0 - kBD3Lo + s;
    const bool ok = p >= 0 && p < width;
    cp_async16(st + s * kBD3S + c,
               d3g + ((size_t)b * width + (ok ? p : 0)) * kC3 + c, ok);
  }
  bf16* ys = st + kBP3 * kBD3S;
  const int step = vec ? 8 : 1;
  const int per_row = kBWin / step;
  for (int idx = t; idx < kBYRows * per_row; idx += kBThreads) {
    const int row = idx / per_row;
    const int q = (idx - row * per_row) * step;
    const int p = w0 - kBWinLo + q;
    const bool ok = p >= 0 && p < width;
    const bf16* src = row < kC2 ? y2g + ((size_t)b * kC2 + row) * width
                    : row < kC2 + kC1
                        ? y1g + ((size_t)b * kC1 + row - kC2) * width
                        : fpg + (size_t)b * width;
    if (vec)
      cp_async16(ys + row * kBWS + q, src + (ok ? p : 0), ok);
    else
      ys[row * kBWS + q] = ok ? src[p] : __float2bfloat16_rn(0.0f);
  }
  cp_commit();
}

// d2 = mask * bf16(dgrad(d3, w3)) on channels 16m .. 16m+15 and the NT
// column tiles from n0 of the tile's d2 rows (row r is position
// w0 - kBD2Lo + r), transposed: C[i][r] = sum_{k,o} w3t[k][i][o] *
// d3[r + 1 - k][o].  A is w3t (ldmatrix), B the d3 rows shifted by 1 - k
// (ldmatrix, rows clamped into the stage: a clamped row only feeds a d2 row
// that is stored as 0).  Rows outside positions w0-1 .. w0+TW are stored
// as 0; the others are rounded to bf16, then masked by y2 > 0.
template <int NT>
__device__ __forceinline__ void d2_rows(const bf16* __restrict__ w3t,
                                        const bf16* __restrict__ d3s,
                                        const bf16* __restrict__ y2s,
                                        bf16* __restrict__ d2s, int m,
                                        int n0, int lane) {
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const int j = lane >> 3;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    // the d3 stage row of the d2 row r = 8 * n0 + u: r + kBD3Lo - kBD2Lo
    // + 1 - k, clamped
    int rows[(NT + 1) / 2];
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      const int u = 8 * n + (lane & 7) + (n + 1 < NT ? 8 * (j >> 1) : 0);
      rows[n / 2] = min(max(8 * n0 + u + kBD3Lo - kBD2Lo + 1 - k, 0),
                        kBP3 - 1) * kBD3S + 8 * (j & 1);
    }
#pragma unroll 2
    for (int oc = 0; oc < kC3; oc += 16) {
      unsigned a[4];
      ldsm_x4(a, w3t + (k * kC2 + 16 * m + (lane & 15)) * kBW3S + oc +
                     8 * (lane >> 4));
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        unsigned b[4];
        ldsm_x4(b, d3s + rows[n / 2] + oc);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
      if (NT % 2) {
        unsigned b[2];
        ldsm_x2(b, d3s + rows[NT / 2] + oc);
        mma_bf16(acc[NT - 1], a, b[0], b[1]);
      }
    }
  }
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * m + g + 8 * h;
      const int r = 8 * (n0 + n) + 2 * tq;
      const bf162 y = *reinterpret_cast<const bf162*>(
          y2s + i * kBWS + r - kBD2Lo + kBWinLo);
      const float yv[2] = {__low2float(y), __high2float(y)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool keep = r + e >= kBD2Lo - 1 && r + e <= kBD2Lo + kBTW &&
                          yv[e] > 0.0f;
        d2s[(r + e) * kBD2S + i] =
            __float2bfloat16_rn(keep ? acc[n][2 * h + e] : 0.0f);
      }
    }
}

__global__ void __launch_bounds__(kBThreads, 1)
cnn_chain_bwd_bf16_kernel(const bf16* __restrict__ d3g,
                          const bf16* __restrict__ y2g,
                          const bf16* __restrict__ y1g,
                          const bf16* __restrict__ fpg,
                          const bf16* __restrict__ w3g,
                          const bf16* __restrict__ w2g,
                          float* __restrict__ partials, int batch, int width,
                          int vec) {
  extern __shared__ __align__(16) bf16 bsmem[];
  bf16* w3t = bsmem;                   // [k][i][o]: dgrad A, o contiguous
  bf16* w2t = bsmem + kBOffW2;
  bf16* ring = bsmem + kBOffRing;
  bf16* d2s = bsmem + kBOffD2;         // [r][o], pos-major
  bf16* zrow = bsmem + kBOffZero;

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int g = lane >> 2;             // mma fragment row
  const int tq = lane & 3;             // mma fragment column pair
  const int j = lane >> 3;             // ldmatrix 8x8 of this lane's row
  const int nwt = (width + kBTW - 1) / kBTW;
  const int ntiles = batch * nwt;
#pragma unroll
  for (int s = 0; s < kBStages - 1; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < ntiles)
      stage_tile_bf16(ring + s * kBStage, tile, nwt, d3g, y2g, y1g, fpg,
                      width, vec, t);
    else
      cp_commit();
  }
  for (int idx = t; idx < kNW3; idx += kBThreads) {
    const int o = idx / (kC2 * 3);
    const int rem = idx - o * (kC2 * 3);
    const int i = rem / 3;
    const int k = rem - i * 3;
    w3t[(k * kC2 + i) * kBW3S + o] = w3g[idx];
  }
  for (int idx = t; idx < kNW2; idx += kBThreads) {
    const int o = idx / (kC1 * 3);
    const int rem = idx - o * (kC1 * 3);
    const int i = rem / 3;
    const int k = rem - i * 3;
    w2t[(k * kC1 + i) * kBW2S + o] = w2g[idx];
  }
  for (int idx = t; idx < kC3; idx += kBThreads)
    zrow[idx] = __float2bfloat16_rn(0.0f);

  // dw3: warp w owns out channels 16w .. 16w+15, all 64 in channels, 3 taps
  float acc3[3][8][4];
  // dw2: out channels 16 * (w % 4) .., in channels 16 * (w / 4) .., 3 taps
  float acc2[3][2][4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc3[k][n][0] = acc3[k][n][1] = acc3[k][n][2] = acc3[k][n][3] = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      acc2[k][n][0] = acc2[k][n][1] = acc2[k][n][2] = acc2[k][n][3] = 0.0f;
  }
  float db3p[2] = {0.0f, 0.0f};        // channels 2 (t % 64), +1
  float db2p[2] = {0.0f, 0.0f};        // channels 2 (t % 32), +1
  float dw1p[2][4] = {};               // d1 channels 16 (w % 2) + g, +8:
                                       // dw1 taps 0..2, db1
  const int mo = warp & 3;             // dw2 out channel tile, d2 channels
  const int nh = warp >> 2;            // dw2 in channel half
  const int mi = warp & 1;             // d1 channel tile
  const int nq = warp >> 1;            // d1 position quarter

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    cp_wait<kBStages - 2>();
    __syncthreads();   // this tile staged; the last tile's readers done
    {
      const int next = tile + (kBStages - 1) * (int)gridDim.x;
      bf16* dst = ring + (it + kBStages - 1) % kBStages * kBStage;
      if (next < ntiles)
        stage_tile_bf16(dst, next, nwt, d3g, y2g, y1g, fpg, width, vec, t);
      else
        cp_commit();
    }
    const bf16* d3s = ring + it % kBStages * kBStage;   // [s][o]
    const bf16* y2s = d3s + kBP3 * kBD3S;               // [i][window]
    const bf16* y1s = y2s + kC2 * kBWS;
    const bf16* fps = y1s + kC1 * kBWS;

    // ==== bf16 L3: dw3, db3 ==============================================
    // dw3[k][o][i] += sum_p d3[p - k + 1][o] y2[i][p] over the core p,
    // with d3 rows outside the core read as the zero row: A = the shifted
    // d3 rows (ldmatrix.trans), B = the y2 window (ldmatrix); the terms at
    // p = w0 - 1 (k = 0) and p = w0 + TW (k = 2) are added on the FMA pipe
#pragma unroll 1
    for (int c = 0; c < kBTW; c += 16) {
      unsigned b[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldsm_x4(b[np], y2s + (16 * np + (lane & 7) + 8 * (j >> 1)) * kBWS +
                           kBWinLo + c + 8 * (j & 1));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int s = c + (lane & 7) + 8 * (j >> 1) + 1 - k + kBD3Lo;
        const bool halo = s == kBD3Lo - 1 || s == kBD3Lo + kBTW;
        unsigned a[4];
        ldsm_x4_t(a, (halo ? zrow : d3s + s * kBD3S + 16 * warp) +
                         8 * (j & 1));
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mma_bf16(acc3[k][n], a, b[n / 2][2 * (n % 2)],
                   b[n / 2][2 * (n % 2) + 1]);
      }
    }
    {
      const bf16* q0 = d3s + kBD3Lo * kBD3S + 16 * warp + g;
      const bf16* q1 = d3s + (kBD3Lo + kBTW - 1) * kBD3S + 16 * warp + g;
      const float a0[2] = {bf(q0[0]), bf(q0[8])};
      const float a2[2] = {bf(q1[0]), bf(q1[8])};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bf16* yi = y2s + (8 * n + 2 * tq + e) * kBWS;
          const float ylo = bf(yi[kBWinLo - 1]);
          const float yhi = bf(yi[kBWinLo + kBTW]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc3[0][n][2 * h + e] = fmaf(a0[h], ylo, acc3[0][n][2 * h + e]);
            acc3[2][n][2 * h + e] = fmaf(a2[h], yhi, acc3[2][n][2 * h + e]);
          }
        }
    }
    for (int s = kBD3Lo + (t >> 6); s < kBD3Lo + kBTW; s += 4) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(d3s + s * kBD3S + 2 * (t & 63)));
      db3p[0] += v.x;
      db3p[1] += v.y;
    }
    // ==== bf16 L3: d2 ====================================================
    if (warp < 4)
      d2_rows<kBN2a>(w3t, d3s, y2s, d2s, mo, 0, lane);
    else
      d2_rows<kBN2 - kBN2a>(w3t, d3s, y2s, d2s, mo, kBN2a, lane);
    __syncthreads();   // d2 is in shared memory
    // ==== bf16 L2: dw2, db2 ==============================================
    // as dw3: A = the shifted d2 rows, B = the y1 window
#pragma unroll 1
    for (int c = 0; c < kBTW; c += 16) {
      unsigned b[4];
      ldsm_x4(b, y1s + (16 * nh + (lane & 7) + 8 * (j >> 1)) * kBWS +
                     kBWinLo + c + 8 * (j & 1));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int r = c + (lane & 7) + 8 * (j >> 1) + 1 - k + kBD2Lo;
        const bool halo = r == kBD2Lo - 1 || r == kBD2Lo + kBTW;
        unsigned a[4];
        ldsm_x4_t(a, (halo ? zrow : d2s + r * kBD2S + 16 * mo) +
                         8 * (j & 1));
        mma_bf16(acc2[k][0], a, b[0], b[1]);
        mma_bf16(acc2[k][1], a, b[2], b[3]);
      }
    }
    {
      const bf16* q0 = d2s + kBD2Lo * kBD2S + 16 * mo + g;
      const bf16* q1 = d2s + (kBD2Lo + kBTW - 1) * kBD2S + 16 * mo + g;
      const float a0[2] = {bf(q0[0]), bf(q0[8])};
      const float a2[2] = {bf(q1[0]), bf(q1[8])};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bf16* yi = y1s + (16 * nh + 8 * n + 2 * tq + e) * kBWS;
          const float ylo = bf(yi[kBWinLo - 1]);
          const float yhi = bf(yi[kBWinLo + kBTW]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc2[0][n][2 * h + e] = fmaf(a0[h], ylo, acc2[0][n][2 * h + e]);
            acc2[2][n][2 * h + e] = fmaf(a2[h], yhi, acc2[2][n][2 * h + e]);
          }
        }
    }
    for (int r = kBD2Lo + (t >> 5); r < kBD2Lo + kBTW; r += 8) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(d2s + r * kBD2S + 2 * (t & 31)));
      db2p[0] += v.x;
      db2p[1] += v.y;
    }
    // ==== bf16 L2: d1, dw1, db1 ==========================================
    // d1 = mask * bf16(dgrad(d2, w2)) on the core, transposed as d2 (M =
    // channels 16 mi .., N = kBN1 column tiles from 8 kBN1 nq); it never
    // leaves registers: each lane adds its dw1 and db1 terms
    {
      float acc[kBN1][4];
#pragma unroll
      for (int n = 0; n < kBN1; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll 1
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int oc = 0; oc < kC2; oc += 16) {
          unsigned a[4];
          ldsm_x4(a, w2t + (k * kC1 + 16 * mi + (lane & 15)) * kBW2S + oc +
                         8 * (lane >> 4));
#pragma unroll
          for (int n = 0; n + 1 < kBN1; n += 2) {
            const int u = 8 * (kBN1 * nq + n) + (lane & 7) + 8 * (j >> 1);
            unsigned b[4];
            ldsm_x4(b, d2s + (u + 1 - k + kBD2Lo) * kBD2S + oc + 8 * (j & 1));
            mma_bf16(acc[n], a, b[0], b[1]);
            mma_bf16(acc[n + 1], a, b[2], b[3]);
          }
          if (kBN1 % 2) {
            const int u = 8 * (kBN1 * nq + kBN1 - 1) + (lane & 7);
            unsigned b[2];
            ldsm_x2(b, d2s + (u + 1 - k + kBD2Lo) * kBD2S + oc + 8 * (j & 1));
            mma_bf16(acc[kBN1 - 1], a, b[0], b[1]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kBN1; ++n) {
        const int u = 8 * (kBN1 * nq + n) + 2 * tq;   // position - w0
        const float f[4] = {bf(fps[kBWinLo + u - 1]), bf(fps[kBWinLo + u]),
                            bf(fps[kBWinLo + u + 1]),
                            bf(fps[kBWinLo + u + 2])};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf162 y = *reinterpret_cast<const bf162*>(
              y1s + (16 * mi + g + 8 * h) * kBWS + kBWinLo + u);
          const float yv[2] = {__low2float(y), __high2float(y)};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d =
                yv[e] > 0.0f ? bf(__float2bfloat16_rn(acc[n][2 * h + e]))
                             : 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              dw1p[h][k] = fmaf(d, f[e + k], dw1p[h][k]);
            dw1p[h][3] += d;
          }
        }
      }
    }
  }
  cp_wait_all();
  __syncthreads();   // the walk is over: its memory takes the block's sums

  // ---- this block's sums -> partials[blockIdx.x], torch layouts ---------
  float* part = reinterpret_cast<float*>(bsmem);
  float* s_db3 = part + kNTot;          // [4][128]
  float* s_db2 = s_db3 + 4 * kC3;       // [8][64]
  float* s_d1 = s_db2 + 8 * kC2;        // [warp][16][dw1 0..2, db1]
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 16 * warp + g + 8 * (e >> 1);
        const int i = 8 * n + 2 * tq + (e & 1);
        part[(o * kC2 + i) * 3 + k] = acc3[k][n][e];
      }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 16 * mo + g + 8 * (e >> 1);
        const int i = 16 * nh + 8 * n + 2 * tq + (e & 1);
        part[kOffDw2 + (o * kC1 + i) * 3 + k] = acc2[k][n][e];
      }
  }
  s_db3[(t >> 6) * kC3 + 2 * (t & 63)] = db3p[0];
  s_db3[(t >> 6) * kC3 + 2 * (t & 63) + 1] = db3p[1];
  s_db2[(t >> 5) * kC2 + 2 * (t & 31)] = db2p[0];
  s_db2[(t >> 5) * kC2 + 2 * (t & 31) + 1] = db2p[1];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float v = dw1p[h][x];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tq == 0) s_d1[(warp * 16 + g + 8 * h) * 4 + x] = v;
    }
  __syncthreads();
  if (t < kC3) {
    part[kOffDb3 + t] = ((s_db3[t] + s_db3[kC3 + t]) + s_db3[2 * kC3 + t]) +
                        s_db3[3 * kC3 + t];
  } else if (t < kC3 + kC2) {
    float s = 0.0f;
    for (int q = 0; q < 8; ++q) s += s_db2[q * kC2 + t - kC3];
    part[kOffDb2 + t - kC3] = s;
  }
  if (t < kC1 * 4) {
    const int i = t >> 2;
    const int x = t & 3;
    float s = 0.0f;
    for (int w = i >> 4; w < kBWarps; w += 2)
      s += s_d1[(w * 16 + (i & 15)) * 4 + x];
    part[x < 3 ? kOffDw1 + i * 3 + x : kOffDb1 + i] = s;
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(partials +
                                          (size_t)blockIdx.x * kNTot);
  for (int q = t; q < kNTot / 4; q += kBThreads)
    dst[q] = reinterpret_cast<const float4*>(part)[q];
}

// out[q] = sum over blocks g, in order, of partials[g][q] (the partial rows
// are in the output's layout)
__global__ void cnn_chain_sum_kernel(const float* __restrict__ partials,
                                     float* __restrict__ out, int blocks) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= kNTot) return;
  float s = 0.0f;
  for (int g = 0; g < blocks; ++g) s += partials[(size_t)g * kNTot + q];
  out[q] = s;
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

// d3 [B, W, 128], y2 [B, 64, W], y1 [B, 32, W], fp [B, W], w3 [128, 64, 3],
// w2 [64, 32, 3]: f32, contiguous, on the current device, d3 16-byte
// aligned.  partials [blocks, 31040] and out [31040] f32 (dw3 | db3 | dw2 |
// db2 | dw1 | db1, torch layouts); blocks >= 1.  Returns cudaGetLastError()
// after the two launches (0 on success).
extern "C" int cnn_chain_bwd_launch(const void* d3, const void* y2,
                                    const void* y1, const void* fp,
                                    const void* w3, const void* w2,
                                    void* partials, void* out, int batch,
                                    int width, int blocks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int vec = width % 4 == 0 && aligned16(y2) && aligned16(y1) &&
                  aligned16(fp);
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cnn_chain_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cnn_chain_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(d3), static_cast<const float*>(y2),
      static_cast<const float*>(y1), static_cast<const float*>(fp),
      static_cast<const float*>(w3), static_cast<const float*>(w2),
      static_cast<float*>(partials), batch, width, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cnn_chain_reduce_kernel<<<(kNTot + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), blocks);
  return (int)cudaGetLastError();
}

// The same in bf16: d3, y2, y1, fp, w3 and w2 bf16 (d3 16-byte aligned);
// partials and out f32.  The grid walks tiles of kBTW positions.
extern "C" int cnn_chain_bwd_bf16_launch(const void* d3, const void* y2,
                                         const void* y1, const void* fp,
                                         const void* w3, const void* w2,
                                         void* partials, void* out,
                                         int batch, int width, int blocks,
                                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int vec = width % 8 == 0 && aligned16(y2) && aligned16(y1) &&
                  aligned16(fp);
  cudaError_t err = cudaFuncSetAttribute(
      cnn_chain_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBSmem);
  if (err != cudaSuccess) return (int)err;
  cnn_chain_bwd_bf16_kernel<<<blocks, kBThreads, kBSmem, s>>>(
      static_cast<const bf16*>(d3), static_cast<const bf16*>(y2),
      static_cast<const bf16*>(y1), static_cast<const bf16*>(fp),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
      static_cast<float*>(partials), batch, width, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cnn_chain_sum_kernel<<<(kNTot + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), blocks);
  return (int)cudaGetLastError();
}
