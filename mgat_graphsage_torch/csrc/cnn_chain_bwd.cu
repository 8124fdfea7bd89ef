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
// bf16 variant (cnn_chain_bwd_bf16_launch, compute_dtype="bfloat16"): d3,
// y2, y1, fp, w3 and w2 in bf16; the sums and the six outputs f32.  It is
// the same kernel, instantiated on its storage type: a tile's bf16 window
// is copied into one of two bf16 stage buffers (cp.async, 8-byte copies
// of y2, y1 and fp where W % 4 == 0, else plain loads) and widened into
// one f32 buffer at the start of its turn, so the products are the f32
// kernel's on the exact bf16 values.  As the reference's kernel does
// (pallas_cnn.py:_chain_bwd_kernel), d2 and d1 are rounded to bf16 before
// their ReLU masks, and every sum stays f32.  Bound on the H100 at B=1024,
// W=1024: 472 MB of bf16 activations, 141 us at 3.35 TB/s, against
// ~131 GFLOP, 133 us at the dense bf16 tensor-core rate.  This variant
// runs on the f32 FMA pipe (~2 ms for those operations alone at 67
// TFLOP/s): it is the simple, exact design, not a fast one.  Shared
// memory: 222 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
// bf16: one f32 stage buffer and two bf16 ones, each padded to 16 bytes
constexpr int kRawStage = (kStage + 7) / 8 * 8;        // bf16 values
constexpr int kSmemFloatsBf16 = kSW3 + kSW2 + kStage + kRawStage + kSD2 +
                                kNW2;
static_assert(kSmemFloatsBf16 * 4 <= 232448, "shared memory, bf16");
static_assert(kStage % 4 == 0, "the widening pass takes 4 values a step");
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

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

template <typename T>
constexpr bool kNarrow = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a dgrad as the storage type holds it (the reference rounds it to the
// compute dtype before the ReLU mask)
template <typename T>
__device__ __forceinline__ float stored(float v) {
  if constexpr (kNarrow<T>)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
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
// lies wholly inside or outside [0, W)), else in 4-byte copies.  bf16: the
// same layout in bf16, d3 in 16-byte copies, the windows in 8-byte copies
// where `vec`, else in plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_tile(T* st, int tile, int nwt,
                                           const T* __restrict__ d3g,
                                           const T* __restrict__ y2g,
                                           const T* __restrict__ y1g,
                                           const T* __restrict__ fpg,
                                           int width, bool vec, int t) {
  constexpr int kPer16 = 16 / sizeof(T);     // values per 16-byte copy
  const int b = tile / nwt;
  const int w0 = (tile - b * nwt) * kTW;
  for (int idx = t; idx < kP3 * (kC3 / kPer16); idx += kThreads) {
    const int s = idx / (kC3 / kPer16);
    const int c = (idx - s * (kC3 / kPer16)) * kPer16;
    const int p = w0 - 2 + s;
    const bool ok = p >= 0 && p < width;
    cp_async16(st + s * kC3 + c,
               d3g + ((size_t)b * width + (ok ? p : 0)) * kC3 + c, ok);
  }
  T* ys = st + kSD3;
  const int step = vec ? 4 : 1;
  const int per_row = kWin / step;
  for (int idx = t; idx < kYRows * per_row; idx += kThreads) {
    const int row = idx / per_row;
    const int q = (idx - row * per_row) * step;
    const int p = w0 - 4 + q;
    const bool ok = p >= 0 && p < width;
    const T* src = row < kC2 ? y2g + ((size_t)b * kC2 + row) * width
                 : row < kC2 + kC1
                     ? y1g + ((size_t)b * kC1 + row - kC2) * width
                     : fpg + (size_t)b * width;
    if constexpr (kNarrow<T>) {
      if (vec)
        cp_async8(ys + row * kWS + q, src + (ok ? p : 0), ok);
      else
        ys[row * kWS + q] = ok ? src[p] : __float2bfloat16_rn(0.0f);
    } else {
      if (vec)
        cp_async16(ys + row * kWS + q, src + (ok ? p : 0), ok);
      else
        cp_async4(ys + row * kWS + q, src + (ok ? p : 0), ok);
    }
  }
  cp_commit();
}

// the bf16 stage buffer `buf`, after the f32 one (kNarrow), or the f32
// stage buffer `buf`
template <typename T>
__device__ __forceinline__ T* stage_buf(float* stages, int buf) {
  if constexpr (kNarrow<T>)
    return reinterpret_cast<T*>(stages + kStage) + buf * kRawStage;
  else
    return stages + buf * kStage;
}

// a staged bf16 tile, widened into the f32 stage buffer, 4 values a step
__device__ __forceinline__ void widen_stage(float* dst,
                                            const __nv_bfloat16* src, int t) {
  for (int i = t; i < kStage / 4; i += kThreads) {
    const uint2 v = *reinterpret_cast<const uint2*>(src + 4 * i);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    *reinterpret_cast<float4*>(dst + 4 * i) =
        make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
cnn_chain_bwd_kernel(const T* __restrict__ d3g, const T* __restrict__ y2g,
                     const T* __restrict__ y1g, const T* __restrict__ fpg,
                     const T* __restrict__ w3g, const T* __restrict__ w2g,
                     float* __restrict__ partials, int batch, int width,
                     int vec) {
  extern __shared__ __align__(16) float smem[];
  float* w3s = smem;
  float* w2s = w3s + kSW3;
  float* stages = w2s + kSW2;
  float* d2s = stages + (kNarrow<T> ? kStage + kRawStage : 2 * kStage);
  float* dw2a = d2s + kSD2;      // [k][i][o]

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int nwt = (width + kTW - 1) / kTW;
  const int ntiles = batch * nwt;
  if ((int)blockIdx.x < ntiles)
    stage_tile(stage_buf<T>(stages, 0), blockIdx.x, nwt, d3g, y2g, y1g, fpg,
               width, vec, t);

  for (int idx = t; idx < kNW3; idx += kThreads) {
    const int o = idx / (kC2 * 3);
    const int rem = idx - o * (kC2 * 3);
    const int i = rem / 3;
    const int k = rem - i * 3;
    w3s[(k * kC3 + o) * kC2 + i] = widen(w3g[idx]);
  }
  for (int idx = t; idx < kNW2; idx += kThreads) {
    const int o = idx / (kC1 * 3);
    const int rem = idx - o * (kC1 * 3);
    const int i = rem / 3;
    const int k = rem - i * 3;
    w2s[(k * kC2 + o) * kC1 + i] = widen(w2g[idx]);
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
      stage_tile(stage_buf<T>(stages, buf ^ 1), tile + gridDim.x, nwt, d3g,
                 y2g, y1g, fpg, width, vec, t);
    const float* d3s = stages + (kNarrow<T> ? 0 : buf * kStage);
    if constexpr (kNarrow<T>) {
      widen_stage(stages, stage_buf<T>(stages, buf), t);
      __syncthreads();   // the tile is in the f32 buffer
    }
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
              y2s[ch * kWS + s2 + kQ] > 0.0f ? stored<T>(acc[r][0]) : 0.0f;
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
        const float v = mv[r] > 0.0f ? stored<T>(acc[r][0]) : 0.0f;
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

namespace {

// the chain kernel on storage type T (align: the bytes a window copy
// moves), then the reduction over blocks
template <typename T>
int chain_launch(const void* d3, const void* y2, const void* y1,
                 const void* fp, const void* w3, const void* w2,
                 void* partials, void* out, int batch, int width, int blocks,
                 void* stream, size_t align, size_t smem) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int vec = width % 4 == 0 && (reinterpret_cast<size_t>(y2) |
                                     reinterpret_cast<size_t>(y1) |
                                     reinterpret_cast<size_t>(fp)) % align == 0;
  cudaError_t err = cudaFuncSetAttribute(
      cnn_chain_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cnn_chain_bwd_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(d3), static_cast<const T*>(y2),
      static_cast<const T*>(y1), static_cast<const T*>(fp),
      static_cast<const T*>(w3), static_cast<const T*>(w2),
      static_cast<float*>(partials), batch, width, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cnn_chain_reduce_kernel<<<(kNTot + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), blocks);
  return (int)cudaGetLastError();
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
  return chain_launch<float>(d3, y2, y1, fp, w3, w2, partials, out, batch,
                             width, blocks, stream, 16,
                             (size_t)kSmemFloats * sizeof(float));
}

// The same in bf16: d3, y2, y1, fp, w3 and w2 bf16 (d3 16-byte aligned);
// partials and out f32.
extern "C" int cnn_chain_bwd_bf16_launch(const void* d3, const void* y2,
                                         const void* y1, const void* fp,
                                         const void* w3, const void* w2,
                                         void* partials, void* out,
                                         int batch, int width, int blocks,
                                         void* stream) {
  return chain_launch<__nv_bfloat16>(d3, y2, y1, fp, w3, w2, partials, out,
                                     batch, width, blocks, stream, 8,
                                     (size_t)kSmemFloatsBf16 * sizeof(float));
}
