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
// byte, far above the f32 ridge of 20.
//
// Design: the position axis is cut into tiles of 32 positions of one
// molecule (any B and W; the last tile of a row is ragged).  A persistent
// grid of one block per SM walks the tiles in a fixed order.  A tile
// stages d3 and y2 over its positions +-2 and y1, fp over +-1 (zero
// outside [0, W)) in shared memory beside w3 and w2, computes d2 over the
// tile +-1 and d1 over the tile there, so neither goes to device memory,
// and adds the tile's weight and bias gradients to per-block sums: dw3
// stays in registers (8 x 4 x 3 per thread), the smaller sums in shared
// memory, each owned by one thread.  Each block then writes its sums once,
// and a second kernel adds the blocks' sums in block order.  No atomics:
// the result repeats bit for bit.  Shared memory: 190 KB.

#include <cuda_runtime.h>

namespace {

constexpr int kC3 = 128;
constexpr int kC2 = 64;
constexpr int kC1 = 32;
constexpr int kTW = 32;            // core positions per tile
constexpr int kP3 = kTW + 4;       // d3, y2 rows: positions w0-2 .. w0+TW+1
constexpr int kP2 = kTW + 2;       // d2, y1, fp rows: positions w0-1 .. w0+TW
constexpr int kY2S = kC2 + 4;      // padded row strides (multiples of 4)
constexpr int kY1S = kC1 + 4;
constexpr int kThreads = 256;

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
constexpr int kSD3 = kP3 * kC3;
constexpr int kSY2 = kP3 * kY2S;
constexpr int kSD2 = kP2 * kC2;
constexpr int kSY1 = kP2 * kY1S;
constexpr int kSD1 = kTW * kC1;
constexpr int kSFp = kP2 + 2;
constexpr int kSAcc = kNW2 + kNW1 + kC3 + kC2 + kC1;
constexpr int kSmemFloats =
    kSW3 + kSW2 + kSD3 + kSY2 + kSD2 + kSY1 + kSD1 + kSFp + kSAcc;

__global__ void __launch_bounds__(kThreads, 1)
cnn_chain_bwd_kernel(const float* __restrict__ d3g,
                     const float* __restrict__ y2g,
                     const float* __restrict__ y1g,
                     const float* __restrict__ fpg,
                     const float* __restrict__ w3g,
                     const float* __restrict__ w2g,
                     float* __restrict__ partials, int batch, int width) {
  extern __shared__ __align__(16) float smem[];
  float* w3s = smem;
  float* w2s = w3s + kSW3;
  float* d3s = w2s + kSW2;
  float* y2s = d3s + kSD3;
  float* d2s = y2s + kSY2;
  float* y1s = d2s + kSD2;
  float* d1s = y1s + kSY1;
  float* fps = d1s + kSD1;
  float* dw2a = fps + kSFp;
  float* dw1a = dw2a + kNW2;
  float* db3a = dw1a + kNW1;
  float* db2a = db3a + kC3;
  float* db1a = db2a + kC2;

  const int t = threadIdx.x;
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
  for (int idx = t; idx < kSAcc; idx += kThreads) dw2a[idx] = 0.0f;

  // dw3 register tile: out channels 8*tb3 .. +7, in channels 4*ib3 .. +3
  const int tb3 = t / 16;
  const int ib3 = t % 16;
  float acc3[3][8][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc3[k][r][c] = 0.0f;

  const int lane = t % 32;
  const int warp = t / 32;
  const int nwt = (width + kTW - 1) / kTW;
  const int ntiles = batch * nwt;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / nwt;
    const int w0 = (tile - b * nwt) * kTW;
    __syncthreads();   // the previous tile's readers are done

    // ---- stage the tile (zero outside [0, W)) --------------------------
    for (int idx = t; idx < kP3 * (kC3 / 4); idx += kThreads) {
      const int s = idx / (kC3 / 4);
      const int c = (idx - s * (kC3 / 4)) * 4;
      const int p = w0 - 2 + s;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p >= 0 && p < width) {
        val = *reinterpret_cast<const float4*>(
            d3g + ((size_t)b * width + p) * kC3 + c);
      }
      *reinterpret_cast<float4*>(d3s + s * kC3 + c) = val;
    }
    for (int idx = t; idx < kC2 * kP3; idx += kThreads) {
      const int c = idx / kP3;
      const int s = idx - c * kP3;
      const int p = w0 - 2 + s;
      y2s[s * kY2S + c] = (p >= 0 && p < width)
          ? y2g[((size_t)b * kC2 + c) * width + p] : 0.0f;
    }
    for (int idx = t; idx < kC1 * kP2; idx += kThreads) {
      const int c = idx / kP2;
      const int s = idx - c * kP2;
      const int p = w0 - 1 + s;
      y1s[s * kY1S + c] = (p >= 0 && p < width)
          ? y1g[((size_t)b * kC1 + c) * width + p] : 0.0f;
    }
    for (int s = t; s < kP2; s += kThreads) {
      const int p = w0 - 1 + s;
      fps[s] = (p >= 0 && p < width) ? fpg[(size_t)b * width + p] : 0.0f;
    }
    __syncthreads();

    // ---- level 3: dw3 (registers), db3, d2 = mask * dgrad(d3, w3) ------
    for (int sc = 0; sc < kTW; ++sc) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          d3s + (sc + 2) * kC3 + 8 * tb3);
      const float4 a1 = *reinterpret_cast<const float4*>(
          d3s + (sc + 2) * kC3 + 8 * tb3 + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 bq = *reinterpret_cast<const float4*>(
            y2s + (sc + k + 1) * kY2S + 4 * ib3);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc3[k][r][c] = fmaf(av[r], bv[c], acc3[k][r][c]);
      }
    }
    if (t < kC3) {
      float s = 0.0f;
      for (int sc = 0; sc < kTW; ++sc) s += d3s[(sc + 2) * kC3 + t];
      db3a[t] += s;
    }
    {
      // d2 rows s2 = warp + 8 r (r < 5, s2 < kP2), channels 2*lane, +1
      float ad[5][2];
#pragma unroll
      for (int r = 0; r < 5; ++r) ad[r][0] = ad[r][1] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        for (int o = 0; o < kC3; ++o) {
          const float2 wv = *reinterpret_cast<const float2*>(
              w3s + (k * kC3 + o) * kC2 + 2 * lane);
#pragma unroll
          for (int r = 0; r < 5; ++r) {
            const int s2 = warp + 8 * r;
            if (s2 < kP2) {
              const float d = d3s[(s2 - k + 2) * kC3 + o];
              ad[r][0] = fmaf(d, wv.x, ad[r][0]);
              ad[r][1] = fmaf(d, wv.y, ad[r][1]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const int s2 = warp + 8 * r;
        if (s2 < kP2) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * lane + e;
            d2s[s2 * kC2 + i] = y2s[(s2 + 1) * kY2S + i] > 0.0f ? ad[r][e]
                                                                : 0.0f;
          }
        }
      }
    }
    __syncthreads();

    // ---- level 2: dw2, db2 (shared sums), d1 = mask * dgrad(d2, w2) ----
    {
      const int tb2 = t / 16;     // out channels 4*tb2 .. +3
      const int ib2 = t % 16;     // in channels 2*ib2, +1
      float a2[3][4][2];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) a2[k][r][0] = a2[k][r][1] = 0.0f;
      for (int sc = 0; sc < kTW; ++sc) {
        const float4 a = *reinterpret_cast<const float4*>(
            d2s + (sc + 1) * kC2 + 4 * tb2);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float2 bq = *reinterpret_cast<const float2*>(
              y1s + (sc + k) * kY1S + 2 * ib2);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a2[k][r][0] = fmaf(av[r], bq.x, a2[k][r][0]);
            a2[k][r][1] = fmaf(av[r], bq.y, a2[k][r][1]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            dw2a[((4 * tb2 + r) * kC1 + 2 * ib2 + c) * 3 + k] += a2[k][r][c];
    }
    if (t < kC2) {
      float s = 0.0f;
      for (int sc = 0; sc < kTW; ++sc) s += d2s[(sc + 1) * kC2 + t];
      db2a[t] += s;
    }
    {
      // d1 rows sc = warp + 8 r (r < 4), channel lane
      float ad[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        for (int o = 0; o < kC2; ++o) {
          const float wv = w2s[(k * kC2 + o) * kC1 + lane];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int sc = warp + 8 * r;
            ad[r] = fmaf(d2s[(sc - k + 2) * kC2 + o], wv, ad[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int sc = warp + 8 * r;
        d1s[sc * kC1 + lane] = y1s[(sc + 1) * kY1S + lane] > 0.0f ? ad[r]
                                                                  : 0.0f;
      }
    }
    __syncthreads();

    // ---- level 1: dw1, db1 ---------------------------------------------
    if (t < kNW1) {
      const int o = t / 3;
      const int k = t - o * 3;
      float s = 0.0f;
      for (int sc = 0; sc < kTW; ++sc) s = fmaf(d1s[sc * kC1 + o], fps[sc + k], s);
      dw1a[t] += s;
    } else if (t < kNW1 + kC1) {
      const int o = t - kNW1;
      float s = 0.0f;
      for (int sc = 0; sc < kTW; ++sc) s += d1s[sc * kC1 + o];
      db1a[o] += s;
    }
  }
  __syncthreads();

  // ---- this block's sums -> partials[blockIdx.x] -------------------------
  float* part = partials + (size_t)blockIdx.x * kNTot;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[((8 * tb3 + r) * kC2 + 4 * ib3 + c) * 3 + k] = acc3[k][r][c];
  for (int idx = t; idx < kC3; idx += kThreads) part[kOffDb3 + idx] = db3a[idx];
  for (int idx = t; idx < kNW2; idx += kThreads) part[kOffDw2 + idx] = dw2a[idx];
  for (int idx = t; idx < kC2; idx += kThreads) part[kOffDb2 + idx] = db2a[idx];
  for (int idx = t; idx < kNW1; idx += kThreads) part[kOffDw1 + idx] = dw1a[idx];
  for (int idx = t; idx < kC1; idx += kThreads) part[kOffDb1 + idx] = db1a[idx];
}

// out[e] = sum over blocks g, in order, of partials[g][e]
__global__ void cnn_chain_reduce_kernel(const float* __restrict__ partials,
                                        float* __restrict__ out, int blocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kNTot) return;
  float s = 0.0f;
  for (int g = 0; g < blocks; ++g) s += partials[(size_t)g * kNTot + e];
  out[e] = s;
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
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cnn_chain_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cnn_chain_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(d3), static_cast<const float*>(y2),
      static_cast<const float*>(y1), static_cast<const float*>(fp),
      static_cast<const float*>(w3), static_cast<const float*>(w2),
      static_cast<float*>(partials), batch, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cnn_chain_reduce_kernel<<<(kNTot + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), blocks);
  return (int)cudaGetLastError();
}
