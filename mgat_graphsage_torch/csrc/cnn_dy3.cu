// Masked fc1 input gradient of the fingerprint CNN, for Hopper (sm_90a).
//
// Replaces: mgat_graphsage_tpu/ops/pallas_cnn.py::_dy3_pallas (_dy3_kernel),
// kernel 1 of the fused CNN-branch backward.
//
// Computes, for every molecule b and pos-major column k = w * C + c of the
// flattened conv3 output (all f32):
//     dy3[b, k] = (sum_h dy[b, h] * fc1_w[h, k]) * (y3[b, k] > 0)
// dy [B, H]; fc1_w [H, K] (torch Linear layout, K = W * C, pos-major
// columns); y3 [B, K] the post-ReLU conv3 output as the forward flattened
// it; dy3 [B, K], read as [B, W, C] by csrc/cnn_chain_bwd.cu with no copy
// between.  The ReLU mask uses the post-activation, as the reference does.
//
// Bound on the H100: operations.  2 B H K flops (8.6 GFLOP at B=128,
// H=256, K=131072) against the fc1 weight (134 MB), y3 and dy3 (67 MB
// each): 32 flops per byte, above the f32 ridge of 20.
//
// Design: a plain SIMT SGEMM, no cuBLAS and no tensor cores (f32).  Block
// tile 128 molecules x 128 columns, 256 threads, each thread an 8 x 8
// register tile; the reduction over H runs in chunks of 16 staged in
// shared memory (dy transposed, rows padded to 132 floats).  Each column
// tile of the weight is read once per 128 molecules, so at B <= 128 the
// 134 MB weight streams once.  The epilogue applies the mask and writes
// two float4 per row, coalesced.  No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;   // molecules per block
constexpr int kBN = 128;   // columns per block
constexpr int kBK = 16;    // reduction chunk
constexpr int kThreads = 256;
constexpr int kAStride = kBM + 4;

__global__ void __launch_bounds__(kThreads)
cnn_dy3_kernel(const float* __restrict__ dy, const float* __restrict__ w,
               const float* __restrict__ y3, float* __restrict__ out,
               int batch, int h, int k) {
  __shared__ __align__(16) float a_s[kBK * kAStride];   // [kk][b]
  __shared__ __align__(16) float b_s[kBK * kBN];        // [kk][col]

  const int t = threadIdx.x;
  const int tb = t / 16;          // rows 8*tb .. 8*tb+7
  const int tc = t % 16;          // cols 4*tc .. +3 and 64+4*tc .. +3
  const int b0 = blockIdx.y * kBM;
  const size_t c0 = (size_t)blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int h0 = 0; h0 < h; h0 += kBK) {
    // dy chunk, transposed: a_s[kk][b] = dy[b0 + b, h0 + kk]
    for (int idx = t; idx < kBM * kBK; idx += kThreads) {
      const int b = idx / kBK;
      const int kk = idx % kBK;
      float val = 0.0f;
      if (b0 + b < batch && h0 + kk < h) val = dy[(size_t)(b0 + b) * h + h0 + kk];
      a_s[kk * kAStride + b] = val;
    }
    // weight chunk: b_s[kk][col] = w[h0 + kk, c0 + col], float4 loads
    for (int idx = t; idx < kBK * kBN / 4; idx += kThreads) {
      const int kk = idx / (kBN / 4);
      const int col = (idx % (kBN / 4)) * 4;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (h0 + kk < h && c0 + col < (size_t)k) {
        val = *reinterpret_cast<const float4*>(w + (size_t)(h0 + kk) * k + c0 + col);
      }
      *reinterpret_cast<float4*>(b_s + kk * kBN + col) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * kAStride + 8 * tb);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * kAStride + 8 * tb + 4);
      const float4 p0 = *reinterpret_cast<const float4*>(b_s + kk * kBN + 4 * tc);
      const float4 p1 = *reinterpret_cast<const float4*>(b_s + kk * kBN + 64 + 4 * tc);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int b = b0 + 8 * tb + r;
    if (b >= batch) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t col = c0 + 64 * half + 4 * tc;
      if (col >= (size_t)k) continue;
      const size_t o = (size_t)b * k + col;
      const float4 m = *reinterpret_cast<const float4*>(y3 + o);
      float4 res;
      res.x = m.x > 0.0f ? acc[r][4 * half + 0] : 0.0f;
      res.y = m.y > 0.0f ? acc[r][4 * half + 1] : 0.0f;
      res.z = m.z > 0.0f ? acc[r][4 * half + 2] : 0.0f;
      res.w = m.w > 0.0f ? acc[r][4 * half + 3] : 0.0f;
      *reinterpret_cast<float4*>(out + o) = res;
    }
  }
}

}  // namespace

// dy [B, H], fc1_w [H, K], y3 and out [B, K]; all f32, contiguous, on the
// current device, 16-byte aligned, K % 4 == 0 (checked by the caller).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cnn_dy3_launch(const void* dy, const void* fc1_w,
                              const void* y3, void* out, int batch, int h,
                              int k, void* stream) {
  if (batch == 0 || k == 0) return 0;
  const dim3 grid((k + kBN - 1) / kBN, (batch + kBM - 1) / kBM);
  cnn_dy3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(dy), static_cast<const float*>(fc1_w),
      static_cast<const float*>(y3), static_cast<float*>(out), batch, h, k);
  return (int)cudaGetLastError();
}
