// Per-molecule fused masked attention (forward), for Hopper (sm_90a).
//
// Replaces: mgat_graphsage_tpu/ops/pallas_attention.py::fused_masked_attention
// forward (_forward_call -> _attention_kernel), the core of ModifiedGATLayer.
//
// Computes, for every molecule b, query row i and feature f (all f32):
//     s[i, j]   = (k_new[i] . q[j]) * (1/sqrt(F)) + (mask[j] > 0 ? 0 : -1e9)
//     e[i, j]   = exp(s[i, j] - max_j s[i, j]) * (mask[j] > 0)
//     attn[i,j] = e[i, j] / max(sum_j e[i, j], 1e-16)
//     out[i, f] = sum_j attn[i, j] * v[j, f]  (+ v[i, f] when residual)
// Note the transposed roles (rows from k_new, columns from q), as in the
// reference layer.  A fully-masked molecule gives attn = 0, not NaN.  Padded
// query rows are computed like real ones, as the plain version computes them.
//
// Bound on the H100: bytes and f32 operations about equally.  Per molecule
// the work is 4*N*N*F flops (two N x N x F products) against 4*N*F*4 bytes
// of q, k_new, v and out; at N=80, F=35 that is 20 flops per byte, the
// ridge of the f32 CUDA cores (67 TFLOP/s over 3.35 TB/s).  Either bound is
// under 1 us for the serving batch (B=64: 2.2 MB in, 0.7 MB out), so the
// kernel lives near the launch floor; what matters is that scores and attn
// ([B, N, N], 1.6 MB each) never go to device memory, and that the grid
// spreads over the 132 SMs.
//
// Design: grid (B, ceil(N / kRowsPerBlock)); each block stages its
// molecule's q (with an odd row stride, F | 1, so that 32 lanes reading 32
// different keys hit 32 banks) and v in shared memory, plus the key mask.  Each warp owns
// query rows: lane l scores keys j = l, l+32, l+64, l+96 (N <= 128) from
// k_new[i] held in shared memory, the row max and the denominator are warp
// shuffles, the normalised row goes to a per-warp shared buffer, and each
// lane then sums attn[i, :] . v[:, f] for its features f = l, l+32, ...
// Shared memory is (N*(F|1) + N*F + N + warps*(F+N)) * 4 bytes: 24.6 KB at
// N=80, F=35, and 136 KB at N=F=128 (dynamic shared memory opt-in).
// expf, not __expf, keeps the result within f32 rounding of the plain
// version.  No tensor cores: at F=35 the products are too small to pay for
// a wgmma tile, which is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 16;
constexpr int kMaxKeysPerLane = 4;  // N <= 128
constexpr float kNegInf = -1e9f;

__global__ void masked_attention_kernel(const float* __restrict__ q,
                                        const float* __restrict__ k_new,
                                        const float* __restrict__ v,
                                        const float* __restrict__ mask,
                                        float* __restrict__ out,
                                        int n, int f, float scale,
                                        int residual) {
  extern __shared__ float smem[];
  const int fq = f | 1;                       // odd q row stride
  float* q_s = smem;                          // [n][fq]
  float* v_s = q_s + n * fq;                  // [n][f]
  float* m_s = v_s + n * f;                   // [n]
  float* k_s = m_s + n;                       // [kWarps][f]
  float* a_s = k_s + kWarps * f;              // [kWarps][n]

  const int b = blockIdx.x;
  const size_t base = (size_t)b * n * f;
  const float* qb = q + base;
  const float* kb = k_new + base;
  const float* vb = v + base;

  for (int idx = threadIdx.x; idx < n * f; idx += blockDim.x) {
    const int j = idx / f;
    const int c = idx - j * f;
    q_s[j * fq + c] = qb[idx];
    v_s[idx] = vb[idx];
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    m_s[j] = mask[(size_t)b * n + j];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* k_row = k_s + warp * f;
  float* a_row = a_s + warp * n;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, n);

  for (int i = row0 + warp; i < row_end; i += kWarps) {
    for (int c = lane; c < f; c += 32) k_row[c] = kb[(size_t)i * f + c];
    __syncwarp();

    float s[kMaxKeysPerLane];
    float row_max = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < n) {
        const float* qj = q_s + j * fq;
        float acc = 0.0f;
        for (int c = 0; c < f; ++c) acc = fmaf(k_row[c], qj[c], acc);
        s[t] = acc * scale + (m_s[j] > 0.0f ? 0.0f : kNegInf);
        row_max = fmaxf(row_max, s[t]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
    }
    float denom = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        s[t] = m_s[j] > 0.0f ? expf(s[t] - row_max) : 0.0f;
        denom += s[t];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      denom += __shfl_xor_sync(0xffffffffu, denom, off);
    }
    denom = fmaxf(denom, 1e-16f);
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) a_row[j] = s[t] / denom;
    }
    __syncwarp();

    for (int c = lane; c < f; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) acc = fmaf(a_row[j], v_s[j * f + c], acc);
      if (residual) acc += v_s[i * f + c];
      out[base + (size_t)i * f + c] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

// q, k_new, v, out [B, N, F] f32; mask [B, N] f32; all contiguous on the
// current device; N <= 128, F <= 128 (checked by the caller).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int masked_attention_launch(const void* q, const void* k_new,
                                       const void* v, const void* mask,
                                       void* out, int batch, int n, int f,
                                       float scale, int residual,
                                       void* stream) {
  if (batch == 0 || n == 0) return 0;
  const size_t smem =
      (size_t)(n * (f | 1) + n * f + n + kWarps * (f + n)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(batch, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  masked_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<float*>(out), n, f, scale, residual);
  return (int)cudaGetLastError();
}
