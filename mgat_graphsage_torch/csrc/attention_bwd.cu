// Per-molecule fused masked attention (backward), for Hopper (sm_90a).
//
// Replaces: mgat_graphsage_tpu/ops/pallas_attention.py::_backward_call
// (_attention_bwd_kernel), the custom VJP of fused_masked_attention.
//
// Recomputes the forward's attention (same formula as csrc/attention.cu,
// expf and the 1e-16 clamp included, so attn is the forward's to the bit)
// and returns, for every molecule b (all f32, s = 1/sqrt(F)):
//     attn       = masked_softmax(s * k_new q^T)         (keys masked)
//     dv         = attn^T g  (+ g when residual)
//     dattn      = g v^T
//     dscores    = attn * (dattn - rowsum(dattn * attn))
//     dk_new     = s * dscores q
//     dq         = s * dscores^T k_new
// A fully-masked molecule has attn = 0, hence dscores = 0: dq = dk_new = 0
// and dv = g or 0.  Padded query rows are computed like real ones.
//
// Bound on the H100: operations.  Per molecule the work is 5 N x N x F
// products (2 to recompute scores and dattn, 3 for the gradients), 10 N^2 F
// flops, against 8 N F floats in and out; at N=80, F=35 that is 56 flops
// per byte, above the f32 ridge of 20.
//
// Design: dq and dv are column sums over query rows, so a row-tiled grid
// cannot form them without a cross-block reduction.  One block per
// molecule holds the whole molecule instead: q, k_new, v and g (odd row
// stride F|1, so 32 lanes reading 32 rows hit 32 banks) and the two N x N
// matrices attn and dscores live in shared memory.  Phase A gives each warp
// query rows: lane l handles keys j = l, l+32, ... (N <= 128), the row max,
// denominator and rowsum(dattn * attn) are warp shuffles, and the row of
// attn and of dscores goes to shared memory.  Phase B gives each thread
// output elements (j, c) of dv, dq and dk_new, each a sum over N in a fixed
// order: no atomics, so the result repeats bit for bit.  Shared memory is
// (4 N (F|1) + 2 N^2 + N) * 4 bytes: 96 KB at N=80, F=35; the wrapper gates
// on it (at most 227 KB: N <= 128 at F=35, N <= 84 at F=128).
// No tensor cores: F=35 fits no wgmma tile (later work).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKeysPerLane = 4;  // N <= 128
constexpr float kNegInf = -1e9f;

__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k_new,
                            const float* __restrict__ v,
                            const float* __restrict__ mask,
                            const float* __restrict__ g,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int n, int f,
                            float scale, int residual) {
  extern __shared__ float smem[];
  const int fs = f | 1;                        // odd row stride
  float* q_s = smem;                           // [n][fs]
  float* k_s = q_s + n * fs;                   // [n][fs]
  float* v_s = k_s + n * fs;                   // [n][fs]
  float* g_s = v_s + n * fs;                   // [n][fs]
  float* p_s = g_s + n * fs;                   // [n][n] attn
  float* d_s = p_s + n * n;                    // [n][n] dscores
  float* m_s = d_s + n * n;                    // [n]

  const size_t base = (size_t)blockIdx.x * n * f;
  for (int idx = threadIdx.x; idx < n * f; idx += blockDim.x) {
    const int j = idx / f;
    const int c = idx - j * f;
    const int s = j * fs + c;
    q_s[s] = q[base + idx];
    k_s[s] = k_new[base + idx];
    v_s[s] = v[base + idx];
    g_s[s] = g[base + idx];
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    m_s[j] = mask[(size_t)blockIdx.x * n + j];
  }
  __syncthreads();

  // ---- phase A: one warp per query row: attn and dscores rows ----------
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += kWarps) {
    const float* ki = k_s + i * fs;
    const float* gi = g_s + i * fs;
    float s[kMaxKeysPerLane];
    float row_max = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < n) {
        const float* qj = q_s + j * fs;
        float acc = 0.0f;
        for (int c = 0; c < f; ++c) acc = fmaf(ki[c], qj[c], acc);
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
    float da[kMaxKeysPerLane];
    float row = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      da[t] = 0.0f;
      if (j < n) {
        s[t] = s[t] / denom;                   // attn[i, j]
        const float* vj = v_s + j * fs;
        float acc = 0.0f;
        for (int c = 0; c < f; ++c) acc = fmaf(gi[c], vj[c], acc);
        da[t] = acc;                           // dattn[i, j]
        row = fmaf(acc, s[t], row);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      row += __shfl_xor_sync(0xffffffffu, row, off);
    }
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        p_s[i * n + j] = s[t];
        d_s[i * n + j] = s[t] * (da[t] - row);
      }
    }
  }
  __syncthreads();

  // ---- phase B: one thread per (row j, feature c) of each gradient -----
  for (int idx = threadIdx.x; idx < n * f; idx += blockDim.x) {
    const int j = idx / f;
    const int c = idx - j * f;
    float acc_v = 0.0f, acc_q = 0.0f, acc_k = 0.0f;
    for (int i = 0; i < n; ++i) {
      acc_v = fmaf(p_s[i * n + j], g_s[i * fs + c], acc_v);
      acc_q = fmaf(d_s[i * n + j], k_s[i * fs + c], acc_q);
      acc_k = fmaf(d_s[j * n + i], q_s[i * fs + c], acc_k);
    }
    if (residual) acc_v += g_s[j * fs + c];
    dv[base + idx] = acc_v;
    dq[base + idx] = acc_q * scale;
    dk[base + idx] = acc_k * scale;
  }
}

}  // namespace

// q, k_new, v, g, dq, dk, dv [B, N, F] f32; mask [B, N] f32; all contiguous
// on the current device; N <= 128, F <= 128 and the shared memory below
// within the 227 KB opt-in limit (checked by the caller).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int masked_attention_bwd_launch(const void* q, const void* k_new,
                                           const void* v, const void* mask,
                                           const void* g, void* dq, void* dk,
                                           void* dv, int batch, int n, int f,
                                           float scale, int residual,
                                           void* stream) {
  if (batch == 0 || n == 0) return 0;
  const size_t smem =
      (size_t)(4 * n * (f | 1) + 2 * n * n + n) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_attention_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  masked_attention_bwd_kernel<<<batch, kThreads, smem,
                                (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), n, f, scale,
      residual);
  return (int)cudaGetLastError();
}
