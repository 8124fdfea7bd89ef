// Per-molecule fused masked attention (backward), for Hopper (sm_90a).
//
// Replaces: mgat_graphsage_tpu/ops/pallas_attention.py::_backward_call
// (_attention_bwd_kernel), the custom VJP of fused_masked_attention.
//
// Recomputes the forward's attention with the forward's own code
// (attention_common.cuh: row_products and softmax_rows, so attn is the
// forward's to the bit) and returns, for every molecule b (all f32,
// s = 1/sqrt(F)):
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
// per byte, above the f32 ridge of 20.  At B=128 the bound is 4.3 us.
//
// What held the first design back (87 us at B=128, N=80, F=35): one
// 8-warp block per molecule (at B=128 one block per SM, an eighth of its
// warp slots), every score and dattn element a lone 35-long dot product
// with two shared loads per FMA (and idle lanes at N=80, where 32 lanes
// covered 128 key slots), and a phase B with six shared loads per three
// FMAs.  Shared memory, not the FMA pipe, sets the pace of this kernel: a
// 16-byte shared load costs four of the SM's shared-memory cycles
// whatever the lanes' addresses, so a product needs about four FMAs per
// float a lane loads to keep the FMA pipe ahead.
//
// Design: still one block per molecule, so the column sums of dq and dv
// stay in one block's shared memory with no cross-block reduction and no
// atomics; 10 warps, and register tiles with 16-byte shared loads in both
// phases.  The molecule arrives by 4-byte cp.async, all of it in flight at
// once.  q, k_new, v and g sit in shared memory with the row stride F
// rounded up to 4 (and to an odd number of float4 when that fits, 36 at
// F=35, so 8 lanes reading 8 rows hit 32 banks); the padding is never read
// into a real element's sum: every product runs float4 steps over the
// first F & ~3 features, then a scalar tail.
// Phase A: a half-warp owns 4 query rows and all keys, each lane a
// 4 x KPT tile (keys j = lane + 16 t, KPT = ceil(N/16): 5 at N=80, no idle
// slot; 2.2 FMAs per loaded float), so row max, denominator and
// rowsum(dattn * attn) are shuffles within 16 lanes, taken for the 4 rows
// together; each score is a sequential fmaf over c from 0, as in the
// forward, and the denominator is summed in the forward's tree.  attn and
// dscores rows go to shared memory ([N4][N8], N4 and N8 = N rounded up to
// 4 and 8).  Phase B: three products, each thread an 8 x 4 output tile of
// dv, dq or dk_new (2.7 FMAs per loaded float), 4-deep float4 steps over
// the reduction, sums in ascending order: the result repeats bit for bit.
// Shared memory is ((2 N + 2 N4) Fp + 2 N4 N8 + N) * 4 bytes, 200 KB at
// N=128, F=35 and 226 KB at N=84, F=128 (Fp = F rounded up to 4 there);
// the wrapper gates on it.  No tensor cores: the f32 preset keeps IEEE
// f32.

#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 10;
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemLimit = 232448;

// dscores of R rows from their attn (a) and dattn (da), in place in da
template <int R, int KPT>
__device__ __forceinline__ void dscores_rows(const float (&a)[R][KPT],
                                             float (&da)[R][KPT], int n,
                                             int kg) {
  float row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      if (kg + 16 * t < n) row[r] = fmaf(da[r][t], a[r][t], row[r]);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      row[r] += __shfl_xor_sync(0xffffffffu, row[r], off);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < KPT; ++t)
      da[r][t] = kg + 16 * t < n ? a[r][t] * (da[r][t] - row[r]) : 0.0f;
}

template <int KPT>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_bwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k_new,
                            const float* __restrict__ v,
                            const float* __restrict__ mask,
                            const float* __restrict__ g,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int n, int f, int fp,
                            float scale, int residual) {
  extern __shared__ __align__(16) float smem[];
  const int nr = (n + 3) & ~3;                 // rows of k, g, attn, dscores
  const int np = (n + 7) & ~7;                 // columns of attn, dscores
  float* k_s = smem;                           // [nr][fp]
  float* g_s = k_s + nr * fp;                  // [nr][fp]
  float* q_s = g_s + nr * fp;                  // [n][fp]
  float* v_s = q_s + n * fp;                   // [n][fp]
  float* p_s = v_s + n * fp;                   // [nr][np] attn
  float* d_s = p_s + nr * np;                  // [nr][np] dscores
  float* m_s = d_s + nr * np;                  // [n]

  // all of the molecule in flight at once: 4-byte cp.async, padding
  // zero-filled
  const size_t base = (size_t)blockIdx.x * n * f;
  for (int idx = threadIdx.x; idx < nr * fp; idx += kThreads) {
    const int j = idx / fp;
    const int c = idx - j * fp;
    const bool real = j < n && c < f;
    const size_t src = real ? base + (size_t)j * f + c : 0;
    cp_async4(k_s + idx, k_new + src, real);
    cp_async4(g_s + idx, g + src, real);
    if (j < n) {
      cp_async4(q_s + idx, q + src, real);
      cp_async4(v_s + idx, v + src, real);
    }
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    cp_async4(m_s + j, mask + (size_t)blockIdx.x * n + j, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // ---- phase A: a half-warp per 4 query rows, 4 x KPT per lane -------
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kg = lane & 15;
  for (int oct = warp; oct < (nr + 7) / 8; oct += kWarps) {
    // a half-warp past the last row recomputes the last 4 and stores
    // nothing: every lane takes part in the shuffles
    const int i0 = 8 * oct + 4 * (lane >> 4);
    const int ic = min(i0, nr - 4);
    float a[4][KPT], da[4][KPT];
    row_products<4, KPT>(k_s + ic * fp, q_s, fp, f, n, kg, a);
    softmax_rows<4, KPT>(a, m_s, n, kg, scale);
    row_products<4, KPT>(g_s + ic * fp, v_s, fp, f, n, kg, da);
    dscores_rows<4, KPT>(a, da, n, kg);
    if (i0 < nr) {
#pragma unroll
      for (int t = 0; t < KPT; ++t) {
        const int j = kg + 16 * t;
        if (j < np) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            p_s[(i0 + r) * np + j] = a[r][t];
            d_s[(i0 + r) * np + j] = da[r][t];
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- phase B: 8 x 4 output tiles of dv, dq (sums over query rows i)
  // and dk_new (sums over keys j) ------------------------------------------
  const int ct_n = fp / 4;
  const int tiles = (np / 8) * ct_n;
  for (int task = threadIdx.x; task < 3 * tiles; task += kThreads) {
    const int kind = task / tiles;             // 0 dv, 1 dq, 2 dk_new
    const int rem = task - kind * tiles;
    const int r0 = (rem / ct_n) * 8;
    const int c0 = (rem % ct_n) * 4;
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

    if (kind < 2) {
      // out[j, c] = sum_i A[i, j] * B[i, c], rows j = r0..r0+7
      const float* A = (kind == 0 ? p_s : d_s) + r0;
      const float* B = (kind == 0 ? g_s : k_s) + c0;
      int i = 0;
      for (; i + 4 <= n; i += 4) {
        float4 x[4][2], y[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u][0] = ld4(A + (i + u) * np);
          x[u][1] = ld4(A + (i + u) * np + 4);
          y[u] = ld4(B + (i + u) * fp);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(at(x[u][r / 4], r % 4), at(y[u], c), acc[r][c]);
      }
      for (; i < n; ++i) {
        const float4 x0 = ld4(A + i * np);
        const float4 x1 = ld4(A + i * np + 4);
        const float4 y = ld4(B + i * fp);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(at(r < 4 ? x0 : x1, r % 4), at(y, c), acc[r][c]);
      }
    } else {
      // out[i, c] = sum_j dscores[i, j] * q[j, c], rows i = r0..r0+7 (rows
      // past nr read row nr - 1; they are not stored)
      const float* A[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) A[r] = d_s + min(r0 + r, nr - 1) * np;
      const float* B = q_s + c0;
      int j = 0;
      for (; j + 4 <= n; j += 4) {
        float4 x[8], y[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) x[r] = ld4(A[r] + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = ld4(B + (j + u) * fp);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(at(x[r], u), at(y[u], c), acc[r][c]);
      }
      for (; j < n; ++j) {
        const float4 y = ld4(B + j * fp);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x = A[r][j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x, at(y, c), acc[r][c]);
        }
      }
    }

    float* out = kind == 0 ? dv : kind == 1 ? dq : dk;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = r0 + r;
      if (row >= n) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + c;
        if (col >= f) continue;
        float val = acc[r][c];
        if (kind == 0) {
          if (residual) val += g_s[row * fp + col];
        } else {
          val *= scale;
        }
        out[base + (size_t)row * f + col] = val;
      }
    }
  }
}

size_t smem_bytes(int n, int f, int fp) {
  const size_t nr = (size_t)((n + 3) & ~3);
  const size_t np = (size_t)((n + 7) & ~7);
  return ((2 * (size_t)n + 2 * nr) * fp + 2 * nr * np + n) * sizeof(float);
}

template <int KPT>
int launch(const void* q, const void* k_new, const void* v, const void* mask,
           const void* g, void* dq, void* dk, void* dv, int batch, int n,
           int f, int fp, float scale, int residual, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, f, fp);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_attention_bwd_kernel<KPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  masked_attention_bwd_kernel<KPT><<<batch, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(g), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), n, f, fp, scale,
      residual);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k_new, v, g, dq, dk, dv [B, N, F] f32; mask [B, N] f32; all contiguous
// on the current device; 1 <= N <= 128, F <= 128 and the shared memory at
// the row stride F rounded up to 4 within the 227 KB opt-in limit (checked
// by the caller: ops/attention.py::kernels_support).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int masked_attention_bwd_launch(const void* q, const void* k_new,
                                           const void* v, const void* mask,
                                           const void* g, void* dq, void* dk,
                                           void* dv, int batch, int n, int f,
                                           float scale, int residual,
                                           void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (n > 128) return (int)cudaErrorInvalidValue;
  int fp = (f + 3) & ~3;
  if ((fp / 4) % 2 == 0 && smem_bytes(n, f, fp + 4) <= kSmemLimit) fp += 4;
  if (smem_bytes(n, f, fp) > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((n + 15) / 16) {
    case 1: return launch<1>(q, k_new, v, mask, g, dq, dk, dv, batch, n, f, fp, scale, residual, s);
    case 2: return launch<2>(q, k_new, v, mask, g, dq, dk, dv, batch, n, f, fp, scale, residual, s);
    case 3: return launch<3>(q, k_new, v, mask, g, dq, dk, dv, batch, n, f, fp, scale, residual, s);
    case 4: return launch<4>(q, k_new, v, mask, g, dq, dk, dv, batch, n, f, fp, scale, residual, s);
    case 5: return launch<5>(q, k_new, v, mask, g, dq, dk, dv, batch, n, f, fp, scale, residual, s);
    case 6: return launch<6>(q, k_new, v, mask, g, dq, dk, dv, batch, n, f, fp, scale, residual, s);
    case 7: return launch<7>(q, k_new, v, mask, g, dq, dk, dv, batch, n, f, fp, scale, residual, s);
    default: return launch<8>(q, k_new, v, mask, g, dq, dk, dv, batch, n, f, fp, scale, residual, s);
  }
}
