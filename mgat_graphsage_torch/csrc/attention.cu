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
// under 1 us for the serving batch (B=64: 2.2 MB in, 0.7 MB out) and about
// 1.8 us for the training batch (B=128), so the kernel lives near the
// launch floor: what matters is the latency of one molecule's load and
// arithmetic, that scores and attn ([B, N, N]) never go to device memory,
// and that the grid spreads over the 132 SMs.
//
// What held the first design back (a warp per query row, grid (B, N/16)):
// each of a molecule's blocks staged all of q and v for 16 rows, with
// scalar loads and a division per element; each score was a lone 35-long
// fmaf chain with two shared loads per FMA, and 48 of the 128 key slots of
// a row were idle at N=80; a warp took its rows one at a time, each behind
// a global load of its k_new row; attn . v gave a lane one feature, an
// 80-long chain with two shared loads per FMA, 3 of 32 lanes busy in the
// second pass at F=35.
//
// Design: grid (B, G), G row groups per molecule (row_groups below).  The
// block takes its molecule by 4-byte cp.async, all of it in flight at
// once, consecutive lanes on consecutive addresses: q, v and the mask
// whole, and only its own rows of k_new.  Rows sit in shared memory with
// the stride fp = F rounded up to an odd number of float4 (36 at F=35), so
// 8 lanes reading 8 rows hit 32 banks.  Phase A is the backward's
// (attention_common.cuh): a half-warp owns kRows = 4 query rows and all
// keys, each lane a 4 x KPT tile of scores (KPT = ceil(N/16): 5 at N=80,
// no idle slot), row max and denominator by shuffles within the 16 lanes
// for the 4 rows together.  So this kernel's attn is the one the backward
// recomputes, bit for bit, and the first design's (same summation orders).
// One change: a row is normalised by one division and a correctly rounded
// quotient per key (div_rn), the same bits as a division per key; the
// compiler's division carries a range check and a branch that serialised
// the 20 divisions of a lane.  Then the half-warp writes its 4 attn rows to
// a scratch of its own in shared memory and, after __syncwarp, computes
// those 4 rows of out: lane kg sums features kg, kg + 16 and kg + 32 (48
// per pass) over the keys in ascending order, with 16-byte loads of attn
// along the keys.  No block barrier follows the load: the warps run on
// independently.  Each block is a few warps, one pass each, so the kernel
// is a chain of latencies (launch, load, scores, softmax, product) more
// than a rate; shared-memory loads set the pace where many warps share an
// SM.  expf, not __expf, keeps the result within f32 rounding of the plain
// version.  No tensor cores: the f32 preset keeps IEEE f32.

#include <cuda_runtime.h>

#include <algorithm>

#include "attention_common.cuh"

namespace {

constexpr int kRows = 4;               // query rows of a half-warp
constexpr int kMaxWarps = 16;          // warps of a block at most
constexpr int kCols = 3;               // attn . v: features per lane per pass
constexpr int kMaxGroups = 3;          // row groups per molecule, by choice
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may use

template <int KPT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
masked_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_new,
                        const float* __restrict__ v,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int n, int f, int fp,
                        unsigned long long magic, int tiles, float scale,
                        int residual) {
  extern __shared__ __align__(16) float smem[];
  const int nr = (n + 3) & ~3;                 // rows rounded up to 4
  const int t0 = blockIdx.y * tiles;           // the block's row tiles
  const int t1 = min(t0 + tiles, (n + kRows - 1) / kRows);
  const int rows = kRows * (t1 - t0);
  float* q_s = smem;                           // [n][fp]
  float* v_s = q_s + n * fp;                   // [nr][fp], rows past n zero
  float* m_s = v_s + nr * fp;                  // [nr]
  float* k_s = m_s + nr;                       // [kRows tiles][fp] own rows
  float* a_s = k_s + kRows * tiles * fp;       // [2 warps][kRows][nr] attn

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t base = (size_t)blockIdx.x * n * f;

  // ---- load: 4-byte cp.async over the molecule's contiguous q, v and
  // own k_new rows, consecutive lanes on consecutive addresses; element
  // idx is row idx / f, found as (idx * magic) >> 32 (exact here)
  const int nf = n * f;
  for (int idx = tid; idx < nf; idx += nthreads) {
    const int j = (int)((idx * magic) >> 32);
    const int dst = idx + j * (fp - f);        // j * fp + (idx - j * f)
    cp_async4(q_s + dst, q + base + idx, true);
    cp_async4(v_s + dst, v + base + idx, true);
  }
  const int k0 = kRows * t0 * f;
  const int k1 = min(kRows * t1, n) * f;
  for (int idx = k0 + tid; idx < k1; idx += nthreads) {
    const int j = (int)((idx * magic) >> 32);
    cp_async4(k_s + idx - k0 + (j - kRows * t0) * (fp - f), k_new + base + idx,
              true);
  }
  for (int j = tid; j < n; j += nthreads) {
    cp_async4(m_s + j, mask + (size_t)blockIdx.x * n + j, true);
  }
  // the rows past n that are read (v's up to nr, k_new's up to the last
  // tile), zero
  for (int idx = n * fp + tid; idx < nr * fp; idx += nthreads) v_s[idx] = 0.0f;
  for (int idx = (min(kRows * t1, n) - kRows * t0) * fp + tid; idx < rows * fp;
       idx += nthreads)
    k_s[idx] = 0.0f;
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // ---- phase A: a half-warp per row tile, kRows x KPT scores per lane
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kg = lane & 15;
  float* a_h = a_s + (2 * warp + (lane >> 4)) * kRows * nr;
  for (int pair = warp; 2 * pair < t1 - t0; pair += nthreads >> 5) {
    // a half-warp past the block's last tile recomputes that tile and
    // stores nothing: every lane takes part in the shuffles
    const int tl = t0 + 2 * pair + (lane >> 4);
    const int il = kRows * (min(tl, t1 - 1) - t0);
    float a[kRows][KPT];
    row_products<kRows, KPT>(k_s + il * fp, q_s, fp, f, n, kg, a);
    softmax_rows<kRows, KPT, true>(a, m_s, n, kg, scale);
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int j = kg + 16 * t;
      if (j < nr) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) a_h[r * nr + j] = a[r][t];
      }
    }
    __syncwarp();

    // ---- attn . v: lane kg sums features c0 + kg + 16 u of its rows
    // over the keys in ascending order (attn is 0 and v zero past n)
    for (int c0 = 0; c0 < f; c0 += 16 * kCols) {
      int col[kCols];
      float acc[kRows][kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        col[u] = min(c0 + kg + 16 * u, f - 1);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][u] = 0.0f;
      }
      for (int j = 0; j < nr; j += 4) {
        float4 x[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) x[r] = ld4(a_h + r * nr + j);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float* vr = v_s + (j + s) * fp;
          float y[kCols];
#pragma unroll
          for (int u = 0; u < kCols; ++u) y[u] = vr[col[u]];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int u = 0; u < kCols; ++u)
              acc[r][u] = fmaf(at(x[r], s), y[u], acc[r][u]);
        }
      }
      if (tl < t1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = kRows * tl + r;
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            const int c = c0 + kg + 16 * u;
            if (i < n && c < f) {
              float val = acc[r][u];
              if (residual) val += v_s[i * fp + c];
              out[base + (size_t)i * f + c] = val;
            }
          }
        }
      }
    }
    __syncwarp();
  }
}

// shared-memory floats of a block holding `tiles` row tiles with `warps`
// warps; ops/attention.py::forward_smem_bytes evaluates this same return
// expression, so keep it on one line in integer arithmetic
int smem_floats(int n, int fp, int tiles, int warps) {
  return (n + ((n + 3) & ~3)) * fp + ((n + 3) & ~3) + kRows * tiles * fp + 2 * kRows * warps * ((n + 3) & ~3);
}

int tiles_per_group(int n, int groups) {
  const int nt = (n + kRows - 1) / kRows;
  return (nt + groups - 1) / groups;
}

int warps_for(int tiles) { return std::min((tiles + 1) / 2, kMaxWarps); }

size_t block_smem(int n, int fp, int groups) {
  const int tiles = tiles_per_group(n, groups);
  return (size_t)smem_floats(n, fp, tiles, warps_for(tiles)) * sizeof(float);
}

// Row groups per molecule: the SM count over the batch, rounded, within
// 1..kMaxGroups (each block reloads q and v, from L2).  From the times of
// kernel_phases.py's "k2 G=1/2/3" copies at N=80, F=35 on an H100 (132
// SMs, PERF.md): at B=64 G=2 and G=3 beat G=1; at B=128 G=1 beats both.
int row_groups(int batch, int n, int sms) {
  const int g = (sms + batch / 2) / batch;
  return std::max(1, std::min(std::min(g, kMaxGroups),
                              (n + kRows - 1) / kRows));
}

template <int KPT>
int launch(const void* q, const void* k_new, const void* v, const void* mask,
           void* out, int batch, int n, int f, int fp, int groups,
           float scale, int residual, cudaStream_t stream) {
  const int tiles = tiles_per_group(n, groups);
  const size_t smem = block_smem(n, fp, groups);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_attention_kernel<KPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nt = (n + kRows - 1) / kRows;
  const dim3 grid(batch, (nt + tiles - 1) / tiles);
  masked_attention_kernel<KPT><<<grid, warps_for(tiles) * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<float*>(out), n, f, fp, ((1ull << 32) + f - 1) / f, tiles,
      scale, residual);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k_new, v, out [B, N, F] f32; mask [B, N] f32; all contiguous on the
// current device; 1 <= N <= 128, 1 <= F <= 128 (checked by the caller:
// ops/attention.py::_forward_fits).  Every such shape fits: the row groups
// grow until the block's shared memory does.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int masked_attention_launch(const void* q, const void* k_new,
                                       const void* v, const void* mask,
                                       void* out, int batch, int n, int f,
                                       float scale, int residual,
                                       void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (n > 128 || f < 1 || f > 128) return (int)cudaErrorInvalidValue;
  const int fp = ((f + 3) & ~3) | 4;           // an odd number of float4
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int groups = row_groups(batch, n, sms);
  while (block_smem(n, fp, groups) > kSmemLimit) ++groups;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((n + 15) / 16) {
    case 1: return launch<1>(q, k_new, v, mask, out, batch, n, f, fp, groups, scale, residual, s);
    case 2: return launch<2>(q, k_new, v, mask, out, batch, n, f, fp, groups, scale, residual, s);
    case 3: return launch<3>(q, k_new, v, mask, out, batch, n, f, fp, groups, scale, residual, s);
    case 4: return launch<4>(q, k_new, v, mask, out, batch, n, f, fp, groups, scale, residual, s);
    case 5: return launch<5>(q, k_new, v, mask, out, batch, n, f, fp, groups, scale, residual, s);
    case 6: return launch<6>(q, k_new, v, mask, out, batch, n, f, fp, groups, scale, residual, s);
    case 7: return launch<7>(q, k_new, v, mask, out, batch, n, f, fp, groups, scale, residual, s);
    default: return launch<8>(q, k_new, v, mask, out, batch, n, f, fp, groups, scale, residual, s);
  }
}
