// Graphormer's biased multi-head attention, forward and backward, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no graph transformer.  It
// takes the place of the chain of PyTorch ops of ops/biased_attention.py::
// BiasedAttention (kept for the CPU) on CUDA tensors, in every layer of
// models/layers.py::GraphormerLayer.
//
// For q, k, v [B, H, N, d] bf16 (read through their strides: the layer's
// are views of the projections' [B, N, H, d]), an optional bias [B, H, N,
// N] f32, key_mask [B, N] bool and an optional keep-mask [B, H, N, N] bool
// of drop rate p (r = 1 / (1 - p)):
//     s   = scale * q k^T + bias, keys outside key_mask at -inf     (f32)
//     P   = softmax(s) over the keys                                (f32)
//     out = bf16(P * keep * r) v          (bf16 operands, f32 sums)
//     lse = rowmax(s) + log(rowsum(exp(s - rowmax)))     [B, H, N] f32
// and the backward, from the same inputs, out, its gradient dO and lse:
//     P   = exp(s - lse), recomputed;  D = rowsum(dO * out)
//     dS  = P * ((dO v^T) * keep * r - D)        -> the bias gradient, f32
//     dq  = scale * bf16(dS) k,  dk = scale * bf16(dS)^T q,
//     dv  = bf16(P * keep * r)^T dO
// out, dq, dk and dv are written [B, N, H, d] (the caller sees their
// [B, H, N, d] transposes).  A row with no valid key gives out = 0, lse =
// +inf and zero gradients.
//
// Without a bias (NULL: GraphGPS's attention, models/layers.py::GPSLayer)
// nothing [B, H, N, N] is read but the keep-mask, and the bias gradient is
// neither formed for output nor written: each block stages a row of KP
// zeros in the bias's place and reads every row's bias from it (a bias row
// stride of 0), so the arithmetic is the biased one's with a bias of 0.
// With a bias given, the staging, the layout and the arithmetic are as they
// were, to the bit.
//
// Bound on the H100: bytes.  At N = 81, H = 32, d = 24 a molecule's layer
// moves ~1.56 MB forward (the f32 bias 0.84, the keep-mask 0.21, q, k, v,
// out 0.5) and ~2.9 MB backward (the bias read and its gradient written in
// f32), some 20 operations a byte against the card's ridge of ~295 bf16
// operations a byte.  So every [N, N] intermediate stays on chip and each
// input is read once; the arithmetic has to hide behind the loads.
//
// Design.  A block per (molecule, head), KT = 2 * ceil(N / 32) tiles of 16
// rows (and keys), a warp per tile; the whole key range sits in the block,
// so no block needs another's row statistics and nothing is summed across
// blocks.  The block stages with 16-byte cp.async into shared memory the
// rows of q, k, v (and dO, out), zero-padded to 16 KT rows and d to a
// multiple of 16, and its contiguous [N, N] slices of the bias and the
// keep-mask, whose staged copy keeps the source's offset within 16 bytes,
// so each whole 16-byte piece is one cp.async and only the ragged ends go
// by 4-byte (bias) or 1-byte (mask) copies.  Products are mma.sync m16n8k16
// on ldmatrix fragments (mma_bf16.cuh) with f32 sums; a product's f32
// result feeds the next one as bf16 from registers (the accumulator
// fragment of two n8 tiles is the A fragment of a k16 step), so the
// logits, P and dS never leave the SM except as the bias gradient.
// Forward: warp w owns rows 16w..16w+15 and all keys: S = q k^T, the row
// max and sum within a thread and over the 4 lanes of a quad, P, dropout,
// out = Pd v.  Backward: warp w owns keys 16w..16w+15 and all rows: S^T =
// k q^T and dP^T = v dO^T, dS^T (stored from registers as the bias
// gradient), then dk = dS^T q and dv = Pd^T dO from registers; after a
// barrier bf16 dS^T goes over the dead q, v, dO and keep-mask, from which
// each warp forms dq for its 16 rows.  Rows sit in shared memory with a
// stride of d + 8 padded (80 bytes at d = 24), so ldmatrix's 8 row
// addresses fall in distinct banks.
//
// What the measurements taught (H100, B = 1024, N = 81, PERF.md).  The
// staging alone runs near the HBM's rate, and the arithmetic alone takes
// about as long; the resident blocks start, load and compute together, so
// the two add up, and what overlaps them is more resident blocks.  So:
// the staged bias carries a zeroed tail (the keep-mask room for one), the
// forward clamps its rows to N - 1 and the backward its keys, so no
// element tests its row and key against N (72 registers, four forward
// blocks an SM); keys from
// the molecule's last valid one on have p = 0 exactly, so their tiles (a
// backward warp's whole work) are skipped, the results the same to the
// bit, and a molecule of 29 atoms uses 2 of the 6 key tiles; a persistent
// block of two parts, the second a load behind the first, overlapped no
// better than that and was dropped.  expf and logf, not the fast
// intrinsics, keep P within f32 rounding of the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int r16(int x) { return (x + 15) & ~15; }

template <int KT, int D8>
struct Tile {
  static constexpr int KP = 16 * KT;        // rows and keys, padded
  static constexpr int DK = (D8 + 1) / 2;   // k16 steps over d
  static constexpr int DP = 16 * DK;        // d, padded
  static constexpr int LD = DP + 8;         // staged row stride (bf16)
  static constexpr int LDS = KP + 8;        // dS^T row stride (bf16)
  static constexpr int ROWS = KP * LD * 2;  // bytes of one staged [KP, d]
  static constexpr int NT = 2 * KT;         // n8 tiles over the keys (rows)
  static constexpr int THREADS = 32 * KT;

  // bn is the bias's row stride: n, or 0 without a bias (its tail of KP
  // zeros is then every row)
  // forward: q, k, v; the bias (offset, N^2, a tail of KP); the keep-mask
  // (offset, N^2, KP); the key mask as 0 / -inf
  static __host__ __device__ int fbias_bytes(int bn) {
    return r16((bn * bn + KP + 4) * 4);
  }
  static __host__ __device__ int fkeep_bytes(int n) {
    return r16(n * n + KP + 16);
  }
  static __host__ __device__ int fwd_smem(int n, int bn) {
    return 3 * ROWS + fbias_bytes(bn) + fkeep_bytes(n) + KP * 4;
  }
  // backward: q, v, dO and the keep-mask (KP rows of N), which bf16 dS^T
  // overwrites in the end; k; out; the bias (KP rows of N); lse and D per
  // row
  static __host__ __device__ int bkeep_bytes(int n) {
    return r16(KP * n + 16);
  }
  static __host__ __device__ int union_bytes(int n) {
    const int a = 3 * ROWS + bkeep_bytes(n), b = r16(KP * LDS * 2);
    return a > b ? a : b;
  }
  static __host__ __device__ int bbias_bytes(int bn) {
    return r16((KP * (bn > 0 ? bn : 1) + 4) * 4);
  }
  static __host__ __device__ int bwd_smem(int n, int bn) {
    return union_bytes(n) + 2 * ROWS + bbias_bytes(bn) + 2 * KP * 4;
  }
};

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* bias;
  const uint8_t *key_mask, *keep;
  const float* lse_in;
  float* lse;
  bf16 *out, *dq, *dk, *dv;
  float* dbias;
  int heads, n;
  long long sb, sh, sn;  // q, k, v strides (elements)
  long long ob, oh, on;  // out's, in the backward
  long long gb, gh, gn;  // dO's
  float scale, rscale;
};

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// rows [0, n) of a (molecule, head)'s [N, d] slice (row stride sn, d contiguous) into
// dst [KP][LD]; zeros past d (to DP) and past n (to KP)
template <int KT, int D8>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int n,
                                           long long sn, int tid) {
  using T = Tile<KT, D8>;
  constexpr int C = T::DP / 8;  // 16-byte pieces of a staged row
  for (int i = tid; i < T::KP * C; i += T::THREADS) {
    const int r = i / C, c = i - r * C;
    bf16* d = dst + r * T::LD + 8 * c;
    if (r < n && c < D8) cp16(d, src + r * sn + 8 * c);
    else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// count floats from src to dst + off, where off (returned) is src's offset
// in floats within 16 bytes; then zeros from dst + off + count to dst +
// off + count + tail; dst 16-byte aligned
template <int THREADS>
__device__ __forceinline__ int stage_f32(float* dst, const float* src,
                                         int count, int tail, int tid) {
  const int off =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const float* base = src - off;
  const int pieces = (off + count + 3) >> 2;
  for (int j = tid; j < pieces; j += THREADS) {
    const int e = 4 * j - off;
    if (e >= 0 && e + 4 <= count) {
      cp16(dst + 4 * j, base + 4 * j);
    } else {
      for (int u = 0; u < 4; ++u)
        if (e + u >= 0 && e + u < count) cp4(dst + 4 * j + u, base + 4 * j + u);
    }
  }
  for (int j = tid; j < tail; j += THREADS) dst[off + count + j] = 0.0f;
  return off;
}

// count bytes from src to dst + off (off in bytes), dst 16-byte aligned
template <int THREADS>
__device__ __forceinline__ int stage_u8(uint8_t* dst, const uint8_t* src,
                                        int count, int tid) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const uint8_t* base = src - off;
  const int pieces = (off + count + 15) >> 4;
  for (int j = tid; j < pieces; j += THREADS) {
    const int e = 16 * j - off;
    if (e >= 0 && e + 16 <= count) {
      cp16(dst + 16 * j, base + 16 * j);
    } else {
      for (int u = 0; u < 16; ++u)
        if (e + u >= 0 && e + u < count) dst[16 * j + u] = base[16 * j + u];
    }
  }
  return off;
}

// d[t] += A (16 x 16, registers) * rows [16 kc, 16 kc + 16) of a staged
// [KP, d] matrix (as B, k = its rows, n = its columns: ldmatrix.trans)
template <int KT, int D8>
__device__ __forceinline__ void mma_rows_t(float (&d)[D8][4],
                                           const unsigned (&a)[4],
                                           const bf16* rows, int lane) {
  using T = Tile<KT, D8>;
  const bf16* row = rows + (lane & 15) * T::LD;
#pragma unroll
  for (int t = 0; t + 1 < D8; t += 2) {
    unsigned b[4];
    ldsm_x4_t(b, row + 8 * (t + (lane >> 4)));
    mma_bf16(d[t], a, b[0], b[1]);
    mma_bf16(d[t + 1], a, b[2], b[3]);
  }
  if constexpr (D8 & 1) {
    unsigned b[2];
    ldsm_x2_t(b, row + 8 * (D8 - 1));
    mma_bf16(d[D8 - 1], a, b[0], b[1]);
  }
}

// d += A (16 x DP, fragments a[DK]) * rows [8 j, 8 j + 8) of a staged [KP,
// d] matrix (as B, k = its columns, n = its rows: ldmatrix)
template <int KT, int D8>
__device__ __forceinline__ void mma_cols(float (&d)[4],
                                         const unsigned (&a)[Tile<KT, D8>::DK][4],
                                         const bf16* rows, int lane) {
  using T = Tile<KT, D8>;
  const bf16* row = rows + (lane & 7) * T::LD;
  if constexpr (T::DK == 2) {
    unsigned b[4];
    ldsm_x4(b, row + 8 * (lane >> 3));
    mma_bf16(d, a[0], b[0], b[1]);
    mma_bf16(d, a[1], b[2], b[3]);
  } else {
    unsigned b[2];
    ldsm_x2(b, row + 8 * ((lane >> 3) & 1));
    mma_bf16(d, a[0], b[0], b[1]);
  }
}

// the A fragments (16 rows x DP) of rows [r0, r0 + 16) of a staged matrix
template <int KT, int D8>
__device__ __forceinline__ void load_a(unsigned (&a)[Tile<KT, D8>::DK][4],
                                       const bf16* rows, int lane) {
  using T = Tile<KT, D8>;
#pragma unroll
  for (int ks = 0; ks < T::DK; ++ks)
    ldsm_x4(a[ks], rows + (lane & 15) * T::LD + 16 * ks + 8 * (lane >> 4));
}

// the bf16 A fragment of k16 step kc from f32 accumulators of n8 tiles
// 2 kc and 2 kc + 1
__device__ __forceinline__ void to_a(unsigned (&a)[4], const float (&lo)[4],
                                     const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// rows r0 + g and r0 + g + 8 (those < n) of an accumulator [16, d] times
// mul, to dst [B, N, H, d] (row stride heads * d)
template <int D8>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D8][4],
                                           int r0, int n, int heads, int lane,
                                           float mul) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= n) continue;
    bf16* p = dst + static_cast<long long>(row) * heads * (8 * D8) + 2 * c;
#pragma unroll
    for (int t = 0; t < D8; ++t)
      *reinterpret_cast<unsigned*>(p + 8 * t) =
          pack_bf16(acc[t][2 * i] * mul, acc[t][2 * i + 1] * mul);
  }
}

// four blocks an SM up to N = 96 (at most 85 registers a thread)
template <int KT, int D8>
__global__ void __launch_bounds__(32 * KT, KT <= 6 ? 4 : 1)
biased_attention_fwd_kernel(const Args a) {
  using T = Tile<KT, D8>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, tid = threadIdx.x, bn = a.bias ? n : 0;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = reinterpret_cast<bf16*>(smem + T::ROWS);
  bf16* sv = reinterpret_cast<bf16*>(smem + 2 * T::ROWS);
  float* sbias = reinterpret_cast<float*>(smem + 3 * T::ROWS);
  uint8_t* skeep = smem + 3 * T::ROWS + T::fbias_bytes(bn);
  float* smask = reinterpret_cast<float*>(skeep + T::fkeep_bytes(n));
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, r0 = 16 * warp;
  const long long nn = static_cast<long long>(n) * n;
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const long long in = b * a.sb + h * a.sh;
  stage_rows<KT, D8>(sq, a.q + in, n, a.sn, tid);
  stage_rows<KT, D8>(sk, a.k + in, n, a.sn, tid);
  stage_rows<KT, D8>(sv, a.v + in, n, a.sn, tid);
  const int ob = stage_f32<T::THREADS>(sbias, a.bias ? a.bias + bh * nn : a.bias,
                                       bn * bn, T::KP, tid);
  const int ok =
      a.keep ? stage_u8<T::THREADS>(skeep, a.keep + bh * nn, n * n, tid) : 0;
  if (tid < T::KP)
    smask[tid] = (tid < n && a.key_mask[static_cast<long long>(b) * n + tid])
                     ? 0.0f : -INFINITY;
  cp_wait_all();
  __syncthreads();

  // keys from kmax on are masked: their p is 0, so their tiles are
  // skipped (the result is the same to the bit)
  int kv = 0;
  for (int t = lane; t < T::KP; t += 32)
    if (smask[t] == 0.0f) kv = t + 1;
  const int kmax = __reduce_max_sync(0xffffffffu, kv);
  if (r0 >= n) return;  // no barrier follows
  unsigned qa[T::DK][4];
  load_a<KT, D8>(qa, sq + r0 * T::LD, lane);
  float s[T::NT][4];
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    if (8 * j < kmax) mma_cols<KT, D8>(s[j], qa, sk + 8 * j * T::LD, lane);
  }

  // element (j, e): row r0 + g + 8 (e >> 1), key 8 j + 2 c + (e & 1);
  // rows past n read row n - 1 (their results are dropped)
  const float* brow[2];
  const uint8_t* krow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min(r0 + g + 8 * i, n - 1);
    brow[i] = sbias + ob + row * bn + 2 * c;
    krow[i] = skeep + ok + row * n + 2 * c;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    if (8 * j >= kmax) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e] * a.scale + smask[8 * j + 2 * c + (e & 1)]
                      + brow[e >> 1][8 * j + (e & 1)];
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if (mx[i] == -INFINITY) mx[i] = 0.0f;  // no valid key: every p is 0
  }
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    if (8 * j >= kmax) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    inv[i] = sum[i] > 0.0f ? 1.0f / sum[i] : 0.0f;
  }

  // P, dropped and scaled, as the bf16 A fragments of out = Pd v; a key
  // past n has p = 0, whatever its keep byte
  unsigned pa[KT][4];
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    if (8 * j >= kmax) continue;  // s is 0 there
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = s[j][e] * inv[e >> 1];
      if (a.keep) p = krow[e >> 1][8 * j + (e & 1)] ? p * a.rscale : 0.0f;
      s[j][e] = p;
    }
  }
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) to_a(pa[kc], s[2 * kc], s[2 * kc + 1]);

  float o[D8][4];
#pragma unroll
  for (int t = 0; t < D8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc)
    if (16 * kc < kmax)
      mma_rows_t<KT, D8>(o, pa[kc], sv + 16 * kc * T::LD, lane);

  const long long row0 = static_cast<long long>(b) * n * a.heads;
  store_rows<D8>(a.out + (row0 + h) * (8 * D8), o, r0, n, a.heads, lane,
                 1.0f);
  if (a.lse && c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < n)
        a.lse[bh * static_cast<long long>(n) + row] =
            sum[i] > 0.0f ? mx[i] + logf(sum[i]) : INFINITY;
    }
  }
}

template <int KT, int D8>
__global__ void __launch_bounds__(32 * KT)
biased_attention_bwd_kernel(const Args a) {
  using T = Tile<KT, D8>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, tid = threadIdx.x, bn = a.bias ? n : 0;
  const int ub = T::union_bytes(n);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sv = reinterpret_cast<bf16*>(smem + T::ROWS);
  bf16* sdo = reinterpret_cast<bf16*>(smem + 2 * T::ROWS);
  uint8_t* skeep = smem + 3 * T::ROWS;
  bf16* sds = reinterpret_cast<bf16*>(smem);  // after the q, v, dO phase
  bf16* sk = reinterpret_cast<bf16*>(smem + ub);
  bf16* so = reinterpret_cast<bf16*>(smem + ub + T::ROWS);
  float* sbias = reinterpret_cast<float*>(smem + ub + 2 * T::ROWS);
  float* slse = reinterpret_cast<float*>(smem + ub + 2 * T::ROWS +
                                         T::bbias_bytes(bn));
  float* sD = slse + T::KP;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, k0 = 16 * warp;
  const long long nn = static_cast<long long>(n) * n;

  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const long long in = b * a.sb + h * a.sh;
  stage_rows<KT, D8>(sq, a.q + in, n, a.sn, tid);
  stage_rows<KT, D8>(sk, a.k + in, n, a.sn, tid);
  stage_rows<KT, D8>(sv, a.v + in, n, a.sn, tid);
  stage_rows<KT, D8>(sdo, a.dout + b * a.gb + h * a.gh, n, a.gn, tid);
  stage_rows<KT, D8>(so, a.o + b * a.ob + h * a.oh, n, a.on, tid);
  // rows past n read zeros from the bias's tail
  const int ob = stage_f32<T::THREADS>(
      sbias, a.bias ? a.bias + bh * nn : a.bias, bn * n,
      a.bias ? (T::KP - n) * n : T::KP, tid);
  const int ok =
      a.keep ? stage_u8<T::THREADS>(skeep, a.keep + bh * nn, n * n, tid) : 0;
  if (tid < T::KP) {
    if (tid < n) cp4(slse + tid, a.lse_in + bh * static_cast<long long>(n) + tid);
    else slse[tid] = INFINITY;
  }
  // keys from kmax on are masked: a warp whose keys all are has dS = 0
  // and Pd = 0, and skips its products (the result is the same to the
  // bit); row tiles from n on have p = 0 and are skipped too
  int kv = 0;
  for (int t = lane; t < n; t += 32)
    if (a.key_mask[static_cast<long long>(b) * n + t]) kv = t + 1;
  const int kmax = __reduce_max_sync(0xffffffffu, kv);
  const bool live = k0 < kmax;
  float* dbias = a.dbias ? a.dbias + bh * nn : a.dbias;
  // this thread's keys (clamped to n - 1 for the bias and the mask)
  float madd[2];
  int kk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + g + 8 * i;
    kk[i] = min(key, n - 1);
    madd[i] = (key < n && a.key_mask[static_cast<long long>(b) * n + kk[i]])
                  ? 0.0f : -INFINITY;
  }
  cp_wait_all();
  __syncthreads();

  // D = rowsum(dO * out), 0 past n
  if (tid < T::KP) {
    float dsum = 0.0f;
#pragma unroll
    for (int u = 0; u < D8; ++u) {
      const __nv_bfloat162* ov =
          reinterpret_cast<const __nv_bfloat162*>(so + tid * T::LD + 8 * u);
      const __nv_bfloat162* gv =
          reinterpret_cast<const __nv_bfloat162*>(sdo + tid * T::LD + 8 * u);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 x = __bfloat1622float2(ov[w]);
        const float2 y = __bfloat1622float2(gv[w]);
        dsum = fmaf(x.x, y.x, dsum);
        dsum = fmaf(x.y, y.y, dsum);
      }
    }
    sD[tid] = dsum;
  }
  __syncthreads();

  // S^T = k q^T and dP^T = v dO^T over every row, for keys k0..k0+15
  const bool kok[2] = {k0 + g < n, k0 + g + 8 < n};
  unsigned da[KT][4], pa[KT][4];
  float gk[D8][4], gv[D8][4];
#pragma unroll
  for (int u = 0; u < D8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[u][e] = gv[u][e] = 0.0f;
  if (live) {
    unsigned ka[T::DK][4], va[T::DK][4];
    load_a<KT, D8>(ka, sk + k0 * T::LD, lane);
    load_a<KT, D8>(va, sv + k0 * T::LD, lane);
    float st[T::NT][4], dp[T::NT][4];
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
      if (8 * j >= n) continue;
      mma_cols<KT, D8>(st[j], ka, sq + 8 * j * T::LD, lane);
      mma_cols<KT, D8>(dp[j], va, sdo + 8 * j * T::LD, lane);
    }

    // element (j, e): row 8 j + 2 c + (e & 1), key k0 + g + 8 (e >> 1);
    // st becomes dS (also the bias gradient, stored from here), dp
    // becomes Pd.  Rows past n have lse = +inf, so p = 0.
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      if (8 * j >= n) continue;  // st and dp are 0 there
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * j + 2 * c + (e & 1), i = e >> 1;
        const float x = st[j][e] * a.scale + madd[i] +
                        sbias[ob + row * bn + kk[i]];
        const float p = expf(x - slse[row]);
        float kp = 1.0f;
        if (a.keep) kp = skeep[ok + row * n + kk[i]] ? a.rscale : 0.0f;
        const float ds = p * (dp[j][e] * kp - sD[row]);
        if (dbias && kok[i] && row < n) dbias[row * n + kk[i]] = ds;
        st[j][e] = ds;
        dp[j][e] = p * kp;
      }
    }
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      to_a(da[kc], st[2 * kc], st[2 * kc + 1]);
      to_a(pa[kc], dp[2 * kc], dp[2 * kc + 1]);
    }

    // dk = dS^T q and dv = Pd^T dO for keys k0..k0+15
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      if (16 * kc >= n) continue;
      mma_rows_t<KT, D8>(gk, da[kc], sq + 16 * kc * T::LD, lane);
      mma_rows_t<KT, D8>(gv, pa[kc], sdo + 16 * kc * T::LD, lane);
    }
  } else if (dbias) {
    // masked keys: a bias gradient of 0
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * j + 2 * c + (e & 1), i = e >> 1;
        if (kok[i] && row < n) dbias[row * n + kk[i]] = 0.0f;
      }
  }
  const long long out0 =
      (static_cast<long long>(b) * n * a.heads + h) * (8 * D8);
  store_rows<D8>(a.dk + out0, gk, k0, n, a.heads, lane, a.scale);
  store_rows<D8>(a.dv + out0, gv, k0, n, a.heads, lane, 1.0f);

  __syncthreads();  // q, v, dO and the keep-mask are dead
  // bf16 dS^T [key][row] over them, for the keys before kmax
  if (live) {
#pragma unroll
    for (int kc = 0; kc < KT; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + g + 8 * (i & 1);
        const int row = 16 * kc + 8 * (i >> 1) + 2 * c;
        *reinterpret_cast<unsigned*>(sds + key * T::LDS + row) = da[kc][i];
      }
  }
  __syncthreads();

  // dq = dS k for rows r0..r0+15 (dS from dS^T by ldmatrix.trans)
  const int r0 = 16 * warp;
  float gq[D8][4];
#pragma unroll
  for (int u = 0; u < D8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[u][e] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    if (16 * kc >= kmax) continue;
    unsigned af[4];
    ldsm_x4_t(af, sds + (16 * kc + 8 * ((lane >> 4) & 1) + (lane & 7)) *
                            T::LDS + r0 + 8 * ((lane >> 3) & 1));
    mma_rows_t<KT, D8>(gq, af, sk + 16 * kc * T::LD, lane);
  }
  store_rows<D8>(a.dq + out0, gq, r0, n, a.heads, lane, a.scale);
}

template <int KT, int D8, bool kBwd>
int launch(const Args& a, int batch, cudaStream_t stream) {
  using T = Tile<KT, D8>;
  const int bn = a.bias ? a.n : 0;
  const int smem = kBwd ? T::bwd_smem(a.n, bn) : T::fwd_smem(a.n, bn);
  void (*kernel)(const Args) = kBwd ? biased_attention_bwd_kernel<KT, D8>
                                    : biased_attention_fwd_kernel<KT, D8>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch * a.heads, T::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KT, bool kBwd>
int launch_d(const Args& a, int batch, int d, cudaStream_t s) {
  switch (d / 8) {
    case 1: return launch<KT, 1, kBwd>(a, batch, s);
    case 2: return launch<KT, 2, kBwd>(a, batch, s);
    case 3: return launch<KT, 3, kBwd>(a, batch, s);
    default: return launch<KT, 4, kBwd>(a, batch, s);
  }
}

template <bool kBwd>
int dispatch(const Args& a, int batch, int d, void* stream) {
  if (batch == 0 || a.heads == 0) return 0;
  if (a.n < 1 || a.n > 128 || d < 8 || d > 32 || d % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((a.n + 31) / 32) {
    case 1: return launch_d<2, kBwd>(a, batch, d, s);
    case 2: return launch_d<4, kBwd>(a, batch, d, s);
    case 3: return launch_d<6, kBwd>(a, batch, d, s);
    default: return launch_d<8, kBwd>(a, batch, d, s);
  }
}

}  // namespace

// q, k, v [B, H, N, d] bf16 with strides (sb, sh, sn, 1) in elements, each a
// multiple of 8, 16-byte aligned; bias (or NULL) [B, H, N, N] f32 and keep
// (or NULL) [B, H, N, N] bool, contiguous; key_mask [B, N] bool; out [B, N, H, d]
// bf16 and lse (or NULL) [B, H, N] f32, contiguous.  1 <= N <= 128, d in
// {8, 16, 24, 32} (checked by the caller: ops/biased_attention.py::
// kernels_support).  Returns cudaGetLastError() after the launch.
extern "C" int biased_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* bias,
    const void* key_mask, const void* keep, void* out, void* lse, int batch,
    int heads, int n, int d, long long sb, long long sh, long long sn,
    float scale, float rscale, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.keep = static_cast<const uint8_t*>(keep);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.heads = heads;
  a.n = n;
  a.sb = sb;
  a.sh = sh;
  a.sn = sn;
  a.scale = scale;
  a.rscale = rscale;
  return dispatch<false>(a, batch, d, stream);
}

// The forward's inputs, out [B, H, N, d] (strides ob, oh, on), its gradient
// dout (gb, gh, gn), both under the forward's rules for q, and its lse ->
// dq, dk, dv [B, N, H, d] bf16 and dbias [B, H, N, N] f32, contiguous (both
// bias and dbias NULL without a bias).
extern "C" int biased_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* bias, const void* key_mask,
    const void* keep, const void* lse, void* dq, void* dk, void* dv,
    void* dbias, int batch, int heads, int n, int d, long long sb,
    long long sh, long long sn, long long ob, long long oh, long long on,
    long long gb, long long gh, long long gn, float scale, float rscale,
    void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.bias = static_cast<const float*>(bias);
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.keep = static_cast<const uint8_t*>(keep);
  a.lse_in = static_cast<const float*>(lse);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dbias = static_cast<float*>(dbias);
  a.heads = heads;
  a.n = n;
  a.sb = sb;
  a.sh = sh;
  a.sn = sn;
  a.ob = ob;
  a.oh = oh;
  a.on = on;
  a.gb = gb;
  a.gh = gh;
  a.gn = gn;
  a.scale = scale;
  a.rscale = rscale;
  return dispatch<true>(a, batch, d, stream);
}
