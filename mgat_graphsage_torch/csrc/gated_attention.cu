// EGT's gated attention, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no EGT.  It takes the place of
// the chain of PyTorch ops of ops/biased_attention.py::GatedAttention (kept
// for the CPU, other dtypes and shapes past the limits below) on CUDA
// tensors, in every layer of models/layers.py::EGTLayer.
//
// For q, k, v [B, H, N, d] bf16 (read through their strides: the layer's
// are views of the projections' [B, N, H, d]), the pair stream's bias E and
// gate logits G [B, H, N, N] bf16, stored as [B, N, N, H] (the pair Linears'
// own layout, H heads of a slot side by side), key_mask [B, N] bool, an
// optional keep-mask [B, H, N, N] bool of drop rate p (r = 1 / (1 - p)), the
// clip c and the first `fixed` rows (the virtual nodes):
//     S    = scale q k^T                                        (f32 sums)
//     H^   = clamp(S, -c, c) + E        every slot -> bf16 [B, N, N, H]
//     A    = softmax(H^, masked keys at -inf)                   (f32)
//     g    = sigmoid(G), 0 at masked keys;  gs = rowsum(g)
//     sc   = ln(1 + gs), 1 on the first `fixed` rows
//     out  = sc * bf16(A g keep r) v               -> bf16 [B, N, H, d]
//     lse  = log-sum-exp of the row, gs                 [B, H, N] f32 each
// A row with no valid key reads out = 0, lse = +inf.  The backward, from the
// same inputs, out, its gradient dO, the gradient of H^ (dH, same layout as
// E; may be NULL: the last layer uses no H^) and lse and gs:
//     do   = bf16(sc dO);  D = rowsum(dO out)  (= sum_j dA_j A_j = do . o)
//     dsc  = D / sc / (1 + gs), 0 on the fixed rows
//     A    = exp(H^ - lse), g recomputed;  dP = (do v^T) keep r
//     dE   = A (dP g - D) + dH                       every slot -> bf16
//     dG   = (dP A + dsc) g (1 - g)                  every slot -> bf16
//     dS   = bf16(scale dE where |S| <= c, else 0)
//     dq   = dS k,  dk = dS^T q,  dv = bf16(A g keep r)^T do
// the explicit path's arithmetic, up to where it rounds (it rounds S to bf16
// before the clip and o before the scaler; here both stay f32).
//
// Bound on the H100: bytes.  At N = 84, H = 32, d = 24 (egt_110m.train) a
// molecule's layer moves ~2.1 MB forward (E, G and H^ 1.35, the keep-mask
// 0.23, q, k, v and out 0.52) and ~3.5 MB backward (E, G, dH, dE, dG 2.26),
// some 16 operations a byte against the card's ridge of ~295.  So every
// [N, N] intermediate (the logits, the clip's mask, the probabilities, the
// gates, dS) stays on chip; the forward writes out, H^ and two f32 row
// statistics, the backward recomputes the rest from them.
//
// Design.  A block per (molecule, 8 heads), two warps a head, 512 threads.
// Each library holds one tile shape, KT = 2 ceil(N / 32) row and key tiles
// of 16 and d / 8, built when a process first launches it: the 30 kernels
// of every shape took 107 s to compile, one shape's two 9.7 s.
// The pair tensors hold a slot's H heads in 2 H contiguous bytes, so a block
// of 8 heads reads and writes 16 bytes of each slot, half a 32-byte sector:
// the other half belongs to the block of the next 8 heads, which has the
// next block index, runs beside it and finds the sector in L2.  (16 heads a
// block would take a whole sector, but k and v of 16 heads, 147 KB at N =
// 84, leave no room for the pair tiles.)  Staging copies 4 bytes (2 heads)
// of each slot into one of four planes, so that a warp reads its head's
// half-words across 32 lanes without a 4-way bank conflict, and writes H^,
// dE and dG into the same half-words; the planes go back to device memory
// as one 16-byte store a slot.
//   Forward: k and v of the 8 heads stay staged; the block walks the rows
// in tiles of 16, each tile's q, E, G and keep-mask copied in by cp.async
// after the tile before has gone back out.  Head h's two warps take half
// the keys each: S = q k^T (mma.sync m16n8k16, and m16n8k8 for the last 8
// of d = 24), clip + E -> H^ (in place), the row max and sums within a
// thread and its quad, then over both halves through shared memory, the
// gates, P = A g keep r as the bf16 A fragments of P v; the second half's
// P v is added to the first's, scaled rows stored.
//   Backward: q and do (scaled as it is staged, with D and dsc per row) of
// the 8 heads stay staged; the block walks key tiles of 16 in order (and
// for d = 32, or N > 96 and d > 8, the rows in chunks), each round's k, v, E, G, dH and
// keep-mask copied in after the one before has gone out.  Head h's two
// warps take alternate 16-row tiles: S^T = k q^T and dP^T = v do^T, per
// element dE and dG (written over E and G), dS^T and P^T in registers, the
// tile's part of dk and dv, and dq for its rows (the tiles transposed by
// movmatrix), summed over every key tile in registers; the second warp's dk
// and dv are added to the first's.  Every sum runs in one order on every
// run: no atomics, the same bits.
//
// What the measurements taught (H100, the cell's shape, PERF.md rows E-E'').
// The kernels are instruction-bound, not short of bytes in flight: a second
// stage of tiles (cp.async while the tile before is computed) changed
// neither time, so there is one, and the forward without its element
// passes took two thirds of its time.  A warp a head (8 an SM, with shared
// memory full of k and v) ran 274 and 506 us (forward, backward); two warps
// a head 258 and 431 us.  Runtime divisions in the staging loops, branches
// and shared-memory key flags in the element loops and IEEE division in the
// gates had cost 25-30%.  Sharing each sector with the next block costs
// little: a copy that read and wrote each group's 16 bytes contiguously
// (wrong results, the same work) ran 249.5 and 496.8 us at a warp a head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeads = 8;               // heads a block: 16 bytes of a slot
constexpr int kThreads = 64 * kHeads;   // two warps a head
constexpr int kMaxSmem = 232448;        // a block's shared memory on sm_90
constexpr int kRowWords = 20;           // backward: a staged pair row, 16 keys

template <int KT, int D8>
struct Geo {
  static constexpr int KP = 16 * KT;         // rows and keys, padded
  static constexpr int NT = 2 * KT;          // n8 tiles over the keys
  static constexpr int LD = 8 * (D8 | 1);    // staged row stride (bf16)
  static constexpr int HP = KP * LD;         // a head's staged rows (bf16)
  // forward: a staged pair row (words of 2 heads) and keep-mask row
  // (bytes), KP keys and 8 more: 8 modulo 16, so a warp's 32 reads fall
  // at most two to a bank; a pair plane of 16 rows
  static constexpr int RWF = KP + 8;
  static constexpr int PSF = 16 * RWF + 8;

  // forward: k, v and the key flags, the two key halves' exchange (row
  // maxima, row and gate sums, P v), then the row tile's q, E and G (4
  // planes each) and keep-mask
  static constexpr int fwd_smem = 2 * kHeads * HP * 2 + KP * 4 +
                                  (2 * 16 + 2 * 16 * 2 + 16 * 8 * D8) *
                                      kHeads * 4 +
                                  kHeads * 16 * LD * 2 + 2 * 4 * PSF * 4 +
                                  kHeads * 16 * RWF;
};

struct FwdArgs {
  const bf16 *q, *k, *v, *bias, *gate;
  const uint8_t *key_mask, *keep;
  bf16 *out, *hh;
  float *lse, *gsum;
  int heads, n, fixed;
  long long sb, sh, sn;  // q, k, v strides (elements)
  float scale, clip, rscale;
};

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout, *dhh, *bias, *gate;
  const uint8_t *key_mask, *keep;
  const float *lse, *gsum;
  bf16 *dq, *dk, *dv, *dbias, *dgate;
  int heads, n, fixed;
  long long sb, sh, sn;  // q, k, v strides (elements)
  long long ob, oh, on;  // out's
  long long gb, gh, gn;  // dO's
  float scale, clip, rscale;
};

// ---- copies and fragments ---------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x1(unsigned& r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_tr(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

// d += a (16 x 8, row) * b (8 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_k8(float (&d)[4], unsigned a0,
                                       unsigned a1, unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// the transpose of an 8 x 8 bf16 tile held one row pair a lane
__device__ __forceinline__ unsigned transpose8(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// the bf16 of head `hi` (0: the low half, 1: the high) of a word holding
// two, in f32: one prmt with the selector half_sel(hi), made once
__device__ __forceinline__ unsigned half_sel(int hi) {
  return hi ? 0x3244u : 0x1044u;
}

__device__ __forceinline__ float half_at(unsigned w, unsigned sel) {
  return __uint_as_float(__byte_perm(w, 0u, sel));
}

__device__ __forceinline__ void put_half(unsigned* w, int hi, float x) {
  reinterpret_cast<bf16*>(w)[hi] = __float2bfloat16_rn(x);
}

// the fast exponential and division (ex2.approx, rcp.approx: a few f32
// ulps): the probabilities and gates round to bf16 before they reach an
// output
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

// the A fragments (16 rows x d) of 16 staged rows: k16 steps, then a k8
// step's two registers in the last entry when d / 8 is odd
template <int D8, int LD>
__device__ __forceinline__ void load_a(unsigned (&a)[(D8 + 1) / 2][4],
                                       const bf16* rows, int lane) {
#pragma unroll
  for (int ks = 0; ks < D8 / 2; ++ks)
    ldsm_x4(a[ks], rows + (lane & 15) * LD + 16 * ks + 8 * (lane >> 4));
  if constexpr (D8 & 1) {
    unsigned r[2];
    ldsm_x2(r, rows + (lane & 15) * LD + 16 * (D8 / 2));
    a[D8 / 2][0] = r[0];
    a[D8 / 2][1] = r[1];
  }
}

// d += A (16 x d) * the 8 staged rows at `rows` (as B: n = its rows, k = d)
template <int D8, int LD>
__device__ __forceinline__ void mma_dot(float (&d)[4],
                                        const unsigned (&a)[(D8 + 1) / 2][4],
                                        const bf16* rows, int lane) {
  const bf16* row = rows + (lane & 7) * LD;
  int ks = 0;
#pragma unroll
  for (; ks + 2 <= D8 / 2; ks += 2) {
    unsigned b[4];
    ldsm_x4(b, row + 16 * ks + 8 * (lane >> 3));
    mma_bf16(d, a[ks], b[0], b[1]);
    mma_bf16(d, a[ks + 1], b[2], b[3]);
  }
  if constexpr ((D8 / 2) & 1) {
    unsigned b[2];
    ldsm_x2(b, row + 16 * (D8 / 2 - 1) + 8 * ((lane >> 3) & 1));
    mma_bf16(d, a[D8 / 2 - 1], b[0], b[1]);
  }
  if constexpr (D8 & 1) {
    unsigned b;
    ldsm_x1(b, row + 16 * (D8 / 2));
    mma_k8(d, a[D8 / 2][0], a[D8 / 2][1], b);
  }
}

// d[t] += A (16 x 16, registers) * the 16 staged rows at `rows` (as B: k =
// its rows, n = d: ldmatrix.trans)
template <int D8, int LD>
__device__ __forceinline__ void mma_t(float (&d)[D8][4], const unsigned (&a)[4],
                                      const bf16* rows, int lane) {
  const bf16* row = rows + (lane & 15) * LD;
#pragma unroll
  for (int t = 0; t + 1 < D8; t += 2) {
    unsigned b[4];
    ldsm_x4_t(b, row + 8 * (t + (lane >> 4)));
    mma_bf16(d[t], a, b[0], b[1]);
    mma_bf16(d[t + 1], a, b[2], b[3]);
  }
  if constexpr (D8 & 1) {
    unsigned b[2];
    ldsm_x2_tr(b, row + 8 * (D8 - 1));
    mma_bf16(d[D8 - 1], a, b[0], b[1]);
  }
}

// the bf16 A fragment of k16 step kc from f32 accumulators of n8 tiles
// 2 kc and 2 kc + 1
__device__ __forceinline__ void to_a(unsigned (&a)[4], const float (&lo)[4],
                                     const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

template <int D8>
__device__ __forceinline__ void zero(float (&d)[D8][4]) {
#pragma unroll
  for (int t = 0; t < D8; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.0f;
}

// rows r0 + g and r0 + g + 8 (those < n) of an accumulator [16, d] times
// mul[i], to dst [B, N, H, d] at (row 0, this head)
template <int D8>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D8][4],
                                           int r0, int n, int heads, int lane,
                                           const float (&mul)[2]) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= n) continue;
    bf16* p = dst + static_cast<long long>(row) * heads * (8 * D8) + 2 * c;
#pragma unroll
    for (int t = 0; t < D8; ++t)
      *reinterpret_cast<unsigned*>(p + 8 * t) =
          pack(acc[t][2 * i] * mul[i], acc[t][2 * i + 1] * mul[i]);
  }
}

// The staging loops run over a tile's compile-time shape (no division by
// a runtime number) and skip what lies past the runtime rows and keys.

// rows [r0, r0 + ROWS) of the group's 8 heads of a [B, H, N, d] tensor
// (strides sh, sn; `src` at (b, first head, row 0)) into dst [8][ROWS][LD]
// (head stride HS); zeros for rows from n on
template <int D8, int LD, int ROWS, int HS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long sh, long long sn, int r0,
                                           int n, int tid) {
  for (int i = tid; i < kHeads * ROWS * D8; i += kThreads) {
    const int hh = i / (ROWS * D8), rem = i - hh * ROWS * D8;
    const int r = rem / D8, cc = rem - r * D8;
    bf16* d = dst + hh * HS + r * LD + 8 * cc;
    if (r0 + r < n) cp16(d, src + hh * sh + (r0 + r) * sn + 8 * cc);
    else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// slots [0, rows) x [0, keys) of a ROWS x KEYS tile of the group's 8 heads
// of a pair tensor ([B, N, N, H]; `src` at the tile's first slot, row
// stride n H) into 4 planes of 2 heads (plane stride PL, row stride RW
// words)
template <int ROWS, int KEYS, int RW, int PL>
__device__ __forceinline__ void stage_pairs(unsigned* dst, const bf16* src,
                                            int n, int heads, int rows,
                                            int keys, int tid) {
  for (int i = tid; i < ROWS * KEYS * 4; i += kThreads) {
    const int r = i / (KEYS * 4), key = (i >> 2) % KEYS, p = i & 3;
    if (r < rows && key < keys)
      cp4(dst + p * PL + r * RW + key,
          src + (static_cast<long long>(r) * n + key) * heads + 2 * p);
  }
}

// the 4 planes of slots [0, rows) x [0, keys) of a staged tile back to a
// pair tensor, one 16-byte store a slot
template <int ROWS, int KEYS, int RW, int PL>
__device__ __forceinline__ void unstage_pairs(bf16* dst, const unsigned* src,
                                              int n, int heads, int rows,
                                              int keys, int tid) {
  for (int i = tid; i < ROWS * KEYS; i += kThreads) {
    const int r = i / KEYS, key = i - r * KEYS;
    if (r < rows && key < keys) {
      const unsigned* s = src + r * RW + key;
      *reinterpret_cast<uint4*>(
          dst + (static_cast<long long>(r) * n + key) * heads) =
          make_uint4(s[0], s[PL], s[2 * PL], s[3 * PL]);
    }
  }
}

// rows [0, rows) x keys [0, keys) of a ROWS x KEYS tile of the group's 8
// heads' keep-masks (`src` at the first head's tile, head stride nn, row
// stride n) into dst [8][ROWS][RB] bytes; by 4 bytes where n is a multiple
// of 4 (then so are the tile's offset and keys), else by bytes
template <int ROWS, int KEYS, int RB>
__device__ __forceinline__ void stage_keep(uint8_t* dst, const uint8_t* src,
                                           long long nn, int n, int rows,
                                           int keys, int tid) {
  if ((n & 3) == 0) {
    constexpr int W = KEYS / 4;
    for (int i = tid; i < kHeads * ROWS * W; i += kThreads) {
      const int hh = i / (ROWS * W), rem = i - hh * ROWS * W;
      const int r = rem / W, w = rem - r * W;
      if (r < rows && 4 * w < keys)
        cp4(dst + (hh * ROWS + r) * RB + 4 * w,
            src + hh * nn + static_cast<long long>(r) * n + 4 * w);
    }
  } else {
    for (int i = tid; i < kHeads * ROWS * KEYS; i += kThreads) {
      const int hh = i / (ROWS * KEYS), rem = i - hh * ROWS * KEYS;
      const int r = rem / KEYS, key = rem - r * KEYS;
      if (r < rows && key < keys)
        dst[(hh * ROWS + r) * RB + key] =
            src[hh * nn + static_cast<long long>(r) * n + key];
    }
  }
}

// ---- forward ----------------------------------------------------------------

template <int KT, int D8>
__global__ void __launch_bounds__(kThreads, 1)
gated_attention_fwd_kernel(const FwdArgs a) {
  using G = Geo<KT, D8>;
  constexpr int LD = G::LD, KP = G::KP, NH = G::NT / 2, KH = KT / 2;
  constexpr int RW = G::RWF, PS = G::PSF;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hw = warp & 7, kh = warp >> 3;
  const int g = lane >> 2, c = lane & 3, hx = hw & 1;
  const int groups = a.heads / kHeads;
  const int b = blockIdx.x / groups, grp = blockIdx.x - b * groups;
  const int h = grp * kHeads + hw;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kHeads * G::HP;
  float* skv = reinterpret_cast<float*>(sv + kHeads * G::HP);
  float* xm = skv + KP;                 // [8][2][16] row maxima
  float* xs = xm + kHeads * 2 * 16;     // [8][2][16][2] row sums, gate sums
  float* xo = xs + kHeads * 2 * 16 * 2; // [8][16][8 D8] key half 1's P v
  unsigned char* st = reinterpret_cast<unsigned char*>(xo + kHeads * 16 * 8 * D8);

  const long long nn = static_cast<long long>(n) * n;
  const long long head0 = b * a.sb + static_cast<long long>(grp) * kHeads * a.sh;
  const long long pair0 = static_cast<long long>(b) * nn * a.heads + grp * kHeads;
  const uint8_t* keep0 =
      a.keep ? a.keep + (static_cast<long long>(b) * a.heads + grp * kHeads) * nn
             : nullptr;
  const int tiles = (n + 15) / 16;
  bf16* sq = reinterpret_cast<bf16*>(st);
  unsigned* sE = reinterpret_cast<unsigned*>(st + kHeads * 16 * LD * 2);
  unsigned* sG = sE + 4 * PS;
  uint8_t* skp = reinterpret_cast<uint8_t*>(sG + 4 * PS);

  auto load = [&](int rt) {
    const int r0 = 16 * rt, rows = min(16, n - r0);
    stage_rows<D8, LD, 16, 16 * LD>(sq, a.q + head0, a.sh, a.sn, r0, n, tid);
    const long long slot0 = pair0 + static_cast<long long>(r0) * n * a.heads;
    stage_pairs<16, KP, RW, PS>(sE, a.bias + slot0, n, a.heads, rows, n, tid);
    stage_pairs<16, KP, RW, PS>(sG, a.gate + slot0, n, a.heads, rows, n, tid);
    if (keep0)
      stage_keep<16, KP, RW>(skp, keep0 + static_cast<long long>(r0) * n, nn,
                                        n, rows, n, tid);
  };

  stage_rows<D8, LD, KP, G::HP>(sk, a.k + head0, a.sh, a.sn, 0, n, tid);
  stage_rows<D8, LD, KP, G::HP>(sv, a.v + head0, a.sh, a.sn, 0, n, tid);
  for (int i = tid; i < KP; i += kThreads)
    skv[i] = (i < n && a.key_mask[static_cast<long long>(b) * n + i]) ? 1.0f : 0.0f;
  load(0);
  cp_commit();

  const int k0 = kh * (KP / 2);
  const bf16* wk = sk + hw * G::HP;
  const bf16* wv = sv + hw * G::HP;
  const long long row0 = static_cast<long long>(b) * n * a.heads;
  const unsigned sel = half_sel(hx);
  __syncthreads();
  unsigned kbits = 0u;
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (skv[k0 + 8 * j + 2 * c + e] != 0.0f) kbits |= 1u << (2 * j + e);
  const int bar = 1 + hw;
  for (int rt = 0; rt < tiles; ++rt) {
    cp_wait<0>();
    __syncthreads();
    unsigned* wE = sE + (hw >> 1) * PS;
    const unsigned* wG = sG + (hw >> 1) * PS;
    const uint8_t* wkeep = skp + hw * 16 * RW;
    const int r0 = 16 * rt;

    unsigned qa[(D8 + 1) / 2][4];
    load_a<D8, LD>(qa, sq + hw * 16 * LD, lane);
    float s[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      mma_dot<D8, LD>(s[j], qa, wk + (k0 + 8 * j) * LD, lane);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * c + (e & 1);
        const int wi = (g + 8 * (e >> 1)) * RW + key;
        const float y = fminf(fmaxf(s[j][e] * a.scale, -a.clip), a.clip) +
                        half_at(wE[wi], sel);
        put_half(wE + wi, hx, y);
        s[j][e] = (kbits >> (2 * j + (e & 1))) & 1u ? y : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (c == 0) xm[(hw * 2 + kh) * 16 + g + 8 * i] = mx[i];
    }
    named_sync(bar, 64);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], xm[(hw * 2 + (kh ^ 1)) * 16 + g + 8 * i]);
      if (mx[i] == -INFINITY) mx[i] = 0.0f;
    }
    float sum[2] = {0.0f, 0.0f}, gs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * c + (e & 1), rl = g + 8 * (e >> 1);
        const float ex = __expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += ex;
        const float sg = sigmoid(half_at(wG[rl * RW + key], sel));
        const float gt = (kbits >> (2 * j + (e & 1))) & 1u ? sg : 0.0f;
        gs[e >> 1] += gt;
        float m = 1.0f;
        if (keep0) m = wkeep[rl * RW + key] ? a.rscale : 0.0f;
        s[j][e] = ex * gt * m;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      gs[i] += __shfl_xor_sync(0xffffffffu, gs[i], 1);
      gs[i] += __shfl_xor_sync(0xffffffffu, gs[i], 2);
      if (c == 0) {
        xs[((hw * 2 + kh) * 16 + g + 8 * i) * 2] = sum[i];
        xs[((hw * 2 + kh) * 16 + g + 8 * i) * 2 + 1] = gs[i];
      }
    }
    named_sync(bar, 64);
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* x0 = xs + ((hw * 2) * 16 + g + 8 * i) * 2;
      const float* x1 = xs + ((hw * 2 + 1) * 16 + g + 8 * i) * 2;
      sum[i] = x0[0] + x1[0];
      gs[i] = x0[1] + x1[1];
      inv[i] = sum[i] > 0.0f ? 1.0f / sum[i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
    unsigned pa[KH][4];
#pragma unroll
    for (int kc = 0; kc < KH; ++kc) to_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
    float o[D8][4];
    zero<D8>(o);
#pragma unroll
    for (int kc = 0; kc < KH; ++kc)
      mma_t<D8, LD>(o, pa[kc], wv + (k0 + 16 * kc) * LD, lane);
    float* wo = xo + hw * 16 * 8 * D8;
    if (kh == 1) {
#pragma unroll
      for (int t = 0; t < D8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wo[(g + 8 * (e >> 1)) * 8 * D8 + 8 * t + 2 * c + (e & 1)] = o[t][e];
    }
    named_sync(bar, 64);
    if (kh == 0) {
#pragma unroll
      for (int t = 0; t < D8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[t][e] += wo[(g + 8 * (e >> 1)) * 8 * D8 + 8 * t + 2 * c + (e & 1)];
      float sc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + g + 8 * i;
        sc[i] = row < a.fixed ? 1.0f : log1pf(gs[i]);
      }
      store_rows<D8>(a.out + (row0 + h) * (8 * D8), o, r0, n, a.heads, lane, sc);
      if (a.lse && c == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + g + 8 * i;
          if (row < n) {
            const long long at =
                (static_cast<long long>(b) * a.heads + h) * n + row;
            a.lse[at] = sum[i] > 0.0f ? mx[i] + __logf(sum[i]) : INFINITY;
            a.gsum[at] = gs[i];
          }
        }
      }
    }
    __syncthreads();
    unstage_pairs<16, KP, RW, PS>(
        a.hh + pair0 + static_cast<long long>(r0) * n * a.heads, sE, n,
        a.heads, min(16, n - r0), n, tid);
    __syncthreads();
    if (rt + 1 < tiles) {
      load(rt + 1);
      cp_commit();
    }
  }
}

// ---- backward ---------------------------------------------------------------

// backward with two warps a head: warp (head, rh) takes the 16-row tiles
// rh, rh + 2, ... of each chunk; a round is (key tile, chunk of rows)
template <int KT, int D8>
constexpr int bwd16_fixed() {
  return 2 * kHeads * Geo<KT, D8>::HP * 2 + 3 * kHeads * 16 * KT * 4 + 16 * KT * 4
         + 2 * kHeads * 16 * 8 * D8 * 4;
}
template <int KT, int D8>
constexpr int bwd16_stage(int rc) {
  return 2 * kHeads * 16 * Geo<KT, D8>::LD * 2 + 3 * 4 * (rc * kRowWords + 8) * 4
         + kHeads * rc * kRowWords;
}
template <int KT, int D8>
constexpr bool bwd16_fits(int ch) {
  return KT % ch == 0 && (KT / ch) % 2 == 0 &&
         bwd16_fixed<KT, D8>() + bwd16_stage<KT, D8>(16 * KT / ch) <= kMaxSmem;
}

template <int KT, int D8>
struct BwdGeo {
  static constexpr int CH = bwd16_fits<KT, D8>(1) ? 1 : bwd16_fits<KT, D8>(2) ? 2
                            : bwd16_fits<KT, D8>(3) ? 3 : 4;
  static constexpr int RCA = 16 * KT / CH;       // rows a chunk
  static constexpr int TPW = RCA / 32;           // row tiles a warp a chunk
  static constexpr int PSA = RCA * kRowWords + 8;
  static constexpr int smem = bwd16_fixed<KT, D8>() + bwd16_stage<KT, D8>(RCA);
  static_assert(bwd16_fits<KT, D8>(CH), "no chunk of rows fits");
};

template <int KT, int D8>
__global__ void __launch_bounds__(kThreads, 1)
gated_attention_bwd_kernel(const BwdArgs a) {
  using G = Geo<KT, D8>;
  using B16 = BwdGeo<KT, D8>;
  constexpr int LD = G::LD, KP = G::KP, RW = kRowWords;
  constexpr int CH = B16::CH, RCA = B16::RCA, TPW = B16::TPW, PS = B16::PSA;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hw = warp & 7, rh = warp >> 3;
  const int g = lane >> 2, c = lane & 3, hx = hw & 1;
  const int groups = a.heads / kHeads;
  const int b = blockIdx.x / groups, grp = blockIdx.x - b * groups;
  const int h = grp * kHeads + hw;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kHeads * G::HP;
  float* slse = reinterpret_cast<float*>(sdo + kHeads * G::HP);
  float* sD = slse + kHeads * KP;
  float* sdsc = sD + kHeads * KP;
  float* skv = sdsc + kHeads * KP;
  float* xkv = skv + KP;                       // [8][2][16][8 D8]
  unsigned char* st =
      reinterpret_cast<unsigned char*>(xkv + kHeads * 2 * 16 * 8 * D8);
  bf16* sk = reinterpret_cast<bf16*>(st);
  bf16* sv = sk + kHeads * 16 * LD;
  unsigned* sE = reinterpret_cast<unsigned*>(sv + kHeads * 16 * LD);
  unsigned* sG = sE + 4 * PS;
  unsigned* sH = sG + 4 * PS;
  uint8_t* skp = reinterpret_cast<uint8_t*>(sH + 4 * PS);

  const long long nn = static_cast<long long>(n) * n;
  const long long head0 = b * a.sb + static_cast<long long>(grp) * kHeads * a.sh;
  const long long pair0 = static_cast<long long>(b) * nn * a.heads + grp * kHeads;
  const uint8_t* keep0 =
      a.keep ? a.keep + (static_cast<long long>(b) * a.heads + grp * kHeads) * nn
             : nullptr;
  const int ktiles = (n + 15) / 16;

  auto load = [&](int kt, int ch) {
    const int k0 = 16 * kt, r0 = RCA * ch;
    const int rows = min(RCA, n - r0), keys = min(16, n - k0);
    stage_rows<D8, LD, 16, 16 * LD>(sk, a.k + head0, a.sh, a.sn, k0, n, tid);
    stage_rows<D8, LD, 16, 16 * LD>(sv, a.v + head0, a.sh, a.sn, k0, n, tid);
    if (rows <= 0) return;
    const long long slot0 = pair0 + (static_cast<long long>(r0) * n + k0) * a.heads;
    stage_pairs<RCA, 16, RW, PS>(sE, a.bias + slot0, n, a.heads, rows, keys, tid);
    stage_pairs<RCA, 16, RW, PS>(sG, a.gate + slot0, n, a.heads, rows, keys, tid);
    if (a.dhh)
      stage_pairs<RCA, 16, RW, PS>(sH, a.dhh + slot0, n, a.heads, rows, keys, tid);
    if (keep0)
      stage_keep<RCA, 16, RW>(skp, keep0 + static_cast<long long>(r0) * n + k0,
                                         nn, n, rows, keys, tid);
  };

  stage_rows<D8, LD, KP, G::HP>(sq, a.q + head0, a.sh, a.sn, 0, n, tid);
  for (int i = tid; i < KP; i += kThreads)
    skv[i] = (i < n && a.key_mask[static_cast<long long>(b) * n + i]) ? 1.0f : 0.0f;
  load(0, 0);
  cp_commit();
  for (int i = tid; i < kHeads * KP; i += kThreads) {
    const int hh = i / KP, row = i - hh * KP;
    bf16* dst = sdo + hh * G::HP + row * LD;
    if (row < n) {
      const long long at =
          (static_cast<long long>(b) * a.heads + grp * kHeads + hh) * n + row;
      const float gsum = a.gsum[at];
      const float sc = row < a.fixed ? 1.0f : log1pf(gsum);
      const bf16* go = a.dout + b * a.gb + (grp * kHeads + hh) * a.gh + row * a.gn;
      const bf16* ov = a.o + b * a.ob + (grp * kHeads + hh) * a.oh + row * a.on;
      float dsum = 0.0f;
#pragma unroll
      for (int u = 0; u < D8; ++u) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(go + 8 * u));
        const uint4 y = __ldg(reinterpret_cast<const uint4*>(ov + 8 * u));
        const unsigned xs[4] = {x.x, x.y, x.z, x.w};
        const unsigned ys[4] = {y.x, y.y, y.z, y.w};
        unsigned packed[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float x0 = half_at(xs[w], half_sel(0));
          const float x1 = half_at(xs[w], half_sel(1));
          dsum = fmaf(x0, half_at(ys[w], half_sel(0)), dsum);
          dsum = fmaf(x1, half_at(ys[w], half_sel(1)), dsum);
          packed[w] = pack(sc * x0, sc * x1);
        }
        *reinterpret_cast<uint4*>(dst + 8 * u) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      slse[hh * KP + row] = a.lse[at];
      sD[hh * KP + row] = dsum;
      sdsc[hh * KP + row] = (row < a.fixed || !(sc > 0.0f))
                                ? 0.0f : dsum / (sc * (1.0f + gsum));
    } else {
#pragma unroll
      for (int u = 0; u < D8; ++u)
        *reinterpret_cast<uint4*>(dst + 8 * u) = make_uint4(0u, 0u, 0u, 0u);
      slse[hh * KP + row] = INFINITY;
      sD[hh * KP + row] = 0.0f;
      sdsc[hh * KP + row] = 0.0f;
    }
  }

  const bf16* wq = sq + hw * G::HP;
  const bf16* wdo = sdo + hw * G::HP;
  const float* wlse = slse + hw * KP;
  const float* wD = sD + hw * KP;
  const float* wdsc = sdsc + hw * KP;
  const long long out0 = (static_cast<long long>(b) * n * a.heads + h) * (8 * D8);
  const float one[2] = {1.0f, 1.0f};
  const unsigned sel = half_sel(hx);
  const int pw = (hw >> 1) * PS;
  const uint8_t* wkeep = skp + hw * RCA * RW;
  float* wx = xkv + hw * 2 * 16 * 8 * D8;
  const int bar = 1 + hw;
  float gq[CH * TPW][D8][4];
#pragma unroll
  for (int t = 0; t < CH * TPW; ++t) zero<D8>(gq[t]);

  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = 16 * kt;
    float gk[D8][4], gv[D8][4];
    zero<D8>(gk);
    zero<D8>(gv);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int r0 = RCA * ch;
      cp_wait<0>();
      __syncthreads();
      unsigned ka[(D8 + 1) / 2][4], va[(D8 + 1) / 2][4];
      load_a<D8, LD>(ka, sk + hw * 16 * LD, lane);
      load_a<D8, LD>(va, sv + hw * 16 * LD, lane);
      const bool kvalid[2] = {skv[k0 + g] != 0.0f, skv[k0 + g + 8] != 0.0f};
      const bool kreal[2] = {k0 + g < n, k0 + g + 8 < n};
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int tl = 16 * (rh + 2 * i);      // the tile's first row in the chunk
        float st2[2][4], dp[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          st2[u][0] = st2[u][1] = st2[u][2] = st2[u][3] = 0.0f;
          dp[u][0] = dp[u][1] = dp[u][2] = dp[u][3] = 0.0f;
          mma_dot<D8, LD>(st2[u], ka, wq + (r0 + tl + 8 * u) * LD, lane);
          mma_dot<D8, LD>(dp[u], va, wdo + (r0 + tl + 8 * u) * LD, lane);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int rl = tl + 8 * u + 2 * c + e1, row = r0 + rl;
            const float lse = wlse[row], dsum = wD[row], dsc = wdsc[row];
#pragma unroll
            for (int eh = 0; eh < 2; ++eh) {
              const int e = 2 * eh + e1, kl = g + 8 * eh;
              const int wi = pw + rl * RW + kl;
              const float x = st2[u][e] * a.scale;
              const bool inside = x >= -a.clip && x <= a.clip;
              const float y =
                  fminf(fmaxf(x, -a.clip), a.clip) + half_at(sE[wi], sel);
              const float av = kvalid[eh] ? __expf(y - lse) : 0.0f;
              const float gt = kvalid[eh] ? sigmoid(half_at(sG[wi], sel)) : 0.0f;
              float m = 1.0f;
              if (keep0) m = wkeep[rl * RW + kl] ? a.rscale : 0.0f;
              const float dam = dp[u][e] * m;
              float dhh = av * (dam * gt - dsum);
              if (a.dhh) dhh += half_at(sH[wi], sel);
              const float dgate = (dam * av + dsc) * gt * (1.0f - gt);
              put_half(sE + wi, hx, dhh);
              put_half(sG + wi, hx, dgate);
              const bool real = kreal[eh] && row < n;
              st2[u][e] = real && inside ? dhh * a.scale : 0.0f;
              dp[u][e] = real ? av * gt * m : 0.0f;
            }
          }
        unsigned da[4], pa[4];
        to_a(da, st2[0], st2[1]);
        to_a(pa, dp[0], dp[1]);
        mma_t<D8, LD>(gk, da, wq + (r0 + tl) * LD, lane);
        mma_t<D8, LD>(gv, pa, wdo + (r0 + tl) * LD, lane);
        const unsigned af[4] = {transpose8(da[0]), transpose8(da[2]),
                                transpose8(da[1]), transpose8(da[3])};
        mma_t<D8, LD>(gq[ch * TPW + i], af, sk + hw * 16 * LD, lane);
      }
      __syncthreads();
      {
        const int rows = min(RCA, n - r0), keys = min(16, n - k0);
        if (rows > 0) {
          const long long slot0 =
              pair0 + (static_cast<long long>(r0) * n + k0) * a.heads;
          unstage_pairs<RCA, 16, RW, PS>(a.dbias + slot0, sE, n, a.heads,
                                         rows, keys, tid);
          unstage_pairs<RCA, 16, RW, PS>(a.dgate + slot0, sG, n, a.heads,
                                         rows, keys, tid);
        }
      }
      __syncthreads();
      const int nch = ch + 1 < CH ? ch + 1 : 0, nkt = ch + 1 < CH ? kt : kt + 1;
      if (nkt < ktiles) {
        load(nkt, nch);
        cp_commit();
      }
    }
    // the two row halves' dk and dv, summed in one order
    if (rh == 1) {
#pragma unroll
      for (int t = 0; t < D8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (g + 8 * (e >> 1)) * 8 * D8 + 8 * t + 2 * c + (e & 1);
          wx[at] = gk[t][e];
          wx[16 * 8 * D8 + at] = gv[t][e];
        }
    }
    named_sync(bar, 64);
    if (rh == 0) {
#pragma unroll
      for (int t = 0; t < D8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (g + 8 * (e >> 1)) * 8 * D8 + 8 * t + 2 * c + (e & 1);
          gk[t][e] += wx[at];
          gv[t][e] += wx[16 * 8 * D8 + at];
        }
      store_rows<D8>(a.dk + out0, gk, k0, n, a.heads, lane, one);
      store_rows<D8>(a.dv + out0, gv, k0, n, a.heads, lane, one);
    }
  }
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int i = 0; i < TPW; ++i)
      store_rows<D8>(a.dq + out0, gq[ch * TPW + i], RCA * ch + 16 * (rh + 2 * i), n,
                     a.heads, lane, one);
}


// ---- launch -----------------------------------------------------------------

#if !defined(GATED_KT) || !defined(GATED_D8)
#error "build one tile shape: -DGATED_KT=<2|4|6|8> -DGATED_D8=<1..4>"
#endif
static_assert(GATED_KT % 2 == 0 && GATED_KT >= 2 && GATED_KT <= 8 &&
                  GATED_D8 >= 1 && GATED_D8 <= 4 &&
                  !(GATED_KT == 8 && GATED_D8 == 4),
              "k and v (or q and do) of 8 heads alone fill shared memory");

template <bool kBwd, typename Args>
int launch(const Args& a, int batch, cudaStream_t stream) {
  using G = Geo<GATED_KT, GATED_D8>;
  int smem;
  void (*kernel)(const Args);
  if constexpr (kBwd) {
    smem = BwdGeo<GATED_KT, GATED_D8>::smem;
    kernel = gated_attention_bwd_kernel<GATED_KT, GATED_D8>;
  } else {
    smem = G::fwd_smem;
    kernel = gated_attention_fwd_kernel<GATED_KT, GATED_D8>;
  }
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch * (a.heads / kHeads), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the library holds the one tile shape (KT = 2 ceil(N / 32) tiles of 16
// rows, d / 8) that GATED_KT and GATED_D8 name (ops/_build.py::VARIANTS)
template <bool kBwd, typename Args>
int dispatch(const Args& a, int batch, int d, void* stream) {
  if (batch == 0 || a.heads == 0) return 0;
  if (a.n < 1 || 2 * ((a.n + 31) / 32) != GATED_KT || d != 8 * GATED_D8 ||
      a.heads % kHeads)
    return (int)cudaErrorInvalidValue;
  return launch<kBwd>(a, batch, (cudaStream_t)stream);
}

}  // namespace

// q, k, v [B, H, N, d] bf16 with strides (sb, sh, sn, 1) in elements, each a
// multiple of 8, 16-byte aligned; bias, gate [B, N, N, H] bf16 and keep (or
// NULL) [B, H, N, N] bool, contiguous, 16-byte aligned; key_mask [B, N]
// bool; out [B, N, H, d] and hh [B, N, N, H] bf16, lse and gsum (both or
// neither NULL) [B, H, N] f32, contiguous.  1 <= N <= 128, d in {8, 16, 24,
// 32} (not 32 past N = 96), H a multiple of 8 (checked by the caller:
// ops/biased_attention.py::gated_kernels_support), and N and d of the
// library's tile shape.  Returns cudaGetLastError() after the launch.
extern "C" int gated_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* bias,
    const void* gate, const void* key_mask, const void* keep, void* out,
    void* hh, void* lse, void* gsum, int batch, int heads, int n, int d,
    long long sb, long long sh, long long sn, float scale, float clip,
    float rscale, int fixed, void* stream) {
  FwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const bf16*>(bias);
  a.gate = static_cast<const bf16*>(gate);
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.keep = static_cast<const uint8_t*>(keep);
  a.out = static_cast<bf16*>(out);
  a.hh = static_cast<bf16*>(hh);
  a.lse = static_cast<float*>(lse);
  a.gsum = static_cast<float*>(gsum);
  a.heads = heads;
  a.n = n;
  a.fixed = fixed;
  a.sb = sb;
  a.sh = sh;
  a.sn = sn;
  a.scale = scale;
  a.clip = clip;
  a.rscale = rscale;
  return dispatch<false>(a, batch, d, stream);
}

// The forward's inputs, out [B, H, N, d] (strides ob, oh, on), its gradient
// dout (gb, gh, gn), both under the forward's rules for q, H^'s gradient dhh
// (or NULL) under the rules for bias, and the forward's lse and gsum -> dq,
// dk, dv [B, N, H, d] and dbias, dgate [B, N, N, H] bf16, contiguous.
extern "C" int gated_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* dhh, const void* bias, const void* gate,
    const void* key_mask, const void* keep, const void* lse,
    const void* gsum, void* dq, void* dk, void* dv, void* dbias,
    void* dgate, int batch, int heads, int n, int d, long long sb,
    long long sh, long long sn, long long ob, long long oh, long long on,
    long long gb, long long gh, long long gn, float scale, float clip,
    float rscale, int fixed, void* stream) {
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.dhh = static_cast<const bf16*>(dhh);
  a.bias = static_cast<const bf16*>(bias);
  a.gate = static_cast<const bf16*>(gate);
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.keep = static_cast<const uint8_t*>(keep);
  a.lse = static_cast<const float*>(lse);
  a.gsum = static_cast<const float*>(gsum);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dbias = static_cast<bf16*>(dbias);
  a.dgate = static_cast<bf16*>(dgate);
  a.heads = heads;
  a.n = n;
  a.fixed = fixed;
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
  a.clip = clip;
  a.rscale = rscale;
  return dispatch<true>(a, batch, d, stream);
}
